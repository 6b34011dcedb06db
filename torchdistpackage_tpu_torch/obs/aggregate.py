"""Sample aggregation — the parts of
``torchdistpackage_tpu/obs/aggregate.py`` the serving summary uses:
latency percentiles and the MoE expert-load summary."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np


def percentiles(samples: Sequence[float], ps=(50, 95, 99)
                ) -> Dict[str, float]:
    """``{"p50": ..., "p95": ..., "p99": ...}`` (empty input -> {});
    ``ps`` picks the percentiles."""
    arr = np.asarray(list(samples), dtype=np.float64)
    if arr.size == 0:
        return {}
    return {f"p{p}": float(np.percentile(arr, p)) for p in ps}


def moe_load_stats(expert_tokens: Sequence[float],
                   dropped_rate: Optional[float] = None) -> Dict[str, Any]:
    """Expert-load summary from per-expert routed-token counts (the
    reference's, :205): ``imbalance`` = ``max/mean - 1`` (0 = balanced),
    ``load_entropy`` = entropy of the load over ``log(E)`` (1 = uniform),
    and ``dropped_token_rate`` passed through when given."""
    tok = np.asarray(list(expert_tokens), dtype=np.float64)
    E = int(tok.size)
    total = float(tok.sum())
    out: Dict[str, Any] = {"num_experts": E,
                           "expert_tokens": [float(t) for t in tok]}
    if E == 0 or total <= 0:
        out.update(imbalance=0.0, load_entropy=0.0)
    else:
        p = tok / total
        with np.errstate(divide="ignore", invalid="ignore"):
            h = abs(float(-np.sum(np.where(p > 0, p * np.log(p), 0.0))))
        out.update(imbalance=float(tok.max() / tok.mean() - 1.0),
                   load_entropy=h / math.log(E) if E > 1 else 1.0)
    if dropped_rate is not None:
        out["dropped_token_rate"] = float(dropped_rate)
    return out
