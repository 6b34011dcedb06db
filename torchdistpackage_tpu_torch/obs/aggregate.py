"""Sample aggregation — the part of
``torchdistpackage_tpu/obs/aggregate.py`` the serving summary uses."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def percentiles(samples: Sequence[float]) -> Dict[str, float]:
    """``{"p50": ..., "p95": ..., "p99": ...}`` (empty input -> {})."""
    arr = np.asarray(list(samples), dtype=np.float64)
    if arr.size == 0:
        return {}
    return {f"p{p}": float(np.percentile(arr, p)) for p in (50, 95, 99)}
