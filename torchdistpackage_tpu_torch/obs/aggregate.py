"""Sample aggregation — the port's ``torchdistpackage_tpu/obs/aggregate.py``:
latency percentiles, host step-time statistics and their cross-host view
with straggler detection, the pipeline schedules' bubble and time
inflation (host arithmetic), and the MoE expert-load summary."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def percentiles(samples: Sequence[float], ps=(50, 95, 99)
                ) -> Dict[str, float]:
    """``{"p50": ..., "p95": ..., "p99": ...}`` (empty input -> {});
    ``ps`` picks the percentiles."""
    arr = np.asarray(list(samples), dtype=np.float64)
    if arr.size == 0:
        return {}
    return {f"p{p}": float(np.percentile(arr, p)) for p in ps}


def step_time_stats(times: Sequence[float]) -> Dict[str, float]:
    """Host-local summary of one run's step times (JAX :38)."""
    arr = np.asarray(list(times), dtype=np.float64)
    if arr.size == 0:
        return {"n": 0}
    out = {
        "n": int(arr.size),
        "mean": float(arr.mean()),
        "min": float(arr.min()),
        "max": float(arr.max()),
    }
    out.update(percentiles(arr))
    return out


def gather_f64_rows(row: Sequence[float], group=None) -> np.ndarray:
    """Every rank's ``row`` of float64 values, ``[world, len(row)]``, by
    one ``all_gather`` over ``group`` (None: the default group) — on the
    card under NCCL, in host memory under gloo.  float64 travels exactly,
    so step counters and checksums compare bit for bit."""
    t = torch.tensor(list(row), dtype=torch.float64)
    if dist.get_backend(group) == "nccl":
        t = t.to("cuda", torch.cuda.current_device())
    parts = [torch.empty_like(t)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts).cpu().numpy()


def cross_host_step_stats(
    local_times: Sequence[float],
    straggler_factor: float = 1.5,
    event_log=None,
) -> Dict[str, Any]:
    """Every process's step-time view (JAX :53): per process (min, mean,
    max) through one gather over the default ``torch.distributed`` group
    when one is initialised, plus straggler detection.  A process whose
    mean exceeds ``straggler_factor`` x the median of the means is the
    straggler, and a ``straggler`` event lands on ``event_log`` (or the
    process default).  Without a group it takes the collective-free
    single-process path; with one, every process must call it."""
    local = step_time_stats(local_times)
    row = [local.get("mean", 0.0), local.get("min", 0.0),
           local.get("max", 0.0)]
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        gathered = gather_f64_rows(row)
    else:
        gathered = np.asarray([row], np.float64)
    per_host = [{"process": i, "mean": float(g[0]), "min": float(g[1]),
                 "max": float(g[2])} for i, g in enumerate(gathered)]

    means = np.asarray([h["mean"] for h in per_host])
    med = float(np.median(means)) if means.size else 0.0
    straggler: Optional[int] = None
    ratio = 1.0
    if med > 0 and means.size > 1:
        worst = int(np.argmax(means))
        ratio = float(means[worst] / med)
        if ratio > straggler_factor:
            straggler = worst
    out = {
        "n_hosts": len(per_host),
        "per_host": per_host,
        "mean": float(means.mean()) if means.size else 0.0,
        "min": float(min((h["min"] for h in per_host), default=0.0)),
        "max": float(max((h["max"] for h in per_host), default=0.0)),
        "straggler": straggler,
        "straggler_ratio": round(ratio, 4),
    }
    if straggler is not None:
        from .events import default_event_log

        (event_log or default_event_log()).emit(
            "straggler",
            host=straggler,
            ratio=round(ratio, 4),
            mean_s=per_host[straggler]["mean"],
            median_s=med,
        )
    return out


def pipeline_bubble_fraction(
    num_microbatches: int,
    pipe_size: int,
    num_chunks: int = 1,
    schedule: str = "1f1b",
) -> float:
    """Fraction of schedule slot executions a stage spends idle (JAX :135),
    from the schedules' tick counts: ``'forward'`` ``(P-1)/(M+P-1)``;
    ``'1f1b'`` ``(PV + P - 2)/(VM + PV + P - 2)``; ``'zb'`` (V 1 only)
    ``4(P-1)/(3M + 4(P-1))``."""
    M, P_, V = int(num_microbatches), int(pipe_size), int(num_chunks)
    if M < 1 or P_ < 1 or V < 1:
        raise ValueError(f"bad schedule shape M={M} P={P_} V={V}")
    if schedule == "forward":
        return (P_ - 1) / (M + P_ - 1)
    if schedule == "1f1b":
        ticks = V * M + P_ * V + P_ - 2
        return (P_ * V + P_ - 2) / ticks
    if schedule == "zb":
        if V != 1:
            raise ValueError("the zb schedule has no interleaved variant")
        return (4 * (P_ - 1)) / (3 * M + 4 * (P_ - 1))
    raise ValueError(f"unknown schedule {schedule!r}")


def pipeline_time_inflation(
    num_microbatches: int,
    pipe_size: int,
    schedule: str = "1f1b",
) -> float:
    """Modeled wall-clock multiplier of a pipelined step over the ideal
    bubble-free one (JAX :174), in forward units (fwd = dgrad = wgrad =
    recompute = 1): ``'1f1b'`` ``(M + 2(P-1))/M``; ``'zb'`` ``(5M +
    6(P-1))/(4M)``."""
    M, P_ = int(num_microbatches), int(pipe_size)
    if M < 1 or P_ < 1:
        raise ValueError(f"bad schedule shape M={M} P={P_}")
    if schedule == "1f1b":
        return (M + 2 * (P_ - 1)) / M
    if schedule == "zb":
        return (5 * M + 6 * (P_ - 1)) / (4 * M)
    raise ValueError(f"unknown schedule {schedule!r}")


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
