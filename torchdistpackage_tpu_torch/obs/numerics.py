"""Training numerics — the port's counterpart of
``torchdistpackage_tpu/obs/numerics.py``: the global gradient norm, the
host-side threshold checks Telemetry runs on every step record
(:data:`DEFAULT_THRESHOLDS`, :func:`check_alerts`) and the RUNREPORT
``numerics`` section (:func:`numerics_report`).  The in-step
``numerics_stats`` and the HLO dtype ledger have no counterpart yet, so
the section's ``dtype_ledgers`` is ``[]``."""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

import torch

from ..tools.surgery import is_int8_weight

NUMERICS_SCHEMA = "tdp-numerics/v1"

# Alert thresholds (JAX :56; Telemetry accepts overrides).  The bands are
# loose on purpose: an alert should mean "look at this run".
DEFAULT_THRESHOLDS: Dict[str, float] = {
    # global grad-norm explosion / vanishing (absolute, post-reduction)
    "grad_norm_explode": 1.0e3,
    "grad_norm_vanish": 1.0e-7,
    # |update| / |param| out of band: >1e-1 means steps rewrite the net,
    # <1e-6 means the optimizer is effectively frozen
    "update_ratio_high": 1.0e-1,
    "update_ratio_low": 1.0e-6,
}


def tree_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict / list / tuple tree, in insertion
    order; an int8 weight node (``tools.surgery.QuantizedLinear``) gives
    its two tensors."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif is_int8_weight(tree):
        yield tree.q
        yield tree.scale
    elif tree is not None:
        yield tree


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor of ``tree`` (int8 weights and their scales
    counted as stored)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def global_grad_norm(tree: Any) -> torch.Tensor:
    """Global L2 norm of every leaf of ``tree``: the square root of the sum
    of each leaf's f32 sum of squares, as the reference computes it.  A
    0-dim f32 tensor on the leaves' device (no host sync)."""
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    if not sq:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(torch.stack(sq).sum())


def check_alerts(
    rec: Dict[str, Any], thresholds: Optional[Dict[str, float]] = None
) -> List[Dict[str, Any]]:
    """Threshold checks over one HOST-side step record (floats, as built
    by ``Telemetry.end_step``).  Returns ``[{reason, value, threshold}]``
    — empty when healthy.  Reasons: ``nonfinite_loss``,
    ``nonfinite_grads``, ``grad_explosion``, ``grad_vanishing``,
    ``update_ratio_high``, ``update_ratio_low``."""
    th = dict(DEFAULT_THRESHOLDS)
    if thresholds:
        th.update(thresholds)
    alerts: List[Dict[str, Any]] = []

    def add(reason, value, threshold=None):
        alerts.append({
            "reason": reason, "value": value, "threshold": threshold})

    loss = rec.get("loss")
    if isinstance(loss, (int, float)) and not math.isfinite(loss):
        add("nonfinite_loss", loss)
    nf = rec.get("nonfinite_grads")
    if isinstance(nf, (int, float)) and nf > 0:
        add("nonfinite_grads", nf)
    gn = rec.get("grad_norm")
    if isinstance(gn, (int, float)):
        if not math.isfinite(gn):
            if not any(a["reason"] == "nonfinite_grads" for a in alerts):
                add("nonfinite_grads", gn)
        elif gn >= th["grad_norm_explode"]:
            add("grad_explosion", gn, th["grad_norm_explode"])
        elif 0.0 < gn <= th["grad_norm_vanish"]:
            add("grad_vanishing", gn, th["grad_norm_vanish"])
    ur = rec.get("update_ratio")
    if isinstance(ur, (int, float)) and math.isfinite(ur):
        if ur >= th["update_ratio_high"]:
            add("update_ratio_high", ur, th["update_ratio_high"])
        elif 0.0 < ur <= th["update_ratio_low"]:
            add("update_ratio_low", ur, th["update_ratio_low"])
    return alerts


def numerics_report(
    timeline: Sequence[Dict[str, Any]] = (),
    dtype_ledgers: Sequence[Optional[Dict[str, Any]]] = (),
    events: Iterable[Dict[str, Any]] = (),
    parity: Optional[Dict[str, Any]] = None,
    thresholds: Optional[Dict[str, float]] = None,
) -> Dict[str, Any]:
    """The RUNREPORT ``numerics`` section: timeline summary + alert roll-up
    + dtype ledger(s) (+ the optional A/B :mod:`.parity` verdict)."""
    tl = [dict(t) for t in timeline]
    summary: Dict[str, Any] = {"steps": len(tl)}
    gns = [t["grad_norm"] for t in tl
           if isinstance(t.get("grad_norm"), (int, float))
           and math.isfinite(t["grad_norm"])]
    if gns:
        summary["grad_norm_final"] = gns[-1]
        summary["grad_norm_mean"] = float(np.mean(gns))
        summary["grad_norm_max"] = float(np.max(gns))
    urs = [t["update_ratio"] for t in tl
           if isinstance(t.get("update_ratio"), (int, float))
           and math.isfinite(t["update_ratio"])]
    if urs:
        summary["update_ratio_final"] = urs[-1]
        summary["update_ratio_mean"] = float(np.mean(urs))
    summary["nonfinite_steps"] = sum(
        1 for t in tl if t.get("nonfinite_grads"))

    alert_events = [e for e in events if e.get("kind") == "numerics_alert"]
    by_reason: Dict[str, int] = {}
    for e in alert_events:
        by_reason[str(e.get("reason"))] = by_reason.get(
            str(e.get("reason")), 0) + 1
    alerts: Dict[str, Any] = {"count": len(alert_events),
                              "by_reason": by_reason}
    if alert_events:
        first = alert_events[0]
        alerts["first"] = {
            "step": first.get("step"), "reason": first.get("reason"),
            "value": first.get("value")}

    stride = max(1, len(tl) // 64)
    section: Dict[str, Any] = {
        "schema": NUMERICS_SCHEMA,
        "summary": summary,
        "alerts": alerts,
        "timeline": tl[::stride],
        "dtype_ledgers": [
            {k: v for k, v in d.items() if k != "schema"}
            for d in dtype_ledgers if d],
        "thresholds": dict(DEFAULT_THRESHOLDS, **(thresholds or {})),
    }
    if parity is not None:
        section["parity"] = dict(parity)
    return section
