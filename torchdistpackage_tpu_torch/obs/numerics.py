"""Training numerics — the port's counterpart of
``torchdistpackage_tpu/obs/numerics.py``: the global gradient norm, the
in-step training-dynamics stats (:func:`numerics_stats`, what
``make_train_step(numerics=True)`` returns), the host-side threshold
checks Telemetry runs on every step record (:data:`DEFAULT_THRESHOLDS`,
:func:`check_alerts`) and the RUNREPORT ``numerics`` section
(:func:`numerics_report`).  The HLO dtype ledger has no counterpart (the
port compiles no program), so the section's ``dtype_ledgers`` is
``[]``."""

from __future__ import annotations

import math
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

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

# Low-precision range constants (JAX :66): bf16 shares f32's exponent
# range, so its underflow line is the f32 smallest normal; f16's max is
# 65504.
BF16_TINY = 1.17549435e-38
F16_MAX = 65504.0


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


def tree_paths(tree: Any, path: Tuple = ()
               ) -> Iterator[Tuple[Tuple, torch.Tensor]]:
    """``(path, tensor)`` for every tensor of ``tree``, in
    :func:`tree_leaves` order: a path is the tuple of dict keys and list
    indices down to the leaf (an int8 weight node's two tensors end in
    ``'q'`` / ``'scale'``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, path + (i,))
    elif is_int8_weight(tree):
        yield path + ("q",), tree.q
        yield path + ("scale",), tree.scale
    elif tree is not None:
        yield path, tree


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


# ------------------------------------------------------------- step stats


def default_group_fn(path: Sequence) -> str:
    """Leaf path -> layer-group name (JAX :125): the first path component,
    plus the index when the model is a list of blocks (``blocks/0``) —
    a handful of scalars that still say WHICH layer's gradients died."""
    parts = [str(p) for p in path]
    if not parts:
        return "params"
    if len(parts) >= 2 and parts[1].isdigit():
        return f"{parts[0]}/{parts[1]}"
    return parts[0]


def _leaf_groups(groups: Optional[Sequence[Tuple[Any, ...]]], n: int
                 ) -> Optional[List[Tuple[Any, ...]]]:
    if groups is None:
        return None
    groups = [tuple(g) for g in groups]
    if len(groups) != n:
        raise ValueError(f"{len(groups)} leaf groups for {n} leaves")
    return groups


def _reduced(rows: List[torch.Tensor], groups: Optional[List[Tuple]],
             op=None) -> torch.Tensor:
    """The sum (``op`` None) of per-leaf rows, each leaf's row reduced
    over its tuple of process groups first: the leaves that share a tuple
    are added together, that sum all-reduced over each group in turn, and
    the partial sums added in the order their tuples first appear — the
    grouped reduction of ``parallel/clip.py``'s ``_norms`` (JAX's
    ``_psum_grouped``).  ``op`` MAX: the per-leaf rows are reduced each
    over its own groups and returned stacked (the int8 dead zone's
    ``pmax``)."""
    from ..parallel.tensor_parallel.tp_utils import all_reduce_

    if op is not None:
        out = torch.stack(rows)
        for gs in dict.fromkeys(groups):
            idx = [i for i, g in enumerate(groups) if g == gs]
            part = out[idx].contiguous()
            for g in gs:
                all_reduce_(part, g, op)
            out[idx] = part
        return out
    parts: Dict[Tuple, torch.Tensor] = {}
    for r, gs in zip(rows, groups):
        parts[gs] = r if gs not in parts else parts[gs] + r
    out = torch.zeros_like(rows[0])
    for gs, v in parts.items():
        for g in gs:
            all_reduce_(v, g)
        out = out + v
    return out


def _norm_stats(tree: Any, gf: Callable, groups: Optional[List[Tuple]]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(global norm, {group name: norm}) of ``tree``: each leaf's sum of
    squares formed in f32; whole leaves summed in f32 (the global norm is
    exactly :func:`global_grad_norm`'s), split ones in f64 over their
    groups (exactly ``parallel/clip.py``'s ``_norms``)."""
    pairs = list(tree_paths(tree))
    if not pairs:
        z = torch.zeros((), dtype=torch.float32)
        return z, {}
    sq = [torch.sum(torch.square(t.float())) for _, t in pairs]
    names = [gf(p) for p, _ in pairs]
    order = list(dict.fromkeys(names))
    if groups is None:
        total = torch.sqrt(torch.stack(sq).sum())
        return total, {n: torch.sqrt(torch.stack(
            [s for s, m in zip(sq, names) if m == n]).sum()) for n in order}
    rows = []
    for s, m in zip(sq, names):
        r = torch.zeros(1 + len(order), dtype=torch.float64, device=s.device)
        r[0] = s.double()
        r[1 + order.index(m)] = s.double()
        rows.append(r)
    out = torch.sqrt(_reduced(rows, groups)).float()
    return out[0], {n: out[1 + i] for i, n in enumerate(order)}


def numerics_stats(
    grads: Any,
    params: Any = None,
    updates: Any = None,
    group_fn: Optional[Callable] = None,
    eps: float = 1e-12,
    groups: Optional[Sequence[Tuple[Any, ...]]] = None,
) -> Dict[str, Any]:
    """Training-dynamics stats over one step's (grads, params, updates)
    (JAX :158): trees of tensors of one structure (dicts and lists),
    ``params`` the values before the update.  Returns a dict of 0-dim
    f32 tensors on the leaves' device (nothing is read back):

    - ``grad_norm`` / ``param_norm`` / ``update_norm`` — global L2 norms
      (param / update only when those trees are passed);
    - ``update_ratio`` — ``update_norm / (param_norm + eps)``;
    - ``nonfinite_grads`` — the count of NaN / Inf gradient elements;
    - ``bf16_underflow_frac`` / ``f16_overflow_frac`` / ``int8_zero_frac``
      — the share of gradient elements that are nonzero and below bf16's
      smallest normal, above f16's max, and nonzero inside the dead zone
      of a symmetric int8 quantiser on the leaf's own amax
      (``|g| < amax / 254``);
    - ``groups`` — per layer group (:func:`default_group_fn`, or
      ``group_fn(path)``) the same norms and ratio.

    ``groups``: each leaf's tuple of process groups, in
    :func:`tree_leaves` order (the TP / pipe steps' ``_norm_groups``):
    a split leaf's squares, counts and sizes are summed over its groups
    and its amax is their max, so every rank reports the whole model's
    values (JAX psums over the axes each leaf varies on).  Every rank of
    each group calls it."""
    gf = group_fn or default_group_fn
    grad_leaves = list(tree_leaves(grads))
    lg = _leaf_groups(groups, len(grad_leaves))
    gnorm, gper = _norm_stats(grads, gf, lg)
    out: Dict[str, Any] = {"grad_norm": gnorm}
    per: Dict[str, Dict[str, Any]] = {k: {"grad_norm": v}
                                      for k, v in gper.items()}
    if params is not None:
        out["param_norm"], pper = _norm_stats(params, gf, lg)
        for k, v in pper.items():
            per.setdefault(k, {})["param_norm"] = v
    out["groups"] = per
    out.update(_range_stats(grad_leaves, lg))
    if updates is not None:
        add_update_stats(out, updates, group_fn=gf, eps=eps, groups=groups)
    return out


def add_update_stats(stats: Dict[str, Any], updates: Any,
                     group_fn: Optional[Callable] = None, eps: float = 1e-12,
                     groups: Optional[Sequence[Tuple[Any, ...]]] = None
                     ) -> Dict[str, Any]:
    """``stats`` (from :func:`numerics_stats` without ``updates``) given
    ``update_norm`` and, where ``param_norm`` is there, ``update_ratio``,
    globally and per group.  The in-place train step calls it after the
    optimizer, once the update (``p_after - p_before``) exists, while the
    gradient half was formed before the clip scaled the grads."""
    gf = group_fn or default_group_fn
    lg = _leaf_groups(groups, len(list(tree_leaves(updates))))
    stats["update_norm"], uper = _norm_stats(updates, gf, lg)
    per = stats.setdefault("groups", {})
    for k, v in uper.items():
        per.setdefault(k, {})["update_norm"] = v
    if "param_norm" in stats:
        stats["update_ratio"] = stats["update_norm"] / (
            stats["param_norm"] + eps)
        for g in per.values():
            if "update_norm" in g and "param_norm" in g:
                g["update_ratio"] = g["update_norm"] / (g["param_norm"] + eps)
    return stats


def _range_stats(grads: List[torch.Tensor], groups: Optional[List[Tuple]]
                 ) -> Dict[str, torch.Tensor]:
    """``nonfinite_grads`` and the three low-precision fractions over the
    floating leaves of ``grads`` (JAX :214-240)."""
    idx = [i for i, g in enumerate(grads) if g.is_floating_point()]
    if not idx:
        return {}
    leaves = [grads[i] for i in idx]
    lg = None if groups is None else [groups[i] for i in idx]
    absg = [g.float().abs() for g in leaves]
    amax = [a.max() if a.numel() else a.new_zeros(()) for a in absg]
    if lg is not None:
        amax = list(_reduced(amax, lg, op=_max_op()))
    rows = []
    for g, a, m in zip(leaves, absg, amax):
        nz = a > 0
        rows.append(torch.stack([
            (~torch.isfinite(g)).sum(), (nz & (a < BF16_TINY)).sum(),
            (a > F16_MAX).sum(), (nz & (a < m / 254.0)).sum(),
            torch.tensor(g.numel(), device=g.device)]).double())
    if lg is None:
        tot = torch.stack(rows).sum(0)
    else:
        tot = _reduced(rows, lg)
    tot = tot.float()
    return {"nonfinite_grads": tot[0], "bf16_underflow_frac": tot[1] / tot[4],
            "f16_overflow_frac": tot[2] / tot[4],
            "int8_zero_frac": tot[3] / tot[4]}


def _max_op():
    import torch.distributed as dist

    return dist.ReduceOp.MAX


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
