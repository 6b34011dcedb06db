"""Run-parity — the port's ``torchdistpackage_tpu/obs/parity.py``:
compare two runs' record streams into an ``exact | bounded | diverged``
verdict.

- :func:`stream_of` — a ``{step: value}`` scalar stream from a list of
  step records (a ``JsonlSink`` file, ``Telemetry.history``) or from a
  RUNREPORT's ``numerics.timeline``.
- :func:`compare_streams` — per-step deltas over the common steps, a
  downsampled drift curve, and the verdict: ``exact`` (bitwise-equal),
  ``bounded`` (every delta inside ``atol + rtol * |ref|``), ``diverged``
  (a delta escapes the band, or non-finiteness on one side only).
- :func:`param_divergence` — per-leaf L2 distance between two final
  parameter trees (nested dicts and lists of tensors or arrays).
- :func:`parity_section` — the comparisons rolled into the RUNREPORT
  ``numerics.parity`` sub-section (``Telemetry.record_parity``).

``tools/parity_diff.py`` is the command line over the same functions.
Only :func:`param_divergence` touches tensors (torch imported there), so
the tool runs over artifacts on disk without a card.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

PARITY_SCHEMA = "tdp-parity/v1"

#: The A/B verdict vocabulary (RUNREPORT ``numerics.parity.verdict``).
PARITY_VERDICTS = ("exact", "bounded", "diverged", "unknown")


def stream_of(source: Any, key: str = "loss") -> Dict[int, float]:
    """``{step: value}`` from a records list or a RUNREPORT dict.

    - a list of dicts: every ``type == "step"`` record carrying ``key``
      (non-step records — events, comm records — are skipped);
    - a RUNREPORT dict: the ``numerics.timeline`` entries carrying
      ``key`` (the per-step stream the report retains).
    """
    if isinstance(source, dict):
        records = (source.get("numerics") or {}).get("timeline") or []
    else:
        records = [r for r in source
                   if isinstance(r, dict) and r.get("type", "step") == "step"]
    out: Dict[int, float] = {}
    for r in records:
        if not isinstance(r, dict) or "step" not in r:
            continue
        v = r.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[int(r["step"])] = float(v)
    return out


def compare_streams(
    a: Dict[int, float],
    b: Dict[int, float],
    key: str = "loss",
    rtol: float = 0.05,
    atol: float = 1e-9,
) -> Dict[str, Any]:
    """Per-step comparison of two scalar streams over their common steps.

    The bound is elementwise ``|a - b| <= atol + rtol * max(|a|, |b|)``
    (allclose semantics, symmetric in the arms).  Non-finite on BOTH
    sides at a step counts as agreement (both runs blew up identically);
    one-sided non-finiteness is divergence regardless of tolerance.
    """
    steps = sorted(set(a) & set(b))
    cmp: Dict[str, Any] = {
        "key": key, "rtol": rtol, "atol": atol,
        "n_a": len(a), "n_b": len(b), "n_common": len(steps),
    }
    if not steps:
        cmp.update(verdict="unknown", max_abs_delta=None, max_rel_delta=None)
        return cmp
    deltas: List[Tuple[int, float, float]] = []  # (step, abs delta, rel)
    n_mismatch = 0
    first_mismatch = None
    one_sided_nonfinite = False
    for s in steps:
        va, vb = a[s], b[s]
        fa, fb = math.isfinite(va), math.isfinite(vb)
        if not fa or not fb:
            if fa != fb:
                one_sided_nonfinite = True
                n_mismatch += 1
                if first_mismatch is None:
                    first_mismatch = s
                deltas.append((s, math.inf, math.inf))
            else:
                deltas.append((s, 0.0, 0.0))
            continue
        d = abs(va - vb)
        ref = max(abs(va), abs(vb))
        rel = d / ref if ref > 0 else (0.0 if d == 0 else math.inf)
        deltas.append((s, d, rel))
        if d > atol + rtol * ref:
            n_mismatch += 1
            if first_mismatch is None:
                first_mismatch = s
    finite_d = [d for _, d, _ in deltas if math.isfinite(d)]
    finite_r = [r for _, _, r in deltas if math.isfinite(r)]
    cmp["max_abs_delta"] = max(finite_d) if finite_d else math.inf
    cmp["mean_abs_delta"] = (
        sum(finite_d) / len(finite_d) if finite_d else math.inf)
    cmp["max_rel_delta"] = max(finite_r) if finite_r else math.inf
    cmp["n_mismatch"] = n_mismatch
    cmp["first_mismatch_step"] = first_mismatch
    stride = max(1, len(deltas) // 64)
    cmp["drift_curve"] = [
        {"step": s, "delta": d if math.isfinite(d) else None,
         "rel": r if math.isfinite(r) else None}
        for s, d, r in deltas[::stride]]
    if one_sided_nonfinite or n_mismatch:
        cmp["verdict"] = "diverged"
    elif all(d == 0.0 for _, d, _ in deltas):
        cmp["verdict"] = "exact"
    else:
        cmp["verdict"] = "bounded"
    return cmp


def _leaves_with_paths(tree: Any, prefix: str = ""
                       ) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of a nested dict / list / tuple tree in the
    reference's flatten order (dict keys sorted) and its path spelling
    (``['blocks']['attn']['wqkv']``, ``[0]``)."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k in sorted(tree):
            out.extend(_leaves_with_paths(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_leaves_with_paths(v, f"{prefix}[{i}]"))
        return out
    return [(prefix, tree)]


def _host_f64(leaf: Any):
    import numpy as np

    try:
        import torch
    except ImportError:  # the tool over artifacts needs no torch
        torch = None
    if torch is not None and isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", torch.float64).numpy()
    return np.asarray(leaf, dtype=np.float64)


def param_divergence(params_a: Any, params_b: Any) -> Dict[str, Any]:
    """Per-leaf L2 distance between two (same-structure) parameter trees
    of tensors or arrays, fetched to the host.  Returns ``{per_leaf:
    [{path, norm_a, norm_b, diff_norm, rel}], global: {diff_norm, rel}}``
    sorted by descending relative drift, so the first row answers "which
    layer moved"."""
    import numpy as np

    flat_a = _leaves_with_paths(params_a)
    flat_b = _leaves_with_paths(params_b)
    if len(flat_a) != len(flat_b):
        raise ValueError(
            f"param trees differ in structure: {len(flat_a)} vs "
            f"{len(flat_b)} leaves")
    rows: List[Dict[str, Any]] = []
    sq_diff = sq_a = 0.0
    for (path, la), (_, lb) in zip(flat_a, flat_b):
        xa, xb = _host_f64(la), _host_f64(lb)
        na = float(np.linalg.norm(xa))
        nb = float(np.linalg.norm(xb))
        nd = float(np.linalg.norm(xa - xb))
        sq_diff += nd * nd
        sq_a += na * na
        rows.append({
            "path": path,
            "norm_a": na, "norm_b": nb, "diff_norm": nd,
            "rel": nd / na if na > 0 else (0.0 if nd == 0 else math.inf),
        })
    rows.sort(key=lambda r: -r["rel"])
    g = math.sqrt(sq_diff)
    ga = math.sqrt(sq_a)
    return {
        "per_leaf": rows,
        "global": {
            "diff_norm": g,
            "rel": g / ga if ga > 0 else (0.0 if g == 0 else math.inf),
        },
    }


def parity_section(
    streams: Sequence[Dict[str, Any]] = (),
    params: Optional[Dict[str, Any]] = None,
    labels: Tuple[str, str] = ("a", "b"),
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Roll stream comparisons (+ optional :func:`param_divergence`) into
    the RUNREPORT ``numerics.parity`` sub-section.  The section verdict is
    the WORST stream verdict (diverged > bounded > exact > unknown with
    unknown only when nothing compared)."""
    order = {"diverged": 3, "bounded": 2, "exact": 1, "unknown": 0}
    worst = "unknown"
    for c in streams:
        v = c.get("verdict", "unknown")
        if order.get(v, 0) > order.get(worst, 0):
            worst = v
    section: Dict[str, Any] = {
        "schema": PARITY_SCHEMA,
        "labels": list(labels),
        "verdict": worst,
        "streams": [dict(c) for c in streams],
    }
    if params is not None:
        section["params"] = {
            "global": dict(params.get("global", {})),
            # the artifact keeps the 8 worst leaves; the full table is a
            # tool-side (parity_diff) rendering concern
            "per_leaf": [dict(r) for r in params.get("per_leaf", [])[:8]],
            "n_leaves": len(params.get("per_leaf", [])),
        }
    if extra:
        section.update(extra)
    return section
