"""Memory observability — the runtime half of
``torchdistpackage_tpu/obs/mem_ledger.py``: the port's one
``torch.cuda.memory_stats`` reader (:func:`live_memory`), the card's
capacity (:func:`device_capacity`), the ``ok | tight | oom_risk |
unknown`` headroom verdict (:func:`headroom_verdict`) and the RUNREPORT
``memory`` section (:func:`mem_report`).

The reference's static ledger (``static_ledger`` / ``ledger_from_compiled``
over XLA's ``memory_analysis()`` of a compiled program) has no
counterpart: the port runs eagerly and compiles no program, so the
section's ``programs`` is ``[]`` and its verdict rests on the measured
peak alone.  On the CPU nothing is reported (``reported`` False) and
the verdict is ``unknown``, as on the reference's CPU sim.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

#: The memory headroom verdicts (RUNREPORT ``memory.verdict``).
#: ``unknown`` = no capacity to judge against (the CPU reports nothing).
MEM_VERDICTS = ("ok", "tight", "oom_risk", "unknown")

# Peak-vs-capacity thresholds (JAX's): below TIGHT_FRAC the config has
# real headroom; past OOM_RISK_FRAC one allocator hiccup plausibly OOMs.
TIGHT_FRAC = 0.80
OOM_RISK_FRAC = 0.95


def _cuda_devices(device: Any = None) -> List[torch.device]:
    """The CUDA devices to read: ``device`` when it is one, every visible
    card when it is None, none for a CPU device or without a card."""
    if not torch.cuda.is_available():
        return []
    if device is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    dev = torch.device(device)
    if dev.type != "cuda":
        return []
    return [torch.device("cuda", dev.index if dev.index is not None
                         else torch.cuda.current_device())]


def device_capacity(device: Any = None) -> Optional[int]:
    """A card's memory in bytes (``get_device_properties().total_memory``
    of ``device``, or of the first card); None without one (JAX :112)."""
    devs = _cuda_devices(device)
    if not devs:
        return None
    return int(torch.cuda.get_device_properties(devs[0]).total_memory)


def live_memory(device: Any = None) -> Dict[str, Any]:
    """The port's one ``torch.cuda.memory_stats`` reader (JAX :63): the
    caching allocator's live and peak allocated bytes and its reserved
    bytes per card, plus their sums.

    Returns ``{reported, live_bytes, peak_bytes, reserved_bytes,
    limit_bytes, peak_frac, per_device}`` — ``limit_bytes`` the cards'
    capacity and ``peak_frac`` the largest per-card ``peak / capacity``
    (an OOM happens on one card).  ``reported`` is False, and the bytes
    0, on the CPU or without a card.  ``device`` picks one card; None
    reads every visible card."""
    per_device: List[Dict[str, Any]] = []
    live = peak = reserved = limit = 0
    peak_frac = 0.0
    for d in _cuda_devices(device):
        ms = torch.cuda.memory_stats(d)
        row = {
            "device": str(d),
            "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
            "reserved_bytes": int(ms.get("reserved_bytes.all.current", 0)),
            "bytes_limit": device_capacity(d),
        }
        per_device.append(row)
        live += row["bytes_in_use"]
        peak += row["peak_bytes_in_use"]
        reserved += row["reserved_bytes"]
        limit += row["bytes_limit"]
        if row["bytes_limit"] > 0:
            peak_frac = max(
                peak_frac, row["peak_bytes_in_use"] / row["bytes_limit"])
    return {
        "reported": bool(per_device),
        "live_bytes": live,
        "peak_bytes": peak,
        "reserved_bytes": reserved,
        "limit_bytes": limit,
        "peak_frac": peak_frac if per_device else None,
        "per_device": per_device,
    }


def headroom_verdict(
    peak_bytes: Optional[float], capacity_bytes: Optional[float]
) -> Dict[str, Any]:
    """``{verdict, frac, headroom_frac}`` for a peak against a capacity.

    ``frac`` = peak/capacity; verdict thresholds: ``ok`` below
    :data:`TIGHT_FRAC`, ``tight`` up to :data:`OOM_RISK_FRAC`,
    ``oom_risk`` past it (or peak > capacity outright); ``unknown`` when
    either side is missing/non-positive."""
    if not peak_bytes or not capacity_bytes or capacity_bytes <= 0:
        return {"verdict": "unknown", "frac": None, "headroom_frac": None}
    frac = float(peak_bytes) / float(capacity_bytes)
    if frac >= OOM_RISK_FRAC:
        verdict = "oom_risk"
    elif frac >= TIGHT_FRAC:
        verdict = "tight"
    else:
        verdict = "ok"
    return {
        "verdict": verdict,
        "frac": round(frac, 4),
        "headroom_frac": round(1.0 - frac, 4),
    }


def mem_report(
    programs: Sequence[Optional[Dict[str, Any]]] = (),
    measured_peak_bytes: Optional[int] = None,
    measured_peak_frac: Optional[float] = None,
    capacity_bytes: Optional[int] = None,
    timeline: Optional[Sequence[Dict[str, Any]]] = None,
    kv_pool: Optional[Dict[str, Any]] = None,
    emit: bool = True,
) -> Dict[str, Any]:
    """The RUNREPORT ``memory`` section (JAX :261).

    - ``programs`` — per-program static ledgers; the port passes none
      (it compiles no program), so the modeled peak is None.
    - verdict: the measured per-card peak (``measured_peak_frac``, see
      :func:`live_memory`) or peak bytes against ``capacity_bytes``;
      ``unknown`` without a capacity.
    - ``kv_pool`` — the serving cross-check: the engine's expected pool
      bytes (shape math) against the buffer it holds
      (``paged_cache.pool_bytes``); a mismatch is flagged, not hidden.
    - ``emit`` — an ``oom_risk`` verdict lands on the default event log.
    """
    progs = [p for p in programs if p]
    modeled_peak = max(
        (p["peak_estimate_bytes"] for p in progs), default=None)
    if measured_peak_frac is not None:
        meas = headroom_verdict(measured_peak_frac, 1.0)
        basis = "measured per-device peak vs device capacity"
    else:
        meas = headroom_verdict(measured_peak_bytes, capacity_bytes)
        basis = "measured peak vs capacity"
    model = headroom_verdict(modeled_peak, capacity_bytes)
    if meas["verdict"] != "unknown":
        verdict, frac, basis = meas["verdict"], meas["frac"], basis
    elif model["verdict"] != "unknown":
        verdict, frac = model["verdict"], model["frac"]
        basis = "modeled (static ledger) peak vs capacity"
    else:
        verdict, frac, basis = "unknown", None, "no device capacity reported"
    section: Dict[str, Any] = {
        "programs": [
            {k: v for k, v in p.items() if k != "schema"} for p in progs],
        "modeled_peak_bytes": modeled_peak,
        "measured_peak_bytes": measured_peak_bytes,
        "capacity_bytes": capacity_bytes,
        "peak_frac": frac,
        "headroom_frac": (
            round(1.0 - frac, 4) if isinstance(frac, (int, float)) else None),
        "verdict": verdict,
        "verdict_basis": basis,
    }
    if timeline:
        # downsampled to <= 64 points like the throughput trajectory
        tl = list(timeline)
        stride = max(1, len(tl) // 64)
        section["timeline"] = tl[::stride]
    if kv_pool is not None:
        expected = kv_pool.get("pool_bytes_expected")
        actual = kv_pool.get("pool_bytes")
        section["kv_pool"] = {
            **kv_pool,
            "accounting_match": (
                expected == actual
                if (expected is not None and actual is not None) else None),
        }
    if emit and verdict == "oom_risk":
        from .events import emit_event

        emit_event(
            "oom_risk", peak_frac=frac, basis=basis,
            modeled_peak_bytes=modeled_peak,
            measured_peak_bytes=measured_peak_bytes)
    return section
