"""The shared comm record — the part of
``torchdistpackage_tpu/obs/comm_ledger.py`` the port uses:
:func:`comm_record`, the one shape of every comm measurement
(``dist.comm_bench`` emits it per (op, size) cell,
``obs.comm_model.CommModel.calibrate`` fits from it).  The reference's
ledger, parsed from a compiled step's HLO, has no counterpart here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

COMM_RECORD_SCHEMA = "tdp-comm-record/v1"


def comm_record(
    op: str,
    axis: str,
    nbytes: float,
    axis_size: int = 0,
    time_s: Optional[float] = None,
    algbw_GBps: Optional[float] = None,
    busbw_GBps: Optional[float] = None,
    **extra: Any,
) -> Dict[str, Any]:
    """The shared comm record: ``{type, schema, op, axis, axis_size,
    bytes, ...}``.  ``op`` in comm_bench's underscore spelling
    (``all_reduce``); ``axis`` the axis name (several joined with '+').
    The measurement fields are optional (an annotation has bytes but no
    time)."""
    rec: Dict[str, Any] = {
        "type": "comm",
        "schema": COMM_RECORD_SCHEMA,
        "op": str(op),
        "axis": str(axis),
        "axis_size": int(axis_size),
        "bytes": int(nbytes),
    }
    if time_s is not None:
        rec["time_s"] = float(time_s)
    if algbw_GBps is not None:
        rec["algbw_GBps"] = float(algbw_GBps)
    if busbw_GBps is not None:
        rec["busbw_GBps"] = float(busbw_GBps)
    rec.update(extra)
    return rec
