"""Append-only structured event log — the minimum of
``torchdistpackage_tpu/obs/events.py`` that the serving engine's timeline
needs: :class:`EventLog` (``emit``, ``as_list``), the process-wide
:func:`default_event_log`, and :data:`EVENT_KINDS`, the part of the
reference's kind registry that the port emits.  File sinks and tagging
are not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import collections
import datetime
import time
from typing import Any, Dict, FrozenSet, Optional

#: The event kinds the port emits (a subset of the reference's registry,
#: same names and meaning); a new emitter adds its kind here.
EVENT_KINDS: FrozenSet[str] = frozenset({
    # serving: the request lifecycle and the engine's audit
    "request_submitted", "request_admitted", "prefill_chunk",
    "request_retired", "request_cancelled", "engine_fault_detected",
    "engine_recovered",
    # serving under stress: shedding, expiry, preemption, drain / resume
    "request_shed", "request_expired", "request_preempted",
    "engine_drained", "request_resumed",
    # the prefix cache
    "prefix_hit", "block_cow", "cache_evict",
    # slot migration between engines
    "request_exported", "request_imported", "import_aborted",
    # speculative decoding and the CP prefill ring
    "spec_draft", "spec_verify", "cp_prefill_chunk", "cp_ring_hop",
    # training: a dynamic loss scale changed (parallel.clip)
    "loss_scale",
    # a termination signal arrived (utils/preemption.GracefulShutdown)
    "preemption",
    # MoE: which dispatch 'auto' resolved to, and the host-side
    # capacity-overflow alarm (dropped-token rate over threshold)
    "moe_dispatch_selected", "expert_overflow",
})


def _process_index() -> int:
    """The torch.distributed rank when a process group is up, else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


class EventLog:
    """In-memory event log holding the newest 4096 events."""

    def __init__(self) -> None:
        self.events: collections.deque = collections.deque(maxlen=4096)

    def emit(self, kind: str, **fields: Any) -> Dict[str, Any]:
        """Record one event; returns the record."""
        rec: Dict[str, Any] = {
            "type": "event",
            "kind": str(kind),
            "t_wall": datetime.datetime.now().timestamp(),
            "t_mono": time.perf_counter(),
            "process": _process_index(),
        }
        rec.update(fields)
        self.events.append(rec)
        return rec

    def as_list(self):
        return list(self.events)


_default_log: Optional[EventLog] = None


def default_event_log() -> EventLog:
    """The process-wide event log (created in memory on first use)."""
    global _default_log
    if _default_log is None:
        _default_log = EventLog()
    return _default_log
