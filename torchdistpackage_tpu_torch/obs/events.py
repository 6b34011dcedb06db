"""Append-only structured event log — the port's
``torchdistpackage_tpu/obs/events.py``: :class:`EventLog` (``emit``,
``of_kind``, ``as_list``; a JSONL file by ``path=`` or any ``sink``), the
replica tagging a fleet puts on a shared timeline
(:class:`TaggedEventLog`, :func:`tag_events`), the process-wide default
log (:func:`default_event_log`, :func:`set_default_event_log`,
:func:`emit_event`) and :data:`EVENT_KINDS`, the part of the reference's
kind registry that the port emits (same names and meaning).  A ``sink``
is any object with a ``write(record)`` method
(:class:`~.exporters.JsonlSink` and friends).
"""

from __future__ import annotations

import collections
import datetime
import time
from typing import Any, Dict, FrozenSet, Optional

#: The event kinds the port emits (a subset of the reference's registry,
#: same names and meaning); a new emitter adds its kind here.
EVENT_KINDS: FrozenSet[str] = frozenset({
    # a telemetry run: its bounds, each wrapped step's first call
    # of a signature (compile) and a later new signature (recompile)
    "run_start", "run_end", "compile", "recompile",
    # memory samples and the OOM-risk line (obs.mem_ledger + Telemetry)
    "mem_snapshot", "oom_risk",
    # host step times across processes (obs.aggregate) and the numerics
    # thresholds Telemetry.end_step checks
    "straggler", "numerics_alert",
    # the watchdog's heartbeat-gap escalation and the cross-process
    # consistency check (resilience.watchdog)
    "hang_suspected", "hang_resolved", "hang_abort", "desync_detected",
    # serving observability: one engine tick's accounting (with the
    # per-rid attribution the request trace is assembled from) and the
    # periodic occupancy sample
    "engine_tick", "slots_snapshot",
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
    # the collectives: grad_compress='auto''s per-leaf choices, and the
    # overlap regime dist.overlap.configure set
    "compress_policy", "overlap_configure",
    # the chaos harness fired a declared fault (resilience.chaos), and
    # a retry of with_retries with no caller hook (resilience.ckpt_guard)
    "fault_injected", "ckpt_retry",
    # the router: placements, moves, degradation and KV migration
    "request_routed", "request_migrated", "replica_degraded",
    "blocks_migrated",
    # the router's decision ledger and its rotation switch
    "route_decision", "handoff_decision", "rebalance_decision",
    "replica_up", "replica_down",
    # the elastic fleet: every autoscaler evaluation, the migration
    # wire's re-requests, and a dead transfer's re-prefill fallback
    "scale_decision", "migration_retry", "migration_fallback",
    # a long document's prefill -> decode handoff (the CP prefill tier)
    "kv_handoff_long",
})


def _process_index() -> int:
    """The torch.distributed rank when a process group is up, else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


class EventLog:
    """In-memory event log holding the newest ``history_max`` events.
    ``path``: an append-mode JSONL file (a :class:`~.exporters.JsonlSink`);
    ``sink``: any object with ``write(record)``, used instead of ``path``.
    Either is handed every record of process 0."""

    def __init__(self, path: Optional[str] = None, sink: Any = None,
                 history_max: int = 4096) -> None:
        if path is not None and sink is None:
            from .exporters import JsonlSink

            sink = JsonlSink(path)
        self._sink = sink
        self.events: collections.deque = collections.deque(
            maxlen=history_max)

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
        if self._sink is not None and rec["process"] == 0:
            try:
                self._sink.write(rec)
            except OSError:
                pass  # a full disk: keep the in-memory log
        return rec

    def of_kind(self, kind: str):
        return [e for e in self.events if e["kind"] == kind]

    def as_list(self):
        return list(self.events)


class TaggedEventLog:
    """A view of an :class:`EventLog` that stamps fixed fields on every
    emit (JAX :403): how a fleet gives each replica's engine an identity
    on a shared timeline.  Everything but ``emit`` forwards to the
    wrapped log, and a field given to an emit wins over the tag."""

    def __init__(self, inner: EventLog, tags: Dict[str, Any]) -> None:
        self.inner = inner
        self.tags = dict(tags)

    def emit(self, kind: str, **fields: Any) -> Dict[str, Any]:
        return self.inner.emit(kind, **{**self.tags, **fields})

    def __getattr__(self, name: str) -> Any:
        return getattr(self.inner, name)


def tag_events(log: Any, **tags: Any) -> TaggedEventLog:
    """Wrap ``log`` so every emit carries ``tags``; re-tagging a tagged
    log replaces its tags instead of stacking views (JAX :426)."""
    while isinstance(log, TaggedEventLog):
        log = log.inner
    return TaggedEventLog(log, tags)


_default_log: Optional[EventLog] = None


def default_event_log() -> EventLog:
    """The process-wide event log (created in memory on first use)."""
    global _default_log
    if _default_log is None:
        _default_log = EventLog()
    return _default_log


def set_default_event_log(log: Optional[EventLog]) -> None:
    """Install (or with None: reset) the process-wide default log."""
    global _default_log
    _default_log = log


def emit_event(kind: str, **fields: Any) -> Dict[str, Any]:
    """Emit on the process-wide default log."""
    return default_event_log().emit(kind, **fields)
