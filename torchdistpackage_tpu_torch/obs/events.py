"""Append-only structured event log — the minimum of
``torchdistpackage_tpu/obs/events.py`` that the serving engine's timeline
needs: :class:`EventLog` (``emit``, ``as_list``) and the
process-wide :func:`default_event_log`.  File sinks, tagging and the
event-kind registry are not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import collections
import datetime
import time
from typing import Any, Dict, Optional


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
