"""Observability — the minimum the serving engine and the train step
need, the comm record and alpha-beta model the compression policy and
the comm benchmark read, the replica tagging of a fleet's shared
timeline, and the fleet report's validators (``obs.report``)."""

from .aggregate import moe_load_stats, percentiles
from .comm_ledger import comm_record
from .comm_model import (
    AxisCost,
    CommModel,
    compressed_wire_bytes,
    fit_alpha_beta,
)
from .events import (
    EVENT_KINDS,
    EventLog,
    TaggedEventLog,
    default_event_log,
    emit_event,
    set_default_event_log,
    tag_events,
)
from .numerics import global_grad_norm

__all__ = ["AxisCost", "CommModel", "EVENT_KINDS", "EventLog",
           "TaggedEventLog", "comm_record", "compressed_wire_bytes",
           "default_event_log", "emit_event", "fit_alpha_beta",
           "global_grad_norm", "moe_load_stats", "percentiles",
           "set_default_event_log", "tag_events"]
