"""Observability — the minimum the serving engine and the train step
need."""

from .aggregate import moe_load_stats, percentiles
from .events import EVENT_KINDS, EventLog, default_event_log
from .numerics import global_grad_norm

__all__ = ["EVENT_KINDS", "EventLog", "default_event_log",
           "global_grad_norm", "moe_load_stats", "percentiles"]
