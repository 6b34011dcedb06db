"""Observability — the minimum the serving engine and the train step
need."""

from .aggregate import percentiles
from .events import EventLog, default_event_log
from .numerics import global_grad_norm

__all__ = ["EventLog", "default_event_log", "global_grad_norm",
           "percentiles"]
