"""Observability — the minimum the serving engine needs."""

from .aggregate import percentiles
from .events import EventLog, default_event_log

__all__ = ["EventLog", "default_event_log", "percentiles"]
