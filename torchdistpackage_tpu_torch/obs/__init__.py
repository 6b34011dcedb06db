"""Observability — the minimum the serving engine and the train step
need, and the comm record and alpha-beta model the compression policy
and the comm benchmark read."""

from .aggregate import moe_load_stats, percentiles
from .comm_ledger import comm_record
from .comm_model import (
    AxisCost,
    CommModel,
    compressed_wire_bytes,
    fit_alpha_beta,
)
from .events import EVENT_KINDS, EventLog, default_event_log
from .numerics import global_grad_norm

__all__ = ["AxisCost", "CommModel", "EVENT_KINDS", "EventLog",
           "comm_record", "compressed_wire_bytes", "default_event_log",
           "fit_alpha_beta", "global_grad_norm", "moe_load_stats",
           "percentiles"]
