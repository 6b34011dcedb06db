"""Observability — the port's ``torchdistpackage_tpu/obs``: the per-run
object (:class:`Telemetry`), the event timeline (:mod:`.events`), the
sinks (:mod:`.exporters`), the end-of-run report and its validators
(:mod:`.report`), the Perfetto trace (:mod:`.trace`), step-time and
pipeline / MoE aggregates (:mod:`.aggregate`), card memory
(:mod:`.mem_ledger`), training numerics (:mod:`.numerics`), and the comm
record and alpha-beta model the compression policy and the comm
benchmark read (:mod:`.comm_ledger`, :mod:`.comm_model`)."""

from .aggregate import (
    cross_host_step_stats,
    moe_load_stats,
    percentiles,
    pipeline_bubble_fraction,
    pipeline_time_inflation,
    step_time_stats,
)
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
from .exporters import (
    JsonlSink,
    MultiSink,
    PrometheusTextfileSink,
    TensorBoardSink,
    tensorboard_available,
)
from .mem_ledger import (
    MEM_VERDICTS,
    device_capacity,
    headroom_verdict,
    live_memory,
    mem_report,
)
from .numerics import (
    DEFAULT_THRESHOLDS,
    check_alerts,
    global_grad_norm,
    numerics_report,
)
from .report import (
    RUNREPORT_SCHEMA,
    render_markdown,
    render_summary_line,
    validate_runreport,
    write_runreport,
)
from .telemetry import Telemetry, peak_flops_for
from .trace import build_trace, chrome_trace_events, export_trace, \
    validate_trace

__all__ = ["AxisCost", "CommModel", "DEFAULT_THRESHOLDS", "EVENT_KINDS",
           "EventLog", "JsonlSink", "MEM_VERDICTS", "MultiSink",
           "PrometheusTextfileSink", "RUNREPORT_SCHEMA", "TaggedEventLog",
           "Telemetry", "TensorBoardSink", "build_trace", "check_alerts",
           "chrome_trace_events", "comm_record", "compressed_wire_bytes",
           "cross_host_step_stats", "default_event_log", "device_capacity",
           "emit_event", "export_trace", "fit_alpha_beta",
           "global_grad_norm", "headroom_verdict", "live_memory",
           "mem_report", "moe_load_stats", "numerics_report",
           "peak_flops_for", "percentiles", "pipeline_bubble_fraction",
           "pipeline_time_inflation", "render_markdown",
           "render_summary_line", "set_default_event_log",
           "step_time_stats", "tag_events", "tensorboard_available",
           "validate_runreport", "validate_trace", "write_runreport"]
