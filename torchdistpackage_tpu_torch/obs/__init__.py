"""Observability — the port's ``torchdistpackage_tpu/obs``: the per-run
object (:class:`Telemetry`), the event timeline (:mod:`.events`), the
sinks (:mod:`.exporters`), the end-of-run report and its validators
(:mod:`.report`), the Perfetto trace (:mod:`.trace`), step-time and
pipeline / MoE aggregates (:mod:`.aggregate`), card memory
and the planner's memory model (:mod:`.mem_ledger`), training numerics
(:mod:`.numerics`), the profiler step window (:mod:`.trace`), the comm
ledger recorded from the port's collectives and its alpha-beta model
and reports (:mod:`.comm_ledger`, :mod:`.comm_model`), and run parity
(:mod:`.parity`)."""

from .aggregate import (
    cross_host_step_stats,
    moe_load_stats,
    percentiles,
    pipeline_bubble_fraction,
    pipeline_time_inflation,
    step_time_stats,
)
from .comm_ledger import (
    LEDGER_SCHEMA,
    CommRecorder,
    comm_record,
    cp_ring_overlap,
    ledger_from_records,
    render_table,
    tp_pp_overlap,
)
from .comm_model import (
    COMPRESSION_SCHEMA,
    AxisCost,
    CommModel,
    comm_report,
    compressed_wire_bytes,
    compression_report,
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
    MemoryModel,
    device_capacity,
    headroom_verdict,
    live_memory,
    mem_report,
)
from .numerics import (
    DEFAULT_THRESHOLDS,
    add_update_stats,
    check_alerts,
    default_group_fn,
    global_grad_norm,
    numerics_report,
    numerics_stats,
)
from .parity import (
    PARITY_SCHEMA,
    PARITY_VERDICTS,
    compare_streams,
    param_divergence,
    parity_section,
    stream_of,
)
from .report import (
    RUNREPORT_SCHEMA,
    render_markdown,
    render_summary_line,
    validate_runreport,
    write_runreport,
)
from .telemetry import Telemetry, peak_flops_for
from .trace import (
    ProfilerStepWindow,
    build_trace,
    chrome_trace_events,
    export_trace,
    validate_trace,
)

__all__ = ["AxisCost", "COMPRESSION_SCHEMA", "CommModel", "CommRecorder",
           "DEFAULT_THRESHOLDS", "EVENT_KINDS", "EventLog", "JsonlSink",
           "LEDGER_SCHEMA", "MEM_VERDICTS", "MemoryModel", "MultiSink",
           "PARITY_SCHEMA", "PARITY_VERDICTS", "ProfilerStepWindow",
           "PrometheusTextfileSink", "RUNREPORT_SCHEMA", "TaggedEventLog",
           "Telemetry", "TensorBoardSink", "add_update_stats", "build_trace",
           "check_alerts", "chrome_trace_events", "comm_record",
           "comm_report", "compare_streams", "compressed_wire_bytes",
           "compression_report", "cp_ring_overlap", "cross_host_step_stats",
           "default_event_log", "default_group_fn", "device_capacity",
           "emit_event", "export_trace", "fit_alpha_beta",
           "global_grad_norm", "headroom_verdict", "ledger_from_records",
           "live_memory", "mem_report", "moe_load_stats", "numerics_report",
           "numerics_stats", "param_divergence", "parity_section",
           "peak_flops_for", "percentiles", "pipeline_bubble_fraction",
           "pipeline_time_inflation", "render_markdown",
           "render_summary_line", "render_table", "set_default_event_log",
           "step_time_stats", "stream_of", "tag_events",
           "tensorboard_available", "tp_pp_overlap", "validate_runreport",
           "validate_trace", "write_runreport"]
