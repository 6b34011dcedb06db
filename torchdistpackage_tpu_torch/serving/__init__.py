"""Paged-KV continuous-batching serving, and the fleet over it: the
Router (prefix-affinity routing, prefill -> decode KV handoff, rebalance,
evacuation), the migration transports and the Autoscaler; and their
observability (:mod:`.tracing`: the request-lifecycle and fleet traces,
the tick accounting's vocabulary and live-export schema)."""

from .autoscale import AUTOSCALE_VERDICTS, Autoscaler
from .engine import DRAIN_SCHEMA, Request, ServingEngine
from .paged_cache import (
    BlockAllocator,
    PoolSnapshot,
    chain_block_hashes,
    copy_blocks,
    cp_paged_forward,
    gather_kv,
    init_paged_kv,
    migrate_blocks,
    migration_wire_bytes,
    paged_attention,
    paged_forward,
    paged_forward_moe,
    paged_write,
)
from .router import (
    FLEET_BALANCE_VERDICTS,
    IMBALANCE_SKEWED_AT,
    ROLES,
    Router,
)
from .sim import (
    DeviceStep,
    LatencyModel,
    StubDeviceStep,
    TorchDeviceStep,
    host_migrate_blocks,
)
from .tracing import (
    REQUEST_PHASES,
    ROUTER_EVENT_KINDS,
    SERVING_METRICS_SCHEMA,
    TICK_PHASES,
    assemble_fleet_request_timelines,
    assemble_request_timelines,
    fleet_trace_events,
    lifecycle_phases,
    phase_table,
    request_trace_events,
    serving_metrics_record,
    serving_trace_events,
    tick_trace_events,
    validate_request_record,
)
from .transport import (
    ChunkedWireTransport,
    LoopbackTransport,
    MigrationTransport,
    ReplicaDiedError,
    TransportDeadError,
    TransportError,
)

__all__ = [
    "AUTOSCALE_VERDICTS", "Autoscaler", "BlockAllocator",
    "ChunkedWireTransport", "DRAIN_SCHEMA", "DeviceStep",
    "FLEET_BALANCE_VERDICTS", "IMBALANCE_SKEWED_AT", "LatencyModel",
    "LoopbackTransport", "MigrationTransport", "PoolSnapshot",
    "REQUEST_PHASES", "ROLES", "ROUTER_EVENT_KINDS",
    "ReplicaDiedError", "Request", "Router", "SERVING_METRICS_SCHEMA",
    "ServingEngine", "StubDeviceStep", "TICK_PHASES", "TorchDeviceStep",
    "TransportDeadError", "TransportError",
    "assemble_fleet_request_timelines", "assemble_request_timelines",
    "chain_block_hashes", "copy_blocks", "cp_paged_forward",
    "fleet_trace_events", "gather_kv", "host_migrate_blocks",
    "init_paged_kv", "lifecycle_phases", "migrate_blocks",
    "migration_wire_bytes", "paged_attention", "paged_forward",
    "paged_forward_moe", "paged_write", "phase_table",
    "request_trace_events", "serving_metrics_record",
    "serving_trace_events", "tick_trace_events", "validate_request_record",
]
