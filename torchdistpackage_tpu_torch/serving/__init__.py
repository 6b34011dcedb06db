"""Paged-KV continuous-batching serving, and the fleet over it: the
Router (prefix-affinity routing, prefill -> decode KV handoff, rebalance,
evacuation), the migration transports and the Autoscaler."""

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
from .tracing import ROUTER_EVENT_KINDS
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
    "LoopbackTransport", "MigrationTransport", "PoolSnapshot", "ROLES",
    "ROUTER_EVENT_KINDS", "ReplicaDiedError", "Request", "Router",
    "ServingEngine", "StubDeviceStep", "TorchDeviceStep",
    "TransportDeadError", "TransportError", "chain_block_hashes",
    "copy_blocks", "cp_paged_forward", "gather_kv", "host_migrate_blocks",
    "init_paged_kv", "migrate_blocks", "migration_wire_bytes",
    "paged_attention", "paged_forward", "paged_forward_moe", "paged_write",
]
