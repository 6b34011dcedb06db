"""Paged-KV continuous-batching serving on one device."""

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
from .sim import (
    DeviceStep,
    LatencyModel,
    StubDeviceStep,
    TorchDeviceStep,
    host_migrate_blocks,
)

__all__ = [
    "BlockAllocator", "DRAIN_SCHEMA", "DeviceStep", "LatencyModel",
    "PoolSnapshot", "Request", "ServingEngine", "StubDeviceStep",
    "TorchDeviceStep", "chain_block_hashes", "copy_blocks",
    "cp_paged_forward", "gather_kv", "host_migrate_blocks", "init_paged_kv",
    "migrate_blocks", "migration_wire_bytes", "paged_attention",
    "paged_forward", "paged_forward_moe", "paged_write",
]
