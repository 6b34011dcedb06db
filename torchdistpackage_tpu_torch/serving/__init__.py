"""Paged-KV continuous-batching serving on one device."""

from .engine import Request, ServingEngine
from .paged_cache import (
    BlockAllocator,
    gather_kv,
    init_paged_kv,
    paged_attention,
    paged_forward,
    paged_forward_moe,
    paged_write,
)
from .sim import TorchDeviceStep

__all__ = [
    "BlockAllocator", "Request", "ServingEngine",
    "TorchDeviceStep", "gather_kv", "init_paged_kv", "paged_attention",
    "paged_forward", "paged_forward_moe", "paged_write",
]
