"""Parallel layers and the train steps — the serial block math, the
single-device step, data parallelism (``data_parallel.DataParallel``),
the sharded training state (``zero.ZeroOptimizer``, ``fsdp.FSDP``,
``ema.ShardedEMA``), parallel clipping (``clip``) and the pipeline
schedules (``pipeline_parallel``)."""

from . import pipeline_parallel

from .clip import (
    DynamicLossScale,
    chain,
    clip_by_global_norm_parallel,
    clip_grads_by_global_norm,
    global_grad_norm,
)
from .data_parallel import DataParallel, adamw, reduce_gradients
from .ema import ShardedEMA
from .fsdp import (
    FSDP,
    gather_params,
    memory_report,
    offload_to_host,
    prefetched_layer_scan,
    reload_to_device,
    stacked_fsdp_specs,
)
from .zero import ZeroOptimizer, zero_partition_spec

__all__ = [
    "DataParallel", "DynamicLossScale", "FSDP", "ShardedEMA",
    "ZeroOptimizer", "adamw", "chain", "clip_by_global_norm_parallel",
    "clip_grads_by_global_norm", "gather_params", "global_grad_norm",
    "memory_report", "offload_to_host", "pipeline_parallel",
    "prefetched_layer_scan",
    "reduce_gradients", "reload_to_device", "stacked_fsdp_specs",
    "zero_partition_spec",
]
