"""Utilities — seeds and per-rank random streams, numel-balanced
partitioning, the input pipeline, preemption signals, rank-gated printing,
the structured metrics logger, profiling ranges and checkpoints (the
port's counterparts of the JAX package's ``utils/random.py``,
``utils/partition.py``, ``utils/data.py``, ``utils/preemption.py``,
``utils/logging.py``, ``utils/metrics.py``, ``utils/profiling.py`` and
``utils/checkpoint.py``)."""

from .checkpoint import (
    CheckpointManager,
    auto_resume,
    get_mp_ckpt_suffix,
    load_checkpoint,
    save_checkpoint,
)
from .data import microbatch, prefetch_to_sharding, shard_batch
from .logging import (
    disable_non_master_print,
    enable_all_print,
    is_master,
    master_only,
    master_print,
)
from .metrics import MetricsLogger
from .partition import partition_params
from .preemption import GracefulShutdown
from .profiling import TimedScope, prof_start, prof_stop, scope_decorator
from .random import axis_unique_key, fix_rand, fold_in, per_axis_keys, split

__all__ = ["CheckpointManager", "GracefulShutdown", "MetricsLogger",
           "TimedScope", "auto_resume", "axis_unique_key",
           "disable_non_master_print", "enable_all_print", "fix_rand",
           "fold_in", "get_mp_ckpt_suffix", "is_master", "load_checkpoint",
           "master_only", "master_print", "microbatch", "partition_params",
           "per_axis_keys", "prefetch_to_sharding", "prof_start",
           "prof_stop", "save_checkpoint", "scope_decorator",
           "shard_batch", "split"]
