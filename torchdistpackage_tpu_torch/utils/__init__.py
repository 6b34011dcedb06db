"""Utilities — seeds and per-rank random streams, numel-balanced
partitioning, the input pipeline, preemption signals, rank-gated printing
and the structured metrics logger (the port's counterparts of the JAX
package's ``utils/random.py``, ``utils/partition.py``, ``utils/data.py``,
``utils/preemption.py``, ``utils/logging.py`` and ``utils/metrics.py``)."""

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
from .random import axis_unique_key, fix_rand, fold_in, per_axis_keys, split

__all__ = ["GracefulShutdown", "MetricsLogger", "axis_unique_key",
           "disable_non_master_print", "enable_all_print", "fix_rand",
           "fold_in", "is_master", "master_only", "master_print",
           "microbatch", "partition_params", "per_axis_keys",
           "prefetch_to_sharding", "shard_batch", "split"]
