"""Utilities — seeds and per-rank random streams, numel-balanced
partitioning, the input pipeline and preemption signals (the port's
counterparts of the JAX package's ``utils/random.py``,
``utils/partition.py``, ``utils/data.py`` and
``utils/preemption.py``)."""

from .data import microbatch, prefetch_to_sharding, shard_batch
from .partition import partition_params
from .preemption import GracefulShutdown
from .random import axis_unique_key, fix_rand, fold_in, per_axis_keys, split

__all__ = ["GracefulShutdown", "axis_unique_key", "fix_rand", "fold_in",
           "microbatch",
           "partition_params", "per_axis_keys", "prefetch_to_sharding",
           "shard_batch", "split"]
