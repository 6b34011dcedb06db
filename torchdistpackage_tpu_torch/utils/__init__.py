"""Utilities — seeds and per-rank random streams, numel-balanced
partitioning and the input pipeline (the port's counterparts of the JAX
package's ``utils/random.py``, ``utils/partition.py`` and
``utils/data.py``)."""

from .data import microbatch, prefetch_to_sharding, shard_batch
from .partition import partition_params
from .random import axis_unique_key, fix_rand, fold_in, per_axis_keys, split

__all__ = ["axis_unique_key", "fix_rand", "fold_in", "microbatch",
           "partition_params", "per_axis_keys", "prefetch_to_sharding",
           "shard_batch", "split"]
