"""Seeds and per-rank random streams — the port's counterpart of
``torchdistpackage_tpu/utils/random.py``.

The reference threads a ``jax.random`` key; the port's key is a plain
integer seed.  :func:`fold_in` derives a new seed from a seed and an
integer with a fixed 64-bit mix (SplitMix64's finaliser), never Python's
``hash()``, so every process of a job computes the same value.  A
dropout mask is drawn from a ``torch.Generator`` seeded with such a
derived key (Philox on the card), so it depends on the key alone and
never on a generator's running state: a checkpointed block's recompute
draws the very same mask.
"""

from __future__ import annotations

import os
import random
from typing import Sequence, Tuple, Union

import numpy as np
import torch

AxisName = Union[str, Tuple[str, ...]]

_M64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """SplitMix64's step and finaliser on a 64-bit integer."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and the integer ``data`` — the counterpart
    of ``jax.random.fold_in``.  Non-negative and below 2**63, so it
    seeds any ``torch.Generator``."""
    return _mix64(_mix64(int(key) & _M64) ^ (int(data) & _M64)) >> 1


def split(key: int, num: int = 2) -> Tuple[int, ...]:
    """``num`` distinct keys from ``key`` (``jax.random.split``'s role)."""
    return tuple(fold_in(key, (1 << 32) + i) for i in range(num))


def fix_rand(seed: int = 1024) -> int:
    """Seed Python's ``random``, numpy and torch (every card too) and
    return the port's key, the seed itself.  The reference's default
    seed."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ.setdefault("PYTHONHASHSEED", str(seed))
    torch.manual_seed(seed)
    return int(seed)


def axis_unique_key(key: int, *axes: AxisName, ctx=None) -> int:
    """Fold this rank's coordinate along each named axis of ``ctx``
    (default: the module-level ``tpc``) into ``key``.  Ranks that differ
    on a listed axis get different keys; ranks that agree on all of them
    share one — e.g. dropout that differs per data shard but agrees
    across tensor shards: ``axis_unique_key(key, 'data')``."""
    if ctx is None:
        from ..dist.topology import tpc as ctx
    for ax in axes:
        for name in (ax if isinstance(ax, tuple) else (ax,)):
            key = fold_in(key, ctx.get_group_rank(name))
    return key


def per_axis_keys(key: int, sizes: Sequence[int]) -> np.ndarray:
    """A grid of keys of shape ``sizes`` (int64), one a coordinate, for
    placing pre-split randomness (e.g. per-stage init)."""
    n = int(np.prod(sizes))
    keys = np.array([fold_in(key, i) for i in range(n)], dtype=np.int64)
    return keys.reshape(tuple(sizes))
