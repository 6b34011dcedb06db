"""Sharded EMA — the port's counterpart of
``torchdistpackage_tpu/parallel/ema.py``.

Each rank keeps the f32 EMA of its shard of every leaf only, placed by
ZeRO's rule (:func:`~.zero.zero_partition_spec` over the shard group),
so the EMA's shards sit beside ZeRO's master shards.  An update is
elementwise on the shard, ``e = e * d + p * (1 - d)`` in the
reference's operand order, ``d`` and ``1 - d`` formed in f32; the
parameters are the full (or tensor-parallel) leaves every rank holds, and
the update reads this rank's slice of each.  :meth:`ShardedEMA.state_dict`
all-gathers the shards over the shard group into host numpy arrays
(under tensor parallelism: this tensor rank's leaves).
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..dist.topology import DATA_AXIS, ParallelContext, tpc
from ..obs.numerics import tree_leaves
from .data_parallel import _unflatten_like
from .tensor_parallel.tp_utils import _all_gather
from .zero import leaf_specs, shard_of, zero_partition_spec


class ShardedEMA:
    """EMA of the parameters, sharded over ``shard_axis`` like ZeRO's
    state::

        ema = ShardedEMA(decay=0.9999)
        state = ema.init(params, param_specs)   # f32 shards
        state = ema.update(state, params)       # each step, in place
        full = ema.state_dict(state)            # host numpy, full tree
        ema.verify_with_gt(state, dense_ema)    # golden check

    ``ctx`` defaults to ``tpc``; every rank of the shard group calls each
    method."""

    def __init__(self, decay: float = 0.9999, shard_axis: str = DATA_AXIS,
                 dtype: torch.dtype = torch.float32,
                 ctx: Optional[ParallelContext] = None) -> None:
        self.decay = float(decay)
        self.shard_axis = shard_axis
        self.dtype = dtype
        self.ctx = tpc if ctx is None else ctx
        self.group = self.ctx.get_group(shard_axis)
        self.n = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self._dims: Optional[List[int]] = None

    def ema_dims(self, params: Any, param_specs: Any = None) -> Any:
        """Each leaf's shard dim (-1: whole), a tree like ``params``."""
        dims = [zero_partition_spec(tuple(p.shape), s, self.n) for p, s in
                zip(tree_leaves(params), leaf_specs(params, param_specs))]
        return _unflatten_like(params, iter(dims))

    def init(self, params: Any, param_specs: Any = None) -> Any:
        """The EMA state: this rank's shard of every leaf in ``dtype``."""
        self._dims = list(tree_leaves(self.ema_dims(params, param_specs)))
        out = [shard_of(p.detach(), d, self.rank, self.n).to(
            self.dtype, copy=True, memory_format=torch.contiguous_format)
            for p, d in zip(tree_leaves(params), self._dims)]
        return _unflatten_like(params, iter(out))

    def update(self, state: Any, params: Any,
               decay: Optional[float] = None) -> Any:
        """One EMA step on the shards, in place; returns ``state``."""
        if self._dims is None:
            raise RuntimeError("call init() before update()")
        d = torch.tensor(self.decay if decay is None else float(decay),
                         dtype=torch.float32)
        one_minus = 1.0 - d
        with torch.no_grad():
            for e, p, dim in zip(tree_leaves(state), tree_leaves(params),
                                 self._dims):
                p = shard_of(p.detach(), dim, self.rank, self.n)
                e.mul_(d).add_(p.to(e.dtype) * one_minus)
        return state

    def state_dict(self, state: Any) -> Any:
        """The full EMA tree as host numpy arrays, each sharded leaf
        all-gathered over the shard group."""
        if self._dims is None:
            raise RuntimeError("call init() before state_dict()")
        out = []
        with torch.no_grad():
            for e, dim in zip(tree_leaves(state), self._dims):
                if dim >= 0:
                    e = _all_gather(e, self.group, dim, "ema_all_gather")
                out.append(e.cpu().numpy())
        return _unflatten_like(state, iter(out))

    def verify_with_gt(self, state: Any, gt: Any, atol: float = 0.0) -> bool:
        """Golden check against a dense EMA tree (tensors or arrays, the
        same structure): every leaf within ``atol`` (default: exact)."""
        mine = list(tree_leaves(self.state_dict(state)))
        want = list(tree_leaves(gt))
        if len(mine) != len(want):
            return False
        for m, g in zip(mine, want):
            if torch.is_tensor(g):
                g = g.detach().cpu().numpy()
            g = np.asarray(g, dtype=m.dtype)
            if m.shape != g.shape or not np.allclose(m, g, atol=atol,
                                                     rtol=0.0):
                return False
        return True
