"""FSDP (ZeRO-3: the parameters themselves sharded) and host offload —
the port's counterpart of ``torchdistpackage_tpu/parallel/fsdp.py``.

Placement is ZeRO's rule (:func:`~.zero.zero_partition_spec`), so ZeRO-1,
-2 and -3 are one family: each rank keeps its shard of every leaf (a
leaf with no free dim the group divides stays whole) and the optimizer
runs on the shards, its state sharded with them.

The reference is GSPMD: ``jit`` with sharded in / out placements and
XLA gathers each weight before its use and reduce-scatters its grad.
The port has no GSPMD, so both steps gather explicitly and both take
this rank's LOCAL batch (the ``DataParallel`` convention; the
reference's GSPMD step sees the global batch, and for a mean loss over
equal shards the two agree):

- :meth:`FSDP.make_train_step` gathers every leaf before the forward,
  takes the grads of the full leaves, then reduce-scatters each to its
  shard (the unoverlapped baseline);
- :meth:`FSDP.make_overlap_train_step` gathers through
  :func:`gather_params`, an autograd Function whose backward is the
  reduce-scatter, so each leaf's grad is scattered inside the backward
  as soon as it is complete (``gather='none'`` hands ``loss_fn`` the
  shards, for :func:`prefetched_layer_scan` inside the model).

Gathered leaves' grads come back summed and are divided by the group
size; whole leaves' grads are averaged over the group.
:func:`prefetched_layer_scan` gathers a layer stack one layer at a time,
the next layer's all-gather started before this layer's compute.
:func:`offload_to_host` / :func:`reload_to_device` move tensors and an
optimizer's state to pinned host memory and back IN PLACE, so the
optimizer's references stay valid.  ``compress='int8'`` (and the
overlap step's ``grad_compress='int8'``) sends a leaf whose gathered
size reaches ``compress_min_size`` elements through
``dist.compressed.int8_ring_all_gather``, whose backward is the int8
ring reduce-scatter: the compressed forward gather buys a compressed
backward scatter; the resident shards and the optimizer state stay
full precision.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..dist.compressed import int8_ring_all_gather
from ..dist.topology import DATA_AXIS, TENSOR_AXIS, ParallelContext, tpc
from ..obs.numerics import tree_leaves
from ..utils.partition import named_leaves
from .clip import clip_of, clip_scale, global_grad_norm, scale_
from .data_parallel import _unflatten_like
from .tensor_parallel.layers import PARTIAL_UNDER_SP
from .tensor_parallel.tp_utils import (
    _check_compress,
    _reduce_scatter,
    _start_all_gather,
)
from .zero import _psum_, leaf_specs, shard_of, zero_partition_spec


# ------------------------------------------------------ explicit gathers


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` (or the result of a gather already
    started, ``pending``); backward: the reduce-scatter (sum)."""

    @staticmethod
    def forward(ctx, x, group, dim, pending):
        ctx.group, ctx.dim = group, dim
        if pending is None:
            pending = _start_all_gather(x, group, dim, "fsdp_all_gather",
                                        async_op=False)
        return pending()

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g, ctx.group, ctx.dim, "fsdp_reduce_scatter"),
                None, None, None)


def _int8(x: torch.Tensor, d: int, group, compress: Optional[str],
          min_size: int) -> bool:
    """Whether the gather of ``x`` along ``d`` goes int8: asked for, over more than one rank, and the gathered leaf at least
    ``min_size`` elements."""
    if compress != "int8" or d < 0:
        return False
    n = dist.get_world_size(group)
    return n > 1 and x.numel() * n >= min_size


def _gather(x: torch.Tensor, d: int, group, pending=None,
            int8: bool = False) -> torch.Tensor:
    if d < 0:
        return x
    if int8:
        return int8_ring_all_gather(x, group, d)
    return _Gather.apply(x, group, d, pending)


def gather_params(params: Any, shard_dims: Any, group=None,
                  compress: Optional[str] = None,
                  compress_min_size: int = 65536) -> Any:
    """Every sharded leaf of this rank's shard tree all-gathered back to
    full size along its dim (``shard_dims``: a tree of dims, -1 whole),
    differentiably: each gather's backward reduce-scatters (sums) the
    leaf's grad to the shards.  ``group`` defaults to ``tpc``'s data
    group; every rank of it calls this.  ``compress='int8'``: a leaf
    whose gathered size reaches ``compress_min_size`` elements goes
    through ``int8_ring_all_gather`` (its backward the int8 ring
    reduce-scatter)."""
    _check_compress(compress)
    group = tpc.get_group(DATA_AXIS) if group is None else group
    out = [_gather(p, d, group, int8=_int8(p, d, group, compress,
                                           compress_min_size))
           for p, d in zip(tree_leaves(params), tree_leaves(shard_dims))]
    return _unflatten_like(params, iter(out))


def _spec(ndim: int, tp_spec: Any, d: int, axis: str) -> Tuple:
    """A leaf's placement as a PartitionSpec-like tuple of axis names
    (None: not split), trailing Nones dropped."""
    entries: List[Optional[str]] = [None] * ndim
    if isinstance(tp_spec, int) and ndim:
        entries[tp_spec % ndim] = TENSOR_AXIS
    if d >= 0:
        entries[d] = axis
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def stacked_fsdp_specs(stacked: Any, n: int, base_specs: Any = None,
                       axis: str = DATA_AXIS) -> Tuple[Any, Any]:
    """``(specs, shard_dims)`` for a layer-stacked tree (``[L, ...]``
    leaves): the shard goes on the first free dim ``n`` divides PAST the
    stack dim, so :func:`prefetched_layer_scan` can gather one layer at a
    time (ZeRO's rule alone would take the stack dim when ``n`` divides
    L).  ``specs``: PartitionSpec-like tuples of axis names."""
    specs, dims = [], []
    for p, s in zip(tree_leaves(stacked), leaf_specs(stacked, base_specs)):
        shape = tuple(p.shape)
        tail_tp = (s % len(shape)) - 1 if isinstance(s, int) else s
        d = zero_partition_spec(shape[1:], tail_tp, n)
        d = d + 1 if d >= 0 else -1
        dims.append(d)
        specs.append(_spec(len(shape), s, d, axis))
    return (_unflatten_like(stacked, iter(specs)),
            _unflatten_like(stacked, iter(dims)))


def prefetched_layer_scan(stacked: Any, x: torch.Tensor,
                          apply_fn: Callable[[Any, torch.Tensor, int],
                                             torch.Tensor],
                          group, shard_dims: Any, prefetch: bool = True,
                          compress: Optional[str] = None,
                          compress_min_size: int = 65536) -> torch.Tensor:
    """Run ``x`` through a layer stack whose ``[L, ...]`` leaves are this
    rank's shards (``shard_dims`` from :func:`stacked_fsdp_specs`, never
    0), gathering ONE layer's weights at a time: ``apply_fn(layer_params,
    carry, i) -> carry``.  With ``prefetch`` layer ``i + 1``'s
    all-gathers are started (``async_op``) before layer ``i``'s compute
    and waited on just before layer ``i + 1`` reads them; without it each
    layer gathers when it starts.  The backward reduce-scatters each
    layer's slice of the grads as that layer's backward finishes.  Both
    give the same numbers bit for bit.

    A gathered layer is ``apply_fn``'s input: under a checkpointed
    ``apply_fn`` it is kept for the layer's backward, never re-gathered,
    so every rank issues the same collectives in the same order.

    ``compress='int8'``: a layer slice whose gathered size reaches
    ``compress_min_size`` elements is gathered through
    ``int8_ring_all_gather`` when its layer starts (not prefetched), and
    its backward rides the int8 reduce-scatter ring."""
    _check_compress(compress)
    dims = list(tree_leaves(shard_dims))
    if any(d == 0 for d in dims):
        raise ValueError(
            "prefetched_layer_scan: a leaf is sharded on the stack dim "
            "(shard_dim 0); derive specs with stacked_fsdp_specs")
    leaves = list(tree_leaves(stacked))
    parts = [p.unbind(0) for p in leaves]
    L = len(parts[0])
    layer_dims = [d - 1 if d >= 1 else -1 for d in dims]

    int8 = [_int8(p[0], d, group, compress, compress_min_size)
            for p, d in zip(parts, layer_dims)]

    def start_one(x, d, q):
        if d < 0 or q:
            return None
        return _start_all_gather(x, group, d, "fsdp_all_gather")

    def start(i):
        with torch.no_grad():
            return [start_one(p[i], d, q)
                    for p, d, q in zip(parts, layer_dims, int8)]

    def gathered(i, pending):
        out = [_gather(p[i], d, group, pend, q) for p, d, pend, q in
               zip(parts, layer_dims, pending, int8)]
        return _unflatten_like(stacked, iter(out))

    pending = start(0) if prefetch else [None] * len(parts)
    for i in range(L):
        lp = gathered(i, pending)
        if prefetch and i + 1 < L:
            pending = start(i + 1)
        elif not prefetch:
            pending = [None] * len(parts)
        x = apply_fn(lp, x, i)
    return x


# ------------------------------------------------------------------ FSDP


class FSDP:
    """Fully-sharded data parallelism over ``shard_axis`` of ``ctx``
    (default ``tpc``)::

        fsdp = FSDP()
        shards = fsdp.shard_params(params)        # this rank's shards
        state = adamw(3e-4).init(shards)          # state on the shards
        step = fsdp.make_overlap_train_step(loss_fn, adamw(3e-4))
        shards, state, loss, gnorm = step(shards, state, local_batch)

    Composes with TP: pass the tensor group's spec tree as
    ``param_specs`` (the shard goes on the first free dim of each TP
    shard, and the norm and the SP sums use the tensor group)."""

    def __init__(self, shard_axis: str = DATA_AXIS, param_specs: Any = None,
                 ctx: Optional[ParallelContext] = None) -> None:
        self.ctx = tpc if ctx is None else ctx
        self.shard_axis = shard_axis
        self.param_specs = param_specs
        self.n = self.ctx.get_group_size(shard_axis)
        self._dims: Dict[str, int] = {}

    @property
    def group(self):
        return self.ctx.get_group(self.shard_axis)

    # ----------------------------------------------------------- specs

    def fsdp_shard_dims(self, params: Any, param_specs: Any = None) -> Any:
        """Each FULL leaf's shard dim (-1: whole), a tree like
        ``params``."""
        base = param_specs if param_specs is not None else self.param_specs
        dims = [zero_partition_spec(tuple(p.shape), s, self.n) for p, s in
                zip(tree_leaves(params), leaf_specs(params, base))]
        return _unflatten_like(params, iter(dims))

    def fsdp_specs(self, params: Any, param_specs: Any = None) -> Any:
        """Each full leaf's placement as a PartitionSpec-like tuple of
        axis names: its TP split and the shard axis."""
        base = param_specs if param_specs is not None else self.param_specs
        specs = [_spec(p.dim(), s, d, self.shard_axis) for p, s, d in zip(
            tree_leaves(params), leaf_specs(params, base),
            tree_leaves(self.fsdp_shard_dims(params, base)))]
        return _unflatten_like(params, iter(specs))

    def shard_params(self, params: Any, param_specs: Any = None) -> Any:
        """This rank's shard of every full leaf (new contiguous tensors);
        the dims are remembered by leaf name for the steps, and
        ``param_specs`` (when given) becomes the instance's."""
        if param_specs is not None:
            self.param_specs = param_specs
        base = self.param_specs
        dims = list(tree_leaves(self.fsdp_shard_dims(params, base)))
        rank = dist.get_rank(self.group)
        out = []
        for (name, p), d in zip(named_leaves(params), dims):
            self._dims[name] = d
            out.append(shard_of(p.detach(), d, rank, self.n).clone(
                memory_format=torch.contiguous_format))
        return _unflatten_like(params, iter(out))

    def shard_dims_of(self, shards: Any) -> Any:
        """The dims :meth:`shard_params` chose, as a tree like
        ``shards``."""
        try:
            dims = [self._dims[name] for name, _ in named_leaves(shards)]
        except KeyError as e:
            raise ValueError(f"leaf {e} was not placed by this FSDP's "
                             f"shard_params") from None
        return _unflatten_like(shards, iter(dims))

    # ------------------------------------------------------------ steps

    def _finish(self, shards, opt_state, loss, grads, dims, clip, sp, n):
        """Every shard's final grad from its raw one (gathered leaves:
        scattered sums, divided by ``n``; whole leaves: averaged over the
        group), the SP sums, the norm, the clip and the update; the loss
        averaged over the group."""
        group = self.group
        leaves = list(tree_leaves(shards))
        specs = leaf_specs(shards, self.param_specs)
        tp_group = (self.ctx.get_group(TENSOR_AXIS)
                    if self.param_specs is not None else None)
        with torch.no_grad():
            for p, g, d, s in zip(leaves, grads, dims, specs):
                if g is None:  # a leaf the loss does not read: grad 0
                    g = torch.zeros_like(p)
                if d < 0:
                    g = _psum_(g.clone(), group, "fsdp_all_reduce")
                g = g / n
                if sp and s == PARTIAL_UNDER_SP:
                    _psum_(g, tp_group, "fsdp_all_reduce")
                p.grad = g
            groups = [((group,) if d >= 0 else ())
                      + ((tp_group,) if isinstance(s, int) else ())
                      for d, s in zip(dims, specs)]
            gs = [p.grad for p in leaves]
            gnorm = global_grad_norm(gs, groups)
            if clip is not None:
                scale_(gs, clip_scale(gnorm, clip))
        opt_state.step()
        loss = _psum_(loss.detach().clone(), group, "fsdp_all_reduce")
        return shards, opt_state, loss / n, gnorm

    def _check(self, optimizer, sp):
        if sp and self.param_specs is None:
            raise ValueError("sp needs the tensor group's param_specs")
        return clip_of(optimizer)

    def make_train_step(self, loss_fn: Callable, optimizer,
                        sp: bool = False) -> Callable:
        """``step(shards, opt_state, batch) -> (shards, opt_state, loss,
        gnorm)`` on this rank's local batch: every sharded leaf gathered
        before the forward, the grads of the full leaves by autograd,
        each reduce-scattered to its shard after the backward, then the
        update of the shards in place (``opt_state`` is
        ``optimizer.init(shards)``).  ``loss`` is the mean over the
        group; ``gnorm`` the global norm before any clip."""
        clip = self._check(optimizer, sp)

        def step(shards, opt_state, batch):
            group, n = self.group, self.n
            dims = list(tree_leaves(self.shard_dims_of(shards)))
            leaves = list(tree_leaves(shards))
            opt_state.zero_grad(set_to_none=True)
            with torch.no_grad():
                full = [p if d < 0 else _start_all_gather(
                    p, group, d, "fsdp_all_gather", async_op=False)()
                    for p, d in zip(leaves, dims)]
            inputs = [f if d < 0 else f.requires_grad_(True)
                      for f, d in zip(full, dims)]
            loss = loss_fn(_unflatten_like(shards, iter(inputs)), batch)
            grads = torch.autograd.grad(loss, inputs, allow_unused=True)
            del full, inputs
            grads = [g if g is None or d < 0 else _reduce_scatter(
                g, group, d, "fsdp_reduce_scatter")
                for g, d in zip(grads, dims)]
            return self._finish(shards, opt_state, loss, grads, dims, clip,
                                sp, n)

        return step

    def make_overlap_train_step(self, loss_fn: Callable, optimizer,
                                gather: str = "leaf",
                                grad_compress: Optional[str] = None,
                                sp: bool = False,
                                compress_min_size: int = 65536) -> Callable:
        """As :meth:`make_train_step`, but each leaf is gathered through
        :func:`gather_params`, so its grad is reduce-scattered inside the
        backward as soon as it is complete, and the full-size grads never
        persist.  ``gather='none'``: ``loss_fn`` gets the SHARDS and
        gathers them itself (:func:`prefetched_layer_scan` over a stack
        placed by :func:`stacked_fsdp_specs`).  ``grad_compress='int8'``:
        the leaves whose gathered size reaches ``compress_min_size``
        elements take the int8 gather forward and the int8 ring
        reduce-scatter backward."""
        if gather not in ("leaf", "none"):
            raise ValueError(f"gather must be 'leaf' or 'none', got "
                             f"{gather!r}")
        if grad_compress not in (None, "int8"):
            raise ValueError(f"unknown grad_compress {grad_compress!r}; the "
                             f"overlap step supports None or 'int8'")
        clip = self._check(optimizer, sp)

        def step(shards, opt_state, batch):
            dims = self.shard_dims_of(shards)
            opt_state.zero_grad(set_to_none=True)
            params = (gather_params(shards, dims, self.group,
                                    compress=grad_compress,
                                    compress_min_size=compress_min_size)
                      if gather == "leaf" else shards)
            loss = loss_fn(params, batch)
            del params
            loss.backward()
            return self._finish(
                shards, opt_state, loss,
                [p.grad for p in tree_leaves(shards)],
                list(tree_leaves(dims)), clip, sp, self.n)

        return step


# ---------------------------------------------------------- host offload


def _move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cpu":
        pinned = t.device.type == "cuda"
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
    else:
        out = torch.empty(t.shape, dtype=t.dtype, device=device)
    return out.copy_(t, non_blocking=True)


def _relocate(tree: Any, device, donate: bool) -> Any:
    def one(x):
        if isinstance(x, torch.optim.Optimizer):
            if not donate:
                raise TypeError("an optimizer's state moves in place only "
                                "(donate=True)")
            for st in x.state.values():
                for k, v in st.items():
                    # AdamW's 'step' count is a host scalar; it stays
                    if torch.is_tensor(v) and v.dim() > 0:
                        one(v)
            return x
        if not torch.is_tensor(x) or x.device == device:
            return x
        moved = _move(x.detach(), device)
        if not donate:
            return moved
        x.grad = None  # stale: every step sets the grads anew
        x.data = moved  # the same tensor object: references stay valid
        return x

    if isinstance(tree, dict):
        return {k: _relocate(v, device, donate) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_relocate(v, device, donate) for v in tree)
    return one(tree)


def offload_to_host(tree: Any, donate: bool = True) -> Any:
    """Move a tree's tensors (and any ``torch.optim.Optimizer`` leaf's
    state) to pinned host memory with non-blocking copies.  ``donate``
    (default): in place, each tensor keeping its identity (``.data``
    swapped; a stale ``.grad`` dropped), so an optimizer built on them
    stays valid and the card's copy is freed; ``donate=False``: a new tree of host copies, the inputs
    left as they are.  A tensor already on the host is left alone."""
    return _relocate(tree, torch.device("cpu"), donate)


def reload_to_device(tree: Any, donate: bool = True, device=None) -> Any:
    """:func:`offload_to_host`'s inverse: the tensors back on ``device``
    (default: the card), in place when ``donate``."""
    from ..device import resolve_device

    return _relocate(tree, resolve_device(device), donate)


def memory_report(label: str = "") -> Dict[str, Dict[str, int]]:
    """This process's bytes in use and peak bytes on each card
    (``torch.cuda``'s allocator), ``{}`` without a card; with ``label``,
    one line printed on rank 0."""
    if not torch.cuda.is_available():
        return {}
    stats = {f"cuda:{i}": {
        "bytes_in_use": torch.cuda.memory_allocated(i),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(i)}
        for i in range(torch.cuda.device_count())}
    if label and (not dist.is_initialized() or dist.get_rank() == 0):
        used = max(v["bytes_in_use"] for v in stats.values())
        peak = max(v["peak_bytes_in_use"] for v in stats.values())
        print(f"[mem {label}] in_use={used / 1e9:.3f} GB "
              f"peak={peak / 1e9:.3f} GB", flush=True)
    return stats
