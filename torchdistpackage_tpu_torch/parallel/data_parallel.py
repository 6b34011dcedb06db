"""The train step and data parallelism — the port's counterpart of
``torchdistpackage_tpu/parallel/data_parallel.py``.

:func:`make_train_step` is the single-device step (``bench.py``'s).
:class:`DataParallel` is the reference's ``NaiveDDP`` design over
``torch.distributed``: parameters broadcast from rank 0 of the data
group, per-parameter gradient hooks that pack each gradient, as it
becomes ready, into 25 MB flat buckets, and each full bucket's
all-reduce started asynchronously while the backward goes on; the step
waits on every bucket before the optimizer.  The JAX package gets the
same result from XLA inside one SPMD program (params marked varying
over the data axes, one explicit reduce); here each rank runs its own
autograd and reduces explicitly.  The semantics are the reference's:
per-axis ``'mean'`` / ``'sum'``, ``grad_reduce_overrides`` (first
matching name substring wins; ``()`` = no reduction; ``'mean'`` divides
by the FULL data-group size, the MoE-DP rule), accumulation with the
reduction once at the end or once a microbatch, and the logged loss the
mean over the data ranks.

The GPT's block parameters are one ``[L, ...]`` leaf per weight kind,
unbound once by ``scan_blocks``: such a leaf's gradient exists only
after layer 0's backward, the end of the backward.  So the step also
taps each layer's slice (``layers.grad_taps``): a slice is bucketed as
soon as its layer's backward is done, and its reduced value is written
into its row of the leaf's ``.grad`` before the optimizer.  Leaves
that are not stacked (the embeddings, ``ln_f``, the head) are bucketed
whole, by a post-accumulate hook.

Tensor parallelism composes with both steps: given the tensor group's
spec tree (``models.gpt_param_specs``) each rank trains its shard, AdamW
elementwise on it as on the whole leaf; under sequence parallelism the
gradients of the leaves the specs mark ``PARTIAL_UNDER_SP`` (norms and
row-parallel biases, which see only the rank's sequence rows) are
summed over the tensor group in the step — by :func:`make_train_step`
after the backward, by :class:`DataParallel` in the same buckets as the
data reduction (the bucket's group spans the data and tensor axes) —
and the gradient norm sums the split leaves' squares over the group.

The optimizer is optax's ``adamw`` as ``torch.optim.AdamW``:
:func:`adamw` keeps optax's defaults (betas 0.9 / 0.999, eps 1e-8,
weight decay 1e-4 on every leaf — torch's own default is 1e-2), and the
moments take the parameters' dtype, as optax's do.  Both update
``p <- p - lr * (m̂ / (sqrt(v̂) + eps) + wd * p)``.  Every step also
takes ``clip.chain(clip_by_global_norm_parallel(c), adamw(lr))``, the
global-norm clip before the update.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..dist.topology import (
    CONTEXT_AXIS,
    DATA_AXIS,
    PIPE_AXIS,
    TENSOR_AXIS,
    ParallelContext,
    tpc,
)
from ..obs.comm_ledger import note
from ..obs.numerics import (
    add_update_stats,
    global_grad_norm,
    numerics_stats,
    tree_leaves,
)
from ..utils.data import microbatch
from ..utils.data import shard_batch as _shard_batch
from ..utils.partition import named_leaves
from .clip import _norms, clip_of, clip_scale, scale_
from .tensor_parallel.layers import PARTIAL_UNDER_SP, grad_taps, spec_pairs
from .tensor_parallel.tp_utils import (
    all_reduce_,
    from_host,
    host_path,
    start_all_reduce,
    to_host,
)

AxisName = Union[str, Tuple[str, ...]]

#: optax ``adamw``'s defaults (torch's own weight decay default is 1e-2)
BETAS, EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4
#: NaiveDDP's default bucket size
BUCKET_CAP_MB = 25


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax-style handle: ``opt_state = adamw(3e-4).init(params)``."""

    lr: float = 3e-4

    def init(self, params: Dict[str, Any]) -> torch.optim.AdamW:
        """Marks every leaf of ``params`` as trainable and returns the
        optimizer over them (its state is the optax state's
        counterpart)."""
        leaves = list(tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        return torch.optim.AdamW(leaves, lr=self.lr, betas=BETAS, eps=EPS,
                                 weight_decay=WEIGHT_DECAY)


def adamw(lr: float = 3e-4) -> AdamW:
    """optax ``adamw(lr)`` with its defaults (see the module note)."""
    return AdamW(lr=lr)


@dataclasses.dataclass(frozen=True)
class _TP:
    """A step's tensor parallelism: the group, each leaf's spec (aligned
    with ``tree_leaves(params)``) and whether SP is on."""

    group: Any
    specs: Tuple[Any, ...]
    sp: bool

    def split(self, i: int) -> bool:
        return isinstance(self.specs[i], int)


def _tp_of(group, params, specs, sp: bool) -> Optional[_TP]:
    if specs is None:
        if sp:
            raise ValueError("sp needs the tensor group's param_specs")
        return None
    return _TP(group, tuple(s for _, s in spec_pairs(params, specs)), sp)


def _norm_groups(tp: Optional[_TP], pipe: Optional[tuple], n: int
                 ) -> Optional[List[Tuple[Any, ...]]]:
    """Each leaf's groups for ``clip._norms`` (None: every leaf whole):
    the tensor-split leaves' squares are summed over the tensor group, a
    stage slab's over the pipe group (``pipe``: :func:`pipe_of`)."""
    if tp is None and pipe is None:
        return None
    return [((tp.group,) if tp is not None and tp.split(i) else ())
            + ((pipe[0],) if pipe is not None and pipe[1][i] else ())
            for i in range(n)]


def _update(params, opt_state: torch.optim.AdamW, loss: torch.Tensor,
            numerics: bool, tp: Optional[_TP] = None,
            clip: Optional[float] = None, pipe: Optional[tuple] = None):
    """The step's tail once every leaf's ``.grad`` is final: the global
    gradient norm (or the numerics dict), the clip of a :func:`~.clip.chain`
    (``clip``: its ``max_norm``) and one AdamW update.  Under tensor
    parallelism the norms are the whole model's: the split leaves'
    squares summed over the tensor group; pipelined (``pipe``:
    :func:`pipe_of`), the stage slabs' over the pipe group.

    ``numerics``: ``obs.numerics.numerics_stats`` over the grads before
    the clip, the params before the update and the update, as the
    reference's step (JAX :559-562).  AdamW updates in place, so the
    update is ``p_after - p_before`` from an f32 copy of every leaf taken
    before the step (the leaf's rounded change, for a bf16 leaf)."""
    leaves = list(tree_leaves(params))
    grads = [p.grad for p in leaves]
    groups = _norm_groups(tp, pipe, len(leaves))
    if any(g is None for g in grads):
        # AdamW would skip the leaf, weight decay included, where
        # optax decays every leaf
        raise RuntimeError("a parameter leaf got no gradient")
    with torch.no_grad():
        if numerics:
            before = [p.detach().to(torch.float32, copy=True) for p in leaves]
            stats = numerics_stats(_unflatten_like(params, iter(grads)),
                                   params=_unflatten_like(params,
                                                          iter(before)),
                                   groups=groups)
            gnorm = stats["grad_norm"]
        elif groups is None:
            gnorm = global_grad_norm(grads)
        else:
            gnorm = torch.sqrt(_norms(grads, groups)[0]).float()
        if clip is not None:
            scale_(grads, clip_scale(gnorm, clip))
    opt_state.step()
    if not numerics:
        return params, opt_state, loss.detach(), gnorm
    with torch.no_grad():
        for b, p in zip(before, leaves):
            b.neg_().add_(p)  # p_after - p_before, in place on the copy
        add_update_stats(stats, _unflatten_like(params, iter(before)),
                         groups=groups)
    return params, opt_state, loss.detach(), stats


def make_train_step(loss_fn: Callable[[Dict[str, Any], Dict[str, Any]],
                                      torch.Tensor],
                    optimizer: Any, numerics: bool = False,
                    param_specs: Any = None, sp: bool = False,
                    tp_group=None):
    """``step(params, opt_state, batch) -> (params, opt_state, loss,
    gnorm)``: the loss and its gradients by autograd, the global gradient
    norm, one AdamW update.  ``opt_state`` is ``optimizer.init(params)``;
    ``optimizer`` is ``adamw()`` or ``clip.chain(
    clip_by_global_norm_parallel(c), adamw())``, which scales the grads
    by ``min(1, c / (gnorm + 1e-6))`` before the update (``gnorm`` is
    the norm before the clip).

    Tensor parallelism: ``params`` is this rank's shard, ``param_specs``
    its spec tree (``models.gpt_param_specs``), ``tp_group`` the tensor
    group (default ``tpc``'s ``'tensor'`` group) and ``loss_fn`` runs
    with that group.  ``sp=True``: the gradients of the leaves the specs
    mark ``PARTIAL_UNDER_SP`` are summed over the group after the
    backward.  The loss is the same on every rank of the group.

    Unlike the reference's functional step, the update is in place: the
    returned ``params`` is the same dict, its leaves updated, and the
    optimizer's moments live in ``opt_state``.  ``loss`` and ``gnorm`` are
    0-dim tensors on the device (reading them syncs).  ``numerics=True``
    returns the reference's whole ``obs.numerics.numerics_stats`` dict
    instead of ``gnorm`` (norms of the grads, the params before the update
    and the update, ``update_ratio``, ``nonfinite_grads``, the three
    low-precision fractions and the per-group ``groups``); it holds an
    f32 copy of the params through the update."""
    clip = clip_of(optimizer)
    if param_specs is not None and tp_group is None:
        tp_group = tpc.get_group(TENSOR_AXIS)

    def step(params: Dict[str, Any], opt_state: torch.optim.AdamW,
             batch: Dict[str, Any]) -> Tuple[Dict[str, Any], Any,
                                             torch.Tensor, Any]:
        tp = _tp_of(tp_group, params, param_specs, sp)
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch)
        loss.backward()
        if tp is not None and sp:
            buckets = _Buckets(lambda axes: tp_group, BUCKET_CAP_MB * 2**20)
            for i, p in enumerate(tree_leaves(params)):
                if tp.specs[i] == PARTIAL_UNDER_SP:
                    buckets.add(p, p.grad, _Plan((TENSOR_AXIS,), 1.0))
            buckets.flush()
            for p, red in buckets.finish():
                p.grad.copy_(red)
        return _update(params, opt_state, loss, numerics, tp, clip)

    return step


# ------------------------------------------------------------- reduction


def _validate_reduce_op(reduce_op) -> None:
    ops = reduce_op.values() if isinstance(reduce_op, dict) else (reduce_op,)
    for op in ops:
        if op not in ("mean", "sum"):
            raise ValueError(f"reduce op must be 'mean' or 'sum', got {op!r}")


def _axis_op(reduce_op, a: str) -> str:
    """The reduce op for axis ``a`` ('mean' when unlisted in a dict)."""
    if isinstance(reduce_op, dict):
        return reduce_op.get(a, "mean")
    return reduce_op


def _axes(axis: AxisName) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _check_compress(compress, axes: Tuple[str, ...] = (),
                    reduce_op="mean") -> None:
    if compress not in (None, "int8", "auto"):
        raise ValueError(
            f"unknown grad_compress {compress!r}; DataParallel supports "
            f"None, 'int8' or 'auto' ('int8_ef' needs the persistent "
            f"residual state only ZeroOptimizer carries)")
    if compress is not None and axes and not any(
            _axis_op(reduce_op, a) == "mean" for a in axes):
        raise ValueError(
            "grad_compress needs at least one mean-op data axis — with "
            "every axis on 'sum' every leaf would take the exact path")


@dataclasses.dataclass(frozen=True)
class _Plan:
    """How one gradient is reduced: summed over the flattened group of
    ``axes`` (none: left as it is), then multiplied by ``scale``.  A
    compressed leaf (``ring``, its mean-op axes) instead leaves the
    buckets: it is summed exactly over ``pre`` (the tensor axis of an SP
    partial leaf), averaged over each ``ring`` axis in turn by
    ``dist.compressed.int8_ring_pmean``, then summed exactly over
    ``axes`` (its sum-op axes), and ``scale`` is 1."""

    axes: Tuple[str, ...]
    scale: float
    ring: Tuple[str, ...] = ()
    pre: Tuple[str, ...] = ()


def _leaf_plan(name: str, axes: Tuple[str, ...], reduce_op,
               overrides: Dict[str, Tuple[str, ...]],
               ctx: ParallelContext, compress: bool = False) -> _Plan:
    """The reference's ``reduce_leaf`` rule for the leaf ``name``: the
    first override whose substring is in the name sums over its axes and
    divides by the full size of the mean-op default axes; otherwise the
    mean-op axes average and the sum-op axes sum — through the int8 ring
    when ``compress`` (an override leaf never compresses)."""
    mean = math.prod(ctx.get_group_size(a) for a in axes
                     if _axis_op(reduce_op, a) == "mean")
    for tok, ax in overrides.items():
        if tok in name:
            ax = _axes(ax)
            return _Plan(ax, 1.0 / mean) if ax else _Plan((), 1.0)
    if compress:
        return _Plan(tuple(a for a in axes if _axis_op(reduce_op, a)
                           == "sum"), 1.0,
                     ring=tuple(a for a in axes
                                if _axis_op(reduce_op, a) == "mean"))
    return _Plan(axes, 1.0 / mean)


def _whole_shape(p: torch.Tensor, tp: Optional["_TP"], i: int
                 ) -> Tuple[int, ...]:
    """Leaf ``i``'s whole shape: its tensor-split dim times the tensor
    group's size (the shape the reference's policy sees)."""
    shape = list(p.shape)
    if tp is not None and tp.split(i) and shape:
        shape[tp.specs[i] % len(shape)] *= dist.get_world_size(tp.group)
    return tuple(shape)


def _compressed(name: str, numel: int, compress: Optional[str],
                min_size: int, policy: Optional[Dict[str, bool]]) -> bool:
    """Whether leaf ``name`` of ``numel`` elements takes the int8 ring:
    under a policy (``'auto'``) its choice, else the size threshold."""
    if compress is None:
        return False
    if policy is not None:
        return bool(policy.get(name, False))
    return numel >= min_size


class _Buckets:
    """Gradients packed, in the order they are added, into flat buckets
    of one plan, dtype and device.  A bucket's all-reduce starts
    (``async_op=True``: NCCL's stream on the card, gloo's thread on the
    CPU) as soon as the next gradient would take it past ``cap_bytes``;
    :meth:`flush` starts the rest and :meth:`finish` waits and yields
    every unit's reduced value."""

    def __init__(self, group_of: Callable[[Tuple[str, ...]], Any],
                 cap_bytes: int, extra_scale: float = 1.0):
        self.group_of = group_of
        self.cap = cap_bytes
        self.extra_scale = extra_scale
        self.open: Dict[tuple, list] = {}
        self.started: List[tuple] = []
        self.bytes_started = 0
        self.bytes_before_backward_returned = 0
        self.bytes_before_blocks_done: Optional[int] = None

    def add(self, unit, grad: torch.Tensor, plan: _Plan) -> None:
        if plan.ring:
            self.add_ring(unit, grad, plan)
            return
        key = (plan, grad.dtype, grad.device)
        nbytes = grad.numel() * grad.element_size()
        b = self.open.get(key)
        if b is not None and b[2] + nbytes > self.cap:
            self._start(key)
            b = None
        if b is None:
            b = self.open[key] = [[], [], 0]
        b[0].append(unit)
        b[1].append(grad)
        b[2] += nbytes
        if b[2] >= self.cap:
            self._start(key)

    def add_ring(self, unit, grad: torch.Tensor, plan: _Plan) -> None:
        """A compressed leaf: reduced now, whole, outside the buckets (the
        int8 ring's groups of 256 elements must not straddle leaves)."""
        from ..dist.compressed import int8_ring_pmean

        g = grad * self.extra_scale if self.extra_scale != 1.0 else grad
        with torch.no_grad():
            if plan.pre:
                g = all_reduce_(g.clone(memory_format=torch.contiguous_format),
                                self.group_of(plan.pre))
            for a in plan.ring:
                g = int8_ring_pmean(g, self.group_of((a,)))
            if plan.axes:
                g = all_reduce_(g.clone(memory_format=torch.contiguous_format),
                                self.group_of(plan.axes))
        self.started.append(([unit], [g.shape], g.reshape(-1), plan, None,
                             1.0))
        self.bytes_started += g.numel() * g.element_size()

    def _start(self, key) -> None:
        units, grads, _ = self.open.pop(key)
        plan = key[0]
        flat = torch.cat([g.reshape(-1) for g in grads])
        work = (start_all_reduce(flat, self.group_of(plan.axes))
                if plan.axes else None)
        self.started.append((units, [g.shape for g in grads], flat, plan,
                             work, plan.scale * self.extra_scale))
        self.bytes_started += flat.numel() * flat.element_size()

    def flush(self) -> None:
        for key in list(self.open):
            self._start(key)

    def finish(self) -> Iterator[Tuple[Any, torch.Tensor]]:
        """Each unit's reduced value, bucket by bucket in start order; a
        bucket's flat buffer is let go once its units are handed out."""
        while self.started:
            units, shapes, flat, plan, work, scale = self.started.pop(0)
            if work is not None:
                work()
            if scale != 1.0:
                flat.mul_(scale)
            off = 0
            for unit, shape in zip(units, shapes):
                n = math.prod(shape)
                yield unit, flat[off:off + n].view(shape)
                off += n


def reduce_gradients(grads: Any, axis: AxisName = DATA_AXIS,
                     reduce_op: Union[str, Dict[str, str]] = "mean",
                     grad_reduce_overrides: Optional[
                         Dict[str, Tuple[str, ...]]] = None,
                     compress: Optional[str] = None,
                     compress_min_size: int = 65536,
                     compress_policy: Optional[Dict[str, bool]] = None,
                     ctx: Optional[ParallelContext] = None) -> Any:
    """This rank's gradient tree (nested dicts of tensors) reduced over
    the data axes of ``ctx`` (default ``tpc``), as a new tree — the
    counterpart of the reference's ``reduce_gradients`` (call it on
    every rank).  ``reduce_op``: one op or ``{axis: op}`` (unlisted axes
    'mean').  ``grad_reduce_overrides``: ``{name_substring: axes}``,
    first match wins; ``()`` leaves the gradient as it is; under
    ``'mean'`` an override sums over its axes and divides by the full
    size of the mean-op default axes (MoE-DP: expert grads reduce over
    ``moe_dp`` only, yet average over the whole data group, since each
    expert saw only its EP share of the batch).

    ``compress='int8'`` / ``'auto'``: a leaf of at least
    ``compress_min_size`` elements (or, given ``compress_policy``
    ``{name: bool}``, the leaves it chooses) averages its mean-op axes
    through ``dist.compressed.int8_ring_pmean``, one axis after another,
    each leaf its own ring; override leaves, the sum-op axes and the
    other leaves stay exact."""
    ctx = tpc if ctx is None else ctx
    _validate_reduce_op(reduce_op)
    axes, overrides = _axes(axis), dict(grad_reduce_overrides or {})
    _check_compress(compress, axes, reduce_op)
    buckets = _Buckets(ctx.get_group, BUCKET_CAP_MB * 2**20)
    names = []
    for name, g in named_leaves(grads):
        names.append(name)
        buckets.add(name, g, _leaf_plan(
            name, axes, reduce_op, overrides, ctx,
            _compressed(name, g.numel(), compress, compress_min_size,
                        compress_policy)))
    buckets.flush()
    reduced = dict(buckets.finish())
    return _unflatten_like(grads, (reduced[n] for n in names))


def _unflatten_like(tree, leaves: Iterator[torch.Tensor]):
    """A tree shaped like ``tree`` (dicts and lists) holding ``leaves``
    in ``named_leaves`` order."""
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(v, leaves) for v in tree)
    return next(leaves)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _split_micro(batch: Any, iters: int) -> List[Any]:
    """``iters`` microbatches cut from every leaf's leading dim."""
    micro = microbatch(batch, iters)
    return [_tree_map(lambda m: m[i], micro) for i in range(iters)]


def local_value_and_grad(loss_fn: Callable[[Any, Any], torch.Tensor],
                         params: Any, batch: Any,
                         grad_accum_iters: int = 1,
                         reduce_fn: Optional[Callable[[Any], Any]] = None):
    """``(loss, grads)`` of this rank's mean loss, the grads a tree like
    ``params`` (``torch.autograd.grad``; ``.grad`` is not touched).  With
    ``grad_accum_iters`` the leading batch dim is cut into that many
    microbatches whose losses and grads are averaged.  ``reduce_fn`` is
    applied to each microbatch's grads (the reduce-a-microbatch path);
    the returned grads are then already reduced.  The reference's step
    is built on it; :class:`DataParallel` is not (its microbatches
    accumulate in ``.grad`` so that the hooks can reduce inside the
    backward), so this is for a ``value_and_grad_fn`` of one's own."""
    leaves = list(tree_leaves(params))

    def vag(mb):
        loss = loss_fn(params, mb)
        g = _unflatten_like(params, iter(torch.autograd.grad(loss, leaves)))
        return loss.detach(), (reduce_fn(g) if reduce_fn else g)

    if grad_accum_iters == 1:
        return vag(batch)
    loss, grads = None, None
    for mb in _split_micro(batch, grad_accum_iters):
        l, g = vag(mb)
        loss = l if loss is None else loss + l
        grads = g if grads is None else _tree_map(torch.add, grads, g)
    inv = 1.0 / grad_accum_iters
    return loss * inv, _tree_map(lambda g: g * inv, grads)


#: the model axes of the port's models besides the data axes
_MODEL_AXES = (TENSOR_AXIS, PIPE_AXIS, CONTEXT_AXIS)


def normalize_model_axis_grads(loss, grads, ctx: Optional[ParallelContext]
                               = None, data_axes=(DATA_AXIS,)):
    """``(grads, other)``: the reference divides the grads by the size of
    every non-data axis the loss VARIES on (its vma type), whose
    cotangents shard_map has summed, and returns those axes.  The port
    has no vma types; the rule that takes their place: every model-axis
    loss of the port is the same on every rank of its group — a tensor-
    parallel loss closes its regions with collectives (``reduce_from_tp``,
    the vocab-parallel cross-entropy), a pipelined loss is broadcast from
    the last stage (``pipeline_parallel.last_stage_value``, the schedules'
    all-reduce), and the pipe sum of the leaves every stage holds whole is
    the schedule's own — so it varies on no model axis: ``other`` is
    ``()`` and the grads come back unscaled, which is what the reference
    returns for such a loss.  A ``context`` axis outside ``data_axes`` is
    such a model axis only for a loss that is the same on every rank of
    the context group, as the ViT's is (it pools over the group inside
    the model, and every leaf's grad comes out whole there:
    ``models.vit``).  A GPT loss is the mean over the rank's own tokens
    and varies on ``context``: ``context`` is a data axis for it, as in
    the reference.  So a ``loss`` given here (a train step's first) is
    compared across the context group, and a loss that differs there
    raises.  An axis that is no axis of the port's models raises when
    larger than 1."""
    ctx = tpc if ctx is None else ctx
    unknown = [a for a in ctx.axis_names
               if a not in data_axes and a not in _MODEL_AXES
               and ctx.get_group_size(a) > 1]
    if unknown:
        raise NotImplementedError("; ".join(
            f"model axis {a!r} is no axis of the port's models"
            for a in unknown))
    if (loss is not None and CONTEXT_AXIS in ctx.axis_names
            and CONTEXT_AXIS not in data_axes
            and ctx.get_group_size(CONTEXT_AXIS) > 1):
        _check_context_invariant(loss, ctx.get_group(CONTEXT_AXIS))
    return grads, ()


#: how far a context-invariant loss may differ across its group
#: (rounding; per-shard means of a sequence differ by far more)
_CONTEXT_LOSS_RTOL = 1e-6


def _check_context_invariant(loss: torch.Tensor, group) -> None:
    """Raise unless ``loss`` is the same on every rank of the context
    ``group``: one all-reduce MAX of ``(loss, -loss)``."""
    t = torch.stack([loss.detach().float().reshape(()),
                     -loss.detach().float().reshape(())])
    hi, neg_lo = all_reduce_(t, group, dist.ReduceOp.MAX).tolist()
    spread = hi + neg_lo
    if spread > _CONTEXT_LOSS_RTOL * max(1.0, abs(hi)):
        raise ValueError(
            f"the loss differs across the context group (max - min "
            f"{spread:.3e}): a loss that is each rank's mean over its own "
            f"tokens (a GPT under ring or Ulysses attention) needs "
            f"'context' among the reduced axes, e.g. "
            f"grad_reduce_axes=('data', 'context')")


def pipe_of(ctx: ParallelContext, params, pipe_specs) -> Optional[tuple]:
    """``(pipe group, each leaf's is-a-stage-slab flag)`` for the norm of a
    pipelined step, or None without a pipe axis above 1.  A pipe axis
    above 1 needs ``pipe_specs`` (``pipeline_parallel.stacked_param_specs``
    or ``models.gpt_param_specs(params, pipe_axis='pipe')``): the norm
    sums the stage slabs' squares over the pipe group and counts the
    leaves every stage holds whole once."""
    from .pipeline_parallel.pipeline_helper import pipe_split_flags

    if PIPE_AXIS not in ctx.axis_names or ctx.get_group_size(PIPE_AXIS) == 1:
        return None
    if pipe_specs is None:
        raise ValueError(
            f"a pipe axis of {ctx.get_group_size(PIPE_AXIS)} needs "
            f"pipe_specs: the global norm sums each stage slab's squares "
            f"over the pipe group")
    return ctx.get_group(PIPE_AXIS), pipe_split_flags(params, pipe_specs)


# ---------------------------------------------------------- DataParallel


class DataParallel:
    """Makes data-parallel (optionally accumulating) train steps
    over ``ctx``'s process groups (default ``tpc``)::

        tpc.setup_process_groups([("data", world)])
        dp = DataParallel()
        params = dp.broadcast_params(params)
        step = dp.make_train_step(loss_fn, adamw(3e-4))
        params, state, loss, gnorm = step(params, state,
                                          dp.shard_batch(global_batch))

    Every rank builds it at the same point: the groups it reduces over
    (the data axes and every override's axes) are made here.
    ``last_stats`` holds the latest step's bucket count, reduced bytes,
    the bytes whose all-reduce started before the backward returned, and
    those started before the block stack's backward was done (layer 0's
    slices ready): the part that can overlap the blocks' backward.

    ``grad_compress='int8'``: a leaf of at least ``compress_min_size``
    elements averages its mean-op axes through the int8 ring
    (``dist.compressed.int8_ring_pmean``), whole, once its grad is
    complete, outside the buckets (its layer slices are not tapped);
    ``'auto'``: the leaves ``dist.compressed.auto_compress_policy``
    chooses from ``comm_model`` (default ``CommModel.from_defaults``),
    decided at the step's first call and recorded as a
    ``compress_policy`` event."""

    def __init__(self, axis: AxisName = DATA_AXIS,
                 reduce_op: Union[str, Dict[str, str]] = "mean",
                 grad_reduce_overrides: Optional[
                     Dict[str, Tuple[str, ...]]] = None,
                 grad_compress: Optional[str] = None,
                 compress_min_size: int = 65536,
                 comm_model: Any = None,
                 bucket_cap_mb: float = BUCKET_CAP_MB,
                 ctx: Optional[ParallelContext] = None) -> None:
        self.ctx = tpc if ctx is None else ctx
        self.axis = axis
        self.axes = _axes(axis)
        _validate_reduce_op(reduce_op)
        _check_compress(grad_compress, self.axes, reduce_op)
        self.grad_compress = grad_compress
        self.compress_min_size = compress_min_size
        self.comm_model = comm_model
        self.reduce_op = reduce_op
        self.grad_reduce_overrides = {k: _axes(v) for k, v in
                                      (grad_reduce_overrides or {}).items()}
        self.bucket_bytes = int(bucket_cap_mb * 2**20)
        self.group = self.ctx.get_group(self.axes)
        for ax in self.grad_reduce_overrides.values():
            if ax:
                self.ctx.get_group(ax)
        if grad_compress is not None:  # the rings' groups, made now
            for a in self.axes:
                self.ctx.get_group(a)
            sums = tuple(a for a in self.axes
                         if _axis_op(reduce_op, a) == "sum")
            if sums:
                self.ctx.get_group(sums)
        self.last_stats: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------- placement

    def broadcast_params(self, params: Any) -> Any:
        """Every leaf set, in place, to rank 0 of the data group's value
        (the reference's wrap-time broadcast); returns ``params``.  Under
        tensor parallelism ``params`` is this rank's shard, and the ranks
        of its data group hold the same shard."""
        src = dist.get_global_rank(self.group, 0)
        with torch.no_grad():
            for p in tree_leaves(params):
                note("broadcast", p, self.group)
                if host_path(self.group, p.device):
                    h = to_host(p)
                    dist.broadcast(h, src=src, group=self.group)
                    p.copy_(from_host(h, p.device))
                else:
                    dist.broadcast(p, src=src, group=self.group)
        return params

    def shard_batch(self, batch: Any, device=None) -> Any:
        """This rank's rows of the global batch over the data group, on
        ``device`` (default: the card)."""
        return _shard_batch(batch, self.group, device)

    # ---------------------------------------------------------- step

    def _policy(self, params, tp: Optional[_TP]) -> Optional[Dict[str,
                                                                  bool]]:
        """``'auto'``'s choices for ``params`` (None otherwise): each leaf
        scored on its whole shape (a tensor-split leaf's split dim times
        the group) through ``auto_compress_policy`` over the mean-op data
        axes; the ``compress_policy`` event records them."""
        if self.grad_compress != "auto":
            return None
        from ..dist.compressed import auto_compress_policy
        from ..obs.events import default_event_log

        mean_axes = tuple(a for a in self.axes
                          if _axis_op(self.reduce_op, a) == "mean")
        leaves = [(name, _whole_shape(p, tp, i), p.element_size())
                  for i, (name, p) in enumerate(named_leaves(params))]
        policy, records = auto_compress_policy(
            leaves, "all_reduce", mean_axes, self.ctx, model=self.comm_model,
            min_size=self.compress_min_size)
        default_event_log().emit(
            "compress_policy", family="data_parallel", mode="auto",
            op="all_reduce", axes=list(mean_axes), n_leaves=len(records),
            n_compressed=sum(1 for r in records if r["compress"]),
            leaves=records)
        return policy

    def _plans(self, params, tp: Optional[_TP] = None,
               policy: Optional[Dict[str, bool]] = None
               ) -> List[Tuple[torch.Tensor, _Plan]]:
        """Each leaf's plan; under SP a leaf the specs mark
        ``PARTIAL_UNDER_SP`` also sums over the tensor axis, in the same
        bucket's all-reduce (a compressed one before its ring)."""
        out = []
        for i, (name, p) in enumerate(named_leaves(params)):
            plan = _leaf_plan(name, self.axes, self.reduce_op,
                              self.grad_reduce_overrides, self.ctx,
                              _compressed(name, p.numel(),
                                          self.grad_compress,
                                          self.compress_min_size, policy))
            if tp is not None and tp.sp and tp.specs[i] == PARTIAL_UNDER_SP:
                plan = (dataclasses.replace(plan, pre=(TENSOR_AXIS,))
                        if plan.ring else
                        _Plan(plan.axes + (TENSOR_AXIS,), plan.scale))
            out.append((p, plan))
        return out

    @contextlib.contextmanager
    def _hooked(self, plans, buckets: _Buckets, taps: bool = True):
        """Gradient hooks for one backward: each layer's slice of a
        stacked leaf (``grad_taps``) and every other leaf's accumulated
        grad (a post-accumulate hook) go into ``buckets`` as they become
        ready.  ``buckets.bytes_before_blocks_done`` notes
        the bytes already started when layer 0's backward ends.
        ``taps=False`` (a pipelined loss, whose stage runs each of its
        layers once a microbatch within the one backward): every leaf,
        stacked or not, is bucketed whole once its grad is accumulated; a
        slice tapped twice in one backward raises."""
        plan_of = {id(p): plan for p, plan in plans}
        tapped = set()  # every slice is tapped before its leaf's hook runs
        slices = set()

        def on_slice(leaf, i, g):
            if i == 0 and buckets.bytes_before_blocks_done is None:
                buckets.bytes_before_blocks_done = buckets.bytes_started
            if plan_of[id(leaf)].ring:  # reduced whole, by its leaf's hook
                return
            if (id(leaf), i) in slices:
                raise RuntimeError(
                    "a layer ran twice in one backward (a pipelined loss?): "
                    "its slice would be reduced before its grad is whole; "
                    "pass pipe_specs to make_train_step")
            slices.add((id(leaf), i))
            tapped.add(id(leaf))
            if leaf.grad is not None:  # earlier microbatches' sum
                g = g + leaf.grad[i]
            buckets.add((leaf, i), g, plan_of[id(leaf)])

        def on_leaf(leaf):
            if id(leaf) not in tapped:
                buckets.add((leaf, None), leaf.grad, plan_of[id(leaf)])

        handles = [p.register_post_accumulate_grad_hook(on_leaf)
                   for p, _ in plans if p.requires_grad]
        try:
            with (grad_taps(on_slice) if taps else contextlib.nullcontext()):
                yield
        finally:
            for h in handles:
                h.remove()

    def _reduced_backward(self, loss_fn, params, mb, plans, extra_scale,
                          taps: bool = True):
        """One microbatch's forward and backward with the hooks on, the
        rest of the buckets flushed; returns the loss and the buckets."""
        buckets = _Buckets(self.ctx.get_group, self.bucket_bytes,
                           extra_scale)
        with self._hooked(plans, buckets, taps):
            loss = loss_fn(params, mb)
            loss.backward()
        buckets.bytes_before_backward_returned = buckets.bytes_started
        buckets.flush()
        return loss.detach(), buckets

    def _mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The logged loss: the mean over the data ranks (whatever the
        grads' ops, as the reference)."""
        loss = all_reduce_(loss.detach().clone(), self.group)
        n = dist.get_world_size(self.group)
        return loss / n if n > 1 else loss

    def make_train_step(self, loss_fn: Optional[Callable] = None,
                        optimizer: Any = None,
                        grad_accum_iters: int = 1,
                        value_and_grad_fn: Optional[Callable] = None,
                        accum_reduce: str = "final",
                        numerics: bool = False, param_specs: Any = None,
                        sp: bool = False, pipe_specs: Any = None):
        """``step(params, opt_state, batch) -> (params, opt_state, loss,
        gnorm)`` on this rank's local batch, as :func:`make_train_step`
        but with the gradients reduced over the data group.

        - ``loss_fn(params, batch)`` or ``value_and_grad_fn(params,
          batch) -> (loss, grads)`` (a schedule that owns its backward;
          its grads are reduced after it returns, no overlap).
        - ``grad_accum_iters``: the local batch is cut into that many
          microbatches; grads are averaged over them.
        - ``accum_reduce='final'``: only the last microbatch's backward
          reduces (the accumulated grads); ``'microbatch'``: every
          microbatch reduces its own grads, and the reduced grads are
          averaged.
        - ``numerics``: as :func:`make_train_step`.
        - ``param_specs`` / ``sp``: tensor (and sequence) parallelism
          over ``ctx``'s ``'tensor'`` axis, as :func:`make_train_step`
          (``params`` this rank's shard, ``loss_fn`` run over the tensor
          group); under ``sp`` the ``PARTIAL_UNDER_SP`` grads reduce over
          the data and tensor axes at once.
        - ``pipe_specs``: a data x pipe layout (``params`` this stage's,
          ``loss_fn`` a pipelined loss such as
          ``pipeline_parallel.pipeline_loss``, or ``value_and_grad_fn`` a
          schedule such as ``models.gpt_pipeline_1f1b``): the grads still
          reduce over the data group only, each leaf bucketed whole (a
          stage runs each layer once a microbatch in one backward); the
          norm sums the stage slabs' squares over the pipe group
          (:func:`pipe_of`).

        The loss returned is the mean over the data ranks."""
        if (loss_fn is None) == (value_and_grad_fn is None):
            raise ValueError("pass exactly one of loss_fn / value_and_grad_fn")
        if optimizer is None:
            raise ValueError("make_train_step requires an optimizer")
        clip = clip_of(optimizer)
        if value_and_grad_fn is not None and grad_accum_iters != 1:
            raise ValueError(
                "grad_accum_iters applies to the loss_fn path only; a "
                "value_and_grad_fn owns its own microbatching")
        if accum_reduce not in ("final", "microbatch"):
            raise ValueError(f"accum_reduce must be 'final' or 'microbatch', "
                             f"got {accum_reduce!r}")
        M = grad_accum_iters
        tp_group = None
        if param_specs is not None:
            tp_group = self.ctx.get_group(TENSOR_AXIS)
            if sp:  # made now, every rank together, not inside a backward
                self.ctx.get_group(self.axes + (TENSOR_AXIS,))
                for ax in self.grad_reduce_overrides.values():
                    self.ctx.get_group(ax + (TENSOR_AXIS,))

        policies: Dict[tuple, Optional[Dict[str, bool]]] = {}

        def policy_for(params, tp):
            """'auto''s choices, decided once for each set of shapes."""
            key = tuple(tuple(p.shape) for p in tree_leaves(params))
            if key not in policies:
                policies[key] = self._policy(params, tp)
            return policies[key]

        def vag_step(params, opt_state, batch):
            tp = _tp_of(tp_group, params, param_specs, sp)
            pipe = pipe_of(self.ctx, params, pipe_specs)
            opt_state.zero_grad(set_to_none=True)
            loss, grads = value_and_grad_fn(params, batch)
            plans = self._plans(params, tp, policy_for(params, tp))
            buckets = _Buckets(self.ctx.get_group, self.bucket_bytes)
            for (p, plan), g in zip(plans, tree_leaves(grads)):
                buckets.add((p, None), g, plan)
            buckets.flush()
            n_buckets = len(buckets.started)
            for (p, _), red in buckets.finish():
                p.grad = red
            self.last_stats = {"buckets": n_buckets,
                               "bytes": buckets.bytes_started,
                               "bytes_before_backward_returned": 0,
                               "bytes_before_blocks_done": 0}
            return _update(params, opt_state, self._mean_loss(loss),
                           numerics, tp, clip, pipe)

        def step(params, opt_state, batch):
            tp = _tp_of(tp_group, params, param_specs, sp)
            pipe = pipe_of(self.ctx, params, pipe_specs)
            opt_state.zero_grad(set_to_none=True)
            plans = self._plans(params, tp, policy_for(params, tp))
            micro = [batch] if M == 1 else _split_micro(batch, M)
            # one microbatch: reducing it is reducing the final grads
            per_micro = accum_reduce == "microbatch" and M > 1
            losses, acc = [], None
            stats = dict.fromkeys(
                ("buckets", "bytes", "bytes_before_backward_returned",
                 "bytes_before_blocks_done"), 0)
            for m, mb in enumerate(micro):
                if not per_micro and m < M - 1:
                    loss = loss_fn(params, mb)
                    loss.backward()
                    losses.append(loss.detach())
                    continue
                if per_micro:
                    for p, _ in plans:
                        p.grad = None
                loss, buckets = self._reduced_backward(
                    loss_fn, params, mb, plans,
                    1.0 if per_micro else 1.0 / M,
                    taps=pipe_specs is None)
                losses.append(loss)
                stats["buckets"] += len(buckets.started)
                for (leaf, i), red in buckets.finish():
                    if per_micro:
                        if acc is None:
                            acc = {id(p): torch.zeros_like(p)
                                   for p, _ in plans}
                        dst = acc[id(leaf)]
                        (dst if i is None else dst[i]).add_(red)
                    else:  # into autograd's own grads: no view keeps
                        # a bucket's flat buffer alive past the step
                        (leaf.grad if i is None else leaf.grad[i]).copy_(red)
                stats["bytes"] += buckets.bytes_started
                stats["bytes_before_backward_returned"] += (
                    buckets.bytes_before_backward_returned)
                stats["bytes_before_blocks_done"] += (
                    buckets.bytes_before_blocks_done or 0)
            if per_micro:
                for p, _ in plans:
                    p.grad = acc[id(p)] * (1.0 / M)
            loss = losses[0]
            for l in losses[1:]:
                loss = loss + l
            if M > 1:
                loss = loss * (1.0 / M)
            self.last_stats = stats
            return _update(params, opt_state, self._mean_loss(loss),
                           numerics, tp, clip, pipe)

        return vag_step if value_and_grad_fn is not None else step
