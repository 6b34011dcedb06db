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

The optimizer is optax's ``adamw`` as ``torch.optim.AdamW``:
:func:`adamw` keeps optax's defaults (betas 0.9 / 0.999, eps 1e-8,
weight decay 1e-4 on every leaf — torch's own default is 1e-2), and the
moments take the parameters' dtype, as optax's do.  Both update
``p <- p - lr * (m̂ / (sqrt(v̂) + eps) + wd * p)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..dist.topology import DATA_AXIS, ParallelContext, tpc
from ..obs.numerics import global_grad_norm, tree_leaves
from ..utils.data import microbatch
from ..utils.data import shard_batch as _shard_batch
from ..utils.partition import named_leaves
from .tensor_parallel.layers import grad_taps

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


def _update(params, opt_state: torch.optim.AdamW, loss: torch.Tensor,
            numerics: bool):
    """The step's tail once every leaf's ``.grad`` is final: the global
    gradient norm (or the numerics dict) and one AdamW update."""
    grads = [p.grad for p in tree_leaves(params)]
    if any(g is None for g in grads):
        # AdamW would skip the leaf, weight decay included, where
        # optax decays every leaf
        raise RuntimeError("a parameter leaf got no gradient")
    gnorm = global_grad_norm(grads)
    if numerics:
        with torch.no_grad():
            stats = {
                "grad_norm": gnorm,
                "param_norm": global_grad_norm(
                    [p.detach() for p in tree_leaves(params)]),
                "nonfinite_grads": sum(
                    (~torch.isfinite(g)).sum() for g in grads),
            }
    opt_state.step()
    return params, opt_state, loss.detach(), stats if numerics else gnorm


def make_train_step(loss_fn: Callable[[Dict[str, Any], Dict[str, Any]],
                                      torch.Tensor],
                    optimizer: AdamW, numerics: bool = False):
    """``step(params, opt_state, batch) -> (params, opt_state, loss,
    gnorm)``: the loss and its gradients by autograd, the global gradient
    norm, one AdamW update.  ``opt_state`` is ``optimizer.init(params)``.

    Unlike the reference's functional step, the update is in place: the
    returned ``params`` is the same dict, its leaves updated, and the
    optimizer's moments live in ``opt_state``.  ``loss`` and ``gnorm`` are
    0-dim tensors on the device (reading them syncs).  ``numerics=True``
    returns a dict instead of ``gnorm``: ``grad_norm``, ``param_norm``
    (before the update) and ``nonfinite_grads``."""
    if not isinstance(optimizer, AdamW):
        raise TypeError(
            f"optimizer must be the port's adamw(), got {type(optimizer)}")

    def step(params: Dict[str, Any], opt_state: torch.optim.AdamW,
             batch: Dict[str, Any]) -> Tuple[Dict[str, Any], Any,
                                             torch.Tensor, Any]:
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch)
        loss.backward()
        return _update(params, opt_state, loss, numerics)

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


def _check_compress(compress) -> None:
    if compress in ("int8", "auto"):
        raise NotImplementedError(
            f"compress={compress!r}: the int8 rings are not ported yet "
            f"(ROADMAP queue A, 'Collectives')")
    if compress is not None:
        raise ValueError(f"unknown compress {compress!r}; supported: None")


@dataclasses.dataclass(frozen=True)
class _Plan:
    """How one gradient is reduced: summed over the flattened group of
    ``axes`` (none: left as it is), then multiplied by ``scale``."""

    axes: Tuple[str, ...]
    scale: float


def _leaf_plan(name: str, axes: Tuple[str, ...], reduce_op,
               overrides: Dict[str, Tuple[str, ...]],
               ctx: ParallelContext) -> _Plan:
    """The reference's ``reduce_leaf`` rule for the leaf ``name``: the
    first override whose substring is in the name sums over its axes and
    divides by the full size of the mean-op default axes; otherwise the
    mean-op axes average and the sum-op axes sum."""
    mean = math.prod(ctx.get_group_size(a) for a in axes
                     if _axis_op(reduce_op, a) == "mean")
    for tok, ax in overrides.items():
        if tok in name:
            ax = _axes(ax)
            return _Plan(ax, 1.0 / mean) if ax else _Plan((), 1.0)
    return _Plan(axes, 1.0 / mean)


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

    def _start(self, key) -> None:
        units, grads, _ = self.open.pop(key)
        plan = key[0]
        flat = torch.cat([g.reshape(-1) for g in grads])
        work = (dist.all_reduce(flat, group=self.group_of(plan.axes),
                                async_op=True) if plan.axes else None)
        self.started.append((units, [g.shape for g in grads], flat, plan,
                             work))
        self.bytes_started += flat.numel() * flat.element_size()

    def flush(self) -> None:
        for key in list(self.open):
            self._start(key)

    def finish(self) -> Iterator[Tuple[Any, torch.Tensor]]:
        """Each unit's reduced value, bucket by bucket in start order; a
        bucket's flat buffer is let go once its units are handed out."""
        while self.started:
            units, shapes, flat, plan, work = self.started.pop(0)
            if work is not None:
                work.wait()
            scale = plan.scale * self.extra_scale
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
    expert saw only its EP share of the batch).  ``compress``: the int8
    rings are not ported (``NotImplementedError``)."""
    ctx = tpc if ctx is None else ctx
    _validate_reduce_op(reduce_op)
    _check_compress(compress)
    axes, overrides = _axes(axis), dict(grad_reduce_overrides or {})
    buckets = _Buckets(ctx.get_group, BUCKET_CAP_MB * 2**20)
    names = []
    for name, g in named_leaves(grads):
        names.append(name)
        buckets.add(name, g, _leaf_plan(name, axes, reduce_op, overrides,
                                        ctx))
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


def normalize_model_axis_grads(loss, grads, ctx: Optional[ParallelContext]
                               = None, data_axes=(DATA_AXIS,)):
    """The reference rescales grads for model-axis redundancy (TP's
    summed cotangents).  Tensor parallelism is not ported (ROADMAP queue
    A, "TP + SP"), so every non-data axis must have size 1; returns
    ``(grads, ())`` then and raises otherwise."""
    ctx = tpc if ctx is None else ctx
    other = [a for a in ctx.axis_names
             if a not in data_axes and ctx.get_group_size(a) > 1]
    if other:
        raise NotImplementedError(
            f"model axes {other}: tensor parallelism is not ported yet "
            f"(ROADMAP queue A, 'TP + SP')")
    del loss
    return grads, ()


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
    slices ready): the part that can overlap the blocks' backward."""

    def __init__(self, axis: AxisName = DATA_AXIS,
                 reduce_op: Union[str, Dict[str, str]] = "mean",
                 grad_reduce_overrides: Optional[
                     Dict[str, Tuple[str, ...]]] = None,
                 grad_compress: Optional[str] = None,
                 bucket_cap_mb: float = BUCKET_CAP_MB,
                 ctx: Optional[ParallelContext] = None) -> None:
        self.ctx = tpc if ctx is None else ctx
        self.axis = axis
        self.axes = _axes(axis)
        _validate_reduce_op(reduce_op)
        _check_compress(grad_compress)
        self.reduce_op = reduce_op
        self.grad_reduce_overrides = {k: _axes(v) for k, v in
                                      (grad_reduce_overrides or {}).items()}
        self.bucket_bytes = int(bucket_cap_mb * 2**20)
        self.group = self.ctx.get_group(self.axes)
        for ax in self.grad_reduce_overrides.values():
            if ax:
                self.ctx.get_group(ax)
        self.last_stats: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------- placement

    def broadcast_params(self, params: Any) -> Any:
        """Every leaf set, in place, to rank 0 of the data group's value
        (the reference's wrap-time broadcast); returns ``params``."""
        src = dist.get_global_rank(self.group, 0)
        with torch.no_grad():
            for p in tree_leaves(params):
                dist.broadcast(p, src=src, group=self.group)
        return params

    def shard_batch(self, batch: Any, device=None) -> Any:
        """This rank's rows of the global batch over the data group, on
        ``device`` (default: the card)."""
        return _shard_batch(batch, self.group, device)

    # ---------------------------------------------------------- step

    def _plans(self, params) -> List[Tuple[torch.Tensor, _Plan]]:
        return [(p, _leaf_plan(name, self.axes, self.reduce_op,
                               self.grad_reduce_overrides, self.ctx))
                for name, p in named_leaves(params)]

    @contextlib.contextmanager
    def _hooked(self, plans, buckets: _Buckets):
        """Gradient hooks for one backward: each layer's slice of a
        stacked leaf (``grad_taps``) and every other leaf's accumulated
        grad (a post-accumulate hook) go into ``buckets`` as they become
        ready.  ``buckets.bytes_before_blocks_done`` notes
        the bytes already started when layer 0's backward ends."""
        plan_of = {id(p): plan for p, plan in plans}
        tapped = set()  # every slice is tapped before its leaf's hook runs

        def on_slice(leaf, i, g):
            if i == 0 and buckets.bytes_before_blocks_done is None:
                buckets.bytes_before_blocks_done = buckets.bytes_started
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
            with grad_taps(on_slice):
                yield
        finally:
            for h in handles:
                h.remove()

    def _reduced_backward(self, loss_fn, params, mb, plans, extra_scale):
        """One microbatch's forward and backward with the hooks on, the
        rest of the buckets flushed; returns the loss and the buckets."""
        buckets = _Buckets(self.ctx.get_group, self.bucket_bytes,
                           extra_scale)
        with self._hooked(plans, buckets):
            loss = loss_fn(params, mb)
            loss.backward()
        buckets.bytes_before_backward_returned = buckets.bytes_started
        buckets.flush()
        return loss.detach(), buckets

    def _mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The logged loss: the mean over the data ranks (whatever the
        grads' ops, as the reference)."""
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=self.group)
        n = dist.get_world_size(self.group)
        return loss / n if n > 1 else loss

    def make_train_step(self, loss_fn: Optional[Callable] = None,
                        optimizer: Optional[AdamW] = None,
                        grad_accum_iters: int = 1,
                        value_and_grad_fn: Optional[Callable] = None,
                        accum_reduce: str = "final",
                        numerics: bool = False):
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

        The loss returned is the mean over the data ranks."""
        if (loss_fn is None) == (value_and_grad_fn is None):
            raise ValueError("pass exactly one of loss_fn / value_and_grad_fn")
        if optimizer is None:
            raise ValueError("make_train_step requires an optimizer")
        if not isinstance(optimizer, AdamW):
            raise TypeError(
                f"optimizer must be the port's adamw(), got {type(optimizer)}")
        if value_and_grad_fn is not None and grad_accum_iters != 1:
            raise ValueError(
                "grad_accum_iters applies to the loss_fn path only; a "
                "value_and_grad_fn owns its own microbatching")
        if accum_reduce not in ("final", "microbatch"):
            raise ValueError(f"accum_reduce must be 'final' or 'microbatch', "
                             f"got {accum_reduce!r}")
        M = grad_accum_iters

        def vag_step(params, opt_state, batch):
            opt_state.zero_grad(set_to_none=True)
            loss, grads = value_and_grad_fn(params, batch)
            plans = self._plans(params)
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
                           numerics)

        def step(params, opt_state, batch):
            opt_state.zero_grad(set_to_none=True)
            plans = self._plans(params)
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
                    1.0 if per_micro else 1.0 / M)
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
                           numerics)

        return vag_step if value_and_grad_fn is not None else step
