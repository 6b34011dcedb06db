"""Parallel gradient clipping and dynamic loss scaling — the port's
counterpart of ``torchdistpackage_tpu/parallel/clip.py``.

The reference's global norm sums each leaf's squares over exactly the
mesh axes the leaf varies on (its vma type), so a mix of tensor-parallel
shards, ZeRO shards and whole leaves gives the norm of the whole model.
The port has no vma types: the caller says how each leaf is split, as a
tree shaped like the gradients whose leaves are the process groups the
leaf's squares are summed over (one group, a tuple of groups, or None
for a whole leaf, counted once).  The steps that shard
(``zero.ZeroOptimizer``, ``fsdp.FSDP``, the tensor-parallel steps of
``data_parallel``) build that tree from the placements they hold.

``optax.chain(clip_by_global_norm_parallel(c), adamw(lr))`` becomes
``chain(clip_by_global_norm_parallel(c), adamw(lr))``: the port's
optimizer is a ``torch.optim`` handle, not a gradient transformation, so
:class:`Chain` is the smallest handle that puts the clip before the
update; every train step of the port accepts it where it takes
``adamw()``, and clips the gradients it would hand the optimizer (under
ZeRO the shards after the reduce-scatter, as the reference clips inside
the inner optimizer's update).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..obs.events import default_event_log
from ..obs.numerics import tree_leaves


def _as_groups(node) -> Tuple[Any, ...]:
    if node is None:
        return ()
    return tuple(node) if isinstance(node, (list, tuple)) else (node,)


def leaf_groups(grads: Any, groups: Any = None) -> List[Tuple[Any, ...]]:
    """Each tensor leaf's tuple of process groups, in ``tree_leaves``
    order: ``groups`` is walked along ``grads``' structure, and at a
    tensor of ``grads`` its node is that leaf's group, tuple of groups, or
    None (whole).  ``groups=None``: every leaf whole."""
    out: List[Tuple[Any, ...]] = []

    def walk(g, s):
        if isinstance(g, dict):
            for k, v in g.items():
                walk(v, None if s is None else s[k])
        elif isinstance(g, (list, tuple)):
            for i, v in enumerate(g):
                walk(v, None if s is None else s[i])
        elif g is not None:
            out.append(_as_groups(s))
    walk(grads, groups)
    return out


def _norms(tensors: Sequence[torch.Tensor],
           groups: Sequence[Tuple[Any, ...]]) -> torch.Tensor:
    """[sum of squares, non-finite count] of ``tensors`` (f64; each sum
    of squares formed in f32, as ``obs.numerics.global_grad_norm``):
    the leaves that share a tuple of groups are summed together, that
    sum all-reduced over each of its groups in turn, and the partial
    sums added in the order their tuples first appear (the same on every
    rank)."""
    parts: Dict[Tuple[Any, ...], torch.Tensor] = {}
    for t, gs in zip(tensors, groups):
        v = torch.stack([torch.sum(torch.square(t.float())).double(),
                         (~torch.isfinite(t)).sum().double()])
        parts[gs] = v if gs not in parts else parts[gs] + v
    out = torch.zeros(2, dtype=torch.float64, device=tensors[0].device)
    for gs, v in parts.items():
        for g in gs:
            dist.all_reduce(v, group=g)
        out += v
    return out


def global_grad_norm(grads: Any, groups: Any = None) -> torch.Tensor:
    """The global L2 norm of a gradient tree whose leaves may be split
    (``groups``: see :func:`leaf_groups`): a 0-dim f32 tensor on the
    leaves' device, the same on every rank.  Every rank of each group
    calls it."""
    leaves = list(tree_leaves(grads))
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(_norms(leaves, leaf_groups(grads, groups))[0]).float()


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / (norm + 1e-6))`` in f32 (the reference's)."""
    return torch.clamp(max_norm / (norm.float() + 1e-6), max=1.0)


def scale_(tensors, scale: torch.Tensor) -> None:
    """Each tensor multiplied by ``scale`` in place, the product formed
    in f32 and rounded to the tensor's dtype (the reference's
    ``(g * scale).astype(g.dtype)``)."""
    with torch.no_grad():
        for t in tensors:
            if t.dtype == torch.float32:
                t.mul_(scale)
            else:
                t.copy_(t.float() * scale)


def clip_grads_by_global_norm(grads: Any, max_norm: float,
                              groups: Any = None):
    """``(clipped, norm)``: a new tree, every leaf scaled by
    ``min(1, max_norm / (norm + 1e-6))``, and the pre-clip global norm
    (``groups`` as :func:`global_grad_norm`)."""
    from .data_parallel import _unflatten_like

    norm = global_grad_norm(grads, groups)
    out = [g.clone() for g in tree_leaves(grads)]
    scale_(out, clip_scale(norm, max_norm))
    return _unflatten_like(grads, iter(out)), norm


@dataclasses.dataclass(frozen=True)
class ClipByGlobalNorm:
    """The clip of :func:`clip_by_global_norm_parallel`; goes first in a
    :func:`chain`."""

    max_norm: float


def clip_by_global_norm_parallel(max_norm: float) -> ClipByGlobalNorm:
    """The counterpart of the reference's gradient transformation: chain
    it before ``adamw()`` (:func:`chain`); the step computes the norm of
    the whole model over the groups its leaves are split on."""
    return ClipByGlobalNorm(float(max_norm))


@dataclasses.dataclass(frozen=True)
class Chain:
    """``clip`` then ``opt``: ``opt_state = chain(...).init(params)`` is
    ``opt``'s ``torch.optim.AdamW``; the steps clip before its update."""

    clip: ClipByGlobalNorm
    opt: Any

    def init(self, params: Any) -> torch.optim.AdamW:
        return self.opt.init(params)


def chain(*transforms) -> Chain:
    """``optax.chain`` for the one composition the port has: a
    :func:`clip_by_global_norm_parallel` then ``adamw()``."""
    from .data_parallel import AdamW

    if (len(transforms) != 2 or not isinstance(transforms[0],
                                               ClipByGlobalNorm)
            or not isinstance(transforms[1], AdamW)):
        raise TypeError("chain takes clip_by_global_norm_parallel(c) then "
                        "the port's adamw(); got "
                        f"{[type(t).__name__ for t in transforms]}")
    return Chain(*transforms)


def clip_of(optimizer) -> Optional[float]:
    """The step's optimizer handle checked: ``adamw()`` (no clip, None) or
    a :class:`Chain` (its ``max_norm``)."""
    from .data_parallel import AdamW

    if isinstance(optimizer, Chain):
        return optimizer.clip.max_norm
    if isinstance(optimizer, AdamW):
        return None
    raise TypeError(f"optimizer must be the port's adamw() or "
                    f"chain(clip_by_global_norm_parallel(c), adamw()), got "
                    f"{type(optimizer)}")


# ------------------------------------------------------ dynamic loss scale


class LossScaleState(NamedTuple):
    scale: torch.Tensor       # 0-dim f32
    good_steps: torch.Tensor  # 0-dim int32


class DynamicLossScale:
    """Dynamic loss scaling (the reference's ``NativeScalerPP`` parity):
    unscale the gradients; if any is not finite on any rank of the groups
    they are split on, zero them and halve the scale (floor 1.0); grow it
    by ``factor`` after ``growth_interval`` clean steps.  With
    ``emit_events`` a change of the scale is a ``loss_scale`` event in
    the process-wide ``obs.events`` log (reading the scale syncs)."""

    def __init__(self, init_scale: float = 2.0 ** 15,
                 growth_interval: int = 2000, factor: float = 2.0,
                 emit_events: bool = True) -> None:
        self.init_scale = init_scale
        self.growth_interval = growth_interval
        self.factor = factor
        self.emit_events = emit_events

    def init(self, device=None) -> LossScaleState:
        dev = resolve_device(device)
        return LossScaleState(
            torch.tensor(self.init_scale, dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))

    def scale_loss(self, loss: torch.Tensor, state: LossScaleState):
        return loss * state.scale

    def unscale_and_update(self, grads: Any, state: LossScaleState,
                           groups: Any = None):
        """``(grads, new_state, finite)``: a new tree of unscaled
        gradients (zeros when any is not finite), the next state, and
        whether every gradient was finite on every rank (a MIN all-reduce
        over each group of ``groups``, as :func:`leaf_groups`)."""
        from .data_parallel import _unflatten_like

        inv = 1.0 / state.scale
        leaves = [g * inv for g in tree_leaves(grads)]
        finite = torch.ones((), dtype=torch.int32, device=state.scale.device)
        for g in leaves:
            finite = finite * torch.isfinite(g).all().int()
        seen = []
        for gs in leaf_groups(grads, groups):
            for g in gs:
                if not any(g is s for s in seen):
                    seen.append(g)
                    dist.all_reduce(finite, op=dist.ReduceOp.MIN, group=g)
        ok = finite.bool()
        grow = state.good_steps + 1 >= self.growth_interval
        new_scale = torch.where(
            ok, torch.where(grow, state.scale * self.factor, state.scale),
            torch.clamp(state.scale / self.factor, min=1.0))
        new_good = torch.where(
            ok, (state.good_steps + 1) % self.growth_interval,
            torch.zeros_like(state.good_steps))
        leaves = [torch.where(ok, g, torch.zeros_like(g)) for g in leaves]
        if self.emit_events:
            old, new = float(state.scale), float(new_scale)
            if old != new:
                default_event_log().emit("loss_scale", old=old, new=new)
        return (_unflatten_like(grads, iter(leaves)),
                LossScaleState(new_scale, new_good), ok)
