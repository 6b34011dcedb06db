"""ZeRO-1/2: f32 master shards and sharded optimizer state — the port's
counterpart of ``torchdistpackage_tpu/parallel/zero.py``, hybrid
(intra-node) sharding and tensor parallelism included.

The placement rule is the reference's, one per leaf: the leaf's shard
goes on the first dim that the tensor group does not split and that the
shard group's size divides (:func:`zero_partition_spec`); a leaf with no
such dim stays whole on every rank (the small leaves the reference's
greedy partition would place whole).  For the GPT's layer-stacked
``[L, ...]`` leaves that dim can be the layer dim itself.

Each rank holds its shard of every parameter's f32 master and the inner
optimizer over those shards (``adamw()``'s moments are then f32, as
optax's are on f32 masters), beside the full parameters in the
training dtype.  A step (:meth:`ZeroOptimizer.make_train_step`):

1. this rank's loss and grads by autograd (``local_value_and_grad``);
2. each sharded leaf's grad, in f32, reduce-scattered over the shard
   group to its owner, summed over the other data axes, divided by the
   data-group size; a whole leaf's grad averaged over its axes; a
   ``grad_reduce_overrides`` leaf summed over its own axes and divided
   by the full data-group size (the MoE-DP rule);
3. the inner optimizer's update of the master shards (the shard grads
   as the masters' ``.grad``, kept until the next step; a
   :func:`~.clip.chain` clips them first, with the norm summed over the
   groups each shard is split on);
4. the re-gather: each master cast to the parameter's dtype on the
   shard, all-gathered in that dtype over the shard group (bf16: half
   the bytes) and written into the parameter in place, after the
   backward and outside autograd.

``accum_reduce='microbatch'`` reduces each microbatch's grads to the
shard inside the accumulation loop and accumulates only the shard.
Hybrid ZeRO: ``shard_axis='data_intra'``, ``grad_reduce_axes=
('data_inter', 'data_intra')`` on ``tpc.build_hybrid_mesh``'s view.
Beside TP: ``param_specs`` is the tensor group's spec tree
(``models.gpt_param_specs``), the parameters are this rank's TP shards,
and the loss runs its tensor regions as in ``data_parallel``.

Beside the pipeline (ZeRO x 1F1B): a data x pipe layout, the step's
``value_and_grad_fn`` a schedule (``models.gpt_pipeline_1f1b``) whose
grads are this stage's (the slab's own, the whole leaves' already summed
over the pipe group); each stage's masters are its own leaves' shards
over the shard axis, and ``pipe_specs`` (which leaves are stage slabs)
makes the clip chain's norm sum the slabs' squares over the pipe group
and count the whole leaves once (the reference's ``clip_grad_parallel``
over the pipe group).

Beside MoE experts and expert parallelism (the moe view of
``tpc.build_moe_mesh``): ``shard_axis='moe_dp'``, ``grad_reduce_axes=
('moe_dp', 'moe_ep')``, ``grad_reduce_overrides=
parallel.moe.moe_grad_reduce_overrides()`` — each rank's masters are the
shards over ``moe_dp`` of its own leaves (its ``E / ep`` experts
included); an expert grad reduce-scatters over ``moe_dp`` only and is
divided by the whole data group, the dense grads also sum over
``moe_ep``.

Beside context parallelism (a GPT under ring or Ulysses attention, whose
loss is the mean over each rank's sequence shard): ``shard_axis='data'``,
``grad_reduce_axes=('data', 'context')`` — the context axis is a data
axis of the reduction (JAX ``tests/test_zero.py:338``).

The int8 wire (``grad_compress``, ``dist/compressed.py``):
``'int8'`` sends a sharded leaf of at least ``compress_min_size``
elements to its owner through ``int8_ring_reduce_scatter`` and over the
other data axes through ``int8_ring_pmean``; ``'int8_ef'`` also carries
an f32 error-feedback residual a leaf in the state (``state['ef']``):
each step compresses grad + residual and keeps the quantization error
(``ef_compress``); ``'auto'`` takes the leaves
``auto_compress_policy`` chooses for the reduce-scatter and records a
``compress_policy`` event.  Override (expert) leaves and whole leaves
never compress.  ``gather_compress`` (``'follow'``: ``'int8'`` whenever
``grad_compress`` is on) re-gathers the compressed leaves through
``int8_psum_all_gather``: the wire carries quantized parameters, the
masters stay f32.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..dist.topology import (
    DATA_AXIS,
    TENSOR_AXIS,
    ParallelContext,
    tpc,
)
from ..obs.numerics import tree_leaves
from ..utils.partition import named_leaves
from .clip import clip_of, clip_scale, global_grad_norm, scale_
from .data_parallel import (
    _axes,
    _unflatten_like,
    local_value_and_grad,
    normalize_model_axis_grads,
    pipe_of,
)
from .tensor_parallel.layers import PARTIAL_UNDER_SP, spec_pairs
from .tensor_parallel.tp_utils import (
    COLLECTIVES,
    _all_gather,
    _reduce_scatter,
    all_reduce_,
)


def zero_partition_spec(shape: Sequence[int], tp_spec: Any, n: int) -> int:
    """The dim a leaf of ``shape`` is sharded on over ``n`` ranks: the
    first dim that ``tp_spec`` (the tensor group's split dim, an int
    counted from either end, or None / a marker for a whole leaf) does
    not use and that ``n`` divides; -1 when none does and the leaf stays
    whole.  The reference's rule (which inserts the axis on that dim of
    the leaf's PartitionSpec)."""
    used = tp_spec % len(shape) if isinstance(tp_spec, int) and len(
        shape) else None
    for d, size in enumerate(shape):
        if d != used and size > 0 and size % n == 0:
            return d
    return -1


def leaf_specs(params: Any, specs: Any) -> List[Any]:
    """Each leaf's tensor-parallel spec in ``tree_leaves`` order (None
    for every leaf when ``specs`` is None)."""
    if specs is None:
        return [None] * len(list(tree_leaves(params)))
    return [s for _, s in spec_pairs(params, specs)]


def shard_of(x: torch.Tensor, d: int, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank`` of ``n``'s slice of ``x`` along ``d`` (a view); ``x``
    itself for ``d < 0``."""
    if d < 0:
        return x
    c = x.shape[d] // n
    return x.narrow(d, rank * c, c)


def _psum_(t: torch.Tensor, group, name: str) -> torch.Tensor:
    """``t`` summed over ``group`` in place, counted under ``name``."""
    COLLECTIVES[name] += 1
    return all_reduce_(t, group)


def _check_compress(grad_compress, gather_compress) -> None:
    if grad_compress not in (None, "int8", "int8_ef", "auto"):
        raise ValueError(f"unknown grad_compress {grad_compress!r}; "
                         f"ZeroOptimizer supports None, 'int8', 'int8_ef' "
                         f"or 'auto'")
    if gather_compress not in (None, "int8", "follow"):
        raise ValueError(f"unknown gather_compress {gather_compress!r}")


class ZeroOptimizer:
    """An optimizer handle (``adamw()`` or a :func:`~.clip.chain`) with
    ZeRO-sharded f32 masters and state::

        zero = ZeroOptimizer(adamw(3e-4), param_dtype=torch.bfloat16)
        params = zero.place_params(params)   # the training dtype
        state = zero.init(params)            # f32 master shards
        step = zero.make_train_step(loss_fn)
        params, state, loss, gnorm = step(params, state, local_batch)

    Every rank builds it at the same point (the groups it reduces over
    are made here).  ``ctx`` defaults to ``tpc``.  On a data x pipe
    layout ``pipe_specs`` names the stage slabs (see the module note)."""

    def __init__(self, inner, shard_axis: str = DATA_AXIS,
                 grad_reduce_axes: Optional[Tuple[str, ...]] = None,
                 param_specs: Any = None,
                 param_dtype: Optional[torch.dtype] = None,
                 master_dtype: torch.dtype = torch.float32,
                 grad_reduce_overrides: Optional[Dict[str, Any]] = None,
                 grad_compress: Optional[str] = None,
                 gather_compress: Optional[str] = "follow",
                 ctx: Optional[ParallelContext] = None,
                 pipe_specs: Any = None, compress_min_size: int = 65536,
                 comm_model: Any = None) -> None:
        self.clip = clip_of(inner)
        self.inner = inner
        self.ctx = tpc if ctx is None else ctx
        self.shard_axis = shard_axis
        if grad_reduce_axes is None:
            grad_reduce_axes = (shard_axis,)
        if shard_axis not in grad_reduce_axes:
            raise ValueError(f"shard_axis {shard_axis!r} must be one of "
                             f"grad_reduce_axes {grad_reduce_axes}")
        self.grad_reduce_axes = tuple(grad_reduce_axes)
        self.grad_reduce_overrides = {k: _axes(v) for k, v in
                                      (grad_reduce_overrides or {}).items()}
        for tok, ax in self.grad_reduce_overrides.items():
            if shard_axis not in ax:
                raise ValueError(
                    f"grad_reduce_overrides[{tok!r}]={ax} must contain "
                    f"shard_axis {shard_axis!r}: ZeRO owners are shards of "
                    f"that axis (for MoE, shard over 'moe_dp' — the axis "
                    f"expert grads reduce on)")
            extra = set(ax) - set(self.grad_reduce_axes)
            if extra:
                raise ValueError(
                    f"grad_reduce_overrides[{tok!r}] axes {sorted(extra)} "
                    f"not in grad_reduce_axes {self.grad_reduce_axes}")
        _check_compress(grad_compress, gather_compress)
        self.grad_compress = grad_compress
        self.gather_compress = gather_compress
        self.compress_min_size = compress_min_size
        self.comm_model = comm_model
        # 'data' itself is a data axis when the shard axes are its parts
        self.data_axes = self.grad_reduce_axes + (DATA_AXIS,)
        normalize_model_axis_grads(None, None, self.ctx, self.data_axes)
        self.param_specs = param_specs
        self.param_dtype = param_dtype
        self.master_dtype = master_dtype
        ctx = self.ctx
        self.n = ctx.get_group_size(shard_axis)
        self.total = math.prod(ctx.get_group_size(a)
                               for a in self.grad_reduce_axes)
        self.shard_group = ctx.get_group(shard_axis)
        self.rank = dist.get_rank(self.shard_group)
        self.group = ctx.get_group(self.grad_reduce_axes)
        self._groups = {}
        for ax in (self.grad_reduce_axes,) + tuple(
                self.grad_reduce_overrides.values()):
            other = tuple(a for a in ax if a != shard_axis)
            self._groups[ax] = ctx.get_group(ax)
            self._groups[other] = ctx.get_group(other) if other else None
            for a in other:  # the int8 rings run an axis at a time
                self._groups[(a,)] = ctx.get_group(a)
        self.tp_group = (ctx.get_group(TENSOR_AXIS)
                         if param_specs is not None else None)
        self.pipe_specs = pipe_specs

    # ----------------------------------------------------------- specs

    def shard_dims(self, params: Any) -> Any:
        """Each leaf's shard dim (-1: whole), a tree like ``params``."""
        dims = [zero_partition_spec(tuple(p.shape), s, self.n) for p, s in
                zip(tree_leaves(params), leaf_specs(params,
                                                    self.param_specs))]
        return _unflatten_like(params, iter(dims))

    def _norm_groups(self, params: Any, dims: List[int]) -> List[tuple]:
        """Each shard's groups for the global norm: the shard group when
        it is sharded, the tensor group when the tensor group splits it,
        the pipe group when it is a stage slab."""
        pipe = pipe_of(self.ctx, params, self.pipe_specs)
        flags = pipe[1] if pipe is not None else [False] * len(dims)
        return [((self.shard_group,) if d >= 0 else ())
                + ((self.tp_group,) if isinstance(s, int) else ())
                + ((pipe[0],) if f else ())
                for d, s, f in zip(dims, leaf_specs(params, self.param_specs),
                                   flags)]

    # ------------------------------------------------------- placement

    def place_params(self, params: Any) -> Any:
        """The parameters in ``param_dtype`` (a new tree when it differs,
        else ``params``), every leaf trainable."""
        dt = self.param_dtype
        out = [p.detach().to(dt) if dt is not None and p.dtype != dt else p
               for p in tree_leaves(params)]
        for p in out:
            p.requires_grad_(True)
        return _unflatten_like(params, iter(out))

    def init(self, params: Any) -> Dict[str, Any]:
        """``{'master': this rank's f32 shard of every leaf, 'inner': the
        inner optimizer over those shards}``; under
        ``grad_compress='int8_ef'`` also ``'ef'``, a zero f32 residual of
        each leaf's (this rank's) shape."""
        dims = list(tree_leaves(self.shard_dims(params)))
        masters = [shard_of(p.detach(), d, self.rank, self.n).to(
            self.master_dtype, copy=True, memory_format=torch.contiguous_format)
            for p, d in zip(tree_leaves(params), dims)]
        for p in tree_leaves(params):
            p.requires_grad_(True)
        master = _unflatten_like(params, iter(masters))
        state = {"master": master, "inner": self.inner.init(master)}
        if self.grad_compress == "int8_ef":
            state["ef"] = _unflatten_like(params, iter(
                torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in tree_leaves(params)))
        return state

    def _compress_decisions(self, params: Any, shard_dims: Any
                            ) -> Tuple[Dict[str, bool], Optional[List]]:
        """Each leaf's compress / exact choice, ``(policy {name: bool},
        'auto''s records or None)``: override (expert) leaves and whole
        leaves never compress; ``'int8'`` / ``'int8_ef'`` take the size
        threshold, ``'auto'`` ``auto_compress_policy`` on the shard
        axis's reduce-scatter — both on each leaf's whole shape (a
        tensor-split leaf's split dim times the tensor group)."""
        if self.grad_compress is None:
            return {}, None
        itemsize = torch.empty((), dtype=self.master_dtype).element_size()
        tp_n = (dist.get_world_size(self.tp_group)
                if self.tp_group is not None else 1)
        policy: Dict[str, bool] = {}
        eligible = []
        for (name, p), d, s in zip(named_leaves(params),
                                   tree_leaves(shard_dims),
                                   leaf_specs(params, self.param_specs)):
            if d < 0 or any(tok in name for tok in
                            self.grad_reduce_overrides):
                policy[name] = False
                continue
            shape = list(p.shape)
            if isinstance(s, int) and shape:
                shape[s % len(shape)] *= tp_n
            eligible.append((name, tuple(shape), itemsize))
        if self.grad_compress == "auto":
            from ..dist.compressed import auto_compress_policy

            pol, records = auto_compress_policy(
                eligible, "reduce_scatter", (self.shard_axis,), self.ctx,
                model=self.comm_model, min_size=self.compress_min_size)
            policy.update(pol)
            return policy, records
        for name, shape, _ in eligible:
            policy[name] = math.prod(shape) >= self.compress_min_size
        return policy, None

    # ------------------------------------------------------ reduction

    def reduce_grads_to_shard(self, grads: Any, shard_dims: Any,
                              policy: Optional[Dict[str, bool]] = None,
                              ef: Any = None) -> Any:
        """Every rank's grads reduced to this rank's shards, as a new tree
        (see the module note, step 2).  Every rank calls it.  The
        compressed leaves (``policy``, default :meth:`_compress_decisions`
        on ``grads``) reduce through the int8 rings; with ``ef`` (a
        residual tree, ``'int8_ef'``) each compresses grad + residual and
        ``(grads, new residuals)`` is returned."""
        from ..dist.compressed import (
            ef_compress,
            int8_ring_pmean,
            int8_ring_reduce_scatter,
        )

        if policy is None:
            policy, _ = self._compress_decisions(grads, shard_dims)
        e_leaves = (list(tree_leaves(ef)) if ef is not None
                    else [None] * len(list(tree_leaves(shard_dims))))
        out, new_ef = [], []
        for (name, g), d, e in zip(named_leaves(grads),
                                   tree_leaves(shard_dims), e_leaves):
            axes, matched = self.grad_reduce_axes, False
            for tok, ax in self.grad_reduce_overrides.items():
                if tok in name:
                    axes, matched = ax, True
                    break
            other = tuple(a for a in axes if a != self.shard_axis)
            if d < 0:
                g = _psum_(g.to(self.master_dtype, copy=True),
                           self._groups[axes], "zero_all_reduce")
                size = self.total if matched else math.prod(
                    self.ctx.get_group_size(a) for a in axes)
                out.append(g / size)
                new_ef.append(e)
                continue
            g = g.to(self.master_dtype)
            if policy.get(name, False):
                with torch.no_grad():
                    if e is not None:
                        g, e = ef_compress(g + e)
                    g = int8_ring_reduce_scatter(g, self.shard_group, d)
                    for a in other:
                        # the ring's mean times the size: the sum, int8
                        g = int8_ring_pmean(g, self._groups[(a,)]) \
                            * self.ctx.get_group_size(a)
            else:
                g = _reduce_scatter(g, self.shard_group, d,
                                    "zero_reduce_scatter")
                if other:
                    _psum_(g, self._groups[other], "zero_all_reduce")
            out.append(g / self.total)
            new_ef.append(e)
        out = _unflatten_like(grads, iter(out))
        if ef is None:
            return out
        return out, _unflatten_like(grads, iter(new_ef))

    def apply_gradients(self, grads_shard: Any, state: Dict[str, Any],
                        shard_dims: Any) -> Tuple[Any, Dict[str, Any],
                                                  torch.Tensor]:
        """The inner optimizer's step on the master shards: ``(master,
        state, gnorm)``, ``gnorm`` the global norm of the shard grads
        before any clip.  The (clipped) shard grads stay the masters'
        ``.grad`` until the next step."""
        master = state["master"]
        ms, gs = list(tree_leaves(master)), list(tree_leaves(grads_shard))
        groups = self._norm_groups(master, list(tree_leaves(shard_dims)))
        with torch.no_grad():
            gnorm = global_grad_norm(gs, groups)
            if self.clip is not None:
                scale_(gs, clip_scale(gnorm, self.clip))
        for m, g in zip(ms, gs):
            m.grad = g
        state["inner"].step()
        return master, state, gnorm

    def _gather_mode(self) -> Optional[str]:
        if self.gather_compress == "follow":
            return "int8" if self.grad_compress is not None else None
        return self.gather_compress

    def regather(self, params: Any, master: Any, shard_dims: Any,
                 policy: Optional[Dict[str, bool]] = None) -> Any:
        """Every parameter set, in place, to the all-gathered master
        shards cast to its dtype (the cast on the shard, the gather in
        the parameter's dtype).  Under an int8 re-gather
        (``gather_compress``) the leaves ``policy`` compresses are
        gathered through ``int8_psum_all_gather``."""
        from ..dist.compressed import int8_psum_all_gather

        int8 = self._gather_mode() == "int8"
        policy = policy or {}
        with torch.no_grad():
            for (name, p), m, d in zip(named_leaves(params),
                                       tree_leaves(master),
                                       tree_leaves(shard_dims)):
                m = m.to(p.dtype)
                if d >= 0 and int8 and policy.get(name, False):
                    COLLECTIVES["zero_all_gather"] += 1
                    m = int8_psum_all_gather(m, self.shard_group, d)
                elif d >= 0:
                    m = _all_gather(m, self.shard_group, d, "zero_all_gather")
                p.copy_(m)
        return params

    # ------------------------------------------------------ train step

    def make_train_step(self, loss_fn: Optional[Callable] = None,
                        grad_accum_iters: int = 1,
                        value_and_grad_fn: Optional[Callable] = None,
                        accum_reduce: str = "final", sp: bool = False):
        """``step(params, state, batch) -> (params, state, loss, gnorm)``
        on this rank's local batch (the ``DataParallel`` convention): the
        loss the mean over the data group, ``gnorm`` the global norm of
        the reduced grads before any clip, ``params`` updated in place.

        ``value_and_grad_fn(params, batch) -> (loss, grads)`` replaces
        ``loss_fn`` for a schedule that owns its backward (no
        accumulation).  ``accum_reduce='microbatch'`` (``loss_fn`` with
        ``grad_accum_iters > 1``): each microbatch's grads are reduced
        to the shard inside the accumulation loop, and only the shard is
        accumulated.  ``sp``: the tensor group runs sequence parallel;
        the grads of the leaves the specs mark ``PARTIAL_UNDER_SP`` are
        summed over it."""
        if (loss_fn is None) == (value_and_grad_fn is None):
            raise ValueError("pass exactly one of loss_fn / value_and_grad_fn")
        if value_and_grad_fn is not None and grad_accum_iters != 1:
            raise ValueError(
                "grad_accum_iters applies to the loss_fn path only; a "
                "value_and_grad_fn (e.g. pipeline_1f1b) owns its own "
                "microbatching")
        if accum_reduce not in ("final", "microbatch"):
            raise ValueError(f"accum_reduce must be 'final' or 'microbatch', "
                             f"got {accum_reduce!r}")
        if sp and self.param_specs is None:
            raise ValueError("sp needs the tensor group's param_specs")
        in_scan = (accum_reduce == "microbatch" and value_and_grad_fn is None
                   and grad_accum_iters > 1)
        ef_mode = self.grad_compress == "int8_ef"
        if ef_mode and in_scan:
            # the residual is one a step; the microbatch path reduces
            # inside the accumulation loop, where it would be dropped
            raise ValueError(
                "grad_compress='int8_ef' does not compose with "
                "accum_reduce='microbatch': the error-feedback residual "
                "updates once per step, but 'microbatch' reduces inside "
                "the accumulation loop; use accum_reduce='final' or "
                "grad_compress='int8'")

        first = True
        policies: Dict[tuple, Dict[str, bool]] = {}

        def policy_for(params, dims):
            """The compress decisions, once for each set of shapes;
            'auto''s recorded as a ``compress_policy`` event."""
            key = tuple(tuple(p.shape) for p in tree_leaves(params))
            if key not in policies:
                policy, records = self._compress_decisions(params, dims)
                if records is not None:
                    from ..obs.events import default_event_log

                    default_event_log().emit(
                        "compress_policy", family="zero", mode="auto",
                        op="reduce_scatter", axes=[self.shard_axis],
                        n_leaves=len(records),
                        n_compressed=sum(1 for r in records
                                         if r["compress"]),
                        leaves=records)
                policies[key] = policy
            return policies[key]

        def step(params, state, batch):
            nonlocal first
            dims = self.shard_dims(params)
            policy = policy_for(params, dims)

            def reduce(g):
                return self.reduce_grads_to_shard(g, dims, policy)

            if value_and_grad_fn is not None:
                loss, grads = value_and_grad_fn(params, batch)
            else:
                loss, grads = local_value_and_grad(
                    loss_fn, params, batch, grad_accum_iters,
                    reduce_fn=reduce if in_scan else None)
            # the first step's loss is checked against the layout's rule
            grads, _ = normalize_model_axis_grads(
                loss if first else None, grads, self.ctx, self.data_axes)
            first = False
            if in_scan:
                g_shard = grads
            elif ef_mode:
                g_shard, state["ef"] = self.reduce_grads_to_shard(
                    grads, dims, policy, ef=state["ef"])
            else:
                g_shard = reduce(grads)
            del grads
            if sp:
                for g, s in zip(tree_leaves(g_shard),
                                leaf_specs(params, self.param_specs)):
                    if s == PARTIAL_UNDER_SP:
                        _psum_(g, self.tp_group, "zero_all_reduce")
            master, state, gnorm = self.apply_gradients(g_shard, state, dims)
            self.regather(params, master, dims, policy)
            loss = _psum_(loss.detach().clone(), self.group,
                          "zero_all_reduce") / self.total
            return params, state, loss, gnorm

        return step
