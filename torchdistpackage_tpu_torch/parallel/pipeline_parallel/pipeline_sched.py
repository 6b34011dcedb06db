"""Pipeline schedules over a pipe process group — the port's counterpart
of ``torchdistpackage_tpu/parallel/pipeline_parallel/pipeline_sched.py``
(the reference's 1F1B scheduler and its p2p layer).

The JAX package runs a schedule as ONE SPMD program: a ``lax.scan`` over
ticks inside ``shard_map``, activations moved by ``ppermute`` over the
``pipe`` axis, the backward by AD through the scan (or a ``jax.vjp`` per
tick in 1F1B).  The port has no program that spans ranks, so it runs the
reference's own design, MPMD: each rank of the pipe group
(``pipe_group=``, default ``tpc.get_group(pipe_axis)``) is one stage and
runs its own loop in Python, exchanging activations and cotangents with
its neighbours by point-to-point messages (``_p2p.exchange``: every step's
sends and receives in one ``batch_isend_irecv``).  The public contracts
are the JAX package's:

- :func:`pipeline_forward` / :func:`pipeline_loss`, the fill-drain
  schedule differentiated by the caller's autograd.  :func:`shift_right`
  / :func:`shift_left` are autograd Functions whose backward is the
  reverse shift (JAX's transpose of ``ppermute``), and
  :func:`last_stage_value` a masked all-reduce whose backward hands each
  rank its own cotangent (every rank seeds the same loss, so a summing
  backward would give P times the grads).  Each stage keeps the JAX
  carry chain: a tick's input is ``where(first, mb, state)``, so every
  stage's graph is one chain and its backward runs its messages in the
  same reverse-tick order as its neighbours'.
- :func:`pipeline_1f1b` returns ``(loss, grads)`` (do not differentiate
  it).  Classic (``num_chunks=1``): Megatron's order — ``min(P - s - 1,
  M)`` warm-up forwards, then one forward and one backward at a time,
  then the cool-down — so stage ``s`` holds at most ``min(M, P - s)``
  microbatch graphs (``last_stats['max_in_flight']``).  The forward unit
  runs under autograd and keeps its graph; the backward unit is
  ``torch.autograd.backward(y, grad_y)``, the reference's idiom.  (JAX
  recomputes the stage in its backward unit; keeping the graph gives the
  same grads from one forward a unit, and ``remat=`` still acts inside the
  stage through ``scan_blocks``.)  Interleaved (``num_chunks=V > 1``):
  JAX's tick schedule, each tick one forward unit in Megatron's
  virtual-stage order ``sigma(v, m)`` and one backward unit mirrored,
  the ``P-1 -> 0`` wrap edge a real message, at most
  :func:`ring_slots` chunk graphs in flight.
- The grads of the leaves every stage holds whole (embedding, final
  norm, head: every leaf whose spec does not name the pipe axis, see
  ``pipeline_helper.pipe_split_flags``) are summed over the pipe group
  once, after the schedule (JAX's ``sync``); the stage slabs' stay local.
  The loss is the same on every stage.

``transfer_shard_group`` (JAX's ``transfer_shard_axis``, the reference's
``scatter_gather_tensors``): the inter-stage state is carried sliced
1/tp over the tensor group on its first divisible dim, sliced at each
stage exit (``split_to_sp``: backward all-gather) and all-gathered at
each entry by a region whose backward takes the rank's own slice.  The
port's tensor regions keep a replicated activation's cotangent whole on
every rank (``copy_to_tp`` sums the partial ones where they arise), so
that split backward gives exact grads with every rank seeding 1; it is
the port's form of JAX's closing rule (:578-590), which pairs a
``psum_scatter`` at the entry with a ``pmean`` of each escaping scalar —
a reduce-scatter here would make every grad tp times too large.
"""

from __future__ import annotations

import collections
import inspect
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ...dist.topology import PIPE_AXIS, tpc
from ...obs.numerics import tree_leaves
from ..tensor_parallel.layers import RematMode, checkpoint_block
from ..tensor_parallel.tp_utils import gather_whole, split_to_sp
from . import _p2p
from ._p2p import ACT, COT
from .pipeline_helper import pipe_split_flags

#: the latest schedule's stage, sizes, in-flight count and bound and its
#: point-to-point traffic (``_p2p.P2P_STATS`` over the call); updated in
#: place by every schedule
last_stats: Dict[str, Any] = {}


def _group(pipe_axis: str = PIPE_AXIS, pipe_group=None):
    return pipe_group if pipe_group is not None else tpc.get_group(pipe_axis)


def stage_index(pipe_axis: str = PIPE_AXIS, pipe_group=None) -> int:
    """This rank's stage: its rank in the pipe group."""
    return dist.get_rank(_group(pipe_axis, pipe_group))


def num_stages(pipe_axis: str = PIPE_AXIS, pipe_group=None) -> int:
    return dist.get_world_size(_group(pipe_axis, pipe_group))


def is_first_stage(pipe_axis: str = PIPE_AXIS, pipe_group=None) -> bool:
    return stage_index(pipe_axis, pipe_group) == 0


def is_last_stage(pipe_axis: str = PIPE_AXIS, pipe_group=None) -> bool:
    g = _group(pipe_axis, pipe_group)
    return dist.get_rank(g) == dist.get_world_size(g) - 1


# ------------------------------------------------------- differentiable p2p


class _LastStageValue(torch.autograd.Function):
    """Forward: the last stage's ``x`` on every stage (a masked
    all-reduce).  Backward: each rank's own cotangent, not summed."""

    @staticmethod
    def forward(ctx, x, group):
        last = dist.get_rank(group) == dist.get_world_size(group) - 1
        v = x.detach().clone() if last else torch.zeros_like(x)
        return _p2p.all_reduce_(v, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def last_stage_value(x: torch.Tensor, pipe_axis: str = PIPE_AXIS,
                     pipe_group=None) -> torch.Tensor:
    """The last stage's (small) value on every stage: mask + all-reduce
    over the pipe group, differentiable (see :class:`_LastStageValue`)."""
    return _LastStageValue.apply(x, _group(pipe_axis, pipe_group))


class _Shift(torch.autograd.Function):
    """Send ``x`` to stage ``dst`` and receive a tensor of ``x``'s shape
    from stage ``src`` (None: nothing; zeros come out), on channel
    ``tags[0]``; the backward sends the output's cotangent to ``src`` and
    receives ``x``'s from ``dst`` on ``tags[1]`` — the reverse shift."""

    @staticmethod
    def forward(ctx, x, group, dst, src, tags):
        ctx.group, ctx.dst, ctx.src, ctx.tags = group, dst, src, tags
        ctx.like = (tuple(x.shape), x.dtype, x.device)
        got = _p2p.exchange(
            group, [(x, dst, tags[0])] if dst is not None else [],
            [(src, tags[0]) + ctx.like] if src is not None else [])
        return got[0] if got else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        got = _p2p.exchange(
            ctx.group, [(g, ctx.src, ctx.tags[1])] if ctx.src is not None
            else [], [(ctx.dst, ctx.tags[1]) + ctx.like]
            if ctx.dst is not None else [])
        gx = got[0] if got else torch.zeros(ctx.like[0], dtype=ctx.like[1],
                                            device=ctx.like[2])
        return gx, None, None, None, None


def shift_right(x: torch.Tensor, pipe_axis: str = PIPE_AXIS,
                circular: bool = False, pipe_group=None) -> torch.Tensor:
    """Stage ``s``'s value arrives at ``s + 1`` (every stage holds a tensor
    of one shape).  Non-circular: stage 0 receives zeros (the reference's
    ``send_forward`` / ``recv_forward``); ``circular``: stage 0 receives
    stage ``P - 1``'s, the interleaved schedule's wrap edge.  Its backward
    is :func:`shift_left`'s exchange."""
    g = _group(pipe_axis, pipe_group)
    P, s = dist.get_world_size(g), dist.get_rank(g)
    if P == 1:
        return x if circular else torch.zeros_like(x)
    dst = (s + 1) % P if (circular or s < P - 1) else None
    src = (s - 1) % P if (circular or s > 0) else None
    return _Shift.apply(x, g, dst, src, (ACT, COT))


def shift_left(x: torch.Tensor, pipe_axis: str = PIPE_AXIS,
               circular: bool = False, pipe_group=None) -> torch.Tensor:
    """Stage ``s``'s value arrives at ``s - 1`` — the cotangent channel
    (the reference's ``send_backward`` / ``recv_backward``);
    ``circular``: stage ``P - 1`` receives stage 0's."""
    g = _group(pipe_axis, pipe_group)
    P, s = dist.get_world_size(g), dist.get_rank(g)
    if P == 1:
        return x if circular else torch.zeros_like(x)
    dst = (s - 1) % P if (circular or s > 0) else None
    src = (s + 1) % P if (circular or s < P - 1) else None
    return _Shift.apply(x, g, dst, src, (COT, ACT))


class _Tie(torch.autograd.Function):
    """``value``, with ``others`` in its graph (zero cotangents): puts a
    stage's last carry into the loss, so every stage's backward walks its
    whole chain of shifts."""

    @staticmethod
    def forward(ctx, value, *others):
        ctx.likes = [(o.shape, o.dtype, o.device) for o in others]
        return value.view_as(value)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=d, device=v)
                            for s, d, v in ctx.likes)


# ----------------------------------------------------- tensor-sharded state


def _transfer_dim(shape, n: int) -> int:
    """The dim a sharded transfer slices: the first one ``n`` divides
    (batch and sequence dims come first); -1: the state goes whole."""
    for d, s in enumerate(shape):
        if s % n == 0 and s >= n:
            return d
    return -1


class _Transfer:
    """Slices a state at a stage's exit and gathers it at the entry."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        self.dim = None

    def bind(self, full_shape) -> None:
        self.dim = _transfer_dim(full_shape, self.n)

    def slice(self, x):
        return x if self.dim < 0 else split_to_sp(x, self.group, self.dim)

    def gather(self, x):
        return x if self.dim < 0 else gather_whole(x, self.group, self.dim,
                                                   "transfer_gather")



# ----------------------------------------------------------- fill-drain


def _take(tree, i: int):
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_take(v, i) for v in tree)
    return tree[i]


def _device_of(*trees) -> torch.device:
    for t in trees:
        for x in tree_leaves(t):
            return x.device
    return torch.device("cpu")


_TRUE: Dict[torch.device, torch.Tensor] = {}


def _chain(x_in: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """``where(first, mb, state)`` on the first stage: ``x_in``, with the
    carry in its graph (a zero cotangent)."""
    t = _TRUE.get(x_in.device)
    if t is None:
        t = _TRUE[x_in.device] = torch.ones((), dtype=torch.bool,
                                            device=x_in.device)
    return torch.where(t, x_in, state)


def _pipeline_scan(stage_params, microbatches, stage_fn, M: int, group,
                   remat: RematMode, consume, first_fn=None, params=None):
    """The fill -> drain loop of :func:`pipeline_forward` and
    :func:`pipeline_loss`: ``M + P - 1`` ticks; stage ``s`` runs
    microbatch ``t - s`` at tick ``t`` (stage 0 from ``microbatches``,
    through ``first_fn(params, mb)`` when given), hands the output to
    ``consume(y, m)`` on the last stage and to :func:`_Shift` everywhere.
    A stage idle at a tick passes its carry through (no compute).
    Returns the last carry (to tie into the caller's result)."""
    P, s = dist.get_world_size(group), dist.get_rank(group)
    body = checkpoint_block(stage_fn, remat)
    first, last = s == 0, s == P - 1
    dev = _device_of(stage_params, microbatches, params)

    def first_x(t):
        mb = _take(microbatches, min(t, M - 1))
        return first_fn(params, mb) if first_fn is not None else mb

    x0 = first_x(0) if first else None
    if P > 1:
        shape, dtype = _p2p.shape_preamble(group, x0, dev)
    else:
        shape, dtype = tuple(x0.shape), x0.dtype
    state = torch.zeros(shape, dtype=dtype, device=dev,
                        requires_grad=torch.is_grad_enabled())
    for t in range(M + P - 1):
        active = s <= t < s + M
        if active:
            x = _chain(x0 if t == 0 else first_x(t), state) if first \
                else state
            y = body(stage_params, x)
            if tuple(y.shape) != shape or y.dtype != dtype:
                raise ValueError(
                    f"stage_fn must preserve activation shape/dtype for "
                    f"pipelining: {shape}/{dtype} -> "
                    f"{tuple(y.shape)}/{y.dtype}")
            if last:
                consume(y, t - (P - 1))
        else:
            y = state
        dst = s + 1 if active and not last else None
        src = s - 1 if (s > 0 and s - 1 <= t < s - 1 + M) else None
        state = (_Shift.apply(y, group, dst, src, (ACT, COT))
                 if dst is not None or src is not None else y)
    return state


def pipeline_forward(stage_params, microbatches, stage_fn: Callable,
                     num_microbatches: int, pipe_axis: str = PIPE_AXIS,
                     remat: RematMode = True, collect_outputs: bool = True,
                     first_fn: Optional[Callable] = None, params=None,
                     pipe_group=None):
    """The pipelined forward: ``stage_params`` this stage's own params
    (its slab of a stacked stack), ``microbatches`` ``[M, mbs, ...]``
    (read on stage 0; pass the same everywhere), ``stage_fn(stage_params,
    x) -> y`` keeping ``x``'s shape and dtype.  Returns the outputs
    ``[M, mbs, ...]``, valid on the LAST stage (zeros elsewhere; combine
    with :func:`last_stage_value`), or None without ``collect_outputs``.
    ``first_fn(params, mb) -> x``: stage 0's per-tick preprocessing."""
    group = _group(pipe_axis, pipe_group)
    M = num_microbatches
    outs: List[Optional[torch.Tensor]] = [None] * M

    def consume(y, m):
        outs[m] = y

    tail = _pipeline_scan(stage_params, microbatches, stage_fn, M, group,
                          remat, consume, first_fn, params)
    if not collect_outputs:
        return None
    if outs[0] is None:
        out = torch.zeros((M,) + tuple(tail.shape), dtype=tail.dtype,
                          device=tail.device)
    else:
        out = torch.stack(outs)
    return _Tie.apply(out, tail) if tail.requires_grad else out


def pipeline_loss(stage_params, microbatches, targets,
                  stage_fn: Callable, loss_fn: Callable,
                  num_microbatches: int, pipe_axis: str = PIPE_AXIS,
                  remat: RematMode = True,
                  first_fn: Optional[Callable] = None, params=None,
                  pipe_group=None,
                  loss_takes_params: bool = False) -> torch.Tensor:
    """Pipelined forward plus each microbatch's ``loss_fn(y, target)`` on
    the last stage; returns the mean loss, the same on every stage
    (:func:`last_stage_value`), for the caller's ``backward()`` on every
    stage.  ``targets`` ``[M, ...]`` (read on the last stage).

    ``params`` (for ``first_fn``; with ``loss_takes_params`` also handed
    to ``loss_fn(params, y, target)``): leaves every stage holds whole.
    They enter through one identity node whose backward sums their grads
    over the pipe group — the first node each stage creates, so the last
    its backward runs, after every message — and every stage ends its
    backward with the whole grads (JAX gets the sum from ``shard_map``'s
    transpose)."""
    group = _group(pipe_axis, pipe_group)
    M, P = num_microbatches, dist.get_world_size(group)
    last = dist.get_rank(group) == P - 1
    if params is not None and P > 1:
        params = _pipe_summed(params, group)
    acc = {"sum": None}

    def consume(y, m):
        tgt = _take(targets, m)
        v = loss_fn(params, y, tgt) if loss_takes_params else loss_fn(y, tgt)
        acc["sum"] = v if acc["sum"] is None else acc["sum"] + v

    tail = _pipeline_scan(stage_params, microbatches, stage_fn, M, group,
                          remat, consume, first_fn, params)
    total = acc["sum"] if last else torch.zeros(
        (), dtype=torch.float32, device=tail.device)
    if total.dtype != torch.float32:
        total = total.float()
    ties = [tail] if tail.requires_grad else []
    if params is not None and P > 1:
        ties += [p for p in tree_leaves(params) if p.requires_grad]
    if ties:
        total = _Tie.apply(total, *ties)
    return last_stage_value(total, pipe_group=group) / M


class _PipeSum(torch.autograd.Function):
    """Identity on a list of leaves whose backward sums their cotangents
    over the pipe group, one flat all-reduce a dtype (absent ones as
    zeros)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.likes = [(x.shape, x.dtype, x.device) for x in xs]
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = [g if g is not None else torch.zeros(s, dtype=d, device=v)
              for g, (s, d, v) in zip(gs, ctx.likes)]
        by = collections.defaultdict(list)
        for i, g in enumerate(gs):
            by[g.dtype].append(i)
        out = list(gs)
        for idx in by.values():
            flat = torch.cat([gs[i].reshape(-1) for i in idx])
            _p2p.all_reduce_(flat, ctx.group)
            off = 0
            for i in idx:
                n = gs[i].numel()
                out[i] = flat[off:off + n].view_as(gs[i])
                off += n
        return (None,) + tuple(out)


def _pipe_summed(params, group):
    """``params`` with every grad-requiring tensor through one
    :class:`_PipeSum` node."""
    from ..data_parallel import _unflatten_like

    leaves = list(tree_leaves(params))
    idx = [i for i, p in enumerate(leaves) if p.requires_grad]
    if not idx:
        return params
    outs = _PipeSum.apply(group, *(leaves[i] for i in idx))
    for i, o in zip(idx, outs):
        leaves[i] = o
    return _unflatten_like(params, iter(leaves))


# --------------------------------------------------------------------- 1F1B


def ring_slots(num_microbatches: int, pipe_size: int,
               num_chunks: int = 1) -> int:
    """``min(V M, 2 P V - 1)``: the stage inputs the JAX tick schedule
    keeps live, the bound of the interleaved schedule's chunk graphs in
    flight (classic 1F1B keeps fewer, ``min(M, P - s)``)."""
    return min(num_microbatches * num_chunks, 2 * pipe_size * num_chunks - 1)


def _check_arity(stage_fn) -> None:
    try:
        sig = inspect.signature(stage_fn).parameters.values()
    except (TypeError, ValueError):
        return
    if any(p.kind is inspect.Parameter.VAR_POSITIONAL for p in sig):
        return
    n_pos = sum(p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                           inspect.Parameter.POSITIONAL_OR_KEYWORD)
                for p in sig)
    if n_pos < 4:
        raise ValueError(
            f"num_chunks > 1 (interleaved schedule) requires a stage_fn "
            f"with signature (params, x, microbatch_idx, chunk_idx); got a "
            f"callable taking {n_pos} positional args. The scheduler passes "
            f"m to replay per-microbatch behavior in the backward recompute "
            f"and v to select the chunk's param slab.")


class _Stage:
    """One stage's side of a schedule: its group position, the state's
    shape, the message helpers, the grads and the in-flight count."""

    def __init__(self, params, inputs, targets, first_fn, call_stage,
                 last_fn, M, group, V, circular, transfer, param_specs,
                 pipe_axis, returns_aux):
        self.params, self.inputs, self.targets = params, inputs, targets
        self.first_fn, self.call_stage, self.last_fn = (first_fn, call_stage,
                                                        last_fn)
        self.M, self.V, self.group = M, V, group
        self.P, self.s = dist.get_world_size(group), dist.get_rank(group)
        self.first, self.last = self.s == 0, self.s == self.P - 1
        self.circular = circular
        self.nxt = (self.s + 1) % self.P if circular or not self.last \
            else None
        self.prv = (self.s - 1) % self.P if circular or not self.first \
            else None
        self.transfer = transfer
        self.returns_aux = returns_aux
        self.leaves = list(tree_leaves(params))
        self.split = pipe_split_flags(params, param_specs, pipe_axis)
        self.device = _device_of(params, inputs)
        self.loss = torch.zeros((), dtype=torch.float32, device=self.device)
        self.live = 0
        self.max_live = 0
        self.shape = self.dtype = None

    # ------------------------------------------------------------ grads

    def __enter__(self):
        self.saved = []
        for p in self.leaves:
            if p.is_leaf and p.is_floating_point() and not p.requires_grad:
                p.requires_grad_(True)
            self.saved.append(p.grad)
            p.grad = None
        return self

    def __exit__(self, *exc):
        if exc[0] is not None:
            for p, g in zip(self.leaves, self.saved):
                p.grad = g
        return False

    def grads(self):
        """The accumulated grads over M, the replicated leaves' summed
        over the pipe group (one flat all-reduce a dtype); ``.grad``
        restored."""
        inv = 1.0 / self.M
        out = []
        for p, g in zip(self.leaves, self.saved):
            gr = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = g
            out.append(gr * inv)
        self.sync(out)
        from ..data_parallel import _unflatten_like

        return _unflatten_like(self.params, iter(out))

    def sync(self, grads: List[torch.Tensor]) -> None:
        """JAX's ``sync``: every replicated leaf's grad summed over the
        pipe group (the stage slabs' stay local)."""
        if self.P == 1:
            return
        rep = [g for g, sp in zip(grads, self.split) if not sp]
        by = collections.defaultdict(list)
        for g in rep:
            by[g.dtype].append(g)
        for gs in by.values():
            flat = torch.cat([g.reshape(-1) for g in gs])
            _p2p.all_reduce_(flat, self.group)
            off = 0
            for g in gs:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()

    def mean_loss(self) -> torch.Tensor:
        loss = self.loss.clone()
        if self.P > 1:
            _p2p.all_reduce_(loss, self.group)
        return loss / self.M

    # -------------------------------------------------------- messages

    def begin(self):
        """Stage 0's first stage input and the shape preamble (every stage
        joins it before its first receive); returns that input on stage 0,
        None elsewhere."""
        x0 = self.stage_input(0) if self.first else None
        if self.P > 1:
            self.shape, self.dtype = _p2p.shape_preamble(self.group, x0,
                                                         self.device)
        else:
            self.shape, self.dtype = tuple(x0.shape), x0.dtype
        return x0

    def comm(self, send_act=None, recv_act=False, send_cot=None,
             recv_cot=False):
        """One step's messages (activations go to ``nxt``, cotangents to
        ``prv``), in one batch; returns ``(act, cot)`` received.  A
        one-stage interleaved schedule's wrap edge is the stage itself:
        what it sends is what it receives."""
        if self.P == 1:
            return (send_act if recv_act else None,
                    send_cot if recv_cot else None)
        like = (self.shape, self.dtype, self.device)
        sends, recvs = [], []
        if send_act is not None:
            sends.append((send_act, self.nxt, ACT))
        if recv_act:
            recvs.append((self.prv, ACT) + like)
        if send_cot is not None:
            sends.append((send_cot, self.prv, COT))
        if recv_cot:
            recvs.append((self.nxt, COT) + like)
        got = iter(_p2p.exchange(self.group, sends, recvs))
        return (next(got) if recv_act else None,
                next(got) if recv_cot else None)

    # ------------------------------------------------------------ units

    def stage_input(self, m: int):
        """Stage 0's input for microbatch ``m``."""
        return self.first_fn(self.params, _take(self.inputs, m))

    def forward(self, x, m: int, v: int, head: bool):
        """One forward unit under autograd; returns ``(unit, y)``: the
        kept graph and the output to send (None at the model's tail).
        ``x``: a received state (made a grad-requiring leaf here) or, on
        the model's head chunk, stage 0's input."""
        if not head:
            x = x.requires_grad_(True)
        out = self.call_stage(self.params, x, m, v)
        y, aux = out if self.returns_aux else (out, None)
        if tuple(y.shape) != self.shape or y.dtype != self.dtype:
            raise ValueError(
                f"stage_fn must preserve activation shape/dtype for "
                f"pipelining: {self.shape}/{self.dtype} -> "
                f"{tuple(y.shape)}/{y.dtype}")
        outs, seeds = [], []
        if aux is not None:
            self.loss = self.loss + aux.detach().float()
            outs.append(aux)
            seeds.append(torch.ones_like(aux))
        send = None
        if self.last and v == self.V - 1:
            loss_m = self.last_fn(self.params, y, _take(self.targets, m))
            self.loss = self.loss + loss_m.detach().float()
            outs.append(loss_m)
            seeds.append(torch.ones_like(loss_m))
        else:
            outs.append(y)
            seeds.append(None)
            send = y.detach()
        self.live += 1
        self.max_live = max(self.max_live, self.live)
        return (x, outs, seeds, head), send

    def backward(self, unit, g):
        """One backward unit: ``torch.autograd.backward`` of the kept
        graph with ``g`` as the output's cotangent; returns the input's
        cotangent (None on the model's head chunk)."""
        x, outs, seeds, head = unit
        seeds = [g if sd is None else sd for sd in seeds]
        torch.autograd.backward(outs, seeds)
        self.live -= 1
        if head:
            return None
        return x.grad if x.grad is not None else torch.zeros_like(x)


def _classic(st: _Stage) -> None:
    """Megatron's non-interleaved 1F1B, every exchange a paired batch."""
    P, s, M = st.P, st.s, st.M
    warm = min(P - s - 1, M)
    rest = M - warm
    live = collections.deque()
    x0 = st.begin()

    def inp(m, recv):
        if st.first:
            return (x0 if m == 0 else st.stage_input(m)), True
        return recv, False

    nxt_in = None
    for i in range(warm):
        if not st.first:
            nxt_in, _ = st.comm(recv_act=True)
        x, head = inp(i, nxt_in)
        unit, y = st.forward(x, i, 0, head)
        live.append(unit)
        st.comm(send_act=y)
    if rest > 0 and not st.first:
        nxt_in, _ = st.comm(recv_act=True)
    for i in range(rest):
        m = warm + i
        x, head = inp(m, nxt_in)
        unit, y = st.forward(x, m, 0, head)
        live.append(unit)
        _, g = st.comm(send_act=y, recv_cot=not st.last)
        dx = st.backward(live.popleft(), g)
        if i == rest - 1:
            st.comm(send_cot=dx)
        else:
            nxt_in, _ = st.comm(send_cot=dx, recv_act=not st.first)
    for i in range(warm):
        _, g = st.comm(recv_cot=True)
        dx = st.backward(live.popleft(), g)
        st.comm(send_cot=dx)


def _unit_of(k: int, P: int, V: int):
    """Forward unit ``k`` of a stage: ``(v, m)`` by Megatron's order
    ``sigma(v, m) = (m // P) P V + v P + m % P``."""
    r = k % (P * V)
    return r // P, (k // (P * V)) * P + r % P


def _bwd_unit_of(k: int, P: int, V: int):
    """Backward unit ``k``: ``(v, m, forward counter)``, chunks in the
    reverse order."""
    r = k % (P * V)
    v = (V - 1) - r // P
    m = (k // (P * V)) * P + r % P
    return v, m, (k // (P * V)) * (P * V) + v * P + r % P


def _ticks(st: _Stage) -> None:
    """JAX's tick schedule (the interleaved one at ``V > 1``): tick ``t``
    runs forward unit ``t - s`` and backward unit ``t - (P - 1 - s) - (P V
    - 1)``, then one batch of messages; the forward units keep their
    graphs until their backward."""
    P, s, M, V = st.P, st.s, st.M, st.V
    T = V * M + P * V + P - 2
    live: Dict[int, Any] = {}
    x0 = st.begin()
    act = cot = None

    def f_unit(t):
        k = t - s
        return (k,) + _unit_of(k, P, V) if 0 <= k < V * M else None

    def b_unit(t):
        k = t - (P - 1 - s) - (P * V - 1)
        return _bwd_unit_of(k, P, V) if 0 <= k < V * M else None

    for t in range(T):
        send_act = send_cot = None
        fu = f_unit(t)
        if fu is not None:
            k, v, m = fu
            head = st.first and v == 0
            x = (x0 if m == 0 else st.stage_input(m)) if head else act
            live[k], send_act = st.forward(x, m, v, head)
        bu = b_unit(t)
        if bu is not None:
            v, m, k = bu
            g = None if (st.last and v == V - 1) else cot
            send_cot = st.backward(live.pop(k), g)
        nf, nb = f_unit(t + 1), b_unit(t + 1)
        need_act = nf is not None and not (st.first and nf[1] == 0)
        need_cot = nb is not None and not (st.last and nb[0] == V - 1)
        act, cot = st.comm(send_act=send_act, recv_act=need_act,
                           send_cot=send_cot, recv_cot=need_cot)


def _transfer_of(transfer_shard_axis, transfer_shard_group):
    if transfer_shard_group is None and transfer_shard_axis is not None:
        transfer_shard_group = tpc.get_group(transfer_shard_axis)
    return None if transfer_shard_group is None else _Transfer(
        transfer_shard_group)


class _TransferStage(_Stage):
    """The state sliced over the tensor group: stage 0 announces the
    WHOLE state's shape in the preamble; every stage slices at its exit
    and gathers at its entry (and the last stage before ``last_fn``)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        first_fn, call_stage, last_fn = (self.first_fn, self.call_stage,
                                         self.last_fn)
        tr = self.transfer

        def stage(p, x, m, v):
            out = call_stage(p, tr.gather(x), m, v)
            if isinstance(out, tuple):
                return tr.slice(out[0]), out[1]
            return tr.slice(out)

        self.whole_first = first_fn
        self.call_stage = stage
        self.last_fn = lambda p, y, tgt: last_fn(p, tr.gather(y), tgt)

    def begin(self):
        h0 = (self.whole_first(self.params, _take(self.inputs, 0))
              if self.first else None)
        if self.P > 1:
            shape, self.dtype = _p2p.shape_preamble(self.group, h0,
                                                    self.device)
        else:
            shape, self.dtype = tuple(h0.shape), h0.dtype
        self.transfer.bind(shape)
        self.shape = tuple(n // self.transfer.n if d == self.transfer.dim
                           else n for d, n in enumerate(shape))
        return None if h0 is None else self.transfer.slice(h0)

    def stage_input(self, m: int):
        return self.transfer.slice(self.whole_first(
            self.params, _take(self.inputs, m)))


def _run_stage(st: _Stage, runner, schedule: str, bound: int):
    before = dict(_p2p.P2P_STATS)
    with st:
        runner(st)
        grads = st.grads()
    loss = st.mean_loss()
    after = dict(_p2p.P2P_STATS)
    last_stats.clear()
    last_stats.update(
        schedule=schedule, stage=st.s, stages=st.P, microbatches=st.M,
        chunks=st.V, max_in_flight=st.max_live, in_flight_bound=bound,
        **{k: after[k] - before[k] for k in after})
    return loss, grads


def pipeline_1f1b(params, inputs, targets, first_fn: Callable,
                  stage_fn: Callable, last_fn: Callable,
                  num_microbatches: int, pipe_axis: str = PIPE_AXIS,
                  stage_takes_mb: bool = False,
                  stage_returns_aux: bool = False, num_chunks: int = 1,
                  transfer_shard_axis: Optional[str] = None,
                  pipe_group=None, param_specs: Any = None,
                  transfer_shard_group=None):
    """One-forward-one-backward: returns ``(loss, grads)`` (do NOT call
    ``backward`` on the loss — the backward pipeline runs inside).

    - ``params``: this stage's params: its slab of the stacked stack
      (leaves whose ``param_specs`` entry names ``pipe_axis``) and the
      leaves every stage holds whole (the rest; ``param_specs`` None:
      every leaf).  ``first_fn(params, mb) -> x`` runs on stage 0,
      ``stage_fn(params, x) -> y`` on every stage (``stage_takes_mb``:
      ``(params, x, m)``; ``num_chunks > 1``: ``(params, x, m, v)``),
      ``last_fn(params, y, target) -> loss`` (a microbatch's mean) on the
      last stage.  ``inputs`` / ``targets``: trees of ``[M, ...]`` leaves.
    - Returns the mean loss over the M microbatches, the same on every
      stage, and a grads tree like ``params``: the slab leaves' this
      stage's, the whole leaves' summed over the pipe group.
    - ``stage_returns_aux``: ``stage_fn`` returns ``(y, aux)``, a scalar
      loss term of this stage added once a microbatch and backpropagated
      with a unit cotangent (the loss is ``mean_m [CE_m + sum_s aux]``).
    - ``num_chunks=V``: the interleaved schedule (chunk ``v`` of stage
      ``s`` holds layer slab ``v P + s``); needs ``M % P == 0``.
    - ``transfer_shard_group`` / ``transfer_shard_axis``: the tensor
      group the inter-stage state is sliced over (see the module note).

    ``last_stats`` holds the stage's in-flight maximum and bound
    (``min(M, P - s)`` classic, :func:`ring_slots` interleaved) and its
    point-to-point counts and bytes."""
    group = _group(pipe_axis, pipe_group)
    M, V = num_microbatches, num_chunks
    P = dist.get_world_size(group)
    if V < 1:
        raise ValueError(f"num_chunks must be >= 1, got {V}")
    if V > 1 and M % P != 0:
        raise ValueError(
            f"the interleaved schedule requires num_microbatches ({M}) "
            f"divisible by pipe size ({P}): the last microbatch group would "
            f"otherwise break the sigma(v, m) dependency spacing")
    if V > 1:
        _check_arity(stage_fn)
        call_stage = stage_fn
    elif stage_takes_mb:
        call_stage = lambda p, x, m, v: stage_fn(p, x, m)  # noqa: E731
    else:
        call_stage = lambda p, x, m, v: stage_fn(p, x)  # noqa: E731
    transfer = _transfer_of(transfer_shard_axis, transfer_shard_group)
    st = _make_stage(params, inputs, targets, first_fn, call_stage, last_fn,
                     M, group, V, V > 1, transfer, param_specs, pipe_axis,
                     stage_returns_aux)
    s = st.s
    if V == 1:
        return _run_stage(st, _classic, "1f1b", min(M, P - s))
    return _run_stage(st, _ticks, "interleaved", ring_slots(M, P, V))


def _make_stage(params, inputs, targets, first_fn, call_stage, last_fn, M,
                group, V, circular, transfer, param_specs, pipe_axis,
                returns_aux) -> _Stage:
    cls = _Stage if transfer is None else _TransferStage
    return cls(params, inputs, targets, first_fn, call_stage, last_fn, M,
               group, V, circular, transfer, param_specs, pipe_axis,
               returns_aux)
