"""Tensor- and sequence-parallel regions — the PyTorch counterpart of
``torchdistpackage_tpu/parallel/tensor_parallel/tp_utils.py``.

The JAX package runs one SPMD program inside ``shard_map`` and names a
mesh axis; JAX's autodiff supplies every backward collective.  The port
runs the same Python on every rank over its own shards, so the axis
becomes a ``torch.distributed`` process group (default: ``tpc``'s
``'tensor'`` group, or the one :func:`set_tp_group` sets) and each
Megatron region is a ``torch.autograd.Function`` whose backward is
written out:

=================  ===========================  ======================
region             forward                      backward
=================  ===========================  ======================
``reduce_from_tp``  all-reduce                   identity
``copy_to_tp``      identity                     all-reduce
``gather_from_sp``  all-gather (sequence dim)    reduce-scatter
``scatter_to_sp``   reduce-scatter (sequence)    all-gather
``split_to_sp``     this rank's sequence slice   all-gather
=================  ===========================  ======================

``copy_to_tp`` is the Megatron "f" region: a replicated activation
entering a column-parallel product gets its gradient summed over the
group (JAX gets that sum from ``pvary``'s transpose).  Every region
makes its collective at every group size, one rank included, so a
one-rank group runs the same code as N ranks.  :data:`COLLECTIVES`
counts the collectives made, by region; each helper that issues one
also notes it for the comm ledger (``obs.comm_ledger.note``: its
operand bytes, its group and that region's name).

``torch.distributed``'s gather and scatter work on dim 0, the package's
sequence dim is 1: the gather collects the ranks' whole tensors along a
new leading dim and moves it next to the sequence, the reduce-scatter
lays the sequence slices out along a new leading dim first; both give
contiguous tensors (the products after them then take the serial path's
layouts) and copy nothing beyond the collective's own at one rank.

The collective-matmul rings (:func:`ring_ag_matmul`,
:func:`ring_matmul_rs`) compose the caller's product with one
differentiable ring shift, :func:`ppermute` (forward to rank ``+1`` by
``batch_isend_irecv``, backward to ``-1``), so autograd builds the
reverse ring as JAX's AD transposes ``ppermute``.  A one-rank group
takes the reference's shortcut: the product alone, no shift.

``compress='int8'`` on :func:`gather_from_sp` / :func:`scatter_to_sp`
sends the boundary through the int8 collectives of
``dist/compressed.py`` (the gather one all-gather of the codes and their
scales, the reduce-scatter a ring of :func:`ppermute` hops), each the
other's backward.

Over a gloo group a CUDA tensor goes through the host: every
collective here copies it to the host and back (:func:`to_host` /
:func:`from_host`, counted in :data:`HOST_STAGING`).  Several processes
on one card talk over gloo, NCCL putting no two ranks of a
communicator on one device.  The async starts (:func:`start_all_reduce`,
:func:`_start_all_gather`) wait where they are issued under the
overlap regime ``'none'`` (``dist.overlap``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from ...dist.topology import TENSOR_AXIS, tpc
from ...obs.comm_ledger import note, note_done

#: collectives made, by region (forward and backward alike);
#: ``ring_shift`` counts the rings' point-to-point exchanges,
#: ``xent_max`` the vocab-parallel loss's all-reduce MAX,
#: ``gather_params`` the all-gathers of ``layers.gather_params``,
#: ``full_logits`` decoding's all-gather of the vocabulary slices; and
#: the sharded training state's (``parallel.zero``, ``parallel.fsdp``,
#: ``parallel.ema``): ZeRO's grad reduce-scatters, its all-reduces (the
#: other data axes, whole leaves, the SP sum, the logged loss) and its
#: re-gathers of the updated masters; FSDP's parameter all-gathers,
#: their backward reduce-scatters and its all-reduces; the sharded
#: EMA's gathers for ``state_dict``; ``transfer_gather`` the pipeline's
#: gathers of a tensor-sharded inter-stage state (its slices count as
#: ``split_to_sp``); ``moe_gather`` the MoE block's gather of its SP
#: rows into the whole sequence (``gather_whole``); the int8 rings of
#: ``dist/compressed.py``: ``int8_hop`` a hop's codes and scales,
#: ``int8_gather`` the all-gather of finished codes, ``int8_fallback``
#: the exact mean of a ragged leaf; ``comm_bench`` the benchmark's
#: exact collectives
COLLECTIVES: Dict[str, int] = dict.fromkeys(
    ("reduce_from_tp", "copy_to_tp", "gather_from_sp", "scatter_to_sp",
     "split_to_sp", "ring_shift", "xent_max", "gather_params",
     "full_logits", "zero_reduce_scatter", "zero_all_reduce",
     "zero_all_gather", "fsdp_all_gather", "fsdp_reduce_scatter",
     "fsdp_all_reduce", "ema_all_gather", "transfer_gather",
     "moe_gather", "int8_hop", "int8_gather", "int8_fallback",
     "comm_bench", "cp_export"), 0)

_TP_GROUP = None


def set_tp_group(group) -> None:
    """The group the regions default to (``set_tp_axis``'s counterpart);
    None restores ``tpc.get_group('tensor')``."""
    global _TP_GROUP
    _TP_GROUP = group


def get_tp_group():
    """The default tensor-parallel group: the one :func:`set_tp_group`
    set, else ``tpc``'s ``'tensor'`` group."""
    return _TP_GROUP if _TP_GROUP is not None else tpc.get_group(TENSOR_AXIS)


def tp_size(group=None) -> int:
    return dist.get_world_size(group if group is not None else get_tp_group())


def tp_rank(group=None) -> int:
    return dist.get_rank(group if group is not None else get_tp_group())


def _check_compress(compress: Optional[str]) -> None:
    if compress not in (None, "int8"):
        raise ValueError(f"compress must be None or 'int8', got {compress!r}")


#: the overlap regime's switch (``dist.overlap.configure`` sets it): True
#: under ``'none'``, where every async start waits where it is issued
SYNC_COLLECTIVES = False


def _count(name: str) -> None:
    COLLECTIVES[name] += 1


def start_all_reduce(t: torch.Tensor, group, op=None, async_op: bool = True,
                     stats: Optional[Dict[str, int]] = None,
                     name: Optional[str] = None
                     ) -> Callable[[], torch.Tensor]:
    """Start summing (or ``op``) ``t`` over ``group`` in place and return
    the call that waits and returns ``t``.  A CUDA tensor over gloo goes
    through a host copy (counted in ``stats``, default
    :data:`HOST_STAGING`), written back into ``t`` by the wait.  Under
    the overlap regime ``'none'`` the wait happens here.  ``name``: the
    :data:`COLLECTIVES` region the caller counted it under, for the comm
    ledger (``obs.comm_ledger.note``)."""
    op = dist.ReduceOp.SUM if op is None else op
    async_op = async_op and not SYNC_COLLECTIVES
    buf = to_host(t, stats) if host_path(group, t.device) else t
    token = note("all-reduce", t, group, name, async_op)
    work = dist.all_reduce(buf, op=op, group=group, async_op=async_op)

    def finish() -> torch.Tensor:
        nonlocal work, buf
        if work is not None:
            work.wait()
            work = None
            note_done(token)
        if buf is not t:
            t.copy_(from_host(buf, t.device, stats))
            buf = t
        return t
    if not async_op:
        finish()
    return finish


def all_reduce_(t: torch.Tensor, group, op=None,
                stats: Optional[Dict[str, int]] = None,
                name: Optional[str] = None) -> torch.Tensor:
    """``t`` summed (or ``op``) over ``group`` in place and returned."""
    return start_all_reduce(t, group, op, async_op=False, stats=stats,
                            name=name)()


def _all_reduce(x: torch.Tensor, group, name: str) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    _count(name)
    return all_reduce_(out, group, name=name)


def _start_all_gather(x: torch.Tensor, group, dim: int, name: str,
                      async_op: bool = True) -> Callable[[], torch.Tensor]:
    """Start the gather of :func:`_all_gather` and return the call that
    finishes it: waits for the collective (the calling stream waits on
    NCCL's) and returns the gathered tensor.  The output is allocated,
    and read after the wait, on the calling stream, and the closure keeps
    ``x`` alive until then, so no buffer crosses streams in the caching
    allocator's view.  Over gloo a CUDA ``x`` goes through the host and
    the wait copies the result back; under the overlap regime ``'none'``
    the wait happens here."""
    n = dist.get_world_size(group)
    device = x.device
    staged = host_path(group, device)
    x = to_host(x) if staged else x.contiguous()
    out = x.new_empty((n,) + tuple(x.shape))
    _count(name)
    waits_later = async_op and not SYNC_COLLECTIVES
    token = note("all-gather", x, group, name, waits_later)
    work = dist.all_gather_into_tensor(
        out.view((n * x.shape[0],) + x.shape[1:]) if x.dim() else out, x,
        group=group, async_op=async_op)
    shape = list(x.shape)
    if x.dim():
        shape[dim] *= n

    def finish() -> torch.Tensor:
        nonlocal work, out, staged
        if work is not None:
            work.wait()
            work = None
            note_done(token)
        if staged:
            out, staged = from_host(out, device), False
        # reads x: the closure holds it until the collective is done
        return out.movedim(0, dim).reshape(shape) if x.dim() else out
    if async_op and not waits_later:
        finish()
    return finish


def _all_gather(x: torch.Tensor, group, dim: int, name: str) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in rank order, into
    a contiguous tensor: the ranks' whole tensors are gathered along a new
    leading dim (the collective's own layout), then moved into place — a
    copy that a one-rank group does not need."""
    return _start_all_gather(x, group, dim, name, async_op=False)()


def _reduce_scatter(x: torch.Tensor, group, dim: int,
                    name: str) -> torch.Tensor:
    """Sum ``x`` over the group and keep this rank's slice of ``dim``,
    contiguous: the slices are laid out along a new leading dim for the
    collective (a copy that a one-rank group does not need)."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"seq dim {x.shape[dim]} not divisible by TP size "
                         f"{n}")
    device = x.device
    staged = host_path(group, device)
    xs = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)
    xs = (to_host(xs) if staged else xs).contiguous()
    out = xs.new_empty(xs.shape[1:])
    _count(name)
    note("reduce-scatter", xs, group, name)
    dist.reduce_scatter_tensor(out, xs.view((-1,) + tuple(xs.shape[2:])),
                               op=dist.ReduceOp.SUM, group=group)
    return from_host(out, device) if staged else out


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, "reduce_from_tp")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, "copy_to_tp"), None


class _GatherFromSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim, "gather_from_sp")

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g, ctx.group, ctx.dim, "gather_from_sp"),
                None, None)


class _ScatterToSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim, "scatter_to_sp")

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim, "scatter_to_sp"), None, None


class _SplitToSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n, r = dist.get_world_size(group), dist.get_rank(group)
        if x.shape[dim] % n:
            raise ValueError(f"seq dim {x.shape[dim]} not divisible by TP "
                             f"size {n}")
        c = x.shape[dim] // n
        return x.narrow(dim, r * c, c).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim, "split_to_sp"), None, None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, name):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim, name)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        c = g.shape[ctx.dim] // n
        return (g.narrow(ctx.dim, r * c, c).contiguous(
            memory_format=torch.contiguous_format), None, None, None)


def reduce_from_tp(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce (sum) over the tensor group; backward identity —
    closes a row-parallel product (``_ReduceFromModelParallelRegion``)."""
    return _ReduceFromTP.apply(x, group if group is not None
                               else get_tp_group())


def copy_to_tp(x: torch.Tensor, group=None) -> torch.Tensor:
    """Identity; backward all-reduce — opens a column-parallel product on
    a replicated activation (the Megatron "f" region)."""
    return _CopyToTP.apply(x, group if group is not None else get_tp_group())


def gather_from_sp(x: torch.Tensor, group=None, seq_dim: int = 1,
                   compress: Optional[str] = None) -> torch.Tensor:
    """SP -> full: all-gather along the sequence dim; backward
    reduce-scatter (``_GatherFromSequenceParallelRegion``).
    ``compress='int8'``: the gather rides the int8 ring
    (``dist.compressed.int8_ring_all_gather``), and so does its backward
    reduce-scatter."""
    _check_compress(compress)
    group = group if group is not None else get_tp_group()
    if compress == "int8":
        from ...dist.compressed import int8_ring_all_gather

        _count("gather_from_sp")
        return int8_ring_all_gather(x, group, seq_dim)
    return _GatherFromSP.apply(x, group, seq_dim)


def scatter_to_sp(x: torch.Tensor, group=None, seq_dim: int = 1,
                  compress: Optional[str] = None) -> torch.Tensor:
    """Full -> SP: reduce-scatter along the sequence dim; backward
    all-gather (``_ReduceScatterToSequenceParallelRegion``).
    ``compress='int8'``: the partial sums reduce through the int8 ring
    (``dist.compressed.int8_ring_reduce_scatter``), and the backward's
    gather rides the int8 ring too."""
    _check_compress(compress)
    group = group if group is not None else get_tp_group()
    if compress == "int8":
        from ...dist.compressed import int8_ring_reduce_scatter

        _count("scatter_to_sp")
        return int8_ring_reduce_scatter(x, group, seq_dim)
    return _ScatterToSP.apply(x, group, seq_dim)


def split_to_sp(x: torch.Tensor, group=None, seq_dim: int = 1
                ) -> torch.Tensor:
    """Full -> SP without a reduction: this rank's slice of the sequence;
    backward all-gather — enters SP from a replicated activation."""
    return _SplitToSP.apply(
        x, group if group is not None else get_tp_group(), seq_dim)


def gather_whole(x: torch.Tensor, group=None, dim: int = 1,
                 name: str = "moe_gather") -> torch.Tensor:
    """All-gather along ``dim`` into the whole tensor for a region that
    every rank of the group then computes whole (replicated weights: the
    MoE half of a block under SP, a pipeline stage's entry under sharded
    transfers); backward this rank's slice of the cotangent, which such
    a region leaves whole and the same on every rank — where
    :func:`gather_from_sp`'s reduce-scatter would sum it tp times.
    Counted under ``name``."""
    return _GatherWhole.apply(
        x, group if group is not None else get_tp_group(), dim, name)


# ------------------------------------------------ vocabulary-parallel ends


def vocab_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of ``x`` over the group (an all-reduce MAX),
    outside autograd: the vocab-parallel loss's log-sum-exp shift, which
    cancels in the gradient (JAX's ``pmax`` under ``stop_gradient``)."""
    group = group if group is not None else get_tp_group()
    with torch.no_grad():
        out = x.clone(memory_format=torch.contiguous_format)
        _count("xent_max")
        all_reduce_(out, group, dist.ReduceOp.MAX, name="xent_max")
    return out


def gather_vocab(x: torch.Tensor, group=None) -> torch.Tensor:
    """Vocabulary slices [..., V / tp] -> [..., V] in rank order
    (forward only: decoding's full logits)."""
    group = group if group is not None else get_tp_group()
    return _all_gather(x, group, x.dim() - 1, "full_logits")


# ------------------------------------------------------- collective matmul


class _RingShift(torch.autograd.Function):
    """``x`` sent to rank ``r + shift`` of the group, the tensor of rank
    ``r - shift`` received; the backward shifts the gradient back."""

    @staticmethod
    def forward(ctx, x, group, shift, name):
        ctx.group, ctx.shift, ctx.name = group, shift, name
        return _shift(x, group, shift, name)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift, ctx.name), None, None, None


#: the host copies (each way) and their bytes that gloo needed for CUDA
#: payloads, since the last reset: every collective of this module and
#: of the sharded steps (``start_all_reduce``, the gathers and
#: reduce-scatters, the ring shift, the autograd all-to-all, the int8
#: rings).  The pipeline's point-to-point passes its own ``P2P_STATS``
#: to the same helpers.
HOST_STAGING: Dict[str, int] = dict.fromkeys(
    ("host_copies", "host_copy_bytes"), 0)


def host_path(group, device: torch.device) -> bool:
    """A CUDA payload exchanged over a gloo group goes through the host
    (gloo's point-to-point and all-to-all take CPU tensors): several
    processes on one card talk over gloo, NCCL putting no two ranks of a
    communicator on one device."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def _count_copy(t: torch.Tensor, stats: Optional[Dict[str, int]]) -> None:
    stats = HOST_STAGING if stats is None else stats
    stats["host_copies"] += 1
    stats["host_copy_bytes"] += t.numel() * t.element_size()


def to_host(t: torch.Tensor, stats: Optional[Dict[str, int]] = None
            ) -> torch.Tensor:
    """A detached, contiguous host copy of ``t``, counted in ``stats``
    (default :data:`HOST_STAGING`)."""
    _count_copy(t, stats)
    return t.detach().to("cpu", memory_format=torch.contiguous_format)


def from_host(t: torch.Tensor, device: torch.device,
              stats: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """``t`` copied back to ``device``, counted as :func:`to_host`."""
    _count_copy(t, stats)
    return t.to(device)


def _shift(x: torch.Tensor, group, shift: int,
           name: str = "ring_shift") -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    device = x.device
    staged = host_path(group, device)
    x = to_host(x) if staged else x.contiguous()
    out = torch.empty_like(x)
    _count(name)
    note("collective-permute", x, group, name)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - shift) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return from_host(out, device) if staged else out


def ppermute(x: torch.Tensor, group=None, shift: int = 1,
             name: str = "ring_shift") -> torch.Tensor:
    """One differentiable ring step over the tensor group (JAX's
    ``ppermute`` with the permutation ``p -> p + shift``), counted in
    :data:`COLLECTIVES` under ``name``."""
    return _RingShift.apply(x, group if group is not None else get_tp_group(),
                            shift, name)


class _AllToAll(torch.autograd.Function):
    """One ``all_to_all_single`` over ``group``: ``send [n, ...]``, block
    i to rank i of the group, returns ``[n, ...]`` with block i from rank
    i.  Its backward is the same exchange of the cotangent (an all-to-all
    is its own transpose: the block that came from rank i goes back to
    rank i)."""

    @staticmethod
    def forward(ctx, send, group):
        ctx.group = group
        return _all_to_all(send, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    device = send.device
    staged = host_path(group, device)
    send = to_host(send) if staged else send.contiguous()
    recv = torch.empty_like(send)
    note("all-to-all", send, group)
    dist.all_to_all_single(recv, send, group=group)
    return from_host(recv, device) if staged else recv


def all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """The differentiable all-to-all over ``group`` (JAX's ``all_to_all``
    on the leading dim): the MoE layer's expert exchange and Ulysses'
    head / sequence exchange."""
    return _AllToAll.apply(send, group)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def ring_ag_matmul(x: torch.Tensor, mm: Callable[[torch.Tensor], Any],
                   group=None, out_seq_dim: int = 1) -> Any:
    """``mm(gather_from_sp(x))`` without gathering first.  ``x`` is this
    rank's sequence chunk ``[B, s, D]``; ``mm`` maps a chunk to its output
    (a tensor or a dict of tensors whose ``out_seq_dim`` is the sequence
    dim) and must be row-wise in the sequence.  Each of the ``n`` steps
    applies ``mm`` to the chunk held and passes the raw chunk on to rank
    ``+1``; the outputs are concatenated in their owners' order."""
    group = group if group is not None else get_tp_group()
    n, i = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return mm(x)
    buf, ys = x, []
    for k in range(n):
        ys.append(mm(buf))  # rank i holds rank (i - k)'s chunk at step k
        if k < n - 1:
            buf = ppermute(buf, group, 1)
    order = [ys[(i - o) % n] for o in range(n)]
    return _tree_map(lambda *c: torch.cat(c, dim=out_seq_dim), *order)


def ring_matmul_rs(h: torch.Tensor, mm: Callable[[torch.Tensor],
                                                 torch.Tensor],
                   group=None, seq_dim: int = 1) -> torch.Tensor:
    """``scatter_to_sp(mm(h))`` as a ring of partial products.  ``h`` is
    the full-sequence activation holding this rank's partial features;
    ``mm`` maps a sequence chunk to its partial product.  Chunk ``j``'s
    sum starts at rank ``j + 1`` and travels ``+1`` a step, each rank
    adding its share, and lands home at rank ``j`` after ``n - 1``
    hops."""
    group = group if group is not None else get_tp_group()
    n, i = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return mm(h)
    S = h.shape[seq_dim]
    if S % n:
        raise ValueError(f"seq dim {S} not divisible by TP size {n}")
    c = S // n

    def chunk(j):
        return h.narrow(seq_dim, j * c, c)

    acc = mm(chunk((i - 1) % n))
    for k in range(1, n):
        acc = ppermute(acc, group, 1) + mm(chunk((i - 1 - k) % n))
    return acc
