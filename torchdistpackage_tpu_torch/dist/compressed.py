"""Quantized collectives — the port's counterpart of
``torchdistpackage_tpu/dist/compressed.py`` (EQuARX, "Efficient
Quantized AllReduce in XLA"): int8 payloads with per-group f32 scales
carried hop by hop around a ring, requantized at each hop, to cut the
bytes a gradient or activation collective moves.

- :func:`int8_ring_pmean` — mean all-reduce (DP grad sync);
- :func:`int8_ring_reduce_scatter` — sum to the owner (ZeRO, FSDP's
  backward, SP's closing reduce-scatter); its backward is
  :func:`int8_ring_all_gather` of the cotangent;
- :func:`int8_ring_all_gather` — gather (FSDP's parameter gathers, SP's
  entering gather); its backward is :func:`int8_ring_reduce_scatter`, so
  a compressed forward gather buys a compressed backward scatter;
- :func:`int8_psum_all_gather` — the gather of ZeRO's int8 re-gather;
- :func:`ef_compress` — input-side error feedback (ZeRO's
  ``'int8_ef'``);
- :func:`auto_compress_policy` — per-leaf compress / exact choices from
  ``obs.comm_model.CommModel.predict_compressed``.

Every function takes a ``torch.distributed`` group (the port's
``tp_group=`` convention) where the reference names a mesh axis.  Each
hop of the reduce-scatter ring is one ``tp_utils.ppermute``
(``batch_isend_irecv`` to rank ``+1``) of the codes and their scales
packed into one byte buffer, the hops unrolled in a Python loop as in
the reference.  The accumulator is f32;
only the payload is int8, plus the f32 scales.  The quantizer
(:func:`_quant`, :func:`_dequant`) is plain PyTorch, as the reference's
is XLA arithmetic and not a Pallas kernel: the same f32 divides (by
tensors, never by a host scalar), then ``torch.round`` (half to even, as
``jnp.round``), then the clip, so the codes and scales are bit-equal to
the reference's on the CPU and on the card.

Every int8 gather — :func:`int8_ring_all_gather`, the gather leg of
:func:`int8_ring_pmean` and :func:`int8_psum_all_gather` — is one
``all_gather_into_tensor`` of the packed codes and scales.  The
reference's all-gather ring sends each shard's codes round ``n - 1``
hops unchanged, and its other gathers run a masked int8 ``psum`` (it
needs the psum only for its invariance typing).  Each shard is quantized
once either way, so the values are the same; the all-gather moves the
ring's ``(n-1)/n`` of the quantized payload in one collective instead of
``n - 1`` serial exchanges, and the pmean's gather leg moves ``(n-1)/n``
instead of the psum's ``2(n-1)/n``, so the port's int8 mean all-reduce
moves ``2(n-1)/n`` where ``obs.comm_model.compressed_wire_bytes`` (the
reference's model) counts ``3(n-1)/n``.  Only the reduce-scatter, where
each hop requantizes a partial sum, is a ring.
Over a gloo group a CUDA payload goes through the host
(``tp_utils.to_host`` / ``from_host``, counted in ``HOST_STAGING``),
the bytes staying int8.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..parallel.tensor_parallel import tp_utils

GROUP = 256  # elements per quantization scale (1.5% f32-scale overhead)

#: every ``grad_compress=`` knob validates against this set ('int8_ef'
#: is ZeRO's alone: the residual needs persistent optimizer state)
COMPRESS_MODES = (None, "int8", "int8_ef", "auto")


def _group_size(n: int) -> int:
    """Largest power of two <= GROUP dividing n (n a chunk's size)."""
    g = 1
    while g * 2 <= GROUP and n % (g * 2) == 0:
        g *= 2
    return g


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with a scale a group: x [c] f32 ->
    (q [c] int8, scales [c / g] f32).  Per-group scales keep the noise
    proportional to the local largest |value| (one scale a chunk lets a
    few outliers wash out the rest)."""
    c = x.shape[0]
    g = _group_size(c)
    grouped = x.reshape(-1, g)
    amax = torch.clamp(grouped.abs().amax(dim=1), min=1e-30)
    # a tensor divisor: CUDA divides by a host scalar as a multiply by its
    # reciprocal, which rounds some scales a unit apart from the CPU's
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(grouped / scale[:, None]), -127, 127).to(
        torch.int8)
    return q.reshape(c), scale.to(torch.float32)


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    c = q.shape[0]
    g = c // scale.shape[0]
    return (q.to(torch.float32).reshape(-1, g) * scale[:, None]).reshape(c)


def ef_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Input-side error feedback: ``x`` round-tripped through the
    quantizer, ``(x_q, residual = x - Q(x))`` (the residual f32, x's
    shape).  The caller adds the previous step's residual before
    compressing and keeps the new one, so each step's quantization error
    is fed back instead of dropped."""
    flat = x.reshape(-1).to(torch.float32)
    q, s = _quant(flat)
    xq = _dequant(q, s)
    return (xq.reshape(x.shape).to(x.dtype), (flat - xq).reshape(x.shape))


# ------------------------------------------------------------ the rings


def _pack(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """One byte buffer: the scales' bytes, then the codes'."""
    return torch.cat([s.view(torch.uint8), q.view(torch.uint8)])


def _unpack(buf: torch.Tensor, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    m = 4 * (c // _group_size(c))
    s = buf[:m]
    if s.storage_offset() % 4:  # a row of a gathered buffer: realign
        s = s.clone()
    return buf[m:].view(torch.int8), s.view(torch.float32)


def _hop(q: torch.Tensor, s: torch.Tensor, group
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The codes and scales sent to rank ``+1``, rank ``-1``'s received:
    one ``ppermute`` of their bytes."""
    buf = tp_utils.ppermute(_pack(q, s), group, 1, name="int8_hop")
    return _unpack(buf, q.shape[0])


def _gather_codes(q: torch.Tensor, s: torch.Tensor, group
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Every rank's ``(codes, scales)``, in rank order: one all-gather
    of the packed bytes."""
    n = dist.get_world_size(group)
    buf = tp_utils._start_all_gather(_pack(q, s), group, 0, "int8_gather",
                                     async_op=False)()
    return [_unpack(b, q.shape[0]) for b in buf.reshape(n, -1)]


def _ring_reduce_scatter(g: torch.Tensor, group,
                         scatter_dim: int) -> torch.Tensor:
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    if g.shape[scatter_dim] % n:
        raise ValueError(
            f"scatter dim {scatter_dim} of size {g.shape[scatter_dim]} must "
            f"divide by the group size {n} (the contract of a tiled "
            f"reduce-scatter)")
    if n == 1:
        return g
    gm = g.movedim(scatter_dim, 0).to(torch.float32)
    rest = tuple(gm.shape[1:])
    tile = gm.shape[0] // n
    chunks = gm.reshape(n, -1)  # chunk c = tile c of scatter_dim
    # rank r starts by sending chunk r - 1; each hop adds the local value
    # of the travelling chunk and requantizes the partial sum.  After
    # n - 1 hops rank r holds chunk r fully reduced.
    send_q, send_s = _quant(chunks[(idx - 1) % n])
    part = None
    for t in range(n - 1):
        recv_q, recv_s = _hop(send_q, send_s, group)
        part = chunks[(idx - t - 2) % n] + _dequant(recv_q, recv_s)
        if t < n - 2:
            send_q, send_s = _quant(part)
    out = part.reshape((tile,) + rest).movedim(0, scatter_dim)
    return out.to(g.dtype).contiguous()


def _all_gather_q(x: torch.Tensor, group, gather_dim: int) -> torch.Tensor:
    """The int8 all-gather's body: this rank's shard quantized once, every
    rank's codes and scales gathered, every shard dequantized (the owner's
    too, so all ranks hold the same tensor)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    xm = x.movedim(gather_dim, 0)
    tile, rest = xm.shape[0], tuple(xm.shape[1:])
    q, s = _quant(xm.reshape(-1).to(torch.float32))
    vals = torch.stack([_dequant(gq, gs)
                        for gq, gs in _gather_codes(q, s, group)])
    full = vals.reshape((n * tile,) + rest).movedim(0, gather_dim)
    return full.to(x.dtype).contiguous()


class _Int8ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, group, dim):
        ctx.group, ctx.dim = group, dim
        out = _ring_reduce_scatter(g, group, dim)
        return out.view_as(out) if out is g else out

    @staticmethod
    def backward(ctx, ct):
        return _all_gather_q(ct, ctx.group, ctx.dim), None, None


class _Int8AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        out = _all_gather_q(x, group, dim)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, ct):
        return _ring_reduce_scatter(ct, ctx.group, ctx.dim), None, None


def int8_ring_reduce_scatter(g: torch.Tensor, group,
                             scatter_dim: int) -> torch.Tensor:
    """A tiled reduce-scatter with an int8 wire: rank r of ``group`` gets
    the SUM over the group of tile r of ``scatter_dim`` (the caller
    normalizes), in ``g``'s dtype.  One ring pass, ``(n-1)/n`` int8 bytes
    an element (plus the scales) where an f32 reduce-scatter moves
    ``4(n-1)/n``.  Differentiable: the backward is
    :func:`int8_ring_all_gather` of the cotangent."""
    return _Int8ReduceScatter.apply(g, group, scatter_dim)


def int8_ring_all_gather(x: torch.Tensor, group,
                         gather_dim: int) -> torch.Tensor:
    """A tiled all-gather with an int8 wire: every rank assembles the
    whole tensor along ``gather_dim`` from the quantized shards (its own
    included, so all ranks hold the same tensor).  The shards' codes and
    scales travel in one ``all_gather_into_tensor`` (see the module
    note).  Differentiable: the backward is
    :func:`int8_ring_reduce_scatter` of the cotangent."""
    return _Int8AllGather.apply(x, group, gather_dim)


def int8_psum_all_gather(x: torch.Tensor, group,
                         gather_dim: int) -> torch.Tensor:
    """The all-gather of ZeRO's int8 re-gather: each rank's shard
    quantized once, the codes and scales gathered (one
    ``all_gather_into_tensor``), every shard dequantized — the values of
    the reference's masked int8 psum, which each position gets from one
    rank.  Not differentiable (it runs on updated masters)."""
    return _all_gather_q(x, group, gather_dim)


def int8_ring_pmean(g: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``g`` over ``group`` with an int8 wire, in ``g``'s
    dtype and shape.  The exact mean when the group has one member or the
    flat size does not divide by its size.  Two legs: a ring
    reduce-scatter (``n - 1`` requantizing hops, each rank starting with
    its own chunk), then the gather of the finished chunks' codes (see
    the module note)."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return g
    flat = g.reshape(-1)
    if flat.shape[0] % n:
        tp_utils._count("int8_fallback")
        return tp_utils.all_reduce_(flat.clone(), group).reshape(
            g.shape) / n
    chunks = flat.reshape(n, -1).to(torch.float32)
    # rank r sends chunk r; after n - 1 accumulate-requantize hops it
    # holds chunk (r + 1) % n fully reduced
    send_q, send_s = _quant(chunks[idx])
    part = None
    for t in range(n - 1):
        recv_q, recv_s = _hop(send_q, send_s, group)
        part = chunks[(idx - t - 1) % n] + _dequant(recv_q, recv_s)
        if t < n - 2:
            send_q, send_s = _quant(part)
    oq, os_ = _quant(part / n)
    got = _gather_codes(oq, os_, group)
    # chunk c is owned by rank c - 1
    out = torch.stack([_dequant(*got[(c - 1) % n]) for c in range(n)])
    return out.reshape(g.shape).to(g.dtype)


# ------------------------------------------------------------ auto policy


def auto_compress_policy(
    named_leaves: Sequence[Tuple[str, Tuple[int, ...], int]],
    op: str,
    axes: Sequence[str],
    ctx=None,
    model=None,
    min_size: int = 65536,
    group: int = GROUP,
) -> Tuple[Dict[str, bool], List[Dict[str, Any]]]:
    """Per-leaf compress / exact choices from the alpha-beta model.

    ``named_leaves``: ``[(name, shape, itemsize)]`` of the leaves a step
    reduces; ``op`` the exact collective replaced (``'all_reduce'`` for
    DP's mean, ``'reduce_scatter'`` for ZeRO's reduce-to-owner); ``axes``
    the axes of ``ctx`` (default ``tpc``) it spans.  A leaf compresses
    when ``model.predict_compressed`` (default
    ``CommModel.from_defaults`` over ``ctx``'s axes) predicts the ring
    faster AND it has at least ``min_size`` elements.  Returns
    ``(policy {name: bool}, records)``, a record a leaf: bytes, both
    predictions, the choice — the ``compress_policy`` event's
    payload."""
    from ..obs.comm_model import CommModel
    from .topology import tpc

    ctx = tpc if ctx is None else ctx
    if model is None:
        model = CommModel.from_defaults(ctx=ctx)
    n = 1
    for a in axes:
        n *= int(ctx.get_group_size(a))
    policy: Dict[str, bool] = {}
    records: List[Dict[str, Any]] = []
    for name, shape, itemsize in named_leaves:
        size = 1
        for d in shape:
            size *= int(d)
        payload = size * itemsize
        pred = model.predict_compressed(op, payload, n, axes=tuple(axes),
                                        elem_bytes=itemsize, group=group)
        choose = bool(pred["compress"]) and size >= min_size
        policy[name] = choose
        records.append({
            "leaf": name,
            "elems": size,
            "bytes": payload,
            "op": op,
            "axes": list(axes),
            "compress": choose,
            "pred_exact_s": pred["exact_s"],
            "pred_compressed_s": pred["compressed_s"],
            "ledger_bytes_exact": pred["ledger_bytes_exact"],
            "ledger_bytes_compressed": pred["ledger_bytes_compressed"],
        })
    return policy, records
