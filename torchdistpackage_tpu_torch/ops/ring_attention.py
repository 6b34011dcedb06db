"""Context parallelism for training: ring attention and Ulysses — the
PyTorch counterpart of ``torchdistpackage_tpu/ops/ring_attention.py``.

The sequence of q/k/v ``[B, H, S_local, hd]`` is sharded over a context
group (a ``torch.distributed`` process group, ``group=``), contiguously
(rank i owns positions ``[i S_local, (i + 1) S_local)``) or in the
ZIGZAG layout (rank i owns chunks i and 2n-1-i of 2n, which balances the
causal work; prepare batches with :func:`zigzag_permute`).

- :func:`ring_attention` keeps the rank's q and rotates the KV shards
  around the group, one hop a step, by the differentiable ring step of
  ``tp_utils.ppermute`` (autograd builds the reverse ring for the
  backward, as JAX's AD transposes ``ppermute``).  With ``use_flash``
  each hop (each half-pair under zigzag) is the diagonal (a causal flash
  call), entirely in the past (a non-causal one) or entirely in the
  future (skipped: no call, no mass); every call is
  ``flash_attention_with_lse``, so CUDA tensors run K3 forward and K4/K5
  backward, and the hops combine exactly through their logsumexps
  (:func:`_lse_combine`), whose cotangent reaches ``flash_delta``.
  ``use_flash=False`` is the einsum online-softmax golden path.
- :func:`ulysses_attention` scatters heads and gathers the sequence by
  an autograd all-to-all over the group (``tp_utils.all_to_all``, the
  MoE layer's expert exchange too),
  runs ``flash_attention`` on ``H / n`` heads of the whole sequence and
  scatters back.

Two differences from the reference.  The exchange is synchronous: JAX
overlaps each hop's ``ppermute`` with the hop's compute (XLA async
collectives); here a hop's send and receive complete before the hop's
call.  A skipped future hop makes no call and enters no combine, where
JAX combines a zero-mass partial; the KV still rotates, so every rank of
the group enters the same sends in the same order, and the rotated KV is
tied to the output (:class:`_Tie`) so that every rank's backward runs
every reverse send, whatever hops it skipped.  Serially (``group=None``)
both ops are one ``flash_attention`` call (K3-K5 on the card; the
einsum attention without ``use_flash``), as the reference's serial
path.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.tensor_parallel.tp_utils import all_to_all, ppermute
from .flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_with_lse,
    mha_reference,
)

_LAYOUTS = ("contiguous", "zigzag")


def _block_update(q, k, v, m, l, acc, qpos, kpos, causal: bool,
                  sm_scale: float):
    """One online-softmax step against a KV block (JAX :43): q [B, H, Sq,
    hd], k/v [B, H, Sk, hd], m/l [B, H, Sq, 1] and acc [B, H, Sq, hd] f32;
    qpos [Sq] / kpos [Sk] the global positions for the causal mask."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1, keepdim=True)
    acc = acc * corr + torch.matmul(p, v.float())
    return m_new, l, acc


def _lse_combine(o, lse, o_j, lse_j):
    """Exactly combine two softmax partials through their logsumexps (JAX
    :62): each ``o`` is normalised over its own keys; the result weighs
    them by their share of the total mass.  o f32 [B, H, S, hd], lse f32
    [B, H, S]."""
    lse_new = torch.logaddexp(lse, lse_j)
    w = torch.exp(lse - lse_new)[..., None]
    w_j = torch.exp(lse_j - lse_new)[..., None]
    return o * w + o_j.float() * w_j, lse_new


def zigzag_positions(shard_idx: int, s_local: int, n: int, device=None
                     ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """The global positions owned by ``shard_idx`` of ``n`` under the
    zigzag layout (JAX :74): chunks ``shard_idx`` and ``2n - 1 -
    shard_idx`` of ``s_local / 2`` each.  Returns ``([s_local]
    positions, (lo_start, hi_start))``."""
    if s_local % 2 != 0:
        raise ValueError(
            f"zigzag needs an even local sequence length, got {s_local}")
    c = s_local // 2
    lo, hi = shard_idx * c, (2 * n - 1 - shard_idx) * c
    pos = torch.cat([torch.arange(lo, lo + c, device=device),
                     torch.arange(hi, hi + c, device=device)])
    return pos, (lo, hi)


def shard_positions(group, s_local: int, layout: str = "contiguous",
                    device=None) -> torch.Tensor:
    """The [s_local] global positions this rank of the context ``group``
    holds: its contiguous offset or its zigzag chunks (the reference's
    ``_rope_positions`` / ``gpt_embed`` offsets); ``arange`` serially."""
    if layout not in _LAYOUTS:
        raise ValueError(f"unknown ring layout {layout!r}")
    if group is None:
        return torch.arange(s_local, device=device)
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    if layout == "zigzag":
        return zigzag_positions(idx, s_local, n, device)[0]
    return torch.arange(idx * s_local, (idx + 1) * s_local, device=device)


def _zigzag_index(S: int, n: int, device=None) -> torch.Tensor:
    """The [S] gather index of the zigzag layout (JAX :92): position j of
    the permuted sequence holds token ``idx[j]``."""
    if S % (2 * n) != 0:
        raise ValueError(
            f"sequence length {S} not divisible by 2*n = {2 * n} — trailing "
            f"tokens would be silently dropped")
    c = S // (2 * n)
    return torch.cat([torch.cat([torch.arange(i * c, (i + 1) * c),
                                 torch.arange((2 * n - 1 - i) * c,
                                              (2 * n - i) * c)])
                      for i in range(n)]).to(device)


def zigzag_permute(x: torch.Tensor, n: int, seq_dim: int = 1
                   ) -> torch.Tensor:
    """Reorder the sequence dim so that a contiguous ``n``-way split gives
    the zigzag ownership (JAX :109); apply to tokens and targets before
    sharding.  A mean loss is permutation-invariant."""
    return x.index_select(seq_dim, _zigzag_index(x.shape[seq_dim], n,
                                                  x.device))


def zigzag_unpermute(x: torch.Tensor, n: int, seq_dim: int = 1
                     ) -> torch.Tensor:
    """:func:`zigzag_permute`'s inverse (JAX :117)."""
    inv = torch.argsort(_zigzag_index(x.shape[seq_dim], n, x.device))
    return x.index_select(seq_dim, inv)


class _Tie(torch.autograd.Function):
    """``out`` unchanged, with ``anchor`` made a dependency: its backward
    hands ``anchor`` a zero gradient, so every ring step that produced
    ``anchor`` runs its reverse send on every rank, including a rank
    whose last hops were all in the future (nothing else would reach
    them there)."""

    @staticmethod
    def forward(ctx, out, anchor):
        ctx.anchor = (anchor.shape, anchor.dtype, anchor.device)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.anchor
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _rotations(k, v, group, n: int):
    """``(held, last)``: the (k, v) in hand at each of the ``n`` hops (step
    ``t`` holds rank ``(idx - t) % n``'s shard) and the last rotated
    tensor (None at one rank: nothing is sent).  k and v travel stacked,
    one send a hop."""
    if n == 1:
        return [(k, v)], None
    kv = torch.stack((k, v))
    held = [(k, v)]
    for _ in range(n - 1):
        kv = ppermute(kv, group, 1)
        held.append((kv[0], kv[1]))
    return held, kv


def _finish(o, last, q_dtype):
    if last is not None:
        o = _Tie.apply(o, last)
    return o.to(q_dtype)


def _serial(q, k, v, causal, sm_scale, use_flash):
    """The attention without a context group: one flash call (CUDA
    tensors launch K3-K5), or the einsum attention without
    ``use_flash``."""
    if use_flash:
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal,
                               sm_scale=sm_scale)
    return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, causal: bool = True,
                   sm_scale: Optional[float] = None, use_flash: bool = True,
                   layout: str = "contiguous") -> torch.Tensor:
    """Ring attention over the context ``group`` (JAX :124): q [B, H,
    S_local, hd], k/v [B, Hkv, S_local, hd] -> [B, H, S_local, hd], the
    sequence sharded as ``layout`` says.  ``use_flash``: a flash call
    (K3-K5 on the card) per hop, combined through the logsumexps; else
    the einsum online-softmax golden path.  ``group=None``: one
    ``flash_attention`` call (the einsum attention without
    ``use_flash``)."""
    if layout not in _LAYOUTS:
        raise ValueError(f"unknown ring layout {layout!r}")
    if group is None:
        return _serial(q, k, v, causal, sm_scale, use_flash)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    H, Hkv = q.shape[1], k.shape[1]
    if H % Hkv:
        raise ValueError(f"GQA needs q heads divisible by kv heads ({H} vs "
                         f"{Hkv})")
    if not use_flash and Hkv != H:
        # the einsum path assumes equal head counts; the flash calls serve
        # shared KV heads themselves
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    if layout == "zigzag" and causal:
        if use_flash:
            return _ring_zigzag_flash(q, k, v, group, sm_scale)
        return _ring_einsum(q, k, v, group, True, sm_scale, zigzag=True)
    # non-causal work is uniform: zigzag needs no bookkeeping of its own
    if use_flash:
        return _ring_flash(q, k, v, group, causal, sm_scale)
    return _ring_einsum(q, k, v, group, causal, sm_scale, zigzag=False)


def _ring_einsum(q, k, v, group, causal, sm_scale, zigzag: bool):
    """The golden path (JAX :190 and :284): the online-softmax update per
    hop on global position arrays.  Contiguous causal skips the future
    hops; zigzag masks them (every zigzag hop carries a past / diagonal
    mix)."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    B, H, S, D = q.shape
    layout = "zigzag" if zigzag else "contiguous"
    qpos = shard_positions(group, S, layout, q.device)
    m = torch.full((B, H, S, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, S, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    held, last = _rotations(k, v, group, n)
    for t, kv in enumerate(held):
        src = (idx - t) % n
        if causal and not zigzag and src > idx:
            continue
        if zigzag:
            kpos = zigzag_positions(src, S, n, q.device)[0]
        else:
            kpos = torch.arange(src * S, (src + 1) * S, device=q.device)
        m, l, acc = _block_update(q, kv[0], kv[1], m, l, acc, qpos, kpos,
                                  causal, sm_scale)
    return _finish(acc / l, last, q.dtype)


def _hop(q, k, v, relation: int, sm_scale):
    """One flash call by the chunks' relation: 1 the diagonal (causal), 2
    entirely in the past (non-causal)."""
    return flash_attention_with_lse(q, k.contiguous(), v.contiguous(),
                                    causal=relation == 1, sm_scale=sm_scale)


def _relation(k_start: int, q_start: int) -> int:
    """0 the key chunk is in the future (skipped), 1 the diagonal, 2 the
    past — JAX's branch index (:265, :358)."""
    return int(k_start <= q_start) + int(k_start < q_start)


def _accumulate(acc, part):
    if acc is None:
        return part[0].float(), part[1]
    return _lse_combine(acc[0], acc[1], part[0], part[1])


def _ring_flash(q, k, v, group, causal, sm_scale):
    """The contiguous flash ring (JAX :230): a causal call on the own
    shard, non-causal calls on the past shards, none on the future ones
    (all hops non-causal without ``causal``)."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    q = q.contiguous()
    held, last = _rotations(k, v, group, n)
    acc = None
    for t, kv in enumerate(held):
        src = (idx - t) % n
        rel = _relation(src, idx) if causal else 2
        if rel:
            acc = _accumulate(acc, _hop(q, kv[0], kv[1], rel, sm_scale))
    return _finish(acc[0], last, q.dtype)


def _ring_zigzag_flash(q, k, v, group, sm_scale):
    """The zigzag flash ring (JAX :315): four half-sized (q-half,
    kv-half) pairs a hop, each the diagonal, the past or the future by
    its chunks' starts — ``2n + 1`` calls a rank in all, whatever its
    index."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    S = q.shape[2]
    if S % 2 != 0:
        raise ValueError(f"zigzag needs an even local sequence length, got "
                         f"{S}")
    c = S // 2
    halves = (q[:, :, :c].contiguous(), q[:, :, c:].contiguous())
    q_starts = (idx * c, (2 * n - 1 - idx) * c)
    held, last = _rotations(k, v, group, n)
    acc: List = [None, None]
    for t, kv in enumerate(held):
        src = (idx - t) % n
        k_starts = (src * c, (2 * n - 1 - src) * c)
        for qi in range(2):
            for ki in range(2):
                rel = _relation(k_starts[ki], q_starts[qi])
                if rel:
                    sl = slice(ki * c, (ki + 1) * c)
                    acc[qi] = _accumulate(acc[qi], _hop(
                        halves[qi], kv[0][:, :, sl], kv[1][:, :, sl], rel,
                        sm_scale))
    return _finish(torch.cat([acc[0][0], acc[1][0]], dim=2), last,
                   q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group=None, causal: bool = True,
                      sm_scale: Optional[float] = None,
                      use_flash: bool = True) -> torch.Tensor:
    """Ulysses sequence parallelism over the context ``group`` (JAX :390):
    an all-to-all scatters the heads and gathers the sequence, attention
    runs on the whole sequence at ``H / n`` heads (``flash_attention``,
    or the plain attention without ``use_flash``), and the inverse
    all-to-all restores ``[B, H, S_local, hd]``.  Both head counts must
    divide by ``n`` (GQA: the kv heads too).  ``group=None``: one
    ``flash_attention`` call (the einsum attention without
    ``use_flash``)."""
    if group is None:
        return _serial(q, k, v, causal, sm_scale, use_flash)
    n = dist.get_world_size(group)
    B, H, S, D = q.shape

    def scatter_heads(x):
        hx = x.shape[1]
        if hx % n:
            raise ValueError(
                f"heads {hx} not divisible by context-parallel size {n}"
                + (" (GQA under Ulysses needs kv_heads % cp == 0)"
                   if hx != H else ""))
        # [n, B, hx/n, S, D]: block r (head group r) to rank r; received
        # blocks come in source order, the sequence's order
        send = x.reshape(B, n, hx // n, S, D).transpose(0, 1)
        recv = all_to_all(send, group)
        return recv.permute(1, 2, 0, 3, 4).reshape(B, hx // n, n * S, D)

    def gather_heads(x):
        send = x.reshape(B, H // n, n, S, D).permute(2, 0, 1, 3, 4)
        recv = all_to_all(send, group)  # [n (head group), B, ...]
        return recv.transpose(0, 1).reshape(B, H, S, D)

    qf, kf, vf = (scatter_heads(t).contiguous() for t in (q, k, v))
    if use_flash:
        out = flash_attention(qf, kf, vf, causal=causal, sm_scale=sm_scale)
    else:
        out = mha_reference(qf, kf, vf, causal=causal, sm_scale=sm_scale)
    return gather_heads(out)
