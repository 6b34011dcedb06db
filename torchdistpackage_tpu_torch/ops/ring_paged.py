"""Ring paged attention: context-parallel (CP) chunked prefill over the
paged pool, over a ``torch.distributed`` group — the PyTorch counterpart
of ``torchdistpackage_tpu/ops/ring_paged.py``.

- **The pool is sharded by blocks**: rank ``r`` of the CP group holds
  global blocks ``[r nb_local, (r + 1) nb_local)`` of every layer as its
  local ``[nb_local, Hkv, bs, hd]`` slice.  Host code (allocator, tables)
  keeps seeing one global pool.
- **A prefill chunk splits into ``cp`` sub-chunks**: rank ``r`` holds rows
  ``[r Csub, (r + 1) Csub)`` of it.  Per layer two rings run, each hop a
  ``dist.batch_isend_irecv`` rotation to rank ``r + 1`` into fresh
  buffers, unrolled like the reference's python-unrolled ``ppermute``:

  1. *write ring* (:func:`ring_paged_write`): the fresh sub-chunk (k, v)
     travels ``cp - 1`` hops and every rank scatters the rows that land
     in ITS blocks;
  2. *attend ring* (:func:`ring_paged_attend`): the per-layer pool
     slices travel ``cp - 1`` hops and each rank's rows continue their
     online-softmax carry against every slice — ``impl='cuda'`` through
     K2 (:func:`.paged_attention.paged_carry_attention`), ``'gather'``
     through its plain version.  The local slice is never overwritten by
     a payload.
- **Decode** (``prefill=False``): every rank runs the same row, attends
  its local slice only, and the partial carries combine exactly across
  the group (``all_reduce`` MAX on ``m``, then SUM on the weighted
  ``acc`` and ``l``), so every rank holds the same output.

``prefill`` is an explicit flag, never inferred from a shape: at
``chunk == cp`` a prefill sub-chunk is one row, like decode.  At ``cp ==
1`` nothing travels and the one hop is the local slice.

``RING_PAYLOADS`` counts the point-to-point payloads the rings send (one
a tensor a hop), so a run can hold them against
:func:`ring_hops_per_chunk`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from .paged_attention import (
    Carry,
    finalize_paged_carry,
    paged_carry_attention,
    paged_carry_attention_reference,
)

__all__ = [
    "RING_PAYLOADS",
    "ring_paged_write",
    "ring_paged_attend",
    "ring_hops_per_chunk",
    "ring_chunk_bytes",
    "modeled_cp_working_set_bytes",
]

#: point-to-point payloads sent by the rings since the counter was last
#: reset (each tensor a hop carries counts one)
RING_PAYLOADS: Dict[str, int] = {"sent": 0}


def cp_size_rank(group) -> tuple:
    """``(cp, rank)`` of this process in the CP ``group``."""
    return dist.get_world_size(group), dist.get_rank(group)


def _rotate(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """One hop of the ring: send each tensor to group rank ``r + 1`` and
    receive its counterpart from ``r - 1``, into fresh buffers."""
    cp, r = cp_size_rank(group)
    to = dist.get_global_rank(group, (r + 1) % cp)
    frm = dist.get_global_rank(group, (r - 1) % cp)
    recv = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, buf in zip(tensors, recv):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), to, group))
        ops.append(dist.P2POp(dist.irecv, buf, frm, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    RING_PAYLOADS["sent"] += len(tensors)
    return recv


def _scatter_local(c: torch.Tensor, val: torch.Tensor, pos: torch.Tensor,
                   tables: torch.Tensor, rank_base: int, nb_local: int,
                   whole: bool = False) -> torch.Tensor:
    """Scatter ``val`` [B, Hkv, S, hd] at absolute positions ``pos``
    [B, S] into the LOCAL slice ``c`` [nb_local, Hkv, bs, hd], in place:
    global block ids resolve through ``tables`` and re-base by
    ``rank_base``; rows that land outside this slice are left out
    (another rank owns them and scatters them when the payload reaches
    it).  The reference sends them to a sentinel index that
    ``mode='drop'`` discards; PyTorch has no drop mode, so the rows are
    filtered instead.  ``whole``: the slice is the whole pool (cp 1), so
    every row is this rank's and no filter (a host sync on the card) is
    needed.  Positions past the table clamp to its last entry, as in
    ``paged_write``."""
    B, Hkv, S, hd = val.shape
    bs = c.shape[2]
    col = torch.clamp(pos // bs, 0, tables.shape[1] - 1).long()
    loc = torch.gather(tables.long(), 1, col).reshape(-1) - rank_base
    idx = (pos % bs).reshape(-1).long()
    rows = val.transpose(1, 2).reshape(B * S, Hkv, hd).to(c.dtype)
    if whole:
        c[loc, :, idx] = rows
        return c
    mine = (loc >= 0) & (loc < nb_local)
    c[loc[mine], :, idx[mine]] = rows[mine]
    return c


def ring_paged_write(c: torch.Tensor, val: torch.Tensor,
                     offset: torch.Tensor, *, tables: torch.Tensor, group,
                     prefill: bool) -> torch.Tensor:
    """The CP counterpart of ``paged_write`` on this rank's slice ``c``:
    ``val`` [B, Hkv, S, hd] holds THIS rank's fresh rows — its sub-chunk
    (rows at ``offset + rank*S + arange(S)``) when ``prefill``, or the
    decode row every rank holds alike otherwise.  A prefill payload
    travels the ring so every rank scatters the rows that map into its
    slice; decode needs no hop.  Int8 pools raise."""
    if isinstance(c, tuple):
        raise NotImplementedError("cp_group does not support kv_quant pools")
    cp, r = cp_size_rank(group)
    B, Hkv, S, hd = val.shape
    nb_local = c.shape[0]
    ar = torch.arange(S, device=val.device)[None, :]
    offset = offset.to(val.device).long()[:, None]
    if not prefill or cp == 1:
        return _scatter_local(c, val, offset + ar, tables, r * nb_local,
                              nb_local, whole=cp == 1)
    cur = val.contiguous()
    for hop in range(cp):  # unrolled: one rotation per hop
        src = (r - hop) % cp
        c = _scatter_local(c, cur, offset + src * S + ar, tables,
                           r * nb_local, nb_local)
        if hop < cp - 1:
            (cur,) = _rotate([cur], group)
    return c


def _combine(carry: Carry, group) -> Carry:
    """Exact cross-rank combine of the decode carries (the reference's
    ``_psum_combine_kernel_carry``): MAX of ``m``, then SUM of
    ``acc * w`` and ``l * w`` with ``w = exp(m - m_max)``."""
    acc, m, l = carry
    m_g = m.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(m - m_g)
    acc = acc * w[..., None]
    l = l * w
    dist.all_reduce(acc, group=group)
    dist.all_reduce(l, group=group)
    return acc, m_g, l


def ring_paged_attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      offset: torch.Tensor, *, tables: torch.Tensor, group,
                      window: Optional[int] = None, impl: str = "gather",
                      sm_scale: Optional[float] = None,
                      prefill: bool = False) -> torch.Tensor:
    """Attention of this rank's rows ``q`` [B, H, S_in, hd] against the
    CP-sharded pool (this rank's slices ``ck``/``cv``).  Prefill: the rows
    sit at ``offset + rank*S_in + arange(S_in)``; the slices travel
    ``cp - 1`` hops and the carry continues across them — the payload at
    hop ``h`` came from rank ``(rank - h) mod cp`` and counts exactly its
    owned blocks.  Decode: each rank attends its local slice and the
    carries combine across the group.  ``impl='cuda'`` runs K2 (its plain
    version for CPU tensors), ``'gather'`` the plain version."""
    if isinstance(ck, tuple):
        raise NotImplementedError("cp_group does not support kv_quant pools")
    if impl not in ("cuda", "gather"):
        raise ValueError(f"impl must be 'cuda' or 'gather', got {impl!r}")
    hop_fn = (paged_carry_attention if impl == "cuda"
              else paged_carry_attention_reference)
    cp, r = cp_size_rank(group)
    B, H, S_in, hd = q.shape
    nb_local = ck.shape[0]
    decode = not prefill and cp > 1
    q = q.contiguous()
    tables = tables.to(device=q.device, dtype=torch.int32)
    offs = offset.to(device=q.device, dtype=torch.int32)
    if prefill:
        offs = offs + r * S_in
    carry = None
    kk, vv = ck, cv
    hops = 1 if decode else cp
    for hop in range(hops):  # unrolled: one rotation per hop
        src = (r - hop) % cp
        carry = hop_fn(q, kk, vv, tables - src * nb_local, offs,
                       carry=carry, window=window, sm_scale=sm_scale)
        if hop < hops - 1:
            kk, vv = _rotate([kk, vv], group)
    if decode:
        carry = _combine(carry, group)
    return finalize_paged_carry(carry, B, H, S_in, hd, q.dtype)


# ----------------------------------------------------- host-side ring models


def ring_hops_per_chunk(nlayers: int, cp: int) -> int:
    """Point-to-point payloads one prefill chunk sends from each rank:
    per layer, the k and v fresh payloads each travel ``cp - 1`` hops
    (write ring) and the k and v pool slices each ``cp - 1`` hops (attend
    ring)."""
    return 0 if cp <= 1 else 4 * (cp - 1) * nlayers


def ring_chunk_bytes(*, nlayers: int, cp: int, batch: int, kv_heads: int,
                     head_dim: int, chunk: int, nb_local: int,
                     block_size: int, itemsize: int) -> int:
    """Modeled wire bytes one prefill chunk puts on the ring from each
    rank (the engine's ``long_context.ring_bytes``): per layer and per
    hop, two fresh sub-chunk payloads (k, v) plus two pool slices."""
    if cp <= 1:
        return 0
    fresh = batch * kv_heads * (chunk // cp) * head_dim * itemsize
    pool = nb_local * kv_heads * block_size * head_dim * itemsize
    return nlayers * (cp - 1) * 2 * (fresh + pool)


def modeled_cp_working_set_bytes(*, kv_heads: int, head_dim: int,
                                 block_size: int, nb_local: int, chunk: int,
                                 cp: int, batch: int = 1, itemsize: int = 4,
                                 attend_temp_bytes: int = 0) -> int:
    """Per-device CP prefill working set beyond the resident pool slice:
    two in-flight rotating slice buffers (k + v, send and receive), the
    fresh sub-chunk (k, v) payload and the attention's per-call temp
    (:func:`.paged_attention.modeled_attend_temp_bytes`)."""
    pool_slice = 2 * nb_local * kv_heads * block_size * head_dim * itemsize
    fresh = (2 * batch * kv_heads * max(1, chunk // max(cp, 1)) * head_dim
             * itemsize)
    return 2 * pool_slice + fresh + int(attend_temp_bytes)
