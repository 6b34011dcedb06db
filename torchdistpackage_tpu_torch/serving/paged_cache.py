"""Paged KV cache: the block pool the serving engine runs on — the
PyTorch counterpart of ``torchdistpackage_tpu/serving/paged_cache.py``.

- **Pool**: ``{'k','v': [L, num_blocks, Hkv, block_size, hd]}`` on the
  device, or int8 ``(q8, scale [L, num_blocks, Hkv, block_size] f32)``
  pairs with ``quantized=True``.
- **Block tables**: ``[num_slots, max_blocks]`` int32; entry ``i`` of a
  slot's row holds its positions ``[i*bs, (i+1)*bs)``.  Block 0 is the
  NULL block: inactive slots and clamped overshoot writes land there and
  it is never read by a live slot.
- **Write** scatters k/v into the pool IN PLACE (the JAX code returns a
  new array; here the pool tensors are updated and returned as they are).
- **Attend**: ``'cuda'`` runs the hand-written kernel
  (:func:`~..ops.paged_attention.paged_decode_attention`) that walks the
  table on the card; ``'gather'`` gathers a dense per-slot view and runs
  the dense attention — the oracle, and the CPU path.
- **Forward**: :func:`paged_forward` for the dense family,
  :func:`paged_forward_moe` for the MoE family (expert FFN every
  ``moe_every``-th block; its experts sharded over an expert-parallel
  group with ``ep_group``), :func:`cp_paged_forward` for the dense family
  over a context-parallel group whose ranks each hold a block slice of
  the pool (ring paged attention, ``ops/ring_paged.py``, K2 on the card).

:class:`BlockAllocator` is host-side and O(blocks).  The prefix-cache
hash index, copy-on-write and block migration are not ported yet
(ROADMAP queue A).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.generate import _embed_at, _kv_quant, cached_block_forward
from ..models.gpt import GPTConfig, gpt_head, layer_params
from ..ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_reference,
)
from ..parallel.tensor_parallel.layers import rope_cache

#: Block id 0 is reserved: inactive slots' tables are all-zero and clamped
#: out-of-range writes land here.  No live slot's table references it.
NULL_BLOCK = 0


def init_paged_kv(cfg: GPTConfig, num_blocks: int, block_size: int,
                  quantized: bool = False, device=None,
                  cp: int = 1) -> Dict[str, Any]:
    """Zeroed pool ``{'k','v': [L, num_blocks, Hkv, block_size, hd]}`` in
    ``cfg.dtype`` on ``device`` (default: the card); int8 pairs with unit
    scales when ``quantized``.  ``cp > 1``: one rank's block slice of a
    context-parallel pool, ``num_blocks / cp`` blocks."""
    device = resolve_device(device)
    if num_blocks < 2:
        raise ValueError(
            f"num_blocks must be >= 2 (block 0 is the reserved NULL block), "
            f"got {num_blocks}")
    if num_blocks % cp:
        raise ValueError(
            f"num_blocks ({num_blocks}) must be divisible by the CP group "
            f"size ({cp})")
    shape = (cfg.nlayers, num_blocks // cp, cfg.block.kv_head_count,
             block_size, cfg.block.head_dim)
    if quantized:
        def entry():
            return (torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.ones(shape[:-1], dtype=torch.float32,
                               device=device))
        return {"k": entry(), "v": entry()}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _leaves(cache: Dict[str, Any]) -> List[torch.Tensor]:
    out = []
    for name in ("k", "v"):
        x = cache[name]
        out.extend(x if isinstance(x, tuple) else (x,))
    return out


def block_size_of(cache: Dict[str, Any]) -> int:
    """The pool's block size (quantized pools store pairs)."""
    k = cache["k"]
    return (k[0] if isinstance(k, tuple) else k).shape[3]


def pool_bytes(cache: Dict[str, Any]) -> int:
    """Bytes of the pool's device buffers (k + v, scales included)."""
    return sum(t.numel() * t.element_size() for t in _leaves(cache))


def expected_pool_bytes(cfg: GPTConfig, num_blocks: int, block_size: int,
                        quantized: bool = False) -> int:
    """What :func:`init_paged_kv` should allocate, from shape math alone —
    the independent half of the pool-accounting cross-check."""
    entries = (cfg.nlayers * num_blocks * cfg.block.kv_head_count
               * block_size)
    hd = cfg.block.head_dim
    if quantized:
        per_kv = entries * hd * 1 + entries * 4  # int8 q + f32 scale
    else:
        per_kv = entries * hd * torch.empty((), dtype=cfg.dtype).element_size()
    return 2 * per_kv


def _scatter_positions(tables: torch.Tensor, pos: torch.Tensor,
                       block_size: int):
    """Absolute per-slot positions [B, S] -> (block ids [B*S], in-block
    offsets [B*S]) through the tables.  Positions past a table's width
    clamp to its LAST entry (NULL for any slot that does not fill its
    table), so padded prefill tails land in the write-off block."""
    max_blocks = tables.shape[1]
    col = torch.clamp(pos // block_size, 0, max_blocks - 1).long()
    blk = torch.gather(tables, 1, col)
    return blk.reshape(-1).long(), (pos % block_size).reshape(-1).long()


def paged_write(c, val: torch.Tensor, offset: torch.Tensor, *,
                tables: torch.Tensor, slots=None):
    """Scatter ``val`` [B, Hkv, S_in, hd] into one layer's pool ``c``
    ([num_blocks, Hkv, bs, hd] or its int8 pair) at per-slot positions
    ``offset[b] + arange(S_in)``, in place; returns ``c``.  ``slots``:
    the ``_scatter_positions`` of those positions when the caller has
    them already (they are the same in every layer of a forward)."""
    B, Hkv, S_in, hd = val.shape
    if slots is None:
        bs = (c[0] if isinstance(c, tuple) else c).shape[2]
        pos = offset[:, None] + torch.arange(S_in, device=val.device)[None, :]
        slots = _scatter_positions(tables, pos, bs)
    blk, idx = slots
    vals = val.transpose(1, 2).reshape(B * S_in, Hkv, hd)
    if isinstance(c, tuple):
        q8, scale = c
        vq, vs = _kv_quant(vals)
        q8[blk, :, idx] = vq
        scale[blk, :, idx] = vs
        return c
    c[blk, :, idx] = vals.to(c.dtype)
    return c


def gather_kv(c, tables: torch.Tensor):
    """One layer's pool -> the dense per-slot view [B, Hkv,
    max_blocks*bs, hd] (or its int8 pair) through the tables; gathered
    index == slot-relative position."""
    tables = tables.long()
    if isinstance(c, tuple):
        q8, scale = c
        g = q8[tables]
        B, nb, Hkv, bs, hd = g.shape
        gs = scale[tables].permute(0, 2, 1, 3).reshape(B, Hkv, nb * bs)
        return (g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, nb * bs, hd), gs)
    g = c[tables]
    B, nb, Hkv, bs, hd = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, nb * bs, hd)


def paged_attention(q: torch.Tensor, ck, cv, offset, *,
                    tables: torch.Tensor, window: Optional[int] = None,
                    impl: str = "gather") -> torch.Tensor:
    """Attention of q [B, H, S_in, hd] against each slot's paged context:
    ``impl='cuda'`` the kernel, ``'gather'`` the plain version."""
    if impl == "cuda":
        return paged_decode_attention(q.contiguous(), ck, cv, tables, offset,
                                      window=window)
    return paged_decode_attention_reference(q, ck, cv, tables, offset,
                                            window=window)


def _paged_cache_ops(tables: torch.Tensor, attn_impl: str, slots):
    """The ``(write, attend)`` pair ``cached_block_forward`` runs on;
    ``slots`` are the write positions shared by every layer."""
    def write(c, val, offset):
        return paged_write(c, val, offset, tables=tables, slots=slots)

    def attend(q, ck, cv, offset, window=None):
        return paged_attention(q, ck, cv, offset, tables=tables,
                               window=window, impl=attn_impl)
    return write, attend


def _batched_rope(bcfg, positions: torch.Tensor):
    """Per-slot rope tables: positions [B, S] -> (cos, sin) [B, 1, S,
    hd/2], from ``rope_cache`` on the flattened positions."""
    if not bcfg.rope:
        return None
    B, S = positions.shape
    cos, sin = rope_cache(positions.reshape(-1), bcfg.head_dim,
                          bcfg.rope_theta, scaling=bcfg.rope_scaling)
    half = cos.shape[-1]
    return (cos.reshape(B, S, half)[:, None],
            sin.reshape(B, S, half)[:, None])


def _select_row(h: torch.Tensor, last_idx) -> torch.Tensor:
    """h [B, S, D] -> [B, 1, D] at per-slot row ``last_idx`` ([B]);
    None = the last row (the decode case)."""
    if last_idx is None:
        return h[:, -1:, :]
    idx = torch.clamp(torch.as_tensor(last_idx, device=h.device).long(), 0,
                      h.shape[1] - 1)
    return torch.gather(h, 1, idx[:, None, None].expand(-1, 1, h.shape[2]))


def _layer_kv(c, layer: int):
    return tuple(t[layer] for t in c) if isinstance(c, tuple) else c[layer]


def _paged_inputs(params: Dict[str, Any], tokens: torch.Tensor,
                  cfg: GPTConfig, cache: Dict[str, Any], tables: torch.Tensor,
                  offset: torch.Tensor, attn_impl: str):
    """What every layer of a paged forward shares: the embedded rows, the
    int32 offsets, the rope tables and the ``(write, attend)`` pair."""
    S_in = tokens.shape[1]
    offset = offset.to(device=tokens.device, dtype=torch.int32)
    tables = tables.to(device=tokens.device, dtype=torch.int32)
    positions = offset[:, None] + torch.arange(
        S_in, device=tokens.device, dtype=torch.int32)[None, :]
    # padded prefill rows may run past a learned position table; their
    # values are never read, so clamp instead of faulting on the device
    h = _embed_at(params, tokens.long(),
                  positions.clamp(max=cfg.max_seq - 1).long())
    rope = _batched_rope(cfg.block, positions)
    slots = _scatter_positions(tables, positions, block_size_of(cache))
    return h, offset, rope, _paged_cache_ops(tables, attn_impl, slots)


def paged_forward(params: Dict[str, Any], tokens: torch.Tensor,
                  cfg: GPTConfig, cache: Dict[str, Any], tables: torch.Tensor,
                  offset: torch.Tensor, last_idx=None,
                  attn_impl: str = "gather",
                  all_logits: bool = False) -> Tuple[Dict[str, Any],
                                                     torch.Tensor]:
    """Run ``tokens`` [B, S_in] (slot b's rows at positions ``offset[b] +
    arange(S_in)``) through the cached stack on the pool: every layer
    writes its k/v into the slots' blocks (in place) and attends through
    the tables.  Returns the pool and the logits [B, V] at per-slot row
    ``last_idx`` (default: the last row).  Chunked prefill is ``S_in =
    chunk``; decode is ``S_in = 1`` — one implementation, both phases.
    ``all_logits=True`` (JAX :254-297) returns every row's logits [B,
    S_in, V] instead: the speculative verify's ``K + 1`` rows a slot, one
    K1 call a layer."""
    h, offset, rope, ops = _paged_inputs(params, tokens, cfg, cache, tables,
                                         offset, attn_impl)
    for layer in range(cfg.nlayers):
        h, _, _ = cached_block_forward(
            layer_params(params, layer), h, cfg.block,
            _layer_kv(cache["k"], layer), _layer_kv(cache["v"], layer),
            offset, cache_ops=ops, rope=rope)
    if all_logits:
        return cache, gpt_head(params, h, eps=cfg.norm_eps)
    logits = gpt_head(params, _select_row(h, last_idx), eps=cfg.norm_eps)
    return cache, logits[:, 0, :]


def _cp_paged_cache_ops(tables: torch.Tensor, group, attn_impl: str,
                        prefill: bool):
    """The ``(write, attend)`` pair for a pool whose block dim is sharded
    over the CP ``group`` (``ops/ring_paged.py``): the write ring
    completes the chunk's pool write before attend runs, so the attend
    ring only ever moves pool slices.  ``prefill`` is the phase of the
    WHOLE chunk (S_in > 1): at ``chunk == cp`` a sub-chunk is one row,
    like decode."""
    from ..ops.ring_paged import ring_paged_attend, ring_paged_write

    def write(c, val, offset):
        return ring_paged_write(c, val, offset, tables=tables, group=group,
                                prefill=prefill)

    def attend(q, ck, cv, offset, window=None):
        return ring_paged_attend(q, ck, cv, offset, tables=tables,
                                 group=group, window=window, impl=attn_impl,
                                 prefill=prefill)
    return write, attend


def cp_paged_forward(params: Dict[str, Any], tokens: torch.Tensor,
                     cfg: GPTConfig, cache: Dict[str, Any],
                     tables: torch.Tensor, offset: torch.Tensor, *,
                     cp_group, last_idx=None,
                     attn_impl: str = "gather") -> Tuple[Dict[str, Any],
                                                         torch.Tensor]:
    """:func:`paged_forward` across a context-parallel (CP) group — ring
    paged prefill.  Every rank calls it with the same tokens, tables and
    offsets; ``cache`` is the rank's block slice of the pool
    (``[L, num_blocks / cp, Hkv, bs, hd]``: global blocks ``[r nb_local,
    (r + 1) nb_local)``).

    Prefill (``S_in = chunk``, divisible by cp): rank ``r`` embeds and
    projects only its sub-chunk rows ``[r Csub, (r + 1) Csub)``; per layer
    the write ring lands every row in its owner's slice and the attend
    ring carries each rank's rows across all slices.  A slot's head row
    lives on one rank: its logits are kept there, zeroed elsewhere, and
    summed over the group, so every rank samples from the same logits.
    Decode (``S_in = 1``): every rank runs the same row, attends its local
    slice, and the exact cross-rank combine leaves the output the same on
    every rank.  At cp 1 there is no collective and one hop.
    ``attn_impl``: ``'cuda'`` (K2) or ``'gather'`` (its plain version)."""
    from ..ops.ring_paged import cp_size_rank

    cp, r = cp_size_rank(cp_group)
    dev = tokens.device
    S_in = tokens.shape[1]
    offset = offset.to(device=dev, dtype=torch.int32)
    tables = tables.to(device=dev, dtype=torch.int32)
    decode = S_in == 1
    sub, base = S_in, 0
    if not (decode or cp == 1):
        if S_in % cp:
            raise ValueError(
                f"cp prefill needs the chunk ({S_in}) divisible by the "
                f"CP group size ({cp})")
        sub, base = S_in // cp, r * (S_in // cp)
    positions = offset[:, None] + base + torch.arange(
        sub, device=dev, dtype=torch.int32)[None, :]
    # padded prefill rows may run past a learned position table; their
    # values are never read, so clamp instead of faulting on the device
    h = _embed_at(params, tokens[:, base:base + sub].long(),
                  positions.clamp(max=cfg.max_seq - 1).long())
    rope = _batched_rope(cfg.block, positions)
    ops = _cp_paged_cache_ops(tables, cp_group, attn_impl,
                              prefill=not decode)
    for layer in range(cfg.nlayers):
        h, _, _ = cached_block_forward(
            layer_params(params, layer), h, cfg.block,
            _layer_kv(cache["k"], layer), _layer_kv(cache["v"], layer),
            offset, cache_ops=ops, rope=rope)
    if decode or cp == 1:
        logits = gpt_head(params, _select_row(h, last_idx), eps=cfg.norm_eps)
        return cache, logits[:, 0, :]
    li = (torch.full((tokens.shape[0],), S_in - 1, device=dev)
          if last_idx is None else torch.as_tensor(last_idx, device=dev))
    li = li.long()
    mine = (li >= base) & (li < base + sub)
    logits = gpt_head(params, _select_row(h, li - base), eps=cfg.norm_eps)
    logits = torch.where(mine[:, None, None], logits,
                         torch.zeros((), dtype=logits.dtype, device=dev))
    dist.all_reduce(logits, group=cp_group)
    return cache, logits[:, 0, :]


def resolve_serving_dispatch(dispatch: Optional[str], device,
                             ep: bool = False) -> str:
    """The MoE dispatch a serving forward runs: ``'cuda'`` or the plain
    arm, ``'auto'`` / None by the device.  Without expert parallelism the
    plain arm is the ragged ``'gather'``; with it (``ep``) the exchange has
    no ragged form, so ``'gather'`` maps to the index dispatch
    ``'sorted'``."""
    from ..ops.moe_dispatch import resolve_moe_dispatch

    if not ep:
        return resolve_moe_dispatch(dispatch, device)
    return resolve_moe_dispatch("sorted" if dispatch == "gather" else
                                dispatch, device, plain="sorted")


def paged_forward_moe(params: Dict[str, Any], tokens: torch.Tensor,
                      cfg: GPTConfig, cache: Dict[str, Any],
                      tables: torch.Tensor, offset: torch.Tensor,
                      last_idx=None, attn_impl: str = "gather",
                      moe_dispatch: Optional[str] = None,
                      moe_stats: bool = False, ep_group=None,
                      all_logits: bool = False):
    """:func:`paged_forward` for the MoE family: ``params['blocks']`` is the
    per-block list of ``init_gpt_moe_params``, and every expert block's FFN
    is :func:`~..parallel.moe.moe_serve_forward` (exact no-drop routing).
    ``moe_dispatch`` overrides ``cfg.moe_dispatch`` (``'gather'`` the
    ragged plain arm, ``'cuda'`` the fused kernel K6, ``'auto'`` by the
    device), resolved once a call.  ``moe_stats=True`` returns ``(cache,
    logits, metrics)`` with the per-expert routed-token counts summed over
    the expert layers and the drop rate averaged — the engine's live
    expert-load signal.

    ``ep_group`` (a ``torch.distributed`` group; every rank runs the same
    tokens, its blocks holding its share of the experts —
    ``models.gpt_moe.shard_moe_params``): the expert layers run
    :func:`~..parallel.moe.moe_forward`'s exchange path at the no-drop
    capacity factor ``max(cf, E / top_k)`` (so ``C = T``: nothing drops),
    with token-major priority for a causal model; ``'gather'`` maps to
    the index dispatch ``'sorted'`` (the exchange has no ragged form) and
    ``'cuda'`` runs K7.  ``all_logits=True``: every row's logits [B, S_in,
    V], as in :func:`paged_forward` (JAX :415)."""
    from ..models.gpt_moe import moe_layer_config
    from ..parallel.moe import moe_forward, moe_serve_forward

    mcfg = moe_layer_config(cfg)
    disp = resolve_serving_dispatch(
        mcfg.dispatch if moe_dispatch is None else moe_dispatch,
        tokens.device, ep=ep_group is not None)
    if ep_group is not None:
        mcfg = dataclasses.replace(
            mcfg, dispatch=disp, capacity_factor=max(
                mcfg.capacity_factor, mcfg.num_experts / mcfg.top_k))
    h, offset, rope, ops = _paged_inputs(params, tokens, cfg, cache, tables,
                                         offset, attn_impl)
    collected = []  # per-expert-layer metrics (moe_stats)

    def moe_ffn(p, hh):
        if ep_group is None:
            out = moe_serve_forward(p["moe"], hh, mcfg, dispatch=disp,
                                    return_metrics=moe_stats)
        else:
            out = moe_forward(p["moe"], hh, mcfg, ep_group=ep_group,
                              causal=cfg.block.causal,
                              return_metrics=moe_stats)
            out = out[::2] if moe_stats else out[0]  # drop the aux loss
        if not moe_stats:
            return out
        collected.append(out[1])
        return out[0]

    for layer, bp in enumerate(params["blocks"]):
        h, _, _ = cached_block_forward(
            bp, h, cfg.block, _layer_kv(cache["k"], layer),
            _layer_kv(cache["v"], layer), offset, cache_ops=ops, rope=rope,
            ffn=moe_ffn if "moe" in bp else None)
    if all_logits:
        logits = gpt_head(params, h, eps=cfg.norm_eps)
    else:
        logits = gpt_head(params, _select_row(h, last_idx),
                          eps=cfg.norm_eps)[:, 0, :]
    if not moe_stats:
        return cache, logits
    # routed-token counts sum over the expert layers, the drop rate averages
    metrics = {
        "expert_tokens": sum(m["expert_tokens"] for m in collected),
        "dropped_token_rate": sum(m["dropped_token_rate"] for m in collected)
        / max(len(collected), 1),
    }
    return cache, logits, metrics


class BlockAllocator:
    """Host-side free list over a pool's blocks (block 0 reserved as the
    NULL block), LIFO reuse.  Every in-use block has one owner in this
    slice: the refcounts, the content-hash index and the cached LRU of
    the reference's prefix cache are not ported yet."""

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is reserved), "
                f"got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._in_use: set = set()
        self.peak_in_use = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_usable(self) -> int:
        """Allocatable blocks (pool minus the NULL block)."""
        return self.num_blocks - 1

    @property
    def in_use(self) -> int:
        return len(self._in_use)

    def utilization(self) -> float:
        return self.in_use / self.n_usable

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` blocks, or None when the pool cannot cover the request
        (nothing is partially allocated)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self._in_use.update(blocks)
        self.peak_in_use = max(self.peak_in_use, len(self._in_use))
        return blocks

    def free(self, blocks: List[int]) -> None:
        """Return blocks to the free list; raises on a block this
        allocator did not hand out (or already took back)."""
        for b in blocks:
            b = int(b)
            if b == NULL_BLOCK or b not in self._in_use:
                raise ValueError(
                    f"freeing block {b} not handed out by this allocator")
            self._in_use.discard(b)
            self._free.append(b)

    def audit(self, slot_tables) -> Dict[str, Any]:
        """Block conservation against the live slots' owned-block lists:
        ``orphaned`` in-use blocks no slot owns (a leak), ``unknown``
        blocks a slot owns that are free (a use-after-free), ``shared``
        blocks owned by more than one slot (a collision), and
        ``conserved``: in-use + free == usable with disjoint sets and no
        NULL entry.  ``ok`` iff all four are clean."""
        counts = collections.Counter(
            int(b) for t in slot_tables for b in t if int(b) != NULL_BLOCK)
        refset = set(counts)
        free_set = set(self._free)
        report = {
            "orphaned": sorted(self._in_use - refset),
            "unknown": sorted(refset - self._in_use),
            "shared": sorted(b for b, c in counts.items()
                             if b in self._in_use and c != 1),
            "conserved": (
                len(self._in_use) + len(self._free) == self.n_usable
                and len(free_set) == len(self._free)
                and not (free_set & self._in_use)
                and NULL_BLOCK not in free_set
                and NULL_BLOCK not in self._in_use),
            "in_use": self.in_use,
            "n_free": self.n_free,
        }
        report["ok"] = (report["conserved"] and not report["orphaned"]
                        and not report["unknown"] and not report["shared"])
        return report

    def reclaim(self, blocks) -> List[int]:
        """Force-return ``blocks`` to the free list whatever their state
        (the self-healing half of :meth:`audit`); returns the blocks
        actually recovered.  NULL and already-free blocks are no-ops."""
        healed = []
        free_set = set(self._free)
        for b in blocks:
            b = int(b)
            if b == NULL_BLOCK or not (0 < b < self.num_blocks):
                continue
            self._in_use.discard(b)
            if b not in free_set:
                self._free.append(b)
                free_set.add(b)
                healed.append(b)
        return healed
