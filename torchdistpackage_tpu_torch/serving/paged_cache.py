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
  With ``tp_group`` the three forwards run tensor-parallel: the pool
  holds the rank's ``Hkv / tp`` KV heads (``init_paged_kv(axis_size=
  tp)``), the parameters are the rank's shard, and the logits come back
  as the rank's vocabulary slice — beside ``ep_group`` (TP x EP) and
  beside ``cp_group`` (TP x CP: the rings at the local heads).

:class:`BlockAllocator` is host-side and O(blocks): refcounts, the
chained content-hash index of the prefix cache (:func:`chain_block_hashes`)
and the refcount-0 LRU of retained blocks.  The device halves of the
prefix cache and of slot migration are block copies on the pool's own
device and stream: :func:`copy_blocks` (the copy-on-write within one
pool) and :func:`migrate_blocks` (pool to pool), neither reading a value
back to the host.  A torch pool is written in place, so a migration
source that must outlive the source engine's next step is a
:class:`PoolSnapshot` of the slot's live blocks.
"""

from __future__ import annotations

import collections
import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.generate import (
    _embed_at,
    _kv_quant,
    cached_block_forward,
)
from ..models.gpt import GPTConfig, gpt_head, layer_params
from ..obs.comm_ledger import note
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
                  cp: int = 1, axis_size: int = 1) -> Dict[str, Any]:
    """Zeroed pool ``{'k','v': [L, num_blocks, Hkv, block_size, hd]}`` in
    ``cfg.dtype`` on ``device`` (default: the card); int8 pairs with unit
    scales when ``quantized``.  ``cp > 1``: one rank's block slice of a
    context-parallel pool, ``num_blocks / cp`` blocks.  ``axis_size``:
    the tensor-parallel size — the rank's ``Hkv / axis_size`` heads (JAX
    :75)."""
    device = resolve_device(device)
    hkv, rem = divmod(cfg.block.kv_head_count, axis_size)
    if rem or hkv == 0:
        raise ValueError(
            f"kv_heads {cfg.block.kv_head_count} not divisible by tp "
            f"{axis_size} (whole KV heads per shard)")
    if num_blocks < 2:
        raise ValueError(
            f"num_blocks must be >= 2 (block 0 is the reserved NULL block), "
            f"got {num_blocks}")
    if num_blocks % cp:
        raise ValueError(
            f"num_blocks ({num_blocks}) must be divisible by the CP group "
            f"size ({cp})")
    shape = (cfg.nlayers, num_blocks // cp, hkv, block_size,
             cfg.block.head_dim)
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
    """Bytes of the pool's buffers (k + v, scales included; a host-only
    stub's numpy pool too)."""
    return sum(int(t.nbytes) for t in _leaves(cache))


def expected_pool_bytes(cfg: GPTConfig, num_blocks: int, block_size: int,
                        quantized: bool = False, axis_size: int = 1) -> int:
    """What :func:`init_paged_kv` should allocate, from shape math alone —
    the independent half of the pool-accounting cross-check.
    ``axis_size``: the KV heads' split (1: every head here)."""
    entries = (cfg.nlayers * num_blocks
               * (cfg.block.kv_head_count // axis_size) * block_size)
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
    hd/2], from ``rope_cache`` on the flattened positions (JAX :221).
    Under ``'dynamic'`` scaling the length is therefore the longest
    position of the whole call, so one slot's rotation depends on the
    batch it shares — the reference's semantics, kept as they are."""
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
                  offset: torch.Tensor, attn_impl: str, tp_group=None):
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
                  positions.clamp(max=cfg.max_seq - 1).long(), tp_group)
    rope = _batched_rope(cfg.block, positions)
    slots = _scatter_positions(tables, positions, block_size_of(cache))
    return h, offset, rope, _paged_cache_ops(tables, attn_impl, slots)


def paged_forward(params: Dict[str, Any], tokens: torch.Tensor,
                  cfg: GPTConfig, cache: Dict[str, Any], tables: torch.Tensor,
                  offset: torch.Tensor, last_idx=None,
                  attn_impl: str = "gather", all_logits: bool = False,
                  tp_group=None) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Run ``tokens`` [B, S_in] (slot b's rows at positions ``offset[b] +
    arange(S_in)``) through the cached stack on the pool: every layer
    writes its k/v into the slots' blocks (in place) and attends through
    the tables.  Returns the pool and the logits [B, V] at per-slot row
    ``last_idx`` (default: the last row).  Chunked prefill is ``S_in =
    chunk``; decode is ``S_in = 1`` — one implementation, both phases.
    ``all_logits=True`` (JAX :254-297) returns every row's logits [B,
    S_in, V] instead: the speculative verify's ``K + 1`` rows a slot, one
    K1 call a layer.  ``tp_group`` (JAX's ``axis``): ``params`` and the
    pool are the rank's shard (K1 over its ``Hkv / tp`` heads) and the
    logits its vocabulary slice [..., V / tp]."""
    h, offset, rope, ops = _paged_inputs(params, tokens, cfg, cache, tables,
                                         offset, attn_impl, tp_group)
    for layer in range(cfg.nlayers):
        h, _, _ = cached_block_forward(
            layer_params(params, layer), h, cfg.block,
            _layer_kv(cache["k"], layer), _layer_kv(cache["v"], layer),
            offset, cache_ops=ops, rope=rope, tp_group=tp_group)
    return cache, _logits(params, h, cfg, last_idx, all_logits, tp_group)


def _logits(params, h: torch.Tensor, cfg: GPTConfig, last_idx,
            all_logits: bool, tp_group) -> torch.Tensor:
    """Every row's logits [B, S_in, V] (``all_logits``) or row
    ``last_idx``'s [B, V]; the rank's vocabulary slice under
    ``tp_group``."""
    if all_logits:
        return gpt_head(params, h, eps=cfg.norm_eps, tp_group=tp_group)
    return gpt_head(params, _select_row(h, last_idx), eps=cfg.norm_eps,
                    tp_group=tp_group)[:, 0, :]


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
                     cp_group, last_idx=None, attn_impl: str = "gather",
                     tp_group=None) -> Tuple[Dict[str, Any], torch.Tensor]:
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
    ``attn_impl``: ``'cuda'`` (K2) or ``'gather'`` (its plain version).

    ``tp_group`` (JAX :321 with ``axis``): ``params`` is the rank's
    tensor shard and ``cache`` holds its ``Hkv / tp`` heads, so both rings
    run over the CP group (the ranks of this tensor rank) at the local
    heads; each block sums its row-parallel products over the tensor
    group.  The head row's logits are this rank's vocabulary slice, kept
    on its owning CP rank and summed over the CP group, in the
    reference's order; the caller gathers the slices over the tensor
    group (``models.generate._full_logits``)."""
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
                  positions.clamp(max=cfg.max_seq - 1).long(), tp_group)
    rope = _batched_rope(cfg.block, positions)
    ops = _cp_paged_cache_ops(tables, cp_group, attn_impl,
                              prefill=not decode)
    for layer in range(cfg.nlayers):
        h, _, _ = cached_block_forward(
            layer_params(params, layer), h, cfg.block,
            _layer_kv(cache["k"], layer), _layer_kv(cache["v"], layer),
            offset, cache_ops=ops, rope=rope, tp_group=tp_group)
    if decode or cp == 1:
        logits = gpt_head(params, _select_row(h, last_idx), eps=cfg.norm_eps,
                          tp_group=tp_group)
        return cache, logits[:, 0, :]
    li = (torch.full((tokens.shape[0],), S_in - 1, device=dev)
          if last_idx is None else torch.as_tensor(last_idx, device=dev))
    li = li.long()
    mine = (li >= base) & (li < base + sub)
    logits = gpt_head(params, _select_row(h, li - base), eps=cfg.norm_eps,
                      tp_group=tp_group)
    logits = torch.where(mine[:, None, None], logits,
                         torch.zeros((), dtype=logits.dtype, device=dev))
    note("all-reduce", logits, cp_group)
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
                      all_logits: bool = False, tp_group=None):
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
    V], as in :func:`paged_forward` (JAX :415).  ``tp_group``: attention,
    the embedding and the head as in :func:`paged_forward`, the router
    and the experts replicated over the tensor group
    (``models.gpt_moe.gpt_moe_param_specs``).  Both groups at once (JAX
    :407 with ``axis`` and ``ep_axis``): each tensor rank's expert layers
    exchange over its own ``moe_ep`` group, on the activations the
    attention's all-reduce left the same on every tensor rank; in every
    layer every rank issues the all-reduce before the exchange."""
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
                                         offset, attn_impl, tp_group)
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
            ffn=moe_ffn if "moe" in bp else None, tp_group=tp_group)
    logits = _logits(params, h, cfg, last_idx, all_logits, tp_group)
    if not moe_stats:
        return cache, logits
    # routed-token counts sum over the expert layers, the drop rate averages
    metrics = {
        "expert_tokens": sum(m["expert_tokens"] for m in collected),
        "dropped_token_rate": sum(m["dropped_token_rate"] for m in collected)
        / max(len(collected), 1),
    }
    return cache, logits, metrics


# ----------------------------------------------------- block copies


def _lane(ids, device) -> torch.Tensor:
    """A block-id lane vector (list, numpy or tensor) as int64 on
    ``device``; a host vector crosses in one copy, nothing is read back."""
    if isinstance(ids, torch.Tensor):
        return ids.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(ids, np.int64)).to(device)


def _pairs(src_cache: Dict[str, Any], dst_cache: Dict[str, Any]):
    """(src leaf, dst leaf) for every leaf of two pools of one layout
    (a quantized pool's ``(q8, scale)`` pairs leaf by leaf)."""
    for name in ("k", "v"):
        s, d = src_cache[name], dst_cache[name]
        if isinstance(s, tuple) != isinstance(d, tuple):
            raise ValueError(
                "migrate_blocks between a quantized and a float pool")
        yield from (zip(s, d) if isinstance(s, tuple) else ((s, d),))


def copy_blocks(cache: Dict[str, Any], src, dst) -> Dict[str, Any]:
    """Copy block contents ``src[i] -> dst[i]`` along the pool's block dim
    (dim 1 of every leaf, quantized pairs included), in place — the device
    half of copy-on-write (JAX :516).  ``src`` / ``dst`` are fixed-width
    lane vectors, unused lanes padded ``NULL -> NULL`` (the write-off
    block is never read, so colliding pad writes are harmless).  Every
    source block is read before any lane is written, as in the
    reference's functional update.  One gather and one scatter a leaf on
    the pool's stream; no host sync."""
    for leaf in _leaves(cache):
        s, d = _lane(src, leaf.device), _lane(dst, leaf.device)
        leaf[:, d] = leaf[:, s]
    return cache


class PoolSnapshot(dict):
    """One slot's live blocks copied out of a pool: ``{'k','v'}`` leaves
    ``[L, 1 + n, ...]`` whose row 0 is the pool's NULL block and row
    ``1 + j`` block ``block_ids[j]``.  The reference's ``export_slot``
    hands back the pool value itself, immutable in JAX; a torch pool is
    overwritten in place once its engine reuses the blocks, so the export
    copies them (on the pool's device, no host sync) into tensors the
    snapshot owns.  :func:`migrate_blocks` reads it through the source
    engine's block ids, NULL pad lanes included."""

    def __init__(self, cache: Dict[str, Any], blocks: Sequence[int]) -> None:
        ids = [NULL_BLOCK] + [int(b) for b in blocks]

        def take(leaf):
            if isinstance(leaf, np.ndarray):
                return leaf[:, ids].copy()
            return leaf[:, _lane(ids, leaf.device)]

        super().__init__({
            name: (tuple(take(t) for t in x) if isinstance(x, tuple)
                   else take(x)) for name, x in cache.items()})
        self._index(ids)

    @classmethod
    def from_rows(cls, leaves: Dict[str, Any],
                  block_ids: Sequence[int]) -> "PoolSnapshot":
        """A snapshot of leaves already copied out (``[L, len(block_ids),
        ...]``, row ``j`` block ``block_ids[j]``, row 0 the NULL block):
        what a CP engine's export assembles from its ranks' slices."""
        snap = cls.__new__(cls)
        dict.__init__(snap, leaves)
        snap._index([int(b) for b in block_ids])
        return snap

    def _index(self, ids: List[int]) -> None:
        #: the source pool's id of each row
        self.block_ids = ids
        self._row = {}
        for r, b in enumerate(ids):
            self._row.setdefault(b, r)

    def rows(self, ids) -> np.ndarray:
        """The snapshot rows of source block ids (host ids)."""
        ids = ids.tolist() if isinstance(ids, (np.ndarray, torch.Tensor)) \
            else ids
        try:
            return np.asarray([self._row[int(b)] for b in ids], np.int64)
        except KeyError as e:
            raise ValueError(
                f"block {e.args[0]} is not in this snapshot (it holds "
                f"{self.block_ids[1:]})") from None


def migrate_blocks(src_cache: Dict[str, Any], dst_cache: Dict[str, Any],
                   src_ids, dst_ids, compress: bool = False
                   ) -> Dict[str, Any]:
    """Cross-pool block copy ``dst[:, dst_ids[i]] = src[:, src_ids[i]]``
    for every leaf pair, into ``dst_cache`` in place (JAX :530): the
    device half of a prefill -> decode handoff.  The lane vectors are
    fixed width, unused lanes ``NULL -> NULL``.  ``src_cache`` is a pool
    or a :class:`PoolSnapshot` (then ``src_ids`` are the source pool's
    block ids).  The payload moves to the destination's device in the
    same copy.

    ``compress=True`` models the int8 wire of an fp pool: the payload is
    quantised per position vector (``_kv_quant``) and dequantised into the
    destination's dtype.  A quantized pool's ``(q8, scale)`` pairs are the
    wire format already and copy verbatim."""
    compress = compress and not isinstance(dst_cache["k"], tuple)
    if isinstance(src_cache, PoolSnapshot):
        src_ids = src_cache.rows(src_ids)
    for s_leaf, d_leaf in _pairs(src_cache, dst_cache):
        payload = s_leaf[:, _lane(src_ids, s_leaf.device)]
        if compress:
            q, scale = _kv_quant(payload)
            payload = q.float() * scale[..., None]
        d_leaf[:, _lane(dst_ids, d_leaf.device)] = payload.to(
            device=d_leaf.device, dtype=d_leaf.dtype)
    return dst_cache


def migration_wire_bytes(cfg: GPTConfig, n_blocks: int, block_size: int,
                         axis_size: int = 1, quantized: bool = False,
                         compressed: bool = False) -> int:
    """Bytes a migration of ``n_blocks`` pool blocks puts on the wire
    (JAX :570): the k + v payload in the pool's storage format, or the
    int8 ``(q8, scale)`` wire format when ``quantized`` or
    ``compressed``."""
    if n_blocks <= 0:
        return 0
    return expected_pool_bytes(cfg, n_blocks, block_size,
                               quantized=quantized or compressed,
                               axis_size=axis_size)


# ------------------------------------------------------------ allocator


def chain_block_hashes(tokens, block_size: int) -> List[Any]:
    """Per-full-block content hashes chained from position 0 (JAX :587):
    ``h_i = hash((h_{i-1}, tokens of block i))``, so a hash names a
    block's contents AND everything before it — equal hashes mean equal
    KV.  Full blocks only.  Python hashes an int tuple the same in every
    process, so the port and the reference index equal blocks alike."""
    h: Any = 0
    out: List[Any] = []
    for i in range(len(tokens) // block_size):
        h = hash((h, tuple(
            int(t) for t in tokens[i * block_size:(i + 1) * block_size])))
        out.append(h)
    return out


class BlockAllocator:
    """Host-side free list over a pool's blocks (block 0 reserved as the
    NULL block), LIFO reuse — the reference's allocator (JAX :603).

    Every in-use block carries a refcount.  :meth:`share` maps a resident
    block into another slot's table (refcount + 1), :meth:`free`
    decrements, and only a block's last owner releases it.
    :meth:`register` binds a block to a content hash; a released
    registered block is retained on a refcount-0 LRU instead of the free
    list, so its KV survives for the next request with the same prefix.
    :meth:`alloc` evicts retained blocks LRU-first, and only when the free
    list alone falls short (:meth:`pop_evicted` reports them).
    Conservation under sharing: ``unique in_use + cached + free ==
    usable``, ownership refcount-weighted (:meth:`audit`)."""

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is reserved), "
                f"got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        #: block -> refcount (> 0: in use)
        self._ref: Dict[int, int] = {}
        #: refcount-0 retained blocks; insertion order is the LRU order
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self._hash_of: Dict[int, Any] = {}   # block -> content hash
        self._by_hash: Dict[Any, int] = {}   # content hash -> block
        self._evicted: List[int] = []        # since the last pop_evicted()
        self.cache_evictions = 0
        self.peak_in_use = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_cached(self) -> int:
        """Refcount-0 blocks retained for prefix reuse (reclaimable)."""
        return len(self._cached)

    @property
    def n_usable(self) -> int:
        """Allocatable blocks (pool minus the NULL block)."""
        return self.num_blocks - 1

    @property
    def in_use(self) -> int:
        """Unique blocks with a live owner (a shared block counts once)."""
        return len(self._ref)

    def utilization(self) -> float:
        return self.in_use / self.n_usable

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` blocks, or None when the pool cannot cover the request
        (nothing is partially allocated).  Free blocks first; only when
        they fall short are retained blocks evicted, LRU first (their
        hashes leave the index)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free) + len(self._cached):
            return None
        while len(self._free) < n:
            b, _ = self._cached.popitem(last=False)  # LRU
            self._drop_hash(b)
            self._free.append(b)
            self._evicted.append(b)
            self.cache_evictions += 1
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._ref[b] = 1
        self.peak_in_use = max(self.peak_in_use, len(self._ref))
        return blocks

    def pop_evicted(self) -> List[int]:
        """Blocks evicted from the prefix cache since the last call."""
        out, self._evicted = self._evicted, []
        return out

    def _drop_hash(self, b: int) -> None:
        h = self._hash_of.pop(b, None)
        if h is not None and self._by_hash.get(h) == b:
            del self._by_hash[h]

    def share(self, block: int) -> None:
        """Map a resident block into another owner's table: refcount + 1
        for an in-use block, a retained block revived off the LRU.
        Raises on a block that is not resident."""
        b = int(block)
        if b in self._ref:
            self._ref[b] += 1
        elif b in self._cached:
            del self._cached[b]
            self._ref[b] = 1
        else:
            raise ValueError(f"share of non-resident block {b}")
        self.peak_in_use = max(self.peak_in_use, len(self._ref))

    def register(self, block: int, content_hash: Any) -> bool:
        """Bind an in-use block to a content hash for :meth:`match`.  The
        first registration wins: when the hash already names another
        resident block, the newcomer stays unregistered.  Returns True
        when registered."""
        b = int(block)
        if b not in self._ref:
            raise ValueError(f"register of block {b} not in use")
        if content_hash in self._by_hash and self._by_hash[content_hash] != b:
            return False
        self._by_hash[content_hash] = b
        self._hash_of[b] = content_hash
        return True

    def match(self, hashes: Sequence[Any]) -> List[int]:
        """The longest prefix of ``hashes`` whose blocks are resident (in
        use or retained), in order.  A pure read: :meth:`share` pins."""
        out: List[int] = []
        for h in hashes:
            b = self._by_hash.get(h)
            if b is None or (b not in self._ref and b not in self._cached):
                break
            out.append(b)
        return out

    def free(self, blocks: List[int]) -> None:
        """Release one ownership reference a block.  At refcount 0 a
        registered block moves to the LRU's most-recent end, an
        unregistered one to the free list.  Raises on a block this
        allocator does not hold in use."""
        for b in blocks:
            b = int(b)
            r = self._ref.get(b)
            if b == NULL_BLOCK or r is None:
                raise ValueError(
                    f"freeing block {b} not handed out by this allocator")
            if r > 1:
                self._ref[b] = r - 1
                continue
            del self._ref[b]
            if b in self._hash_of:
                self._cached[b] = None
            else:
                self._free.append(b)

    def audit(self, slot_tables) -> Dict[str, Any]:
        """Block conservation against the live slots' owned-block lists:
        ``orphaned`` in-use blocks no slot references (a leak),
        ``unknown`` blocks a slot references that are free or retained (a
        use-after-free), ``shared`` blocks whose number of referencing
        slots differs from their refcount, and ``conserved``: unique
        in-use + retained + free == usable with disjoint sets and no NULL
        entry.  ``ok`` iff all four are clean."""
        counts = collections.Counter(
            int(b) for t in slot_tables for b in t if int(b) != NULL_BLOCK)
        refset = set(counts)
        free_set = set(self._free)
        ref_keys = set(self._ref)
        cached_set = set(self._cached)
        report = {
            "orphaned": sorted(ref_keys - refset),
            "unknown": sorted(refset - ref_keys),
            "shared": sorted(b for b, c in counts.items()
                             if b in self._ref and c != self._ref[b]),
            "conserved": (
                len(self._ref) + len(self._cached) + len(self._free)
                == self.n_usable
                and len(free_set) == len(self._free)
                and not (free_set & ref_keys)
                and not (free_set & cached_set)
                and not (cached_set & ref_keys)
                and NULL_BLOCK not in free_set
                and NULL_BLOCK not in ref_keys
                and NULL_BLOCK not in cached_set),
            "in_use": self.in_use,
            "n_free": self.n_free,
            "n_cached": self.n_cached,
        }
        report["ok"] = (report["conserved"] and not report["orphaned"]
                        and not report["unknown"] and not report["shared"])
        return report

    def reclaim(self, blocks) -> List[int]:
        """Force ``blocks`` back to the free list whatever their state
        (the self-healing half of :meth:`audit`): refcounts, retention
        and hash registrations are dropped.  Returns the blocks actually
        recovered; NULL and already-free blocks are no-ops."""
        healed = []
        free_set = set(self._free)
        for b in blocks:
            b = int(b)
            if b == NULL_BLOCK or not (0 < b < self.num_blocks):
                continue
            self._ref.pop(b, None)
            self._cached.pop(b, None)
            self._drop_hash(b)
            if b not in free_set:
                self._free.append(b)
                free_set.add(b)
                healed.append(b)
        return healed
