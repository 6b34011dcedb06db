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

:class:`BlockAllocator` is host-side and O(blocks).  The prefix-cache
hash index, copy-on-write, block migration and the context-parallel
forward are not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Tuple

import torch

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
                  quantized: bool = False, device=None) -> Dict[str, Any]:
    """Zeroed pool ``{'k','v': [L, num_blocks, Hkv, block_size, hd]}`` in
    ``cfg.dtype`` on ``device`` (default: the card); int8 pairs with unit
    scales when ``quantized``."""
    device = resolve_device(device)
    if num_blocks < 2:
        raise ValueError(
            f"num_blocks must be >= 2 (block 0 is the reserved NULL block), "
            f"got {num_blocks}")
    shape = (cfg.nlayers, num_blocks, cfg.block.kv_head_count, block_size,
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


def paged_forward(params: Dict[str, Any], tokens: torch.Tensor,
                  cfg: GPTConfig, cache: Dict[str, Any], tables: torch.Tensor,
                  offset: torch.Tensor, last_idx=None,
                  attn_impl: str = "gather") -> Tuple[Dict[str, Any],
                                                      torch.Tensor]:
    """Run ``tokens`` [B, S_in] (slot b's rows at positions ``offset[b] +
    arange(S_in)``) through the cached stack on the pool: every layer
    writes its k/v into the slots' blocks (in place) and attends through
    the tables.  Returns the pool and the logits [B, V] at per-slot row
    ``last_idx`` (default: the last row).  Chunked prefill is ``S_in =
    chunk``; decode is ``S_in = 1`` — one implementation, both phases.
    The reference's ``all_logits`` (every row's logits, for speculative
    verify) waits for ``spec_k`` (ROADMAP queue A)."""
    bcfg = cfg.block
    S_in = tokens.shape[1]
    offset = offset.to(device=tokens.device, dtype=torch.int32)
    tables = tables.to(device=tokens.device, dtype=torch.int32)
    positions = offset[:, None] + torch.arange(
        S_in, device=tokens.device, dtype=torch.int32)[None, :]
    # padded prefill rows may run past a learned position table; their
    # values are never read, so clamp instead of faulting on the device
    h = _embed_at(params, tokens.long(),
                  positions.clamp(max=cfg.max_seq - 1).long())
    rope = _batched_rope(bcfg, positions)
    slots = _scatter_positions(tables, positions, block_size_of(cache))
    ops = _paged_cache_ops(tables, attn_impl, slots)
    for layer in range(cfg.nlayers):
        h, _, _ = cached_block_forward(
            layer_params(params, layer), h, bcfg,
            _layer_kv(cache["k"], layer), _layer_kv(cache["v"], layer),
            offset, cache_ops=ops, rope=rope)
    logits = gpt_head(params, _select_row(h, last_idx), eps=cfg.norm_eps)
    return cache, logits[:, 0, :]


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
