"""Paged attention: the query rows of each slot attend against that
slot's KV, walking its block table inside one kernel.

Replaces the TPU kernel ``paged_decode_attention``
(``torchdistpackage_tpu/ops/paged_attention.py:214``, body ``_kernel``
:136) with a CUDA kernel written by hand for Hopper,
``ops/csrc/paged_attention.cu`` (built by :mod:`._build` at first use).
One entry point serves decode (``S_in = 1``), chunked prefill
(``S_in = chunk``), GQA, a sliding window and int8 pools.

What bounds it on an H100: the bytes of live KV it reads, at 3.35 TB/s —
a decode step does one or two operations per byte read.  The kernel
therefore reads each live block once per CTA and only the blocks the
CTA's rows can see (causal and window bounds per CTA), builds no gathered
view, keeps int8 pools int8 until registers, and keeps stages of blocks
in flight with ``cp.async``.  The source's header says what is still
left for a faster version.

The TPU kernel's v5e tuning knobs ``fetch_width`` and ``q_pad_to`` have no
counterpart: a CTA loads its own table entries, and rows are tiled by
the grid's second dimension instead of being padded.

``paged_decode_attention`` launches the kernel for CUDA tensors and
raises on anything it does not take; it computes the plain version,
:func:`paged_decode_attention_reference`, only for tensors on the CPU.
``LAUNCHES["paged_decode_attention"]`` counts kernel launches, so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Dict, Optional

import torch

NEG_INF = -1e30  # finite "minus infinity", as in the kernel

#: kernel launches since the counter was last reset (the wrapper adds one
#: where it launches, and nowhere else)
LAUNCHES: Dict[str, int] = {"paged_decode_attention": 0}

#: (q dtype, pool dtype) -> the C entry point's dtype tag
_DTYPE_TAG = {
    (torch.bfloat16, torch.bfloat16): 0,
    (torch.float32, torch.float32): 1,
    (torch.bfloat16, torch.int8): 2,
    (torch.float32, torch.int8): 3,
}

_ARGTYPES = (
    [ctypes.c_void_p] * 8            # q, k, v, k_scale, v_scale, tables, offsets, out
    + [ctypes.c_int] * 8             # B, Hkv, R, S_in, hd, nb, bs, mb
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
       ctypes.c_int, ctypes.c_void_p]  # block stride, table stride, window,
)                                      # sm_scale, dtype tag, stream


def resolve_attn_impl(impl: Optional[str], device) -> str:
    """``'auto'``/None -> ``'cuda'`` (the kernel) on a CUDA device,
    ``'gather'`` (the plain version) on the CPU.  Explicit values pass
    through validated; ``'gather'`` stays legal on the card as the
    oracle arm."""
    if impl in (None, "auto"):
        return "cuda" if torch.device(device).type == "cuda" else "gather"
    if impl not in ("cuda", "gather"):
        raise ValueError(
            f"attn_impl must be 'cuda', 'gather' or 'auto', got {impl!r}")
    return impl


def _kernel():
    from ._build import load

    lib = load("paged_attention")
    fn = lib.tdp_paged_attention
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def paged_decode_attention_reference(q: torch.Tensor, k_pool: Any,
                                     v_pool: Any, tables: torch.Tensor,
                                     offsets, *, window: Optional[int] = None
                                     ) -> torch.Tensor:
    """The plain version: gather each slot's blocks into a dense view
    (``gather_kv``) and run the dense masked attention
    (``_cached_attention``) — the JAX package's own oracle, in torch."""
    from ..models.generate import _cached_attention
    from ..serving.paged_cache import gather_kv

    return _cached_attention(q, gather_kv(k_pool, tables),
                             gather_kv(v_pool, tables), offsets,
                             window=window)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_decode_attention: {msg}")


def paged_decode_attention(q: torch.Tensor, k_pool: Any, v_pool: Any,
                           tables: torch.Tensor, offsets, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """Attention of ``q`` [B, H, S_in, hd] against each slot's paged
    context.  ``k_pool``/``v_pool``: one layer's pool ``[num_blocks, Hkv,
    bs, hd]``, or its int8 ``(q8, scale [num_blocks, Hkv, bs] f32)``
    pair.  ``tables`` [B, max_blocks] int32; ``offsets`` an int or [B] —
    slot b's rows sit at positions ``offsets[b] + arange(S_in)`` and
    attend keys at ``kpos <= qpos`` (and ``kpos > qpos - window``).
    Returns [B, H, S_in, hd] in ``q.dtype``.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes contiguous tensors, hd in {64, 128}, blocks of 16
    positions, and bf16 or f32 (q and pool alike) or an int8 pool."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pool, v_pool, tables,
                                                offsets, window=window)
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    quantized = isinstance(k_pool, tuple)
    if quantized:
        (k8, ks), (v8, vs) = k_pool, v_pool
        pools, scales = (k8, v8), (ks, vs)
    else:
        pools, scales = (k_pool, v_pool), ()
    _check(q.dim() == 4, f"q must be [B, H, S_in, hd], got {tuple(q.shape)}")
    B, H, S_in, hd = q.shape
    nb, Hkv, bs, pool_hd = pools[0].shape
    tag = _DTYPE_TAG.get((q.dtype, pools[0].dtype))
    _check(tag is not None,
           f"q {q.dtype} with a {pools[0].dtype} pool is not supported")
    _check(hd == pool_hd and hd in (64, 128),
           f"head dim must be 64 or 128 and match the pool, got {hd} / "
           f"{pool_hd}")
    _check(bs == 16, f"the kernel takes pool blocks of 16 positions, got {bs}")
    _check(H % Hkv == 0, f"{H} query heads not divisible by {Hkv} kv heads")
    _check(tables.dim() == 2 and tables.shape[0] == B
           and tables.dtype == torch.int32,
           f"tables must be int32 [{B}, max_blocks]")
    for t in (q, *pools, *scales, tables):
        _check(t.device == q.device, "all tensors must be on q's device")
        _check(t.is_contiguous(), "all tensors must be contiguous")
    for t in pools[1:]:
        _check(t.shape == pools[0].shape and t.dtype == pools[0].dtype,
               "k and v pools must match")
    for t in scales:
        _check(t.dtype == torch.float32 and t.shape == (nb, Hkv, bs),
               f"int8 scales must be f32 [{nb}, {Hkv}, {bs}]")
    if isinstance(offsets, torch.Tensor):
        offs = offsets.to(device=q.device, dtype=torch.int32)
        if offs.dim() == 0:
            offs = offs.expand(B)
        offs = offs.contiguous()
    else:
        offs = torch.full((B,), int(offsets), dtype=torch.int32,
                          device=q.device)
    _check(offs.shape == (B,), f"offsets must be scalar or [{B}]")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(
            q.data_ptr(), pools[0].data_ptr(), pools[1].data_ptr(),
            scales[0].data_ptr() if quantized else None,
            scales[1].data_ptr() if quantized else None,
            tables.data_ptr(), offs.data_ptr(), out.data_ptr(),
            B, Hkv, (H // Hkv) * S_in, S_in, hd, nb, bs, tables.shape[1],
            Hkv * bs * hd, tables.shape[1],
            -1 if window is None else int(window), 1.0 / math.sqrt(hd), tag,
            stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: CUDA error {err}")
    LAUNCHES["paged_decode_attention"] += 1
    return out


def modeled_attend_temp_bytes(impl: str, *, batch: int, kv_heads: int,
                              max_blocks: int, block_size: int,
                              head_dim: int, s_in: int = 1, groups: int = 1,
                              itemsize: int = 4) -> int:
    """Modeled per-layer attention working-set bytes in device memory
    for one call.  ``gather``: the dense per-slot view ``[B, Hkv,
    max_blocks*bs, hd]`` for k and v — O(max context) whatever a slot
    holds.  ``cuda``: only the q rows in and the output rows out; the KV
    blocks stream through shared memory."""
    if impl == "gather":
        return (2 * batch * kv_heads * max_blocks * block_size * head_dim
                * itemsize)
    if impl == "cuda":
        return batch * kv_heads * 2 * groups * s_in * head_dim * itemsize
    raise ValueError(f"impl must be 'gather' or 'cuda', got {impl!r}")
