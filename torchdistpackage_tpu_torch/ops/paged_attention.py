"""Paged attention: the query rows of each slot attend against that
slot's KV, walking its block table inside one kernel (K1), and one hop of
the context-parallel ring over one rank's slice of the pool (K2).

Replaces the TPU kernel ``paged_decode_attention``
(``torchdistpackage_tpu/ops/paged_attention.py:214``, body ``_kernel``
:136) with a CUDA kernel written by hand for Hopper,
``ops/csrc/paged_attention.cu`` (built by :mod:`._build` at first use).
One entry point serves decode (``S_in = 1``), chunked prefill
(``S_in = chunk``), GQA, a sliding window and int8 pools.

What bounds it on an H100 depends on the shape.  Decode rows (``R = (H /
Hkv) * S_in <= DECODE_ROWS``) are bound by the bytes of live KV they read,
at 3.35 TB/s (one or two operations per byte): they run split-KV — a grid
of ``(B * Hkv, nsplit)`` CTAs, each over one near-equal share of its
slot's visible blocks (:func:`decode_split_plan`), bf16 pools on the
tensor cores, f32 and int8 pools on the CUDA cores — and a second kernel
merges each row's partials in split order from a workspace the wrapper
takes from PyTorch's caching allocator, so the output is the same bits
run to run.  ``nsplit`` (:func:`decode_splits`) depends on the grid and
the table width only, never on ``offsets``: a decode step reads nothing
back from the card.  The kernel reads only the blocks a CTA's rows can
see, builds no gathered view and keeps int8 pools int8 until registers.
A prefill chunk is bound by operations:
with bf16 pools its rows run on the tensor cores (``mma.sync`` m16n8k16,
64 query rows a CTA, key tiles of 4 pool blocks, the online softmax on
the accumulator fragments, P re-packed in registers for P·V); f32 and
int8 pools keep their rows on the CUDA cores.  The source's header says
what is still left for a faster version.

The TPU kernel's v5e tuning knobs ``fetch_width`` and ``q_pad_to`` have no
counterpart: a CTA loads its own table entries, and rows are tiled by
the grid's second dimension instead of being padded.

``paged_decode_attention`` launches the kernel for CUDA tensors and
raises on anything it does not take; it computes the plain version,
:func:`paged_decode_attention_reference`, only for tensors on the CPU.
``LAUNCHES["paged_decode_attention"]`` counts wrapper calls that launch
(one a call, also where decode rows launch the split kernel and the
merge), so a run can show that its main path went through the kernel.
:func:`paged_decode_split_reference` is the plain version of the decode
rows' split schedule itself: K2's plain version over each split's share,
merged in the kernels' order.

K2, :func:`paged_carry_attention`, replaces the TPU kernel of the same
name (``torchdistpackage_tpu/ops/paged_attention.py:509``, body
``_cp_kernel`` :332).  It is K1's kernel bodies with the carry in and out:
the walk over ONE rank's pool slice through a re-based table (entries
outside the slice are other ranks' blocks, neither read nor scored; on
the tensor cores each key tile packs the next 4 blocks the rank owns;
decode rows seed the incoming carry once, in the merge),
returning the raw online-softmax carry ``(acc, m, l)`` that the ring
(:mod:`.ring_paged`) passes from hop to hop and
:func:`finalize_paged_carry` divides once.  At cp 1 it runs K1's tiles in
K1's order, so the finished carry equals K1's output bit for bit.  Its
plain version is the gather arm's arithmetic,
:func:`paged_carry_attention_reference`;
``LAUNCHES["paged_carry_attention"]`` counts its launches.  The TPU
kernel's 128-lane ``m``/``l`` and ``q_pad_to`` row padding have no
counterpart: ``m`` and ``l`` are ``[B, Hkv, R]``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

NEG_INF = -1e30  # finite "minus infinity", as in the kernel
BLOCK = 16  # the kernels' pool block (positions)

#: kernel launches since the counter was last reset (the wrapper adds one
#: where it launches, and nowhere else)
LAUNCHES: Dict[str, int] = {"paged_decode_attention": 0,
                            "paged_carry_attention": 0}

#: K2's online-softmax carry: (acc [B, Hkv, R, hd], m [B, Hkv, R],
#: l [B, Hkv, R]), all f32, rows group-major (r = g * S_in + s)
Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

#: (q dtype, pool dtype) -> the C entry point's dtype tag
_DTYPE_TAG = {
    (torch.bfloat16, torch.bfloat16): 0,
    (torch.float32, torch.float32): 1,
    (torch.bfloat16, torch.int8): 2,
    (torch.float32, torch.int8): 3,
}

_ARGTYPES = (
    [ctypes.c_void_p] * 9            # q, k, v, k_scale, v_scale, tables,
    + [ctypes.c_int] * 10            # offsets, out, workspace; B, Hkv, R,
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
       ctypes.c_int, ctypes.c_void_p]  # S_in, hd, nb, bs, mb, nsplit,
)                                      # order; block stride, table stride,
                                       # window, sm_scale, dtype tag, stream


_CARRY_ARGTYPES = (
    [ctypes.c_void_p] * 12           # q, k, v, tables, offsets, acc/m/l in,
    + [ctypes.c_int] * 10            # acc/m/l out, workspace; B, Hkv, R,
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
       ctypes.c_int, ctypes.c_void_p]  # S_in, hd, nb, bs, mb, nsplit,
)                                      # order; block stride, table stride,
                                       # window, sm_scale, dtype tag, stream

#: decode rows: a call with R = (H / Hkv) * S_in <= DECODE_ROWS rows a
#: (slot, KV head) runs the split-KV body and the merge (one m16 tile)
DECODE_ROWS = 16
#: CTAs the decode rows' split grid holds at most, per SM: two waves of
#: the two that fit an SM (``chip_smoke.py``'s NSPLIT sweep)
DECODE_CTAS_PER_SM = 4
#: fewest table blocks a split is cut to (one stage of the tensor-core
#: body)
DECODE_MIN_BLOCKS = 4
#: most slots whose bf16 split grid starts the longest slots first: each
#: CTA ranks the B slots itself, B^2 / 128 compares a thread, which
#: outweighs the shorter tail above about 128 slots (``chip_smoke.py``'s
#: ``order_sweep`` and ``slot_order_sweep``)
DECODE_ORDER_MAX_SLOTS = 128


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


def _kernel(name: str = "tdp_paged_attention", argtypes=_ARGTYPES):
    from ._build import load

    fn = getattr(load("paged_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def decode_splits(bh: int, mb: int, sms: int = 132) -> int:
    """NSPLIT of the decode rows' split grid ``(bh, NSPLIT)``, from the
    number of (slot, KV head) pairs ``bh``, the table width ``mb`` and
    the card's SM count alone — never from ``offsets``, so a decode step
    needs no read back from the device: as many splits as keep the grid
    within ``DECODE_CTAS_PER_SM`` CTAs an SM, but none cut below
    ``DECODE_MIN_BLOCKS`` blocks of the widest table, and at least one."""
    want = DECODE_CTAS_PER_SM * sms // bh
    return max(1, min(want, -(-mb // DECODE_MIN_BLOCKS)))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _splits_for(bh: int, mb: int, device) -> int:
    """:func:`decode_splits` on ``device``'s SM count."""
    return decode_splits(bh, mb, _sm_count(torch.device(device)))


def decode_split_plan(offsets: Sequence[int], S_in: int,
                      window: Optional[int], mb: int,
                      nsplit: int) -> List[List[Tuple[int, int]]]:
    """The kernels' split plan of decode rows, per slot and split: the
    table blocks ``[lo, hi)`` the slot's rows can see — causal above (the
    block of its last row), the window below (the first block its first
    row still sees), as ``cta_bounds`` in the source — cut into
    ``nsplit`` near-equal shares ``[lo + n s // nsplit, lo + n (s + 1) //
    nsplit)``, ``n = hi - lo``: every block in exactly one share."""
    plan = []
    for off in offsets:
        qmin, qmax = int(off), int(off) + S_in - 1
        hi = min(qmax // BLOCK + 1, mb)
        lo = (max(0, qmin - window + 1) // BLOCK
              if window is not None and window > 0 else 0)
        n = max(hi - lo, 0)
        plan.append([(lo + n * s // nsplit, lo + n * (s + 1) // nsplit)
                     for s in range(nsplit)])
    return plan


def merge_partials(partials: Sequence[Carry],
                   carry: Optional[Carry] = None) -> Carry:
    """The split-KV merge, in the kernels' order: ``carry`` (K2's incoming
    one, entering exactly once) then each partial in index order, all
    rescaled to the max over the states that met a key (``l > 0``; one
    that met none adds nothing)."""
    acc0, m0, _ = partials[0]
    if carry is None:
        acc = torch.zeros_like(acc0)
        m = torch.full_like(m0, NEG_INF)
        l = torch.zeros_like(m0)
    else:
        acc, m, l = carry
    mm = m
    for _, pm, pl in partials:
        mm = torch.where(pl > 0, torch.maximum(mm, pm), mm)
    f0 = torch.exp(m - mm)
    acc, l = acc * f0[..., None], l * f0
    for pa, pm, pl in partials:
        f = torch.where(pl > 0, torch.exp(pm - mm), 0.0)
        acc = acc + pa * f[..., None]
        l = l + pl * f
    return acc, mm, l


def paged_decode_split_reference(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, tables: torch.Tensor,
                                 offsets, *, nsplit: int,
                                 carry: Optional[Carry] = None,
                                 window: Optional[int] = None,
                                 sm_scale: Optional[float] = None) -> Carry:
    """The plain version of the decode rows' split-KV schedule: each
    split's partial carry by K2's plain version over that split's blocks
    under :func:`decode_split_plan` (every other entry marked another
    rank's), merged by :func:`merge_partials` in index order after
    ``carry``.  Returns the carry; :func:`finalize_paged_carry` gives K1's
    output.  ``tables`` may be K2's re-based slice tables."""
    B, _, S_in, _ = q.shape
    tab = tables.to(q.device)
    offs = _offsets_on(offsets, B, q.device)
    plan = decode_split_plan(offs.tolist(), S_in, window, tab.shape[1],
                             nsplit)
    cols = torch.arange(tab.shape[1], device=q.device)[None]
    partials = []
    for s in range(nsplit):
        lo, hi = (torch.tensor([p[s][i] for p in plan], device=q.device)
                  [:, None] for i in (0, 1))
        mine = (cols >= lo) & (cols < hi)
        partials.append(paged_carry_attention_reference(
            q, k_pool, v_pool, torch.where(mine, tab, -1), offs,
            window=window, sm_scale=sm_scale))
    return merge_partials(partials, carry)


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


def check_nsplit(nsplit: Optional[int], R: int, mb: int,
                 where: str = "paged_decode_attention") -> None:
    """An explicit ``nsplit`` (the tuner's knob; None keeps
    :func:`decode_splits`) applies to decode rows only (``R <=
    DECODE_ROWS``) and lies in ``[1, mb]``: every split then owns a share
    of the table, empty where a slot sees fewer blocks."""
    if nsplit is None:
        return
    _check(R <= DECODE_ROWS, f"nsplit applies to decode rows (R <= "
           f"{DECODE_ROWS}), got R = {R}", where)
    _check(1 <= int(nsplit) <= mb,
           f"nsplit must be in [1, {mb}] (the table width), got {nsplit}",
           where)


def _workspace(B: int, Hkv: int, R: int, hd: int, mb: int, device,
               nsplit: Optional[int] = None
               ) -> Tuple[int, int, Optional[torch.Tensor]]:
    """``(nsplit, order, workspace)`` of one launch: for decode rows the
    split count (``nsplit``, else :func:`decode_splits`), whether the grid
    starts the longest slots first (up to ``DECODE_ORDER_MAX_SLOTS``
    slots) and the f32 partial states (acc, m, l of ``nsplit`` splits of
    every (slot, KV head)'s R rows) from PyTorch's caching allocator;
    ``(0, 0, None)`` for prefill rows."""
    if R > DECODE_ROWS:
        return 0, 0, None
    nsplit = (int(nsplit) if nsplit is not None
              else _splits_for(B * Hkv, mb, device))
    return nsplit, int(B <= DECODE_ORDER_MAX_SLOTS), torch.empty(
        B * Hkv * nsplit * R * (hd + 2), dtype=torch.float32, device=device)


def _check(cond: bool, msg: str,
           where: str = "paged_decode_attention") -> None:
    if not cond:
        raise ValueError(f"{where}: {msg}")


def _aligned(tensors, where: str = "paged_decode_attention") -> None:
    """The kernels read q, the pools and the carry in 16-byte pieces."""
    for t in tensors:
        _check(t.data_ptr() % 16 == 0,
               "q, the pools and the carry must start 16-byte aligned", where)


def _offsets_on(offsets, B: int, device) -> torch.Tensor:
    """``offsets`` (an int or [B]) as a contiguous int32 [B] on ``device``."""
    if isinstance(offsets, torch.Tensor):
        offs = offsets.to(device=device, dtype=torch.int32)
        if offs.dim() == 0:
            offs = offs.expand(B)
        return offs.contiguous()
    return torch.full((B,), int(offsets), dtype=torch.int32, device=device)


def paged_decode_attention(q: torch.Tensor, k_pool: Any, v_pool: Any,
                           tables: torch.Tensor, offsets, *,
                           window: Optional[int] = None,
                           nsplit: Optional[int] = None) -> torch.Tensor:
    """Attention of ``q`` [B, H, S_in, hd] against each slot's paged
    context.  ``k_pool``/``v_pool``: one layer's pool ``[num_blocks, Hkv,
    bs, hd]``, or its int8 ``(q8, scale [num_blocks, Hkv, bs] f32)``
    pair.  ``tables`` [B, max_blocks] int32; ``offsets`` an int or [B] —
    slot b's rows sit at positions ``offsets[b] + arange(S_in)`` and
    attend keys at ``kpos <= qpos`` (and ``kpos > qpos - window``).
    Returns [B, H, S_in, hd] in ``q.dtype``.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes contiguous tensors (q and the pools 16-byte aligned), hd
    in {64, 128}, blocks of 16 positions, and bf16 or f32 (q and pool
    alike) or an int8 pool.

    ``nsplit``: the decode rows' split count (:func:`check_nsplit`), for
    the tuner; None (the default) keeps :func:`decode_splits`.  On the
    CPU an explicit one runs the split schedule's plain version
    (:func:`paged_decode_split_reference`; float pools)."""
    B, H, S_in, _ = q.shape
    kp = k_pool[0] if isinstance(k_pool, tuple) else k_pool
    check_nsplit(nsplit, (H // kp.shape[1]) * S_in, tables.shape[1])
    if q.device.type == "cpu":
        if nsplit is not None and not isinstance(k_pool, tuple):
            return finalize_paged_carry(
                paged_decode_split_reference(q, k_pool, v_pool, tables,
                                             offsets, nsplit=nsplit,
                                             window=window),
                B, H, S_in, q.shape[-1], q.dtype)
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
    _aligned((q, *pools))
    for t in pools[1:]:
        _check(t.shape == pools[0].shape and t.dtype == pools[0].dtype,
               "k and v pools must match")
    for t in scales:
        _check(t.dtype == torch.float32 and t.shape == (nb, Hkv, bs),
               f"int8 scales must be f32 [{nb}, {Hkv}, {bs}]")
    offs = _offsets_on(offsets, B, q.device)
    _check(offs.shape == (B,), f"offsets must be scalar or [{B}]")
    out = torch.empty_like(q)
    R = (H // Hkv) * S_in
    nsplit, order, ws = _workspace(B, Hkv, R, hd, tables.shape[1],
                                   q.device, nsplit)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(
            q.data_ptr(), pools[0].data_ptr(), pools[1].data_ptr(),
            scales[0].data_ptr() if quantized else None,
            scales[1].data_ptr() if quantized else None,
            tables.data_ptr(), offs.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            B, Hkv, R, S_in, hd, nb, bs, tables.shape[1], nsplit, order,
            Hkv * bs * hd, tables.shape[1],
            -1 if window is None else int(window), 1.0 / math.sqrt(hd), tag,
            stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: CUDA error {err}")
    LAUNCHES["paged_decode_attention"] += 1
    return out


# ------------------------------------------------------------------ K2


def _no_int8(k_pool: Any) -> None:
    if isinstance(k_pool, tuple):
        raise NotImplementedError(
            "paged_carry_attention does not support int8 pools")


def paged_carry_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                                    v_pool: torch.Tensor,
                                    tables_local: torch.Tensor, offsets, *,
                                    carry: Optional[Carry] = None,
                                    window: Optional[int] = None,
                                    sm_scale: Optional[float] = None
                                    ) -> Carry:
    """The plain version of K2: the reference gather arm's arithmetic
    (``ops/ring_paged.py`` ``_gather_slice`` :129, ``_valid_positions``
    :167, ``_partial_update`` :139).  The slice's blocks are gathered
    through ``tables_local`` into a dense per-slot view (another rank's
    entries, outside ``[0, nb)``, gather zeros and are masked), scores
    formed in f32, and one online-softmax update applied to ``carry``
    (default: the empty carry).  A masked key adds exactly 0 to ``l`` and
    ``acc`` — the reference's ``exp(NEG_INF - m)``, which is 0 once the row
    has met a key; a row that has met none keeps ``(0, NEG_INF, 0)``, where
    the reference's interim carry counts its masked keys until the next
    owned key wipes them.  P stays f32 (the kernel rounds it to the pool
    dtype)."""
    _no_int8(k_pool)
    B, H, S_in, hd = q.shape
    nb, Hkv, bs, _ = k_pool.shape
    g = H // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    tab = tables_local.to(q.device).long()
    owned = (tab >= 0) & (tab < nb)
    idx = torch.where(owned, tab, torch.zeros_like(tab))
    W = tab.shape[1] * bs

    def view(pool):
        blocks = pool[idx].float() * owned[:, :, None, None, None]
        return blocks.permute(0, 2, 1, 3, 4).reshape(B, Hkv, W, hd)

    offs = _offsets_on(offsets, B, q.device).long()
    qpos = offs[:, None] + torch.arange(S_in, device=q.device)[None, :]
    kpos = torch.arange(W, device=q.device)
    keep = (owned.repeat_interleave(bs, dim=1)[:, None, :]
            & (kpos[None, None, :] <= qpos[..., None]))
    if window is not None:
        keep = keep & (kpos[None, None, :] > qpos[..., None] - window)
    keep = keep[:, None, None]                          # [B, 1, 1, S, W]
    qg = q.float().reshape(B, Hkv, g, S_in, hd)
    s = torch.matmul(qg, view(k_pool)[:, :, None].transpose(-1, -2))
    s = torch.where(keep, s * sm_scale, NEG_INF)
    R = g * S_in
    if carry is None:
        m = torch.full((B, Hkv, g, S_in, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, g, S_in, 1), device=q.device)
        acc = torch.zeros((B, Hkv, g, S_in, hd), device=q.device)
    else:
        acc, m, l = carry
        acc = acc.reshape(B, Hkv, g, S_in, hd)
        m = m.reshape(B, Hkv, g, S_in, 1)
        l = l.reshape(B, Hkv, g, S_in, 1)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.where(keep, torch.exp(s - m_new), 0.0)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1, keepdim=True)
    acc = acc * corr + torch.matmul(p, view(v_pool)[:, :, None])
    return (acc.reshape(B, Hkv, R, hd), m_new.reshape(B, Hkv, R),
            l.reshape(B, Hkv, R))


def finalize_paged_carry(carry: Carry, B: int, H: int, S_in: int, hd: int,
                         dtype) -> torch.Tensor:
    """Divide the last hop's ``acc`` by ``l`` once and restore the public
    ``[B, H, S_in, hd]`` layout (undo the group-major packing)."""
    acc, _m, l = carry
    return (acc / l[..., None]).reshape(B, H, S_in, hd).to(dtype)


def paged_carry_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables_local: torch.Tensor,
                          offsets, *, carry: Optional[Carry] = None,
                          window: Optional[int] = None,
                          sm_scale: Optional[float] = None,
                          nsplit: Optional[int] = None) -> Carry:
    """One ring hop: accumulate ``q`` [B, H, S_in, hd] (rows at global
    positions ``offsets[b] + arange(S_in)``) against ONE rank's pool slice
    ``[nb, Hkv, bs, hd]`` through ``tables_local`` [B, max_blocks] int32
    (the global tables minus that slice's first block id; entries outside
    ``[0, nb)`` are other ranks' blocks), continuing ``carry`` (the
    previous hop's return; None for the first).  Returns the raw carry
    ``(acc [B, Hkv, R, hd], m [B, Hkv, R], l [B, Hkv, R])`` f32 with
    ``R = (H / Hkv) * S_in`` group-major rows; finish with
    :func:`finalize_paged_carry`.  ``l`` may be 0 mid-ring.

    CPU tensors take the plain version; CUDA tensors launch K2, which
    takes contiguous tensors (q, the pools and the carry 16-byte
    aligned), bf16 or f32 (q and pool alike), hd in {64, 128} and blocks
    of 16 positions.  Int8 pools raise
    NotImplementedError, as in the reference.  ``nsplit``: as for
    :func:`paged_decode_attention` (on the CPU an explicit one runs
    :func:`paged_decode_split_reference` after ``carry``)."""
    _no_int8(k_pool)
    check_nsplit(nsplit, (q.shape[1] // k_pool.shape[1]) * q.shape[2],
                 tables_local.shape[1], "paged_carry_attention")
    if q.device.type == "cpu":
        if nsplit is not None:
            return paged_decode_split_reference(
                q, k_pool, v_pool, tables_local, offsets, nsplit=nsplit,
                carry=carry, window=window, sm_scale=sm_scale)
        return paged_carry_attention_reference(
            q, k_pool, v_pool, tables_local, offsets, carry=carry,
            window=window, sm_scale=sm_scale)
    where = "paged_carry_attention"
    _check(q.device.type == "cuda", f"unsupported device {q.device}", where)
    _check(q.dim() == 4, f"q must be [B, H, S_in, hd], got {tuple(q.shape)}",
           where)
    B, H, S_in, hd = q.shape
    nb, Hkv, bs, pool_hd = k_pool.shape
    tag = {torch.bfloat16: 0, torch.float32: 1}.get(q.dtype)
    _check(tag is not None and k_pool.dtype == q.dtype,
           f"q {q.dtype} with a {k_pool.dtype} pool is not supported", where)
    _check(hd == pool_hd and hd in (64, 128),
           f"head dim must be 64 or 128 and match the pool, got {hd} / "
           f"{pool_hd}", where)
    _check(bs == 16, f"the kernel takes pool blocks of 16 positions, got "
           f"{bs}", where)
    _check(H % Hkv == 0, f"{H} query heads not divisible by {Hkv} kv heads",
           where)
    _check(tables_local.dim() == 2 and tables_local.shape[0] == B
           and tables_local.dtype == torch.int32,
           f"tables must be int32 [{B}, max_blocks]", where)
    _check(v_pool.shape == k_pool.shape and v_pool.dtype == k_pool.dtype,
           "k and v pools must match", where)
    R = (H // Hkv) * S_in
    shapes = ((B, Hkv, R, hd), (B, Hkv, R), (B, Hkv, R))
    for t, shape in zip(carry or (), shapes):
        _check(t.dtype == torch.float32 and tuple(t.shape) == shape,
               f"the carry must be f32 {shapes}", where)
    for t in (q, k_pool, v_pool, tables_local, *(carry or ())):
        _check(t.device == q.device, "all tensors must be on q's device",
               where)
        _check(t.is_contiguous(), "all tensors must be contiguous", where)
    _aligned((q, k_pool, v_pool, *(carry or ())), where)
    offs = _offsets_on(offsets, B, q.device)
    _check(offs.shape == (B,), f"offsets must be scalar or [{B}]", where)
    out = tuple(torch.empty(shape, dtype=torch.float32, device=q.device)
                for shape in shapes)
    cin = carry if carry is not None else (None, None, None)
    nsplit, order, ws = _workspace(B, Hkv, R, hd, tables_local.shape[1],
                                   q.device, nsplit)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel("tdp_paged_carry_attention", _CARRY_ARGTYPES)(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables_local.data_ptr(), offs.data_ptr(),
            *(None if t is None else t.data_ptr() for t in cin),
            *(t.data_ptr() for t in out),
            None if ws is None else ws.data_ptr(),
            B, Hkv, R, S_in, hd, nb, bs, tables_local.shape[1], nsplit,
            order,
            Hkv * bs * hd, tables_local.shape[1],
            -1 if window is None else int(window),
            float(1.0 / math.sqrt(hd) if sm_scale is None else sm_scale),
            tag, stream)
    if err != 0:
        raise RuntimeError(
            f"paged_carry_attention kernel launch failed: CUDA error {err}")
    LAUNCHES["paged_carry_attention"] += 1
    return out


def paged_carry_rounding_scale(q: torch.Tensor,
                               hops: Sequence[Tuple[torch.Tensor,
                                                    torch.Tensor,
                                                    torch.Tensor]],
                               offsets, *, window: Optional[int] = None,
                               sm_scale: Optional[float] = None
                               ) -> torch.Tensor:
    """For each element of the finished output ``[B, H, S_in, hd]``,
    ``sqrt(Σ (p v)²)`` over the keys of every hop, ``p`` the final
    normalised probability: the scale of the error K2 adds by rounding P
    to a bf16 pool's dtype before P·V (each term off by at most 2^-8 of
    itself, in random directions).  ``hops``: each hop's ``(k_pool,
    v_pool, tables_local)`` in order.  Computed by the plain version in
    f32 on ``(2 sm_scale, v²)``, whose ``acc`` is ``Σ exp(2 (s - m)) v²``,
    divided by the plain run's ``l``."""
    B, H, S_in, hd = q.shape
    scale = 1.0 / math.sqrt(hd) if sm_scale is None else sm_scale
    plain = sq = None
    for k_pool, v_pool, tab in hops:
        plain = paged_carry_attention_reference(
            q.float(), k_pool.float(), v_pool.float(), tab, offsets,
            carry=plain, window=window, sm_scale=scale)
        sq = paged_carry_attention_reference(
            q.float(), k_pool.float(), v_pool.float().square(), tab, offsets,
            carry=sq, window=window, sm_scale=2.0 * scale)
    return finalize_paged_carry((sq[0].sqrt(), plain[1], plain[2]), B, H,
                                S_in, hd, torch.float32)


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
