"""Fused MoE expert dispatch: gather token rows through the ``[E, C]``
slot maps, run each expert's FFN and add the gate-weighted result back
per token, with no ``[T, E, C]`` dispatch tensor and no gathered
``[E, C, D]`` slot view in device memory.

Replaces the TPU kernel K6, ``_pallas_moe_ffn``
(``torchdistpackage_tpu/ops/moe_dispatch.py:289``, body ``_kernel`` :202),
with a CUDA kernel written by hand for Hopper, ``ops/csrc/moe_dispatch.cu``
(built by :mod:`._build` at first use), in two variants: float expert
weights, and int8 weight-only experts — the ``(q8, scale)`` pairs of
:func:`quantize_moe_experts`, the TPU kernel's ``quantized`` branch
(``_kernel`` :253-258).

What bounds it on an H100: at decode (a few rows) the bytes of every
expert that was hit — its whole W1 and W2, 352 MB an expert at Mixtral
widths; at a prefill chunk (4096 rows) the operations, ``2 (T k) 3 D F``
for SwiGLU.  K6 has three hand-written bodies, chosen by
:func:`moe_ffn_body` from the capacity and the tokens' type:

- bf16 tokens at decode's few slots (below :data:`MOE_FFN_WGMMA_C_MIN`):
  the swap-AB decode body K7's decode rows run, with the slot-map gather
  fused in.  Only the 16-slot tiles that hold a filled slot are walked
  (its first launch lists them on the device, :func:`chunk_tiles`' rule,
  :func:`decode_tiles`: at C <= 16, the experts that were hit), with no
  host sync and a fixed grid; one CTA an SM streams their weights once
  through up to
  16 TMA stages, pass 1's producer warpgroup gathers the token rows
  through ``idx`` by ``cp.async`` into the layout ``wgmma`` reads, pass
  2 splits the F sum evenly over the CTAs (stream-K) into a partials
  scratch, and a merge launch adds each token's routed choices in
  (expert, slot) order, each choice's runs in run order: no atomics, so
  the output is the same bits from run to run.  Its plan is
  :func:`moe_decode_plan`, and :func:`moe_decode_split_reference` its
  schedule in plain form;
- bf16 tokens at a prefill chunk's capacity: a two-pass grouped GEMM on
  the warpgroup MMA (``wgmma``), the body K7's chunk rows run, with the
  slot-map gather fused in.  Pass 1's producer warpgroup gathers each
  128-slot tile's token rows through ``idx`` with ``cp.async`` into the
  swizzled layout ``wgmma`` reads (empty slots zero-filled; no gathered
  ``[E, C, D]`` view is written), pass 2 keeps the whole F reduction in
  registers and adds ``comb x`` each filled slot's row into the f32
  output once (one add per routed choice: at top-2 the same bits from
  run to run).  Only the tiles :func:`chunk_tiles` lists on the device
  (those holding a filled slot) are walked, with no host sync, so
  serving at the no-drop capacity ``C = T`` pays no ``E / k`` padded
  tax;
- f32 tokens (a check path no engine drives): the walk, a CTA a (64
  slots, 64 columns of F) tile on ``mma.sync``, whose F-tile partial
  sums meet in the f32 output by atomic adds (their order varies from
  run to run).

The int8 variant streams 1-byte weights (half the bytes of bf16: 176 MB
an expert at Mixtral widths) and applies each output column's scale to
the product, not to the weights.

- :func:`slot_maps` compresses a ``_top_k_route`` decision into the
  kernel's maps: ``idx`` (the token in each slot) and ``comb`` (its gate
  weight, 0 for an empty or dropped slot).
- :func:`quantize_moe_experts` makes the int8 expert leaves, and
  :func:`_dequant` turns a leaf back into f32, as the reference does.
- :func:`moe_ffn_slots_reference` is K6's plain version on those maps; it
  does build the ``[E, C, D]`` slot view, and takes int8 leaves through
  :func:`_dequant`.  :func:`moe_ffn_oracle` is the JAX package's oracle
  (maps built from the routing, output in the tokens' dtype).
- :func:`fused_moe_ffn_slots` is the kernel's wrapper: it launches K6 for
  CUDA tensors and raises on anything K6 does not take, and takes the
  plain version only for CPU tensors.  ``LAUNCHES["fused_moe_ffn"]``
  counts the float variant's calls, ``LAUNCHES["fused_moe_ffn_int8"]``
  the int8 variant's, one a call whichever body runs.
  :func:`fused_moe_ffn` is the routing-level entry point the serving
  forward calls.

K7, the expert FFN of expert-parallel layers, replaces
``_pallas_expert_ffn`` (the reference's :479, ``pallas_call`` :506, body
``_ep_kernel`` :418), float and int8: :func:`fused_expert_ffn` runs every
local expert's FFN on every row of the exchanged ``[e_loc, G, D]``
groups (pad rows included, as on the TPU) in the same CUDA source, in
one of three hand-written bodies that :func:`expert_ffn_body` chooses
from the rows' count and type.  bf16 chunk rows (G of at least
:data:`EXPERT_FFN_WGMMA_G_MIN`) take the two-pass grouped GEMM
(``expert_ffn_up_wgmma_kernel`` then ``expert_ffn_down_wgmma_kernel``,
the activation in bf16 device memory between them, the output in x's
dtype with no atomics); bf16 decode rows take the swap-AB decode body
(``expert_ffn_up_decode_kernel``, ``expert_ffn_down_decode_kernel``,
then ``expert_ffn_merge_kernel``: the weight tile is ``wgmma``'s 64-row
A side and the few rows its N side, one CTA an SM streams the weights,
pass 2 split evenly over the CTAs into a partials scratch that the merge
adds in run order, with the scale and b2, into x's dtype: the same bits
from run to run); f32 rows take the K6 walk on the identity slot map
(``expert_ffn_kernel`` / ``expert_ffn_int8_kernel``).  Each counts one
launch a call under ``LAUNCHES["fused_expert_ffn"]`` /
``["fused_expert_ffn_int8"]``.  :func:`expert_ffn_reference` is its
plain version (the reference's ``_ep_ffn_reference``) and
:func:`expert_ffn_rounding_scale` the scale of its bf16 rounding.  It
pays what the reference pays under EP: at the no-drop capacity ``C = T``
every expert computes all its slots, ``E / k`` times K6's work at a
prefill chunk.

The backward the reference gives ``fused_moe_ffn`` and
``fused_expert_ffn`` (``custom_vjp``s through their oracles) belongs to
MoE training, which is not ported yet (ROADMAP queue A): this module is
forward-only, and int8 is forward-only in the reference too.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..obs.numerics import tree_leaves
from .paged_attention import _sm_count

#: kernel launches since the counter was last reset (the wrapper adds one
#: where it launches, and nowhere else)
LAUNCHES: Dict[str, int] = {"fused_moe_ffn": 0, "fused_moe_ffn_int8": 0,
                             "fused_expert_ffn": 0,
                             "fused_expert_ffn_int8": 0}

_DTYPE_TAG = {torch.bfloat16: 0, torch.float32: 1}
TILE = 64  # the kernel's D and F tile: both must be multiples of it
_ARGTYPES = {
    # x, idx, comb, dst, w1, b1, w2, b2, y, T, D, F, E, C, swiglu, dtype,
    # stream
    "tdp_moe_ffn": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    # x, idx, comb, dst, q1, s1, b1, q2, s2, b2, y, T, D, F, E, C, swiglu,
    # dtype, stream
    "tdp_moe_ffn_int8": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    # K7: x, w1, b1, w2, b2, y, E, G, D, F, swiglu, dtype, stream
    "tdp_expert_ffn": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    # x, q1, s1, b1, q2, s2, b2, y, E, G, D, F, swiglu, dtype, stream
    "tdp_expert_ffn_int8": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    # K7's warpgroup body: x, w1, s1, b1, w2, s2, b2, h, y, E, G, D, F,
    # swiglu, quantized, stream
    "tdp_expert_ffn_wgmma": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    # K7's decode body: x, w1, s1, b1, w2, s2, b2, h, part, y, E, G, D, F,
    # swiglu, quantized, rows, grid1, grid2, segs, stream
    "tdp_expert_ffn_decode": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
    + [ctypes.c_void_p],
    # K6's warpgroup body: x, idx, comb, dst, tiles, offs, w1, s1, b1, w2,
    # s2, b2, h, y, T, D, F, E, C, swiglu, quantized, stream
    "tdp_moe_ffn_wgmma": [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    # K6's decode body: x, idx, comb, dst, tiles, offs, w1, s1, b1, w2, s2,
    # b2, h, part, y, T, D, F, E, C, swiglu, quantized, grid1, grid2, segs,
    # stream
    "tdp_moe_ffn_decode": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10
    + [ctypes.c_void_p],
    # the decode body's tile list alone: comb, tiles, offs, E, C, rows,
    # stream
    "tdp_moe_tiles": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
}
#: the fewest rows a group must have for K7 to take its warpgroup body
#: (chunk rows); fewer bf16 rows (decode) take the decode body.  Set from
#: ``chip_smoke.py``'s ``expert_ffn_body_sweep`` (e_loc 8, Mixtral widths):
#: with int8 experts the decode body is faster up to 64 rows, with bf16
#: ones up to 16 and within 2 % at 32
EXPERT_FFN_WGMMA_G_MIN = 64
#: the fewest bf16 rows a group must have for K7's decode body; 1: every
#: bf16 group takes a warpgroup body, and the walk runs f32 rows only (the
#: same sweep: the decode body beats the walk from G 1 up)
EXPERT_FFN_DECODE_G_MIN = 1
#: the fewest capacity slots an expert must have for K6 to take its
#: warpgroup body (a prefill chunk's slot maps); fewer bf16 slots (decode's
#: 8) take the decode body, f32 tokens the walk.  Set from
#: ``chip_smoke.py``'s ``moe_ffn_body_sweep`` at Mixtral widths (C = T,
#: top-2): the decode body is faster up to C 48, float and int8 experts
#: alike, the warpgroup body at 64 with float experts (int8 experts still
#: favour the decode body there; the choice reads neither)
MOE_FFN_WGMMA_C_MIN = 64
#: the fewest capacity slots an expert must have for K6 to take its decode
#: body (bf16 tokens below ``MOE_FFN_WGMMA_C_MIN``); 1: every such call
#: (the same sweep: the decode body beats the walk from C = T = 1 up), and
#: the walk runs f32 tokens only
MOE_FFN_DECODE_C_MIN = 1
#: the slots of one of K6's warpgroup tiles (the unit of its empty-tile
#: skip)
CHUNK_ROWS = 128
#: the slots of one of K6's decode-body tiles: at decode's C <= 16 one
#: tile an expert, so the listed tiles are the experts that were hit
DECODE_ROWS = 16
#: the decode body's weight-column tile (64 columns a consumer warpgroup)
DECODE_COLS = 128


def _kernel(name: str):
    from ._build import load

    fn = getattr(load("moe_dispatch"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def resolve_moe_dispatch(dispatch: Optional[str], device,
                         plain: str = "gather") -> str:
    """``'auto'``/None -> ``'cuda'`` (the kernel) on a CUDA device,
    ``plain`` on the CPU — by the device, where the reference asks the
    backend.  ``plain`` names the plain arm of the caller: ``'gather'``
    (the ragged serving path) or ``'sorted'`` (the capacity path's index
    dispatch, ``moe_forward``).  Explicit values pass through validated;
    the plain arm stays legal on the card as the oracle arm.  The choice
    is recorded as a ``moe_dispatch_selected`` event."""
    if dispatch in (None, "auto"):
        chosen = "cuda" if torch.device(device).type == "cuda" else plain
        from ..obs.events import default_event_log

        default_event_log().emit("moe_dispatch_selected", requested="auto",
                                 chosen=chosen, device=str(device))
        return chosen
    if dispatch not in ("cuda", plain):
        raise ValueError(
            f"moe dispatch must be 'cuda', {plain!r} or 'auto', got "
            f"{dispatch!r}")
    return dispatch


def _is_q(w) -> bool:
    return isinstance(w, tuple)


def _dequant(w) -> torch.Tensor:
    """``(q8, scale)`` -> f32 ``q8 * scale`` (the scale broadcast over the
    contracted dim -2); a float leaf upcast to f32 — the reference's
    oracle numerics."""
    if _is_q(w):
        q, s = w
        return q.float() * s.unsqueeze(-2)
    return w.float()


@torch.no_grad()
def quantize_moe_experts(experts: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Per-expert, per-output-column symmetric int8 for the matmul weights
    (w1 / w2 -> ``(q8, scale)`` pairs; biases stay float), the reference's
    arithmetic in the weights' own dtype: ``s = max|w|`` over the
    contracted dim (-2) / 127, then ``max(s, 1e-8)``, ``q8 = clip(round(w /
    s), -127, 127)`` (``torch.round`` rounds half to even, as
    ``jnp.round``), the scale cast to f32 last."""

    def q(w):
        s = (w.abs().amax(-2) / 127.0).clamp_min(1e-8)
        q8 = torch.round(w / s.unsqueeze(-2)).clamp_(-127, 127).to(
            torch.int8)
        return q8, s.float()

    return {"w1": q(experts["w1"]), "b1": experts["b1"],
            "w2": q(experts["w2"]), "b2": experts["b2"]}


def slot_maps(gate_vals: torch.Tensor, gate_idx: torch.Tensor,
              slot: torch.Tensor, keep: torch.Tensor, capacity: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A ``_top_k_route`` decision -> the kernel's two ``[E, C]`` maps:
    ``idx`` int32 (the token in each slot; 0 where empty — harmless, its
    weight is 0) and ``comb`` f32 (the renormalised gate weight of that
    (token, choice); 0 for empty or dropped slots).  Dropped choices land
    on a dumpster entry that is cut off."""
    T, k = gate_idx.shape
    E = keep.shape[-1]
    dev = gate_idx.device
    kept = keep.sum(-1)  # [T, k]: 1 iff the choice fit capacity
    dest = torch.where(kept > 0, gate_idx.long() * capacity + slot.long(),
                       E * capacity).reshape(-1)
    tok = torch.arange(T, dtype=torch.int32, device=dev)[:, None].expand(
        T, k).reshape(-1)
    idx = torch.zeros(E * capacity + 1, dtype=torch.int32, device=dev)
    idx[dest] = tok
    comb = torch.zeros(E * capacity + 1, dtype=torch.float32, device=dev)
    comb[dest] = (gate_vals * kept).float().reshape(-1)
    return (idx[:E * capacity].reshape(E, capacity),
            comb[:E * capacity].reshape(E, capacity))


def expert_act(xs: torch.Tensor, w1: torch.Tensor,
               b1: torch.Tensor) -> torch.Tensor:
    """The expert's activation h on ``[..., G, D]`` rows: a ``[..., 2, D,
    F]`` w1 (one more dim than the rows) is the stacked gate/up SwiGLU
    expert, ``silu(x w1[0] + b1[0]) * (x w1[1] + b1[1])``; a ``[..., D,
    F]`` one the GELU expert (tanh approximation, ``jax.nn.gelu``'s
    default).  Leading dims batch over experts; the arithmetic is in the
    inputs' dtype."""
    if w1.dim() == xs.dim() + 1:
        g = xs @ w1.select(-3, 0) + b1.select(-2, 0).unsqueeze(-2)
        u = xs @ w1.select(-3, 1) + b1.select(-2, 1).unsqueeze(-2)
        return F.silu(g) * u
    return F.gelu(xs @ w1 + b1.unsqueeze(-2), approximate="tanh")


def ffn_rows(xs: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The expert FFN on ``[..., G, D]`` rows: :func:`expert_act`, then
    ``h w2 + b2``."""
    return expert_act(xs, w1, b1) @ w2 + b2.unsqueeze(-2)


def _expert_weights_f32(experts: Dict[str, Any]):
    return tuple(_dequant(experts[n]) for n in ("w1", "b1", "w2", "b2"))


@torch.no_grad()
def moe_ffn_slots_reference(experts: Dict[str, Any], tokens: torch.Tensor,
                            idx: torch.Tensor, comb: torch.Tensor,
                            scatter_idx: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """K6's plain version on the slot maps: gather the ``[E, C, D]`` slot
    view in f32 (empty slots zeroed), run each expert's FFN on its slots
    (int8 weights ``_dequant``-ed to f32 first), and add ``comb x`` each
    slot's output into f32 ``[T, D]`` at ``scatter_idx`` (default
    ``idx``) — the reference oracle's arithmetic."""
    T, D = tokens.shape
    E, C = idx.shape
    w1, b1, w2, b2 = _expert_weights_f32(experts)
    filled = (comb != 0.0)[..., None]
    view = torch.where(filled, tokens.float()[idx.long()], 0.0)  # [E, C, D]
    out = ffn_rows(view, w1, b1, w2, b2)  # [E, C, D]
    dst = idx if scatter_idx is None else scatter_idx
    y = torch.zeros(T, D, dtype=torch.float32, device=tokens.device)
    y.index_add_(0, dst.reshape(-1).long(),
                 comb.reshape(-1, 1) * out.reshape(E * C, D))
    return y


def moe_ffn_oracle(experts: Dict[str, Any], tokens: torch.Tensor,
                   gate_vals: torch.Tensor, gate_idx: torch.Tensor,
                   slot: torch.Tensor, keep: torch.Tensor, capacity: int
                   ) -> torch.Tensor:
    """The reference's ``moe_ffn_oracle``: slot maps from the routing
    decision, the plain version, output in ``tokens.dtype``."""
    idx, comb = slot_maps(gate_vals, gate_idx, slot, keep, capacity)
    return moe_ffn_slots_reference(experts, tokens, idx, comb).to(
        tokens.dtype)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_moe_ffn: {msg}")


def _quantized(experts: Dict[str, Any], kernel: str) -> bool:
    """Whether the experts are int8 pairs; a mix raises, as neither
    variant of ``kernel`` takes it."""
    quantized = _is_q(experts["w1"])
    if quantized != _is_q(experts["w2"]):
        raise NotImplementedError(
            f"{kernel} takes int8 (q8, scale) pairs for both w1 and w2, or "
            f"float weights for both; not an int8 / float mix")
    return quantized


def _kernel_weights(experts: Dict[str, Any], tokens: torch.Tensor, D: int,
                    quantized: bool):
    """The expert leaves checked against what K6 and K7 take: ``(weights,
    E, F, swiglu, dtype tag)`` with ``weights`` in the C entry's order —
    ``(w1, b1, w2, b2)``, or ``(q1, s1, b1, q2, s2, b2)`` for int8."""
    w1, b1, w2, b2 = (experts[n] for n in ("w1", "b1", "w2", "b2"))
    (w1, s1), (w2, s2) = (w1, w2) if quantized else ((w1, None), (w2, None))
    tag = _DTYPE_TAG.get(tokens.dtype)
    _check(tag is not None, f"tokens must be bf16 or f32, got {tokens.dtype}")
    swiglu = w1.dim() == 4
    _check(w1.dim() in (3, 4), f"w1 must be [E, D, F] or [E, 2, D, F], got "
           f"{tuple(w1.shape)}")
    E, Fd = w1.shape[0], w1.shape[-1]
    wdt = torch.int8 if quantized else tokens.dtype
    want = {  # name: (shape, dtype)
        "w1": ((E, 2, D, Fd) if swiglu else (E, D, Fd), wdt),
        "b1": ((E, 2, Fd) if swiglu else (E, Fd), tokens.dtype),
        "w2": ((E, Fd, D), wdt),
        "b2": ((E, D), tokens.dtype),
    }
    if quantized:
        want["w1 scale"] = ((E, 2, Fd) if swiglu else (E, Fd), torch.float32)
        want["w2 scale"] = ((E, D), torch.float32)
    got = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w1 scale": s1,
           "w2 scale": s2}
    for name, (shape, dt) in want.items():
        t = got[name]
        _check(tuple(t.shape) == shape,
               f"{name} must be {shape}, got {tuple(t.shape)}")
        _check(t.dtype == dt, f"{name} is {t.dtype}, must be {dt} (tokens "
               f"are {tokens.dtype})")
    _check(D % TILE == 0 and Fd % TILE == 0,
           f"D and F must be multiples of {TILE}, got {D} / {Fd}")
    weights = (w1, s1, b1, w2, s2, b2) if quantized else (w1, b1, w2, b2)
    return weights, E, Fd, swiglu, tag


def _launch(entry: str, name: str, args, y: torch.Tensor, *ints) -> None:
    """Launch ``entry`` on ``args`` (checked for device, contiguity and
    alignment; None passes a null pointer) into ``y`` on the current
    stream, and count it under ``name`` — once, however many CUDA launches
    the entry makes."""
    dev = y.device
    for t in args:
        if t is None:
            continue
        _check(t.device == dev, "all tensors must be on the tokens' device")
        _check(t.is_contiguous(), "all tensors must be contiguous")
        _check(t.data_ptr() % 16 == 0, "all tensors must be 16-byte aligned")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel(entry)(*(None if t is None else t.data_ptr()
                               for t in args), y.data_ptr(), *ints, stream)
    if err != 0:
        raise RuntimeError(f"moe_dispatch kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1


def moe_ffn_body(C: int, dtype: torch.dtype) -> str:
    """Which of K6's three bodies a CUDA call with ``C`` capacity slots an
    expert and tokens of ``dtype`` takes, float or int8 experts alike:
    ``'wgmma'``, the two-pass grouped GEMM on the warpgroup MMA with the
    slot-map gather fused in, for bf16 tokens at ``C`` of at least
    :data:`MOE_FFN_WGMMA_C_MIN` (a prefill chunk's maps); ``'decode'``,
    the swap-AB warpgroup body with the gather fused in and a fixed-order
    merge, for fewer bf16 slots down to :data:`MOE_FFN_DECODE_C_MIN`
    (decode, where the weight bytes bound the call); ``'walk'``, the
    ``mma.sync`` walk, otherwise (f32 tokens)."""
    if dtype == torch.bfloat16 and C >= MOE_FFN_WGMMA_C_MIN:
        return "wgmma"
    if dtype == torch.bfloat16 and C >= MOE_FFN_DECODE_C_MIN:
        return "decode"
    return "walk"


def chunk_tiles(comb: torch.Tensor, rows: int = CHUNK_ROWS
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's tile list on the maps' device, with no host sync: the
    ``[E, C]`` slots cut into tiles of ``rows`` per expert (the last one
    ragged), tile ``t`` of expert ``e`` named ``e ceil(C / rows) + t`` ->
    ``(tiles, offs)``: int32 ``[E ceil(C / rows)]`` listing the tiles that
    hold a filled slot (``comb != 0``) first, in order (so by expert),
    then the others; and int32 ``[E + 1]``, how many listed tiles come
    before expert ``e`` (``offs[E]``: all of them).  The kernel walks only
    the listed tiles, expert by expert."""
    E, C = comb.shape
    n = -(-C // rows)
    filled = torch.zeros(E, n * rows, dtype=torch.bool, device=comb.device)
    filled[:, :C] = comb != 0
    busy = filled.reshape(E, n, rows).any(-1)
    tiles = torch.argsort((~busy.reshape(-1)).to(torch.int32), stable=True)
    offs = torch.zeros(E + 1, dtype=torch.int32, device=comb.device)
    offs[1:] = busy.sum(-1).cumsum(0)
    return tiles.to(torch.int32), offs


# ------------------------------------------------ the decode body's plan


class DecodeSegment(NamedTuple):
    """Part of a CTA's run of a decode-body pass: stages ``[kb, ke)`` of
    unit ``u`` — expert ``e``, row tile ``rows`` (K6: of the expert's
    slots), weight-column tile ``cols``, and the position ``pos`` of the
    unit's rows in H (K6: its tile's list position; K7: ``e``)."""
    u: int
    e: int
    rows: int
    cols: int
    pos: int
    kb: int
    ke: int


def decode_rows(G: int) -> int:
    """K7's row tile on the decode body for ``G`` rows an expert: 16 or 32
    up to that many rows, else 64 (more rows in more tiles)."""
    return 16 if G <= 16 else 32 if G <= 32 else 64


def decode_depth(two_weights: bool) -> int:
    """The reduction depth of one decode-body stage: 64 where a stage holds
    two weight tiles (SwiGLU's pass 1, gate and up), 128 where the pass
    streams one weight."""
    return 64 if two_weights else 128


def decode_grid(units1: int, units2: int, nk2: int,
                sms: int) -> Tuple[int, int, int]:
    """``(grid1, grid2, segs)`` of a decode-body call from the most units
    its passes can have (``units1`` of pass 1, ``units2`` of pass 2 with
    ``nk2`` stages each) and the card's SM count: one CTA an SM, fewer
    where there are fewer units (pass 1) or stages (pass 2); ``segs``
    bounds the units one pass-2 run can meet (its slots in the partials'
    scratch ``[grid2, segs, rows, 128]``)."""
    grid1 = max(1, min(units1, sms))
    total = units2 * nk2
    grid2 = max(1, min(total, sms))
    run = -(-total // grid2)
    return grid1, grid2, (run + nk2 - 1) // nk2 + 1


def decode_runs(units: int, nk: int, grid: int,
                whole: bool) -> List[List[Tuple[int, int, int]]]:
    """Each CTA's run of a decode-body pass over ``units`` units of ``nk``
    stages, as ``(unit, kb, ke)`` pieces in run order: pass 1 (``whole``)
    gives CTA ``b`` units ``[units b // grid, units (b + 1) // grid)``;
    pass 2 stages ``[units nk b // grid, units nk (b + 1) // grid)``, cut
    where a unit ends.  A run's j-th piece is its unit ``beg // nk + j``."""
    out = []
    for b in range(grid):
        if whole:
            beg, end = units * b // grid * nk, units * (b + 1) // grid * nk
        else:
            beg, end = units * nk * b // grid, units * nk * (b + 1) // grid
        run, pos = [], beg
        while pos < end:
            u, kb = divmod(pos, nk)
            ke = min(nk, kb + end - pos)
            run.append((u, kb, ke))
            pos += ke - kb
        out.append(run)
    return out


def merge_runs(u: int, nk: int, total: int, grid: int
               ) -> List[Tuple[int, int]]:
    """The merge's order for pass-2 unit ``u`` (of ``total`` stages over
    ``grid`` CTAs): ``(cta, slot)`` of each run that meets the unit, in run
    order, by the kernel's closed form — from the last CTA whose run
    starts at or before the unit's first stage to the one holding its
    last, empty runs skipped; ``slot`` is the unit's place in that run."""
    s0 = u * nk
    out = []
    for b in range(((s0 + 1) * grid - 1) // total,
                   ((s0 + nk) * grid - 1) // total + 1):
        beg = total * b // grid
        if beg < total * (b + 1) // grid:
            out.append((b, u - beg // nk))
    return out


def _slot_unit(u: int, mt: int, tiles, offs, ntc: int):
    """K6's unit ``u`` -> ``(e, row tile, column tile, list position)``:
    the list's run for expert ``e`` holds its ``ne`` tiles from position
    ``offs[e]``; its units take the row tile fastest, then the column
    tile."""
    e = tiles[u // mt] // ntc
    o, ne = offs[e], offs[e + 1] - offs[e]
    j = u - o * mt
    pos = o + j % ne
    return e, tiles[pos] - e * ntc, j // ne, pos


def moe_decode_plan(comb: torch.Tensor, D: int, F_: int, swiglu: bool,
                    sms: int) -> Dict[str, Any]:
    """K6's decode-body plan on ``comb`` ``[E, C]`` (the kernels compute
    the same on the device from :func:`chunk_tiles` at
    :data:`DECODE_ROWS`): the grids and scratch slots from the list's
    longest length (:func:`decode_grid`), and each CTA's run of pass 1
    (whole units of 16 slots x 128 F columns over D) and pass 2 (16 slots
    x 128 D columns over F, cut evenly) as :class:`DecodeSegment` lists."""
    E, C = comb.shape
    tiles, offs = (t.tolist() for t in chunk_tiles(comb.cpu(), DECODE_ROWS))
    ntc = -(-C // DECODE_ROWS)
    mt1, mt2 = -(-F_ // DECODE_COLS), -(-D // DECODE_COLS)
    nk1 = -(-D // decode_depth(swiglu))
    nk2 = -(-F_ // decode_depth(False))
    grid1, grid2, segs = decode_grid(E * ntc * mt1, E * ntc * mt2, nk2, sms)
    n = offs[E]

    def pieces(mt, nk, grid, whole):
        return [[DecodeSegment(u, *_slot_unit(u, mt, tiles, offs, ntc), kb,
                               ke) for u, kb, ke in run]
                for run in decode_runs(n * mt, nk, grid, whole)]

    return {"tiles": tiles, "offs": offs, "grid": (grid1, grid2),
            "segs": segs, "nk": (nk1, nk2), "mt": (mt1, mt2),
            "up": pieces(mt1, nk1, grid1, True),
            "down": pieces(mt2, nk2, grid2, False)}


def expert_decode_plan(E: int, G: int, D: int, F_: int, swiglu: bool,
                       sms: int) -> Dict[str, Any]:
    """K7's decode-body plan on ``[E, G, D]`` rows: row tile
    (:func:`decode_rows`), grids and scratch slots, and each CTA's run of
    both passes as :class:`DecodeSegment` lists (units: row tile fastest,
    then the column tile, then the expert)."""
    nr = decode_rows(G)
    gt = -(-G // nr)
    mt1, mt2 = -(-F_ // DECODE_COLS), -(-D // DECODE_COLS)
    nk1 = -(-D // decode_depth(swiglu))
    nk2 = -(-F_ // decode_depth(False))
    grid1, grid2, segs = decode_grid(E * gt * mt1, E * gt * mt2, nk2, sms)

    def pieces(mt, nk, grid, whole):
        return [[DecodeSegment(u, u // (gt * mt), u % gt, u // gt % mt,
                               u // (gt * mt), kb, ke)
                 for u, kb, ke in run]
                for run in decode_runs(E * gt * mt, nk, grid, whole)]

    return {"rows": nr, "grid": (grid1, grid2), "segs": segs,
            "nk": (nk1, nk2), "mt": (mt1, mt2),
            "up": pieces(mt1, nk1, grid1, True),
            "down": pieces(mt2, nk2, grid2, False)}


@torch.no_grad()
def moe_decode_split_reference(experts: Dict[str, Any],
                               tokens: torch.Tensor, idx: torch.Tensor,
                               comb: torch.Tensor,
                               scatter_idx: Optional[torch.Tensor] = None,
                               sms: int = 132) -> torch.Tensor:
    """The plain version of K6's decode-body schedule, in f32 on the
    ``_dequant``-ed weights: pass 1's H of each listed 16-slot tile (the
    gathered rows, an empty slot's zeroed), each pass-2 run's partial sum
    over its F stages under :func:`moe_decode_plan`, and the merge in the
    kernel's order — token by token its routed choices in (expert, slot)
    order, each the sum of its unit's runs in run order
    (:func:`merge_runs`) plus b2, scaled by its gate weight.  Returns f32
    ``[T, D]``."""
    T, D = tokens.shape
    E, C = idx.shape
    w1, b1, w2, b2 = _expert_weights_f32(experts)
    F_ = w2.shape[1]
    plan = moe_decode_plan(comb, D, F_, w1.dim() == 4, sms)
    tiles, offs = plan["tiles"], plan["offs"]
    (_, grid2), (_, nk2), (_, mt2) = plan["grid"], plan["nk"], plan["mt"]
    R, M, K2 = DECODE_ROWS, DECODE_COLS, decode_depth(False)
    ntc = -(-C // R)
    dst = (idx if scatter_idx is None else scatter_idx).tolist()
    filled = (comb != 0).tolist()
    idx_l, comb_l = idx.tolist(), comb.tolist()
    x = tokens.float()
    h = []
    for i in range(offs[E]):
        e, t = divmod(tiles[i], ntc)
        rows = torch.zeros(R, D, dtype=torch.float32, device=x.device)
        for r in range(R):
            c = t * R + r
            if c < C and filled[e][c]:
                rows[r] = x[idx_l[e][c]]
        h.append(expert_act(rows, w1[e], b1[e]))
    part = {}
    for b, run in enumerate(plan["down"]):
        for j, s in enumerate(run):
            f = slice(s.kb * K2, min(s.ke * K2, F_))
            d = slice(s.cols * M, min((s.cols + 1) * M, D))
            part[b, j] = h[s.pos][:, f] @ w2[s.e][f, d]
    total = offs[E] * mt2 * nk2
    y = torch.zeros(T, D, dtype=torch.float32, device=x.device)
    for tok in range(T):
        for e in range(E):
            o, ne = offs[e], offs[e + 1] - offs[e]
            i, busy = o, False
            for c in range(C):
                if c % R == 0 and busy:
                    i, busy = i + 1, False
                if not filled[e][c]:
                    continue
                busy = True
                if dst[e][c] != tok:
                    continue
                for ct in range(mt2):
                    d = slice(ct * M, min((ct + 1) * M, D))
                    v = torch.zeros(d.stop - d.start, dtype=torch.float32,
                                    device=x.device)
                    for b, j in merge_runs(o * mt2 + ct * ne + (i - o), nk2,
                                           total, grid2):
                        v = v + part[b, j][c % R]
                    y[tok, d] += comb_l[e][c] * (v + b2[e, d])
    return y


def decode_tiles(comb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode body's tile list, :func:`chunk_tiles` at
    :data:`DECODE_ROWS` slots a tile: on CUDA by the kernel the decode
    body launches first (one launch, no host sync), on the CPU by
    :func:`chunk_tiles` itself."""
    if comb.device.type == "cpu":
        return chunk_tiles(comb, DECODE_ROWS)
    _check(comb.dtype == torch.float32 and comb.dim() == 2
           and comb.is_contiguous(), "comb must be contiguous f32 [E, C]")
    E, C = comb.shape
    tiles = torch.empty(E * -(-C // DECODE_ROWS), dtype=torch.int32,
                        device=comb.device)
    offs = torch.empty(E + 1, dtype=torch.int32, device=comb.device)
    with torch.cuda.device(comb.device):
        err = _kernel("tdp_moe_tiles")(
            comb.data_ptr(), tiles.data_ptr(), offs.data_ptr(), E, C,
            DECODE_ROWS, torch.cuda.current_stream(comb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_dispatch kernel launch failed: CUDA error "
                           f"{err}")
    return tiles, offs


def _named_weights(weights, quantized: bool):
    """``_kernel_weights``' tuple as ``(w1, s1, b1, w2, s2, b2)``, the
    scales None for float weights: the warpgroup bodies' argument order."""
    if quantized:
        return weights
    w1, b1, w2, b2 = weights
    return w1, None, b1, w2, None, b2


def fused_moe_ffn_slots(experts: Dict[str, Any], tokens: torch.Tensor,
                        idx: torch.Tensor, comb: torch.Tensor,
                        scatter_idx: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """K6 on the slot maps: tokens ``[T, D]``, ``idx`` int32 / ``comb``
    f32 ``[E, C]`` -> f32 ``[T, D]``.  ``scatter_idx`` (default ``idx``)
    names the token each slot's result is added to.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes contiguous bf16 or f32 tokens, D and F multiples of 64,
    biases of the tokens' dtype and either float w1 / w2 of that dtype
    (the float variant) or int8 ``(q8, scale)`` pairs of
    :func:`quantize_moe_experts` for both (the int8 variant: q8 int8 of
    the float layout, f32 scales ``[E, 2, F]`` / ``[E, F]`` for w1 and
    ``[E, D]`` for w2).  One int8 and one float weight raise
    ``NotImplementedError``, as neither variant takes the mix.
    :func:`moe_ffn_body` picks the body.  Both warpgroup bodies list the
    non-empty slot tiles on the device with no host sync (the chunk body
    by :func:`chunk_tiles`, the decode body in its first launch, the same
    rule) and allocate the activation between their passes: the chunk body
    bf16 ``[E ceil(C / 128), 128, F]`` (0.94 GB at ``E`` 8, ``C`` 4096, F
    14336), the decode body bf16 ``[E ceil(C / 16), 16, F]`` (3.7 MB at
    decode's ``C`` 8) and f32 pass-2 partials ``[grid2, segs, 16, 128]``
    sized from the grid (:func:`decode_grid`; 3.2 MB on 132 SMs).  The
    decode body writes every element of the output in a fixed order, so
    its result is the same bits from run to run; the walk's (f32 tokens)
    is not."""
    quantized = _quantized(experts, "K6")
    if tokens.device.type == "cpu":
        _check(all(t.device.type == "cpu"
                   for t in (idx, comb, *tree_leaves(experts))),
               "all tensors must be on the tokens' device")
        return moe_ffn_slots_reference(experts, tokens, idx, comb,
                                       scatter_idx)
    _check(tokens.device.type == "cuda", f"unsupported device {tokens.device}")
    dst = idx if scatter_idx is None else scatter_idx
    _check(tokens.dim() == 2, f"tokens must be [T, D], got "
           f"{tuple(tokens.shape)}")
    T, D = tokens.shape
    weights, E, Fd, swiglu, tag = _kernel_weights(experts, tokens, D,
                                                  quantized)
    _check(idx.dim() == 2 and idx.shape[0] == E and idx.dtype == torch.int32,
           f"idx must be int32 [{E}, C]")
    C = idx.shape[1]
    _check(comb.shape == idx.shape and comb.dtype == torch.float32,
           f"comb must be f32 [{E}, {C}]")
    _check(dst.shape == idx.shape and dst.dtype == torch.int32,
           f"scatter_idx must be int32 [{E}, {C}]")
    name, entry = (("fused_moe_ffn_int8", "tdp_moe_ffn_int8") if quantized
                   else ("fused_moe_ffn", "tdp_moe_ffn"))
    dev = tokens.device
    body = moe_ffn_body(C, tokens.dtype)
    if body == "decode":
        # the first launch lists the tiles (chunk_tiles' rule); every
        # element of y is written by the merge, in a fixed order
        n_max = E * -(-C // DECODE_ROWS)
        tiles = torch.empty(n_max, dtype=torch.int32, device=dev)
        offs = torch.empty(E + 1, dtype=torch.int32, device=dev)
        grid1, grid2, segs = decode_grid(
            n_max * -(-Fd // DECODE_COLS), n_max * -(-D // DECODE_COLS),
            -(-Fd // decode_depth(False)), _sm_count(dev))
        h = torch.empty(n_max, DECODE_ROWS, Fd, dtype=tokens.dtype,
                        device=dev)
        part = torch.empty(grid2 * segs * DECODE_ROWS * DECODE_COLS,
                           dtype=torch.float32, device=dev)
        y = torch.empty(T, D, dtype=torch.float32, device=dev)
        _launch("tdp_moe_ffn_decode", name,
                (tokens, idx, comb, dst, tiles, offs)
                + _named_weights(weights, quantized) + (h, part), y, T, D,
                Fd, E, C, int(swiglu), int(quantized), grid1, grid2, segs)
        return y
    y = torch.zeros(T, D, dtype=torch.float32, device=dev)
    if body == "wgmma":
        tiles, offs = chunk_tiles(comb)
        h = torch.empty(tiles.numel(), CHUNK_ROWS, Fd, dtype=tokens.dtype,
                        device=dev)
        _launch("tdp_moe_ffn_wgmma", name,
                (tokens, idx, comb, dst, tiles, offs)
                + _named_weights(weights, quantized) + (h,), y, T, D, Fd, E,
                C, int(swiglu), int(quantized))
        return y
    _launch(entry, name, (tokens, idx, comb, dst) + weights, y, T, D, Fd, E,
            C, int(swiglu), tag)
    return y


def fused_moe_ffn(experts: Dict[str, Any], tokens: torch.Tensor,
                  gate_vals: torch.Tensor, gate_idx: torch.Tensor,
                  slot: torch.Tensor, keep: torch.Tensor, capacity: int
                  ) -> torch.Tensor:
    """Fused gather -> expert FFN -> weighted scatter-add over a
    ``_top_k_route`` decision: tokens ``[T, D]`` -> ``[T, D]`` in
    ``tokens.dtype`` (K6 on the card, the plain version on the CPU)."""
    idx, comb = slot_maps(gate_vals, gate_idx, slot, keep, capacity)
    return fused_moe_ffn_slots(experts, tokens, idx, comb).to(tokens.dtype)


# ------------------------------------------- K7: the EP expert FFN


@torch.no_grad()
def expert_ffn_reference(experts: Dict[str, Any],
                         x: torch.Tensor) -> torch.Tensor:
    """K7's plain version, the reference's ``_ep_ffn_reference`` (:449)
    before its cast: :func:`ffn_rows` per local expert on ``x [e_loc, G,
    D]`` in f32 on the ``_dequant``-ed weights -> f32 ``[e_loc, G, D]``,
    every row computed."""
    return ffn_rows(x.float(), *_expert_weights_f32(experts))


def expert_ffn_body(G: int, dtype: torch.dtype) -> str:
    """Which of K7's three bodies a CUDA call on ``[e_loc, G, D]`` rows of
    ``dtype`` takes: ``'wgmma'``, the two-pass grouped GEMM on the
    warpgroup MMA, for bf16 rows of at least
    :data:`EXPERT_FFN_WGMMA_G_MIN` (a prefill chunk's groups);
    ``'decode'``, the swap-AB warpgroup body, for fewer bf16 rows (down to
    :data:`EXPERT_FFN_DECODE_G_MIN`: decode, where the weight bytes bound
    the call); ``'walk'``, the K6 body on the identity slot map, for f32
    rows."""
    if dtype == torch.bfloat16 and G >= EXPERT_FFN_WGMMA_G_MIN:
        return "wgmma"
    if dtype == torch.bfloat16 and G >= EXPERT_FFN_DECODE_G_MIN:
        return "decode"
    return "walk"


def fused_expert_ffn(experts: Dict[str, Any],
                     x: torch.Tensor) -> torch.Tensor:
    """K7, the expert FFN of an expert-parallel layer on the exchanged
    groups: ``x [e_loc, G, D]`` -> ``[e_loc, G, D]`` in ``x.dtype``, every
    row computed (a pad row gives ``act(b1) W2 + b2``, which the combine
    discards) — ``moe_forward``'s FFN under ``dispatch='cuda'`` with an
    EP group, the reference's ``fused_expert_ffn`` (:518).

    CPU tensors take the plain version (cast to ``x.dtype``); CUDA tensors
    launch the kernel, float or int8 ``(q8, scale)`` experts, with what K6
    takes: contiguous bf16 or f32 rows, D and F multiples of 64, biases of
    the rows' dtype.  :func:`expert_ffn_body` picks the body; both
    warpgroup bodies allocate the ``[e_loc, G, F]`` activation between
    their passes (0.94 GB at ``[8, 4096, 4096]``, F 14336; 1.8 MB at
    decode's ``[8, 8, 4096]``), the decode body also its f32 pass-2
    partials, sized from the grid (:func:`decode_grid`), which a merge
    launch adds in a fixed order: its output is the same bits from run
    to run.  Forward only, as K6."""
    quantized = _quantized(experts, "K7")
    if x.device.type == "cpu":
        _check(all(t.device.type == "cpu" for t in tree_leaves(experts)),
               "all tensors must be on the tokens' device")
        return expert_ffn_reference(experts, x).to(x.dtype)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    _check(x.dim() == 3, f"x must be [e_loc, G, D], got {tuple(x.shape)}")
    E, G, D = x.shape
    weights, e_w, Fd, swiglu, tag = _kernel_weights(experts, x, D, quantized)
    _check(e_w == E, f"x holds {E} experts' rows, the weights {e_w} experts")
    name = "fused_expert_ffn_int8" if quantized else "fused_expert_ffn"
    body = expert_ffn_body(G, x.dtype)
    if body != "walk":
        # the activation between the passes; both bodies write every
        # element of y in x's dtype
        h = torch.empty(E, G, Fd, dtype=x.dtype, device=x.device)
        y = torch.empty_like(x)
        named = _named_weights(weights, quantized)
        if body == "wgmma":
            _launch("tdp_expert_ffn_wgmma", name, (x,) + named + (h,), y, E,
                    G, D, Fd, int(swiglu), int(quantized))
            return y
        nr = decode_rows(G)
        units = E * -(-G // nr)
        grid1, grid2, segs = decode_grid(
            units * -(-Fd // DECODE_COLS), units * -(-D // DECODE_COLS),
            -(-Fd // decode_depth(False)), _sm_count(x.device))
        part = torch.empty(grid2 * segs * nr * DECODE_COLS,
                           dtype=torch.float32, device=x.device)
        _launch("tdp_expert_ffn_decode", name, (x,) + named + (h, part), y,
                E, G, D, Fd, int(swiglu), int(quantized), nr, grid1, grid2,
                segs)
        return y
    entry = "tdp_expert_ffn_int8" if quantized else "tdp_expert_ffn"
    y = torch.zeros(E, G, D, dtype=torch.float32, device=x.device)
    _launch(entry, name, (x,) + weights, y, E, G, D, Fd, int(swiglu), tag)
    return y.to(x.dtype)


@torch.no_grad()
def expert_ffn_rounding_scale(experts: Dict[str, Any],
                              x: torch.Tensor) -> torch.Tensor:
    """K7's counterpart of :func:`moe_rounding_scale`: per output element
    of ``x [e_loc, G, D]``, ``sqrt(sum_f (h_f W2[f, d])^2)`` in f32 — the
    scale of the error that rounding the activation to bf16 before the
    second product puts into it.  One expert at a time."""
    w1, b1, w2, _ = _expert_weights_f32(experts)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for e in range(x.shape[0]):
        h = expert_act(x[e].float(), w1[e], b1[e])
        out[e] = ((h * h) @ (w2[e] * w2[e])).sqrt()
    return out


@torch.no_grad()
def moe_rounding_scale(experts: Dict[str, Any], tokens: torch.Tensor,
                       idx: torch.Tensor, comb: torch.Tensor) -> torch.Tensor:
    """Per output element, ``sqrt(sum over its slots of g^2 sum_f (h_f
    W2[f, d])^2)`` in f32 ``[T, D]``: the scale of the error that rounding
    the activation h to bf16 before the second product (as the kernel
    does) puts into each output, each term moving by up to 2^-8 of itself
    in random directions; int8 weights enter ``_dequant``-ed.  One expert
    at a time, so the ``[C, F]`` activations of a long prefill stay
    within memory."""
    T, D = tokens.shape
    w1, b1, w2, b2 = _expert_weights_f32(experts)
    out = torch.zeros(T, D, dtype=torch.float32, device=tokens.device)
    for e in range(idx.shape[0]):
        filled = comb[e] != 0.0
        if not bool(filled.any()):
            continue
        h = expert_act(tokens.float()[idx[e][filled].long()], w1[e], b1[e])
        sq = (h * h) @ (w2[e] * w2[e])
        out.index_add_(0, idx[e][filled].long(),
                       comb[e][filled, None] ** 2 * sq)
    return out.sqrt()

