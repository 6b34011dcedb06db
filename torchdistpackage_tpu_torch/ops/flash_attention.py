"""Flash attention, forward and backward: causal / sliding-window / GQA
attention that never forms the [S, S] score matrix in device memory.

Replaces three TPU kernels of ``torchdistpackage_tpu/ops/flash_attention.py``
with CUDA kernels written by hand for Hopper, ``ops/csrc/flash_attention.cu``
(built by :mod:`._build` at first use):

- K3, the forward ``_fwd`` (:220, body ``_fwd_kernel`` :174) ->
  :func:`flash_fwd`, returning ``o`` and the f32 logsumexp;
- K4, the dq backward (``_bwd`` :353, body ``_bwd_dq_kernel`` :262) ->
  :func:`flash_bwd_dq`;
- K5, the dk/dv backward (``_bwd`` :353, body ``_bwd_dkv_kernel`` :301) ->
  :func:`flash_bwd_dkv`, which also sums the G query heads of a GQA group
  inside the kernel, so no ``[B*Hq, S, hd]`` f32 partials are written.

What bounds them on an H100 at training shapes: operations.  A causal
forward at B 16, H 12, S 2048, hd 64 does ~1.03e11 FLOP against ~50 MB
of q, k, v, o — ~2000 operations a byte, far above the ~295 where the
tensor cores and not memory set the pace.  So every product runs on the
tensor cores and the tile loop is cut at the causal and window bounds.
bf16 K3, K4 and K5 run on Hopper's warpgroup MMA (``wgmma``, two 64-row
warpgroups a CTA) on tiles that TMA loads into shared memory (shared
pieces in ``ops/csrc/hopper.cuh``; the TMA descriptors are encoded on the
host for each call); the f32 instantiations run exact f32 on the CUDA
cores, one warp per 16 rows, with a ``cp.async`` double buffer.  The
source's header says what each design does and what is left.

Each wrapper launches its kernel for CUDA tensors and raises on anything
it does not take (head dim 64 or 128, sequence lengths a multiple of 64,
contiguous bf16 or f32); it computes its plain version
(``flash_fwd_reference``, ``flash_bwd_dq_reference``,
``flash_bwd_dkv_reference``) only for tensors on the CPU.  ``LAUNCHES``
counts kernel launches, so a run can show that its path went through the
kernels.

:func:`flash_attention` / :func:`flash_attention_with_lse` are the
differentiable entry points (the reference's ``_flash`` custom VJP
becomes one ``torch.autograd.Function``); :func:`mha_reference` is the
plain dense attention the ``'naive'`` path runs.

Two deliberate differences from the reference: the port's plain versions
form the scores in f32 (as the kernel does; ``mha_reference`` there
forms them with a bf16 einsum), and ``causal`` with ``Sq != Sk`` raises,
because the reference's oracle aligns the causal mask bottom-right and
its kernel top-left.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import math
from typing import Dict, List, Optional, Tuple

import torch

NEG_INF = -1e30  # finite "minus infinity": no (-inf) - (-inf) NaN
TILE = 64        # the kernels' row tile: sequence lengths are multiples

#: kernel launches since the counters were last reset (each wrapper adds
#: one where it launches its kernel, and nowhere else)
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0}

_DTYPE_TAG = {torch.bfloat16: 0, torch.float32: 1}
_SHAPE_ARGS = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_void_p]
# B, H, Hkv, Sq, Sk, hd, causal, window, sm_scale, dtype tag, stream
_ARGTYPES = {
    "tdp_flash_fwd": [ctypes.c_void_p] * 5 + _SHAPE_ARGS,
    "tdp_flash_bwd_dq": [ctypes.c_void_p] * 7 + _SHAPE_ARGS,
    "tdp_flash_bwd_dkv": [ctypes.c_void_p] * 8 + _SHAPE_ARGS,
}


def _kernel(name: str):
    from ._build import load

    fn = getattr(load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


# ------------------------------------------------------------ arguments


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def prep_args(q: torch.Tensor, k: torch.Tensor, sm_scale: Optional[float],
              causal: bool, window: Optional[int]
              ) -> Tuple[int, float, Optional[int]]:
    """The reference's ``_prep`` argument handling: the GQA group count,
    the default ``sm_scale`` (1/sqrt(hd)) and the window checks.  Returns
    ``(groups, sm_scale, window)``.  The TPU tile tuning (``_tiles_for``,
    ``default_tiles``) has no counterpart: the kernels pick their own."""
    _check(q.dim() == 4 and k.dim() == 4,
           f"q and k must be [B, H, S, hd], got {tuple(q.shape)} / "
           f"{tuple(k.shape)}")
    H, Hkv = q.shape[1], k.shape[1]
    groups, rem = divmod(H, Hkv)
    if rem:
        raise ValueError(
            f"GQA needs q heads divisible by kv heads, got {H} vs {Hkv}")
    if window is not None and not causal:
        raise ValueError("sliding window requires causal attention")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if causal and q.shape[2] != k.shape[2]:
        # the reference's oracle aligns the mask bottom-right, its kernel
        # top-left; only Sq == Sk reaches the kernel there
        raise ValueError(
            f"causal attention needs Sq == Sk, got {q.shape[2]} vs "
            f"{k.shape[2]}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return groups, float(sm_scale), None if window is None else int(window)


def _mask(Sq: int, Sk: int, causal: bool, window: Optional[int], device):
    """Keep-mask [Sq, Sk] (key in ``(qpos - window, qpos]``), or None."""
    if not causal:
        return None
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    keep = kpos <= qpos
    if window is not None:
        keep = keep & (kpos > qpos - window)
    return keep


# -------------------------------------------------------- plain versions


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, sm_scale: Optional[float] = None,
                  window: Optional[int] = None) -> torch.Tensor:
    """Plain softmax(QKᵀ)V, [B, H, S, hd], differentiable through plain
    ops — the ``'naive'`` attention.  GQA: ``k``/``v`` may carry fewer
    heads; each group of ``H // Hkv`` consecutive query heads shares one.
    Scores in f32; the probabilities enter P·V in ``v``'s dtype, as in
    the reference."""
    groups, sm_scale, window = prep_args(q, k, sm_scale, causal, window)
    if groups > 1:
        k = k.repeat_interleave(groups, dim=1)
        v = v.repeat_interleave(groups, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    keep = _mask(q.shape[2], k.shape[2], causal, window, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def _per_kv_head(q, k, groups):
    """(kv head, its q-head slice) pairs: the plain versions work one KV
    head's group at a time, so the [B, G, Sq, Sk] f32 scores of a long
    sequence stay within memory."""
    for h in range(k.shape[1]):
        yield h, slice(h * groups, (h + 1) * groups)


def _probs(qg, kh, lse_g, sm_scale, keep):
    """p = exp(s - lse) of one group, in f32 ([B, G, Sq, Sk])."""
    s = torch.matmul(qg.float(), kh.float().transpose(-1, -2)) * sm_scale
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    return torch.exp(s - lse_g[..., None])


@torch.no_grad()
def flash_fwd_reference(q, k, v, sm_scale: float, causal: bool,
                        window: Optional[int]):
    """K3's plain version: ``(o [B, H, Sq, hd] in q's dtype, lse [B, H, Sq]
    f32)``, the probabilities rounded to ``v``'s dtype before P·V as the
    kernel does."""
    groups = q.shape[1] // k.shape[1]
    keep = _mask(q.shape[2], k.shape[2], causal, window, q.device)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    for h, sl in _per_kv_head(q, k, groups):
        s = torch.matmul(q[:, sl].float(),
                         k[:, h:h + 1].float().transpose(-1, -2)) * sm_scale
        if keep is not None:
            s = s.masked_fill(~keep, NEG_INF)
        lse[:, sl] = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[:, sl, :, None]).to(v.dtype).float()
        o[:, sl] = torch.matmul(p, v[:, h:h + 1].float()).to(q.dtype)
    return o, lse


@torch.no_grad()
def flash_bwd_dq_reference(q, k, v, do, lse, delta, sm_scale: float,
                           causal: bool, window: Optional[int]):
    """K4's plain version: ``dq = sm_scale * (p * (dO·Vᵀ - delta)) · K``
    with p recomputed from ``lse``; dS rounded to ``k``'s dtype before
    the product, as the kernel does."""
    groups = q.shape[1] // k.shape[1]
    keep = _mask(q.shape[2], k.shape[2], causal, window, q.device)
    dq = torch.empty_like(q)
    for h, sl in _per_kv_head(q, k, groups):
        p = _probs(q[:, sl], k[:, h:h + 1], lse[:, sl], sm_scale, keep)
        dp = torch.matmul(do[:, sl].float(),
                          v[:, h:h + 1].float().transpose(-1, -2))
        ds = (p * (dp - delta[:, sl, :, None])).to(k.dtype).float()
        dq[:, sl] = (torch.matmul(ds, k[:, h:h + 1].float())
                     * sm_scale).to(q.dtype)
    return dq


@torch.no_grad()
def flash_bwd_dkv_reference(q, k, v, do, lse, delta, sm_scale: float,
                            causal: bool, window: Optional[int]):
    """K5's plain version: ``dv = Σ_q pᵀ·dO`` and ``dk = sm_scale · Σ_q
    dSᵀ·Q``, summed over the G query heads of each KV head; P and dS
    rounded to the inputs' dtype before the products, as the kernel
    does.  Returns ``(dk, dv)`` in the kv heads' own shape."""
    groups = q.shape[1] // k.shape[1]
    keep = _mask(q.shape[2], k.shape[2], causal, window, q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for h, sl in _per_kv_head(q, k, groups):
        p = _probs(q[:, sl], k[:, h:h + 1], lse[:, sl], sm_scale, keep)
        dog = do[:, sl].float()
        pt = p.to(do.dtype).float().transpose(-1, -2)
        dv[:, h] = torch.matmul(pt, dog).sum(1).to(v.dtype)
        dp = torch.matmul(dog, v[:, h:h + 1].float().transpose(-1, -2))
        ds = (p * (dp - delta[:, sl, :, None])).to(q.dtype).float()
        dk[:, h] = (torch.matmul(ds.transpose(-1, -2), q[:, sl].float())
                    .sum(1) * sm_scale).to(k.dtype)
    return dk, dv


@torch.no_grad()
def grad_rounding_scale(q, k, v, do, lse, delta, sm_scale: float,
                        causal: bool, window: Optional[int]):
    """For each gradient element, ``sqrt(Σ (x·y)²)`` over the terms of its
    product, with x the probability (dv) or dS (dq, dk) and y the other
    operand: the scale of the error that rounding x to bf16 before the
    product adds (each term off by at most 2^-8 of itself, in random
    directions).  The card checks hold bf16 grads to a few of these.
    Returns ``(sq, sk, sv)`` in the grads' shapes, f32."""
    groups = q.shape[1] // k.shape[1]
    keep = _mask(q.shape[2], k.shape[2], causal, window, q.device)
    sq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    sk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    sv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    for h, sl in _per_kv_head(q, k, groups):
        p = _probs(q[:, sl], k[:, h:h + 1], lse[:, sl], sm_scale, keep)
        dp = torch.matmul(do[:, sl].float(),
                          v[:, h:h + 1].float().transpose(-1, -2))
        ds2 = (p * (dp - delta[:, sl, :, None])).square()
        sq[:, sl] = torch.matmul(ds2, k[:, h:h + 1].float().square()).sqrt()
        sk[:, h] = torch.matmul(ds2.transpose(-1, -2),
                                q[:, sl].float().square()).sum(1).sqrt()
        sv[:, h] = torch.matmul(p.square().transpose(-1, -2),
                                do[:, sl].float().square()).sum(1).sqrt()
    return sq * sm_scale, sk * sm_scale, sv


def flash_delta(o: torch.Tensor, do: torch.Tensor,
                dlse: Optional[torch.Tensor]) -> torch.Tensor:
    """The backward's ``delta = rowsum(dO·O) - dlse`` [B, H, Sq] f32 (the
    reference's ``_bwd`` :363-367; a cotangent on lse folds in here, since
    d lse_i / d s_ij = p_ij).  A plain PyTorch reduction, as JAX left it
    to XLA."""
    delta = (do.float() * o.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta


# ------------------------------------------------------------- wrappers


def _check_kernel_inputs(name: str, tensors, q, k, causal):
    tag = _DTYPE_TAG.get(q.dtype)
    _check(tag is not None, f"{name}: dtype {q.dtype} is not supported "
           f"(bf16 or f32)")
    B, H, Sq, hd = q.shape
    _check(hd in (64, 128), f"{name}: head dim must be 64 or 128, got {hd}")
    _check(Sq % TILE == 0 and k.shape[2] % TILE == 0,
           f"{name}: sequence lengths must be multiples of {TILE}, got "
           f"{Sq} / {k.shape[2]}")
    _check(k.shape[0] == B and k.shape[3] == hd,
           f"{name}: k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    _check(not causal or Sq == k.shape[2], f"{name}: causal needs Sq == Sk")
    _check(q.device.type == "cuda", f"{name}: unsupported device {q.device}")
    for t in tensors:
        _check(t.device == q.device, f"{name}: all tensors must be on "
               f"q's device")
        _check(t.is_contiguous(), f"{name}: all tensors must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"{name}: tensors must be 16-byte "
               f"aligned")
    return tag


def _launch(name: str, fn_name: str, ptrs, q, k, sm_scale, causal, window,
            tag) -> None:
    B, H, Sq, hd = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel(fn_name)(
            *ptrs, B, H, k.shape[1], Sq, k.shape[2], hd, int(causal),
            -1 if window is None else int(window), float(sm_scale), tag,
            stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def flash_fwd(q, k, v, sm_scale: float, causal: bool,
              window: Optional[int]):
    """K3: ``(o, lse)`` for q [B, H, Sq, hd] and k/v [B, Hkv, Sk, hd]."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, sm_scale, causal, window)
    tag = _check_kernel_inputs("flash_fwd", (q, k, v), q, k, causal)
    _check(v.shape == k.shape and v.dtype == k.dtype == q.dtype,
           "flash_fwd: q, k, v must share a dtype and k/v a shape")
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_fwd", "tdp_flash_fwd",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr()), q, k, sm_scale, causal, window, tag)
    return o, lse


def _check_bwd(name, q, k, v, do, lse, delta, causal):
    tag = _check_kernel_inputs(name, (q, k, v, do, lse, delta), q, k, causal)
    _check(v.shape == k.shape and do.shape == q.shape
           and v.dtype == k.dtype == do.dtype == q.dtype,
           f"{name}: q/do and k/v must match in shape, all in one dtype")
    _check(lse.shape == q.shape[:3] and delta.shape == q.shape[:3]
           and lse.dtype == delta.dtype == torch.float32,
           f"{name}: lse and delta must be f32 [B, H, Sq]")
    return tag


def flash_bwd_dq(q, k, v, do, lse, delta, sm_scale: float, causal: bool,
                 window: Optional[int]):
    """K4: dq [B, H, Sq, hd] in q's dtype."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, sm_scale,
                                      causal, window)
    tag = _check_bwd("flash_bwd_dq", q, k, v, do, lse, delta, causal)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", "tdp_flash_bwd_dq",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()),
            q, k, sm_scale, causal, window, tag)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, sm_scale: float, causal: bool,
                  window: Optional[int]):
    """K5: ``(dk, dv)`` [B, Hkv, Sk, hd], the GQA group sum included."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, sm_scale,
                                       causal, window)
    tag = _check_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, causal)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", "tdp_flash_bwd_dkv",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            q, k, sm_scale, causal, window, tag)
    return dk, dv


# ------------------------------------------------ autograd and remat='flash'

# Under remat='flash' the block forward runs twice: once recording K3's
# (o, lse) here, once (in the backward's recompute) replaying them, so K3
# runs once per block per step.  None outside a checkpointed block.
_STASH: contextvars.ContextVar = contextvars.ContextVar("flash_stash",
                                                        default=None)


@contextlib.contextmanager
def _stash_mode(stash: List, mode: str):
    token = _STASH.set((stash, mode))
    try:
        yield
    finally:
        _STASH.reset(token)


def flash_residual_contexts():
    """``context_fn`` for ``torch.utils.checkpoint``: the forward context
    keeps each flash call's ``(o, lse)``, the recompute context hands them
    back instead of launching K3 again — the counterpart of the
    reference's ``save_only_these_names('flash_out', 'flash_lse')``."""
    stash: List = []
    return _stash_mode(stash, "record"), _stash_mode(stash, "replay")


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: forward K3; backward delta
    (plain), then K4 and K5.  ``saved`` carries a replayed ``(o, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, window, saved):
        if saved is None:
            o, lse = flash_fwd(q, k, v, sm_scale, causal, window)
        else:
            o, lse = (t.detach() for t in saved)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (sm_scale, causal, window)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        do = do.contiguous()
        delta = flash_delta(o, do, dlse)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, *ctx.args)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None


def _flash(q, k, v, sm_scale, causal, window):
    stash = _STASH.get()
    if stash is not None and stash[1] == "replay" and stash[0]:
        return _Flash.apply(q, k, v, sm_scale, causal, window,
                            stash[0].pop(0))
    o, lse = _Flash.apply(q, k, v, sm_scale, causal, window, None)
    if stash is not None and stash[1] == "record":
        stash[0].append((o.detach(), lse.detach()))
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Blockwise (flash) attention, [B, H, S, hd], differentiable.
    ``window``: key in ``(q - window, q]`` (needs ``causal``).  GQA:
    ``k``/``v`` may carry fewer heads; grads come back in the kv heads'
    own shape.  CUDA tensors go through the kernels (contiguous, hd 64 or
    128, S a multiple of 64, bf16 or f32); CPU tensors through the plain
    versions."""
    _, sm_scale, window = prep_args(q, k, sm_scale, causal, window)
    o, _ = _flash(q, k, v, sm_scale, bool(causal), window)
    return o


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             sm_scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`flash_attention` (no window, as in the reference) but
    also returns the per-row logsumexp [B, H, S] f32, differentiably."""
    _, sm_scale, _ = prep_args(q, k, sm_scale, causal, None)
    return _flash(q, k, v, sm_scale, bool(causal), None)
