"""The transformer block's math, serial and tensor-parallel — the PyTorch
counterpart of ``torchdistpackage_tpu/parallel/tensor_parallel/layers.py``.

Parameters are plain dicts of tensors with the JAX package's layouts, so
the parity tests compare like with like: weights are ``[in, out]`` and
used as ``x @ w`` (not ``nn.Linear``'s ``[out, in]``), the fused QKV is
stacked ``[3, D, D]``, the GQA k/v projection ``[2, D, Dkv]`` and the
SwiGLU gate/up ``[2, D, F]``.  The norm kind and the activation are
carried by the parameter structure exactly as in the reference: a norm
without a ``bias`` leaf is RMSNorm, a 3-dim ``w1`` is SwiGLU.

One implementation serves both modes, as in the reference.  With
``tp_group=None`` a function runs serially on whole weights; with a
tensor-parallel group (``tp_utils``) each rank holds its shard of every
leaf (:func:`shard_params` cuts it by :data:`TP_SPLIT_DIMS`) and the
block inserts the Megatron regions: ``copy_to_tp`` (or, with ``sp``,
``gather_from_sp``) before the column-parallel QKV / W1, and
``reduce_from_tp`` (``scatter_to_sp``) after the row-parallel WO / W2,
the output bias added once after the reduction.  Under ``sp`` the
residual stream holds this rank's sequence rows; with
``cfg.collective_matmul`` the SP boundaries run as rings
(:func:`attention_partial_cm`, :func:`mlp_partial_cm`).  The training
block (:func:`block_forward`, :func:`scan_blocks`) runs its attention
through :func:`core_attention`: the plain ``'naive'`` path, the flash
kernels K3-K5 (``ops/flash_attention.py``), or the context-parallel
ring / Ulysses attention over a ``cp_group`` (``ops/ring_attention.py``),
at ``H / tp`` local heads, with residual dropout (:func:`dropout`) when
a key is given.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
import warnings
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...device import resolve_device
from ...obs.numerics import tree_leaves
from ...tools.surgery import int8_matmul, is_int8_weight
from ...utils.random import fold_in, split
from .tp_utils import (
    copy_to_tp,
    gather_from_sp,
    reduce_from_tp,
    ring_ag_matmul,
    ring_matmul_rs,
    scatter_to_sp,
    split_to_sp,
    tp_size,
)

Params = Dict[str, torch.Tensor]

#: the rope-scaling types, the reference's four
_ROPE_SCALING_TYPES = ("linear", "llama3", "dynamic", "yarn")
_ATTN_IMPLS = ("naive", "flash", "ring", "ulysses")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The fields of the reference ``TransformerConfig`` that the serving
    and training paths read.  ``dtype`` is a ``torch.dtype``.
    ``attn_impl``: ``'naive'`` (the [S, S] score matrix, plain ops),
    ``'flash'`` (kernels K3-K5), or the context-parallel ``'ring'`` /
    ``'ulysses'`` (``ops/ring_attention.py``, K3-K5 per hop): the
    sequence is sharded over the context group that the block functions
    take as ``cp_group=`` (serially, without one, they are one
    ``flash_attention`` call).  ``cp_layout``: ``'contiguous'`` or ``'zigzag'`` (ring
    only: rank i holds chunks i and 2n-1-i; prepare batches with
    ``ops.ring_attention.zigzag_permute``).
    ``dropout_rate``: residual dropout, applied when the caller passes a
    ``dropout_key``.  ``collective_matmul`` (SP only): the block's SP
    boundaries as rings once the gathered activation reaches
    ``cm_min_bytes``.  ``ag_compress='int8'`` (SP only): a block
    boundary whose gathered activation reaches ``compress_min_bytes``
    gathers and reduce-scatters through the int8 rings of
    ``dist/compressed.py`` (their backwards quantized too); where the
    collective-matmul ring applies it wins."""

    dim: int
    nheads: int
    nlayers: int = 2
    ffn_mult: int = 4
    causal: bool = True
    dtype: torch.dtype = torch.float32
    attn_impl: str = "naive"
    cp_layout: str = "contiguous"
    dropout_rate: float = 0.0
    kv_heads: Optional[int] = None
    rope: bool = False
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    norm: str = "layer"
    act: str = "gelu"
    ffn_hidden: Optional[int] = None
    norm_eps: float = 1e-5
    sliding_window: Optional[int] = None
    collective_matmul: bool = False
    cm_min_bytes: int = 1 << 20
    ag_compress: Optional[str] = None
    compress_min_bytes: int = 1 << 16

    def __post_init__(self):
        if self.attn_impl not in _ATTN_IMPLS:
            raise ValueError(
                f"attn_impl must be one of {_ATTN_IMPLS}, got "
                f"{self.attn_impl!r}")
        if self.cp_layout not in ("contiguous", "zigzag"):
            raise ValueError(f"cp_layout must be 'contiguous' or 'zigzag', "
                             f"got {self.cp_layout!r}")
        if self.cp_layout != "contiguous" and self.attn_impl != "ring":
            raise ValueError(f"cp_layout={self.cp_layout!r} applies to "
                             f"attn_impl='ring' only (got "
                             f"{self.attn_impl!r})")
        if self.sliding_window is not None and self.attn_impl in (
                "ring", "ulysses"):
            raise ValueError(
                "sliding_window is not supported by the context-parallel "
                "attention (a shard boundary would change the window's "
                "reach)")
        if self.sliding_window is not None:
            if not self.causal:
                raise ValueError("sliding_window requires causal attention")
            if self.sliding_window < 1:
                raise ValueError(
                    f"sliding_window must be >= 1, got {self.sliding_window}")
        if self.ag_compress not in (None, "int8"):
            raise ValueError(
                f"ag_compress must be None or 'int8', got {self.ag_compress!r}")
        if self.norm not in ("layer", "rms"):
            raise ValueError(f"norm must be 'layer' or 'rms', got {self.norm!r}")
        if self.act not in ("gelu", "swiglu"):
            raise ValueError(f"act must be 'gelu' or 'swiglu', got {self.act!r}")
        if self.rope_scaling is not None:
            kind = self.rope_scaling.get(
                "rope_type", self.rope_scaling.get("type"))
            if kind not in _ROPE_SCALING_TYPES:
                raise NotImplementedError(
                    f"rope_scaling type {kind!r}; supported: "
                    f"{_ROPE_SCALING_TYPES}")
            need = {
                "linear": ("factor",),
                "llama3": ("factor", "low_freq_factor", "high_freq_factor",
                           "original_max_position_embeddings"),
                "dynamic": ("factor", "original_max_position_embeddings"),
                "yarn": ("factor", "original_max_position_embeddings"),
            }[kind]
            missing = [k for k in need if k not in self.rope_scaling]
            if missing:
                raise ValueError(
                    f"rope_scaling type {kind!r} needs keys {missing}")

    @property
    def head_dim(self) -> int:
        if self.dim % self.nheads:
            raise ValueError(f"dim {self.dim} not divisible by {self.nheads}")
        return self.dim // self.nheads

    @property
    def kv_head_count(self) -> int:
        kv = self.nheads if self.kv_heads is None else self.kv_heads
        if self.nheads % kv:
            raise ValueError(f"nheads {self.nheads} not divisible by {kv}")
        return kv

    @property
    def is_gqa(self) -> bool:
        return self.kv_head_count != self.nheads

    @property
    def ffn_dim(self) -> int:
        return (self.ffn_hidden if self.ffn_hidden is not None
                else self.dim * self.ffn_mult)


# ------------------------------------------------------------------ norms


def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics whatever the storage dtype; params
    without a ``bias`` leaf dispatch to :func:`rms_norm` (the structural
    norm switch of the reference).  The variance is the population
    variance, as ``jnp.var``."""
    if "bias" not in p:
        return rms_norm(x, p, eps)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    # a bf16 scale / bias promotes to f32 inside the kernels: exactly the
    # reference's astype(f32), without a cast kernel of its own
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def rms_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm: ``x / rms(x) * scale`` with f32 statistics."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * p["scale"]).to(x.dtype)


def init_norm_params(dim: int, dtype: torch.dtype, norm: str = "layer",
                     device: Optional[torch.device] = None) -> Params:
    """Norm params whose structure encodes the norm kind ('layer' carries
    a bias leaf, 'rms' does not)."""
    out = {"scale": torch.ones(dim, dtype=dtype, device=device)}
    if norm == "layer":
        out["bias"] = torch.zeros(dim, dtype=dtype, device=device)
    return out


# ------------------------------------------------------------------- rope


def _scaled_inv_freq(inv_freq: torch.Tensor, scaling: dict,
                     theta: float = 10000.0,
                     pos: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, float]:
    """A rope-scaling recipe applied to the base inverse frequencies
    (JAX ``layers.py:257``, ``transformers``' ``modeling_rope_utils``);
    returns ``(inv_freq, attention_factor)``, the factor 1.0 for every
    type but yarn.

    - 'linear': every frequency / factor.
    - 'llama3': long wavelengths / factor, short ones kept, the band
      between interpolated.
    - 'dynamic' (NTK): the base theta grows with the current length past
      ``original_max_position_embeddings``, ``theta * ((f s / orig) - (f
      - 1)) ^ (d / (d - 2))``; the length ``s`` is ``max(pos) + 1``
      floored at the original length, read on ``pos``'s device (no host
      read).  At or below the original length it is the unscaled rope.
    - 'yarn': interpolated below ``beta_slow`` rotations, extrapolated
      above ``beta_fast``, a linear ramp between, and the attention
      factor ``0.1 ln(factor) + 1`` (or the ``mscale`` /
      ``mscale_all_dim`` ratio) that the caller folds into the tables;
      ``truncate`` (default True) rounds the ramp's ends outward."""
    kind = scaling.get("rope_type", scaling.get("type"))
    factor = float(scaling["factor"])
    if kind == "linear":
        return inv_freq / factor, 1.0
    if kind == "llama3":
        lo = float(scaling["low_freq_factor"])
        hi = float(scaling["high_freq_factor"])
        old_len = float(scaling["original_max_position_embeddings"])
        wavelen = 2.0 * math.pi / inv_freq
        scaled = torch.where(wavelen > old_len / lo, inv_freq / factor,
                             inv_freq)
        smooth = (old_len / wavelen - lo) / (hi - lo)
        smoothed = (1.0 - smooth) * scaled / factor + smooth * scaled
        medium = (wavelen >= old_len / hi) & (wavelen <= old_len / lo)
        return torch.where(medium, smoothed, scaled), 1.0
    half = inv_freq.shape[0]
    dim = 2 * half
    steps = torch.arange(0, half, dtype=torch.float32,
                         device=inv_freq.device)
    if kind == "dynamic":
        orig = float(scaling["original_max_position_embeddings"])
        if pos is None:
            seq_len = torch.tensor(orig, dtype=torch.float32,
                                   device=inv_freq.device)
        else:
            seq_len = (pos.max() + 1).to(torch.float32).clamp_min(orig)
        base = theta * ((factor * seq_len / orig) - (factor - 1.0)) ** (
            dim / (dim - 2.0))
        return base ** (-steps / half), 1.0
    if kind != "yarn":
        raise NotImplementedError(f"rope_scaling type {kind!r}")
    orig = float(scaling["original_max_position_embeddings"])
    beta_fast = float(scaling.get("beta_fast") or 32)
    beta_slow = float(scaling.get("beta_slow") or 1)

    def get_mscale(scale, m=1.0):
        return 0.1 * m * math.log(scale) + 1.0 if scale > 1 else 1.0

    af = scaling.get("attention_factor")
    if af is None:
        ms, msad = scaling.get("mscale"), scaling.get("mscale_all_dim")
        af = (get_mscale(factor, ms) / get_mscale(factor, msad)
              if ms and msad else get_mscale(factor))

    def correction_dim(n_rot):
        return dim * math.log(orig / (n_rot * 2 * math.pi)) / (
            2 * math.log(theta))

    low, high = correction_dim(beta_fast), correction_dim(beta_slow)
    if scaling.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001  # transformers' singularity guard
    ramp = ((steps - low) / (high - low)).clamp(0.0, 1.0)
    extrap_w = 1.0 - ramp
    inv = inv_freq / factor * (1.0 - extrap_w) + inv_freq * extrap_w
    return inv, float(af)


def rope_cache(pos: torch.Tensor, head_dim: int, theta: float = 10000.0,
               scaling: Optional[dict] = None):
    """(cos, sin) tables ``[1, 1, S, hd/2]`` in f32 for the positions
    ``pos`` [S] — compute once per forward and reuse in every layer.
    ``scaling``: a rope-scaling dict (:func:`_scaled_inv_freq`; yarn's
    attention factor is folded into the tables, dynamic reads the current
    length from ``pos``)."""
    if head_dim % 2:
        raise ValueError(f"rope needs an even head_dim, got {head_dim}")
    half = head_dim // 2
    inv_freq = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=pos.device) / half)
    af = 1.0
    if scaling is not None:
        inv_freq, af = _scaled_inv_freq(inv_freq, scaling, theta=theta,
                                        pos=pos)
    ang = pos.float()[:, None] * inv_freq[None, :]
    return torch.cos(ang)[None, None] * af, torch.sin(ang)[None, None] * af


def apply_rope(x: torch.Tensor, cache) -> torch.Tensor:
    """Rotary embedding, half-split convention (not interleaved): the
    pairs ``(x_i, x_{i+hd/2})`` rotate by the cached angles; f32 trig, the
    result in ``x``'s dtype.  ``x`` is ``[B, H, S, hd]``."""
    cos, sin = cache
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------- projections


def dense(x: torch.Tensor, w, b: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """``x @ w (+ b)`` with the reference's structural int8 dispatch: a
    weight with ``q`` / ``scale`` (``tools.surgery.QuantizedLinear``) runs
    :func:`~...tools.surgery.int8_matmul` (the int8 weight upcast to
    ``x.dtype``, the product, the per-column scale in f32, a cast back),
    and the bias is added after, as the reference adds it.  A plain
    ``[in, out]`` weight takes the bias in the GEMM's epilogue (one
    kernel, not two); it rounds once where ``x @ w + b`` rounds twice,
    which is the same value for the zero biases of the Llama preset and
    within f32 rounding otherwise.  A stacked int8 weight is indexed to
    2-D before it gets here (``wqkv[i]``), its scale with it."""
    if is_int8_weight(w):
        y = int8_matmul(x, w)
        return y if b is None else y + b
    return F.linear(x, w.t(), b)


def _project_qkv(p: Params, x: torch.Tensor, cfg: TransformerConfig):
    """x [B, S, D] -> unrotated ``(q [B, H_loc, S, hd], k, v [B, Hkv_loc,
    S, hd])``; the head counts are read off the (local) weights."""
    B, S, _ = x.shape
    hd = cfg.head_dim

    def heads(t):
        return t.reshape(B, S, -1, hd).transpose(1, 2)

    if "wqkv" in p:
        w, b = p["wqkv"], p["bqkv"]
        return tuple(heads(dense(x, w[i], b[i])) for i in range(3))
    cols = p["wkv"].shape[-1]
    hkv_loc, rem = divmod(cols, hd)
    if rem or hkv_loc == 0:
        # e.g. MQA (kv_heads 1) under TP 2: the shard holds half a head
        raise ValueError(
            f"TP shard holds {cols} kv columns = {cols / hd:g} heads of dim "
            f"{hd}; GQA under TP needs kv_heads % tp_size == 0 (whole heads "
            f"per shard)")
    return (heads(dense(x, p["wq"], p["bq"])),
            heads(dense(x, p["wkv"][0], p["bkv"][0])),
            heads(dense(x, p["wkv"][1], p["bkv"][1])))


def _rotate(q: torch.Tensor, k: torch.Tensor, rope):
    # q and k rotate in one pass: the same elementwise arithmetic, half
    # the kernels
    qk = apply_rope(torch.cat([q, k], dim=1), rope)
    return qk.split([q.shape[1], k.shape[1]], dim=1)


def compute_qkv(p: Params, x: torch.Tensor, cfg: TransformerConfig,
                rope=None):
    """x [B, S, D] -> rope-rotated ``(q [B, H, S, hd], k, v [B, Hkv, S,
    hd])`` from either the fused ``wqkv`` layout or the GQA ``wq``/``wkv``
    layout; under TP the local heads of the rank's shard (a GQA shard
    must hold whole KV heads).  ``rope`` is the (cos, sin) cache;
    computed here when ``cfg.rope`` and None."""
    S = x.shape[1]
    hd = cfg.head_dim
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.rope:
        if rope is None:
            rope = rope_cache(torch.arange(S, device=x.device), hd,
                              cfg.rope_theta, scaling=cfg.rope_scaling)
        q, k = _rotate(q, k, rope)
    return q, k, v


def mlp_partial(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Col -> act -> Row without the output bias.  A 3-dim ``w1`` is the
    stacked ``[2, D, F]`` SwiGLU gate/up pair; a 2-dim one the GELU MLP,
    with the tanh approximation that ``jax.nn.gelu`` uses by default."""
    w1, b1 = p["w1"], p["b1"]
    if w1.ndim == 3:
        h = F.silu(dense(x, w1[0], b1[0])) * dense(x, w1[1], b1[1])
    else:
        h = F.gelu(dense(x, w1, b1), approximate="tanh")
    return dense(h, p["w2"])


# ------------------------------------------------------- training block


def block_rope_cache(cfg: TransformerConfig, s: int, device,
                     tp_group=None, sp: bool = False, cp_group=None):
    """The layer-invariant (cos, sin) rope cache for a block stack whose
    activations have ``s`` sequence rows, or None when rope is off —
    computed once per forward and passed to every block.  Attention sees
    the SP-gathered sequence, so under ``sp`` the table covers ``s tp``
    rows; under context parallelism (``cp_group``) they are the shard's
    global positions, contiguous or zigzag (JAX ``_rope_positions``)."""
    if not cfg.rope:
        return None
    if tp_group is not None and sp:
        s *= tp_size(tp_group)
    from ...ops.ring_attention import shard_positions

    return rope_cache(shard_positions(cp_group, s, cfg.cp_layout, device),
                      cfg.head_dim, cfg.rope_theta, scaling=cfg.rope_scaling)


def core_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: TransformerConfig, cp_group=None) -> torch.Tensor:
    """(q, k, v) [B, H(kv), S, hd] -> [B, H, S, hd] through the configured
    ``attn_impl`` — the one dispatch switch, as in the reference.  The
    flash kernels take contiguous tensors, so the head-major views are
    made contiguous here.  ``'ring'`` / ``'ulysses'`` run over the
    context group ``cp_group`` (the rank's sequence shard in q/k/v); with
    none they are one ``flash_attention`` call, as the reference's serial
    fallback is its flash path."""
    from ...ops.flash_attention import flash_attention, mha_reference

    if cp_group is not None and cfg.attn_impl not in ("ring", "ulysses"):
        raise ValueError(
            f"a cp_group needs attn_impl 'ring' or 'ulysses' (got "
            f"{cfg.attn_impl!r}): a shard-local attention would be a "
            f"silently different model")
    if cfg.attn_impl == "flash":
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=cfg.causal,
                               window=cfg.sliding_window)
    if cfg.attn_impl == "ring":
        from ...ops.ring_attention import ring_attention

        return ring_attention(q, k, v, group=cp_group, causal=cfg.causal,
                              layout=cfg.cp_layout)
    if cfg.attn_impl == "ulysses":
        from ...ops.ring_attention import ulysses_attention

        return ulysses_attention(q, k, v, group=cp_group, causal=cfg.causal)
    return mha_reference(q, k, v, causal=cfg.causal,
                         window=cfg.sliding_window)


def attention_partial(p: Params, x: torch.Tensor, cfg: TransformerConfig,
                      rope=None, cp_group=None) -> torch.Tensor:
    """QKV projection, core attention and the output projection without
    its bias: x [B, S, D] -> [B, S, D] (the rank's sequence shard under
    context parallelism, ``cp_group``)."""
    B, S, _ = x.shape
    q, k, v = compute_qkv(p, x, cfg, rope=rope)
    out = core_attention(q, k, v, cfg, cp_group)
    return dense(out.transpose(1, 2).reshape(B, S, -1), p["wo"])


def dropout(x: torch.Tensor, rate: float, key: Optional[int]
            ) -> torch.Tensor:
    """Inverted dropout; the identity when ``key`` is None or ``rate`` is
    0.  The mask is drawn from a ``torch.Generator`` on ``x``'s device
    (Philox on the card) seeded with ``key`` alone, so the same key gives
    the same mask — a checkpointed block's recompute included, whatever
    any generator's running state.  Derive the key per data rank with
    ``utils.random.axis_unique_key(key, 'data')`` so data shards draw
    distinct masks while tensor shards agree."""
    if key is None or rate == 0.0:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed(key)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _open_column_parallel(h: torch.Tensor, tp_group, sp: bool,
                          compress: Optional[str] = None) -> torch.Tensor:
    """The activation a column-parallel product reads: ``h`` serially,
    the SP-gathered sequence under ``sp`` (``compress='int8'``: through
    the int8 ring), else ``h`` through ``copy_to_tp`` (its gradient
    summed over the group)."""
    if tp_group is None:
        return h
    return (gather_from_sp(h, tp_group, compress=compress) if sp
            else copy_to_tp(h, tp_group))


def _close_row_parallel(y: torch.Tensor, bias: torch.Tensor, tp_group,
                        sp: bool, compress: Optional[str] = None
                        ) -> torch.Tensor:
    """Finish a row-parallel product: reduce the partial sums over the
    group (into SP layout under ``sp``; ``compress='int8'``: through the
    int8 ring) and add the output bias once.  The non-SP all-reduce
    stays exact, as in the reference."""
    if tp_group is not None:
        y = (scatter_to_sp(y, tp_group, compress=compress) if sp
             else reduce_from_tp(y, tp_group))
    return y + bias


def _sp_compress(cfg: TransformerConfig, h: torch.Tensor, tp_group,
                 sp: bool) -> Optional[str]:
    """One SP boundary's decision: ``'int8'`` when ``ag_compress='int8'``,
    SP is on over more than one rank and the gathered activation (``h``
    this rank's rows) reaches ``compress_min_bytes``; else None (the
    exact collectives)."""
    if cfg.ag_compress != "int8" or tp_group is None or not sp:
        return None
    n = tp_size(tp_group)
    if n <= 1:
        return None
    full = h.numel() * n * h.element_size()
    return "int8" if full >= cfg.compress_min_bytes else None


def _use_cm(cfg: TransformerConfig, x: torch.Tensor, tp_group,
            sp: bool) -> bool:
    """Collective matmul only under SP on a group of more than one rank,
    and only once the gathered activation reaches ``cm_min_bytes``."""
    if not (cfg.collective_matmul and tp_group is not None and sp):
        return False
    n = tp_size(tp_group)
    return n > 1 and x.numel() * n * x.element_size() >= cfg.cm_min_bytes


def attention_partial_cm(p: Params, x: torch.Tensor, cfg: TransformerConfig,
                         tp_group, rope=None, cp_group=None) -> torch.Tensor:
    """Collective-matmul attention on an SP shard: x [B, s, D] -> [B, s,
    D], reduced over the group into SP layout, without ``bo`` (the ring
    reduces; the caller adds only the bias).  The QKV projection runs
    inside :func:`~.tp_utils.ring_ag_matmul`, attention on the assembled
    sequence, the output projection through
    :func:`~.tp_utils.ring_matmul_rs`."""
    B, s, _ = x.shape
    S = s * tp_size(tp_group)
    qkv = ring_ag_matmul(
        x, lambda xc: dict(zip("qkv", _project_qkv(p, xc, cfg))), tp_group,
        out_seq_dim=2)
    q, k, v = qkv["q"], qkv["k"], qkv["v"]
    if cfg.rope:
        if rope is None:
            rope = rope_cache(torch.arange(S, device=x.device),
                              cfg.head_dim, cfg.rope_theta,
                              scaling=cfg.rope_scaling)
        q, k = _rotate(q, k, rope)
    out = core_attention(q, k, v, cfg, cp_group).transpose(1, 2).reshape(
        B, S, -1)
    return ring_matmul_rs(out, lambda oc: dense(oc, p["wo"]), tp_group)


def mlp_partial_cm(p: Params, x: torch.Tensor, tp_group) -> torch.Tensor:
    """Collective-matmul MLP on an SP shard: [B, s, D] -> [B, s, D]
    reduced into SP layout, without ``b2``; the activation is row-wise,
    so it folds into the ring's chunk product and the hidden [B, S, F]
    is never whole."""
    w1, b1 = p["w1"], p["b1"]
    if w1.ndim == 3:
        def mm1(xc):
            return F.silu(dense(xc, w1[0], b1[0])) * dense(xc, w1[1], b1[1])
    else:
        def mm1(xc):
            return F.gelu(dense(xc, w1, b1), approximate="tanh")
    h = ring_ag_matmul(x, mm1, tp_group, out_seq_dim=1)
    return ring_matmul_rs(h, lambda hc: dense(hc, p["w2"]), tp_group)


def block_forward(p: Params, x: torch.Tensor, cfg: TransformerConfig,
                  rope=None, dropout_key: Optional[int] = None,
                  tp_group=None, sp: bool = False,
                  cp_group=None) -> torch.Tensor:
    """Pre-norm block: x + attn(norm(x)) + bo, then + mlp(norm(.)) + b2.
    ``dropout_key`` turns on residual dropout at ``cfg.dropout_rate`` on
    both branches, each site with its own key.  ``tp_group``: the
    tensor-parallel group ``p``'s shards belong to (None: serial);
    ``sp``: x is this rank's sequence rows [B, S / tp, D] (sequence
    parallelism), the norms run on them and the attention / MLP
    boundaries gather and reduce-scatter.  ``cp_group``: context
    parallelism (``cfg.attn_impl`` ``'ring'`` / ``'ulysses'``), x the
    rank's shard of the sequence; the rope cache (built here when None)
    takes the shard's global positions."""
    if rope is None and cfg.rope and cp_group is not None:
        rope = block_rope_cache(cfg, x.shape[1], x.device, tp_group, sp,
                                cp_group)
    k_attn = k_mlp = None
    if dropout_key is not None and cfg.dropout_rate > 0.0:
        k_attn, k_mlp = split(dropout_key)
    use_cm = _use_cm(cfg, x, tp_group, sp)
    h = layer_norm(x, p["ln1"], cfg.norm_eps)
    if use_cm:
        y = attention_partial_cm(p["attn"], h, cfg, tp_group, rope=rope,
                                 cp_group=cp_group) + p["attn"]["bo"]
    else:
        # quantized SP boundaries (cfg.ag_compress): the entering gather
        # and the closing reduce-scatter, and their backwards, int8
        qc = _sp_compress(cfg, h, tp_group, sp)
        y = _close_row_parallel(
            attention_partial(p["attn"], _open_column_parallel(h, tp_group,
                                                               sp, qc),
                              cfg, rope=rope, cp_group=cp_group),
            p["attn"]["bo"], tp_group, sp, qc)
    x = x + dropout(y, cfg.dropout_rate, k_attn)
    h = layer_norm(x, p["ln2"], cfg.norm_eps)
    if use_cm:
        z = mlp_partial_cm(p["mlp"], h, tp_group) + p["mlp"]["b2"]
    else:
        qc = _sp_compress(cfg, h, tp_group, sp)
        z = _close_row_parallel(
            mlp_partial(p["mlp"], _open_column_parallel(h, tp_group, sp,
                                                        qc)),
            p["mlp"]["b2"], tp_group, sp, qc)
    return x + dropout(z, cfg.dropout_rate, k_mlp)


def transformer_forward(params: Params, x: torch.Tensor,
                        cfg: TransformerConfig, tp_group=None,
                        sp: bool = False) -> torch.Tensor:
    """The block list ``params['blocks']`` then ``ln_f`` on a full
    activation x [B, S, D] (JAX :876).  Under ``sp`` the input is split
    to this rank's rows first, and gathered back at the end."""
    if tp_group is not None and sp:
        x = split_to_sp(x, tp_group)
    rope = block_rope_cache(cfg, x.shape[1], x.device, tp_group, sp)
    for bp in params["blocks"]:
        x = block_forward(bp, x, cfg, rope=rope, tp_group=tp_group, sp=sp)
    x = layer_norm(x, params["ln_f"], cfg.norm_eps)
    if tp_group is not None and sp:
        x = gather_from_sp(x, tp_group)
    return x


#: ``remat`` values: False/None (no checkpointing), True (each block
#: recomputed in the backward), 'flash' (recomputed, but the flash
#: kernel's (o, lse) are kept, so the backward does not run K3 again),
#: 'flash_offload' ('flash' with each kept o parked in pinned host
#: memory between the forward and the backward; lse stays on the card).
RematMode = Union[bool, None, str]
_REMAT_MODES = (False, None, True, "flash", "flash_offload")


def _device_hbm_bytes(device: torch.device) -> Optional[int]:
    """The card's memory, or None off the card."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory


def offload_advice(cfg: TransformerConfig, x_shape: Tuple[int, ...],
                   nlayers: int, hbm_bytes: Optional[int] = None,
                   device: Optional[torch.device] = None) -> Optional[str]:
    """Guard-rail for ``remat='flash_offload'``: a warning when the
    'flash' policy's resident activations fit comfortably (under half of
    the device's memory), where the offload's copies buy nothing; None when
    the offload is plausibly needed or the memory is unknown (the CPU).
    The estimate, as the reference's: per block one boundary carry and
    the saved o ([B, S, D] in ``cfg.dtype`` each) and the f32 lse [B, H,
    S]; parameters, optimizer state and temporaries are not modelled."""
    if hbm_bytes is None and device is not None:
        hbm_bytes = _device_hbm_bytes(device)
    if not hbm_bytes:
        return None
    B, S, D = x_shape
    dt = torch.empty((), dtype=cfg.dtype).element_size()
    total = nlayers * (2 * B * S * D * dt + B * cfg.nheads * S * 4)
    if total >= 0.5 * hbm_bytes:
        return None
    return (
        f"remat='flash_offload': the 'flash' policy's resident activations "
        f"are ~{total / 1e9:.2f} GB for this config against "
        f"~{hbm_bytes / 1e9:.1f} GB of device memory, so plain "
        f"remat='flash' should fit; 'flash_offload' adds a copy of each "
        f"block's o to host memory and back every step, which pays only "
        f"when 'flash' runs out of memory.")


def checkpoint_block(fn, remat: RematMode):
    """``fn`` wrapped in ``torch.utils.checkpoint`` per the validated remat
    mode; a misspelled mode raises instead of silently degrading."""
    if remat not in _REMAT_MODES:
        raise ValueError(f"remat must be one of {_REMAT_MODES}, got {remat!r}")
    if not remat:
        return fn
    kw = {}
    if remat in ("flash", "flash_offload"):
        from ...ops.flash_attention import flash_residual_contexts

        kw["context_fn"] = functools.partial(
            flash_residual_contexts, offload=remat == "flash_offload")

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return wrapped


# Set by :func:`grad_taps` (data parallelism) while a forward runs.
_GRAD_TAP: contextvars.ContextVar = contextvars.ContextVar("grad_tap",
                                                         default=None)


class _GradTap(torch.autograd.Function):
    """The identity, whose backward first hands the incoming gradient to
    a callback."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.fn(g)
        return g, None


@contextlib.contextmanager
def grad_taps(callback: Callable[[torch.Tensor, int, torch.Tensor], None]):
    """While active, :func:`scan_blocks` passes each layer's slice of a
    stacked parameter (a leaf tensor) that requires grad through an
    identity whose backward calls ``callback(leaf, layer, grad)`` as soon as that layer's
    backward has produced the slice's gradient — long before the stacked
    leaf's own gradient exists (it is formed once layer 0's backward is
    done).  The gradients themselves are unchanged."""
    token = _GRAD_TAP.set(callback)
    try:
        yield
    finally:
        _GRAD_TAP.reset(token)


def scan_blocks(stacked: Params, x: torch.Tensor, cfg: TransformerConfig,
                remat: RematMode = False, dropout_key: Optional[int] = None,
                tp_group=None, sp: bool = False,
                layer_mask=None, cp_group=None) -> torch.Tensor:
    """Run ``x`` through the layer-stacked block params ([L, ...] leaves)
    — the reference's ``lax.scan`` as a Python loop.  The stacked leaves
    are unbound once (their backward is one stack, not L scatter-adds),
    and the rope cache is computed once for all layers.  ``dropout_key``
    turns on residual dropout; layer ``i`` folds ``i`` into the key, so
    layers draw distinct masks.  ``tp_group`` / ``sp`` as in
    :func:`block_forward` (x is [B, S / tp, D] under ``sp``); ``cp_group``
    the context group of ``'ring'`` / ``'ulysses'`` attention (x the
    rank's sequence shard).  Under remat the recompute runs each block's
    ring sends again, in the same order on every rank of the group.

    ``layer_mask`` ([L] floats or a sequence, 1 = real layer, 0 =
    padding) runs a padded stage slab of
    ``pipeline_parallel.balanced_stage_stack``: a padding layer is
    skipped, so it costs no FLOPs and its slice of every leaf gets an
    exactly zero grad (zero-initialised padding stays zero under any
    optimizer).  The reference selects with ``jnp.where`` (one SPMD
    program pays the padding's FLOPs); here the mask is read on the
    host, once a call.  Under context parallelism a stage's mask is the
    same on every rank of its context group, so no rank skips a ring the
    others enter."""
    tap = _GRAD_TAP.get()

    def unbind(tree):
        if isinstance(tree, dict):
            return {k: unbind(v) for k, v in tree.items()}
        return tree, tree.unbind(0)

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        leaf, parts = tree
        if tap is None or not (leaf.requires_grad and leaf.is_leaf):
            return parts[i]
        return _GradTap.apply(parts[i], functools.partial(tap, leaf, i))

    per_layer = unbind(stacked)
    L = len(next(tree_leaves(stacked)))
    rope = block_rope_cache(cfg, x.shape[1], x.device, tp_group, sp,
                            cp_group)
    if remat == "flash_offload":
        advice = offload_advice(cfg, tuple(x.shape), L, device=x.device)
        if advice:
            warnings.warn(advice, stacklevel=2)
    # the serial call passes no tensor-parallel arguments at all
    tp = {} if tp_group is None else {"tp_group": tp_group, "sp": sp}
    if cp_group is not None:
        tp["cp_group"] = cp_group
    real = [True] * L
    if layer_mask is not None:
        flags = [float(m) for m in (layer_mask.tolist() if isinstance(
            layer_mask, torch.Tensor) else layer_mask)]
        if len(flags) != L:
            raise ValueError(f"layer_mask has {len(flags)} entries for {L} "
                             f"layers")
        real = [m > 0 for m in flags]
    for i in range(L):
        if not real[i]:
            continue
        lp = layer(per_layer, i)
        key = None if dropout_key is None else fold_in(dropout_key, i)
        x = checkpoint_block(
            lambda h, lp=lp, key=key: block_forward(
                lp, h, cfg, rope=rope, dropout_key=key, **tp), remat)(x)
    return x


# ------------------------------------------------------------------- init


def _normal(shape, std: float, dtype: torch.dtype, gen: torch.Generator,
            device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * std).to(dtype)


def init_block_params(gen: torch.Generator, cfg: TransformerConfig,
                      device=None, mlp: bool = True) -> Params:
    """One block's parameters, drawn from ``gen`` on ``device``: the
    reference's layouts and scales (``N(0, 1/D)`` projections,
    ``N(0, 1/F)`` down-projection, zero biases).  The draws differ from
    JAX's; parity tests carry JAX's weights over with
    :func:`~..models.convert.params_from_jax` instead.  ``device``
    defaults to the card, like every entry point of the port.
    ``mlp=False`` leaves the MLP out (an expert block carries ``moe``
    instead)."""
    device = resolve_device(device)
    D, Fd = cfg.dim, cfg.ffn_dim
    s = 1.0 / math.sqrt(D)
    dt = cfg.dtype

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    if cfg.is_gqa:
        Dkv = cfg.kv_head_count * cfg.head_dim
        attn = {"wq": _normal((D, D), s, dt, gen, device), "bq": zeros(D),
                "wkv": _normal((2, D, Dkv), s, dt, gen, device),
                "bkv": zeros(2, Dkv)}
    else:
        attn = {"wqkv": _normal((3, D, D), s, dt, gen, device),
                "bqkv": zeros(3, D)}
    attn["wo"] = _normal((D, D), s, dt, gen, device)
    attn["bo"] = zeros(D)
    out = {"ln1": init_norm_params(D, dt, cfg.norm, device), "attn": attn,
           "ln2": init_norm_params(D, dt, cfg.norm, device)}
    if not mlp:
        return out
    if cfg.act == "swiglu":
        mlp = {"w1": _normal((2, D, Fd), s, dt, gen, device),
               "b1": zeros(2, Fd)}
    else:
        mlp = {"w1": _normal((D, Fd), s, dt, gen, device), "b1": zeros(Fd)}
    mlp["w2"] = _normal((Fd, D), 1.0 / math.sqrt(Fd), dt, gen, device)
    mlp["b2"] = zeros(D)
    out["mlp"] = mlp
    return out


def init_transformer_params(gen: torch.Generator, cfg: TransformerConfig,
                            device=None) -> Params:
    """The transformer family's tree (JAX :1064): ``blocks``, a list of
    ``cfg.nlayers`` block dicts (:func:`init_block_params`), and
    ``ln_f`` — what :func:`transformer_forward` takes.  ``device``
    defaults to the card (``'meta'`` gives shapes and dtypes alone)."""
    device = resolve_device(device)
    return {"blocks": [init_block_params(gen, cfg, device)
                       for _ in range(cfg.nlayers)],
            "ln_f": init_norm_params(cfg.dim, cfg.dtype, cfg.norm, device)}


# ------------------------------------------------------------------ specs


def transformer_param_specs(cfg: TransformerConfig, axis: str = "tensor"
                            ) -> Dict[str, object]:
    """The transformer family's spec tree over the tensor axis ``axis``
    (JAX :1126) in the port's PartitionSpec-like form: each leaf a tuple
    of axis names, one entry a dim, ``axis`` on the leaf's
    :data:`TP_SPLIT_DIMS` dim (:func:`param_specs` of the family's tree
    on the ``meta`` device) and every other dim replicated.
    ``dist.autoplan.plan_param_specs`` reads it."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    shapes = init_transformer_params(gen, cfg, device="meta")

    def tup(leaf, spec):
        entries = [None] * leaf.dim()
        if isinstance(spec, int):
            entries[spec % leaf.dim()] = axis
        return tuple(entries)
    return _zip_specs(tup, shapes, param_specs(shapes))


#: The one table of tensor-parallel placement (the reference's
#: ``block_param_specs`` / ``stacked_block_specs`` /
#: ``transformer_param_specs`` / ``gpt_param_specs``): the dimension
#: each leaf is split on over the tensor group, by the leaf's name,
#: counted from the end so that a layer-stacked ``[L, ...]`` leaf keeps
#: its leading layer dim.  Column-parallel weights and biases split
#: their output columns (-1; whole heads, since the columns are
#: head-major), row-parallel weights their input rows (-2), the
#: vocab-parallel embedding its rows and the head its columns.  Every
#: other leaf is replicated, and so is everything under ``moe`` (the
#: router and the experts: the MoE FFN runs whole on every tensor rank).
TP_SPLIT_DIMS: Dict[str, int] = {
    "wqkv": -1, "bqkv": -1, "wq": -1, "bq": -1, "wkv": -1, "bkv": -1,
    "wo": -2, "w1": -1, "b1": -1, "w2": -2, "tok_emb": -2, "head": -1}
#: Replicated leaves that sequence parallelism applies to this rank's
#: sequence rows only (the norms, and the row-parallel biases added after
#: the reduce-scatter): under ``sp`` each rank's gradient of such a leaf
#: is a partial sum, to be summed over the tensor group before the
#: update.  The reference gets that sum from ``shard_map``'s transpose.
SEQUENCE_PARTIAL = ("ln1", "ln2", "ln_f", "bo", "b2")
#: a spec tree's leaf for a replicated leaf whose grad is partial under SP
PARTIAL_UNDER_SP = "partial_under_sp"


def param_specs(tree) -> object:
    """The spec tree of a parameter tree (dicts and lists, the dense GPT's
    stacked blocks or the MoE family's block list): at each leaf its
    split dim (an int, from :data:`TP_SPLIT_DIMS`), None for a replicated
    leaf, or :data:`PARTIAL_UNDER_SP` for a replicated leaf of
    :data:`SEQUENCE_PARTIAL`."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not _is_leaf(node):
            return type(node)(walk(v, path) for v in node)
        if "moe" in path:
            return None
        if any(name in SEQUENCE_PARTIAL for name in path):
            return PARTIAL_UNDER_SP
        return TP_SPLIT_DIMS.get(path[-1])
    return walk(tree, ())


def _is_leaf(node) -> bool:
    # an int8 expert (q8, scale) pair is one leaf of the tree
    return isinstance(node, tuple) and len(node) == 2 and not any(
        isinstance(t, (dict, list, tuple)) for t in node)


def _zip_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_leaf(tree):
        return type(tree)(_zip_specs(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def _split_dim(spec) -> Optional[int]:
    return spec if isinstance(spec, int) else None


def shard_params(tree, specs, rank: int, size: int):
    """Rank ``rank`` of ``size``'s shard of a full parameter tree: every
    split leaf cut to its ``1 / size`` slice along its spec's dim (views
    of ``tree``'s tensors — or numpy arrays —, like
    ``parallel.moe.shard_experts``), every other leaf as it is.  A split
    dim not divisible by ``size`` raises, and so does a split int8
    weight-only leaf: the reference's specs do not shard one."""
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} not in [0, {size})")

    def cut(leaf, spec):
        d = _split_dim(spec)
        if d is None or size == 1:
            return leaf
        if is_int8_weight(leaf) or _is_leaf(leaf):
            raise NotImplementedError(
                "an int8 weight-only leaf under tensor parallelism: the "
                "reference's specs do not shard one (ROADMAP C)")
        d %= leaf.ndim
        n = leaf.shape[d]
        if n % size:
            raise ValueError(f"leaf of shape {tuple(leaf.shape)} not "
                             f"divisible by TP size {size} on dim {d}")
        c = n // size
        return leaf[(slice(None),) * d + (slice(rank * c, (rank + 1) * c),)]
    return _zip_specs(cut, tree, specs)


def gather_params(tree, specs, group=None):
    """The full parameter tree from every rank's shard (``shard_params``'
    inverse): each split leaf all-gathered over the tensor group along its
    spec's dim, every other leaf as it is.  Every rank of the group calls
    it; for the tests and for checkpoints."""
    from .tp_utils import _all_gather, get_tp_group

    group = group if group is not None else get_tp_group()

    def full(leaf, spec):
        d = _split_dim(spec)
        if d is None:
            return leaf
        with torch.no_grad():
            return _all_gather(leaf, group, d % leaf.dim(), "gather_params")
    return _zip_specs(full, tree, specs)


def spec_pairs(tree, specs):
    """``(tensor, spec)`` for every tensor of ``tree`` in
    ``obs.numerics.tree_leaves`` order (an int8 weight's or an int8
    expert pair's two tensors share the leaf's spec)."""
    out = []

    def add(leaf, spec):
        if is_int8_weight(leaf):
            out.extend(((leaf.q, spec), (leaf.scale, spec)))
        elif _is_leaf(leaf):
            out.extend((t, spec) for t in leaf)
        elif leaf is not None:
            out.append((leaf, spec))
    _zip_specs(add, tree, specs)
    return out
