"""The transformer block's math, serial — the PyTorch counterpart of
``torchdistpackage_tpu/parallel/tensor_parallel/layers.py``.

Parameters are plain dicts of tensors with the JAX package's layouts, so
the parity tests compare like with like: weights are ``[in, out]`` and
used as ``x @ w`` (not ``nn.Linear``'s ``[out, in]``), the fused QKV is
stacked ``[3, D, D]``, the GQA k/v projection ``[2, D, Dkv]`` and the
SwiGLU gate/up ``[2, D, F]``.  The norm kind and the activation are
carried by the parameter structure exactly as in the reference: a norm
without a ``bias`` leaf is RMSNorm, a 3-dim ``w1`` is SwiGLU.

Tensor parallelism is not ported yet (ROADMAP queue A): every function
here is the ``axis=None`` branch of its reference.  The training block
(:func:`block_forward`, :func:`scan_blocks`) runs its attention through
:func:`core_attention`: the plain ``'naive'`` path or the flash kernels
K3-K5 (``ops/flash_attention.py``), with residual dropout
(:func:`dropout`) when a key is given.
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

Params = Dict[str, torch.Tensor]

#: rope-scaling types the port computes; the reference's 'dynamic' and
#: 'yarn' are queued (ROADMAP queue A) and refused with a clear error
_ROPE_SCALING_TYPES = ("linear", "llama3")
_ROPE_SCALING_QUEUED = ("dynamic", "yarn")
_ATTN_IMPLS = ("naive", "flash", "ring", "ulysses")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The fields of the reference ``TransformerConfig`` that the serving
    and training paths read.  ``dtype`` is a ``torch.dtype``.
    ``attn_impl``: ``'naive'`` (the [S, S] score matrix, plain ops) or
    ``'flash'`` (kernels K3-K5); ``'ring'``/``'ulysses'`` are context
    parallel and queued (ROADMAP, queue A: "Training CP").
    ``dropout_rate``: residual dropout, applied when the caller passes a
    ``dropout_key``."""

    dim: int
    nheads: int
    nlayers: int = 2
    ffn_mult: int = 4
    causal: bool = True
    dtype: torch.dtype = torch.float32
    attn_impl: str = "naive"
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

    def __post_init__(self):
        if self.attn_impl not in _ATTN_IMPLS:
            raise ValueError(
                f"attn_impl must be one of {_ATTN_IMPLS}, got "
                f"{self.attn_impl!r}")
        if self.sliding_window is not None:
            if not self.causal:
                raise ValueError("sliding_window requires causal attention")
            if self.sliding_window < 1:
                raise ValueError(
                    f"sliding_window must be >= 1, got {self.sliding_window}")
        if self.norm not in ("layer", "rms"):
            raise ValueError(f"norm must be 'layer' or 'rms', got {self.norm!r}")
        if self.act not in ("gelu", "swiglu"):
            raise ValueError(f"act must be 'gelu' or 'swiglu', got {self.act!r}")
        if self.rope_scaling is not None:
            kind = self.rope_scaling.get(
                "rope_type", self.rope_scaling.get("type"))
            if kind in _ROPE_SCALING_QUEUED:
                raise NotImplementedError(
                    f"rope_scaling type {kind!r} is not ported yet; the port "
                    f"computes {_ROPE_SCALING_TYPES}")
            if kind not in _ROPE_SCALING_TYPES:
                raise NotImplementedError(
                    f"rope_scaling type {kind!r}; supported: "
                    f"{_ROPE_SCALING_TYPES}")
            need = {
                "linear": ("factor",),
                "llama3": ("factor", "low_freq_factor", "high_freq_factor",
                           "original_max_position_embeddings"),
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


def _scaled_inv_freq(inv_freq: torch.Tensor, scaling: dict
                     ) -> Tuple[torch.Tensor, float]:
    """The 'linear' and 'llama3' rope-scaling recipes of the reference
    (``transformers``' ``modeling_rope_utils``); returns ``(inv_freq,
    attention_factor)`` with the factor 1.0 for both."""
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
    raise NotImplementedError(f"rope_scaling type {kind!r}")


def rope_cache(pos: torch.Tensor, head_dim: int, theta: float = 10000.0,
               scaling: Optional[dict] = None):
    """(cos, sin) tables ``[1, 1, S, hd/2]`` in f32 for the positions
    ``pos`` [S] — compute once per forward and reuse in every layer."""
    if head_dim % 2:
        raise ValueError(f"rope needs an even head_dim, got {head_dim}")
    half = head_dim // 2
    inv_freq = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=pos.device) / half)
    af = 1.0
    if scaling is not None:
        inv_freq, af = _scaled_inv_freq(inv_freq, scaling)
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


def compute_qkv(p: Params, x: torch.Tensor, cfg: TransformerConfig,
                rope=None):
    """x [B, S, D] -> rope-rotated ``(q [B, H, S, hd], k, v [B, Hkv, S,
    hd])`` from either the fused ``wqkv`` layout or the GQA ``wq``/``wkv``
    layout.  ``rope`` is the (cos, sin) cache; required when
    ``cfg.rope``."""
    B, S, _ = x.shape
    hd = cfg.head_dim

    def heads(t):
        return t.reshape(B, S, -1, hd).transpose(1, 2)

    if "wqkv" in p:
        w, b = p["wqkv"], p["bqkv"]
        q, k, v = (heads(dense(x, w[i], b[i])) for i in range(3))
    else:
        if p["wkv"].shape[-1] % hd:
            raise ValueError(
                f"wkv holds {p['wkv'].shape[-1]} columns, not whole heads of "
                f"dim {hd}")
        q = heads(dense(x, p["wq"], p["bq"]))
        k = heads(dense(x, p["wkv"][0], p["bkv"][0]))
        v = heads(dense(x, p["wkv"][1], p["bkv"][1]))
    if cfg.rope:
        if rope is None:
            rope = rope_cache(torch.arange(S, device=x.device), hd,
                              cfg.rope_theta, scaling=cfg.rope_scaling)
        # q and k rotate in one pass: the same elementwise arithmetic,
        # half the kernels
        qk = apply_rope(torch.cat([q, k], dim=1), rope)
        q, k = qk.split([q.shape[1], k.shape[1]], dim=1)
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


def block_rope_cache(cfg: TransformerConfig, s: int, device):
    """The layer-invariant (cos, sin) rope cache for ``s`` sequence rows,
    or None when rope is off — computed once per forward and passed to
    every block."""
    if not cfg.rope:
        return None
    return rope_cache(torch.arange(s, device=device), cfg.head_dim,
                      cfg.rope_theta, scaling=cfg.rope_scaling)


def core_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: TransformerConfig) -> torch.Tensor:
    """(q, k, v) [B, H(kv), S, hd] -> [B, H, S, hd] through the configured
    ``attn_impl`` — the one dispatch switch, as in the reference.  The
    flash kernels take contiguous tensors, so the head-major views are
    made contiguous here."""
    from ...ops.flash_attention import flash_attention, mha_reference

    if cfg.attn_impl == "flash":
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=cfg.causal,
                               window=cfg.sliding_window)
    if cfg.attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is context-parallel attention, "
            f"not ported yet (ROADMAP, queue A: 'Training CP')")
    return mha_reference(q, k, v, causal=cfg.causal,
                         window=cfg.sliding_window)


def attention_partial(p: Params, x: torch.Tensor, cfg: TransformerConfig,
                      rope=None) -> torch.Tensor:
    """QKV projection, core attention and the output projection without
    its bias: x [B, S, D] -> [B, S, D]."""
    B, S, _ = x.shape
    q, k, v = compute_qkv(p, x, cfg, rope=rope)
    out = core_attention(q, k, v, cfg)
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


def block_forward(p: Params, x: torch.Tensor, cfg: TransformerConfig,
                  rope=None, dropout_key: Optional[int] = None
                  ) -> torch.Tensor:
    """Pre-norm block: x + attn(norm(x)) + bo, then + mlp(norm(.)) + b2.
    ``dropout_key`` turns on residual dropout at ``cfg.dropout_rate`` on
    both branches, each site with its own key."""
    k_attn = k_mlp = None
    if dropout_key is not None and cfg.dropout_rate > 0.0:
        k_attn, k_mlp = split(dropout_key)
    h = layer_norm(x, p["ln1"], cfg.norm_eps)
    x = x + dropout(attention_partial(p["attn"], h, cfg, rope=rope)
                    + p["attn"]["bo"], cfg.dropout_rate, k_attn)
    h = layer_norm(x, p["ln2"], cfg.norm_eps)
    return x + dropout(mlp_partial(p["mlp"], h) + p["mlp"]["b2"],
                       cfg.dropout_rate, k_mlp)


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
    stacked leaf that requires grad through an identity whose backward
    calls ``callback(leaf, layer, grad)`` as soon as that layer's
    backward has produced the slice's gradient — long before the stacked
    leaf's own gradient exists (it is formed once layer 0's backward is
    done).  The gradients themselves are unchanged."""
    token = _GRAD_TAP.set(callback)
    try:
        yield
    finally:
        _GRAD_TAP.reset(token)


def scan_blocks(stacked: Params, x: torch.Tensor, cfg: TransformerConfig,
                remat: RematMode = False, dropout_key: Optional[int] = None
                ) -> torch.Tensor:
    """Run ``x`` through the layer-stacked block params ([L, ...] leaves)
    — the reference's ``lax.scan`` as a Python loop.  The stacked leaves
    are unbound once (their backward is one stack, not L scatter-adds),
    and the rope cache is computed once for all layers.  ``dropout_key``
    turns on residual dropout; layer ``i`` folds ``i`` into the key, so
    layers draw distinct masks."""
    tap = _GRAD_TAP.get()

    def unbind(tree):
        if isinstance(tree, dict):
            return {k: unbind(v) for k, v in tree.items()}
        return tree, tree.unbind(0)

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        leaf, parts = tree
        if tap is None or not leaf.requires_grad:
            return parts[i]
        return _GradTap.apply(parts[i], functools.partial(tap, leaf, i))

    per_layer = unbind(stacked)
    L = len(next(tree_leaves(stacked)))
    rope = block_rope_cache(cfg, x.shape[1], x.device)
    if remat == "flash_offload":
        advice = offload_advice(cfg, tuple(x.shape), L, device=x.device)
        if advice:
            warnings.warn(advice, stacklevel=2)
    for i in range(L):
        lp = layer(per_layer, i)
        key = None if dropout_key is None else fold_in(dropout_key, i)
        x = checkpoint_block(
            lambda h, lp=lp, key=key: block_forward(
                lp, h, cfg, rope=rope, dropout_key=key), remat)(x)
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
