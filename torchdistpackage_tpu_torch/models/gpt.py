"""GPT / Llama-family model config, init and head — the PyTorch
counterpart of ``torchdistpackage_tpu/models/gpt.py`` (serial branch).

Parameters are a plain dict with the reference's tree: ``tok_emb`` [V, D],
``pos_emb`` [max_seq, D] (learned positions only), ``blocks`` with every
leaf stacked over the layer dim ``[L, ...]``, ``ln_f`` and ``head``
[D, V].  The serial training path is here: :func:`gpt_embed`,
:func:`gpt_hidden`, :func:`gpt_forward`, the cross-entropy
(:func:`vocab_parallel_xent`, :func:`streamed_head_loss`) and
:func:`gpt_loss`; the parallel paths are queued (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..parallel.tensor_parallel.layers import (
    RematMode,
    TransformerConfig,
    _normal,
    dense,
    init_block_params,
    init_norm_params,
    layer_norm,
    scan_blocks,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int
    dim: int
    nheads: int
    nlayers: int
    max_seq: int
    ffn_mult: int = 4
    causal: bool = True
    dtype: torch.dtype = torch.float32
    # 'naive' (plain score matrix) | 'flash' (kernels K3-K5)
    attn_impl: str = "naive"
    dropout_rate: float = 0.0  # refused above 0 until dropout is ported
    kv_heads: Optional[int] = None
    # 'learned' (table added at embed) | 'rope' (q/k rotated in attention)
    pos: str = "learned"
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    norm: str = "layer"
    act: str = "gelu"
    ffn_hidden: Optional[int] = None
    norm_eps: float = 1e-5
    sliding_window: Optional[int] = None
    # Mixture-of-Experts (0 = dense model).  With ``moe_experts > 0`` every
    # ``moe_every``-th block's FFN is an expert layer (``models/gpt_moe.py``
    # builds the per-block list); serving runs it (``paged_forward_moe``),
    # MoE training is not ported yet (ROADMAP queue A).
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    # 'topk' only for this causal family: 'expert_choice' ranks the whole
    # sequence per expert (a future-token leak), refused as in the reference
    moe_router: str = "topk"
    moe_dispatch: str = "auto"  # 'gather' | 'cuda' | 'auto' (see MoEConfig)

    def __post_init__(self):
        if not isinstance(self.dtype, torch.dtype):
            raise TypeError(f"dtype must be a torch.dtype, got {self.dtype!r}")
        if self.pos not in ("learned", "rope"):
            raise ValueError(f"pos must be 'learned' or 'rope', got {self.pos!r}")
        if self.moe_experts < 0 or self.moe_every < 1:
            raise ValueError(
                f"moe_experts must be >= 0 and moe_every >= 1, got "
                f"{self.moe_experts} / {self.moe_every}")
        if self.moe_experts and self.moe_router == "expert_choice" \
                and self.causal:
            raise ValueError(
                "moe_router='expert_choice' is incompatible with a causal "
                "model: each expert picks its top tokens over the whole "
                "sequence, so token t's routing depends on tokens > t. Use "
                "moe_router='topk'.")
        self.block  # validates the block fields
        if self.moe_experts:
            from ..models.gpt_moe import moe_layer_config

            moe_layer_config(self)  # validates the MoE fields

    @property
    def block(self) -> TransformerConfig:
        return TransformerConfig(
            dim=self.dim, nheads=self.nheads, nlayers=self.nlayers,
            ffn_mult=self.ffn_mult, causal=self.causal, dtype=self.dtype,
            attn_impl=self.attn_impl, dropout_rate=self.dropout_rate,
            kv_heads=self.kv_heads, rope=self.pos == "rope",
            rope_theta=self.rope_theta, rope_scaling=self.rope_scaling,
            norm=self.norm, act=self.act, ffn_hidden=self.ffn_hidden,
            norm_eps=self.norm_eps, sliding_window=self.sliding_window)

    def num_params(self) -> int:
        D, V, L = self.dim, self.vocab_size, self.nlayers
        Fd = self.block.ffn_dim
        if self.kv_heads is not None and self.kv_heads != self.nheads:
            Dkv = self.kv_heads * (D // self.nheads)
            attn = (D * D + D) + (2 * D * Dkv + 2 * Dkv)
        else:
            attn = 3 * D * D + 3 * D
        mlp = (3 * D * Fd + 2 * Fd + D) if self.act == "swiglu" else (
            2 * D * Fd + Fd + D)
        norm = D if self.norm == "rms" else 2 * D
        per_block = attn + D * D + D + 2 * norm
        # an expert block carries the router [D, E] and E expert MLPs of the
        # dense MLP's shape in place of the one MLP
        n_moe = sum(1 for i in range(L) if self.moe_experts
                    and i % self.moe_every == self.moe_every - 1)
        ffn = ((L - n_moe) * mlp
               + n_moe * (D * self.moe_experts + self.moe_experts * mlp))
        pos = self.max_seq * D if self.pos == "learned" else 0
        return V * D + pos + L * per_block + ffn + norm + D * V


def llama_config(
    vocab_size: int, dim: int, nheads: int, nlayers: int, max_seq: int,
    kv_heads: Optional[int] = None, ffn_hidden: Optional[int] = None,
    rope_theta: float = 10000.0, rope_scaling: Optional[dict] = None,
    dtype: torch.dtype = torch.bfloat16, **kw,
) -> GPTConfig:
    """Llama-family preset: RMSNorm + SwiGLU + RoPE (+ GQA when
    ``kv_heads`` is set).  ``ffn_hidden`` defaults to ceil(8d/3) rounded
    up to a multiple of 256.  Like the reference it keeps zero bias
    leaves, so trees map leaf for leaf."""
    if ffn_hidden is None:
        ffn_hidden = -(-8 * dim // 3)
        ffn_hidden = -(-ffn_hidden // 256) * 256
    return GPTConfig(
        vocab_size=vocab_size, dim=dim, nheads=nheads, nlayers=nlayers,
        max_seq=max_seq, kv_heads=kv_heads, ffn_hidden=ffn_hidden,
        pos="rope", rope_theta=rope_theta, rope_scaling=rope_scaling,
        norm="rms", act="swiglu", dtype=dtype, **kw)


def mistral_7b_config() -> GPTConfig:
    """The published Mistral-7B-v0.1 (its ``config.json``), in bf16:
    hidden 4096, 32 layers, 32 query / 8 KV heads of dim 128, SwiGLU
    14336, vocab 32000, 32768 positions, RMSNorm eps 1e-5, RoPE theta
    10000, sliding window 4096."""
    return llama_config(
        vocab_size=32000, dim=4096, nheads=32, nlayers=32, max_seq=32768,
        kv_heads=8, ffn_hidden=14336, rope_theta=10000.0, norm_eps=1e-5,
        sliding_window=4096, dtype=torch.bfloat16)


def mixtral_8x7b_config(nlayers: int = 32) -> GPTConfig:
    """The published Mixtral-8x7B-v0.1 (its ``config.json``), in bf16:
    hidden 4096, 32 query / 8 KV heads of dim 128, SwiGLU experts of
    14336, 8 experts with top-2 routing in every layer, vocab 32000,
    32768 positions, RoPE theta 1e6, RMSNorm eps 1e-5, no sliding window.
    ``nlayers`` cuts the depth (32 published; 46.7 B parameters there)."""
    return llama_config(
        vocab_size=32000, dim=4096, nheads=32, nlayers=nlayers,
        max_seq=32768, kv_heads=8, ffn_hidden=14336, rope_theta=1e6,
        norm_eps=1e-5, dtype=torch.bfloat16, moe_experts=8, moe_top_k=2,
        moe_every=1)


# ------------------------------------------------------------------ model


def vocab_parallel_embed(tok_emb: torch.Tensor,
                         tokens: torch.Tensor) -> torch.Tensor:
    """Token lookup [B, S] -> [B, S, D] (the serial branch; the
    vocab-sharded lookup waits for tensor parallelism)."""
    return tok_emb[tokens]


def gpt_head(params: Params, h: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """Final norm + LM head: [B, S, D] -> logits [B, S, V]."""
    return dense(layer_norm(h, params["ln_f"], eps), params["head"])


def vocab_parallel_xent(logits: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy of ``logits`` [..., V] against int
    ``targets`` [...] (the serial branch: ``mean(logsumexp - target
    logit)``).  The log-sum-exp runs in f32 whatever the logits' dtype."""
    V = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, V).float(),
                           targets.reshape(-1))


def gpt_embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """[B, S] ids -> [B, S, D]: the token lookup, plus the learned
    position table when the config has one (rope enters in attention)."""
    h = vocab_parallel_embed(params["tok_emb"], tokens)
    if "pos_emb" not in params:
        return h
    return h + params["pos_emb"][:tokens.shape[-1]]


def gpt_hidden(params: Params, tokens: torch.Tensor, cfg: GPTConfig,
               remat: RematMode = False) -> torch.Tensor:
    """tokens [B, S] -> hidden after the block stack [B, S, D] (before
    the final norm).  ``remat``: False | True | 'flash' — see
    :func:`..parallel.tensor_parallel.layers.scan_blocks`."""
    h = gpt_embed(params, tokens)
    return scan_blocks(params["blocks"], h, cfg.block, remat=remat)


def gpt_forward(params: Params, tokens: torch.Tensor, cfg: GPTConfig,
                remat: RematMode = False) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V]."""
    h = gpt_hidden(params, tokens, cfg, remat=remat)
    return gpt_head(params, h, eps=cfg.norm_eps)


def streamed_head_loss(params: Params, h: torch.Tensor,
                       targets: torch.Tensor, chunk: int = 256,
                       eps: float = 1e-5) -> torch.Tensor:
    """Final norm + head + cross-entropy over sequence chunks of
    ``chunk``: each [B, chunk, V] slab is formed, reduced and dropped,
    and recomputed in the backward (checkpointed per chunk), so the full
    [B, S, V] logits never exist.  Equal chunks: the mean of chunk means
    is the token mean."""
    h = layer_norm(h, params["ln_f"], eps)
    S = h.shape[1]
    if S % chunk:
        raise ValueError(
            f"sequence length {S} not divisible by xent_chunk {chunk} — "
            f"the fallback would materialize the full logits the caller "
            f"opted out of")

    def body(hh, tt):
        return vocab_parallel_xent(dense(hh, params["head"]), tt)

    n = S // chunk
    total = h.new_zeros((), dtype=torch.float32)
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(body, h[:, sl], targets[:, sl],
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    return total / n


def gpt_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: GPTConfig,
             remat: RematMode = False,
             xent_chunk: Optional[int] = None) -> torch.Tensor:
    """Mean next-token cross-entropy.  ``batch``: {'tokens': [B, S],
    'targets': [B, S]}.  ``xent_chunk`` streams the head and the loss
    over sequence chunks of that size (:func:`streamed_head_loss`)."""
    if xent_chunk is not None:
        h = gpt_hidden(params, batch["tokens"], cfg, remat=remat)
        return streamed_head_loss(params, h, batch["targets"],
                                  chunk=xent_chunk, eps=cfg.norm_eps)
    logits = gpt_forward(params, batch["tokens"], cfg, remat=remat)
    return vocab_parallel_xent(logits, batch["targets"])


def init_gpt_params(cfg: GPTConfig, gen: Optional[torch.Generator] = None,
                    device=None) -> Params:
    """Random parameters drawn from ``gen`` on ``device`` (default: the
    card).  The block leaves are stacked over the layer dim, filled one
    layer at a time so peak memory stays at the model plus one block."""
    if cfg.moe_experts:
        raise ValueError(
            "an MoE config has a per-block list: use "
            "models.gpt_moe.init_gpt_moe_params")
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    D, V, dt = cfg.dim, cfg.vocab_size, cfg.dtype
    out: Params = {"tok_emb": _normal((V, D), 0.02, dt, gen, dev)}
    if cfg.pos == "learned":
        out["pos_emb"] = _normal((cfg.max_seq, D), 0.02, dt, gen, dev)
    blocks = None
    for layer in range(cfg.nlayers):
        bp = init_block_params(gen, cfg.block, device=dev)
        if blocks is None:
            blocks = _map(lambda a: torch.empty(
                (cfg.nlayers,) + tuple(a.shape), dtype=a.dtype, device=dev),
                bp)
        _zip_apply(lambda dst, src: dst[layer].copy_(src), blocks, bp)
    out["blocks"] = blocks
    out["ln_f"] = init_norm_params(D, dt, cfg.norm, dev)
    out["head"] = _normal((D, V), 1.0 / math.sqrt(D), dt, gen, dev)
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _zip_apply(fn, a, b) -> None:
    if isinstance(a, dict):
        for k in a:
            _zip_apply(fn, a[k], b[k])
    else:
        fn(a, b)


def layer_params(params: Params, layer: int) -> Params:
    """Layer ``layer``'s block params as views of the stacked leaves."""
    return _map(lambda a: a[layer], params["blocks"])
