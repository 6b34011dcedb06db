"""GPT / Llama-family model config, init and head — the PyTorch
counterpart of ``torchdistpackage_tpu/models/gpt.py`` (serial branch).

Parameters are a plain dict with the reference's tree: ``tok_emb`` [V, D],
``pos_emb`` [max_seq, D] (learned positions only), ``blocks`` with every
leaf stacked over the layer dim ``[L, ...]``, ``ln_f`` and ``head``
[D, V].  The training forward, the loss and the parallel paths are not
ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from ..device import resolve_device
from ..parallel.tensor_parallel.layers import (
    TransformerConfig,
    _normal,
    dense,
    init_block_params,
    init_norm_params,
    layer_norm,
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
    # Mixture-of-Experts is not ported yet: any value > 0 is refused
    moe_experts: int = 0

    def __post_init__(self):
        if not isinstance(self.dtype, torch.dtype):
            raise TypeError(f"dtype must be a torch.dtype, got {self.dtype!r}")
        if self.pos not in ("learned", "rope"):
            raise ValueError(f"pos must be 'learned' or 'rope', got {self.pos!r}")
        if self.moe_experts:
            raise NotImplementedError(
                "MoE families are not ported yet (ROADMAP queue A)")
        self.block  # validates the block fields

    @property
    def block(self) -> TransformerConfig:
        return TransformerConfig(
            dim=self.dim, nheads=self.nheads, nlayers=self.nlayers,
            ffn_mult=self.ffn_mult, causal=self.causal, dtype=self.dtype,
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
        per_block = attn + D * D + D + mlp + 2 * norm
        pos = self.max_seq * D if self.pos == "learned" else 0
        return V * D + pos + L * per_block + norm + D * V


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


def init_gpt_params(cfg: GPTConfig, gen: Optional[torch.Generator] = None,
                    device=None) -> Params:
    """Random parameters drawn from ``gen`` on ``device`` (default: the
    card).  The block leaves are stacked over the layer dim, filled one
    layer at a time so peak memory stays at the model plus one block."""
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
