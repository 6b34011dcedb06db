"""The cached transformer block behind paged serving — the PyTorch
counterpart of the parts of ``torchdistpackage_tpu/models/generate.py``
that the serving engine runs: ``_kv_quant``, ``_cached_attention``,
``cached_block_forward`` (its ``cache_ops`` branch) and ``_embed_at``.

The contiguous-cache ``generate()`` loop and its flash prefill are not
ported yet (ROADMAP queue A); the serving path never reaches them,
because with ``cache_ops`` set attention always goes through the paged
``attend``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..parallel.tensor_parallel.layers import (
    TransformerConfig,
    compute_qkv,
    dense,
    layer_norm,
    mlp_partial,
)
from .gpt import vocab_parallel_embed

KV = Any  # a tensor, or an int8 ``(q8, scale)`` pair


def _kv_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., hd] -> (int8 [..., hd], f32 scale [...]): symmetric
    per-vector, ``scale = max(amax, 1e-30) / 127``.  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-30) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _cached_attention(q: torch.Tensor, ck: KV, cv: KV, offset,
                      window: Optional[int] = None) -> torch.Tensor:
    """Grouped-query attention of q [B, H, S_in, hd] against the dense
    cache ck/cv [B, Hkv, T, hd] (or int8 pairs), masked to ``key_pos <=
    offset + row`` (and ``> qpos - window``); ``offset`` is a scalar or a
    [B] tensor.  f32 softmax, ``1/sqrt(hd)`` scale, the int8 k-scale
    folded into the scores and the v-scale into the probabilities.

    Scores are formed in f32 from the stored values (what the TPU kernel
    does with ``preferred_element_type=f32``).  On f32 inputs this is the
    reference's arithmetic; on bf16 inputs the reference's einsum rounds
    the scores to bf16 first, which this oracle does not."""
    B, H, S_in, hd = q.shape
    k_scale = v_scale = None
    if isinstance(ck, tuple):
        ck, k_scale = ck
    if isinstance(cv, tuple):
        cv, v_scale = cv
    Hkv, T = ck.shape[1], ck.shape[2]
    g = H // Hkv
    # group-major rows r = g*S_in + s against the shared KV head: one
    # matmul per (b, kv head), no repeated keys
    qr = q.reshape(B, Hkv, g * S_in, hd).float()
    s = (qr @ ck.float().transpose(-1, -2)).view(B, Hkv, g, S_in, T)
    if k_scale is not None:
        s = s * k_scale[:, :, None, None, :]
    s = s * (1.0 / math.sqrt(hd))
    key_pos = torch.arange(T, device=q.device)
    off = torch.as_tensor(offset, device=q.device)
    qpos = off[..., None] + torch.arange(S_in, device=q.device)
    mask = key_pos <= qpos[..., None]
    if window is not None:  # Mistral: key in (qpos - window, qpos]
        mask = mask & (key_pos > qpos[..., None] - window)
    if mask.dim() == 2:  # scalar offset: broadcast over the batch
        mask = mask[None]
    s = torch.where(mask[:, None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale[:, :, None, None, :]
        out = (p.view(B, Hkv, g * S_in, T) @ cv.float()).to(q.dtype)
    else:
        out = p.to(cv.dtype).view(B, Hkv, g * S_in, T) @ cv
    return out.reshape(B, H, S_in, hd)


def cached_block_forward(p: Dict[str, Any], x: torch.Tensor,
                         cfg: TransformerConfig, ck: KV, cv: KV, offset, *,
                         cache_ops, rope=None,
                         ffn=None) -> Tuple[torch.Tensor, KV, KV]:
    """One pre-norm block with KV caching through ``cache_ops = (write,
    attend)``: this call's k/v are written into the cache first, then the
    queries attend against it — so the chunk's own keys are read back
    from the cache.  x [B, S_in, D]; returns ``(y, ck, cv)``.

    ``ffn``: optional ``(p, h) -> z`` replacing the dense MLP half (``h``
    the post-ln2 activation, ``z`` the complete FFN output) — how the MoE
    family plugs its expert layer into the same block."""
    B, S_in, _ = x.shape
    write, attend = cache_ops
    h = layer_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = compute_qkv(p["attn"], h, cfg, rope=rope)
    ck = write(ck, k, offset)
    cv = write(cv, v, offset)
    out = attend(q, ck, cv, offset, window=cfg.sliding_window)
    out = out.transpose(1, 2).reshape(B, S_in, q.shape[1] * cfg.head_dim)
    x = x + dense(out, p["attn"]["wo"], p["attn"]["bo"])
    h = layer_norm(x, p["ln2"], cfg.norm_eps)
    if ffn is None:
        z = mlp_partial(p["mlp"], h) + p["mlp"]["b2"]
    else:
        z = ffn(p, h)
    return x + z, ck, cv


def _embed_at(params: Dict[str, Any], tokens: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """[B, S_in] ids at the given global positions -> [B, S_in, D]."""
    h = vocab_parallel_embed(params["tok_emb"], tokens)
    if "pos_emb" in params:  # learned positions; rope models skip this
        h = h + params["pos_emb"][positions]
    return h
