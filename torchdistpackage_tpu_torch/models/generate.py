"""KV-cache generation for the GPT / Llama and MoE families — the PyTorch
counterpart of ``torchdistpackage_tpu/models/generate.py``.

- The contiguous cache: :func:`init_kv_cache` (JAX :57) holds ``[L, B,
  Hkv, max_len, hd]`` buffers (or int8 ``(q8, scale)`` pairs) on the
  device, and :func:`_cache_write` (:100) writes each call's k/v into
  them in place by slice assignment at ``offset``.
- One cached block serves prefill and decode
  (:func:`cached_block_forward`, :164): a prefill at a Python-int offset
  0 attends through ``layers.core_attention`` (flash, kernel K3, on the
  card when ``cfg.attn_impl == 'flash'``; any prompt length), every other
  call through :func:`_cached_attention` over the whole buffer with a
  position mask.  The serving engine passes its paged ``cache_ops``.
- :func:`forward_cached` (:239) and :func:`forward_cached_moe` (:283)
  run the stack; :func:`generate` (:428), :func:`speculative_generate`
  (:521) and :func:`beam_generate` (:635) are the decoding loops, and
  :func:`_sample` (:374) the sampler.

Tensor parallelism (``tp_group``, the reference's ``axis``): each rank
holds its shard (``models.gpt.shard_gpt_params``: ``Hkv / tp`` KV heads
of the cache, ``V / tp`` vocabulary rows and columns), every block closes
its row-parallel products with ``reduce_from_tp``, and the step's
vocabulary slices are all-gathered into the full logits
(:func:`_full_logits`) before sampling; every rank takes the group's
rank 0's token.  ``speculative_generate`` and ``beam_generate`` take no
group, as in the reference.

Where JAX jits one ``lax.scan`` of decode steps, the port runs a Python
loop of single-token steps on the device; positions are host integers,
so a step reads nothing back (``speculative_generate`` reads one count a
macro step, to move its host position).  Sampling draws from a
``torch.Generator``, so sampled tokens are not JAX's threefry draws;
greedy tokens are the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..obs.comm_ledger import note
from ..parallel.tensor_parallel.layers import (
    TransformerConfig,
    _close_row_parallel,
    compute_qkv,
    core_attention,
    dense,
    layer_norm,
    mlp_partial,
    rope_cache,
)
from ..parallel.tensor_parallel.tp_utils import (
    gather_vocab,
    tp_size,
)
from .gpt import GPTConfig, gpt_head, layer_params, vocab_parallel_embed

KV = Any  # a tensor, or an int8 ``(q8, scale)`` pair


def init_kv_cache(cfg: GPTConfig, batch: int, max_len: int,
                  quantized: bool = False, device=None,
                  axis_size: int = 1) -> Dict[str, Any]:
    """Zeroed cache ``{'k', 'v': [L, B, Hkv / axis_size, max_len, hd]}``
    in ``cfg.dtype`` on ``device`` (default: the card), JAX :57;
    ``axis_size`` is the tensor-parallel size (whole KV heads a rank).
    ``quantized=True``: each entry is an int8 ``(q8, scale [L, B, Hkv,
    max_len] f32)`` pair with unit scales, one scale per written
    position-vector."""
    device = resolve_device(device)
    hkv, rem = divmod(cfg.block.kv_head_count, axis_size)
    if rem or hkv == 0:
        raise ValueError(
            f"kv_heads {cfg.block.kv_head_count} not divisible by tp "
            f"{axis_size} (whole KV heads per shard)")
    shape = (cfg.nlayers, batch, hkv, max_len, cfg.block.head_dim)
    if quantized:
        def entry():
            return (torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.ones(shape[:-1], dtype=torch.float32,
                               device=device))
        return {"k": entry(), "v": entry()}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _kv_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., hd] -> (int8 [..., hd], f32 scale [...]): symmetric
    per-vector, ``scale = max(amax, 1e-30) / 127``.  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-30) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _cache_write(c: KV, val: torch.Tensor, offset: int) -> KV:
    """Write ``val`` [B, Hkv, S_in, hd] into one layer's cache ``c`` ([B,
    Hkv, T, hd] or its int8 ``(q8, scale)`` pair, quantised here by
    :func:`_kv_quant`) at positions ``[offset, offset + S_in)``, in place
    (JAX :100, ``dynamic_update_slice``); returns ``c``."""
    S_in = val.shape[2]
    if isinstance(c, tuple):
        q8, scale = c
        vq, vs = _kv_quant(val)
        q8[:, :, offset:offset + S_in] = vq
        scale[:, :, offset:offset + S_in] = vs
        return c
    c[:, :, offset:offset + S_in] = val.to(c.dtype)
    return c


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
                         cache_ops=None, rope=None, ffn=None,
                         tp_group=None) -> Tuple[torch.Tensor, KV, KV]:
    """One pre-norm block with KV caching (JAX :164): this call's k/v are
    written into the cache first, then the queries attend against it.  x
    [B, S_in, D]; returns ``(y, ck, cv)``.

    ``cache_ops = (write, attend)`` picks the cache layout; None is the
    contiguous buffer, ``(_cache_write, _cached_attention)``.  There, a
    prefill (``offset`` the Python int 0, ``S_in > 1``) attends over this
    call's (q, k, v) through ``core_attention`` — flash (K3) on the card
    under ``attn_impl='flash'``, at any prompt length — since every key
    the cache then holds is this call's own.  ``ffn``: optional ``(p, h)
    -> z`` replacing the dense MLP half (``h`` the post-ln2 activation,
    ``z`` the complete FFN output) — how the MoE family plugs its expert
    layer into the same block.  The biases ``bo`` and ``b2`` are added
    where the serial ``_close_row_parallel`` adds them.  ``tp_group``
    (forward only): ``p`` is the rank's shard and the cache holds its
    KV heads; each row-parallel product is summed over the group before
    its bias is added."""
    B, S_in, _ = x.shape
    write, attend = (cache_ops if cache_ops is not None
                     else (_cache_write, _cached_attention))
    h = layer_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = compute_qkv(p["attn"], h, cfg, rope=rope)
    ck = write(ck, k, offset)
    cv = write(cv, v, offset)
    if (cache_ops is None and isinstance(offset, int) and offset == 0
            and S_in > 1):
        out = core_attention(q, k, v, cfg)
    else:
        out = attend(q, ck, cv, offset, window=cfg.sliding_window)
    out = out.transpose(1, 2).reshape(B, S_in, q.shape[1] * cfg.head_dim)
    x = x + _close_row_parallel(dense(out, p["attn"]["wo"]),
                                p["attn"]["bo"], tp_group, False)
    h = layer_norm(x, p["ln2"], cfg.norm_eps)
    if ffn is None:
        z = _close_row_parallel(mlp_partial(p["mlp"], h), p["mlp"]["b2"],
                                tp_group, False)
    else:
        z = ffn(p, h)
    return x + z, ck, cv


def _embed_at(params: Dict[str, Any], tokens: torch.Tensor,
              positions: torch.Tensor, tp_group=None) -> torch.Tensor:
    """[B, S_in] ids at the given global positions -> [B, S_in, D]."""
    h = vocab_parallel_embed(params["tok_emb"], tokens, tp_group)
    if "pos_emb" in params:  # learned positions; rope models skip this
        h = h + params["pos_emb"][positions]
    return h


def _layer_cache(c: KV, layer: int) -> KV:
    return tuple(t[layer] for t in c) if isinstance(c, tuple) else c[layer]


def _rope_at(bcfg: TransformerConfig, offset: int, S_in: int, device):
    """(cos, sin) at the global positions ``offset + arange(S_in)``."""
    if not bcfg.rope:
        return None
    positions = offset + torch.arange(S_in, device=device)
    return rope_cache(positions, bcfg.head_dim, bcfg.rope_theta,
                      scaling=bcfg.rope_scaling)


def _embed(params, tokens: torch.Tensor, offset: int,
           tp_group=None) -> torch.Tensor:
    positions = offset + torch.arange(tokens.shape[1], device=tokens.device)
    return _embed_at(params, tokens.long(), positions, tp_group)


def _head(params, h: torch.Tensor, cfg: GPTConfig, all_logits: bool,
          tp_group=None) -> torch.Tensor:
    """The LAST row's logits [B, V] (every row's [B, S_in, V] with
    ``all_logits``); this rank's vocabulary slice under ``tp_group``."""
    if all_logits:
        return gpt_head(params, h, eps=cfg.norm_eps, tp_group=tp_group)
    return gpt_head(params, h[:, -1:], eps=cfg.norm_eps,
                    tp_group=tp_group)[:, 0]


def forward_cached(params: Dict[str, Any], tokens: torch.Tensor,
                   cfg: GPTConfig, cache: Dict[str, Any], offset: int,
                   all_logits: bool = False, tp_group=None
                   ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Run ``tokens`` [B, S_in] (at global positions ``offset +
    arange(S_in)``) through the cached stack (JAX :239; a loop over
    ``layer_params`` where JAX scans).  The cache is written in place and
    returned with the LAST position's logits [B, V], or every position's
    [B, S_in, V] with ``all_logits`` (the speculative verify).  With
    ``tp_group`` (JAX's ``axis``) ``params`` and the cache are the rank's
    shard and the logits its vocabulary slice [..., V / tp]
    (:func:`_full_logits` gathers them)."""
    h = _embed(params, tokens, offset, tp_group)
    rope = _rope_at(cfg.block, offset, tokens.shape[1], tokens.device)
    for layer in range(cfg.nlayers):
        h, _, _ = cached_block_forward(
            layer_params(params, layer), h, cfg.block,
            _layer_cache(cache["k"], layer), _layer_cache(cache["v"], layer),
            offset, rope=rope, tp_group=tp_group)
    return cache, _head(params, h, cfg, all_logits, tp_group)


def forward_cached_moe(params: Dict[str, Any], tokens: torch.Tensor,
                       cfg: GPTConfig, cache: Dict[str, Any], offset: int,
                       ep_group=None, moe_dispatch: Optional[str] = None,
                       all_logits: bool = False, tp_group=None
                       ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """:func:`forward_cached` for the MoE family (JAX :283; the block list
    of ``init_gpt_moe_params``).  Routing is exact no-drop top-k, so token
    t's output never depends on what other tokens routed and incremental
    decode equals the full forward.

    - Serial: every expert layer is ``parallel.moe.moe_serve_forward``
      with the serving dispatch (``serving.paged_cache.
      resolve_serving_dispatch``: K6 on the card, the ragged arm on the
      CPU; ``moe_dispatch`` overrides ``cfg.moe_dispatch``).
    - ``ep_group`` (the port's ``ep_axis``; each rank holds its share of
      the experts, ``models.shard_moe_params``): ``moe_forward``'s
      exchange at the no-drop capacity ``max(cf, E / top_k)``, K7 on the
      card, token-major priority for a causal model.

    - ``tp_group`` (JAX's ``axis``): attention, the embedding and the
      head are the rank's shard (``models.gpt_moe.gpt_moe_param_specs``),
      the router and the experts replicated over the tensor group.
      Alone, every expert layer runs whole on every rank as it does
      serially; with ``ep_group`` (JAX's ``axis`` with ``ep_axis``: the
      ``moe_ep`` group of this tensor rank, ``models.shard_moe_params(...,
      tp_rank=, tp_size=)``) each tensor rank runs the exchange over its
      own expert group, on the activations the attention's all-reduce
      left the same on every tensor rank — the all-reduce first, then
      the exchange, in every layer, on every rank.

    ``all_logits`` as in :func:`forward_cached` (JAX's has none; the port
    uses it to teacher-force an MoE sequence)."""
    from ..parallel.moe import moe_forward, moe_serve_forward
    from ..serving.paged_cache import resolve_serving_dispatch
    from .gpt_moe import moe_layer_config

    bcfg = cfg.block
    mcfg = moe_layer_config(cfg)
    disp = resolve_serving_dispatch(
        mcfg.dispatch if moe_dispatch is None else moe_dispatch,
        tokens.device, ep=ep_group is not None)
    mcfg = dataclasses.replace(
        mcfg, dispatch=disp, capacity_factor=max(
            mcfg.capacity_factor, mcfg.num_experts / mcfg.top_k))

    def moe_ffn(p, hh):
        if ep_group is None:
            return moe_serve_forward(p["moe"], hh, mcfg, dispatch=disp)
        return moe_forward(p["moe"], hh, mcfg, ep_group=ep_group,
                           causal=bcfg.causal)[0]

    h = _embed(params, tokens, offset, tp_group)
    rope = _rope_at(bcfg, offset, tokens.shape[1], tokens.device)
    for layer, bp in enumerate(params["blocks"]):
        h, _, _ = cached_block_forward(
            bp, h, bcfg, _layer_cache(cache["k"], layer),
            _layer_cache(cache["v"], layer), offset, rope=rope,
            ffn=moe_ffn if "moe" in bp else None, tp_group=tp_group)
    return cache, _head(params, h, cfg, all_logits, tp_group)


def _full_logits(logits: torch.Tensor, cfg: GPTConfig, tp_group=None):
    """Vocab-local logits [..., V / tp] -> full [..., V] (JAX :359): the
    group's slices all-gathered in rank order; the identity when
    serial."""
    if tp_group is None:
        return logits
    full = gather_vocab(logits, tp_group)
    if full.shape[-1] != cfg.vocab_size:
        raise ValueError(f"gathered {full.shape[-1]} logits, vocab "
                         f"{cfg.vocab_size}")
    return full


def _agree(tok: torch.Tensor, tp_group) -> torch.Tensor:
    """Every rank of the group takes rank 0's tokens (the reference's
    ``pmax``), so the ranks feed the same next step."""
    if tp_group is not None:
        note("broadcast", tok, tp_group)
        dist.broadcast(tok, src=dist.get_global_rank(tp_group, 0),
                       group=tp_group)
    return tok


def _sample_filter(logits: torch.Tensor, temperature: float,
                   top_k: Optional[int] = None,
                   top_p: Optional[float] = None) -> torch.Tensor:
    """The sampler's filtered f32 logits (JAX ``_sample`` :374-423):
    temperature -> top-k -> top-p, masked entries -inf; top-p keeps the
    smallest prefix of the probability-sorted vocab whose mass reaches
    ``top_p``, rank 0 always."""
    x = logits.float() / temperature
    V = x.shape[-1]
    neg = float("-inf")
    need_k = top_k is not None and top_k < V
    need_p = top_p is not None and top_p < 1.0
    if need_k and not need_p:
        kth = torch.topk(x, top_k, dim=-1).values[..., -1:]
        x = torch.where(x < kth, neg, x)
    elif need_k or need_p:
        sorted_x = torch.sort(x, dim=-1, descending=True).values
        if need_k:
            x = torch.where(x < sorted_x[..., top_k - 1:top_k], neg, x)
            ranks = torch.arange(V, device=x.device)
            sorted_x = torch.where(ranks < top_k, sorted_x, neg)
        if need_p:
            cum = torch.cumsum(torch.softmax(sorted_x, dim=-1), dim=-1)
            keep = torch.roll(cum, 1, dims=-1)
            keep[..., 0] = 0.0
            keep = keep < top_p
            keep[..., 0] = True
            cutoff = torch.where(keep, sorted_x, float("inf")).min(
                dim=-1, keepdim=True).values
            x = torch.where(x < cutoff, neg, x)
    return x


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: float, top_k: Optional[int] = None,
            top_p: Optional[float] = None) -> torch.Tensor:
    """[B, V] logits -> [B] tokens (JAX :374): the argmax when no
    ``generator`` is given or ``temperature == 0``, else one draw a row
    (``torch.multinomial`` from ``generator``) from the
    :func:`_sample_filter` distribution.  top_k < 1 and temperature < 0
    raise, as in the reference."""
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if generator is None or temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    probs = torch.softmax(_sample_filter(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


_CP_DECODE = ("context-parallel decode is not supported: the KV cache is "
              "not sequence-sharded. attn_impl is a runtime choice — decode "
              "a CP-trained checkpoint with dataclasses.replace(cfg, "
              "attn_impl='flash', context_axis=None)")


def _check_decode(cfg: GPTConfig, max_new_tokens: int, total: int,
                  what: str = "P + max_new_tokens") -> None:
    if cfg.attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(_CP_DECODE)
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if cfg.pos == "learned" and total > cfg.max_seq:
        raise ValueError(f"{what} = {total} exceeds the learned position "
                         f"table ({cfg.max_seq})")


@torch.no_grad()
def generate(params: Dict[str, Any], prompt: torch.Tensor, cfg: GPTConfig,
             max_new_tokens: int, tp_group=None,
             generator: Optional[torch.Generator] = None,
             temperature: float = 1.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, ep_group=None,
             kv_quant: bool = False, device=None) -> torch.Tensor:
    """Extend ``prompt`` [B, P] by ``max_new_tokens`` (JAX :428); returns
    [B, P + max_new_tokens] int64, the prompt included.  Greedy without a
    ``generator`` (or at temperature 0), else temperature / top-k / top-p
    sampling, each step drawing from ``generator`` in turn.  One prefill
    call (flash attention over the prompt under ``attn_impl='flash'``),
    then single-token steps against the contiguous cache (int8 with
    ``kv_quant``).  MoE configs run :func:`forward_cached_moe`; its
    experts sharded over ``ep_group`` with one (the port's ``ep_axis``).
    ``device``: where the cache and the tokens live (default: the card;
    ``params`` must be there).  ``tp_group`` (JAX's ``axis``): ``params``
    is the rank's shard (``shard_gpt_params``), the cache holds ``Hkv /
    tp`` heads, and each step gathers the full logits and takes the
    group's rank 0's token, so every rank returns the same tokens.  Both
    groups at once serve TP x EP (``models.shard_moe_params(..., tp_rank=,
    tp_size=)``; :func:`forward_cached_moe`): each expert-parallel rank
    runs its own prompt rows, as it does without ``tp_group``, and its
    tensor ranks take their rank 0's token."""
    if ep_group is not None and not cfg.moe_experts:
        raise ValueError("ep_group is only meaningful for MoE configs")
    B, P = prompt.shape
    total = P + max_new_tokens
    _check_decode(cfg, max_new_tokens, total)
    dev = resolve_device(device)
    if cfg.moe_experts:
        def fwd(tok, cache, off):
            return forward_cached_moe(params, tok, cfg, cache, off,
                                      ep_group=ep_group, tp_group=tp_group)
    else:
        def fwd(tok, cache, off):
            return forward_cached(params, tok, cfg, cache, off,
                                  tp_group=tp_group)

    def sample(logits):
        return _agree(_sample(_full_logits(logits, cfg, tp_group), generator,
                              temperature, top_k, top_p), tp_group)

    tp = 1 if tp_group is None else tp_size(tp_group)
    cache = init_kv_cache(cfg, B, total, quantized=kv_quant, device=dev,
                          axis_size=tp)
    tokens = torch.zeros(B, total, dtype=torch.long, device=dev)
    tokens[:, :P] = prompt.to(dev)
    cache, logits = fwd(tokens[:, :P], cache, 0)
    tokens[:, P] = sample(logits)
    for pos in range(P, total - 1):  # the position of the token fed
        cache, logits = fwd(tokens[:, pos:pos + 1], cache, pos)
        tokens[:, pos + 1] = sample(logits)
    return tokens


def _spec_macro_step(params, draft_params, cfg: GPTConfig, dcfg: GPTConfig,
                     tokens: torch.Tensor, cache_v, cache_d, t: int, K: int):
    """One macro step of :func:`speculative_generate` from certified
    position ``t``: ``K + 1`` draft steps (the last writes the K-th
    draft's K/V at ``t + K``, which JAX's K-step scan never writes — see
    ROADMAP C), one ``(K+1)``-row verify of the target, the accepted
    prefix and the target's own next token written into ``tokens`` at
    ``t + 1..``.  Returns ``(cache_v, cache_d, n accepted)`` (one
    read-back)."""
    tok = tokens[:, t:t + 1]
    drafts = []
    for i in range(K + 1):
        cache_d, lg = forward_cached(draft_params, tok, dcfg, cache_d, t + i)
        tok = torch.argmax(lg, dim=-1)[:, None]
        drafts.append(tok)
    drafts = torch.cat(drafts[:K], dim=1)  # [1, K]
    cand = torch.cat([tokens[:, t:t + 1], drafts], dim=1)  # [1, K+1]
    cache_v, all_lg = forward_cached(params, cand, cfg, cache_v, t,
                                     all_logits=True)
    verify = torch.argmax(all_lg[0], dim=-1)  # the target's t+1..t+K+1
    n = int(torch.cumprod((drafts[0] == verify[:K]).long(), 0).sum())
    tokens[0, t + 1:t + K + 2] = verify
    return cache_v, cache_d, n


@torch.no_grad()
def speculative_generate(params: Dict[str, Any], draft_params: Dict[str, Any],
                         prompt: torch.Tensor, cfg: GPTConfig,
                         max_new_tokens: int,
                         draft_cfg: Optional[GPTConfig] = None,
                         num_draft: int = 4, kv_quant: bool = False,
                         device=None) -> torch.Tensor:
    """Greedy speculative decoding (JAX :521), B == 1, serial: the draft
    model proposes ``num_draft`` tokens a macro step, the target verifies
    them in ONE (K+1)-row cached forward, and the longest agreeing prefix
    plus the target's own next token are emitted — so the output equals
    greedy :func:`generate` whatever the draft proposes.  The natural
    draft is ``tools.surgery.quantize_decode_params(params)``.  Stale
    cache entries past the certified position are masked and later
    overwritten, so a rejection needs no rollback.  The macro loop runs
    on the host, reading one count a step."""
    if cfg.moe_experts:
        raise NotImplementedError(
            "speculative_generate supports the dense families")
    if cfg.attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(_CP_DECODE)
    B, P = prompt.shape
    if B != 1:
        raise ValueError(f"speculative decode is B == 1 (got {B})")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    K = int(num_draft)
    if K < 1:
        raise ValueError(f"num_draft must be >= 1, got {K}")
    dcfg = draft_cfg or cfg
    if dcfg.vocab_size != cfg.vocab_size:
        raise ValueError("draft and target must share a vocabulary")
    total = P + max_new_tokens + K + 1  # slack for overshoot writes
    _check_decode(cfg, max_new_tokens, total,
                  "P + max_new_tokens + num_draft + 1")
    dev = resolve_device(device)
    cache_v = init_kv_cache(cfg, 1, total, quantized=kv_quant, device=dev)
    cache_d = init_kv_cache(dcfg, 1, total, quantized=kv_quant, device=dev)
    tokens = torch.zeros(1, total, dtype=torch.long, device=dev)
    tokens[:, :P] = prompt.to(dev)
    cache_v, logits = forward_cached(params, tokens[:, :P], cfg, cache_v, 0)
    cache_d, _ = forward_cached(draft_params, tokens[:, :P], dcfg, cache_d,
                                0)
    tokens[:, P] = torch.argmax(logits, dim=-1)
    t = P
    while t < P + max_new_tokens - 1:  # the final required token's index
        cache_v, cache_d, n = _spec_macro_step(
            params, draft_params, cfg, dcfg, tokens, cache_v, cache_d, t, K)
        t += n + 1
    return tokens[:, :P + max_new_tokens]


@torch.no_grad()
def beam_generate(params: Dict[str, Any], prompt: torch.Tensor,
                  cfg: GPTConfig, max_new_tokens: int, num_beams: int = 4,
                  return_all: bool = False, kv_quant: bool = False,
                  device=None) -> torch.Tensor:
    """Fixed-length beam search (JAX :635), B == 1, serial: every step
    scores the ``num_beams x V`` continuations by accumulated f32
    log-probability, keeps the top ``num_beams`` (one top-k over the
    flattened scores) and re-gathers the tokens and the cache (the int8
    pairs too) along the batch dimension by parent beam.  Returns the
    best beam [1, P + max_new_tokens], or every beam best first with
    ``return_all``."""
    B, P = prompt.shape
    if B != 1:
        raise ValueError(f"beam search is B == 1 (got {B})")
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    total = P + max_new_tokens
    _check_decode(cfg, max_new_tokens, total)
    dev = resolve_device(device)
    V, nb = cfg.vocab_size, int(num_beams)
    fwd = forward_cached_moe if cfg.moe_experts else forward_cached
    cache = init_kv_cache(cfg, nb, total, quantized=kv_quant, device=dev)
    tokens = torch.zeros(nb, total, dtype=torch.long, device=dev)
    tokens[:, :P] = prompt.to(dev)
    cache, logits = fwd(params, tokens[:, :P], cfg, cache, 0)
    lp = torch.log_softmax(logits.float(), dim=-1)
    # beams start distinct: the nb best first tokens of (any) one row
    scores, tokens[:, P] = torch.topk(lp[0], nb)

    def pick(c, parent):
        if isinstance(c, tuple):
            return tuple(t[:, parent] for t in c)
        return c[:, parent]

    for pos in range(P, total - 1):
        cache, logits = fwd(params, tokens[:, pos:pos + 1], cfg, cache, pos)
        lp = torch.log_softmax(logits.float(), dim=-1)
        scores, flat = torch.topk((scores[:, None] + lp).reshape(-1), nb)
        parent = flat // V
        tokens = tokens[parent]
        tokens[:, pos + 1] = flat % V
        cache = {name: pick(c, parent) for name, c in cache.items()}
    out = tokens[torch.argsort(-scores)]
    return out if return_all else out[:1]
