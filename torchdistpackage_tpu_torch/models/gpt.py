"""GPT / Llama-family model config, init and head — the PyTorch
counterpart of ``torchdistpackage_tpu/models/gpt.py`` (serial branch).

Parameters are a plain dict with the reference's tree: ``tok_emb`` [V, D],
``pos_emb`` [max_seq, D] (learned positions only), ``blocks`` with every
leaf stacked over the layer dim ``[L, ...]``, ``ln_f`` and ``head``
[D, V].  The training path is here: :func:`gpt_embed`,
:func:`gpt_hidden`, :func:`gpt_forward`, the cross-entropy
(:func:`vocab_parallel_xent`, :func:`streamed_head_loss`) and
:func:`gpt_loss`, serial or over a tensor-parallel group (``tp_group``,
optionally sequence parallel, ``sp``): each rank then holds its shard
(:func:`shard_gpt_params`), the embedding and the head split over the
vocabulary, and the loss closes the vocabulary split with two small
collectives.
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
    _open_column_parallel,
    dense,
    init_block_params,
    init_norm_params,
    layer_norm,
    param_specs,
    scan_blocks,
    shard_params,
)
from ..parallel.tensor_parallel.tp_utils import (
    copy_to_tp,
    gather_from_sp,
    reduce_from_tp,
    split_to_sp,
    tp_rank,
    vocab_max,
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
    # 'naive' (plain score matrix) | 'flash' (kernels K3-K5) | 'ring' |
    # 'ulysses' (context parallel over the cp_group the entry points take)
    attn_impl: str = "naive"
    # 'contiguous' | 'zigzag' (ring only): how the sequence is sharded
    cp_layout: str = "contiguous"
    dropout_rate: float = 0.0  # residual dropout (needs a dropout_key)
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
    # sequence parallelism's rings (TransformerConfig.collective_matmul)
    collective_matmul: bool = False
    cm_min_bytes: int = 1 << 20
    # Mixture-of-Experts (0 = dense model).  With ``moe_experts > 0`` every
    # ``moe_every``-th block's FFN is an expert layer (``models/gpt_moe.py``
    # builds the per-block list); serving runs it (``paged_forward_moe``),
    # training ``gpt_moe_loss`` / ``gpt_moe_pipeline_1f1b``.
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    # 'topk' only for this causal family: 'expert_choice' ranks the whole
    # sequence per expert (a future-token leak), refused as in the reference
    moe_router: str = "topk"
    # 'auto' | 'cuda' | 'gather' (serving) | 'dense' | 'sorted' (training's
    # capacity path); see MoEConfig
    moe_dispatch: str = "auto"

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
            attn_impl=self.attn_impl, cp_layout=self.cp_layout,
            dropout_rate=self.dropout_rate,
            kv_heads=self.kv_heads, rope=self.pos == "rope",
            rope_theta=self.rope_theta, rope_scaling=self.rope_scaling,
            norm=self.norm, act=self.act, ffn_hidden=self.ffn_hidden,
            norm_eps=self.norm_eps, sliding_window=self.sliding_window,
            collective_matmul=self.collective_matmul,
            cm_min_bytes=self.cm_min_bytes)

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


def vocab_parallel_embed(tok_emb: torch.Tensor, tokens: torch.Tensor,
                         tp_group=None) -> torch.Tensor:
    """Token lookup [B, S] -> [B, S, D].  With ``tp_group``, ``tok_emb``
    is this rank's vocabulary rows ``[V / tp, D]``: ids outside them
    contribute zeros and ``reduce_from_tp`` sums the shards (the table's
    gradient stays in the rank's own rows)."""
    if tp_group is None:
        return tok_emb[tokens]
    v_loc = tok_emb.shape[0]
    local = tokens - tp_rank(tp_group) * v_loc
    valid = (local >= 0) & (local < v_loc)
    emb = tok_emb[torch.where(valid, local, 0)]
    emb = torch.where(valid[..., None], emb,
                      torch.zeros((), dtype=emb.dtype, device=emb.device))
    return reduce_from_tp(emb, tp_group)


def gpt_head(params: Params, h: torch.Tensor, eps: float = 1e-5,
             tp_group=None, sp: bool = False) -> torch.Tensor:
    """Final norm + LM head: [B, S, D] -> logits [B, S, V], or this
    rank's vocabulary columns [B, S, V / tp] with ``tp_group`` (the
    normed rows gathered first under ``sp``)."""
    h = layer_norm(h, params["ln_f"], eps)
    return dense(_open_column_parallel(h, tp_group, sp), params["head"])


def vocab_parallel_xent(logits: torch.Tensor, targets: torch.Tensor,
                        tp_group=None) -> torch.Tensor:
    """Mean token cross-entropy of ``logits`` [..., V] against int
    ``targets`` [...]: ``mean(logsumexp - target logit)`` in f32 whatever
    the logits' dtype.  With ``tp_group`` the logits are this rank's
    vocabulary columns [..., V / tp] and the full softmax is never
    formed: the max shift is an all-reduce MAX outside autograd (it
    cancels in the gradient), and the sum of exponentials and the target
    logit (kept by the rank that holds the target) close in one
    ``reduce_from_tp``."""
    if tp_group is None:
        V = logits.shape[-1]
        return F.cross_entropy(logits.reshape(-1, V).float(),
                               targets.reshape(-1))
    x = logits.float()
    v_loc = x.shape[-1]
    m = vocab_max(x.detach().amax(dim=-1), tp_group)
    local = targets.long() - tp_rank(tp_group) * v_loc
    valid = (local >= 0) & (local < v_loc)
    tl = x.gather(-1, torch.where(valid, local, 0)[..., None])[..., 0]
    zt = reduce_from_tp(torch.stack([
        torch.exp(x - m[..., None]).sum(dim=-1),
        torch.where(valid, tl, torch.zeros((), device=x.device))]),
        tp_group)
    return (torch.log(zt[0]) + m - zt[1]).mean()


def gpt_embed(params: Params, tokens: torch.Tensor, tp_group=None,
              cp_group=None, cp_layout: str = "contiguous") -> torch.Tensor:
    """[B, S] ids -> [B, S, D]: the token lookup (vocab-parallel with
    ``tp_group``), plus the learned position table when the config has
    one (rope enters in attention).  With ``cp_group`` the tokens are the
    rank's sequence shard and the table is read at its global positions
    (JAX :275-293): a contiguous slice, or the zigzag rows gathered."""
    h = vocab_parallel_embed(params["tok_emb"], tokens, tp_group)
    if "pos_emb" not in params:
        return h
    S = tokens.shape[-1]
    if cp_group is None:
        return h + params["pos_emb"][:S]
    if cp_layout == "zigzag":
        from ..ops.ring_attention import shard_positions

        return h + params["pos_emb"][shard_positions(cp_group, S, cp_layout,
                                                     h.device)]
    off = torch.distributed.get_rank(cp_group) * S
    return h + params["pos_emb"][off:off + S]


def gpt_hidden(params: Params, tokens: torch.Tensor, cfg: GPTConfig,
               remat: RematMode = False,
               dropout_key: Optional[int] = None, tp_group=None,
               sp: bool = False, cp_group=None) -> torch.Tensor:
    """tokens [B, S] -> hidden after the block stack [B, S, D] (before
    the final norm; this rank's rows [B, S / tp, D] under ``sp``).
    ``remat``: False | True | 'flash' | 'flash_offload' — see
    :func:`..parallel.tensor_parallel.layers.scan_blocks`.
    ``dropout_key`` turns on residual dropout at ``cfg.dropout_rate``;
    under data parallelism derive it with
    ``utils.random.axis_unique_key(key, 'data')`` (tensor ranks then
    agree).  ``tp_group`` / ``sp``: tensor / sequence parallelism over
    this rank's shard of the parameters.  ``cp_group``: context
    parallelism (``cfg.attn_impl`` ``'ring'`` / ``'ulysses'``): ``tokens``
    are the rank's shard of the sequence (``cfg.cp_layout``), the
    activations stay sharded and only attention talks over the group."""
    h = gpt_embed(params, tokens, tp_group, cp_group, cfg.cp_layout)
    if tp_group is not None and sp:
        h = split_to_sp(h, tp_group)
    return scan_blocks(params["blocks"], h, cfg.block, remat=remat,
                       dropout_key=dropout_key, tp_group=tp_group, sp=sp,
                       cp_group=cp_group)


def gpt_forward(params: Params, tokens: torch.Tensor, cfg: GPTConfig,
                remat: RematMode = False,
                dropout_key: Optional[int] = None, tp_group=None,
                sp: bool = False, cp_group=None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] (this rank's [B, S, V / tp]
    with ``tp_group``; its sequence shard's with ``cp_group``)."""
    h = gpt_hidden(params, tokens, cfg, remat=remat, dropout_key=dropout_key,
                   tp_group=tp_group, sp=sp, cp_group=cp_group)
    return gpt_head(params, h, eps=cfg.norm_eps, tp_group=tp_group, sp=sp)


def streamed_head_loss(params: Params, h: torch.Tensor,
                       targets: torch.Tensor, chunk: int = 256,
                       eps: float = 1e-5, tp_group=None,
                       sp: bool = False) -> torch.Tensor:
    """Final norm + head + cross-entropy over sequence chunks of
    ``chunk``: each [B, chunk, V] slab is formed, reduced and dropped,
    and recomputed in the backward (checkpointed per chunk), so the full
    [B, S, V] logits never exist.  Equal chunks: the mean of chunk means
    is the token mean.  ``h`` is the whole sequence; with ``tp_group``
    each slab is this rank's vocabulary columns.  ``sp``: the caller
    gathered ``h`` from sequence shards, and that gather's backward (a
    reduce-scatter) sums the partial cotangent, so ``copy_to_tp``'s
    all-reduce is left out (``ln_f``'s grad is then partial, summed once
    by the train step's SP sum)."""
    h = layer_norm(h, params["ln_f"], eps)
    if tp_group is not None and not sp:
        h = copy_to_tp(h, tp_group)
    S = h.shape[1]
    if S % chunk:
        raise ValueError(
            f"sequence length {S} not divisible by xent_chunk {chunk} — "
            f"the fallback would materialize the full logits the caller "
            f"opted out of")

    def body(hh, tt):
        return vocab_parallel_xent(dense(hh, params["head"]), tt, tp_group)

    n = S // chunk
    total = h.new_zeros((), dtype=torch.float32)
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(body, h[:, sl], targets[:, sl],
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    return total / n


def gpt_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: GPTConfig,
             remat: RematMode = False, dropout_key: Optional[int] = None,
             xent_chunk: Optional[int] = None, tp_group=None,
             sp: bool = False, cp_group=None) -> torch.Tensor:
    """Mean next-token cross-entropy.  ``batch``: {'tokens': [B, S],
    'targets': [B, S]}.  ``xent_chunk`` streams the head and the loss
    over sequence chunks of that size (:func:`streamed_head_loss`).
    ``tp_group`` / ``sp``: tensor / sequence parallelism, every rank of
    the group on the same batch with its shard of the parameters; the
    loss comes out the same on every rank of the group.  ``cp_group``:
    context parallelism, ``batch`` the rank's sequence shard; the loss is
    the mean over the rank's tokens, so the context axis is a data axis
    of the train step (``DataParallel(axis=('data', 'context'))``
    averages the grads over both, as the reference's)."""
    if xent_chunk is not None:
        h = gpt_hidden(params, batch["tokens"], cfg, remat=remat,
                       dropout_key=dropout_key, tp_group=tp_group, sp=sp,
                       cp_group=cp_group)
        if tp_group is not None and sp:
            h = gather_from_sp(h, tp_group)
        return streamed_head_loss(params, h, batch["targets"],
                                  chunk=xent_chunk, eps=cfg.norm_eps,
                                  tp_group=tp_group,
                                  sp=tp_group is not None and sp)
    logits = gpt_forward(params, batch["tokens"], cfg, remat=remat,
                         dropout_key=dropout_key, tp_group=tp_group, sp=sp,
                         cp_group=cp_group)
    return vocab_parallel_xent(logits, batch["targets"], tp_group)


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


# ------------------------------------------------------------------ specs


def gpt_param_specs(params: Params, pipe_axis: Optional[str] = None,
                    tp_axis: Optional[str] = None,
                    interleaved: bool = False) -> Params:
    """The tensor-parallel spec tree of a GPT param tree (JAX :747, the
    placement table ``layers.TP_SPLIT_DIMS``): ``tok_emb`` split on its
    vocabulary rows, ``head`` on its vocabulary columns, the blocks'
    column- and row-parallel leaves on their heads / hidden units;
    norms, row biases, ``pos_emb``, and an MoE block's router and
    experts replicated.

    With ``pipe_axis`` (or ``tp_axis``) the PartitionSpec-like form
    instead, JAX's ``gpt_param_specs(cfg, tp_axis, pipe_axis)``: each
    leaf a tuple of axis names, one a dim — the ``[L, ...]`` block leaves
    split dim 0 over ``pipe_axis`` (``interleaved``: the ``[V, P, Lc,
    ...]`` layout of :func:`interleave_stage_params`, dim 1),
    ``tp_axis`` on each leaf's tensor-parallel dim.  The pipeline
    schedules read which leaves are a stage's own slab from it."""
    specs = param_specs(params)
    if pipe_axis is None and tp_axis is None:
        return specs

    def tup(leaf, spec, stacked):
        entries = [None] * leaf.ndim
        if tp_axis is not None and isinstance(spec, int):
            entries[spec % leaf.ndim] = tp_axis
        if stacked and pipe_axis is not None:
            entries[1 if interleaved else 0] = pipe_axis
        return tuple(entries)

    def walk(node, spec, stacked):
        if isinstance(node, dict):
            return {k: walk(v, spec[k], stacked or k == "blocks")
                    for k, v in node.items()}
        return tup(node, spec, stacked)
    return walk(params, specs, False)


def interleave_stage_params(params: Params, num_chunks: int,
                            pipe_size: int) -> Params:
    """The ``[L, ...]`` block leaves reshaped to the interleaved layout
    ``[V, P, L / (P V), ...]``: chunk ``v`` of stage ``s`` holds layer slab
    ``v P + s`` (JAX :496).  Works on tensors and numpy arrays (views)."""
    def r(a):
        L = a.shape[0]
        if L % (num_chunks * pipe_size):
            raise ValueError(f"nlayers {L} not divisible by num_chunks*pipe "
                             f"({num_chunks}*{pipe_size})")
        return a.reshape((num_chunks, pipe_size,
                          L // (num_chunks * pipe_size)) + tuple(a.shape[1:]))
    return {**params, "blocks": _map(r, params["blocks"])}


def deinterleave_stage_params(params: Params, num_chunks: int,
                              pipe_size: int) -> Params:
    """:func:`interleave_stage_params`' inverse: ``[V, P, Lc, ...]`` back
    to the serial ``[L, ...]`` layout."""
    def r(a):
        if tuple(a.shape[:2]) != (num_chunks, pipe_size):
            raise ValueError(
                f"leaf leading dims {tuple(a.shape[:2])} != (V={num_chunks}, "
                f"P={pipe_size}) — not an interleaved layout")
        return a.reshape((num_chunks * pipe_size * a.shape[2],)
                         + tuple(a.shape[3:]))
    return {**params, "blocks": _map(r, params["blocks"])}


def gpt_interleaved_param_specs(params: Params, tp_axis: Optional[str] = None,
                                pipe_axis: str = "pipe") -> Params:
    """Specs of the :func:`interleave_stage_params` layout: the block
    leaves ``[V, P, Lc, ...]`` split dim 1 over ``pipe_axis`` (JAX :540)."""
    return gpt_param_specs(params, pipe_axis=pipe_axis, tp_axis=tp_axis,
                           interleaved=True)


def pipe_slab(params: Params, pp_rank: int, pp_size: int,
              num_chunks: int = 1) -> Params:
    """Stage ``pp_rank`` of ``pp_size``'s params: views of the ``[L,
    ...]`` block leaves' contiguous ``[L / P, ...]`` slab (``num_chunks >
    1``: the interleaved layout's ``[V, 1, Lc, ...]``), every other leaf
    whole."""
    if not 0 <= pp_rank < pp_size:
        raise ValueError(f"pp_rank {pp_rank} not in [0, {pp_size})")
    if num_chunks > 1:
        params = interleave_stage_params(params, num_chunks, pp_size)
        cut = lambda a: a[:, pp_rank:pp_rank + 1]  # noqa: E731
    else:
        def cut(a):
            L = a.shape[0]
            if L % pp_size:
                raise ValueError(f"nlayers {L} not divisible by pipe "
                                 f"{pp_size} (equal stage slabs)")
            c = L // pp_size
            return a[pp_rank * c:(pp_rank + 1) * c]
    return {**params, "blocks": _map(cut, params["blocks"])}


def shard_gpt_params(params: Params, cfg: GPTConfig, rank: int,
                     size: int, pp_rank: int = 0, pp_size: int = 1,
                     num_chunks: int = 1) -> Params:
    """Tensor-parallel rank ``rank`` of ``size``'s shard of a GPT param
    tree (dense or MoE): views of ``params`` cut by
    :func:`gpt_param_specs`.  The vocabulary and the KV heads must divide
    by ``size`` (whole KV heads a shard).  ``pp_size > 1``: then pipeline
    stage ``pp_rank``'s slab of the block leaves (:func:`pipe_slab`; an
    MoE tree's block list: ``models.gpt_moe.moe_stage_params``)."""
    if cfg.vocab_size % size:
        raise ValueError(f"vocab_size {cfg.vocab_size} not divisible by tp "
                         f"{size} (whole vocabulary slices per shard)")
    if cfg.block.kv_head_count % size:
        raise ValueError(
            f"kv_heads {cfg.block.kv_head_count} not divisible by tp "
            f"{size} (whole KV heads per shard)")
    out = shard_params(params, gpt_param_specs(params), rank, size)
    if pp_size > 1 or num_chunks > 1:
        if isinstance(out.get("blocks"), list):
            from .gpt_moe import moe_stage_params

            return moe_stage_params(out, cfg, pp_rank, pp_size, num_chunks)
        out = pipe_slab(out, pp_rank, pp_size, num_chunks)
    return out


# ------------------------------------------------------------------ pipeline


def _pipe_block_specs(params: Params, pipe_axis: str) -> Params:
    """The schedules' placement: the block leaves a stage's own, the rest
    replicated over the pipe group."""
    return {k: (_map(lambda _: (pipe_axis,), v) if k == "blocks" else None)
            for k, v in params.items()}


def _gpt_stage_fns(cfg: GPTConfig, tp_group, sp: bool, remat: RematMode,
                   dropout_key: Optional[int], stage: int, num_chunks: int,
                   cp_group=None):
    """``(first_fn, stage_fn, last_fn)`` of the GPT pipelines (JAX
    :598-650): stage 0 embeds (and enters SP), each stage scans its slab,
    the last runs the final norm, the head and the vocab-parallel loss.
    Dropout folds (stage, microbatch[, chunk]) into the key, then
    ``scan_blocks`` the layer.  ``cp_group``: the microbatches are the
    rank's sequence shards, embedded at their global positions, and every
    stage's blocks run the ring over the group."""
    from ..utils.random import fold_in

    def first_fn(p, toks):
        h = gpt_embed(p, toks, tp_group, cp_group, cfg.cp_layout)
        if tp_group is not None and sp:
            h = split_to_sp(h, tp_group)
        return h

    def key(m, v=None):
        if dropout_key is None or cfg.dropout_rate <= 0.0:
            return None
        k = fold_in(fold_in(dropout_key, stage), m)
        return k if v is None else fold_in(k, v)

    if num_chunks == 1:
        def stage_fn(p, x, m):
            return scan_blocks(p["blocks"], x, cfg.block, remat=remat,
                               dropout_key=key(m), tp_group=tp_group, sp=sp,
                               cp_group=cp_group)
    else:
        def stage_fn(p, x, m, v):
            slab = _map(lambda a: a[v, 0], p["blocks"])
            return scan_blocks(slab, x, cfg.block, remat=remat,
                               dropout_key=key(m, v), tp_group=tp_group,
                               sp=sp, cp_group=cp_group)

    def last_fn(p, y, tgt):
        logits = gpt_head(p, y, eps=cfg.norm_eps, tp_group=tp_group, sp=sp)
        return vocab_parallel_xent(logits, tgt, tp_group)
    return first_fn, stage_fn, last_fn


def gpt_pipeline_loss(params: Params, batch: Dict[str, torch.Tensor],
                      cfg: GPTConfig, num_microbatches: int, tp_group=None,
                      pipe_axis: str = "pipe", sp: bool = False,
                      remat: RematMode = True, pipe_group=None,
                      cp_group=None) -> torch.Tensor:
    """The pipelined GPT loss on the fill-drain schedule (JAX :443),
    differentiated by the caller (``loss.backward()`` on every stage).
    ``params``: this stage's (its ``[L / P, ...]`` block slab, every other
    leaf whole); ``batch``: {'tokens', 'targets'} ``[M, mbs, S]``.  Stage 0
    embeds per tick, the last stage runs the head and the loss; the
    embedding's and the head's grads are summed over the pipe group inside
    the backward (``pipeline_loss(params=)``)."""
    from ..parallel.pipeline_parallel import pipeline_loss

    first_fn, _, last_fn = _gpt_stage_fns(cfg, tp_group, sp, False, None,
                                          0, 1, cp_group)
    whole = {k: v for k, v in params.items() if k != "blocks"}

    def stage_fn(stacked, x):
        return scan_blocks(stacked, x, cfg.block, tp_group=tp_group, sp=sp,
                           cp_group=cp_group)

    return pipeline_loss(
        params["blocks"], batch["tokens"], batch["targets"],
        stage_fn=stage_fn, loss_fn=last_fn,
        num_microbatches=num_microbatches, pipe_axis=pipe_axis, remat=remat,
        first_fn=first_fn, params=whole, pipe_group=pipe_group,
        loss_takes_params=True)


def gpt_pipeline_1f1b(params: Params, batch: Dict[str, torch.Tensor],
                      cfg: GPTConfig, num_microbatches: int, tp_group=None,
                      pipe_axis: str = "pipe", sp: bool = False,
                      remat: RematMode = True,
                      dropout_key: Optional[int] = None, num_chunks: int = 1,
                      shard_transfers: Optional[bool] = None,
                      pipe_group=None, cp_group=None):
    """The 1F1B GPT step's core (JAX :556): ``(loss, grads)`` directly (do
    not call ``backward``).  ``params``: this stage's — its block slab
    (``shard_gpt_params(..., pp_rank=, pp_size=)`` / ``params_from_jax``),
    every other leaf whole; ``num_chunks > 1`` the interleaved layout's
    ``[V, 1, Lc, ...]`` slab and schedule (``M % P == 0``).  ``batch``:
    {'tokens', 'targets'} ``[M, mbs, S]``.  Stage 0 embeds, the last stage
    runs the head and the loss; their grads are summed over the pipe group
    once, after the schedule.  ``dropout_key`` folds (stage, microbatch[,
    chunk]).  ``tp_group`` / ``sp``: tensor parallelism inside each stage
    (this rank's TP shards); ``shard_transfers`` (default: on exactly when
    ``tp_group`` is set and ``sp`` off) carries the inter-stage activation
    sliced 1/tp over the tensor group.  The pipe group is ``pipe_group``,
    else ``tpc``'s ``pipe_axis`` group.  ``cp_group``: ring / Ulysses
    stages over the context group, ``batch`` the rank's sequence shards
    (JAX ``tests/test_gpt.py:573``); the stages of one context rank talk
    to each other, every context rank runs the same schedule."""
    from ..parallel.pipeline_parallel import pipeline_1f1b, stage_index

    if shard_transfers is None:
        shard_transfers = tp_group is not None and not sp
    first_fn, stage_fn, last_fn = _gpt_stage_fns(
        cfg, tp_group, sp, remat, dropout_key,
        stage_index(pipe_axis, pipe_group), num_chunks, cp_group)
    return pipeline_1f1b(
        params, batch["tokens"], batch["targets"], first_fn=first_fn,
        stage_fn=stage_fn, last_fn=last_fn,
        num_microbatches=num_microbatches, pipe_axis=pipe_axis,
        stage_takes_mb=True, num_chunks=num_chunks, pipe_group=pipe_group,
        param_specs=_pipe_block_specs(params, pipe_axis),
        transfer_shard_group=tp_group if shard_transfers else None)


def gpt_pipeline_zb(params: Params, batch: Dict[str, torch.Tensor],
                    cfg: GPTConfig, num_microbatches: int, tp_group=None,
                    pipe_axis: str = "pipe", sp: bool = False,
                    remat: RematMode = True,
                    dropout_key: Optional[int] = None,
                    shard_transfers: Optional[bool] = None, pipe_group=None,
                    cp_group=None):
    """:func:`gpt_pipeline_1f1b`'s contract on the zero-bubble schedule
    (JAX :663; no ``num_chunks``): the dgrad on the wavefront, the wgrad
    in a drain, the same key recipe, so both recomputes replay the
    forward's dropout masks."""
    from ..parallel.pipeline_parallel import pipeline_zb_1f1b, stage_index

    if shard_transfers is None:
        shard_transfers = tp_group is not None and not sp
    first_fn, stage_fn, last_fn = _gpt_stage_fns(
        cfg, tp_group, sp, remat, dropout_key,
        stage_index(pipe_axis, pipe_group), 1, cp_group)
    return pipeline_zb_1f1b(
        params, batch["tokens"], batch["targets"], first_fn=first_fn,
        stage_fn=stage_fn, last_fn=last_fn,
        num_microbatches=num_microbatches, pipe_axis=pipe_axis,
        stage_takes_mb=True, pipe_group=pipe_group,
        param_specs=_pipe_block_specs(params, pipe_axis),
        transfer_shard_group=tp_group if shard_transfers else None)
