"""The MoE GPT family — the PyTorch counterpart of
``torchdistpackage_tpu/models/gpt_moe.py``: :func:`moe_layer_config`
(:69), :func:`is_moe_block` (:86), the training forward
(:func:`moe_block_forward` :95, :func:`gpt_moe_forward` :144,
``_moe_bodies`` :179, :func:`moe_block_stack` :202), the specs
(:func:`moe_blocks_param_specs` :264, :func:`gpt_moe_param_specs` :545),
:func:`gpt_moe_loss` (:285), :func:`init_gpt_moe_params` (:308), the
pipeline layout (:func:`moe_stage_pattern` :338, :func:`moe_stage_params`
for ``stack_moe_stage_params`` :369), the MoE 1F1B
(:func:`gpt_moe_pipeline_1f1b` :405, :func:`gpt_moe_pipeline_param_specs`
:517), and the expert-parallel / tensor-parallel shard of a tree
(:func:`shard_moe_params`).

Every ``cfg.moe_every``-th block's FFN is an expert layer.  Blocks are a
heterogeneous Python list of per-block param dicts — dense blocks carry
``mlp``, expert blocks ``moe`` (``router`` + stacked ``experts``) — so a
forward walks the list instead of indexing stacked leaves.  The serving
forward over this list is ``serving/paged_cache.py``'s
:func:`~..serving.paged_cache.paged_forward_moe`; training goes through
:func:`gpt_moe_loss`, serial, over a tensor group (``tp_group`` /
``sp``; the experts replicated over it) and an expert group
(``ep_group``), or pipelined (:func:`gpt_moe_pipeline_1f1b`).  A
pipeline stage holds its own slab of the block list
(:func:`moe_stage_params`), since the port's stages are separate
programs.
"""

from __future__ import annotations

import math
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..device import resolve_device
from ..parallel.moe import (
    MoEConfig,
    init_moe_params,
    moe_forward,
    moe_param_specs,
    shard_experts,
)
from ..parallel.tensor_parallel.layers import (
    RematMode,
    _close_row_parallel,
    _normal,
    _open_column_parallel,
    attention_partial,
    block_forward,
    block_rope_cache,
    checkpoint_block,
    dropout,
    init_block_params,
    init_norm_params,
    layer_norm,
    offload_advice,
    param_specs,
)
from ..parallel.tensor_parallel.tp_utils import gather_whole, split_to_sp
from ..utils.random import fold_in, split

Params = Dict[str, Any]


def moe_layer_config(cfg) -> MoEConfig:
    """The MoEConfig of cfg's expert layers (ffn width and activation are
    the dense FFN's: ``act='swiglu'`` makes the Mixtral expert)."""
    return MoEConfig(
        dim=cfg.dim, ffn_dim=cfg.block.ffn_dim, num_experts=cfg.moe_experts,
        top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
        aux_loss_weight=cfg.moe_aux_weight, dtype=cfg.dtype,
        router=cfg.moe_router, dispatch=cfg.moe_dispatch, act=cfg.act)


def is_moe_block(cfg, i: int) -> bool:
    """Block i carries an expert FFN: blocks moe_every-1, 2*moe_every-1,
    ... (with moe_every=2 the odd blocks, the Switch placement; with 1
    every block, as Mixtral)."""
    return cfg.moe_experts > 0 and i % cfg.moe_every == cfg.moe_every - 1


# ------------------------------------------------------------------ forward


def moe_block_forward(p: Params, x: torch.Tensor, cfg, tp_group=None,
                      sp: bool = False, ep_group=None,
                      dropout_key: Optional[int] = None, rope=None,
                      return_metrics: bool = False, cp_group=None):
    """Pre-norm block whose FFN is the MoE layer: ``(y, aux)`` (plus the
    router's counters with ``return_metrics``).  The attention half is
    :func:`~..parallel.tensor_parallel.layers.block_forward`'s; the MoE
    half runs on the whole sequence (under ``sp`` gathered by
    ``gather_whole``), its experts replicated over the tensor group and
    split over ``ep_group``, so every tensor rank computes the same
    output, and under ``sp`` leaves by ``split_to_sp``, not a reduction.
    The MoE half's cotangent is then whole on every tensor rank, as its
    weights' grads are (no tensor-group sum); the gather's backward takes
    the rank's own rows.  ``cfg.block.causal`` selects token-major
    capacity priority and refuses the expert-choice router.
    ``cp_group``: context-parallel attention; the MoE half routes the
    rank's own tokens (JAX ``tests/test_moe.py:971``)."""
    bcfg = cfg.block
    k_attn = k_mlp = None
    if dropout_key is not None and bcfg.dropout_rate > 0.0:
        k_attn, k_mlp = split(dropout_key)
    h = layer_norm(x, p["ln1"], bcfg.norm_eps)
    y = _close_row_parallel(
        attention_partial(p["attn"], _open_column_parallel(h, tp_group, sp),
                          bcfg, rope=rope, cp_group=cp_group),
        p["attn"]["bo"], tp_group, sp)
    x = x + dropout(y, bcfg.dropout_rate, k_attn)
    h = layer_norm(x, p["ln2"], bcfg.norm_eps)
    tp_sp = tp_group is not None and sp
    out = moe_forward(p["moe"], gather_whole(h, tp_group) if tp_sp else h,
                      moe_layer_config(cfg), ep_group=ep_group,
                      causal=bcfg.causal, return_metrics=return_metrics)
    z = split_to_sp(out[0], tp_group) if tp_sp else out[0]
    y = x + dropout(z, bcfg.dropout_rate, k_mlp)
    return (y,) + tuple(out[1:])


def _moe_bodies(cfg, tp_group, sp: bool, ep_group, remat: RematMode,
                cp_group=None):
    """``(moe_body, dense_body)``, each ``(bp, h, key, rope)``, with the
    remat mode applied — one place for the block checkpointing, shared by
    the serial stack and the pipeline's stages.  The MoE body returns
    ``(y, aux)``; under ``'flash'`` its recompute hands back the kept
    flash ``(o, lse)`` and re-runs the router and the expert FFN (K6, or
    the exchanges and K7 under EP) on the same inputs, so it routes the
    same way."""
    moe_body = checkpoint_block(
        lambda bp, h, k, rope: moe_block_forward(
            bp, h, cfg, tp_group=tp_group, sp=sp, ep_group=ep_group,
            dropout_key=k, rope=rope, cp_group=cp_group), remat)
    cp = {} if cp_group is None else {"cp_group": cp_group}
    dense_body = checkpoint_block(
        lambda bp, h, k, rope: block_forward(
            bp, h, cfg.block, rope=rope, dropout_key=k, tp_group=tp_group,
            sp=sp, **cp), remat)
    return moe_body, dense_body


def moe_block_stack(blocks: List[Params], h: torch.Tensor, cfg,
                    tp_group=None, sp: bool = False, ep_group=None,
                    dropout_key: Optional[int] = None,
                    remat: RematMode = False, collect_metrics: bool = False,
                    block_keys: Optional[List[int]] = None, cp_group=None):
    """The dense / expert block loop of the MoE families: ``(h, aux)``,
    ``aux`` the mean over the expert blocks.  Block ``i`` folds ``i`` into
    ``dropout_key``, or takes ``block_keys[i]`` (a pipeline stage's keys,
    which fold the stage, microbatch and chunk around the block index in
    the reference's order); a block with ``moe`` runs :func:`moe_block_forward`,
    the others the dense block, each checkpointed per ``remat``.
    ``collect_metrics=True`` (an observability pass: the expert blocks run
    un-checkpointed) also returns the router counters over the expert
    blocks — ``expert_tokens`` summed, ``router_entropy`` and
    ``dropped_token_rate`` averaged — for ``obs.aggregate.moe_load_stats``.
    ``cp_group``: context-parallel attention over the group, ``h`` the
    rank's sequence shard (each rank routes its own tokens)."""
    moe_body, dense_body = _moe_bodies(cfg, tp_group, sp, ep_group, remat,
                                       cp_group)
    rope = block_rope_cache(cfg.block, h.shape[1], h.device, tp_group, sp,
                            cp_group)
    if remat == "flash_offload":
        advice = offload_advice(cfg.block, tuple(h.shape), len(blocks),
                                device=h.device)
        if advice:
            warnings.warn(advice, stacklevel=2)
    aux_total = h.new_zeros((), dtype=torch.float32)
    n_moe = 0
    sums: Optional[Dict[str, torch.Tensor]] = None
    for i, bp in enumerate(blocks):
        if block_keys is not None:
            k = block_keys[i]
        else:
            k = None if dropout_key is None else fold_in(dropout_key, i)
        if "moe" not in bp:
            h = dense_body(bp, h, k, rope)
            continue
        if collect_metrics:
            h, aux, m = moe_block_forward(
                bp, h, cfg, tp_group=tp_group, sp=sp, ep_group=ep_group,
                dropout_key=k, rope=rope, return_metrics=True,
                cp_group=cp_group)
            sums = m if sums is None else {n: sums[n] + m[n] for n in m}
        else:
            h, aux = moe_body(bp, h, k, rope)
        aux_total = aux_total + aux
        n_moe += 1
    aux_mean = aux_total / max(n_moe, 1)
    if not collect_metrics:
        return h, aux_mean
    if sums is not None:
        sums = {"expert_tokens": sums["expert_tokens"],
                "router_entropy": sums["router_entropy"] / n_moe,
                "dropped_token_rate": sums["dropped_token_rate"] / n_moe}
    return h, aux_mean, sums


def gpt_moe_forward(params: Params, tokens: torch.Tensor, cfg,
                    remat: RematMode = False,
                    dropout_key: Optional[int] = None, tp_group=None,
                    sp: bool = False, ep_group=None,
                    collect_metrics: bool = False, cp_group=None):
    """tokens ``[B, S]`` -> ``(logits [B, S, V], aux)`` (this rank's
    ``[B, S, V / tp]`` with ``tp_group``), ``aux`` the mean load-balance
    loss over the expert blocks; with ``collect_metrics`` also the
    aggregated router counters (:func:`moe_block_stack`).  ``remat``:
    False | True | 'flash' | 'flash_offload', each block checkpointed.
    ``cp_group``: context parallelism, ``tokens`` the rank's sequence
    shard embedded at its global positions (JAX :166)."""
    from .gpt import gpt_embed, gpt_head

    h = gpt_embed(params, tokens, tp_group, cp_group, cfg.cp_layout)
    if tp_group is not None and sp:
        h = split_to_sp(h, tp_group)
    out = moe_block_stack(params["blocks"], h, cfg, tp_group=tp_group, sp=sp,
                          ep_group=ep_group, dropout_key=dropout_key,
                          remat=remat, collect_metrics=collect_metrics,
                          cp_group=cp_group)
    logits = gpt_head(params, out[0], eps=cfg.norm_eps, tp_group=tp_group,
                      sp=sp)
    return (logits,) + tuple(out[1:])


def gpt_moe_loss(params: Params, batch: Dict[str, torch.Tensor], cfg,
                 remat: RematMode = False, dropout_key: Optional[int] = None,
                 tp_group=None, sp: bool = False, ep_group=None,
                 cp_group=None) -> torch.Tensor:
    """Mean next-token cross-entropy plus ``cfg.moe_aux_weight`` x the mean
    load-balance aux (the Switch recipe).  ``batch``: {'tokens',
    'targets'} ``[B, S]``.  ``tp_group`` / ``sp``: tensor / sequence
    parallelism over this rank's shard (:func:`shard_moe_params`);
    ``ep_group``: the expert group this rank's experts are split over.
    Under expert parallelism each rank routes its own rows: the aux is a
    product of per-batch means, so it is the rank's.  ``cp_group``:
    context parallelism (the loss and the aux are the rank's shard's, so
    the context axis is a data axis of the step, as for the dense GPT)."""
    from .gpt import vocab_parallel_xent

    logits, aux = gpt_moe_forward(params, batch["tokens"], cfg, remat=remat,
                                  dropout_key=dropout_key, tp_group=tp_group,
                                  sp=sp, ep_group=ep_group,
                                  cp_group=cp_group)
    ce = vocab_parallel_xent(logits, batch["targets"], tp_group)
    return ce + cfg.moe_aux_weight * aux.to(ce.dtype)


def init_gpt_moe_params(cfg, gen: Optional[torch.Generator] = None,
                        device=None) -> Params:
    """Like :func:`~.gpt.init_gpt_params`, but ``blocks`` is a list with
    the expert blocks' ``mlp`` replaced by ``moe`` — random parameters
    drawn from ``gen`` on ``device`` (default: the card), one block at a
    time."""
    if cfg.moe_experts <= 0:
        raise ValueError("use init_gpt_params for dense models")
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    D, V, dt = cfg.dim, cfg.vocab_size, cfg.dtype
    mcfg = moe_layer_config(cfg)
    out: Params = {"tok_emb": _normal((V, D), 0.02, dt, gen, dev)}
    if cfg.pos == "learned":
        out["pos_emb"] = _normal((cfg.max_seq, D), 0.02, dt, gen, dev)
    blocks: List[Params] = []
    for i in range(cfg.nlayers):
        if is_moe_block(cfg, i):
            bp = init_block_params(gen, cfg.block, device=dev, mlp=False)
            bp["moe"] = init_moe_params(gen, mcfg, device=dev)
        else:
            bp = init_block_params(gen, cfg.block, device=dev)
        blocks.append(bp)
    out["blocks"] = blocks
    out["ln_f"] = init_norm_params(D, dt, cfg.norm, dev)
    out["head"] = _normal((D, V), 1.0 / math.sqrt(D), dt, gen, dev)
    return out


def shard_moe_params(params: Params, cfg, rank: int, size: int,
                     tp_rank: int = 0, tp_size: int = 1) -> Params:
    """Expert-parallel rank ``rank`` of ``size``'s share of an MoE model:
    every expert block's stacked expert leaves cut along E to the rank's
    ``[E / size, ...]`` block (:func:`~..parallel.moe.shard_experts`;
    both halves of an int8 pair); attention, norms, routers, embeddings
    and the head stay whole, as ``gpt_moe_param_specs`` replicates them.
    ``tp_size > 1`` also cuts the tensor-parallel shard of tensor rank
    ``tp_rank`` (``models.gpt.shard_gpt_params``: attention, the
    embedding and the head), the experts replicated over the tensor
    group — JAX ``gpt_moe_param_specs(tp_axis, ep_axis)``.  The slices
    are views of ``params``."""
    if cfg.moe_experts % size != 0:
        raise ValueError(f"num_experts {cfg.moe_experts} not divisible by "
                         f"EP size {size}")
    if tp_size > 1:
        from .gpt import shard_gpt_params

        params = shard_gpt_params(params, cfg, tp_rank, tp_size)
    blocks = [dict(bp, moe=shard_experts(bp["moe"], rank, size))
              if "moe" in bp else bp for bp in params["blocks"]]
    return dict(params, blocks=blocks)


def moe_blocks_param_specs(blocks: List[Params],
                           ep_axis: Optional[str] = None) -> List[Any]:
    """The spec list of a block list (JAX :264): each block's tensor-
    parallel specs (``layers.param_specs``), an expert block's ``moe``
    that of :func:`~..parallel.moe.moe_param_specs` — the router
    replicated, the experts split along E over ``ep_axis`` (replicated
    over the tensor group)."""
    return [dict(sp, moe=moe_param_specs(ep_axis)) if "moe" in bp else sp
            for sp, bp in zip(param_specs(blocks), blocks)]


def gpt_moe_param_specs(params: Params,
                        ep_axis: Optional[str] = None) -> Dict[str, Any]:
    """The spec tree of an MoE param tree (JAX :545), its blocks from
    :func:`moe_blocks_param_specs`: attention, the embedding and the head
    split over the tensor group as in the dense family (an int dim,
    ``layers.TP_SPLIT_DIMS``), the router replicated, the expert leaves
    replicated over the tensor group — the MoE FFN runs whole on every
    tensor rank — and, with ``ep_axis`` (the reference's ``moe_ep``),
    split along E over that axis: their spec is the axis name, which
    every tensor-parallel helper reads as replicated
    (:func:`shard_moe_params` cuts them)."""
    return dict(param_specs(params),
                blocks=moe_blocks_param_specs(params["blocks"], ep_axis))


# ------------------------------------------------------------------ pipeline


def moe_stage_pattern(cfg, pipe_size: int, num_chunks: int = 1
                      ) -> List[bool]:
    """Which positions of a pipeline slab (``nlayers / (P V)`` blocks)
    are expert blocks (JAX :338).  Every slab must have the same pattern
    — the reference runs one program on every stage and chunk, and the
    port keeps its layouts — which holds iff ``moe_every`` divides the
    slab; anything else raises."""
    L = cfg.nlayers
    nslabs = pipe_size * num_chunks
    if L % nslabs:
        raise ValueError(f"nlayers {L} not divisible by pipe*chunks "
                         f"({pipe_size}*{num_chunks})")
    lpp = L // nslabs
    pattern = [is_moe_block(cfg, i) for i in range(lpp)]
    for g in range(1, nslabs):
        for i in range(lpp):
            if is_moe_block(cfg, g * lpp + i) != pattern[i]:
                raise ValueError(
                    f"MoE block placement is not slab-invariant: block "
                    f"{g * lpp + i} (slab {g}, position {i}) differs from "
                    f"block {i}; choose moe_every dividing nlayers/(pipe*V) "
                    f"({lpp}) so every slab holds the same dense/expert "
                    f"pattern")
    return pattern


def moe_stage_params(params: Params, cfg, pp_rank: int, pp_size: int,
                     num_chunks: int = 1) -> Params:
    """Stage ``pp_rank`` of ``pp_size``'s params: its slab of the block
    list, every other leaf whole — the port's ``stack_moe_stage_params``
    (JAX :369), whose stages each hold their own slab: chunk ``v``'s
    blocks are slab ``v P + s`` (the interleaved order), at positions
    ``[v L_c, (v + 1) L_c)`` of the stage's list, ``L_c = nlayers / (P
    V)``.  The blocks are the same objects as ``params``'."""
    if not 0 <= pp_rank < pp_size:
        raise ValueError(f"pp_rank {pp_rank} not in [0, {pp_size})")
    lpp = len(moe_stage_pattern(cfg, pp_size, num_chunks))
    blocks = params["blocks"]
    if len(blocks) != cfg.nlayers:
        raise ValueError(f"a block list of {len(blocks)} for nlayers "
                         f"{cfg.nlayers}")
    return {**params, "blocks": [
        blocks[(v * pp_size + pp_rank) * lpp + i]
        for v in range(num_chunks) for i in range(lpp)]}


def gpt_moe_pipeline_param_specs(params: Params,
                                 pipe_axis: str = "pipe") -> Params:
    """A stage's placement (JAX :517's pipe entries): every leaf of its
    block slab the stage's own (``(pipe_axis,)``), every other leaf
    replicated over the pipe group (None) — what ``pipeline_1f1b(
    param_specs=)`` and the train steps' ``pipe_specs`` read.  The
    tensor split stays :func:`gpt_moe_param_specs`'s; the experts are
    the rank's own."""
    def own(node):
        if isinstance(node, dict):
            return {k: own(v) for k, v in node.items()}
        if isinstance(node, list):
            return [own(v) for v in node]
        return (pipe_axis,)
    return {k: (own(v) if k == "blocks" else None)
            for k, v in params.items()}


def gpt_moe_pipeline_1f1b(params: Params, batch: Dict[str, torch.Tensor],
                          cfg, num_microbatches: int, tp_group=None,
                          pipe_axis: str = "pipe", ep_group=None,
                          sp: bool = False, remat: RematMode = True,
                          dropout_key: Optional[int] = None,
                          num_chunks: int = 1,
                          shard_transfers: Optional[bool] = None,
                          pipe_group=None, cp_group=None):
    """The MoE GPT's 1F1B step core (JAX :405): ``(loss, grads)``
    directly (do not call ``backward``).  ``params``: this stage's
    (:func:`moe_stage_params`; ``num_chunks > 1`` its ``V`` chunks'
    slabs, the interleaved schedule); ``batch``: {'tokens', 'targets'}
    ``[M, mbs, S]``.  A stage's aux rides the schedule's
    ``stage_returns_aux``: ``moe_aux_weight / n_moe`` x the sum of its
    expert blocks' aux, so the loss is ``mean_m [CE_m + moe_aux_weight x
    mean_blocks aux]``, :func:`gpt_moe_loss` a microbatch.  Each
    microbatch routes (and balances, and sizes its capacity on) its own
    rows.  ``ep_group``: the experts split over it, its exchanges in
    every expert block of every microbatch on each EP peer in the same
    schedule order.  ``tp_group`` / ``sp`` / ``shard_transfers`` /
    ``dropout_key`` (folding stage, microbatch, block[, chunk]) and
    ``cp_group`` as ``models.gpt_pipeline_1f1b`` (JAX :455)."""
    from ..parallel.pipeline_parallel import pipeline_1f1b, stage_index
    from .gpt import gpt_embed, gpt_head, vocab_parallel_xent

    if shard_transfers is None:
        shard_transfers = tp_group is not None and not sp
    n_moe = sum(1 for i in range(cfg.nlayers) if is_moe_block(cfg, i))
    aux_scale = cfg.moe_aux_weight / max(n_moe, 1)
    lc = len(params["blocks"]) // num_chunks
    stage = stage_index(pipe_axis, pipe_group)

    def first_fn(p, toks):
        h = gpt_embed(p, toks, tp_group, cp_group, cfg.cp_layout)
        return split_to_sp(h, tp_group) if tp_group is not None and sp else h

    def run_blocks(blocks, x, m, v=None):
        keys = None
        if dropout_key is not None and cfg.dropout_rate > 0.0:
            # the reference's fold order: stage, microbatch, block[, chunk]
            base = fold_in(fold_in(dropout_key, stage), m)
            keys = [fold_in(base, i) if v is None
                    else fold_in(fold_in(base, i), v)
                    for i in range(len(blocks))]
        x, aux_mean = moe_block_stack(blocks, x, cfg, tp_group=tp_group,
                                      sp=sp, ep_group=ep_group, remat=remat,
                                      block_keys=keys, cp_group=cp_group)
        n_stage = sum(1 for bp in blocks if "moe" in bp)
        return x, (aux_scale * n_stage) * aux_mean

    if num_chunks == 1:
        def stage_fn(p, x, m):
            return run_blocks(p["blocks"], x, m)
    else:
        def stage_fn(p, x, m, v):
            return run_blocks(p["blocks"][v * lc:(v + 1) * lc], x, m, v)

    def last_fn(p, y, tgt):
        logits = gpt_head(p, y, eps=cfg.norm_eps, tp_group=tp_group, sp=sp)
        return vocab_parallel_xent(logits, tgt, tp_group)

    return pipeline_1f1b(
        params, batch["tokens"], batch["targets"], first_fn=first_fn,
        stage_fn=stage_fn, last_fn=last_fn,
        num_microbatches=num_microbatches, pipe_axis=pipe_axis,
        stage_takes_mb=True, stage_returns_aux=True, num_chunks=num_chunks,
        pipe_group=pipe_group,
        param_specs=gpt_moe_pipeline_param_specs(params, pipe_axis),
        transfer_shard_group=tp_group if shard_transfers else None)
