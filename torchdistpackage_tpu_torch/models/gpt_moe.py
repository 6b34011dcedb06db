"""The MoE GPT family — the serving subset of
``torchdistpackage_tpu/models/gpt_moe.py``: :func:`moe_layer_config`
(:69), :func:`is_moe_block` (:86) and :func:`init_gpt_moe_params` (:308).

Every ``cfg.moe_every``-th block's FFN is an expert layer.  Blocks are a
heterogeneous Python list of per-block param dicts — dense blocks carry
``mlp``, expert blocks ``moe`` (``router`` + stacked ``experts``) — so a
forward walks the list instead of indexing stacked leaves.  The serving
forward over this list is ``serving/paged_cache.py``'s
:func:`~..serving.paged_cache.paged_forward_moe`.  ``gpt_moe_forward``,
``gpt_moe_loss`` and the MoE pipeline wait for MoE training (ROADMAP
queue A).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from ..device import resolve_device
from ..parallel.moe import MoEConfig, init_moe_params, shard_experts
from ..parallel.tensor_parallel.layers import (
    _normal,
    init_block_params,
    init_norm_params,
)

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


def shard_moe_params(params: Params, cfg, rank: int, size: int) -> Params:
    """Expert-parallel rank ``rank`` of ``size``'s share of an MoE model:
    every expert block's stacked expert leaves cut along E to the rank's
    ``[E / size, ...]`` block (:func:`~..parallel.moe.shard_experts`;
    both halves of an int8 pair); attention, norms, routers, embeddings
    and the head stay whole, as ``gpt_moe_param_specs`` replicates them.
    The slices are views of ``params``."""
    if cfg.moe_experts % size != 0:
        raise ValueError(f"num_experts {cfg.moe_experts} not divisible by "
                         f"EP size {size}")
    blocks = [dict(bp, moe=shard_experts(bp["moe"], rank, size))
              if "moe" in bp else bp for bp in params["blocks"]]
    return dict(params, blocks=blocks)
