"""ViT-MoE: the encoder MoE family (V-MoE style) — the PyTorch
counterpart of ``torchdistpackage_tpu/models/vit_moe.py``.

Every ``cfg.moe_every``-th ViT block's FFN is the expert layer of
``parallel/moe.py``, run by the GPT-MoE family's block loop
(``models.gpt_moe.moe_block_stack``) with ``causal=False`` (the ViT
block's), so both routers are open: top-k (K6 under autograd on the
card, by ``moe_forward``'s ``'auto'``) and expert choice (the plain
arm, as in the reference).  The experts split over an expert group with
``ep_group=``, each rank routing its own images' patches.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..device import resolve_device
from ..parallel.moe import init_moe_params
from ..parallel.tensor_parallel.layers import RematMode, init_block_params
from ..parallel.tensor_parallel.tp_utils import split_to_sp
from .gpt_moe import (
    is_moe_block,
    moe_block_stack,
    moe_blocks_param_specs,
    moe_layer_config,
)
from .vit import (
    ViTConfig,
    _vit_ends,
    vit_embed,
    vit_param_specs,
    vit_pool_logits,
)

Params = Dict[str, Any]


def init_vit_moe_params(cfg: ViTConfig, gen: Optional[torch.Generator] = None,
                        device=None) -> Params:
    """Like ``models.vit.init_vit_params``, but ``blocks`` is a list with
    the expert blocks' ``mlp`` replaced by ``moe`` (router + stacked
    experts), drawn from ``gen`` on ``device`` (default: the card)."""
    if cfg.moe_experts <= 0:
        raise ValueError("use init_vit_params for dense models")
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    mcfg = moe_layer_config(cfg)
    out = _vit_ends(cfg, gen, dev)
    blocks: List[Params] = []
    for i in range(cfg.nlayers):
        if is_moe_block(cfg, i):
            bp = init_block_params(gen, cfg.block, device=dev, mlp=False)
            bp["moe"] = init_moe_params(gen, mcfg, device=dev)
        else:
            bp = init_block_params(gen, cfg.block, device=dev)
        blocks.append(bp)
    out["blocks"] = blocks
    return out


def vit_moe_forward(params: Params, images: torch.Tensor, cfg: ViTConfig,
                    tp_group=None, sp: bool = False, ep_group=None,
                    dropout_key: Optional[int] = None,
                    remat: RematMode = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W, C] images -> ``(logits [B, classes], aux)``, ``aux`` the
    mean load-balance loss over the expert blocks (0 under expert
    choice).  ``ep_group``: the expert group the experts split over.  No
    context group, as in the reference: each rank's aux would be the mean
    over its own patches, a loss that differs across the group."""
    h = vit_embed(params, images, cfg)
    if tp_group is not None and sp:
        h = split_to_sp(h, tp_group)
    h, aux = moe_block_stack(params["blocks"], h, cfg, tp_group=tp_group,
                             sp=sp, ep_group=ep_group,
                             dropout_key=dropout_key, remat=remat)
    logits = vit_pool_logits(params, h, cfg, tp_group=tp_group, sp=sp)
    return logits, aux


def vit_moe_loss(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: ViTConfig, tp_group=None, sp: bool = False,
                 ep_group=None, dropout_key: Optional[int] = None,
                 remat: RematMode = False) -> torch.Tensor:
    """Mean cross-entropy plus ``cfg.moe_aux_weight`` x the mean aux.
    ``batch``: {'images': [B, H, W, C], 'labels': int [B]}."""
    from .gpt import vocab_parallel_xent

    logits, aux = vit_moe_forward(params, batch["images"], cfg,
                                  tp_group=tp_group, sp=sp, ep_group=ep_group,
                                  dropout_key=dropout_key, remat=remat)
    ce = vocab_parallel_xent(logits, batch["labels"], tp_group)
    return ce + cfg.moe_aux_weight * aux.to(ce.dtype)


def vit_moe_param_specs(params: Params,
                        ep_axis: Optional[str] = None) -> Params:
    """``models.vit.vit_param_specs``' ends and the MoE families' per-block
    spec list (``moe_blocks_param_specs``: the experts split along E over
    ``ep_axis``)."""
    specs = vit_param_specs({k: v for k, v in params.items()
                             if k != "blocks"})
    specs["blocks"] = moe_blocks_param_specs(params["blocks"], ep_axis)
    return specs
