"""The Vision Transformer — the PyTorch counterpart of
``torchdistpackage_tpu/models/vit.py``: :class:`ViTConfig` (:41),
:func:`patchify` (:98), :func:`init_vit_params` (:108),
:func:`vit_embed` (:131), :func:`vit_pool_logits` (:161),
:func:`vit_forward` (:183), :func:`vit_loss` (:206),
:func:`vit_param_specs` (:228) and :func:`vit_pipeline_1f1b` (:251).

Built from the GPT family's blocks (non-causal attention): patchify is
a reshape and the patch projection one matmul, the head a mean pool over
the patches then a class projection.  Tensor (and sequence) parallelism
over ``tp_group`` splits the blocks as the GPT's and the class head on
its classes; the loss closes with the vocabulary-parallel
cross-entropy.

Context parallelism (``cp_group``, ``attn_impl`` ``'ring'`` /
``'ulysses'``): each rank embeds its contiguous chunk of the patches,
the blocks run the non-causal ring (or Ulysses) over the group, and the
pool is the mean of the ranks' means, so the loss is the same on every
rank.  The context axis is then a MODEL axis (the reference's
``vit.py:283-293``): the leaves before the pool see only the rank's
patches, the class head after it sees the whole pooled vector.  The
port's design: the pool's backward hands each rank ``1 / cp`` of the
cotangent (its share of the mean), and every leaf used before the pool
(the patch projection, ``pos_emb``, the blocks, ``ln_f``) enters the
forward through ``copy_to_tp`` over the context group, whose backward
sums the ranks' shares.  Every leaf's grad, the head's included, then
comes out whole and equal on every rank of the group — the serial
model's — and a train step treats ``context`` as a model axis
(``DataParallel(axis='data')``), with no rescale.

One deliberate match of the reference: ``ln_f`` runs at the norm's
default eps (1e-5), whatever ``norm_eps`` the blocks take (JAX :175
passes none); the ViT config has no eps of its own, so the two agree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

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
)
from ..parallel.tensor_parallel.tp_utils import (
    copy_to_tp,
    gather_from_sp,
    reduce_from_tp,
    split_to_sp,
)

Params = Dict[str, Any]
_CP_IMPLS = ("ring", "ulysses")


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """The reference's ``ViTConfig`` (its defaults: ViT-S/16 at 224).
    ``attn_impl`` ``'naive'`` | ``'flash'`` | ``'ring'`` | ``'ulysses'``
    (the last two context parallel over the ``cp_group`` the entry points
    take; non-causal).  The MoE fields drive ``models.vit_moe`` (V-MoE
    style; an encoder, so the expert-choice router is allowed)."""

    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    num_classes: int = 1000
    dim: int = 384
    nheads: int = 6
    nlayers: int = 12
    ffn_mult: int = 4
    dtype: torch.dtype = torch.float32
    attn_impl: str = "naive"
    dropout_rate: float = 0.0
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    moe_router: str = "topk"
    moe_dispatch: str = "auto"
    norm: str = "layer"
    act: str = "gelu"

    def __post_init__(self):
        if not isinstance(self.dtype, torch.dtype):
            raise TypeError(f"dtype must be a torch.dtype, got {self.dtype!r}")
        if self.image_size % self.patch_size:
            raise ValueError(f"image_size {self.image_size} not divisible by "
                             f"patch_size {self.patch_size}")
        self.block  # validates the block fields

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels

    @property
    def block(self) -> TransformerConfig:
        return TransformerConfig(
            dim=self.dim, nheads=self.nheads, nlayers=self.nlayers,
            ffn_mult=self.ffn_mult, causal=False, dtype=self.dtype,
            attn_impl=self.attn_impl, dropout_rate=self.dropout_rate,
            norm=self.norm, act=self.act)

    def num_params(self) -> int:
        """Parameters of the dense ViT (``init_vit_params``)."""
        D, Fd = self.dim, self.block.ffn_dim
        norm = D if self.norm == "rms" else 2 * D
        mlp = (3 * D * Fd + 2 * Fd + D) if self.act == "swiglu" else (
            2 * D * Fd + Fd + D)
        per_block = 3 * D * D + 3 * D + D * D + D + 2 * norm + mlp
        return (self.patch_dim * D + D + self.num_patches * D
                + self.nlayers * per_block + norm
                + D * self.num_classes + self.num_classes)


def _cp(cfg: ViTConfig, cp_group):
    """The context group the forward runs over, or None; a group with an
    attention that is not context parallel raises."""
    if cp_group is None:
        return None
    if cfg.attn_impl not in _CP_IMPLS:
        raise ValueError(
            f"a cp_group needs attn_impl 'ring' or 'ulysses' (got "
            f"{cfg.attn_impl!r})")
    return cp_group


def _pre_pool(tree, cp_group):
    """``tree``'s tensors through ``copy_to_tp`` over the context group:
    the identity, whose backward sums each rank's share of the grad of a
    leaf used before the pool (see the module note)."""
    if cp_group is None:
        return tree
    if isinstance(tree, dict):
        return {k: _pre_pool(v, cp_group) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pre_pool(v, cp_group) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_pre_pool(v, cp_group) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.requires_grad:
        return copy_to_tp(tree, cp_group)
    return tree


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, P P C] non-overlapping patches, row-major
    over the patch grid (JAX :98)."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def init_vit_params(cfg: ViTConfig, gen: Optional[torch.Generator] = None,
                    device=None) -> Params:
    """Random parameters drawn from ``gen`` on ``device`` (default: the
    card), the reference's tree and scales: ``patch_proj`` {w [P P C,
    D] ~ N(0, 1 / (P P C)), b}, ``pos_emb`` [N, D] ~ 0.02 N, the
    layer-stacked ``blocks``, ``ln_f`` and ``head`` {w [D, classes] ~
    N(0, 1 / D), b}.  The draws differ from JAX's; parity tests carry
    JAX's weights over with ``models.convert.vit_params_from_jax``."""
    if cfg.moe_experts:
        raise ValueError("an MoE config has a per-block list: use "
                         "models.vit_moe.init_vit_moe_params")
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    out = _vit_ends(cfg, gen, dev)
    blocks = [init_block_params(gen, cfg.block, device=dev)
              for _ in range(cfg.nlayers)]
    out["blocks"] = _stack(blocks)
    return out


def _vit_ends(cfg: ViTConfig, gen, dev) -> Params:
    """Every leaf but the blocks (shared with the MoE family's init)."""
    D, dt = cfg.dim, cfg.dtype
    return {
        "patch_proj": {
            "w": _normal((cfg.patch_dim, D), 1.0 / math.sqrt(cfg.patch_dim),
                         dt, gen, dev),
            "b": torch.zeros(D, dtype=dt, device=dev)},
        "pos_emb": _normal((cfg.num_patches, D), 0.02, dt, gen, dev),
        "ln_f": init_norm_params(D, dt, cfg.norm, dev),
        "head": {
            "w": _normal((D, cfg.num_classes), 1.0 / math.sqrt(D), dt, gen,
                         dev),
            "b": torch.zeros(cfg.num_classes, dtype=dt, device=dev)},
    }


def _stack(blocks):
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return torch.stack(blocks)


def vit_embed(params: Params, images: torch.Tensor, cfg: ViTConfig,
              cp_group=None) -> torch.Tensor:
    """[B, H, W, C] images -> [B, N, D] patch embeddings (JAX :131).
    ``cp_group``: this rank's contiguous chunk of the N patches, sliced
    before the projection, with its rows of ``pos_emb``."""
    x = patchify(images.to(cfg.dtype), cfg.patch_size)
    pos = params["pos_emb"]
    if _cp(cfg, cp_group) is not None:
        n = dist.get_world_size(cp_group)
        if x.shape[1] % n:
            raise ValueError(
                f"num_patches {x.shape[1]} not divisible by context-parallel "
                f"size {n} — trailing patches would be silently dropped")
        s = x.shape[1] // n
        off = dist.get_rank(cp_group) * s
        x, pos = x[:, off:off + s], pos[off:off + s]
    return x @ params["patch_proj"]["w"] + params["patch_proj"]["b"] + pos


def vit_pool_logits(params: Params, h: torch.Tensor, cfg: ViTConfig,
                    tp_group=None, sp: bool = False,
                    cp_group=None) -> torch.Tensor:
    """Hidden after the blocks -> logits [B, classes] (this rank's [B,
    classes / tp] with ``tp_group``) (JAX :161): the final norm, the mean
    over the patches, the class head.  Under ``sp`` the normed rows are
    gathered first (the gather's backward sums the ranks' partial
    cotangents, as the GPT head's); ``cp_group``: the mean of the ranks'
    means, whose backward hands each rank ``1 / cp`` of the cotangent."""
    h = layer_norm(h, params["ln_f"])
    if tp_group is not None and sp:
        h = gather_from_sp(h, tp_group)
    pooled = h.float().mean(dim=1).to(h.dtype)
    if _cp(cfg, cp_group) is not None:
        pooled = reduce_from_tp(pooled, cp_group) / dist.get_world_size(
            cp_group)
    if tp_group is not None and not sp:
        pooled = _open_column_parallel(pooled, tp_group, False)
    return dense(pooled, params["head"]["w"], params["head"]["b"])


def vit_forward(params: Params, images: torch.Tensor, cfg: ViTConfig,
                tp_group=None, sp: bool = False, remat: RematMode = False,
                dropout_key: Optional[int] = None,
                cp_group=None) -> torch.Tensor:
    """[B, H, W, C] images -> logits [B, classes] (JAX :183); ``tp_group``
    / ``sp`` / ``remat`` / ``dropout_key`` as ``models.gpt_forward``,
    ``cp_group`` as the module note says."""
    cp_group = _cp(cfg, cp_group)
    pre = _pre_pool({k: params[k] for k in ("patch_proj", "pos_emb",
                                             "blocks", "ln_f")}, cp_group)
    h = vit_embed(pre, images, cfg, cp_group)
    if tp_group is not None and sp:
        h = split_to_sp(h, tp_group)
    h = scan_blocks(pre["blocks"], h, cfg.block, remat=remat,
                    dropout_key=dropout_key, tp_group=tp_group, sp=sp,
                    cp_group=cp_group)
    return vit_pool_logits(dict(pre, head=params["head"]), h, cfg,
                           tp_group=tp_group, sp=sp, cp_group=cp_group)


def vit_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ViTConfig,
             tp_group=None, sp: bool = False, remat: RematMode = False,
             dropout_key: Optional[int] = None,
             cp_group=None) -> torch.Tensor:
    """Mean softmax cross-entropy of ``batch`` {'images': [B, H, W, C],
    'labels': int [B]} (JAX :206); class-parallel with ``tp_group``."""
    from .gpt import vocab_parallel_xent

    logits = vit_forward(params, batch["images"], cfg, tp_group=tp_group,
                         sp=sp, remat=remat, dropout_key=dropout_key,
                         cp_group=cp_group)
    return vocab_parallel_xent(logits, batch["labels"], tp_group)


def vit_param_specs(params: Params) -> Params:
    """The tensor-parallel spec tree of a ViT tree (JAX :228): the blocks
    as the GPT's (``layers.param_specs``), the class head split on its
    classes (``w`` and ``b``, dim -1), ``patch_proj`` and ``pos_emb``
    replicated, ``ln_f`` replicated with its grad partial under SP.  The
    MoE family's blocks: ``models.vit_moe.vit_moe_param_specs``."""
    specs = param_specs(params)
    specs["head"] = {"w": -1, "b": -1}
    return specs


def vit_pipeline_1f1b(params: Params, batch: Dict[str, torch.Tensor],
                      cfg: ViTConfig, num_microbatches: int, tp_group=None,
                      pipe_axis: str = "pipe", sp: bool = False,
                      remat: RematMode = True,
                      dropout_key: Optional[int] = None, pipe_group=None,
                      cp_group=None):
    """The 1F1B ViT step's core (JAX :251): ``(loss, grads)`` directly (do
    not call ``backward``).  ``params``: this stage's (its ``[L / P,
    ...]`` block slab, every other leaf whole: ``models.pipe_slab``);
    ``batch``: {'images': [M, mbs, H, W, C], 'labels': int [M, mbs]}.
    Stage 0 embeds, every stage scans its slab, the last pools and
    classifies.  ``dropout_key`` folds (stage, microbatch), then the
    layer.  ``cp_group``: the context group, a model axis (module note:
    each leaf's grad comes out whole on every rank of it); the stages of
    one context rank form the pipe group."""
    from ..parallel.pipeline_parallel import pipeline_1f1b, stage_index
    from ..utils.random import fold_in
    from .gpt import _pipe_block_specs, vocab_parallel_xent

    cp_group = _cp(cfg, cp_group)
    stage = stage_index(pipe_axis, pipe_group)

    def first_fn(p, images):
        pre = _pre_pool({k: p[k] for k in ("patch_proj", "pos_emb")},
                        cp_group)
        h = vit_embed(pre, images, cfg, cp_group)
        return split_to_sp(h, tp_group) if tp_group is not None and sp else h

    def stage_fn(p, x, m):
        k = None
        if dropout_key is not None and cfg.dropout_rate > 0.0:
            k = fold_in(fold_in(dropout_key, stage), m)
        return scan_blocks(_pre_pool(p["blocks"], cp_group), x, cfg.block,
                           remat=remat, dropout_key=k, tp_group=tp_group,
                           sp=sp, cp_group=cp_group)

    def last_fn(p, y, labels):
        p = dict(p, ln_f=_pre_pool(p["ln_f"], cp_group))
        logits = vit_pool_logits(p, y, cfg, tp_group=tp_group, sp=sp,
                                 cp_group=cp_group)
        return vocab_parallel_xent(logits, labels, tp_group)

    return pipeline_1f1b(
        params, batch["images"], batch["labels"], first_fn=first_fn,
        stage_fn=stage_fn, last_fn=last_fn,
        num_microbatches=num_microbatches, pipe_axis=pipe_axis,
        stage_takes_mb=True, pipe_group=pipe_group,
        param_specs=_pipe_block_specs(params, pipe_axis))
