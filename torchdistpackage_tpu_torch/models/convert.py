"""Carry a parameter tree of the JAX package over to the port.

The port keeps the reference's layouts leaf for leaf (``[in, out]``
weights, block leaves stacked ``[L, ...]``, the Llama preset's zero
biases; the MoE family's per-block list with its stacked ``[E, ...]``
expert leaves; the int8 weight-only leaves), so the conversion is a
value-preserving copy of every array — after which the port and the JAX
package compute the same function on the same weights, which is what the
parity tests rely on.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.moe import shard_experts
from ..tools.surgery import QuantizedLinear, is_int8_weight
from .gpt import GPTConfig, shard_gpt_params


def _tensor(x, device, dtype=None) -> torch.Tensor:
    """One numpy array as a tensor on ``device``, of ``dtype`` or (None)
    of its own dtype.  bfloat16 (numpy's ``ml_dtypes`` extension type)
    passes through float32, which holds every bfloat16 value exactly."""
    arr = np.asarray(x)
    own = None
    if arr.dtype.name == "bfloat16":
        arr, own = arr.astype(np.float32), torch.bfloat16
    t = torch.from_numpy(np.array(arr, order="C"))  # a writable copy
    return t.to(device=device, dtype=dtype or own or t.dtype)


def params_from_jax(np_tree: Dict[str, Any], cfg: GPTConfig,
                    device=None, ep_rank: int = 0, ep_size: int = 1,
                    tp_rank: int = 0, tp_size: int = 1, pp_rank: int = 0,
                    pp_size: int = 1, num_chunks: int = 1) -> Dict[str, Any]:
    """``np_tree``: the JAX param pytree with every leaf already turned
    into a numpy array (``jax.tree.map(np.asarray, params)`` on the JAX
    side — this module never imports JAX).  Returns the port's dict with
    each float leaf a tensor of ``cfg.dtype`` on ``device`` (default: the
    card).  int8 weight-only leaves keep their dtypes (int8 weights, their
    scales' own float type): an ``ops.moe_dispatch.quantize_moe_experts``
    ``(q8, scale)`` expert pair stays a tuple of two tensors, and a
    ``tools.surgery.QuantizedLinear`` node of the reference (recognised by
    its ``q`` / ``scale`` attributes, whatever its class) becomes the
    port's :class:`~..tools.surgery.QuantizedLinear`.

    ``blocks`` is the dense family's stacked dict, or — for an MoE config
    (``cfg.moe_experts > 0``) — the per-block list of
    ``init_gpt_moe_params``, one dict per block, kept a list.
    ``ep_size > 1`` converts only expert-parallel rank ``ep_rank``'s
    share: each expert block's stacked expert leaves cut along E to the
    rank's ``[E / ep_size, ...]`` block before they are copied (as
    ``models.gpt_moe.shard_moe_params`` cuts a whole tree).
    ``tp_size > 1`` converts only tensor-parallel rank ``tp_rank``'s
    shard: ``models.gpt.shard_gpt_params`` cuts the numpy tree before the
    copy (an int8 leaf the table splits raises: the reference's specs
    shard none).  Both at once give rank ``(ep_rank, tp_rank)``'s share
    of an MoE tree, JAX ``gpt_moe_param_specs(tp_axis, ep_axis)``:
    attention, the embedding and the head cut over the tensor group, the
    experts cut along E over the expert group and replicated over the
    tensor group (so an int8 expert pair passes).

    ``pp_size > 1`` (or ``num_chunks > 1``) converts pipeline stage
    ``pp_rank``'s params: the dense family's slab of the stacked block
    leaves, or an MoE tree's slab of its block list
    (``models.gpt_moe.moe_stage_params``) — from the serial list, or from
    JAX's pipeline layout (``stack_moe_stage_params``: a list of ``L / (P
    V)`` positions whose leaves are stacked ``[P, ...]``, or ``[V, P,
    ...]`` interleaved), whose stage slices are taken first."""
    dev = resolve_device(device)
    if ep_size > 1 and not cfg.moe_experts:
        raise ValueError(f"EP size {ep_size} needs an MoE config")
    blocks = np_tree.get("blocks")
    nslabs, stages = pp_size * num_chunks, pp_size
    if (isinstance(blocks, (list, tuple)) and nslabs > 1
            and len(blocks) * nslabs == cfg.nlayers):
        np_tree = dict(np_tree, blocks=_jax_stage_slab(
            blocks, pp_rank, pp_size, num_chunks))
        pp_size = num_chunks = 1
    if tp_size > 1 or pp_size > 1 or num_chunks > 1:
        np_tree = shard_gpt_params(np_tree, cfg, tp_rank, tp_size,
                                   pp_rank=pp_rank, pp_size=pp_size,
                                   num_chunks=num_chunks)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, tuple):
            if len(x) != 2 or np.asarray(x[0]).dtype != np.int8:
                raise TypeError(
                    "a tuple leaf must be an int8 (q8, scale) expert pair")
            return tuple(_tensor(a, dev) for a in x)
        if is_int8_weight(x):
            return QuantizedLinear(_tensor(x.q, dev), _tensor(x.scale, dev))
        return _tensor(x, dev, cfg.dtype)

    tree = dict(np_tree)
    blocks = tree.pop("blocks", None)
    out = conv(tree)
    if isinstance(blocks, (list, tuple)):
        if not cfg.moe_experts or len(blocks) * stages != cfg.nlayers:
            raise TypeError(
                f"a per-block list of {len(blocks)} blocks needs an MoE "
                f"config of as many layers (moe_experts "
                f"{cfg.moe_experts}, nlayers {cfg.nlayers})")
        if ep_size > 1:
            blocks = [dict(b, moe=shard_experts(b["moe"], ep_rank, ep_size))
                      if "moe" in b else b for b in blocks]
        out["blocks"] = [conv(dict(b)) for b in blocks]
    elif blocks is not None:
        if cfg.moe_experts:
            raise TypeError("an MoE config needs the per-block list of "
                            "init_gpt_moe_params, got stacked blocks")
        out["blocks"] = conv(blocks)
    want = {"tok_emb", "blocks", "ln_f", "head"}
    if cfg.pos == "learned":
        want.add("pos_emb")
    if set(out) != want:
        raise ValueError(
            f"param tree keys {sorted(out)} do not match the config "
            f"(expected {sorted(want)})")
    return out



def _jax_stage_slab(blocks, pp_rank: int, pp_size: int, num_chunks: int):
    """Stage ``pp_rank``'s block list from JAX's MoE pipeline layout:
    position ``i``'s leaves ``[P, ...]`` (or ``[V, P, ...]``) sliced to the
    stage, chunk-major — the order of ``moe_stage_params``."""
    def take(node, v):
        if isinstance(node, dict):
            return {k: take(a, v) for k, a in node.items()}
        a = np.asarray(node)
        return a[pp_rank] if num_chunks == 1 else a[v, pp_rank]
    return [take(b, v) for v in range(num_chunks) for b in blocks]


def vit_params_from_jax(np_tree: Dict[str, Any], cfg, device=None,
                        ep_rank: int = 0, ep_size: int = 1,
                        tp_rank: int = 0, tp_size: int = 1,
                        pp_rank: int = 0, pp_size: int = 1
                        ) -> Dict[str, Any]:
    """:func:`params_from_jax` for the ViT families (``models.vit``,
    ``models.vit_moe``): ``np_tree`` is JAX's ``init_vit_params`` /
    ``init_vit_moe_params`` tree with numpy leaves — ``patch_proj`` {w,
    b}, ``pos_emb``, the stacked ``blocks`` (or, with
    ``cfg.moe_experts``, the per-block list), ``ln_f`` and ``head`` {w,
    b}.  Every float leaf becomes a tensor of ``cfg.dtype`` on ``device``
    (default: the card).  ``tp_size > 1``: tensor rank ``tp_rank``'s
    shard (``vit_param_specs`` / ``vit_moe_param_specs``: the blocks as
    the GPT's, the head on its classes); ``ep_size > 1``: each expert
    block's experts cut to rank ``ep_rank``'s ``[E / ep_size, ...]``;
    ``pp_size > 1``: stage ``pp_rank``'s slab of the blocks, every other
    leaf whole."""
    from ..parallel.tensor_parallel.layers import shard_params
    from .gpt import pipe_slab
    from .gpt_moe import moe_stage_params
    from .vit import vit_param_specs
    from .vit_moe import vit_moe_param_specs

    dev = resolve_device(device)
    moe = isinstance(np_tree.get("blocks"), (list, tuple))
    if moe != bool(cfg.moe_experts):
        raise TypeError(
            f"a {'per-block list' if moe else 'stacked block tree'} for a "
            f"config with moe_experts={cfg.moe_experts}")
    if ep_size > 1 and not moe:
        raise ValueError(f"EP size {ep_size} needs an MoE config")
    tree = dict(np_tree, blocks=list(np_tree["blocks"])) if moe else np_tree
    if tp_size > 1:
        specs = vit_moe_param_specs(tree) if moe else vit_param_specs(tree)
        tree = shard_params(tree, specs, tp_rank, tp_size)
    if pp_size > 1:
        tree = (moe_stage_params(tree, cfg, pp_rank, pp_size) if moe
                else pipe_slab(tree, pp_rank, pp_size))
    if ep_size > 1:
        tree = dict(tree, blocks=[
            dict(b, moe=shard_experts(b["moe"], ep_rank, ep_size))
            if "moe" in b else b for b in tree["blocks"]])

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        return _tensor(x, dev, cfg.dtype)

    out = conv(dict(tree))
    want = {"patch_proj", "pos_emb", "blocks", "ln_f", "head"}
    if set(out) != want:
        raise ValueError(f"param tree keys {sorted(out)} do not match a ViT "
                         f"(expected {sorted(want)})")
    return out
