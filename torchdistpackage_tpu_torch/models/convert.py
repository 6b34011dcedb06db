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
from .gpt import GPTConfig


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
                    device=None, ep_rank: int = 0,
                    ep_size: int = 1) -> Dict[str, Any]:
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
    ``models.gpt_moe.shard_moe_params`` cuts a whole tree)."""
    dev = resolve_device(device)
    if ep_size > 1 and not cfg.moe_experts:
        raise ValueError(f"EP size {ep_size} needs an MoE config")

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
        if not cfg.moe_experts or len(blocks) != cfg.nlayers:
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
