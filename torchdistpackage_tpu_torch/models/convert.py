"""Carry a parameter tree of the JAX package over to the port.

The port keeps the reference's layouts leaf for leaf (``[in, out]``
weights, block leaves stacked ``[L, ...]``, the Llama preset's zero
biases), so the conversion is a dtype-preserving copy of every array —
after which the port and the JAX package compute the same function on the
same weights, which is what the parity tests rely on.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device
from .gpt import GPTConfig


def params_from_jax(np_tree: Dict[str, Any], cfg: GPTConfig,
                    device=None) -> Dict[str, Any]:
    """``np_tree``: the JAX param pytree with every leaf already turned
    into a numpy array (``jax.tree.map(np.asarray, params)`` on the JAX
    side — this module never imports JAX).  Returns the port's dict with
    each leaf a tensor of ``cfg.dtype`` on ``device`` (default: the
    card).  bfloat16 leaves (numpy's ``ml_dtypes`` extension type) pass
    through float32, which holds every bfloat16 value exactly."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            raise TypeError(
                "expected the stacked-blocks tree of init_gpt_params "
                "(dict leaves), got a list")
        arr = np.asarray(x)
        if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=dev, dtype=cfg.dtype)

    out = conv(dict(np_tree))
    want = {"tok_emb", "blocks", "ln_f", "head"}
    if cfg.pos == "learned":
        want.add("pos_emb")
    if set(out) != want:
        raise ValueError(
            f"param tree keys {sorted(out)} do not match the config "
            f"(expected {sorted(want)})")
    return out
