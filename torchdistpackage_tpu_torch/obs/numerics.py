"""Training numerics — the port's counterpart of
``torchdistpackage_tpu/obs/numerics.py`` (single device so far)."""

from __future__ import annotations

from typing import Any, Iterator

import torch

from ..tools.surgery import is_int8_weight


def tree_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict / list / tuple tree, in insertion
    order; an int8 weight node (``tools.surgery.QuantizedLinear``) gives
    its two tensors."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif is_int8_weight(tree):
        yield tree.q
        yield tree.scale
    elif tree is not None:
        yield tree


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor of ``tree`` (int8 weights and their scales
    counted as stored)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def global_grad_norm(tree: Any) -> torch.Tensor:
    """Global L2 norm of every leaf of ``tree``: the square root of the sum
    of each leaf's f32 sum of squares, as the reference computes it.  A
    0-dim f32 tensor on the leaves' device (no host sync)."""
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    if not sq:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(torch.stack(sq).sum())
