"""Training numerics — the port's counterpart of
``torchdistpackage_tpu/obs/numerics.py`` (single device so far)."""

from __future__ import annotations

from typing import Any, Iterator

import torch


def tree_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict / list tree, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif tree is not None:
        yield tree


def global_grad_norm(tree: Any) -> torch.Tensor:
    """Global L2 norm of every leaf of ``tree``: the square root of the sum
    of each leaf's f32 sum of squares, as the reference computes it.  A
    0-dim f32 tensor on the leaves' device (no host sync)."""
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    if not sq:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(torch.stack(sq).sum())
