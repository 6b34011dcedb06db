"""Greedy numel-balanced parameter partitioning — the port's counterpart
of ``torchdistpackage_tpu/utils/partition.py``.

Leaves are named by their ``/``-joined key path (``blocks/attn/wqkv``),
as the reference names a pytree path, so both give the identical
partition on the same tree: largest leaf first onto the lightest part,
ties broken by ``(load, index)``, each part sorted by name.
"""

from __future__ import annotations

import heapq
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np


def named_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of a nested dict / list / tuple tree, the path
    ``/``-joined (list items by index)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from named_leaves(v, f"{prefix}/{k}" if prefix else str(k))


def _numel(x) -> int:
    return int(x.numel()) if hasattr(x, "numel") else int(np.size(x))


def partition_params(params: Any, num_partitions: int,
                     return_dict: bool = False):
    """Split ``params``' leaves into ``num_partitions`` numel-balanced
    groups: a list of lists of ``(name, leaf)`` pairs (or ``{name:
    leaf}`` dicts with ``return_dict``), computed identically on every
    process."""
    if num_partitions < 1:
        raise ValueError("num_partitions must be >= 1")
    named = list(named_leaves(params))
    order = sorted(named, key=lambda kv: (-_numel(kv[1]), kv[0]))
    heap: List[Tuple[int, int]] = [(0, i) for i in range(num_partitions)]
    heapq.heapify(heap)
    parts: List[List[Tuple[str, Any]]] = [[] for _ in range(num_partitions)]
    for name, leaf in order:
        load, idx = heapq.heappop(heap)
        parts[idx].append((name, leaf))
        heapq.heappush(heap, (load + _numel(leaf), idx))
    for p in parts:
        p.sort(key=lambda kv: kv[0])
    if return_dict:
        out: List[Dict[str, Any]] = [dict(p) for p in parts]
        return out
    return parts
