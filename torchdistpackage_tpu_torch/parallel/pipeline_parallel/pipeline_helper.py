"""Pipeline model partitioning — the port's counterpart of
``torchdistpackage_tpu/parallel/pipeline_parallel/pipeline_helper.py``.

The partitioners work on per-layer weights and return contiguous stage
bounds (the reference's ``pipeline_helper.py:6-111`` semantics, the same
algorithm as the JAX package's, so both give the same bounds);
:func:`stack_stage_params` stacks a per-layer parameter list into
``[L, ...]`` leaves, whose dim 0 a pipeline splits into equal
contiguous stage slabs (stage ``s`` of ``P`` holds rows ``[s L / P,
(s + 1) L / P)``).  :func:`balanced_stage_stack` pads unequal stages to
equal slabs with zero layers and a mask that ``scan_blocks(layer_mask=)``
skips.

Placement specs are PartitionSpec-like tuples of axis names, one entry a
dim (``None``: not split), the vocabulary of ``fsdp.stacked_fsdp_specs``:
a leaf whose spec names the ``pipe`` axis is its stage's own slab, every
other leaf is replicated over the pipe group (its grads are summed over
the group after a schedule, :func:`pipe_split_flags`).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...dist.topology import PIPE_AXIS
from ...obs.numerics import tree_leaves


def partition_uniform(num_items: int, num_parts: int
                      ) -> List[Tuple[int, int]]:
    """Contiguous ``[start, end)`` ranges, as even as possible (the
    first ``num_items % num_parts`` parts one longer)."""
    if num_parts <= 0:
        raise ValueError("num_parts must be positive")
    base, rem = divmod(num_items, num_parts)
    bounds, start = [], 0
    for i in range(num_parts):
        size = base + (1 if i < rem else 0)
        bounds.append((start, start + size))
        start += size
    return bounds


def partition_balanced(weights: Sequence[float], num_parts: int
                       ) -> List[Tuple[int, int]]:
    """Contiguous partition minimising the heaviest part: a binary
    search on the bottleneck with greedy packing, then the heaviest
    splittable part split at its most even cut until there are
    ``num_parts`` parts."""
    w = [float(x) for x in weights]
    n = len(w)
    if num_parts > n:
        raise ValueError(f"cannot split {n} layers into {num_parts} stages")

    def parts_needed(cap: float) -> int:
        parts, cur = 1, 0.0
        for x in w:
            if x > cap:
                return num_parts + 1
            if cur + x > cap:
                parts += 1
                cur = x
            else:
                cur += x
        return parts

    lo, hi = max(w), sum(w)
    for _ in range(100):
        mid = (lo + hi) / 2
        if parts_needed(mid) <= num_parts:
            hi = mid
        else:
            lo = mid
    cap = hi
    bounds: List[Tuple[int, int]] = []
    start, cur = 0, 0.0
    for i, x in enumerate(w):
        if cur + x > cap and i > start:
            bounds.append((start, i))
            start, cur = i, x
        else:
            cur += x
    bounds.append((start, n))
    while len(bounds) < num_parts:
        sizes = [sum(w[a:b]) if b - a > 1 else -1 for a, b in bounds]
        j = int(np.argmax(sizes))
        a, b = bounds[j]
        best, best_diff = a + 1, float("inf")
        for cut in range(a + 1, b):
            diff = abs(sum(w[a:cut]) - sum(w[cut:b]))
            if diff < best_diff:
                best, best_diff = cut, diff
        bounds[j:j + 1] = [(a, best), (best, b)]
    return bounds


def flat_and_partition(weights: Sequence[float], num_parts: int,
                       method: str = "balanced") -> List[Tuple[int, int]]:
    """``'uniform'`` or ``'balanced'`` bounds (the reference's
    ``flat_and_partition``)."""
    if method == "uniform":
        return partition_uniform(len(weights), num_parts)
    if method == "balanced":
        return partition_balanced(weights, num_parts)
    raise ValueError(f"unknown partition method {method!r}")


def param_count(tree: Any) -> int:
    """Elements of every tensor (or numpy array) of ``tree``."""
    return sum(int(np.prod(tuple(x.shape))) for x in tree_leaves(tree))


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_stage_params(layer_params: List[Any]) -> Any:
    """A list of per-layer trees (dicts of tensors) stacked into one tree
    of ``[num_layers, ...]`` leaves."""
    return _map(lambda *xs: torch.stack(xs, dim=0), *layer_params)


def unstack_stage_params(stacked: Any) -> List[Any]:
    """:func:`stack_stage_params`' inverse: views of each layer."""
    n = next(iter(tree_leaves(stacked))).shape[0]
    return [_map(lambda a, i=i: a[i], stacked) for i in range(n)]


def balanced_stage_stack(layer_params: List[Any], weights: Sequence[float],
                         num_stages: int
                         ) -> Tuple[Any, torch.Tensor, List[Tuple[int, int]]]:
    """``(stacked, mask, bounds)``: layers assigned to stages by
    :func:`partition_balanced`'s contiguous bounds, every stage's slab
    padded to the longest with zero layers.  ``stacked`` has
    ``[num_stages * max_len, ...]`` leaves (stage ``s`` holds rows
    ``[s max_len, (s + 1) max_len)``), ``mask`` is ``[num_stages,
    max_len]`` float32 (1 a real layer, 0 padding; stage ``s`` hands row
    ``s`` to ``scan_blocks(layer_mask=)``), ``bounds`` the stages'
    ``[start, end)`` layer ranges.  Padding layers get exactly zero grads,
    so they stay zero under any optimizer."""
    if len(weights) != len(layer_params):
        raise ValueError(
            f"weights ({len(weights)}) and layer_params ({len(layer_params)}) "
            f"must have one entry per layer")
    bounds = partition_balanced([float(w) for w in weights], num_stages)
    max_len = max(b - a for a, b in bounds)
    zeros = _map(torch.zeros_like, layer_params[0])
    slabs: List[Any] = []
    mask = torch.zeros((num_stages, max_len), dtype=torch.float32)
    for s, (a, b) in enumerate(bounds):
        slabs.extend(layer_params[a:b])
        slabs.extend([zeros] * (max_len - (b - a)))
        mask[s, :b - a] = 1.0
    return stack_stage_params(slabs), mask, bounds


def stacked_param_specs(stacked: Any, pipe_axis: str = PIPE_AXIS,
                        inner_specs: Optional[Any] = None) -> Any:
    """Specs of a layer-stacked tree: ``pipe_axis`` on the layer dim,
    then each leaf's per-layer spec from ``inner_specs`` (a tree of
    tuples of axis names for the remaining dims), as JAX's
    ``P(pipe_axis, *inner)``."""
    if inner_specs is None:
        return _map(lambda _: (pipe_axis,), stacked)
    return _map(lambda _, s: (pipe_axis,) + tuple(s or ()), stacked,
                inner_specs)


def _names(spec) -> Tuple[str, ...]:
    out = []
    for e in spec if isinstance(spec, (tuple, list)) else (spec,):
        if isinstance(e, (tuple, list)):
            out.extend(e)
        elif e is not None:
            out.append(e)
    return tuple(out)


def pipe_split_flags(params: Any, specs: Any = None,
                     pipe_axis: str = PIPE_AXIS) -> List[bool]:
    """For each tensor of ``params`` (``tree_leaves`` order): True when
    its spec names ``pipe_axis`` (the stage's own slab), False when the
    leaf is replicated over the pipe group.  ``specs`` None: every leaf
    replicated (a leaf without a spec is replicated, as JAX's ``P()``)."""
    out: List[bool] = []

    def walk(p, s):
        if isinstance(p, dict):
            for k, v in p.items():
                walk(v, None if s is None else s.get(k))
        elif isinstance(p, (list, tuple)):
            for i, v in enumerate(p):
                walk(v, None if s is None else s[i])
        elif p is not None:
            n = sum(1 for _ in tree_leaves(p))
            out.extend([s is not None and pipe_axis in _names(s)] * n)
    walk(params, specs)
    return out
