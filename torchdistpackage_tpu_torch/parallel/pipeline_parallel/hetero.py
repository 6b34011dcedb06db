"""Heterogeneous stage activations — the port's counterpart of
``torchdistpackage_tpu/parallel/pipeline_parallel/hetero.py`` (the
reference's shape-meta handshake, ``comm.py:26-105``, which lets
neighbouring stages exchange tensors of different shapes and dtypes).

The JAX package needs ONE static state shape inside its scan, so the
state becomes a flat **bus** as large as the largest edge: every stage
packs its true activation onto the bus and unpacks its input from it,
and ``lax.switch`` on the stage index picks the stage's function.  Under
MPMD each rank runs its own stage's function (no switch), and the
messages could carry exact sizes; the port keeps the bus all the same,
so that callers written for the JAX package run unchanged, the schedules
keep their one-state-shape rule (``_p2p``'s preamble) and the results
agree.  The costs are the JAX package's: every message carries the
largest edge's bytes; the padding never reaches the compute
(:func:`bus_unpack` reads the leading ``size`` elements, and the pad's
cotangents are dropped).
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Sequence, Tuple

import torch

from ...dist.topology import PIPE_AXIS
from .pipeline_sched import num_stages, stage_index


class ShapeDtype(NamedTuple):
    """An edge's shape and dtype (``jax.ShapeDtypeStruct``'s role)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _aval(x) -> ShapeDtype:
    return ShapeDtype(tuple(x.shape), x.dtype)


def _is_int(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex \
        and dtype != torch.bool


def _bus_aval(edges: Sequence[ShapeDtype]) -> ShapeDtype:
    size = max(math.prod(e.shape) for e in edges)
    dtype = edges[0].dtype
    for e in edges[1:]:
        dtype = torch.promote_types(dtype, e.dtype)
    # an integer edge on a float bus would be corrupted past the float's
    # integer-exact range (an int32 id >= 2**24 through an f32 bus)
    for e in edges:
        if _is_int(e.dtype) != _is_int(dtype):
            raise ValueError(
                f"bus dtype {dtype} cannot carry edge dtype {e.dtype} "
                f"exactly: integer and float edges cannot share one bus — "
                f"use a uniform edge dtype (or cast inside the stage fns)")
    return ShapeDtype((size,), dtype)


def bus_pack(x: torch.Tensor, bus: ShapeDtype) -> torch.Tensor:
    """``x`` flattened into the leading elements of a bus vector."""
    flat = x.reshape(-1).to(bus.dtype)
    pad = bus.shape[0] - flat.shape[0]
    if pad < 0:
        raise ValueError(f"edge {tuple(x.shape)} exceeds the bus "
                         f"({bus.shape[0]})")
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def bus_unpack(bus_val: torch.Tensor, edge: ShapeDtype) -> torch.Tensor:
    """The true activation of ``edge`` from a bus vector."""
    size = math.prod(edge.shape)
    return bus_val[:size].reshape(edge.shape).to(edge.dtype)


def make_heterogeneous_stage(stage_fns: List[Callable], edges: Sequence,
                             pipe_axis: str = PIPE_AXIS, pipe_group=None):
    """``(wrap_first, stage_fn, wrap_last)`` adapting P HETEROGENEOUS stage
    functions to the schedules' one-state contract.

    ``stage_fns[s]``: ``(params, x, m) -> y``, ``x`` of ``edges[s]``'s
    shape and dtype, ``y`` of ``edges[s + 1]``'s (pass
    ``stage_takes_mb=True`` to the schedule).  ``edges``: P + 1 edges
    (tensors, meta tensors or :class:`ShapeDtype`): ``edges[0]`` is
    ``first_fn``'s output, ``edges[P]`` what ``last_fn`` receives.

    - ``wrap_first(first_fn)``: its ``edges[0]`` output packed on the bus;
    - ``stage_fn(params, bus, m)``: this rank's ``stage_fns[s]`` between
      an unpack of ``edges[s]`` and a pack of ``edges[s + 1]``; its
      output is checked against ``edges[s + 1]`` (the handshake) and the
      stage count against the pipe group's size;
    - ``wrap_last(last_fn)``: ``last_fn`` gets the unpacked ``edges[P]``.
    """
    edges = [e if isinstance(e, ShapeDtype) else _aval(e) for e in edges]
    if len(stage_fns) != len(edges) - 1:
        raise ValueError(
            f"{len(stage_fns)} stage fns need {len(stage_fns) + 1} edge "
            f"avals, got {len(edges)}")
    bus = _bus_aval(edges)
    P_ = len(stage_fns)

    def stage_fn(params, bus_val, m):
        n = num_stages(pipe_axis, pipe_group)
        if n != P_:
            raise ValueError(
                f"{P_} heterogeneous stage fns on a {n}-rank {pipe_axis!r} "
                f"axis — one fn per stage is required")
        s = stage_index(pipe_axis, pipe_group)
        y = stage_fns[s](params, bus_unpack(bus_val, edges[s]), m)
        got, want = _aval(y), edges[s + 1]
        if got.shape != want.shape or got.dtype != want.dtype:
            raise ValueError(
                f"stage {s} produced {got.shape}/{got.dtype}, but stage "
                f"{s + 1} expects {want.shape}/{want.dtype} — the edge "
                f"contract (edges[{s + 1}]) is violated")
        return bus_pack(y, bus)

    def wrap_first(first_fn):
        def first(params, mb):
            out = first_fn(params, mb)
            got = _aval(out)
            if got.shape != edges[0].shape or got.dtype != edges[0].dtype:
                raise ValueError(
                    f"first_fn produced {got.shape}/{got.dtype}, expected "
                    f"edges[0] = {edges[0].shape}/{edges[0].dtype}")
            return bus_pack(out, bus)
        return first

    def wrap_last(last_fn):
        def last(params, bus_val, tgt):
            return last_fn(params, bus_unpack(bus_val, edges[-1]), tgt)
        return last

    return wrap_first, stage_fn, wrap_last
