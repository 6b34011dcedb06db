"""Process groups by named axis — the port's counterpart of
``torchdistpackage_tpu/dist/topology.py``.

:class:`ParallelContext` (and the module-level ``tpc``) lays the ranks
out over an ordered config such as ``[('data', 2), ('pipe', 2),
('tensor', 2)]`` with the reference's rule: C order, the last-listed
axis has stride 1 (consecutive ranks, i.e. intra-node).  Where the
reference names a mesh axis inside ``shard_map``, the port hands out
the ``torch.distributed`` ``ProcessGroup`` of this rank along that axis
(:meth:`ParallelContext.get_group`), and the rank's coordinate on it is
a host integer (:meth:`ParallelContext.get_group_rank`).  Views factor
an axis in two, as the reference's view meshes do:
:meth:`~ParallelContext.build_moe_mesh` splits ``data`` into ``('moe_dp',
'moe_ep')`` with EP innermost, :meth:`~ParallelContext.build_hybrid_mesh`
into ``('data_inter', 'data_intra')``.  A serving replica spans every
axis but the data one (:meth:`~ParallelContext.replica_group`): data x
tensor, moe_dp x moe_ep x tensor (``build_moe_mesh`` on a data x tensor
layout) and context x tensor are the compositions the engine serves.

The reference's ``_assign_devices`` (ICI / DCN torus placement) has no
counterpart: ranks follow C order, and which ranks share a node is the
launcher's business.

Two older helpers stay as they were: :func:`build_moe_groups` (the
expert-parallel groups of ``world / ep`` contiguous ranks) and
:func:`build_cp_group` (the context-parallel ones).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..obs.comm_ledger import note, register_group

AxisName = Union[str, Tuple[str, ...]]

# Canonical axis names (the reference's group "modes").
DATA_AXIS = "data"
TENSOR_AXIS = "tensor"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "moe_ep"
MOE_DATA_AXIS = "moe_dp"
CONTEXT_AXIS = "context"


@dataclasses.dataclass(frozen=True)
class View:
    """The ranks laid out over named axes — the counterpart of a view
    mesh.  ``ranks[i0, i1, ...]`` is the global rank at those
    coordinates."""

    axis_names: Tuple[str, ...]
    ranks: np.ndarray

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)


class ParallelContext:
    """Registry of this rank's process groups by named axis.  The
    module-level ``tpc`` is the canonical instance; construct one
    explicitly in tests."""

    def __init__(self) -> None:
        self._reset()

    def _reset(self) -> None:
        self._views: Dict[str, View] = {}
        # one ProcessGroup (this rank's) per partition of the ranks
        self._groups: Dict[Tuple[Tuple[int, ...], ...], object] = {}
        self.rank: Optional[int] = None
        self.world_size: Optional[int] = None
        self.with_groups = False

    def reset(self) -> None:
        """Drop all state (the groups themselves stay with
        ``torch.distributed`` until it is destroyed)."""
        self._reset()

    @property
    def is_initialized(self) -> bool:
        return bool(self._views)

    # ------------------------------------------------------------ setup

    def setup_process_groups(self, config: Sequence[Tuple[str, int]],
                             world_size: Optional[int] = None,
                             rank: Optional[int] = None) -> View:
        """Lay the ranks out over the ordered ``[(axis, size), ...]``
        config and build this rank's group along every axis.  The last
        axis has stride 1; at most one size may be ``-1`` and absorbs
        the rest of the world.

        With ``torch.distributed`` up, the world and this rank are the
        default group's and every rank must call this (group creation is
        collective).  Without it, pass ``world_size`` and ``rank``: the
        layout and every rank query work, :meth:`get_group` raises."""
        if dist.is_initialized():
            w, r = dist.get_world_size(), dist.get_rank()
            if (world_size not in (None, w)) or (rank not in (None, r)):
                raise ValueError(
                    f"world_size / rank {world_size} / {rank} disagree with "
                    f"torch.distributed's {w} / {r}")
            world_size, rank, groups = w, r, True
        elif world_size is None or rank is None:
            raise RuntimeError(
                "setup_process_groups needs init_distributed first, or "
                "world_size and rank for a layout without groups")
        else:
            groups = False
        names = [str(d) for d, _ in config]
        sizes = [int(s) for _, s in config]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate axis names in config: {names}")
        if sizes.count(-1) > 1:
            raise ValueError("at most one axis size may be -1")
        if -1 in sizes:
            known = math.prod(s for s in sizes if s != -1)
            if world_size % known != 0:
                raise ValueError(
                    f"cannot infer -1 axis: {world_size} ranks, known "
                    f"product {known}")
            sizes[sizes.index(-1)] = world_size // known
        if math.prod(sizes) != world_size:
            raise ValueError(f"config sizes {sizes} do not multiply to the "
                             f"world size {world_size}")
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} not in [0, {world_size})")
        self._reset()
        self.rank, self.world_size, self.with_groups = rank, world_size, groups
        view = View(tuple(names), np.arange(world_size).reshape(sizes))
        self._views["default"] = view
        for name in names:
            self._build_group(view, (name,))
        return view

    def _require(self) -> View:
        if not self._views:
            raise RuntimeError("ParallelContext not initialized — call "
                               "setup_process_groups first")
        return self._views["default"]

    @staticmethod
    def _partition(view: View, axes: Tuple[str, ...]) -> List[List[int]]:
        """Every group of ranks along ``axes`` (flattened in C order)."""
        idx = [view.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(view.axis_names)) if i not in idx]
        n = math.prod(view.ranks.shape[i] for i in idx)
        return np.transpose(view.ranks, rest + idx).reshape(-1, n).tolist()

    def _build_group(self, view: View, axes: Tuple[str, ...]):
        """This rank's group along ``axes`` of ``view``, created (every
        rank must get here together) unless an identical partition of the
        ranks already has one."""
        part = self._partition(view, axes)
        key = tuple(tuple(g) for g in part)
        if not self.with_groups:
            return None
        if key not in self._groups:
            mine = None
            for ranks in part:
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = group
            self._groups[key] = mine
        # the comm ledger names the group's collectives by these axes
        register_group(self._groups[key], axes,
                       [view.shape[a] for a in axes])
        return self._groups[key]

    # ------------------------------------------------------------ views

    def build_view(self, view_name: str, split_axis: str,
                   sub_names: Tuple[str, str], inner_size: int) -> View:
        """The default layout with ``split_axis`` factored into ``(outer,
        inner)``, the inner axis on consecutive members; builds this
        rank's group along both new axes.  A sum over both equals a sum
        over ``split_axis``."""
        base = self._require()
        if split_axis not in base.axis_names:
            raise ValueError(f"axis {split_axis!r} not in {base.axis_names}")
        size = base.shape[split_axis]
        if size % inner_size != 0:
            raise ValueError(f"axis {split_axis!r} of size {size} not "
                             f"divisible by {inner_size}")
        names, sizes = [], []
        for name in base.axis_names:
            if name == split_axis:
                names.extend(sub_names)
                sizes.extend([size // inner_size, inner_size])
            else:
                names.append(name)
                sizes.append(base.shape[name])
        view = View(tuple(names), base.ranks.reshape(sizes))
        self._views[view_name] = view
        for name in sub_names:
            self._build_group(view, (name,))
        return view

    def build_moe_mesh(self, moe_dp_size: Optional[int] = None,
                       moe_ep_size: Optional[int] = None) -> View:
        """MoE view: ``data`` -> ``('moe_dp', 'moe_ep')``, EP innermost
        (expert-parallel ranks contiguous within each data group,
        same-expert replicas on the strided ``moe_dp`` groups)."""
        dp = self.get_dp_size()
        if moe_dp_size and not moe_ep_size:
            if dp % moe_dp_size != 0:
                raise ValueError(
                    f"moe_dp_size {moe_dp_size} does not divide dp size {dp}")
            moe_ep_size = dp // moe_dp_size
        elif moe_ep_size and not moe_dp_size:
            if dp % moe_ep_size != 0:
                raise ValueError(
                    f"moe_ep_size {moe_ep_size} does not divide dp size {dp}")
            moe_dp_size = dp // moe_ep_size
        elif moe_dp_size and moe_ep_size:
            if moe_dp_size * moe_ep_size != dp:
                raise ValueError(f"moe_dp {moe_dp_size} * moe_ep "
                                 f"{moe_ep_size} != dp {dp}")
        else:
            raise ValueError("need moe_dp_size or moe_ep_size")
        return self.build_view("moe", DATA_AXIS, (MOE_DATA_AXIS, EXPERT_AXIS),
                               moe_ep_size)

    def build_hybrid_mesh(self, intra_size: int) -> View:
        """Hybrid-ZeRO view: ``data`` -> ``('data_inter', 'data_intra')``,
        intra innermost."""
        return self.build_view("hybrid", DATA_AXIS,
                               ("data_inter", "data_intra"), intra_size)

    def get_view(self, name: str = "default") -> View:
        self._require()
        if name not in self._views:
            raise KeyError(f"view {name!r} not built; have "
                           f"{list(self._views)}")
        return self._views[name]

    # -------------------------------------------------------- axis info

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self._require().axis_names

    def _axis_view(self, mode: AxisName) -> View:
        names = (mode,) if isinstance(mode, str) else tuple(mode)
        for view in self._views.values():
            if all(n in view.axis_names for n in names):
                return view
        raise KeyError(f"axis {mode!r} not found in any view")

    def _has_axis(self, mode: str) -> bool:
        return any(mode in v.axis_names for v in self._views.values())

    def is_mode_inited(self, mode: str) -> bool:
        """The axis exists in some view with size > 1 (the reference's
        semantics)."""
        if not self._views:
            return False
        if any(mode in v.axis_names and v.shape[mode] > 1
               for v in self._views.values()):
            return True
        return mode == "model" and self.get_mp_size() > 1

    def get_group(self, mode: AxisName = DATA_AXIS):
        """This rank's ``ProcessGroup`` along ``mode``: an axis name, a
        tuple of axis names of one view (their flattened product — made
        on first use, so every rank must ask for it together), ``'model'``
        (every axis but ``data``) or ``'global'``."""
        self._require()
        if not self.with_groups:
            raise RuntimeError("a layout set up without torch.distributed "
                               "has no process groups")
        if mode == "global":
            return dist.group.WORLD
        if mode == "model":
            mode = self.model_axes()
        axes = (mode,) if isinstance(mode, str) else tuple(mode)
        return self._build_group(self._axis_view(axes), axes)

    def get_group_size(self, mode: AxisName) -> int:
        if mode == "global":
            return self._require().size
        if mode == "model":
            return self.get_mp_size()
        axes = (mode,) if isinstance(mode, str) else tuple(mode)
        view = self._axis_view(axes)
        return math.prod(view.shape[a] for a in axes)

    def _coords(self, v: View, rank: Optional[int]) -> Dict[str, int]:
        pos = np.argwhere(v.ranks == (self.rank if rank is None else rank))
        if len(pos) == 0:
            raise ValueError(f"rank {rank} not in the layout")
        return dict(zip(v.axis_names, (int(i) for i in pos[0])))

    def coords(self, rank: Optional[int] = None,
               view: str = "default") -> Dict[str, int]:
        """``{axis: coordinate}`` of ``rank`` (default: this rank)."""
        return self._coords(self.get_view(view), rank)

    def get_group_rank(self, mode: AxisName) -> int:
        """This rank's coordinate along ``mode`` (a tuple: its index in
        the flattened group, C order)."""
        axes = (mode,) if isinstance(mode, str) else tuple(mode)
        view = self._axis_view(axes)
        c = self._coords(view, None)
        return int(np.ravel_multi_index(
            tuple(c[a] for a in axes), tuple(view.shape[a] for a in axes)))

    def _size_or_1(self, mode: str) -> int:
        return self.get_group_size(mode) if self._has_axis(mode) else 1

    def _rank_or_0(self, mode: str) -> int:
        return self.get_group_rank(mode) if self._has_axis(mode) else 0

    def get_tp_size(self) -> int:
        return self._size_or_1(TENSOR_AXIS)

    def get_pp_size(self) -> int:
        return self._size_or_1(PIPE_AXIS)

    def get_dp_size(self) -> int:
        return self._size_or_1(DATA_AXIS)

    def get_tp_rank(self) -> int:
        return self._rank_or_0(TENSOR_AXIS)

    def get_pp_rank(self) -> int:
        return self._rank_or_0(PIPE_AXIS)

    def get_dp_rank(self) -> int:
        return self._rank_or_0(DATA_AXIS)

    def get_mp_size(self) -> int:
        """Product of every axis but ``data`` (the auto-derived 'model'
        group, the transpose of the data groups)."""
        v = self._require()
        return math.prod(v.shape[a] for a in v.axis_names if a != DATA_AXIS)

    def model_axes(self) -> Tuple[str, ...]:
        v = self._require()
        return tuple(a for a in v.axis_names if a != DATA_AXIS)

    def data_axes(self, view: str = "default") -> Tuple[str, ...]:
        """The axes whose product is the data-parallel group in ``view``
        ('default' -> ('data',); 'moe' -> ('moe_dp', 'moe_ep'))."""
        base = {DATA_AXIS, MOE_DATA_AXIS, EXPERT_AXIS, "data_inter",
                "data_intra"}
        return tuple(a for a in self.get_view(view).axis_names if a in base)

    def replica_group(self, view: str = "default"):
        """This rank's group over every axis of ``view`` but the data axis
        the serving slots split over (``data``, or ``moe_dp`` on the MoE
        view) — ``tensor`` on data x tensor, ``moe_ep`` x ``tensor`` on
        moe_dp x moe_ep x tensor, ``context`` x ``tensor`` on context x
        tensor — made on first use, so every rank must ask for it
        together: the ranks that run one replica of a serving engine and
        must take one rank's sampled tokens, the group
        ``ServingEngine(replica_group=)`` broadcasts them over.  A
        broadcast over one of its axes alone would leave the ranks of the
        others free to differ."""
        axes = tuple(a for a in self.get_view(view).axis_names
                     if a not in (DATA_AXIS, MOE_DATA_AXIS))
        if not axes:
            raise ValueError(f"view {view!r} has no axis beside the data "
                             f"axis: a replica is one rank")
        self._require()
        if not self.with_groups:
            raise RuntimeError("a layout set up without torch.distributed "
                               "has no process groups")
        return self._build_group(self.get_view(view), axes)

    def is_first_in_group(self, mode: AxisName) -> bool:
        return self.get_group_rank(mode) == 0

    def is_last_in_group(self, mode: AxisName) -> bool:
        return self.get_group_rank(mode) == self.get_group_size(mode) - 1

    def is_first_in_pipeline_group(self) -> bool:
        return self.is_first_in_group(PIPE_AXIS)

    def is_last_in_pipeline_group(self) -> bool:
        return self.is_last_in_group(PIPE_AXIS)

    def is_using_pp(self) -> bool:
        return self.is_mode_inited(PIPE_AXIS)

    def ranks_in_axis(self, mode: str) -> List[List[int]]:
        """Every group of global ranks along ``mode``."""
        return self._partition(self._axis_view((mode,)), (mode,))


# The canonical context.
tpc = ParallelContext()


def is_using_pp() -> bool:
    return tpc.is_using_pp()


def test_comm(ctx: Optional[ParallelContext] = None) -> Dict[str, bool]:
    """One all-reduce a group: along every axis of the default layout,
    each rank contributes its coordinate and must get back ``0 + 1 + ...
    + (n - 1)``.  Returns ``{axis: True}``; raises on a wrong sum.  The
    tensor lives on this rank's card under NCCL, on the CPU under gloo."""
    ctx = tpc if ctx is None else ctx
    results: Dict[str, bool] = {}
    for axis in ctx.axis_names:
        group = ctx.get_group(axis)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend(group) == "nccl" else torch.device("cpu"))
        n = ctx.get_group_size(axis)
        x = torch.tensor([float(ctx.get_group_rank(axis))], device=dev)
        note("all-reduce", x, group)
        dist.all_reduce(x, group=group)
        if float(x) != n * (n - 1) / 2:
            raise AssertionError(f"test_comm failed for axis {axis!r}: got "
                                 f"{float(x)}, want {n * (n - 1) / 2}")
        results[axis] = True
    return results


def _contiguous_groups(size: int, what: str):
    """This rank's group among ``world / size`` groups of ``size``
    contiguous ranks; every rank must call it (group creation is
    collective)."""
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs init_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if size < 1 or world % size != 0:
        raise ValueError(f"{what}: size {size} does not divide world size "
                         f"{world}")
    mine = None
    for lo in range(0, world, size):
        group = dist.new_group(list(range(lo, lo + size)))
        if lo <= rank < lo + size:
            mine = group
    return mine


def build_moe_groups(moe_ep_size: int):
    """This rank's expert-parallel ``ProcessGroup``: ranks ``[i ep, (i +
    1) ep)`` for the ``i`` that holds it.  Every rank must call it (group
    creation is collective).  Raises if ``moe_ep_size`` does not divide
    the world size."""
    group = _contiguous_groups(moe_ep_size, "build_moe_groups")
    register_group(group, (EXPERT_AXIS,), (moe_ep_size,))
    return group


def build_cp_group(cp: int):
    """This rank's context-parallel ``ProcessGroup`` (for
    ``ServingEngine(cp_group=...)``): ranks ``[i cp, (i + 1) cp)`` for the
    ``i`` that holds it.  Every rank must call it.  Raises if ``cp`` does
    not divide the world size."""
    group = _contiguous_groups(cp, "build_cp_group")
    register_group(group, (CONTEXT_AXIS,), (cp,))
    return group
