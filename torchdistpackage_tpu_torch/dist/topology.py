"""Process groups of the parallel layouts the port serves:

- expert-parallel groups, the counterpart of
  ``ParallelContext.build_moe_mesh`` (``torchdistpackage_tpu/dist/
  topology.py:324``): the world is cut into ``world / ep`` groups of
  ``ep`` contiguous ranks (EP innermost, as the reference lays its
  ``moe_ep`` axis), each holding ``E / ep`` experts a rank;
- context-parallel groups, the counterpart of a ``context`` mesh axis:
  ``world / cp`` groups of ``cp`` contiguous ranks, each holding a block
  slice of one serving engine's pool.

The rest of the reference's topology (tensor, pipeline and data axes,
``ParallelContext`` and its views) is not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import torch.distributed as dist


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
    return _contiguous_groups(moe_ep_size, "build_moe_groups")


def build_cp_group(cp: int):
    """This rank's context-parallel ``ProcessGroup`` (for
    ``ServingEngine(cp_group=...)``): ranks ``[i cp, (i + 1) cp)`` for the
    ``i`` that holds it.  Every rank must call it.  Raises if ``cp`` does
    not divide the world size."""
    return _contiguous_groups(cp, "build_cp_group")
