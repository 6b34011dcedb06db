"""Expert-parallel groups — the port's counterpart of
``ParallelContext.build_moe_mesh`` (``torchdistpackage_tpu/dist/
topology.py:324``): the world is cut into ``world / ep`` groups of ``ep``
contiguous ranks (EP innermost, as the reference lays its ``moe_ep``
axis), each holding ``E / ep`` experts a rank.  The rest of the
reference's topology (tensor, pipeline, data and context axes, views) is
not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import torch.distributed as dist


def build_moe_groups(moe_ep_size: int):
    """This rank's expert-parallel ``ProcessGroup``: ranks ``[i ep, (i +
    1) ep)`` for the ``i`` that holds it.  Every rank must call it (group
    creation is collective).  Raises if ``moe_ep_size`` does not divide
    the world size."""
    if not dist.is_initialized():
        raise RuntimeError("build_moe_groups needs init_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if moe_ep_size < 1 or world % moe_ep_size != 0:
        raise ValueError(
            f"moe_ep_size {moe_ep_size} does not divide world size {world}")
    mine = None
    for lo in range(0, world, moe_ep_size):
        group = dist.new_group(list(range(lo, lo + moe_ep_size)))
        if lo <= rank < lo + moe_ep_size:
            mine = group
    return mine
