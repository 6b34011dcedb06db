"""Process groups for the port: :func:`init_distributed` /
:func:`setup_distributed` start ``torch.distributed`` (NCCL on the card,
gloo on the CPU), ``tpc`` (:class:`ParallelContext`) hands out this
rank's group along each named axis, and :func:`build_moe_groups` /
:func:`build_cp_group` cut the expert- and context-parallel groups."""

from .launch import find_free_port, init_distributed, setup_distributed
from .topology import (
    ParallelContext,
    build_cp_group,
    build_moe_groups,
    is_using_pp,
    tpc,
)

__all__ = ["ParallelContext", "build_cp_group", "build_moe_groups",
           "find_free_port", "init_distributed", "is_using_pp",
           "setup_distributed", "tpc"]
