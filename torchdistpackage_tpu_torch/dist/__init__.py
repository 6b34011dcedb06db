"""Process groups for the port: :func:`init_distributed` /
:func:`setup_distributed` start ``torch.distributed`` (NCCL on the card,
gloo on the CPU), ``tpc`` (:class:`ParallelContext`) hands out this
rank's group along each named axis, and :func:`build_moe_groups` /
:func:`build_cp_group` cut the expert- and context-parallel groups.
``compressed`` holds the int8 rings and their policy, ``comm_bench``
the collective benchmark, ``overlap`` the overlap regime."""

from .launch import find_free_port, init_distributed, setup_distributed
from .topology import (
    ParallelContext,
    build_cp_group,
    build_moe_groups,
    is_using_pp,
    tpc,
)
from . import comm_bench, compressed, overlap
from .compressed import (
    COMPRESS_MODES,
    GROUP,
    auto_compress_policy,
    ef_compress,
    int8_psum_all_gather,
    int8_ring_all_gather,
    int8_ring_pmean,
    int8_ring_reduce_scatter,
)

__all__ = ["COMPRESS_MODES", "GROUP", "ParallelContext",
           "auto_compress_policy", "build_cp_group", "build_moe_groups",
           "comm_bench", "compressed", "ef_compress", "find_free_port",
           "init_distributed", "int8_psum_all_gather",
           "int8_ring_all_gather", "int8_ring_pmean",
           "int8_ring_reduce_scatter", "is_using_pp", "overlap",
           "setup_distributed", "tpc"]
