"""Process groups for the port: :func:`init_distributed` starts
``torch.distributed`` (NCCL on the card, gloo on the CPU),
:func:`build_moe_groups` cuts the expert-parallel groups and
:func:`build_cp_group` the context-parallel ones."""

from .launch import init_distributed
from .topology import build_cp_group, build_moe_groups

__all__ = ["build_cp_group", "build_moe_groups", "init_distributed"]
