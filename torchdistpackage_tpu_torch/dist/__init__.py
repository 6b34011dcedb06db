"""Process groups for the port: :func:`init_distributed` starts
``torch.distributed`` (NCCL on the card, gloo on the CPU) and
:func:`build_moe_groups` cuts the expert-parallel groups."""

from .launch import init_distributed
from .topology import build_moe_groups

__all__ = ["build_moe_groups", "init_distributed"]
