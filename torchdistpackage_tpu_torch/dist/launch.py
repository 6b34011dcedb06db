"""Start ``torch.distributed`` — the port's counterpart of the process
bootstrap in ``torchdistpackage_tpu/dist/launch.py``.

Nothing here reads a cluster's environment: the caller names the
rendezvous (``tcp://host:port`` or ``file:///path``), the world size,
this process's rank and the device, and the backend follows the device
— NCCL for a CUDA device, gloo for the CPU — never a guess.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device


def init_distributed(init_method: str, world_size: int, rank: int,
                     device: DeviceLike = None) -> torch.device:
    """Join the default process group and return this rank's device.
    ``device`` None or ``"cuda"`` means the card ``rank % device_count``
    (set as the current device) and the ``nccl`` backend; ``"cpu"``
    means ``gloo``.  Raises if a group is already up, or without a card
    when one is asked for."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} not in [0, {world_size})")
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialised")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dev
