"""Start ``torch.distributed`` — the port's counterpart of
``torchdistpackage_tpu/dist/launch.py``.

:func:`init_distributed` takes the rendezvous (``tcp://host:port`` or
``file:///path``), the world size, this process's rank and the device
from the caller, and the backend follows the device — NCCL for a CUDA
device, gloo for the CPU — never a guess.  :func:`setup_distributed`
reads them from the environment instead, in the reference's order: a
SLURM job, then torchrun's variables, then a single process (nothing to
start).
"""

from __future__ import annotations

import os
import socket
import subprocess
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

_INITIALIZED = False


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


def find_free_port() -> int:
    """An OS-assigned free TCP port."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _slurm_master_addr(nodelist: str) -> str:
    """The job's first host: ``scontrol show hostname``'s first line, or,
    without ``scontrol``, the first host of a compressed list
    (``node[01-08],x`` -> ``node01``)."""
    try:
        out = subprocess.run(
            ["scontrol", "show", "hostname", nodelist],
            capture_output=True, text=True, check=True,
        ).stdout
        return out.split()[0]
    except (OSError, subprocess.CalledProcessError):
        first = nodelist.split(",")[0]
        if "[" in first:
            prefix, rng = first.split("[", 1)
            start = rng.rstrip("]").split("-")[0].split(",")[0]
            return prefix + start
        return first


def _local_device(device: DeviceLike, local_rank: Optional[str]):
    """The card of this node's ``local_rank`` when the launcher names one
    and the caller asked for the card; otherwise ``device`` as given."""
    if local_rank is None or (device is not None
                              and torch.device(device).type != "cuda"):
        return device
    return torch.device("cuda", int(local_rank))


def setup_distributed(port: Optional[int] = None,
                      device: DeviceLike = None) -> None:
    """Join ``torch.distributed`` from the environment, in the
    reference's order:

    1. SLURM: ``SLURM_PROCID`` / ``SLURM_NTASKS`` (> 1) /
       ``SLURM_NODELIST`` (the first host is the rendezvous; the card is
       ``SLURM_LOCALID``);
    2. torchrun: ``RANK`` / ``WORLD_SIZE`` (> 1) / ``MASTER_ADDR`` /
       ``MASTER_PORT`` (the card is ``LOCAL_RANK``);
    3. a single process: nothing to start.

    The port is ``port``, else ``MASTER_PORT``, else 12345.  The group
    is joined through :func:`init_distributed` (NCCL on the card, gloo
    for ``device="cpu"``).  A second call does nothing."""
    global _INITIALIZED
    if _INITIALIZED:
        return
    env = os.environ
    if "SLURM_PROCID" in env and int(env.get("SLURM_NTASKS", "1")) > 1:
        rank, world = int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
        addr = _slurm_master_addr(env["SLURM_NODELIST"])
        local = env.get("SLURM_LOCALID")
    elif "RANK" in env and int(env.get("WORLD_SIZE", "1")) > 1:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        addr = env.get("MASTER_ADDR", "127.0.0.1")
        local = env.get("LOCAL_RANK")
    else:
        _INITIALIZED = True
        return
    port = port or int(env.get("MASTER_PORT", "12345"))
    init_distributed(f"tcp://{addr}:{port}", world, rank,
                     _local_device(device, local))
    _INITIALIZED = True
