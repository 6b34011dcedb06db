"""Device resolution shared by every entry point of the port.

The port runs on the card: ``device=None`` means ``"cuda"``, and a
missing card is an error, never a silent move to the CPU.  Callers that
want the CPU (the tests, which hold the port against the JAX package)
ask for it explicitly with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is unavailable); anything
    else is passed through ``torch.device``.  An explicit CUDA device
    also raises when no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "torchdistpackage_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path explicitly")
    return dev

