"""torchdistpackage_tpu_torch — the PyTorch / CUDA port of
``torchdistpackage_tpu``, written for an NVIDIA H100.

The JAX package stays beside it as the reference; every module here
mirrors its counterpart's path (``models/gpt.py``, ``serving/engine.py``,
``ops/paged_attention.py`` ...) and is held against it by the
``tests/test_torch_*.py`` parity tests.  This package imports ``torch``
and numpy only — never ``jax`` and nothing of ``torchdistpackage_tpu``.

Every entry point runs on the card unless the caller passes
``device="cpu"`` (see :func:`device.resolve_device`).  Each TPU kernel of
the reference becomes a kernel written by hand for Hopper; its plain
PyTorch version stays beside it as the oracle and as the CPU path.
"""

from .device import resolve_device

_SUBPACKAGES = ("dist", "models", "obs", "ops", "parallel", "serving",
                "tools")


def __getattr__(name: str):
    # Lazy subpackage import (PEP 562), as in the JAX package: importing
    # the top level pulls in neither the model stack nor the kernels.
    if name in _SUBPACKAGES:
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBPACKAGES))


__all__ = ["resolve_device"]
__version__ = "0.1.0"
