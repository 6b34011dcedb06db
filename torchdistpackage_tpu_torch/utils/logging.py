"""Rank-gated printing — the port's ``torchdistpackage_tpu/utils/logging.py``.

"Master" is rank 0 of the default ``torch.distributed`` process group,
and every process is the master when no group is initialised.
"""

from __future__ import annotations

import builtins
import functools
from typing import Callable

import torch.distributed as dist

_builtin_print = builtins.print


def is_master() -> bool:
    """Rank 0 of the default process group (True without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def master_print(*args, **kwargs) -> None:
    """Print only on the master (always through the un-patched builtin)."""
    if is_master():
        _builtin_print(*args, **kwargs)


def master_only(fn: Callable) -> Callable:
    """Decorator: run ``fn`` only on the master, return None elsewhere."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_master():
            return fn(*args, **kwargs)
        return None

    return wrapper


def disable_non_master_print(force: bool = False) -> None:
    """Patch ``builtins.print`` to a no-op on non-master processes.  A call
    escapes the gate with ``print(..., force=True)``; calling again
    re-installs the gate with the new ``force`` default."""

    def gated_print(*args, force: bool = force, force_print: bool = False,
                    **kwargs):
        if is_master() or force or force_print:
            _builtin_print(*args, **kwargs)

    builtins.print = gated_print


def enable_all_print() -> None:
    """Undo :func:`disable_non_master_print`."""
    builtins.print = _builtin_print
