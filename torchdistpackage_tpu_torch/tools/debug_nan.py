"""NaN / Inf hunting — the port's ``torchdistpackage_tpu/tools/debug_nan.py``
(the reference's ``debug_nan``).

- :func:`enable_nan_debug` — ``torch.autograd.set_detect_anomaly``: a
  backward that produces NaN raises at the operation, with the forward's
  traceback.
- :func:`check_tensors` / :func:`check_model_params` — a tree scan that
  names the non-finite leaves.
- :func:`nan_guard` — a decorator that scans a function's outputs after
  each call.  The port runs eagerly, so the scan reads a flag back from
  the card (a sync a call), where the reference's runs inside the
  compiled program.
- :func:`find_nan_block` — run a block-decomposed model and return the
  first block whose output is not finite.

Findings land on the event timeline: ``nan_watchdog`` (a guard trip, or
``check_tensors(emit=True)``) and ``nan_block_located``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

PyTree = Any


def enable_nan_debug(enable: bool = True) -> None:
    """Autograd's anomaly mode: NaN produced in a backward raises there."""
    torch.autograd.set_detect_anomaly(enable)


def check_tensors(tree: PyTree, name: str = "tensors",
                  raise_on_bad: bool = False, emit: bool = False
                  ) -> List[str]:
    """The paths (``name/a/0/b``) of the non-finite floating leaves of
    ``tree``, each with its NaN and Inf counts (JAX :47).  ``emit=True``
    lands a finding as a ``nan_watchdog`` event; ``raise_on_bad=True``
    raises ``FloatingPointError``."""
    from ..obs.numerics import tree_paths

    bad: List[str] = []
    for path, leaf in tree_paths(tree):
        if not leaf.is_floating_point():
            continue
        finite = torch.isfinite(leaf)
        if bool(finite.all()):
            continue
        n_nan = int(torch.isnan(leaf).sum())
        n_inf = int(torch.isinf(leaf).sum())
        key = "/".join(str(p) for p in path)
        bad.append(f"{name}/{key} (nan={n_nan}, inf={n_inf})")
    if bad and emit:
        from ..obs.events import emit_event

        emit_event("nan_watchdog", fn=name, source="check_tensors",
                   bad_paths=bad[:8], n_bad=len(bad))
    if bad and raise_on_bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
    return bad


def check_model_params(params: PyTree, raise_on_bad: bool = False
                       ) -> List[str]:
    """:func:`check_tensors` over a parameter tree (JAX :81)."""
    return check_tensors(params, name="params", raise_on_bad=raise_on_bad)


def nan_guard(fn: Callable = None, *, name: Optional[str] = None
              ) -> Callable:
    """Decorator (JAX :86): after each call, scan the floating outputs and
    raise ``FloatingPointError`` (after a ``nan_watchdog`` event) on any
    non-finite value.  Eager: one flag a leaf, read back together."""

    def deco(f: Callable) -> Callable:
        label = name or f.__qualname__

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            from ..obs.numerics import tree_paths

            out = f(*args, **kwargs)
            leaves = [t for _, t in tree_paths(out) if t.is_floating_point()]
            if leaves:
                flags = torch.stack([~torch.isfinite(t).all()
                                     for t in leaves]).cpu()
                n_bad = int(flags.sum())
                if n_bad:
                    from ..obs.events import emit_event

                    emit_event("nan_watchdog", fn=label, source="nan_guard",
                               n_bad=n_bad, n_leaves=len(leaves))
                    raise FloatingPointError(
                        f"nan_guard: non-finite output of {label}")
            return out

        return wrapper

    if fn is not None:
        return deco(fn)
    return deco


def find_nan_block(blocks: Sequence[Tuple[str, Callable]], x: PyTree
                   ) -> Tuple[Optional[str], PyTree]:
    """Run ``[(name, fn), ...]`` in order; ``(first block whose output is
    not finite, or None; the last output)`` (JAX :135).  A hit emits
    ``nan_block_located`` (block, index, bad paths)."""
    for i, (name, fn) in enumerate(blocks):
        x = fn(x)
        bad = check_tensors(x, name=name)
        if bad:
            from ..obs.events import emit_event

            emit_event("nan_block_located", block=name, index=i,
                       bad_paths=bad[:8], n_bad=len(bad))
            return name, x
    return None, x
