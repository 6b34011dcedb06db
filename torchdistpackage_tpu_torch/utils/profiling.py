"""Profiling ranges and trace capture — the port's
``torchdistpackage_tpu/utils/profiling.py`` (the reference's NVTX
toolkit):

- :func:`prof_start` / :func:`prof_stop` — a ``torch.profiler`` capture
  window (CPU and, with a card, CUDA activity) written as a Chrome trace
  (Perfetto / ``chrome://tracing``) when it stops;
- :func:`scope_decorator` — a named range on both timelines: a
  ``torch.profiler.record_function`` (host) and, with a card, an NVTX
  range;
- :class:`TimedScope` — the same range plus a wall time that is real:
  :meth:`TimedScope.sync_on` names the tensors whose card work must be
  done before the clock stops (PyTorch returns before the card
  finishes).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Any, Callable, Optional

import torch

_PROFILER: Optional[Any] = None
_LOGDIR: Optional[str] = None


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def prof_start(logdir: str = "torch-trace") -> None:
    """Begin a profiler capture window (JAX :24): a few steady-state
    steps, not a whole run.  :func:`prof_stop` writes it."""
    global _PROFILER, _LOGDIR
    if _PROFILER is not None:
        raise RuntimeError("a prof_start window is already open")
    _PROFILER = torch.profiler.profile(activities=_activities())
    _PROFILER.__enter__()
    _LOGDIR = logdir


def prof_stop() -> Optional[str]:
    """Close the window (waiting for the card first) and write
    ``<logdir>/trace.json``; returns its path."""
    global _PROFILER, _LOGDIR
    prof, logdir = _PROFILER, _LOGDIR
    _PROFILER = _LOGDIR = None
    if prof is None:
        return None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def _range(name: str):
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def scope_decorator(fn: Callable = None, *, name: Optional[str] = None
                    ) -> Callable:
    """Wrap ``fn`` in a named range on the host and card timelines (JAX
    :41, the reference's ``nvtx_decorator``)."""

    def deco(f: Callable) -> Callable:
        scope = name or f.__qualname__

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            with _range(scope):
                return f(*args, **kwargs)

        return wrapper

    if fn is not None:
        return deco(fn)
    return deco


class TimedScope:
    """``with TimedScope('fwd') as t: ...`` — a named range and its wall
    time (JAX :61, the reference's ``NVTXContext``).  On exit it waits
    for the card when :meth:`sync_on` named CUDA tensors (otherwise the
    time is the host's enqueue only), then sets ``elapsed`` (seconds) and
    optionally prints it."""

    def __init__(self, name: str, verbose: bool = False):
        self.name = name
        self.verbose = verbose
        self.elapsed: Optional[float] = None
        self._sync_target = None

    def sync_on(self, *tensors) -> None:
        """Tensors whose card work the clock waits for."""
        self._sync_target = tensors

    def __enter__(self) -> "TimedScope":
        self._range = _range(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        devices = {t.device for t in self._sync_target or ()
                   if isinstance(t, torch.Tensor) and t.is_cuda}
        for d in devices:
            torch.cuda.synchronize(d)
        self.elapsed = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        if self.verbose:
            from .logging import master_print

            master_print(f"[{self.name}] {self.elapsed * 1e3:.3f} ms")
