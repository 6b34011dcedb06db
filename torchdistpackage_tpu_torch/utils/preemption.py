"""Preemption handling — the port's ``GracefulShutdown`` (JAX
``utils/preemption.py:44``): termination signals become a flag that a
loop polls, so a serving engine drains
(``ServingEngine.run_until_idle(stop=...)``) or a trainer saves inside
the grace window instead of dying mid-step."""

from __future__ import annotations

import signal
import threading
import time
from typing import Optional, Sequence, Union

SignalLike = Union[int, str, signal.Signals]


def _resolve_signal(s: SignalLike) -> int:
    """``signal.SIGTERM``, ``15``, ``"SIGUSR1"`` or ``"USR1"`` -> the
    signal number."""
    if isinstance(s, str):
        name = s.upper()
        if not name.startswith("SIG"):
            name = "SIG" + name
        try:
            return int(getattr(signal, name))
        except AttributeError:
            raise ValueError(f"unknown signal name {s!r}") from None
    return int(s)


class GracefulShutdown:
    """Context manager that turns termination signals into a flag::

        with GracefulShutdown() as stop:
            engine.run_until_idle(stop=stop, persist_path="drain.json")

    - ``signals``: ints, ``signal.Signals`` members or names
      (``"SIGUSR1"`` / ``"USR2"``).
    - ``grace_s`` (when given) is recorded in the ``preemption`` event
      with the monotonic deadline of the grace window.
    - Handlers are installed on ``__enter__`` and the previous ones
      restored on ``__exit__``; entering from a thread other than the
      main one raises RuntimeError (``signal.signal`` is main-thread
      only).
    - A second signal restores the default handler and re-raises it (a
      hard stop)."""

    def __init__(self, signals: Sequence[SignalLike] = (signal.SIGTERM,
                                                        signal.SIGINT),
                 grace_s: Optional[float] = None):
        self._signals = tuple(_resolve_signal(s) for s in signals)
        self._previous = {}
        self.grace_s = grace_s
        self.requested = False
        #: perf_counter deadline of the grace window, set by the first
        #: signal when ``grace_s`` is given
        self.deadline_mono: Optional[float] = None

    def _handler(self, signum, frame):
        if self.requested:
            signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)
        self.requested = True
        fields = {"signum": int(signum),
                  "signal": signal.Signals(signum).name}
        if self.grace_s is not None:
            self.deadline_mono = time.perf_counter() + self.grace_s
            fields["grace_s"] = float(self.grace_s)
            fields["grace_deadline_mono"] = self.deadline_mono
        try:
            from ..obs.events import default_event_log

            default_event_log().emit("preemption", **fields)
        except Exception:
            pass  # the event log must never break the grace window

    def __enter__(self) -> "GracefulShutdown":
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError(
                "GracefulShutdown must be entered from the main thread: "
                "signal.signal() is a main-thread-only CPython API (got "
                f"thread {threading.current_thread().name!r}). Enter it in "
                "the main thread and share the instance, or poll its "
                "`requested` flag from workers.")
        for s in self._signals:
            self._previous[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()
