"""Structured training metrics — the port's
``torchdistpackage_tpu/utils/metrics.py``: step timing, throughput, EMA
smoothing and JSONL output, as a thin shim over ``obs.exporters``
(:class:`~..obs.exporters.JsonlSink` writes the file)::

    ml = MetricsLogger(path="metrics.jsonl", tokens_per_step=B * S)
    for step in range(n):
        params, state, loss = train_step(...)
        ml.log(step, loss=float(loss))   # prints + appends one JSON line

``log`` takes host scalars already read back (``float(loss)`` is the
sync, so the interval brackets the device's work, not the enqueue).  The
first interval (warm-up, the kernels' first build) is reported but kept
out of the running mean.  Writing and printing happen on the master
(rank 0 of the default ``torch.distributed`` group) only.  New code
should prefer ``obs.Telemetry``.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, Optional

from .logging import is_master, master_print


class MetricsLogger:
    """Per-step metrics with wall-time, throughput, and EMA smoothing.

    - ``tokens_per_step``: if set, each interval also reports
      ``tok_per_sec`` (and a running average without the first
      interval).
    - ``ema``: smoothing factor for ``<name>_ema`` companions of every
      logged scalar (0 disables).
    - ``path``: append-mode JSONL file (master process only); None keeps
      metrics in memory (``.history``) and stdout only.
    - ``print_every``: print a one-line summary every N calls (0 silences).
    - ``history_max``: in-memory records kept (a deque — the JSONL file is
      the durable sink; unbounded history would leak over a long run).
    """

    def __init__(
        self,
        path: Optional[str] = None,
        tokens_per_step: Optional[int] = None,
        ema: float = 0.9,
        print_every: int = 1,
        history_max: int = 10_000,
    ) -> None:
        self.path = path
        self.tokens_per_step = tokens_per_step
        self.ema = ema
        self.print_every = print_every
        self.history: collections.deque = collections.deque(maxlen=history_max)
        self._n_logged = 0
        self._emas: Dict[str, float] = {}
        self._last_t: Optional[float] = None
        self._n_intervals = 0
        self._tok_s_sum = 0.0
        self._is_master = is_master()
        self._sink = None
        if path is not None and self._is_master:
            # the obs layer owns JSONL writing (one code path package-wide)
            from ..obs.exporters import JsonlSink

            self._sink = JsonlSink(path)

    def log(self, step: int, **scalars: Any) -> Dict[str, Any]:
        """Record one step.  Returns the full record (all processes); side
        effects (print, file append) on the master only."""
        now = time.perf_counter()
        rec: Dict[str, Any] = {"step": int(step)}
        for k, v in scalars.items():
            v = float(v)
            rec[k] = v
            if self.ema > 0:
                prev = self._emas.get(k, v)
                self._emas[k] = self.ema * prev + (1.0 - self.ema) * v
                rec[f"{k}_ema"] = self._emas[k]
        if self._last_t is not None:
            dt = now - self._last_t
            rec["step_time_s"] = dt
            if self.tokens_per_step and dt > 0:
                tps = self.tokens_per_step / dt
                rec["tok_per_sec"] = tps
                # interval 1 is the warm-up: report it, do not average it
                if self._n_intervals >= 1:
                    self._tok_s_sum += tps
                    rec["tok_per_sec_avg"] = self._tok_s_sum / self._n_intervals
            self._n_intervals += 1
        self._last_t = now
        self.history.append(rec)
        self._n_logged += 1
        if self._is_master:
            if self._sink is not None:
                self._sink.write(rec)
            if self.print_every and self._n_logged % self.print_every == 0:
                parts = [f"step {rec['step']}"]
                for k, v in rec.items():
                    if k == "step" or k.endswith("_ema"):
                        continue
                    parts.append(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}")
                master_print("  ".join(parts))
        return rec
