"""Pluggable metric sinks — the PyTorch port's copy of
``torchdistpackage_tpu/obs/exporters.py``.

Every sink speaks one protocol — ``write(record: dict)`` for per-step /
event records and ``write_summary(report: dict)`` at end of run:

- :class:`JsonlSink` (JAX :35) — always available, the durable artifact;
  the one JSONL code path of the port (``utils.MetricsLogger`` and
  ``obs.EventLog(path=)`` write through it).
- :class:`TensorBoardSink` (:77) — scalars via ``tensorboardX`` or
  ``torch.utils.tensorboard``, behind :func:`tensorboard_available` (:62):
  without either package it refuses at construction.
- :class:`PrometheusTextfileSink` (:116) — node-exporter textfile-collector
  gauges, rewritten atomically.
- :class:`MultiSink` (:163) — fan-out; one failing sink does not take
  down the others.

The serving engine's live export rides the same protocol:
``ServingEngine(metrics_sink=...)`` writes one ``serving_metrics`` record
(:data:`~..serving.tracing.SERVING_METRICS_SCHEMA`) every
``metrics_every`` ticks.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Iterable, List, Optional


class JsonlSink:
    """Append one JSON line per record.  Opens lazily, appends, flushes per
    write (a preempted run keeps everything emitted so far)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = None

    def _file(self):
        if self._f is None:
            self._f = open(self.path, "a")
        return self._f

    def write(self, record: Dict[str, Any]) -> None:
        f = self._file()
        f.write(json.dumps(record) + "\n")
        f.flush()

    def write_summary(self, report: Dict[str, Any]) -> None:
        self.write({"type": "summary", **report})

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def tensorboard_available() -> bool:
    try:
        import tensorboardX  # noqa: F401

        return True
    except ImportError:
        pass
    try:
        from torch.utils import tensorboard  # noqa: F401

        return True
    except ImportError:
        return False


class TensorBoardSink:
    """Scalar records -> TensorBoard.  Optional dependency: raises a clear
    ImportError at CONSTRUCTION (not at first write, deep inside a train
    loop) when no writer implementation is installed; gate with
    :func:`tensorboard_available`."""

    def __init__(self, logdir: str) -> None:
        writer = None
        try:
            from tensorboardX import SummaryWriter

            writer = SummaryWriter(logdir)
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter

                writer = SummaryWriter(logdir)
            except ImportError:
                raise ImportError(
                    "TensorBoardSink needs tensorboardX or torch; neither is "
                    "installed — use JsonlSink (always available) or check "
                    "obs.tensorboard_available() before constructing"
                )
        self._writer = writer

    def write(self, record: Dict[str, Any]) -> None:
        step = int(record.get("step", 0))
        for k, v in record.items():
            if isinstance(v, (int, float)) and k != "step":
                self._writer.add_scalar(k, float(v), step)

    def write_summary(self, report: Dict[str, Any]) -> None:
        self._writer.add_text("runreport", json.dumps(report, indent=1))
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()


class PrometheusTextfileSink:
    """Latest-value gauges in node-exporter textfile-collector format.

    Each ``write`` updates the in-memory gauge set and atomically rewrites
    ``path`` (tmp + rename — the collector must never read a torn file).
    Labels: ``run`` and ``process`` on every gauge.
    """

    def __init__(self, path: str, prefix: str = "tdp", run: str = "run") -> None:
        self.path = path
        self.prefix = prefix
        self.run = run
        self._gauges: Dict[str, float] = {}

    def write(self, record: Dict[str, Any]) -> None:
        for k, v in record.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self._gauges[k] = float(v)
        self._flush(process=record.get("process", 0))

    def write_summary(self, report: Dict[str, Any]) -> None:
        flat = _flatten_scalars(report)
        for k, v in flat.items():
            self._gauges[f"summary_{k}"] = v
        self._flush()

    def _flush(self, process: int = 0) -> None:
        lines: List[str] = []
        labels = f'{{run="{self.run}",process="{process}"}}'
        for k in sorted(self._gauges):
            name = f"{self.prefix}_{_sanitize(k)}"
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{labels} {self._gauges[k]:.10g}")
        body = "\n".join(lines) + "\n"
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        try:
            fd, tmp = tempfile.mkstemp(dir=d, prefix=".prom_tmp")
            with os.fdopen(fd, "w") as f:
                f.write(body)
            os.replace(tmp, self.path)
        except OSError:
            pass  # read-only dir: scrape target simply goes stale

    def close(self) -> None:
        pass


class MultiSink:
    """Fan a record out to several sinks; one failing sink (e.g. a full
    disk behind JsonlSink) must not take down the others."""

    def __init__(self, sinks: Iterable[Any]) -> None:
        self.sinks = list(sinks)

    def write(self, record: Dict[str, Any]) -> None:
        for s in self.sinks:
            try:
                s.write(record)
            except Exception:
                pass

    def write_summary(self, report: Dict[str, Any]) -> None:
        for s in self.sinks:
            try:
                s.write_summary(report)
            except Exception:
                pass

    def close(self) -> None:
        for s in self.sinks:
            try:
                s.close()
            except Exception:
                pass


def _sanitize(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def _flatten_scalars(tree: Dict[str, Any], prefix: str = "") -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, bool):
            continue
        if isinstance(v, (int, float)):
            out[key] = float(v)
        elif isinstance(v, dict):
            out.update(_flatten_scalars(v, prefix=f"{key}_"))
    return out
