"""Telemetry — the per-run object a loop reports through, the
port's ``torchdistpackage_tpu/obs/telemetry.py``.

Wrap the step once and every call is accounted for::

    tel = Telemetry(run="train_llama", tokens_per_step=B * S,
                    sinks=[JsonlSink("metrics.jsonl")])
    step = tel.wrap_step(step)
    for it in range(n):
        batch = next(batches)                      # -> 'data' span
        params, state, loss = step(params, state, batch)   # -> 'dispatch'
        rec = tel.end_step(step=it, loss=loss)     # -> 'device' + 'fetch'
    report = tel.finalize()                        # RUNREPORT.json (+ .md)

Per-step spans (host clock, seconds):

- ``data``     — end of the last step's fetch to this step's call.
- ``dispatch`` — the wrapped call itself: PyTorch's eager enqueue, and
  for a step that reads its results back (the serving step) the device's
  work too.
- ``device``   — the wait on a CUDA event recorded right after the
  wrapped call, on the card's current stream: the work still queued
  when the call returned.  Never a ``torch.cuda.synchronize()``, and
  nothing is launched.  0 on the CPU.
- ``fetch``    — ``float()`` of the scalars handed to :meth:`end_step`.

Signatures.  The port runs eagerly and compiles no program, so there is
no compiled cost to read: the wrapper always calls the original
callable.  It keys each call on the shapes and dtypes of the tensors
and arrays among its arguments (other leaves, such as the sampling
streams, do not enter the key).  The first call of a wrapped step is
its ``compile`` event, carrying that call's wall time (on the card it
includes the kernels' build at first use); a later new signature of
the same step is a ``recompile`` event and ``recompiled: true`` on its
step record.  The report's ``mfu`` carries the hand formula only (no
``xla*`` keys) and ``memory.programs`` is ``[]``.

Comm: the first call of the first signature runs inside a
:class:`~.comm_ledger.CommRecorder` (where the reference parses the
first compiled signature's HLO), so :attr:`Telemetry.comm_ledger` holds
every collective that call made, and :meth:`Telemetry.finalize` turns it
into the report's ``comm`` section (:func:`~.comm_model.comm_report`,
the steady steps' mean against the hand formula's FLOPs a step).  Steady
steps record nothing.  ``comm_ledger_enabled=False``: no recorder,
``comm`` is ``{}``.

Memory: ``mem_ledger.live_memory`` (the port's one
``torch.cuda.memory_stats`` reader) is polled at each step's end into a
live / peak timeline (``mem_snapshot`` events, a Perfetto counter track)
and the report's ``memory`` section judges the measured peak against
the card's capacity.  Numerics: ``end_step(numerics=stats)`` takes host
stats (or 0-dim tensors) and the :func:`~.numerics.check_alerts`
thresholds run over every record, the loss included.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from . import aggregate as _agg
from . import report as _report
from .events import EventLog, set_default_event_log

#: Peak dense bf16 FLOP/s by CUDA device name (NVIDIA's data sheet for
#: the H100 SXM); the one lookup table of the port.
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}


def peak_flops_for(device_name: str) -> Optional[float]:
    """The card's peak dense bf16 FLOP/s by its exact CUDA name; None for
    any other device."""
    return PEAK_BF16_FLOPS.get(device_name)


def _abstract_signature(args: Any) -> Tuple:
    """The shapes and dtypes of every tensor and array in ``args`` (nested
    dicts, lists and tuples walked in order): what a new eager shape is
    keyed on.  Other leaves do not enter it."""
    sig: List[Tuple] = []

    def walk(node: Any) -> None:
        if isinstance(node, (torch.Tensor, np.ndarray)):
            sig.append((tuple(node.shape), str(node.dtype)))
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(args)
    return tuple(sig)


def _host_numerics(stats: Dict[str, Any]) -> Dict[str, Any]:
    """A (possibly nested) dict of host scalars or 0-dim tensors as host
    floats; what is not a number passes through."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        try:
            return float(node)
        except (TypeError, ValueError, RuntimeError):
            return node

    return conv(stats)


def _scalar(v: Any) -> Any:
    try:
        return float(v)
    except (TypeError, ValueError, RuntimeError):
        return v


class Telemetry:
    """One instance per run; see the module docstring for the loop shape.

    Parameters
    ----------
    run: name stamped on every record and the report.
    sinks: exporter sinks fed every step record and the summary
        (:mod:`.exporters`); the in-memory history and the RUNREPORT work
        without any.
    tokens_per_step: enables tokens/s accounting.
    flops_per_token: the hand formula (e.g. 6N + 12LSD); with
        ``peak_flops`` it gives the report's ``mfu.formula``.
    peak_flops: the card's peak FLOP/s; default :func:`peak_flops_for`
        the card's name, None on the CPU.
    report_path: where :meth:`finalize` writes ``RUNREPORT.json`` (+ a
        sibling ``.md``); default the ``TDP_RUNREPORT`` variable, unset ->
        no file (the report dict is still returned).
    event_log: a shared :class:`EventLog`; by default a fresh one is made
        AND installed as the process default, so the chaos harness, the
        watchdog and signal handlers land on this run's timeline.
    trace_path: where :meth:`finalize` writes the Perfetto trace
        (:mod:`.trace`); default the ``TDP_TRACE`` variable.
    device: the card the run's steps run on (``None``: the card, which
        must exist; ``"cpu"`` for the plain path).  Names the report's
        ``backend`` (``"gpu"`` / ``"cpu"``) and ``chip``, and is the card
        the memory poll and the ``device`` span's event read.
    mem_snapshot_every: a ``mem_snapshot`` event every N steps (0: never;
        every step's sample lands on its record regardless).
    numerics_thresholds: overrides of :data:`~.numerics.DEFAULT_THRESHOLDS`.
    profile_window: a :class:`~.trace.ProfilerStepWindow` — a
        ``torch.profiler`` capture bracketing a window of wrapped steps
        (the reference's ``xla_trace=``).
    comm_ledger_enabled: record the collectives of the first wrapped
        call into :attr:`comm_ledger` (see the module docstring); the
        ledger's ``mesh_axes`` and the comm model's axes are
        ``dist.topology.tpc``'s layout, when it is set up.
    """

    def __init__(
        self,
        run: str = "run",
        sinks: Optional[List[Any]] = None,
        tokens_per_step: Optional[int] = None,
        flops_per_token: Optional[float] = None,
        peak_flops: Optional[float] = None,
        report_path: Optional[str] = None,
        event_log: Optional[EventLog] = None,
        poll_memory: bool = True,
        history_max: int = 100_000,
        trace_path: Optional[str] = None,
        device: DeviceLike = None,
        mem_snapshot_every: int = 16,
        numerics_thresholds: Optional[Dict[str, float]] = None,
        profile_window: Optional[Any] = None,
        comm_ledger_enabled: bool = True,
    ) -> None:
        from . import trace as _trace

        self.device = resolve_device(device)
        self.run = run
        self.sinks = list(sinks) if sinks else []
        self.tokens_per_step = tokens_per_step
        self.flops_per_token = flops_per_token
        self.poll_memory = poll_memory
        self.report_path = (report_path if report_path is not None
                            else _report.default_report_path())
        self.trace_path = (trace_path if trace_path is not None
                           else _trace.default_trace_path())
        self.mem_snapshot_every = mem_snapshot_every
        #: per-step live / peak card-memory samples
        self.mem_timeline: List[Dict[str, Any]] = []
        self._peak_frac = 0.0
        self._oom_emitted = False
        self.numerics_thresholds = dict(numerics_thresholds or {})
        #: per-step numerics samples (the training-dynamics timeline)
        self.numerics_timeline: List[Dict[str, Any]] = []
        self._alert_active: set = set()
        self.parity: Optional[Dict[str, Any]] = None
        self.compression: Optional[Dict[str, Any]] = None
        self.profile_window = profile_window
        self.comm_ledger_enabled = comm_ledger_enabled
        #: the ledger of the first wrapped call's collectives
        #: (``obs.comm_ledger``); None until that call, or when disabled
        self.comm_ledger: Optional[Dict[str, Any]] = None
        if event_log is None:
            event_log = EventLog()
            set_default_event_log(event_log)
        self.events = event_log
        self.counters: Dict[str, Any] = {}
        self.resilience: Optional[Dict[str, Any]] = None
        self.serving: Optional[Dict[str, Any]] = None
        self.router: Optional[Dict[str, Any]] = None
        self.autoplan: Optional[Dict[str, Any]] = None
        self.history: List[Dict[str, Any]] = []
        self._history_max = history_max

        cuda = self.device.type == "cuda"
        self._backend = "gpu" if cuda else self.device.type
        self._chip = (torch.cuda.get_device_name(self.device) if cuda
                      else self.device.type)
        self._n_devices = torch.cuda.device_count() if cuda else 1
        grouped = dist.is_available() and dist.is_initialized()
        self._n_processes = dist.get_world_size() if grouped else 1
        self._is_master = not grouped or dist.get_rank() == 0
        self.peak_flops = (peak_flops if peak_flops is not None
                           else peak_flops_for(self._chip) if cuda else None)
        #: one reusable CUDA event (no timing) marking the end of each
        #: wrapped call on the card's current stream
        self._event = torch.cuda.Event() if cuda else None
        self._event_pending = False

        self._signatures: Dict[Tuple, float] = {}
        self._wrap_n = 0  # wrap_step counter: scopes signatures per fn
        self._pending_spans: Dict[str, float] = {}
        self._recompiled = False
        self._last_fetch_end: Optional[float] = None
        self._step_n = 0
        self.n_compiles = 0
        self.n_recompiles = 0
        self.compile_time_s = 0.0
        self._peak_bytes = 0
        self._t_start = time.monotonic()
        self.events.emit(
            "run_start", run=run, backend=self._backend, chip=self._chip,
            n_devices=self._n_devices, n_processes=self._n_processes,
        )

    # ------------------------------------------------------------- wrapping

    def wrap_step(self, fn: Callable) -> Callable:
        """Instrument a step callable.  The wrapper calls ``fn`` unchanged
        (telemetry never changes what the loop computes), times the call
        (the ``dispatch`` span), records the ``device`` span's CUDA event
        after it, and emits ``compile`` / ``recompile`` for a new
        signature.  Signatures are scoped per wrapped callable: two steps
        wrapped by one Telemetry are two first compiles."""
        self._wrap_n += 1
        wrap_id = self._wrap_n

        def wrapped(*args, **kwargs):
            now = time.perf_counter()
            if self._last_fetch_end is not None:
                self._pending_spans["data"] = now - self._last_fetch_end
            if self.profile_window is not None:
                self.profile_window.on_step_start(self._step_n)
            sig = (wrap_id, _abstract_signature((args, kwargs)))
            recorder = None
            if (self.comm_ledger_enabled and not self._signatures
                    and self.comm_ledger is None):
                from .comm_ledger import CommRecorder

                recorder = CommRecorder()
            t0 = time.perf_counter()
            with recorder or contextlib.nullcontext():
                out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            if recorder is not None:
                self.comm_ledger = recorder.ledger()
            if self._event is not None:
                self._event.record(torch.cuda.current_stream(self.device))
                self._event_pending = True
            self._pending_spans["dispatch"] = dt
            if sig not in self._signatures:
                self._new_signature(sig, dt)
            return out

        return wrapped

    def _new_signature(self, sig: Tuple, dt: float) -> None:
        # a RE-compile is the same wrapped step seeing a new signature; a
        # different wrapped step's first call is a plain compile
        re_sig = any(k[0] == sig[0] for k in self._signatures)
        self._signatures[sig] = dt
        self.n_compiles += 1
        self.compile_time_s += dt
        if re_sig:
            self._recompiled = True
            self.n_recompiles += 1
        self.events.emit(
            "recompile" if re_sig else "compile", run=self.run,
            compile_time_s=round(dt, 4),
            n_signatures=len(self._signatures))

    # ------------------------------------------------------------ recording

    def end_step(
        self,
        step: Optional[int] = None,
        *,
        numerics: Optional[Dict[str, Any]] = None,
        **scalars: Any,
    ) -> Dict[str, Any]:
        """Close the step opened by the wrapped call: wait on its event
        (``device`` span), read the passed scalars back (``fetch`` span),
        build the record, feed the sinks.  Returns the record with host
        floats.  ``numerics``: the step's numerics stats (host floats or
        0-dim tensors), read with the scalars; it lands on the record as
        ``rec["numerics"]`` (``grad_norm`` / ``update_ratio`` /
        ``nonfinite_grads`` promoted to top-level floats), extends the
        numerics timeline and runs the alert thresholds."""
        t0 = time.perf_counter()
        if self._event_pending:
            self._event.synchronize()
            self._event_pending = False
        t1 = time.perf_counter()
        rec: Dict[str, Any] = {
            "type": "step",
            "run": self.run,
            "step": int(step) if step is not None else self._step_n,
        }
        for k, v in scalars.items():
            rec[k] = _scalar(v)
        if numerics is not None:
            rec["numerics"] = _host_numerics(numerics)
            for k in ("grad_norm", "update_ratio", "nonfinite_grads"):
                if k in rec["numerics"]:
                    rec[k] = rec["numerics"][k]
        t2 = time.perf_counter()
        spans = dict(self._pending_spans)
        self._pending_spans = {}
        spans["device"] = t1 - t0
        spans["fetch"] = t2 - t1
        for name, dt in spans.items():
            rec[f"span_{name}_s"] = dt
        step_time = sum(spans.values())
        rec["step_time_s"] = step_time
        rec["t_end_s"] = t2  # perf_counter-domain stamp for the trace
        if self.profile_window is not None:
            self.profile_window.on_step_end(rec["step"])
        if self._recompiled:
            rec["recompiled"] = True
            self._recompiled = False
        if self.tokens_per_step and step_time > 0:
            rec["tok_per_sec"] = self.tokens_per_step / step_time
        if self.poll_memory:
            self._poll_memory(rec)
        if numerics is not None:
            self.numerics_timeline.append({
                "step": rec["step"],
                **{k: v for k, v in rec["numerics"].items() if k != "groups"},
                **({"loss": rec["loss"]}
                   if isinstance(rec.get("loss"), float) else {}),
            })
        # alerts fire on ENTERING a bad state, not every step inside it
        from . import numerics as _numerics

        alerts = _numerics.check_alerts(rec, self.numerics_thresholds)
        for a in alerts:
            if a["reason"] not in self._alert_active:
                self.events.emit(
                    "numerics_alert", step=rec["step"],
                    source="telemetry", **a)
        self._alert_active = {a["reason"] for a in alerts}
        self._last_fetch_end = t2
        self._step_n += 1
        if len(self.history) < self._history_max:
            self.history.append(rec)
        if self._is_master:
            for s in self.sinks:
                try:
                    s.write(rec)
                except Exception:
                    pass  # a sink must never stop the loop it observes
        return rec

    def _poll_memory(self, rec: Dict[str, Any]) -> None:
        from .mem_ledger import OOM_RISK_FRAC, live_memory

        mem = live_memory(self.device)
        if not mem["reported"]:
            return
        rec["peak_bytes_in_use"] = mem["peak_bytes"]
        rec["bytes_in_use"] = mem["live_bytes"]
        self._peak_bytes = max(self._peak_bytes, mem["peak_bytes"])
        self._peak_frac = max(self._peak_frac, mem["peak_frac"])
        self.mem_timeline.append({
            "step": rec["step"],
            "live_bytes": mem["live_bytes"],
            "peak_bytes": mem["peak_bytes"],
        })
        if self.mem_snapshot_every and \
                self._step_n % self.mem_snapshot_every == 0:
            self.events.emit(
                "mem_snapshot", step=rec["step"],
                live_bytes=mem["live_bytes"], peak_bytes=mem["peak_bytes"],
                peak_frac=mem["peak_frac"])
        if not self._oom_emitted and mem["peak_frac"] >= OOM_RISK_FRAC:
            # the first crossing lands on the timeline as it happens
            self._oom_emitted = True
            self.events.emit(
                "oom_risk", step=rec["step"],
                peak_frac=round(mem["peak_frac"], 4),
                basis="live memory_stats sample")

    def record_counters(self, **named: Any) -> None:
        """Attach per-parallelism counters to the report, e.g.
        ``tel.record_counters(pipeline={"bubble_fraction": f})``."""
        self.counters.update(named)

    def record_resilience(self, summary: Dict[str, Any]) -> None:
        """The report's optional ``resilience`` section."""
        self.resilience = dict(summary)

    def record_parity(self, section: Dict[str, Any]) -> None:
        """The report's optional ``numerics.parity`` sub-section."""
        self.parity = dict(section)

    def record_compression(self, section: Dict[str, Any]) -> None:
        """The report's optional ``compression`` section."""
        self.compression = dict(section)

    def record_autoplan(self, section: Dict[str, Any]) -> None:
        """The report's optional ``autoplan`` section."""
        self.autoplan = dict(section)

    def record_serving(self, summary: Dict[str, Any]) -> None:
        """Attach a ``ServingEngine.serving_summary()`` as the report's
        ``serving`` section (its ``kv_pool`` also feeds the ``memory``
        section's pool cross-check)."""
        self.serving = dict(summary)

    def record_router(self, summary: Dict[str, Any]) -> None:
        """Attach a ``serving.Router.summary()`` as the report's ``router``
        section: one serving section per replica and the fleet roll-up
        (a FLEETREPORT)."""
        self.router = dict(summary)

    # ------------------------------------------------------------- finalize

    def _steady_steps(self) -> List[Dict[str, Any]]:
        """Records without the first one and any recompiled one: those
        intervals time a first call, not the steady state."""
        if not self.history:
            return []
        first = self.history[0]["step"]
        return [r for r in self.history
                if not r.get("recompiled") and r["step"] != first]

    def finalize(
        self,
        extra: Optional[Dict[str, Any]] = None,
        write: bool = True,
        print_summary: bool = True,
    ) -> Dict[str, Any]:
        """Build the end-of-run report; on the master write
        ``RUNREPORT.json`` + markdown and the trace (where paths are set)
        and hand the summary to every sink.  A collective when a process
        group is up (the cross-process step-time gather): call it on
        every process."""
        from . import mem_ledger as _mem
        from . import numerics as _numerics

        steady = self._steady_steps()
        times = [r["step_time_s"] for r in steady]
        stats = _agg.step_time_stats(times)
        hosts = _agg.cross_host_step_stats(times, event_log=self.events)

        span_means: Dict[str, float] = {}
        for name in ("data", "dispatch", "device", "fetch"):
            vals = [r[f"span_{name}_s"] for r in steady
                    if f"span_{name}_s" in r]
            if vals:
                span_means[name] = float(np.mean(vals))

        throughput: Dict[str, Any] = {}
        tps = [r["tok_per_sec"] for r in steady if "tok_per_sec" in r]
        if tps:
            throughput["tokens_per_sec"] = float(np.mean(tps))
            throughput["tokens_per_sec_final"] = float(tps[-1])
            stride = max(1, len(tps) // 64)
            throughput["trajectory"] = [round(t, 2) for t in tps[::stride]]

        mfu: Dict[str, Any] = {}
        mean_t = stats.get("mean", 0.0)
        if mean_t > 0 and self.flops_per_token and self.tokens_per_step:
            formula = self.flops_per_token * self.tokens_per_step
            mfu["formula_flops_per_step"] = formula
            if self.peak_flops:
                mfu["formula"] = round(formula / mean_t / self.peak_flops, 4)

        comm: Dict[str, Any] = {}
        if self.comm_ledger is not None:
            from ..dist.topology import tpc
            from . import comm_model as _comm_model

            comm = _comm_model.comm_report(
                self.comm_ledger, stats.get("mean"),
                flops=mfu.get("formula_flops_per_step"),
                peak_flops=self.peak_flops,
                ctx=tpc if tpc.is_initialized else None)

        kv_pool = None
        if self.serving is not None and "kv_pool" in self.serving:
            kv_pool = {
                k: self.serving["kv_pool"].get(k)
                for k in ("pool_bytes", "pool_bytes_expected", "num_blocks",
                          "block_size", "dp_groups")
                if k in self.serving["kv_pool"]
            } or None
        memory = _mem.mem_report(
            measured_peak_bytes=self._peak_bytes or None,
            measured_peak_frac=self._peak_frac or None,
            capacity_bytes=_mem.device_capacity(self.device),
            timeline=self.mem_timeline,
            kv_pool=kv_pool,
            emit=not self._oom_emitted,
        )
        memory["peak_bytes_in_use"] = self._peak_bytes
        memory["reported"] = self._peak_bytes > 0

        numerics_sec = _numerics.numerics_report(
            timeline=self.numerics_timeline,
            events=self.events.as_list(),
            parity=self.parity,
            thresholds=self.numerics_thresholds,
        )

        if self.profile_window is not None:
            self.profile_window.close()
        self.events.emit("run_end", run=self.run, steps=self._step_n)
        report = {
            "schema": _report.RUNREPORT_SCHEMA,
            "run": self.run,
            "backend": self._backend,
            "chip": self._chip,
            "n_devices": self._n_devices,
            "n_processes": self._n_processes,
            "steps": self._step_n,
            "wall_time_s": round(time.monotonic() - self._t_start, 3),
            "step_time_s": stats,
            "spans_mean_s": span_means,
            "throughput": throughput,
            "mfu": mfu,
            "memory": memory,
            "numerics": numerics_sec,
            "compile": {
                "count": self.n_compiles,
                "time_s": round(self.compile_time_s, 3),
                # same-step new signatures only: two different wrapped
                # steps are two first compiles
                "recompiles": self.n_recompiles,
            },
            "hosts": hosts,
            "comm": comm,
            "counters": self.counters,
            "events": self.events.as_list(),
        }
        if self.resilience is not None:
            report["resilience"] = self.resilience
        if self.serving is not None:
            report["serving"] = self.serving
        if self.router is not None:
            report["router"] = self.router
        if self.compression is not None:
            report["compression"] = self.compression
        if self.autoplan is not None:
            report["autoplan"] = self.autoplan
        if extra:
            report.update(extra)
        if self._is_master:
            for s in self.sinks:
                try:
                    s.write_summary(report)
                except Exception:
                    pass  # a sink must never stop the run it reports
            if write and self.report_path:
                _report.write_runreport(report, self.report_path)
            if write and self.trace_path:
                from . import trace as _trace

                _trace.export_trace(self, self.trace_path)
            if print_summary:
                from ..utils.logging import master_print

                master_print(_report.render_summary_line(report))
        return report
