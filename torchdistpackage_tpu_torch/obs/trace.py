"""Chrome-trace-event export — the port's ``torchdistpackage_tpu/obs/trace.py``:
the run's timeline as a file https://ui.perfetto.dev and
``chrome://tracing`` load.

Every step's host spans (data / dispatch / device / fetch) are complete
events on per-span tracks, the :mod:`.events` timeline instant events,
the step records' counters (card bytes in use, ``grad_norm`` /
``update_ratio``) counter tracks.  A timeline that carries serving
events also gets the serving layer (``serving/tracing.py``): one async
track per request (queued -> prefill -> decode across preemptions and a
drain -> resume), the engine tick's phase lanes and its counter tracks;
a fleet's timeline one process per replica and the router's lane.

:func:`export_trace` is the host-side view rebuilt from Telemetry's own
records: spans laid back to back from each step's end stamp, exactly
the quantities ``end_step`` measured.  Set ``TDP_TRACE=/path/trace.json``
and ``Telemetry.finalize`` writes it beside the RUNREPORT.  The
reference's ``XlaStepTrace`` (a ``jax.profiler`` window) has no
counterpart yet.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# Span name -> Chrome tid.  tid 0 carries the event timeline.
SPAN_TIDS = {"data": 1, "dispatch": 2, "device": 3, "fetch": 4}
_SPAN_ORDER = ("data", "dispatch", "device", "fetch")


def default_trace_path() -> Optional[str]:
    """The ``TDP_TRACE`` env var; empty/unset -> None (no trace file)."""
    return os.environ.get("TDP_TRACE") or None


def _metadata_events(process: int, run: str) -> List[Dict[str, Any]]:
    out = [{
        "ph": "M", "name": "process_name", "pid": process, "tid": 0,
        "args": {"name": f"host{process} [{run}]"},
    }, {
        "ph": "M", "name": "thread_name", "pid": process, "tid": 0,
        "args": {"name": "events"},
    }]
    for span, tid in SPAN_TIDS.items():
        out.append({
            "ph": "M", "name": "thread_name", "pid": process, "tid": tid,
            "args": {"name": f"step/{span}"},
        })
        out.append({
            "ph": "M", "name": "thread_sort_index", "pid": process,
            "tid": tid, "args": {"sort_index": tid},
        })
    return out


def chrome_trace_events(
    history: Sequence[Dict[str, Any]],
    events: Iterable[Dict[str, Any]] = (),
    ledger: Optional[Dict[str, Any]] = None,
    process: int = 0,
    run: str = "run",
) -> List[Dict[str, Any]]:
    """Step records + event log (+ ledger) -> Chrome trace events.

    ``history`` rows are Telemetry step records; rows without the
    ``t_end_s`` stamp (written by ``end_step``) are skipped.  Spans are
    reconstructed back-to-back from the step-end timestamp: fetch ends at
    ``t_end_s``, device before it, and so on — the inverse of how
    ``end_step`` accumulated them.  All timestamps land on one
    perf_counter-domain axis, offset so the trace starts at ts=0.
    """
    stamped = [r for r in history if "t_end_s" in r]
    ev_list = list(events)
    t0_candidates = [r["t_end_s"] - r.get("step_time_s", 0.0) for r in stamped]
    # engine_tick events span [t_start, t_mono]; anchoring t0 on t_mono
    # alone would push their spans to negative timestamps
    t0_candidates += [e.get("t_start", e["t_mono"])
                      for e in ev_list if "t_mono" in e]
    if not t0_candidates:
        return _metadata_events(process, run)
    t0 = min(t0_candidates)

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 3)

    out = _metadata_events(process, run)
    per_dim = (ledger or {}).get("per_dim") or {}
    for r in stamped:
        step = r.get("step", -1)
        end = r["t_end_s"]
        # walk backwards: fetch | device | dispatch | data
        cursor = end
        spans: List[Tuple[str, float, float]] = []
        for name in reversed(_SPAN_ORDER):
            dur = float(r.get(f"span_{name}_s", 0.0) or 0.0)
            spans.append((name, cursor - dur, dur))
            cursor -= dur
        for name, start, dur in reversed(spans):
            if dur <= 0:
                continue
            args: Dict[str, Any] = {"step": step}
            if name == "device":
                for k in ("loss", "tok_per_sec"):
                    if k in r and isinstance(r[k], (int, float)):
                        args[k] = r[k]
                if r.get("recompiled"):
                    args["recompiled"] = True
                if per_dim:
                    args["comm_bytes"] = {
                        d: v["bytes"] for d, v in per_dim.items()}
            out.append({
                "ph": "X", "name": f"{name}[{step}]" if name == "device" else name,
                "cat": "step", "pid": process, "tid": SPAN_TIDS[name],
                "ts": us(start), "dur": round(dur * 1e6, 3), "args": args,
            })
        if per_dim:
            out.append({
                "ph": "C", "name": "comm_bytes_per_step", "pid": process,
                "tid": 0, "ts": us(end - r.get("step_time_s", 0.0)),
                "args": {d: v["bytes"] for d, v in per_dim.items()},
            })
        for counter in ("grad_norm", "update_ratio"):
            # the numerics timeline as Perfetto counter tracks: scrub the
            # run and watch the gradient norm / update ratio move
            if isinstance(r.get(counter), (int, float)):
                out.append({
                    "ph": "C", "name": counter, "pid": process, "tid": 0,
                    "ts": us(end), "args": {counter: r[counter]},
                })
        if "bytes_in_use" in r:
            # the HBM timeline as a Perfetto counter track: live bytes per
            # step (and the high-water mark), from mem_ledger.live_memory
            out.append({
                "ph": "C", "name": "hbm_bytes", "pid": process, "tid": 0,
                "ts": us(end),
                "args": {
                    "live": r["bytes_in_use"],
                    "peak": r.get("peak_bytes_in_use", r["bytes_in_use"]),
                },
            })
    for e in ev_list:
        if "t_mono" not in e:
            continue
        if e.get("kind") == "engine_tick":
            # rendered as phase lanes + counter tracks below, not as a
            # per-tick instant (hundreds of identical pins are noise)
            continue
        args = {k: v for k, v in e.items()
                if k not in ("type", "kind", "t_wall", "t_mono", "process")
                and v is not None}
        out.append({
            "ph": "i", "name": e.get("kind", "event"), "cat": "event",
            "pid": process, "tid": 0, "ts": us(e["t_mono"]), "s": "t",
            "args": args,
        })
    # serving observability: when the timeline carries serving events,
    # append the request-lifecycle flow tracks and the tick phase lanes /
    # counter tracks (serving/tracing.py), on the SAME t0 axis.  Local
    # import: obs stays a leaf at module scope.
    if any(e.get("kind") in ("engine_tick", "request_submitted")
           for e in ev_list):
        try:
            from ..serving.tracing import serving_trace_events
        except ImportError:
            serving_trace_events = None
        if serving_trace_events is not None:
            out.extend(serving_trace_events(ev_list, process=process, t0=t0))
    return out


def build_trace(
    history: Sequence[Dict[str, Any]],
    events: Iterable[Dict[str, Any]] = (),
    ledger: Optional[Dict[str, Any]] = None,
    process: int = 0,
    run: str = "run",
) -> Dict[str, Any]:
    """The full Chrome trace object (``{"traceEvents": [...], ...}``)."""
    return {
        "traceEvents": chrome_trace_events(
            history, events=events, ledger=ledger, process=process, run=run),
        "displayTimeUnit": "ms",
        "otherData": {"run": run, "exporter": "torchdistpackage_tpu_torch.obs.trace"},
    }


def export_trace(telemetry, path: str) -> Dict[str, Any]:
    """Write ``telemetry``'s host trace to ``path`` (best-effort on OSError,
    like the RUNREPORT writer) and return the trace object."""
    trace = build_trace(
        telemetry.history,
        events=telemetry.events.as_list(),
        ledger=getattr(telemetry, "comm_ledger", None),
        process=0 if telemetry._is_master else 1,
        run=telemetry.run,
    )
    try:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(trace, f)
    except OSError:
        pass
    return trace


_VALID_PH = {"X", "B", "E", "i", "I", "C", "M", "b", "e", "n", "s", "t", "f"}


def validate_trace(obj: Any) -> List[str]:
    """Structural validation against the Chrome trace-event JSON format
    (the subset Perfetto/chrome://tracing require).  Returns problem
    strings; empty list = loadable."""
    errs: List[str] = []
    if isinstance(obj, list):  # the bare-array variant is legal too
        events = obj
    elif isinstance(obj, dict):
        events = obj.get("traceEvents")
        if not isinstance(events, list):
            return ["traceEvents missing or not a list"]
    else:
        return [f"trace is {type(obj).__name__}, expected dict or list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where} is not an object")
            break
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            errs.append(f"{where} has bad ph {ph!r}")
        if "name" not in ev:
            errs.append(f"{where} lacks name")
        if ph not in ("M",):
            if not isinstance(ev.get("ts"), (int, float)):
                errs.append(f"{where} lacks numeric ts")
            elif ev["ts"] < 0:
                errs.append(f"{where} has negative ts")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            errs.append(f"{where} complete event lacks dur")
        if errs and len(errs) > 8:
            break
    return errs
