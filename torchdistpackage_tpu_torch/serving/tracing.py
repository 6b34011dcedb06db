"""Serving observability — the port's ``torchdistpackage_tpu/serving/tracing.py``:
request-lifecycle tracing and tick-level accounting, all host-side over
plain event dicts (no device call, nothing the engine's
``decode_signatures == 1`` contract could see):

- **Request-lifecycle assembly** (:func:`assemble_request_timelines`):
  the timeline replayed into one record per request instance — phase
  spans (``queued`` -> ``prefill`` -> ``decode``, ``queued`` again on a
  preemption or a fault requeue), per-tick children from the
  ``engine_tick`` rid attribution, instant marks, the terminal state,
  and drain -> resume links.  ``sequence`` is the ordered walk.
- **Perfetto rendering** (:func:`request_trace_events`,
  :func:`tick_trace_events`, :func:`serving_trace_events`): one async
  track per request instance with flow arrows across preemptions and a
  restart; each ``engine_tick`` as phase lanes (audit / sched / prefill
  / draft / decode / fetch / host, back to back from the tick's start)
  and counter tracks.  ``obs.trace.chrome_trace_events`` appends it when
  serving events are on the timeline.
- **Fleet stitching** (:func:`assemble_fleet_request_timelines`,
  :func:`fleet_trace_events`): a Router's shared timeline (each engine's
  events tagged ``replica=i``) stitched into one journey per router rid
  across its placements and migrations, rendered with a process per
  replica, the router's decision lane and flow arrows between them.
- **Live export** (:func:`serving_metrics_record`): one tick record
  flattened into the ``serving_metrics`` schema
  (:data:`SERVING_METRICS_SCHEMA`) the engine's ``metrics_sink=`` writes.
- **Operator table** (:func:`phase_table`): the per-tick phase breakdown
  as text.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence

#: Schema tag on every ``metrics_sink`` record (the fields:
#: :func:`serving_metrics_record`).
SERVING_METRICS_SCHEMA = "tdp-serving-metrics/v1"

#: Per-tick phases, in execution order (the order the lanes are laid
#: back-to-back from the tick start): invariant ``audit``, host
#: ``sched``-uling (expiry + admission + the COW flush), the ``prefill``
#: chunk's enqueue, the host ``draft``-er (speculative only), the
#: ``decode``/verify enqueue, output ``fetch`` (the wait for the step's
#: one device->host read-back, and Telemetry's ``end_step``), and the
#: residual ``host`` walk.  A step that marks no enqueue time
#: (``TorchDeviceStep.t_enqueued``) charges its whole call to its phase.
TICK_PHASES = ("audit", "sched", "prefill", "draft", "decode", "fetch",
               "host")

#: Request phase-span vocabulary (re-entered on preemption/requeue).
REQUEST_PHASES = ("queued", "prefill", "decode")

#: Terminal states a request instance can reach.  ``exported`` ends an
#: instance on the engine that migrated it out; the importing engine's
#: instance (opened by ``request_imported``) continues the request.
REQUEST_TERMINALS = ("retired", "cancelled", "shed", "expired", "drained",
                     "exported")

#: Chrome tids for the tick phase lanes (obs/trace.py owns 0-4 for the
#: step spans; serving lanes start at 10).
TICK_TIDS = {name: 10 + i for i, name in enumerate(TICK_PHASES)}


def serving_metrics_record(rec: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten one engine tick record into the ``serving_metrics`` sink
    schema: scalar gauges only (PrometheusTextfileSink turns every
    numeric field into a gauge; JsonlSink keeps the record whole)."""
    out: Dict[str, Any] = {
        "type": "serving_metrics",
        "schema": SERVING_METRICS_SCHEMA,
        "tick": rec["tick"],
        "tick_s": rec.get("tick_s", 0.0),
        "queue_depth": rec.get("queue_depth", 0),
        "busy_slots": rec.get("busy", 0),
        "prefill_slots": rec.get("prefill_slots", 0),
        "decode_slots": rec.get("decode_slots", 0),
        "batch_util": rec.get("batch_util", 0.0),
        "pool_util": rec.get("pool_util", 0.0),
        "admitted": rec.get("admitted", 0),
        "expired": rec.get("expired", 0),
        "emitted_tokens": rec.get("emitted_tokens", 0),
        "prefix_hit_rate": rec.get("prefix_hit_rate", 0.0),
        "spec_accept_rate": rec.get("spec_accept_rate", 0.0),
    }
    phases = rec.get("phases") or {}
    for name in TICK_PHASES:
        out[f"phase_{name}_s"] = float(phases.get(name, 0.0))
    return out


# ------------------------------------------------------ lifecycle assembly


def _new_record(rid: int, instance: int) -> Dict[str, Any]:
    return {
        "rid": int(rid),
        "uid": f"{int(rid)}.{instance}",
        "spans": [],        # [{"name", "t0", "t1"}] phase-level
        "ticks": [],        # [{"name", "tick", "t0", "t1"}] per-tick children
        "marks": [],        # [{"name", "t"}] instants
        "sequence": [],     # ordered phase/mark walk (the lifecycle)
        "terminal": None,
        "resumed_from": None,
        "resumed_to": None,
        "preemptions": 0,
        "args": {},
        "_phase": None,
        "_t_phase": None,
    }


def _open_phase(rec: Dict[str, Any], name: str, t: float) -> None:
    rec["_phase"], rec["_t_phase"] = name, t
    rec["sequence"].append(name)


def _close_phase(rec: Dict[str, Any], t: float) -> None:
    if rec["_phase"] is None:
        return
    t0 = rec["_t_phase"]
    rec["spans"].append(
        {"name": rec["_phase"], "t0": t0, "t1": max(t, t0)})
    rec["_phase"] = rec["_t_phase"] = None


def _mark(rec: Dict[str, Any], name: str, t: float) -> None:
    rec["marks"].append({"name": name, "t": t})
    rec["sequence"].append(name)


def assemble_request_timelines(
    events: Iterable[Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """Replay an event timeline into per-request-instance lifecycle
    records (submission order).  Tolerant of a log attached mid-run: an
    event for a request whose submission was never seen opens a fresh
    record at that event.  Request ids restart at 0 per engine, so
    instances are keyed ``uid = "<rid>.<n>"`` — a reused rid (several
    engines sharing one timeline, or drain→resume) gets a NEW instance,
    and ``request_resumed`` links the new instance to the one it
    continues (``resumed_from`` / ``resumed_to``)."""
    records: List[Dict[str, Any]] = []
    open_by_rid: Dict[int, Dict[str, Any]] = {}
    all_by_rid: Dict[int, List[Dict[str, Any]]] = {}

    def start(rid: int, t: float) -> Dict[str, Any]:
        rec = _new_record(rid, len(all_by_rid.get(rid, [])))
        records.append(rec)
        open_by_rid[rid] = rec
        all_by_rid.setdefault(rid, []).append(rec)
        _open_phase(rec, "queued", t)
        return rec

    def ensure(rid: int, t: float) -> Dict[str, Any]:
        rec = open_by_rid.get(rid)
        return rec if rec is not None else start(rid, t)

    def finish(rid: int, t: float, terminal: str) -> None:
        rec = ensure(rid, t)
        _close_phase(rec, t)
        rec["terminal"] = terminal
        rec["sequence"].append(terminal)
        open_by_rid.pop(rid, None)

    def requeue(rid: int, t: float, mark: str) -> None:
        rec = open_by_rid.get(rid)
        if rec is None:
            return
        _close_phase(rec, t)
        _mark(rec, mark, t)
        rec["preemptions"] += 1
        _open_phase(rec, "queued", t)

    for e in events:
        kind = e.get("kind")
        t = e.get("t_mono")
        if kind is None or t is None:
            continue
        rid = e.get("rid")
        if kind == "request_submitted":
            if rid in open_by_rid:  # rid reused without a terminal: rotate
                _close_phase(open_by_rid[rid], t)
                open_by_rid.pop(rid)
            rec = start(rid, t)
            rec["args"] = {
                k: e[k] for k in ("prompt_len", "max_new_tokens",
                                  "priority", "deadline_s")
                if e.get(k) is not None}
        elif kind == "request_resumed":
            rec = ensure(rid, t)
            parents = [r for r in all_by_rid.get(e.get("orig_rid"), [])
                       if r is not rec]
            if parents:
                rec["resumed_from"] = parents[-1]["uid"]
                parents[-1]["resumed_to"] = rec["uid"]
        elif kind == "request_admitted":
            rec = ensure(rid, t)
            _close_phase(rec, t)
            _mark(rec, "admitted", t)
            _open_phase(rec, "prefill", t)
        elif kind == "engine_tick":
            t0 = e.get("t_start", t)
            spec = bool(e.get("spec"))
            for r in e.get("prefill_rids") or []:
                rec = open_by_rid.get(r)
                if rec is not None:
                    rec["ticks"].append({"name": "prefill_chunk",
                                         "tick": e.get("tick"),
                                         "t0": t0, "t1": t})
            for r in e.get("decode_rids") or []:
                rec = open_by_rid.get(r)
                if rec is None:
                    continue
                if rec["_phase"] == "prefill":
                    # the final prefill chunk and the first decode run in
                    # ONE tick, and admission may also have happened mid-
                    # tick — clamp the switch so phases never overlap
                    t_sw = max(t0, rec["_t_phase"] if rec["_t_phase"]
                               is not None else t0)
                    _close_phase(rec, t_sw)
                    _open_phase(rec, "decode", t_sw)
                rec["ticks"].append(
                    {"name": "verify_tick" if spec else "decode_tick",
                     "tick": e.get("tick"), "t0": t0, "t1": t})
        elif kind == "request_preempted":
            requeue(rid, t, "preempted")
        elif kind == "engine_recovered":
            rids = e.get("requeued_rids")
            if rids is None:
                rids = [rid] if (rid is not None
                                 and e.get("action") == "requeued") else []
            for r in rids:
                requeue(r, t, "fault_requeued")
        elif kind == "request_imported":
            # a migrated-in instance: opens straight in DECODE (no queue,
            # no prefill — the KV arrives by migrate_blocks).  orig_rid
            # names the SRC-engine instance; on a per-engine timeline
            # that rid lives in another engine's namespace, so the
            # cross-engine link is stitched at fleet scope
            # (assemble_fleet_request_timelines), not here.
            if rid in open_by_rid:  # rid reused without a terminal: rotate
                _close_phase(open_by_rid[rid], t)
                open_by_rid.pop(rid)
            rec = _new_record(rid, len(all_by_rid.get(rid, [])))
            records.append(rec)
            open_by_rid[rid] = rec
            all_by_rid.setdefault(rid, []).append(rec)
            rec["args"] = {
                k: e[k] for k in ("orig_rid", "n_shared", "n_live",
                                  "emitted_tokens")
                if e.get(k) is not None}
            _mark(rec, "imported", t)
            _open_phase(rec, "decode", t)
        elif kind == "request_exported":
            finish(rid, t, "exported")
        elif kind == "request_retired":
            finish(rid, t, "retired")
        elif kind == "request_cancelled":
            finish(rid, t, "cancelled")
        elif kind == "request_shed":
            finish(rid, t, "shed")
        elif kind == "request_expired":
            finish(rid, t, "expired")
        elif kind == "engine_drained":
            for r in list(open_by_rid):
                rec = open_by_rid[r]
                _close_phase(rec, t)
                _mark(rec, "drained", t)
                rec["terminal"] = "drained"
                open_by_rid.pop(r)
    return records


def lifecycle_phases(record: Dict[str, Any]) -> List[str]:
    """The ordered phase/mark walk of one request instance — e.g.
    ``['queued', 'admitted', 'prefill', 'decode', 'preempted', 'queued',
    'drained']`` — what "the lifecycle reconstructs from the trace"
    means, concretely."""
    return list(record["sequence"])


def validate_request_record(record: Dict[str, Any]) -> List[str]:
    """Structural checks on one assembled record: known vocabulary,
    spans time-ordered and non-negative, tick children inside the
    record's overall window.  Returns problem strings (empty = good)."""
    errs: List[str] = []
    uid = record.get("uid", "?")
    last_t = None
    for s in record["spans"]:
        if s["name"] not in REQUEST_PHASES:
            errs.append(f"{uid}: unknown phase {s['name']!r}")
        if s["t1"] < s["t0"]:
            errs.append(f"{uid}: span {s['name']} ends before it starts")
        if last_t is not None and s["t0"] < last_t - 1e-9:
            errs.append(f"{uid}: span {s['name']} overlaps its predecessor")
        last_t = s["t1"]
    term = record.get("terminal")
    if term is not None and term not in REQUEST_TERMINALS:
        errs.append(f"{uid}: unknown terminal {term!r}")
    if record["spans"]:
        lo = record["spans"][0]["t0"] - 1e-9
        hi = record["spans"][-1]["t1"] + 1e-9
        for c in record["ticks"]:
            if c["t0"] < lo or c["t1"] > hi:
                errs.append(f"{uid}: tick child {c['name']} outside spans")
                break
    return errs


# ------------------------------------------------------- Perfetto rendering


def _serving_t0(events: Sequence[Dict[str, Any]]) -> Optional[float]:
    ts = [e.get("t_start", e["t_mono"]) for e in events if "t_mono" in e]
    return min(ts) if ts else None


def request_trace_events(
    events: Sequence[Dict[str, Any]],
    process: int = 0,
    t0: Optional[float] = None,
) -> List[Dict[str, Any]]:
    """Chrome trace events for the per-request tracks: one async track
    per request instance (``cat="request"``, ``id=uid``) holding the
    outer request span, nested phase spans, per-tick children, and
    instant marks; flow arrows (``s``/``f``) connect a preemption to its
    re-admission and a drained instance to the instance that resumes
    it."""
    records = assemble_request_timelines(events)
    if t0 is None:
        t0 = _serving_t0(events)
    if t0 is None:
        return []

    def us(t: float) -> float:
        return round(max(t - t0, 0.0) * 1e6, 3)

    out: List[Dict[str, Any]] = []
    by_uid = {r["uid"]: r for r in records}

    def window(rec):
        ts = ([s["t0"] for s in rec["spans"]]
              + [s["t1"] for s in rec["spans"]]
              + [m["t"] for m in rec["marks"]])
        return (min(ts), max(ts)) if ts else None

    for rec in records:
        win = window(rec)
        if win is None:
            continue
        base = {"cat": "request", "id": rec["uid"], "pid": process, "tid": 0}
        args = dict(rec["args"])
        if rec["terminal"]:
            args["terminal"] = rec["terminal"]
        if rec["resumed_from"]:
            args["resumed_from"] = rec["resumed_from"]
        out.append({"ph": "b", "name": f"req{rec['rid']}",
                    "ts": us(win[0]), "args": args, **base})
        for s in rec["spans"]:
            out.append({"ph": "b", "name": s["name"], "ts": us(s["t0"]),
                        **base})
            out.append({"ph": "e", "name": s["name"], "ts": us(s["t1"]),
                        **base})
        for c in rec["ticks"]:
            out.append({"ph": "b", "name": c["name"], "ts": us(c["t0"]),
                        "args": {"tick": c.get("tick")}, **base})
            out.append({"ph": "e", "name": c["name"], "ts": us(c["t1"]),
                        **base})
        for m in rec["marks"]:
            out.append({"ph": "n", "name": m["name"], "ts": us(m["t"]),
                        **base})
        out.append({"ph": "e", "name": f"req{rec['rid']}",
                    "ts": us(win[1]), **base})
        # preempt/fault requeue -> next admission, as flow arrows
        readmits = [m["t"] for m in rec["marks"] if m["name"] == "admitted"]
        for i, m in enumerate(m for m in rec["marks"]
                              if m["name"] in ("preempted",
                                               "fault_requeued")):
            nxt = [t for t in readmits if t >= m["t"]]
            if not nxt:
                continue
            fid = f"requeue-{rec['uid']}-{i}"
            flow = {"cat": "flow", "name": "requeue", "id": fid,
                    "pid": process, "tid": 0}
            out.append({"ph": "s", "ts": us(m["t"]), **flow})
            out.append({"ph": "f", "bp": "e", "ts": us(nxt[0]), **flow})
        # drain -> resume, across engine instances
        if rec["resumed_from"] and rec["resumed_from"] in by_uid:
            parent = by_uid[rec["resumed_from"]]
            pwin = window(parent)
            if pwin is not None:
                fid = f"resume-{rec['uid']}"
                flow = {"cat": "flow", "name": "resume", "id": fid,
                        "pid": process, "tid": 0}
                out.append({"ph": "s", "ts": us(pwin[1]), **flow})
                out.append({"ph": "f", "bp": "e", "ts": us(win[0]), **flow})
    return out


def tick_trace_events(
    events: Sequence[Dict[str, Any]],
    process: int = 0,
    t0: Optional[float] = None,
) -> List[Dict[str, Any]]:
    """Chrome trace events for the tick accounting: per-phase lanes
    (``X`` spans laid back-to-back from each tick's start, the same
    reconstruction as obs/trace.py's step spans) plus counter tracks —
    queue depth, busy/prefill/decode slots, batch + pool utilization,
    and the live prefix-hit / spec-accept rates."""
    ticks = [e for e in events if e.get("kind") == "engine_tick"
             and "t_mono" in e]
    if not ticks:
        return []
    if t0 is None:
        t0 = _serving_t0(ticks)

    def us(t: float) -> float:
        return round(max(t - t0, 0.0) * 1e6, 3)

    out: List[Dict[str, Any]] = []
    for name, tid in TICK_TIDS.items():
        out.append({"ph": "M", "name": "thread_name", "pid": process,
                    "tid": tid, "args": {"name": f"tick/{name}"}})
        out.append({"ph": "M", "name": "thread_sort_index", "pid": process,
                    "tid": tid, "args": {"sort_index": tid}})
    for e in ticks:
        start = e.get("t_start", e["t_mono"])
        phases = e.get("phases") or {}
        cursor = start
        for name in TICK_PHASES:
            dur = float(phases.get(name, 0.0) or 0.0)
            if dur > 0:
                out.append({
                    "ph": "X", "name": name, "cat": "tick",
                    "pid": process, "tid": TICK_TIDS[name],
                    "ts": us(cursor), "dur": round(dur * 1e6, 3),
                    "args": {"tick": e.get("tick")},
                })
            cursor += dur
        ts = us(start)
        out.append({"ph": "C", "name": "serving_queue_depth",
                    "pid": process, "tid": 0, "ts": ts,
                    "args": {"queued": e.get("queue_depth", 0)}})
        out.append({"ph": "C", "name": "serving_slots", "pid": process,
                    "tid": 0, "ts": ts,
                    "args": {"busy": e.get("busy", 0),
                             "prefill": e.get("prefill_slots", 0),
                             "decode": e.get("decode_slots", 0)}})
        out.append({"ph": "C", "name": "serving_utilization",
                    "pid": process, "tid": 0, "ts": ts,
                    "args": {"batch": e.get("batch_util", 0.0),
                             "pool": e.get("pool_util", 0.0)}})
        out.append({"ph": "C", "name": "serving_rates", "pid": process,
                    "tid": 0, "ts": ts,
                    "args": {"prefix_hit": e.get("prefix_hit_rate", 0.0),
                             "spec_accept": e.get("spec_accept_rate",
                                                  0.0)}})
    return out


def serving_trace_events(
    events: Sequence[Dict[str, Any]],
    process: int = 0,
    t0: Optional[float] = None,
) -> List[Dict[str, Any]]:
    """Everything serving adds to a Chrome trace: request-flow tracks +
    tick lanes + counters.  ``obs.trace.chrome_trace_events`` calls this
    when serving events are on the timeline; pass the same ``t0`` the
    rest of the trace uses so both land on one axis.

    A FLEET timeline — engine events carrying the ``replica`` tag the
    Router stamps on each engine's log — dispatches to
    :func:`fleet_trace_events` instead: one Perfetto process per
    replica plus the router decision lane, so two engines' tick lanes
    never interleave on one track (``process`` is ignored; fleet pids
    are fixed by :func:`fleet_pid`)."""
    if t0 is None:
        t0 = _serving_t0([e for e in events if "t_mono" in e])
    if any(e.get("replica") is not None
           and e.get("kind") not in ROUTER_EVENT_KINDS for e in events):
        return fleet_trace_events(events, t0=t0)
    return (tick_trace_events(events, process=process, t0=t0)
            + request_trace_events(events, process=process, t0=t0))


# ------------------------------------------------------ fleet (multi-replica)

#: Event kinds emitted by the Router itself (the decision ledger + the
#: routing/migration records).  On a fleet timeline these stay on
#: the router lane; everything else carrying a ``replica`` tag is an
#: engine event and belongs to that replica's stream.
ROUTER_EVENT_KINDS = frozenset({
    "route_decision", "request_routed", "handoff_decision",
    "rebalance_decision", "request_migrated", "blocks_migrated",
    "replica_degraded", "replica_up", "replica_down",
    # the elastic fleet: autoscaler evaluations and the migration
    # wire's retry/fallback records — router-tier decisions, so they
    # ride the router lane of a fleet trace
    "scale_decision", "migration_retry", "migration_fallback",
})

#: Chrome pid of the router decision lane in a fleet trace.
ROUTER_PID = 99


def fleet_pid(replica: int) -> int:
    """Chrome pid of replica ``i``'s process in a fleet trace."""
    return 100 + int(replica)


def _split_fleet_events(
    events: Iterable[Dict[str, Any]],
) -> tuple:
    """Split one shared fleet timeline into the router's own events and
    per-replica engine streams (keyed by the ``replica`` tag
    ``Router.__init__`` stamps on each engine's log)."""
    router_ev: List[Dict[str, Any]] = []
    streams: Dict[Any, List[Dict[str, Any]]] = {}
    for e in events:
        if e.get("kind") is None or e.get("t_mono") is None:
            continue
        if e["kind"] in ROUTER_EVENT_KINDS:
            router_ev.append(e)
        elif e.get("replica") is not None:
            streams.setdefault(e["replica"], []).append(e)
    return router_ev, streams


def _record_t0(rec: Dict[str, Any]) -> Optional[float]:
    ts = [s["t0"] for s in rec["spans"]] + [m["t"] for m in rec["marks"]]
    if rec.get("_t_phase") is not None:
        ts.append(rec["_t_phase"])
    return min(ts) if ts else None


def _record_t1(rec: Dict[str, Any]) -> Optional[float]:
    ts = [s["t1"] for s in rec["spans"]] + [m["t"] for m in rec["marks"]]
    if rec.get("_t_phase") is not None:
        ts.append(rec["_t_phase"])
    return max(ts) if ts else None


def _find_instance(
    records: Sequence[Dict[str, Any]], engine_rid: Any, t: float,
) -> Optional[Dict[str, Any]]:
    """The request instance a router record at time ``t`` refers to: the
    LATEST instance of that engine rid that had already started (engine
    rids are reused, so 'rid 3 on replica 1' alone is ambiguous — 'rid 3
    on replica 1 as of t' is not: the engine-side event precedes the
    router record that cites it)."""
    best, best_t = None, None
    for r in records:
        if r["rid"] != engine_rid:
            continue
        rt = _record_t0(r)
        if rt is None or rt > t + 1e-6:
            continue
        if best is None or rt >= best_t:
            best, best_t = r, rt
    return best


def assemble_fleet_request_timelines(
    events: Iterable[Dict[str, Any]],
) -> Dict[str, Any]:
    """Stitch one shared fleet timeline into per-ROUTER-rid journeys.

    Splits the timeline on the ``replica`` tag, assembles each replica's
    engine events with :func:`assemble_request_timelines` (uids become
    ``"r<replica>/<rid>.<n>"``), then walks the router's own records to
    link each router rid's engine instances in placement order:
    ``request_routed`` names the first hop (replica + engine rid), each
    ``request_migrated`` names the next (``src_rid``/``dst_rid`` pin the
    exact instances), and ``blocks_migrated`` prices the KV legs.

    Returns ``{"journeys", "replicas", "router_events"}``; each journey
    is ``{rid, hops, decisions, migrations, sequence, outcome}`` where
    ``sequence`` is the request's full cross-replica phase walk
    (``@replica<i>`` markers between hops) — what "a migrated request
    reconstructs from the trace alone" means at fleet scope."""
    router_ev, streams = _split_fleet_events(events)
    replicas: Dict[Any, List[Dict[str, Any]]] = {}
    for rep in sorted(streams):
        recs = assemble_request_timelines(streams[rep])
        rename = {r["uid"]: f"r{rep}/{r['uid']}" for r in recs}
        for r in recs:
            r["replica"] = rep
            r["uid"] = rename[r["uid"]]
            if r["resumed_from"] in rename:
                r["resumed_from"] = rename[r["resumed_from"]]
            if r["resumed_to"] in rename:
                r["resumed_to"] = rename[r["resumed_to"]]
        replicas[rep] = recs

    journeys: Dict[Any, Dict[str, Any]] = {}
    order: List[Dict[str, Any]] = []

    def journey(rid: Any) -> Dict[str, Any]:
        j = journeys.get(rid)
        if j is None:
            j = {"rid": rid, "hops": [], "decisions": [],
                 "migrations": [], "sequence": [], "outcome": None}
            journeys[rid] = j
            order.append(j)
        return j

    def uid_of(rep: Any, erid: Any, t: float) -> Optional[str]:
        rec = _find_instance(replicas.get(rep, ()), erid, t)
        return rec["uid"] if rec is not None else None

    for e in router_ev:
        kind, t, rid = e["kind"], e["t_mono"], e.get("rid")
        if kind == "route_decision":
            j = journey(rid)
            j["decisions"].append(
                {"kind": kind, "t": t, "outcome": e.get("outcome"),
                 "chosen": e.get("chosen")})
            if e.get("outcome") == "shed":
                j["outcome"] = "shed"
        elif kind == "request_routed":
            journey(rid)["hops"].append(
                {"replica": e.get("replica"),
                 "engine_rid": e.get("replica_rid"),
                 "uid": uid_of(e.get("replica"), e.get("replica_rid"), t),
                 "via": "routed", "t": t})
        elif kind == "handoff_decision":
            journey(rid)["decisions"].append(
                {"kind": kind, "t": t, "outcome": e.get("outcome"),
                 "chosen": e.get("chosen")})
        elif kind == "request_migrated":
            journey(rid)["hops"].append(
                {"replica": e.get("dst_replica"),
                 "engine_rid": e.get("dst_rid"),
                 "uid": uid_of(e.get("dst_replica"), e.get("dst_rid"), t),
                 "via": e.get("mode", "migrated"), "t": t,
                 "src_replica": e.get("src_replica"),
                 "src_rid": e.get("src_rid")})
        elif kind == "blocks_migrated":
            journey(rid)["migrations"].append(
                {"t": t, "src_replica": e.get("src_replica"),
                 "dst_replica": e.get("dst_replica"),
                 "n_blocks": e.get("n_blocks"),
                 "n_shared": e.get("n_shared"),
                 "bytes": e.get("bytes"),
                 "compressed": e.get("compressed"), "dcn": e.get("dcn")})

    by_uid = {r["uid"]: r
              for recs in replicas.values() for r in recs}
    for j in order:
        seq: List[str] = []
        for h in j["hops"]:
            rec = by_uid.get(h["uid"])
            if rec is None:
                continue
            seq.append(f"@replica{h['replica']}")
            seq.extend(rec["sequence"])
        j["sequence"] = seq
        if j["outcome"] is None and j["hops"]:
            last = by_uid.get(j["hops"][-1]["uid"])
            if last is not None:
                j["outcome"] = last["terminal"]
    return {"journeys": order, "replicas": replicas,
            "router_events": router_ev}


def fleet_trace_events(
    events: Sequence[Dict[str, Any]],
    t0: Optional[float] = None,
) -> List[Dict[str, Any]]:
    """Chrome trace events for a multi-replica fleet timeline: one
    Perfetto process per replica (pid :func:`fleet_pid`, carrying that
    engine's tick lanes + request tracks exactly as the single-engine
    renderer draws them), a ``router`` process (pid :data:`ROUTER_PID`)
    with one instant per decision-ledger record, a ``route`` flow arrow
    from each placement decision to the engine instance it created, and
    a ``migrate`` flow arrow across processes for every cross-replica
    hop — carrying the priced wire bytes from ``blocks_migrated`` — so
    a migrated request reads as ONE connected track in
    https://ui.perfetto.dev."""
    router_ev, streams = _split_fleet_events(events)
    all_ev = router_ev + [e for s in streams.values() for e in s]
    if t0 is None:
        t0 = _serving_t0(all_ev)
    if t0 is None:
        return []

    def us(t: float) -> float:
        return round(max(t - t0, 0.0) * 1e6, 3)

    fleet = assemble_fleet_request_timelines(events)
    by_uid = {r["uid"]: r
              for recs in fleet["replicas"].values() for r in recs}
    out: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": ROUTER_PID, "tid": 0,
         "args": {"name": "router"}},
        {"ph": "M", "name": "process_sort_index", "pid": ROUTER_PID,
         "tid": 0, "args": {"sort_index": ROUTER_PID}},
        {"ph": "M", "name": "thread_name", "pid": ROUTER_PID, "tid": 0,
         "args": {"name": "decisions"}},
    ]
    for rep in sorted(fleet["replicas"]):
        pid = fleet_pid(rep)
        out.append({"ph": "M", "name": "process_name", "pid": pid,
                    "tid": 0, "args": {"name": f"replica{rep}"}})
        out.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                    "tid": 0, "args": {"sort_index": pid}})
        out.extend(tick_trace_events(streams[rep], process=pid, t0=t0))
        out.extend(request_trace_events(streams[rep], process=pid, t0=t0))
    # the router decision lane: every ledger record, with its evidence
    for e in router_ev:
        args = {k: v for k, v in e.items()
                if k not in ("type", "kind", "t_wall", "t_mono", "process")}
        out.append({"ph": "i", "name": e["kind"], "cat": "router",
                    "s": "t", "pid": ROUTER_PID, "tid": 0,
                    "ts": us(e["t_mono"]), "args": args})
    # flow arrows: router -> first placement, then hop -> hop
    for j in fleet["journeys"]:
        hops = [h for h in j["hops"] if h["uid"] in by_uid]
        if not hops:
            continue
        fid = f"route-{j['rid']}"
        out.append({"ph": "s", "cat": "flow", "name": "route", "id": fid,
                    "pid": ROUTER_PID, "tid": 0, "ts": us(hops[0]["t"])})
        out.append({"ph": "f", "bp": "e", "cat": "flow", "name": "route",
                    "id": fid, "pid": fleet_pid(hops[0]["replica"]),
                    "tid": 0, "ts": us(hops[0]["t"])})
        for k, h in enumerate(hops[1:]):
            src_rep = h.get("src_replica")
            src = _find_instance(
                fleet["replicas"].get(src_rep, ()), h.get("src_rid"),
                h["t"]) if src_rep is not None else None
            t_s = _record_t1(src) if src is not None else h["t"]
            t_s = h["t"] if t_s is None else min(t_s, h["t"])
            dst = by_uid[h["uid"]]
            t_f = _record_t0(dst)
            t_f = t_s if t_f is None else max(t_f, t_s)
            args = {"via": h["via"]}
            legs = [m for m in j["migrations"]
                    if m.get("src_replica") == src_rep
                    and m.get("dst_replica") == h["replica"]]
            if legs:
                leg = min(legs, key=lambda m: abs(m["t"] - h["t"]))
                args.update({kk: leg[kk] for kk in
                             ("n_blocks", "n_shared", "bytes",
                              "compressed", "dcn") if kk in leg})
            mid = f"mig-{j['rid']}-{k}"
            out.append({"ph": "s", "cat": "flow", "name": "migrate",
                        "id": mid, "pid": fleet_pid(src_rep)
                        if src_rep is not None else ROUTER_PID,
                        "tid": 0, "ts": us(t_s), "args": args})
            out.append({"ph": "f", "bp": "e", "cat": "flow",
                        "name": "migrate", "id": mid,
                        "pid": fleet_pid(h["replica"]), "tid": 0,
                        "ts": us(t_f)})
    return out


# ---------------------------------------------------------- operator table


def phase_table(events: Iterable[Dict[str, Any]]) -> str:
    """Text table of the per-tick phase breakdown over ``engine_tick``
    records — totals, mean ms, and share of accounted tick time per
    phase."""
    ticks = [e for e in events if e.get("kind") == "engine_tick"]
    if not ticks:
        return "tick phase breakdown: no engine_tick records"
    totals = {name: 0.0 for name in TICK_PHASES}
    counts = {name: 0 for name in TICK_PHASES}
    for e in ticks:
        for name in TICK_PHASES:
            dur = float((e.get("phases") or {}).get(name, 0.0) or 0.0)
            totals[name] += dur
            counts[name] += 1 if dur > 0 else 0
    accounted = sum(totals.values()) or 1.0
    lines = [f"tick phase breakdown ({len(ticks)} ticks, "
             f"{accounted * 1e3:.1f} ms accounted):",
             f"  {'phase':<9} {'total_ms':>10} {'mean_ms':>9} "
             f"{'ticks':>6} {'share':>7}"]
    for name in TICK_PHASES:
        n = counts[name]
        lines.append(
            f"  {name:<9} {totals[name] * 1e3:>10.2f} "
            f"{(totals[name] / n * 1e3 if n else 0.0):>9.3f} "
            f"{n:>6} {totals[name] / accounted:>6.1%}")
    return "\n".join(lines)
