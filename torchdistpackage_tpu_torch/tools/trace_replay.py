"""Trace replay: routing policy at 10^5-request scale, with no device —
the PyTorch counterpart of ``torchdistpackage_tpu/tools/trace_replay.py``.

It drives a synthetic, structured workload through the real
:class:`~..serving.router.Router` and real
:class:`~..serving.engine.ServingEngine` schedulers, with only the device
step swapped for the host-only :class:`~..serving.sim.StubDeviceStep`
(same admission, preemption, shedding and deadlines, same allocator and
audit, same migration lanes).  The workload has the reference's four
structures, from the same ``numpy.random.RandomState(seed)`` draws in the
same order: Zipf-skewed shared prefixes, diurnal (sinusoidal Poisson)
arrivals whose peak exceeds the fleet's capacity, multi-turn re-arrivals,
and mixed priorities and deadlines.  So the offered load and the
``config_hash`` of a run equal the reference's at the same arguments;
decisions that read the host clock (deadline shedding and queue expiry,
the TTFT estimates, the autoscaler's windows) may differ.

Evidence out: the fleet report (``Router.summary()``) validated by
``obs.report._validate_router``; the decision ledger's attribution
(every placement reconciles with a ``route_decision`` /
``handoff_decision`` / ``rebalance_decision`` record, every fleet-size
change with a non-hold ``scale_decision``: ``attribution.complete``);
``--ledger`` writes the router-scope records as JSONL.  ``--spares``,
``--autoscale``, ``--chaos`` (every ``TRANSPORT_FAULT_KINDS`` member
seeded into the migration wire), ``--ab`` (both arms at one config hash)
and ``--long-docs`` (the mixed-traffic starvation probe) are the
reference's.  ``--report`` writes the FLEETREPORT (``<path>`` JSON and
a sibling ``.md``, through ``obs.report.write_runreport``) and
``--trace`` the fleet Perfetto trace of the retained event window
(``serving.tracing.fleet_trace_events``).  The FLEETREPORT carries every
key ``obs.report.validate_runreport`` requires (the reference's carries
only the router section and the run's identity), so it validates
whole: ``backend`` ``"sim"``, no steps timed, ``memory`` and
``numerics`` empty sections, ``comm`` ``{}``.

Usage::

    python -m torchdistpackage_tpu_torch.tools.trace_replay \
        --n-requests 100000 --replicas 4 --spares 2 \
        --autoscale --chaos --ledger /tmp/ledger.jsonl \
        --report /tmp/FLEETREPORT.json --trace /tmp/fleet_trace.json

Prints one ``{"metric": "trace-replay", ...}`` JSON line, then the
report's one-line summary.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

REPLAY_SCHEMA = "tdp-trace-replay/v1"


class LedgerCounter:
    """EventLog sink that tallies the decision ledger as it streams —
    the attribution check at 10^5 scale without holding 10^6 event
    dicts in memory.  Optionally tees router-scope records (the ledger
    proper, not per-tick engine telemetry) to an inner JSONL sink."""

    def __init__(self, sink: Any = None) -> None:
        from ..serving.tracing import ROUTER_EVENT_KINDS

        self._router_kinds = ROUTER_EVENT_KINDS
        self._sink = sink
        self.kinds: Dict[str, int] = {}
        self.route_outcomes: Dict[str, int] = {}
        self.handoff_outcomes: Dict[str, int] = {}
        self.rebalance_moved = 0
        self.scale_actions = 0
        self.scale_holds = 0

    def write(self, rec: Dict[str, Any]) -> None:
        kind = rec.get("kind")
        self.kinds[kind] = self.kinds.get(kind, 0) + 1
        if kind == "route_decision":
            o = rec.get("outcome")
            self.route_outcomes[o] = self.route_outcomes.get(o, 0) + 1
        elif kind == "handoff_decision":
            o = rec.get("outcome")
            self.handoff_outcomes[o] = self.handoff_outcomes.get(o, 0) + 1
        elif kind == "rebalance_decision":
            self.rebalance_moved += int(rec.get("moved", 0))
        elif kind == "scale_decision":
            if rec.get("action") in ("scale_up", "scale_down"):
                self.scale_actions += 1
            else:
                self.scale_holds += 1
        if self._sink is not None and kind in self._router_kinds:
            self._sink.write(rec)


class SyntheticWorkload:
    """Request generator with the four structures described in the
    module docstring.  ``next_request()`` yields Request kwargs;
    ``register(rid, ...)``/``complete(rid, tokens)`` feed finished
    conversations back in as multi-turn re-arrivals."""

    def __init__(
        self,
        rng: np.random.RandomState,
        vocab: int,
        block_size: int,
        max_ctx: int,
        n_groups: int = 32,
        zipf_a: float = 1.2,
        multiturn_p: float = 0.3,
        max_turns: int = 3,
    ) -> None:
        self.rng = rng
        self.vocab = vocab
        self.max_ctx = max_ctx
        self.multiturn_p = multiturn_p
        self.max_turns = max_turns
        w = (1.0 + np.arange(n_groups)) ** -zipf_a
        self.group_p = w / w.sum()
        self.prefixes = [
            rng.randint(0, vocab,
                        size=int(rng.choice([2, 3, 4])) * block_size
                        ).tolist()
            for _ in range(n_groups)]
        self.pool: List[tuple] = []    # (tokens, turn) finished convos
        self._turn: Dict[int, int] = {}  # router rid -> turn number
        self.stats = {"fresh": 0, "multiturn": 0, "by_prio": {}}

    def _tail(self) -> List[int]:
        return self.rng.randint(
            0, self.vocab, size=int(self.rng.randint(3, 13))).tolist()

    def next_request(self) -> Dict[str, Any]:
        max_new = int(self.rng.randint(4, 13))
        tokens = None
        turn = 0
        if self.pool and self.rng.random_sample() < self.multiturn_p:
            prev, prev_turn = self.pool.pop(
                int(self.rng.randint(len(self.pool))))
            cont = prev + self._tail()
            if len(cont) + max_new <= self.max_ctx:
                tokens, turn = cont, prev_turn + 1
        if tokens is None:
            g = int(self.rng.choice(len(self.group_p), p=self.group_p))
            tokens = self.prefixes[g] + self._tail()
        self.stats["multiturn" if turn else "fresh"] += 1
        prio = int(self.rng.choice([0, 0, 0, 0, 0, 0, 1, 1, 1, 2]))
        self.stats["by_prio"][prio] = self.stats["by_prio"].get(prio, 0) + 1
        # deadline mix: most unconstrained, a band of generous TTFT
        # budgets, and a tight slice that sheds when peak queues form
        u = self.rng.random_sample()
        deadline = None if u < 0.6 else (0.25 if u < 0.9 else 0.02)
        return {"tokens": tokens, "max_new_tokens": max_new,
                "priority": prio, "deadline_s": deadline,
                "temperature": 0.0 if self.rng.random_sample() < 0.7
                else 0.8, "seed": int(self.rng.randint(1 << 31)),
                "_turn": turn}

    def register(self, rid: int, turn: int) -> None:
        if turn < self.max_turns:
            self._turn[rid] = turn

    def complete(self, rid: int, tokens: List[int]) -> None:
        turn = self._turn.pop(rid, None)
        if turn is None:
            return
        self.pool.append((tokens, turn))
        if len(self.pool) > 4096:  # bounded re-arrival candidate pool
            self.pool.pop(0)


def run_replay(
    n_requests: int = 20_000,
    n_replicas: int = 4,
    num_slots: int = 16,
    block_size: int = 16,
    chunk: int = 16,
    vocab: int = 512,
    seed: int = 0,
    disaggregate: bool = True,
    rate_util: float = 0.9,
    diurnal_amp: float = 0.6,
    diurnal_period: int = 2048,
    rebalance_every: int = 8,
    rebalance_watermark: int = 4,
    history_max: int = 65_536,
    groups: int = 32,
    zipf_a: float = 1.2,
    multiturn_p: float = 0.3,
    long_docs: int = 0,
    long_doc_len: int = 512,
    ledger_path: Optional[str] = None,
    max_ticks: Optional[int] = None,
    autoscale: bool = False,
    n_spares: int = 0,
    autoscale_kw: Optional[Dict[str, Any]] = None,
    chaos: bool = False,
    chaos_faults: int = 12,
    curve_every: int = 512,
) -> Dict[str, Any]:
    """Drive ``n_requests`` through a stubbed fleet; return the replay
    report (validated FLEETREPORT + attribution + sim/wall costs).
    Keeps the last ``history_max`` events in memory (returned under
    ``'events'``); the full ledger streams through :class:`LedgerCounter`
    (and to ``ledger_path`` as JSONL when given).

    ``n_spares`` extra replicas join the fleet PARKED
    (``provisioned_spare``); arrival rate comes from the core replicas
    only, so the workload — and the returned ``config_hash`` — is
    byte-identical whether ``autoscale`` is on or off (the A/B
    contract).  ``chaos=True`` seeds ``chaos_faults`` transport faults
    (cycling every ``TRANSPORT_FAULT_KINDS`` member, death included)
    across the migration-send sequence space.

    ``long_docs > 0`` carves that many submissions out of
    ``n_requests`` and replaces them with ``long_doc_len``-token
    documents spread evenly over the arrival schedule — the
    mixed-traffic starvation probe: the returned ``mixed_traffic``
    block carries per-class latency percentiles in TICKS, so "one long
    document does not starve the short requests' TTFT" is an
    assertable, device-free claim."""
    import hashlib

    from ..models.gpt import GPTConfig
    from ..obs.events import (
        EventLog,
        default_event_log,
        set_default_event_log,
    )
    from ..obs.exporters import JsonlSink
    from ..obs.report import _validate_router
    from ..serving.autoscale import Autoscaler
    from ..serving.engine import Request, ServingEngine
    from ..serving.router import Router
    from ..serving.sim import StubDeviceStep
    from ..serving.transport import ChunkedWireTransport

    max_ctx = 8 * block_size + 64
    if long_docs:
        max_ctx = max(max_ctx, long_doc_len + 64)
    cfg = GPTConfig(vocab_size=vocab, dim=64, nheads=4, nlayers=2,
                    max_seq=max_ctx)
    rng = np.random.RandomState(seed)
    wl = SyntheticWorkload(rng, vocab, block_size, max_ctx,
                           n_groups=groups, zipf_a=zipf_a,
                           multiturn_p=multiturn_p)

    ledger_sink = JsonlSink(ledger_path) if ledger_path is not None else None
    counter = LedgerCounter(sink=ledger_sink)
    log = EventLog(sink=counter, history_max=history_max)
    prev_log = default_event_log()
    set_default_event_log(log)

    # everything that shapes the WORKLOAD and fleet hardware — but NOT
    # the autoscale switch — goes into the hash, so an A/B pair proves
    # "same offered load, same fleet, only the controller differs"
    config_hash = hashlib.sha256(json.dumps({
        "n_requests": n_requests, "n_replicas": n_replicas,
        "n_spares": n_spares, "num_slots": num_slots,
        "block_size": block_size, "chunk": chunk, "vocab": vocab,
        "seed": seed, "disaggregate": disaggregate,
        "rate_util": rate_util, "diurnal_amp": diurnal_amp,
        "diurnal_period": diurnal_period,
        "rebalance_every": rebalance_every,
        "rebalance_watermark": rebalance_watermark, "groups": groups,
        "zipf_a": zipf_a, "multiturn_p": multiturn_p,
        "long_docs": long_docs, "long_doc_len": long_doc_len,
        "chaos": chaos, "chaos_faults": chaos_faults,
    }, sort_keys=True).encode()).hexdigest()[:16]

    try:
        n_total = n_replicas + max(0, n_spares)
        stubs = [StubDeviceStep() for _ in range(n_total)]
        engines = [
            ServingEngine(None, cfg, num_slots=num_slots,
                          block_size=block_size, chunk=chunk,
                          max_ctx=max_ctx, prefix_cache=True,
                          max_queue=8 * num_slots, device_step=st)
            for st in stubs]
        roles = (["prefill"] + ["decode"] * (n_replicas - 1)
                 if disaggregate and n_replicas > 1
                 else ["both"] * n_replicas)
        roles += ["both"] * max(0, n_spares)

        monkey = None
        transport = None
        if chaos:
            from ..resilience.chaos import (
                TRANSPORT_FAULT_KINDS,
                ChaosMonkey,
                Fault,
            )

            # seed faults across the migration-send sequence space:
            # cycle every kind (recoverable singles plus one repeating
            # drop and the death) at rng-chosen, collision-free seqs
            frng = np.random.RandomState(seed + 1)
            horizon = max(16, n_requests // 4)
            seqs = sorted(frng.choice(
                np.arange(1, horizon), size=min(chaos_faults, horizon - 1),
                replace=False).tolist())
            plan = []
            for k, s in enumerate(seqs):
                kind = TRANSPORT_FAULT_KINDS[k % len(TRANSPORT_FAULT_KINDS)]
                plan.append(Fault(
                    kind, step=int(s),
                    duration_s=9.0 if kind == "transport_stall" else 0.0,
                    repeat=(kind == "chunk_drop" and k % 8 == 4)))
            monkey = ChaosMonkey(faults=plan, seed=seed)
            transport = ChunkedWireTransport(chaos=monkey)

        router = Router(engines, roles=roles,
                        rebalance_every=rebalance_every,
                        rebalance_watermark=rebalance_watermark,
                        transport=transport)
        for i in range(n_replicas, n_total):
            router.set_alive(i, False, reason="provisioned_spare")
        asc = Autoscaler(router, **(autoscale_kw or {})) if autoscale \
            else None

        # arrival pacing: steady-state decode width is the fleet's
        # non-prefill slots, each retiring ~1 token/tick, so capacity
        # is ~decode_slots/avg_new requests per tick; the diurnal peak
        # runs (1 + amp) * rate_util over that on purpose.  Spares are
        # EXCLUDED — offered load must not change when they exist
        decode_slots = num_slots * sum(
            1 for r in roles[:n_replicas] if r != "prefill")
        avg_new = 8.0
        base_rate = rate_util * decode_slots / avg_new
        if max_ticks is None:
            max_ticks = int(4 * n_requests * avg_new
                            / max(decode_slots, 1)) + 10_000

        def _slo_totals():
            met = demand = good = 0
            for e in engines:
                for row in e._slo_by_prio.values():
                    met += row["met"]
                    demand += (row["completed"] + row["shed"]
                               + row["expired"])
                    good += row["goodput_tokens"]
            return met, demand, good

        curves: Dict[str, List[Any]] = {
            "tick": [], "attainment": [], "goodput_tokens": [],
            "n_alive": [], "queued": []}
        prev_slo = _slo_totals()

        def _sample(t: int) -> None:
            nonlocal prev_slo
            met, demand, good = _slo_totals()
            d_met = met - prev_slo[0]
            d_dem = demand - prev_slo[1]
            d_good = good - prev_slo[2]
            prev_slo = (met, demand, good)
            curves["tick"].append(t)
            curves["attainment"].append(
                round(d_met / d_dem, 4) if d_dem else None)
            curves["goodput_tokens"].append(d_good)
            curves["n_alive"].append(sum(router.alive))
            curves["queued"].append(
                sum(len(e.queue) for e in engines))

        # mixed traffic: the i-th long document replaces the submission
        # at an evenly spaced mark, so offered load (and the hash'd
        # workload shape) stays n_requests total
        long_marks = {
            int(round((i + 1) * n_requests / (long_docs + 1)))
            for i in range(long_docs)} if long_docs else set()
        long_rids: set = set()
        sub_tick: Dict[int, int] = {}
        waits: Dict[str, List[int]] = {"short": [], "long": []}

        submitted = 0
        tick = 0
        t0 = time.perf_counter()
        while submitted < n_requests or router.has_work():
            if submitted < n_requests:
                lam = base_rate * (1.0 + diurnal_amp * math.sin(
                    2.0 * math.pi * tick / diurnal_period))
                k = min(int(rng.poisson(max(lam, 0.0))),
                        n_requests - submitted)
                for _ in range(k):
                    if submitted in long_marks:
                        rid = router.submit(Request(
                            rng.randint(0, vocab,
                                        size=long_doc_len - 16).tolist(),
                            16, temperature=0.0,
                            seed=int(rng.randint(1 << 31))))
                        if rid not in router.rejected:
                            long_rids.add(rid)
                            sub_tick[rid] = tick
                    else:
                        kw = wl.next_request()
                        turn = kw.pop("_turn")
                        rid = router.submit(Request(**kw))
                        if rid not in router.rejected:
                            wl.register(rid, turn)
                            sub_tick[rid] = tick
                    submitted += 1
            router.step()
            if router.finished:
                # feed completions back as multi-turn re-arrivals and
                # keep the result dict from growing 10^5 entries deep
                for rid, rec in router.finished.items():
                    wl.complete(rid, [int(t) for t in rec["tokens"]])
                    t_sub = sub_tick.pop(rid, None)
                    if t_sub is not None:
                        waits["long" if rid in long_rids
                              else "short"].append(tick - t_sub)
                router.finished.clear()
            tick += 1
            if curve_every and tick % curve_every == 0:
                _sample(tick)
            if tick >= max_ticks:
                break
        _sample(tick)
        wall = time.perf_counter() - t0

        summary = router.summary()
        errs = _validate_router(summary)
        st = router.stats
        attribution = {
            "submitted": submitted,
            "ledger_route_decisions": counter.kinds.get(
                "route_decision", 0),
            "placements": st["routed"],
            "ledger_placements": counter.route_outcomes.get("routed", 0),
            "handoffs": st["handoffs"],
            "ledger_handoffs": (
                counter.handoff_outcomes.get("handoff", 0)
                + counter.handoff_outcomes.get("bounced", 0)),
            "rebalanced": st["rebalanced_requests"],
            "ledger_rebalance_moved": counter.rebalance_moved,
            "scale_actions": asc.actions if asc is not None else 0,
            "ledger_scale_actions": counter.scale_actions,
        }
        attribution["complete"] = (
            attribution["submitted"]
            == attribution["ledger_route_decisions"]
            and attribution["placements"]
            == attribution["ledger_placements"]
            and attribution["handoffs"] == attribution["ledger_handoffs"]
            and attribution["rebalanced"]
            == attribution["ledger_rebalance_moved"]
            and attribution["scale_actions"]
            == attribution["ledger_scale_actions"])
        sim = {
            "sim_device_s": round(sum(s.sim_s for s in stubs), 6),
            "calls": {k: sum(s.calls[k] for s in stubs)
                      for k in stubs[0].calls},
        }
        def _wait_pcts(xs: List[int]) -> Dict[str, Any]:
            if not xs:
                return {"n": 0, "p50_wait_ticks": None,
                        "p99_wait_ticks": None}
            a = np.asarray(xs)
            return {"n": len(xs),
                    "p50_wait_ticks": int(np.percentile(a, 50)),
                    "p99_wait_ticks": int(np.percentile(a, 99))}

        return {
            "schema": REPLAY_SCHEMA,
            "n_requests": n_requests,
            "submitted": submitted,
            "ticks": tick,
            "wall_s": round(wall, 3),
            "config_hash": config_hash,
            "curves": curves,
            "autoscale": asc.summary() if asc is not None else None,
            "chaos": ({"declared": len(monkey.faults),
                       "fired": monkey.fired_count}
                      if monkey is not None else None),
            "workload": dict(wl.stats,
                             multiturn_pool=len(wl.pool),
                             groups=groups, zipf_a=zipf_a,
                             diurnal_amp=diurnal_amp,
                             diurnal_period=diurnal_period,
                             base_rate_req_per_tick=round(base_rate, 3)),
            "summary": summary,
            "mixed_traffic": ({
                "long_docs": long_docs,
                "long_doc_len": long_doc_len,
                "short": _wait_pcts(waits["short"]),
                "long": _wait_pcts(waits["long"]),
            } if long_docs else None),
            "validation_errors": errs,
            "attribution": attribution,
            "sim": sim,
            "events": log,   # popped by main() before serialization
        }
    finally:
        set_default_event_log(prev_log)
        if ledger_sink is not None:
            ledger_sink.close()


def fleet_report(out: Dict[str, Any], seed: int) -> Dict[str, Any]:
    """The FLEETREPORT of a :func:`run_replay` result: the router section
    and the run's counters (JAX ``main`` :580), with every other key
    ``obs.report.validate_runreport`` requires, empty — no step was
    timed and no device ran."""
    from ..obs.aggregate import cross_host_step_stats, step_time_stats
    from ..obs.mem_ledger import mem_report
    from ..obs.numerics import numerics_report
    from ..obs.report import RUNREPORT_SCHEMA

    memory = mem_report()
    memory.update(peak_bytes_in_use=0, reported=False)
    return {
        "schema": RUNREPORT_SCHEMA,
        "run": f"trace-replay-seed{seed}",
        "steps": out["ticks"],
        "backend": "sim",
        "chip": "none",
        "n_devices": 0,
        "n_processes": 1,
        "wall_time_s": out["wall_s"],
        "step_time_s": step_time_stats([]),
        "spans_mean_s": {},
        "throughput": {},
        "mfu": {},
        "memory": memory,
        "numerics": numerics_report(),
        "compile": {"count": 0, "time_s": 0.0, "recompiles": 0},
        "hosts": cross_host_step_stats([]),
        "comm": {},
        "router": out["summary"],
        "counters": {"workload": out["workload"],
                     "attribution": out["attribution"],
                     "mixed_traffic": out["mixed_traffic"],
                     "sim": out["sim"],
                     "curves": out["curves"],
                     "autoscale": out["autoscale"],
                     "chaos": out["chaos"],
                     "replay": {"schema": out["schema"],
                                "n_requests": out["n_requests"],
                                "submitted": out["submitted"],
                                "config_hash": out["config_hash"],
                                "validation_errors":
                                    out["validation_errors"]}},
        "events": [],
    }


def main(argv: Optional[List[str]] = None) -> int:
    from ..obs.report import render_summary_line, write_runreport

    ap = argparse.ArgumentParser(
        description="replay a synthetic request trace through the real "
                    "Router on DeviceStep-stubbed engines (no devices)")
    ap.add_argument("--n-requests", type=int, default=20_000)
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--num-slots", type=int, default=16)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--flat", action="store_true",
                    help="homogeneous 'both' replicas (default is 1 "
                         "prefill + N-1 decode, which exercises KV "
                         "handoffs)")
    ap.add_argument("--rate-util", type=float, default=0.9,
                    help="mean arrival rate as a fraction of fleet "
                         "decode capacity")
    ap.add_argument("--diurnal-amp", type=float, default=0.6)
    ap.add_argument("--diurnal-period", type=int, default=2048)
    ap.add_argument("--rebalance-every", type=int, default=8)
    ap.add_argument("--rebalance-watermark", type=int, default=4)
    ap.add_argument("--groups", type=int, default=32)
    ap.add_argument("--zipf-a", type=float, default=1.2)
    ap.add_argument("--multiturn-p", type=float, default=0.3)
    ap.add_argument("--long-docs", type=int, default=0,
                    help="long documents carved out of N_REQUESTS and "
                         "spread evenly over the schedule (the "
                         "mixed-traffic starvation probe)")
    ap.add_argument("--long-doc-len", type=int, default=512,
                    help="--long-docs document length in tokens")
    ap.add_argument("--history", type=int, default=65_536,
                    help="events kept in memory for --trace rendering")
    ap.add_argument("--autoscale", action="store_true",
                    help="attach the goodput-driven Autoscaler")
    ap.add_argument("--spares", type=int, default=0,
                    help="extra replicas provisioned PARKED (revived "
                         "only by the autoscaler)")
    ap.add_argument("--chaos", action="store_true",
                    help="seed transport faults (drop/corrupt/stall/"
                         "death) into the migration wire")
    ap.add_argument("--chaos-faults", type=int, default=12)
    ap.add_argument("--curve-every", type=int, default=512,
                    help="ticks between attainment/goodput/replica-"
                         "count curve samples")
    ap.add_argument("--ab", action="store_true",
                    help="run the autoscaling-DISABLED arm too (same "
                         "config hash) and report the attainment delta")
    ap.add_argument("--eval-every", type=int, default=64,
                    help="autoscaler control period (fleet ticks)")
    ap.add_argument("--cooldown", type=int, default=192)
    ap.add_argument("--queue-high", type=float, default=4.0)
    ap.add_argument("--ledger", default=None,
                    help="write router decision records as JSONL")
    ap.add_argument("--report", default=None,
                    help="write the FLEETREPORT as <path> JSON + a "
                         "sibling .md (the RUNREPORT convention)")
    ap.add_argument("--trace", default=None,
                    help="write a fleet Perfetto trace of the retained "
                         "event window")
    args = ap.parse_args(argv)

    for path in (args.ledger, args.trace):
        if path is not None and os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)

    common = dict(
        n_requests=args.n_requests, n_replicas=args.replicas,
        num_slots=args.num_slots, block_size=args.block_size,
        chunk=args.chunk, seed=args.seed, disaggregate=not args.flat,
        rate_util=args.rate_util, diurnal_amp=args.diurnal_amp,
        diurnal_period=args.diurnal_period,
        rebalance_every=args.rebalance_every,
        rebalance_watermark=args.rebalance_watermark,
        history_max=args.history, groups=args.groups,
        zipf_a=args.zipf_a, multiturn_p=args.multiturn_p,
        long_docs=args.long_docs, long_doc_len=args.long_doc_len,
        n_spares=args.spares, chaos=args.chaos,
        chaos_faults=args.chaos_faults, curve_every=args.curve_every,
        autoscale_kw={"eval_every": args.eval_every,
                      "cooldown": args.cooldown,
                      "queue_high": args.queue_high})

    baseline = None
    if args.ab:
        baseline = run_replay(autoscale=False, **common)
        baseline.pop("events")

    out = run_replay(autoscale=args.autoscale or args.ab,
                     ledger_path=args.ledger, **common)
    log = out.pop("events")

    if args.trace is not None:
        from ..serving.tracing import fleet_trace_events

        with open(args.trace, "w") as f:
            json.dump({"traceEvents": fleet_trace_events(log.as_list())},
                      f)

    report = fleet_report(out, args.seed)
    if args.report is not None:
        write_runreport(report, args.report)

    fleet = out["summary"]["fleet"]
    asc = out["autoscale"] or {}
    print(json.dumps({
        "metric": "trace-replay",
        "value": round(fleet["goodput_tok_s"], 1),
        "n_requests": out["n_requests"],
        "ticks": out["ticks"],
        "wall_s": out["wall_s"],
        "sim_device_s": out["sim"]["sim_device_s"],
        "fleet_goodput_tok_s": round(fleet["goodput_tok_s"], 1),
        "fleet_slo_attainment": fleet["attainment"],
        "migration_count": fleet["migrations"]["handoffs"],
        "migration_bytes": fleet["migrations"]["bytes"],
        "fleet_verdict": fleet["verdict"],
        "balance_verdict": fleet["balance"]["verdict"],
        "autoscale_actions": asc.get("actions", 0),
        "migration_retry_count": fleet["migrations"].get("retries", 0),
        "transport_fallback_count": fleet["migrations"].get(
            "fallbacks", 0),
        "config_hash": out["config_hash"],
        "report_valid": not out["validation_errors"],
        "attribution_complete": out["attribution"]["complete"],
        **({"short_p99_wait_ticks":
                out["mixed_traffic"]["short"]["p99_wait_ticks"],
            "long_p50_wait_ticks":
                out["mixed_traffic"]["long"]["p50_wait_ticks"]}
           if out["mixed_traffic"] else {}),
    }), flush=True)
    if baseline is not None:
        att_on = fleet["attainment"]
        att_off = baseline["summary"]["fleet"]["attainment"]
        print(json.dumps({
            "metric": "trace-replay-ab",
            "config_hash": out["config_hash"],
            "config_hash_match": (out["config_hash"]
                                  == baseline["config_hash"]),
            "attainment_autoscaled": att_on,
            "attainment_static": att_off,
            "attainment_delta": round(att_on - att_off, 4),
            "baseline_valid": not baseline["validation_errors"],
            "win": att_on > att_off,
        }), flush=True)
    print(render_summary_line(report), flush=True)
    if out["validation_errors"]:
        print(json.dumps(
            {"validation_errors": out["validation_errors"]}), flush=True)
        return 1
    return 0 if out["attribution"]["complete"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
