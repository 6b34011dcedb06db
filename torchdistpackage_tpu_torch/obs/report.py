"""End-of-run report — the port's ``torchdistpackage_tpu/obs/report.py``:
the ``RUNREPORT.json`` schema and its validation, the one-line summary
and the markdown rendering, and the writer.

``RUNREPORT.json`` is the machine-readable artifact a run leaves behind
(a FLEETREPORT is one whose ``router`` section a Router filled); the
sibling ``RUNREPORT.md`` is the human summary.  :func:`validate_runreport`
returns a list of problems (empty = valid) rather than raising.  Where
the port's serving summary differs from the reference's, so does the
check: a ``moe.dispatch`` is one of the port's (``'gather'``, ``'cuda'``,
``'sorted'``), and a ``long_context`` block names no mesh axis (the
engine takes ``cp_group``).  A port report has no compiled program
behind it: ``comm`` is built from the collectives recorded around the
first call of the wrapped step (``obs.comm_ledger``; ``{}``, valid, when
the ledger is off or no step was wrapped), ``memory.programs`` and
``numerics.dtype_ledgers`` are ``[]``, and ``mfu`` carries the hand
formula only.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from .mem_ledger import MEM_VERDICTS

RUNREPORT_SCHEMA = "tdp-runreport/v1"

# the self-healing loop's end states (resilience/loop.py summary verdicts)
RESILIENCE_VERDICTS = ("clean", "recovered", "preempted", "aborted")

# the serving engine's end states (serving/engine.py serving_summary):
# overloaded = demand was refused (shed / expired requests), degraded =
# the engine preempted or healed faults to keep serving, healthy = neither
SERVING_VERDICTS = ("healthy", "degraded", "overloaded")

# the fleet balance verdicts (serving/router.py owns the policy and the
# skew threshold; the vocabulary is mirrored here so obs — a leaf
# subsystem — validates router sections without importing serving)
FLEET_BALANCE_VERDICTS = ("balanced", "skewed", "degraded")

# the autoscaler's end states (serving/autoscale.py owns the control
# policy; vocabulary mirrored for the same leaf-subsystem reason):
# static = never acted, elastic = acted within the thrash budget,
# thrashing = more scale flips than the budget allows
AUTOSCALE_VERDICTS = ("static", "elastic", "thrashing")

# the auto-sharding planner's end states (the reference's dist/autoplan.py;
# the section Telemetry.record_autoplan attaches): ``ok`` = a plan was
# chosen, ``all_oom`` = every candidate was pruned by the memory budget
AUTOPLAN_SCHEMA = "tdp-autoplan/v1"
PLAN_VERDICTS = ("ok", "all_oom")

# the A/B run-parity verdicts (the reference's obs/parity.py; the
# numerics.parity sub-section Telemetry.record_parity attaches)
PARITY_VERDICTS = ("exact", "bounded", "diverged", "unknown")

# top-level key -> required python type (None = any); everything Telemetry
# emits, and everything validate checks.
_REQUIRED: Dict[str, type] = {
    "schema": str,
    "run": str,
    "backend": str,
    "n_devices": int,
    "n_processes": int,
    "steps": int,
    "step_time_s": dict,
    "spans_mean_s": dict,
    "throughput": dict,
    "mfu": dict,
    "memory": dict,
    "numerics": dict,
    "compile": dict,
    "hosts": dict,
    "comm": dict,
    "counters": dict,
    "events": list,
}


def default_report_path() -> Optional[str]:
    """The ``TDP_RUNREPORT`` env var — how the CI example runner points
    each subprocess at its own report file.  Empty/unset -> None."""
    return os.environ.get("TDP_RUNREPORT") or None


def validate_runreport(report: Any) -> List[str]:
    """Structural validation; returns problem strings (empty list = valid)."""
    errs: List[str] = []
    if not isinstance(report, dict):
        return [f"report is {type(report).__name__}, expected dict"]
    for key, typ in _REQUIRED.items():
        if key not in report:
            errs.append(f"missing key {key!r}")
        elif not isinstance(report[key], typ):
            errs.append(
                f"{key!r} is {type(report[key]).__name__}, expected {typ.__name__}")
    if errs:
        return errs
    if report["schema"] != RUNREPORT_SCHEMA:
        errs.append(
            f"schema {report['schema']!r} != {RUNREPORT_SCHEMA!r}")
    if report["steps"] < 0:
        errs.append(f"steps {report['steps']} < 0")
    st = report["step_time_s"]
    if st.get("n", 0) > 0:
        for k in ("mean", "min", "max", "p50"):
            if not isinstance(st.get(k), (int, float)):
                errs.append(f"step_time_s.{k} missing/non-numeric")
    for i, ev in enumerate(report["events"]):
        if not isinstance(ev, dict) or "kind" not in ev or "t_mono" not in ev:
            errs.append(f"events[{i}] lacks kind/t_mono")
            break
    hosts = report["hosts"]
    if "n_hosts" not in hosts or "per_host" not in hosts:
        errs.append("hosts lacks n_hosts/per_host")
    comm = report["comm"]
    if comm:  # empty dict = no compiled step was observed; that's valid
        if "ledger" not in comm or "verdict" not in comm:
            errs.append("comm section lacks ledger/verdict")
        elif comm["verdict"] not in ("comm-bound", "compute-bound", "unknown"):
            errs.append(f"comm verdict {comm['verdict']!r} invalid")
    errs.extend(_validate_memory(report["memory"]))
    errs.extend(_validate_numerics(report["numerics"]))
    res = report.get("resilience")
    if res is not None:  # optional: present when a ResilientLoop drove the run
        if not isinstance(res, dict):
            errs.append(f"resilience is {type(res).__name__}, expected dict")
        elif res.get("verdict") not in RESILIENCE_VERDICTS:
            errs.append(f"resilience verdict {res.get('verdict')!r} invalid")
        elif not isinstance(res.get("rollbacks"), int) or res["rollbacks"] < 0:
            errs.append("resilience.rollbacks missing/negative")
    errs.extend(_validate_serving(report.get("serving")))
    errs.extend(_validate_router(report.get("router")))
    errs.extend(_validate_compression(report.get("compression")))
    errs.extend(_validate_autoplan(report.get("autoplan")))
    errs.extend(_validate_pipeline(report["counters"].get("pipeline")))
    return errs


#: schedules the pipeline counters section may name (obs/aggregate.py's
#: ``pipeline_bubble_fraction`` vocabulary)
PIPELINE_SCHEDULES = ("forward", "1f1b", "zb")


def _validate_pipeline(pipe: Any) -> List[str]:
    """The optional ``counters.pipeline`` section (the pipelined examples
    and the ZB A/B record it): schedule-shape fields must be coherent,
    bubble fractions in range, and a ``zb`` record claiming a win over
    1F1B must actually show one — a section whose own numbers contradict
    the schedule it names is a reporting bug, surfaced here."""
    if pipe is None:
        return []
    if not isinstance(pipe, dict):
        return [f"counters.pipeline is {type(pipe).__name__}, expected dict"]
    errs: List[str] = []
    for key in ("pipe_size", "num_microbatches"):
        v = pipe.get(key)
        if not isinstance(v, int) or v < 1:
            errs.append(f"counters.pipeline.{key} missing/invalid: {v!r}")
    bf = pipe.get("bubble_fraction")
    if not isinstance(bf, (int, float)) or not (0.0 <= bf < 1.0):
        errs.append(f"counters.pipeline.bubble_fraction out of [0,1): {bf!r}")
    sched = pipe.get("schedule")
    if sched is not None and sched not in PIPELINE_SCHEDULES:
        errs.append(
            f"counters.pipeline.schedule {sched!r} not in "
            f"{PIPELINE_SCHEDULES}")
    ref = pipe.get("bubble_fraction_1f1b")
    if ref is not None:
        if not isinstance(ref, (int, float)) or not (0.0 <= ref < 1.0):
            errs.append(
                f"counters.pipeline.bubble_fraction_1f1b out of [0,1): "
                f"{ref!r}")
        elif sched == "zb" and isinstance(bf, (int, float)) and bf >= ref:
            errs.append(
                f"counters.pipeline: zb bubble_fraction {bf} not below the "
                f"1f1b reference {ref} — the zero-bubble claim is "
                f"contradicted by the section's own numbers")
    return errs


def _validate_autoplan(ap: Any) -> List[str]:
    """The optional ``autoplan`` section (dist/autoplan.py ``plan``): the
    candidate/pruned counts, the chosen plan (None only on the all-OOM
    verdict), ranked alternatives, and the optional modeled-vs-measured
    audit record."""
    if ap is None:
        return []
    if not isinstance(ap, dict):
        return [f"autoplan is {type(ap).__name__}, expected dict"]
    errs: List[str] = []
    if ap.get("schema") != AUTOPLAN_SCHEMA:
        errs.append(f"autoplan.schema {ap.get('schema')!r} invalid")
    if ap.get("verdict") not in PLAN_VERDICTS:
        errs.append(f"autoplan.verdict {ap.get('verdict')!r} invalid")
    nc, npr = ap.get("n_candidates"), ap.get("n_pruned_oom")
    if not isinstance(nc, int) or nc < 0:
        errs.append("autoplan.n_candidates missing/negative")
    if not isinstance(npr, int) or npr < 0 or (
            isinstance(nc, int) and npr > nc):
        errs.append("autoplan.n_pruned_oom missing/out of range")
    chosen = ap.get("chosen")
    if ap.get("verdict") == "all_oom":
        if chosen is not None:
            errs.append("autoplan.chosen set despite all_oom verdict")
        if isinstance(nc, int) and isinstance(npr, int) and npr != nc:
            errs.append("autoplan all_oom but n_pruned_oom != n_candidates")
    elif not isinstance(chosen, dict):
        errs.append("autoplan.chosen missing/non-dict")
    else:
        for k in ("key", "step_s", "compute_s", "comm_s"):
            if k == "key":
                if not isinstance(chosen.get(k), str) or not chosen[k]:
                    errs.append("autoplan.chosen.key missing")
            elif not isinstance(chosen.get(k), (int, float)) or chosen[k] < 0:
                errs.append(f"autoplan.chosen.{k} missing/negative")
        if not isinstance(chosen.get("mesh_axes"), dict):
            errs.append("autoplan.chosen.mesh_axes missing")
        if not isinstance(chosen.get("terms"), list):
            errs.append("autoplan.chosen.terms missing (per-term breakdown)")
    ranked = ap.get("ranked")
    if not isinstance(ranked, list):
        errs.append("autoplan.ranked missing/non-list")
        ranked = []
    for i, r in enumerate(ranked):
        if not isinstance(r, dict) or not r.get("key") or not isinstance(
                r.get("step_s"), (int, float)):
            errs.append(f"autoplan.ranked[{i}] lacks key/step_s")
            break
    mvm = ap.get("modeled_vs_measured")
    if mvm is not None:
        if not isinstance(mvm, dict) or not isinstance(
                mvm.get("rows"), list) or not mvm["rows"]:
            errs.append("autoplan.modeled_vs_measured lacks rows")
        elif not isinstance(mvm.get("ordering_agrees"), bool):
            errs.append("autoplan.modeled_vs_measured lacks ordering_agrees")
        else:
            for i, r in enumerate(mvm["rows"]):
                if not all(isinstance(r.get(k), (int, float)) and r[k] > 0
                           for k in ("modeled_step_s", "measured_step_s")):
                    errs.append(
                        f"autoplan.modeled_vs_measured.rows[{i}] invalid")
                    break
    return errs


def _validate_compression(comp: Any) -> List[str]:
    """The optional ``compression`` section (obs/comm_model.py
    ``compression_report``): mode, per-leaf policy roll-up, and
    predicted-vs-ledger-measured bytes per axis."""
    if comp is None:
        return []
    if not isinstance(comp, dict):
        return [f"compression is {type(comp).__name__}, expected dict"]
    errs: List[str] = []
    if not isinstance(comp.get("mode"), str) or not comp["mode"]:
        errs.append("compression.mode missing")
    pol = comp.get("policy")
    if not isinstance(pol, dict) or not isinstance(
            pol.get("n_leaves"), int) or not isinstance(
            pol.get("n_compressed"), int):
        errs.append("compression.policy lacks n_leaves/n_compressed")
    rows = comp.get("per_axis")
    if not isinstance(rows, list):
        errs.append("compression.per_axis missing/non-list")
        rows = []
    for i, r in enumerate(rows):
        if not isinstance(r, dict) or not r.get("axes"):
            errs.append(f"compression.per_axis[{i}] lacks axes")
            break
        for k in ("predicted_bytes", "measured_bytes"):
            v = r.get(k)
            if v is not None and (not isinstance(v, (int, float)) or v < 0):
                errs.append(f"compression.per_axis[{i}].{k} invalid")
    return errs


def _validate_memory(mem: Any) -> List[str]:
    """The required ``memory`` section (obs/mem_ledger.py): per-program
    static breakdown, modeled-vs-measured peak, headroom verdict."""
    errs: List[str] = []
    if mem.get("verdict") not in MEM_VERDICTS:
        errs.append(f"memory verdict {mem.get('verdict')!r} invalid")
    progs = mem.get("programs")
    if not isinstance(progs, list):
        errs.append("memory.programs missing/non-list")
        progs = []
    byte_keys = ("argument_bytes", "output_bytes", "temp_bytes",
                 "alias_bytes", "generated_code_bytes",
                 "peak_estimate_bytes")
    for i, p in enumerate(progs):
        if not isinstance(p, dict):
            errs.append(f"memory.programs[{i}] is not a dict")
            break
        for k in byte_keys:
            v = p.get(k)
            if not isinstance(v, int) or v < 0:
                errs.append(f"memory.programs[{i}].{k} missing/negative")
                break
    for k in ("modeled_peak_bytes", "measured_peak_bytes",
              "capacity_bytes", "peak_frac", "headroom_frac"):
        v = mem.get(k, None)
        if v is not None and not isinstance(v, (int, float)):
            errs.append(f"memory.{k} non-numeric")
    kv = mem.get("kv_pool")
    if kv is not None and kv.get("accounting_match") is False:
        # the serving engine's shape math and the device buffer disagree —
        # a real accounting bug, surfaced as a validation failure
        errs.append(
            f"memory.kv_pool accounting mismatch: expected "
            f"{kv.get('pool_bytes_expected')} != actual {kv.get('pool_bytes')}")
    return errs


def _validate_numerics(num: Any) -> List[str]:
    """The required ``numerics`` section (obs/numerics.py): timeline
    summary, alert roll-up, per-dtype HLO ledgers, optional A/B parity."""
    errs: List[str] = []
    alerts = num.get("alerts")
    if not isinstance(alerts, dict) or not isinstance(
            alerts.get("count"), int) or alerts["count"] < 0:
        errs.append("numerics.alerts.count missing/negative")
    elif alerts["count"] > 0 and not alerts.get("by_reason"):
        errs.append("numerics.alerts.by_reason empty with count > 0")
    if not isinstance(num.get("timeline"), list):
        errs.append("numerics.timeline missing/non-list")
    else:
        for i, t in enumerate(num["timeline"]):
            if not isinstance(t, dict) or "step" not in t:
                errs.append(f"numerics.timeline[{i}] lacks step")
                break
    leds = num.get("dtype_ledgers")
    if not isinstance(leds, list):
        errs.append("numerics.dtype_ledgers missing/non-list")
        leds = []
    for i, led in enumerate(leds):
        per = led.get("per_dtype") if isinstance(led, dict) else None
        if not isinstance(per, dict):
            errs.append(f"numerics.dtype_ledgers[{i}].per_dtype missing")
            break
        for dt, b in per.items():
            if not all(isinstance(b.get(k), int) and b[k] >= 0
                       for k in ("bytes", "ops", "flops")):
                errs.append(
                    f"numerics.dtype_ledgers[{i}].per_dtype[{dt!r}] "
                    f"lacks bytes/ops/flops")
                break
    summ = num.get("summary")
    if not isinstance(summ, dict):
        errs.append("numerics.summary missing/non-dict")
    else:
        for k in ("grad_norm_final", "update_ratio_final"):
            v = summ.get(k)
            if v is not None and not isinstance(v, (int, float)):
                errs.append(f"numerics.summary.{k} non-numeric")
    par = num.get("parity")
    if par is not None:
        if not isinstance(par, dict):
            errs.append(f"numerics.parity is {type(par).__name__}")
        elif par.get("verdict") not in PARITY_VERDICTS:
            errs.append(
                f"numerics.parity verdict {par.get('verdict')!r} invalid")
        elif not isinstance(par.get("streams"), list):
            errs.append("numerics.parity.streams missing/non-list")
    return errs


def _validate_serving(srv: Any) -> List[str]:
    """The optional ``serving`` section (a ServingEngine drove the run):
    TTFT/TPOT percentiles, aggregate tokens/s, slot occupancy and KV-pool
    utilization must be present and sane."""
    if srv is None:
        return []
    if not isinstance(srv, dict):
        return [f"serving is {type(srv).__name__}, expected dict"]
    errs: List[str] = []
    tps = srv.get("tokens_per_sec")
    if not isinstance(tps, (int, float)) or tps < 0:
        errs.append("serving.tokens_per_sec missing/negative")
    completed = srv.get("requests", {}).get("completed")
    if not isinstance(completed, int) or completed < 0:
        errs.append("serving.requests.completed missing/negative")
    for key in ("ttft_s", "tpot_s"):
        pct = srv.get(key)
        if not isinstance(pct, dict):
            errs.append(f"serving.{key} missing/non-dict")
            continue
        # ttft is stamped for every completed request; tpot may legitimately
        # be empty (every request retired on its first token)
        if completed and not pct and key == "ttft_s":
            errs.append("serving.ttft_s empty with completed requests")
        for p in ("p50", "p95", "p99"):
            if pct and not isinstance(pct.get(p), (int, float)):
                errs.append(f"serving.{key}.{p} missing/non-numeric")
    occ = srv.get("slot_occupancy", {}).get("mean")
    if not isinstance(occ, (int, float)) or not (0.0 <= occ <= 1.0):
        errs.append("serving.slot_occupancy.mean missing/out of [0,1]")
    util = srv.get("kv_pool", {}).get("mean_utilization")
    if not isinstance(util, (int, float)) or not (0.0 <= util <= 1.0):
        errs.append("serving.kv_pool.mean_utilization missing/out of [0,1]")
    # stress fields — optional for back-compat, validated when set
    if "verdict" in srv and srv["verdict"] not in SERVING_VERDICTS:
        errs.append(
            f"serving.verdict {srv['verdict']!r} not in {SERVING_VERDICTS}")
    reqs = srv.get("requests", {})
    # the verdict must cite evidence AND agree with the counters
    # that define it — a verdict whose own numbers contradict it is a
    # reporting bug, surfaced here instead of trusted downstream
    if "verdict_basis" in srv and (
            not isinstance(srv["verdict_basis"], str)
            or not srv["verdict_basis"]):
        errs.append("serving.verdict_basis empty/non-string")
    if "verdict" in srv and srv["verdict"] in SERVING_VERDICTS:
        refused = reqs.get("shed", 0) + reqs.get("expired", 0)
        degraded = (reqs.get("preempted", 0)
                    + (srv.get("faults") or {}).get("detected", 0))
        want = ("overloaded" if refused > 0
                else "degraded" if degraded > 0 else "healthy")
        if srv["verdict"] != want:
            errs.append(
                f"serving.verdict {srv['verdict']!r} contradicts its "
                f"evidence (shed+expired={refused}, "
                f"preempted+faults={degraded} -> {want!r})")
    for key in ("shed", "expired", "cancelled", "preempted", "resumed"):
        if key in reqs and (not isinstance(reqs[key], int) or reqs[key] < 0):
            errs.append(f"serving.requests.{key} non-int/negative")
    prios = srv.get("priorities")
    if prios is not None:
        if not isinstance(prios, dict):
            errs.append("serving.priorities non-dict")
        else:
            for p, row in prios.items():
                if not isinstance(row, dict) or not isinstance(
                        row.get("ttft_s", {}), dict):
                    errs.append(f"serving.priorities[{p}] malformed")
    faults = srv.get("faults")
    if faults is not None and (
            not isinstance(faults, dict)
            or faults.get("healed", 0) > faults.get("detected", 0)):
        errs.append("serving.faults malformed (healed > detected)")
    # fast-path fields — optional for back-compat, ranged when set
    for key in ("prefix_hit_rate", "spec_accept_rate"):
        if key in srv and (
                not isinstance(srv[key], (int, float))
                or not (0.0 <= srv[key] <= 1.0)):
            errs.append(f"serving.{key} non-numeric/out of [0,1]")
    spec = srv.get("spec")
    if spec is not None and (
            not isinstance(spec, dict)
            or spec.get("accepted", 0) > spec.get("drafted", 0)):
        errs.append("serving.spec malformed (accepted > drafted)")
    # expert-load fields — present for MoE engines, ranged when set
    moe = srv.get("moe")
    if moe is not None:
        if not isinstance(moe, dict):
            errs.append("serving.moe non-dict")
        else:
            imb = moe.get("imbalance")
            if not isinstance(imb, (int, float)) or imb < 0:
                errs.append("serving.moe.imbalance missing/negative")
            ent = moe.get("load_entropy")
            if not isinstance(ent, (int, float)) or not (0.0 <= ent <= 1.0):
                errs.append("serving.moe.load_entropy missing/out of [0,1]")
            dr = moe.get("dropped_token_rate")
            if not isinstance(dr, (int, float)) or not (0.0 <= dr <= 1.0):
                errs.append(
                    "serving.moe.dropped_token_rate missing/out of [0,1]")
            ne = moe.get("num_experts")
            if not isinstance(ne, int) or ne < 2:
                errs.append("serving.moe.num_experts missing/< 2")
            et = moe.get("expert_tokens")
            if not isinstance(et, list) or (
                    isinstance(ne, int) and len(et) != ne):
                errs.append("serving.moe.expert_tokens missing/wrong length")
            if moe.get("dispatch") not in ("gather", "cuda", "sorted"):
                errs.append(
                    f"serving.moe.dispatch {moe.get('dispatch')!r} unknown")
    # ring-paged-prefill fields — present for cp_group engines
    lc = srv.get("long_context")
    if lc is not None:
        if not isinstance(lc, dict):
            errs.append("serving.long_context non-dict")
        else:
            cp = lc.get("cp")
            if not isinstance(cp, int) or cp < 1:
                errs.append("serving.long_context.cp missing/< 1")
            for k in ("max_ctx", "chunk"):
                v = lc.get(k)
                if not isinstance(v, int) or v < 1:
                    errs.append(f"serving.long_context.{k} missing/< 1")
            for k in ("prefill_chunks", "ring_hops", "ring_bytes"):
                v = lc.get(k)
                if not isinstance(v, int) or v < 0:
                    errs.append(
                        f"serving.long_context.{k} missing/negative")
            # a width-1 'ring' has no hops; width > 1 with chunks must
            # have accumulated hop accounting
            if (isinstance(cp, int) and cp > 1
                    and lc.get("prefill_chunks", 0) > 0
                    and not lc.get("ring_hops", 0)):
                errs.append(
                    "serving.long_context.ring_hops zero with cp > 1 and "
                    "prefill chunks recorded")
    errs.extend(_validate_serving_slo(srv))
    return errs


def _validate_serving_slo(srv: Dict[str, Any]) -> List[str]:
    """The ``serving.slo`` sub-section: per-priority deadline
    attainment in [0, 1], goodput bounded by the aggregate tokens/s
    (goodput counts a SUBSET of the generated tokens over the same
    span), and the TTFT calibration record's ranges (positive bias,
    non-negative relative errors)."""
    slo = srv.get("slo")
    if slo is None:
        return []
    if not isinstance(slo, dict):
        return [f"serving.slo is {type(slo).__name__}, expected dict"]
    errs: List[str] = []
    gp = slo.get("goodput_tok_s")
    if not isinstance(gp, (int, float)) or gp < 0:
        errs.append("serving.slo.goodput_tok_s missing/negative")
    tps = srv.get("tokens_per_sec")
    if (isinstance(gp, (int, float)) and isinstance(tps, (int, float))
            and gp > tps * 1.001 + 1e-9):
        errs.append(
            f"serving.slo.goodput_tok_s {gp} exceeds tokens_per_sec {tps}")
    att = slo.get("attainment")
    if att is not None and (
            not isinstance(att, (int, float)) or not 0.0 <= att <= 1.0):
        errs.append("serving.slo.attainment out of [0, 1]")
    for p, row in (slo.get("priorities") or {}).items():
        if not isinstance(row, dict):
            errs.append(f"serving.slo.priorities[{p}] non-dict")
            continue
        for k in ("completed", "met", "missed", "shed", "expired",
                  "goodput_tokens"):
            v = row.get(k)
            if not isinstance(v, int) or v < 0:
                errs.append(f"serving.slo.priorities[{p}].{k} "
                            "missing/negative")
                break
        else:
            if row["met"] + row["missed"] != row["completed"]:
                errs.append(
                    f"serving.slo.priorities[{p}]: met+missed != completed")
        ra = row.get("attainment")
        if ra is not None and (
                not isinstance(ra, (int, float)) or not 0.0 <= ra <= 1.0):
            errs.append(f"serving.slo.priorities[{p}].attainment "
                        "out of [0, 1]")
    cal = slo.get("calibration")
    if cal is not None:
        if not isinstance(cal, dict):
            errs.append("serving.slo.calibration non-dict")
            return errs
        bias = cal.get("bias")
        if bias is not None and (
                not isinstance(bias, (int, float)) or bias <= 0):
            errs.append("serving.slo.calibration.bias non-positive")
        if not isinstance(cal.get("n"), int) or cal["n"] < 0:
            errs.append("serving.slo.calibration.n missing/negative")
        for p, row in (cal.get("priorities") or {}).items():
            for k, v in (row or {}).items():
                if k.startswith("rel_err_") and (
                        not isinstance(v, (int, float)) or v < 0):
                    errs.append(
                        f"serving.slo.calibration.priorities[{p}].{k} "
                        "negative/non-numeric")
    return errs


def _validate_router(rt: Any) -> List[str]:
    """The optional ``router`` section (a serving Router drove the run):
    one full serving section per replica — each re-validated through
    :func:`_validate_serving` — plus the fleet roll-up, whose invariants
    are cross-replica: fleet goodput cannot exceed the sum of the
    replica token rates (goodput counts a subset of the same tokens over
    a span at least as long as any replica's), the affinity hit rate is
    a fraction of routed requests, and the per-replica verdict list must
    agree with the replica sections it rolls up."""
    if rt is None:
        return []
    if not isinstance(rt, dict):
        return [f"router is {type(rt).__name__}, expected dict"]
    errs: List[str] = []
    reps = rt.get("replicas")
    if not isinstance(reps, list) or not reps:
        return ["router.replicas missing/empty"]
    for i, row in enumerate(reps):
        if not isinstance(row, dict):
            errs.append(f"router.replicas[{i}] non-dict")
            continue
        for key in ("index", "role", "alive"):
            if key not in row:
                errs.append(f"router.replicas[{i}].{key} missing")
        errs.extend(f"router.replicas[{i}]: {e}"
                    for e in _validate_serving(row))
    fleet = rt.get("fleet")
    if not isinstance(fleet, dict):
        errs.append("router.fleet missing/non-dict")
        return errs
    if fleet.get("verdict") not in SERVING_VERDICTS:
        errs.append(
            f"router.fleet.verdict {fleet.get('verdict')!r} not in "
            f"{SERVING_VERDICTS}")
    verdicts = fleet.get("verdicts")
    if (not isinstance(verdicts, list) or len(verdicts) != len(reps)
            or any(v not in SERVING_VERDICTS for v in verdicts)):
        errs.append("router.fleet.verdicts missing/mislengthed/invalid")
    elif verdicts != [row.get("verdict") for row in reps
                      if isinstance(row, dict)]:
        errs.append(
            "router.fleet.verdicts disagree with the replica sections")
    gp = fleet.get("goodput_tok_s")
    if not isinstance(gp, (int, float)) or gp < 0:
        errs.append("router.fleet.goodput_tok_s missing/negative")
    else:
        cap = sum(row.get("tokens_per_sec", 0.0) for row in reps
                  if isinstance(row, dict))
        if gp > cap * 1.001 + 1e-9:
            errs.append(
                f"router.fleet.goodput_tok_s {gp} exceeds the sum of "
                f"replica tokens_per_sec {cap}")
    aff = fleet.get("affinity")
    if not isinstance(aff, dict):
        errs.append("router.fleet.affinity missing/non-dict")
    else:
        hr = aff.get("hit_rate")
        if not isinstance(hr, (int, float)) or not (0.0 <= hr <= 1.0):
            errs.append("router.fleet.affinity.hit_rate out of [0, 1]")
        for k in ("routed", "affinity_routed"):
            if not isinstance(aff.get(k), int) or aff[k] < 0:
                errs.append(f"router.fleet.affinity.{k} missing/negative")
    mig = fleet.get("migrations")
    if not isinstance(mig, dict):
        errs.append("router.fleet.migrations missing/non-dict")
    else:
        for k in ("handoffs", "blocks", "bytes", "compressed"):
            v = mig.get(k)
            if not isinstance(v, int) or v < 0:
                errs.append(f"router.fleet.migrations.{k} missing/negative")
        # the fault-tolerant wire: retry/fallback counters are
        # optional (old reports) but must be sane when present, and a
        # fallback implies the transfer's handoff never completed — the
        # counters may never exceed what the wire actually carried
        for k in ("retries", "fallbacks"):
            v = mig.get(k)
            if v is not None and (not isinstance(v, int) or v < 0):
                errs.append(f"router.fleet.migrations.{k} negative/non-int")
    for k in ("rebalances", "evacuations"):
        v = fleet.get(k)
        if not isinstance(v, int) or v < 0:
            errs.append(f"router.fleet.{k} missing/negative")
    slo = fleet.get("slo")
    if not isinstance(slo, dict):
        errs.append("router.fleet.slo missing/non-dict")
    else:
        att = slo.get("attainment")
        if att is not None and (
                not isinstance(att, (int, float)) or not 0.0 <= att <= 1.0):
            errs.append("router.fleet.slo.attainment out of [0, 1]")
        prios = slo.get("priorities")
        if not isinstance(prios, dict):
            errs.append("router.fleet.slo.priorities missing/non-dict")
        else:
            for k, row in prios.items():
                a = row.get("attainment") if isinstance(row, dict) else None
                if a is not None and (
                        not isinstance(a, (int, float))
                        or not 0.0 <= a <= 1.0):
                    errs.append(
                        f"router.fleet.slo.priorities[{k}].attainment "
                        f"out of [0, 1]")
        per = slo.get("per_replica")
        if not isinstance(per, list) or len(per) != len(reps):
            errs.append("router.fleet.slo.per_replica missing/mislengthed")
    bal = fleet.get("balance")
    if not isinstance(bal, dict):
        errs.append("router.fleet.balance missing/non-dict")
    else:
        if bal.get("verdict") not in FLEET_BALANCE_VERDICTS:
            errs.append(
                f"router.fleet.balance.verdict {bal.get('verdict')!r} "
                f"not in {FLEET_BALANCE_VERDICTS}")
        idx = bal.get("imbalance_index")
        if idx is not None and (
                not isinstance(idx, (int, float)) or idx < 1.0 - 1e-9):
            errs.append(
                "router.fleet.balance.imbalance_index below 1 (it is "
                "max/mean served tokens within a role group)")
        if not bal.get("basis"):
            errs.append("router.fleet.balance.basis missing/empty (the "
                        "verdict must cite its evidence)")
        if (fleet.get("verdict") in SERVING_VERDICTS
                and fleet.get("verdict") != "healthy"
                and bal.get("verdict") == "balanced"):
            errs.append(
                "router.fleet.balance.verdict 'balanced' contradicts "
                f"fleet verdict {fleet.get('verdict')!r}")
    asc = fleet.get("autoscale")
    if asc is not None:
        errs.extend(_validate_autoscale(asc))
    return errs


def _validate_autoscale(asc: Any) -> List[str]:
    """The optional ``router.fleet.autoscale`` subsection (an
    ``Autoscaler`` was attached): verdict-vs-evidence cross-checked in
    BOTH directions — a ``static`` verdict with recorded scale actions
    lies about what the controller did, and a non-``static`` verdict
    with zero actions claims activity the ledger cannot attribute;
    ``thrashing`` must agree with the action count vs the thrash budget,
    and the action total must reconcile with its up/down split."""
    if not isinstance(asc, dict):
        return ["router.fleet.autoscale non-dict"]
    errs: List[str] = []
    if asc.get("verdict") not in AUTOSCALE_VERDICTS:
        errs.append(
            f"router.fleet.autoscale.verdict {asc.get('verdict')!r} not "
            f"in {AUTOSCALE_VERDICTS}")
    for k in ("actions", "evals", "scale_ups", "scale_downs", "holds"):
        v = asc.get(k)
        if not isinstance(v, int) or v < 0:
            errs.append(f"router.fleet.autoscale.{k} missing/negative")
    if not asc.get("basis"):
        errs.append("router.fleet.autoscale.basis missing/empty (the "
                    "verdict must cite its evidence)")
    actions = asc.get("actions")
    ups, downs = asc.get("scale_ups"), asc.get("scale_downs")
    if (isinstance(actions, int) and isinstance(ups, int)
            and isinstance(downs, int) and actions != ups + downs):
        errs.append(
            f"router.fleet.autoscale.actions {actions} != scale_ups "
            f"{ups} + scale_downs {downs}")
    verdict = asc.get("verdict")
    if isinstance(actions, int) and verdict in AUTOSCALE_VERDICTS:
        if verdict == "static" and actions > 0:
            errs.append(
                f"router.fleet.autoscale.verdict 'static' contradicts "
                f"{actions} recorded scale actions")
        if verdict != "static" and actions == 0:
            errs.append(
                f"router.fleet.autoscale.verdict {verdict!r} with 0 "
                f"actions — 'static' is the only verdict for a "
                f"controller that never acted")
        thrash_at = asc.get("thrash_at")
        if isinstance(thrash_at, int):
            if verdict == "thrashing" and actions <= thrash_at:
                errs.append(
                    f"router.fleet.autoscale.verdict 'thrashing' with "
                    f"{actions} actions <= thrash_at {thrash_at}")
            if verdict == "elastic" and actions > thrash_at:
                errs.append(
                    f"router.fleet.autoscale.verdict 'elastic' with "
                    f"{actions} actions > thrash_at {thrash_at}")
    return errs


def render_summary_line(report: Dict[str, Any]) -> str:
    """One line for stdout at end of run."""
    parts = [f"[obs] run={report['run']} steps={report['steps']}"]
    st = report.get("step_time_s", {})
    if st.get("n"):
        parts.append(f"step={st['mean'] * 1e3:.1f}ms(p99 {st['p99'] * 1e3:.1f})")
    tp = report.get("throughput", {})
    if "tokens_per_sec" in tp:
        parts.append(f"tok/s={tp['tokens_per_sec']:.0f}")
    mfu = report.get("mfu", {})
    if "xla" in mfu:
        parts.append(f"mfu_xla={mfu['xla']:.3f}")
    mem = report.get("memory", {})
    if mem.get("reported"):
        parts.append(f"peak_hbm={mem['peak_bytes_in_use'] / 1e9:.2f}GB")
    if mem.get("verdict") and mem["verdict"] != "unknown":
        frac = mem.get("headroom_frac")
        parts.append(
            f"mem={mem['verdict']}"
            + (f"(headroom {frac:.0%})" if isinstance(frac, (int, float))
               else ""))
    num = report.get("numerics", {})
    gn = num.get("summary", {}).get("grad_norm_final")
    if isinstance(gn, (int, float)):
        parts.append(f"gnorm={gn:.3g}")
    if num.get("alerts", {}).get("count"):
        reasons = ",".join(sorted(num["alerts"]["by_reason"]))
        parts.append(f"NUMERICS={num['alerts']['count']}alert({reasons})")
    par = num.get("parity")
    if par and par.get("verdict") and par["verdict"] != "unknown":
        parts.append(f"parity={par['verdict']}")
    hosts = report.get("hosts", {})
    if hosts.get("straggler") is not None:
        parts.append(f"STRAGGLER=host{hosts['straggler']}")
    comm = report.get("comm", {})
    if comm.get("verdict") and comm.get("verdict") != "unknown":
        frac = comm.get("comm_fraction")
        parts.append(
            f"{comm['verdict']}"
            + (f"(comm {frac:.0%})" if isinstance(frac, (int, float)) else ""))
    res = report.get("resilience")
    if res and res.get("verdict") and res["verdict"] != "clean":
        parts.append(
            f"RESILIENCE={res['verdict']}"
            f"(rollbacks {res.get('rollbacks', 0)})")
    cmpx = report.get("compression")
    if cmpx:
        pol = cmpx.get("policy", {})
        parts.append(
            f"compress={cmpx.get('mode', '?')}"
            f"({pol.get('n_compressed', 0)}/{pol.get('n_leaves', 0)} leaves)")
    ap = report.get("autoplan")
    if ap:
        if ap.get("verdict") == "all_oom":
            parts.append(f"AUTOPLAN=all_oom({ap.get('n_pruned_oom', 0)} pruned)")
        elif ap.get("chosen"):
            tail = ""
            mvm = ap.get("modeled_vs_measured")
            if mvm and mvm.get("rows"):
                r0 = mvm["rows"][0]
                if isinstance(r0.get("rel_err"), (int, float)):
                    tail = f"(model {r0['rel_err']:+.0%} vs measured)"
            parts.append(f"plan={ap['chosen']['key']}{tail}")
    srv = report.get("serving")
    if srv and isinstance(srv.get("tokens_per_sec"), (int, float)):
        tail = ""
        p50 = srv.get("ttft_s", {}).get("p50")
        if isinstance(p50, (int, float)):
            tail = f"(ttft p50 {p50 * 1e3:.0f}ms)"
        parts.append(f"serve={srv['tokens_per_sec']:.1f}tok/s{tail}")
        slo = srv.get("slo") or {}
        if slo.get("attainment") is not None:
            parts.append(
                f"goodput={slo.get('goodput_tok_s', 0.0):.1f}tok/s"
                f"(att {slo['attainment']:.0%})")
        if srv.get("verdict") and srv["verdict"] != "healthy":
            reqs = srv.get("requests", {})
            detail = ", ".join(
                f"{k} {reqs.get(k, 0)}"
                for k in ("shed", "expired", "preempted")
                if reqs.get(k))
            parts.append(
                f"SERVING={srv['verdict']}" + (f"({detail})" if detail else ""))
    rt = report.get("router")
    if rt and isinstance(rt.get("fleet"), dict):
        fleet = rt["fleet"]
        aff = fleet.get("affinity") or {}
        mig = fleet.get("migrations") or {}
        att = fleet.get("attainment")
        parts.append(
            f"fleet={fleet.get('n_alive', '?')}/"
            f"{fleet.get('n_replicas', '?')}rep "
            f"{fleet.get('tokens_per_sec', 0.0):.1f}tok/s"
            f"(aff {aff.get('hit_rate', 0.0):.0%}, "
            f"mig {mig.get('handoffs', 0)}/"
            f"{mig.get('bytes', 0) / 1e6:.2f}MB"
            + (f", att {att:.0%}" if att is not None else "") + ")")
        if fleet.get("verdict") and fleet["verdict"] != "healthy":
            parts.append(f"FLEET={fleet['verdict']}")
        bal = fleet.get("balance") or {}
        if bal.get("verdict") and bal["verdict"] != "balanced":
            idx = bal.get("imbalance_index")
            parts.append(
                f"BALANCE={bal['verdict']}"
                + (f"({idx:.2f})" if idx is not None else ""))
    return "  ".join(parts)


def render_markdown(report: Dict[str, Any]) -> str:
    """Human summary: headline table, MFU cross-check, counters, memory,
    and the event timeline."""
    L: List[str] = [f"# Run report — {report['run']}", ""]
    L.append(
        f"`{report['backend']}` · chip `{report.get('chip', '?')}` · "
        f"{report['n_devices']} device(s) / {report['n_processes']} process(es) · "
        f"{report['steps']} steps · {report.get('wall_time_s', 0):.1f}s wall")
    L.append("")

    st = report.get("step_time_s", {})
    if st.get("n"):
        L.append("## Step time (steady-state)")
        L.append("")
        L.append("| mean | min | p50 | p95 | p99 | max |")
        L.append("|---|---|---|---|---|---|")
        L.append(
            "| " + " | ".join(
                f"{st[k] * 1e3:.2f} ms"
                for k in ("mean", "min", "p50", "p95", "p99", "max")) + " |")
        L.append("")
        spans = report.get("spans_mean_s", {})
        if spans:
            L.append(
                "Span means: " + ", ".join(
                    f"{k} {v * 1e3:.2f} ms" for k, v in spans.items()))
            L.append("")

    tp = report.get("throughput", {})
    if "tokens_per_sec" in tp:
        L.append("## Throughput")
        L.append("")
        L.append(f"- mean **{tp['tokens_per_sec']:.1f} tok/s**, "
                 f"final {tp['tokens_per_sec_final']:.1f} tok/s")
        traj = tp.get("trajectory")
        if traj:
            L.append(f"- trajectory ({len(traj)} pts): "
                     + " ".join(f"{t:.0f}" for t in traj))
        L.append("")

    mfu = report.get("mfu", {})
    if mfu:
        L.append("## MFU / FLOPs")
        L.append("")
        if "xla" in mfu:
            L.append(f"- XLA cost-analysis MFU: **{mfu['xla']:.3f}**")
        if "formula" in mfu:
            L.append(f"- hand-formula MFU: {mfu['formula']:.3f}")
        if "xla_vs_formula_rel" in mfu:
            L.append(f"- XLA vs formula FLOPs: {mfu['xla_vs_formula_rel']:+.1%}")
        if "xla_flops_per_step" in mfu:
            L.append(f"- FLOPs/step (XLA): {mfu['xla_flops_per_step']:.3e}")
        if "xla_bytes_per_step" in mfu:
            L.append(f"- bytes moved/step (XLA): {mfu['xla_bytes_per_step']:.3e}")
        L.append("")

    mem = report.get("memory", {})
    if mem.get("reported") or mem.get("programs"):
        L.append("## Memory")
        L.append("")
        if mem.get("verdict"):
            L.append(f"- headroom verdict: **{mem['verdict']}** "
                     f"({mem.get('verdict_basis', '')})")
        if mem.get("reported"):
            L.append(
                f"- measured peak HBM: "
                f"**{mem['peak_bytes_in_use'] / 1e9:.3f} GB**"
                + (f" of {mem['capacity_bytes'] / 1e9:.1f} GB capacity"
                   if mem.get("capacity_bytes") else ""))
        if mem.get("modeled_peak_bytes"):
            L.append(f"- modeled (static ledger) peak: "
                     f"{mem['modeled_peak_bytes'] / 1e9:.3f} GB")
        kv = mem.get("kv_pool")
        if kv:
            match = kv.get("accounting_match")
            L.append(
                f"- serving KV pool: {kv.get('pool_bytes', 0) / 1e6:.2f} MB "
                f"device buffer ("
                + ("matches" if match else "MISMATCHES" if match is False
                   else "vs") + " the engine's shape math)")
        progs = mem.get("programs") or []
        if progs:
            L.append("")
            L.append("| program | args | outputs | temps | gen code "
                     "| donated | static peak |")
            L.append("|---|---|---|---|---|---|---|")
            for p in progs:
                L.append(
                    "| " + (p.get("label") or "?") + " | "
                    + " | ".join(
                        f"{p[k] / 1e6:.2f} MB"
                        for k in ("argument_bytes", "output_bytes",
                                  "temp_bytes", "generated_code_bytes",
                                  "alias_bytes", "peak_estimate_bytes"))
                    + " |")
            lead = progs[0]
            if lead.get("n_leaves"):
                L.append("")
                L.append(
                    f"- argument attribution ({lead['label']}): "
                    f"{lead['n_leaves']} leaves, "
                    f"{lead['sharded_leaves']} sharded / "
                    f"{lead['replicated_leaves']} replicated")
        L.append("")

    num = report.get("numerics", {})
    if (num.get("timeline") or num.get("dtype_ledgers")
            or num.get("alerts", {}).get("count")):
        L.append("## Numerics")
        L.append("")
        summ = num.get("summary", {})
        if "grad_norm_final" in summ:
            L.append(
                f"- grad norm: final **{summ['grad_norm_final']:.4g}**, "
                f"mean {summ.get('grad_norm_mean', 0):.4g}, "
                f"max {summ.get('grad_norm_max', 0):.4g}")
        if "update_ratio_final" in summ:
            L.append(f"- update ratio |Δp|/|p|: final "
                     f"{summ['update_ratio_final']:.3g}, mean "
                     f"{summ.get('update_ratio_mean', 0):.3g}")
        alerts = num.get("alerts", {})
        if alerts.get("count"):
            first = alerts.get("first", {})
            L.append(
                f"- **{alerts['count']} numerics alert(s)**: "
                + ", ".join(f"{r}×{n}"
                            for r, n in sorted(alerts["by_reason"].items()))
                + (f" — first at step {first.get('step')}"
                   f" ({first.get('reason')})" if first else ""))
        else:
            L.append("- no numerics alerts")
        for led in (num.get("dtype_ledgers") or [])[:1]:
            per = led.get("per_dtype") or {}
            if per:
                L.append("")
                L.append("| dtype | ops | buffer bytes | matmul FLOPs |")
                L.append("|---|---|---|---|")
                for dt, b in per.items():
                    L.append(f"| {dt} | {b['ops']} | {b['bytes']:,} | "
                             + (f"{b['flops']:.3e} |" if b['flops']
                                else "- |"))
        par = num.get("parity")
        if par:
            L.append("")
            L.append(f"- A/B parity ({' vs '.join(par.get('labels', []))}): "
                     f"**{par.get('verdict')}**")
            for c in par.get("streams", []):
                mrd = c.get("max_rel_delta")
                L.append(
                    f"  - {c.get('key')}: {c.get('verdict')} over "
                    f"{c.get('n_common')} steps"
                    + (f", max rel delta {mrd:.3g}"
                       if isinstance(mrd, (int, float)) else ""))
        L.append("")

    comp = report.get("compile", {})
    L.append(f"Compiles: {comp.get('count', 0)} "
             f"({comp.get('recompiles', 0)} recompiles), "
             f"{comp.get('time_s', 0):.1f}s total")
    L.append("")

    comm = report.get("comm", {})
    if comm.get("ledger", {}).get("n_collectives"):
        led = comm["ledger"]
        model = comm.get("model", {})
        L.append("## Communication")
        L.append("")
        L.append(
            f"- verdict: **{comm.get('verdict', 'unknown')}** "
            f"({comm.get('verdict_basis', '')})")
        if "comm_fraction" in comm:
            L.append(f"- modeled comm fraction of step: "
                     f"**{comm['comm_fraction']:.1%}** "
                     f"({comm['modeled_comm_s'] * 1e3:.3f} ms modeled vs "
                     f"{comm['measured_step_s'] * 1e3:.2f} ms measured)")
        if "modeled_compute_s" in comm:
            L.append(f"- modeled compute: "
                     f"{comm['modeled_compute_s'] * 1e3:.3f} ms")
        ov = comm.get("overlap")
        if ov:
            dist = ov.get("mean_sched_distance")
            L.append(
                f"- achieved overlap: **{ov['achieved_fraction']:.1%}** of "
                f"modeled comm hidden ({ov['hidden_ops']}/{ov['async_ops']} "
                f"async + {ov['sync_ops']} sync collectives"
                + (f", mean sched distance {dist:.0f} instr" if dist is not None
                   else "") + ")")
            if "comm_fraction_effective" in comm:
                L.append(f"- effective (exposed) comm fraction: "
                         f"{comm['comm_fraction_effective']:.1%}")
        if "overlap_headroom_s" in comm:
            L.append(f"- overlap headroom: "
                     f"{comm['overlap_headroom_s'] * 1e3:.3f} ms"
                     + (" (vs zero-overlap floor; see achieved overlap above)"
                        if ov else ""))
        L.append(f"- model source: {model.get('source', '?')} "
                 f"(chip {model.get('chip', '?')})")
        L.append("")
        L.append("| dim | collectives | bytes/step | modeled time |")
        L.append("|---|---|---|---|")
        per_dim_s = model.get("per_dim_s", {})
        for dim, st in sorted(led.get("per_dim", {}).items()):
            t = per_dim_s.get(dim)
            L.append(
                f"| {dim} | {st['ops']} | {st['bytes']:,} | "
                + (f"{t * 1e3:.3f} ms |" if isinstance(t, (int, float))
                   else "- |"))
        L.append("")

    cmpx = report.get("compression")
    if cmpx:
        L.append("## Compression")
        L.append("")
        pol = cmpx.get("policy", {})
        L.append(f"- mode: **{cmpx.get('mode', '?')}** — "
                 f"{pol.get('n_compressed', 0)}/{pol.get('n_leaves', 0)} "
                 f"grad leaves on the int8 ring")
        rows = cmpx.get("per_axis") or []
        if rows:
            L.append("")
            L.append("| axes | predicted bytes | ledger-measured bytes |")
            L.append("|---|---|---|")
            for r in rows:
                pred = r.get("predicted_bytes")
                meas = r.get("measured_bytes")
                L.append(
                    f"| {r['axes']} | "
                    + (f"{pred:,} | " if isinstance(pred, int) else "- | ")
                    + (f"{meas:,} |" if isinstance(meas, int) else "- |"))
        L.append("")

    ap = report.get("autoplan")
    if ap:
        L.append("## Auto-sharding plan")
        L.append("")
        L.append(
            f"- {ap.get('n_candidates', 0)} candidate(s) enumerated, "
            f"**{ap.get('n_pruned_oom', 0)} pruned over-budget** before any "
            f"compile (`plan_rejected_oom` events carry each)")
        basis = ap.get("basis") or {}
        if basis:
            L.append(
                f"- scoring basis: comm `{basis.get('comm', '?')}`, compute "
                f"`{basis.get('compute', '?')}`, memory "
                f"`{basis.get('memory', '?')}`")
        chosen = ap.get("chosen")
        if ap.get("verdict") == "all_oom":
            L.append("- **no plan fits the memory budget** (verdict "
                     "`all_oom`) — every candidate pruned")
        elif chosen:
            mem = chosen.get("memory") or {}
            L.append(
                f"- chosen: **`{chosen['key']}`** — modeled step "
                f"{chosen['step_s'] * 1e3:.3f} ms (compute "
                f"{chosen['compute_s'] * 1e3:.3f} + comm "
                f"{chosen['comm_s'] * 1e3:.3f}), modeled resident "
                f"{mem.get('total_bytes', 0) / 1e6:.1f} MB/device")
            terms = chosen.get("terms") or []
            if terms:
                L.append("")
                L.append("| term | op | axes | payload | x | modeled |")
                L.append("|---|---|---|---|---|---|")
                for t in terms:
                    tag = " (int8)" if t.get("compressed") else ""
                    L.append(
                        f"| {t['name']}{tag} | {t['op']} | "
                        f"{'+'.join(t['axes'])} | {t['payload_bytes']:,} B "
                        f"| {t['count']} | {t['total_s'] * 1e3:.3f} ms |")
        ranked = ap.get("ranked") or []
        if len(ranked) > 1:
            L.append("")
            L.append("| rank | plan | modeled step | comm | resident | "
                     "verdict |")
            L.append("|---|---|---|---|---|---|")
            for i, r in enumerate(ranked):
                mem = r.get("memory") or {}
                L.append(
                    f"| {i + 1} | `{r['key']}` | {r['step_s'] * 1e3:.3f} ms "
                    f"| {r['comm_s'] * 1e3:.3f} ms "
                    f"| {mem.get('total_bytes', 0) / 1e6:.1f} MB "
                    f"| {mem.get('verdict', '?')} |")
        mvm = ap.get("modeled_vs_measured")
        if mvm and mvm.get("rows"):
            agree = mvm.get("ordering_agrees")
            L.append("")
            L.append(
                "- modeled vs measured: ordering "
                + ("**agrees**" if agree else "**DISAGREES** (per-term "
                   "breakdowns above are the audit trail)"))
            for r in mvm["rows"]:
                re_ = r.get("rel_err")
                L.append(
                    f"  - `{r['key']}`: modeled "
                    f"{r['modeled_step_s'] * 1e3:.3f} ms vs measured "
                    f"{r['measured_step_s'] * 1e3:.3f} ms"
                    + (f" ({re_:+.1%})" if isinstance(re_, (int, float))
                       else ""))
        L.append("")

    res = report.get("resilience")
    if res:
        L.append("## Resilience")
        L.append("")
        L.append(f"- verdict: **{res.get('verdict', '?')}**")
        L.append(f"- rollbacks: {res.get('rollbacks', 0)} "
                 f"(budget {res.get('max_rollbacks', '?')})")
        if res.get("faults_injected"):
            L.append(f"- chaos faults injected: {res['faults_injected']}")
        if res.get("data_offset"):
            L.append(f"- data stream advanced by {res['data_offset']} "
                     f"batch(es) past poisoned windows")
        if res.get("last_checkpoint") is not None:
            L.append(f"- last good checkpoint: step {res['last_checkpoint']}")
        if res.get("hang_suspected"):
            L.append(f"- watchdog hang episodes: {res['hang_suspected']}")
        L.append("")

    srv = report.get("serving")
    if srv:
        L.append("## Serving")
        L.append("")
        reqs = srv.get("requests", {})
        L.append(f"- requests: **{reqs.get('completed', 0)} completed** "
                 f"({reqs.get('queued', 0)} queued, "
                 f"{reqs.get('in_flight', 0)} in flight at finalize)")
        if srv.get("verdict"):
            stress = ", ".join(
                f"{k} {reqs.get(k, 0)}"
                for k in ("shed", "expired", "preempted", "cancelled",
                          "resumed")
                if reqs.get(k))
            L.append(f"- verdict: **{srv['verdict']}**"
                     + (f" ({stress})" if stress else "")
                     + (f" — {srv['verdict_basis']}"
                        if srv.get("verdict_basis") else ""))
        faults = srv.get("faults") or {}
        if faults.get("detected"):
            L.append(f"- faults: {faults['detected']} detected, "
                     f"{faults.get('healed', 0)} healed "
                     f"({faults.get('audits', 0)} invariant audits)")
        pc = srv.get("prefix_cache") or {}
        if pc.get("enabled"):
            L.append(
                f"- prefix cache: hit rate "
                f"**{srv.get('prefix_hit_rate', 0.0):.0%}** "
                f"({pc.get('hits', 0)} hits, {pc.get('cached_tokens', 0)} "
                f"tokens, {pc.get('cow_copies', 0)} COW, "
                f"{pc.get('evictions', 0)} evictions)")
        spec = srv.get("spec") or {}
        if spec.get("k"):
            L.append(
                f"- speculative decode (k={spec['k']}): accept rate "
                f"**{srv.get('spec_accept_rate', 0.0):.0%}** "
                f"({spec.get('accepted', 0)}/{spec.get('drafted', 0)} "
                f"drafts)")
        prios = srv.get("priorities") or {}
        if len(prios) > 1:
            L.append("")
            L.append("| priority | completed | TTFT p50 | TTFT p99 "
                     "| TPOT p50 |")
            L.append("|---|---|---|---|---|")
            for p in sorted(prios, key=lambda x: -int(x)):
                row = prios[p]
                tt, tp = row.get("ttft_s") or {}, row.get("tpot_s") or {}
                fmt = (lambda d, k: f"{d[k] * 1e3:.2f} ms"
                       if isinstance(d.get(k), (int, float)) else "-")
                L.append(
                    f"| {p} | {row.get('completed', 0)} "
                    f"| {fmt(tt, 'p50')} | {fmt(tt, 'p99')} "
                    f"| {fmt(tp, 'p50')} |")
            L.append("")
        L.append(f"- aggregate throughput: "
                 f"**{srv.get('tokens_per_sec', 0.0):.1f} tok/s** "
                 f"({srv.get('generated_tokens', 0)} tokens)")
        for key, label in (("ttft_s", "TTFT"), ("tpot_s", "TPOT")):
            pct = srv.get(key) or {}
            if pct:
                L.append(
                    f"- {label}: " + " / ".join(
                        f"{p} {pct[p] * 1e3:.2f} ms"
                        for p in ("p50", "p95", "p99") if p in pct))
        occ = srv.get("slot_occupancy", {})
        pool = srv.get("kv_pool", {})
        if occ:
            L.append(f"- slot occupancy: mean "
                     f"**{occ.get('mean', 0.0):.1%}** of "
                     f"{occ.get('num_slots', '?')} slots")
        if pool:
            L.append(
                f"- KV pool: {pool.get('num_blocks', '?')} blocks x "
                f"{pool.get('block_size', '?')} positions "
                f"(x{pool.get('dp_groups', 1)} dp) — mean utilization "
                f"{pool.get('mean_utilization', 0.0):.1%}, peak "
                f"{pool.get('peak_utilization', 0.0):.1%}")
        L.append(
            f"- {srv.get('decode_steps', 0)} decode steps "
            f"(mean batch {srv.get('decode_batch_mean', 0.0):.2f}) + "
            f"{srv.get('prefill_chunks', 0)} prefill chunks; "
            f"{srv.get('decode_signatures', '?')} decode signature(s) "
            f"compiled")
        slo = srv.get("slo") or {}
        if slo:
            att = slo.get("attainment")
            L.append(
                f"- SLO goodput: **{slo.get('goodput_tok_s', 0.0):.1f} "
                f"tok/s** ({slo.get('goodput_tokens', 0)} deadline-meeting "
                f"tokens)"
                + (f", attainment **{att:.0%}**" if att is not None
                   else " — no deadlines submitted"))
            cal = slo.get("calibration") or {}
            if cal.get("n"):
                bias = cal.get("bias")
                L.append(
                    f"- TTFT calibration: {cal['n']} prediction(s) "
                    f"resolved, EWMA bias "
                    + (f"**{bias:.3f}**" if isinstance(bias, (int, float))
                       else "unset")
                    + f" ({cal.get('pending', 0)} pending)")
            sp = slo.get("priorities") or {}
            if sp:
                L.append("")
                L.append("| priority | completed | met | missed | shed "
                         "| expired | attainment | goodput tokens |")
                L.append("|---|---|---|---|---|---|---|---|")
                for p in sorted(sp, key=lambda x: -int(x)):
                    row = sp[p]
                    ra = row.get("attainment")
                    L.append(
                        f"| {p} | {row.get('completed', 0)} "
                        f"| {row.get('met', 0)} | {row.get('missed', 0)} "
                        f"| {row.get('shed', 0)} | {row.get('expired', 0)} "
                        f"| " + (f"{ra:.0%}" if ra is not None else "-")
                        + f" | {row.get('goodput_tokens', 0)} |")
                L.append("")
        ta = srv.get("tick_accounting") or {}
        if ta.get("ticks"):
            pm = ta.get("phases_mean_s") or {}
            L.append(
                f"- tick accounting: {ta['ticks']} ticks, mean "
                f"{ta.get('mean_tick_s', 0.0) * 1e3:.2f} ms ("
                + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in pm.items()
                            if v > 0)
                + " ms)")
        L.append("")

    rt = report.get("router")
    if rt and isinstance(rt.get("fleet"), dict):
        fleet = rt["fleet"]
        L.append("## Router fleet")
        L.append("")
        L.append(
            f"- verdict: **{fleet.get('verdict', '?')}** "
            f"({fleet.get('n_alive', '?')}/{fleet.get('n_replicas', '?')} "
            f"replicas alive)")
        L.append(
            f"- fleet throughput: "
            f"**{fleet.get('tokens_per_sec', 0.0):.1f} tok/s** "
            f"({fleet.get('generated_tokens', 0)} tokens), goodput "
            f"{fleet.get('goodput_tok_s', 0.0):.1f} tok/s")
        aff = fleet.get("affinity") or {}
        L.append(
            f"- prefix affinity: hit rate "
            f"**{aff.get('hit_rate', 0.0):.0%}** "
            f"({aff.get('affinity_routed', 0)}/{aff.get('routed', 0)} "
            f"routed warm, {aff.get('fallbacks', 0)} shed-fallbacks)")
        mig = fleet.get("migrations") or {}
        L.append(
            f"- KV migrations: {mig.get('handoffs', 0)} handoffs "
            f"({mig.get('blocks', 0)} blocks copied, "
            f"{mig.get('shared_blocks', 0)} prefix-shared on arrival, "
            f"{mig.get('bytes', 0) / 1e6:.2f} MB wire, "
            f"{mig.get('compressed', 0)} int8-compressed) over "
            f"{mig.get('signatures', 0)} compiled pair program(s)")
        if mig.get("retries") or mig.get("fallbacks"):
            L.append(
                f"- migration wire: {mig.get('retries', 0)} chunk "
                f"re-request(s) healed by backoff, "
                f"{mig.get('fallbacks', 0)} dead transfer(s) fell back "
                f"to re-prefill")
        asc = fleet.get("autoscale") or {}
        if asc:
            L.append(
                f"- autoscale: **{asc.get('verdict', '?')}** "
                f"({asc.get('scale_ups', 0)} up / "
                f"{asc.get('scale_downs', 0)} down / "
                f"{asc.get('retiers', 0)} retier over "
                f"{asc.get('evals', 0)} evals) — {asc.get('basis', '')}")
        L.append(
            f"- rebalances: {fleet.get('rebalances', 0)} "
            f"({fleet.get('rebalanced_requests', 0)} requests moved), "
            f"evacuations: {fleet.get('evacuations', 0)} "
            f"({fleet.get('evacuated_requests', 0)} rehomed)")
        slo = fleet.get("slo") or {}
        if slo:
            att = slo.get("attainment")
            prio_bits = ", ".join(
                f"p{k}: {row['attainment']:.0%}"
                for k, row in sorted((slo.get("priorities") or {}).items())
                if isinstance(row, dict)
                and row.get("attainment") is not None)
            L.append(
                f"- fleet SLO attainment: "
                f"**{att:.0%}**" if att is not None
                else "- fleet SLO attainment: **n/a** (no deadlines)")
            if prio_bits:
                L[-1] += f" ({prio_bits})"
        bal = fleet.get("balance") or {}
        if bal:
            idx = bal.get("imbalance_index")
            L.append(
                f"- load balance: **{bal.get('verdict', '?')}**"
                + (f" (imbalance index {idx:.2f})" if idx is not None
                   else "")
                + f" — {bal.get('basis', '')}")
        reps = rt.get("replicas") or []
        if reps:
            L.append("")
            L.append("| replica | role | zone | alive | verdict | tok/s "
                     "| completed | migrated in/out | hit rate | SLO att |")
            L.append("|---|---|---|---|---|---|---|---|---|---|")
            for row in reps:
                reqs = row.get("requests") or {}
                ratt = (row.get("slo") or {}).get("attainment")
                L.append(
                    f"| {row.get('index', '?')} | {row.get('role', '?')} "
                    f"| {row.get('zone', '?')} "
                    f"| {'yes' if row.get('alive') else 'DEAD'} "
                    f"| {row.get('verdict', '?')} "
                    f"| {row.get('tokens_per_sec', 0.0):.1f} "
                    f"| {reqs.get('completed', 0)} "
                    f"| {reqs.get('migrated_in', 0)}/"
                    f"{reqs.get('migrated_out', 0)} "
                    f"| {row.get('prefix_hit_rate', 0.0):.0%} "
                    f"| {f'{ratt:.0%}' if ratt is not None else 'n/a'} |")
        L.append("")

    counters = report.get("counters", {})
    if counters:
        L.append("## Counters")
        L.append("")
        for name, val in counters.items():
            L.append(f"- **{name}**: `{json.dumps(val)}`")
        L.append("")

    hosts = report.get("hosts", {})
    if hosts.get("n_hosts", 1) > 1:
        L.append("## Hosts")
        L.append("")
        L.append("| host | mean | min | max |")
        L.append("|---|---|---|---|")
        for h in hosts["per_host"]:
            mark = " ⚠" if h["process"] == hosts.get("straggler") else ""
            L.append(f"| {h['process']}{mark} | {h['mean'] * 1e3:.2f} ms "
                     f"| {h['min'] * 1e3:.2f} | {h['max'] * 1e3:.2f} |")
        L.append("")

    events = report.get("events", [])
    if events:
        L.append("## Event timeline")
        L.append("")
        t0 = events[0]["t_mono"]
        n_ticks = sum(1 for ev in events if ev.get("kind") == "engine_tick")
        if n_ticks:
            # per-tick accounting is trace material, not summary material
            L.append(f"- ({n_ticks} `engine_tick` record(s) elided — "
                     f"scrub them in the Perfetto trace)")
        for ev in events:
            if ev.get("kind") == "engine_tick":
                continue
            extras = {k: v for k, v in ev.items()
                      if k not in ("type", "kind", "t_wall", "t_mono", "process")
                      and v is not None}
            tail = f" {json.dumps(extras)}" if extras else ""
            L.append(f"- `+{ev['t_mono'] - t0:8.3f}s` p{ev['process']} "
                     f"**{ev['kind']}**{tail}")
        L.append("")
    return "\n".join(L)


def write_runreport(report: Dict[str, Any], path: str) -> None:
    """Write ``path`` (JSON) and a sibling ``.md``; best-effort on OSError
    (a read-only checkout must not crash the run at its last step)."""
    try:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(report, f, indent=1, default=str)
        md = os.path.splitext(path)[0] + ".md"
        with open(md, "w") as f:
            f.write(render_markdown(report))
    except OSError:
        pass
