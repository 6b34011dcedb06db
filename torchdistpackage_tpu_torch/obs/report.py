"""The fleet report's validators — the part of
``torchdistpackage_tpu/obs/report.py`` that the Router's and the
Autoscaler's summaries are checked with: :func:`_validate_router` (JAX
:571), :func:`_validate_autoscale` (:705) and what they call of the
serving section's, :func:`_validate_serving` (:363) and
:func:`_validate_serving_slo` (:506), with the verdict vocabularies.
Each returns a list of problems (empty: valid).  Where the port's
serving summary differs from the reference's, so does the check: a
``moe.dispatch`` is one of the port's (``'gather'``, ``'cuda'``,
``'sorted'``), and a ``long_context`` block names no mesh axis (the
engine takes ``cp_group``).  ``render_markdown``,
``render_summary_line`` and ``write_runreport`` wait for ROADMAP queue
A's "Obs, resilience, tools, utils and HF conversion".
"""

from __future__ import annotations

from typing import Any, Dict, List

#: the serving engine's end states (``serving_summary()['verdict']``):
#: overloaded = demand was refused (shed / expired), degraded = the
#: engine preempted or healed faults to keep serving, healthy = neither
SERVING_VERDICTS = ("healthy", "degraded", "overloaded")

#: the fleet balance verdicts (``serving/router.py`` owns the policy; the
#: vocabulary is mirrored so obs validates without importing serving)
FLEET_BALANCE_VERDICTS = ("balanced", "skewed", "degraded")

#: the autoscaler's end states (``serving/autoscale.py``)
AUTOSCALE_VERDICTS = ("static", "elastic", "thrashing")


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
