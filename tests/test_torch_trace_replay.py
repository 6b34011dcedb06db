"""The port's ``tools/trace_replay.py`` on the CPU, against the JAX
package's: a 10^3-request replay through the port's Router on
``StubDeviceStep`` engines is schema-valid with complete ledger
attribution, and its ``submitted`` and ``config_hash`` equal JAX's
``run_replay`` at the same arguments; the CLI's JSON line and
``--ledger`` file; the ``--autoscale --chaos --ab`` twin; the
mixed-traffic starvation claim; and the ``--report`` / ``--trace``
files, valid under both packages' validators.

Compared with JAX: what the seeded workload fixes before any
completion feeds back (``submitted``, ``config_hash``, the base arrival
rate).  Excluded, because they read the host clock: placements and
sheds (the replay's deadlines are TTFT budgets the engines estimate
from measured tick times) and what follows from them — ticks, goodput,
attainment, the multi-turn re-arrivals and the A/B delta.
"""

import json

import pytest

from torchdistpackage_tpu.obs.report import \
    validate_runreport as jax_validate_runreport
from torchdistpackage_tpu.obs.trace import validate_trace as jax_validate_trace
from torchdistpackage_tpu.tools.trace_replay import \
    run_replay as jax_run_replay
from torchdistpackage_tpu_torch.obs import validate_runreport, validate_trace
from torchdistpackage_tpu_torch.serving import ROUTER_EVENT_KINDS
from torchdistpackage_tpu_torch.serving.tracing import ROUTER_PID, fleet_pid
from torchdistpackage_tpu_torch.tools.trace_replay import main, run_replay

SMALL = dict(n_requests=1000, num_slots=8, diurnal_period=256)


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def test_replay_1000_is_valid_and_matches_jax_workload():
    out = run_replay(**SMALL)
    out.pop("events")
    want = jax_run_replay(**SMALL)
    want.pop("events")
    assert out["validation_errors"] == []
    assert out["attribution"]["complete"], out["attribution"]
    assert out["submitted"] == want["submitted"] == 1000
    assert out["config_hash"] == want["config_hash"]
    assert out["attribution"]["ledger_route_decisions"] == 1000
    assert out["attribution"]["handoffs"] > 0
    assert out["summary"]["fleet"]["verdict"] in (
        "healthy", "degraded", "overloaded")
    # the workload's draws before the first clock-driven decision
    assert out["workload"]["groups"] == want["workload"]["groups"]
    assert out["workload"]["base_rate_req_per_tick"] == \
        want["workload"]["base_rate_req_per_tick"]


def test_cli_line_and_ledger(tmp_path, capsys):
    ledger = tmp_path / "ledger.jsonl"
    assert main(["--n-requests", "1000", "--num-slots", "8",
                 "--diurnal-period", "256", "--ledger", str(ledger)]) == 0
    (rec,) = [r for r in _lines(capsys) if r.get("metric") == "trace-replay"]
    assert rec["report_valid"] and rec["attribution_complete"]
    assert rec["n_requests"] == 1000
    assert {"fleet_goodput_tok_s", "fleet_slo_attainment",
            "migration_count", "migration_bytes", "config_hash"} <= set(rec)
    led = [json.loads(ln) for ln in ledger.read_text().splitlines()]
    assert {r["kind"] for r in led} <= ROUTER_EVENT_KINDS
    assert sum(r["kind"] == "route_decision" for r in led) == 1000


def test_cli_autoscale_chaos_ab_twin(tmp_path, capsys):
    """``--autoscale --chaos --ab`` with a spare: both arms at one config
    hash, the autoscaler acted and the ledger reconciles, the wire's
    fault plan fired (re-requests healed it)."""
    assert main(["--n-requests", "1000", "--num-slots", "8",
                 "--replicas", "3", "--spares", "1",
                 "--diurnal-period", "256", "--curve-every", "64",
                 "--eval-every", "16", "--cooldown", "48",
                 "--queue-high", "1.0", "--autoscale", "--chaos",
                 "--ab", "--ledger", str(tmp_path / "l.jsonl")]) == 0
    lines = _lines(capsys)
    (rec,) = [r for r in lines if r.get("metric") == "trace-replay"]
    (ab,) = [r for r in lines if r.get("metric") == "trace-replay-ab"]
    assert rec["report_valid"] and rec["attribution_complete"]
    assert rec["autoscale_actions"] >= 1
    assert rec["migration_retry_count"] >= 1  # only a fired fault retries
    assert ab["config_hash_match"] and ab["baseline_valid"]


def test_mixed_traffic_no_starvation():
    """Three 384-token documents among short requests: the short class's
    p99 wait (ticks) stays below the long class's p50, every document
    completes, and the ledger still reconciles."""
    out = run_replay(n_requests=160, n_replicas=3, num_slots=8, seed=3,
                     long_docs=3, long_doc_len=384, curve_every=64)
    assert out["validation_errors"] == []
    assert out["attribution"]["complete"]
    mt = out["mixed_traffic"]
    assert mt["long_docs"] == 3 and mt["long"]["n"] == 3
    assert mt["short"]["n"] > 100
    assert mt["short"]["p99_wait_ticks"] < mt["long"]["p50_wait_ticks"]
    assert mt["long"]["p99_wait_ticks"] < out["ticks"]


@pytest.mark.parametrize("flag", ["--report", "--trace"])
def test_report_and_trace_are_refused(tmp_path, flag, capsys):
    """No longer refused: ``--report`` writes a FLEETREPORT that both
    packages' ``validate_runreport`` pass (with its ``.md`` beside it)
    and ``--trace`` a fleet trace that both ``validate_trace`` pass, with
    the router's lane and a process per replica."""
    path = tmp_path / "out" / "x.json"
    assert main(["--n-requests", "40", "--num-slots", "4",
                 "--diurnal-period", "64", flag, str(path)]) == 0
    got = json.loads(path.read_text())
    assert "Obs, resilience" not in capsys.readouterr().out
    if flag == "--report":
        assert validate_runreport(got) == []
        assert jax_validate_runreport(got) == []
        assert got["router"]["fleet"]["n_replicas"] == 4
        assert path.with_suffix(".md").read_text().startswith(
            "# Run report — trace-replay-seed0")
    else:
        assert validate_trace(got) == [] and jax_validate_trace(got) == []
        pids = {e["pid"] for e in got["traceEvents"]}
        assert {ROUTER_PID} | {fleet_pid(i) for i in range(4)} <= pids
