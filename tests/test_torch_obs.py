"""The port's observability layer on the CPU, against the JAX package's:
the sinks and ``MetricsLogger`` write byte-equal files, the step-time and
pipeline arithmetic and the numerics thresholds equal JAX's, one report
dict renders to byte-equal summary lines and markdown, the port's
RUNREPORT passes both packages' ``validate_runreport`` and malformed
reports fail both, and ``Telemetry.wrap_step`` on a plain function
records its spans and its ``compile`` / ``recompile`` events.

Telemetry installs its event log as the process default; every test
here resets it.
"""

import json
import time

import numpy as np
import pytest
import torch

from torchdistpackage_tpu.obs import aggregate as jagg
from torchdistpackage_tpu.obs import exporters as jexp
from torchdistpackage_tpu.obs import numerics as jnum
from torchdistpackage_tpu.obs import report as jrep
from torchdistpackage_tpu.obs.events import EventLog as JEventLog
from torchdistpackage_tpu.utils.metrics import MetricsLogger as JLogger
from torchdistpackage_tpu_torch.obs import (
    EVENT_KINDS,
    EventLog,
    JsonlSink,
    MultiSink,
    PrometheusTextfileSink,
    Telemetry,
    TensorBoardSink,
    check_alerts,
    cross_host_step_stats,
    live_memory,
    mem_report,
    numerics_report,
    pipeline_bubble_fraction,
    pipeline_time_inflation,
    render_markdown,
    render_summary_line,
    set_default_event_log,
    step_time_stats,
    tensorboard_available,
    validate_runreport,
)
from torchdistpackage_tpu_torch.utils import MetricsLogger


@pytest.fixture(autouse=True)
def _fresh_default_log():
    set_default_event_log(None)
    yield
    set_default_event_log(None)


def _records():
    rs = np.random.RandomState(0)
    return [{"step": i, "loss": float(rs.rand()), "lr": 1e-3 * (i + 1),
             "tok_per_sec": float(rs.rand() * 1e4), "ok": True,
             "process": 0, "name": f"s{i}"} for i in range(5)]


# ------------------------------------------------------------- exporters


def test_jsonl_and_prometheus_files_byte_equal_jax(tmp_path):
    report = {"run": "r", "steps": 5, "step_time_s": {"mean": 0.25, "n": 5},
              "memory": {"reported": False, "peak_bytes_in_use": 0}}
    for pkg, (jsonl, prom) in {
            "jax": (jexp.JsonlSink, jexp.PrometheusTextfileSink),
            "port": (JsonlSink, PrometheusTextfileSink)}.items():
        sinks = [jsonl(str(tmp_path / f"{pkg}.jsonl")),
                 prom(str(tmp_path / f"{pkg}.prom"), run="r")]
        for rec in _records():
            for s in sinks:
                s.write(rec)
        for s in sinks:
            s.write_summary(report)
            s.close()
    for ext in ("jsonl", "prom"):
        got = (tmp_path / f"port.{ext}").read_bytes()
        assert got == (tmp_path / f"jax.{ext}").read_bytes() and got


def test_multisink_isolates_a_failing_sink(tmp_path):
    class Broken:
        def write(self, rec):
            raise OSError("disk full")

        write_summary = close = write

    good = JsonlSink(str(tmp_path / "m.jsonl"))
    ms = MultiSink([Broken(), good])
    ms.write({"step": 0})
    ms.write_summary({"run": "r"})
    ms.close()
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert [json.loads(ln)["type"] if "type" in ln else "rec"
            for ln in lines] == ["rec", "summary"]


def test_tensorboard_guard_matches_jax():
    assert tensorboard_available() == jexp.tensorboard_available()
    if not tensorboard_available():
        with pytest.raises(ImportError, match="tensorboard"):
            TensorBoardSink("unused")


def test_metrics_logger_files_byte_equal_jax(tmp_path, monkeypatch):
    """The shim over JsonlSink, under one fake clock for both packages."""
    for pkg, cls in (("jax", JLogger), ("port", MetricsLogger)):
        ticks = iter(np.arange(0.0, 100.0, 0.5))
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
        ml = cls(path=str(tmp_path / f"{pkg}.jsonl"), tokens_per_step=64,
                 print_every=0)
        for rec in _records():
            ml.log(rec["step"], loss=rec["loss"], lr=rec["lr"])
        monkeypatch.undo()
    got = (tmp_path / "port.jsonl").read_bytes()
    assert got == (tmp_path / "jax.jsonl").read_bytes()
    assert b"tok_per_sec_avg" in got


def test_event_log_writes_jsonl(tmp_path):
    path = tmp_path / "events.jsonl"
    log = EventLog(path=str(path))
    log.emit("compile", compile_time_s=0.5)
    log.emit("engine_tick", tick=1)
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [ln["kind"] for ln in lines] == ["compile", "engine_tick"]
    assert lines[0]["process"] == 0 and lines[0]["t_mono"] > 0
    assert {"run_start", "compile", "recompile", "mem_snapshot",
            "engine_tick", "slots_snapshot", "hang_suspected", "hang_abort",
            "desync_detected", "straggler", "numerics_alert"} <= EVENT_KINDS


# ------------------------------------------------------------ arithmetic


def test_step_time_stats_equal_jax():
    rs = np.random.RandomState(1)
    for times in ([], [0.5], list(rs.exponential(0.1, 257))):
        assert step_time_stats(times) == jagg.step_time_stats(times)
    times = list(rs.exponential(0.1, 64))
    assert cross_host_step_stats(times) == jagg.cross_host_step_stats(times)


@pytest.mark.parametrize("schedule", ["forward", "1f1b", "zb"])
def test_pipeline_arithmetic_equal_jax(schedule):
    rs = np.random.RandomState(2)
    for M, P in rs.randint(1, 33, size=(20, 2)):
        for V in ((1, 2, 4) if schedule == "1f1b" else (1,)):
            assert pipeline_bubble_fraction(M, P, V, schedule) == \
                jagg.pipeline_bubble_fraction(M, P, V, schedule)
        if schedule != "forward":
            assert pipeline_time_inflation(M, P, schedule) == \
                jagg.pipeline_time_inflation(M, P, schedule)
    with pytest.raises(ValueError, match="interleaved"):
        pipeline_bubble_fraction(8, 4, 2, "zb")


def test_numerics_alerts_and_section_equal_jax():
    rs = np.random.RandomState(3)
    recs = [{"step": i, "loss": float(v), "grad_norm": float(g),
             "update_ratio": float(u), "nonfinite_grads": float(n)}
            for i, (v, g, u, n) in enumerate(zip(
                rs.rand(12), 10.0 ** rs.uniform(-9, 5, 12),
                10.0 ** rs.uniform(-8, 0, 12), rs.randint(0, 2, 12)))]
    recs[3]["loss"] = float("nan")
    th = {"grad_norm_explode": 50.0}
    for r in recs:
        assert check_alerts(r, th) == jnum.check_alerts(r, th)
    events = [{"kind": "numerics_alert", "step": 3,
               "reason": "nonfinite_loss", "value": 1.0}]
    assert numerics_report(recs, events=events, thresholds=th) == \
        jnum.numerics_report(recs, events=events, thresholds=th)


def test_memory_section_on_the_cpu_is_unknown():
    mem = live_memory("cpu")
    assert mem["reported"] is False and mem["peak_frac"] is None
    sec = mem_report(kv_pool={"pool_bytes": 10, "pool_bytes_expected": 10})
    assert sec["verdict"] == "unknown" and sec["programs"] == []
    assert sec["kv_pool"]["accounting_match"] is True


# -------------------------------------------------------- telemetry, report


def _telemetry_report(tmp_path):
    """A port RUNREPORT of a plain function run as a 'step': one compile,
    a recompile, steps, and every optional section the renderers draw."""
    tel = Telemetry(run="plain", device="cpu", tokens_per_step=128,
                    flops_per_token=6e6, peak_flops=1e12,
                    report_path=str(tmp_path / "RUNREPORT.json"),
                    trace_path=str(tmp_path / "trace.json"))
    step = tel.wrap_step(lambda x, w: (x @ w).sum())
    w = torch.ones(8, 8)
    for i in range(6):
        x = torch.ones(4 if i < 4 else 5, 8)
        loss = step(x, w)
        tel.end_step(loss=loss)
    tel.record_counters(pipeline={
        "pipe_size": 4, "num_microbatches": 8, "schedule": "1f1b",
        "bubble_fraction": pipeline_bubble_fraction(8, 4)})
    return tel, tel.finalize(print_summary=False)


def test_wrap_step_spans_and_compile_events(tmp_path):
    tel, rep = _telemetry_report(tmp_path)
    kinds = [e["kind"] for e in tel.events.as_list()]
    assert kinds.count("compile") == 1 and kinds.count("recompile") == 1
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert [r.get("recompiled", False) for r in tel.history] == [
        False, False, False, False, True, False]
    for r in tel.history:
        assert set(r) >= {"span_dispatch_s", "span_device_s",
                          "span_fetch_s", "step_time_s", "t_end_s",
                          "tok_per_sec", "loss"}
        assert r["span_device_s"] >= 0 and isinstance(r["loss"], float)
    assert rep["compile"] == {"count": 2, "time_s": rep["compile"]["time_s"],
                              "recompiles": 1}
    assert rep["backend"] == "cpu" and rep["steps"] == 6
    assert rep["step_time_s"]["n"] == 4  # the first and recompiled out
    assert set(rep["mfu"]) == {"formula_flops_per_step", "formula"}
    assert rep["comm"] == {} and rep["memory"]["programs"] == []
    assert rep["numerics"]["dtype_ledgers"] == []
    on_disk = json.loads((tmp_path / "RUNREPORT.json").read_text())
    assert on_disk["run"] == "plain"
    assert (tmp_path / "RUNREPORT.md").read_text() == render_markdown(
        json.loads(json.dumps(rep, default=str)))


def test_telemetry_without_a_card_refuses_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        Telemetry()


def test_report_validates_under_both_packages(tmp_path):
    _, rep = _telemetry_report(tmp_path)
    rep = json.loads(json.dumps(rep, default=str))
    assert validate_runreport(rep) == []
    assert jrep.validate_runreport(rep) == []


def _full_report(tmp_path):
    """The port's report with every section the renderers draw filled:
    memory with a program row, alerts, comm, compression, autoplan,
    resilience, serving, a two-host view."""
    _, rep = _telemetry_report(tmp_path)
    rep = json.loads(json.dumps(rep, default=str))
    rep["memory"].update(
        reported=True, peak_bytes_in_use=int(3e10), capacity_bytes=int(8e10),
        verdict="ok", verdict_basis="measured", headroom_frac=0.62,
        modeled_peak_bytes=int(2e10),
        kv_pool={"pool_bytes": 4096, "pool_bytes_expected": 4096,
                 "accounting_match": True},
        programs=[{"label": "sig0", "argument_bytes": 10, "output_bytes": 2,
                   "temp_bytes": 3, "alias_bytes": 1,
                   "generated_code_bytes": 4, "peak_estimate_bytes": 18,
                   "n_leaves": 3, "sharded_leaves": 1,
                   "replicated_leaves": 2}])
    rep["numerics"]["alerts"] = {
        "count": 2, "by_reason": {"grad_explosion": 2},
        "first": {"step": 1, "reason": "grad_explosion", "value": 2e3}}
    rep["numerics"]["summary"].update(grad_norm_final=3.5,
                                      grad_norm_mean=2.0, grad_norm_max=9.0)
    rep["hosts"] = {"n_hosts": 2, "straggler": 1, "per_host": [
        {"process": 0, "mean": 0.1, "min": 0.09, "max": 0.2},
        {"process": 1, "mean": 0.3, "min": 0.2, "max": 0.5}]}
    rep["resilience"] = {"verdict": "recovered", "rollbacks": 1,
                         "max_rollbacks": 3, "hang_suspected": 1}
    rep["compression"] = {"mode": "int8", "policy": {
        "n_leaves": 4, "n_compressed": 2}, "per_axis": [
        {"axes": "data", "predicted_bytes": 100, "measured_bytes": 120}]}
    rep["serving"] = {
        "requests": {"completed": 3, "queued": 0, "in_flight": 0,
                     "shed": 1, "expired": 0, "preempted": 2},
        "verdict": "overloaded", "verdict_basis": "shed=1",
        "tokens_per_sec": 100.0, "generated_tokens": 18,
        "ttft_s": {"p50": 0.1, "p95": 0.2, "p99": 0.3},
        "tpot_s": {"p50": 0.01, "p95": 0.02, "p99": 0.03},
        "slot_occupancy": {"mean": 0.5, "num_slots": 3},
        "kv_pool": {"num_blocks": 37, "block_size": 4, "dp_groups": 1,
                    "mean_utilization": 0.25, "peak_utilization": 0.5},
        "slo": {"goodput_tok_s": 50.0, "goodput_tokens": 9,
                "attainment": 0.5, "priorities": {"0": {
                    "completed": 2, "met": 1, "missed": 1, "shed": 1,
                    "expired": 0, "goodput_tokens": 9,
                    "attainment": 0.5}},
                "calibration": {"n": 2, "bias": 0.8, "pending": 0,
                                "priorities": {}}},
        "tick_accounting": {"ticks": 9, "mean_tick_s": 0.004,
                            "phases_mean_s": {"prefill": 0.002,
                                              "decode": 0.001,
                                              "fetch": 0.0}},
        "decode_steps": 7, "prefill_chunks": 3, "decode_signatures": 1}
    return rep


def test_summary_line_and_markdown_byte_equal_jax(tmp_path):
    rep = _full_report(tmp_path)
    assert render_summary_line(rep) == jrep.render_summary_line(rep)
    md = render_markdown(rep)
    assert md == jrep.render_markdown(rep)
    for head in ("## Step time", "## Memory", "## Numerics",
                 "## Compression", "## Resilience", "## Serving",
                 "## Counters", "## Hosts", "## Event timeline"):
        assert head in md


def _break(name):
    def f(rep):
        if name == "missing_key":
            del rep["hosts"]
        elif name == "schema":
            rep["schema"] = "tdp-runreport/v0"
        elif name == "kv_pool_mismatch":
            rep["memory"]["kv_pool"] = {
                "pool_bytes": 8, "pool_bytes_expected": 16,
                "accounting_match": False}
        elif name == "memory_verdict":
            rep["memory"]["verdict"] = "fine"
        elif name == "alerts_count":
            rep["numerics"]["alerts"]["count"] = -1
        elif name == "zb_claim":
            rep["counters"]["pipeline"].update(
                schedule="zb", bubble_fraction=0.5,
                bubble_fraction_1f1b=0.3)
        elif name == "comm":
            rep["comm"] = {"ledger": {}, "verdict": "bound"}
        elif name == "serving_verdict":
            rep["serving"] = {"verdict": "healthy", "requests": {
                "completed": 1, "shed": 2}}
        elif name == "router":
            rep["router"] = {"replicas": []}
        return rep
    return f


@pytest.mark.parametrize("name", [
    "missing_key", "schema", "kv_pool_mismatch", "memory_verdict",
    "alerts_count", "zb_claim", "comm", "serving_verdict", "router"])
def test_malformed_reports_fail_both_validators(tmp_path, name):
    _, rep = _telemetry_report(tmp_path)
    bad = _break(name)(json.loads(json.dumps(rep, default=str)))
    got, want = validate_runreport(bad), jrep.validate_runreport(bad)
    assert got and want
    if name == "kv_pool_mismatch":
        assert any("accounting mismatch" in e for e in got)
    assert got == want or name == "serving_verdict"


def test_event_log_jsonl_equals_jax_shape(tmp_path):
    """The port's and JAX's file-backed logs write the same fields."""
    logs = {"jax": JEventLog(path=str(tmp_path / "j.jsonl")),
            "port": EventLog(path=str(tmp_path / "p.jsonl"))}
    for log in logs.values():
        log.emit("straggler", host=1, ratio=2.0)
    j, p = (json.loads((tmp_path / f).read_text())
            for f in ("j.jsonl", "p.jsonl"))
    assert set(j) == set(p) and j["kind"] == p["kind"] == "straggler"
