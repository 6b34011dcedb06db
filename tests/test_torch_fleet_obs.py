"""The fleet's observability on the CPU, against the JAX package's: a
``Router(telemetry=)`` over a prefill and a decode replica (host-only
``StubDeviceStep`` engines in both packages: the same scheduler and
allocator, no model) serves the same greedy requests, and

- the FLEETREPORT (``Telemetry.record_router`` + ``finalize``) passes
  both packages' ``validate_runreport``, its ``router`` section and its
  one-line summary included, and renders the same markdown under both;
- the router's and the engines' events share the telemetry's timeline,
  every engine event tagged with its replica;
- every request reconstructs as one journey spanning both replicas,
  and the journeys (hops, sequences, outcomes) equal the JAX fleet's;
- JAX's and the port's ``assemble_fleet_request_timelines`` and
  ``fleet_trace_events`` give the same answer on the port's events,
  and the trace passes both ``validate_trace``;
- a planted contradiction (a 'balanced' verdict under a degraded
  fleet) fails both validators.

Nothing here reads the host clock for a decision: one submit and one
import target.
"""

import json

import numpy as np
import pytest

from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.obs import Telemetry as JTelemetry
from torchdistpackage_tpu.obs import report as jrep
from torchdistpackage_tpu.obs import trace as jtrace
from torchdistpackage_tpu.obs.events import \
    set_default_event_log as jset_default_log
from torchdistpackage_tpu.serving import Request as JRequest
from torchdistpackage_tpu.serving import Router as JRouter
from torchdistpackage_tpu.serving import ServingEngine as JEngine
from torchdistpackage_tpu.serving import StubDeviceStep as JStub
from torchdistpackage_tpu.serving import tracing as jtr
from torchdistpackage_tpu_torch.models import GPTConfig
from torchdistpackage_tpu_torch.obs import (
    Telemetry,
    render_markdown,
    render_summary_line,
    set_default_event_log,
    validate_runreport,
    validate_trace,
)
from torchdistpackage_tpu_torch.serving import (
    ROUTER_EVENT_KINDS,
    Request,
    Router,
    ServingEngine,
    StubDeviceStep,
)
from torchdistpackage_tpu_torch.serving import tracing as ttr

SMALL = dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=64)
ENGINE = dict(num_slots=3, block_size=4, chunk=4, prefix_cache=True)
N = 6


def _prompts():
    rs = np.random.RandomState(5)
    return [rs.randint(0, SMALL["vocab_size"], int(n)).tolist()
            for n in rs.randint(5, 14, N)]


def _drive(router, make):
    rids = [router.submit(make(p, 4)) for p in _prompts()]
    ticks = 0
    while router.has_work():
        router.step()
        ticks += 1
        assert ticks < 500
    return rids


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet_obs")
    jtel = JTelemetry(run="jax-fleet", report_path="", trace_path="")
    try:
        jcfg = JGPTConfig(**SMALL)
        jengs = [JEngine(None, jcfg, device_step=JStub(), **ENGINE)
                 for _ in range(2)]
        jr = JRouter(jengs, roles=["prefill", "decode"], telemetry=jtel)
        jrids = _drive(jr, JRequest)
        jtel.record_router(jr.summary())
        jrep_ = jtel.finalize(write=False, print_summary=False)
    finally:
        jset_default_log(None)
    tel = Telemetry(run="fleet", device="cpu",
                    report_path=str(d / "FLEETREPORT.json"),
                    trace_path=str(d / "fleet_trace.json"))
    try:
        cfg = GPTConfig(**SMALL)
        engs = [ServingEngine(None, cfg, device_step=StubDeviceStep(),
                              **ENGINE) for _ in range(2)]
        router = Router(engs, roles=["prefill", "decode"], telemetry=tel)
        rids = _drive(router, Request)
        tel.record_router(router.summary())
        rep = tel.finalize(print_summary=False)
    finally:
        set_default_event_log(None)
    return {"jax": {"router": jr, "rids": jrids, "report": jrep_,
                    "ev": jtel.events.as_list()},
            "port": {"router": router, "rids": rids, "report": rep,
                     "tel": tel, "ev": tel.events.as_list(),
                     "file": json.loads(
                         (d / "FLEETREPORT.json").read_text()),
                     "md": (d / "FLEETREPORT.md").read_text(),
                     "trace": json.loads(
                         (d / "fleet_trace.json").read_text())}}


def test_fleetreport_validates_under_both(fleets):
    rep = fleets["port"]["file"]
    assert validate_runreport(rep) == []
    assert jrep.validate_runreport(rep) == []
    fleet = rep["router"]["fleet"]
    assert fleet["n_replicas"] == 2 and fleet["migrations"]["handoffs"] == N
    assert render_summary_line(rep) == jrep.render_summary_line(rep)
    assert fleets["port"]["md"] == render_markdown(rep) == \
        jrep.render_markdown(rep)
    assert "## Router fleet" in fleets["port"]["md"]


def test_tokens_and_tiers_equal_jax(fleets):
    jr, tr = fleets["jax"]["router"], fleets["port"]["router"]
    for jrid, rid in zip(fleets["jax"]["rids"], fleets["port"]["rids"]):
        np.testing.assert_array_equal(tr.finished[rid]["tokens"],
                                      jr.finished[jrid]["tokens"])
    jm = fleets["jax"]["report"]["router"]["fleet"]["migrations"]
    tm = fleets["port"]["report"]["router"]["fleet"]["migrations"]
    assert {k: tm[k] for k in ("handoffs", "blocks", "bytes")} == \
        {k: jm[k] for k in ("handoffs", "blocks", "bytes")}


def test_one_timeline_replica_tagged(fleets):
    ev = fleets["port"]["ev"]
    assert {e["replica"] for e in ev
            if e["kind"] == "request_admitted"} == {0}
    assert {e["replica"] for e in ev
            if e["kind"] == "request_imported"} == {1}
    assert any(e["kind"] in ROUTER_EVENT_KINDS for e in ev)
    assert fleets["port"]["router"]._ev is fleets["port"]["tel"].events


def test_every_request_is_one_journey_across_both_replicas(fleets):
    def journeys(ev, mod):
        out = mod.assemble_fleet_request_timelines(ev)["journeys"]
        return [(j["rid"], [h["replica"] for h in j["hops"]],
                 j["sequence"], j["outcome"]) for j in out]
    got = journeys(fleets["port"]["ev"], ttr)
    assert got == journeys(fleets["jax"]["ev"], jtr)
    assert len(got) == N
    for rid, hops, seq, outcome in got:
        assert hops == [0, 1] and outcome == "retired"
        assert seq == ["@replica0", "queued", "admitted", "prefill",
                       "exported", "@replica1", "imported", "decode",
                       "retired"]


def test_stitching_and_trace_agree_with_jax_on_port_events(fleets):
    ev = fleets["port"]["ev"]
    assert ttr.assemble_fleet_request_timelines(ev) == \
        jtr.assemble_fleet_request_timelines(ev)
    got = ttr.fleet_trace_events(ev)
    assert got == jtr.fleet_trace_events(ev)
    t0 = min(e["t_mono"] for e in ev)  # the dispatch seam, one axis
    assert ttr.serving_trace_events(ev, t0=t0) == \
        ttr.fleet_trace_events(ev, t0=t0)
    for obj in (got, fleets["port"]["trace"]):
        assert validate_trace(obj) == [] and jtrace.validate_trace(obj) == []
    pids = {e["pid"] for e in fleets["port"]["trace"]["traceEvents"]}
    assert {ttr.ROUTER_PID, ttr.fleet_pid(0), ttr.fleet_pid(1)} <= pids
    migrate = [e for e in got if e.get("name") == "migrate"]
    assert len(migrate) == 2 * N


def test_a_contradicted_fleet_report_fails_both(fleets):
    bad = json.loads(json.dumps(fleets["port"]["file"]))
    fleet = bad["router"]["fleet"]
    fleet["verdict"] = "degraded"
    fleet["balance"]["verdict"] = "balanced"
    for validate in (validate_runreport, jrep.validate_runreport):
        errs = validate(bad)
        assert any("contradicts fleet verdict" in e for e in errs), errs
