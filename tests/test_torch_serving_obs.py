"""The engine's observability on the CPU, against the JAX engine's: one
JAX engine and one port engine, each with a ``Telemetry`` and a JSONL
metrics sink, serve the same staggered greedy requests (weights from
JAX's init through ``params_from_jax``), and

- the tokens are equal;
- every tick record's fields that do not read the clock (tick, queue
  depth, busy / prefill / decode slots, admitted, expired, batch and
  pool utilisation, emitted tokens, hit and accept rates) and every
  ``engine_tick`` event's rid lists are equal tick for tick, and so are
  the metrics sinks' records;
- each request's lifecycle ``sequence`` rebuilt from the timeline is
  equal, and every record validates;
- on every port record the named phases plus ``host`` make ``tick_s``;
- JAX's and the port's assembly, Perfetto rendering and phase table
  give the same answer on the port's own event list;
- ``serving_summary()['tick_accounting']`` has JAX's keys;
- telemetry changes nothing: the decode step is one signature and no
  ``recompile``;
- a ``slot_stall`` past the watchdog's timeout puts ``hang_suspected``
  and ``hang_abort`` (the exit hook replaced) on the timeline, and the
  requests still finish.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.models import llama_config as jllama
from torchdistpackage_tpu.obs import Telemetry as JTelemetry
from torchdistpackage_tpu.obs.events import \
    set_default_event_log as jset_default_log
from torchdistpackage_tpu.obs.exporters import JsonlSink as JJsonlSink
from torchdistpackage_tpu.serving import Request as JRequest
from torchdistpackage_tpu.serving import ServingEngine as JEngine
from torchdistpackage_tpu.serving import tracing as jtr
from torchdistpackage_tpu_torch.models import llama_config
from torchdistpackage_tpu_torch.models.convert import params_from_jax
from torchdistpackage_tpu_torch.obs import (
    JsonlSink,
    Telemetry,
    set_default_event_log,
)
from torchdistpackage_tpu_torch.resilience import ChaosMonkey, Fault, Watchdog
from torchdistpackage_tpu_torch.serving import Request, ServingEngine
from torchdistpackage_tpu_torch.serving import tracing as ttr

SMALL = dict(vocab_size=64, dim=64, nheads=4, nlayers=2, max_seq=64,
             kv_heads=2, ffn_hidden=96, sliding_window=6)
ENGINE = dict(num_slots=3, block_size=4, chunk=8, max_ctx=48)
PROMPTS = ((5, 6), (13, 4), (20, 7), (9, 5))  # (prompt length, new tokens)
#: tick-record fields that do not read the host clock
TICK_FIELDS = ("tick", "queue_depth", "busy", "admitted", "expired",
               "prefill_slots", "decode_slots", "batch_util", "pool_util",
               "emitted_tokens", "prefix_hit_rate", "spec_accept_rate")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(make):
    rs = np.random.RandomState(0)
    return [make(rs.randint(0, SMALL["vocab_size"], n).tolist(), m)
            for n, m in PROMPTS]


def _serve(eng, reqs):
    """Request 0 runs two ticks alone, then the rest arrive (one queues)."""
    rids = [eng.submit(reqs[0])]
    eng.step()
    eng.step()
    rids += [eng.submit(r) for r in reqs[1:]]
    eng.run_until_idle(max_ticks=500)
    return [np.asarray(eng.finished[r]["tokens"]) for r in rids]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving_obs")
    jcfg = jllama(**SMALL, dtype=jnp.float32)
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    jtel = JTelemetry(run="jax", report_path="", trace_path="")
    try:
        jeng = JEngine(jparams, jcfg, attn_impl="gather", telemetry=jtel,
                       metrics_sink=JJsonlSink(str(d / "jax.jsonl")),
                       **ENGINE)
        jtok = _serve(jeng, _requests(JRequest))
    finally:
        jset_default_log(None)
    tcfg = llama_config(**SMALL, dtype=torch.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    tel = Telemetry(run="port", device="cpu", report_path="",
                    trace_path="")
    try:
        eng = ServingEngine(tparams, tcfg, device="cpu", telemetry=tel,
                            metrics_sink=JsonlSink(str(d / "port.jsonl")),
                            **ENGINE)
        tok = _serve(eng, _requests(Request))
    finally:
        set_default_event_log(None)
    return {"jax": {"eng": jeng, "tel": jtel, "tok": jtok,
                    "ev": jtel.events.as_list(),
                    "sink": (d / "jax.jsonl").read_text()},
            "port": {"eng": eng, "tel": tel, "tok": tok,
                     "ev": tel.events.as_list(),
                     "sink": (d / "port.jsonl").read_text()},
            "tparams": tparams, "tcfg": tcfg}


def test_tokens_equal_jax(runs):
    for i, (w, g) in enumerate(zip(runs["jax"]["tok"], runs["port"]["tok"])):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def test_tick_records_equal_jax_tick_for_tick(runs):
    want = [{k: r[k] for k in TICK_FIELDS}
            for r in runs["jax"]["eng"].tick_records]
    got = [{k: r[k] for k in TICK_FIELDS}
           for r in runs["port"]["eng"].tick_records]
    assert got == want and len(got) > 5
    assert any(r["queue_depth"] for r in got)


def test_engine_tick_rid_lists_equal_jax(runs):
    def rids(ev):
        return [(e["tick"], e["prefill_rids"], e["decode_rids"])
                for e in ev if e["kind"] == "engine_tick"]
    assert rids(runs["port"]["ev"]) == rids(runs["jax"]["ev"])


def test_metrics_sink_records_equal_jax(runs):
    def recs(text):
        out = []
        for ln in text.splitlines():
            r = json.loads(ln)
            out.append({k: v for k, v in r.items()
                        if k != "tick_s" and not k.startswith("phase_")})
            assert set(r) >= {f"phase_{p}_s" for p in ttr.TICK_PHASES}
        return out
    got, want = recs(runs["port"]["sink"]), recs(runs["jax"]["sink"])
    assert got == want and got[0]["schema"] == ttr.SERVING_METRICS_SCHEMA
    assert len(got) == runs["port"]["eng"]._tick


def test_lifecycles_rebuild_and_equal_jax(runs):
    def seqs(ev, mod):
        recs = mod.assemble_request_timelines(ev)
        for r in recs:
            assert mod.validate_request_record(r) == []
        return [(r["uid"], mod.lifecycle_phases(r)) for r in recs]
    got = seqs(runs["port"]["ev"], ttr)
    assert got == seqs(runs["jax"]["ev"], jtr)
    assert [s for _, s in got] == [
        ["queued", "admitted", "prefill", "decode", "retired"]] * 4


def test_phases_account_for_every_tick(runs):
    for r in runs["port"]["eng"].tick_records:
        assert set(r["phases"]) == set(ttr.TICK_PHASES)
        assert min(r["phases"].values()) >= 0
        assert abs(sum(r["phases"].values()) - r["tick_s"]) < 1e-6
    decode_ticks = [r for r in runs["port"]["eng"].tick_records
                    if r["decode_slots"]]
    assert all(r["phases"]["decode"] > 0 for r in decode_ticks)


def test_tracing_functions_agree_with_jax_on_port_events(runs):
    ev = runs["port"]["ev"]
    assert ttr.assemble_request_timelines(ev) == \
        jtr.assemble_request_timelines(ev)
    for name in ("request_trace_events", "tick_trace_events",
                 "serving_trace_events"):
        got = getattr(ttr, name)(ev, process=3)
        assert got == getattr(jtr, name)(ev, process=3) and got
    assert ttr.phase_table(ev) == jtr.phase_table(ev)
    tick = next(e for e in ev if e["kind"] == "engine_tick")
    assert ttr.serving_metrics_record(tick) == jtr.serving_metrics_record(
        tick)


def test_tick_accounting_has_jax_keys(runs):
    got = runs["port"]["eng"].serving_summary()["tick_accounting"]
    want = runs["jax"]["eng"].serving_summary()["tick_accounting"]
    assert set(got) == set(want) and got["ticks"] == want["ticks"]
    assert set(got["phases_mean_s"]) == set(want["phases_mean_s"])


def test_telemetry_changes_no_signature(runs):
    eng, tel = runs["port"]["eng"], runs["port"]["tel"]
    s = eng.serving_summary()
    assert s["decode_signatures"] == 1
    kinds = [e["kind"] for e in runs["port"]["ev"]]
    assert kinds.count("compile") == 1 and "recompile" not in kinds
    assert len(tel.history) == s["decode_steps"]
    assert all(r["active_slots"] >= 1 for r in tel.history)


def test_slot_stall_trips_the_watchdog(runs):
    exits = []
    tel = Telemetry(run="stall", device="cpu", report_path="",
                    trace_path="")
    dog = Watchdog(timeout_s=0.2, poll_s=0.02, abort=True,
                   abort_grace_s=0.2, _exit=exits.append)
    monkey = ChaosMonkey([Fault("slot_stall", step=3, duration_s=0.8)])
    try:
        with dog:
            eng = ServingEngine(runs["tparams"], runs["tcfg"], device="cpu",
                                telemetry=tel, watchdog=dog, chaos=monkey,
                                **ENGINE)
            rids = [eng.submit(r) for r in _requests(Request)]
            eng.run_until_idle(max_ticks=500)
    finally:
        set_default_event_log(None)
    kinds = [e["kind"] for e in tel.events.as_list()]
    assert exits == [87]
    assert kinds.index("fault_injected") < kinds.index("hang_suspected") \
        < kinds.index("hang_abort")
    sus = tel.events.of_kind("hang_suspected")[0]
    assert sus["last_step"] == 2 and sus["will_abort"]
    assert all(eng.finished[r]["reason"] == "max_tokens" for r in rids)
