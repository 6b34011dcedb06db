"""The port's Router over port engines on the CPU, against the JAX
package: prefix-affinity routing and the shed fall-through, the
prefill -> decode handoff (cold and warm), rebalance, evacuation after an
engine fault, migration pricing, ``migrate_blocks``, the validators, the
grouped-replica refusal, and the engine's four chaos kinds.

The shapes are the JAX tests' (``tests/test_serving_router.py``): GPT
vocab 64, dim 32, 4 heads, 2 layers, max_seq 64, f32; blocks of 4,
chunk 4, 3 slots; the weights JAX's init through ``params_from_jax``.

Held exactly:

- greedy tokens against JAX's jitted ``generate`` golden, in every
  scenario on real port engines; a sampled request's tokens against one
  port engine serving it alone (its stream travels in the descriptor);
- what decides without the host clock, against the JAX Router over JAX
  ``StubDeviceStep`` engines on the same requests: the placements
  decided by affinity (replica and affinity tokens), the handoff
  targets, the migrated and shared block counts and wire bytes
  (``blocks_migrated``), the compression decisions and their basis, the
  rebalance and evacuation counts;
- ``Router.audit()`` after every tick and ``_validate_router`` on every
  summary.

Excluded, because they read the host clock: ``est_ttft_s`` in the
candidate tables and ``request_routed``, the placement of traffic no
replica holds a prefix of (it ranks on the TTFT estimate), tokens/s,
TTFT / TPOT, goodput and the calibration bias.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import generate as jgenerate
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.obs.comm_model import AxisCost as JAxisCost
from torchdistpackage_tpu.obs.comm_model import CommModel as JCommModel
from torchdistpackage_tpu.obs.events import EventLog as JEventLog
from torchdistpackage_tpu.obs.events import \
    set_default_event_log as jset_default_log
from torchdistpackage_tpu.resilience import ChaosMonkey as JChaosMonkey
from torchdistpackage_tpu.resilience import Fault as JFault
from torchdistpackage_tpu.serving import Request as JRequest
from torchdistpackage_tpu.serving import Router as JRouter
from torchdistpackage_tpu.serving import ServingEngine as JEngine
from torchdistpackage_tpu.serving import StubDeviceStep as JStub
from torchdistpackage_tpu.serving import init_paged_kv as jinit_paged_kv
from torchdistpackage_tpu.serving import migrate_blocks as jmigrate_blocks
from torchdistpackage_tpu_torch.models import GPTConfig
from torchdistpackage_tpu_torch.models.convert import params_from_jax
from torchdistpackage_tpu_torch.obs import AxisCost, CommModel
from torchdistpackage_tpu_torch.obs.events import (
    EventLog,
    set_default_event_log,
)
from torchdistpackage_tpu_torch.obs.report import _validate_router
from torchdistpackage_tpu_torch.resilience import (
    ENGINE_FAULT_KINDS,
    ChaosMonkey,
    Fault,
)
from torchdistpackage_tpu_torch.serving import (
    ROLES,
    Request,
    Router,
    ServingEngine,
    StubDeviceStep,
    init_paged_kv,
    migrate_blocks,
    migration_wire_bytes,
)
from torchdistpackage_tpu_torch.serving.autoscale import Autoscaler

SMALL = dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=64)
JCFG = JGPTConfig(**SMALL)
CFG = GPTConfig(**SMALL, dtype=torch.float32)
PROMPT, NEW, BS = 9, 6, 4
ENGINE = dict(num_slots=3, block_size=BS, chunk=4, prefix_cache=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the tiny models: several test processes
    share the cores, and spinning thread pools slow each one many
    times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fleet():
    """JAX's weights (and the port's copy), the JAX tests' four prompts,
    the warm-handoff and rebalance prompts, and one jitted ``generate``
    golden for all twelve."""
    jparams = jinit(jax.random.PRNGKey(0), JCFG)
    prompts = [np.asarray(jax.random.randint(
        jax.random.PRNGKey(20 + i), (PROMPT,), 0, SMALL["vocab_size"]))
        .astype(np.int32).tolist() for i in range(4)]
    shared = prompts[0][:8]  # two full blocks
    warm = [shared + [1], shared + [2]]
    reb = [shared + [i] for i in range(6)]
    rows = prompts + warm + reb
    want = np.asarray(jax.jit(
        lambda p, t: jgenerate(p, t, JCFG, max_new_tokens=NEW)
    )(jparams, np.asarray(rows, np.int32)))
    golden = {tuple(r): w for r, w in zip(rows, want)}
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), CFG,
                              device="cpu")
    return {"params": tparams, "prompts": prompts, "warm": warm,
            "reb": reb, "golden": golden}


def _port_engine(params, **kw):
    return ServingEngine(params, CFG, device="cpu", **{**ENGINE, **kw})


def _stub_engine(**kw):
    return ServingEngine(None, CFG, device_step=StubDeviceStep(),
                         **{**ENGINE, **kw})


def _jax_stub_engine(**kw):
    return JEngine(None, JCFG, device_step=JStub(), **{**ENGINE, **kw})


def _run(router, max_ticks=400):
    """Drain the fleet with the cross-replica audit green after every
    tick."""
    ticks = 0
    while router.has_work():
        router.step()
        rep = router.audit()
        assert rep["ok"], (ticks, rep["violations"])
        ticks += 1
        assert ticks < max_ticks, "fleet wedged"
    return ticks


def _fleet(make, log_cls, set_log, scenario, n=2, **router_kw):
    """``scenario(router, Req, engines)`` on a fresh fleet of ``n``
    engines from ``make`` with its own event log; returns (router, log,
    whatever the scenario returned)."""
    log = log_cls()
    set_log(log)
    try:
        engines = [make() for _ in range(n)]
        router = (JRouter if log_cls is JEventLog else Router)(
            engines, **router_kw)
        out = scenario(router, JRequest if log_cls is JEventLog
                       else Request, engines)
    finally:
        set_log(None)
    return router, log, out


def _port(fleet, scenario, **kw):
    return _fleet(lambda: _port_engine(fleet["params"]), EventLog,
                  set_default_event_log, scenario, **kw)


def _jax_stub(scenario, **kw):
    return _fleet(_jax_stub_engine, JEventLog, jset_default_log, scenario,
                  **kw)


def _kind(log, kind):
    return [e for e in log.as_list() if e["kind"] == kind]


def _migrations(log):
    return [(e["src_replica"], e["dst_replica"], e["n_blocks"],
             e["n_shared"], e["bytes"], e["compressed"], e["dcn"],
             e["basis"]) for e in _kind(log, "blocks_migrated")]


def _handoffs(log):
    return [(e["src_replica"], e["outcome"], e["chosen"], e["need_blocks"])
            for e in _kind(log, "handoff_decision")]


def _golden(fleet, router, rids, rows):
    for rid, row in zip(rids, rows):
        np.testing.assert_array_equal(
            router.finished[rid]["tokens"], fleet["golden"][tuple(row)],
            err_msg=f"router rid {rid}")


# ------------------------------------------------------ migrate_blocks


def test_migrate_blocks_unit_matches_jax():
    """The cross-pool copy against JAX's on the same pools: fp and int8
    pools bit-exact, the int8 wire of an fp pool within JAX's bound of
    the source, NULL pad lanes harmless."""
    rs = np.random.RandomState(1)
    jsrc = {k: rs.randn(*v.shape).astype(np.float32)
            for k, v in jinit_paged_kv(JCFG, 8, BS).items()}
    jdst = {k: np.array(v) for k, v in jinit_paged_kv(JCFG, 8, BS).items()}
    for v in jdst.values():
        v[:, 5] = 7.0
    lanes_src = np.zeros(4, np.int32)
    lanes_dst = np.zeros(4, np.int32)
    lanes_src[:2], lanes_dst[:2] = [2, 3], [4, 6]
    t = lambda d: {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    for compress in (False, True):
        want = jmigrate_blocks(
            {k: jax.numpy.asarray(v) for k, v in jsrc.items()},
            {k: jax.numpy.asarray(v) for k, v in jdst.items()},
            lanes_src, lanes_dst, compress=compress)
        got = migrate_blocks(t(jsrc), t(jdst), lanes_src, lanes_dst,
                             compress=compress)
        for k in ("k", "v"):
            g, w = got[k].numpy(), np.asarray(want[k])
            if compress:
                ref = jsrc[k][:, [2, 3]]
                amax = np.abs(ref).max(axis=-1, keepdims=True)
                assert np.all(np.abs(g[:, [4, 6]] - ref)
                              <= amax / 127.0 + 1e-7)
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g[:, 5], jdst[k][:, 5])
    assert migration_wire_bytes(CFG, 2, BS, compressed=True) < \
        migration_wire_bytes(CFG, 2, BS)
    # an int8 pool is the wire format: its pairs copy bit-exactly
    src_q = init_paged_kv(CFG, 8, BS, quantized=True, device="cpu")
    src_q = {k: (torch.from_numpy(rs.randint(-5, 5, q.shape)).to(torch.int8),
                 torch.from_numpy(rs.rand(*s.shape).astype(np.float32)))
             for k, (q, s) in src_q.items()}
    for flag in (False, True):
        out = migrate_blocks(
            src_q, init_paged_kv(CFG, 8, BS, quantized=True, device="cpu"),
            lanes_src, lanes_dst, compress=flag)
        for j in (0, 1):
            assert torch.equal(out["k"][j][:, 4], src_q["k"][j][:, 2])


# --------------------------------------------------- routing and fallback


def _affinity_scenario(router, Req, engines):
    """Warm each replica with a different prompt, then send each warm
    prompt again; the third submit finds its owner's queue full."""
    p = _affinity_scenario.prompts
    wa = router.submit(Req(p[0], 2))
    router.run_until_idle()
    where_a = router.finished[wa]["replica"]
    router.alive[where_a] = False
    wb = router.submit(Req(p[1], 2))
    router.run_until_idle()
    router.alive[where_a] = True
    router.reset_metrics()
    ra = router.submit(Req(p[0], NEW))
    rb = router.submit(Req(p[1], NEW))
    _run(router)
    pref = router.replicas[where_a]
    pref.max_queue = 1
    pref.queue = [(Req(p[2], NEW, rid=900), 0.0)]
    pref._seq[900] = 900
    rc = router.submit(Req(p[0], NEW))
    pref.queue.clear()
    pref.max_queue = None
    _run(router)
    return {"where_a": where_a, "rids": (ra, rb, rc), "warm": (wa, wb)}


def test_affinity_routing_and_shed_fallback(fleet):
    """Warm traffic routes to its prefix owner, a shedding owner falls
    through to the next, and the placements, affinity tokens and
    fall-through ranks equal the JAX Router's."""
    _affinity_scenario.prompts = fleet["prompts"]
    router, log, out = _port(fleet, _affinity_scenario)
    _, jlog, jout = _jax_stub(_affinity_scenario)
    ra, rb, rc = out["rids"]
    _golden(fleet, router, (ra, rb, rc), [fleet["prompts"][i]
                                          for i in (0, 1, 0)])
    routed = {e["rid"]: e for e in _kind(log, "request_routed")}
    assert routed[ra]["replica"] == out["where_a"]
    assert routed[ra]["affinity_tokens"] > 0
    assert routed[rb]["replica"] != out["where_a"]
    assert routed[rc]["fallback_rank"] > 0 and rc not in router.rejected
    s = router.summary()
    aff = s["fleet"]["affinity"]
    assert (aff["routed"], aff["affinity_routed"], aff["fallbacks"]) == \
        (3, 2, 1)
    assert _validate_router(s) == []

    def placed(lg, rids):
        ev = {e["rid"]: e for e in _kind(lg, "request_routed")}
        return [(ev[r]["replica"], ev[r]["affinity_tokens"],
                 ev[r]["fallback_rank"]) for r in rids]
    assert placed(log, out["rids"]) == placed(jlog, jout["rids"])
    assert out["where_a"] == jout["where_a"]


# ------------------------------------------------ disaggregated handoff


def _handoff_scenario(router, Req, engines):
    p = _handoff_scenario.prompts
    rids = [router.submit(Req(p[i], NEW)) for i in range(3)]
    rs = router.submit(Req(p[3], NEW, temperature=1.0, top_k=16, seed=7))
    _run(router)
    return rids, rs


def test_prefill_decode_handoff(fleet):
    """Three greedy requests and one sampled through a prefill and a
    decode replica: greedy tokens equal JAX's golden, the sampled one
    equals one port engine serving it (its stream travels), the tiers
    stay apart, and the handoff targets, block counts and bytes equal
    the JAX Router's."""
    p = fleet["prompts"]
    solo = _port_engine(fleet["params"])
    r0 = solo.submit(Request(p[3], NEW, temperature=1.0, top_k=16, seed=7))
    solo.run_until_idle()
    _handoff_scenario.prompts = p
    router, log, (rids, rs) = _port(fleet, _handoff_scenario,
                                    roles=["prefill", "decode"])
    jrouter, jlog, _ = _jax_stub(_handoff_scenario,
                                 roles=["prefill", "decode"])
    _golden(fleet, router, rids, p[:3])
    np.testing.assert_array_equal(router.finished[rs]["tokens"],
                                  solo.finished[r0]["tokens"])
    assert all(router.finished[r]["replica"] == 1 for r in rids + [rs])
    a, b = router.replicas
    assert a.stats["decode_steps"] == 0 and a.stats["prefill_chunks"] > 0
    assert b.stats["prefill_chunks"] == 0 and b.stats["decode_steps"] > 0
    assert a.serving_summary()["requests"]["migrated_out"] == 4
    assert b.serving_summary()["requests"]["migrated_in"] == 4
    s = router.summary()
    mig = s["fleet"]["migrations"]
    assert mig["handoffs"] == 4 and mig["blocks"] > 0 and mig["bytes"] > 0
    assert mig["signatures"] == 1
    assert mig["bytes"] == migration_wire_bytes(CFG, mig["blocks"], BS)
    assert _validate_router(s) == []
    assert _migrations(log) == _migrations(jlog)
    assert _handoffs(log) == _handoffs(jlog)
    assert mig == {k: v for k, v in jrouter.summary()["fleet"][
        "migrations"].items() if k in mig}


def _warm_scenario(router, Req, engines):
    out = []
    for r in _warm_scenario.rows:
        out.append(router.submit(Req(r, NEW)))
        _run(router)
    return out


def test_warm_handoff_ships_only_the_tail(fleet):
    """The second same-prefix handoff shares the two prefix blocks the
    first registered on the decode replica and ships only the tail."""
    _warm_scenario.rows = fleet["warm"]
    router, log, rids = _port(fleet, _warm_scenario,
                              roles=["prefill", "decode"])
    _, jlog, _ = _jax_stub(_warm_scenario, roles=["prefill", "decode"])
    _golden(fleet, router, rids, fleet["warm"])
    first, second = _kind(log, "blocks_migrated")
    assert first["n_shared"] == 0 and second["n_shared"] == 2
    assert second["bytes"] < first["bytes"]
    assert router.replicas[0].stats["prefix_hits"] >= 1
    assert _migrations(log) == _migrations(jlog)


# ----------------------------------------------- rebalance and evacuation


def _rebalance_scenario(router, Req, engines):
    w = router.submit(Req(_rebalance_scenario.prompt, 2))
    router.run_until_idle()
    pinned = router.finished[w]["replica"]
    router.reset_metrics()
    rids = [router.submit(Req(r, NEW)) for r in _rebalance_scenario.rows]
    _run(router)
    return pinned, rids


def test_rebalance_moves_queue_with_exact_tokens(fleet):
    """Six same-prefix requests pile on the warm replica; the watermark
    scan moves queued ones to the idle peer by drain descriptors.
    Tokens equal JAX's golden; the rebalance counts equal the JAX
    Router's."""
    _rebalance_scenario.prompt = fleet["prompts"][0]
    _rebalance_scenario.rows = fleet["reb"]
    kw = dict(rebalance_every=1, rebalance_watermark=1)
    router, log, (pinned, rids) = _port(fleet, _rebalance_scenario, **kw)
    jrouter, jlog, (jpinned, _) = _jax_stub(_rebalance_scenario, **kw)
    _golden(fleet, router, rids, fleet["reb"])
    s = router.summary()
    assert s["fleet"]["rebalances"] >= 1
    assert router.replicas[1 - pinned].stats["generated_tokens"] > 0
    moved = [e for e in _kind(log, "request_migrated")
             if e["mode"] == "rebalance"]
    assert moved and all(e["src_replica"] == pinned for e in moved)
    assert _validate_router(s) == []
    js = jrouter.summary()["fleet"]
    assert pinned == jpinned
    assert (s["fleet"]["rebalances"], s["fleet"]["rebalanced_requests"]) \
        == (js["rebalances"], js["rebalanced_requests"])
    assert [(e["trigger"], e["stolen"], e["moved"])
            for e in _kind(log, "rebalance_decision")] == \
        [(e["trigger"], e["stolen"], e["moved"])
         for e in _kind(jlog, "rebalance_decision")]


def _evacuate_scenario(router, Req, engines):
    router.alive[1] = False
    rids = [router.submit(Req(p, NEW)) for p in _evacuate_scenario.rows]
    router.alive[1] = True
    _run(router)
    return rids


def test_engine_fault_evacuates_to_survivor(fleet):
    """A ``table_corrupt`` fault on replica 0 mid-decode: the router
    evacuates it and the survivor finishes both requests with JAX's
    golden tokens; the evacuation counts equal the JAX Router's."""
    _evacuate_scenario.rows = fleet["prompts"][:2]

    def chaotic(make, monkey_cls, fault_cls):
        engines = []

        def mk():
            e = make()
            if not engines:
                e.chaos = monkey_cls(
                    faults=[fault_cls("table_corrupt", step=4, slot=0)])
            engines.append(e)
            return e
        return mk, engines

    mk, made = chaotic(lambda: _port_engine(fleet["params"]), ChaosMonkey,
                       Fault)
    router, log, rids = _fleet(mk, EventLog, set_default_event_log,
                               _evacuate_scenario, evacuate_on_fault=True)
    jmk, jmade = chaotic(_jax_stub_engine, JChaosMonkey, JFault)
    jrouter, jlog, _ = _fleet(jmk, JEventLog, jset_default_log,
                              _evacuate_scenario, evacuate_on_fault=True)
    assert made[0].chaos.fired_count == 1
    _golden(fleet, router, rids, fleet["prompts"][:2])
    assert all(router.finished[r]["replica"] == 1 for r in rids)
    assert router.alive == [False, True] == jrouter.alive
    s = router.summary()
    assert s["fleet"]["verdict"] == "degraded" and s["fleet"]["n_alive"] == 1
    assert _validate_router(s) == []
    js = jrouter.summary()["fleet"]
    assert (s["fleet"]["evacuations"], s["fleet"]["evacuated_requests"]) \
        == (js["evacuations"], js["evacuated_requests"]) == (1, 2)
    assert {e["mode"] for e in _kind(log, "request_migrated")} == \
        {"evacuation"}


# ------------------------------------------- pricing and the validators


def _pricing_scenario(router, Req, engines):
    rid = router.submit(Req(_pricing_scenario.prompt, NEW))
    _run(router)
    return rid


@pytest.mark.parametrize("leg", ["approved", "refused"])
def test_dcn_migration_pricing(fleet, leg):
    """A zone-crossing handoff priced through ``predict_compressed``:
    an approving model ships the int8 wire (its bytes), an
    alpha-dominated one stays exact; the decision, the bytes and the
    basis equal the JAX Router's.  Tokens: the exact wire equals JAX's
    golden; the int8 wire still serves every token."""
    alpha, beta = (1e-3, 1e9) if leg == "approved" else (1.0, float("inf"))
    _pricing_scenario.prompt = fleet["prompts"][1]
    mk = lambda cls, ax: cls(  # noqa: E731
        axis_costs={"dcn": ax(alpha, beta, "calibrated")},
        compressed_axis_costs={"dcn": ax(alpha, beta, "calibrated")})
    kw = dict(roles=["prefill", "decode"], zones=["east", "west"])
    router, log, rid = _port(fleet, _pricing_scenario,
                             comm_model=mk(CommModel, AxisCost), **kw)
    _, jlog, _ = _jax_stub(_pricing_scenario,
                           comm_model=mk(JCommModel, JAxisCost), **kw)
    (ev,) = _kind(log, "blocks_migrated")
    assert ev["dcn"] and ev["compressed"] == (leg == "approved")
    assert _migrations(log) == _migrations(jlog)
    if leg == "approved":
        assert ev["basis"] == "calibrated-int8"
        assert ev["bytes"] == migration_wire_bytes(
            CFG, ev["n_blocks"], BS, compressed=True)
        assert router.finished[rid]["new_tokens"] == NEW
    else:
        _golden(fleet, router, [rid], [fleet["prompts"][1]])


def test_router_summary_validator_bites():
    """``_validate_router`` passes the real roll-up and bites on the
    corruptions JAX's tests use."""
    prompt = np.random.RandomState(17).randint(0, 64, PROMPT).tolist()
    router = Router([_stub_engine(), _stub_engine()])
    rid = router.submit(Request(prompt, NEW))
    router.run_until_idle()
    assert router.finished[rid]["new_tokens"] == NEW
    s = router.summary()
    assert _validate_router(s) == [] and _validate_router(None) == []

    def bad(patch):
        b = copy.deepcopy(s)
        patch(b)
        return _validate_router(b)
    assert any("goodput" in e for e in bad(
        lambda b: b["fleet"].__setitem__("goodput_tok_s", 1e9)))
    assert any("hit_rate" in e for e in bad(
        lambda b: b["fleet"]["affinity"].__setitem__("hit_rate", 1.5)))
    assert any("verdicts" in e for e in bad(
        lambda b: b["fleet"].__setitem__("verdicts", ["healthy"])))
    assert bad(lambda b: b["replicas"][0].__setitem__("verdict", "on fire"))
    assert any("migrations" in e for e in bad(
        lambda b: b["fleet"].pop("migrations")))
    assert any("contradicts" in e for e in bad(lambda b: (
        b["fleet"].__setitem__("verdict", "degraded"),
        b["fleet"]["balance"].__setitem__("verdict", "balanced"))))
    assert any("balance" in e for e in bad(
        lambda b: b["fleet"]["balance"].__setitem__("verdict", "wobbly")))
    assert bad(lambda b: b["fleet"]["slo"].__setitem__("per_replica", []))
    assert bad(lambda b: b["fleet"]["migrations"].__setitem__("retries",
                                                              -1))


# ------------------------------------- grouped replicas and the clock


def test_router_refuses_clock_placements_with_a_grouped_replica():
    """A replica over a process group (here marked so on a stub engine;
    the two-process CP test builds real ones) refuses two submit
    targets, two import targets and an Autoscaler, naming the clock; one
    prefill and one decode replica pass."""
    def fleet_of(roles):
        engines = [_stub_engine() for _ in roles]
        engines[0]._grouped = True
        return engines
    for roles in (["both", "both"], ["prefill", "decode", "decode"],
                  ["prefill", "prefill", "decode"]):
        with pytest.raises(NotImplementedError, match="host clock"):
            Router(fleet_of(roles), roles=roles)
    router = Router(fleet_of(["prefill", "decode"]),
                    roles=["prefill", "decode"])
    with pytest.raises(NotImplementedError, match="Autoscaler"):
        Autoscaler(router)
    assert ROLES == ("both", "prefill", "decode")


# ---------------------------------------------- the engine's chaos kinds


@pytest.mark.parametrize("kind", ENGINE_FAULT_KINDS)
def test_engine_chaos_kind_is_healed(fleet, kind):
    """Each engine fault kind at tick 4 (mid-decode) on a port engine
    serving three requests: detected and healed (``slot_stall`` only
    sleeps), and every request's tokens equal JAX's golden."""
    eng = _port_engine(fleet["params"], prefix_cache=False)
    eng.chaos = ChaosMonkey(faults=[Fault(kind, step=4, slot=1,
                                          duration_s=0.01)])
    rids = [eng.submit(Request(p, NEW)) for p in fleet["prompts"][:3]]
    eng.run_until_idle()
    assert eng.chaos.fired_count == 1
    for rid, p in zip(rids, fleet["prompts"][:3]):
        np.testing.assert_array_equal(eng.finished[rid]["tokens"],
                                      fleet["golden"][tuple(p)])
    st = eng.stats
    if kind == "slot_stall":
        assert st["faults_detected"] == 0
    else:
        assert st["faults_detected"] >= 1
        assert st["faults_healed"] == st["faults_detected"]
    assert eng.audit(heal=False)["ok"] and eng._alloc.in_use == 0
