"""The port's migration transports and Autoscaler on the CPU, against
the JAX package: the chunked wire against the loopback and against
JAX's golden tokens, every ``TRANSPORT_FAULT_KINDS`` arm (healed by one
re-request, a spent retry budget falling back to re-prefill, a
destination dying mid-transfer), the in-flight window as an audit
ownership site, prefix blocks evicted mid-handoff re-shipped, the wire
format unit against JAX's transport, and the Autoscaler's scale-up,
scale-down, floors, re-tiering, verdicts and validator.

The fleets are the JAX tests' (``tests/test_transport.py``): two
replicas, 3 slots, blocks of 4, chunk 4, the prefix cache on; the
transport fleets run real port engines (GPT vocab 64, dim 32, 4 heads,
2 layers, f32, JAX's weights through ``params_from_jax``) and the
Autoscaler's run on ``StubDeviceStep`` engines as JAX's do.

Held exactly: greedy tokens against JAX's jitted ``generate`` golden in
every wire arm; the retry, fallback, dead-transfer, re-shipped and
evacuation counts, the handoff targets and the migrated blocks and
bytes against the JAX Router over JAX stub engines on the same requests
and fault plan; the wire's staged bytes and byte count against JAX's
``ChunkedWireTransport`` on the same pool.  Excluded, because they read
the host clock: the Autoscaler's decisions (its windows take deadline
attainment and the TTFT bias), which are held to their structure, not
to JAX's.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import generate as jgenerate
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.obs.events import EventLog as JEventLog
from torchdistpackage_tpu.obs.events import \
    set_default_event_log as jset_default_log
from torchdistpackage_tpu.resilience import ChaosMonkey as JChaosMonkey
from torchdistpackage_tpu.resilience import Fault as JFault
from torchdistpackage_tpu.serving import \
    ChunkedWireTransport as JChunkedWireTransport
from torchdistpackage_tpu.serving import Request as JRequest
from torchdistpackage_tpu.serving import Router as JRouter
from torchdistpackage_tpu.serving import ServingEngine as JEngine
from torchdistpackage_tpu.serving import StubDeviceStep as JStub
from torchdistpackage_tpu_torch.models import GPTConfig
from torchdistpackage_tpu_torch.models.convert import params_from_jax
from torchdistpackage_tpu_torch.models.generate import _kv_quant
from torchdistpackage_tpu_torch.obs.events import (
    EventLog,
    set_default_event_log,
)
from torchdistpackage_tpu_torch.obs.report import _validate_router
from torchdistpackage_tpu_torch.resilience import (
    TRANSPORT_FAULT_KINDS,
    ChaosMonkey,
    Fault,
)
from torchdistpackage_tpu_torch.serving import (
    Autoscaler,
    ChunkedWireTransport,
    LoopbackTransport,
    Request,
    Router,
    ServingEngine,
    StubDeviceStep,
    TransportDeadError,
)

SMALL = dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=64)
JCFG = JGPTConfig(**SMALL)
CFG = GPTConfig(**SMALL, dtype=torch.float32)
BS, NEW = 4, 6
ENGINE = dict(num_slots=3, block_size=BS, chunk=4, prefix_cache=True)


def _prompt(seed, n=9):
    return np.random.RandomState(seed).randint(0, 64, size=n).tolist()


SHARED = _prompt(7, n=2 * BS)  # two full blocks of shared prefix
ROWS = ([_prompt(i) for i in range(6)]
        + [SHARED + _prompt(20 + i, n=3) for i in range(3)])


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
def model():
    """JAX's weights, their port copy, and one jitted ``generate``
    golden for every prompt of the module."""
    jparams = jinit(jax.random.PRNGKey(0), JCFG)
    gen = jax.jit(lambda p, t: jgenerate(p, t, JCFG, max_new_tokens=NEW))
    golden = {}
    for n in sorted({len(r) for r in ROWS}):  # one call a prompt length
        rows = [r for r in ROWS if len(r) == n]
        want = np.asarray(gen(jparams, np.asarray(rows, np.int32)))
        golden.update({tuple(r): w for r, w in zip(rows, want)})
    return {"params": params_from_jax(jax.tree.map(np.asarray, jparams),
                                      CFG, device="cpu"),
            "golden": golden}


def _stub_engine(**kw):
    return ServingEngine(None, CFG, device_step=StubDeviceStep(),
                         **{**ENGINE, **kw})


@pytest.fixture()
def event_log():
    log = EventLog()
    set_default_event_log(log)
    yield log
    set_default_event_log(None)


def _drive(router, max_ticks=200):
    ticks = 0
    while router.has_work() and ticks < max_ticks:
        router.step()
        ticks += 1
        rep = router.audit()
        assert rep["ok"], rep["violations"]
    assert not router.has_work(), "fleet wedged"


def _run(side, model, transport=None, faults=None, rows=ROWS[:6],
         sequential=False):
    """``rows`` through a prefill / decode fleet on ``side`` ('port':
    real port engines; 'jax': JAX stub engines), auditing every tick;
    ``transport='wire'`` is the chunked wire with ``faults``.  Returns
    (router, log, rids)."""
    jax_side = side == "jax"
    log = (JEventLog if jax_side else EventLog)()
    (jset_default_log if jax_side else set_default_event_log)(log)
    try:
        if transport == "wire":
            monkey = ((JChaosMonkey if jax_side else ChaosMonkey)(
                faults=faults) if faults else None)
            transport = (JChunkedWireTransport if jax_side
                         else ChunkedWireTransport)(chaos=monkey)
        if jax_side:
            engines = [JEngine(None, JCFG, device_step=JStub(), **ENGINE)
                       for _ in range(2)]
            router = JRouter(engines, roles=["prefill", "decode"],
                             transport=transport)
            req = JRequest
        else:
            engines = [ServingEngine(model["params"], CFG, device="cpu",
                                     **ENGINE) for _ in range(2)]
            router = Router(engines, roles=["prefill", "decode"],
                            transport=transport)
            req = Request
        rids = []
        for r in rows:
            rids.append(router.submit(req(r, NEW)))
            if sequential:
                _drive(router)
        _drive(router)
    finally:
        (jset_default_log if jax_side else set_default_event_log)(None)
    return router, log, rids


def _golden(model, router, rids, rows=ROWS[:6]):
    for rid, row in zip(rids, rows):
        np.testing.assert_array_equal(router.finished[rid]["tokens"],
                                      model["golden"][tuple(row)],
                                      err_msg=f"rid {rid}")


def _kind(log, kind):
    return [e for e in log.as_list() if e["kind"] == kind]


def _no_clock(router, log):
    """What the wire arms decide without the host clock."""
    return {
        "transport": {k: router.transport.stats[k] for k in (
            "sends", "chunks", "retries", "reshipped_blocks",
            "dead_transfers")},
        "stats": {k: router.stats[k] for k in (
            "handoffs", "migration_blocks", "migration_shared_blocks",
            "migration_bytes", "transport_fallbacks", "evacuations",
            "evacuated_requests")},
        "alive": list(router.alive), "roles": list(router.roles),
        "handoffs": [(e["src_replica"], e["outcome"], e["chosen"])
                     for e in _kind(log, "handoff_decision")],
        "fallbacks": [(e["src_replica"], e["dst_replica"],
                       e["replica_died"]) for e in _kind(
                           log, "migration_fallback")],
        "retries": [(e["seq"], e["chunk"], e["attempt"])
                    for e in _kind(log, "migration_retry")],
    }


# ------------------------------------------------------------- wire parity


def test_loopback_is_the_default_transport(event_log):
    r = Router([_stub_engine(), _stub_engine()])
    assert isinstance(r.transport, LoopbackTransport)
    assert r.summary()["fleet"]["migrations"]["transport"]["kind"] == \
        "loopback"


def test_chunked_wire_is_bit_invisible(model):
    """Loopback and chunked wire give JAX's golden tokens; the wire
    carried manifest-checked chunks with no retry, as JAX's did."""
    router, _, rids = _run("port", model)
    _golden(model, router, rids)
    wire, log, wrids = _run("port", model, "wire")
    _golden(model, wire, wrids)
    st = wire.transport.stats
    assert st["chunks"] == wire.stats["migration_blocks"] > 0
    assert st["wire_bytes"] == wire.stats["migration_bytes"]
    assert st["retries"] == st["dead_transfers"] == 0
    jwire, jlog, _ = _run("jax", model, "wire")
    assert _no_clock(wire, log) == _no_clock(jwire, jlog)


def test_wire_unit_roundtrip_matches_jax():
    """The wire format on one pool, against JAX's transport: exact
    chunks deliver bit-exactly, int8 chunks equal the ``_kv_quant``
    dequantisation, and both byte counts equal JAX's."""
    rs = np.random.RandomState(0)
    src = {"k": rs.randn(2, 8, BS, 6).astype(np.float32),
           "v": rs.randn(2, 8, BS, 6).astype(np.float32)}
    for compress, blocks, dst_ids in ((False, [2, 5], [3, 4]),
                                      (True, [2], [3])):
        got, want = [], []
        for cls, out in ((ChunkedWireTransport, got),
                         (JChunkedWireTransport, want)):
            tr = cls()
            h = tr.begin({k: v.copy() for k, v in src.items()},
                         {"orig_rid": 0}, src=0, dst=1, compress=compress)
            assert h["compress"] == compress
            tr.fetch(h, blocks)
            dst = tr.deliver(h, {k: np.zeros_like(v)
                                 for k, v in src.items()}, blocks, dst_ids)
            out.append((np.asarray(dst["k"]), np.asarray(dst["v"]),
                        tr.stats["wire_bytes"]))
        (gk, gv, gb), (wk, wv, wb) = got[0], want[0]
        assert gb == wb
        if compress:
            q, scale = _kv_quant(torch.from_numpy(src["k"][:, 2]))
            np.testing.assert_array_equal(
                gk[:, 3], (q.float() * scale[..., None]).numpy())
            np.testing.assert_allclose(gk, wk, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(gk[:, 3], src["k"][:, 2])
            np.testing.assert_array_equal(gv[:, 4], src["v"][:, 5])
            np.testing.assert_array_equal(gk, wk)


def test_deliver_before_fetch_is_a_dead_transfer():
    tr = ChunkedWireTransport()
    h = tr.begin({"k": np.zeros((1, 4, BS, 2), np.float32)},
                 {"orig_rid": 0}, src=0, dst=1, compress=False)
    with pytest.raises(TransportDeadError, match="never staged"):
        tr.deliver(h, {"k": np.zeros((1, 4, BS, 2), np.float32)}, [1], [2])


# ----------------------------------------------------------- chaos matrix

#: the wire arms: a one-shot fault of each kind, a stall under the
#: timeout, a repeating drop, and the destination's death
ARMS = {
    "chunk_drop": [Fault("chunk_drop", step=1)],
    "chunk_corrupt": [Fault("chunk_corrupt", step=1)],
    "transport_stall": [Fault("transport_stall", step=1, duration_s=2.0)],
    "stall_under_timeout": [Fault("transport_stall", step=1,
                                  duration_s=0.1)],
    "drop_repeating": [Fault("chunk_drop", step=1, repeat=True)],
    "replica_death_midmigration": [
        Fault("replica_death_midmigration", step=1)],
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_wire_fault_arm(model, arm):
    """Each arm's greedy tokens equal JAX's golden; what it decided
    (retries, fallbacks, dead transfers, evacuations, handoff targets,
    migrated blocks and bytes, liveness and roles) equals the JAX Router
    on the same plan."""
    assert {f.kind for f in ARMS[arm]} <= set(TRANSPORT_FAULT_KINDS)
    faults = ARMS[arm]
    router, log, rids = _run("port", model, "wire", faults)
    jfaults = [JFault(f.kind, step=f.step, duration_s=f.duration_s,
                      repeat=f.repeat) for f in faults]
    jrouter, jlog, _ = _run("jax", model, "wire", jfaults)
    _golden(model, router, rids)
    got = _no_clock(router, log)
    assert got == _no_clock(jrouter, jlog)
    st = got["transport"]
    if arm in ("chunk_drop", "chunk_corrupt", "transport_stall"):
        assert st["retries"] == 1 and st["dead_transfers"] == 0
        assert got["stats"]["transport_fallbacks"] == 0
        assert _kind(log, "fault_injected")
    elif arm == "stall_under_timeout":
        assert st["retries"] == 0
    elif arm == "drop_repeating":
        assert st["retries"] == 3 and st["dead_transfers"] == 1
        (fb,) = _kind(log, "migration_fallback")
        assert not fb["replica_died"] and fb["transport"] == "chunked_wire"
    else:
        assert router.alive == [True, False] and router.roles[0] == "both"
        assert got["stats"]["evacuations"] == 1
        assert not router._inflight
        assert any(e["reason"] == "died_midmigration"
                   for e in _kind(log, "replica_down"))
    assert _validate_router(router.summary()) == []


# ------------------------------------------------- in-flight audit window


class _AuditProbeTransport(ChunkedWireTransport):
    """Audits the fleet from inside the export -> import window."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.window_audits = []

    def fetch(self, handle, block_ids, reship=False):
        if not reship and self._router is not None:
            self.window_audits.append(copy.deepcopy(self._router.audit()))
        return super().fetch(handle, block_ids, reship)


def test_inflight_window_is_an_audit_ownership_site(model):
    """During export -> import the request lives only in its
    descriptor: the audit counts the in-flight record as its one
    ownership site, and flags a request both in flight and admitted."""
    tr = _AuditProbeTransport()
    router, _, rids = _run("port", model, tr)
    _golden(model, router, rids)
    assert tr.window_audits
    for rep in tr.window_audits:
        assert rep["ok"], rep["violations"]
        assert rep["inflight"] == 1
    rid = router.submit(Request(_prompt(99), max_new_tokens=4))
    router.step()
    router._inflight[rid] = {"src": 0, "dst": 1, "src_rid": 0}
    rep = router.audit()
    assert any(v["kind"] == "double_owned" and v["rid"] == rid
               for v in rep["violations"]), rep["violations"]


# --------------------------------------------------- eviction-window reship


def _evicting(base):
    class Evicting(base):
        """Evicts the destination's whole prefix cache between the
        prestage fetch and the import."""

        def fetch(self, handle, block_ids, reship=False):
            out = super().fetch(handle, block_ids, reship)
            if not reship and self._router is not None:
                dst = self._router.replicas[handle["dst"]]
                for alloc in dst._allocs:
                    grabbed = alloc.alloc(alloc.n_free + alloc.n_cached)
                    alloc.free(grabbed)
            return out
    return Evicting()


def test_evicted_prefix_blocks_are_reshipped(model):
    """Sequential same-prefix handoffs share the prefix on arrival;
    with the destination's cache evicted mid-handoff the blocks are
    re-shipped over the wire instead, tokens still JAX's golden, and the
    counts equal the JAX Router's."""
    rows = ROWS[6:]
    golden, _, grids = _run("port", model, rows=rows, sequential=True)
    _golden(model, golden, grids, rows)
    assert golden.stats["migration_shared_blocks"] > 0
    router, log, rids = _run("port", model, _evicting(ChunkedWireTransport),
                             rows=rows, sequential=True)
    _golden(model, router, rids, rows)
    assert router.transport.stats["reshipped_blocks"] >= 1
    assert router.stats["migration_shared_blocks"] == 0
    assert router.stats["transport_fallbacks"] == 0
    jrouter, jlog, _ = _run("jax", model, _evicting(JChunkedWireTransport),
                            rows=rows, sequential=True)
    assert _no_clock(router, log) == _no_clock(jrouter, jlog)


# ------------------------------------------------------------- autoscaler


def _burst_fleet(n_spares=1, **asc_kw):
    engines = [_stub_engine() for _ in range(2 + n_spares)]
    r = Router(engines, roles=["both"] * (2 + n_spares))
    for i in range(2, 2 + n_spares):
        r.set_alive(i, False, reason="provisioned_spare")
    asc_kw.setdefault("eval_every", 4)
    asc_kw.setdefault("cooldown", 8)
    asc_kw.setdefault("queue_high", 1.0)
    return r, Autoscaler(r, **asc_kw)


def test_autoscaler_scales_up_under_backlog_and_parks_when_calm(event_log):
    """A backlog revives the parked spare; the calm tail parks an idle
    replica through the drain path; every evaluation is one
    ``scale_decision``; the summary validates."""
    r, asc = _burst_fleet()
    rids = [r.submit(Request(_prompt(i), max_new_tokens=6))
            for i in range(12)]
    ticks = 0
    while r.has_work() and ticks < 200:
        r.step()
        ticks += 1
    assert asc.stats["scale_ups"] >= 1
    assert any(e.get("reason") == "scale_up"
               for e in event_log.of_kind("replica_up"))
    while not asc.stats["scale_downs"] and ticks < 300:
        r.step()
        ticks += 1
    assert asc.stats["scale_downs"] >= 1 and sum(r.alive) == 2
    assert all(rid in r.finished for rid in rids)
    evs = event_log.of_kind("scale_decision")
    assert len(evs) == asc.stats["evals"]
    ups = [e for e in evs if e["action"] == "scale_up"]
    assert ups and ups[0]["reasons"] and ups[0]["evidence"]["queued"] > 0
    s = r.summary()
    assert s["fleet"]["autoscale"]["verdict"] == "elastic"
    assert _validate_router(s) == []


def test_autoscaler_floors_retier_and_verdicts(event_log):
    """``min_alive`` and the last submit target are never parked; a
    decode-starved window re-tiers a revived prefill spare to decode;
    ``static`` and ``thrashing`` verdicts."""
    r, asc = _burst_fleet(n_spares=0, min_alive=2)
    for _ in range(5 * asc.eval_every):
        r.step()
    assert asc.stats["scale_downs"] == 0 and sum(r.alive) == 2
    s = asc.summary()
    assert s["verdict"] == "static" and s["holds"] == s["evals"] >= 1
    r2, asc2 = _burst_fleet(n_spares=0, min_alive=1)
    for _ in range(20 * asc2.eval_every):
        r2.step()
    assert sum(r2.alive) >= 1

    r3 = Router([_stub_engine() for _ in range(3)],
                roles=["prefill", "decode", "prefill"])
    r3.set_alive(2, False, reason="provisioned_spare")
    asc3 = Autoscaler(r3, eval_every=24, cooldown=8, queue_high=0.5,
                      retier=True)
    rids = [r3.submit(Request(_prompt(i, n=4), max_new_tokens=24))
            for i in range(10)]
    ticks = 0
    while r3.has_work() and ticks < 400:
        r3.step()
        ticks += 1
    assert all(rid in r3.finished for rid in rids)
    assert asc3.stats["retiers"] == 1 and r3.roles[2] == "decode"
    assert not r3.replicas[2].hold_decode

    r4, asc4 = _burst_fleet(thrash_at=0)
    for i in range(12):
        r4.submit(Request(_prompt(i), max_new_tokens=6))
    ticks = 0
    while r4.has_work() and ticks < 200:
        r4.step()
        ticks += 1
    assert asc4.actions >= 1 and asc4.summary()["verdict"] == "thrashing"


def test_validate_autoscale_bites_both_directions(event_log):
    r, asc = _burst_fleet()
    for i in range(12):
        r.submit(Request(_prompt(i), max_new_tokens=6))
    ticks = 0
    while r.has_work() and ticks < 200:
        r.step()
        ticks += 1
    summary = r.summary()
    assert _validate_router(summary) == []
    a = summary["fleet"]["autoscale"]
    assert a["actions"] >= 1

    def corrupt(**patch):
        bad = copy.deepcopy(summary)
        bad["fleet"]["autoscale"].update(patch)
        return _validate_router(bad)
    assert corrupt(verdict="static")
    assert corrupt(actions=0)
    assert corrupt(verdict="thrashing")
    assert corrupt(verdict="elastic", actions=a["thrash_at"] + 1,
                   scale_ups=a["thrash_at"] + 1, scale_downs=0)
    assert corrupt(actions=a["scale_ups"] + a["scale_downs"] + 1)
    assert corrupt(holds=-1)
    assert corrupt(verdict="bogus")
    assert corrupt(basis=None)
    for k, v in (("retries", -1), ("fallbacks", -2)):
        bad = copy.deepcopy(summary)
        bad["fleet"]["migrations"][k] = v
        assert _validate_router(bad)
