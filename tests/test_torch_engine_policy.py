"""The port's engine on the port's stub against the reference's engine on
the reference's stub, on the CPU.

``StubDeviceStep`` (both packages) runs no model: a greedy token is a
hash of (input token, position), a sampled one also folds in the slot's
two-word key, which both stubs advance with the same LCG.  So the whole
scheduler — priority admission, preemption, the prefix cache with its
copy-on-write and eviction, cancel, speculative verify, deadline
shedding and expiry, drain / resume, export / import, ``abort_import``,
``steal_queued``, ``hold_decode`` — runs the same seeded trace in both
engines, and everything it decides must be EQUAL: finished tokens,
rejection verdicts, stats, the sequence of event kinds, every slot's
block ids after every tick, and drain / export descriptors.

Both engines read one injected clock (``time.perf_counter``, advanced by
the trace between ticks) and an injected tick EWMA before each submit,
as the reference's own stress tests inject it, so deadlines, TTFTs and
the calibration bias are exact on both sides.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest

from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.obs.events import EventLog as JEventLog
from torchdistpackage_tpu.serving import Request as JRequest
from torchdistpackage_tpu.serving import ServingEngine as JEngine
from torchdistpackage_tpu.serving import StubDeviceStep as JStub
from torchdistpackage_tpu.serving.sim import (
    host_migrate_blocks as j_migrate,
)
from torchdistpackage_tpu_torch.models import GPTConfig
from torchdistpackage_tpu_torch.obs.events import EventLog
from torchdistpackage_tpu_torch.serving import (
    Request,
    ServingEngine,
    StubDeviceStep,
    host_migrate_blocks,
)

SMALL = dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=512)
SEEDS = (0, 1, 2)
#: kinds only the reference emits (its tick tracing and slot snapshots
#: wait for the port's obs slice)
JAX_ONLY_KINDS = {"engine_tick", "slots_snapshot"}


class Clock:
    """``time.perf_counter`` for both engines: constant within a tick,
    advanced by the trace."""

    def __init__(self) -> None:
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture()
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(time, "perf_counter", c)
    return c


class Side:
    """One package's engine family on its stub."""

    def __init__(self, name: str, clock: Clock) -> None:
        self.name, self.clock = name, clock
        if name == "jax":
            self.cfg = JGPTConfig(**SMALL, dtype=jnp.float32)
            self.Engine, self.Req, self.Stub = JEngine, JRequest, JStub
            self.Log, self.migrate = JEventLog, j_migrate
        else:
            self.cfg = GPTConfig(**SMALL)
            self.Engine, self.Req, self.Stub = (ServingEngine, Request,
                                                StubDeviceStep)
            self.Log, self.migrate = EventLog, host_migrate_blocks
        self.engines = []
        self.record = {"blocks": [], "ticks": [], "returns": []}

    def engine(self, **kw):
        kw = {"num_slots": 3, "block_size": 4, "chunk": 8, "max_ctx": 96,
              **kw}
        eng = self.Engine(None, self.cfg, device_step=self.Stub(), **kw)
        eng._ev = self.Log()
        self.engines.append(eng)
        return eng

    def req(self, tokens, new, **kw):
        return self.Req([int(t) for t in tokens], int(new), **kw)

    def step(self, eng, n=1):
        for _ in range(n):
            self.clock.t += 0.05
            self.record["ticks"].append(dict(eng.step()))
            self.record["blocks"].append(
                [list(map(int, s.blocks)) for s in eng._slots])

    def run(self, eng, max_ticks=400):
        ticks = 0
        while eng.queue or eng.n_busy:
            self.step(eng)
            ticks += 1
            assert ticks < max_ticks
            assert eng.audit(heal=False)["ok"]

    def result(self):
        out = []
        for eng in self.engines:
            out.append({
                "finished": {r: (f["tokens"].tolist(), f["reason"],
                                 f["new_tokens"], f["prompt_len"],
                                 f.get("resumed"))
                             for r, f in eng.finished.items()},
                "rejected": {r: (v["reason"], v.get("est_ttft_s"),
                                 v.get("waited_s"))
                             for r, v in eng.rejected.items()},
                "rejected_order": list(eng._rejected_order),
                "finished_order": list(eng._finished_order),
                "stats": {k: v for k, v in eng.stats.items()},
                "kinds": [e["kind"] for e in eng._ev.as_list()
                          if e["kind"] not in JAX_ONLY_KINDS],
                "calls": dict(eng.device_step.calls),
                "summary": _summary(eng),
                "free": (eng._allocs[0] if hasattr(eng, "_allocs")
                         else eng._alloc)._free[:],
            })
        return {"engines": out, **self.record}


def _summary(eng):
    """The summary blocks both engines share (on the injected clock their
    TTFTs, and so the SLO and calibration records, are exact)."""
    s = eng.serving_summary()
    return {k: s[k] for k in ("verdict", "verdict_evidence", "slo",
                              "priorities", "prefix_cache", "requests",
                              "prefix_hit_rate", "tokens_per_sec")}


def _prompts(seed, n, lo, hi, head=None):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tail = rs.randint(0, SMALL["vocab_size"], rs.randint(lo, hi))
        out.append((list(head) if head is not None else []) + tail.tolist())
    return out


# ----------------------------------------------------------------- traces


def trace_priorities_preemption(side, seed):
    """A tight pool: priority-2 and priority-1 arrivals evict running
    priority-0 slots, which replay later (sampled rows too)."""
    eng = side.engine(num_blocks=1 + 3 * 7)
    ps = _prompts(seed, 7, 6, 20)
    for i, p in enumerate(ps[:4]):
        eng.submit(side.req(p, 6, temperature=0.8 if i % 2 else 0.0,
                            seed=seed * 10 + i))
    side.step(eng, 3)
    eng.submit(side.req(ps[4], 5, priority=2))
    side.step(eng, 2)
    eng.submit(side.req(ps[5], 4, priority=1, temperature=0.9, seed=77))
    eng.submit(side.req(ps[6], 4, priority=2))
    side.run(eng)


def trace_prefix_cow_evict(side, seed):
    """Shared system prompts (prefix hits), whole-prompt hits that COW
    their last block (two in one wave), and LRU eviction under pressure."""
    eng = side.engine(num_blocks=1 + 18, prefix_cache=True)
    rs = np.random.RandomState(100 + seed)
    sysp = [rs.randint(0, 64, 12).tolist() for _ in range(2)]
    for i, s in enumerate(sysp):
        eng.submit(side.req(s + rs.randint(0, 64, 3 + i).tolist(), 4))
    side.run(eng)
    for j in range(4):
        tail = rs.randint(0, 64, 1 + j).tolist()
        eng.submit(side.req(sysp[j % 2] + tail, 5,
                            temperature=0.7 if j == 3 else 0.0, seed=j))
    eng.submit(side.req(sysp[0], 3))   # whole-prompt hits: COW
    eng.submit(side.req(sysp[0], 3))
    side.run(eng)
    for p in _prompts(seed, 3, 14, 22):  # cold: evicts the LRU prefixes
        eng.submit(side.req(p, 4))
    side.run(eng)
    eng.submit(side.req(sysp[1] + [1, 2], 3))
    side.run(eng)
    assert eng.prefix_lookup(sysp[1] + [1, 2]) >= 0


def trace_cancel(side, seed):
    """Cancel a queued request, an in-flight sharer (prefix cache on:
    it decrements, its co-owner decodes on) and an unknown rid."""
    eng = side.engine(num_blocks=1 + 24, prefix_cache=True)
    rs = np.random.RandomState(200 + seed)
    base = rs.randint(0, 64, 16).tolist()
    a = eng.submit(side.req(base + [5], 6))
    side.run(eng)
    c1 = eng.submit(side.req(base + [7], 12))
    c2 = eng.submit(side.req(base + [9], 12, temperature=0.6, seed=3))
    q = [eng.submit(side.req(p, 4)) for p in _prompts(seed, 2, 5, 9)]
    side.step(eng, 3)
    side.record["returns"].append(
        [eng.cancel(c1), eng.cancel(q[-1]), eng.cancel(999), eng.cancel(a)])
    side.run(eng)
    del c2


def trace_spec(side, seed):
    """``spec_k`` 2 with the prefix cache: the verify step, greedy and
    sampled rows, preemption in between."""
    eng = side.engine(num_blocks=1 + 30, prefix_cache=True, spec_k=2)
    rs = np.random.RandomState(300 + seed)
    seg = rs.randint(0, 64, 6).tolist()
    for i in range(4):
        eng.submit(side.req(seg * 3 + [i], 8,
                            temperature=0.5 if i == 1 else 0.0, seed=i))
    side.step(eng, 4)
    eng.submit(side.req(seg * 2, 6, priority=1))
    side.run(eng)


def trace_shedding(side, seed):
    """Deadlines against an injected tick EWMA, a bounded queue, expiry,
    and the calibration bias learning from the injected clock."""
    eng = side.engine(num_blocks=1 + 40, max_queue=4, prefix_cache=True)
    rs = np.random.RandomState(400 + seed)
    ps = _prompts(seed, 16, 4, 30)
    for i, p in enumerate(ps):
        eng._tick_ewma = 0.05 if i else None
        dl = [None, 0.05, 0.3, 1.0, 4.0][rs.randint(5)]
        eng.submit(side.req(p, int(rs.randint(2, 6)), deadline_s=dl,
                            priority=int(rs.randint(2))))
        if i % 3 == 2:
            side.step(eng)
    eng._tick_ewma = 0.05
    exp = eng.submit(side.req(ps[0], 3, deadline_s=5.0))
    eng.queue = [(r, t - 100.0 if r.rid == exp else t) for r, t in eng.queue]
    side.record["returns"].append(
        [eng.estimate_ttft(12), eng.estimate_ttft(12, tokens=ps[1][:12])])
    side.run(eng)


def trace_drain_resume(side, seed, tmp_path):
    """Drain mid-run (DECODE, PREFILL and queued requests, a resumed
    request drained again), persist, resume in a fresh engine."""
    eng = side.engine(num_blocks=1 + 30)
    ps = _prompts(seed, 5, 10, 30)
    for i, p in enumerate(ps):
        eng.submit(side.req(p, 7, temperature=0.9 if i % 2 else 0.0,
                            seed=i + seed, priority=int(i == 4)))
    side.step(eng, 4)
    path = str(tmp_path / f"{side.name}.json")
    payload = eng.drain(persist_path=path)
    late = eng.submit(side.req(ps[0], 3))
    side.record["returns"].append([payload, late])
    eng2 = side.engine(num_blocks=1 + 30)
    side.record["returns"].append(eng2.resume(path))
    side.step(eng2, 3)
    payload2 = eng2.drain()
    side.record["returns"].append(payload2)
    eng3 = side.engine(num_blocks=1 + 30)
    side.record["returns"].append(eng3.resume(payload2))
    side.run(eng3)


def trace_migration(side, seed):
    """A prefill engine (``hold_decode``) exports decoding slots into a
    prefix-cached decode engine (warm second import ships only the tail),
    one import aborted, queued requests stolen and resumed there."""
    pre = side.engine(num_blocks=1 + 40)
    pre.hold_decode = True
    dec = side.engine(num_blocks=1 + 40, prefix_cache=True)
    rs = np.random.RandomState(500 + seed)
    base = rs.randint(0, 64, 16).tolist()
    for i in range(5):
        pre.submit(side.req(base + rs.randint(0, 64, 2 + i).tolist(), 6,
                            temperature=0.7 if i == 2 else 0.0, seed=i))
    side.step(pre, 3)
    moved = []
    for n, (rid, _slot) in enumerate(pre.decode_slots()):
        desc, src = pre.export_slot(rid)
        got = dec.import_slot(desc)
        if got is None:
            continue
        lo, hi = got["n_shared"], got["n_live"]
        if n == 1:
            dec.abort_import(got["rid"], n_valid=lo)
            moved.append(("aborted", desc, got))
            continue
        dec.cache = side.migrate(src, dec.cache,
                                 np.asarray(desc["blocks"][lo:hi]),
                                 np.asarray(got["blocks"][lo:hi]))
        moved.append(("imported", desc, got))
        side.step(dec)
    stolen = pre.steal_queued(2)
    moved.append(("stolen", stolen, dec.resume({
        "schema": "tdp-engine-drain/v1", "n": len(stolen),
        "requests": stolen})))
    side.record["returns"].append(moved)
    side.step(pre, 2)
    side.record["returns"].append(pre.decode_slots())
    pre.hold_decode = False
    side.run(pre)
    side.run(dec)


TRACES = {
    "priorities_preemption": trace_priorities_preemption,
    "prefix_cow_evict": trace_prefix_cow_evict,
    "cancel": trace_cancel,
    "spec": trace_spec,
    "shedding": trace_shedding,
    "migration": trace_migration,
}


def _both(fn, clock, *args):
    out = {}
    for name in ("jax", "torch"):
        clock.t = 1000.0
        side = Side(name, clock)
        fn(side, *args)
        out[name] = side.result()
    return out


def _assert_equal(out):
    j, t = out["jax"], out["torch"]
    assert len(j["engines"]) == len(t["engines"])
    for k, (je, te) in enumerate(zip(j["engines"], t["engines"])):
        for key in je:
            assert te[key] == je[key], f"engine {k}: {key} differs"
    assert t["blocks"] == j["blocks"]
    assert t["ticks"] == j["ticks"]
    assert _plain(t["returns"]) == _plain(j["returns"])


def _plain(x):
    """Numpy values and tuples as plain lists, for equality."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("trace", sorted(TRACES))
def test_stub_engine_equals_reference(trace, seed, clock):
    out = _both(TRACES[trace], clock, seed)
    _assert_equal(out)
    # the trace did what it is named for
    st = out["torch"]["engines"][0]["stats"]
    want = {"priorities_preemption": ("preempted",),
            "prefix_cow_evict": ("prefix_hits", "cow_copies",
                                 "cache_evictions"),
            "cancel": ("cancelled", "prefix_hits"),
            "spec": ("spec_drafted", "preempted"),
            "shedding": ("shed", "expired"),
            "migration": ("migrated_out",)}[trace]
    for key in want:
        assert st[key] > 0, key


@pytest.mark.parametrize("seed", SEEDS)
def test_stub_drain_resume_equals_reference(seed, clock, tmp_path):
    out = _both(trace_drain_resume, clock, seed, tmp_path)
    _assert_equal(out)
    payload = out["torch"]["returns"][0][0]
    states = {len(d["emitted"]) > 0 for d in payload["requests"]}
    assert states == {True, False}  # in-flight and queued both drained
    assert out["torch"]["engines"][1]["stats"]["resumed"] > 0
