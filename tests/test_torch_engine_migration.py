"""The port's engine interrupted against its own uninterrupted run, on
the CPU, with a real (small) model: preemption replay, drain / resume
(in memory, through a verified file, and by ``run_until_idle(stop=)``),
``export_slot`` / ``import_slot`` with ``migrate_blocks`` — including a
source engine that reuses the exported blocks before the copy — and the
same under ``spec_k``.  Greedy AND sampled rows must give EXACTLY the
uninterrupted tokens: a sampled row's ``torch.Generator`` state travels
in the descriptors.  Also the drain file's refusals (a flipped byte, a
size mismatch, a foreign schema) and ``GracefulShutdown``."""

import json
import os
import signal

import numpy as np
import pytest
import torch

from torchdistpackage_tpu_torch.models import init_gpt_params, llama_config
from torchdistpackage_tpu_torch.resilience import CheckpointCorruptError
from torchdistpackage_tpu_torch.serving import (
    DRAIN_SCHEMA,
    Request,
    ServingEngine,
    migrate_blocks,
)
from torchdistpackage_tpu_torch.serving.sim import TorchDeviceStep
from torchdistpackage_tpu_torch.utils import GracefulShutdown

CFG = llama_config(vocab_size=64, dim=64, nheads=4, nlayers=2, max_seq=128,
                   kv_heads=2, ffn_hidden=96, dtype=torch.float32,
                   sliding_window=10)
NEW = 10
ENGINE = dict(num_slots=4, block_size=4, chunk=8, max_ctx=64, device="cpu")


def _requests():
    """Two greedy and two sampled requests (one nucleus-filtered)."""
    rs = np.random.RandomState(0)
    lens = (7, 13, 18, 22)
    out = []
    for i, n in enumerate(lens):
        toks = rs.randint(0, CFG.vocab_size, n).tolist()
        if i % 2:
            out.append(Request(toks, NEW, temperature=0.9, top_k=20,
                               top_p=0.9 if i == 3 else None, seed=11 * i))
        else:
            out.append(Request(toks, NEW))
    return out


@pytest.fixture(scope="module")
def model():
    params = init_gpt_params(CFG, torch.Generator().manual_seed(0),
                             device="cpu")
    want = {}
    for k in (0, 2):
        eng = ServingEngine(params, CFG, spec_k=k, **ENGINE)
        rids = [eng.submit(r) for r in _requests()]
        eng.run_until_idle()
        want[k] = [eng.finished[r]["tokens"] for r in rids]
    return {"params": params, "want": want}


def _check(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: request {i}")


def _mid_decode(eng, n=2):
    busy = [s for s in eng._slots if s.state != "free"]
    return busy and all(s.state == "decode" and n <= len(s.generated) < NEW
                        for s in busy)


def test_preemption_replays_exactly(model):
    """A priority-1 arrival into a full pool evicts the most recent
    priority-0 slot, which replays from its seed to the same tokens."""
    eng = ServingEngine(model["params"], CFG, num_blocks=1 + 20, **ENGINE)
    rids = [eng.submit(r) for r in _requests()]
    for _ in range(4):
        eng.step()
    hi = eng.submit(Request(_requests()[1].tokens, NEW, temperature=0.9,
                            top_k=20, seed=11, priority=1))
    eng.run_until_idle()
    assert eng.stats["preempted"] >= 1
    _check([eng.finished[r]["tokens"] for r in rids], model["want"][0],
           "preempted")
    np.testing.assert_array_equal(eng.finished[hi]["tokens"],
                                  model["want"][0][1])
    assert eng.audit(heal=False)["ok"] and eng._alloc.in_use == 0


@pytest.mark.parametrize("spec_k", [0, 2])
@pytest.mark.parametrize("when", ["mid_decode", "mid_prefill"])
def test_drain_resume_is_exact(model, tmp_path, spec_k, when):
    """Drained mid-decode (each stream's state after its last draw) or
    mid-prefill (no draw yet: the seed), persisted, resumed."""
    eng = ServingEngine(model["params"], CFG, spec_k=spec_k, **ENGINE)
    for r in _requests():
        eng.submit(r)
    if when == "mid_decode":
        while not _mid_decode(eng):
            eng.step()
    else:
        eng.step()
        assert any(s.state == "prefill" for s in eng._slots)
    path = str(tmp_path / "drain.json")
    payload = eng.drain(persist_path=path)
    assert eng.n_busy == 0 and eng._alloc.n_free == eng._alloc.n_usable
    assert eng.submit(_requests()[0]) in eng.rejected  # draining: shed
    keys = [d["key"] for d in payload["requests"]]
    assert (all(k is not None for k in keys) if when == "mid_decode"
            else any(k is None for k in keys))
    eng2 = ServingEngine(model["params"], CFG, spec_k=spec_k, **ENGINE)
    rids = eng2.resume(path)
    eng2.run_until_idle()
    got = [eng2.finished[r]["tokens"] for r in rids]
    want = model["want"][spec_k]
    if spec_k and when == "mid_decode":
        # a verify tick draws K + (K+1) V uniforms a slot, a resumed
        # slot's first token one plain draw of V: sampled rows continue
        # their stream's state but not the same draws.  Greedy rows are
        # exact; sampled rows keep what they emitted before the drain.
        for i, (g, w, d) in enumerate(zip(got, want, payload["requests"])):
            if i % 2:
                n = len(d["prompt"]) + len(d["emitted"])
                np.testing.assert_array_equal(g[:n], w[:n])
            else:
                np.testing.assert_array_equal(g, w)
    else:
        _check(got, want, f"resumed {when}")
    for r, req in zip(rids, _requests()):
        f = eng2.finished[r]
        assert f["prompt_len"] == len(req.tokens) and f["new_tokens"] == NEW
    assert eng2.serving_summary()["requests"]["resumed"] == len(rids)


def test_run_until_idle_drains_on_stop(model, tmp_path):
    class Stop:
        requested = False

    stop = Stop()
    eng = ServingEngine(model["params"], CFG, **ENGINE)
    for r in _requests():
        eng.submit(r)
    real_step = eng.step

    def step():
        out = real_step()
        stop.requested = eng._tick >= 5
        return out

    eng.step = step
    path = str(tmp_path / "stop.json")
    eng.run_until_idle(stop=stop, persist_path=path)
    assert eng._tick == 5 and eng.n_busy == 0 and eng._draining
    assert os.path.exists(path + ".manifest.json")
    eng2 = ServingEngine(model["params"], CFG, **ENGINE)
    rids = eng2.resume(path)
    eng2.run_until_idle()
    _check([eng2.finished[r]["tokens"] for r in rids], model["want"][0],
           "stop")


def test_drain_file_refusals(model, tmp_path):
    """Verify before parse: one flipped byte, a changed size, a foreign
    schema — each refused before any request is submitted."""
    eng = ServingEngine(model["params"], CFG, **ENGINE)
    eng.submit(_requests()[0])
    eng.step()
    path = str(tmp_path / "d.json")
    eng.drain(persist_path=path)
    raw = bytearray(open(path, "rb").read())
    fresh = ServingEngine(model["params"], CFG, **ENGINE)
    raw[len(raw) // 2] ^= 0x01
    open(path, "wb").write(bytes(raw))
    with pytest.raises(CheckpointCorruptError, match="sha256"):
        fresh.resume(path)
    open(path, "wb").write(bytes(raw) + b" ")
    with pytest.raises(CheckpointCorruptError, match="size"):
        fresh.resume(path)
    with pytest.raises(ValueError, match=DRAIN_SCHEMA):
        fresh.resume({"schema": "other/v1", "requests": []})
    other = str(tmp_path / "o.json")
    json.dump({"schema": "other/v1"}, open(other, "w"))
    with pytest.raises(ValueError, match="not a"):
        fresh.resume(other)
    assert not fresh.queue and fresh.stats["resumed"] == 0


def _migrate_all(src_eng, dst_eng, snaps=None, reuse=None):
    """Export every DECODE slot of ``src_eng`` and import it into
    ``dst_eng``; ``reuse()`` runs between the export and the copy."""
    moved = []
    for rid, _slot in src_eng.decode_slots():
        desc, snap = src_eng.export_slot(rid)
        got = dst_eng.import_slot(desc)
        assert got is not None
        moved.append((desc, snap, got))
    if reuse is not None:
        reuse(moved)
    for desc, snap, got in moved:
        lo, hi = got["n_shared"], got["n_live"]
        dst_eng.cache = migrate_blocks(snap, dst_eng.cache,
                                       desc["blocks"][lo:hi],
                                       got["blocks"][lo:hi])
    return [g["rid"] for _d, _s, g in moved]


@pytest.mark.parametrize("spec_k", [0, 2])
def test_export_import_is_exact(model, spec_k):
    """A prefill engine (``hold_decode``) hands every slot to a decode
    engine with the prefix cache on; the second import of a prompt that
    shares blocks with the first ships only the tail."""
    pre = ServingEngine(model["params"], CFG, spec_k=spec_k, **ENGINE)
    pre.hold_decode = True
    dec = ServingEngine(model["params"], CFG, spec_k=spec_k,
                        prefix_cache=True, **ENGINE)
    for r in _requests():
        pre.submit(r)
    while len(pre.decode_slots()) < 4:
        pre.step()
    assert pre.stats["decode_steps"] == 0
    order = [rid for rid, _ in pre.decode_slots()]
    rids = _migrate_all(pre, dec)
    dec.run_until_idle()
    got = {o: dec.finished[r]["tokens"] for o, r in zip(order, rids)}
    _check([got[i] for i in range(4)], model["want"][spec_k], "imported")
    assert pre._alloc.in_use == 0 and dec._alloc.in_use == 0
    # warm: the same request again shares its full prompt blocks
    pre.submit(_requests()[3])
    while not pre.decode_slots():
        pre.step()
    rid, = _migrate_all(pre, dec)
    assert dec.stats["prefix_hits"] >= 1
    dec.run_until_idle()
    np.testing.assert_array_equal(dec.finished[rid]["tokens"],
                                  model["want"][spec_k][3])


def test_export_snapshot_survives_source_reuse(model):
    """The torch pool is overwritten in place: the source engine serves
    other requests into the very blocks it exported before the copy runs,
    and the imported requests still equal the uninterrupted run."""
    pre = ServingEngine(model["params"], CFG, **ENGINE)
    pre.hold_decode = True
    dec = ServingEngine(model["params"], CFG, **ENGINE)
    reqs = _requests()
    for r in reqs[:2]:
        pre.submit(r)
    while len(pre.decode_slots()) < 2:
        pre.step()
    order = [rid for rid, _ in pre.decode_slots()]

    def reuse(moved):
        live = {b for d, _s, _g in moved for b in d["blocks"][:d["n_live"]]}
        pre.hold_decode = False
        for r in reqs[2:]:
            pre.submit(Request(list(reversed(r.tokens)), NEW))
        pre.step()
        used = {b for s in pre._slots for b in s.blocks}
        assert live & used, "the source engine did not reuse the blocks"
        pre.run_until_idle()

    rids = _migrate_all(pre, dec, reuse=reuse)
    dec.run_until_idle()
    got = {o: dec.finished[r]["tokens"] for o, r in zip(order, rids)}
    _check([got[0], got[1]], model["want"][0][:2], "snapshot")


def test_generator_state_round_trip():
    dev = TorchDeviceStep(CFG, device="cpu")
    g = dev.stream(5)
    torch.rand(7, generator=g)
    state = dev.stream_state(g)
    assert json.loads(json.dumps(state)) == state
    h = dev.restore_stream(state)
    assert torch.equal(torch.rand(9, generator=g), torch.rand(9, generator=h))


def test_graceful_shutdown_flags_a_signal():
    with GracefulShutdown(signals=("SIGUSR1",), grace_s=5.0) as stop:
        assert not stop.requested
        os.kill(os.getpid(), signal.SIGUSR1)
        assert stop.requested and stop.deadline_mono is not None
    assert signal.getsignal(signal.SIGUSR1) in (signal.SIG_DFL, None) or \
        signal.getsignal(signal.SIGUSR1) is not stop._handler


def test_a_dropped_engine_frees_its_pool_at_once(model):
    """No reference cycle through the device step: the pool goes with
    the last reference to the engine, without waiting for the cyclic
    collector (a card holds few 8 GB pools)."""
    import gc
    import weakref

    gc.disable()
    try:
        eng = ServingEngine(model["params"], CFG, prefix_cache=True,
                            **ENGINE)
        eng.submit(_requests()[0])
        eng.run_until_idle()
        pool = weakref.ref(eng.cache["k"])
        del eng
        assert pool() is None
    finally:
        gc.enable()
