"""The port's training resilience against the JAX package's, on the CPU.

- JAX's fault matrix (``tests/test_resilience.py``) through both
  packages' ``ResilientLoop`` and ``GuardedCheckpointManager``, each loop
  over its own package's linear-regression step (JAX: a jitted optax
  AdamW step; the port: ``make_train_step`` with ``adamw``, in place):
  the verdicts, the summaries and the ordered event kinds with their
  step fields equal, the losses and final parameters within
  :data:`TOL`; the port's own trajectories also bit-exact against its
  hand loops (and the replay gate fails on two planted faults).
- The checkpoint layer: the save decisions and retention against JAX's
  Orbax-backed manager, manifests, stale-manifest pruning, quarantine
  and the walk back, template drift, retries, the context manager; the
  port's own format round trip, bit-exact for f32, bf16 and int8 leaves
  and an AdamW ``state_dict``, restored in place.

The two-rank half (a step one rank sees corrupt condemned on both) runs
in ``tests/test_torch_numerics.py``'s two-rank world, beside the TP
numerics.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchdistpackage_tpu import resilience as jres
from torchdistpackage_tpu import utils as jutils
from torchdistpackage_tpu.obs import events as jevents
from torchdistpackage_tpu_torch import resilience as tres
from torchdistpackage_tpu_torch import utils as tutils
from torchdistpackage_tpu_torch.obs import EventLog, set_default_event_log
from torchdistpackage_tpu_torch.parallel.data_parallel import (
    adamw,
    make_train_step,
)
from torchdistpackage_tpu_torch.utils import checkpoint as tckpt

LR = 0.1
#: the two frameworks' f32 AdamW on the same linear regression: their
#: sums round apart at ~1e-7 of the loss
TOL = dict(rtol=1e-5, atol=1e-6)

# ------------------------------------------------------------- the steps

_JOPT = optax.adamw(LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)


@jax.jit
def _jstep(params, opt_state, batch):
    def loss_fn(p):
        pred = batch["x"] @ p["w"] + p["b"]
        return jnp.mean((pred - batch["y"]) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt_state = _JOPT.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss


def _np_batch(index):
    """Fully index-derived (the offset shift IS the stream's advance)."""
    x = np.sin(np.arange(32, dtype=np.float32).reshape(8, 4) + index)
    y = np.cos(np.arange(8, dtype=np.float32) + index * 0.5)
    return {"x": x, "y": y}


def _jinit():
    params = {"w": jnp.zeros((4,)), "b": jnp.zeros(())}
    return params, _JOPT.init(params)


def _jpayload(params, opt_state, offset=0):
    return {"params": params, "opt": opt_state,
            "loop": {"data_offset": jnp.int32(offset)}}


def _tloss(p, b):
    pred = b["x"] @ p["w"] + p["b"]
    return torch.mean((pred - b["y"]) ** 2)


_tstep = make_train_step(_tloss, adamw(LR))


def _tbatch(index):
    return {k: torch.from_numpy(v) for k, v in _np_batch(index).items()}


def _tinit():
    params = {"w": torch.zeros(4), "b": torch.zeros(())}
    return params, adamw(LR).init(params)


def _tpayload(params, opt_state, offset=0):
    return {"params": params, "opt": opt_state,
            "loop": {"data_offset": offset}}


PKG = {
    "jax": dict(res=jres, utils=jutils, step=_jstep, batch=_np_batch,
                init=_jinit, payload=_jpayload),
    "torch": dict(res=tres, utils=tutils, step=_tstep, batch=_tbatch,
                  init=_tinit, payload=_tpayload),
}


@pytest.fixture()
def logs():
    """Fresh process-default event logs of both packages."""
    jlog, tlog = jevents.EventLog(), EventLog()
    jevents.set_default_event_log(jlog)
    set_default_event_log(tlog)
    yield {"jax": jlog, "torch": tlog}
    jevents.set_default_event_log(None)
    set_default_event_log(None)


#: the fields of an event that the two timelines must share
FIELDS = ("step", "from_step", "to_step", "data_offset", "rollbacks_used",
          "forced", "last_checkpoint", "fault", "target_step", "signal",
          "wait", "skipped")


def _timeline(log):
    out = []
    for e in log.as_list():
        fields = tuple((k, e[k]) for k in FIELDS if k in e)
        if e["kind"] in ("numerics_alert", "rollback", "resilience_abort"):
            fields += (("reason", e["reason"]),)
        out.append((e["kind"],) + fields)
    return out


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def _close_params(tp, jp):
    for k in ("w", "b"):
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), err_msg=k, **TOL)


def _run(pkg, d, total, faults=(), mgr_kw=None, **loop_kw):
    P = PKG[pkg]
    params, opt = P["init"]()
    chaos = P["res"].ChaosMonkey(
        [P["res"].Fault(**f) for f in faults], seed=7) if faults else None
    with P["res"].GuardedCheckpointManager(
            d, **{"max_to_keep": 4, **(mgr_kw or {})}) as mgr:
        loop = P["res"].ResilientLoop(P["step"], P["batch"], mgr,
                                      total_steps=total, chaos=chaos,
                                      **loop_kw)
        return loop.run(params, opt)


def _both(tmp_path, logs, total, faults=(), mgr_kw=None, **loop_kw):
    """Each package's loop on its own directory; asserts the shared
    outcome and returns ``{pkg: LoopResult}``."""
    out = {pkg: _run(pkg, str(tmp_path / pkg / "run"), total, faults,
                     mgr_kw, **loop_kw) for pkg in ("jax", "torch")}
    j, t = out["jax"], out["torch"]
    assert t.verdict == j.verdict
    assert t.summary == j.summary
    tl = _timeline(logs["torch"])
    if t.aborted:
        # the port rebuilds the last healthy state in place after the
        # abort: one restore more than the reference, right after it
        i = [e[0] for e in tl].index("resilience_abort")
        assert tl.pop(i + 1)[0] == "checkpoint_restore"
    assert tl == _timeline(logs["jax"])
    assert sorted(t.losses) == sorted(j.losses)
    for s in j.losses:
        np.testing.assert_allclose(t.losses[s], j.losses[s],
                                   err_msg=f"loss {s}", **TOL)
    _close_params(t.params, j.params)
    return out


def _hand(steps, params=None, opt=None, offset=0):
    """The port's step by hand over ``steps``: losses and the state."""
    if params is None:
        params, opt = _tinit()
    losses = {}
    for s in steps:
        params, opt, loss, _ = _tstep(params, opt, _tbatch(s + offset))
        losses[s] = float(loss)
    return losses, params, opt


def _same(a, b):
    for k in ("w", "b"):
        assert torch.equal(a[k], b[k]), k


# ========================================================== fault matrix


def test_armed_unfired_chaos_is_bit_identical(tmp_path, logs):
    res = _both(tmp_path, logs, 6, [dict(kind="nan_spike", step=99)],
                save_every=2)["torch"]
    assert res.verdict == "clean" and res.summary["faults_injected"] == 0
    losses, params, _ = _hand(range(6))
    assert losses == res.losses
    _same(params, res.params)


def _replay_from_3(d):
    """The port's hand replay from its step-3 checkpoint over the shifted
    stream (offset 2): steps 4-9."""
    params, opt = _tinit()
    with tres.GuardedCheckpointManager(d, max_to_keep=4) as mgr:
        mgr.restore(3, template=_tpayload(params, opt))
    return _hand(range(4, 10), params, opt, offset=2)


def test_nan_spike_rollback_exact_parity(tmp_path, logs):
    res = _both(tmp_path, logs, 10, [dict(kind="nan_spike", step=5)],
                save_every=2, max_rollbacks=2)["torch"]
    assert res.verdict == "recovered" and res.summary["rollbacks"] == 1
    assert res.summary["data_offset"] == 2
    rb = logs["torch"].of_kind("rollback")
    assert [(e["from_step"], e["to_step"]) for e in rb] == [(5, 3)]
    kinds = [e["kind"] for e in logs["torch"].as_list()]
    assert kinds.index("numerics_alert") < kinds.index("rollback")
    losses, params, _ = _replay_from_3(str(tmp_path / "torch" / "run"))
    assert losses == {s: res.losses[s] for s in range(4, 10)}
    _same(params, res.params)


@pytest.mark.parametrize("fault", ["offset_not_advanced", "unrestored"])
def test_replay_gate_catches_planted_faults(tmp_path, logs, monkeypatch,
                                            fault):
    """The nan-spike replay gate must fail on a loop that does not advance
    the data stream and on a restore that leaves the live state as the
    poisoned step left it."""
    if fault == "offset_not_advanced":
        real = tres.ResilientLoop._rollback

        def rollback(self, params, opt, step, reason, loss, offset, *a):
            nxt, _ = real(self, params, opt, step, reason, loss, offset, *a)
            return nxt, offset
        monkeypatch.setattr(tres.ResilientLoop, "_rollback", rollback)
    else:
        monkeypatch.setattr(tckpt, "restore_into",
                            lambda template, loaded, path="": template)
    d = str(tmp_path / "run")
    res = _run("torch", d, 10, [dict(kind="nan_spike", step=5)],
               save_every=2, max_rollbacks=2)
    monkeypatch.undo()
    losses, params, _ = _replay_from_3(d)
    assert losses != {s: res.losses[s] for s in range(4, 10)}


@pytest.mark.parametrize("case", ["at_checkpoint", "replayed"])
def test_rollback_budget_spent_aborts_cleanly(tmp_path, logs, case):
    """A persistent divergence spends the budget and aborts; the result
    holds the last healthy state, as the reference's (``replayed``: the
    newest checkpoint is older than the last healthy step, whose state
    the port rebuilds by replaying the step after it)."""
    if case == "at_checkpoint":
        kw = dict(faults=[dict(kind="nan_spike", step=3, repeat=True)],
                  save_every=1, max_rollbacks=1)
        healthy = range(3)
    else:
        kw = dict(faults=[dict(kind="nan_spike", step=4, repeat=True)],
                  save_every=3, max_rollbacks=0)
        healthy = range(4)
    res = _both(tmp_path, logs, 8, **kw)["torch"]
    assert res.aborted and res.verdict == "aborted"
    ab = logs["torch"].of_kind("resilience_abort")
    assert len(ab) == 1
    # every healthy step ran at offset 0 (a rollback's replay of step 3
    # at offset 1 diverged again)
    losses, params, _ = _hand(healthy)
    assert losses == res.losses
    _same(params, res.params)
    with tres.GuardedCheckpointManager(str(tmp_path / "torch" / "run"),
                                       max_to_keep=4) as mgr:
        assert mgr.latest_step() is not None


def test_sigterm_mid_run_resume_exact_trajectory(tmp_path, logs):
    out = _both(tmp_path, logs, 8, [dict(kind="sigterm", step=4)],
                save_every=3)
    res1 = out["torch"]
    assert res1.preempted and max(res1.losses) == 4
    assert [e["signal"] for e in logs["torch"].of_kind("preemption")] == [
        "SIGTERM"]
    again = _both(tmp_path, logs, 8, save_every=3)
    res2 = again["torch"]
    assert res2.verdict == "clean" and sorted(res2.losses) == [5, 6, 7]
    losses, params, _ = _hand(range(8))
    assert losses == {**res1.losses, **res2.losses}
    _same(params, res2.params)


def test_grace_save_forced_past_save_interval(tmp_path, logs):
    res = _both(tmp_path, logs, 8, [dict(kind="sigterm", step=2)],
                mgr_kw=dict(save_interval_steps=5), save_every=1)["torch"]
    assert res.preempted and res.summary["last_checkpoint"] == 2
    with tres.GuardedCheckpointManager(str(tmp_path / "torch" / "run"),
                                       max_to_keep=4) as mgr:
        assert mgr.latest_step() == 2
        start, _ = tutils.auto_resume(mgr, _tpayload(*_tinit()))
        assert start == 3


def test_declined_forced_save_is_loud(tmp_path, logs):
    out = {}
    for pkg, base in (("jax", jutils.CheckpointManager),
                      ("torch", tutils.CheckpointManager)):
        class Declining(base):
            def save(self, step, state, wait=False, force=False):
                return False

        P = PKG[pkg]
        with Declining(str(tmp_path / pkg), max_to_keep=2) as mgr:
            out[pkg] = P["res"].ResilientLoop(
                P["step"], P["batch"], mgr, total_steps=2,
                save_every=1).run(*P["init"]())
    assert out["torch"].summary == out["jax"].summary
    assert out["torch"].summary["last_checkpoint"] is None
    assert _timeline(logs["torch"]) == _timeline(logs["jax"])
    assert logs["torch"].of_kind("checkpoint_save_skipped")[-1]["step"] == 1


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_corrupt_newest_then_spike_walks_back(tmp_path, logs, mode):
    """``ckpt_corrupt`` of the newest checkpoint (step 3, committed in the
    background: a short stall first gives its write the time), then a
    spike at 5: the rollback's auto_resume quarantines step 3 and walks
    back to step 1, and the run recovers bit-exactly to a hand replay
    from there (the chip's arm (c) at toy size).  The port only: its
    manifest is written when a step commits, the reference's at the next
    save, so the reference's newest step has none yet and a damaged byte
    there is found only if its restore happens to fail."""
    d = str(tmp_path / "run")
    res = _run("torch", d, 8,
               [dict(kind="stall", step=4, duration_s=0.05),
                dict(kind="ckpt_corrupt", step=4, mode=mode),
                dict(kind="nan_spike", step=5)], save_every=2)
    assert res.verdict == "recovered" and res.summary["data_offset"] == 4
    assert [e["step"] for e in logs["torch"].of_kind("ckpt_quarantine")] \
        == [3]
    rb = logs["torch"].of_kind("rollback")
    assert [(e["from_step"], e["to_step"]) for e in rb] == [(5, 1)]
    assert os.path.isdir(d + ".quarantine/3")
    params, opt = _tinit()
    with tres.GuardedCheckpointManager(d, max_to_keep=4) as mgr:
        mgr.restore(1, template=_tpayload(params, opt))
    losses, params, _ = _hand(range(2, 8), params, opt, offset=4)
    assert losses == {s: res.losses[s] for s in range(2, 8)}
    _same(params, res.params)


def test_stall_trips_watchdog_hang_suspected(tmp_path, logs):
    """A host stall past the watchdog's timeout: one ``hang_suspected``,
    resolved once the loop beats again (the timeout well above a step's
    host time, so that only the stall trips it; a short stall two steps
    later keeps the loop alive until the watchdog polls)."""
    out = {}
    for pkg in ("jax", "torch"):
        dog = PKG[pkg]["res"].Watchdog(timeout_s=0.3, poll_s=0.03)
        out[pkg] = _run(pkg, str(tmp_path / pkg), 7,
                        [dict(kind="stall", step=3, duration_s=0.9),
                         dict(kind="stall", step=5, duration_s=0.1)],
                        save_every=7, watchdog=dog)
    assert out["torch"].summary == out["jax"].summary
    assert out["torch"].summary["hang_suspected"] == 1
    sus = logs["torch"].of_kind("hang_suspected")
    assert len(sus) == 1 and sus[0]["last_step"] == 3
    assert len(logs["torch"].of_kind("hang_resolved")) == 1


# ====================================================== checkpoint layer


@pytest.mark.parametrize("interval", [1, 3])
def test_save_decisions_and_retention_match_orbax(tmp_path, interval):
    """The same (step, force) calls through JAX's Orbax manager and the
    port's: each call's return and the committed steps after it."""
    calls = [(0, False), (1, False), (2, False), (2, False), (3, False),
             (4, True), (5, False), (7, False), (6, False), (8, False),
             (9, False), (10, True), (12, False)]
    got = {}
    for pkg in ("jax", "torch"):
        P = PKG[pkg]
        params, opt = P["init"]()
        rows = []
        with P["utils"].CheckpointManager(
                str(tmp_path / pkg), max_to_keep=3,
                save_interval_steps=interval) as mgr:
            for step, force in calls:
                saved = mgr.save(step, P["payload"](params, opt, step),
                                 wait=True, force=force)
                rows.append((step, bool(saved), list(mgr.all_steps())))
        got[pkg] = rows
    assert got["torch"] == got["jax"]


def test_manifest_roundtrip_and_template_drift(tmp_path, logs):
    for pkg in ("jax", "torch"):
        P = PKG[pkg]
        d = str(tmp_path / pkg)
        params, opt = P["init"]()
        zeros5 = jnp.zeros((5,)) if pkg == "jax" else torch.zeros(5)
        with P["res"].GuardedCheckpointManager(d, max_to_keep=4) as mgr:
            mgr.save(0, P["payload"](params, opt), wait=True)
            assert os.path.exists(os.path.join(d, "manifests", "0.json"))
            assert P["res"].verify_checkpoint(d, 0) == []
            assert P["res"].verify_template(
                d, 0, P["payload"](params, opt)) == []
            drift = P["res"].verify_template(d, 0, {"params": {"w": zeros5}})
            assert "leaf ['params']['w']: ckpt ([4], 'float32') vs " \
                "template ([5], 'float32')" in drift
            mgr.save(1, P["payload"](params, opt, 1), wait=True)
            with pytest.raises(ValueError, match="does not match its recorded"):
                P["utils"].auto_resume(mgr, {"params": {"w": zeros5}})
            assert sorted(mgr.all_steps()) == [0, 1]
    assert not os.path.exists(str(tmp_path / "torch") + ".quarantine")
    assert logs["torch"].of_kind("ckpt_quarantine") == []
    tspec = tres.tree_spec(_tpayload(*_tinit()))
    assert [r["path"] for r in tspec] == [
        "['params']['w']", "['params']['b']", "['opt']['params'][0]",
        "['opt']['params'][1]", "['loop']['data_offset']"]


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_corruption_detected_and_quarantined(tmp_path, logs, mode):
    for pkg in ("jax", "torch"):
        P = PKG[pkg]
        d = str(tmp_path / pkg)
        params, opt = P["init"]()
        with P["res"].GuardedCheckpointManager(d, max_to_keep=4) as mgr:
            for s in range(3):
                mgr.save(s, P["payload"](params, opt, s), wait=True)
            P["res"].corrupt_checkpoint(d, step=2, mode=mode)
            assert P["res"].verify_checkpoint(d, 2) != []
            with pytest.raises(P["res"].CheckpointCorruptError):
                mgr.restore(2, template=P["payload"](params, opt))
            start, state = P["utils"].auto_resume(mgr,
                                                  P["payload"](params, opt))
            assert start == 2 and int(state["loop"]["data_offset"]) == 1
            assert os.path.isdir(os.path.join(d + ".quarantine", "2"))
            assert mgr.latest_step() == 1
    assert _timeline(logs["torch"]) == _timeline(logs["jax"])


def test_unmanifested_corruption_still_walks_back(tmp_path, logs):
    for pkg in ("jax", "torch"):
        P = PKG[pkg]
        d = str(tmp_path / pkg)
        params, opt = P["init"]()
        with P["utils"].CheckpointManager(d, max_to_keep=4) as mgr:
            for s in range(2):
                mgr.save(s, P["payload"](params, opt, s), wait=True)
            for root, _dirs, files in os.walk(os.path.join(d, "1")):
                for f in files:
                    with open(os.path.join(root, f), "r+b") as fh:
                        fh.truncate(0)
            start, state = P["utils"].auto_resume(mgr,
                                                  P["payload"](params, opt))
            assert start == 1 and int(state["loop"]["data_offset"]) == 0
    assert [e["step"] for e in logs["torch"].of_kind("ckpt_quarantine")] \
        == [1]
    assert _timeline(logs["torch"]) == _timeline(logs["jax"])


def test_manifestless_template_drift_reraises(tmp_path, logs):
    with tutils.CheckpointManager(str(tmp_path), max_to_keep=4) as mgr:
        mgr.save(0, _tpayload(*_tinit()), wait=True)
        with pytest.raises(ValueError, match="[Kk]ey mismatch"):
            tutils.auto_resume(mgr, {"params": {"w": torch.zeros(5)}})
        assert mgr.latest_step() == 0
    assert logs["torch"].of_kind("ckpt_quarantine") == []


def test_transient_oserror_retries_then_reraises(tmp_path, logs):
    for pkg in ("jax", "torch"):
        P = PKG[pkg]
        params, opt = P["init"]()
        with P["utils"].CheckpointManager(str(tmp_path / pkg),
                                          max_to_keep=4) as mgr:
            mgr.save(0, P["payload"](params, opt), wait=True)
            real = mgr.restore
            mgr.restore = lambda *a, **k: (_ for _ in ()).throw(
                OSError("mount gone"))
            with pytest.raises(OSError, match="mount gone"):
                P["utils"].auto_resume(mgr, P["payload"](params, opt))
            mgr.restore = real
            assert mgr.latest_step() == 0
    assert len(logs["torch"].of_kind("ckpt_retry")) == 3
    assert _timeline(logs["torch"]) == _timeline(logs["jax"])


def test_manifests_pruned_stale_and_recycled(tmp_path, logs):
    import shutil

    for pkg in ("jax", "torch"):
        P = PKG[pkg]
        d = str(tmp_path / pkg)
        params, opt = P["init"]()
        with P["res"].GuardedCheckpointManager(d, max_to_keep=2) as mgr:
            for s in range(5):
                mgr.save(s, P["payload"](params, opt, s), wait=True)
            assert sorted(mgr.all_steps()) == [3, 4]
        assert sorted(os.listdir(os.path.join(d, "manifests"))) == [
            "3.json", "4.json"]
        # a fresh run in the same directory: stale manifests pruned
        for s in ("3", "4"):
            shutil.rmtree(os.path.join(d, s))
        with P["res"].GuardedCheckpointManager(d, max_to_keep=3) as mgr2:
            assert os.listdir(os.path.join(d, "manifests")) == []
            mgr2.save(0, P["payload"](params, opt, 7), wait=True)
            assert P["res"].verify_checkpoint(d, 0) == []
            start, state = P["utils"].auto_resume(mgr2,
                                                  P["payload"](params, opt))
            assert start == 1 and int(state["loop"]["data_offset"]) == 7
        # a poisoned checksum is caught; pushed into the past it is stale
        mpath = os.path.join(d, "manifests", "0.json")
        with open(mpath) as f:
            manifest = json.load(f)
        manifest["files"][0]["sha256"] = "0" * 64
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        assert any("checksum" in p for p in P["res"].verify_checkpoint(d, 0))
        manifest["files_max_mtime"] -= 10_000.0
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        assert P["res"].verify_checkpoint(d, 0) == []
    assert logs["torch"].of_kind("ckpt_quarantine") == []


def test_ckpt_manager_ctx_waits_on_exception(tmp_path):
    params, opt = _tinit()
    with pytest.raises(RuntimeError, match="boom"):
        with tutils.CheckpointManager(str(tmp_path), max_to_keep=2) as mgr:
            mgr.save(0, _tpayload(params, opt), wait=False)
            raise RuntimeError("boom")
    with tutils.CheckpointManager(str(tmp_path), max_to_keep=2) as mgr2:
        assert mgr2.latest_step() == 0
    with pytest.raises(NotImplementedError, match="Obs, resilience"):
        mgr2.restore(0, template=_tpayload(params, opt), specs={})


def test_roundtrip_bit_exact_in_place(tmp_path, logs):
    """f32, bf16 and int8 leaves and an AdamW ``state_dict`` come back bit
    for bit INTO the live tensors (the optimizer's references stay
    valid); an asynchronous save holds the values of the moment it was
    called."""
    g = torch.Generator().manual_seed(0)
    params = {"f32": torch.randn(5, 3, generator=g),
              "bf16": torch.randn(4, 2, generator=g).to(torch.bfloat16),
              "blocks": [{"w": torch.randn(3, generator=g)}]}
    q8 = torch.randint(-127, 128, (6,), dtype=torch.int8, generator=g)
    opt = adamw(1e-2).init(params)
    step = make_train_step(
        lambda p, b: (p["f32"].sum() * b + p["bf16"].float().square().sum()
                      + p["blocks"][0]["w"].sum()), adamw(1e-2))
    for _ in range(2):
        step(params, opt, 1.5)
    want = tckpt.to_host({"params": params, "q8": q8, "opt": opt})
    ptrs = [t.data_ptr() for t in (params["f32"], params["bf16"],
                                   params["blocks"][0]["w"], q8)]
    with tutils.CheckpointManager(str(tmp_path), max_to_keep=2) as mgr:
        mgr.save(2, {"params": params, "q8": q8, "opt": opt}, wait=False)
        step(params, opt, 1.5)  # trains in place while the write runs
        q8.zero_()
        mgr.wait_until_finished()
        got = mgr.restore(2, template={"params": params, "q8": q8,
                                       "opt": opt})
    assert got["opt"] is opt and all(
        got["params"][k] is params[k] for k in ("f32", "bf16"))
    assert ptrs == [t.data_ptr() for t in (params["f32"], params["bf16"],
                                           params["blocks"][0]["w"], q8)]
    for a, b in ((params["f32"], want["params"]["f32"]),
                 (params["bf16"], want["params"]["bf16"]),
                 (params["blocks"][0]["w"], want["params"]["blocks"][0]["w"]),
                 (q8, want["q8"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    sd, wsd = opt.state_dict(), want["opt"][tckpt.OPTIMIZER_KEY]
    for i, st in wsd["state"].items():
        for k, v in st.items():
            assert torch.equal(sd["state"][i][k].cpu(), v), (i, k)
    # the restored optimizer still steps the live leaves
    before = params["f32"].clone()
    step(params, opt, 1.5)
    assert not torch.equal(before, params["f32"])
    assert [e["step"] for e in logs["torch"].of_kind(
        "checkpoint_restore")] == [2]


def test_one_shot_checkpoint_and_mp_suffix(tmp_path):
    """``save_checkpoint`` / ``load_checkpoint`` (host tree, or into a
    template in place; ``force``; the resharding restore refused) and
    ``get_mp_ckpt_suffix`` over a layout-only ``tpc``."""
    from torchdistpackage_tpu_torch.dist import tpc

    params, opt = _tinit()
    _tstep(params, opt, _tbatch(0))
    path = str(tmp_path / "one")
    tutils.save_checkpoint(path, _tpayload(params, opt, 5))
    with pytest.raises(FileExistsError):
        tutils.save_checkpoint(path, _tpayload(params, opt), force=False)
    host = tutils.load_checkpoint(path)
    assert torch.equal(host["params"]["w"], params["w"])
    assert host["loop"]["data_offset"] == 5
    fresh, fopt = _tinit()
    got = tutils.load_checkpoint(path, template=_tpayload(fresh, fopt))
    assert got["params"]["w"] is fresh["w"] and torch.equal(fresh["w"],
                                                            params["w"])
    assert got["loop"]["data_offset"] == 5
    with pytest.raises(NotImplementedError, match="resharding"):
        tutils.load_checkpoint(path, template=_tpayload(fresh, fopt),
                               specs={})
    assert tutils.get_mp_ckpt_suffix() == ""
    try:
        tpc.setup_process_groups([("pipe", 2), ("tensor", 2)],
                                 world_size=4, rank=3)
        c = tpc.coords()
        assert tutils.get_mp_ckpt_suffix() == \
            f"_tp_{c['tensor']}_pp_{c['pipe']}" == "_tp_1_pp_1"
    finally:
        tpc.reset()


# ================================================ the abort after a walk-back


def _abort_faults(corrupt):
    """A rollback at 4 (4 -> 3, offset 1), a stall at 7 so the async
    saves commit, the checkpoints ``corrupt`` damaged, then a second
    divergence at 7 with the budget spent: an abort whose walk-back
    passes the rollback's target."""
    return ([dict(kind="nan_spike", step=4),
             dict(kind="stall", step=7, duration_s=1.0)]
            + [dict(kind="ckpt_corrupt", step=7, target_step=c)
               for c in corrupt]
            + [dict(kind="nan_spike", step=7)])


@pytest.mark.parametrize("keep,corrupt", [(1, (5,)), (2, (5, 3)),
                                          (4, (5, 3))])
def test_abort_after_walk_back_replays_each_step_at_its_offset(
        tmp_path, logs, keep, corrupt):
    """The walk-back after the abort passes the last rollback's target
    (corrupt checkpoints quarantined, older ones pruned under
    ``max_to_keep``): the port's last healthy state equals the
    reference's — steps 0-3 at offset 0, 4-6 at offset 1 — to 1e-6.  The
    port's abort reads the checkpoints, so its timeline has the
    walk-back's quarantines and a restore after ``resilience_abort``
    where the reference's has none."""
    kw = dict(faults=_abort_faults(corrupt), mgr_kw=dict(max_to_keep=keep),
              save_every=2, max_rollbacks=1)
    out = {pkg: _run(pkg, str(tmp_path / pkg / "run"), 10, **kw)
           for pkg in ("jax", "torch")}
    j, t = out["jax"], out["torch"]
    assert t.aborted and t.verdict == j.verdict == "aborted"
    assert t.summary == j.summary and t.summary["data_offset"] == 1
    tl, jl = _timeline(logs["torch"]), _timeline(logs["jax"])
    i = [e[0] for e in tl].index("resilience_abort")
    extra = [e for e in tl[i + 1:]
             if e[0] in ("ckpt_quarantine", "checkpoint_restore")]
    assert [e for e in tl if e not in extra] == jl
    assert sum(e[0] == "ckpt_quarantine" for e in extra) == len(corrupt)
    assert sorted(t.losses) == sorted(j.losses) == list(range(7))
    # the reference's state is its hand run of the lineage: 0-3 at offset
    # 0, 4-6 at offset 1 — and the port's is its own, bit for bit
    jp, jo = _jinit()
    for s in range(7):
        jp, jo, _ = _jstep(jp, jo, _np_batch(s + (s >= 4)))
    for k in ("w", "b"):
        assert np.array_equal(_np(j.params[k]), np.asarray(jp[k])), k
    losses, params, opt = _hand(range(4))
    more, params, _ = _hand(range(4, 7), params, opt, offset=1)
    _same(params, t.params)
    assert t.losses == {**losses, **more}
    np.testing.assert_allclose(_np(t.params["w"]), _np(j.params["w"]),
                               rtol=0, atol=1e-6)
    # b: the two frameworks' f32 AdamW over these 7 steps by hand round
    # 1.72e-6 apart (w 5.8e-7); the fault put the port 0.05 off
    np.testing.assert_allclose(_np(t.params["b"]), _np(j.params["b"]),
                               rtol=0, atol=2e-6)


def test_abort_replay_older_than_the_run_raises(tmp_path, logs):
    """A resumed run whose every checkpoint is lost by the abort: the
    steps before the resume ran in another run, their offsets were never
    recorded, and the loop raises instead of returning a state the run
    never had."""
    d = str(tmp_path / "run")
    res = _run("torch", d, 4, save_every=2, mgr_kw=dict(max_to_keep=1))
    assert res.verdict == "clean"
    faults = [dict(kind="stall", step=6, duration_s=1.0),
              dict(kind="ckpt_corrupt", step=6, target_step=5),
              dict(kind="nan_spike", step=6)]
    with pytest.raises(RuntimeError, match="cannot be rebuilt"):
        _run("torch", d, 10, faults, mgr_kw=dict(max_to_keep=1),
             save_every=2, max_rollbacks=0)
