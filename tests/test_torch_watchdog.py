"""The port's hang watchdog and cross-process guards on the CPU,
against the JAX package's ``resilience/watchdog.py``:

- ``config_fingerprint`` and ``code_fingerprint`` equal JAX's on the
  same inputs, ``param_checksum`` agrees to 1e-6 relative on the same
  weights, and the fingerprint vector and the gathered verdict equal
  JAX's (its ``_gathered`` seam);
- ONE spawned world of two JAX-free processes over gloo
  (``tests/_torch_watchdog_worker.py``): ``check_consistency`` agrees,
  then names ``params`` in ``desync_detected`` once rank 1's weights
  drift by one element; ``cross_host_step_stats`` names the slow rank
  in a ``straggler`` event; ``Telemetry.finalize``'s ``hosts`` section
  is the same gather;
- the heartbeat thread: a gap raises ``hang_suspected``, a beat
  ``hang_resolved``, and ``abort=True`` calls the (replaced) exit hook
  after ``hang_abort``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_watchdog_worker as W
from torchdistpackage_tpu.resilience import watchdog as jwd
from torchdistpackage_tpu_torch.obs import EventLog, set_default_event_log
from torchdistpackage_tpu_torch.resilience import (
    Watchdog,
    check_consistency,
    code_fingerprint,
    config_fingerprint,
    consistency_fingerprint,
    param_checksum,
)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_watchdog_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


@dataclasses.dataclass
class _Cfg:
    dim: int = 64
    name: str = "x"


@pytest.mark.parametrize("obj", [
    W.CONFIG, "a string", 7, [1, 2.5, None], {"nested": {"z": 1, "a": 2}},
    _Cfg()], ids=["dict", "str", "int", "list", "nested", "dataclass"])
def test_config_fingerprint_equal_jax(obj):
    assert config_fingerprint(obj) == jwd.config_fingerprint(obj)


def test_code_fingerprint_equal_jax():
    for sub in ("torchdistpackage_tpu_torch/obs",
                "torchdistpackage_tpu/resilience"):
        root = os.path.join(REPO, sub)
        assert code_fingerprint(root) == jwd.code_fingerprint(root)
    # the default is the port's own package, hashed once a process
    own = os.path.join(REPO, "torchdistpackage_tpu_torch")
    assert code_fingerprint() == code_fingerprint(own)


def _tree(seed):
    rs = np.random.RandomState(seed)
    return {"embed": rs.randn(32, 16).astype(np.float32),
            "blocks": [{"w": rs.randn(16, 16).astype(np.float32),
                        "b": rs.randn(16).astype(np.float32)}
                       for _ in range(3)],
            "scale": rs.randn(16).astype(np.float16)}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def test_param_checksum_agrees_with_jax():
    for seed in range(3):
        tree = _tree(seed)
        want = jwd.param_checksum(_map(tree, jnp.asarray))
        got = param_checksum(_map(tree, torch.from_numpy))
        assert got == pytest.approx(want, rel=1e-6) and got > 0


def test_fingerprint_and_verdict_equal_jax():
    tree = _tree(0)
    kw = dict(step=11, config=W.CONFIG)
    got = consistency_fingerprint(params=_map(tree, torch.from_numpy), **kw)
    want = jwd.consistency_fingerprint(params=_map(tree, jnp.asarray), **kw)
    assert got[0] == want[0] == ["step", "config_a", "config_b", "params"]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    rows = np.asarray([got[1], got[1], got[1]])
    rows[2, 3] += 1.0
    for bad in (rows[:2], rows):
        g = check_consistency(_gathered=bad, event_log=EventLog(), **kw,
                              params=_map(tree, torch.from_numpy))
        j = jwd.check_consistency(_gathered=bad, event_log=EventLog(), **kw,
                                  params=_map(tree, jnp.asarray))
        assert (g["ok"], g["mismatched"], g["n_hosts"]) == (
            j["ok"], j["mismatched"], j["n_hosts"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("watchdog")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD),
         f"file://{d / 'store'}", str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [json.loads((d / f"rank{r}.json").read_text())
            for r in range(WORLD)]


def test_consistency_agrees_then_names_the_drifted_params(ranks):
    for out in ranks:
        assert out["agree"]["ok"] and out["agree"]["n_hosts"] == WORLD
        assert out["agree"]["labels"] == [
            "step", "config_a", "config_b", "code_a", "code_b", "params"]
        assert out["drift"]["mismatched"] == ["params"]
        desync = [e for e in out["events"] if e["kind"] == "desync_detected"]
        assert len(desync) == 1 and desync[0]["mismatched"] == ["params"]
        a, b = desync[0]["per_host"]["params"]
        assert a != b and abs(a - b) < 1e-2
    assert ranks[0]["drift"] == ranks[1]["drift"]


def test_cross_host_stats_name_the_straggler(ranks):
    for out in ranks:
        h = out["hosts"]
        assert h["n_hosts"] == WORLD and h["straggler"] == 1
        assert [p["mean"] for p in h["per_host"]] == [W.STEP_S,
                                                      W.SLOW * W.STEP_S]
        ev = [e for e in out["events"] if e["kind"] == "straggler"]
        assert len(ev) == 1 and ev[0]["host"] == 1
        assert out["report_hosts"]["n_hosts"] == WORLD
        assert out["n_processes"] == WORLD


@pytest.fixture()
def default_log():
    log = EventLog()
    set_default_event_log(log)
    yield log
    set_default_event_log(None)


def _wait(cond, timeout=3.0):
    t0 = time.perf_counter()
    while not cond() and time.perf_counter() - t0 < timeout:
        threading.Event().wait(0.01)
    return cond()


def test_watchdog_suspects_resolves_and_aborts(default_log):
    with Watchdog(timeout_s=0.1, poll_s=0.02) as dog:
        dog.beat(0)
        assert _wait(lambda: default_log.of_kind("hang_suspected"))
        dog.beat(1)
        assert _wait(lambda: default_log.of_kind("hang_resolved"))
    assert dog.n_suspected == 1 and dog._thread is None
    exits = []
    with Watchdog(timeout_s=0.05, poll_s=0.01, abort=True,
                  abort_grace_s=0.05, exit_code=9,
                  _exit=exits.append) as dog:
        dog.beat(4)
        assert _wait(lambda: exits)
    assert exits == [9]
    ab = default_log.of_kind("hang_abort")
    assert len(ab) == 1 and ab[0]["last_step"] == 4
