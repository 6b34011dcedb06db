"""The Router's long-prompt tier at cp 2, two processes over gloo,
against JAX's ``tests/test_cp_prefill.py::test_cp_prefill_tier_handoff``:
a CP prefill replica (each rank holding half the pool's blocks) rings
two prompts to their first token, the Router hands each to a plain
decode replica, and

- the greedy tokens equal JAX's single-replica engine (the oracle that
  JAX test holds its own CP fleet to) and JAX's CP fleet;
- the two ``kv_handoff_long`` events equal the JAX fleet's (``cp`` 2,
  ``length``, ``n_blocks``, ``bytes``, ``src_replica``, ``dst_replica``);
- the CP replica only prefills and the decode replica only decodes;
- each export gathered its blocks over the group once (the export no
  longer indexes blocks outside the rank's slice: the decode replica's
  tokens would differ);
- the audit is green after every tick, ``_validate_router`` is clean,
  and a second decode target or an Autoscaler is refused by name.

Nothing here reads the host clock: the fleet has one submit and one
import target.  The workers (``tests/_torch_fleet_worker.py``) import
no JAX.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_cp_worker as CPW
import _torch_fleet_worker as W
from torchdistpackage_tpu.dist import tpc
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.models import llama_config as jllama
from torchdistpackage_tpu.obs.events import EventLog as JEventLog
from torchdistpackage_tpu.obs.events import \
    set_default_event_log as jset_default_log
from torchdistpackage_tpu.serving import Request as JRequest
from torchdistpackage_tpu.serving import Router as JRouter
from torchdistpackage_tpu.serving import ServingEngine as JEngine

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_fleet_worker.py")
WORLD = 2


@pytest.fixture(scope="module")
def jax_fleet():
    """JAX's weights and prompts (the gqa family and prompts of
    tests/test_cp_prefill.py), its single-replica engine's tokens, and
    its own CP prefill -> decode fleet's tokens and events."""
    cfg = jllama(**W.FAMILY, dtype=jnp.float32)
    params = jinit(jax.random.PRNGKey(0), cfg)
    prompts = np.stack([np.asarray(jax.random.randint(
        jax.random.PRNGKey(10 + i), (9,), 0, cfg.vocab_size))
        for i in range(2)]).astype(np.int32)
    eng = JEngine(params, cfg, **W.ENGINE)
    rids = [eng.submit(JRequest(p.tolist(), W.NEW)) for p in prompts]
    eng.run_until_idle(max_ticks=500)
    want = [np.asarray(eng.finished[r]["tokens"]) for r in rids]

    log = JEventLog()
    jset_default_log(log)
    try:
        tpc.setup_process_groups([("context", WORLD)],
                                 devices=jax.devices()[:WORLD])
        pre = JEngine(params, cfg, mesh=tpc.get_view(), cp_axis="context",
                      attn_impl="gather", **W.ENGINE)
        dec = JEngine(params, cfg, **W.ENGINE)
        router = JRouter([pre, dec], roles=["prefill", "decode"],
                         long_ctx_threshold=W.THRESHOLD)
        jrids = [router.submit(JRequest(p.tolist(), W.NEW))
                 for p in prompts]
        router.run_until_idle()
    finally:
        jset_default_log(None)
        tpc.reset()
    return {"np": jax.tree.map(np.asarray, params), "prompts": prompts,
            "want": want,
            "fleet_tokens": [np.asarray(router.finished[r]["tokens"])
                             for r in jrids],
            "long_events": [[e[k] for k in W.LONG_FIELDS]
                            for e in log.as_list()
                            if e["kind"] == "kv_handoff_long"]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_fleet):
    d = tmp_path_factory.mktemp("fleet_cp")
    inp = {f"params/{k}": v for k, v in CPW.flatten(jax_fleet["np"]).items()}
    inp["prompts"] = jax_fleet["prompts"]
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD),
         f"file://{d / 'store'}", str(d / "in.npz"), str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def test_cp2_handoff_tokens_equal_jax(jax_fleet, ranks):
    for w, f in zip(jax_fleet["want"], jax_fleet["fleet_tokens"]):
        np.testing.assert_array_equal(w, f)  # JAX's own fleet: the oracle
    for r, out in enumerate(ranks):
        for i, w in enumerate(jax_fleet["want"]):
            np.testing.assert_array_equal(
                out[f"tokens{i}"], w, err_msg=f"rank {r} request {i}")
        assert out["replica"].tolist() == [1, 1]


def test_cp2_kv_handoff_long_events_equal_jax(jax_fleet, ranks):
    want = jax_fleet["long_events"]
    assert len(want) == 2
    for out in ranks:
        assert out["long_events"].tolist() == want
        for src, dst, length, n_blocks, nbytes, cp in want:
            assert (src, dst, cp) == (0, 1, 2)
            assert length >= W.THRESHOLD and nbytes > 0
            assert n_blocks == -(-(9 + 1) // W.ENGINE["block_size"])


def test_cp2_tiers_gather_audit_and_summary(ranks):
    for out in ranks:
        pre_dec, pre_pf, dec_pf, dec_dec, out_n, in_n = out["tiers"]
        assert pre_dec == 0 and pre_pf > 0
        assert dec_pf == 0 and dec_dec > 0
        assert out_n == in_n == 2
        assert int(out["cp_export_gathers"]) == 2
        assert bool(out["audits_ok"]) and bool(out["pools_conserved"])
        assert json.loads(str(out["validation"])) == []
        assert int(out["pre_cp"]) == 2
    assert ranks[0]["migration_bytes"] == ranks[1]["migration_bytes"] > 0


def test_cp2_grouped_router_refusals(ranks):
    for out in ranks:
        msgs = json.loads(str(out["refusals"]))
        assert len(msgs) == 2
        assert all("host clock" in m for m in msgs)
        assert "Autoscaler" in msgs[1]
