"""The port's serving compositions at world 4 over gloo against the JAX
package: data-parallel slot groups beside tensor parallelism, tensor
parallelism beside expert parallelism and beside context parallelism,
and data groups beside expert groups.

One launch of 4 ``tests/_torch_compose_worker.py`` processes runs every
case (see its docstring); the JAX side runs here, on the conftest's CPU
devices.  Weights are JAX's init carried over by ``params_from_jax``:

- data 2 x tensor 2: the engine's greedy tokens on four requests equal
  JAX's ``ServingEngine(mesh=, axis='tensor', dp_axis='data')`` (built
  as JAX ``tests/test_serving.py:194-228`` builds it) for the gqa and
  sliding families, and its ``dp_groups``, per-group ``num_blocks`` and
  pool bytes equal JAX's; with the prefix cache and ``spec_k`` on,
  drained mid-run and resumed, the tokens are the same;
- tensor 2 x moe_ep 2: the layer stack's logits equal JAX's
  ``forward_cached_moe(axis='tensor', ep_axis='moe_ep')`` under
  ``shard_map(check_vma=False)`` (f32, rtol / atol 5e-5), and
  ``generate`` and the engine equal JAX's serial runs (JAX's EP engine
  does not run on jax 0.9, ROADMAP C);
- context 2 x tensor 2: the engine equals JAX's serial oracle of
  ``tests/test_cp_prefill.py:154-171`` (gqa);
- moe_dp 2 x moe_ep 2: the engine equals JAX's serial engine;
- the planted faults fail, and every grouped engine refuses
  ``deadline_s`` (the rule for decisions that read the host clock).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from torchdistpackage_tpu.compat import shard_map
from torchdistpackage_tpu.dist import tpc as jtpc
from torchdistpackage_tpu.models import generate as jgenerate
from torchdistpackage_tpu.models import gpt_moe_param_specs as jmoe_specs
from torchdistpackage_tpu.models import gpt_param_specs as jspecs
from torchdistpackage_tpu.models import init_gpt_moe_params as jinit_moe
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.models import llama_config as jllama
from torchdistpackage_tpu.models.generate import _full_logits as jfull
from torchdistpackage_tpu.models.generate import (
    forward_cached_moe as jforward_moe,
)
from torchdistpackage_tpu.models.generate import init_kv_cache as jcache
from torchdistpackage_tpu.serving import Request as JRequest
from torchdistpackage_tpu.serving import ServingEngine as JEngine

sys.path.insert(0, str(Path(__file__).parent))
import _torch_compose_worker as W  # noqa: E402
from _torch_ep_worker import flatten  # noqa: E402

WORKER = str(Path(__file__).parent / "_torch_compose_worker.py")
LOGIT_TOL = dict(rtol=5e-5, atol=5e-5)
PROMPT, CP_PROMPT = 5, 9


def jcfg(name):
    return jllama(**W.CFGS[name], dtype=jnp.float32)


def _serve(eng, prompts, new):
    rids = [eng.submit(JRequest(p.tolist(), new)) for p in prompts]
    eng.run_until_idle(max_ticks=500)
    return np.stack([np.asarray(eng.finished[r]["tokens"]) for r in rids])


def _prompts(n, length, seed0=10):
    return np.stack([np.asarray(jax.random.randint(
        jax.random.PRNGKey(seed0 + i), (length,), 0, 64))
        for i in range(n)]).astype(np.int32)


@pytest.fixture(scope="module")
def inputs():
    out, params = {}, {}
    for fam in ("gqa", "sliding", "cp_gqa"):
        params[fam] = jinit(jax.random.PRNGKey(0), jcfg(fam))
    params["mixtral"] = jinit_moe(jax.random.PRNGKey(0), jcfg("mixtral"))
    two = _prompts(2, PROMPT)
    for fam in W.DP_FAMS:
        out[f"{fam}/prompts"] = np.concatenate([two, two[::-1]])
    out["mixtral/prompt"] = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (2, PROMPT), 0, 64)).astype(np.int32)
    out["mixtral/prompts"] = np.concatenate([two, two[::-1]])
    out["cp_gqa/prompts"] = _prompts(2, CP_PROMPT)
    for fam, tree in params.items():
        out.update({f"{fam}/params/{k}": v for k, v in
                    flatten(jax.tree.map(np.asarray, tree)).items()})
    return out, params


@pytest.fixture(scope="module")
def world4(tmp_path_factory, inputs):
    tmp = tmp_path_factory.mktemp("compose")
    np.savez(tmp / "in.npz", **inputs[0])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(W.WORLD),
         f"file://{tmp / 'store'}", str(tmp / "in.npz"), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(W.WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(W.WORLD)]


@pytest.fixture(scope="module")
def serial(inputs):
    """JAX's serial references: the MoE family's ``generate`` and engine,
    and the CP oracle's engine."""
    inp, params = inputs
    cfg = jcfg("mixtral")
    out = {
        "generate": np.asarray(jgenerate(
            params["mixtral"], jnp.asarray(inp["mixtral/prompt"]), cfg,
            max_new_tokens=W.GEN_NEW)),
        "engine": _serve(JEngine(params["mixtral"], cfg, **W.ENGINE),
                         inp["mixtral/prompts"], W.NEW),
        "cp": _serve(JEngine(params["cp_gqa"], jcfg("cp_gqa"),
                             **W.CP_ENGINE), inp["cp_gqa/prompts"], W.CP_NEW),
    }
    cache = jcache(cfg, 2, PROMPT)
    out["logits"] = np.asarray(jforward_moe(
        params["mixtral"], jnp.asarray(inp["mixtral/prompt"]), cfg, cache,
        0)[1])
    return out


@pytest.fixture(scope="module")
def jax_dp(inputs):
    """JAX's ``dp_axis='data'`` engine on a data 2 x tensor 2 mesh, per
    family: its tokens and ``kv_pool`` summary."""
    inp, params = inputs
    out = {}
    for fam in W.DP_FAMS:
        cfg = jcfg(fam)
        jtpc.reset()
        jtpc.setup_process_groups([("data", 2), ("tensor", 2)],
                                  devices=jax.devices()[:4])
        mesh = jtpc.get_view()
        specs = jspecs(cfg, tp_axis="tensor")
        sharded = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
            params[fam], specs)
        eng = JEngine(sharded, cfg, mesh=mesh, axis="tensor",
                      dp_axis="data", **W.ENGINE)
        assert eng.dp == 2 and eng.slots_per_group == 2
        out[fam] = (_serve(eng, inp[f"{fam}/prompts"], W.NEW),
                    eng.serving_summary()["kv_pool"], eng)
    jtpc.reset()
    return out


@pytest.mark.parametrize("fam", W.DP_FAMS)
def test_dp_tp_engine_tokens_equal_jax_dp_engine(world4, jax_dp, fam):
    """data 2 x tensor 2: every rank's greedy tokens equal JAX's
    ``dp_axis='data'`` engine's, the pool is conserved, one decode
    signature."""
    want = jax_dp[fam][0]
    for r, out in enumerate(world4):
        np.testing.assert_array_equal(out[f"dptp/{fam}/tokens"], want,
                                      err_msg=f"{fam} rank {r}")
        ok, *in_use = out[f"dptp/{fam}/audit"]
        assert ok and in_use == [0, 0]
        assert out[f"dptp/{fam}/pool"][-1] == 1


@pytest.mark.parametrize("fam", W.DP_FAMS)
def test_dp_tp_summary_equals_jax(world4, jax_dp, fam):
    """``dp_groups``, the per-group ``num_blocks`` and the pool's bytes
    equal JAX's: each rank holds one group's pool at ``Hkv / tp`` heads,
    so ``dp x tp`` ranks' slices make JAX's global pool."""
    _, pool, eng = jax_dp[fam]
    for r, out in enumerate(world4):
        dp, nb, mine, expected, every, spg, _ = out[f"dptp/{fam}/pool"]
        assert (dp, nb, spg) == (pool["dp_groups"], pool["num_blocks"],
                                 eng.slots_per_group), f"rank {r}"
        assert mine == expected
        assert every == pool["pool_bytes"] == pool["pool_bytes_expected"]
        assert dp * 2 * mine == pool["pool_bytes"]


@pytest.mark.parametrize("fam", W.DP_FAMS)
def test_dp_tp_features_per_group(world4, jax_dp, fam):
    """The prefix cache and ``spec_k`` under data groups, drained after
    four ticks (descriptors naming both groups) and resumed: every
    request's greedy tokens equal JAX's DP engine's for its prompt."""
    want = {tuple(row[:PROMPT]): row for row in jax_dp[fam][0]}
    for r, out in enumerate(world4):
        got = out[f"dptp/{fam}/features"]
        assert len(got) == 8
        for row in got:
            np.testing.assert_array_equal(row, want[tuple(row[:PROMPT])],
                                          err_msg=f"{fam} rank {r}")
        hits, drafted, n, groups = out[f"dptp/{fam}/features_stats"]
        assert hits > 0 and drafted > 0 and n == 8 and groups == 2


def test_tp_ep_logits_equal_jax_shard_map(world4, inputs, serial):
    """tensor 2 x moe_ep 2: the gathered last-row logits of
    ``forward_cached_moe(tp_group=, ep_group=)`` against JAX's on the
    MoE view under ``shard_map(check_vma=False)``, and both against the
    serial forward."""
    inp, params = inputs
    cfg = jcfg("mixtral")
    jtpc.reset()
    jtpc.setup_process_groups([("data", 2), ("tensor", 2)],
                              devices=jax.devices()[:4])
    mesh = jtpc.build_moe_mesh(moe_ep_size=2)
    specs = jmoe_specs(cfg, tp_axis="tensor", ep_axis="moe_ep")
    sharded = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
        params["mixtral"], specs)

    def run(p, t):
        cache = jcache(cfg, 2, PROMPT, axis_size=2)
        _, lg = jforward_moe(p, t, cfg, cache, 0, axis="tensor",
                             ep_axis="moe_ep")
        return jfull(lg, cfg, "tensor")

    want = np.asarray(jax.jit(shard_map(
        run, mesh=mesh, in_specs=(specs, P()), out_specs=P(),
        check_vma=False))(sharded, jnp.asarray(inp["mixtral/prompt"])))
    jtpc.reset()
    np.testing.assert_allclose(want, serial["logits"], **LOGIT_TOL)
    for r, out in enumerate(world4):
        np.testing.assert_allclose(out["tpep/logits"], want, **LOGIT_TOL,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("what", ["generate", "engine"])
def test_tp_ep_tokens_equal_jax_serial(world4, serial, what):
    """``generate(tp_group=, ep_group=)`` and the TP x EP engine (its
    tokens broadcast over the replica group) equal JAX's serial runs
    token for token; the engine refuses the composition without its
    replica group."""
    for r, out in enumerate(world4):
        np.testing.assert_array_equal(out[f"tpep/{what}"], serial[what],
                                      err_msg=f"{what} rank {r}")
        assert out["tpep/needs_replica"]


def test_tp_cp_engine_tokens_equal_jax_serial_oracle(world4, serial):
    """context 2 x tensor 2: the CP engine with ``tp_group`` equals JAX's
    serial oracle; every rank sent as many ring payloads as the engine's
    hop model counts."""
    for r, out in enumerate(world4):
        np.testing.assert_array_equal(out["tpcp/tokens"], serial["cp"],
                                      err_msg=f"rank {r}")
        hops, sent, nbytes, chunks = out["tpcp/ring"]
        assert hops == sent == chunks * 4 * (2 - 1) * 2 and nbytes > 0


def test_dp_ep_engine_tokens_equal_jax_serial(world4, serial):
    """moe_dp 2 x moe_ep 2: data groups beside expert groups; the expert
    load summed over both groups."""
    for r, out in enumerate(world4):
        np.testing.assert_array_equal(out["dpep/engine"], serial["engine"],
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(out["dpep/moe"], world4[0]["dpep/moe"])
        assert out["dpep/moe"].sum() > 0


@pytest.mark.parametrize("fault", ["other_rows", "one_axis",
                                   "experts_split"])
def test_planted_faults_fail(world4, jax_dp, serial, fault):
    """Each planted fault breaks the tokens on some rank: a rank running
    the other data group's rows; a TP x EP engine whose moe_ep rank 1
    sees a perturbed argmax and whose broadcast covers the tensor axis
    only (under the replica group the same perturbation leaves every
    rank on JAX's tokens); the experts also cut over the tensor group."""
    want = {"other_rows": jax_dp["gqa"][0], "one_axis": serial["engine"],
            "experts_split": serial["generate"]}[fault]
    got = [out[f"fault/{fault}"] for out in world4]
    assert any(g.shape != want.shape or not np.array_equal(g, want)
               for g in got), f"planted fault {fault} passed"
    if fault == "one_axis":
        for r, out in enumerate(world4):
            np.testing.assert_array_equal(out["fault/replica"], want,
                                          err_msg=f"replica rank {r}")


def test_grouped_engines_refuse_deadlines(world4):
    """Decisions that read the host clock are refused on every grouped
    engine: DP x TP (both families), TP x EP, TP x CP, DP x EP."""
    for r, out in enumerate(world4):
        assert out["clock/refused"].tolist() == [True] * 5, f"rank {r}"


def test_moe_specs_with_both_axes_match_jax(inputs):
    """``gpt_moe_param_specs(params, ep_axis='moe_ep')`` places every leaf
    as JAX's ``gpt_moe_param_specs(cfg, tp_axis='tensor',
    ep_axis='moe_ep')`` does: a split dim where JAX splits over
    ``tensor``, the axis name on the expert leaves JAX splits over
    ``moe_ep`` (none of them over ``tensor``), replicated elsewhere."""
    from torchdistpackage_tpu_torch.models.gpt_moe import (
        gpt_moe_param_specs,
    )

    _, params = inputs
    tree = params["mixtral"]
    want = jmoe_specs(jcfg("mixtral"), tp_axis="tensor", ep_axis="moe_ep")
    got = gpt_moe_param_specs(jax.tree.map(np.asarray, tree),
                              ep_axis="moe_ep")
    flat_w = dict(jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, P))[0])
    flat_a = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_w.keys() == flat_a.keys()
    for path, spec in flat_w.items():
        g, ndim = flat_g.get(path), flat_a[path].ndim
        if "moe_ep" in spec:
            assert g == "moe_ep" and spec[0] == "moe_ep", path
            assert "tensor" not in spec, path
        elif "tensor" in spec:
            assert isinstance(g, int) and spec[g % ndim] == "tensor", path
        else:
            assert not isinstance(g, int) and g != "moe_ep", path
