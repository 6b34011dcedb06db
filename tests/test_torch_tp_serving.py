"""The port's tensor-parallel decoding at tp 2 over gloo against the JAX
package's on its CPU mesh.

One launch of 2 ``tests/_torch_tp_worker.py`` processes (job ``serve``)
runs every case; the JAX side runs here.  Weights are JAX's init carried
over by ``params_from_jax(tp_rank=, tp_size=2)``:

- ``paged_forward`` over a 4-row prefill chunk of two prompts, the
  vocabulary slices gathered, against JAX's ``paged_forward`` (f32,
  rtol / atol 5e-5), and the pool holding ``Hkv / 2`` heads
  (``expected_pool_bytes(axis_size=2)``), for the gqa and sliding
  families of ``tests/test_serving.py``;
- the TP engine's greedy tokens on four requests equal to JAX's engine
  on a ``tensor`` 2 mesh (``ServingEngine(mesh=, axis='tensor')``, as
  JAX ``tests/test_serving.py:194-214`` builds it, without ``dp_axis``);
- ``generate(tp_group=)`` tokens equal to JAX's ``generate(axis=
  'tensor')`` under ``shard_map``: the dense Llama, the MoE family (the
  router and experts replicated, ``gpt_moe_param_specs``) and the int8
  KV cache (JAX ``tests/test_generate.py:410``).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from torchdistpackage_tpu.compat import shard_map
from torchdistpackage_tpu.dist import tpc as jtpc
from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import generate as jgenerate
from torchdistpackage_tpu.models import gpt_moe_param_specs as jmoe_specs
from torchdistpackage_tpu.models import gpt_param_specs as jspecs
from torchdistpackage_tpu.models import init_gpt_moe_params as jinit_moe
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.models import llama_config as jllama
from torchdistpackage_tpu.serving import Request as JRequest
from torchdistpackage_tpu.serving import ServingEngine as JEngine
from torchdistpackage_tpu.serving.paged_cache import init_paged_kv as jpool
from torchdistpackage_tpu.serving.paged_cache import paged_forward as jpaged

sys.path.insert(0, str(Path(__file__).parent))
import _torch_tp_worker as W  # noqa: E402

WORKER = str(Path(__file__).parent / "_torch_tp_worker.py")
TP = 2
LOGIT_TOL = dict(rtol=5e-5, atol=5e-5)
PROMPT = 5  # chunk 4 < PROMPT: the prefill chunks (tests/test_serving.py)


def jcfg(name, table):
    kind, kw = table[name]
    if kind == "gpt":
        return JGPTConfig(**kw, dtype=jnp.float32)
    return jllama(**kw, dtype=jnp.float32)


def _mesh():
    jtpc.reset()
    jtpc.setup_process_groups([("tensor", TP)], devices=jax.devices()[:TP])
    return jtpc.get_view()


def _shard(params, specs, mesh):
    return jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), params, specs)


@pytest.fixture(scope="module")
def inputs():
    out, params = {}, {}
    for fam in W.SERVE_CFGS:
        params[fam] = jinit(jax.random.PRNGKey(0), jcfg(fam, W.SERVE_CFGS))
        two = np.stack([np.asarray(jax.random.randint(
            jax.random.PRNGKey(10 + i), (PROMPT,), 0, 64)) for i in range(2)])
        out[f"serve/{fam}/prompts"] = np.concatenate(
            [two, two[::-1]]).astype(np.int32)
    for fam in W.GEN_CFGS:
        cfg = jcfg(fam, W.GEN_CFGS)
        init = jinit_moe if cfg.moe_experts else jinit
        params[fam] = init(jax.random.PRNGKey(0), cfg)
    out["gen/prompt"] = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (2, PROMPT), 0, 64)).astype(np.int32)
    for fam, tree in params.items():
        table = "serve" if fam in W.SERVE_CFGS else "gen"
        out.update({f"{table}/{fam}/params/{k}": v for k, v in
                    W.flatten(jax.tree.map(np.asarray, tree)).items()})
    return out, params


@pytest.fixture(scope="module")
def world2(tmp_path_factory, inputs):
    tmp = tmp_path_factory.mktemp("tpserve")
    np.savez(tmp / "in.npz", **inputs[0])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, "serve", str(r), str(TP),
         f"file://{tmp / 'store'}", str(tmp / "in.npz"), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(TP)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(TP)]


@pytest.mark.parametrize("fam", list(W.SERVE_CFGS))
def test_paged_forward_logits_and_pool(world2, inputs, fam):
    """The gathered logits of a 4-row prefill chunk against JAX's
    ``paged_forward`` on the same pool layout; each rank's pool holds
    its ``Hkv / tp`` heads."""
    from torchdistpackage_tpu_torch.models import llama_config
    from torchdistpackage_tpu_torch.serving.paged_cache import (
        expected_pool_bytes,
    )

    inp, params = inputs
    cfg = jcfg(fam, W.SERVE_CFGS)
    tables = jnp.arange(1, 9, dtype=jnp.int32).reshape(2, 4)
    prompts = inp[f"serve/{fam}/prompts"]
    _, want = jpaged(params[fam], jnp.asarray(prompts[:2, :4]), cfg,
                     jpool(cfg, 9, 4), tables, jnp.zeros(2, jnp.int32),
                     all_logits=True)
    tcfg = llama_config(**W.SERVE_CFGS[fam][1], dtype=torch.float32)
    pool = expected_pool_bytes(tcfg, 9, 4, axis_size=TP)
    assert 2 * pool == expected_pool_bytes(tcfg, 9, 4)
    for r, out in enumerate(world2):
        np.testing.assert_allclose(out[f"paged/{fam}/logits"],
                                   np.asarray(want), **LOGIT_TOL,
                                   err_msg=f"{fam} rank {r}")
        assert int(out[f"paged/{fam}/pool_bytes"]) == pool
        got, expected = out[f"engine/{fam}/pool"]
        assert got == expected


@pytest.mark.parametrize("fam", list(W.SERVE_CFGS))
def test_tp_engine_tokens_equal_jax_tp_engine(world2, inputs, fam):
    """Greedy tokens of the port's ``ServingEngine(tp_group=)`` on four
    requests equal JAX's engine on a ``tensor`` 2 mesh, on both ranks."""
    inp, params = inputs
    cfg = jcfg(fam, W.SERVE_CFGS)
    mesh = _mesh()
    eng = JEngine(_shard(params[fam], jspecs(cfg, tp_axis="tensor"), mesh),
                  cfg, num_slots=4, block_size=4, chunk=4, mesh=mesh,
                  axis="tensor")
    rids = [eng.submit(JRequest(p.tolist(), W.SERVE_NEW))
            for p in inp[f"serve/{fam}/prompts"]]
    eng.run_until_idle(max_ticks=500)
    want = np.stack([eng.finished[r]["tokens"] for r in rids])
    jtpc.reset()
    for r, out in enumerate(world2):
        np.testing.assert_array_equal(out[f"engine/{fam}/tokens"], want,
                                      err_msg=f"{fam} rank {r}")


@pytest.mark.parametrize("case", list(W.GEN_CASES))
def test_tp_generate_equals_jax_generate_axis(world2, inputs, case):
    """``generate(tp_group=)`` tokens equal JAX's ``generate(axis=
    'tensor')`` under ``shard_map`` on a ``tensor`` 2 mesh."""
    inp, params = inputs
    fam, quant = W.GEN_CASES[case]
    cfg = jcfg(fam, W.GEN_CFGS)
    mesh = _mesh()
    specs = (jmoe_specs if cfg.moe_experts else jspecs)(cfg, tp_axis="tensor")
    want = np.asarray(jax.jit(shard_map(
        lambda p, t: jgenerate(p, t, cfg, max_new_tokens=W.GEN_NEW,
                               axis="tensor", kv_quant=quant),
        mesh=mesh, in_specs=(specs, P()), out_specs=P()))(
        _shard(params[fam], specs, mesh), jnp.asarray(inp["gen/prompt"])))
    jtpc.reset()
    for r, out in enumerate(world2):
        np.testing.assert_array_equal(out[f"gen/{case}/tokens"], want,
                                      err_msg=f"{case} rank {r}")
