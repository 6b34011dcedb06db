"""The port's expert-parallel (EP) MoE serving against the JAX package, on
the CPU, in f32 at small widths.

- K7's plain version (``fused_expert_ffn`` on CPU tensors) against JAX's
  ``_pallas_expert_ffn`` in interpret mode and ``_ep_ffn_reference``:
  GELU and SwiGLU, float and ``quantize_moe_experts`` int8, a ragged G.
- ``moe_forward`` (the capacity path) against JAX's serial
  ``moe_forward``: the ``'sorted'`` and ``'cuda'`` arms (K6's or K7's
  plain version here), with and without drops, serially and through a
  world-1 gloo group; and at world 4 over gloo, each rank with its OWN
  tokens (replicated tokens would hide an exchange fault), against JAX's
  ``moe_forward(ep_axis=)`` under ``shard_map(check_vma=False)`` on 4 of
  the 8 CPU devices.
- ``paged_forward_moe(ep_group=)`` logits against JAX's serial
  ``paged_forward_moe``.
- The EP engine at world 1 and world 4: greedy tokens EQUAL to JAX's
  serial engine (``moe_dispatch='gather'``; JAX's own
  ``ServingEngine(ep_axis=)`` dies in its step on this JAX), for the GELU
  GPT-MoE and the Mixtral-style Llama, the ranks' tokens equal, and the
  ``moe`` summary equal to JAX's.
- ``shard_moe_params`` / ``params_from_jax(ep_rank=)`` against slices of
  the whole tree, int8 included; the refusals.

World 4 runs as 4 processes of ``tests/_torch_ep_worker.py`` (JAX-free),
started once for the module; world 1 runs in this process.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import _torch_ep_worker as W
from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import init_gpt_moe_params as jinit
from torchdistpackage_tpu.models import llama_config as jllama
from torchdistpackage_tpu.obs.aggregate import moe_load_stats as j_load_stats
from torchdistpackage_tpu.ops import moe_dispatch as jmd
from torchdistpackage_tpu.parallel import moe as jmoe
from torchdistpackage_tpu.serving import Request as JRequest
from torchdistpackage_tpu.serving import ServingEngine as JEngine
from torchdistpackage_tpu.serving import paged_cache as jpc
from torchdistpackage_tpu_torch.dist import build_moe_groups, init_distributed
from torchdistpackage_tpu_torch.models import shard_moe_params
from torchdistpackage_tpu_torch.models.convert import params_from_jax
from torchdistpackage_tpu_torch.obs.aggregate import moe_load_stats
from torchdistpackage_tpu_torch.ops import moe_dispatch as md
from torchdistpackage_tpu_torch.parallel import moe as tmoe
from torchdistpackage_tpu_torch.serving import Request, ServingEngine
from torchdistpackage_tpu_torch.serving import paged_cache as tpc

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_ep_worker.py")
WORLD = 4
FAMILIES = {
    "gpt_moe": lambda: JGPTConfig(**W.GPT_MOE, dtype=jnp.float32),
    "mixtral_style": lambda: jllama(**W.MIXTRAL_STYLE, dtype=jnp.float32),
}
B, S = 2, 6  # each rank's tokens in the layer cases: T = 12


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_t(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _layer_params(act="swiglu", quantized=False, seed=0):
    """JAX-initialised MoE layer params (numpy) with non-zero biases."""
    cfg = jmoe.MoEConfig(**dict(W.LAYER, act=act))
    p = jax.tree.map(np.asarray, jmoe.init_moe_params(
        jax.random.PRNGKey(seed), cfg))
    rs = np.random.RandomState(seed)
    for b in ("b1", "b2"):
        p["experts"][b] = rs.randn(*p["experts"][b].shape).astype(
            np.float32) * 0.1
    if quantized:
        p["experts"] = jax.tree.map(np.asarray, jmd.quantize_moe_experts(
            p["experts"]))
    return p


def _rank_tokens(seed=5):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, S, W.LAYER["dim"]).astype(np.float32)
            for _ in range(WORLD)]


def _jax_cfg(name):
    disp, cf, _ = W.LAYER_CASES[name]
    return jmoe.MoEConfig(**W.LAYER, capacity_factor=cf, dispatch="sorted")


# ------------------------------------------------------------ fixtures


@pytest.fixture(scope="module")
def families():
    """Per family: the JAX config, params and its SERIAL engine's greedy
    tokens and summary (the reference for every EP engine run)."""
    out = {}
    for name, jcfg_fn in FAMILIES.items():
        jcfg = jcfg_fn()
        jparams = jinit(jax.random.PRNGKey(0), jcfg)
        tcfg = W.torch_config(name)
        jeng = JEngine(jparams, jcfg, attn_impl="gather",
                       moe_dispatch="gather", **W.ENGINE)
        want = W.run_staggered(jeng, JRequest, W.prompts(tcfg.vocab_size))
        out[name] = {"jcfg": jcfg, "jparams": jparams, "tcfg": tcfg,
                     "np": jax.tree.map(np.asarray, jparams), "want": want,
                     "jmoe": jeng.serving_summary()["moe"]}
    return out


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A one-rank gloo group in this process, torn down after the
    module."""
    store = tmp_path_factory.mktemp("ep1") / "store"
    init_distributed(f"file://{store}", 1, 0, "cpu")
    try:
        yield build_moe_groups(1)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world4(tmp_path_factory, families):
    """Every world-4 run at once: 4 worker processes over gloo."""
    d = tmp_path_factory.mktemp("ep4")
    inp = {f"x{r}": x for r, x in enumerate(_rank_tokens())}
    inp.update({f"layer_params/{k}": v
                for k, v in W.flatten(_layer_params()).items()})
    for name, fam in families.items():
        inp.update({f"{name}/{k}": v
                    for k, v in W.flatten(fam["np"]).items()})
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


# ------------------------------------------------------------ K7


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_expert_ffn_plain_matches_jax_k7(act, quantized):
    """[e_loc 2, G 13, D]: G is not a multiple of the kernel's 8-row
    tile, and the biases are non-zero, so pad rows are not zero either."""
    p = _layer_params(act, quantized, seed=3)
    ex = {n: v for n, v in p["experts"].items()}
    ex = {n: (tuple(a[:2] for a in v) if isinstance(v, tuple) else v[:2])
          for n, v in ex.items()}  # two local experts
    x = np.random.RandomState(4).randn(2, 13, W.LAYER["dim"]).astype(
        np.float32)
    jex = jax.tree.map(jnp.asarray, ex)
    k7 = np.asarray(jmd._pallas_expert_ffn(jex, jnp.asarray(x)))
    ref = np.asarray(jmd._ep_ffn_reference(jex, jnp.asarray(x)))
    before = dict(md.LAUNCHES)
    got = md.fused_expert_ffn(_t(ex), torch.from_numpy(x))
    assert md.LAUNCHES == before  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == x.shape
    for want in (k7, ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        md.expert_ffn_reference(_t(ex), torch.from_numpy(x)).numpy(), ref,
        rtol=1e-6, atol=1e-6)


def _wide_experts(act, quantized, seed, dim=64, ffn_dim=192):
    """JAX-initialised experts at K7's warpgroup-body widths (D and F
    multiples of 64, F not of the body's 128-column F tile), non-zero
    biases, optionally ``quantize_moe_experts``-ed; two local experts."""
    cfg = jmoe.MoEConfig(dim=dim, ffn_dim=ffn_dim, num_experts=4, top_k=2,
                         act=act)
    ex = jax.tree.map(np.asarray, jmoe.init_moe_params(
        jax.random.PRNGKey(seed), cfg))["experts"]
    rs = np.random.RandomState(seed)
    for b in ("b1", "b2"):
        ex[b] = rs.randn(*ex[b].shape).astype(np.float32) * 0.1
    if quantized:
        ex = jax.tree.map(np.asarray, jmd.quantize_moe_experts(ex))
    return {n: (tuple(a[:2] for a in v) if isinstance(v, tuple) else v[:2])
            for n, v in ex.items()}


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_expert_ffn_plain_matches_jax_k7_at_chunk_rows(act, quantized):
    """The rows K7's warpgroup body takes: [e_loc 2, G 200, D 64] (G a
    ragged 128-row tile past the body's threshold), F 192 (a multiple of
    64, not of the body's 128-column F tile); pad rows included."""
    ex = _wide_experts(act, quantized, seed=6)
    x = np.random.RandomState(7).randn(2, 200, 64).astype(np.float32)
    x[:, 90:115] = 0  # pad rows, as empty capacity slots
    jex = jax.tree.map(jnp.asarray, ex)
    k7 = np.asarray(jmd._pallas_expert_ffn(jex, jnp.asarray(x)))
    ref = np.asarray(jmd._ep_ffn_reference(jex, jnp.asarray(x)))
    before = dict(md.LAUNCHES)
    got = md.fused_expert_ffn(_t(ex), torch.from_numpy(x))
    assert md.LAUNCHES == before  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == x.shape
    for want in (k7, ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("G,dtype,body", [
    (8, torch.bfloat16, "decode"),    # EP 1 decode: [8, 8, 4096]
    (32, torch.bfloat16, "decode"),   # EP 4 decode: [2, 32, 4096]
    (63, torch.bfloat16, "decode"),
    (64, torch.bfloat16, "wgmma"),
    (200, torch.bfloat16, "wgmma"),
    (4096, torch.bfloat16, "wgmma"),  # EP 1 chunk: [8, 4096, 4096]
    (4096, torch.float32, "walk"),    # f32 rows: CUDA-core body only
])
def test_expert_ffn_body_routes_by_rows_and_dtype(G, dtype, body):
    """K7's shape dispatch between its three hand-written bodies: a group
    of at least ``EXPERT_FFN_WGMMA_G_MIN`` bf16 rows takes the chunk
    body, fewer bf16 rows (decode) the decode body, f32 rows the walk."""
    assert md.EXPERT_FFN_WGMMA_G_MIN == 64
    assert md.expert_ffn_body(G, dtype) == body


# ------------------------------------------------------------ moe_forward


def _jax_serial(name, params, x):
    disp, cf, causal = W.LAYER_CASES[name]
    y, aux, met = jmoe.moe_forward(jax.tree.map(jnp.asarray, params),
                                   jnp.asarray(x), _jax_cfg(name),
                                   causal=causal, return_metrics=True)
    return np.asarray(y), float(aux), jax.tree.map(np.asarray, met)


def _assert_layer(got, want, what):
    y, aux, met = got
    wy, waux, wmet = want
    np.testing.assert_allclose(y, wy, rtol=1e-5, atol=1e-6, err_msg=what)
    np.testing.assert_allclose(aux, waux, rtol=1e-6, err_msg=what)
    for k in ("router_entropy", "expert_tokens", "dropped_token_rate"):
        np.testing.assert_allclose(met[k], wmet[k], rtol=1e-6, atol=1e-7,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", sorted(W.LAYER_CASES))
def test_moe_forward_matches_jax_serial(world1, name):
    """Serially and at world 1 (both exchanges are identities), each arm
    against JAX's serial capacity path, drops included; the expert-load
    summary over the metrics equals JAX's."""
    disp, cf, causal = W.LAYER_CASES[name]
    p = _layer_params()
    x = _rank_tokens()[0]
    want = _jax_serial(name, p, x)
    cfg = tmoe.MoEConfig(**W.LAYER, capacity_factor=cf, dispatch=disp)
    for group in (None, world1):
        y, aux, met = tmoe.moe_forward(_t(p), torch.from_numpy(x), cfg,
                                       ep_group=group, causal=causal,
                                       return_metrics=True)
        assert y.dtype == torch.float32 and aux.dtype == torch.float32
        _assert_layer((y.numpy(), float(aux),
                       {k: v.numpy() for k, v in met.items()}), want,
                      f"{name} group={group is not None}")
    assert (float(met["dropped_token_rate"]) > 0) == (cf < 4.0)
    got = moe_load_stats(met["expert_tokens"].tolist(),
                         float(met["dropped_token_rate"]))
    jstats = j_load_stats(np.asarray(want[2]["expert_tokens"]).tolist(),
                          float(want[2]["dropped_token_rate"]))
    for k in jstats:
        np.testing.assert_allclose(got[k], jstats[k], rtol=1e-6, err_msg=k)


def test_moe_forward_auto_resolves_by_device(world1):
    """``'auto'`` is a plain arm on the CPU (``'cuda'`` on the card):
    ``'dense'`` at this size, below ``_DENSE_DISPATCH_MAX`` (JAX's rule
    off the TPU), recorded as a ``moe_dispatch_selected`` event."""
    from torchdistpackage_tpu_torch.obs import default_event_log

    p = _t(_layer_params())
    x = torch.from_numpy(_rank_tokens()[0])
    base = tmoe.MoEConfig(**W.LAYER, capacity_factor=4.0, dispatch="dense")
    want = tmoe.moe_forward(p, x, base, ep_group=world1)[0]
    log = default_event_log()
    n = len(log.as_list())
    got = tmoe.moe_forward(p, x, dataclasses.replace(base, dispatch="auto"),
                           ep_group=world1)[0]
    assert torch.equal(got, want)
    ev = [e for e in log.as_list()[n:] if e["kind"] == "moe_dispatch_selected"]
    assert [e["chosen"] for e in ev] == ["dense"]


@pytest.fixture(scope="module")
def jax_ep4():
    """JAX's EP reference: ``moe_forward(ep_axis='moe_ep')`` under
    ``shard_map(check_vma=False)`` on 4 CPU devices, tokens sharded P(ep)
    (each device its own), experts P(ep); per case, the [4 B, S, D]
    output, each device's aux and metrics."""
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("moe_ep",))
    params = jax.tree.map(jnp.asarray, _layer_params())
    x = jnp.asarray(np.concatenate(_rank_tokens()))
    specs = jmoe.moe_param_specs("moe_ep", act="swiglu")
    out = {}
    for name in W.LAYER_CASES:
        cfg, causal = _jax_cfg(name), W.LAYER_CASES[name][2]

        def f(p, xx, cfg=cfg, causal=causal):
            y, aux, met = jmoe.moe_forward(p, xx, cfg, ep_axis="moe_ep",
                                           causal=causal,
                                           return_metrics=True)
            return y, aux[None], jax.tree.map(lambda a: a[None], met)

        y, aux, met = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(specs, P("moe_ep")),
            out_specs=(P("moe_ep"), P("moe_ep"), P("moe_ep")),
            check_vma=False))(params, x)
        out[name] = (np.asarray(y), np.asarray(aux),
                     jax.tree.map(np.asarray, met))
    return out


@pytest.mark.parametrize("name", sorted(W.LAYER_CASES))
def test_moe_forward_world4_matches_jax_shard_map(world4, jax_ep4, name):
    """Each of 4 ranks feeds its own tokens: rank r's output, aux and
    metrics equal JAX's EP shard r within 1e-5 relative, and JAX's serial
    capacity path on rank r's tokens alone."""
    y, aux, met = jax_ep4[name]
    p = _layer_params()
    xs = _rank_tokens()
    for r in range(WORLD):
        res = world4[r]
        got = (res[f"layer/{name}/y"], float(res[f"layer/{name}/aux"]),
               {k: res[f"layer/{name}/{k}"] for k in
                ("router_entropy", "expert_tokens", "dropped_token_rate")})
        want = (y[r * B:(r + 1) * B], float(aux[r]),
                {k: v[r] for k, v in met.items()})
        _assert_layer(got, want, f"{name} rank {r} vs shard_map")
        _assert_layer(got, _jax_serial(name, p, xs[r]),
                      f"{name} rank {r} vs serial")
    # the ranks' tokens differ, so their outputs do
    assert not np.allclose(world4[0][f"layer/{name}/y"],
                           world4[1][f"layer/{name}/y"])


# ------------------------------------------------------ the serving path


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_paged_forward_moe_ep_matches_jax_serial(families, world1, family):
    """Two slots through a two-chunk prefill at different offsets, then
    two decode steps: the EP forward's logits (both arms, world 1)
    against JAX's serial ragged arm, and the per-step expert counts."""
    fam = families[family]
    jcfg, tcfg = fam["jcfg"], fam["tcfg"]
    tp = params_from_jax(fam["np"], tcfg, device="cpu")
    Bs, BS, MB = 2, 4, 6
    nb = 1 + Bs * MB
    tables = np.arange(1, nb, dtype=np.int32).reshape(Bs, MB)[:, ::-1].copy()
    rs = np.random.RandomState(3)
    steps = [
        (rs.randint(0, 64, (Bs, 8)).astype(np.int32),
         np.asarray([0, 0], np.int32), np.asarray([7, 2], np.int32)),
        (rs.randint(0, 64, (Bs, 8)).astype(np.int32),
         np.asarray([8, 3], np.int32), np.asarray([5, 7], np.int32)),
        (rs.randint(0, 64, (Bs, 1)).astype(np.int32),
         np.asarray([14, 11], np.int32), None),
        (rs.randint(0, 64, (Bs, 1)).astype(np.int32),
         np.asarray([15, 12], np.int32), None),
    ]
    arms = ("gather", "cuda")  # 'gather' runs as 'sorted' under EP
    jcache = jpc.init_paged_kv(jcfg, nb, BS)
    tcaches = {a: tpc.init_paged_kv(tcfg, nb, BS, device="cpu") for a in arms}
    for tokens, offs, last in steps:
        jcache, jlog, jmet = jpc.paged_forward_moe(
            fam["jparams"], jnp.asarray(tokens), jcfg, jcache,
            jnp.asarray(tables), jnp.asarray(offs),
            last_idx=None if last is None else jnp.asarray(last),
            moe_dispatch="gather", moe_stats=True)
        for arm in arms:
            tcaches[arm], tlog, tmet = tpc.paged_forward_moe(
                tp, torch.from_numpy(tokens), tcfg, tcaches[arm],
                torch.from_numpy(tables), torch.from_numpy(offs),
                last_idx=None if last is None else torch.from_numpy(last),
                moe_dispatch=arm, moe_stats=True, ep_group=world1)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       rtol=1e-5, atol=1e-5, err_msg=arm)
            np.testing.assert_array_equal(tmet["expert_tokens"].numpy(),
                                          np.asarray(jmet["expert_tokens"]))
            assert float(tmet["dropped_token_rate"]) == 0.0


def _assert_moe_summary(got, want, arm):
    got, want = dict(got), dict(want)
    assert got.pop("dispatch") == arm
    want.pop("dispatch")
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12,
                                   err_msg=key)


@pytest.mark.parametrize("arm", W.ENGINE_ARMS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_ep_engine_world1_equals_jax_serial_engine(families, world1, family,
                                                   arm):
    fam = families[family]
    tp = params_from_jax(fam["np"], fam["tcfg"], device="cpu")
    eng = ServingEngine(tp, fam["tcfg"], device="cpu", moe_dispatch=arm,
                        ep_group=world1, **W.ENGINE)
    assert eng.moe_dispatch == arm and eng.ep_group is world1
    got = W.run_staggered(eng, Request, W.prompts(fam["tcfg"].vocab_size))
    for i, (g, w) in enumerate(zip(got, fam["want"])):
        np.testing.assert_array_equal(g, w, err_msg=f"{family} {arm} {i}")
    s = eng.serving_summary()
    _assert_moe_summary(s["moe"], fam["jmoe"], arm)
    assert s["kernel_launches"] == {k: 0 for k in s["kernel_launches"]}
    assert eng.audit(heal=False)["ok"] and eng._alloc.in_use == 0


@pytest.mark.parametrize("arm", W.ENGINE_ARMS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_ep_engine_world4_equals_jax_serial_engine(families, world4, family,
                                                   arm):
    """Four ranks, each with a quarter of the experts, serve the same
    requests: every rank's tokens equal JAX's serial engine's (hence each
    other's), and every rank's ``moe`` summary equals JAX's."""
    fam = families[family]
    for r, res in enumerate(world4):
        for i, w in enumerate(fam["want"]):
            np.testing.assert_array_equal(
                res[f"engine/{family}/{arm}/tokens{i}"], w,
                err_msg=f"{family} {arm} rank {r} request {i}")
        moe = json.loads(str(res[f"engine/{family}/{arm}/moe"]))
        _assert_moe_summary(moe, fam["jmoe"], arm)


# ------------------------------------------------------ expert sharding


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_shard_moe_params_and_params_from_jax_ep(families, family,
                                                 quantized):
    """Each of 4 EP ranks holds its quarter of every expert leaf (both
    halves of an int8 pair), the rest whole — by slicing a converted
    tree and by converting only the rank's share."""
    fam = families[family]
    tree = fam["np"]
    if quantized:
        tree = dict(tree, blocks=[
            dict(b, moe=dict(b["moe"], experts=jax.tree.map(
                np.asarray, jmd.quantize_moe_experts(b["moe"]["experts"]))))
            if "moe" in b else b for b in tree["blocks"]])
    cfg = fam["tcfg"]
    full = params_from_jax(tree, cfg, device="cpu")
    e_loc = cfg.moe_experts // WORLD
    for r in range(WORLD):
        sl = slice(r * e_loc, (r + 1) * e_loc)
        views = shard_moe_params(full, cfg, r, WORLD)
        own = params_from_jax(tree, cfg, device="cpu", ep_rank=r,
                              ep_size=WORLD)
        for got in (views, own):
            for key in ("tok_emb", "head"):
                assert torch.equal(got[key], full[key])
            for gb, fb, jb in zip(got["blocks"], full["blocks"],
                                  tree["blocks"]):
                for n, leaf in fb["attn"].items():
                    assert torch.equal(gb["attn"][n], leaf), n
                if "moe" not in fb:
                    continue
                assert torch.equal(gb["moe"]["router"]["w"],
                                   fb["moe"]["router"]["w"])
                for n, leaf in jb["moe"]["experts"].items():
                    g = gb["moe"]["experts"][n]
                    assert isinstance(g, tuple) == isinstance(leaf, tuple)
                    pairs = zip(g, leaf) if isinstance(leaf, tuple) else [
                        (g, leaf)]
                    for gt, lf in pairs:
                        np.testing.assert_array_equal(gt.numpy(), lf[sl])
                        assert gt.shape[0] == e_loc
    with pytest.raises(ValueError, match="divisible"):
        shard_moe_params(full, cfg, 0, 3)
    with pytest.raises(ValueError, match="EP size"):
        params_from_jax(tree, cfg, device="cpu", ep_rank=0, ep_size=3)


# ------------------------------------------------------------ refusals


def test_ep_refusals(world1):
    p = _t(_layer_params())
    x = torch.from_numpy(_rank_tokens()[0])
    cfg = tmoe.MoEConfig(**W.LAYER, capacity_factor=2.0, dispatch="sorted")
    q = dict(p, experts=md.quantize_moe_experts(p["experts"]))
    with pytest.raises(TypeError, match="'cuda'"):
        tmoe.moe_forward(q, x, cfg, ep_group=world1)
    # int8 experts do run in K7 (its plain version here)
    y, _ = tmoe.moe_forward(q, x, dataclasses.replace(cfg, dispatch="cuda"),
                            ep_group=world1)
    assert torch.isfinite(y).all()
    three = types.SimpleNamespace(size=lambda: 3)
    with pytest.raises(ValueError, match="not divisible by EP size 3"):
        tmoe.moe_forward(p, x, cfg, ep_group=three)
    with pytest.raises(ValueError, match="shard_experts"):
        tmoe.moe_forward(tmoe.shard_experts(p, 0, 2), x, cfg,
                         ep_group=world1)
    # trains (tests/test_torch_moe_train.py); the expert-choice router
    # refuses a causal model
    tmoe.moe_forward(p, x.clone().requires_grad_(), cfg)[0].sum().backward()
    with pytest.raises(ValueError, match="causal"):
        tmoe.moe_forward(p, x, dataclasses.replace(
            cfg, router="expert_choice"), causal=True)
    with pytest.raises(ValueError, match="does not divide"):
        build_moe_groups(3)
    with pytest.raises(RuntimeError, match="already"):
        init_distributed("file:///nonexistent", 1, 0, "cpu")
    gcfg = W.torch_config("gpt_moe")
    for kw in ({"ep_axis": "moe_ep"}, {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="ep_group"):
            ServingEngine(None, gcfg, device="cpu", **kw, **W.ENGINE)
    with pytest.raises(ValueError, match="no MoE"):
        ServingEngine(None, dataclasses.replace(gcfg, moe_experts=0),
                      device="cpu", ep_group=world1, **W.ENGINE)
    with pytest.raises(ValueError, match="moe_dispatch"):
        ServingEngine(None, gcfg, device="cpu", moe_dispatch="sorted",
                      **W.ENGINE)


def test_ep_entry_points_default_to_the_card(world1):
    """No device means CUDA: without a card the EP engine and the
    process-group start raise, never fall back to the CPU (or gloo)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    cfg = W.torch_config("gpt_moe")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(None, cfg, ep_group=world1, **W.ENGINE)
    with pytest.raises(RuntimeError, match="cuda"):
        init_distributed("file:///nonexistent", 1, 0)
