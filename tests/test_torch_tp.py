"""The port's tensor and sequence parallelism at world 2 and 4 over gloo
against the JAX package's on its CPU mesh.

One launch of 2 ``tests/_torch_tp_worker.py`` processes (job ``train``)
and one of 4 (job ``tpdp``) run every multi-rank case; the JAX side runs
here on the conftest's CPU devices.  The models are the tiny f32 GPT
(LayerNorm, GELU, learned positions) and Llama (RMSNorm, SwiGLU, RoPE,
GQA 4 / 2) of ``_torch_tp_worker.TRAIN_CFGS``, JAX's init carried over
by ``params_from_jax``.  Cases:

- each region and both rings on per-rank inputs against JAX's
  ``tp_utils`` under ``shard_map`` (``copy_to_tp`` against ``pvary``),
  outputs and grads, f32 (rtol / atol 1e-6); the rings against the fused
  path within f32 summation order (1e-5);
- ``gpt_loss`` and every grad leaf at tp 2, ``sp`` False and True, and
  with the rings (``collective_matmul``, ``cm_min_bytes=0``), and with
  the head and loss streamed (``xent_chunk``) at ``sp`` False and True: the GPT
  against JAX's TP step (``shard_map`` with ``gpt_param_specs``) and the
  serial step, the Llama against the serial step, rtol / atol 5e-5 (JAX
  ``tests/test_tensor_parallel.py:110-114``); the grads come from
  ``make_train_step``'s own backward and SP sum;
- planted faults: ``copy_to_tp``'s backward all-reduce taken out, and
  the SP sum of the replicated leaves taken out — each fails that check;
- TP 2 x DP 2 (world 4, ``sp=True``) against JAX's ``DataParallel``
  with the TP specs: 3 AdamW steps, the losses (rtol 1e-4 / atol 1e-5)
  and the parameters (rtol 1e-3 / atol 1e-5 but the key bias, as
  ``tests/test_torch_dp.py``);
- the shard / gather round trip, ``params_from_jax``'s TP shard, SP
  dropout (tensor ranks agree; the dropped share by statistics),
  ``transformer_forward`` on a sharded block list against JAX's;
- in this process, over a one-rank gloo group: each region's collectives
  in a training step, ``set_tp_group`` as the regions' default,
  ``normalize_model_axis_grads``' rule, and the refusals.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from torchdistpackage_tpu.compat import pvary, shard_map
from torchdistpackage_tpu.dist import tpc as jtpc
from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import gpt_loss as jgpt_loss
from torchdistpackage_tpu.models import gpt_param_specs as jspecs
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.models import llama_config as jllama
from torchdistpackage_tpu.parallel.data_parallel import DataParallel as JDP
from torchdistpackage_tpu.parallel.tensor_parallel import (
    TransformerConfig as JTransformerConfig,
)
from torchdistpackage_tpu.parallel.tensor_parallel import (
    init_transformer_params as jinit_tf,
)
from torchdistpackage_tpu.parallel.tensor_parallel import tp_utils as jtp
from torchdistpackage_tpu.parallel.tensor_parallel import (
    transformer_forward as jtransformer,
)

sys.path.insert(0, str(Path(__file__).parent))
import _torch_tp_worker as W  # noqa: E402

WORKER = str(Path(__file__).parent / "_torch_tp_worker.py")
TP = 2
#: f32 TP against serial: the reference's own tolerance
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
REGION_TOL = dict(rtol=1e-6, atol=1e-6)
#: the rings against the fused collectives: f32 summation order
RING_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)


def jcfg(name):
    kind, kw = W.TRAIN_CFGS[name]
    if kind == "gpt":
        return JGPTConfig(**kw, dtype=jnp.float32)
    return jllama(**kw, dtype=jnp.float32)


def run_workers(job, world, inputs, tmp):
    """Start ``world`` workers on ``job``; returns each rank's outputs."""
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, job, str(r), str(world),
         f"file://{tmp / 'store'}", str(tmp / "in.npz"), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


def _mesh(axes):
    jtpc.reset()
    n = int(np.prod([s for _, s in axes]))
    jtpc.setup_process_groups(axes, devices=jax.devices()[:n])
    return jtpc.get_view()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ----------------------------------------------------------------- inputs


def _region_inputs(rs):
    """Per-rank inputs [TP, ...]; replicated inputs and the replicated
    output's cotangent are the same on every rank."""
    B, S, D, F = W.RB, W.RS, W.RD, W.RF
    s = S // TP

    def r(*shape):
        return rs.standard_normal(shape).astype(np.float32)

    same = r(B, S, D)
    out = {
        "reduce_from_tp": (r(TP, B, S, D), np.stack([r(B, S, D)] * TP)),
        "copy_to_tp": (np.stack([same] * TP), r(TP, B, S, D)),
        "gather_from_sp": (r(TP, B, s, D), r(TP, B, S, D)),
        "scatter_to_sp": (r(TP, B, S, D), r(TP, B, s, D)),
        "split_to_sp": (np.stack([same] * TP), r(TP, B, s, D)),
    }
    flat = {}
    for name, (x, w) in out.items():
        flat[f"regions/{name}/x"], flat[f"regions/{name}/w"] = x, w
    flat.update({"regions/ring_ag_matmul/x": r(TP, B, s, D),
                 "regions/ring_ag_matmul/m": r(TP, D, F),
                 "regions/ring_ag_matmul/w": r(TP, B, S, F),
                 "regions/ring_matmul_rs/x": r(TP, B, S, F),
                 "regions/ring_matmul_rs/m": r(TP, F, D),
                 "regions/ring_matmul_rs/w": r(TP, B, s, D)})
    return flat


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(0)
    out = _region_inputs(rs)
    params = {}
    for name in W.TRAIN_CFGS:
        params[name] = _np(jinit(jax.random.PRNGKey(0), jcfg(name)))
        out.update({f"train/{name}/params/{k}": v
                    for k, v in W.flatten(params[name]).items()})
    shape = (4, W.TRAIN_CFGS["gpt"][1]["max_seq"])
    for k in ("tokens", "targets"):
        out[f"train/batch/{k}"] = rs.randint(0, 64, shape).astype(np.int32)
    for i in range(W.DP_STEPS):
        for k in ("tokens", "targets"):
            out[f"tpdp/batch{i}/{k}"] = rs.randint(
                0, 64, (8, shape[1])).astype(np.int32)
    tcfg = JTransformerConfig(**W.TRANSFORMER)
    params["tf"] = _np(jinit_tf(jax.random.PRNGKey(0), tcfg))
    out.update({f"tf/params/{k}": v
                for k, v in W.flatten(params["tf"]).items()})
    out["tf/x"] = rs.standard_normal((2, 16, tcfg.dim)).astype(np.float32)
    return out, params


@pytest.fixture(scope="module")
def world2(tmp_path_factory, inputs):
    return run_workers("train", TP, inputs[0],
                       tmp_path_factory.mktemp("tp2"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory, inputs):
    return run_workers("tpdp", 4, inputs[0], tmp_path_factory.mktemp("tp4"))


# ---------------------------------------------------------------- regions


def _jax_regions(inp):
    """Each region's outputs and input grads on a 2-device tensor mesh."""
    mesh = _mesh([("tensor", TP)])
    stacked = P("tensor")

    def local(fn):
        return lambda x: fn(x[0])[None]

    regions = {
        "reduce_from_tp": (lambda x: jtp.reduce_from_tp(x[0], "tensor"),
                           stacked, P(), True),
        "copy_to_tp": (lambda x: pvary(x, "tensor")[None], P(), stacked,
                       False),
        "gather_from_sp": (local(lambda x: jtp.gather_from_sp(x, "tensor")),
                           stacked, stacked, False),
        "scatter_to_sp": (local(lambda x: jtp.scatter_to_sp(x, "tensor")),
                          stacked, stacked, False),
        "split_to_sp": (lambda x: jtp.split_to_sp(x, "tensor")[None], P(),
                        stacked, False),
    }
    out = {}
    for name, (fn, ins, outs, rep_out) in regions.items():
        x = inp[f"regions/{name}/x"]
        w = inp[f"regions/{name}/w"]
        if ins == P():
            x = x[0]
        if rep_out:
            w = w[0]
        f = shard_map(fn, mesh=mesh, in_specs=ins, out_specs=outs)

        def loss(xx, f=f, w=w):
            y = f(xx)
            return jnp.sum(y * w), y

        (_, y), g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x))
        out[name] = (np.asarray(y), np.asarray(g))
    for name in ("ring_ag_matmul", "ring_matmul_rs"):
        x, m, w = (inp[f"regions/{name}/{k}"] for k in ("x", "m", "w"))
        if name == "ring_ag_matmul":
            def body(xl, ml):
                return jtp.ring_ag_matmul(
                    xl[0], lambda c: jnp.tanh(c @ ml[0]), "tensor")[None]
        else:
            def body(xl, ml):
                return jtp.ring_matmul_rs(
                    xl[0], lambda c: c @ ml[0], "tensor")[None]
        f = shard_map(body, mesh=mesh, in_specs=(stacked, stacked),
                      out_specs=stacked)

        def loss(xx, mm, f=f, w=w):
            y = f(xx, mm)
            return jnp.sum(y * w), y

        (_, y), (gx, gm) = jax.value_and_grad(loss, argnums=(0, 1),
                                              has_aux=True)(
            jnp.asarray(x), jnp.asarray(m))
        out[name] = (np.asarray(y), np.asarray(gx), np.asarray(gm))
    jtpc.reset()
    return out


@pytest.fixture(scope="module")
def jax_regions(inputs):
    return _jax_regions(inputs[0])


@pytest.mark.parametrize("name", ["reduce_from_tp", "copy_to_tp",
                                  "gather_from_sp", "scatter_to_sp",
                                  "split_to_sp"])
def test_region_matches_jax(world2, jax_regions, name):
    """Forward and backward of each region against JAX's on the same
    per-rank inputs: a replicated output (``reduce_from_tp``) carries one
    cotangent, a replicated input (``copy_to_tp``, ``split_to_sp``) one
    gradient, the same on every rank."""
    y, g = jax_regions[name]
    for r, out in enumerate(world2):
        want_y = y if name == "reduce_from_tp" else y[r]
        want_g = g if name in ("copy_to_tp", "split_to_sp") else g[r]
        np.testing.assert_allclose(out[f"regions/{name}/y"], want_y,
                                   **REGION_TOL, err_msg=f"{name} rank {r}")
        np.testing.assert_allclose(out[f"regions/{name}/gx"], want_g,
                                   **REGION_TOL, err_msg=f"{name} grad {r}")


@pytest.mark.parametrize("name", ["ring_ag_matmul", "ring_matmul_rs"])
def test_ring_matches_jax_and_the_fused_path(world2, jax_regions, name):
    """Each ring's output and its grads (input and weight) against JAX's
    ring, and against the port's fused collective + product within f32
    summation order."""
    y, gx, gm = jax_regions[name]
    for r, out in enumerate(world2):
        ring = {k: out[f"regions/{name}/ring/{k}"] for k in ("y", "gx", "gm")}
        fused = {k: out[f"regions/{name}/fused/{k}"]
                 for k in ("y", "gx", "gm")}
        for k, want in (("y", y[r]), ("gx", gx[r]), ("gm", gm[r])):
            np.testing.assert_allclose(ring[k], want, **RING_TOL,
                                       err_msg=f"{name} {k} rank {r}")
            np.testing.assert_allclose(ring[k], fused[k], **RING_TOL,
                                       err_msg=f"{name} {k} vs fused {r}")


# ------------------------------------------------------------ gpt_loss TP


def _jax_loss_grads(name, sp, xent, batch):
    """(loss, grads) of JAX's gpt_loss (``xent_chunk=xent``): serial
    (``sp`` None) or under ``shard_map`` on a 2-device tensor mesh."""
    cfg = jcfg(name)
    params = jinit(jax.random.PRNGKey(0), cfg)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    if sp is None:
        loss, g = jax.jit(jax.value_and_grad(
            lambda p: jgpt_loss(p, batch, cfg, xent_chunk=xent)))(params)
        return float(loss), _np(g)
    mesh = _mesh([("tensor", TP)])
    specs = jspecs(cfg, tp_axis="tensor")
    sharded = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), params, specs)

    # the reference's streamed loss leaves its scan typed tensor-varying
    # though every rank holds the same value, so out_specs=P() refuses
    # it: take the per-rank copies out and their mean, whose gradient is
    # the loss's (the copies' spread is checked below)
    def tp_losses(p):
        return shard_map(
            lambda pp, bb: jgpt_loss(pp, bb, cfg, axis="tensor", sp=sp,
                                     xent_chunk=xent)[None],
            mesh=mesh, in_specs=(specs, P()),
            out_specs=P("tensor"))(p, batch)

    def mean_loss(p):
        losses = tp_losses(p)
        return losses.mean(), losses

    (loss, per_rank), g = jax.jit(jax.value_and_grad(
        mean_loss, has_aux=True))(sharded)
    jtpc.reset()
    np.testing.assert_allclose(np.asarray(per_rank), float(loss), rtol=1e-6)
    return float(loss), _np(g)


@pytest.fixture(scope="module")
def jax_loss(inputs):
    """``get(name, sp, xent)``: JAX's loss and grads, each computed
    once."""
    batch = {k: inputs[0][f"train/batch/{k}"] for k in ("tokens", "targets")}
    memo = {}

    def get(name, sp, xent=None):
        if (name, sp, xent) not in memo:
            memo[name, sp, xent] = _jax_loss_grads(name, sp, xent, batch)
        return memo[name, sp, xent]
    return get


def _assert_grads(got_flat, want_tree, what, tol=GRAD_TOL):
    want = W.flatten(want_tree)
    assert set(got_flat) == set(want), (what, sorted(got_flat))
    for k, v in want.items():
        np.testing.assert_allclose(got_flat[k], v, **tol,
                                   err_msg=f"{what}: grad {k}")


def _grads(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("case", list(W.LOSS_CASES))
def test_tp_loss_and_grads_match_jax(world2, jax_loss, case):
    """``gpt_loss`` and every grad leaf (the step's backward and SP sum,
    gathered) at tp 2 against the serial step, and for the GPT against
    JAX's TP step at the same ``sp`` (the rings against the fused TP
    step: JAX's GPT config takes no ``collective_matmul``), with and
    without ``xent_chunk``.  Every rank holds the same loss."""
    name, sp, cm, xent = W.LOSS_CASES[case]
    refs = {"serial": jax_loss(name, None, xent)}
    if name == "gpt":
        refs["jax tp"] = jax_loss(name, sp, xent)
    for r, out in enumerate(world2):
        got = _grads(out, f"grads/{case}/")
        for what, (loss, grads) in refs.items():
            np.testing.assert_allclose(float(out[f"loss/{case}"]), loss,
                                       rtol=2e-5)
            _assert_grads(got, grads, f"{case} rank {r} vs {what}")


@pytest.mark.parametrize("fault,case", [("copy_to_tp", "gpt/tp"),
                                        ("sp_sum", "gpt/sp")])
def test_planted_fault_fails_the_grad_check(world2, jax_loss, fault,
                                            case):
    """Without ``copy_to_tp``'s backward all-reduce (non-SP) or without
    the SP sum of the replicated leaves' grads, the same check fails."""
    _, sp, _, _ = W.LOSS_CASES[case]
    _, want = jax_loss("gpt", sp)
    with pytest.raises(AssertionError):
        _assert_grads(_grads(world2[0], f"fault/{fault}/"), want, fault)


def test_transformer_forward_matches_jax(world2, inputs):
    """``transformer_forward`` of each rank's shard of the block list, SP
    off and on (split in, gathered out), against JAX's serial
    ``transformer_forward`` on the same weights and input (rtol / atol
    2e-5, JAX ``tests/test_tensor_parallel.py``)."""
    inp, params = inputs
    want = np.asarray(jtransformer(
        jax.tree.map(jnp.asarray, params["tf"]), jnp.asarray(inp["tf/x"]),
        JTransformerConfig(**W.TRANSFORMER)))
    for r, out in enumerate(world2):
        for sp in (False, True):
            np.testing.assert_allclose(out[f"tf/{sp}"], want, rtol=2e-5,
                                       atol=2e-5, err_msg=f"sp {sp} rank {r}")


# ----------------------------------------------------------- TP x DP


def _assert_params(got, want, what):
    """``PARAM_TOL``, but for the key bias's column (``bqkv[:, 1]``),
    whose gradient is zero in exact arithmetic (softmax ignores a
    per-row constant) and Adam moves by up to lr a step on either side's
    rounding noise: held to 2 lr a step (tests/test_torch_dp.py)."""
    for k, v in W.flatten(want).items():
        g = got[k]
        if k.endswith("attn/bqkv"):
            np.testing.assert_allclose(g[:, 1], v[:, 1], rtol=0,
                                       atol=2 * W.DP_LR * W.DP_STEPS,
                                       err_msg=f"{what}: {k}[:, 1]")
            g, v = np.delete(g, 1, axis=1), np.delete(v, 1, axis=1)
        np.testing.assert_allclose(g, v, **PARAM_TOL,
                                   err_msg=f"{what}: {k}")


def test_tp_dp_world4_follows_jax(world4, inputs):
    """TP 2 x DP 2 at ``sp=True`` (the data-parallel buckets reduce the
    replicated leaves' grads over the data and tensor axes at once)
    against JAX's ``DataParallel`` with the TP specs on a data 2 x tensor
    2 mesh (JAX ``tests/test_tensor_parallel.py:118``'s composition with
    the GPT and AdamW): three steps' losses and the parameters after
    them; every rank ends with the same full parameters."""
    inp, params = inputs
    cfg = jcfg("gpt")
    mesh = _mesh([("data", 2), ("tensor", TP)])
    specs = jspecs(cfg, tp_axis="tensor")
    dp = JDP(mesh=mesh)
    opt = optax.adamw(W.DP_LR)
    p = dp.broadcast_params(jax.tree.map(jnp.asarray, params["gpt"]),
                            param_specs=specs)
    state = opt.init(p)
    step = dp.make_train_step(
        lambda q, b: jgpt_loss(q, b, cfg, axis="tensor", sp=True), opt,
        param_specs=specs)
    losses = []
    for i in range(W.DP_STEPS):
        b = {k: inp[f"tpdp/batch{i}/{k}"] for k in ("tokens", "targets")}
        p, state, loss = step(p, state, dp.shard_batch(b))
        losses.append(float(loss))
    want = _np(p)
    jtpc.reset()
    for r, out in enumerate(world4):
        np.testing.assert_allclose(out["tpdp/losses"], losses, **LOSS_TOL)
        _assert_params(_grads(out, "tpdp/params/"), want, f"rank {r}")
    a, b = (_grads(world4[r], "tpdp/params/") for r in (0, 3))
    assert all(np.array_equal(a[k], b[k]) for k in a)


# ------------------------------------------------------ shards, dropout


def test_shard_gather_round_trip(world2, inputs):
    """``gather_params`` of every rank's ``shard_gpt_params`` is the whole
    tree; ``params_from_jax(tp_rank=, tp_size=)`` is that same shard; a
    rank's split leaf is its slice (rank 0: the first half)."""
    _, params = inputs
    for name in W.TRAIN_CFGS:
        full = W.flatten(params[name])
        for r, out in enumerate(world2):
            assert bool(out[f"shard/{name}/convert_equal"])
            back = _grads(out, f"shard/{name}/back/")
            assert set(back) == set(full)
            for k, v in full.items():
                np.testing.assert_array_equal(back[k], v, err_msg=k)
        mine = _grads(world2[1], f"shard/{name}/mine/")
        np.testing.assert_array_equal(mine["head"],
                                      full["head"][:, 32:])
        np.testing.assert_array_equal(mine["tok_emb"],
                                      full["tok_emb"][32:])
        np.testing.assert_array_equal(mine["blocks/attn/wo"],
                                      full["blocks/attn/wo"][:, 16:])


def test_sp_dropout_masks(world2):
    """Residual dropout 0.5 under SP, keyed by ``axis_unique_key(7,
    'data')``: the tensor ranks gather the same hidden, finite and apart
    from the rate-0 one; each rank's mask on its own rows is the other
    rank's (one key: the tensor shards agree, as the reference's key
    recipe asks), its dropped share 0.5 within 4 standard deviations."""
    h0 = [out["dropout/0.0"] for out in world2]
    h = [out["dropout/0.5"] for out in world2]
    np.testing.assert_array_equal(h[0], h[1])
    np.testing.assert_array_equal(h0[0], h0[1])
    assert np.isfinite(h[0]).all()
    assert (np.abs(h[0] - h0[0]) > 1e-6).mean() > 0.9
    masks = [out["dropout/mask"] for out in world2]
    np.testing.assert_array_equal(masks[0], masks[1])
    n = masks[0].size
    share = masks[0].mean()
    assert abs(share - W.DROPOUT_RATE) < 4 * np.sqrt(0.25 / n), share


# ------------------------------------------------- one rank, in process


@pytest.fixture(scope="module")
def group1(tmp_path_factory):
    """A one-rank gloo group in this process (destroyed at module end)."""
    from torchdistpackage_tpu_torch.dist import init_distributed
    from torchdistpackage_tpu_torch.dist import tpc as ttpc

    store = tmp_path_factory.mktemp("tp1") / "store"
    init_distributed(f"file://{store}", 1, 0, "cpu")
    ttpc.setup_process_groups([("data", 1), ("tensor", 1)])
    try:
        yield ttpc.get_group("tensor")
    finally:
        ttpc.reset()
        dist.destroy_process_group()


@pytest.mark.parametrize("sp", [False, True])
def test_collectives_of_a_training_step(group1, sp):
    """Each region's collectives in one ``remat='flash'`` training step of
    a 3-layer GPT on one rank — the counts ``chip_smoke.py`` gates on the
    card: the backward recomputes each block up to its last saved tensor
    (the attention's closing collective again, the MLP's not)."""
    from torchdistpackage_tpu_torch.models import GPTConfig, init_gpt_params
    from torchdistpackage_tpu_torch.models import gpt_loss
    from torchdistpackage_tpu_torch.models.gpt import gpt_param_specs
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        adamw,
        make_train_step,
    )
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        COLLECTIVES,
    )

    L = 3
    cfg = GPTConfig(vocab_size=64, dim=32, nheads=4, nlayers=L, max_seq=16,
                    attn_impl="flash", collective_matmul=sp)
    p = init_gpt_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = adamw(1e-3)
    state = opt.init(p)
    step = make_train_step(
        lambda q, b: gpt_loss(q, b, cfg, remat="flash", tp_group=group1,
                              sp=sp), opt,
        param_specs=gpt_param_specs(p), sp=sp, tp_group=group1)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, 64, (2, 16), generator=g)
             for k in ("tokens", "targets")}
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0
    step(p, state, batch)
    got = {k: v for k, v in COLLECTIVES.items() if v}
    want = ({"split_to_sp": 1, "gather_from_sp": 6 * L + 2,
             "scatter_to_sp": 5 * L, "reduce_from_tp": 2, "xent_max": 1}
            if sp else {"reduce_from_tp": 3 * L + 2, "copy_to_tp": 2 * L + 1,
                        "xent_max": 1})
    assert got == want


def test_set_tp_group_is_the_regions_default(group1):
    """``set_tp_group`` (``set_tp_axis``'s counterpart) picks the group a
    region runs on when it is given none; None restores ``tpc``'s
    ``tensor`` group.  ``vocab_max`` and ``gather_vocab`` count their
    collectives under ``xent_max`` and ``full_logits``."""
    from torchdistpackage_tpu_torch.dist import tpc as ttpc
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        COLLECTIVES,
        gather_vocab,
        get_tp_group,
        reduce_from_tp,
        set_tp_group,
        tp_size,
        vocab_max,
    )

    other = dist.new_group([0])
    x = torch.arange(6.0).reshape(2, 3)
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0
    set_tp_group(other)
    try:
        assert get_tp_group() is other and tp_size() == 1
        assert torch.equal(reduce_from_tp(x), x)
        assert torch.equal(vocab_max(x), x)
        assert torch.equal(gather_vocab(x), x)
    finally:
        set_tp_group(None)
    assert get_tp_group() is ttpc.get_group("tensor") is group1
    assert {k: v for k, v in COLLECTIVES.items() if v} == {
        "reduce_from_tp": 1, "xent_max": 1, "full_logits": 1}
    dist.destroy_process_group(other)


def test_normalize_model_axis_grads_rule(group1):
    """The port's TP loss is the same on every rank of the tensor group
    (it closes its regions with collectives), so it varies on no model
    axis: ``other`` is ``()`` and the grads come back as they are — what
    JAX's rule returns for an invariant loss (no rescale).  So does a
    context axis outside the data axes (the ViT's pool closes over it),
    whose loss is compared across the context group when one is given
    (``tests/test_torch_gpt_cp.py``; here the layout alone, no loss); an
    axis that is no axis of the port's models raises when larger than 1."""
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        normalize_model_axis_grads,
    )

    grads = {"w": torch.ones(3)}
    out, other = normalize_model_axis_grads(torch.tensor(1.0), grads)
    assert other == () and out is grads

    class Layout:  # a context's axis sizes without process groups
        def __init__(self, **sizes):
            self.sizes = sizes
            self.axis_names = tuple(sizes)

        def get_group_size(self, a):
            return self.sizes[a]

    assert normalize_model_axis_grads(
        torch.tensor(1.0), grads, Layout(data=2, tensor=2))[1] == ()
    # the pipelined loss is the same on every stage too
    # (tests/test_torch_pipeline_compose.py holds the rule to JAX's)
    assert normalize_model_axis_grads(
        torch.tensor(1.0), grads, Layout(data=1, tensor=2, pipe=2))[1] == ()
    assert normalize_model_axis_grads(
        None, grads, Layout(data=1, tensor=2, context=2)) == (grads, ())
    with pytest.raises(NotImplementedError, match="no axis of the port"):
        normalize_model_axis_grads(torch.tensor(1.0), grads,
                                   Layout(data=1, tensor=2, experts=2))


def test_refusals(group1):
    """What tensor parallelism does not serve yet raises
    ``NotImplementedError`` naming the ROADMAP item it waits for; the int8
    SP boundaries are accepted (at one rank they are the exact
    collectives; the multi-rank runs are in
    tests/test_torch_compressed.py) and an unknown mode is a
    ValueError."""
    import dataclasses

    from torchdistpackage_tpu_torch.models import GPTConfig, init_gpt_params
    from torchdistpackage_tpu_torch.models import llama_config
    from torchdistpackage_tpu_torch.models.gpt import (
        layer_params,
        shard_gpt_params,
    )
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        block_forward,
        gather_from_sp,
        scatter_to_sp,
    )
    from torchdistpackage_tpu_torch.serving import ServingEngine
    from torchdistpackage_tpu_torch.tools.surgery import (
        quantize_decode_params,
    )

    cfg = GPTConfig(vocab_size=64, dim=32, nheads=4, nlayers=1, max_seq=16)
    x = torch.randn(1, 2, 32, generator=torch.Generator().manual_seed(1))
    for fn in (gather_from_sp, scatter_to_sp):
        assert torch.equal(fn(x, group1, compress="int8"), x)
        with pytest.raises(ValueError, match="compress"):
            fn(x, group1, compress="int4")
    p = init_gpt_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(
        block_forward(layer_params(p, 0), x,
                      dataclasses.replace(cfg.block, ag_compress="int8",
                                          compress_min_bytes=0),
                      tp_group=group1, sp=True),
        block_forward(layer_params(p, 0), x, cfg.block, tp_group=group1,
                      sp=True))
    moe = GPTConfig(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=16,
                    moe_experts=4)
    # tp_group serves beside ep_group and cp_group
    # (tests/test_torch_serving_compose.py); what still refuses beside it:
    # context parallelism with data groups or with expert parallelism
    for kw, item in (
            ({"cp_group": object(), "dp_group": object()},
             "cp_group cannot be combined with dp_group"),
            ({"cp_group": object(), "ep_group": object()},
             "cp_group cannot be combined with ep_group")):
        with pytest.raises(NotImplementedError, match=item):
            ServingEngine(None, moe, device="cpu", tp_group=object(), **kw)
    for option, item in (("dp_axis", "takes dp_group="),
                         ("mesh", "tensor parallelism takes tp_group"),
                         ("axis", "tensor parallelism takes tp_group")):
        with pytest.raises(NotImplementedError, match=item):
            ServingEngine(None, cfg, device="cpu", **{option: "tensor"})
    # an int8 weight-only leaf: the reference's specs do not shard one
    lcfg = llama_config(vocab_size=64, dim=32, nheads=4, nlayers=1,
                        max_seq=16, kv_heads=2, ffn_hidden=48,
                        dtype=torch.float32)
    q = quantize_decode_params(init_gpt_params(
        lcfg, torch.Generator().manual_seed(0), device="cpu"), min_size=64)
    with pytest.raises(NotImplementedError, match="int8 weight-only"):
        shard_gpt_params(q, lcfg, 0, 2)
    with pytest.raises(ValueError, match="kv_heads 2 not divisible by tp 4"):
        shard_gpt_params(p, dataclasses.replace(lcfg, kv_heads=2), 0, 4)
    with pytest.raises(ValueError, match="vocab_size 64 not divisible"):
        shard_gpt_params(p, cfg, 0, 3)
