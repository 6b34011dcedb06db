"""The port's data parallelism at world 4 over gloo against the JAX
package's on 4 of the 8 CPU devices.

One launch of 4 ``tests/_torch_dp_worker.py`` processes (JAX-free; a
``file://`` store under ``tmp_path``) runs every case; the JAX side runs
in this process.  The model is a tiny f32 GPT (2 layers, d 32, 4 heads,
S 16, vocab 64, ``attn_impl='naive'``) with JAX's init carried over by
``params_from_jax``, trained 3 AdamW steps on 3 global batches of 8 rows
(2 a rank).  Cases: accumulation 1 and 2 (reduced once at the end and
once a microbatch), ``reduce_op='sum'``, an override to ``()`` (the
head's grads stay per rank; JAX's ``DataParallel`` cannot return
per-rank parameters, so its reference is the same step written with
JAX's ``reduce_gradients`` under ``shard_map`` with per-device
outputs), one microbatch reduced as a microbatch, and one 25 MB bucket.
Tolerances are the JAX test's own (``tests/test_data_parallel.py``):
loss rtol 1e-4 / atol 1e-5, parameters rtol 1e-3 / atol 1e-5, but for
the key bias's column (see ``_assert_params``).  Every rank must end
with the same parameters bit for bit (but the override's head).

Also: the MoE-DP override of ``tests/test_data_parallel.py`` at world 4
(``moe_ep`` 2), ``broadcast_params``, the rows ``shard_batch`` gives a
rank, dropout masks by data and tensor coordinate, ``test_comm``, and at
world 1 (a one-rank gloo group in this process) the data-parallel step
bit-identical to ``make_train_step``.
"""

import functools
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
from jax.sharding import PartitionSpec as P

from torchdistpackage_tpu.compat import shard_map
from torchdistpackage_tpu.dist import tpc as jtpc
from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import gpt_loss as jgpt_loss
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.parallel.data_parallel import DataParallel as JDP
from torchdistpackage_tpu.parallel.data_parallel import (
    reduce_gradients as jreduce,
)

sys.path.insert(0, str(Path(__file__).parent))
import _torch_dp_worker as W  # noqa: E402

WORKER = str(Path(__file__).parent / "_torch_dp_worker.py")
WORLD = 4
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
# f32 grads of the tiny GPT summed in other orders (largest ~1e-1)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _jcfg(**kw):
    return JGPTConfig(**W.GPT, dtype=jnp.float32, attn_impl="naive", **kw)


@pytest.fixture(scope="module")
def inputs():
    """JAX's init as numpy, and the three global batches."""
    params = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), _jcfg()))
    rs = np.random.RandomState(0)
    shape = (W.GLOBAL_BATCH, W.GPT["max_seq"])
    batches = [{k: rs.randint(0, W.GPT["vocab_size"], shape).astype(np.int32)
                for k in ("tokens", "targets")} for _ in range(W.STEPS)]
    return params, batches


@pytest.fixture(scope="module")
def world4(tmp_path_factory, inputs):
    """Every world-4 run at once: 4 worker processes over gloo."""
    params, batches = inputs
    d = tmp_path_factory.mktemp("dp4")
    inp = {f"params/{k}": v for k, v in _flat(params).items()}
    for i, b in enumerate(batches):
        inp.update({f"batch{i}/{k}": v for k, v in b.items()})
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


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _mesh4():
    jtpc.reset()
    jtpc.setup_process_groups([("data", WORLD)],
                              devices=jax.devices()[:WORLD])
    return jtpc.get_view()


def _jax_dp(params, batches, M, acc, op):
    """JAX's DataParallel: (losses, final params as numpy)."""
    _mesh4()
    cfg = _jcfg()
    dp = JDP(reduce_op=op)
    opt = optax.adamw(W.LR)
    p = dp.broadcast_params(jax.tree.map(jnp.asarray, params))
    state = opt.init(p)
    step = dp.make_train_step(lambda q, b: jgpt_loss(q, b, cfg), opt,
                              grad_accum_iters=M, accum_reduce=acc)
    losses = []
    for b in batches:
        p, state, loss = step(p, state, dp.shard_batch(b))
        losses.append(float(loss))
    return np.asarray(losses), [_flat(jax.tree.map(np.asarray, p))] * WORLD


def _jax_override_none(params, batches):
    """The same step with the head's grads left per device: JAX's
    ``reduce_gradients`` (override ``{'head': ()}``) inside a
    ``shard_map`` whose every input and output carries a per-device
    leading axis."""
    mesh = _mesh4()
    cfg = _jcfg()
    opt = optax.adamw(W.LR)
    stack = functools.partial(
        jax.tree.map, lambda x: jnp.broadcast_to(x, (WORLD,) + x.shape))
    p = stack(jax.tree.map(jnp.asarray, params))
    state = jax.vmap(opt.init)(p)

    def body(p, s, b):
        p, s = jax.tree.map(lambda x: x[0], (p, s))
        loss, g = jax.value_and_grad(lambda q: jgpt_loss(q, b, cfg))(p)
        g = jreduce(g, "data", "mean", {"head": ()})
        u, s = opt.update(g, s, p)
        p = optax.apply_updates(p, u)
        return (jax.tree.map(lambda x: x[None], (p, s)),
                jax.lax.pmean(loss, "data"))

    spec = P("data")
    step = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, spec, spec),
                             out_specs=(spec, P())))
    losses = []
    for b in batches:
        (p, state), loss = step(p, state, jax.tree.map(jnp.asarray, b))
        losses.append(float(loss))
    per = jax.tree.map(np.asarray, p)
    return np.asarray(losses), [_flat(jax.tree.map(lambda x: x[r], per))
                                for r in range(WORLD)]


@pytest.fixture(scope="module")
def jax_runs(inputs):
    params, batches = inputs
    ref = {}
    try:
        for case, (M, acc, op, over, _) in W.DP_CASES.items():
            if over:
                ref[case] = _jax_override_none(params, batches)
                continue
            key = (M, acc, op)
            if key not in ref:
                ref[key] = _jax_dp(params, batches, M, acc, op)
            ref[case] = ref[key]
    finally:
        jtpc.reset()
    return ref


def _assert_params(got, want, what):
    """``PARAM_TOL`` on every element but the key bias (``bqkv[:, 1]``):
    attention is invariant to adding one constant to a query row's
    scores, so the key bias's gradient is zero in exact arithmetic and
    each framework's is rounding noise; Adam moves such an element by
    up to lr a step whatever the noise's size, so it is held to 2 lr a
    step.  That column is still held across ranks: a missing or partial
    reduction would leave each rank's noise, and the ranks apart (see
    ``test_dp_world4_matches_jax_data_parallel``)."""
    if what.endswith("blocks/attn/bqkv"):
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0,
                                   atol=2 * W.LR * W.STEPS, err_msg=what)
        got, want = got[:, 0::2], want[:, 0::2]
    np.testing.assert_allclose(got, want, err_msg=what, **PARAM_TOL)


@pytest.mark.parametrize("case", sorted(W.DP_CASES))
def test_dp_world4_matches_jax_data_parallel(world4, jax_runs, case):
    want_losses, want_params = jax_runs[case]
    for k in (k for k in world4[0] if k.startswith(f"dp/{case}/params/")):
        if not (case == "override_none" and k.endswith("/head")):
            for r, got in enumerate(world4[1:], 1):
                np.testing.assert_array_equal(got[k], world4[0][k],
                                              err_msg=f"rank {r} {k}")
    for r, got in enumerate(world4):
        np.testing.assert_allclose(got[f"dp/{case}/losses"], want_losses,
                                   err_msg=f"rank {r}", **LOSS_TOL)
        assert len(want_params[r]) == len(
            [k for k in got if k.startswith(f"dp/{case}/params/")])
        for k, want in want_params[r].items():
            _assert_params(got[f"dp/{case}/params/{k}"], want,
                           f"rank {r} {k}")


def test_override_none_keeps_the_head_per_rank(world4):
    """``{'head': ()}``: the head's grads are not reduced, so each rank's
    head moves on its own rows; every other leaf stays in step."""
    heads = [w["dp/override_none/params/head"] for w in world4]
    assert np.abs(heads[0] - heads[1]).max() > 1e-6
    for k in (k for k in world4[0] if k.startswith("dp/override_none/")
              and "/params/" in k and not k.endswith("/head")):
        for w in world4[1:]:
            np.testing.assert_array_equal(w[k], world4[0][k], err_msg=k)


def _jax_grads(params, batch):
    """Each device's reduced grads of the loss on its own rows under
    JAX's ``reduce_gradients``, for every case of ``W.GRAD_CASES``."""
    mesh = _mesh4()
    cfg = _jcfg()
    out = {}
    for case, (op, over) in W.GRAD_CASES.items():
        def body(p, b, op=op, over=over):
            from torchdistpackage_tpu.parallel.data_parallel import (
                pvary_params,
            )

            g = jax.grad(lambda q: jgpt_loss(q, b, cfg))(
                pvary_params(p, ("data",)))
            g = jreduce(g, "data", op, over)
            return jax.tree.map(lambda x: x[None], g)

        g = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P("data")),
                              out_specs=P("data")))(
            jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, batch))
        out[case] = _flat(jax.tree.map(np.asarray, g))
    return out


@pytest.mark.parametrize("case", sorted(W.GRAD_CASES))
def test_reduce_gradients_world4_matches_jax(world4, inputs, case):
    """The reduced grads themselves (Adam's update hardly sees a grad's
    scale, so a 'sum' step and a 'mean' step train alike): each rank's
    ``reduce_gradients`` against JAX's on the same rows."""
    params, batches = inputs
    try:
        want = _jax_grads(params, batches[0])[case]
    finally:
        jtpc.reset()
    for r, w in enumerate(world4):
        for k, v in want.items():
            np.testing.assert_allclose(w[f"grads/{case}/{k}"], v[r],
                                       err_msg=f"rank {r} {k}", **GRAD_TOL)
    if case == "sum":
        mean = world4[0]["grads/mean/head"]
        np.testing.assert_allclose(world4[0]["grads/sum/head"], 4 * mean,
                                   rtol=1e-5, atol=1e-7)


def test_small_buckets_start_before_the_backward_returns(world4):
    """~10 KB buckets: all-reduces start inside the backward, part of
    them (the last layer's slices) while the block stack's backward is
    still running; one 25 MB bucket starts only when the backward is
    over."""
    for w in world4:
        s = {k.split("/")[-1]: int(w[k]) for k in w
             if k.startswith("dp/accum1/stats/")}
        assert s["buckets"] > 1
        assert 0 < s["bytes_before_blocks_done"] \
            < s["bytes_before_backward_returned"] <= s["bytes"]
        one = {k.split("/")[-1]: int(w[k]) for k in w
               if k.startswith("dp/one_bucket/stats/")}
        assert one["buckets"] == 1 and one["bytes_before_backward_returned"] == 0


def test_moe_dp_override_world4_matches_jax(world4):
    """``reduce_gradients(axis=('moe_dp', 'moe_ep'), grad_reduce_overrides=
    {'expert': ('moe_dp',)})`` on the ``moe`` view at world 4, ``moe_ep``
    2: shared grads are the global mean of x (1.5); ep rank j's expert
    grad sums x over its moe_dp peers (j + (2 + j)) and divides by the
    full data size 4."""
    jtpc.reset()
    try:
        jtpc.setup_process_groups([("data", WORLD)],
                                  devices=jax.devices()[:WORLD])
        mesh = jtpc.build_moe_mesh(moe_ep_size=2)
        from torchdistpackage_tpu.parallel.data_parallel import pvary_params

        params = {"shared": jnp.ones((4,)), "expert": jnp.ones((4,))}

        def body(p, xx):
            p = pvary_params(p, ("moe_dp", "moe_ep"))
            g = jax.grad(lambda p: jnp.mean(xx) * (
                jnp.sum(p["shared"]) + jnp.sum(p["expert"])))(p)
            g = jreduce(g, axis=("moe_dp", "moe_ep"),
                        grad_reduce_overrides={"expert": ("moe_dp",)})
            return jax.tree.map(lambda a: a[None], g)

        g = jax.jit(shard_map(
            body, mesh=mesh, in_specs=(P(), P(("moe_dp", "moe_ep"))),
            out_specs=P(("moe_dp", "moe_ep"))))(params, jnp.arange(4.0))
        g = jax.tree.map(np.asarray, g)
    finally:
        jtpc.reset()
    for r, w in enumerate(world4):
        ep = r % 2
        np.testing.assert_allclose(w["moe_dp/shared"], g["shared"][r],
                                   rtol=1e-6)
        np.testing.assert_allclose(w["moe_dp/expert"], g["expert"][r],
                                   rtol=1e-6)
        np.testing.assert_allclose(w["moe_dp/shared"], 1.5, rtol=1e-6)
        np.testing.assert_allclose(w["moe_dp/expert"], (2 * ep + 2) / 4,
                                   rtol=1e-6)


def test_broadcast_params_world4(world4):
    src = {k[len("broadcast/before/"):]: v for k, v in world4[0].items()
           if k.startswith("broadcast/before/")}
    assert not np.array_equal(world4[1]["broadcast/before/tok_emb"],
                              src["tok_emb"])  # drawn apart
    for k, v in src.items():
        for w in world4:
            np.testing.assert_array_equal(w[f"broadcast/after/{k}"], v,
                                          err_msg=k)


def test_shard_batch_world4_gives_the_rows_of_jax_shard_batch(world4,
                                                              inputs):
    _, batches = inputs
    _mesh4()
    try:
        sharded = JDP().shard_batch(jax.tree.map(jnp.asarray, batches[0]))
        shards = sorted(sharded["tokens"].addressable_shards,
                        key=lambda s: s.index[0].start)
        want = [np.asarray(s.data) for s in shards]
    finally:
        jtpc.reset()
    for r, w in enumerate(world4):
        np.testing.assert_array_equal(w["shard/tokens"], want[r])


def test_dropout_masks_by_data_and_tensor_rank(world4):
    """``axis_unique_key(7, 'data')`` on a data 2 x tensor 2 layout with
    the same tokens everywhere: tensor peers draw the same masks, data
    peers different ones (ranks: d0t0, d0t1, d1t0, d1t1)."""
    h = [w["dropout/h"] for w in world4]
    np.testing.assert_array_equal(h[0], h[1])
    np.testing.assert_array_equal(h[2], h[3])
    assert np.abs(h[0] - h[2]).max() > 1e-3
    for w in world4:
        assert sorted(w["dropout/comm"]) == ["data", "tensor"]


# ------------------------------------------------------------ world 1


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A one-rank gloo group in this process, torn down after the
    module."""
    from torchdistpackage_tpu_torch.dist import init_distributed, tpc

    store = tmp_path_factory.mktemp("dp1") / "store"
    init_distributed(f"file://{store}", 1, 0, "cpu")
    try:
        tpc.setup_process_groups([("data", 1)])
        yield tpc
    finally:
        tpc.reset()
        dist.destroy_process_group()


def _port_run(inputs, dp_kw=None, M=1, acc="final", remat=False):
    from torchdistpackage_tpu_torch.models import gpt_loss, params_from_jax
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        DataParallel,
        adamw,
        make_train_step,
    )

    params, batches = inputs
    cfg = W.config()
    p = params_from_jax(params, cfg, device="cpu")
    opt = adamw(W.LR)
    state = opt.init(p)
    lf = lambda q, b: gpt_loss(q, b, cfg, remat=remat)  # noqa: E731
    if dp_kw is None:
        step = make_train_step(lf, opt)
    else:
        dp = DataParallel(**dp_kw)
        step = dp.make_train_step(lf, opt, grad_accum_iters=M,
                                  accum_reduce=acc)
    losses = []
    for b in batches:
        tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
        p, state, loss, _ = step(p, state, tb)
        losses.append(loss)
    return losses, p


@pytest.mark.parametrize("remat", [False, "flash"])
@pytest.mark.parametrize("acc", ["final", "microbatch"])
def test_dp_world1_is_bit_identical_to_make_train_step(world1, inputs,
                                                       acc, remat):
    """One microbatch reduced either way trains bit for bit as the
    single-device step."""
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves

    want_l, want_p = _port_run(inputs, remat=remat)
    got_l, got_p = _port_run(inputs, dict(bucket_cap_mb=0.01), acc=acc,
                             remat=remat)
    for a, b in zip(got_l, want_l):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(got_p), tree_leaves(want_p)):
        assert torch.equal(a, b)


def test_value_and_grad_fn_and_numerics_paths(world1, inputs):
    """``value_and_grad_fn`` (grads reduced after it returns) trains as
    the ``loss_fn`` path; ``numerics=True`` returns the stats dict."""
    from torchdistpackage_tpu_torch.models import gpt_loss, params_from_jax
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        DataParallel,
        adamw,
        local_value_and_grad,
    )

    params, batches = inputs
    cfg = W.config()
    lf = lambda q, b: gpt_loss(q, b, cfg)  # noqa: E731
    out = {}
    for path in ("loss_fn", "value_and_grad_fn"):
        p = params_from_jax(params, cfg, device="cpu")
        opt = adamw(W.LR)
        state = opt.init(p)
        dp = DataParallel()
        if path == "loss_fn":
            step = dp.make_train_step(lf, opt, numerics=True)
        else:
            step = dp.make_train_step(
                value_and_grad_fn=lambda q, b: local_value_and_grad(lf, q, b),
                optimizer=opt, numerics=True)
        for b in batches:
            tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
            p, state, loss, stats = step(p, state, tb)
        assert set(stats) == {"grad_norm", "param_norm", "nonfinite_grads"}
        assert int(stats["nonfinite_grads"]) == 0
        out[path] = (loss, list(tree_leaves(p)))
    assert torch.allclose(out["loss_fn"][0], out["value_and_grad_fn"][0],
                          rtol=0, atol=1e-6)
    for a, b in zip(out["loss_fn"][1], out["value_and_grad_fn"][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_local_value_and_grad_matches_the_step(world1, inputs):
    """``local_value_and_grad`` with 2 microbatches and a per-microbatch
    ``reduce_gradients`` gives the grads and loss of the step's
    'microbatch' accumulation (one rank: the reduce is the identity)."""
    from torchdistpackage_tpu_torch.models import gpt_loss, params_from_jax
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        local_value_and_grad,
        reduce_gradients,
    )

    params, batches = inputs
    cfg = W.config()
    p = params_from_jax(params, cfg, device="cpu")
    for leaf in tree_leaves(p):
        leaf.requires_grad_(True)
    tb = {k: torch.from_numpy(v).long() for k, v in batches[0].items()}
    lf = lambda q, b: gpt_loss(q, b, cfg)  # noqa: E731
    loss, g = local_value_and_grad(lf, p, tb, 2, reduce_fn=reduce_gradients)
    l1, g1 = local_value_and_grad(lf, p, {k: v[:4] for k, v in tb.items()})
    l2, g2 = local_value_and_grad(lf, p, {k: v[4:] for k, v in tb.items()})
    assert torch.allclose(loss, (l1 + l2) / 2, rtol=0, atol=1e-6)
    torch.testing.assert_close(g["head"], (g1["head"] + g2["head"]) / 2,
                               rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="not divisible"):
        local_value_and_grad(lf, p, tb, 3)


def test_dp_refusals(world1):
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        DataParallel,
        adamw,
        normalize_model_axis_grads,
        reduce_gradients,
    )

    # JAX's modes are accepted (at one rank the int8 mean is the exact
    # one; the multi-rank runs are in tests/test_torch_compressed.py)
    assert DataParallel(grad_compress="int8").grad_compress == "int8"
    g = reduce_gradients({"w": torch.arange(4.0)}, compress="auto",
                         compress_min_size=0, compress_policy={"w": True})
    assert torch.equal(g["w"], torch.arange(4.0))
    with pytest.raises(ValueError, match="ZeroOptimizer"):
        DataParallel(grad_compress="int8_ef")
    with pytest.raises(ValueError, match="unknown grad_compress"):
        reduce_gradients({"w": torch.ones(2)}, compress="int4")
    with pytest.raises(ValueError, match="mean-op"):
        DataParallel(grad_compress="int8", reduce_op="sum")
    with pytest.raises(ValueError, match="reduce op"):
        DataParallel(reduce_op="max")
    dp = DataParallel()
    with pytest.raises(ValueError, match="exactly one"):
        dp.make_train_step(optimizer=adamw())
    with pytest.raises(ValueError, match="accum_reduce"):
        dp.make_train_step(lambda p, b: None, adamw(), accum_reduce="x")
    with pytest.raises(ValueError, match="grad_accum_iters"):
        dp.make_train_step(value_and_grad_fn=lambda p, b: None,
                           optimizer=adamw(), grad_accum_iters=2)
    g = {"w": torch.ones(2)}
    assert normalize_model_axis_grads(None, g)[0] is g
