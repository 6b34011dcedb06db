"""The port's pipeline beside data, ZeRO and tensor parallelism, against
the JAX package's serial trajectories.

One launch of 4 ``tests/_torch_pipeline_worker.py`` processes (job
``compose``, gloo over a ``file://`` store, JAX-free) starts in a module
fixture before this process computes JAX's oracles:

- data 2 x pipe 2 (``tests/test_pipeline.py:671``): ``pipeline_loss``
  inside ``DataParallel.make_train_step(loss_fn)`` on the 4-block stack
  (MSE), and ``gpt_pipeline_1f1b`` as ``DataParallel``'s
  ``value_and_grad_fn`` on the tiny GPT; 2 AdamW(1e-2) steps each
  against the serial ``optax.adamw`` trajectory on the whole batch, and
  the step's norm (slab squares summed over the pipe group) against the
  serial norm;
- ZeRO x 1F1B (``tests/test_zero.py:165``) on ``build_hybrid_mesh(2)``
  beside pipe 2: 3 steps against the serial trajectory, and with the clip
  chain (its norms against the serial norms);
- the planted fault "a cotangent sent to the wrong neighbour": each
  stage's cotangent goes to (and comes from) the other data replica's
  stage; the data-reduced grads must miss the serial grads the correct
  routing meets;
- pipe 2 x tensor 2 (``test_zb_tp_pp_composition``, :416):
  ``gpt_pipeline_1f1b`` and ``gpt_pipeline_zb`` with ``tp_group`` and
  ``shard_transfers`` against the serial golden.

In this process: ``normalize_model_axis_grads``' rule on a data x pipe
layout against JAX's on JAX's own pipelined loss.  Tolerances: the
schedules' grads JAX's 5e-5 (loss ``rtol`` 1e-5); the trajectories
``tests/test_pipeline.py:671``'s and ``tests/test_zero.py``'s (losses
``rtol`` 1e-4 / ``atol`` 1e-5, parameters ``rtol`` 1e-3 / ``atol``
1e-5).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

from torchdistpackage_tpu.compat import shard_map
from torchdistpackage_tpu.dist import tpc as jtpc
from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import gpt_loss as jgpt_loss
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.parallel import pipeline_parallel as jpp
from torchdistpackage_tpu.parallel.clip import (
    clip_by_global_norm_parallel as jclip,
)
from torchdistpackage_tpu.parallel.data_parallel import (
    normalize_model_axis_grads as jnormalize,
)
from torchdistpackage_tpu.parallel.tensor_parallel import (
    TransformerConfig as JTC,
)
from torchdistpackage_tpu.parallel.tensor_parallel import (
    block_forward as jblock,
)
from torchdistpackage_tpu.parallel.tensor_parallel import (
    init_block_params as jinit_block,
)
from torchdistpackage_tpu_torch.dist.topology import ParallelContext

sys.path.insert(0, str(Path(__file__).parent))
import _torch_pipeline_worker as W  # noqa: E402

M, MBS, S = W.M, W.MBS, W.S
JCFG = JTC(**W.BLK)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _gcfg():
    return JGPTConfig(**W.GPT, dtype=jnp.float32, attn_impl="naive")


def _flat(tree, prefix):
    return {prefix + k: v for k, v in W.flatten(_np(tree)).items()}


def _blk_stack():
    keys = jax.random.split(jax.random.PRNGKey(0), JCFG.nlayers)
    return jpp.stack_stage_params([jinit_block(k, JCFG) for k in keys])


def _blk_loss(sp, b):
    def one(i):
        def body(h, lp):
            return jblock(lp, h, JCFG), None
        h, _ = jax.lax.scan(body, b["x"][i], sp)
        return jnp.mean((h - b["y"][i]) ** 2)
    return jnp.mean(jnp.stack([one(i) for i in range(M)]))


def _gpt_loss(p, b):
    cfg = _gcfg()
    return jnp.mean(jnp.stack([jgpt_loss(
        p, {"tokens": b["tokens"][i], "targets": b["targets"][i]}, cfg)
        for i in range(M)]))


def _inputs():
    out = _flat(_blk_stack(), "blk/params/")
    out.update(_flat(jinit(jax.random.PRNGKey(0), _gcfg()), "gpt/params/"))
    rs = np.random.RandomState(0)
    for k in ("tokens", "targets"):
        out[f"gpt/batch/{k}"] = rs.randint(
            0, W.GPT["vocab_size"], (M, MBS, S)).astype(np.int32)
    for i in range(max(W.DP_STEPS, W.ZERO_STEPS)):
        for k in ("tokens", "targets"):
            out[f"dpgpt/batch{i}/{k}"] = rs.randint(
                0, W.GPT["vocab_size"], (M, 2 * MBS, S)).astype(np.int32)
    for i in range(W.DP_STEPS):
        kx, ky = jax.random.split(jax.random.PRNGKey(10 + i))
        out[f"dpblk/batch{i}/x"] = np.asarray(
            jax.random.normal(kx, (M, 2 * MBS, S, JCFG.dim)))
        out[f"dpblk/batch{i}/y"] = np.asarray(
            jax.random.normal(ky, (M, 2 * MBS, S, JCFG.dim)))
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    inp = _inputs()
    tmp = tmp_path_factory.mktemp("pipe_compose")
    return inp, (W.start("compose", 4, inp, tmp), tmp)


def _trajectory(loss_fn, params, batches, opt):
    @jax.jit
    def step(p, s, b):
        loss, g = jax.value_and_grad(loss_fn)(p, b)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss, optax.global_norm(g)

    s = opt.init(params)
    losses, norms = [], []
    for b in batches:
        params, s, loss, n = step(params, s, b)
        losses.append(float(loss))
        norms.append(float(n))
    return np.asarray(losses), np.asarray(norms), _np(params)


@pytest.fixture(scope="module")
def oracles(launched):
    inp = launched[0]

    def batches(prefix, n, keys):
        return [{k: jnp.asarray(inp[f"{prefix}{i}/{k}"]) for k in keys}
                for i in range(n)]
    gp = jinit(jax.random.PRNGKey(0), _gcfg())
    tk = ("tokens", "targets")
    out = {
        "dp_loss": _trajectory(_blk_loss, _blk_stack(), batches(
            "dpblk/batch", W.DP_STEPS, ("x", "y")), optax.adamw(W.LR)),
        "dp_1f1b": _trajectory(_gpt_loss, gp, batches(
            "dpgpt/batch", W.DP_STEPS, tk), optax.adamw(W.LR)),
        "zero": _trajectory(_gpt_loss, gp, batches(
            "dpgpt/batch", W.ZERO_STEPS, tk), optax.adamw(W.LR)),
        "zero_clip": _trajectory(_gpt_loss, gp, batches(
            "dpgpt/batch", W.ZERO_STEPS, tk), optax.chain(
                jclip(W.CLIP), optax.adamw(W.LR))),
    }
    b0 = batches("dpgpt/batch", 1, tk)[0]
    out["route"] = _np(jax.jit(jax.grad(_gpt_loss))(gp, b0))
    single = {k: jnp.asarray(inp[f"gpt/batch/{k}"]) for k in tk}
    out["gold"] = _np(jax.jit(jax.value_and_grad(_gpt_loss))(gp, single))
    return out


@pytest.fixture(scope="module")
def world4(launched, oracles):
    return W.results(*launched[1])


# ------------------------------------------------------------- helpers


def _tree(r, tag, what):
    pre = f"{tag}/{what}/"
    return W.unflatten({k[len(pre):]: v for k, v in r.items()
                        if k.startswith(pre)})


def _join(rs, tag, what, stage_of):
    """The whole tree from each stage's own: the block slabs concatenated
    in stage order, the whole leaves from stage 0 (every stage's equal)."""
    by = {}
    for r, s in zip(rs, stage_of):
        by.setdefault(s, _tree(r, tag, what))
    trees = [by[s] for s in sorted(by)]
    if "blocks" not in trees[0]:  # a block stack: every leaf a slab
        return jax.tree.map(lambda *a: np.concatenate(a, 0), *trees)
    for t in trees[1:]:
        for k in t:
            if k != "blocks":
                jax.tree.map(lambda a, b: np.testing.assert_allclose(
                    a, b, rtol=1e-6, atol=1e-7), t[k], trees[0][k])
    return {**trees[0], "blocks": jax.tree.map(
        lambda *a: np.concatenate(a, 0), *[t["blocks"] for t in trees])}


def _close(got, want, **tol):
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol,
                                   err_msg=jax.tree_util.keystr(path))


def _close_params(got, want, steps):
    """Parameters after ``steps`` AdamW steps: the key bias
    (``bqkv[:, 1]``) gets a zero grad in exact arithmetic, so AdamW moves
    it by up to lr a step on rounding noise on both sides — held to 2 lr
    a step; every other entry to ``PARAM_TOL``."""
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for p in path:
            g = g[p.key]
        g, w = np.asarray(g), np.asarray(w)
        name = jax.tree_util.keystr(path)
        if name.endswith("['bqkv']"):
            np.testing.assert_allclose(g[..., 1, :], w[..., 1, :], rtol=0,
                                       atol=2 * W.LR * steps, err_msg=name)
            g, w = np.delete(g, 1, -2), np.delete(w, 1, -2)
        np.testing.assert_allclose(g, w, **PARAM_TOL, err_msg=name)


DATA_PIPE = [0, 1, 0, 1]   # stage of ranks 0-3 on data 2 x pipe 2
PIPE_TENSOR = [0, 0, 1, 1]  # on pipe 2 x tensor 2


# ---------------------------------------------------------------- tests


@pytest.mark.parametrize("tag", ["dp_loss", "dp_1f1b"])
def test_data_parallel_beside_the_pipeline(world4, oracles, tag):
    """``DataParallel`` over the data group only, the pipelined loss the
    same on every stage, the replicated leaves' pipe sum the schedule's:
    2 AdamW steps equal the serial trajectory; the step's norm is the
    serial grads' (the slabs' squares summed over the pipe group)."""
    losses, norms, params = oracles[tag]
    for r in world4:
        np.testing.assert_allclose(r[f"{tag}/losses"], losses, **LOSS_TOL)
    _close_params(_join(world4, tag, "params", DATA_PIPE), params,
                  W.DP_STEPS)
    if tag == "dp_1f1b":
        for r in world4:
            np.testing.assert_allclose(r[f"{tag}/norms"], norms, rtol=1e-4)


@pytest.mark.parametrize("tag", ["zero", "zero_clip"])
def test_zero_beside_1f1b(world4, oracles, tag):
    """ZeRO x 1F1B on the hybrid view (``data_intra`` the shard axis)
    beside pipe 2: each stage's masters are its own leaves' shards; 3
    steps equal the serial trajectory, and under the clip chain the norms
    (slabs once a stage, summed over pipe; whole leaves once) equal the
    serial norms and the clip bites."""
    losses, norms, params = oracles[tag]
    for r in world4:
        np.testing.assert_allclose(r[f"{tag}/losses"], losses, **LOSS_TOL)
        np.testing.assert_allclose(r[f"{tag}/norms"], norms, rtol=1e-4)
    _close_params(_join(world4, tag, "params", DATA_PIPE), params,
                  W.ZERO_STEPS)
    if tag == "zero_clip":
        assert (norms > W.CLIP).all()


def test_misrouted_cotangent_fails(world4, oracles):
    """The planted fault: cotangents sent to the wrong neighbour (the
    other data replica's stage) give data-reduced grads off the serial
    ones, which the correct routing meets."""
    want = oracles["route"]
    _close(_join(world4, "route", "grads", DATA_PIPE), want, **GRAD_TOL)
    bad = _join(world4, "fault_route", "grads", DATA_PIPE)
    with pytest.raises(AssertionError):
        _close(bad["blocks"], want["blocks"], **GRAD_TOL)


@pytest.mark.parametrize("tag", ["tp_1f1b", "tp_zb"])
def test_tensor_parallel_beside_the_pipeline(world4, oracles, tag):
    """Pipe 2 x tensor 2, the inter-stage state sliced 1/2 over the
    tensor group (a gather at each stage entry): the loss and the grads,
    gathered over the tensor group, equal the serial golden."""
    want_l, want_g = oracles["gold"]
    for r in world4:
        np.testing.assert_allclose(float(r[f"{tag}/loss"]), float(want_l),
                                   rtol=1e-5)
        assert int(r[f"{tag}/gathers"]) > 0
    _close(_join(world4, tag, "grads", PIPE_TENSOR), want_g, **GRAD_TOL)


def test_normalize_rule_matches_jax_on_a_pipelined_loss():
    """JAX's ``normalize_model_axis_grads`` on JAX's own pipelined loss
    (``pipeline_loss`` inside ``shard_map`` over data 2 x pipe 2) returns
    no model axis (the loss is pipe-invariant: psum-ed from the last
    stage), so nothing is rescaled; the port's rule returns the same on a
    data 2 x pipe 2 layout, the grads as they are.  A context axis outside
    the data axes is a model axis of the same kind (the ViT pools over it
    inside the model): the grads come back as they are there too (the
    layout alone, no loss: a given loss is compared across the context
    group, ``tests/test_torch_gpt_cp.py``)."""
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        normalize_model_axis_grads,
    )

    jtpc.reset()
    jtpc.setup_process_groups([("data", 2), ("pipe", 2)],
                              devices=jax.devices()[:4])
    mesh = jtpc.get_view()
    stacked = _blk_stack()
    specs = jpp.stacked_param_specs(stacked, "pipe")
    seen = []

    def body(params, x, y):
        loss, grads = jax.value_and_grad(lambda p: jpp.pipeline_loss(
            p, x, y, stage_fn=lambda sp, h: jax.lax.scan(
                lambda c, lp: (jblock(lp, c, JCFG), None), h, sp)[0],
            loss_fn=lambda o, t: jnp.mean((o - t) ** 2),
            num_microbatches=M))(params)
        _, other = jnormalize(loss, grads, mesh, ("data",))
        seen.append(other)
        return jax.lax.pmean(loss, "data")

    x = jax.ShapeDtypeStruct((M, 2 * MBS, S, JCFG.dim), jnp.float32)
    jax.eval_shape(shard_map(body, mesh=mesh,
                             in_specs=(specs, P(None, "data"),
                                       P(None, "data")),
                             out_specs=P()), stacked, x, x)
    jtpc.reset()
    assert seen == [()]
    ctx = ParallelContext()
    ctx.setup_process_groups([("data", 2), ("pipe", 2)], world_size=4,
                             rank=0)
    grads = {"w": np.ones(3)}
    out, other = normalize_model_axis_grads(1.0, grads, ctx)
    assert other == () and out is grads
    cp = ParallelContext()
    cp.setup_process_groups([("data", 2), ("context", 2)], world_size=4,
                            rank=0)
    out, other = normalize_model_axis_grads(None, grads, cp)
    assert other == () and out is grads
