"""The port's pipeline schedules against the JAX package's.

One launch of 2 and one of 4 ``tests/_torch_pipeline_worker.py``
processes (job ``sched``, gloo over a ``file://`` store, JAX-free) start
in a module fixture before this process computes JAX's oracles on the
conftest's CPU devices, so the workers and JAX's compiles overlap.  The
inputs are JAX's: the 4-block stack of ``tests/test_pipeline.py:47``
(dim 32, 4 heads, f32) with its microbatches ``[4, 2, 16, 32]``, and the
tiny GPT of ``tests/test_zero.py:185`` (vocab 64, dim 32, 4 heads, 4
layers, S 16) on ``[M 4, mbs 2, 16]`` token batches, carried over by
``params_from_jax(pp_rank=, pp_size=, num_chunks=)``.  The serial golden
is JAX's ``gpt_loss`` (or the block stack's MSE) averaged over the M
microbatches; JAX's own schedules run under ``shard_map`` at the same P.

Tolerances are JAX's (``tests/test_pipeline.py``): against the serial
golden the loss ``rtol`` 1e-5 and the grads ``rtol`` / ``atol`` 5e-5;
ZB against 1F1B under one key the loss 1e-6 and the grads ``rtol`` 2e-5 /
``atol`` 2e-6; ``pipeline_forward``'s outputs ``atol`` 2e-5.

In this process, over a one-rank gloo group: the partitioners, the
balanced stack's mask, ``scan_blocks(layer_mask=)``, the interleaved
layout, ``pipe_slab``, the tick counts, the guards (stage_fn arity, the
bus's) and the refusals.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from torchdistpackage_tpu.compat import shard_map
from torchdistpackage_tpu.dist import tpc as jtpc
from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import gpt_loss as jgpt_loss
from torchdistpackage_tpu.models import gpt_param_specs as jgpt_specs
from torchdistpackage_tpu.models import gpt_pipeline_1f1b as jgpt_1f1b
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.models import gpt as jgpt
from torchdistpackage_tpu.parallel import pipeline_parallel as jpp
from torchdistpackage_tpu.parallel.tensor_parallel import (
    TransformerConfig as JTC,
)
from torchdistpackage_tpu.parallel.tensor_parallel import (
    block_forward as jblock,
)
from torchdistpackage_tpu.parallel.tensor_parallel import (
    init_block_params as jinit_block,
)
from torchdistpackage_tpu.parallel.tensor_parallel import (
    scan_blocks as jscan_blocks,
)

sys.path.insert(0, str(Path(__file__).parent))
import _torch_pipeline_worker as W  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
M, MBS, S = W.M, W.MBS, W.S
JCFG = JTC(**W.BLK)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _gcfg(**kw):
    return JGPTConfig(**dict(W.GPT, **kw), dtype=jnp.float32,
                      attn_impl="naive")


def _flat(tree, prefix):
    return {prefix + k: v for k, v in W.flatten(_np(tree)).items()}


def _blk_stack():
    keys = jax.random.split(jax.random.PRNGKey(0), JCFG.nlayers)
    layers = [jinit_block(k, JCFG) for k in keys]
    return layers, jpp.stack_stage_params(layers)


def _blk_serial(sp, xx, yy):
    def one(i):
        def body(h, lp):
            return jblock(lp, h, JCFG), None
        h, _ = jax.lax.scan(body, xx[i], sp)
        return jnp.mean((h - yy[i]) ** 2)
    return jnp.mean(jnp.stack([one(i) for i in range(xx.shape[0])]))


def _gpt_serial(cfg, m):
    def loss(p, b):
        return jnp.mean(jnp.stack([jgpt_loss(
            p, {"tokens": b["tokens"][i], "targets": b["targets"][i]}, cfg)
            for i in range(m)]))
    return jax.jit(jax.value_and_grad(loss))


def _inputs():
    out = {}
    _, stacked = _blk_stack()
    out.update(_flat(stacked, "blk/params/"))
    out["blk/x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                                (M, MBS, S, JCFG.dim)))
    out["blk/y"] = np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                                (M, MBS, S, JCFG.dim)))
    out.update(_flat(jinit(jax.random.PRNGKey(0), _gcfg()), "gpt/params/"))
    rs = np.random.RandomState(0)
    for k in ("tokens", "targets"):
        out[f"gpt/batch/{k}"] = rs.randint(
            0, W.GPT["vocab_size"], (M, MBS, S)).astype(np.int32)
    k0, k1, kx, ky = jax.random.split(jax.random.PRNGKey(3), 4)
    D = W.HET
    out["het/params/w0"] = np.asarray(
        jax.random.normal(k0, (D["D0"], D["D1"])) / np.sqrt(D["D0"]))
    out["het/params/w1"] = np.asarray(
        jax.random.normal(k1, (D["D1"], D["D2"])) / np.sqrt(D["D1"]))
    out["het/x"] = np.asarray(jax.random.normal(kx, (M, MBS, D["D0"])))
    out["het/y"] = np.asarray(jax.random.normal(ky, (M, MBS, D["D2"])))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worker launches, started first; waited for in ``ranks``."""
    inp = _inputs()
    tmp = tmp_path_factory.mktemp("pipe")
    procs = {P_: (W.start("sched", P_, inp, tmp / f"w{P_}"), tmp / f"w{P_}")
             for P_ in (2, 4)}
    return inp, procs, {}


def ranks(runs, P_):
    inp, procs, done = runs
    if P_ not in done:
        done[P_] = W.results(*procs[P_])
    return done[P_]


@pytest.fixture(scope="module")
def gold(runs):
    """JAX's serial goldens (computed while the workers run)."""
    inp = runs[0]
    _, stacked = _blk_stack()
    x, y = jnp.asarray(inp["blk/x"]), jnp.asarray(inp["blk/y"])
    want_fwd = []
    for m in range(M):
        h = x[m]
        for lp in jpp.unstack_stage_params(stacked):
            h = jblock(lp, h, JCFG)
        want_fwd.append(h)
    bl, bg = jax.jit(jax.value_and_grad(_blk_serial))(stacked, x, y)
    params = jinit(jax.random.PRNGKey(0), _gcfg())
    batch = {k: jnp.asarray(inp[f"gpt/batch/{k}"]) for k in
             ("tokens", "targets")}
    out = {"fwd": np.stack([np.asarray(h) for h in want_fwd]),
           "blk": (float(bl), _np(bg))}
    for m in (4, 2):
        l, g = _gpt_serial(_gcfg(), m)(params, jax.tree.map(
            lambda a: a[:m], batch))
        out[f"gpt{m}"] = (float(l), _np(g))
    return out


# ------------------------------------------------------------- helpers


def _grads(r, tag):
    return W.unflatten({k[len(tag) + 7:]: v for k, v in r.items()
                        if k.startswith(f"{tag}/grads/")})


def _assemble(rs, tag, P_, V=1):
    """Every stage's grads joined: the block slabs concatenated in stage
    order (interleaved: ``[V, P, Lc]`` deinterleaved), the whole leaves
    from stage 0 (each stage's must equal it)."""
    gs = [_grads(r, tag) for r in rs]
    for g in gs[1:]:
        for k in g:
            if k != "blocks":
                jax.tree.map(np.testing.assert_array_equal, g[k], gs[0][k])
    if V == 1:
        blocks = jax.tree.map(lambda *a: np.concatenate(a, 0),
                              *[g["blocks"] for g in gs])
    else:
        blocks = jax.tree.map(
            lambda *a: np.concatenate(a, 1).reshape(
                (-1,) + a[0].shape[3:]), *[g["blocks"] for g in gs])
    return {**gs[0], "blocks": blocks}


def _close(got, want, **tol):
    got_l = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in got_l:
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol,
                                   err_msg=jax.tree_util.keystr(path))


def _differs(got, want, **tol):
    try:
        _close(got, want, **tol)
    except AssertionError:
        return True
    return False


# ------------------------------------------------- multi-rank schedules


@pytest.mark.parametrize("P_", [2, 4])
def test_shifts_and_their_backward(runs, P_):
    """``shift_right`` / ``shift_left`` (JAX pipeline_sched.py:135-159):
    stage ``s`` receives its neighbour's value (zeros at the open end,
    the wrap with ``circular``), and its ``x`` gets back the cotangent the
    receiver seeded (10 x the receiver's s + 1) — the reverse shift; the
    interleaved schedule refuses ``M % P != 0`` before any message."""
    rs = ranks(runs, P_)
    for s, r in enumerate(rs):
        for name, step in (("right", 1), ("left", -1)):
            for circ in (0, 1):
                src, dst = s - step, s + step
                inside = lambda i: 0 <= i < P_  # noqa: E731
                want_y = (src % P_ + 1) if (circ or inside(src)) else 0
                want_g = 10 * (dst % P_ + 1) if (circ or inside(dst)) else 0
                np.testing.assert_array_equal(
                    r[f"shift/{name}{circ}/y"], np.full(3, want_y))
                np.testing.assert_array_equal(
                    r[f"shift/{name}{circ}/grad"], np.full(3, want_g))
        assert bool(r["shift/mod_refused"])


@pytest.mark.parametrize("P_", [2, 4])
def test_pipeline_forward_matches_serial(runs, gold, P_):
    """JAX tests/test_pipeline.py:86: the fill-drain forward's outputs,
    broadcast from the last stage, on every stage."""
    for r in ranks(runs, P_):
        np.testing.assert_allclose(r["fwd"], gold["fwd"], rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("P_", [2, 4])
def test_pipeline_loss_and_grads_match_serial(runs, gold, P_):
    """JAX tests/test_pipeline.py:110: ``pipeline_loss`` under the
    caller's ``backward()``; the stage slabs' grads joined in order."""
    rs = ranks(runs, P_)
    want_l, want_g = gold["blk"]
    for r in rs:
        np.testing.assert_allclose(float(r["loss/loss"]), want_l,
                                   rtol=LOSS_RTOL)
    gs = [_grads(r, "loss") for r in rs]
    got = jax.tree.map(lambda *a: np.concatenate(a, 0), *gs)
    _close(got, want_g, **GRAD_TOL)


def test_gpt_pipeline_loss_matches_serial(runs, gold):
    """``gpt_pipeline_loss`` (JAX models/gpt.py:443) at P 2: the
    embedding's and the head's grads summed over the pipe group inside
    the backward, every stage holding them whole."""
    rs = ranks(runs, 2)
    want_l, want_g = gold["gpt4"]
    for r in rs:
        np.testing.assert_allclose(float(r["gloss/loss"]), want_l,
                                   rtol=LOSS_RTOL)
    _close(_assemble(rs, "gloss", 2), want_g, **GRAD_TOL)


@pytest.mark.parametrize("P_,m,tag", [(2, 4, "1f1b_m4"), (4, 4, "1f1b_m4"),
                                      (4, 2, "1f1b_m2")])
def test_gpt_pipeline_1f1b_matches_serial(runs, gold, P_, m, tag):
    """JAX tests/test_pipeline.py:288: ``gpt_pipeline_1f1b``'s loss (the
    same on every stage) and grads against the serial golden; stage
    ``s`` held at most ``min(M, P - s)`` microbatch graphs, exactly that
    many (test_1f1b_activation_memory_bounded, :559)."""
    rs = ranks(runs, P_)
    want_l, want_g = gold[f"gpt{m}"]
    losses = [float(r[f"{tag}/loss"]) for r in rs]
    assert len(set(losses)) == 1, losses
    np.testing.assert_allclose(losses[0], want_l, rtol=LOSS_RTOL)
    _close(_assemble(rs, tag, P_), want_g, **GRAD_TOL)
    for s, r in enumerate(rs):
        held, bound = r[f"{tag}/stats"]
        assert bound == min(m, P_ - s) and held == bound, (s, held, bound)


def _jax_gpt_1f1b(inp, P_, m):
    jtpc.reset()
    jtpc.setup_process_groups([("pipe", P_)], devices=jax.devices()[:P_])
    mesh = jtpc.get_view()
    cfg = _gcfg()
    specs = jgpt_specs(cfg, tp_axis=None, pipe_axis="pipe")
    params = jax.tree.map(lambda a, s: jax.device_put(
        a, NamedSharding(mesh, s)), jinit(jax.random.PRNGKey(0), cfg), specs)
    batch = {k: jnp.asarray(inp[f"gpt/batch/{k}"])[:m] for k in
             ("tokens", "targets")}
    fn = jax.jit(shard_map(lambda p, b: jgpt_1f1b(p, b, cfg, m), mesh=mesh,
                           in_specs=(specs, P()), out_specs=(P(), specs)))
    loss, grads = fn(params, batch)
    jtpc.reset()
    return float(loss), _np(grads)


def test_gpt_pipeline_1f1b_matches_jax_schedule(runs):
    """JAX's own ``gpt_pipeline_1f1b`` at (P, M) = (2, 4) under
    ``shard_map``, held to the port's within the serial tolerances."""
    want_l, want_g = _jax_gpt_1f1b(runs[0], 2, 4)
    rs = ranks(runs, 2)
    np.testing.assert_allclose(float(rs[0]["1f1b_m4/loss"]), want_l,
                               rtol=LOSS_RTOL)
    _close(_assemble(rs, "1f1b_m4", 2), want_g, **GRAD_TOL)


def test_stage_returns_aux_matches_jax(runs):
    """``pipeline_1f1b(stage_returns_aux=True)``: each stage adds
    ``AUX_W * mean(y ** 2)`` a microbatch; against JAX's ``pipeline_1f1b``
    with the same synthetic aux at P 2."""
    inp = runs[0]
    jtpc.reset()
    jtpc.setup_process_groups([("pipe", 2)], devices=jax.devices()[:2])
    mesh = jtpc.get_view()
    _, stacked = _blk_stack()
    specs = jpp.stacked_param_specs(stacked, "pipe")
    sharded = jax.tree.map(lambda a, s: jax.device_put(
        a, NamedSharding(mesh, s)), stacked, specs)

    def stage(p, h):
        def body(c, lp):
            return jblock(lp, c, JCFG), None
        yy, _ = jax.lax.scan(body, h, p)
        return yy, W.AUX_W * jnp.mean(yy ** 2)

    fn = jax.jit(shard_map(functools.partial(
        jpp.pipeline_1f1b, first_fn=lambda p, mb: mb, stage_fn=stage,
        last_fn=lambda p, o, t: jnp.mean((o - t) ** 2), num_microbatches=M,
        stage_returns_aux=True), mesh=mesh, in_specs=(specs, P(), P()),
        out_specs=(P(), specs)))
    want_l, want_g = fn(sharded, jnp.asarray(inp["blk/x"]),
                        jnp.asarray(inp["blk/y"]))
    jtpc.reset()
    rs = ranks(runs, 2)
    for r in rs:
        np.testing.assert_allclose(float(r["aux/loss"]), float(want_l),
                                   rtol=LOSS_RTOL)
    got = jax.tree.map(lambda *a: np.concatenate(a, 0),
                       *[_grads(r, "aux") for r in rs])
    _close(got, _np(want_g), **GRAD_TOL)


def test_interleaved_matches_serial(runs, gold):
    """JAX tests/test_pipeline.py:966: ``num_chunks=2`` at (P, M) = (2, 4)
    — chunk ``v`` of stage ``s`` holds layer ``2 v + s``; the P-1 -> 0 wrap
    is a real message; at most ``ring_slots`` chunk graphs in flight."""
    rs = ranks(runs, 2)
    want_l, want_g = gold["gpt4"]
    for r in rs:
        np.testing.assert_allclose(float(r["inter/loss"]), want_l,
                                   rtol=LOSS_RTOL)
        held, bound = r["inter/stats"]
        assert bound == jpp.ring_slots(M, 2, 2) and 0 < held <= bound
    _close(_assemble(rs, "inter", 2, V=2), want_g, **GRAD_TOL)


@pytest.mark.parametrize("P_,m,tag", [(2, 4, "zb_m4"), (4, 2, "zb_m2")])
def test_zero_bubble_matches_serial(runs, gold, P_, m, tag):
    """JAX tests/test_pipeline.py:331: the dgrad on the wavefront, the
    wgrad in the drain, the same (loss, grads)."""
    rs = ranks(runs, P_)
    want_l, want_g = gold[f"gpt{m}"]
    for r in rs:
        np.testing.assert_allclose(float(r[f"{tag}/loss"]), want_l,
                                   rtol=LOSS_RTOL)
        assert tuple(r[f"{tag}/stats"]) == (m, m)
    _close(_assemble(rs, tag, P_), want_g, **GRAD_TOL)


def test_zero_bubble_dropout_equals_1f1b(runs):
    """JAX tests/test_pipeline.py:360: under one dropout key ZB equals
    1F1B (loss 1e-6, grads 2e-5 / 2e-6): the dgrad and wgrad recomputes
    replay the forward's masks, keyed by (stage, microbatch).  The masks
    themselves are the port's (Philox, not threefry: ROADMAP C)."""
    rs = ranks(runs, 2)
    for r in rs:
        np.testing.assert_allclose(float(r["drop_zb/loss"]),
                                   float(r["drop_1f1b/loss"]), rtol=1e-6)
        _close(_grads(r, "drop_zb"), _grads(r, "drop_1f1b"), rtol=2e-5,
               atol=2e-6)
    # dropout is on: the loss is not the dropout-free one
    assert float(rs[0]["drop_1f1b/loss"]) != float(rs[0]["1f1b_m4/loss"])


def test_heterogeneous_bus_matches_serial(runs):
    """JAX tests/test_pipeline.py:1105: stage 0 maps 8 -> 12, stage 1 12
    -> 6, carried over the 12-wide bus."""
    inp = runs[0]
    params = {k: jnp.asarray(inp[f"het/params/{k}"]) for k in ("w0", "w1")}

    def serial(p, xx, yy):
        out = jnp.tanh(jnp.tanh(xx @ p["w0"]) @ p["w1"])
        return jnp.mean(jnp.mean((out - yy) ** 2, axis=(1, 2)))

    want_l, want_g = jax.value_and_grad(serial)(
        params, jnp.asarray(inp["het/x"]), jnp.asarray(inp["het/y"]))
    for r in ranks(runs, 2):
        np.testing.assert_allclose(float(r["het/loss"]), float(want_l),
                                   rtol=2e-5)
        _close(_grads(r, "het"), _np(want_g), rtol=2e-4, atol=2e-5)


def test_balanced_stage_stack_pipelines_skewed_load(runs, gold):
    """JAX tests/test_pipeline.py:744: bounds [(0, 1), (1, 4)], slabs
    padded to 3 layers; the real layers' grads match serial, the padding
    rows' are exactly zero."""
    rs = ranks(runs, 2)
    want_l, want_g = gold["blk"]
    assert rs[0]["skew/bounds"].tolist() == [[0, 1], [1, 4]]
    np.testing.assert_allclose(float(rs[0]["skew/loss"]), want_l,
                               rtol=LOSS_RTOL)
    n = rs[0]["skew/mask"].shape[1]
    row_to_layer = [0, -1, -1, 1, 2, 3]
    got = jax.tree.map(lambda *a: np.concatenate(a, 0),
                       *[_grads(r, "skew") for r in rs])
    for path, w in jax.tree_util.tree_flatten_with_path(want_g)[0]:
        g = got
        for p in path:
            g = g[p.key]
        assert g.shape[0] == 2 * n
        for row, layer in enumerate(row_to_layer):
            if layer < 0:
                np.testing.assert_array_equal(g[row], 0.0)
            else:
                np.testing.assert_allclose(g[row], w[layer], **GRAD_TOL)


def test_planted_faults_fail(runs, gold):
    """Each planted fault at P 2 must fail the check the real schedule
    passes: the replicated leaves' pipe sum left out (1F1B), and
    ``last_stage_value``'s backward summing the ranks' cotangents
    (``gpt_pipeline_loss``: every grad P times too large)."""
    rs = ranks(runs, 2)
    want_l, want_g = gold["gpt4"]
    bad = [_grads(r, "fault_nosum") for r in rs]
    assert any(_differs({k: g[k] for k in g if k != "blocks"},
                        {k: want_g[k] for k in want_g if k != "blocks"},
                        **GRAD_TOL) for g in bad)
    lsv = _assemble(rs, "fault_lsv", 2)
    assert _differs(lsv, want_g, **GRAD_TOL)
    _close(lsv, jax.tree.map(lambda a: 2 * a, want_g), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------- in this process


@pytest.fixture(scope="module")
def group1(tmp_path_factory):
    """A one-rank gloo group in this process (destroyed at module end)."""
    from torchdistpackage_tpu_torch.dist import init_distributed
    from torchdistpackage_tpu_torch.dist import tpc as ttpc

    store = tmp_path_factory.mktemp("pp1") / "store"
    init_distributed(f"file://{store}", 1, 0, "cpu")
    ttpc.setup_process_groups([("data", 1), ("pipe", 1)])
    try:
        yield ttpc.get_group("pipe")
    finally:
        ttpc.reset()
        dist.destroy_process_group()


def test_partitioners_and_mask_exact():
    """JAX tests/test_pipeline.py:51, and the balanced stack's mask and
    bounds, exactly the JAX package's."""
    from torchdistpackage_tpu_torch.parallel import pipeline_parallel as pp

    cases = [(10, 4), (7, 3), (4, 4), (5, 1)]
    for n, k in cases:
        assert pp.partition_uniform(n, k) == jpp.partition_uniform(n, k)
    for w, k in [([1, 1, 8, 1, 1, 1], 3), ([3, 1, 1, 1], 2),
                 ([1, 2, 3, 4, 5, 6, 7], 4), ([5] * 8, 3)]:
        assert pp.partition_balanced(w, k) == jpp.partition_balanced(w, k)
        for meth in ("uniform", "balanced"):
            assert pp.flat_and_partition(w, k, meth) == \
                jpp.flat_and_partition(w, k, meth)
    with pytest.raises(ValueError, match="cannot split"):
        pp.partition_balanced([1, 2], 3)
    layers, _ = _blk_stack()
    tl = [W.tensors(_np(lp)) for lp in layers]
    for w, k in [(W.SKEW, 2), ([1, 1, 1, 5], 3), ([1, 1, 1, 1], 2)]:
        js, jm, jb = jpp.balanced_stage_stack(layers, w, k)
        ts, tm, tb = pp.balanced_stage_stack(tl, w, k)
        assert tb == jb
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), b.numpy()), _np(js), ts)
    assert pp.param_count(tl[0]) == jpp.param_count(layers[0])
    back = pp.unstack_stage_params(pp.stack_stage_params(tl))
    for a, b in zip(back, tl):
        jax.tree.map(lambda x, y: np.testing.assert_array_equal(
            x.numpy(), y.numpy()), a, b)
    specs = pp.stacked_param_specs(tl[0], "pipe")
    assert all(s == ("pipe",) for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, tuple)))
    assert pp.pipe_split_flags(tl[0], specs) == [True] * 12
    assert pp.pipe_split_flags(tl[0], None) == [False] * 12


def test_scan_blocks_layer_mask_matches_jax():
    """``scan_blocks(layer_mask=)`` (JAX layers.py:910): the padded slab's
    output and grads equal JAX's; the padding layer's grads are exactly
    zero and it runs no compute (its block is never called)."""
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        TransformerConfig,
        layers,
        scan_blocks,
    )

    layers_j, stacked = _blk_stack()
    mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    x = jax.random.normal(jax.random.PRNGKey(5), (MBS, S, JCFG.dim))

    def f(sp, xx):
        return jnp.sum(jscan_blocks(sp, xx, JCFG,
                                    layer_mask=jnp.asarray(mask)) ** 2)

    want_y = jscan_blocks(stacked, x, JCFG, layer_mask=jnp.asarray(mask))
    want_g = jax.grad(f)(stacked, x)
    tstack = W.trainable(W.tensors(_np(stacked)))
    calls = []
    real = layers.block_forward

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)
    layers.block_forward = counting
    try:
        y = scan_blocks(tstack, torch.from_numpy(np.asarray(x)),
                        TransformerConfig(**W.BLK), layer_mask=mask)
    finally:
        layers.block_forward = real
    assert len(calls) == 3
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=2e-5, atol=2e-5)
    got = jax.tree.map(lambda t: t.grad.numpy(), tstack)
    _close(got, _np(want_g), rtol=1e-4, atol=1e-4)
    for g in jax.tree.leaves(got):
        np.testing.assert_array_equal(g[1], 0.0)
    with pytest.raises(ValueError, match="layer_mask has 2"):
        scan_blocks(tstack, torch.zeros(MBS, S, JCFG.dim),
                    TransformerConfig(**W.BLK), layer_mask=[1, 1])


def test_interleaved_layout_and_slabs_match_jax():
    """``interleave_stage_params`` / ``deinterleave_stage_params`` /
    ``gpt_interleaved_param_specs`` (JAX models/gpt.py:496-553),
    ``pipe_slab`` and ``params_from_jax(pp_rank=, pp_size=)`` against
    JAX's layouts and ``gpt_param_specs(pipe_axis=)``."""
    from torchdistpackage_tpu_torch.models import (
        deinterleave_stage_params,
        gpt_interleaved_param_specs,
        gpt_param_specs,
        interleave_stage_params,
        params_from_jax,
        pipe_slab,
    )

    cfg = _gcfg()
    jp = _np(jinit(jax.random.PRNGKey(0), cfg))
    tcfg = W.gcfg()
    for V, P_ in ((2, 2), (1, 4), (4, 1)):
        ji = _np(jgpt.interleave_stage_params(jp, V, P_))
        ti = interleave_stage_params(jp, V, P_)
        jax.tree.map(np.testing.assert_array_equal, ti, ji)
        back = deinterleave_stage_params(ti, V, P_)
        jax.tree.map(np.testing.assert_array_equal, back, jp)
        for s in range(P_):
            sl = pipe_slab(jp, s, P_, V)
            got = params_from_jax(jp, tcfg, device="cpu", pp_rank=s,
                                  pp_size=P_, num_chunks=V)
            jax.tree.map(lambda a, b: np.testing.assert_array_equal(
                a.numpy(), b), got, sl)
            want = jax.tree.map(lambda a: a[:, s:s + 1], ji["blocks"]) \
                if V > 1 else jax.tree.map(
                    lambda a: a[s * 4 // P_:(s + 1) * 4 // P_], jp["blocks"])
            jax.tree.map(np.testing.assert_array_equal, sl["blocks"], want)
    with pytest.raises(ValueError, match="not divisible"):
        interleave_stage_params(jp, 3, 2)
    with pytest.raises(ValueError, match="not an interleaved layout"):
        deinterleave_stage_params(jp, 2, 2)
    tt = params_from_jax(jp, tcfg, device="cpu")
    for tp_axis in (None, "tensor"):
        js = jgpt_specs(cfg, tp_axis=tp_axis, pipe_axis="pipe")
        ts = gpt_param_specs(tt, pipe_axis="pipe", tp_axis=tp_axis)
        jflat = {jax.tree_util.keystr(p): tuple(s) for p, s in
                 jax.tree_util.tree_flatten_with_path(
                     js, is_leaf=lambda x: isinstance(x, P))[0]}
        tflat = {jax.tree_util.keystr(p): s for p, s in
                 jax.tree_util.tree_flatten_with_path(
                     ts, is_leaf=lambda x: isinstance(x, tuple))[0]}
        for k, s in tflat.items():  # JAX's specs may omit trailing Nones
            assert tuple(jflat[k]) == s[:len(jflat[k])] and not any(
                s[len(jflat[k]):]), (k, jflat[k], s)
        ji = jgpt.gpt_interleaved_param_specs(cfg, tp_axis=tp_axis)
        ti = gpt_interleaved_param_specs(interleave_stage_params(tt, 2, 2),
                                         tp_axis=tp_axis)
        assert tuple(ji["blocks"]["attn"]["wqkv"]) == \
            ti["blocks"]["attn"]["wqkv"][:len(ji["blocks"]["attn"]["wqkv"])]


def test_tick_counts_match_jax():
    from torchdistpackage_tpu_torch.parallel import pipeline_parallel as pp

    for m, p_, v in [(4, 2, 1), (16, 4, 1), (8, 2, 2), (6, 2, 4)]:
        assert pp.ring_slots(m, p_, v) == jpp.ring_slots(m, p_, v)
        assert pp.zb_schedule_ticks(m, p_) == jpp.zb_schedule_ticks(m, p_)


def test_one_stage_pipeline_and_guards(group1):
    """At P 1 every schedule is the serial step (loss and grads), the
    interleaved schedule refuses a stage_fn without ``(params, x, m, v)``
    (JAX tests/test_pipeline.py:1017, a ``*args`` one passes) and
    ``M % P``; the bus refuses a stage count that is not the pipe size,
    an edge contract a stage breaks, and integer and float edges on one
    bus (JAX :1199)."""
    from torchdistpackage_tpu_torch.models import (
        gpt_pipeline_1f1b,
        gpt_pipeline_zb,
        params_from_jax,
    )
    from torchdistpackage_tpu_torch.parallel import pipeline_parallel as pp

    jp = _np(jinit(jax.random.PRNGKey(0), _gcfg()))
    rs = np.random.RandomState(1)
    batch = {k: torch.from_numpy(rs.randint(0, 64, (2, MBS, S))).long()
             for k in ("tokens", "targets")}
    jl, jg = _gpt_serial(_gcfg(), 2)(jp, jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), batch))
    for fn in (gpt_pipeline_1f1b, gpt_pipeline_zb):
        params = W.trainable(params_from_jax(jp, W.gcfg(), device="cpu"))
        loss, grads = fn(params, batch, W.gcfg(), 2)
        np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
        _close(jax.tree.map(lambda t: t.numpy(), grads), _np(jg),
               **GRAD_TOL)
        assert all(p.grad is None for p in jax.tree.leaves(params))
    x = torch.zeros(2, MBS, 4)
    for bad in (lambda p, h: h, lambda p, h, m: h):
        with pytest.raises(ValueError, match=r"\(params, x, microbatch_idx"):
            pp.pipeline_1f1b({"w": torch.zeros(2)}, x, x,
                             lambda p, mb: mb, bad,
                             lambda p, y, t: y.mean(), 2, num_chunks=2)
    loss, _ = pp.pipeline_1f1b(
        {"w": torch.ones(2)}, x, x, lambda p, mb: mb,
        lambda *a: a[1] * a[0]["w"].sum(), lambda p, y, t: (y - t).mean(),
        2, num_chunks=2)
    assert np.isfinite(float(loss))
    with pytest.raises(ValueError, match="num_chunks must be"):
        pp.pipeline_1f1b({}, x, x, None, None, None, 2, num_chunks=0)
    f32 = torch.float32
    e3 = [pp.ShapeDtype((2, 4), f32)] * 4
    wf, sf, wl = pp.make_heterogeneous_stage([lambda p, x, m: x] * 3, e3)
    with pytest.raises(ValueError, match="one fn per stage"):
        pp.pipeline_1f1b({"w": torch.zeros(2)}, torch.zeros(2, 2, 4),
                         torch.zeros(2, 2, 4), wf(lambda p, mb: mb), sf,
                         wl(lambda p, y, t: y.mean()), 2,
                         stage_takes_mb=True)
    bad = [pp.ShapeDtype((2, 4), f32), pp.ShapeDtype((2, 5), f32)]
    wf, sf, wl = pp.make_heterogeneous_stage([lambda p, x, m: x], bad)
    with pytest.raises(ValueError, match="edge contract"):
        pp.pipeline_1f1b({"w": torch.zeros(2)}, torch.zeros(2, 2, 4),
                         torch.zeros(2, 2, 4), wf(lambda p, mb: mb), sf,
                         wl(lambda p, y, t: y.mean()), 2,
                         stage_takes_mb=True)
    with pytest.raises(ValueError, match="integer and float"):
        pp.make_heterogeneous_stage(
            [lambda p, x, m: x.float()],
            [pp.ShapeDtype((2, 4), torch.int32), pp.ShapeDtype((2, 4), f32)])
    bus = pp.ShapeDtype((6,), f32)
    v = torch.arange(4.0).reshape(2, 2)
    np.testing.assert_array_equal(
        pp.bus_unpack(pp.bus_pack(v, bus), pp.ShapeDtype((2, 2), f32)), v)
    np.testing.assert_array_equal(
        pp.bus_pack(v, bus).numpy(),
        np.asarray(jpp.bus_pack(jnp.arange(4.0).reshape(2, 2),
                                jax.ShapeDtypeStruct((6,), jnp.float32))))
    with pytest.raises(ValueError, match="exceeds the bus"):
        pp.bus_pack(torch.zeros(7), bus)


def test_data_parallel_one_stage_pipelined_loss(group1):
    """A pipelined loss runs each layer once a microbatch inside one
    backward: ``DataParallel``'s per-layer slice taps would reduce a
    slice before its grad is whole, so without ``pipe_specs`` the step
    raises; with them it buckets whole leaves and equals the
    accumulating step (one stage, data 1)."""
    from torchdistpackage_tpu_torch.parallel import DataParallel, adamw
    from torchdistpackage_tpu_torch.parallel.pipeline_parallel import (
        pipeline_loss,
        stacked_param_specs,
    )

    _, stacked = _blk_stack()
    x = torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), (M, MBS, S, JCFG.dim))))
    batch = {"x": x, "y": torch.flip(x, (0,))}

    def loss_fn(p, b):
        return pipeline_loss(p, b["x"], b["y"], W.blk_stage_fn, W.mse, M)

    runs = {}
    for mode in ("no_specs", "specs", "accum"):
        params = W.trainable(W.tensors(_np(stacked)))
        opt = adamw(1e-2)
        state = opt.init(params)
        dp = DataParallel()
        if mode == "accum":
            step = dp.make_train_step(
                lambda p, b: W.mse(W.blk_stage_fn(p, b["x"]), b["y"]), opt,
                grad_accum_iters=M)
            b = {k: v.reshape(M * MBS, S, JCFG.dim) for k, v in
                 batch.items()}
        else:
            step = dp.make_train_step(loss_fn, opt, pipe_specs=(
                stacked_param_specs(params) if mode == "specs" else None))
            b = batch
        if mode == "no_specs":
            with pytest.raises(RuntimeError, match="a layer ran twice"):
                step(params, state, b)
            continue
        params, state, loss, _ = step(params, state, b)
        runs[mode] = (float(loss), params)
    np.testing.assert_allclose(runs["specs"][0], runs["accum"][0],
                               rtol=LOSS_RTOL)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a.detach().numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-6),
        runs["specs"][1], runs["accum"][1])


def test_refusals_name_their_items():
    """The MoE pipeline (tests/test_torch_moe_train*.py) refuses a stage
    layout whose slabs differ in their dense / expert pattern, as JAX's
    ``moe_stage_pattern`` (gpt_moe.py:338) does: at 2 layers over 2
    stages slab 0 is dense, slab 1 an expert block."""
    from torchdistpackage_tpu_torch.models import GPTConfig, shard_gpt_params

    cfg = GPTConfig(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=16,
                    moe_experts=4)
    with pytest.raises(ValueError, match="slab-invariant"):
        shard_gpt_params({"blocks": [{}, {}]}, cfg, 0, 1, pp_rank=0,
                         pp_size=2)
