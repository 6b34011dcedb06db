"""The port's GPT under context parallelism against the JAX package's
serial goldens, on the CPU.

One launch of 4 ``tests/_torch_gpt_cp_worker.py`` processes (gloo,
JAX-free; what they run is in the worker's docstring) starts in a module
fixture before this process computes JAX's goldens, so the two overlap.
Every golden is JAX's serial model on the whole sequence — what JAX's own
CP tests hold their ``shard_map`` runs to (``tests/test_gpt.py:347``,
:476, :519, :573, :1148, ``tests/test_zero.py:338``,
``tests/test_pipeline.py:839``, ``tests/test_moe.py:971``): a context
rank's loss is the mean over its own tokens, so the ranks' mean loss and
mean grads (JAX's ``pmean``) must equal the serial ones.  Parameters are
numpy draws on ``jax.eval_shape`` of JAX's inits, carried over by
``params_from_jax``.

Tolerances (f32): loss ``rtol`` 2e-5, grads ``rtol`` 2e-4 / ``atol``
2e-5; trajectories over 2 AdamW steps: losses ``rtol`` 1e-4 / ``atol``
1e-5, parameters ``rtol`` 1e-3 / ``atol`` 1e-5 (JAX's own), the key
rows of ``bqkv`` (zero grad in exact arithmetic: AdamW moves them by lr
a step on rounding noise) within 2 lr a step.  The planted fault (zigzag
attention on contiguous chunks) must miss the loss by more than 1e-3.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import gpt_loss as jgpt_loss
from torchdistpackage_tpu.models import gpt_moe_loss as jgpt_moe_loss
from torchdistpackage_tpu.models import init_gpt_moe_params as jinit_moe
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.parallel.tensor_parallel import (
    TransformerConfig as JTransformerConfig,
)
from torchdistpackage_tpu.parallel.tensor_parallel import (
    init_block_params as jinit_block,
)
from torchdistpackage_tpu.parallel.tensor_parallel import (
    scan_blocks as jscan_blocks,
)

sys.path.insert(0, str(Path(__file__).parent))
import _torch_gpt_cp_worker as W  # noqa: E402
import _torch_ring_attention_worker as RW  # noqa: E402
from _torch_ep_worker import flatten  # noqa: E402

LOSS_RTOL, GRAD_TOL = 2e-5, dict(rtol=2e-4, atol=2e-5)
TRAJ_TOL, PARAM_TOL = dict(rtol=1e-4, atol=1e-5), dict(rtol=1e-3, atol=1e-5)
FAULT_GAP = 1e-3


def _jcfg(base=W.GPT, **kw):
    return JGPTConfig(**dict(base, **kw), dtype=jnp.float32)


def _random_tree(shapes, rs):
    """Numpy leaves of a JAX init's shapes: norm scales ``1 + 0.1 N``,
    everything else ``0.1 N`` (biases too, so every grad path carries a
    value)."""
    def leaf(path, sd):
        name = str(getattr(path[-1], "key", ""))
        v = 0.1 * rs.randn(*sd.shape)
        return (1.0 + v if name == "scale" else v).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _init(fn, cfg, rs):
    return _random_tree(jax.eval_shape(lambda: fn(jax.random.PRNGKey(0),
                                                  cfg)), rs)


def _inputs():
    rs = np.random.RandomState(0)
    out = {}
    trees = {"gpt": _init(jinit, _jcfg(), rs),
             "rope": _init(jinit, _jcfg(pos="rope"), rs),
             "moe": _init(jinit_moe, _jcfg(W.MOE), rs)}
    for name, tree in trees.items():
        out.update({f"{name}/params/{k}": v
                    for k, v in flatten(tree).items()})
    blk = JTransformerConfig(**W.BLK)
    for i in range(W.BLK["nlayers"]):
        layer = _random_tree(jax.eval_shape(
            lambda: jinit_block(jax.random.PRNGKey(0), blk)), rs)
        out.update({f"blk/layers/{i}/{k}": v
                    for k, v in flatten(layer).items()})
    for k in ("x", "y"):
        out[f"blk/{k}"] = rs.randn(W.M, W.MBS, W.S, W.BLK["dim"]).astype(
            np.float32)

    def ids(*shape):
        return rs.randint(0, W.GPT["vocab_size"], shape).astype(np.int32)
    for k in ("tokens", "targets"):
        out[f"batch/{k}"] = ids(W.B, W.S)
        for i in range(W.STEPS):
            out[f"train{i}/{k}"] = ids(W.B, W.S)
            out[f"pipe{i}/{k}"] = ids(W.M, W.MBS, W.S)
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    inp = _inputs()
    tmp = tmp_path_factory.mktemp("gpt_cp")
    script = str(Path(W.__file__).resolve())
    return inp, (RW.start(script, inp, tmp), tmp), {}


@pytest.fixture(scope="module")
def ranks(launched, gold):
    _, procs, done = launched
    if "r" not in done:
        done["r"] = RW.results(*procs)
    return done["r"]


def _sub(inp, prefix):
    from _torch_ep_worker import unflatten

    return jax.tree.map(jnp.asarray, unflatten(
        {k[len(prefix):]: inp[k] for k in inp if k.startswith(prefix)}))


@functools.lru_cache(maxsize=None)
def _vag(kind):
    if kind == "moe":
        cfg = _jcfg(W.MOE)
        return jax.jit(jax.value_and_grad(
            lambda p, b: jgpt_moe_loss(p, b, cfg)))
    cfg = _jcfg(pos="rope") if kind == "rope" else _jcfg()
    return jax.jit(jax.value_and_grad(lambda p, b: jgpt_loss(p, b, cfg)))


def _np(tree):
    return {k: np.asarray(v) for k, v in flatten(jax.tree.map(
        np.asarray, tree)).items()}


def _trajectory(vag, params, batches):
    opt = optax.adamw(W.LR)
    update = jax.jit(lambda g, s, p: opt.update(g, s, p))
    state, losses = opt.init(params), []
    for b in batches:
        loss, g = vag(params, b)
        u, state = update(g, state, params)
        params = optax.apply_updates(params, u)
        losses.append(float(loss))
    return losses, _np(params)


def _pipe_vag(params, b):
    """The mean over the M microbatches of the serial loss, its grads."""
    parts = [_vag("gpt")(params, {k: v[m] for k, v in b.items()})
             for m in range(W.M)]
    return (np.mean([float(l) for l, _ in parts]),
            jax.tree.map(lambda *g: sum(g) / len(g), *[g for _, g in parts]))


def _bss_gold(inp):
    blk = JTransformerConfig(**W.BLK)
    layers = [_sub(inp, f"blk/layers/{i}/") for i in range(W.BLK["nlayers"])]
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *layers)

    def loss(p):
        return jnp.mean(jnp.stack([jnp.mean(
            (jscan_blocks(p, jnp.asarray(inp["blk/x"][m]), blk)
             - jnp.asarray(inp["blk/y"][m])) ** 2) for m in range(W.M)]))
    value, grads = jax.jit(jax.value_and_grad(loss))(stacked)
    return float(value), _np(grads)


@pytest.fixture(scope="module")
def gold(launched):
    inp = launched[0]
    gpt, rope, moe = (_sub(inp, f"{n}/params/") for n in ("gpt", "rope",
                                                          "moe"))
    batch = _sub(inp, "batch/")
    out = {}
    for kind, params in (("gpt", gpt), ("rope", rope)):
        loss, grads = _vag(kind)(params, batch)
        out[kind] = (float(loss), _np(grads))
    loss, grads = _vag("moe")(moe, _sub(inp, "train0/"))
    out["moe"] = (float(loss), _np(grads))
    out["train"] = _trajectory(_vag("gpt"), gpt, [
        _sub(inp, f"train{i}/") for i in range(W.STEPS)])
    out["pipe"] = _trajectory(_pipe_vag, gpt, [
        _sub(inp, f"pipe{i}/") for i in range(W.STEPS)])
    out["bss"] = _bss_gold(inp)
    return out


def _mean_over(ranks, prefix, which=None):
    which = range(len(ranks)) if which is None else which
    keys = [k for k in ranks[0] if k.startswith(prefix)]
    return {k[len(prefix):]: np.mean([ranks[r][k] for r in which], axis=0)
            for k in keys}


def _check_grads(got, want, what):
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **GRAD_TOL,
                                   err_msg=f"{what}: {k}")


def _check_params(got, want, what, steps=W.STEPS):
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k in want:
        g, w = got[k], want[k]
        if k.endswith("bqkv"):  # the key rows: AdamW on rounding noise
            np.testing.assert_allclose(g[..., 1, :], w[..., 1, :], rtol=0,
                                       atol=2 * W.LR * steps,
                                       err_msg=f"{what}: {k} key rows")
            g, w = g[..., ::2, :], w[..., ::2, :]
        np.testing.assert_allclose(g, w, **PARAM_TOL, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("name", [n for n in W.LOSS_CASES
                                  if not n.startswith("fault")])
def test_gpt_cp_loss_and_grads_match_serial(ranks, gold, name):
    loss, grads = gold["rope" if name.startswith("rope") else "gpt"]
    got = _mean_over(ranks, f"{name}/loss")[""]
    np.testing.assert_allclose(got, loss, rtol=LOSS_RTOL, err_msg=name)
    _check_grads(_mean_over(ranks, f"{name}/grads/"), grads, name)


def test_planted_fault_zigzag_on_contiguous_chunks_misses(ranks, gold):
    got = _mean_over(ranks, "fault_zigzag_contiguous/loss")[""]
    assert abs(got - gold["gpt"][0]) > FAULT_GAP * abs(gold["gpt"][0])


@pytest.mark.parametrize("tag", ["dpcp", "zerocp"])
def test_gpt_cp_training_matches_serial(ranks, gold, tag):
    """DP x CP (``DataParallel(axis=('data', 'context'))``) and ZeRO x CP
    (``grad_reduce_axes=('data', 'context')``) track the serial model
    over 2 AdamW steps; every rank holds the same parameters."""
    losses, params = gold["train"]
    for r in range(W.WORLD):
        np.testing.assert_allclose(ranks[r][f"{tag}/losses"], losses,
                                   **TRAJ_TOL, err_msg=f"{tag} rank {r}")
        _check_params({k[len(tag) + 8:]: v for k, v in ranks[r].items()
                       if k.startswith(f"{tag}/params/")}, params,
                      f"{tag} rank {r}")


def test_zero_refuses_context_as_model_axis_for_gpt(ranks):
    """ZeRO with ``context`` left out of ``grad_reduce_axes`` treats it as
    a model axis, which holds only for a loss that is the same on every
    rank of the context group; a GPT loss under ring attention is each
    rank's mean over its own tokens, so the first step raises on every
    rank, naming the reduced axes to pass.  A loss that is the same
    across the group passes the check."""
    for r in range(W.WORLD):
        msg = str(ranks[r]["zero_model_cp/raised"])
        assert "differs across the context group" in msg, (r, msg)
        assert "grad_reduce_axes=('data', 'context')" in msg, (r, msg)
        assert int(ranks[r]["zero_model_cp/same_loss_ok"]) == 1


def test_gpt_moe_cp_matches_serial(ranks, gold):
    """GPT-MoE with ring attention over context 2 (x data 2): each rank
    routes its own tokens (capacity 4.0, no drops, aux 0), so the ranks'
    mean loss and grads are the serial model's."""
    loss, grads = gold["moe"]
    got = _mean_over(ranks, "moecp/loss")[""]
    np.testing.assert_allclose(got, loss, rtol=LOSS_RTOL)
    _check_grads(_mean_over(ranks, "moecp/grads/"), grads, "moecp")


def _stage_ranks(ranks, s):
    return [r for r in range(W.WORLD) if int(ranks[r]["stage"]) == s]


def test_gpt_1f1b_with_ring_cp_matches_serial(ranks, gold):
    """1F1B over pipe 2 x context 2: stage 0 embeds each rank's chunk at
    its global positions, every stage's blocks run the ring; 2 AdamW
    steps track the serial model (the stages' slabs joined)."""
    losses, params = gold["pipe"]
    joined = {}
    for r in _stage_ranks(ranks, 0):
        np.testing.assert_allclose(ranks[r]["ppcp/losses"], losses,
                                   **TRAJ_TOL)
        partner = _stage_ranks(ranks, 1)[_stage_ranks(ranks, 0).index(r)]
        for k, v in ranks[r].items():
            if not k.startswith("ppcp/params/"):
                continue
            name = k[len("ppcp/params/"):]
            joined[name] = (np.concatenate([v, ranks[partner][k]])
                            if name.startswith("blocks/") else v)
        _check_params(joined, params, f"ppcp rank {r}")


def test_balanced_stage_stack_with_ring_cp(ranks, gold):
    """Skewed stages (bounds (0, 1), (1, 4), each slab padded to 3 rows)
    with ring blocks: every real row's grad (the context ranks' mean) is
    the serial layer's, every padding row's exactly zero; no rank
    skipped a ring its context peer entered (the run finished)."""
    loss, grads = gold["bss"]
    bounds = [tuple(b) for b in ranks[0]["bss/bounds"]]
    assert bounds == [(0, 1), (1, 4)]
    for s, (a, b) in enumerate(bounds):
        which = _stage_ranks(ranks, s)
        np.testing.assert_allclose(
            np.mean([ranks[r]["bss/loss"] for r in which]), loss,
            rtol=LOSS_RTOL)
        got = _mean_over(ranks, "bss/grads/", which)
        for k, want in grads.items():
            g = got[k]
            np.testing.assert_allclose(g[:b - a], want[a:b], **GRAD_TOL,
                                       err_msg=f"stage {s} {k}")
            assert not np.any(g[b - a:]), f"padding grad at stage {s} {k}"
