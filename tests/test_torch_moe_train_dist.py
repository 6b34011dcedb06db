"""The port's MoE training over process groups against the JAX package's
serial goldens, on the CPU.

One launch of 4 ``tests/_torch_moe_train_worker.py`` processes (gloo over
a ``file://`` store, JAX-free, a 240 s limit of their own: a
mismatched collective order hangs rather than fails) starts in a module
fixture before this process computes JAX's goldens, so the two overlap.
What the ranks run is listed in the worker's docstring; the goldens are
JAX's:

- the MoE layer under EP x MoE-DP (``tests/test_moe.py:285``) and under
  ZeRO over ``moe_dp`` (``tests/test_zero.py:407``): JAX's serial
  ``moe_forward`` on the whole batch, trained by ``optax.adamw``;
- the expert-choice router under EP (``tests/test_moe.py:825``): JAX's
  serial layer on each rank's rows;
- the GPT-MoE under TP + SP x EP (``tests/test_moe.py:354``): JAX's
  ``gpt_moe_loss`` on the whole batch, trained by ``optax.adamw``;
- the MoE 1F1B, classic and interleaved, ZeRO x EP x 1F1B and TP x PP
  (``tests/test_moe.py:485``, ``:675``, ``:1028``, ``tests/test_zero.py:512``):
  the per-(microbatch, data-shard) chunk mean of JAX's ``gpt_moe_loss``
  (each rank routes, balances and sizes its capacity on its own rows),
  aux on.

Tolerances: a step's loss ``rtol`` 1e-5 and grads ``rtol`` / ``atol``
5e-5 (the pipeline tests'); trajectories JAX's (losses ``rtol`` 1e-4 /
``atol`` 1e-5, parameters ``rtol`` 1e-3 / ``atol`` 1e-5).  The planted
faults' step-1 grads must miss the golden by more than 1e-2 of a leaf's
largest value.
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
from torchdistpackage_tpu.models import gpt_moe_loss as jgpt_moe_loss
from torchdistpackage_tpu.models import init_gpt_moe_params as jinit
from torchdistpackage_tpu.models import stack_moe_stage_params
from torchdistpackage_tpu.parallel import moe as jmoe
from torchdistpackage_tpu_torch.models import (
    GPTConfig,
    moe_stage_params,
    shard_gpt_params,
    shard_moe_params,
)

sys.path.insert(0, str(Path(__file__).parent))
import _torch_moe_train_worker as W  # noqa: E402

M, MBS, S, LR = W.M, W.MBS, W.S, W.LR
STEP_LOSS, GRAD_TOL = 1e-5, dict(rtol=5e-5, atol=5e-5)
LOSS_TOL, PARAM_TOL = dict(rtol=1e-4, atol=1e-5), dict(rtol=1e-3, atol=1e-5)
FAULT_GAP = 1e-2
JLAYER = jmoe.MoEConfig(**W.LAYER)
JEC = jmoe.MoEConfig(**dict(W.LAYER, capacity_factor=W.EC_CF),
                     router="expert_choice", dispatch="dense")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix):
    return {prefix + k: v for k, v in W.flatten(_np(tree)).items()}


def _jcfg(base):
    return JGPTConfig(**base, dtype=jnp.float32, attn_impl="naive")


def _tcfg(base):
    return GPTConfig(**base)


def _random_tree(shapes, rs):
    """Numpy leaves of the shapes of a JAX init (``jax.eval_shape``):
    norm scales ``1 + 0.1 N``, everything else ``0.1 N`` (biases too, so
    that every grad path carries a value)."""
    def leaf(path, sd):
        name = str(getattr(path[-1], "key", ""))
        v = 0.1 * rs.randn(*sd.shape)
        return (1.0 + v if name == "scale" else v).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _gpt_init(base, rs):
    c = _jcfg(base)
    return _random_tree(jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0),
                                                     c)), rs)


def _inputs():
    rs = np.random.RandomState(0)
    out = _flat(_random_tree(jax.eval_shape(lambda: jmoe.init_moe_params(
        jax.random.PRNGKey(0), JLAYER)), rs), "layer/params/")
    for i in range(W.ZERO_STEPS):
        for k in "xy":
            out[f"layer/batch{i}/{k}"] = rs.randn(8, 8, JLAYER.dim).astype(
                np.float32)
    out.update(_flat(_gpt_init(W.GPT2, rs), "gpt2/params/"))
    out.update(_flat(_gpt_init(W.GPT4, rs), "gpt4/params/"))
    p8 = _gpt_init(W.GPT8, rs)
    out.update(_flat(p8, "gpt8/params/"))
    out.update(_flat(stack_moe_stage_params(p8, _jcfg(W.GPT8), 2,
                                            num_chunks=2), "gpt8/stacked/"))
    for k in ("tokens", "targets"):
        for i in range(W.STEPS):
            out[f"gpt2/batch{i}/{k}"] = rs.randint(0, 64, (8, S)).astype(
                np.int32)
            out[f"gpt4/batch{i}/{k}"] = rs.randint(
                0, 64, (M, 2 * MBS, S)).astype(np.int32)
        out[f"gpt8/batch/{k}"] = rs.randint(0, 64, (M, 2 * MBS, S)).astype(
            np.int32)
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    inp = _inputs()
    tmp = tmp_path_factory.mktemp("moe_train")
    return inp, (W.start(inp, tmp), tmp), {}


@pytest.fixture(scope="module")
def ranks(launched, gold):
    inp, procs, done = launched
    if "r" not in done:
        done["r"] = W.results(*procs)
    return done["r"]


def _sub(inp, prefix):
    return jax.tree.map(jnp.asarray, W.unflatten(
        {k[len(prefix):]: inp[k] for k in inp if k.startswith(prefix)}))


def _mean(trees):
    return jax.tree.map(lambda *a: sum(a) / len(a), *trees)


def _trajectory(vag, params, batches):
    """``optax.adamw(LR)`` steps on ``vag(params, batch) -> (loss,
    grads)``: the losses, the grads and the parameters after each."""
    opt = optax.adamw(LR)
    update = jax.jit(lambda g, s, p: opt.update(g, s, p))
    state, losses, grads, after = opt.init(params), [], [], []
    for b in batches:
        loss, g = vag(params, b)
        u, state = update(g, state, params)
        params = optax.apply_updates(params, u)
        losses.append(float(loss))
        grads.append(_np(g))
        after.append(_np(params))
    return losses, grads, after


@functools.lru_cache(maxsize=None)
def _chunk_vag(cfg):
    return jax.jit(jax.value_and_grad(lambda p, b: jgpt_moe_loss(p, b, cfg)))


def _chunked(cfg, nshards, rows=MBS):
    """The per-(microbatch, data-shard) chunk mean of JAX's
    ``gpt_moe_loss`` and its grads, one jitted chunk (compiled once a
    config) at a time."""
    one = _chunk_vag(cfg)

    def vag(p, b):
        parts = [one(p, {k: b[k][m, rows * d:rows * (d + 1)]
                         for k in ("tokens", "targets")})
                 for m in range(M) for d in range(nshards)]
        return (float(np.mean([float(l) for l, _ in parts])),
                _mean([g for _, g in parts]))
    return vag


@pytest.fixture(scope="module")
def gold(launched):
    """JAX's goldens (computed while the workers run)."""
    inp = launched[0]
    jb = {k: jnp.asarray(v) for k, v in inp.items()}
    out = {}
    lp = _sub(inp, "layer/params/")

    def layer_loss(p, b):
        y, _ = jmoe.moe_forward(p, b["x"], JLAYER)
        return jnp.mean((y - b["y"]) ** 2)
    out["layer"] = _trajectory(jax.jit(jax.value_and_grad(layer_loss)), lp, [
        {k: jb[f"layer/batch{i}/{k}"] for k in "xy"}
        for i in range(W.ZERO_STEPS)])

    ec = jax.jit(jax.value_and_grad(
        lambda p, x: jnp.mean(jmoe.moe_forward(p, x, JEC)[0] ** 2)))
    ecy = jax.jit(lambda p, x: jmoe.moe_forward(p, x, JEC)[0])
    x0 = jb["layer/batch0/x"]
    chunks = [x0[2 * d:2 * d + 2] for d in range(W.WORLD)]
    out["ec"] = ([np.asarray(ecy(lp, x)) for x in chunks],
                 _np(_mean([ec(lp, x)[1] for x in chunks])))

    c2, c4, c8 = (_jcfg(b) for b in (W.GPT2, W.GPT4, W.GPT8))
    out["gpt2"] = _trajectory(
        jax.jit(jax.value_and_grad(lambda p, b: jgpt_moe_loss(p, b, c2))),
        _sub(inp, "gpt2/params/"),
        [{k: jb[f"gpt2/batch{i}/{k}"] for k in ("tokens", "targets")}
         for i in range(W.STEPS)])
    p4 = _sub(inp, "gpt4/params/")
    out["gpt4"] = _trajectory(
        _chunked(c4, 2), p4,
        [{k: jb[f"gpt4/batch{i}/{k}"] for k in ("tokens", "targets")}
         for i in range(W.STEPS)])
    l8, g8 = _chunked(c8, 2)(_sub(inp, "gpt8/params/"), {
        k: jb[f"gpt8/batch/{k}"] for k in ("tokens", "targets")})
    out["gpt8"] = (l8, _np(g8))
    l1, g1 = _chunked(c4, 1)(p4, {k: jb[f"gpt4/batch0/{k}"]
                                  for k in ("tokens", "targets")})
    out["tppp"] = (l1, _np(g1))
    return out


# ------------------------------------------------------------- helpers


def _got(r, prefix):
    return W.unflatten({k[len(prefix):]: v for k, v in r.items()
                        if k.startswith(prefix)})


def _close(got, want, what, trajectory=False, **tol):
    """Every leaf of ``got`` against ``want``.  ``trajectory``: the key
    rows of the QKV bias (``bqkv[1]``) are left out — their grad is 0 in
    exact arithmetic (softmax ignores a shift of every key's score), so
    AdamW turns each side's rounding noise into steps of up to ``lr``."""
    gf, wf = W.flatten(got), W.flatten(want)
    assert gf.keys() == wf.keys(), (what, sorted(gf), sorted(wf))
    for k in wf:
        g, w = gf[k], wf[k]
        if trajectory and k.endswith("attn/bqkv"):
            g, w = g[[0, 2]], w[[0, 2]]
        np.testing.assert_allclose(g, w, err_msg=f"{what}: {k}", **tol)


def _ep_share(tree, er):
    """The golden's EP rank ``er`` share of a layer tree (experts cut
    along E, two ranks)."""
    e = tree["experts"]
    n = e["w2"].shape[0] // 2
    return dict(tree, experts={k: v[er * n:(er + 1) * n]
                               for k, v in e.items()})


def _stage(tree, base, er=0, ep=1, s=0, P=2, V=1, tr=0, tp=1):
    """The golden's share of rank (expert ``er``, stage ``s``, tensor
    ``tr``), cut by the port's own placement functions (numpy views)."""
    cfg = _tcfg(base)
    tree = shard_moe_params(tree, cfg, er, ep) if ep > 1 else tree
    if tp > 1:
        return shard_gpt_params(tree, cfg, tr, tp, pp_rank=s, pp_size=P,
                                num_chunks=V)
    return moe_stage_params(tree, cfg, s, P, V)


# ------------------------------------------------------------- the layer


@pytest.mark.parametrize("arm", ["dp", "dp_cuda"])
def test_moedp_training_matches_serial(ranks, gold, arm):
    """EP 2 x MoE-DP 2: ``DataParallel`` on the moe view with the expert
    override, 2 AdamW steps against the serial trajectory: losses, the
    step-1 reduced grads (the router whole, each rank's experts its EP
    share: the exchange's backward and the full-group division cancel the
    overcount) and the parameters."""
    losses, grads, after = gold["layer"]
    for rank, r in enumerate(ranks):
        er = rank % 2
        np.testing.assert_allclose(r[f"{arm}/losses"], losses[:W.STEPS],
                                   **LOSS_TOL)
        _close(_got(r, f"{arm}/grads1/"), _ep_share(grads[0], er),
               f"{arm} rank {rank} grads", **GRAD_TOL)
        _close(_got(r, f"{arm}/params/"),
               _ep_share(after[W.STEPS - 1], er),
               f"{arm} rank {rank} params", trajectory=True, **PARAM_TOL)


@pytest.mark.parametrize("fault", ["fault_exchange", "fault_ep_reduced"])
def test_planted_faults_miss_the_golden(ranks, gold, fault):
    """The planted faults must fail the gate the correct arms pass: the
    exchange's backward left out (each rank's cotangent kept, not sent
    back to the rank whose tokens it is), and the expert grads reduced
    over ``moe_ep`` as well as ``moe_dp`` (summing different experts)."""
    want = gold["layer"][1][0]
    for rank, r in enumerate(ranks):
        got = W.flatten(_got(r, f"{fault}/grads1/"))
        wf = W.flatten(_ep_share(want, rank % 2))
        gaps = {k: float(np.abs(got[k] - wf[k]).max()
                         / np.abs(wf[k]).max()) for k in wf}
        assert gaps["experts/w1"] > FAULT_GAP, (fault, rank, gaps)


def test_zero_with_moe_expert_overrides(ranks, gold):
    """``ZeroOptimizer(shard_axis='moe_dp', grad_reduce_axes=('moe_dp',
    'moe_ep'), grad_reduce_overrides=moe_grad_reduce_overrides())``
    beside the EP-split experts, K7's plain version under autograd, 3
    steps against the serial trajectory; each expert master is the
    rank's ``moe_dp`` shard of its EP share."""
    losses, _, after = gold["layer"]
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["zero/losses"], losses, **LOSS_TOL)
        _close(_got(r, "zero/params/"), _ep_share(after[-1], rank % 2),
               f"zero rank {rank}", trajectory=True, **PARAM_TOL)
        assert tuple(r["zero/master_w1_shape"]) == (1, 16, 32)


@pytest.mark.parametrize("disp", ["dense", "sorted"])
def test_expert_choice_ep_matches_serial(ranks, gold, disp):
    """The expert-choice router under EP 2 (C 4 of 16 tokens a rank):
    each rank's output equals JAX's serial layer on its rows (every
    expert picks over the rank's own tokens); aux 0; the reduced grads of
    the mean loss equal JAX's."""
    ys, grads = gold["ec"]
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r[f"ec_{disp}/y"], ys[rank], rtol=1e-5,
                                   atol=1e-6)
        assert float(r[f"ec_{disp}/aux"]) == 0.0
        _close(_got(r, f"ec_{disp}/grads/"), _ep_share(grads, rank % 2),
               f"ec {disp} rank {rank}", **GRAD_TOL)


# ------------------------------------------------------------ the models


def test_gpt_moe_training_matches_serial(ranks, gold):
    """The GPT-MoE under TP 2 with SP beside EP 2 (``DataParallel`` on the
    moe view, ``make_train_step(param_specs=, sp=True)``, K7's plain
    version): 2 AdamW steps against JAX's serial trajectory, every leaf
    of each rank's share; every leaf bucketed (``last_stats``' bytes are
    the whole tree's)."""
    losses, _, after = gold["gpt2"]
    for rank, r in enumerate(ranks):
        d, tr = divmod(rank, 2)
        np.testing.assert_allclose(r["tpsp/losses"], losses, **LOSS_TOL)
        _close(_got(r, "tpsp/params/"),
               _stage(after[-1], W.GPT2, er=d, ep=2, P=1, tr=tr, tp=2),
               f"tpsp rank {rank}", trajectory=True, **PARAM_TOL)
        assert r["tpsp/stats"][0] == r["tpsp/stats"][1]


@pytest.mark.parametrize("tag", ["1f1b", "1f1b_flash", "interleaved"])
def test_gpt_moe_1f1b_matches_serial_microbatched(ranks, gold, tag):
    """The MoE 1F1B over pipe 2 beside EP 2 (``DataParallel``'s
    ``value_and_grad_fn``), aux on: the loss and each stage's reduced
    grads against the per-(microbatch, data-shard) chunk golden — the
    classic schedule (remat True, ``'sorted'``; remat 'flash' with flash
    attention and ``'cuda'``) and the interleaved one on the 8-layer
    model (V 2, converted from JAX's ``[V, P, ...]`` layout)."""
    if tag == "interleaved":
        loss, grads, base, V = *gold["gpt8"], W.GPT8, 2
    else:
        loss, grads, base, V = gold["gpt4"][0][0], gold["gpt4"][1][0], \
            W.GPT4, 1
    for rank, r in enumerate(ranks):
        s, d = divmod(rank, 2)
        np.testing.assert_allclose(float(r[f"{tag}/loss"]), loss,
                                   rtol=STEP_LOSS)
        _close(_got(r, f"{tag}/grads/"),
               _stage(grads, base, er=d, ep=2, s=s, V=V),
               f"{tag} rank {rank}", **GRAD_TOL)


def test_zero_moe_1f1b_full_stack(ranks, gold):
    """ZeRO (``moe_dp``) x EP 2 x 1F1B (pipe 2), aux on: the step-1 shard
    grads (``moe_dp`` 1: whole) of every leaf against the chunk golden's,
    and 2 steps' losses and the parameters JAX's test holds (each stage's
    expert ``w1`` and router — the aux grad's path — and the head) against
    its trajectory.  Not every parameter: an element whose grad nearly
    cancels moves by AdamW's amplified rounding (one of 4096 ``w2``
    elements by 1.5e-4)."""
    losses, grads, after = gold["gpt4"]
    for rank, r in enumerate(ranks):
        s, d = divmod(rank, 2)
        _close(_got(r, "zero_1f1b/grads1/"),
               _stage(grads[0], W.GPT4, er=d, ep=2, s=s),
               f"zero x 1f1b rank {rank} grads", **GRAD_TOL)
        np.testing.assert_allclose(r["zero_1f1b/losses"], losses,
                                   **LOSS_TOL)
        got = W.flatten(_got(r, "zero_1f1b/params/"))
        want = W.flatten(_stage(after[-1], W.GPT4, er=d, ep=2, s=s))
        for k in ("blocks/1/moe/experts/w1", "blocks/1/moe/router/w",
                  "head"):
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **PARAM_TOL)


def test_gpt_moe_1f1b_with_tp_nosp_sharded_transfers(ranks, gold):
    """The MoE 1F1B with ``tp_group`` (pipe 2 x tensor 2, no SP): the
    inter-stage state sliced 1/tp, the experts replicated over the tensor
    group; loss and each rank's grads against the chunk golden."""
    loss, grads = gold["tppp"]
    for rank, r in enumerate(ranks):
        s, tr = divmod(rank, 2)
        np.testing.assert_allclose(float(r["tppp/loss"]), loss,
                                   rtol=STEP_LOSS)
        _close(_got(r, "tppp/grads/"),
               _stage(grads, W.GPT4, s=s, tr=tr, tp=2),
               f"tp x pp rank {rank}", **GRAD_TOL)
