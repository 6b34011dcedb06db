"""The port's ViT and ViT-MoE (``models/vit.py``, ``models/vit_moe.py``)
against the JAX package's, on the CPU — every case of JAX
``tests/test_vit.py``.

In this process: ``patchify`` (JAX :50), the serial model's logits, loss
and grads (:60) with plain and flash attention, the init trees, and
ViT-MoE with both routers (:344), a step's loss and grads and a 3-step
AdamW trajectory.  One launch of 4 ``tests/_torch_vit_worker.py``
processes (gloo, JAX-free; its docstring lists the layouts) starts in a
module fixture first, and runs the rest: ring / Ulysses CP at cp 4 and
ring at cp 2 (:142), TP + SP (:69), DP (:103), 1F1B x TP (:179), 1F1B x
CP (:258) and ViT-MoE under EP (:397).  Every golden is JAX's serial
model (the 1F1B ones the mean over the microbatches, the EP one the mean
over each rank's rows: the expert-choice router ranks the rows it
sees); parameters are numpy draws on ``jax.eval_shape`` of JAX's inits.

Under CP every leaf's grad — the class head's, after the pool, and
every leaf's before it — must equal the serial grad on every rank of the
context group (the port's design: ``models/vit.py``'s module note).

Tolerances (f32): loss ``rtol`` 2e-5, logits and grads ``rtol`` 2e-4 /
``atol`` 2e-5; trajectories over 2 steps (AdamW, or SGD where JAX's
test takes it): losses ``rtol`` 1e-4 / ``atol`` 1e-5, parameters
``rtol`` 1e-3 / ``atol`` 1e-5 (JAX's own), the key rows of ``bqkv``
within 2 lr a step.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchdistpackage_tpu.models import ViTConfig as JViTConfig
from torchdistpackage_tpu.models import init_vit_moe_params as jinit_moe
from torchdistpackage_tpu.models import init_vit_params as jinit
from torchdistpackage_tpu.models import patchify as jpatchify
from torchdistpackage_tpu.models import vit_forward as jvit_forward
from torchdistpackage_tpu.models import vit_loss as jvit_loss
from torchdistpackage_tpu.models import vit_moe_forward as jvit_moe_forward
from torchdistpackage_tpu.models import vit_moe_loss as jvit_moe_loss
from torchdistpackage_tpu_torch.models import (
    ViTConfig,
    init_vit_moe_params,
    init_vit_params,
    patchify,
    vit_forward,
    vit_loss,
    vit_moe_forward,
    vit_moe_loss,
    vit_params_from_jax,
)
from torchdistpackage_tpu_torch.parallel import adamw

sys.path.insert(0, str(Path(__file__).parent))
import _torch_ring_attention_worker as RW  # noqa: E402
import _torch_vit_worker as W  # noqa: E402
from _torch_ep_worker import flatten, unflatten  # noqa: E402
from test_torch_gpt_cp import _check_params, _random_tree  # noqa: E402

LOSS_RTOL, GRAD_TOL = 2e-5, dict(rtol=2e-4, atol=2e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
#: JAX tests/test_vit.py:344's ViT-MoE (both routers, serial)
VIT_MOE = dict(W.VIT, dim=32, nlayers=4, moe_experts=4, moe_every=2,
               moe_capacity_factor=2.0)


def _jcfg(base=W.VIT, **kw):
    return JViTConfig(**dict(base, **kw), dtype=jnp.float32)


def _init(fn, cfg, rs):
    return _random_tree(jax.eval_shape(lambda: fn(jax.random.PRNGKey(0),
                                                  cfg)), rs)


def _flat(tree, prefix):
    return {prefix + k: v for k, v in flatten(jax.tree.map(
        np.asarray, tree)).items()}


def _inputs():
    rs = np.random.RandomState(0)
    out = _flat(_init(jinit, _jcfg(), rs), "vit/params/")
    out.update(_flat(_init(jinit_moe, _jcfg(W.VIT_MOE_EP), rs),
                     "moe/params/"))
    out.update(_flat(_init(jinit_moe, _jcfg(VIT_MOE), rs),
                     "moe4/params/"))

    def batch(prefix, *lead):
        out[f"{prefix}/images"] = rs.randn(*lead, 32, 32, 3).astype(
            np.float32)
        out[f"{prefix}/labels"] = rs.randint(0, 16, lead).astype(np.int32)
    batch("batch", W.B)
    for i in range(W.STEPS):
        batch(f"train{i}", W.B)
        batch(f"pipe{i}", W.M, W.MBS)
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    inp = _inputs()
    tmp = tmp_path_factory.mktemp("vit")
    script = str(Path(W.__file__).resolve())
    return inp, (RW.start(script, inp, tmp), tmp), {}


@pytest.fixture(scope="module")
def inp(launched):
    return launched[0]


@pytest.fixture(scope="module")
def ranks(launched, gold):
    _, procs, done = launched
    if "r" not in done:
        done["r"] = RW.results(*procs)
    return done["r"]


def _sub(inp, prefix):
    return jax.tree.map(jnp.asarray, unflatten(
        {k[len(prefix):]: inp[k] for k in inp if k.startswith(prefix)}))


def _np(tree):
    return {k: np.asarray(v) for k, v in flatten(jax.tree.map(
        np.asarray, tree)).items()}


@functools.lru_cache(maxsize=None)
def _vag(kind):
    if kind == "ep":
        cfg = _jcfg(W.VIT_MOE_EP)
        return jax.jit(jax.value_and_grad(
            lambda p, b: jvit_moe_loss(p, b, cfg)))
    cfg = _jcfg()
    return jax.jit(jax.value_and_grad(lambda p, b: jvit_loss(p, b, cfg)))


def _trajectory(vag, params, batches, opt=None):
    opt = optax.adamw(W.LR) if opt is None else opt
    update = jax.jit(lambda g, s, p: opt.update(g, s, p))
    state, losses = opt.init(params), []
    for b in batches:
        loss, g = vag(params, b)
        u, state = update(g, state, params)
        params = optax.apply_updates(params, u)
        losses.append(float(loss))
    return losses, _np(params)


def _mean_vag(kind, split):
    """The mean loss over ``split(batch)``'s parts and its grads."""
    def vag(params, b):
        parts = [_vag(kind)(params, part) for part in split(b)]
        return (np.mean([float(l) for l, _ in parts]),
                jax.tree.map(lambda *g: sum(g) / len(g),
                             *[g for _, g in parts]))
    return vag


@pytest.fixture(scope="module")
def gold(launched):
    inp = launched[0]
    params, moe = _sub(inp, "vit/params/"), _sub(inp, "moe/params/")
    batch = _sub(inp, "batch/")
    loss, grads = _vag("vit")(params, batch)
    trains = [_sub(inp, f"train{i}/") for i in range(W.STEPS)]
    pipes = [_sub(inp, f"pipe{i}/") for i in range(W.STEPS)]
    n = W.B // W.WORLD
    return {
        "serial": (float(loss), _np(grads)),
        "logits": np.asarray(jvit_forward(params, batch["images"], _jcfg())),
        "dp": _trajectory(_vag("vit"), params, trains),
        "pipe": _trajectory(_mean_vag("vit", lambda b: [
            {k: v[m] for k, v in b.items()} for m in range(W.M)]),
            params, pipes, optax.sgd(W.SGD_LR)),
        "ep": _trajectory(_mean_vag("ep", lambda b: [
            {k: v[d * n:(d + 1) * n] for k, v in b.items()}
            for d in range(W.WORLD)]), moe, trains),
    }


# ------------------------------------------------------- in this process


def _trainable(tree):
    for t in jax.tree.leaves(tree):
        t.requires_grad_(True)
    return tree


def _tb(batch):
    return {"images": torch.from_numpy(np.asarray(batch["images"])),
            "labels": torch.from_numpy(np.asarray(batch["labels"])).long()}


def _grads(loss, params):
    leaves = _leaves(params)
    return dict(zip([k for k, _ in leaves], (g.numpy() for g in
                    torch.autograd.grad(loss, [t for _, t in leaves]))))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree)
                for kv in _leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _check_grads(got, want, what):
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **GRAD_TOL,
                                   err_msg=f"{what}: {k}")


def test_patchify_matches_jax():
    img = np.arange(2 * 32 * 32 * 3, dtype=np.float32).reshape(2, 32, 32, 3)
    got = patchify(torch.from_numpy(img), 8).numpy()
    assert got.shape == (2, 16, 8 * 8 * 3)
    np.testing.assert_array_equal(got, np.asarray(jpatchify(
        jnp.asarray(img), 8)))


def test_init_trees_match_jax():
    """The port's inits build JAX's trees: the same keys and shapes; the
    dense config counts its parameters."""
    for tcfg, jtree in (
            (ViTConfig(**W.VIT), jax.eval_shape(lambda: jinit(
                jax.random.PRNGKey(0), _jcfg()))),
            (ViTConfig(**VIT_MOE), jax.eval_shape(lambda: jinit_moe(
                jax.random.PRNGKey(0), _jcfg(VIT_MOE))))):
        init = init_vit_moe_params if tcfg.moe_experts else init_vit_params
        got = {k: tuple(v.shape) for k, v in _leaves(init(tcfg,
                                                          device="cpu"))}
        want = {k: tuple(v.shape) for k, v in flatten(jax.tree.map(
            lambda s: np.zeros(s.shape), jtree)).items()}
        assert got == want
        if not tcfg.moe_experts:
            assert tcfg.num_params() == sum(int(np.prod(s))
                                            for s in got.values())


@pytest.mark.parametrize("attn", ["naive", "flash"])
def test_vit_serial_matches_jax(inp, gold, attn):
    cfg = ViTConfig(**W.VIT, attn_impl=attn)
    params = _trainable(vit_params_from_jax(jax.tree.map(
        np.asarray, _sub(inp, "vit/params/")), cfg, device="cpu"))
    batch = _tb(_sub(inp, "batch/"))
    logits = vit_forward(params, batch["images"], cfg)
    np.testing.assert_allclose(logits.detach().numpy(), gold["logits"],
                               **GRAD_TOL)
    loss = vit_loss(params, batch, cfg)
    np.testing.assert_allclose(float(loss), gold["serial"][0],
                               rtol=LOSS_RTOL)
    _check_grads(_grads(loss, params), gold["serial"][1], attn)


@pytest.mark.parametrize("router", ["topk", "expert_choice"])
def test_vit_moe_both_routers_match_jax(inp, router):
    """The encoder MoE with either router (expert choice is legal: the
    block is non-causal): aux > 0 under top-k and exactly 0 under expert
    choice, the loss and grads of a step, and a 3-step AdamW trajectory
    against JAX's (``'dense'`` dispatch on both sides)."""
    jcfg = _jcfg(VIT_MOE, moe_router=router, moe_dispatch="dense")
    tcfg = ViTConfig(**dict(VIT_MOE, moe_router=router, moe_dispatch="dense"))
    jparams = _sub(inp, "moe4/params/")
    batch = _sub(inp, "batch/")
    params = _trainable(vit_params_from_jax(jax.tree.map(
        np.asarray, jparams), tcfg, device="cpu"))
    _, jaux = jvit_moe_forward(jparams, batch["images"], jcfg)
    _, aux = vit_moe_forward(params, _tb(batch)["images"], tcfg)
    if router == "expert_choice":
        assert float(aux) == 0.0 == float(jaux)
    else:
        assert float(aux) > 0.0
        np.testing.assert_allclose(float(aux), float(jaux), rtol=LOSS_RTOL)
    vag = jax.jit(jax.value_and_grad(lambda p, b: jvit_moe_loss(p, b, jcfg)))
    jl, jg = vag(jparams, batch)
    loss = vit_moe_loss(params, _tb(batch), tcfg)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    _check_grads(_grads(loss, params), _np(jg), router)
    want, _ = _trajectory(vag, jparams, [batch] * 3)
    opt = adamw(W.LR)
    state = opt.init(params)
    got = []
    for _ in range(3):
        state.zero_grad(set_to_none=True)
        loss = vit_moe_loss(params, _tb(batch), tcfg)
        loss.backward()
        state.step()
        got.append(float(loss))
    np.testing.assert_allclose(got, want, **TRAJ_TOL)
    assert got[-1] < got[0]


# ---------------------------------------------------- the spawned ranks


@pytest.mark.parametrize("tag", ["ring_cp4", "ulysses_cp4", "ring_cp2"])
def test_vit_cp_matches_serial(ranks, gold, tag):
    """Every rank's loss and every leaf's grad, the class head's
    included, equal the serial model's."""
    loss, grads = gold["serial"]
    for r in range(W.WORLD):
        np.testing.assert_allclose(ranks[r][f"{tag}/loss"], loss,
                                   rtol=LOSS_RTOL)
        _check_grads({k[len(tag) + 7:]: v for k, v in ranks[r].items()
                      if k.startswith(f"{tag}/grads/")}, grads,
                     f"{tag} rank {r}")


def test_vit_tp_matches_serial(ranks, gold):
    """TP 2 + SP with the class-parallel head and cross-entropy: the
    tensor ranks' class columns joined are the serial logits."""
    for pair in ((0, 1), (2, 3)):
        order = sorted(pair, key=lambda r: int(ranks[r]["tp/rank"]))
        logits = np.concatenate([ranks[r]["tp/logits"] for r in order], -1)
        np.testing.assert_allclose(logits, gold["logits"], **GRAD_TOL)
        for r in pair:
            np.testing.assert_allclose(ranks[r]["tp/loss"],
                                       gold["serial"][0], rtol=1e-5)


def _params_of(rank_out, tag):
    n = len(tag) + 8
    return {k[n:]: v for k, v in rank_out.items()
            if k.startswith(f"{tag}/params/")}


def test_vit_dp_training_matches_serial(ranks, gold):
    losses, params = gold["dp"]
    for r in range(W.WORLD):
        np.testing.assert_allclose(ranks[r]["dp/losses"], losses, **TRAJ_TOL)
        _check_params(_params_of(ranks[r], "dp"), params, f"dp rank {r}")


@pytest.mark.parametrize("tag", ["pp_tp", "pp_cp"])
def test_vit_1f1b_training_matches_serial(ranks, gold, tag):
    """1F1B x TP + SP, and 1F1B x CP with the context axis a model axis
    (``DataParallel(axis='data')``): 2 SGD steps (JAX's optimizer there)
    track the serial model; the stages' slabs joined."""
    losses, params = gold["pipe"]
    stage = {r: int(ranks[r][f"{tag}/stage"]) for r in range(W.WORLD)}
    firsts = [r for r in range(W.WORLD) if stage[r] == 0]
    lasts = [r for r in range(W.WORLD) if stage[r] == 1]
    for a, b in zip(firsts, lasts):
        np.testing.assert_allclose(ranks[a][f"{tag}/losses"], losses,
                                   **TRAJ_TOL)
        pa, pb = _params_of(ranks[a], tag), _params_of(ranks[b], tag)
        joined = {k: np.concatenate([v, pb[k]]) if k.startswith("blocks/")
                  else v for k, v in pa.items()}
        _check_params(joined, params, f"{tag} ranks {a}+{b}")


def test_vit_moe_ep_training_matches_serial(ranks, gold):
    """ViT-MoE, expert choice under EP 2 x MoE-DP 2: 2 AdamW steps track
    the serial model over each rank's rows; the experts joined over the
    EP ranks."""
    losses, params = gold["ep"]
    for pair in ((0, 1), (2, 3)):
        order = sorted(pair, key=lambda r: int(ranks[r]["moe_ep/ep_rank"]))
        assert [int(ranks[r]["moe_ep/ep_rank"]) for r in order] == [0, 1]
        pa, pb = (_params_of(ranks[r], "moe_ep") for r in order)
        joined = {k: np.concatenate([v, pb[k]]) if "/experts/" in k else v
                  for k, v in pa.items()}
        np.testing.assert_allclose(ranks[order[0]]["moe_ep/losses"], losses,
                                   **TRAJ_TOL)
        _check_params(joined, params, f"moe_ep ranks {pair}")


def test_vit_config_refuses_a_group_without_cp_attention():
    cfg = ViTConfig(**W.VIT)
    params = init_vit_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="ring"):
        vit_forward(params, torch.zeros(1, 32, 32, 3), cfg, cp_group=object())
    assert dataclasses.replace(cfg, attn_impl="ring").block.causal is False
