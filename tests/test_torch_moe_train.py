"""The port's MoE training path against the JAX package, in one process on
the CPU, in f32 at small widths (inputs made with numpy, handed to both):

- ``moe_forward``'s output, aux and every grad leaf for ``'dense'``,
  ``'sorted'`` and ``'cuda'`` (K6's Function on its plain path), GELU and
  SwiGLU, with and without capacity drops, against JAX's ``moe_forward``
  (``'dense'`` / ``'sorted'``; JAX's ``'pallas'`` only through its oracle:
  its kernel does not build on this JAX, ROADMAP C);
- K6's and K7's autograd Functions against ``jax.vjp`` of JAX's
  ``moe_ffn_oracle`` and ``_ep_ffn_reference`` (the backwards JAX's
  ``custom_vjp``s run), the planted fault "the backward without the gate
  cotangent", and int8 experts forward only;
- the expert-choice router (forward and grads), the ``causal=True``
  refusal, the ``'auto'`` threshold, zero output for dropped tokens;
- ``gpt_moe_loss`` and its grads under each remat mode, the router
  counters of ``collect_metrics``, the specs and overrides, the pipeline
  layout, and two AdamW steps of ``make_train_step(gpt_moe_loss)``.

Tolerances: forward ``rtol`` 1e-5 / ``atol`` 1e-6; grads ``rtol`` /
``atol`` 5e-5 (the pipeline tests'); trajectories ``rtol`` 1e-4 / ``atol``
1e-5 (losses) and 1e-3 / 1e-5 (parameters).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import gpt_moe as jgm
from torchdistpackage_tpu.obs.aggregate import moe_load_stats as j_load_stats
from torchdistpackage_tpu.ops import moe_dispatch as jmd
from torchdistpackage_tpu.parallel import moe as jmoe
from torchdistpackage_tpu_torch.models import (
    GPTConfig,
    gpt_moe_forward,
    gpt_moe_loss,
    gpt_moe_param_specs,
    moe_stage_params,
    moe_stage_pattern,
    params_from_jax,
    shard_gpt_params,
)
from torchdistpackage_tpu_torch.obs import default_event_log
from torchdistpackage_tpu_torch.obs.aggregate import moe_load_stats
from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
from torchdistpackage_tpu_torch.ops import moe_dispatch as md
from torchdistpackage_tpu_torch.parallel import adamw
from torchdistpackage_tpu_torch.parallel import moe as tmoe
from torchdistpackage_tpu_torch.parallel.data_parallel import make_train_step
from torchdistpackage_tpu_torch.utils.partition import named_leaves

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
LOSS_TOL, PARAM_TOL = dict(rtol=1e-4, atol=1e-5), dict(rtol=1e-3, atol=1e-5)
D, FF, E = 16, 32, 4
GPT = dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=16,
           ffn_mult=2, moe_experts=4, moe_top_k=2, moe_every=2,
           moe_capacity_factor=1.0, moe_aux_weight=1e-2)


def _random_tree(shapes, rs):
    """Numpy leaves of a JAX init's shapes: norm scales ``1 + 0.1 N``,
    every other leaf ``0.1 N`` (biases too)."""
    def leaf(path, sd):
        v = 0.1 * rs.randn(*sd.shape)
        name = str(getattr(path[-1], "key", ""))
        return (1.0 + v if name == "scale" else v).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _layer(act="gelu", seed=0):
    cfg = jmoe.MoEConfig(dim=D, ffn_dim=FF, num_experts=E, act=act)
    return _random_tree(jax.eval_shape(lambda: jmoe.init_moe_params(
        jax.random.PRNGKey(0), cfg)), np.random.RandomState(seed))


def _t(tree, grad=True):
    if isinstance(tree, dict):
        return {k: _t(v, grad) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_t(v, grad) for v in tree]
    t = torch.from_numpy(np.array(tree))
    return t.requires_grad_(True) if grad and t.is_floating_point() else t


def _by_path(tree):
    """``{path: numpy}`` of a JAX tree, paths as ``named_leaves`` writes
    them."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grads_close(tparams, jgrads, **tol):
    want = _by_path(jgrads)
    got = dict(named_leaves(tparams))
    assert got.keys() == want.keys()
    for n, t in got.items():
        np.testing.assert_allclose(t.grad.numpy(), want[n], err_msg=n,
                                   **tol)


def _jcfg(**kw):
    return JGPTConfig(**dict(GPT, **kw), dtype=jnp.float32)


# ------------------------------------------------------------ the layer

#: (port dispatch, JAX dispatch, act, capacity factor, causal)
LAYER_CASES = {
    "dense_gelu_drops": ("dense", "dense", "gelu", 1.0, False),
    "sorted_swiglu_drops_causal": ("sorted", "sorted", "swiglu", 1.0, True),
    "cuda_gelu_drops": ("cuda", "sorted", "gelu", 1.0, False),
    "cuda_swiglu_nodrop": ("cuda", "dense", "swiglu", 2.0, True),
}


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_moe_forward_and_grads_match_jax(name):
    """Output, aux and every grad leaf of ``mean(y^2) + aux``, and the
    input's grad, against JAX's ``moe_forward``; ``'cuda'`` on the CPU is
    K6's Function on its plain version (no launch)."""
    disp, jdisp, act, cf, causal = LAYER_CASES[name]
    p = _layer(act, seed=1)
    x = np.random.RandomState(2).randn(2, 12, D).astype(np.float32)
    jc = jmoe.MoEConfig(dim=D, ffn_dim=FF, num_experts=E, act=act,
                        capacity_factor=cf, dispatch=jdisp)

    def jl(pp, xx):
        y, aux = jmoe.moe_forward(pp, xx, jc, causal=causal)
        return jnp.mean(y * y) + aux, (y, aux)
    (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
        jl, argnums=(0, 1), has_aux=True))(p, x)
    tc = tmoe.MoEConfig(dim=D, ffn_dim=FF, num_experts=E, act=act,
                        capacity_factor=cf, dispatch=disp)
    tp, tx = _t(p), _t(x)
    before = dict(md.LAUNCHES)
    y, aux = tmoe.moe_forward(tp, tx, tc, causal=causal)
    ((y * y).mean() + aux).backward()
    assert md.LAUNCHES == before
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **FWD_TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    _grads_close(tp, jg[0], **GRAD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]),
                               **GRAD_TOL)
    if cf == 1.0:  # the case really drops
        T = x.shape[0] * x.shape[1]
        probs = torch.softmax(tx.detach().reshape(T, D) @ tp["router"]["w"]
                              .detach(), -1)
        keep = tmoe._top_k_route(probs, 2, int(np.ceil(T * 2 * cf / E)))[3]
        assert float(keep.sum()) < T * 2


def _route(seed, T=24, cap=9):
    logits = np.random.RandomState(seed).randn(T, E).astype(np.float32) * 2
    probs = jax.nn.softmax(jnp.asarray(logits), -1)
    return [np.asarray(a) for a in jmoe._top_k_route(probs, 2, cap)], cap


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_k6_and_k7_functions_match_jax_vjps(act):
    """K6's Function (``fused_moe_ffn`` with grads: experts, tokens,
    ``gate_vals``, ``keep``) against ``jax.vjp`` of JAX's
    ``moe_ffn_oracle``, the backward of its ``_fused_diff``, on a routing
    with drops; K7's (``fused_expert_ffn``) against ``jax.vjp`` of
    ``_ep_ffn_reference``; the int routing args get no grad."""
    p = _layer(act, seed=3)["experts"]
    rs = np.random.RandomState(4)
    x = rs.randn(24, D).astype(np.float32)
    (gv, gi, slot, keep), cap = _route(5)
    cot = rs.randn(24, D).astype(np.float32)
    je, jt, jgv, jkeep = jax.jit(lambda *a: jax.vjp(
        lambda e, t, g, k: jmd.moe_ffn_oracle(e, t, g, gi, slot, k, cap),
        *a)[1](jnp.asarray(cot)))(p, x, gv, keep)
    te, tt, tgv, tkeep = _t(p), _t(x), _t(gv), _t(keep)
    y = md.fused_moe_ffn(te, tt, tgv, _t(gi), _t(slot), tkeep, cap)
    y.backward(torch.from_numpy(cot))
    for n in te:
        np.testing.assert_allclose(te[n].grad.numpy(), np.asarray(je[n]),
                                   err_msg=n, **GRAD_TOL)
    for got, want in ((tt, jt), (tgv, jgv), (tkeep, jkeep)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL)
    assert float(tgv.grad.abs().max()) > 0

    xg = rs.randn(E, 6, D).astype(np.float32)
    cot = rs.randn(E, 6, D).astype(np.float32)
    je, jx = jax.jit(lambda *a: jax.vjp(jmd._ep_ffn_reference, *a)[1](
        jnp.asarray(cot)))(p, xg)
    te, tx = _t(p), _t(xg)
    md.fused_expert_ffn(te, tx).backward(torch.from_numpy(cot))
    for n in te:
        np.testing.assert_allclose(te[n].grad.numpy(), np.asarray(je[n]),
                                   err_msg=n, **GRAD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx), **GRAD_TOL)


def test_planted_fault_gate_cotangent_dropped():
    """A K6 backward that drops the ``gate_vals`` cotangent leaves the
    router without its expert-path grad: the router's grad must then miss
    JAX's by more than 1e-2 of its scale, where the true backward meets
    it within 5e-5."""
    p = _layer("gelu", seed=6)
    x = np.random.RandomState(7).randn(2, 12, D).astype(np.float32)
    jc = jmoe.MoEConfig(dim=D, ffn_dim=FF, num_experts=E, dispatch="sorted")
    jg = jax.jit(jax.grad(lambda pp: jnp.mean(
        jmoe.moe_forward(pp, x, jc)[0] ** 2)))(p)
    want = np.asarray(jg["router"]["w"])
    tc = tmoe.MoEConfig(dim=D, ffn_dim=FF, num_experts=E, dispatch="cuda")

    def router_grad():
        tp = _t(p)
        (tmoe.moe_forward(tp, _t(x, grad=False), tc)[0] ** 2).mean(
            ).backward()
        g = tp["router"]["w"].grad
        return np.zeros_like(want) if g is None else g.numpy()

    np.testing.assert_allclose(router_grad(), want, **GRAD_TOL)
    true_backward = md._FusedMoE.backward

    def dropped(ctx, g):
        grads = list(true_backward(ctx, g))
        grads[4] = None  # gate_vals
        return tuple(grads)
    md._FusedMoE.backward = staticmethod(dropped)
    try:
        got = router_grad()
    finally:
        md._FusedMoE.backward = true_backward
    assert np.abs(got - want).max() > 1e-2 * np.abs(want).max()


def test_int8_experts_are_forward_only():
    """int8 ``(q8, scale)`` experts run forward under autograd and under
    ``no_grad`` (the same output), and a backward through them raises, as
    the reference's int8 path has no VJP."""
    p = _t(_layer("gelu", seed=8)["experts"], grad=False)
    q = md.quantize_moe_experts(p)
    x = torch.from_numpy(np.random.RandomState(9).randn(24, D).astype(
        np.float32))
    (gv, gi, slot, keep), cap = _route(10)
    route = [_t(a, grad=False) for a in (gv, gi, slot, keep)]
    with torch.no_grad():
        want = md.fused_moe_ffn(q, x, *route, cap)
    xr = x.clone().requires_grad_(True)
    y = md.fused_moe_ffn(q, xr, *route, cap)
    assert torch.equal(y.detach(), want)
    with pytest.raises(NotImplementedError, match="forward only"):
        y.sum().backward()
    xg = x.reshape(E, 6, D).clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward only"):
        md.fused_expert_ffn(q, xg).sum().backward()


@pytest.mark.parametrize("disp", ["dense", "sorted"])
def test_expert_choice_forward_and_grads_match_jax(disp):
    """The expert-choice router (C = ceil(T cf / E) = 6 < T = 24): output,
    aux 0, every grad leaf and the counters against JAX's."""
    p = _layer("gelu", seed=11)
    x = np.random.RandomState(12).randn(2, 12, D).astype(np.float32)
    jc = jmoe.MoEConfig(dim=D, ffn_dim=FF, num_experts=E, capacity_factor=1.0,
                        router="expert_choice", dispatch=disp)
    (_, (jy, jm)), jg = jax.jit(jax.value_and_grad(
        lambda pp: (lambda y, a, m: (jnp.mean(y * y), (y, m)))(
            *jmoe.moe_forward(pp, jnp.asarray(x), jc, return_metrics=True)),
        has_aux=True))(p)
    tc = tmoe.MoEConfig(dim=D, ffn_dim=FF, num_experts=E, capacity_factor=1.0,
                        router="expert_choice", dispatch=disp)
    tp = _t(p)
    y, aux, m = tmoe.moe_forward(tp, _t(x, grad=False), tc,
                                 return_metrics=True)
    (y * y).mean().backward()
    assert float(aux) == 0.0
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **FWD_TOL)
    _grads_close(tp, jg, **GRAD_TOL)
    for k in jm:
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_expert_choice_refusals():
    """``causal=True`` refuses the expert-choice router (JAX
    ``tests/test_moe.py:932``), as a causal GPT config does, and
    ``dispatch='cuda'`` refuses it (JAX's ``'pallas'`` does)."""
    p = _t(_layer(), grad=False)
    x = torch.zeros(1, 8, D)
    cfg = tmoe.MoEConfig(dim=D, ffn_dim=FF, num_experts=E,
                         router="expert_choice", dispatch="dense")
    with pytest.raises(ValueError, match="causal"):
        tmoe.moe_forward(p, x, cfg, causal=True)
    with pytest.raises(ValueError, match="expert_choice"):
        dataclasses.replace(cfg, dispatch="cuda")
    with pytest.raises(ValueError, match="expert_choice"):
        GPTConfig(**GPT, moe_router="expert_choice")
    with pytest.raises(ValueError, match="'gather'"):
        tmoe.moe_forward(p, x, dataclasses.replace(cfg, router="topk",
                                                   dispatch="gather"))


def test_dispatch_auto_threshold():
    """``'auto'`` off the card picks ``'dense'`` up to ``T E C`` =
    :data:`_DENSE_DISPATCH_MAX` elements and ``'sorted'`` above, as JAX's
    (``tests/test_moe.py:186``, the same constant); explicit values win;
    on a CUDA device the token-choice router takes ``'cuda'`` and the
    expert-choice one the plain arm by size.  Each ``'auto'`` choice is a
    ``moe_dispatch_selected`` event."""
    assert tmoe._DENSE_DISPATCH_MAX == jmoe._DENSE_DISPATCH_MAX
    cfg = tmoe.MoEConfig(dim=D, ffn_dim=FF, num_experts=E)
    jcfg = jmoe.MoEConfig(dim=D, ffn_dim=FF, num_experts=E)
    big_T = tmoe._DENSE_DISPATCH_MAX // (E * 8) + 1
    for T in (32, big_T):
        assert tmoe._use_sorted(cfg, T, 8) == jmoe._use_sorted(jcfg, T, 8)
    assert not tmoe._use_sorted(cfg, 32, 8) and tmoe._use_sorted(cfg, big_T,
                                                                 8)
    for disp, want in (("sorted", True), ("dense", False)):
        c = dataclasses.replace(cfg, dispatch=disp)
        assert tmoe._use_sorted(c, 2 if want else big_T, 1) == want
    log = default_event_log()
    n = len(log.as_list())
    assert tmoe._forward_dispatch(cfg, "cpu", 32, 8) == "dense"
    assert tmoe._forward_dispatch(cfg, "cpu", big_T, 8) == "sorted"
    assert tmoe._forward_dispatch(cfg, "cuda", big_T, 8) == "cuda"
    ec = dataclasses.replace(cfg, router="expert_choice")
    assert tmoe._forward_dispatch(ec, "cuda", 32, 8) == "dense"
    assert [e["chosen"] for e in log.as_list()[n:]
            if e["kind"] == "moe_dispatch_selected"] == [
        "dense", "sorted", "cuda", "dense"]
    assert tmoe._forward_dispatch(dataclasses.replace(
        cfg, dispatch="sorted"), "cuda", 32, 8) == "sorted"


@pytest.mark.parametrize("disp", ["dense", "sorted", "cuda"])
def test_dropped_tokens_output_zero(disp):
    """A token whose every choice is dropped past capacity adds exactly
    zero (the residual carries it), as in JAX: with C 1 most tokens of a
    sequence are dropped."""
    p = _layer("gelu", seed=13)
    p["experts"]["b2"][:] = 0.5  # a dropped slot must not leak b2
    x = np.random.RandomState(14).randn(1, 16, D).astype(np.float32)
    jc = jmoe.MoEConfig(dim=D, ffn_dim=FF, num_experts=E, top_k=1,
                        capacity_factor=0.25, dispatch="dense")
    jy = np.asarray(jax.jit(lambda pp: jmoe.moe_forward(pp, x, jc)[0])(
        p))[0]
    tc = tmoe.MoEConfig(dim=D, ffn_dim=FF, num_experts=E, top_k=1,
                        capacity_factor=0.25, dispatch=disp)
    y = tmoe.moe_forward(_t(p, grad=False), _t(x, grad=False), tc)[0][0]
    zero = np.all(jy == 0, axis=-1)
    assert 0 < zero.sum() < 16
    assert torch.all(y[torch.from_numpy(zero)] == 0)
    np.testing.assert_allclose(y.numpy(), jy, **FWD_TOL)


# ------------------------------------------------------------ the model

#: port remat mode -> its attention (the 'flash' modes keep K3's (o, lse):
#: the flash path, its plain version on the CPU)
REMAT = {"none": (False, "naive"), "true": (True, "naive"),
         "flash": ("flash", "flash"), "flash_offload": ("flash_offload",
                                                        "flash")}


@pytest.fixture(scope="module")
def gpt_gold():
    """JAX's ``gpt_moe_loss`` value and grads on numpy weights (drops on:
    capacity factor 1), with its ``collect_metrics`` counters."""
    rs = np.random.RandomState(20)
    jc = _jcfg()
    params = _random_tree(jax.eval_shape(lambda: jgm.init_gpt_moe_params(
        jax.random.PRNGKey(0), jc)), rs)
    batch = {k: rs.randint(0, 64, (4, 16)).astype(np.int32)
             for k in ("tokens", "targets")}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jgm.gpt_moe_loss(p, batch, jc)))(params)
    met = jax.jit(lambda p: jgm.gpt_moe_forward(
        p, jnp.asarray(batch["tokens"]), jc, collect_metrics=True)[2])(params)
    return params, batch, float(loss), grads, jax.tree.map(np.asarray, met)


@pytest.mark.parametrize("remat", list(REMAT))
@pytest.mark.parametrize("disp", ["dense", "cuda"])
def test_gpt_moe_loss_matches_jax(gpt_gold, remat, disp):
    """``gpt_moe_loss`` and every grad leaf under each remat mode, the
    ``'dense'`` materialisation and K6's Function, against JAX's
    ``gpt_moe_loss`` (its ``'auto'``: dense here)."""
    params, batch, loss, grads, _ = gpt_gold
    mode, attn = REMAT[remat]
    cfg = GPTConfig(**GPT, attn_impl=attn, moe_dispatch=disp)
    tp = _t(params_from_jax(params, cfg, device="cpu"))
    got = gpt_moe_loss(tp, {k: torch.from_numpy(v).long()
                            for k, v in batch.items()}, cfg, remat=mode)
    got.backward()
    np.testing.assert_allclose(float(got), loss, rtol=1e-5)
    _grads_close(tp, grads, **GRAD_TOL)


def test_collect_metrics_matches_jax(gpt_gold):
    """``gpt_moe_forward(collect_metrics=True)``: the expert blocks'
    router counters (``expert_tokens`` summed, entropy and drop rate
    averaged) and ``moe_load_stats`` over them equal JAX's."""
    params, batch, _, _, jm = gpt_gold
    cfg = GPTConfig(**GPT)
    tp = _t(params_from_jax(params, cfg, device="cpu"), grad=False)
    _, _, m = gpt_moe_forward(tp, torch.from_numpy(batch["tokens"]).long(),
                              cfg, collect_metrics=True)
    for k in jm:
        np.testing.assert_allclose(m[k].numpy(), jm[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert float(jm["dropped_token_rate"]) > 0
    want = j_load_stats(jm["expert_tokens"], jm["dropped_token_rate"])
    got = moe_load_stats(m["expert_tokens"].tolist(),
                         float(m["dropped_token_rate"]))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_make_train_step_trains_gpt_moe(gpt_gold):
    """Two AdamW(1e-2) steps of ``make_train_step(gpt_moe_loss)`` against
    ``optax.adamw``'s serial trajectory on JAX's ``gpt_moe_loss``: the
    losses, and every parameter but the QKV bias's key rows (their grad
    is 0 in exact arithmetic; AdamW turns rounding into steps)."""
    params, batch, _, _, _ = gpt_gold
    jc = _jcfg()
    opt = optax.adamw(1e-2)
    vag = jax.jit(jax.value_and_grad(lambda p: jgm.gpt_moe_loss(p, batch,
                                                                jc)))
    update = jax.jit(opt.update)
    jp, state, want = params, opt.init(params), []
    for _ in range(2):
        loss, g = vag(jp)
        u, state = update(g, state, jp)
        jp = jax.tree.map(jnp.add, jp, u)
        want.append(float(loss))
    cfg = GPTConfig(**GPT, moe_dispatch="cuda")
    tp = params_from_jax(params, cfg, device="cpu")
    step = make_train_step(lambda p, b: gpt_moe_loss(p, b, cfg, remat=True),
                           adamw(1e-2))
    st = adamw(1e-2).init(tp)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    got = []
    for _ in range(2):
        tp, st, loss, _ = step(tp, st, tb)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    wp = _by_path(jp)
    for n, t in named_leaves(tp):
        a, b = t.detach().numpy(), wp[n]
        if n.endswith("attn/bqkv"):
            a, b = a[[0, 2]], b[[0, 2]]
        np.testing.assert_allclose(a, b, err_msg=n, **PARAM_TOL)


def test_specs_and_overrides_match_jax():
    """``moe_param_specs`` / ``moe_grad_reduce_overrides`` carry JAX's
    placement (router replicated, experts over ``moe_ep``; expert grads
    over ``moe_dp`` only), and ``gpt_moe_param_specs`` derives its blocks
    from ``moe_blocks_param_specs``."""
    assert tmoe.moe_grad_reduce_overrides() == \
        jmoe.moe_grad_reduce_overrides()
    js = jmoe.moe_param_specs("moe_ep")
    ts = tmoe.moe_param_specs("moe_ep")
    assert ts["router"]["w"] is None and tuple(js["router"]["w"]) == ()
    for n, s in ts["experts"].items():
        assert s == "moe_ep" and tuple(js["experts"][n])[0] == "moe_ep"
    cfg = GPTConfig(**GPT)
    p = _t(params_from_jax(_random_tree(jax.eval_shape(
        lambda: jgm.init_gpt_moe_params(jax.random.PRNGKey(0), _jcfg())),
        np.random.RandomState(0)), cfg, device="cpu"), grad=False)
    sp = gpt_moe_param_specs(p, "moe_ep")
    assert sp["blocks"][1]["moe"]["experts"]["w1"] == "moe_ep"
    assert sp["blocks"][1]["moe"]["router"]["w"] is None
    assert sp["blocks"][0]["mlp"]["w1"] == -1
    assert gpt_moe_param_specs(p)["blocks"][1]["moe"]["experts"]["w2"] is None


def test_pipeline_layout_matches_jax():
    """``moe_stage_pattern`` raises where JAX's does; ``moe_stage_params``
    gives stage ``s`` JAX's ``stack_moe_stage_params`` slab ``v P + s``
    (classic and interleaved); ``params_from_jax`` takes either JAX layout
    to that slab, and ``shard_gpt_params(pp_size=)`` cuts an MoE tree."""
    kw = dict(GPT, nlayers=8)
    jc, cfg = _jcfg(nlayers=8), GPTConfig(**kw)
    assert moe_stage_pattern(cfg, 2, 2) == jgm.moe_stage_pattern(jc, 2, 2)
    for P_, V in ((4, 2), (8, 1)):
        with pytest.raises(ValueError):
            jgm.moe_stage_pattern(jc, P_, V)
        with pytest.raises(ValueError):
            moe_stage_pattern(cfg, P_, V)
    params = _random_tree(jax.eval_shape(lambda: jgm.init_gpt_moe_params(
        jax.random.PRNGKey(0), jc)), np.random.RandomState(1))
    for V in (1, 2):
        stacked = jgm.stack_moe_stage_params(params, jc, 2, num_chunks=V)
        for s in range(2):
            slab = moe_stage_params(params, cfg, s, 2, V)["blocks"]
            conv = params_from_jax(jax.tree.map(np.asarray, stacked), cfg,
                                   device="cpu", pp_rank=s, pp_size=2,
                                   num_chunks=V)["blocks"]
            cut = shard_gpt_params(params, cfg, 0, 1, pp_rank=s, pp_size=2,
                                   num_chunks=V)["blocks"]
            lc = len(slab) // V
            for j, b in enumerate(slab):
                v, i = divmod(j, lc)
                want = jax.tree.map(
                    lambda a: np.asarray(a)[s] if V == 1
                    else np.asarray(a)[v, s], stacked["blocks"][i])
                for n, a in _by_path(want).items():
                    np.testing.assert_array_equal(
                        dict(named_leaves(b))[n], a)
                    np.testing.assert_array_equal(
                        dict(named_leaves(conv[j]))[n].numpy(), a)
                    np.testing.assert_array_equal(
                        dict(named_leaves(cut[j]))[n], a)
    assert all(t.shape for t in tree_leaves(conv))
