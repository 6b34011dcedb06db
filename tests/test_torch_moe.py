"""The port's MoE serving layer against the JAX package, on the CPU, in
f32 at small widths: the routing decision and its slot maps (exact), K6's
plain version and the kernel's CPU wrapper against JAX's
``moe_ffn_oracle`` (GELU and SwiGLU, with and without capacity drops),
and ``moe_serve_forward``'s two arms against JAX's ragged ``'gather'``
arm.  JAX's Pallas K6 is not called: it does not build on this JAX
(``pl.store``), so the oracle and the ragged arm are the references.

Inputs are made with numpy and handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.obs.aggregate import moe_load_stats as j_load_stats
from torchdistpackage_tpu.ops import moe_dispatch as jmd
from torchdistpackage_tpu.parallel import moe as jmoe
from torchdistpackage_tpu_torch.obs import EVENT_KINDS, default_event_log
from torchdistpackage_tpu_torch.obs.aggregate import moe_load_stats
from torchdistpackage_tpu_torch.ops import moe_dispatch as md
from torchdistpackage_tpu_torch.parallel import moe as tmoe

RTOL, ATOL = 1e-5, 1e-6
T, E, K, D = 24, 4, 2, 32


def _probs(seed, t=T, e=E):
    logits = np.random.RandomState(seed).randn(t, e).astype(np.float32) * 2
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _experts(act, seed, ffn=48, d=D, e=E):
    """JAX-initialised experts with random (non-zero) biases, as numpy."""
    cfg = jmoe.MoEConfig(dim=d, ffn_dim=ffn, num_experts=e, act=act)
    p = jax.tree.map(np.asarray, jmoe.init_moe_params(
        jax.random.PRNGKey(seed), cfg))
    rs = np.random.RandomState(seed)
    for b in ("b1", "b2"):
        p["experts"][b] = rs.randn(*p["experts"][b].shape).astype(
            np.float32) * 0.1
    return p


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(tree)


@pytest.mark.parametrize("capacity,priority", [
    (T, "choice"), (T, "token"), (7, "choice"), (7, "token")])
def test_top_k_route_and_slot_maps_match_jax(capacity, priority):
    """Exact integer routing (expert, slot, kept) and the [E, C] maps;
    capacity 7 < T k / E drops choices."""
    probs = _probs(0)
    jgv, jgi, jslot, jkeep = jmoe._top_k_route(jnp.asarray(probs), K,
                                               capacity, priority=priority)
    gv, gi, slot, keep = tmoe._top_k_route(torch.from_numpy(probs), K,
                                           capacity, priority=priority)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(jgi))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), rtol=0,
                               atol=1e-7)
    if capacity < T:
        assert float(keep.sum()) < T * K  # the case really drops
    idx, comb = md.slot_maps(gv, gi, slot, keep, capacity)
    jidx, jcomb = jmd.slot_maps(jgv, jgi, jslot, jkeep, capacity)
    assert idx.dtype == torch.int32 and idx.shape == (E, capacity)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(comb.numpy(), np.asarray(jcomb), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
@pytest.mark.parametrize("capacity", [T, 7])
def test_oracle_and_wrapper_match_jax_oracle(act, capacity):
    """K6's plain version (through ``moe_ffn_oracle``) and the kernel's
    wrapper on CPU tensors against JAX's ``moe_ffn_oracle`` on the same
    routing and weights."""
    p = _experts(act, seed=1)
    x = np.random.RandomState(2).randn(T, D).astype(np.float32)
    route = jmoe._top_k_route(jnp.asarray(_probs(3)), K, capacity)
    want = np.asarray(jmd.moe_ffn_oracle(_j(p["experts"]), jnp.asarray(x),
                                         *route, capacity))
    troute = [torch.from_numpy(np.array(a)) for a in route]
    ex = _t(p["experts"])
    got = md.moe_ffn_oracle(ex, torch.from_numpy(x), *troute, capacity)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    before = md.LAUNCHES["fused_moe_ffn"]
    fused = md.fused_moe_ffn(ex, torch.from_numpy(x), *troute, capacity)
    assert fused.dtype == torch.float32
    np.testing.assert_allclose(fused.numpy(), want, rtol=RTOL, atol=ATOL)
    assert md.LAUNCHES["fused_moe_ffn"] == before  # CPU: the plain version


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_serve_forward_arms_match_jax_gather(act):
    """Both port arms against JAX's ragged ``dispatch='gather'`` arm:
    outputs to float tolerance, routed-token counts equal."""
    p = _experts(act, seed=4)
    x = np.random.RandomState(5).randn(2, T // 2, D).astype(np.float32)
    jcfg = jmoe.MoEConfig(dim=D, ffn_dim=48, num_experts=E, act=act)
    want, jmet = jmoe.moe_serve_forward(_j(p), jnp.asarray(x), jcfg,
                                        dispatch="gather",
                                        return_metrics=True)
    tcfg = tmoe.MoEConfig(dim=D, ffn_dim=48, num_experts=E, act=act)
    tp = _t(p)
    for arm in ("gather", "cuda", "auto"):
        got, met = tmoe.moe_serve_forward(tp, torch.from_numpy(x), tcfg,
                                          dispatch=arm, return_metrics=True)
        assert got.shape == x.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=arm)
        np.testing.assert_array_equal(met["expert_tokens"].numpy(),
                                      np.asarray(jmet["expert_tokens"]))
        assert float(met["dropped_token_rate"]) == 0.0
    assert float(met["expert_tokens"].sum()) == T * K


def test_kernel_wrapper_refuses_what_k6_does_not_take():
    p = _t(_experts("swiglu", seed=6))
    x = torch.randn(T, D)
    idx, comb = md.slot_maps(*tmoe._top_k_route(
        torch.from_numpy(_probs(7)), K, T), T)
    q8 = dict(p["experts"], w1=(p["experts"]["w1"].to(torch.int8),
                                torch.ones(E, 2, 48)))
    with pytest.raises(NotImplementedError, match="int8"):
        md.fused_moe_ffn_slots(q8, x, idx, comb)
    mixed = dict(p["experts"], w2=p["experts"]["w2"].to("meta"))
    with pytest.raises(ValueError, match="device"):
        md.fused_moe_ffn_slots(mixed, x, idx, comb)


def test_configs_and_dispatch_resolution():
    with pytest.raises(ValueError, match="router"):
        tmoe.MoEConfig(dim=D, ffn_dim=48, num_experts=E, router="hash")
    with pytest.raises(ValueError, match="act"):
        tmoe.MoEConfig(dim=D, ffn_dim=48, num_experts=E, act="relu")
    with pytest.raises(ValueError, match="dispatch"):
        tmoe.MoEConfig(dim=D, ffn_dim=48, num_experts=E, dispatch="pallas")
    with pytest.raises(ValueError, match="expert_choice"):
        tmoe.MoEConfig(dim=D, ffn_dim=48, num_experts=E, dispatch="cuda",
                       router="expert_choice")
    with pytest.raises(NotImplementedError, match="training"):
        tmoe.MoEConfig(dim=D, ffn_dim=48, num_experts=E, dispatch="dense")
    # the capacity path's index dispatch is served (moe_forward)
    assert tmoe.MoEConfig(dim=D, ffn_dim=48, num_experts=E,
                          dispatch="sorted").dispatch == "sorted"
    log = default_event_log()
    n = len(log.as_list())
    assert md.resolve_moe_dispatch("auto", "cpu") == "gather"
    ev = log.as_list()[n:]
    assert [e["kind"] for e in ev] == ["moe_dispatch_selected"]
    assert ev[0]["chosen"] == "gather" and ev[0]["kind"] in EVENT_KINDS
    assert md.resolve_moe_dispatch("cuda", "cpu") == "cuda"
    with pytest.raises(ValueError, match="moe dispatch"):
        md.resolve_moe_dispatch("pallas", "cpu")


@pytest.mark.parametrize("tokens,rate", [
    ([10.0, 30.0, 0.0, 20.0], None), ([5.0] * 4, 0.25), ([0.0] * 3, 0.0),
    ([7.0], None)])
def test_load_stats_and_overflow_match_jax(tokens, rate):
    got = moe_load_stats(tokens, dropped_rate=rate)
    want = j_load_stats(tokens, dropped_rate=rate)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)
    log = default_event_log()
    n = len(log.as_list())
    fired = tmoe.check_expert_overflow(got, where="test")
    assert fired == (rate is not None and rate > 0.05)
    ev = log.as_list()[n:]
    assert [e["kind"] for e in ev] == (["expert_overflow"] if fired else [])


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_init_moe_params_matches_jax_tree(act):
    """Same leaves, shapes, dtypes and scales as the reference's init (the
    draws themselves differ)."""
    jcfg = jmoe.MoEConfig(dim=64, ffn_dim=128, num_experts=E, act=act)
    tcfg = tmoe.MoEConfig(dim=64, ffn_dim=128, num_experts=E, act=act)
    jp = jax.tree_util.tree_flatten_with_path(
        jmoe.init_moe_params(jax.random.PRNGKey(0), jcfg))[0]
    tp = tmoe.init_moe_params(torch.Generator().manual_seed(0), tcfg,
                              device="cpu")
    for path, leaf in jp:
        keys = [k.key for k in path]
        got = tp[keys[0]][keys[1]]
        assert tuple(got.shape) == leaf.shape, keys
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got.std()), float(np.std(leaf)),
                                   rtol=0.2, atol=1e-6, err_msg=str(keys))
