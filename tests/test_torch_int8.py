"""The port's int8 weight-only pieces against the JAX package, on the CPU:
the quantisers (``quantize_moe_experts``, ``quantize_int8``,
``quantize_stacked_int8``, ``quantize_decode_params``: the same int8
values element for element, bit-equal scales, the same set of leaves),
the structural int8 ``dense``, K6's int8 plain version (the kernel's
wrapper on CPU tensors and ``moe_ffn_oracle``) against JAX's
``moe_ffn_oracle`` on ``(q8, scale)`` leaves, the serve arms, and
``params_from_jax`` carrying int8 leaves bit-exact.

Inputs are made with numpy or JAX's init and handed to both packages."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import init_gpt_moe_params as jinit_moe
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.models import llama_config as jllama
from torchdistpackage_tpu.ops import moe_dispatch as jmd
from torchdistpackage_tpu.parallel import moe as jmoe
from torchdistpackage_tpu.parallel.tensor_parallel.layers import (
    dense as jdense,
)
from torchdistpackage_tpu.tools import surgery as js
from torchdistpackage_tpu.utils.tree import key_str as jkey_str
from torchdistpackage_tpu_torch.models import GPTConfig, llama_config
from torchdistpackage_tpu_torch.models.convert import params_from_jax
from torchdistpackage_tpu_torch.obs.numerics import tree_bytes, tree_leaves
from torchdistpackage_tpu_torch.ops import moe_dispatch as md
from torchdistpackage_tpu_torch.parallel import moe as tmoe
from torchdistpackage_tpu_torch.parallel.tensor_parallel.layers import (
    compute_qkv,
    dense,
    mlp_partial,
)
from torchdistpackage_tpu_torch.tools import surgery as ts

RTOL, ATOL = 1e-5, 1e-6  # K6 against the oracle (JAX's own int8 tolerance)
T, E, K, D, FF = 24, 4, 2, 32, 48
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(x):
    """A JAX array as numpy (bf16 through f32, which holds it exactly)."""
    x = jnp.asarray(x)
    if x.dtype == jnp.bfloat16:
        x = x.astype(jnp.float32)
    return np.asarray(x)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(_np(x)))
    return t if dtype is None else t.to(dtype)


def _same_int8(got_q, got_s, want_q, want_s, what=""):
    """q8 equal element for element, scales bit-equal."""
    assert got_q.dtype == torch.int8, what
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q),
                                  err_msg=what)
    want_s = np.asarray(jnp.asarray(want_s).astype(jnp.float32))
    assert got_s.dtype == torch.float32, what
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  want_s.view(np.int32), err_msg=what)


def _jexperts(act, seed, dtype=jnp.float32, ffn=FF, d=D, e=E):
    cfg = jmoe.MoEConfig(dim=d, ffn_dim=ffn, num_experts=e, act=act)
    ex = jmoe.init_moe_params(jax.random.PRNGKey(seed), cfg)["experts"]
    rs = np.random.RandomState(seed)
    for b in ("b1", "b2"):  # random biases, so the bias paths count
        ex[b] = jnp.asarray(rs.randn(*ex[b].shape).astype(np.float32) * 0.1)
    return jax.tree.map(lambda a: a.astype(dtype), ex)


def _probs(seed, t=T, e=E):
    logits = np.random.RandomState(seed).randn(t, e).astype(np.float32) * 2
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


# ------------------------------------------------------------ quantisers


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_quantize_moe_experts_matches_jax(act, dtype):
    tdt, jdt = DTYPES[dtype]
    ex = _jexperts(act, seed=0, dtype=jdt, ffn=128, d=64)
    want = jmd.quantize_moe_experts(ex)
    got = md.quantize_moe_experts({k: _t(v, tdt) for k, v in ex.items()})
    for n in ("w1", "w2"):
        _same_int8(*got[n], *want[n], what=f"{act} {dtype} {n}")
        assert got[n][1].shape == want[n][1].shape
    for n in ("b1", "b2"):  # biases stay float, as they are
        assert got[n].dtype == tdt
        np.testing.assert_array_equal(got[n].float().numpy(), _np(want[n]))
    # and _dequant is the reference's
    np.testing.assert_array_equal(md._dequant(got["w1"]).numpy(),
                                  np.asarray(jmd._dequant(want["w1"])))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("quantizer,shape", [
    ("quantize_int8", (64, 96)),
    ("quantize_stacked_int8", (64, 96)),
    ("quantize_stacked_int8", (2, 3, 64, 48)),
])
def test_surgery_quantisers_match_jax(quantizer, shape, dtype):
    tdt, jdt = DTYPES[dtype]
    w = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = getattr(js, quantizer)(jnp.asarray(w).astype(jdt))
    got = getattr(ts, quantizer)(torch.from_numpy(w).to(tdt))
    _same_int8(got.q, got.scale, want.q, want.scale, what=quantizer)
    assert tuple(got.scale.shape) == want.scale.shape
    assert got.shape == got.q.shape and got.ndim == len(shape)
    assert got.nbytes == want.nbytes
    np.testing.assert_array_equal(ts.dequantize_int8(got).numpy(),
                                  np.asarray(js.dequantize_int8(want)))


@functools.lru_cache(maxsize=None)
def _gpt_trees():
    """JAX param trees of the three families the int8 serving path runs:
    the dense GPT (stacked fused wqkv), a GQA Llama (stacked wq / wkv,
    SwiGLU MLP) and a Mixtral-style MoE block list."""
    small = dict(vocab_size=64, dim=64, nheads=4, nlayers=2, max_seq=32)
    gpt = JGPTConfig(**small, dtype=jnp.float32)
    llama = jllama(**small, kv_heads=2, ffn_hidden=96, dtype=jnp.float32)
    mix = jllama(**small, kv_heads=2, ffn_hidden=96, dtype=jnp.float32,
                 moe_experts=4, moe_every=1)
    key = jax.random.PRNGKey(0)
    return {"gpt": (jinit(key, gpt), GPTConfig(**small)),
            "llama": (jinit(key, llama), llama_config(
                **small, kv_heads=2, ffn_hidden=96, dtype=torch.float32)),
            "mixtral_style": (jinit_moe(key, mix), llama_config(
                **small, kv_heads=2, ffn_hidden=96, dtype=torch.float32,
                moe_experts=4, moe_every=1))}


def _quantized_paths(tree, is_q):
    """Key paths of the int8 weight nodes, in the reference's form."""
    out = {}

    def walk(node, path):
        if is_q(node):
            out["/".join(path)] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
    walk(tree, [])
    return out


@pytest.mark.parametrize("family", ["gpt", "llama", "mixtral_style"])
@pytest.mark.parametrize("min_size", [1024, 16384])
def test_quantize_decode_params_matches_jax(family, min_size):
    """The same leaves quantised (key paths, ``min_size``, the experts /
    router skip), with ``q`` and ``scale`` equal; and ``params_from_jax``
    of JAX's quantised tree is the port's quantised tree."""
    jparams, tcfg = _gpt_trees()[family]
    want = js.quantize_decode_params(jparams, min_size=min_size)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    got = ts.quantize_decode_params(tparams, min_size=min_size)
    wq = _quantized_paths(want, lambda n: isinstance(n, js.QuantizedLinear))
    gq = _quantized_paths(got, lambda n: isinstance(n, ts.QuantizedLinear))
    assert set(gq) == set(wq)
    assert not any("experts" in k or "router" in k for k in gq)
    if min_size == 1024:  # at these widths every matmul weight
        names = {k.rsplit("/", 1)[-1] for k in gq}
        assert "head" in names and names <= set(ts.DECODE_WEIGHT_KEYS)
    for k, w in wq.items():
        _same_int8(gq[k].q, gq[k].scale, w.q, w.scale, what=k)
    carried = params_from_jax(jax.tree.map(np.asarray, want), tcfg,
                              device="cpu")
    cq = _quantized_paths(carried,
                          lambda n: isinstance(n, ts.QuantizedLinear))
    assert set(cq) == set(wq)
    for k, w in wq.items():
        _same_int8(cq[k].q, cq[k].scale, w.q, w.scale, what=k)
    # every leaf the sweep leaves alone stays the same tensor
    assert got["tok_emb"] is tparams["tok_emb"]
    # the key paths are the reference's key_str
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    jkeys = {jkey_str(p) for p, _ in flat}
    assert set(gq) <= jkeys


def test_quantize_params_int8_and_replace_params():
    w = torch.randn(64, 64)
    tree = {"a": w, "b": [torch.randn(8, 8), torch.randn(64, 80)],
            "c": (torch.randn(3, 64, 64),)}
    out = ts.quantize_params_int8(tree)
    assert isinstance(out["a"], ts.QuantizedLinear)
    assert out["b"][0] is tree["b"][0]  # under min_size
    assert isinstance(out["b"][1], ts.QuantizedLinear)
    assert isinstance(out["c"], tuple) and out["c"][0] is tree["c"][0]
    seen = []
    ts.replace_params(out, lambda k, v: seen.append(k) or False, None)
    assert seen == ["a/0", "a/1", "b/0", "b/1/0", "b/1/1", "c/0"]
    assert tree_bytes(out) == sum(t.numel() * t.element_size()
                                  for t in tree_leaves(out))
    assert tree_bytes(out["a"]) == out["a"].nbytes == 64 * 64 + 64 * 4
    with pytest.raises(IndexError, match="stack dims"):
        out["a"][0]


# ----------------------------------------------------------------- dense


@pytest.mark.parametrize("shape", [(64, 96), (3, 64, 64), (2, 64, 32)])
def test_dense_int8_matches_jax(shape):
    """The port's ``dense`` on a QuantizedLinear against JAX's, in f32:
    a 2-D weight, and the stacked ``wqkv`` / ``wkv`` forms through the
    port's indexing (JAX indexes the same pytree)."""
    rs = np.random.RandomState(2)
    w = rs.randn(*shape).astype(np.float32)
    x = rs.randn(2, 5, 64).astype(np.float32)
    b = rs.randn(shape[-1]).astype(np.float32)
    jq = js.quantize_stacked_int8(jnp.asarray(w))
    tq = ts.quantize_stacked_int8(torch.from_numpy(w))
    pairs = ([(jq, tq)] if len(shape) == 2 else
             [(js.QuantizedLinear(jq.q[i], jq.scale[i]), tq[i])
              for i in range(shape[0])])
    for jw, tw in pairs:
        want = np.asarray(jdense(jnp.asarray(x), jw))
        got = dense(torch.from_numpy(x), tw)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            dense(torch.from_numpy(x), tw, torch.from_numpy(b)).numpy(),
            want + b, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ts.int8_matmul(torch.from_numpy(x),
                                                  tw).numpy(),
                                   np.asarray(js.int8_matmul(
                                       jnp.asarray(x), jw)),
                                   rtol=1e-6, atol=1e-6)


def test_block_projections_take_int8_stacked_leaves():
    """``compute_qkv`` (fused ``wqkv`` and GQA ``wq`` / ``wkv``) and
    ``mlp_partial`` (SwiGLU ``[2, D, F]``) on int8 leaves equal the same
    functions on the dequantised float weights, to f32 rounding."""
    from torchdistpackage_tpu_torch.parallel.tensor_parallel.layers import (
        TransformerConfig,
    )

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 64, generator=g)
    for cfg, p in (
            (TransformerConfig(dim=64, nheads=4),
             {"wqkv": torch.randn(3, 64, 64, generator=g),
              "bqkv": torch.randn(3, 64, generator=g)}),
            (TransformerConfig(dim=64, nheads=4, kv_heads=2, rope=True),
             {"wq": torch.randn(64, 64, generator=g),
              "bq": torch.randn(64, generator=g),
              "wkv": torch.randn(2, 64, 32, generator=g),
              "bkv": torch.randn(2, 32, generator=g)})):
        q = {k: ts.quantize_stacked_int8(v) if k[0] == "w" else v
             for k, v in p.items()}
        f = {k: ts.dequantize_int8(v) if k[0] == "w" else v
             for k, v in q.items()}
        for a, b in zip(compute_qkv(q, x, cfg), compute_qkv(f, x, cfg)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5)
    mlp = {"w1": torch.randn(2, 64, 96, generator=g),
           "b1": torch.randn(2, 96, generator=g),
           "w2": torch.randn(96, 64, generator=g)}
    q = {k: ts.quantize_stacked_int8(v) if k[0] == "w" else v
         for k, v in mlp.items()}
    f = {k: ts.dequantize_int8(v) if k[0] == "w" else v for k, v in q.items()}
    np.testing.assert_allclose(mlp_partial(q, x).numpy(),
                               mlp_partial(f, x).numpy(), rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------- K6's int8 plain version


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
@pytest.mark.parametrize("capacity", [T, 7])
def test_int8_plain_matches_jax_oracle(act, capacity):
    """K6's wrapper on CPU tensors (its plain version) and the port's
    ``moe_ffn_oracle`` on ``quantize_moe_experts`` leaves against JAX's
    ``moe_ffn_oracle`` on JAX's leaves, at the no-drop capacity C = T and
    with drops (C 7)."""
    ex = _jexperts(act, seed=1)
    jq = jmd.quantize_moe_experts(ex)
    tq = md.quantize_moe_experts({k: _t(v) for k, v in ex.items()})
    x = np.random.RandomState(2).randn(T, D).astype(np.float32)
    route = jmoe._top_k_route(jnp.asarray(_probs(3)), K, capacity)
    want = np.asarray(jmd.moe_ffn_oracle(jq, jnp.asarray(x), *route,
                                         capacity))
    troute = [torch.from_numpy(np.array(a)) for a in route]
    got = md.moe_ffn_oracle(tq, torch.from_numpy(x), *troute, capacity)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    before = dict(md.LAUNCHES)
    fused = md.fused_moe_ffn(tq, torch.from_numpy(x), *troute, capacity)
    np.testing.assert_allclose(fused.numpy(), want, rtol=RTOL, atol=ATOL)
    assert md.LAUNCHES == before  # CPU tensors: the plain version
    # the int8 model is not the float model: quantisation moved it
    fwant = np.asarray(jmd.moe_ffn_oracle(ex, jnp.asarray(x), *route,
                                          capacity))
    assert 0 < np.abs(fwant - want).max() < 0.05 * np.abs(fwant).max()


def test_int8_rounding_scale_uses_dequantised_weights():
    ex = _jexperts("swiglu", seed=4)
    tq = md.quantize_moe_experts({k: _t(v) for k, v in ex.items()})
    deq = dict(tq, w1=md._dequant(tq["w1"]), w2=md._dequant(tq["w2"]))
    x = torch.from_numpy(np.random.RandomState(5).randn(T, D)
                         .astype(np.float32))
    idx, comb = md.slot_maps(*tmoe._top_k_route(
        torch.from_numpy(_probs(6)), K, T), T)
    np.testing.assert_array_equal(
        md.moe_rounding_scale(tq, x, idx, comb).numpy(),
        md.moe_rounding_scale(deq, x, idx, comb).numpy())


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_serve_forward_int8_arms(act):
    """The ``'cuda'`` arm (K6's plain version on the CPU) serves int8
    experts and equals JAX's ragged arm run on the ``_dequant``-ed f32
    experts; the ``'gather'`` arm refuses int8 leaves with an error that
    names ``'cuda'``, where JAX's ragged arm dies with an AttributeError."""
    p = jax.tree.map(np.asarray, {
        "router": {"w": jax.random.normal(jax.random.PRNGKey(7), (D, E))
                   * D ** -0.5},
        "experts": _jexperts(act, seed=8)})
    jq = jmd.quantize_moe_experts(jax.tree.map(jnp.asarray, p["experts"]))
    jdeq = dict(jq, w1=jmd._dequant(jq["w1"]), w2=jmd._dequant(jq["w2"]))
    x = np.random.RandomState(9).randn(2, T // 2, D).astype(np.float32)
    jcfg = jmoe.MoEConfig(dim=D, ffn_dim=FF, num_experts=E, act=act)
    want, jmet = jmoe.moe_serve_forward(
        {"router": {"w": jnp.asarray(p["router"]["w"])}, "experts": jdeq},
        jnp.asarray(x), jcfg, dispatch="gather", return_metrics=True)
    tcfg = tmoe.MoEConfig(dim=D, ffn_dim=FF, num_experts=E, act=act)
    tp = {"router": {"w": _t(p["router"]["w"])},
          "experts": {k: (tuple(_t(a) for a in v) if isinstance(v, tuple)
                          else _t(v)) for k, v in jq.items()}}
    got, met = tmoe.moe_serve_forward(tp, torch.from_numpy(x), tcfg,
                                      dispatch="cuda", return_metrics=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(met["expert_tokens"].numpy(),
                                  np.asarray(jmet["expert_tokens"]))
    with pytest.raises(TypeError, match="'cuda'"):
        tmoe.moe_serve_forward(tp, torch.from_numpy(x), tcfg,
                               dispatch="gather")
    with pytest.raises(AttributeError):  # the reference gap it replaces
        jmoe.moe_serve_forward(
            {"router": {"w": jnp.asarray(p["router"]["w"])}, "experts": jq},
            jnp.asarray(x), jcfg, dispatch="gather")


def test_wrapper_refuses_an_int8_float_mix_on_any_device():
    ex = md.quantize_moe_experts({k: _t(v) for k, v in
                                  _jexperts("swiglu", seed=10).items()})
    x = torch.randn(T, D)
    idx, comb = md.slot_maps(*tmoe._top_k_route(
        torch.from_numpy(_probs(11)), K, T), T)
    for mix in (dict(ex, w2=md._dequant(ex["w2"])),
                dict(ex, w1=md._dequant(ex["w1"]))):
        with pytest.raises(NotImplementedError, match="int8"):
            md.fused_moe_ffn_slots(mix, x, idx, comb)
    off = dict(ex, w2=(ex["w2"][0], ex["w2"][1].to("meta")))
    with pytest.raises(ValueError, match="device"):
        md.fused_moe_ffn_slots(off, x, idx, comb)


# ------------------------------------------------------- params_from_jax


def test_params_from_jax_carries_int8_leaves_exactly():
    """``(q8, scale)`` expert pairs stay tuples of int8 / f32 tensors and
    QuantizedLinear nodes become the port's, every value bit-exact, while
    float leaves take the config's dtype."""
    jparams = jax.tree.map(lambda a: a, _gpt_trees()["mixtral_style"][0])
    for b in jparams["blocks"]:
        b["moe"]["experts"] = jmd.quantize_moe_experts(b["moe"]["experts"])
    jparams = js.quantize_decode_params(jparams, min_size=1024)
    np_params = jax.tree.map(np.asarray, jparams)
    for dt in (torch.float32, torch.bfloat16):
        tcfg = llama_config(vocab_size=64, dim=64, nheads=4, nlayers=2,
                            max_seq=32, kv_heads=2, ffn_hidden=96, dtype=dt,
                            moe_experts=4, moe_every=1)
        tp = params_from_jax(np_params, tcfg, device="cpu")
        for jb, tb in zip(np_params["blocks"], tp["blocks"]):
            for n in ("w1", "w2"):
                q, s = tb["moe"]["experts"][n]
                assert isinstance(tb["moe"]["experts"][n], tuple)
                assert (q.dtype, s.dtype) == (torch.int8, torch.float32)
                _same_int8(q, s, *jb["moe"]["experts"][n])
            assert tb["moe"]["experts"]["b1"].dtype == dt
            assert tb["moe"]["router"]["w"].dtype == dt
            for n in ("wq", "wkv", "wo"):
                w = tb["attn"][n]
                assert isinstance(w, ts.QuantizedLinear)
                _same_int8(w.q, w.scale, jb["attn"][n].q, jb["attn"][n].scale)
        assert isinstance(tp["head"], ts.QuantizedLinear)
        assert tp["tok_emb"].dtype == dt
    with pytest.raises(TypeError, match="int8"):
        params_from_jax(dict(np_params, ln_f=(np.ones(3), np.ones(3))),
                        tcfg, device="cpu")
