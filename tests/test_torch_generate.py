"""The port's ``generate()`` family against the JAX package, on the CPU,
in f32 at small widths (2 layers, d 64): ``init_kv_cache`` and
``_cache_write`` (exact), ``forward_cached`` and ``forward_cached_moe``
logits (atol 2e-5), ``_sample``'s filters (the surviving support set),
greedy ``generate`` and ``beam_generate`` tokens EQUAL to JAX's,
``speculative_generate`` EQUAL to the port's own greedy ``generate`` for
every draft, the reference's guards, and ``forward_cached_moe(ep_group=)``
at world 4 over gloo against the serial port.

Weights come from JAX's init through ``params_from_jax``; prompts from
numpy seeds.  Three families: a GPT (learned positions, LayerNorm, GELU),
a Llama with GQA and a 24-position window (shorter than the longest
prompt), and a Mixtral-style MoE (SwiGLU experts in every block).  The
JAX runs are cached per (family, prompt length, options) in a module
fixture.  The prefill at offset 0 goes through ``core_attention``: the
plain ``'naive'`` attention on both sides here (flash K3 on the card).
"""

import dataclasses
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import init_gpt_moe_params as jinit_moe
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.models import llama_config as jllama
from torchdistpackage_tpu.models.generate import (
    _cache_write as j_cache_write,
)
from torchdistpackage_tpu.models.generate import (
    init_kv_cache as j_init_kv_cache,
)
from torchdistpackage_tpu_torch.models import (
    GPTConfig,
    beam_generate,
    forward_cached,
    forward_cached_moe,
    generate,
    init_kv_cache,
    llama_config,
    speculative_generate,
)
from torchdistpackage_tpu_torch.models.convert import params_from_jax
from torchdistpackage_tpu_torch.tools.surgery import quantize_decode_params

SMALL = dict(vocab_size=64, dim=64, nheads=4, nlayers=2, max_seq=96)
LLAMA = dict(SMALL, kv_heads=2, ffn_hidden=96, sliding_window=24)
MOE = dict(SMALL, kv_heads=2, ffn_hidden=96, moe_experts=4, moe_every=1)
FAMILIES = {
    "gpt": (lambda: JGPTConfig(**SMALL, dtype=jnp.float32),
            lambda: GPTConfig(**SMALL, dtype=torch.float32), jinit),
    "llama": (lambda: jllama(**LLAMA, dtype=jnp.float32),
              lambda: llama_config(**LLAMA, dtype=torch.float32), jinit),
    "moe": (lambda: jllama(**MOE, dtype=jnp.float32),
            lambda: llama_config(**MOE, dtype=torch.float32), jinit_moe),
}
PROMPT_LENS = (1, 37, 64)
NEW = 8
LOGIT_TOL = 2e-5  # f32 through 2 layers: summation order only
# the modules (the packages export functions of the same name)
jgen_mod = importlib.import_module("torchdistpackage_tpu.models.generate")
tgen_mod = importlib.import_module(
    "torchdistpackage_tpu_torch.models.generate")
WORKER = os.path.join(os.path.dirname(__file__), "_torch_generate_worker.py")


def _prompt(n, batch=2, seed=0):
    return np.random.RandomState(seed + n).randint(0, 64, (batch, n))


@pytest.fixture(scope="module")
def families():
    out = {}
    for name, (jcfg_fn, tcfg_fn, init) in FAMILIES.items():
        jcfg, tcfg = jcfg_fn(), tcfg_fn()
        jparams = init(jax.random.PRNGKey(0), jcfg)
        np_params = jax.tree.map(np.asarray, jparams)
        out[name] = {"jcfg": jcfg, "tcfg": tcfg, "jparams": jparams,
                     "np": np_params,
                     "tparams": params_from_jax(np_params, tcfg,
                                                device="cpu")}
    return out


@pytest.fixture(scope="module")
def jax_runs(families):
    """JAX's greedy ``generate`` per (family, prompt length, kv_quant),
    computed once."""
    memo = {}

    def run(family, n, kv_quant=False):
        key = (family, n, kv_quant)
        if key not in memo:
            f = families[family]
            memo[key] = np.asarray(jgen_mod.generate(
                f["jparams"], jnp.asarray(_prompt(n)), f["jcfg"], NEW,
                kv_quant=kv_quant))
        return memo[key]
    return run


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(a) for a in x)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ the cache


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_init_kv_cache_and_cache_write_equal_jax(families, quantized):
    """Shapes, dtypes and values exactly; a write at offset 3 of 5
    positions (the int8 pair through ``_kv_quant``), in place."""
    f = families["llama"]
    jc = j_init_kv_cache(f["jcfg"], 2, 12, quantized=quantized)
    tc = init_kv_cache(f["tcfg"], 2, 12, quantized=quantized, device="cpu")
    for name in ("k", "v"):
        for got, want in zip(jax.tree.leaves(_np(tc[name])),
                             jax.tree.leaves(_np(jc[name]))):
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    val = np.random.RandomState(3).randn(2, 2, 5, 16).astype(np.float32) * 3
    jl = jax.tree.map(lambda a: a[0], jc["k"])
    tl = tgen_mod._layer_cache(tc["k"], 0)
    want = j_cache_write(jl, jnp.asarray(val), 3)
    got = tgen_mod._cache_write(tl, torch.from_numpy(val), 3)
    assert got is tl  # in place
    for g, w in zip(jax.tree.leaves(_np(got)), jax.tree.leaves(_np(want))):
        np.testing.assert_array_equal(g, w)
    # the write landed in the stacked cache itself
    np.testing.assert_array_equal(
        jax.tree.leaves(_np(tc["k"]))[0][0], jax.tree.leaves(_np(got))[0])


# ----------------------------------------------------------- the forwards


@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["dense", "int8"])
def test_forward_cached_logits_match_jax(families, family, kv_quant):
    """A 37-row prefill at offset 0 (core_attention), a 1-row decode at
    37, then a 3-row step at 38 with ``all_logits`` (the speculative
    verify's shape): logits within 2e-5."""
    f = families[family]
    toks = _prompt(41)
    jc = j_init_kv_cache(f["jcfg"], 2, 48, quantized=kv_quant)
    tc = init_kv_cache(f["tcfg"], 2, 48, quantized=kv_quant, device="cpu")
    steps = ((0, 37, False), (37, 38, False), (38, 41, True))
    for off, end, every in steps:
        jc, jl = jgen_mod.forward_cached(
            f["jparams"], jnp.asarray(toks[:, off:end]), f["jcfg"], jc, off,
            all_logits=every)
        tc, tl = forward_cached(f["tparams"], torch.from_numpy(
            toks[:, off:end]), f["tcfg"], tc, off, all_logits=every)
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)


def test_forward_cached_moe_logits_match_jax(families):
    f = families["moe"]
    toks = _prompt(40)
    jc = j_init_kv_cache(f["jcfg"], 2, 48)
    tc = init_kv_cache(f["tcfg"], 2, 48, device="cpu")
    for off, end in ((0, 37), (37, 38), (38, 40)):
        jc, jl = jgen_mod.forward_cached_moe(
            f["jparams"], jnp.asarray(toks[:, off:end]), f["jcfg"], jc, off)
        tc, tl = forward_cached_moe(f["tparams"], torch.from_numpy(
            toks[:, off:end]), f["tcfg"], tc, off)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)


# ------------------------------------------------------------ sampling


SAMPLE_CASES = {"top_k": (5, None), "top_p": (None, 0.8),
                "both": (7, 0.6), "top_p_0": (None, 0.0),
                "k_past_vocab": (100, None), "none": (None, None)}


@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_sample_filter_keeps_jax_support(case, monkeypatch):
    """The distribution ``_sample`` draws from, against the logits JAX's
    ``_sample`` hands ``jax.random.categorical`` (captured): the same
    surviving support set, the same values on it."""
    top_k, top_p = SAMPLE_CASES[case]
    logits = np.random.RandomState(5).randn(4, 64).astype(np.float32) * 2
    seen = []

    def capture(key, x, axis=-1):
        seen.append(np.asarray(x))
        return jnp.argmax(x, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jgen_mod._sample(jnp.asarray(logits), jax.random.PRNGKey(0), 0.7,
                     top_k, top_p)
    got = tgen_mod._sample_filter(torch.from_numpy(logits), 0.7, top_k,
                                  top_p).numpy()
    want = seen[0]
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    keep = np.isfinite(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)
    if case == "top_p_0":  # top_p -> 0 degrades to greedy
        assert (keep.sum(-1) == 1).all()
        assert (np.argmax(np.where(keep, 1, 0), -1)
                == np.argmax(logits, -1)).all()


def test_sample_draws_inside_the_support_and_replays():
    logits = torch.from_numpy(
        np.random.RandomState(6).randn(3, 64).astype(np.float32))
    keep = torch.isfinite(tgen_mod._sample_filter(logits, 0.9, 4, None))

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return torch.stack([tgen_mod._sample(logits, g, 0.9, top_k=4)
                            for _ in range(20)])

    a, b = draw(1), draw(1)
    assert torch.equal(a, b)
    assert keep.gather(1, a.t()).all()
    # greedy: no generator, or temperature 0
    assert torch.equal(tgen_mod._sample(logits, None, 0.9),
                       logits.argmax(-1))
    assert torch.equal(tgen_mod._sample(logits, torch.Generator(), 0.0),
                       logits.argmax(-1))


# -------------------------------------------------------- the generators


@pytest.mark.parametrize("n", PROMPT_LENS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_greedy_generate_equals_jax(families, jax_runs, family, n):
    f = families[family]
    got = generate(f["tparams"], torch.from_numpy(_prompt(n)), f["tcfg"],
                   NEW, device="cpu")
    assert got.shape == (2, n + NEW) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), jax_runs(family, n))


@pytest.mark.parametrize("n", PROMPT_LENS)
def test_greedy_generate_kv_quant_equals_jax(families, jax_runs, n):
    f = families["llama"]
    got = generate(f["tparams"], torch.from_numpy(_prompt(n)), f["tcfg"],
                   NEW, kv_quant=True, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  jax_runs("llama", n, kv_quant=True))


def test_sampled_generate_replays_from_its_generator(families):
    f = families["llama"]
    prompt = torch.from_numpy(_prompt(9))

    def run(seed):
        return generate(f["tparams"], prompt, f["tcfg"], NEW,
                        generator=torch.Generator().manual_seed(seed),
                        temperature=0.8, top_k=10, top_p=0.9, device="cpu")

    a = run(3)
    assert torch.equal(a, run(3))
    assert torch.equal(a[:, :9], prompt.long())


def _drafts(f):
    adversarial = params_from_jax(
        jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(99), f["jcfg"])),
        f["tcfg"], device="cpu")
    return {"self": f["tparams"],
            "int8": quantize_decode_params(f["tparams"], min_size=512),
            "adversarial": adversarial}


@pytest.mark.parametrize("draft", ["self", "int8", "adversarial"])
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_speculative_equals_greedy_generate(families, family, draft):
    """Lossless: whatever the draft proposes, the tokens are the port's
    greedy ``generate``'s (which equals JAX's, above)."""
    f = families[family]
    prompt = torch.from_numpy(_prompt(11, batch=1))
    want = generate(f["tparams"], prompt, f["tcfg"], 16, device="cpu")
    got = speculative_generate(f["tparams"], _drafts(f)[draft], prompt,
                               f["tcfg"], 16, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_speculative_kv_quant_and_seven_drafts(families):
    f = families["llama"]
    prompt = torch.from_numpy(_prompt(11, batch=1))
    want = generate(f["tparams"], prompt, f["tcfg"], 16, device="cpu")
    got = speculative_generate(
        f["tparams"], _drafts(f)["int8"], prompt, f["tcfg"], 16,
        num_draft=7, kv_quant=True, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_speculative_caches_the_last_draft(families):
    """The K+1 fix (ROADMAP C): with the target as its own draft every
    one of the K drafts is accepted, and the draft cache's position t+K
    then holds the last draft's K/V — equal to what a plain forward of
    that token writes — where JAX's K-step scan leaves zeros."""
    f = families["llama"]
    cfg, p = f["tcfg"], f["tparams"]
    K, P = 3, 11
    prompt = torch.from_numpy(_prompt(P, batch=1)).long()
    total = P + 16
    cache_v = init_kv_cache(cfg, 1, total, device="cpu")
    cache_d = init_kv_cache(cfg, 1, total, device="cpu")
    tokens = torch.zeros(1, total, dtype=torch.long)
    tokens[:, :P] = prompt
    cache_v, lg = forward_cached(p, prompt, cfg, cache_v, 0)
    cache_d, _ = forward_cached(p, prompt, cfg, cache_d, 0)
    tokens[:, P] = lg.argmax(-1)
    cache_v, cache_d, n = tgen_mod._spec_macro_step(
        p, p, cfg, cfg, tokens, cache_v, cache_d, P, K)
    assert n == K
    ref = init_kv_cache(cfg, 1, total, device="cpu")
    ref, _ = forward_cached(p, tokens[:, :P + K + 1], cfg, ref, 0)
    last = P + K
    assert cache_d["k"][:, :, :, last].abs().sum() > 0
    for name in ("k", "v"):
        np.testing.assert_allclose(cache_d[name][:, :, :, last].numpy(),
                                   ref[name][:, :, :, last].numpy(),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("return_all", [False, True])
@pytest.mark.parametrize("family", ["gpt", "moe"])
def test_beam_generate_equals_jax(families, family, return_all):
    f = families[family]
    prompt = _prompt(9, batch=1)
    want = np.asarray(jgen_mod.beam_generate(
        f["jparams"], jnp.asarray(prompt), f["jcfg"], 6, num_beams=3,
        return_all=return_all))
    got = beam_generate(f["tparams"], torch.from_numpy(prompt), f["tcfg"],
                        6, num_beams=3, return_all=return_all, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_beam_kv_quant_and_width_one_is_greedy(families):
    f = families["llama"]
    prompt = _prompt(9, batch=1)
    want = np.asarray(jgen_mod.beam_generate(
        f["jparams"], jnp.asarray(prompt), f["jcfg"], 6, num_beams=3,
        kv_quant=True))
    got = beam_generate(f["tparams"], torch.from_numpy(prompt), f["tcfg"],
                        6, num_beams=3, kv_quant=True, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    one = beam_generate(f["tparams"], torch.from_numpy(prompt), f["tcfg"],
                        6, num_beams=1, device="cpu")
    greedy = generate(f["tparams"], torch.from_numpy(prompt), f["tcfg"], 6,
                      device="cpu")
    assert torch.equal(one, greedy)


# ------------------------------------------------------------ the guards


def test_guards_raise_with_the_reference_messages(families):
    f = families["gpt"]
    cfg, p = f["tcfg"], f["tparams"]
    one = torch.zeros(1, 4, dtype=torch.long)
    cases = [
        (ValueError, "max_new_tokens must be >= 1",
         lambda: generate(p, one, cfg, 0, device="cpu")),
        (ValueError, "exceeds the learned position table",
         lambda: generate(p, one, cfg, 93, device="cpu")),
        (NotImplementedError, "context-parallel decode is not supported",
         lambda: generate(p, one, dataclasses.replace(cfg, attn_impl="ring"),
                          2, device="cpu")),
        (ValueError, "only meaningful for MoE configs",
         lambda: generate(p, one, cfg, 2, ep_group=object(), device="cpu")),
        (ValueError, "only meaningful for MoE configs",
         lambda: generate(p, one, cfg, 2, tp_group=object(),
                          ep_group=object(), device="cpu")),
        (ValueError, "B == 1",
         lambda: speculative_generate(p, p, torch.zeros(2, 4, dtype=int),
                                      cfg, 4, device="cpu")),
        (ValueError, "num_draft must be >= 1",
         lambda: speculative_generate(p, p, one, cfg, 4, num_draft=0,
                                      device="cpu")),
        (ValueError, "share a vocabulary",
         lambda: speculative_generate(
             p, p, one, cfg, 4, draft_cfg=dataclasses.replace(
                 cfg, vocab_size=65), device="cpu")),
        (ValueError, "num_draft \\+ 1 = 97 exceeds",
         lambda: speculative_generate(p, p, one, cfg, 88, device="cpu")),
        (NotImplementedError, "supports the dense families",
         lambda: speculative_generate(
             families["moe"]["tparams"], families["moe"]["tparams"], one,
             families["moe"]["tcfg"], 4, device="cpu")),
        (ValueError, "beam search is B == 1",
         lambda: beam_generate(p, torch.zeros(2, 4, dtype=int), cfg, 4,
                               device="cpu")),
        (ValueError, "num_beams must be >= 1",
         lambda: beam_generate(p, one, cfg, 4, num_beams=0, device="cpu")),
        (ValueError, "top_k must be >= 1",
         lambda: tgen_mod._sample(torch.zeros(1, 4), None, 1.0, top_k=0)),
        (ValueError, "temperature must be >= 0",
         lambda: tgen_mod._sample(torch.zeros(1, 4), torch.Generator(),
                                  -1.0)),
    ]
    for exc, match, fn in cases:
        with pytest.raises(exc, match=match):
            fn()


def test_entry_points_default_to_the_card(families):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    f = families["gpt"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(f["tparams"], torch.zeros(1, 4, dtype=torch.long),
                 f["tcfg"], 2)


# ----------------------------------------------------- expert parallel


def test_ep_forward_cached_moe_world4_matches_serial(tmp_path):
    """``forward_cached_moe(ep_group=)`` and greedy ``generate(ep_group=)``
    at world 4 over gloo (JAX-free workers, 8 experts so a rank holds 2,
    each rank its own prompt), held against the serial port on the full
    weights: logits within 2e-5, tokens equal."""
    sys.path.insert(0, os.path.dirname(__file__))
    import _torch_generate_worker as W

    jcfg = jllama(**W.EP_MOE, dtype=jnp.float32)
    tcfg = llama_config(**W.EP_MOE, dtype=torch.float32)
    np_params = jax.tree.map(np.asarray, jinit_moe(jax.random.PRNGKey(2),
                                                   jcfg))
    np.savez(tmp_path / "in.npz", **W.flatten(np_params))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(W.WORLD),
         f"file://{tmp_path / 'store'}", str(tmp_path / "in.npz"),
         str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(W.WORLD)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=240)[0].decode())
    finally:
        for proc in procs:
            proc.kill()
    for r, proc in enumerate(procs):
        assert proc.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    params = params_from_jax(np_params, tcfg, device="cpu")
    for r in range(W.WORLD):
        got = np.load(tmp_path / f"rank{r}.npz")
        prompt = torch.from_numpy(W.rank_prompt(r))
        cache = init_kv_cache(tcfg, 1, W.P + W.NEW, device="cpu")
        cache, lg = forward_cached_moe(params, prompt, tcfg, cache, 0)
        np.testing.assert_allclose(got["prefill"], lg.numpy(),
                                   atol=LOGIT_TOL, rtol=0)
        want = generate(params, prompt, tcfg, W.NEW, device="cpu")
        np.testing.assert_array_equal(got["tokens"], want.numpy())
