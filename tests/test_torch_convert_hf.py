"""The port's HF converters (``models/convert.py``: ``from_hf_llama``,
``from_hf_gpt2``, ``to_hf_llama`` and the config maps) against the JAX
package's and against ``transformers`` itself, on the CPU.

- The port's import of a random-init HF state dict equals
  ``params_from_jax`` of JAX's import of the same dict, leaf for leaf and
  bit for bit (both are copies of the same f32 values).
- The port's f32 logits agree with the HF forward within 1e-4 (plus 1e-4
  relative: the two sum in other orders), greedy decoding through the
  port's ``generate`` gives HF's ``generate`` tokens exactly, and
  ``to_hf_llama`` then ``from_hf_llama`` gives every leaf back bit for
  bit.
- Tied embeddings, bias checkpoints, each rope scaling JAX accepts, a
  windowed Mistral, and the refusals; a plain dict of the config's
  fields converts as the config object does.

Skipped where ``transformers`` is missing; the models are random-init
and built here (no download).
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from torchdistpackage_tpu.models import convert as jconv  # noqa: E402
from torchdistpackage_tpu_torch.models import (  # noqa: E402
    from_hf_gpt2,
    from_hf_llama,
    generate,
    gpt2_config_from_hf,
    gpt_forward,
    llama_config_from_hf,
    params_from_jax,
    to_hf_llama,
)
from torchdistpackage_tpu_torch.obs.numerics import tree_paths  # noqa: E402

B, S = 2, 16
#: logits against transformers' forward in f32: the two sum in other
#: orders (and the attention's softmax another way), ~1e-6 apart here
TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
             num_hidden_layers=2, num_attention_heads=4,
             max_position_embeddings=64, rms_norm_eps=1e-5)


def _llama(seed=0, **kw):
    cfg = transformers.LlamaConfig(**{**SMALL, "num_key_value_heads": 2,
                                      "attention_bias": False,
                                      "tie_word_embeddings": False, **kw})
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(cfg).eval()


def _gpt2(seed=7, **kw):
    cfg = transformers.GPT2Config(
        vocab_size=128, n_embd=64, n_layer=2, n_head=4, n_positions=64,
        n_inner=None, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, **kw)
    torch.manual_seed(seed)
    return transformers.GPT2LMHeadModel(cfg).eval()


def _tokens(seed, shape=(B, S)):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 128, size=shape))


def _hf_logits(hf, tokens):
    with torch.no_grad():
        return hf(tokens).logits


def _port_logits(params, tokens, cfg):
    with torch.no_grad():
        return gpt_forward(params, tokens, cfg)


def _leaves(tree):
    return {"/".join(map(str, p)): t for p, t in tree_paths(tree)}


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _randomize(hf, seed):
    torch.manual_seed(seed)
    with torch.no_grad():
        for _, p in hf.named_parameters():
            p.normal_(0.0, 0.05)
    return hf


# ----------------------------------------------------- against the JAX import


@pytest.mark.parametrize("kv", [2, 4], ids=["gqa", "mha"])
def test_llama_import_equals_jax_import(kv):
    """The port's tree is JAX's tree carried over by ``params_from_jax``,
    bit for bit, and the configs agree field by field."""
    import jax.numpy as jnp

    hf = _llama(num_key_value_heads=kv)
    sd = hf.state_dict()
    cfg, params = from_hf_llama(sd, hf_config=hf.config,
                                dtype=torch.float32, device="cpu")
    jcfg, jparams = jconv.from_hf_llama(sd, hf_config=hf.config,
                                        dtype=jnp.float32)
    for f in ("vocab_size", "dim", "nheads", "nlayers", "max_seq",
              "kv_heads", "ffn_hidden", "rope_theta", "norm_eps", "norm",
              "act", "pos", "sliding_window", "rope_scaling"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    want = params_from_jax({k: np.asarray(v) if not isinstance(v, dict)
                            else v for k, v in _np_tree(jparams).items()},
                           cfg, device="cpu")
    _assert_trees_equal(params, want)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_gpt2_import_equals_jax_import():
    import jax.numpy as jnp

    hf = _gpt2()
    sd = hf.state_dict()
    cfg, params = from_hf_gpt2(sd, hf_config=hf.config, device="cpu")
    jcfg, jparams = jconv.from_hf_gpt2(sd, hf_config=hf.config,
                                       dtype=jnp.float32)
    assert (cfg.dim, cfg.ffn_hidden, cfg.norm_eps, cfg.pos) == (
        jcfg.dim, jcfg.ffn_hidden, jcfg.norm_eps, jcfg.pos)
    _assert_trees_equal(params, params_from_jax(_np_tree(jparams), cfg,
                                                device="cpu"))


# ------------------------------------------------------ against transformers


@pytest.mark.parametrize("kv", [2, 4], ids=["gqa", "mha"])
def test_llama_logits_parity(kv):
    hf = _llama(num_key_value_heads=kv)
    tokens = _tokens(1)
    cfg, params = from_hf_llama(hf.state_dict(), hf_config=hf.config,
                                dtype=torch.float32, device="cpu")
    assert (cfg.kv_heads is None) == (kv == 4)
    torch.testing.assert_close(_port_logits(params, tokens, cfg),
                               _hf_logits(hf, tokens), **TOL)


def test_llama_greedy_decode_matches_hf_and_dict_config():
    """The port's KV-cache ``generate`` on HF-imported weights gives
    transformers' greedy tokens; the config as a plain dict of its fields
    imports the same tree."""
    hf = _llama()
    prompt = _tokens(2, (1, 8))
    with torch.no_grad():
        want = hf.generate(prompt, max_new_tokens=12, do_sample=False,
                           num_beams=1)
    cfg, params = from_hf_llama(hf.state_dict(), hf_config=hf.config,
                                dtype=torch.float32, device="cpu")
    got = generate(params, prompt, cfg, max_new_tokens=12, device="cpu")
    assert torch.equal(got, want)
    dcfg, dparams = from_hf_llama(hf.state_dict(),
                                  hf_config=hf.config.to_dict(),
                                  dtype=torch.float32, device="cpu")
    assert dcfg == cfg
    _assert_trees_equal(dparams, params)


def test_tied_embeddings_fallback():
    hf = _llama()
    sd = {k: v for k, v in hf.state_dict().items() if k != "lm_head.weight"}
    _, params = from_hf_llama(sd, hf_config=hf.config, dtype=torch.float32,
                              device="cpu")
    assert torch.equal(params["head"], params["tok_emb"].t())


def test_attention_bias_checkpoint_loads_biases():
    hf = _llama(seed=3, attention_bias=True)
    with torch.no_grad():  # random init biases are zero: make them real
        for layer in hf.model.layers:
            for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
                getattr(layer.self_attn, proj).bias.normal_(0.0, 0.1)
    tokens = _tokens(4)
    cfg, params = from_hf_llama(hf.state_dict(), hf_config=hf.config,
                                dtype=torch.float32, device="cpu")
    assert params["blocks"]["attn"]["bq"].abs().max() > 0
    torch.testing.assert_close(_port_logits(params, tokens, cfg),
                               _hf_logits(hf, tokens), **TOL)


ROPE_SCALINGS = [
    ({"rope_type": "llama3", "factor": 4.0, "low_freq_factor": 1.0,
      "high_freq_factor": 4.0, "original_max_position_embeddings": 16}, 48),
    ({"rope_type": "linear", "factor": 2.0}, 48),
    ({"rope_type": "yarn", "factor": 4.0,
      "original_max_position_embeddings": 16}, 48),
    ({"rope_type": "yarn", "factor": 4.0, "beta_fast": 16.0,
      "beta_slow": 2.0, "attention_factor": 1.3,
      "original_max_position_embeddings": 16}, 48),
    ({"rope_type": "dynamic", "factor": 4.0}, 48),
    ({"rope_type": "dynamic", "factor": 4.0}, 80),
]


@pytest.mark.parametrize("scaling,seq", ROPE_SCALINGS, ids=[
    "llama3", "linear", "yarn", "yarn-mscale", "dynamic", "dynamic-long"])
def test_rope_scaling_logits_parity(scaling, seq):
    hf = _llama(seed=5, rope_scaling=dict(scaling))
    tokens = _tokens(6, (B, seq))
    cfg, params = from_hf_llama(hf.state_dict(), hf_config=hf.config,
                                dtype=torch.float32, device="cpu")
    assert cfg.rope_scaling is not None
    torch.testing.assert_close(_port_logits(params, tokens, cfg),
                               _hf_logits(hf, tokens), **TOL)


def test_yarn_checkpoint_decodes_like_hf():
    """A Qwen2-style long-context config (yarn, eps 1e-6, attention
    biases) imports with its eps and decodes HF's greedy tokens."""
    hf = _llama(seed=9, rms_norm_eps=1e-6, attention_bias=True,
                rope_scaling={"rope_type": "yarn", "factor": 4.0,
                              "original_max_position_embeddings": 16})
    prompt = _tokens(10, (1, 8))
    with torch.no_grad():
        want = hf.generate(prompt, max_new_tokens=12, do_sample=False,
                           num_beams=1)
    cfg, params = from_hf_llama(hf.state_dict(), hf_config=hf.config,
                                dtype=torch.float32, device="cpu")
    assert cfg.norm_eps == 1e-6
    assert torch.equal(generate(params, prompt, cfg, max_new_tokens=12,
                                device="cpu"), want)


def test_gpt2_logits_and_greedy_decode():
    hf = _gpt2()
    tokens = _tokens(8)
    cfg, params = from_hf_gpt2(hf.state_dict(), hf_config=hf.config,
                               device="cpu")
    assert (cfg.pos, cfg.norm, cfg.act) == ("learned", "layer", "gelu")
    torch.testing.assert_close(_port_logits(params, tokens, cfg),
                               _hf_logits(hf, tokens), **TOL)
    prompt = tokens[:1, :8]
    with torch.no_grad():
        want = hf.generate(prompt, max_new_tokens=10, do_sample=False,
                           num_beams=1, pad_token_id=0)
    assert torch.equal(generate(params, prompt, cfg, max_new_tokens=10,
                                device="cpu"), want)


@pytest.mark.parametrize("family", ["mistral", "qwen2"])
def test_llama_architecture_variants_parity(family):
    """Mistral and Qwen2 (attention biases) import through
    ``from_hf_llama`` with logits parity."""
    if family == "mistral":
        cfg = transformers.MistralConfig(
            **SMALL, num_key_value_heads=2, sliding_window=None,
            tie_word_embeddings=False)
        hf = transformers.MistralForCausalLM(cfg)
    else:
        cfg = transformers.Qwen2Config(
            **SMALL, num_key_value_heads=2, use_sliding_window=False,
            tie_word_embeddings=False)
        hf = transformers.Qwen2ForCausalLM(cfg)
    hf = _randomize(hf.eval(), 9)
    tokens = _tokens(10)
    mcfg, params = from_hf_llama(hf.state_dict(), hf_config=hf.config,
                                 dtype=torch.float32, device="cpu")
    torch.testing.assert_close(_port_logits(params, tokens, mcfg),
                               _hf_logits(hf, tokens), **TOL)


def test_mistral_sliding_window_logits_and_decode():
    """A windowed Mistral whose window bites: the window imports, the
    logits and greedy tokens (past the window) are HF's, and the window
    changes the logits (the mask is live)."""
    import dataclasses

    cfg = transformers.MistralConfig(
        **SMALL, num_key_value_heads=2, sliding_window=8,
        tie_word_embeddings=False)
    torch.manual_seed(11)
    hf = transformers.MistralForCausalLM(cfg).eval()
    tokens = _tokens(12, (B, 32))
    mcfg, params = from_hf_llama(hf.state_dict(), hf_config=hf.config,
                                 dtype=torch.float32, device="cpu")
    assert mcfg.sliding_window == 8
    got = _port_logits(params, tokens, mcfg)
    torch.testing.assert_close(got, _hf_logits(hf, tokens), **TOL)
    full = _port_logits(params, tokens,
                        dataclasses.replace(mcfg, sliding_window=None))
    assert float((got[:, 16:] - full[:, 16:]).abs().max()) > 1e-3
    prompt = _tokens(13, (1, 6))
    with torch.no_grad():
        want = hf.generate(prompt, max_new_tokens=20, do_sample=False,
                           num_beams=1)
    n = want.shape[1]  # HF may stop at a random-init EOS
    assert n > prompt.shape[1] + 8
    got_t = generate(params, prompt, mcfg, max_new_tokens=20, device="cpu")
    assert torch.equal(got_t[:, :n], want)


# ----------------------------------------------------------------- export


def test_to_hf_llama_round_trip_bit_exact_and_loads_in_hf():
    """``to_hf_llama`` of a port tree loads strictly into
    ``LlamaForCausalLM`` with the returned kwargs (rope_theta 50000
    carried), whose logits are the port's; ``from_hf_llama`` of the export
    gives every leaf back bit for bit, in bf16 too; the export equals
    JAX's export of the same tree."""
    import jax.numpy as jnp

    from torchdistpackage_tpu.models import init_gpt_params as jinit
    from torchdistpackage_tpu.models import llama_config as jllama
    import jax

    jcfg = jllama(vocab_size=128, dim=64, nheads=4, nlayers=2, max_seq=64,
                  kv_heads=2, ffn_hidden=96, rope_theta=50000.0,
                  dtype=jnp.float32)
    jparams = jinit(jax.random.PRNGKey(11), jcfg)
    cfg = llama_config_from_hf({**SMALL, "num_key_value_heads": 2,
                                "rope_theta": 50000.0},
                               dtype=torch.float32)
    params = params_from_jax(_np_tree(jparams), cfg, device="cpu")
    sd, kw = to_hf_llama(params, cfg)
    jsd, jkw = jconv.to_hf_llama(jparams, jcfg)
    assert kw == jkw and sorted(sd) == sorted(jsd)
    for k in jsd:
        assert np.array_equal(sd[k].numpy(), jsd[k]), k
    assert kw["rope_theta"] == 50000.0 and not kw["attention_bias"]
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(**kw)).eval()
    missing, unexpected = hf.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    tokens = _tokens(12)
    torch.testing.assert_close(_hf_logits(hf, tokens),
                               _port_logits(params, tokens, cfg), **TOL)
    _, back = from_hf_llama(sd, hf_config=kw, dtype=torch.float32,
                            device="cpu")
    _assert_trees_equal(back, params)
    bf = {k: v.to(torch.bfloat16) for k, v in _leaves(params).items()}
    bparams = _unflatten(params, bf)
    bsd, bkw = to_hf_llama(bparams, cfg)
    _, bback = from_hf_llama(bsd, hf_config=bkw, dtype=torch.bfloat16,
                             device="cpu")
    _assert_trees_equal(bback, bparams)


def _unflatten(like, flat, prefix=()):
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, prefix + (k,)) for k, v in like.items()}
    return flat["/".join(map(str, prefix))]


def test_to_hf_llama_round_trip_with_biases():
    """A Qwen2-imported tree (real attention biases) exports them with
    ``attention_bias`` set, loads into ``LlamaForCausalLM`` and computes
    the port's logits."""
    q = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        **SMALL, num_key_value_heads=2, use_sliding_window=False,
        tie_word_embeddings=False))
    q = _randomize(q.eval(), 13)
    cfg, params = from_hf_llama(q.state_dict(), hf_config=q.config,
                                dtype=torch.float32, device="cpu")
    sd, kw = to_hf_llama(params, cfg)
    assert kw["attention_bias"] and not kw["mlp_bias"]
    assert "model.layers.0.self_attn.q_proj.bias" in sd
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(**kw)).eval()
    hf.load_state_dict(sd, strict=True)
    tokens = _tokens(14)
    torch.testing.assert_close(_hf_logits(hf, tokens),
                               _port_logits(params, tokens, cfg), **TOL)


# --------------------------------------------------------------- refusals


def test_refusals():
    """Unknown rope scalings, non-silu Llama MLPs, non-standard GPT-2
    variants, mixed per-layer windows and a windowed export all raise, as
    the reference's; Qwen2's switched-off and all-full windows import as
    full attention."""
    from torchdistpackage_tpu_torch.models import llama_config

    bad = transformers.LlamaConfig(**SMALL)
    bad.rope_scaling = {"rope_type": "longrope", "factor": 2.0}
    with pytest.raises(NotImplementedError, match="rope_scaling"):
        llama_config_from_hf(bad)
    with pytest.raises(NotImplementedError, match="hidden_act"):
        llama_config_from_hf(transformers.LlamaConfig(**SMALL,
                                                      hidden_act="gelu"))
    for kw, match in (({"activation_function": "gelu"},
                       "activation_function"),
                      ({"scale_attn_by_inverse_layer_idx": True},
                       "scale_attn"),
                      ({"scale_attn_weights": False}, "scale_attn")):
        with pytest.raises(NotImplementedError, match=match):
            gpt2_config_from_hf(transformers.GPT2Config(
                vocab_size=128, n_embd=64, n_layer=2, n_head=4, **kw))
    small = {k: v for k, v in SMALL.items() if k != "num_hidden_layers"}
    assert llama_config_from_hf(transformers.Qwen2Config(
        **small, num_hidden_layers=4, sliding_window=32,
        use_sliding_window=False)).sliding_window is None
    assert llama_config_from_hf(transformers.Qwen2Config(
        **small, num_hidden_layers=4, sliding_window=32,
        use_sliding_window=True, max_window_layers=4)).sliding_window is None
    assert llama_config_from_hf(transformers.Qwen2Config(
        **small, num_hidden_layers=4, sliding_window=32,
        use_sliding_window=True, max_window_layers=0)).sliding_window == 32
    mixed = transformers.MistralConfig(**SMALL, sliding_window=32)
    mixed.layer_types = ["full_attention", "sliding_attention"]
    with pytest.raises(NotImplementedError, match="layer_types"):
        llama_config_from_hf(mixed)
    wcfg = llama_config(vocab_size=64, dim=32, nheads=4, nlayers=2,
                        max_seq=32, ffn_hidden=48, dtype=torch.float32,
                        sliding_window=8)
    gen = torch.Generator().manual_seed(0)
    from torchdistpackage_tpu_torch.models import GPTConfig, init_gpt_params

    wparams = init_gpt_params(wcfg, gen, device="cpu")
    with pytest.raises(ValueError, match="sliding_window"):
        to_hf_llama(wparams, wcfg)
    with pytest.raises(ValueError, match="Llama-family"):
        to_hf_llama(wparams, GPTConfig(vocab_size=64, dim=32, nheads=4,
                                       nlayers=2, max_seq=32))
