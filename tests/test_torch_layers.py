"""The port's block math against the JAX package, on the CPU, in f32.

Inputs come from numpy seeds and go through the JAX function and its
PyTorch counterpart; f32 results agree within ``atol`` 1e-5 (the two
frameworks sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.models import llama_config as jllama
from torchdistpackage_tpu.parallel.tensor_parallel import layers as jl
from torchdistpackage_tpu_torch.models import (
    GPTConfig,
    init_gpt_params,
    llama_config,
    mistral_7b_config,
)
from torchdistpackage_tpu_torch.models.convert import params_from_jax
from torchdistpackage_tpu_torch.parallel.tensor_parallel import layers as tl

ATOL = 1e-5
SMALL = dict(vocab_size=64, dim=64, nheads=4, nlayers=2, max_seq=64)
ROPE_SCALINGS = {
    "none": None,
    "linear": {"rope_type": "linear", "factor": 4.0},
    "llama3": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0,
               "original_max_position_embeddings": 16},
}


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("norm", ["layer", "rms"])
def test_norms(norm):
    x = _x(2, 5, 64) * 3 + 1
    p = {"scale": _x(64, seed=1)}
    if norm == "layer":
        p["bias"] = _x(64, seed=2)
    want = jl.layer_norm(jnp.asarray(x), {k: jnp.asarray(v)
                                          for k, v in p.items()}, 1e-5)
    got = tl.layer_norm(torch.from_numpy(x),
                        {k: torch.from_numpy(v) for k, v in p.items()}, 1e-5)
    _close(got, want)


@pytest.mark.parametrize("scaling", sorted(ROPE_SCALINGS))
def test_rope(scaling):
    sc = ROPE_SCALINGS[scaling]
    pos = np.arange(3, 40, dtype=np.int32)
    x = _x(2, 4, len(pos), 16)
    jc = jl.rope_cache(jnp.asarray(pos), 16, 10000.0, scaling=sc)
    tc = tl.rope_cache(torch.from_numpy(pos), 16, 10000.0, scaling=sc)
    for a, b in zip(tc, jc):
        _close(a, b)
    _close(tl.apply_rope(torch.from_numpy(x), tc),
           jl.apply_rope(jnp.asarray(x), cache=jc))


def test_rope_scaling_types_queued_are_refused():
    for kind in ("dynamic", "yarn"):
        with pytest.raises(NotImplementedError, match=kind):
            tl.TransformerConfig(dim=64, nheads=4, rope=True, rope_scaling={
                "rope_type": kind, "factor": 2.0,
                "original_max_position_embeddings": 16})


def _block_pair(jcfg, tcfg):
    jp = jinit(jax.random.PRNGKey(3), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    jb = jax.tree.map(lambda a: a[0], jp["blocks"])
    tb = {k: ({kk: vv[0] for kk, vv in v.items()}) for k, v in
          tp["blocks"].items()}
    return jb, tb


LAYOUTS = {
    "wqkv_gelu": (lambda: JGPTConfig(**SMALL, dtype=jnp.float32),
                  lambda: GPTConfig(**SMALL, dtype=torch.float32)),
    "gqa_swiglu_rope": (
        lambda: jllama(**SMALL, kv_heads=2, ffn_hidden=96,
                       dtype=jnp.float32, sliding_window=6),
        lambda: llama_config(**SMALL, kv_heads=2, ffn_hidden=96,
                             dtype=torch.float32, sliding_window=6)),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_compute_qkv_and_mlp(layout):
    jcfg, tcfg = (f() for f in LAYOUTS[layout])
    jb, tb = _block_pair(jcfg, tcfg)
    x = _x(2, 7, 64, seed=4)
    jq = jl.compute_qkv(jb["attn"], jnp.asarray(x), jcfg.block)
    tq = tl.compute_qkv(tb["attn"], torch.from_numpy(x), tcfg.block)
    for a, b in zip(tq, jq):
        assert tuple(a.shape) == b.shape
        _close(a, b)
    _close(tl.mlp_partial(tb["mlp"], torch.from_numpy(x)),
           jl.mlp_partial(jb["mlp"], jnp.asarray(x)))


def test_init_matches_jax_tree_leaf_for_leaf():
    """The port's random init has the reference's tree, shapes and
    dtypes (zero Llama biases included), so params_from_jax maps leaf
    for leaf."""
    for jfn, tfn in LAYOUTS.values():
        jcfg, tcfg = jfn(), tfn()
        jp = jinit(jax.random.PRNGKey(0), jcfg)
        tp = init_gpt_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
        jflat = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_flatten_with_path(jp)[0]}
        tflat = {}

        def walk(tree, prefix):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}['{k}']")
                else:
                    tflat[f"{prefix}['{k}']"] = v
        walk(tp, "")
        assert set(tflat) == set(jflat)
        for k, v in tflat.items():
            assert tuple(v.shape) == jflat[k].shape, k
        assert sum(v.numel() for v in tflat.values()) == tcfg.num_params()


def test_mistral_7b_widths():
    cfg = mistral_7b_config()
    b = cfg.block
    assert (cfg.dim, cfg.nlayers, cfg.nheads, b.kv_head_count, b.head_dim,
            b.ffn_dim, cfg.vocab_size, cfg.sliding_window) == (
        4096, 32, 32, 8, 128, 14336, 32000, 4096)
    assert cfg.dtype == torch.bfloat16 and cfg.norm == "rms"
    assert abs(cfg.num_params() - 7.24e9) < 0.01e9
