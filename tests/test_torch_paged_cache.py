"""The port's paged pool against the JAX package, on the CPU, in f32:
``paged_write`` / ``gather_kv`` (fp and int8 — the quantisation must be
EQUAL), ``paged_forward`` over a prefill chunk and a decode step, and the
host-side ``BlockAllocator``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.models import llama_config as jllama
from torchdistpackage_tpu.models.generate import _kv_quant as j_kv_quant
from torchdistpackage_tpu.serving import paged_cache as jpc
from torchdistpackage_tpu_torch.models import llama_config
from torchdistpackage_tpu_torch.models.convert import params_from_jax
from torchdistpackage_tpu_torch.models.generate import _kv_quant
from torchdistpackage_tpu_torch.serving import paged_cache as tpc

SMALL = dict(vocab_size=64, dim=64, nheads=4, nlayers=2, max_seq=64,
             kv_heads=2, ffn_hidden=96, sliding_window=6)
B, BS, MB = 2, 4, 6
NB = 1 + B * MB


def _tables():
    t = np.zeros((B, MB), np.int32)
    t[0, :5] = [3, 1, 7, 2, 9]   # slot 1 leaves its tail NULL
    t[1, :] = [4, 11, 5, 6, 8, 10]
    return t


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_np(a) for a in x)
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_kv_quant_equal():
    x = np.random.RandomState(0).randn(3, 2, 5, 16).astype(np.float32) * 4
    x[0, 0, 0] = 0.0  # the 1e-30 floor
    q8, s = _kv_quant(torch.from_numpy(x))
    jq8, js = j_kv_quant(jnp.asarray(x))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_write_and_gather_match_jax(quantized):
    rs = np.random.RandomState(1)
    hd, hkv, s_in = 16, 2, 7
    shape = (NB, hkv, BS, hd)
    if quantized:
        pool = (np.zeros(shape, np.int8), np.ones(shape[:-1], np.float32))
    else:
        pool = np.zeros(shape, np.float32)
    val = rs.randn(B, hkv, s_in, hd).astype(np.float32)
    # slot 1 runs past its table: the tail clamps onto the last entry
    offs = np.asarray([5, 20], np.int32)
    tables = _tables()
    jpool = jax.tree.map(jnp.asarray, pool)
    tpool = jax.tree.map(torch.from_numpy, pool)
    jpool = jpc.paged_write(jpool, jnp.asarray(val), jnp.asarray(offs),
                            tables=jnp.asarray(tables))
    out = tpc.paged_write(tpool, torch.from_numpy(val),
                          torch.from_numpy(offs),
                          tables=torch.from_numpy(tables))
    assert out is tpool  # in place
    for got, want in zip(jax.tree.leaves(_np(tpool)),
                         jax.tree.leaves(_np(jpool))):
        np.testing.assert_array_equal(got, want)
    g = tpc.gather_kv(tpool, torch.from_numpy(tables))
    jg = jpc.gather_kv(jpool, jnp.asarray(tables))
    for got, want in zip(jax.tree.leaves(_np(g)), jax.tree.leaves(_np(jg))):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama(**SMALL, dtype=jnp.float32)
    tcfg = llama_config(**SMALL, dtype=torch.float32)
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_forward_matches_jax(models, quantized):
    """A two-slot prefill chunk at different offsets (slot 0 mid-prompt,
    slot 1 from 0), then one decode step, on the same pool."""
    jcfg, tcfg, jp, tp = models
    tables = _tables()
    jcache = jpc.init_paged_kv(jcfg, NB, BS, quantized=quantized)
    tcache = tpc.init_paged_kv(tcfg, NB, BS, quantized=quantized,
                               device="cpu")
    rs = np.random.RandomState(2)
    steps = [
        (rs.randint(0, 64, (B, 8)).astype(np.int32),
         np.asarray([0, 0], np.int32), np.asarray([7, 4], np.int32)),
        (rs.randint(0, 64, (B, 8)).astype(np.int32),
         np.asarray([8, 5], np.int32), np.asarray([7, 7], np.int32)),
        (rs.randint(0, 64, (B, 1)).astype(np.int32),
         np.asarray([16, 13], np.int32), None),
    ]
    for tokens, offs, last in steps:
        jcache, jlog = jpc.paged_forward(
            jp, jnp.asarray(tokens), jcfg, jcache, jnp.asarray(tables),
            jnp.asarray(offs),
            last_idx=None if last is None else jnp.asarray(last))
        tcache, tlog = tpc.paged_forward(
            tp, torch.from_numpy(tokens), tcfg, tcache,
            torch.from_numpy(tables), torch.from_numpy(offs),
            last_idx=None if last is None else torch.from_numpy(last))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-4, rtol=0)
    for got, want in zip(jax.tree.leaves(_np(tcache)),
                         jax.tree.leaves(_np(jcache))):
        if got.dtype == np.int8:  # a rounding tie may land one code off
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert tpc.pool_bytes(tcache) == tpc.expected_pool_bytes(
        tcfg, NB, BS, quantized=quantized)
    assert tpc.block_size_of(tcache) == BS


def test_block_allocator():
    a = tpc.BlockAllocator(6)
    assert a.n_usable == 5 and a.alloc(6) is None
    x = a.alloc(3)
    assert len(set(x)) == 3 and tpc.NULL_BLOCK not in x
    assert a.audit([x])["ok"] and a.peak_in_use == 3
    y = a.alloc(2)
    assert a.alloc(1) is None
    rep = a.audit([x])  # y owned by nobody: a leak
    assert not rep["ok"] and rep["orphaned"] == sorted(y)
    rep = a.audit([x, y, [x[0]]])  # x[0] owned twice
    assert rep["shared"] == [x[0]]
    a.free(y)
    with pytest.raises(ValueError):
        a.free(y)
    assert a.audit([x, y])["unknown"] == sorted(y)  # use after free
    assert sorted(a.reclaim(x + [0, 99])) == sorted(x)
    assert a.n_free == 5 and a.audit([])["ok"]
