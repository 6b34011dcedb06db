"""Residual dropout and remat 'flash_offload' in the port, on the CPU,
against the JAX package where JAX has the function.

- Dropout at rate 0, or without a key, is exactly the no-dropout loss,
  and JAX's within the training tests' f32 tolerance.  JAX's masks come
  from threefry and the port's from a ``torch.Generator``, so masks are
  held by their statistics: at rate 0.5 the kept fraction within 4
  sigma of the binomial, every kept value exactly ``x / (1 - rate)``,
  masks apart across sites, layers and data ranks and equal across
  tensor ranks (the multi-process version is in
  ``tests/test_torch_dp.py``).
- With dropout on, the grads under remat True and 'flash' equal the
  grads without remat (the recompute redraws the same masks).
- 'flash_offload' gives the loss and grads of 'flash' (on the CPU it is
  'flash') and JAX's 'flash_offload' within rtol 1e-4 / atol 1e-6 (the
  JAX test's tolerance, ``tests/test_gpt.py``).
- ``offload_advice`` decides as JAX's on the inputs of JAX's guard-rail
  test, and ``scan_blocks`` warns under 'flash_offload' only.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import gpt_loss as jgpt_loss
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.parallel.tensor_parallel import (
    offload_advice as joffload_advice,
)
import torchdistpackage_tpu_torch.parallel.tensor_parallel.layers as tl
from torchdistpackage_tpu_torch.dist import ParallelContext
from torchdistpackage_tpu_torch.models import (
    GPTConfig,
    gpt_loss,
    params_from_jax,
)
from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
from torchdistpackage_tpu_torch.utils import axis_unique_key

#: JAX's remat / guard-rail test model (tests/test_gpt.py)
SMALL = dict(vocab_size=64, dim=32, nheads=2, nlayers=3, max_seq=16,
             ffn_mult=2, attn_impl="flash")
LOSS_TOL = 2e-5  # f32 through a few layers (tests/test_torch_train.py)
REMAT_TOL = dict(rtol=1e-4, atol=1e-6)


def _batch(seed=1):
    rs = np.random.RandomState(seed)
    return {k: rs.randint(0, 64, (2, 16)).astype(np.int32)
            for k in ("tokens", "targets")}


@functools.lru_cache(maxsize=None)
def _jax(remat):
    """JAX's params (numpy), loss and grads of gpt_loss under ``remat``."""
    cfg = JGPTConfig(**SMALL, dtype=jnp.float32)
    params = jinit(jax.random.PRNGKey(0), cfg)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jgpt_loss(p, jb, cfg, remat=remat)))(params)
    return (jax.tree.map(np.asarray, params), float(loss),
            jax.tree.map(np.asarray, grads))


def _cfg(**kw):
    return GPTConfig(**SMALL, dtype=torch.float32, **kw)


def _loss_grads(cfg, remat=False, key=None):
    np_params, _, _ = _jax(False)
    params = params_from_jax(np_params, cfg, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v).long() for k, v in _batch().items()}
    loss = gpt_loss(params, tb, cfg, remat=remat, dropout_key=key)
    loss.backward()
    return loss.detach(), [p.grad for p in tree_leaves(params)]


def test_dropout_rate0_or_no_key_is_the_plain_loss():
    _, jloss, _ = _jax(False)
    plain, _ = _loss_grads(_cfg())
    assert abs(float(plain) - jloss) <= LOSS_TOL
    rate0, _ = _loss_grads(_cfg(), key=5)
    nokey, _ = _loss_grads(_cfg(dropout_rate=0.5))
    assert torch.equal(rate0, plain) and torch.equal(nokey, plain)
    on, _ = _loss_grads(_cfg(dropout_rate=0.5), key=5)
    assert torch.isfinite(on) and not torch.equal(on, plain)


def test_dropout_statistics_and_kept_values():
    x = torch.randn(64, 128, 32)
    rate = 0.5
    y = tl.dropout(x, rate, 123)
    kept = y != 0
    n = x.numel()
    sigma = (n * rate * (1 - rate)) ** 0.5
    assert abs(int(kept.sum()) - n * (1 - rate)) <= 4 * sigma
    assert torch.equal(y[kept], x[kept] / (1 - rate))
    assert torch.equal(y, tl.dropout(x, rate, 123))
    assert tl.dropout(x, rate, None) is x and tl.dropout(x, 0.0, 1) is x


def _recorded_masks(monkeypatch, cfg, key, x):
    """The masks of every dropout call of one ``scan_blocks`` forward."""
    masks = []
    orig = tl.dropout

    def spy(t, rate, k):
        out = orig(t, rate, k)
        if k is not None:
            masks.append(out == 0)
        return out

    monkeypatch.setattr(tl, "dropout", spy)
    np_params, _, _ = _jax(False)
    params = params_from_jax(np_params, cfg, device="cpu")
    tl.scan_blocks(params["blocks"], x, cfg.block, dropout_key=key)
    monkeypatch.setattr(tl, "dropout", orig)
    return masks


def test_masks_apart_across_sites_layers_and_data_ranks(monkeypatch):
    cfg = _cfg(dropout_rate=0.5)
    x = torch.randn(2, 16, 32)
    masks = _recorded_masks(monkeypatch, cfg, 7, x)
    assert len(masks) == 2 * cfg.nlayers  # two sites a layer
    for i in range(len(masks)):
        for j in range(i):
            assert not torch.equal(masks[i], masks[j]), (i, j)
    # data 2 x tensor 2: ranks 0 and 1 share a data coordinate
    per_rank = []
    for r in range(4):
        ctx = ParallelContext()
        ctx.setup_process_groups([("data", 2), ("tensor", 2)], world_size=4,
                                 rank=r)
        per_rank.append(_recorded_masks(
            monkeypatch, cfg, axis_unique_key(7, "data", ctx=ctx), x))
    for a, b in zip(per_rank[0], per_rank[1]):
        assert torch.equal(a, b)
    for a, b in zip(per_rank[0], per_rank[2]):
        assert not torch.equal(a, b)


@pytest.mark.parametrize("remat", [True, "flash", "flash_offload"])
def test_dropout_grads_under_remat_equal_no_remat(remat):
    cfg = _cfg(dropout_rate=0.3)
    loss0, g0 = _loss_grads(cfg, False, key=11)
    loss1, g1 = _loss_grads(cfg, remat, key=11)
    assert torch.equal(loss0, loss1)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **REMAT_TOL)


def test_flash_offload_matches_flash_and_jax():
    _, jloss, jgrads = _jax("flash_offload")
    loss_f, g_f = _loss_grads(_cfg(), "flash")
    loss_o, g_o = _loss_grads(_cfg(), "flash_offload")
    assert torch.equal(loss_f, loss_o)
    for a, b in zip(g_f, g_o):
        assert torch.equal(a, b)
    assert abs(float(loss_o) - jloss) <= REMAT_TOL["atol"] + \
        REMAT_TOL["rtol"] * abs(jloss)
    np_params, _, _ = _jax(False)
    want = params_from_jax(jgrads, _cfg(), device="cpu")
    for a, b in zip(g_o, tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **REMAT_TOL)


def test_offload_advice_decides_as_jax(monkeypatch):
    jcfg = JGPTConfig(**SMALL, dtype=jnp.float32).block
    cfg = _cfg().block
    for hbm in (16 * 2**30, 10_000, None):
        want = joffload_advice(jcfg, (2, 16, 32), 3, hbm_bytes=hbm)
        got = tl.offload_advice(cfg, (2, 16, 32), 3, hbm_bytes=hbm,
                                device=torch.device("cpu"))
        assert (got is None) == (want is None), hbm
        if got is not None:
            assert "flash" in got
            # no TPU figure or TPU benchmark file in the port's message
            assert "2.4" not in got and "BENCH" not in got
    # end to end: scan_blocks warns under 'flash_offload' only
    monkeypatch.setattr(tl, "_device_hbm_bytes", lambda device: 16 * 2**30)
    x = torch.randn(2, 16, 32)
    np_params, _, _ = _jax(False)
    params = params_from_jax(np_params, _cfg(), device="cpu")
    for remat, warns in (("flash_offload", True), ("flash", False)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            tl.scan_blocks(params["blocks"], x, cfg, remat=remat)
        assert any("flash_offload" in str(w.message) for w in rec) == warns


def test_rate_and_key_reach_every_layer(monkeypatch):
    """``gpt_loss(dropout_key=)`` reaches ``scan_blocks``: one key a
    layer, folded from the caller's."""
    seen = []
    orig = tl.block_forward

    def spy(p, x, cfg, rope=None, dropout_key=None):
        seen.append(dropout_key)
        return orig(p, x, cfg, rope=rope, dropout_key=dropout_key)

    monkeypatch.setattr(tl, "block_forward", spy)
    _loss_grads(dataclasses.replace(_cfg(), dropout_rate=0.1), key=3)
    assert len(seen) == SMALL["nlayers"] and len(set(seen)) == len(seen)
    assert None not in seen
