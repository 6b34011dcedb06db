"""The port's training path against the JAX package's, on the CPU, in f32.

``gpt_loss`` and its gradients against ``jax.value_and_grad(gpt_loss)``
on the same weights (JAX's init, carried over by ``params_from_jax``) and
the same numpy-seeded batch, with ``attn_impl='flash'`` on both sides
(JAX's Pallas kernels in interpret mode, the port's plain versions behind
the same autograd Function the card uses); then three AdamW steps on
both sides.  Configurations: ``bench.py``'s CPU config (vocab 512, d 128,
4 heads, 4 layers, S 256, ffn_mult 2) and a GQA + window + RoPE + SwiGLU
+ RMSNorm Llama config at toy widths with window < S; ``xent_chunk`` set
and unset; remat False, True and 'flash' (the same numbers).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import gpt_loss as jgpt_loss
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.models import llama_config as jllama
import torchdistpackage_tpu_torch.ops.flash_attention as tfa
from torchdistpackage_tpu_torch.models import GPTConfig, gpt_loss
from torchdistpackage_tpu_torch.models import llama_config
from torchdistpackage_tpu_torch.models.convert import params_from_jax
from torchdistpackage_tpu_torch.obs import global_grad_norm
from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
from torchdistpackage_tpu_torch.parallel.data_parallel import (
    adamw,
    make_train_step,
)

BATCH = 2
BENCH = dict(vocab_size=512, dim=128, nheads=4, nlayers=4, max_seq=256,
             ffn_mult=2, attn_impl="flash")
LLAMA = dict(vocab_size=128, dim=64, nheads=4, nlayers=2, max_seq=64,
             kv_heads=2, ffn_hidden=96, sliding_window=24,
             attn_impl="flash")
CONFIGS = {
    "bench_cpu": (lambda: JGPTConfig(**BENCH, dtype=jnp.float32),
                  lambda: GPTConfig(**BENCH, dtype=torch.float32)),
    "llama_gqa_window": (lambda: jllama(**LLAMA, dtype=jnp.float32),
                         lambda: llama_config(**LLAMA, dtype=torch.float32)),
}
CHUNK = {"bench_cpu": 64, "llama_gqa_window": 16}
# f32 through a few layers: the frameworks sum in different orders, and
# the difference grows with each product; 2e-5 of the loss (~6) and 1e-5
# absolute on grads of size up to ~1e-2 (~1e-4 relative to the largest)
LOSS_TOL, GRAD_TOL = 2e-5, 1e-5


def _batch(cfg, seed=0):
    rs = np.random.RandomState(seed)
    shape = (BATCH, cfg.max_seq)
    return {"tokens": rs.randint(0, cfg.vocab_size, shape).astype(np.int32),
            "targets": rs.randint(0, cfg.vocab_size, shape).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(name, xent_chunk):
    """(JAX params, numpy batch, jitted value_and_grad of gpt_loss on that
    batch) — compiled once per configuration."""
    jcfg = CONFIGS[name][0]()
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    vg = jax.jit(jax.value_and_grad(
        lambda p: jgpt_loss(p, jb, jcfg, xent_chunk=xent_chunk)))
    return jinit(jax.random.PRNGKey(0), jcfg), batch, vg


@functools.lru_cache(maxsize=None)
def _jax_reference(name, xent_chunk):
    """(JAX params as numpy, batch, loss, grads as numpy) — shared by the
    remat modes."""
    jp, batch, vg = _jax_value_and_grad(name, xent_chunk)
    loss, grads = vg(jp)
    return (jax.tree.map(np.asarray, jp), batch, float(loss),
            jax.tree.map(np.asarray, grads))


def _torch_params(np_params, cfg):
    p = params_from_jax(np_params, cfg, device="cpu")
    for leaf in tree_leaves(p):
        leaf.requires_grad_(True)
    return p


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _walk(t, j, path=""):
    if isinstance(t, dict):
        assert set(t) == set(j), path
        for k in t:
            yield from _walk(t[k], j[k], f"{path}/{k}")
    else:
        yield path, t, j


@pytest.mark.parametrize("remat", [False, True, "flash"])
@pytest.mark.parametrize("xent", ["full", "chunked"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gpt_loss_and_grads_match_jax(name, xent, remat, monkeypatch):
    xent_chunk = CHUNK[name] if xent == "chunked" else None
    np_params, batch, jloss, jgrads = _jax_reference(name, xent_chunk)
    cfg = CONFIGS[name][1]()
    params = _torch_params(np_params, cfg)

    # count the forward flash calls (K3's plain version on the CPU):
    # remat 'flash' keeps (o, lse) and must not run it again in the
    # backward, remat True must
    calls = []
    fwd = tfa.flash_fwd_reference
    monkeypatch.setattr(tfa, "flash_fwd_reference",
                        lambda *a: calls.append(1) or fwd(*a))
    loss = gpt_loss(params, _torch_batch(batch), cfg, remat=remat,
                    xent_chunk=xent_chunk)
    assert len(calls) == cfg.nlayers
    loss.backward()
    assert len(calls) == cfg.nlayers * (2 if remat is True else 1)

    loss = float(loss.detach())
    assert abs(loss - jloss) <= LOSS_TOL, (loss, jloss)
    tgrads = {k: v for k, v in params.items()}
    n = 0
    for path, t, j in _walk(tgrads, jgrads):
        assert t.grad is not None, path
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=0,
                                   atol=GRAD_TOL, err_msg=path)
        n += 1
    assert n == len(list(tree_leaves(params)))


def test_remat_modes_validated():
    cfg = CONFIGS["llama_gqa_window"][1]()
    np_params, batch, _, _ = _jax_reference("llama_gqa_window", None)
    params = _torch_params(np_params, cfg)
    with pytest.raises(ValueError, match="remat"):
        gpt_loss(params, _torch_batch(batch), cfg, remat="flsh")
    # 'flash_offload' is 'flash' on the CPU; a dropout rate without a
    # dropout_key is the identity, as in the reference
    flash = gpt_loss(params, _torch_batch(batch), cfg, remat="flash")
    assert torch.equal(
        gpt_loss(params, _torch_batch(batch), cfg, remat="flash_offload"),
        flash)
    assert torch.equal(
        gpt_loss(params, _torch_batch(batch),
                 llama_config(**LLAMA, dtype=torch.float32,
                              dropout_rate=0.1)),
        gpt_loss(params, _torch_batch(batch), cfg))
    with pytest.raises(NotImplementedError, match="Training CP"):
        gpt_loss(params, _torch_batch(batch),
                 llama_config(**{**LLAMA, "sliding_window": None,
                                 "attn_impl": "ring"}, dtype=torch.float32))


def test_naive_matches_flash_on_the_port():
    """The two attention paths of the port give the same loss."""
    name = "llama_gqa_window"
    np_params, batch, jloss, _ = _jax_reference(name, None)
    naive = llama_config(**{**LLAMA, "attn_impl": "naive"},
                         dtype=torch.float32)
    loss = gpt_loss(_torch_params(np_params, naive), _torch_batch(batch),
                    naive)
    assert abs(float(loss) - jloss) <= LOSS_TOL


def test_three_adamw_steps_match_optax():
    """Three steps of optax ``adamw(3e-4)`` against the port's step on the
    GQA + window Llama config.  Tolerance: Adam's first update is g / (|g| + eps),
    whose slope near g = 0 is 1/eps = 1e8, so a leaf element with a
    near-zero gradient can move by up to 2 lr a step on an f32 rounding
    difference of its gradient; every element is held to that bound
    (2 lr x 3 steps), and 99.9 % of them to 1e-6."""
    name = "llama_gqa_window"
    jp, batch, vg = _jax_value_and_grad(name, None)
    np_params = jax.tree.map(np.asarray, jp)
    cfg = CONFIGS[name][1]()
    opt = optax.adamw(3e-4)
    jstate = opt.init(jp)
    jlosses, jnorms = [], []
    @jax.jit
    def jupdate(grads, jstate, jp):
        updates, jstate = opt.update(grads, jstate, jp)
        return optax.apply_updates(jp, updates), jstate, optax.global_norm(
            grads)

    for _ in range(3):
        loss, grads = vg(jp)
        jp, jstate, gn = jupdate(grads, jstate, jp)
        jnorms.append(float(gn))
        jlosses.append(float(loss))

    params = params_from_jax(np_params, cfg, device="cpu")
    optimizer = adamw(3e-4)
    state = optimizer.init(params)
    step = make_train_step(lambda p, b: gpt_loss(p, b, cfg), optimizer)
    tb = _torch_batch(batch)
    for i in range(3):
        params, state, loss, gnorm = step(params, state, tb)
        assert abs(float(loss) - jlosses[i]) <= LOSS_TOL
        assert abs(float(gnorm) - jnorms[i]) <= 1e-5 * jnorms[i]
    diffs = np.concatenate([
        np.abs(t.detach().numpy() - np.asarray(j)).ravel()
        for _, t, j in _walk(params, jax.tree.map(np.asarray, jp))])
    assert diffs.max() <= 2 * 3e-4 * 3
    assert np.quantile(diffs, 0.999) <= 1e-6


def test_global_grad_norm_and_numerics_stats():
    tree = {"a": torch.tensor([3.0, 0.0]), "b": {"c": torch.tensor([[4.0]])}}
    assert float(global_grad_norm(tree)) == 5.0
    cfg = CONFIGS["llama_gqa_window"][1]()
    np_params, batch, _, _ = _jax_reference("llama_gqa_window", None)
    params = params_from_jax(np_params, cfg, device="cpu")
    opt = adamw(1e-3)
    state = opt.init(params)
    before = float(global_grad_norm([p.detach() for p in
                                     tree_leaves(params)]))
    step = make_train_step(lambda p, b: gpt_loss(p, b, cfg), opt,
                           numerics=True)
    _, _, loss, stats = step(params, state, _torch_batch(batch))
    assert set(stats) == {"grad_norm", "param_norm", "nonfinite_grads"}
    assert abs(float(stats["param_norm"]) - before) < 1e-6 * before
    assert int(stats["nonfinite_grads"]) == 0 and float(stats["grad_norm"]) > 0
    with pytest.raises(TypeError):
        make_train_step(lambda p, b: 0, torch.optim.SGD)
