"""The port's context-parallel attention (``ops/ring_attention.py``)
against the JAX package's, on the CPU.

One launch of 4 ``tests/_torch_ring_attention_worker.py`` processes
(gloo, JAX-free) starts in a module fixture before this process runs
JAX, so the two overlap.  Each case of the worker's ``CASES`` —
``ring_attention``'s flash and einsum bodies, contiguous and zigzag,
causal and not, GQA, and ``ulysses_attention``, at cp 4 and cp 2 — is
held, forward and grads of q, k, v for one cotangent, against JAX's
``ring_attention`` / ``ulysses_attention`` under ``shard_map`` on as
many CPU devices (JAX ``tests/test_attention_ops.py:102``, :145, :166,
:274) — except Ulysses' grads: JAX's Ulysses does not differentiate
under ``shard_map`` on jax 0.9 (its ``all_to_all`` transpose), so they
are held against JAX's serial ``mha_reference``.  JAX's side runs its einsum bodies (``use_flash=False``): its
Pallas flash bodies compute the same function in interpret mode, far
slower here.  Zigzag inputs are permuted with JAX's ``zigzag_permute``
and the outputs unpermuted, as JAX's own test does.

Tolerances (f32): outputs ``rtol`` / ``atol`` 2e-5, grads ``rtol`` 2e-4
and ``atol`` 2e-5.  The planted fault (every hop's lse detached, so the
combine's cotangent never reaches ``flash_delta``) must miss the grads
by more than 1e-2 of their largest value.
"""

import functools
import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from torchdistpackage_tpu.compat import shard_map
from torchdistpackage_tpu.ops.flash_attention import mha_reference as jmha

# the packages export functions named ring_attention: reach the modules
jra = importlib.import_module("torchdistpackage_tpu.ops.ring_attention")
tra = importlib.import_module("torchdistpackage_tpu_torch.ops.ring_attention")

sys.path.insert(0, str(Path(__file__).parent))
import _torch_ring_attention_worker as W  # noqa: E402

OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
FAULT_GAP = 1e-2
NAMES = ("out", "dq", "dk", "dv")


def _inputs():
    rs = np.random.RandomState(0)
    out = {}
    for kv in sorted({spec[3] for spec in W.CASES.values()}):
        out[f"{kv}/q"] = rs.randn(W.B, W.H, W.S, W.D).astype(np.float32)
        out[f"{kv}/k"] = rs.randn(W.B, kv, W.S, W.D).astype(np.float32)
        out[f"{kv}/v"] = rs.randn(W.B, kv, W.S, W.D).astype(np.float32)
        out[f"{kv}/do"] = rs.randn(W.B, W.H, W.S, W.D).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    inp = _inputs()
    tmp = tmp_path_factory.mktemp("ring_attention")
    return inp, (W.start(W.__file__, inp, tmp), tmp), {}


@pytest.fixture(scope="module")
def ranks(launched, gold):
    _, procs, done = launched
    if "r" not in done:
        done["r"] = W.results(*procs)
    return done["r"]


@functools.lru_cache(maxsize=None)
def _jax_fn(spec):
    impl, causal, layout, _, cp = spec
    mesh = Mesh(np.array(jax.devices()[:cp]), ("context",))
    seq = P(None, None, "context", None)
    if impl == "ulysses":
        fn = functools.partial(jra.ulysses_attention, axis="context",
                               causal=causal, use_flash=False)
    else:
        fn = functools.partial(jra.ring_attention, axis="context",
                               causal=causal, use_flash=False, layout=layout)
    sm = shard_map(fn, mesh=mesh, in_specs=(seq,) * 3, out_specs=seq)

    def run(q, k, v, do):
        if layout == "zigzag":
            q, k, v, do = (jra.zigzag_permute(t, cp, seq_dim=2)
                           for t in (q, k, v, do))
        out = sm(q, k, v)
        # JAX's Ulysses does not differentiate on jax 0.9 (its all_to_all's
        # transpose meets a cotangent of the wrong shape): its grads are the
        # serial attention's, the function Ulysses computes
        grad_fn = sm if impl != "ulysses" else functools.partial(
            jmha, causal=causal)
        grads = jax.grad(lambda *a: jnp.sum(grad_fn(*a) * do),
                         argnums=(0, 1, 2))(q, k, v)
        res = (out,) + grads
        if layout == "zigzag":
            res = tuple(jra.zigzag_unpermute(t, cp, seq_dim=2) for t in res)
        return res
    return jax.jit(run)


@pytest.fixture(scope="module")
def gold(launched):
    inp = launched[0]
    out = {}
    for name, spec in W.CASES.items():
        kv = spec[3]
        res = _jax_fn(spec)(*(jnp.asarray(inp[f"{kv}/{n}"])
                              for n in ("q", "k", "v", "do")))
        out[name] = dict(zip(NAMES, (np.asarray(t) for t in res)))
    return out


def _assembled(ranks, name, cp, first):
    """The global (natural-order) arrays of the cp ranks starting at
    ``first``."""
    layout = W.CASES.get(name, W.CASES["ring_causal_cp4"])[2]
    out = {}
    for n in NAMES:
        x = np.concatenate([ranks[first + r][f"{name}/{n}"]
                            for r in range(cp)], axis=2)
        if layout == "zigzag":
            x = np.asarray(jra.zigzag_unpermute(jnp.asarray(x), cp,
                                                seq_dim=2))
        out[n] = x
    return out


@pytest.mark.parametrize("name", list(W.CASES))
def test_cp_attention_matches_jax(ranks, gold, name):
    cp = W.CASES[name][-1]
    for first in range(0, W.WORLD, cp):
        got = _assembled(ranks, name, cp, first)
        np.testing.assert_allclose(got["out"], gold[name]["out"], **OUT_TOL,
                                   err_msg=f"{name} out (ranks {first}+)")
        for n in NAMES[1:]:
            np.testing.assert_allclose(got[n], gold[name][n], **GRAD_TOL,
                                       err_msg=f"{name} {n} (ranks {first}+)")


def test_planted_fault_no_lse_cotangent_misses(ranks, gold):
    """Each hop's lse detached: the output is unchanged, the grads of q
    and k miss (their lse term is what combines the hops)."""
    got = _assembled(ranks, W.FAULT, 4, 0)
    want = gold["ring_causal_cp4"]
    np.testing.assert_allclose(got["out"], want["out"], **OUT_TOL)
    for n in ("dq", "dk"):
        gap = np.abs(got[n] - want[n]).max()
        assert gap > FAULT_GAP * np.abs(want[n]).max(), (n, gap)


@pytest.mark.parametrize("n,s_local", [(2, 8), (4, 4), (4, 16)])
def test_zigzag_helpers_match_jax(n, s_local):
    """``zigzag_positions`` / ``zigzag_permute`` / ``zigzag_unpermute``
    against JAX's, element for element."""
    for idx in range(n):
        pos, starts = tra.zigzag_positions(idx, s_local, n)
        jpos, jstarts = jra.zigzag_positions(idx, s_local, n)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        assert starts == tuple(int(s) for s in jstarts)
    x = np.arange(3 * n * s_local * 2, dtype=np.float32).reshape(
        3, n * s_local, 2)
    perm = tra.zigzag_permute(torch.from_numpy(x), n, seq_dim=1)
    np.testing.assert_array_equal(
        perm.numpy(), np.asarray(jra.zigzag_permute(jnp.asarray(x), n, 1)))
    np.testing.assert_array_equal(
        tra.zigzag_unpermute(perm, n, seq_dim=1).numpy(), x)
    with pytest.raises(ValueError, match="divisible"):
        tra.zigzag_permute(torch.zeros(1, 2 * n + 1), n)


def test_combine_and_block_update_match_jax():
    """The two pieces every body is made of: the logsumexp combine and
    the online-softmax step (with a causal mask on global positions)."""
    rs = np.random.RandomState(3)
    o, oj = (rs.randn(2, 3, 8, 4).astype(np.float32) for _ in range(2))
    lse, lsej = (rs.randn(2, 3, 8).astype(np.float32) for _ in range(2))
    got = tra._lse_combine(*(torch.from_numpy(a) for a in (o, lse, oj,
                                                           lsej)))
    want = jra._lse_combine(*(jnp.asarray(a) for a in (o, lse, oj, lsej)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OUT_TOL)
    q, k, v = (rs.randn(2, 3, 8, 4).astype(np.float32) for _ in range(3))
    m = rs.randn(2, 3, 8, 1).astype(np.float32)
    l = np.abs(rs.randn(2, 3, 8, 1)).astype(np.float32)
    acc = rs.randn(2, 3, 8, 4).astype(np.float32)
    qpos, kpos = np.arange(8, 16), np.arange(4, 12)
    got = tra._block_update(*(torch.from_numpy(a) for a in (
        q, k, v, m, l, acc, qpos, kpos)), True, 0.5)
    want = jra._block_update(*(jnp.asarray(a) for a in (
        q, k, v, m, l, acc, qpos, kpos)), True, 0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OUT_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_serial_fallback_matches_jax(causal):
    """Without a group both ops are one ``flash_attention`` call (its
    plain version on the CPU; the einsum attention without
    ``use_flash``), and agree with JAX's ``axis=None`` golden path."""
    rs = np.random.RandomState(4)
    q = rs.randn(2, 4, 16, 8).astype(np.float32)
    k, v = (rs.randn(2, 2, 16, 8).astype(np.float32) for _ in range(2))
    want = np.asarray(jra.ring_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                         causal=causal))
    for fn in (tra.ring_attention, tra.ulysses_attention):
        for use_flash in (True, False):
            got = fn(*(torch.from_numpy(a) for a in (q, k, v)),
                     causal=causal, use_flash=use_flash)
            np.testing.assert_allclose(got.numpy(), want, **OUT_TOL)
