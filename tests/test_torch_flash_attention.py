"""The port's flash attention against the JAX package's, on the CPU, in f32.

JAX's ``flash_attention`` runs its Pallas kernels in interpret mode here
(``block_q = block_k = 16``, as ``tests/test_attention_ops.py`` runs
them); the port's runs its plain versions, through the same
``autograd.Function`` the card uses (forward K3's plain version, backward
delta then K4's and K5's).  Inputs come from numpy seeds.  Tolerances as
the JAX package's own tests state them: forward 2e-5, grads 5e-4 (f32;
the two sum in different orders, and the grads go through one more
product).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.ops import flash_attention as jflash
from torchdistpackage_tpu.ops.flash_attention import (
    flash_attention_with_lse as jflash_lse,
)
from torchdistpackage_tpu_torch.ops import flash_attention as tfa

B, H, S, D = 2, 4, 64, 16
FWD_TOL, GRAD_TOL = 2e-5, 5e-4


def _inputs(kv_heads, seed, s=S):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, s, D).astype(np.float32)
    k = rs.randn(B, kv_heads, s, D).astype(np.float32)
    v = rs.randn(B, kv_heads, s, D).astype(np.float32)
    w = rs.randn(B, H, s, D).astype(np.float32)  # cotangent weights
    return q, k, v, w


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=what)


def _torch(*arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


CASES = {
    "mha_causal": dict(causal=True, kv_heads=H, window=None),
    "mha_full": dict(causal=False, kv_heads=H, window=None),
    "gqa2_causal": dict(causal=True, kv_heads=2, window=None),
    "mqa_full": dict(causal=False, kv_heads=1, window=None),
    "mqa_causal": dict(causal=True, kv_heads=1, window=None),
    "gqa2_window24": dict(causal=True, kv_heads=2, window=24),
    "mha_window7": dict(causal=True, kv_heads=H, window=7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_forward_and_grads_match_jax(case):
    c = CASES[case]
    q, k, v, w = _inputs(c["kv_heads"], seed=len(case))

    def jloss(q, k, v):
        o = jflash(q, k, v, causal=c["causal"], window=c["window"],
                   block_q=16, block_k=16)
        return jnp.sum(o * w), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(q, k, v)
    tq, tk, tv = _torch(q, k, v)
    to = tfa.flash_attention(tq, tk, tv, causal=c["causal"],
                             window=c["window"])
    _close(to, jo, FWD_TOL, f"{case}: forward")
    (to * torch.from_numpy(w)).sum().backward()
    for name, t, j in zip("qkv", (tq, tk, tv), jg):
        assert tuple(t.grad.shape) == j.shape
        _close(t.grad, j, GRAD_TOL, f"{case}: d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_with_lse_cotangent_matches_jax(causal):
    """A cotangent on lse (the ``dlse`` term folded into delta)."""
    q, k, v, w = _inputs(2, seed=7)
    u = np.random.RandomState(8).randn(B, H, S).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jflash_lse(q, k, v, causal=causal, block_q=16, block_k=16)
        return jnp.sum(o * w) + jnp.sum(lse * u), (o, lse)

    (_, (jo, jlse)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = _torch(q, k, v)
    to, tlse = tfa.flash_attention_with_lse(tq, tk, tv, causal=causal)
    _close(to, jo, FWD_TOL, "o")
    _close(tlse, jlse, FWD_TOL, "lse")
    ((to * torch.from_numpy(w)).sum()
     + (tlse * torch.from_numpy(u)).sum()).backward()
    for name, t, j in zip("qkv", (tq, tk, tv), jg):
        _close(t.grad, j, GRAD_TOL, f"d{name} with an lse cotangent")


def test_mha_reference_matches_jax_flash():
    """The port's ``'naive'`` attention (plain ops, autograd) against
    JAX's flash kernel, with GQA and a window."""
    q, k, v, w = _inputs(2, seed=11)
    jo = jflash(q, k, v, causal=True, window=20, block_q=16, block_k=16)
    to = tfa.mha_reference(*map(torch.from_numpy, (q, k, v)), causal=True,
                           window=20)
    _close(to, jo, FWD_TOL, "mha_reference")


def test_plain_pieces_agree_with_autograd():
    """K4's and K5's plain versions against autograd through
    ``mha_reference`` (the derivation the kernels implement)."""
    q, k, v, w = _inputs(2, seed=3)
    tq, tk, tv = _torch(q, k, v)
    o = tfa.mha_reference(tq, tk, tv, causal=True, window=30)
    (o * torch.from_numpy(w)).sum().backward()
    qq, kk, vv = map(torch.from_numpy, (q, k, v))
    scale = D ** -0.5
    o2, lse = tfa.flash_fwd_reference(qq, kk, vv, scale, True, 30)
    delta = tfa.flash_delta(o2, torch.from_numpy(w), None)
    dq = tfa.flash_bwd_dq_reference(qq, kk, vv, torch.from_numpy(w), lse,
                                    delta, scale, True, 30)
    dk, dv = tfa.flash_bwd_dkv_reference(qq, kk, vv, torch.from_numpy(w),
                                         lse, delta, scale, True, 30)
    for got, want in ((o2, o), (dq, tq.grad), (dk, tk.grad), (dv, tv.grad)):
        np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_argument_checks():
    q, k, v, _ = _inputs(2, seed=0)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError, match="Sq == Sk"):
        tfa.flash_attention(tq[:, :, :32], tk, tv, causal=True)
    with pytest.raises(ValueError, match="Sq == Sk"):
        tfa.mha_reference(tq[:, :, :32], tk, tv, causal=True)
    out = tfa.flash_attention(tq[:, :, :32], tk, tv, causal=False)
    assert tuple(out.shape) == (B, H, 32, D)
    with pytest.raises(ValueError, match="divisible"):
        tfa.flash_attention(tq[:, :3], tk, tv)
    with pytest.raises(ValueError, match="requires causal"):
        tfa.flash_attention(tq, tk, tv, causal=False, window=8)
    with pytest.raises(ValueError, match=">= 1"):
        tfa.flash_attention(tq, tk, tv, window=0)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """On a non-CPU tensor the wrapper launches or raises; the shape and
    dtype checks run before any build (a meta tensor stands in for a
    card here)."""
    meta = torch.device("meta")
    q = torch.empty(1, 2, 64, 64, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_fwd(q, q, q, 0.125, True, None)
    assert tfa.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0}


# The card's bf16 K3 runs 128-row query tiles over 128-key tiles and K5
# 128-key CTAs over 64- or 128-query tiles, while sequence lengths are
# multiples of 64: these are the shapes that tiling makes risky (a ragged
# last 128-row tile, a window edge inside a 128-key tile, GQA groups, the
# non-causal Sq != Sk case).  The plain versions the card is held against
# are held here against JAX's own ``_fwd`` / ``_bwd`` (Pallas, interpret
# mode, 64-row blocks), f32, from the same numpy inputs.
TILE_CASES = {
    # name: (B, H, Hkv, Sq, Sk, hd, causal, window)
    "s192_hd64_g1_causal": (1, 2, 2, 192, 192, 64, True, None),
    "s320_hd128_g4_causal": (1, 4, 1, 320, 320, 128, True, None),
    "s320_hd64_g4_w100": (1, 4, 1, 320, 320, 64, True, 100),
    "s192_hd128_g1_w80": (1, 2, 2, 192, 192, 128, True, 80),
    "s320_hd64_g1_w80": (1, 1, 1, 320, 320, 64, True, 80),
    "s192_hd128_g4_w100": (1, 4, 1, 192, 192, 128, True, 100),
    "sq192_sk320_hd64_g4_full": (1, 4, 1, 192, 320, 64, False, None),
    "sq320_sk192_hd128_g1_full": (1, 2, 2, 320, 192, 128, False, None),
}


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_plain_versions_match_jax_kernels_at_tile_shapes(case):
    from torchdistpackage_tpu.ops.flash_attention import _bwd, _fwd

    b, h, hkv, sq, sk, hd, causal, window = TILE_CASES[case]
    rs = np.random.RandomState(sum(map(ord, case)))
    q = rs.randn(b, h, sq, hd).astype(np.float32)
    k = rs.randn(b, hkv, sk, hd).astype(np.float32)
    v = rs.randn(b, hkv, sk, hd).astype(np.float32)
    do = rs.randn(b, h, sq, hd).astype(np.float32)
    dlse = rs.randn(b, h, sq).astype(np.float32)
    scale, groups = hd ** -0.5, h // hkv

    def flat(a):
        return jnp.asarray(a.reshape(-1, *a.shape[2:]))

    jq, jk, jv, jdo = map(flat, (q, k, v, do))
    jo, jlse = _fwd(jq, jk, jv, scale, causal, 64, 64, groups, window)
    jdq, jdk, jdv = _bwd(scale, causal, 64, 64, groups, window,
                         (jq, jk, jv, jo, jlse), (jdo, flat(dlse)[..., None]))

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_fwd_reference(tq, tk, tv, scale, causal, window)
    _close(o.reshape(-1, sq, hd), jo, FWD_TOL, f"{case}: o")
    _close(lse.reshape(-1, sq, 1), jlse, FWD_TOL, f"{case}: lse")
    delta = tfa.flash_delta(o, tdo, torch.from_numpy(dlse))
    args = (tq, tk, tv, tdo, lse, delta, scale, causal, window)
    dq = tfa.flash_bwd_dq_reference(*args)
    dk, dv = tfa.flash_bwd_dkv_reference(*args)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
        _close(got.reshape(want.shape), want, GRAD_TOL, f"{case}: {name}")


def test_wrappers_take_s192_and_refuse_s96():
    """Sequence lengths that no tile divides (192 for the 128-row tiles,
    96 and 1 for every tile) are taken — the kernels' last tile is ragged,
    so the refusal that follows is only the meta device's; what the shape
    check still refuses is a head dim of 96 (the name is older than the
    ragged-length repair, when S 96 was refused)."""
    meta = torch.device("meta")
    for name, call in (
            ("flash_fwd", lambda q: tfa.flash_fwd(q, q, q, 0.125, True,
                                                  None)),
            ("flash_bwd_dkv", lambda q: tfa.flash_bwd_dkv(
                q, q, q, q, q[..., 0].float(), q[..., 0].float(), 0.125,
                True, None))):
        for S in (192, 96, 1):
            q = torch.empty(1, 2, S, 64, device=meta, dtype=torch.bfloat16)
            with pytest.raises(ValueError, match="unsupported device"):
                call(q)
        q = torch.empty(1, 2, 96, 96, device=meta, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dim must be 64 or 128"):
            call(q)
    assert tfa.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0}


# bf16 K4 runs 128-row query tiles over 128-key tiles (wgmma, TMA-fed):
# these are the edges of that tiling — a ragged last 128-row tile (S 192),
# a window edge inside a 128-key tile, GQA groups of 4 at hd 128, the
# non-causal Sq != Sk case — each with a non-zero lse cotangent (dlse,
# folded into delta).  dq's plain version is held against JAX's own
# ``_bwd`` dq (Pallas, interpret mode), f32, from the same numpy inputs.
DQ_EDGE_CASES = {
    # name: (B, H, Hkv, Sq, Sk, hd, causal, window)
    "s192_hd64_g1_causal": (1, 2, 2, 192, 192, 64, True, None),
    "s192_hd128_g4_causal": (1, 4, 1, 192, 192, 128, True, None),
    "s256_hd128_g4_w70": (1, 4, 1, 256, 256, 128, True, 70),
    "s320_hd64_g1_w150": (1, 2, 2, 320, 320, 64, True, 150),
    "sq192_sk320_hd128_g4_full": (1, 4, 1, 192, 320, 128, False, None),
}


@pytest.mark.parametrize("case", sorted(DQ_EDGE_CASES))
def test_dq_plain_version_matches_jax_at_k4_tile_edges(case):
    from torchdistpackage_tpu.ops.flash_attention import _bwd, _fwd

    b, h, hkv, sq, sk, hd, causal, window = DQ_EDGE_CASES[case]
    rs = np.random.RandomState(sum(map(ord, case)))
    q = rs.randn(b, h, sq, hd).astype(np.float32)
    k = rs.randn(b, hkv, sk, hd).astype(np.float32)
    v = rs.randn(b, hkv, sk, hd).astype(np.float32)
    do = rs.randn(b, h, sq, hd).astype(np.float32)
    dlse = rs.randn(b, h, sq).astype(np.float32)
    scale, groups = hd ** -0.5, h // hkv

    def flat(a):
        return jnp.asarray(a.reshape(-1, *a.shape[2:]))

    jq, jk, jv, jdo = map(flat, (q, k, v, do))
    jo, jlse = _fwd(jq, jk, jv, scale, causal, 64, 64, groups, window)
    jdq, _, _ = _bwd(scale, causal, 64, 64, groups, window,
                     (jq, jk, jv, jo, jlse), (jdo, flat(dlse)[..., None]))

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_fwd_reference(tq, tk, tv, scale, causal, window)
    delta = tfa.flash_delta(o, tdo, torch.from_numpy(dlse))
    dq = tfa.flash_bwd_dq_reference(tq, tk, tv, tdo, lse, delta, scale,
                                    causal, window)
    _close(dq.reshape(jdq.shape), jdq, GRAD_TOL, f"{case}: dq")


def test_dq_wrapper_takes_s192_and_refuses_s96():
    """``flash_bwd_dq`` as ``test_wrappers_take_s192_and_refuse_s96`` holds
    K3's and K5's wrappers: S 192 and S 96 (ragged last tiles) reach the
    device check, a head dim of 96 is refused by the shape check, and
    nothing is counted."""
    meta = torch.device("meta")
    for s, hd, match in ((192, 64, "unsupported device"),
                         (96, 64, "unsupported device"),
                         (96, 96, "head dim must be 64 or 128")):
        q = torch.empty(1, 2, s, hd, device=meta, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=match):
            tfa.flash_bwd_dq(q, q, q, q, q[..., 0].float(),
                             q[..., 0].float(), 0.125, True, None)
    assert tfa.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0}
