"""The decode rows' split-KV schedule (K1's and K2's decode body on the
card) in its plain form, against the JAX package, on the CPU, in f32.

- ``paged_decode_split_reference`` — each split's partial carry by K2's
  plain version over that split's share of the blocks under the kernels'
  own plan (``decode_split_plan``), merged in index order after the
  incoming carry (``merge_partials``) — finished, against JAX's K1
  (``paged_decode_attention`` in interpret mode), and hop by hop through
  a two-hop chain over half-pool slices with the carry seeded, against
  JAX's K2 (``paged_carry_attention``), within 1e-5: NSPLIT 1, 2, 3, 7
  and more than the live blocks, windows None and 48, S_in 1 and 3.
- The plan itself: every block a slot's rows can see falls in exactly
  one split, for random offsets, windows and split counts; NSPLIT is a
  function of the grid and the table width alone.
- The merge: a lone partial passes through exactly; partials that met
  no key leave the carry exactly as it came in.
- ``_build.variant``, which the card's planted-fault checks run the
  split path's fault builds through: it swaps the library in and puts
  the old one back.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.ops import paged_attention as jpa
from torchdistpackage_tpu_torch.ops import _build
from torchdistpackage_tpu_torch.ops import paged_attention as pa

B, HKV, G, HD, BS, MB = 2, 2, 4, 16, 16, 7
NB = 1 + B * MB
OFFS = np.asarray([40, 100], np.int32)  # slot 1 sees 7 blocks (5 at w48)
SPLITS = [1, 2, 3, 7, 9]  # 9: more splits than any slot's live blocks
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _inputs(s_in, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, HKV * G, s_in, HD).astype(np.float32)
    k = rs.randn(NB, HKV, BS, HD).astype(np.float32)
    v = rs.randn(NB, HKV, BS, HD).astype(np.float32)
    tables = (rs.permutation(NB - 1) + 1).reshape(B, MB).astype(np.int32)
    return q, k, v, tables


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL, err_msg=what)


_JAX = {}  # one interpret-mode JAX run per case, shared by the NSPLITs


def _jax_k1(s_in, window):
    key = ("k1", s_in, window)
    if key not in _JAX:
        q, k, v, tables = _inputs(s_in)
        _JAX[key] = np.asarray(jpa.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(tables), jnp.asarray(OFFS), window=window))
    return _JAX[key]


def _halves(k, v, tables):
    per = -(-NB // 2)
    pad = np.zeros((per * 2 - NB,) + k.shape[1:], np.float32)
    k, v = np.concatenate([k, pad]), np.concatenate([v, pad])
    return [(k[i * per:(i + 1) * per], v[i * per:(i + 1) * per],
             tables - i * per) for i in range(2)]


def _jax_k2_chain(s_in, window):
    key = ("k2", s_in, window)
    if key not in _JAX:
        q, k, v, tables = _inputs(s_in, seed=1)
        carry, hops = None, []
        for ks, vs, tab in _halves(k, v, tables):
            carry = jpa.paged_carry_attention(
                jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs),
                jnp.asarray(tab), jnp.asarray(OFFS), carry=carry,
                window=window)
            hops.append(carry)
        H = HKV * G
        _JAX[key] = (hops, np.asarray(jpa.finalize_paged_carry(
            carry, B, H, s_in, HD, jnp.float32)))
    return _JAX[key]


@pytest.mark.parametrize("nsplit", SPLITS)
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("s_in", [1, 3])
def test_split_reference_matches_jax_k1(s_in, window, nsplit):
    q, k, v, tables = _inputs(s_in)
    carry = pa.paged_decode_split_reference(
        _t(q), _t(k), _t(v), _t(tables), _t(OFFS), nsplit=nsplit,
        window=window)
    got = pa.finalize_paged_carry(carry, B, HKV * G, s_in, HD,
                                  torch.float32)
    _close(got.numpy(), _jax_k1(s_in, window), f"nsplit {nsplit}")


@pytest.mark.parametrize("nsplit", SPLITS)
@pytest.mark.parametrize("window", [None, 48])
def test_split_reference_matches_jax_k2_chain(window, nsplit):
    """Two hops over half-pool slices through re-based tables, the second
    seeded with the first's carry: some splits own no block of a slice.
    Interim hops compare acc and l on rows with a real m (JAX's interim
    carry counts masked keys on a row that met no owned key)."""
    s_in = 1
    R = G * s_in
    q, k, v, tables = _inputs(s_in, seed=1)
    jhops, jout = _jax_k2_chain(s_in, window)
    carry = None
    for i, ((ks, vs, tab), jcarry) in enumerate(zip(_halves(k, v, tables),
                                                    jhops)):
        carry = pa.paged_decode_split_reference(
            _t(q), _t(ks), _t(vs), _t(tab), _t(OFFS), nsplit=nsplit,
            carry=carry, window=window)
        acc, m, l = (t.numpy() for t in carry)
        jacc = np.asarray(jcarry[0])[:, :, :R]
        jm, jl = (np.asarray(x)[:, :, :R, 0] for x in jcarry[1:])
        _close(m, jm, f"m after hop {i}")
        met = jm > -1e29 if i == 0 else np.ones_like(jm, bool)
        _close(l[met], jl[met], f"l after hop {i}")
        _close(acc[met], jacc[met], f"acc after hop {i}")
    got = pa.finalize_paged_carry(carry, B, HKV * G, s_in, HD, torch.float32)
    _close(got.numpy(), jout, "finished output")


@pytest.mark.parametrize("seed", range(6))
def test_split_plan_puts_every_block_in_exactly_one_split(seed):
    rs = np.random.RandomState(seed)
    mb = int(rs.randint(1, 300))
    s_in = int(rs.choice([1, 3, 16]))
    offs = rs.randint(0, mb * BS + 40, size=8).tolist()
    window = [None, 48, 4096, int(rs.randint(1, 2000))][seed % 4]
    nsplit = int(rs.randint(1, 80))
    for off, shares in zip(offs, pa.decode_split_plan(offs, s_in, window,
                                                      mb, nsplit)):
        assert len(shares) == nsplit
        hi = min((off + s_in - 1) // BS + 1, mb)
        lo = max(0, off - window + 1) // BS if window else 0
        seen = [j for a, b in shares for j in range(a, b)]
        assert seen == list(range(lo, hi))  # in order, each block once
        sizes = [b - a for a, b in shares]
        assert max(sizes) - min(sizes) <= 1  # near-equal shares


@pytest.mark.parametrize("bh,mb,sms,want", [
    (64, 288, 132, 8), (32, 2048, 132, 16), (64, 8, 132, 2),
    (4096, 288, 132, 1), (1, 1, 132, 1), (8, 256, 132, 64),
    (256, 512, 132, 2)])
def test_decode_splits_from_grid_and_table_width(bh, mb, sms, want):
    """NSPLIT keeps the grid within DECODE_CTAS_PER_SM CTAs an SM, cut so
    that no split of the widest table gets fewer than DECODE_MIN_BLOCKS
    blocks; the offsets never enter."""
    got = pa.decode_splits(bh, mb, sms)
    assert got == want
    assert 1 <= got <= max(1, -(-mb // pa.DECODE_MIN_BLOCKS))


def test_merge_passes_a_lone_partial_and_keeps_an_unmet_carry_exactly():
    q, k, v, tables = _inputs(1)
    one = pa.paged_carry_attention_reference(_t(q), _t(k), _t(v),
                                             _t(tables), _t(OFFS))
    merged = pa.merge_partials([one])
    for a, b in zip(merged, one):
        assert torch.equal(a, b)
    remote = pa.paged_carry_attention_reference(
        _t(q), _t(k), _t(v), _t(np.full_like(tables, NB + 3)), _t(OFFS))
    again = pa.merge_partials([remote, remote, remote], carry=one)
    for a, b in zip(again, one):
        assert torch.equal(a, b)
    empty = pa.merge_partials([remote, remote])
    assert (empty[0] == 0).all() and (empty[2] == 0).all()
    assert (empty[1] == pa.NEG_INF).all()


@pytest.mark.parametrize("loaded", [True, False])
def test_build_variant_swaps_and_restores(monkeypatch, loaded):
    """Inside ``_build.variant`` every loader of the source gets the -D
    build; after it (also after an error) the library it had, or none."""
    base, fault = object(), object()
    libs = {"paged_attention -DTDP_PAGED_FAULT=1": fault}
    if loaded:
        libs["paged_attention"] = base
    monkeypatch.setattr(_build, "_LIBS", libs)
    for boom in (False, True):
        with pytest.raises(KeyError) if boom else contextlib.nullcontext():
            with _build.variant("paged_attention",
                                ("TDP_PAGED_FAULT=1",)) as lib:
                assert lib is fault
                assert _build.load("paged_attention") is fault
                if boom:
                    raise KeyError("inside the block")
        assert _build._LIBS.get("paged_attention") is (base if loaded
                                                         else None)
