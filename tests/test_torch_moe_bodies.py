"""K6's and K7's body routing and the host-side pieces of their warpgroup
bodies, on the CPU: ``moe_ffn_body`` and ``expert_ffn_body`` at their
thresholds, K6's device tile list (``chunk_tiles``) against a numpy
statement of its rule, and the plain versions (the wrappers on CPU
tensors) against the JAX package's ``moe_ffn_oracle`` and
``_ep_ffn_reference`` at the new bodies' edge shapes: capacities 130 and
200 with holes inside filled tiles, groups of 1 and 8 rows.

Inputs are made with numpy or JAX's init and handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.ops import moe_dispatch as jmd
from torchdistpackage_tpu.parallel import moe as jmoe
from torchdistpackage_tpu_torch.ops import moe_dispatch as md
from torchdistpackage_tpu_torch.parallel.moe import _top_k_route

RTOL, ATOL = 1e-5, 1e-5  # f32, summation order only
E, K, D, FF = 4, 2, 64, 192  # D and F multiples of 64, F not of 128


# ------------------------------------------------------------ routing


@pytest.mark.parametrize("C,dtype,body", [
    (8, torch.bfloat16, "decode"),     # decode: T = C = 8
    (15, torch.bfloat16, "decode"),
    (16, torch.bfloat16, "decode"),
    (200, torch.bfloat16, "wgmma"),
    (4096, torch.bfloat16, "wgmma"),   # a 512-row chunk of 8 slots
    (4096, torch.float32, "walk"),     # f32 tokens: CUDA-core body only
    (1, torch.bfloat16, "decode"),     # the decode body's threshold
    (8, torch.float32, "walk"),
    (63, torch.bfloat16, "decode"),
    (64, torch.bfloat16, "wgmma"),     # the warpgroup body's threshold
])
def test_moe_ffn_body_routes_by_slots_and_dtype(C, dtype, body):
    """K6's dispatch between its three hand-written bodies: bf16 tokens at
    ``MOE_FFN_WGMMA_C_MIN`` slots an expert or more take the warpgroup
    body (float and int8 experts alike: the choice reads neither), fewer
    bf16 slots down to ``MOE_FFN_DECODE_C_MIN`` (decode) the swap-AB
    decode body, f32 tokens the walk."""
    assert md.MOE_FFN_WGMMA_C_MIN == 64
    assert md.MOE_FFN_DECODE_C_MIN == 1
    assert md.moe_ffn_body(C, dtype) == body


@pytest.mark.parametrize("G,dtype,body", [
    (1, torch.bfloat16, "decode"),
    (8, torch.bfloat16, "decode"),     # EP 1 decode: [8, 8, 4096]
    (1, torch.float32, "walk"),
    (8, torch.float32, "walk"),
])
def test_expert_ffn_body_takes_decode_rows_down_to_one(G, dtype, body):
    """K7's decode body takes every bf16 group below the chunk body's
    threshold, down to one row (``EXPERT_FFN_DECODE_G_MIN`` 1); the walk
    keeps f32 rows."""
    assert md.EXPERT_FFN_DECODE_G_MIN == 1
    assert md.expert_ffn_body(G, dtype) == body


# ------------------------------------------------- K6's device tile list


def _tile_rule(comb, rows):
    """The tile list in numpy: per expert, tiles of ``rows`` slots (the
    last ragged), named e n + t; the ones holding a filled slot first, in
    order, then the rest; and how many listed tiles come before each
    expert (and in all)."""
    e_, c_ = comb.shape
    n = -(-c_ // rows)
    busy = [(comb[e, t * rows:(t + 1) * rows] != 0).any()
            for e in range(e_) for t in range(n)]
    listed = [i for i, b in enumerate(busy) if b]
    offs = [sum(busy[:e * n]) for e in range(e_ + 1)]
    return listed + [i for i, b in enumerate(busy) if not b], offs


def _serving_comb(T, C, seed, e=E):
    """Slot maps of a real routing decision (top-2 at capacity C)."""
    logits = np.random.RandomState(seed).randn(T, e).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(logits) * 2, -1)
    return md.slot_maps(*_top_k_route(probs, K, C), C)[1]


@pytest.mark.parametrize("case", [
    "serving_c_eq_t", "holes", "drops_c100", "c130", "c200_holes",
    "all_empty", "all_full", "sparse_random"])
def test_chunk_tiles_match_numpy_rule(case):
    """``chunk_tiles`` on CPU tensors (the same torch ops run on the card,
    with no host sync) against the rule stated in numpy: holes inside
    filled tiles, capacity drops, C not a multiple of 128."""
    if case == "serving_c_eq_t":     # prefix-filled, 3/4 of tiles empty
        comb = _serving_comb(1024, 1024, 1)
    elif case == "holes":
        comb = _serving_comb(512, 512, 2)
        comb = torch.where(torch.arange(512) % 5 == 2, 0.0, comb)
    elif case == "drops_c100":
        comb = _serving_comb(512, 100, 3)
    elif case == "c130":
        comb = _serving_comb(260, 130, 4)
    elif case == "c200_holes":
        comb = _serving_comb(400, 200, 5)
        comb[:, 128:200] = 0  # a tile emptied wholly by holes
        comb[1, 7] = 0
    elif case == "all_empty":
        comb = torch.zeros(E, 300)
    elif case == "all_full":
        comb = torch.rand(E, 300) + 0.1
    else:
        rs = np.random.RandomState(6)
        comb = torch.from_numpy(np.where(rs.rand(6, 700) < 0.002,
                                         rs.rand(6, 700), 0.0)).float()
    tiles, offs = md.chunk_tiles(comb)
    want, want_offs = _tile_rule(comb.numpy(), md.CHUNK_ROWS)
    assert tiles.dtype == torch.int32 and offs.dtype == torch.int32
    assert offs.shape == (comb.shape[0] + 1,)
    assert offs.tolist() == want_offs
    assert tiles.tolist() == want
    if case == "serving_c_eq_t":  # the bound at serving: ceil(T k/128) + E
        assert int(offs[-1]) <= -(-1024 * K // md.CHUNK_ROWS) + E


# ------------------------------------- the plain versions against JAX


def _jexperts(act, seed, quantized):
    cfg = jmoe.MoEConfig(dim=D, ffn_dim=FF, num_experts=E, top_k=K, act=act)
    ex = jax.tree.map(np.asarray, jmoe.init_moe_params(
        jax.random.PRNGKey(seed), cfg))["experts"]
    rs = np.random.RandomState(seed)
    for b in ("b1", "b2"):
        ex[b] = rs.randn(*ex[b].shape).astype(np.float32) * 0.1
    if quantized:
        ex = jax.tree.map(np.asarray, jmd.quantize_moe_experts(ex))
    return ex


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_t(v) for v in tree)
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
@pytest.mark.parametrize("C", [130, 200])
def test_k6_plain_matches_jax_oracle_with_holes(C, act, quantized):
    """K6's plain version (the wrapper on CPU tensors and the port's
    ``moe_ffn_oracle``) against JAX's ``moe_ffn_oracle`` at capacities the
    warpgroup body takes past one 128-slot tile (C = T 130 and 200), with
    holes: every seventh (token, choice) gets gate value 0, so its slot is
    empty inside a filled tile."""
    ex = _jexperts(act, seed=C, quantized=quantized)
    x = np.random.RandomState(C + 1).randn(C, D).astype(np.float32)
    logits = np.random.RandomState(C + 2).randn(C, E).astype(np.float32)
    route = jmoe._top_k_route(jax.nn.softmax(jnp.asarray(logits) * 2, -1),
                              K, C)
    gv = np.array(route[0])
    gv.reshape(-1)[::7] = 0.0  # holes
    route = (jnp.asarray(gv),) + tuple(route[1:])
    want = np.asarray(jmd.moe_ffn_oracle(jax.tree.map(jnp.asarray, ex),
                                         jnp.asarray(x), *route, C))
    troute = [torch.from_numpy(np.array(a)) for a in route]
    tex = _t(ex)
    idx, comb = md.slot_maps(*troute, C)
    assert float((comb == 0).sum()) > E * C - C * K  # holes exist
    got = md.moe_ffn_oracle(tex, torch.from_numpy(x), *troute, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    before = dict(md.LAUNCHES)
    fused = md.fused_moe_ffn(tex, torch.from_numpy(x), *troute, C)
    assert md.LAUNCHES == before  # CPU tensors: the plain version
    np.testing.assert_allclose(fused.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
@pytest.mark.parametrize("G", [1, 8])
def test_k7_plain_matches_jax_at_decode_rows(G, act, quantized):
    """K7's plain version (the wrapper on CPU tensors and
    ``expert_ffn_reference``) against JAX's ``_ep_ffn_reference`` at the
    decode body's row counts: ``[e_loc 2, G, D]`` with G 1 and 8, one pad
    row of zeros in the 8."""
    ex = _jexperts(act, seed=G + 40, quantized=quantized)
    ex = {n: (tuple(a[:2] for a in v) if isinstance(v, tuple) else v[:2])
          for n, v in ex.items()}
    x = np.random.RandomState(G).randn(2, G, D).astype(np.float32)
    if G > 1:
        x[:, 3] = 0  # a pad row
    want = np.asarray(jmd._ep_ffn_reference(jax.tree.map(jnp.asarray, ex),
                                            jnp.asarray(x)))
    tex = _t(ex)
    before = dict(md.LAUNCHES)
    got = md.fused_expert_ffn(tex, torch.from_numpy(x))
    assert md.LAUNCHES == before  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        md.expert_ffn_reference(tex, torch.from_numpy(x)).numpy(), want,
        rtol=RTOL, atol=ATOL)
