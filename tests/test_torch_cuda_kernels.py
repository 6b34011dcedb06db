"""The port's CUDA kernels against their plain versions, on the card.

Every test here is ``gpu``-marked and skips without a CUDA device (a
kernel has no CPU mode).  The file imports neither JAX nor the JAX
package, so it also runs where JAX is absent; there the repo's
``tests/conftest.py`` (which imports JAX) is bypassed::

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from torchdistpackage_tpu_torch.ops.paged_attention import (
    LAUNCHES,
    paged_decode_attention,
    paged_decode_attention_reference,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _assert_rows_close(got, want, dtype):
    """Row by row (one query row of one head).  f32: 2e-5, summation
    order only.  bf16: 2 bf16 ulps of the row's own largest |value| —
    the kernel rounds its unnormalised probabilities to bf16 before P.V
    and its output once, each below one ulp of the row; a row that sees
    one key is as large as v, one that sees thousands about
    1/sqrt(context), so a single tolerance would be set by the largest."""
    err = (got.float() - want.float()).abs().amax(-1)
    if dtype == torch.float32:
        tol = torch.full_like(err, 2e-5)
    else:
        scale = want.float().abs().amax(-1).clamp_min(2.0 ** -100)
        tol = 2.0 * torch.exp2(torch.floor(torch.log2(scale)) - 7)
    assert torch.isfinite(got).all()
    worst = float((err / tol).max())
    assert worst <= 1.0, f"{worst:.3f} of the row tolerance"


def _f32(pool):
    return pool if isinstance(pool, tuple) else pool.float()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("s_in,window", [(1, None), (1, 64), (33, 48)])
def test_kernel_matches_plain_on_card(cuda, dtype, s_in, window):
    g = torch.Generator(device=cuda).manual_seed(0)
    hkv, groups, bs, hd, mb, b = 2, 4, 16, 128, 12, 3
    nb = 1 + b * mb
    tables = torch.randperm(nb - 1, generator=g, device=cuda)[:b * mb]
    tables = (tables + 1).reshape(b, mb).to(torch.int32)
    offs = torch.tensor([0, 70, mb * bs - s_in], dtype=torch.int32,
                        device=cuda)
    qdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    q = torch.randn(b, hkv * groups, s_in, hd, generator=g, device=cuda
                    ).to(qdt)
    if dtype == "int8":
        pools = [(torch.randint(-127, 128, (nb, hkv, bs, hd), generator=g,
                                device=cuda, dtype=torch.int8),
                  torch.rand(nb, hkv, bs, generator=g, device=cuda) * 0.02)
                 for _ in range(2)]
    else:
        pools = [torch.randn(nb, hkv, bs, hd, generator=g, device=cuda
                             ).to(qdt) for _ in range(2)]
    before = LAUNCHES["paged_decode_attention"]
    got = paged_decode_attention(q, *pools, tables, offs, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["paged_decode_attention"] == before + 1
    # the plain version on the same values in f32: the exact arithmetic
    want = paged_decode_attention_reference(
        q.float(), *map(_f32, pools), tables, offs, window=window)
    _assert_rows_close(got, want, qdt)


@pytest.mark.gpu
def test_kernel_rows_past_the_table_and_null_tables_stay_finite(cuda):
    """The engine's edge rows: an inactive slot (all-NULL table, offset
    0) and a padded prefill tail whose positions run past the table with
    a window that masks every key the table holds.  The plain version
    gives NaN for the fully masked rows; the kernel gives finite values
    everywhere (its finite NEG_INF), and agrees on every row whose own
    position lies inside the table."""
    g = torch.Generator(device=cuda).manual_seed(1)
    hkv, groups, bs, hd, mb, b, s_in, window = 2, 4, 16, 128, 4, 2, 40, 8
    nb = 1 + mb
    tables = torch.zeros(b, mb, dtype=torch.int32, device=cuda)
    tables[1] = torch.arange(1, nb, dtype=torch.int32, device=cuda)
    offs = torch.tensor([0, mb * bs - 16], dtype=torch.int32, device=cuda)
    q = torch.randn(b, hkv * groups, s_in, hd, generator=g, device=cuda
                    ).to(torch.bfloat16)
    pools = [torch.randn(nb, hkv, bs, hd, generator=g, device=cuda
                         ).to(torch.bfloat16) for _ in range(2)]
    got = paged_decode_attention(q, *pools, tables, offs, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    want = paged_decode_attention_reference(
        q.float(), *map(_f32, pools), tables, offs, window=window)
    inside = 16  # slot 1's rows 0..15 sit at positions inside its table
    _assert_rows_close(got[:, :, :inside], want[:, :, :inside],
                       torch.bfloat16)


# ------------------------------------------------- flash attention, K3-K5


def _grad_rows_close(got, want, scale, dtype):
    """Gradients: f32 within 2e-5 of the row's largest |value| and at
    least 2e-5 (summation order only, over sums of up to G x S terms).
    bf16: 2 bf16 ulps of the row's largest |value| for the output
    rounding, plus 4 x 2^-8 of the row's largest rounding scale
    (``grad_rounding_scale``): the kernel rounds P or dS to bf16 before
    each product (as the TPU kernel does), which moves every term by up
    to 2^-8 of itself in random directions — 4 of those scales is about
    7 standard deviations."""
    err = (got.float() - want.float()).abs().amax(-1)
    big = want.float().abs().amax(-1)
    if dtype == torch.float32:
        tol = 2e-5 * big.clamp_min(1.0)
    else:
        tol = (2.0 * torch.exp2(torch.floor(torch.log2(
            big.clamp_min(2.0 ** -100))) - 7) + 4.0 * 2.0 ** -8
            * scale.amax(-1))
    assert torch.isfinite(got).all()
    worst = float((err / tol).max())
    assert worst <= 1.0, f"{worst:.3f} of the row tolerance"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("kv_heads,causal,window", [
    (4, True, None), (2, True, 80), (1, False, None), (4, False, None)])
def test_flash_kernels_match_plain_on_card(cuda, dtype, hd, kv_heads,
                                           causal, window):
    from torchdistpackage_tpu_torch.ops import flash_attention as fa

    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(hd + kv_heads)
    b, h, s = 2, 4, 192

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dt)

    q, do = rnd(b, h, s, hd), rnd(b, h, s, hd)
    k, v = rnd(b, kv_heads, s, hd), rnd(b, kv_heads, s, hd)
    dlse = torch.randn(b, h, s, generator=g, device=cuda)
    scale = hd ** -0.5
    args = (scale, causal, window)
    exact = [t.float() for t in (q, k, v, do)]
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, *args)
    o_x, lse_x = fa.flash_fwd_reference(*exact[:3], *args)
    delta = fa.flash_delta(o_x, exact[3], dlse)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_x, delta, *args)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_x, delta, *args)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    _assert_rows_close(o, o_x, dt)
    assert float((lse - lse_x).abs().max()) <= 2e-5
    sq, sk, sv = fa.grad_rounding_scale(*exact, lse_x, delta, *args)
    _grad_rows_close(dq, fa.flash_bwd_dq_reference(*exact, lse_x, delta,
                                                   *args), sq, dt)
    dk_x, dv_x = fa.flash_bwd_dkv_reference(*exact, lse_x, delta, *args)
    _grad_rows_close(dk, dk_x, sk, dt)
    _grad_rows_close(dv, dv_x, sv, dt)


@pytest.mark.gpu
def test_flash_attention_autograd_launches_each_kernel_once(cuda):
    from torchdistpackage_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(1, 4, 128, 64, generator=g, device=cuda,
                    dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn(1, 2, 128, 64, generator=g, device=cuda,
                    dtype=torch.bfloat16, requires_grad=True)
    v = torch.randn(1, 2, 128, 64, generator=g, device=cuda,
                    dtype=torch.bfloat16, requires_grad=True)
    before = dict(fa.LAUNCHES)
    fa.flash_attention(q, k, v, window=40).float().square().sum().backward()
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    assert k.grad.shape == k.shape and torch.isfinite(q.grad).all()
    with pytest.raises(ValueError, match="multiples of 64"):
        fa.flash_attention(q[:, :, :96].detach(), k[:, :, :96].detach(),
                           v[:, :, :96].detach())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.detach().transpose(2, 3).contiguous().transpose(2, 3),
                     k.detach(), v.detach(), 0.125, True, None)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_kernels_noncausal_unequal_lengths(cuda, dtype):
    """Non-causal attention with Sq != Sk (the only unequal-length case
    the kernels take), GQA 2: K3, K4, K5 against their plain versions."""
    from torchdistpackage_tpu_torch.ops import flash_attention as fa

    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(9)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dt)

    q, do = rnd(2, 4, 128, 64), rnd(2, 4, 128, 64)
    k, v = rnd(2, 2, 320, 64), rnd(2, 2, 320, 64)
    args = (0.125, False, None)
    exact = [t.float() for t in (q, k, v, do)]
    o, lse = fa.flash_fwd(q, k, v, *args)
    o_x, lse_x = fa.flash_fwd_reference(*exact[:3], *args)
    delta = fa.flash_delta(o_x, exact[3], None)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_x, delta, *args)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_x, delta, *args)
    torch.cuda.synchronize()
    _assert_rows_close(o, o_x, dt)
    assert float((lse - lse_x).abs().max()) <= 2e-5
    sq, sk, sv = fa.grad_rounding_scale(*exact, lse_x, delta, *args)
    _grad_rows_close(dq, fa.flash_bwd_dq_reference(*exact, lse_x, delta,
                                                   *args), sq, dt)
    dk_x, dv_x = fa.flash_bwd_dkv_reference(*exact, lse_x, delta, *args)
    _grad_rows_close(dk, dk_x, sk, dt)
    _grad_rows_close(dv, dv_x, sv, dt)


# bf16 K3 runs 128-row query tiles over 128-key tiles and K5 128-key CTAs
# over 64- or 128-query tiles (wgmma, TMA-fed); sequence lengths are
# multiples of 64.  These shapes put the edges where that tiling can go
# wrong: a ragged last 128-row tile (S 192, 320), a window edge inside a
# key tile (80, 100, 300), GQA groups of 1, 4 and 8, and the non-causal
# Sq != Sk case.
WG_SHAPES = [  # (q heads, kv heads, Sq, Sk, causal, window)
    (4, 4, 192, 192, True, None),
    (8, 2, 320, 320, True, None),
    (8, 1, 320, 320, True, 100),
    (4, 1, 192, 192, True, 80),
    (8, 8, 320, 320, True, 80),
    (4, 2, 192, 320, False, None),
    (4, 4, 320, 192, False, None),
    (8, 1, 1024, 1024, True, 300),
]


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("h,kv_heads,sq,sk,causal,window", WG_SHAPES)
def test_flash_wgmma_bodies_match_plain_on_card(cuda, hd, h, kv_heads, sq,
                                                sk, causal, window):
    """bf16 K3 and K5 (the warpgroup bodies) against their plain versions
    in f32 on the same values; K4 rides along on the same inputs."""
    from torchdistpackage_tpu_torch.ops import flash_attention as fa

    bf = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(sq + sk + hd + h)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(bf)

    q, do = rnd(2, h, sq, hd), rnd(2, h, sq, hd)
    k, v = rnd(2, kv_heads, sk, hd), rnd(2, kv_heads, sk, hd)
    dlse = torch.randn(2, h, sq, generator=g, device=cuda)
    args = (hd ** -0.5, causal, window)
    exact = [t.float() for t in (q, k, v, do)]
    o, lse = fa.flash_fwd(q, k, v, *args)
    o_x, lse_x = fa.flash_fwd_reference(*exact[:3], *args)
    delta = fa.flash_delta(o_x, exact[3], dlse)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_x, delta, *args)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_x, delta, *args)
    torch.cuda.synchronize()
    _assert_rows_close(o, o_x, bf)
    assert float((lse - lse_x).abs().max()) <= 2e-5
    sq_, sk_, sv_ = fa.grad_rounding_scale(*exact, lse_x, delta, *args)
    _grad_rows_close(dq, fa.flash_bwd_dq_reference(*exact, lse_x, delta,
                                                   *args), sq_, bf)
    dk_x, dv_x = fa.flash_bwd_dkv_reference(*exact, lse_x, delta, *args)
    _grad_rows_close(dk, dk_x, sk_, bf)
    _grad_rows_close(dv, dv_x, sv_, bf)


# bf16 K4 runs 128-row query tiles over 128-key tiles on wgmma: its
# warpgroup body against the plain version in f32 at hd 64 and 128, with
# the tile edges that body has — a ragged last row tile (S 192), a window
# edge inside a key tile, GQA groups of 4, the non-causal Sq != Sk case —
# and a non-zero dlse.
DQ_WG_SHAPES = [  # (q heads, kv heads, Sq, Sk, causal, window)
    (4, 4, 192, 192, True, None),
    (8, 2, 192, 192, True, 70),
    (4, 1, 320, 320, True, 150),
    (8, 2, 256, 256, True, None),
    (4, 1, 192, 320, False, None),
]


def _dq_case(cuda, hd, h, kv_heads, sq, sk, causal, window, seed):
    from torchdistpackage_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(torch.bfloat16)

    q, do = rnd(2, h, sq, hd), rnd(2, h, sq, hd)
    k, v = rnd(2, kv_heads, sk, hd), rnd(2, kv_heads, sk, hd)
    dlse = torch.randn(2, h, sq, generator=g, device=cuda)
    args = (hd ** -0.5, causal, window)
    exact = [t.float() for t in (q, k, v, do)]
    o_x, lse_x = fa.flash_fwd_reference(*exact[:3], *args)
    delta = fa.flash_delta(o_x, exact[3], dlse)
    dq_x = fa.flash_bwd_dq_reference(*exact, lse_x, delta, *args)
    sq_, _, _ = fa.grad_rounding_scale(*exact, lse_x, delta, *args)
    return (q, k, v, do, lse_x, delta, args), exact, dq_x, sq_


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("h,kv_heads,sq,sk,causal,window", DQ_WG_SHAPES)
def test_flash_dq_wgmma_body_matches_plain_on_card(cuda, hd, h, kv_heads, sq,
                                                   sk, causal, window):
    from torchdistpackage_tpu_torch.ops import flash_attention as fa

    (q, k, v, do, lse, delta, args), _, dq_x, scale = _dq_case(
        cuda, hd, h, kv_heads, sq, sk, causal, window, seed=sq + hd + h)
    before = fa.LAUNCHES["flash_bwd_dq"]
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, *args)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_bwd_dq"] == before + 1
    _grad_rows_close(dq, dq_x, scale, torch.bfloat16)


@pytest.mark.gpu
def test_flash_dq_wgmma_planted_faults_fail(cuda):
    """The row check catches K4's faults: delta read one query row off
    (the kernel handed delta shifted by one) and the dlse term left out
    (delta without it)."""
    from torchdistpackage_tpu_torch.ops import flash_attention as fa

    (q, k, v, do, lse, delta, args), exact, dq_x, scale = _dq_case(
        cuda, 128, 8, 2, 256, 256, True, 70, seed=3)
    _grad_rows_close(fa.flash_bwd_dq(q, k, v, do, lse, delta, *args), dq_x,
                     scale, torch.bfloat16)
    o_x, _ = fa.flash_fwd_reference(*exact[:3], *args)
    for bad in (torch.roll(delta, -1, dims=-1).contiguous(),
                fa.flash_delta(o_x, exact[3], None)):
        got = fa.flash_bwd_dq(q, k, v, do, lse, bad, *args)
        with pytest.raises(AssertionError, match="row tolerance"):
            _grad_rows_close(got, dq_x, scale, torch.bfloat16)


# ------------------------------------------------- fused MoE dispatch, K6


def _moe_rows_close(got, exact, scale, dtype):
    """Output row by output row (one token).  f32: 2e-5 of the row's
    largest |value| (F-split partial sums meet by atomics, in an order
    that varies).  bf16: 2 bf16 ulps of the row's largest |value| plus
    4 x 2^-8 of the row's largest rounding scale (``moe_rounding_scale``:
    the kernel rounds the activation to bf16 before the second
    product)."""
    err = (got.float() - exact).abs().amax(-1)
    big = exact.abs().amax(-1)
    if dtype == torch.float32:
        tol = 2e-5 * big
    else:
        tol = (2.0 * torch.exp2(torch.floor(torch.log2(
            big.clamp_min(2.0 ** -100))) - 7) + 4.0 * 2.0 ** -8
            * scale.amax(-1))
    assert torch.isfinite(got).all()
    ratio = torch.where(err == 0, torch.zeros_like(err),
                        err / tol.clamp_min(1e-30))
    worst = float(ratio.max())
    assert worst <= 1.0, f"{worst:.3f} of the row tolerance"


def _moe_inputs(cuda, *, T, C, E, D, F, act, dtype, seed, holes=False):
    from torchdistpackage_tpu_torch.ops.moe_dispatch import slot_maps
    from torchdistpackage_tpu_torch.parallel.moe import _top_k_route

    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=cuda) * std).to(dtype)

    swiglu = act == "swiglu"
    experts = {"w1": rnd(*((E, 2, D, F) if swiglu else (E, D, F)),
                         std=D ** -0.5),
               "b1": rnd(*((E, 2, F) if swiglu else (E, F)), std=0.1),
               "w2": rnd(E, F, D, std=F ** -0.5), "b2": rnd(E, D, std=0.1)}
    tokens = rnd(T, D)
    probs = torch.softmax(torch.randn(T, E, generator=g, device=cuda) * 2, -1)
    route = _top_k_route(probs, 2, C)
    idx, comb = slot_maps(*route, C)
    if holes:  # empty slots inside filled tiles
        comb = torch.where(torch.arange(C, device=cuda) % 5 == 2, 0.0, comb)
    return experts, tokens, idx, comb.contiguous(), route


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
@pytest.mark.parametrize("T,C,D,F,holes", [
    (40, 40, 256, 128, False),      # one partial capacity tile, C = T
    (300, 100, 576, 1408, False),   # drops; C, D, F not powers of two
    (256, 256, 128, 192, True),     # trailing empty tiles, in-tile holes
])
def test_moe_kernel_matches_plain_on_card(cuda, dtype, act, T, C, D, F,
                                          holes):
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    dt = getattr(torch, dtype)
    ex, tok, idx, comb, route = _moe_inputs(
        cuda, T=T, C=C, E=8, D=D, F=F, act=act, dtype=dt, seed=T + D,
        holes=holes)
    before = md.LAUNCHES["fused_moe_ffn"]
    got = md.fused_moe_ffn_slots(ex, tok, idx, comb)
    torch.cuda.synchronize()
    assert md.LAUNCHES["fused_moe_ffn"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (T, D)
    exact = md.moe_ffn_slots_reference(ex, tok, idx, comb)
    scale = md.moe_rounding_scale(ex, tok, idx, comb)
    _moe_rows_close(got.to(dt), exact, scale, dt)
    if not holes:  # the routing-level entry point, in the tokens' dtype
        y = md.fused_moe_ffn(ex, tok, *route, C)
        assert y.dtype == dt
        _moe_rows_close(y, exact, scale, dt)


@pytest.mark.gpu
def test_moe_kernel_wrapper_refuses_what_it_does_not_take(cuda):
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    ex, tok, idx, comb, _ = _moe_inputs(cuda, T=16, C=16, E=4, D=128,
                                        F=128, act="swiglu",
                                        dtype=torch.bfloat16, seed=1)
    with pytest.raises(ValueError, match="device"):
        md.fused_moe_ffn_slots(dict(ex, w2=ex["w2"].cpu()), tok, idx, comb)
    with pytest.raises(ValueError, match="device"):
        md.fused_moe_ffn_slots(ex, tok, idx.cpu(), comb)
    q8 = dict(ex, w1=(ex["w1"].to(torch.int8),
                      torch.ones(4, 2, 128, device=cuda)))
    with pytest.raises(NotImplementedError, match="int8"):
        md.fused_moe_ffn_slots(q8, tok, idx, comb)
    odd = _moe_inputs(cuda, T=16, C=16, E=4, D=96, F=128, act="swiglu",
                      dtype=torch.bfloat16, seed=2)
    with pytest.raises(ValueError, match="multiples of 64"):
        md.fused_moe_ffn_slots(*odd[:4])
    with pytest.raises(ValueError, match="tokens are"):
        md.fused_moe_ffn_slots(ex, tok.float(), idx, comb)
    with pytest.raises(ValueError, match="contiguous"):
        md.fused_moe_ffn_slots(ex, tok, idx.t().contiguous().t(), comb)


# --------------------------------------- fused MoE dispatch, K6's int8 variant


def _moe_ratio(got, exact, scale, dtype):
    """The worst row's error over its tolerance (``_moe_rows_close``'s
    rule), for checks that must fail."""
    err = (got.float() - exact).abs().amax(-1)
    big = exact.abs().amax(-1)
    if dtype == torch.float32:
        tol = 2e-5 * big
    else:
        tol = (2.0 * torch.exp2(torch.floor(torch.log2(
            big.clamp_min(2.0 ** -100))) - 7) + 4.0 * 2.0 ** -8
            * scale.amax(-1))
    return float((err / tol.clamp_min(1e-30)).max())


def _int8_inputs(cuda, **kw):
    from torchdistpackage_tpu_torch.ops.moe_dispatch import (
        quantize_moe_experts,
    )

    ex, tok, idx, comb, route = _moe_inputs(cuda, **kw)
    return quantize_moe_experts(ex), tok, idx, comb, route


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
@pytest.mark.parametrize("T,C,D,F,holes", [
    (40, 40, 256, 128, False),      # one partial capacity tile, C = T
    (300, 100, 576, 1408, False),   # drops; C, D, F not powers of two
    (256, 256, 128, 192, True),     # trailing empty tiles, in-tile holes
])
def test_moe_int8_kernel_matches_plain_on_card(cuda, dtype, act, T, C, D, F,
                                               holes):
    """K6-int8 (``quantize_moe_experts`` leaves) against its plain version
    on the dequantised weights, in f32, row by row; bf16 and f32 tokens."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    dt = getattr(torch, dtype)
    ex, tok, idx, comb, route = _int8_inputs(
        cuda, T=T, C=C, E=8, D=D, F=F, act=act, dtype=dt, seed=T + D + 1,
        holes=holes)
    before = dict(md.LAUNCHES)
    got = md.fused_moe_ffn_slots(ex, tok, idx, comb)
    torch.cuda.synchronize()
    assert {n: md.LAUNCHES[n] - before[n] for n in before} == {
        "fused_moe_ffn": 0, "fused_moe_ffn_int8": 1, "fused_expert_ffn": 0,
        "fused_expert_ffn_int8": 0}
    assert got.dtype == torch.float32 and got.shape == (T, D)
    exact = md.moe_ffn_slots_reference(ex, tok, idx, comb)
    scale = md.moe_rounding_scale(ex, tok, idx, comb)
    _moe_rows_close(got.to(dt), exact, scale, dt)
    if not holes:  # the routing-level entry point, in the tokens' dtype
        y = md.fused_moe_ffn(ex, tok, *route, C)
        assert y.dtype == dt
        _moe_rows_close(y, exact, scale, dt)


@pytest.mark.gpu
def test_moe_int8_kernel_mixtral_decode_and_planted_fault(cuda):
    """Mixtral-8x7B widths at decode (E 8, top-2, D 4096, F 14336, SwiGLU,
    bf16 tokens, T = C = 8): held; with w2's scale not applied (all ones)
    the same check fails."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    ex, tok, idx, comb, _ = _int8_inputs(
        cuda, T=8, C=8, E=8, D=4096, F=14336, act="swiglu",
        dtype=torch.bfloat16, seed=7)
    got = md.fused_moe_ffn_slots(ex, tok, idx, comb)
    exact = md.moe_ffn_slots_reference(ex, tok, idx, comb)
    scale = md.moe_rounding_scale(ex, tok, idx, comb)
    _moe_rows_close(got.to(torch.bfloat16), exact, scale, torch.bfloat16)
    q2, s2 = ex["w2"]
    bad = md.fused_moe_ffn_slots(dict(ex, w2=(q2, torch.ones_like(s2))), tok,
                                 idx, comb)
    assert _moe_ratio(bad.to(torch.bfloat16), exact, scale,
                      torch.bfloat16) > 1.0


@pytest.mark.gpu
def test_moe_int8_kernel_wrapper_refuses_what_it_does_not_take(cuda):
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    ex, tok, idx, comb, _ = _int8_inputs(cuda, T=16, C=16, E=4, D=128,
                                         F=128, act="swiglu",
                                         dtype=torch.bfloat16, seed=3)
    (q1, s1), (q2, s2) = ex["w1"], ex["w2"]
    with pytest.raises(ValueError, match="w1 scale"):
        md.fused_moe_ffn_slots(dict(ex, w1=(q1, s1.to(torch.bfloat16))),
                               tok, idx, comb)
    with pytest.raises(ValueError, match="w2 scale"):
        md.fused_moe_ffn_slots(dict(ex, w2=(q2, s2[:, :64].contiguous())),
                               tok, idx, comb)
    with pytest.raises(ValueError, match="w2 is"):
        md.fused_moe_ffn_slots(dict(ex, w2=(q2.to(torch.uint8), s2)), tok,
                               idx, comb)
    with pytest.raises(ValueError, match="device"):
        md.fused_moe_ffn_slots(dict(ex, w1=(q1, s1.cpu())), tok, idx, comb)
    with pytest.raises(NotImplementedError, match="int8"):
        md.fused_moe_ffn_slots(dict(ex, w2=md._dequant(ex["w2"]).to(
            torch.bfloat16)), tok, idx, comb)


# ------------------------------------------------- the EP expert FFN, K7


def _expert_inputs(cuda, *, E, G, D, F, act, dtype, seed, quantized=False):
    from torchdistpackage_tpu_torch.ops.moe_dispatch import (
        quantize_moe_experts,
    )

    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=cuda) * std

    swiglu = act == "swiglu"
    ex = {"w1": rnd(*((E, 2, D, F) if swiglu else (E, D, F)), std=D ** -0.5),
          "b1": rnd(*((E, 2, F) if swiglu else (E, F)), std=0.1),
          "w2": rnd(E, F, D, std=F ** -0.5), "b2": rnd(E, D, std=0.1)}
    ex = {n: t.to(dtype) for n, t in ex.items()}
    x = rnd(E, G, D)
    x[:, G // 2:G // 2 + 3] = 0  # pad rows, as empty capacity slots
    return (quantize_moe_experts(ex) if quantized else ex), x.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
@pytest.mark.parametrize("E,G,D,F", [
    (2, 40, 256, 128),      # one partial row tile an expert
    (3, 130, 576, 1408),    # G, D, F not powers of two
    (1, 64, 128, 192),      # one full tile
])
def test_expert_ffn_kernel_matches_plain_on_card(cuda, quantized, dtype, act,
                                                 E, G, D, F):
    """K7 (float or int8 experts) against its plain version in f32, row by
    row under K6's rule, every row (pad rows included) computed."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    dt = getattr(torch, dtype)
    ex, x = _expert_inputs(cuda, E=E, G=G, D=D, F=F, act=act, dtype=dt,
                           seed=E + G + D, quantized=quantized)
    name = "fused_expert_ffn_int8" if quantized else "fused_expert_ffn"
    before = dict(md.LAUNCHES)
    got = md.fused_expert_ffn(ex, x)
    torch.cuda.synchronize()
    assert {n: md.LAUNCHES[n] - before[n] for n in before} == {
        n: int(n == name) for n in before}
    assert got.dtype == dt and got.shape == x.shape
    exact = md.expert_ffn_reference(ex, x)
    scale = md.expert_ffn_rounding_scale(ex, x)
    _moe_rows_close(got, exact, scale, dt)


@pytest.mark.gpu
def test_expert_ffn_kernel_planted_faults_fail(cuda):
    """The row check catches the faults it is there for: the last F tile
    left out, b2 added by every F tile, each row in the next expert's
    block, and (int8) w2's scale not applied."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    bf = torch.bfloat16
    ex, x = _expert_inputs(cuda, E=2, G=40, D=256, F=256, act="swiglu",
                           dtype=bf, seed=11)
    exact = md.expert_ffn_reference(ex, x)
    scale = md.expert_ffn_rounding_scale(ex, x)
    _moe_rows_close(md.fused_expert_ffn(ex, x), exact, scale, bf)
    w2 = ex["w2"].clone()
    w2[:, -md.TILE:] = 0
    n_f = ex["w2"].shape[1] // md.TILE
    bad = [md.fused_expert_ffn(dict(ex, w2=w2), x),
           md.fused_expert_ffn(dict(ex, b2=ex["b2"] * n_f), x),
           torch.roll(md.fused_expert_ffn(ex, x), 1, dims=0)]
    q = md.quantize_moe_experts(ex)
    q2, s2 = q["w2"]
    exact_q = md.expert_ffn_reference(q, x)
    scale_q = md.expert_ffn_rounding_scale(q, x)
    _moe_rows_close(md.fused_expert_ffn(q, x), exact_q, scale_q, bf)
    for got in bad:
        assert _moe_ratio(got, exact, scale, bf) > 1.0
    got = md.fused_expert_ffn(dict(q, w2=(q2, torch.ones_like(s2))), x)
    assert _moe_ratio(got, exact_q, scale_q, bf) > 1.0


@pytest.mark.gpu
def test_expert_ffn_kernel_wrapper_refuses_what_it_does_not_take(cuda):
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    ex, x = _expert_inputs(cuda, E=2, G=16, D=128, F=128, act="swiglu",
                           dtype=torch.bfloat16, seed=5)
    with pytest.raises(ValueError, match="experts"):
        md.fused_expert_ffn(ex, x[:1].contiguous())
    with pytest.raises(ValueError, match="device"):
        md.fused_expert_ffn(dict(ex, b2=ex["b2"].cpu()), x)
    with pytest.raises(ValueError, match="tokens are"):
        md.fused_expert_ffn(ex, x.float())
    with pytest.raises(ValueError, match="contiguous"):
        md.fused_expert_ffn(ex, x.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match=r"\[e_loc, G, D\]"):
        md.fused_expert_ffn(ex, x[0])
    q = md.quantize_moe_experts(ex)
    with pytest.raises(NotImplementedError, match="int8"):
        md.fused_expert_ffn(dict(ex, w1=q["w1"]), x)


@pytest.fixture
def k7_body(monkeypatch):
    """Pins K7's shape dispatch to one body: ``k7_body('wgmma')`` sends
    every bf16 group to the chunk body, ``k7_body('decode')`` to the
    decode body, ``k7_body('walk')`` to neither."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    def pin(body):
        monkeypatch.setattr(md, "EXPERT_FFN_WGMMA_G_MIN",
                            1 if body == "wgmma" else 1 << 30)
        monkeypatch.setattr(md, "EXPERT_FFN_DECODE_G_MIN",
                            1 if body == "decode" else 1 << 30)
    return pin


@pytest.mark.gpu
@pytest.mark.parametrize("body", ["wgmma", "walk", "decode"])
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
@pytest.mark.parametrize("E,G,D,F", [
    (2, 200, 256, 512),   # a ragged 128-row tile
    (2, 130, 320, 192),   # F not a multiple of 128, D not of 256
])
def test_expert_ffn_wgmma_body_matches_plain_on_card(cuda, k7_body, body,
                                                     quantized, act, E, G,
                                                     D, F):
    """K7's chunk rows through each of its bodies (the two-pass warpgroup
    GEMM, the walk and the decode body's row tiles), bf16 rows, float and
    int8 experts, against the plain version in f32, row by row under K6's
    rule."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    bf = torch.bfloat16
    k7_body(body)
    ex, x = _expert_inputs(cuda, E=E, G=G, D=D, F=F, act=act, dtype=bf,
                           seed=E + G + F, quantized=quantized)
    assert md.expert_ffn_body(G, bf) == body
    name = "fused_expert_ffn_int8" if quantized else "fused_expert_ffn"
    before = dict(md.LAUNCHES)
    got = md.fused_expert_ffn(ex, x)
    torch.cuda.synchronize()
    assert {n: md.LAUNCHES[n] - before[n] for n in before} == {
        n: int(n == name) for n in before}
    assert got.dtype == bf and got.shape == x.shape
    _moe_rows_close(got, md.expert_ffn_reference(ex, x),
                    md.expert_ffn_rounding_scale(ex, x), bf)


@pytest.mark.gpu
def test_expert_ffn_wgmma_planted_faults_fail(cuda, k7_body):
    """On the warpgroup body the row check catches the walk body's faults
    (the last F tile left out, b2 added by every F tile, each row in the
    next expert's block, int8 w2's scale not applied) and the one only
    this body can make: gate and up swapped, silu(up) * gate."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    bf = torch.bfloat16
    k7_body("wgmma")
    ex, x = _expert_inputs(cuda, E=2, G=200, D=256, F=256, act="swiglu",
                           dtype=bf, seed=12)
    exact = md.expert_ffn_reference(ex, x)
    scale = md.expert_ffn_rounding_scale(ex, x)
    _moe_rows_close(md.fused_expert_ffn(ex, x), exact, scale, bf)
    w2 = ex["w2"].clone()
    w2[:, -md.TILE:] = 0
    n_f = ex["w2"].shape[1] // md.TILE
    bad = [md.fused_expert_ffn(dict(ex, w2=w2), x),
           md.fused_expert_ffn(dict(ex, b2=ex["b2"] * n_f), x),
           torch.roll(md.fused_expert_ffn(ex, x), 1, dims=0),
           md.fused_expert_ffn(dict(ex, w1=ex["w1"].flip(1).contiguous(),
                                    b1=ex["b1"].flip(1).contiguous()), x)]
    for got in bad:
        assert _moe_ratio(got, exact, scale, bf) > 1.0
    q = md.quantize_moe_experts(ex)
    q2, s2 = q["w2"]
    exact_q = md.expert_ffn_reference(q, x)
    scale_q = md.expert_ffn_rounding_scale(q, x)
    _moe_rows_close(md.fused_expert_ffn(q, x), exact_q, scale_q, bf)
    q1, s1 = q["w1"]
    for got in (md.fused_expert_ffn(dict(q, w2=(q2, torch.ones_like(s2))), x),
                md.fused_expert_ffn(dict(
                    q, w1=(q1.flip(1).contiguous(), s1.flip(1).contiguous()),
                    b1=q["b1"].flip(1).contiguous()), x)):
        assert _moe_ratio(got, exact_q, scale_q, bf) > 1.0


def _kernel_names(fn):
    """The CUDA kernels one call of ``fn`` launches, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return " ".join(e.key for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("E", [1, 2, 8])
@pytest.mark.parametrize("G", [1, 8, 16, 32])
def test_expert_ffn_decode_body_matches_plain_on_card(cuda, quantized, E, G):
    """K7's decode rows on the swap-AB body at the routing's own
    threshold (bf16, G below ``EXPERT_FFN_WGMMA_G_MIN``): G 1 to 32 rows
    (one 16- or 64-row tile), e_loc 1 to 8, float and int8 experts, pad
    rows included, against the plain version in f32 under K6's rule."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    bf = torch.bfloat16
    ex, x = _expert_inputs(cuda, E=E, G=G, D=256, F=512, act="swiglu",
                           dtype=bf, seed=E * 100 + G, quantized=quantized)
    assert md.expert_ffn_body(G, bf) == "decode"
    name = "fused_expert_ffn_int8" if quantized else "fused_expert_ffn"
    before = dict(md.LAUNCHES)
    got = md.fused_expert_ffn(ex, x)
    torch.cuda.synchronize()
    assert {n: md.LAUNCHES[n] - before[n] for n in before} == {
        n: int(n == name) for n in before}
    assert got.dtype == bf and got.shape == x.shape
    _moe_rows_close(got, md.expert_ffn_reference(ex, x),
                    md.expert_ffn_rounding_scale(ex, x), bf)


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
@pytest.mark.parametrize("E,G,D,F", [
    (2, 8, 320, 192),    # D and F not multiples of the 128-column tile
    (2, 20, 256, 384),   # a ragged 32-row tile
    (3, 40, 256, 1472),  # a ragged 64-row tile, F 1472
    (2, 100, 128, 256),  # two row tiles (pinned past the threshold)
])
def test_expert_ffn_decode_body_ragged_on_card(cuda, k7_body, quantized, act,
                                               E, G, D, F):
    """The decode body at ragged widths and row counts, GELU and SwiGLU,
    pinned to it, against the plain version in f32 under K6's rule."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    bf = torch.bfloat16
    k7_body("decode")
    ex, x = _expert_inputs(cuda, E=E, G=G, D=D, F=F, act=act, dtype=bf,
                           seed=E + G + D + F, quantized=quantized)
    assert md.expert_ffn_body(G, bf) == "decode"
    _moe_rows_close(md.fused_expert_ffn(ex, x), md.expert_ffn_reference(ex, x),
                    md.expert_ffn_rounding_scale(ex, x), bf)


@pytest.mark.gpu
def test_expert_ffn_decode_planted_faults_fail(cuda):
    """On the decode body the row check catches the last F tile left out,
    b2 added by every F tile (the stream-K runs each add one partial sum;
    only the run that starts the F sum adds b2), each row in the next
    expert's block, gate and up swapped and int8 w2's scale not
    applied."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    bf = torch.bfloat16
    ex, x = _expert_inputs(cuda, E=2, G=8, D=256, F=512, act="swiglu",
                           dtype=bf, seed=13)
    assert md.expert_ffn_body(8, bf) == "decode"
    exact = md.expert_ffn_reference(ex, x)
    scale = md.expert_ffn_rounding_scale(ex, x)
    _moe_rows_close(md.fused_expert_ffn(ex, x), exact, scale, bf)
    w2 = ex["w2"].clone()
    w2[:, -md.TILE:] = 0
    n_f = ex["w2"].shape[1] // md.TILE
    bad = [md.fused_expert_ffn(dict(ex, w2=w2), x),
           md.fused_expert_ffn(dict(ex, b2=ex["b2"] * n_f), x),
           torch.roll(md.fused_expert_ffn(ex, x), 1, dims=0),
           md.fused_expert_ffn(dict(ex, w1=ex["w1"].flip(1).contiguous(),
                                    b1=ex["b1"].flip(1).contiguous()), x)]
    for got in bad:
        assert _moe_ratio(got, exact, scale, bf) > 1.0
    q = md.quantize_moe_experts(ex)
    q2, s2 = q["w2"]
    exact_q = md.expert_ffn_reference(q, x)
    scale_q = md.expert_ffn_rounding_scale(q, x)
    _moe_rows_close(md.fused_expert_ffn(q, x), exact_q, scale_q, bf)
    got = md.fused_expert_ffn(dict(q, w2=(q2, torch.ones_like(s2))), x)
    assert _moe_ratio(got, exact_q, scale_q, bf) > 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("E,G", [(8, 8), (2, 32), (3, 20)])
def test_expert_ffn_decode_body_is_bitwise_repeatable(cuda, quantized, E, G):
    """K7's decode body adds each output element's pass-2 runs in run
    order in a merge launch (no atomics), so two launches give the same
    bits; with one run dropped from the merge (the ``TDP_MOE_FAULT=1``
    build) the row check fails."""
    from torchdistpackage_tpu_torch.ops import _build
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    bf = torch.bfloat16
    ex, x = _expert_inputs(cuda, E=E, G=G, D=256, F=1024, act="swiglu",
                           dtype=bf, seed=E * 10 + G, quantized=quantized)
    assert md.expert_ffn_body(G, bf) == "decode"
    a = md.fused_expert_ffn(ex, x)
    b = md.fused_expert_ffn(ex, x)
    assert torch.equal(a, b)
    exact = md.expert_ffn_reference(ex, x)
    scale = md.expert_ffn_rounding_scale(ex, x)
    _moe_rows_close(a, exact, scale, bf)
    with _build.variant("moe_dispatch", ("TDP_MOE_FAULT=1",)):
        bad = md.fused_expert_ffn(ex, x)
    assert _moe_ratio(bad, exact, scale, bf) > 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("G,dtype,kernel", [
    (8, "bfloat16", "expert_ffn_up_decode_kernel"),
    (63, "bfloat16", "expert_ffn_up_decode_kernel"),
    (64, "bfloat16", "expert_ffn_up_wgmma_kernel"),
    (8, "float32", "expert_ffn_kernel<"),
])
def test_expert_ffn_routing_launches_the_named_body(cuda, G, dtype, kernel):
    """``expert_ffn_body``'s answer is the body that runs: the kernel
    names torch.profiler records (``EXPERT_FFN_WGMMA_G_MIN`` 64)."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    dt = getattr(torch, dtype)
    ex, x = _expert_inputs(cuda, E=2, G=G, D=128, F=256, act="swiglu",
                           dtype=dt, seed=G)
    names = _kernel_names(lambda: md.fused_expert_ffn(ex, x))
    assert kernel in names, names
    others = {"expert_ffn_up_decode_kernel", "expert_ffn_up_wgmma_kernel",
              "expert_ffn_kernel<"} - {kernel}
    assert not any(o in names for o in others), names


# ------------------------------------- K6's chunk rows on the warpgroup body


@pytest.fixture
def k6_body(monkeypatch):
    """Pins K6's dispatch: ``k6_body('wgmma')`` sends every bf16 call to
    the warpgroup body, ``k6_body('decode')`` to the decode body,
    ``k6_body('walk')`` to neither."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    def pin(body):
        monkeypatch.setattr(md, "MOE_FFN_WGMMA_C_MIN",
                            1 if body == "wgmma" else 1 << 30)
        monkeypatch.setattr(md, "MOE_FFN_DECODE_C_MIN",
                            1 if body == "decode" else 1 << 30)
    return pin


def _k6_inputs(cuda, quantized, **kw):
    return (_int8_inputs if quantized else _moe_inputs)(cuda, **kw)


def _scatter_perm(cuda, idx, T, seed):
    """A ``scatter_idx`` other than ``idx``: each slot's token sent
    through a fixed permutation of the T tokens; returns (dst, perm)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    perm = torch.randperm(T, generator=g, device=cuda)
    return perm[idx.long()].to(torch.int32).contiguous(), perm


@pytest.mark.gpu
@pytest.mark.parametrize("body", ["wgmma", "walk", "decode"])
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
@pytest.mark.parametrize("T,C,D,F,holes,scatter", [
    (256, 256, 256, 512, False, False),    # C = T at top-2: 3/4 empty
    (4096, 4096, 128, 192, False, False),  # a chunk's C = T: 24 of 32
                                           # tiles an expert empty; F not
                                           # of the 128-column tile
    (512, 100, 320, 256, False, False),    # drops; C not of 128, D not of
                                           # 256
    (400, 200, 256, 256, True, False),     # holes inside filled tiles
    (256, 256, 256, 256, False, True),     # scatter_idx other than idx
])
def test_moe_bodies_match_plain_on_card(cuda, k6_body, body, quantized, act,
                                        T, C, D, F, holes, scatter):
    """K6's chunk rows on each of its bodies (pinned: the decode body then
    walks several 16-slot tiles an expert), float and int8 experts,
    SwiGLU and GELU, bf16 tokens, against the plain version in f32 row by
    row under K6's rule."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    bf = torch.bfloat16
    k6_body(body)
    ex, tok, idx, comb, _ = _k6_inputs(cuda, quantized, T=T, C=C, E=8, D=D,
                                       F=F, act=act, dtype=bf,
                                       seed=T + C + D + F, holes=holes)
    dst, scale_of = None, None
    if scatter:
        dst, perm = _scatter_perm(cuda, idx, T, seed=T)
    assert md.moe_ffn_body(C, bf) == body
    name = "fused_moe_ffn_int8" if quantized else "fused_moe_ffn"
    before = dict(md.LAUNCHES)
    got = md.fused_moe_ffn_slots(ex, tok, idx, comb, scatter_idx=dst)
    torch.cuda.synchronize()
    assert {n: md.LAUNCHES[n] - before[n] for n in before} == {
        n: int(n == name) for n in before}
    assert got.dtype == torch.float32 and got.shape == (T, D)
    exact = md.moe_ffn_slots_reference(ex, tok, idx, comb, dst)
    scale = md.moe_rounding_scale(ex, tok, idx, comb)
    if scatter:  # token t's output lands in row perm[t]
        scale_of = torch.empty_like(scale)
        scale_of[perm] = scale
        scale = scale_of
    _moe_rows_close(got.to(bf), exact, scale, bf)


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_moe_wgmma_body_is_bitwise_repeatable_at_top2(cuda, quantized):
    """At top-2 each output element gets one add per routed choice into
    zeros, so two launches give the same bits."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    ex, tok, idx, comb, _ = _k6_inputs(cuda, quantized, T=1024, C=1024, E=8,
                                       D=256, F=512, act="swiglu",
                                       dtype=torch.bfloat16, seed=21)
    assert md.moe_ffn_body(1024, torch.bfloat16) == "wgmma"
    a = md.fused_moe_ffn_slots(ex, tok, idx, comb)
    b = md.fused_moe_ffn_slots(ex, tok, idx, comb)
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("C,dtype,kernel", [
    ("min", "bfloat16", "moe_ffn_up_wgmma_kernel"),
    ("below", "bfloat16", "moe_ffn_up_decode_kernel"),
    ("decode_min", "bfloat16", "moe_ffn_up_decode_kernel"),
    (8, "bfloat16", "moe_ffn_up_decode_kernel"),
    (4096, "bfloat16", "moe_ffn_up_wgmma_kernel"),
    (4096, "float32", "moe_ffn_kernel<"),
    (8, "float32", "moe_ffn_kernel<"),
])
def test_moe_routing_launches_the_named_body(cuda, C, dtype, kernel):
    """``moe_ffn_body``'s answer is the body that runs, by the kernel
    names torch.profiler records, at ``MOE_FFN_WGMMA_C_MIN``, one below
    it and at ``MOE_FFN_DECODE_C_MIN``; the decode body's merge runs with
    it, and no other body's kernel."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    C = {"min": md.MOE_FFN_WGMMA_C_MIN,
         "below": md.MOE_FFN_WGMMA_C_MIN - 1,
         "decode_min": md.MOE_FFN_DECODE_C_MIN}.get(C, C)
    dt = getattr(torch, dtype)
    ex, tok, idx, comb, _ = _moe_inputs(cuda, T=C, C=C, E=8, D=128, F=128,
                                        act="swiglu", dtype=dt, seed=C)
    names = _kernel_names(lambda: md.fused_moe_ffn_slots(ex, tok, idx, comb))
    assert kernel in names, names
    if kernel == "moe_ffn_up_decode_kernel":
        assert "moe_ffn_merge_kernel" in names, names
    others = {"moe_ffn_kernel<", "moe_ffn_up_wgmma_kernel",
              "moe_ffn_up_decode_kernel"} - {kernel}
    assert not any(o in names for o in others), names


@pytest.mark.gpu
@pytest.mark.parametrize("E,C,case", [
    (8, 8, "serving"), (8, 1, "serving"), (4, 15, "holes"),
    (8, 100, "serving"), (8, 4096, "serving"),  # 2048 tiles: two chunks
    (3, 300, "empty"), (6, 700, "sparse"), (200, 40, "serving")])
def test_decode_tiles_kernel_matches_chunk_tiles(cuda, E, C, case):
    """The decode body's first launch lists the 16-slot tiles by
    ``chunk_tiles``' rule: the kernel (``decode_tiles`` on the card)
    against ``chunk_tiles`` on the CPU, for serving routings, holes, no
    filled slot at all, sparse fills and more tiles than one CTA's
    1024 threads."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    g = torch.Generator().manual_seed(E * 1000 + C)
    if case == "serving":
        _, _, _, comb, _ = _moe_inputs(cuda, T=C, C=C, E=E, D=64, F=64,
                                       act="swiglu", dtype=torch.bfloat16,
                                       seed=C)
        comb = comb.cpu()
    elif case == "holes":
        comb = torch.rand(E, C, generator=g)
        comb[:, ::3] = 0
        comb[1] = 0
    elif case == "empty":
        comb = torch.zeros(E, C)
    else:
        comb = torch.where(torch.rand(E, C, generator=g) < 0.002,
                           torch.rand(E, C, generator=g), 0.0)
    tiles, offs = md.decode_tiles(comb.to(cuda).contiguous())
    want_tiles, want_offs = md.chunk_tiles(comb, md.DECODE_ROWS)
    assert torch.equal(offs.cpu(), want_offs)
    assert torch.equal(tiles.cpu(), want_tiles)


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("T,C", [(8, 8), (12, 12), (15, 15), (40, 40)])
def test_moe_decode_body_is_bitwise_repeatable(cuda, k6_body, quantized, T,
                                               C):
    """K6's decode body merges each output element's routed choices and
    each choice's F runs in a fixed order (no atomics), so two launches
    give the same bits — at decode's C = T and past one 16-slot tile."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    k6_body("decode")
    ex, tok, idx, comb, _ = _k6_inputs(cuda, quantized, T=T, C=C, E=8,
                                       D=256, F=1024, act="swiglu",
                                       dtype=torch.bfloat16, seed=T + 50)
    assert md.moe_ffn_body(C, torch.bfloat16) == "decode"
    a = md.fused_moe_ffn_slots(ex, tok, idx, comb)
    b = md.fused_moe_ffn_slots(ex, tok, idx, comb)
    assert torch.equal(a, b)
    _moe_rows_close(a.to(torch.bfloat16),
                    md.moe_ffn_slots_reference(ex, tok, idx, comb),
                    md.moe_rounding_scale(ex, tok, idx, comb),
                    torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_moe_decode_planted_faults_fail(cuda, quantized):
    """On K6's decode body (T = C = 8, a decode step) the row check
    catches: the gate weight not applied, the last F tile left out, the
    scatter on the neighbouring slot's token, the gather from the
    neighbouring slot's token, a hit expert treated as unhit (its comb
    zeroed on the kernel side only), one pass-2 run dropped from the
    merge (the ``TDP_MOE_FAULT=1`` build), and for int8 w2's scale not
    applied, the up half on the gate's scale row and each column on its
    neighbour's scale."""
    from torchdistpackage_tpu_torch.ops import _build
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    bf = torch.bfloat16
    ex, tok, idx, comb, _ = _k6_inputs(cuda, quantized, T=8, C=8, E=8,
                                       D=256, F=1024, act="swiglu", dtype=bf,
                                       seed=33)
    assert md.moe_ffn_body(8, bf) == "decode"
    exact = md.moe_ffn_slots_reference(ex, tok, idx, comb)
    scale = md.moe_rounding_scale(ex, tok, idx, comb)
    _moe_rows_close(md.fused_moe_ffn_slots(ex, tok, idx, comb).to(bf), exact,
                    scale, bf)
    (w1, s1), (w2, s2) = ((ex["w1"], ex["w2"]) if quantized
                          else ((ex["w1"], None), (ex["w2"], None)))
    cut = w2.clone()
    cut[:, -md.TILE:] = 0
    unhit = comb.clone()
    unhit[int(torch.nonzero(comb)[0, 0])] = 0
    rolled = torch.roll(idx, -1, dims=1).contiguous()
    faults = [
        (ex, idx, (comb != 0).float(), None),
        (dict(ex, w2=cut if s2 is None else (cut, s2)), idx, comb, None),
        (ex, idx, comb, rolled),
        (ex, rolled, comb, idx),
        (ex, idx, unhit, None),
    ]
    if quantized:
        gate_twice = s1.clone()
        gate_twice[:, 1] = s1[:, 0]
        faults += [
            (dict(ex, w2=(w2, torch.ones_like(s2))), idx, comb, None),
            (dict(ex, w1=(w1, gate_twice)), idx, comb, None),
            (dict(ex, w1=(w1, torch.roll(s1, 1, dims=-1).contiguous()),
                  w2=(w2, torch.roll(s2, 1, dims=-1).contiguous())), idx,
             comb, None),
        ]
    for exf, i, cb, dst in faults:
        got = md.fused_moe_ffn_slots(exf, tok, i, cb, scatter_idx=dst)
        assert _moe_ratio(got.to(bf), exact, scale, bf) > 1.0
    with _build.variant("moe_dispatch", ("TDP_MOE_FAULT=1",)):
        got = md.fused_moe_ffn_slots(ex, tok, idx, comb)
    assert _moe_ratio(got.to(bf), exact, scale, bf) > 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_moe_wgmma_planted_faults_fail(cuda, k6_body, quantized):
    """On K6's warpgroup body the row check catches: the gate weight not
    applied, the last F tile left out, the scatter on the neighbouring
    slot's token, the gather from the neighbouring slot's token, a filled
    tile treated as empty (its comb zeroed on the kernel side only), gate
    and up swapped, and (int8) w2's scale not applied."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    bf = torch.bfloat16
    k6_body("wgmma")
    ex, tok, idx, comb, _ = _k6_inputs(cuda, quantized, T=512, C=512, E=4,
                                       D=256, F=256, act="swiglu", dtype=bf,
                                       seed=31)
    exact = md.moe_ffn_slots_reference(ex, tok, idx, comb)
    scale = md.moe_rounding_scale(ex, tok, idx, comb)
    _moe_rows_close(md.fused_moe_ffn_slots(ex, tok, idx, comb).to(bf), exact,
                    scale, bf)
    (w1, s1), (w2, s2) = ((ex["w1"], ex["w2"]) if quantized
                          else ((ex["w1"], None), (ex["w2"], None)))
    cut = w2.clone()
    cut[:, -md.TILE:] = 0
    empty = comb.clone()
    empty[0, :md.CHUNK_ROWS] = 0
    swap_w1 = (w1.flip(1).contiguous() if s1 is None else
               (w1.flip(1).contiguous(), s1.flip(1).contiguous()))
    faults = [
        (ex, idx, (comb != 0).float(), None),
        (dict(ex, w2=cut if s2 is None else (cut, s2)), idx, comb, None),
        (ex, idx, comb, torch.roll(idx, -1, dims=1).contiguous()),
        (ex, torch.roll(idx, -1, dims=1).contiguous(), comb, idx),
        (ex, idx, empty, None),
        (dict(ex, w1=swap_w1, b1=ex["b1"].flip(1).contiguous()), idx, comb,
         None),
    ]
    if quantized:
        faults.append((dict(ex, w2=(w2, torch.ones_like(s2))), idx, comb,
                       None))
    for exf, i, cb, dst in faults:
        got = md.fused_moe_ffn_slots(exf, tok, i, cb, scatter_idx=dst)
        assert _moe_ratio(got.to(bf), exact, scale, bf) > 1.0


# ------------------------------------------------ the CP carry kernel, K2


def _carry_inputs(cuda, *, dtype, s_in, hd, seed, mb=280, b=3):
    """q, a pool of 1 + b mb blocks of 16 positions, tables a permutation
    of its blocks, offsets up to the table's end (past 4096, so a window
    of 4096 masks)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    hkv, groups, bs = 2, 4, 16
    nb = 1 + b * mb
    tables = (torch.randperm(nb - 1, generator=g, device=cuda) + 1)
    tables = tables.reshape(b, mb).to(torch.int32)
    offs = torch.tensor([0, 70, mb * bs - s_in], dtype=torch.int32,
                        device=cuda)
    q = torch.randn(b, hkv * groups, s_in, hd, generator=g, device=cuda
                    ).to(dtype)
    k, v = (torch.randn(nb, hkv, bs, hd, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    return q, k, v, tables, offs


def _slices(k, v, tables, n):
    """The pool cut into n slices (zero blocks pad the last), each with
    the table re-based by its first block: cp n's per-rank hops."""
    per = -(-k.shape[0] // n)
    pad = per * n - k.shape[0]
    k = torch.cat([k, k.new_zeros((pad,) + k.shape[1:])])
    v = torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
    return [(k[i * per:(i + 1) * per], v[i * per:(i + 1) * per],
             (tables - i * per).contiguous()) for i in range(n)]


def _chain(fn, q, hops, offs, window, carry_fault=None):
    carry = None
    for i, (k, v, t) in enumerate(hops):
        if i and carry_fault is not None:
            carry = carry_fault(carry)
        carry = fn(q, k, v, t, offs, carry=carry, window=window)
    return carry


def _carry_ratio(got, exact, scale, dtype):
    """The worst ratio to its tolerance of: the finished output row by row
    (f32 2e-5; bf16 2 ulps of the row's largest |value| plus 4 x 2^-8 of
    its largest P-rounding scale), the carry's m (1e-4 (1 + |m|)) and l
    (1e-4 of itself); inf on any NaN."""
    from torchdistpackage_tpu_torch.ops.paged_attention import (
        finalize_paged_carry,
    )

    B, H, S, hd = scale.shape
    out = finalize_paged_carry(got, B, H, S, hd, dtype).float()
    want = finalize_paged_carry(exact, B, H, S, hd, torch.float32)
    err = (out - want).abs().amax(-1)
    if dtype == torch.float32:
        tol = torch.full_like(err, 2e-5)
    else:
        big = want.abs().amax(-1).clamp_min(2.0 ** -100)
        tol = (2.0 * torch.exp2(torch.floor(torch.log2(big)) - 7)
               + 4.0 * 2.0 ** -8 * scale.amax(-1))
    ratios = torch.stack([
        (err / tol).max(),
        ((got[1] - exact[1]).abs() / (1e-4 * (1 + exact[1].abs()))).max(),
        ((got[2] - exact[2]).abs() / (1e-4 * exact[2]).clamp_min(1e-30)
         ).max()])
    if not (torch.isfinite(ratios).all() and torch.isfinite(out).all()):
        return float("inf")
    return float(ratios.max())


def _carry_check(q, hops, offs, window):
    """K2 through the chain, and the plain version's chain in f32 on the
    same values with the rounding scale."""
    from torchdistpackage_tpu_torch.ops import paged_attention as pa

    before = pa.LAUNCHES["paged_carry_attention"]
    got = _chain(pa.paged_carry_attention, q, hops, offs, window)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_carry_attention"] == before + len(hops)
    exact = _chain(pa.paged_carry_attention_reference, q.float(),
                   [(k.float(), v.float(), t) for k, v, t in hops], offs,
                   window)
    scale = pa.paged_carry_rounding_scale(q, hops, offs, window=window)
    return got, exact, scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s_in", [1, 33], ids=["split", "rows"])
@pytest.mark.parametrize("window", [None, 4096, 64])
@pytest.mark.parametrize("n_hops", [1, 4])
def test_carry_kernel_matches_plain_on_card(cuda, dtype, hd, s_in, window,
                                            n_hops):
    """K2 over one hop (the whole pool, cp 1) and a four-hop chain over
    quarter-pool slices (cp 4's per-rank work), against the plain version
    in f32 on the same values."""
    dt = getattr(torch, dtype)
    q, k, v, tables, offs = _carry_inputs(cuda, dtype=dt, s_in=s_in, hd=hd,
                                          seed=hd + s_in)
    got, exact, scale = _carry_check(q, _slices(k, v, tables, n_hops), offs,
                                     window)
    assert all(t.dtype == torch.float32 for t in got)
    assert _carry_ratio(got, exact, scale, dt) <= 1.0


@pytest.mark.gpu
def test_carry_kernel_split_mode_seeded_carry_and_planted_faults(cuda):
    """Decode in split mode through a four-hop chain (every hop after the
    first seeded with the carry): it holds, and each planted fault fails
    the same check — the ownership mask off (tables clamped into the
    slice), the carry not seeded, the window one block late, the carry
    merged once a warp (acc and l times the 4 warps)."""
    from torchdistpackage_tpu_torch.ops import paged_attention as pa

    bf = torch.bfloat16
    q, k, v, tables, offs = _carry_inputs(cuda, dtype=bf, s_in=1, hd=128,
                                          seed=7)
    window = 4096
    hops = _slices(k, v, tables, 4)
    got, exact, scale = _carry_check(q, hops, offs, window)
    assert _carry_ratio(got, exact, scale, bf) <= 1.0
    clamped = [(kk, vv, t.clamp(0, kk.shape[0] - 1).contiguous())
               for kk, vv, t in hops]
    fn = pa.paged_carry_attention
    bad = [_chain(fn, q, clamped, offs, window),
           _chain(fn, q, hops, offs, window, carry_fault=lambda c: None),
           _chain(fn, q, hops, offs, window + 16),
           _chain(fn, q, hops, offs, window,
                  carry_fault=lambda c: (c[0] * 4, c[1], c[2] * 4))]
    for b in bad:
        assert _carry_ratio(b, exact, scale, bf) > 1.0


@pytest.mark.gpu
def test_carry_kernel_rows_with_no_owned_key_keep_the_seed(cuda):
    """A hop over a slice that owns none of a row's blocks leaves its
    carry exactly as it came in, and without a carry gives (0, NEG_INF,
    0) — no 0/0 inside the kernel."""
    from torchdistpackage_tpu_torch.ops import paged_attention as pa

    q, k, v, tables, offs = _carry_inputs(cuda, dtype=torch.bfloat16,
                                          s_in=33, hd=128, seed=3, mb=20)
    remote = torch.full_like(tables, k.shape[0] + 5)
    acc, m, l = pa.paged_carry_attention(q, k, v, remote, offs)
    assert (acc == 0).all() and (l == 0).all() and (m == pa.NEG_INF).all()
    carry = pa.paged_carry_attention(q, k, v, tables, offs)
    again = pa.paged_carry_attention(q, k, v, remote, offs, carry=carry)
    for a, b in zip(again, carry):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_carry_kernel_wrapper_refuses_what_it_does_not_take(cuda):
    from torchdistpackage_tpu_torch.ops import paged_attention as pa

    q, k, v, tables, offs = _carry_inputs(cuda, dtype=torch.bfloat16,
                                          s_in=4, hd=128, seed=1, mb=8)
    pair = (k.to(torch.int8), torch.ones(k.shape[:3], device=cuda))
    with pytest.raises(NotImplementedError, match="int8"):
        pa.paged_carry_attention(q, pair, pair, tables, offs)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_carry_attention(q.transpose(2, 3).contiguous()
                                 .transpose(2, 3), k, v, tables, offs)
    with pytest.raises(ValueError, match="not supported"):
        pa.paged_carry_attention(q.float(), k, v, tables, offs)
    with pytest.raises(ValueError, match="carry"):
        acc, m, l = pa.paged_carry_attention(q, k, v, tables, offs)
        pa.paged_carry_attention(q, k, v, tables, offs,
                                 carry=(acc, m[..., :1], l))
    with pytest.raises(ValueError, match="blocks of 16"):
        pa.paged_carry_attention(q, k[:, :, :8].contiguous(),
                                 v[:, :, :8].contiguous(), tables, offs)


# ------------------------- K1 and K2 prefill rows on the tensor cores


def _tc_inputs(cuda, *, s_in, hd, groups, seed, mb=280, b=3):
    """bf16 q and a pool of 1 + b mb blocks of 16 positions, tables a
    permutation of its blocks.  Slot 0's rows start at 0 (the causal
    diagonal inside the first key tile), slot 1's at 70 (mid-block), and
    slot 2's last 40 rows run past the end of its table (and past 4096,
    so a window of 4096 masks) — each still sees at least 8 keys under a
    window of 48."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    hkv, bs = 2, 16
    nb = 1 + b * mb
    tables = (torch.randperm(nb - 1, generator=g, device=cuda) + 1)
    tables = tables.reshape(b, mb).to(torch.int32)
    offs = torch.tensor([0, 70, mb * bs - s_in + 40], dtype=torch.int32,
                        device=cuda)
    q = torch.randn(b, hkv * groups, s_in, hd, generator=g, device=cuda
                    ).to(torch.bfloat16)
    k, v = (torch.randn(nb, hkv, bs, hd, generator=g, device=cuda
                        ).to(torch.bfloat16) for _ in range(2))
    return q, k, v, tables, offs


TC_SHAPES = [pytest.param(hd, s_in, groups, window,
                          id=f"hd{hd}-s{s_in}-g{groups}-w{window}")
             for hd in (64, 128) for s_in in (64, 80, 200)
             for groups in (1, 4, 8) for window in (None, 48, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("hd,s_in,groups,window", TC_SHAPES)
def test_k1_tensor_core_rows_match_plain_on_card(cuda, hd, s_in, groups,
                                                 window):
    """K1's prefill rows on bf16 pools (the tensor-core mode): S_in 64
    (whole row tiles), 80 (a ragged last tile; tiles across two query
    heads once G > 1) and 200, G 1 / 4 / 8, against the plain version
    in f32 on the same values, row by row."""
    q, k, v, tables, offs = _tc_inputs(cuda, s_in=s_in, hd=hd,
                                       groups=groups, seed=hd + s_in + groups)
    before = LAUNCHES["paged_decode_attention"]
    got = paged_decode_attention(q, k, v, tables, offs, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["paged_decode_attention"] == before + 1
    want = paged_decode_attention_reference(
        q.float(), k.float(), v.float(), tables, offs, window=window)
    _assert_rows_close(got, want, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("hd,s_in,groups,window", TC_SHAPES)
def test_k2_tensor_core_rows_match_plain_on_card(cuda, hd, s_in, groups,
                                                 window):
    """K2's prefill rows on bf16 pools through a four-hop chain over
    quarter-pool slices: tables a random permutation, so nearly every
    key tile mixes owned and other ranks' blocks, every hop after the
    first is seeded with the carry, and rows meet no owned key in some
    hops; the finished output, m and l against the plain version's chain
    in f32 with the P-rounding term."""
    q, k, v, tables, offs = _tc_inputs(cuda, s_in=s_in, hd=hd,
                                       groups=groups, seed=hd + s_in + groups)
    got, exact, scale = _carry_check(q, _slices(k, v, tables, 4), offs,
                                     window)
    assert _carry_ratio(got, exact, scale, torch.bfloat16) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s_in", [1, 200], ids=["split", "tc"])
@pytest.mark.parametrize("window", [None, 48, 4096])
def test_k2_one_hop_finished_equals_k1_bit_for_bit(cuda, hd, s_in, window):
    """At cp 1 (one hop over the whole pool) K2 and K1 run one body with
    the same tiles in the same order, so K2's carry finished by the ring
    (acc / l in f32, then bf16) equals K1's output bit for bit — the CP
    engine's logits equal the K1 engine's."""
    from torchdistpackage_tpu_torch.ops import paged_attention as pa

    q, k, v, tables, offs = _tc_inputs(cuda, s_in=s_in, hd=hd, groups=4,
                                       seed=11)
    k1 = pa.paged_decode_attention(q, k, v, tables, offs, window=window)
    carry = pa.paged_carry_attention(q, k, v, tables, offs, window=window)
    B, H, S, _ = q.shape
    k2 = pa.finalize_paged_carry(carry, B, H, S, hd, q.dtype)
    assert torch.equal(k1, k2)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s_in", [80, 200])
def test_k2_tensor_core_rows_with_no_owned_key_keep_the_carry(cuda, hd,
                                                              s_in):
    """On the tensor-core mode: a hop whose slice owns none of a slot's
    blocks leaves that slot's carry exactly as it came in (and gives
    (0, NEG_INF, 0) without one); with the first half of a slot's blocks
    another rank's and a window of 48, its rows whose window lies in that
    half keep the carry exactly too, while the other rows move."""
    from torchdistpackage_tpu_torch.ops import paged_attention as pa

    q, k, v, tables, offs = _tc_inputs(cuda, s_in=s_in, hd=hd, groups=4,
                                       seed=5, mb=20)
    nb = k.shape[0]
    remote = torch.full_like(tables, nb + 5)
    acc, m, l = pa.paged_carry_attention(q, k, v, remote, offs)
    assert (acc == 0).all() and (l == 0).all() and (m == pa.NEG_INF).all()
    seed = pa.paged_carry_attention(q, k, v, tables, offs, window=48)
    again = pa.paged_carry_attention(q, k, v, remote, offs, carry=seed,
                                     window=48)
    for a, b in zip(again, seed):
        assert torch.equal(a, b)
    half = tables.shape[1] // 2
    mixed = tables.clone()
    mixed[:, :half] = -3  # another rank's blocks (re-based below 0)
    out = pa.paged_carry_attention(q, k, v, mixed, offs, carry=seed,
                                   window=48)
    qpos = offs[:, None] + torch.arange(s_in, device=cuda)[None]
    blind = (qpos < half * 16).repeat(1, 4)[:, None, :]  # group-major rows
    blind = blind.expand_as(seed[1])
    assert blind.any() and (~blind).any()
    assert torch.equal(out[1][blind], seed[1][blind])
    assert torch.equal(out[2][blind], seed[2][blind])
    assert torch.equal(out[0][blind], seed[0][blind])
    assert not torch.equal(out[2][~blind], seed[2][~blind])


@pytest.mark.gpu
def test_tensor_core_mask_planted_faults_fail(cuda):
    """The per-element masks of the tensor-core mode are checked: the
    window edge moved by 2 positions (inside a pool block, so only a
    tile's element masks see it) fails the row tolerance for K1 and the
    carry check for K2."""
    from torchdistpackage_tpu_torch.ops import paged_attention as pa

    q, k, v, tables, offs = _tc_inputs(cuda, s_in=200, hd=128, groups=4,
                                       seed=13)
    window = 48
    want = paged_decode_attention_reference(
        q.float(), k.float(), v.float(), tables, offs, window=window)
    got = paged_decode_attention(q, k, v, tables, offs, window=window)
    _assert_rows_close(got, want, torch.bfloat16)
    bad = paged_decode_attention(q, k, v, tables, offs, window=window + 2)
    with pytest.raises(AssertionError):
        _assert_rows_close(bad, want, torch.bfloat16)
    hops = _slices(k, v, tables, 4)
    got, exact, scale = _carry_check(q, hops, offs, window)
    assert _carry_ratio(got, exact, scale, torch.bfloat16) <= 1.0
    bad = _chain(pa.paged_carry_attention, q, hops, offs, window + 2)
    assert _carry_ratio(bad, exact, scale, torch.bfloat16) > 1.0


# ------------------------- K1 and K2 decode rows: the split-KV body


def _decode_inputs(cuda, *, dtype, s_in, hd, groups, seed, mb=280, b=4,
                   offsets=None):
    """q and a pool of 1 + b mb blocks of 16 positions (bf16, f32, or an
    int8 pool with f32 scales and f32 q, or bf16 q for
    ``"bfloat16_int8"``), tables a permutation of its blocks.  Slot
    0's single row sits at position 0 (one key), slot 1's at 70 (mid-
    block), slot 2's last row at the table's last position, and slot 3's
    rows run 40 positions past its table (and past 4096, so a window of
    4096 masks), each still seeing keys under a window of 48."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    hkv, bs = 2, 16
    nb = 1 + b * mb
    tables = (torch.randperm(nb - 1, generator=g, device=cuda) + 1)
    tables = tables.reshape(b, mb).to(torch.int32)
    if offsets is None:
        offsets = [0, 70, mb * bs - s_in, mb * bs - s_in + 40][:b]
    offs = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    qdt = torch.bfloat16 if dtype.startswith("bfloat16") else torch.float32
    q = torch.randn(b, hkv * groups, s_in, hd, generator=g, device=cuda
                    ).to(qdt)
    if dtype.endswith("int8"):
        pools = [(torch.randint(-127, 128, (nb, hkv, bs, hd), generator=g,
                                device=cuda, dtype=torch.int8),
                  torch.rand(nb, hkv, bs, generator=g, device=cuda) * 0.02
                  + 1e-3) for _ in range(2)]
    else:
        pools = [torch.randn(nb, hkv, bs, hd, generator=g, device=cuda
                             ).to(qdt) for _ in range(2)]
    return q, pools[0], pools[1], tables, offs


def _k1_decode_check(q, k, v, tables, offs, window):
    before = LAUNCHES["paged_decode_attention"]
    got = paged_decode_attention(q, k, v, tables, offs, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["paged_decode_attention"] == before + 1
    want = paged_decode_attention_reference(
        q.float(), _f32(k), _f32(v), tables, offs, window=window)
    _assert_rows_close(got, want, q.dtype)
    return got


# (G, S_in): R = G S_in rows a (slot, KV head), up to the decode body's
# 16 (G 16 and 4 x 4 at the edge)
DECODE_ROWS = [(1, 1), (4, 1), (8, 1), (1, 3), (4, 3), (16, 1), (4, 4)]
DECODE_SHAPES = [pytest.param(hd, g, s, w, id=f"hd{hd}-g{g}-s{s}-w{w}")
                 for hd in (64, 128) for g, s in DECODE_ROWS
                 for w in (None, 48, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("hd,groups,s_in,window", DECODE_SHAPES)
def test_k1_split_decode_rows_match_plain_on_card(cuda, hd, groups, s_in,
                                                  window):
    """K1's decode rows on bf16 pools (the split-KV body on the tensor
    cores and the merge), against the plain version in f32, row by row:
    a slot with one key, one mid-block, one ending at its table's last
    position and one running past it."""
    q, k, v, tables, offs = _decode_inputs(
        cuda, dtype="bfloat16", s_in=s_in, hd=hd, groups=groups,
        seed=hd + 10 * groups + s_in)
    _k1_decode_check(q, k, v, tables, offs, window)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16_int8"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("groups,s_in", [(4, 1), (4, 3), (16, 1)])
@pytest.mark.parametrize("window", [None, 48, 4096])
def test_k1_split_decode_rows_f32_and_int8_pools_on_card(cuda, dtype, hd,
                                                         groups, s_in,
                                                         window):
    """f32 and int8 pools keep the walk's CUDA-core arithmetic on the same
    split grid (its split mode at R <= 4, its row mode above)."""
    q, k, v, tables, offs = _decode_inputs(
        cuda, dtype=dtype, s_in=s_in, hd=hd, groups=groups, seed=hd + s_in)
    _k1_decode_check(q, k, v, tables, offs, window)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("groups,s_in", [(1, 1), (4, 1), (8, 1), (4, 3)])
@pytest.mark.parametrize("window", [None, 48, 4096])
def test_k2_split_decode_rows_on_quarter_slices_on_card(cuda, dtype, hd,
                                                        groups, s_in,
                                                        window):
    """K2's decode rows through a four-hop chain over quarter-pool slices
    (tables a random permutation), every hop after the first seeded with
    the carry, which the merge takes exactly once; some splits own no
    block of a hop's slice (they write the neutral partial).  The
    finished output, m and l against the plain version's chain in f32."""
    from torchdistpackage_tpu_torch.ops import paged_attention as pa

    q, k, v, tables, offs = _decode_inputs(
        cuda, dtype=dtype, s_in=s_in, hd=hd, groups=groups, seed=hd + s_in)
    hops = _slices(k, v, tables, 4)
    nsplit = pa._splits_for(tables.shape[0] * k.shape[1], tables.shape[1],
                            cuda)
    plan = pa.decode_split_plan(offs.tolist(), s_in, window,
                                tables.shape[1], nsplit)
    idle = 0  # (hop, slot, split) whose share holds blocks, none owned
    for kk, _, tab in hops:
        for slot, shares in enumerate(plan):
            for lo, hi in shares:
                row = tab[slot, lo:hi]
                idle += int(hi > lo and not bool(
                    ((row >= 0) & (row < kk.shape[0])).any()))
    assert idle > 0
    got, exact, scale = _carry_check(q, hops, offs, window)
    assert _carry_ratio(got, exact, scale, getattr(torch, dtype)) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("nsplit", [1, 2, 7, 64, 1000])
def test_split_decode_rows_hold_at_any_split_count(cuda, monkeypatch,
                                                   nsplit):
    """The split count pinned from 1 to far more than any slot's live
    blocks (most splits then empty): K1 holds, and K2 at cp 1 finished
    equals K1 bit for bit at every count."""
    from torchdistpackage_tpu_torch.ops import paged_attention as pa

    monkeypatch.setattr(pa, "decode_splits", lambda bh, mb, sms: nsplit)
    q, k, v, tables, offs = _decode_inputs(
        cuda, dtype="bfloat16", s_in=1, hd=128, groups=4, seed=nsplit)
    k1 = _k1_decode_check(q, k, v, tables, offs, 4096)
    carry = pa.paged_carry_attention(q, k, v, tables, offs, window=4096)
    B, H, S, hd = q.shape
    assert torch.equal(k1, pa.finalize_paged_carry(carry, B, H, S, hd,
                                                   q.dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_split_decode_rows_at_a_32k_context(cuda, dtype):
    """Mixtral-8x7B-v0.1's 32768 positions without a window: 4 slots at
    32767, 24575, 16383 and 8191 (2048 blocks of table), K1 against the
    plain version and (float pools) K2's four-hop chain."""
    mb = 2048
    q, k, v, tables, offs = _decode_inputs(
        cuda, dtype=dtype, s_in=1, hd=128, groups=4, seed=32, mb=mb,
        offsets=[32767, 24575, 16383, 8191])
    _k1_decode_check(q, k, v, tables, offs, None)
    if dtype != "int8":
        got, exact, scale = _carry_check(q, _slices(k, v, tables, 4), offs,
                                         None)
        assert _carry_ratio(got, exact, scale, q.dtype) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_split_decode_rows_are_bitwise_repeatable(cuda, dtype):
    """The merge adds the partials in split order (no atomics), so two
    launches on the same inputs give the same bits: K1, and K2 seeded
    with a carry over quarter slices."""
    from torchdistpackage_tpu_torch.ops import paged_attention as pa

    q, k, v, tables, offs = _decode_inputs(
        cuda, dtype=dtype, s_in=1, hd=128, groups=4, seed=5)
    runs = [pa.paged_decode_attention(q, k, v, tables, offs, window=4096)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    if dtype != "int8":
        hops = _slices(k, v, tables, 4)
        chains = [_chain(pa.paged_carry_attention, q, hops, offs, 4096)
                  for _ in range(2)]
        for a, b in zip(*chains):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_split_decode_rows_past_the_ordered_slot_count(cuda):
    """With more slots than the kernel ranks longest-first
    (``DECODE_ORDER_MAX_SLOTS``), the split grid keeps its own order: K1
    still holds, and K2 at cp 1 finished still equals K1 bit for bit."""
    from torchdistpackage_tpu_torch.ops import paged_attention as pa

    b, mb = pa.DECODE_ORDER_MAX_SLOTS + 4, 8
    offs = torch.randint(0, mb * 16, (b,), generator=torch.Generator(
        ).manual_seed(3)).tolist()
    q, k, v, tables, offs = _decode_inputs(
        cuda, dtype="bfloat16", s_in=1, hd=128, groups=4, seed=260, mb=mb,
        b=b, offsets=offs)
    k1 = _k1_decode_check(q, k, v, tables, offs, 48)
    carry = pa.paged_carry_attention(q, k, v, tables, offs, window=48)
    B, H, S, hd = q.shape
    assert torch.equal(k1, pa.finalize_paged_carry(carry, B, H, S, hd,
                                                   q.dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [8, 64])
def test_split_decode_slot_order_keeps_the_bits(cuda, monkeypatch, b):
    """The longest-first order only moves (slot, head, split) items
    between CTAs: K1 and K2 give the same bits with the grid's own
    order."""
    from torchdistpackage_tpu_torch.ops import paged_attention as pa

    offs = torch.randint(0, 64 * 16, (b,), generator=torch.Generator(
        ).manual_seed(b)).tolist()
    q, k, v, tables, offs = _decode_inputs(
        cuda, dtype="bfloat16", s_in=1, hd=128, groups=4, seed=b, mb=64,
        b=b, offsets=offs)
    assert b <= pa.DECODE_ORDER_MAX_SLOTS
    outs = []
    for limit in (pa.DECODE_ORDER_MAX_SLOTS, 0):
        monkeypatch.setattr(pa, "DECODE_ORDER_MAX_SLOTS", limit)
        outs.append((pa.paged_decode_attention(q, k, v, tables, offs),
                     *pa.paged_carry_attention(q, k, v, tables, offs)))
    for a, c in zip(*outs):
        assert torch.equal(a, c)
