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
