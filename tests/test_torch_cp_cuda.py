"""Context-parallel attention on the card: one ring hop's kernels with a
live lse cotangent, and the ring / Ulysses over a one-rank NCCL group.

A ring hop is one ``flash_attention_with_lse`` call whose lse feeds the
hops' logsumexp combine, so its backward gets a non-zero lse cotangent
that must reach ``flash_delta``: K3's ``(o, lse)`` and K4 / K5's grads
(through autograd, cotangents on both outputs) against their plain
versions on the same values in f32, causal (the diagonal hop) and not
(a past hop), bf16 and f32, at one hop of ``chip_smoke.py``'s cp-2 GPT
(S 4096 a rank, hd 64; two heads here).  Row tolerances are
``tests/test_torch_cuda_kernels.py``'s.  Over a one-rank NCCL group the
ring is one hop — the same K3 call as ``'flash'`` — so its output and
grads equal ``flash_attention``'s bit for bit, and Ulysses' too (its
all-to-alls move nothing); each launches K3 / K4 / K5 once.  Without
a group both ops are that same one flash call.

Every test is ``gpu``-marked and skips without a CUDA device.  The file
imports neither JAX nor the JAX package::

    python -m pytest --noconftest -m gpu tests/test_torch_cp_cuda.py
"""

import importlib
import socket
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from torchdistpackage_tpu_torch.ops import flash_attention as fa

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_cuda_kernels import (  # noqa: E402
    _assert_rows_close,
    _grad_rows_close,
)

ra = importlib.import_module("torchdistpackage_tpu_torch.ops.ring_attention")
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def nccl1():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torchdistpackage_tpu_torch.dist import init_distributed

    init_distributed(f"tcp://127.0.0.1:{_port()}", 1, 0, "cuda")
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_hop_with_lse_cotangent_matches_plain(cuda, dtype, causal):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(int(causal))
    b, h, s, hd = 1, 2, 4096, 64

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dt)

    q, k, v, do = (rnd(b, h, s, hd) for _ in range(4))
    dlse = torch.randn(b, h, s, generator=g, device=cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_attention_with_lse(*leaves, causal=causal)
    dq, dk, dv = torch.autograd.grad((o, lse), leaves, (do, dlse))
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    args = (hd ** -0.5, causal, None)
    exact = [t.float() for t in (q, k, v, do)]
    o_x, lse_x = fa.flash_fwd_reference(*exact[:3], *args)
    _assert_rows_close(o, o_x, dt)
    assert float((lse - lse_x).abs().max()) <= 2e-5
    delta = fa.flash_delta(o_x, exact[3], dlse)
    assert float(dlse.abs().max()) > 0.5  # the cotangent is live
    sq, sk, sv = fa.grad_rounding_scale(*exact, lse_x, delta, *args)
    _grad_rows_close(dq, fa.flash_bwd_dq_reference(*exact, lse_x, delta,
                                                   *args), sq, dt)
    dk_x, dv_x = fa.flash_bwd_dkv_reference(*exact, lse_x, delta, *args)
    _grad_rows_close(dk, dk_x, sk, dt)
    _grad_rows_close(dv, dv_x, sv, dt)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_one_rank_group_equals_flash_bit_for_bit(nccl1, impl):
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(2, 4, 512, 64, generator=g, device="cuda")
                   .bfloat16() for _ in range(4))

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = dict(fa.LAUNCHES)
        out = fn(*leaves)
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        return (out,) + grads, {n: fa.LAUNCHES[n] - before[n]
                                for n in before}

    want, _ = run(lambda *a: fa.flash_attention(*a, causal=True))
    op = ra.ring_attention if impl == "ring" else ra.ulysses_attention
    got, launches = run(lambda *a: op(*a, group=nccl1, causal=True))
    assert launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                        "flash_bwd_dkv": 1}
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_no_group_launches_the_kernels(cuda, impl):
    """Without a context group both ops are one ``flash_attention`` call
    on the card: K3 / K4 / K5 once each, bit for bit ``'flash'``."""
    g = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, do = (torch.randn(2, 4, 256, 64, generator=g, device="cuda")
                   .bfloat16() for _ in range(4))
    op = ra.ring_attention if impl == "ring" else ra.ulysses_attention
    outs = []
    for fn in (lambda *a: fa.flash_attention(*a, causal=True),
               lambda *a: op(*a, causal=True)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = dict(fa.LAUNCHES)
        out = fn(*leaves)
        outs.append((out,) + torch.autograd.grad(out, leaves, do))
        torch.cuda.synchronize()
        assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
            "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    for a, b in zip(*outs):
        assert torch.equal(a, b)
