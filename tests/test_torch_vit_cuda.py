"""The ViT's attention on the card: K3-K5 at ViT-B/16's attention shape
(non-causal, S 196 patches, hd 64) against their plain versions, and a
ViT training step's launch counts.

K3's ``(o, lse)`` and K4 / K5's grads (a cotangent on o only, as the
ViT's blocks give it) on the same values in f32, bf16 and f32, at B 8 x
12 heads of S 196: a ragged last tile (196 = 128 + 68 rows and keys) on
every body.  Row tolerances are ``tests/test_torch_cuda_kernels.py``'s.
A bf16 ViT step under ``remat='flash'`` launches K3, K4 and K5 once a
layer each (the recompute replays the kept ``(o, lse)``), and its loss
is finite.  ``chip_smoke.py``'s ``vit_train_phase`` runs ViT-B/16 itself.

Every test is ``gpu``-marked and skips without a CUDA device.  The file
imports neither JAX nor the JAX package::

    python -m pytest --noconftest -m gpu tests/test_torch_vit_cuda.py
"""

import sys
from pathlib import Path

import pytest
import torch

from torchdistpackage_tpu_torch.models import (
    ViTConfig,
    init_vit_params,
    vit_loss,
)
from torchdistpackage_tpu_torch.ops import flash_attention as fa

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_cuda_kernels import (  # noqa: E402
    _assert_rows_close,
    _grad_rows_close,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_kernels_at_vit_shape(cuda, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(196)
    b, h, s, hd = 8, 12, 196, 64

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dt)

    q, k, v, do = (rnd(b, h, s, hd) for _ in range(4))
    args = (hd ** -0.5, False, None)
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


def test_vit_step_launches_each_kernel_once_a_layer(cuda):
    cfg = ViTConfig(dim=128, nheads=2, nlayers=3, num_classes=10,
                    dtype=torch.bfloat16, attn_impl="flash")
    params = init_vit_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    for t in _leaves(params):
        t.requires_grad_(True)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"images": torch.randn(4, 224, 224, 3, generator=g, device=cuda),
             "labels": torch.randint(0, 10, (4,), generator=g, device=cuda)}
    before = dict(fa.LAUNCHES)
    loss = vit_loss(params, batch, cfg, remat="flash")
    loss.backward()
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == dict.fromkeys(
        before, cfg.nlayers)
    assert torch.isfinite(loss)
    assert all(torch.isfinite(t.grad).all() for t in _leaves(params))


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]
