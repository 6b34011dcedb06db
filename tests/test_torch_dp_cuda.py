"""The data-parallel slice on the card: the step at world 1 over NCCL,
remat 'flash_offload' and dropout.

Every test is ``gpu``-marked and skips without a CUDA device.  The file
imports neither JAX nor the JAX package; on a machine without JAX run
it past the repo's ``tests/conftest.py`` (which imports JAX)::

    python -m pytest --noconftest -m gpu tests/test_torch_dp_cuda.py
"""

import dataclasses
import socket

import pytest
import torch
import torch.distributed as dist

from torchdistpackage_tpu_torch.models import (
    GPTConfig,
    gpt_loss,
    init_gpt_params,
)
from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
from torchdistpackage_tpu_torch.ops import flash_attention as fa
from torchdistpackage_tpu_torch.parallel.data_parallel import (
    DataParallel,
    adamw,
    make_train_step,
)
from torchdistpackage_tpu_torch.parallel.tensor_parallel.layers import (
    dropout,
)

pytestmark = pytest.mark.gpu

#: a small GPT the kernels take (head dim 64, S a multiple of 64)
SMALL = dict(vocab_size=512, dim=256, nheads=4, nlayers=2, max_seq=128,
             attn_impl="flash")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def nccl1(cuda):
    """A one-rank NCCL group and ``tpc``'s data axis over it."""
    from torchdistpackage_tpu_torch.dist import init_distributed, tpc

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    init_distributed(f"tcp://127.0.0.1:{port}", 1, 0, "cuda")
    try:
        tpc.setup_process_groups([("data", 1)])
        yield tpc
    finally:
        tpc.reset()
        dist.destroy_process_group()


def _batch(cfg, rows=4, seed=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (rows, cfg.max_seq)
    return {k: torch.randint(0, cfg.vocab_size, shape, generator=g,
                             device="cuda") for k in ("tokens", "targets")}


def _train(cfg, dp=None, steps=3, **kw):
    params = init_gpt_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = adamw(1e-3)
    state = opt.init(params)
    lf = lambda p, b: gpt_loss(p, b, cfg, **kw)  # noqa: E731
    step = make_train_step(lf, opt) if dp is None else dp.make_train_step(
        lf, opt)
    losses = []
    for _ in range(steps):
        params, state, loss, _ = step(params, state, _batch(cfg))
        losses.append(loss)
    return losses, params


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cap_mb", [0.25, 25], ids=["small", "default"])
def test_dp_world1_nccl_is_bit_identical(nccl1, dtype, cap_mb):
    cfg = GPTConfig(**SMALL, dtype=dtype)
    dp = DataParallel(bucket_cap_mb=cap_mb)
    want_l, want_p = _train(cfg, remat="flash")
    got_l, got_p = _train(cfg, dp, remat="flash")
    assert dist.get_backend(dp.group) == "nccl"
    if cap_mb < 1:
        assert dp.last_stats["buckets"] > 1
        assert dp.last_stats["bytes_before_blocks_done"] > 0
    else:
        assert dp.last_stats["buckets"] == 1
    for a, b in zip(got_l, want_l):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(got_p), tree_leaves(want_p)):
        assert torch.equal(a, b)


def test_flash_offload_keeps_o_in_pinned_host_memory(cuda):
    rec, _ = fa.flash_residual_contexts(offload=True)
    q, k, v = (torch.randn(2, 4, 128, 64, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    with rec:
        o = fa.flash_attention(q, k, v)
        stash = fa._STASH.get()[0]
    kept, lse = stash[0]
    assert isinstance(kept, fa._Offloaded)
    assert kept.host.device.type == "cpu" and kept.host.is_pinned()
    assert lse.is_cuda
    torch.cuda.synchronize()
    assert torch.equal(kept.host.to("cuda"), o)
    assert torch.equal(kept.get(), o)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_offload_matches_flash(cuda, dtype):
    cfg = GPTConfig(**SMALL, dtype=dtype)
    out = {}
    for remat in ("flash", "flash_offload"):
        params = init_gpt_params(
            cfg, torch.Generator(device="cuda").manual_seed(0))
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss = gpt_loss(params, _batch(cfg), cfg, remat=remat)
        loss.backward()
        out[remat] = (loss.detach(), [p.grad for p in tree_leaves(params)])
    assert torch.equal(out["flash"][0], out["flash_offload"][0])
    for a, b in zip(out["flash"][1], out["flash_offload"][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dropout_repeats_bit_for_bit(cuda, dtype):
    x = torch.randn(4, 128, 256, device="cuda", dtype=dtype)
    a, b = dropout(x, 0.5, 7), dropout(x, 0.5, 7)
    assert torch.equal(a, b)
    assert not torch.equal(a, dropout(x, 0.5, 8))
    kept = a != 0
    assert torch.equal(a[kept], (x / 0.5)[kept])
    frac = kept.float().mean().item()
    assert abs(frac - 0.5) < 0.01


def test_dropout_training_repeats_bit_for_bit(cuda):
    cfg = dataclasses.replace(GPTConfig(**SMALL, dtype=torch.bfloat16),
                              dropout_rate=0.1)
    runs = [_train(cfg, remat="flash", dropout_key=11)[0] for _ in range(2)]
    rate0 = _train(dataclasses.replace(cfg, dropout_rate=0.0),
                   remat="flash")[0]
    for a, b in zip(*runs):
        assert torch.equal(a, b) and torch.isfinite(a)
    assert not all(torch.equal(a, b) for a, b in zip(runs[0], rate0))


def test_prefetch_to_sharding_on_the_card(cuda):
    import numpy as np

    from torchdistpackage_tpu_torch.utils import prefetch_to_sharding

    batches = [{"tokens": np.arange(8 * 4).reshape(8, 4) + 100 * i}
               for i in range(5)]
    got = list(prefetch_to_sharding(iter(batches), prefetch=2))
    assert len(got) == 5
    for i, b in enumerate(got):
        assert b["tokens"].is_cuda
        assert torch.equal(b["tokens"].cpu(),
                           torch.from_numpy(batches[i]["tokens"]))
