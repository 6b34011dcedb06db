"""The compressed collectives on the card: the int8 quantizer on CUDA
tensors against the CPU's, and the ``n == 1`` contract of DataParallel,
ZeroOptimizer and FSDP's overlap step under their int8 modes over a
one-rank NCCL data group (the reference's rings fall back to the exact
collective at one member, so each compressed step equals its exact step
bit for bit), on a 2-layer GPT of GPT-125M's widths.

``chip_smoke.py``'s ``compress_phase`` runs these at full depth and the
rings over two processes; the rings at n 2 and 4 are held against JAX
on the CPU (``tests/test_torch_compressed.py``).

Every test is ``gpu``-marked and skips without a CUDA device.  The file
imports neither JAX nor the JAX package::

    python -m pytest --noconftest -m gpu tests/test_torch_compressed_cuda.py
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torchdistpackage_tpu_torch.dist import compressed as C
from torchdistpackage_tpu_torch.models import GPTConfig, gpt_loss
from torchdistpackage_tpu_torch.models import init_gpt_params
from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
from torchdistpackage_tpu_torch.ops import flash_attention as fa
from torchdistpackage_tpu_torch.parallel import (
    FSDP,
    DataParallel,
    ZeroOptimizer,
    adamw,
)

pytestmark = pytest.mark.gpu

#: GPT-125M's widths at 2 layers and S 256
CFG = dict(vocab_size=32768, dim=768, nheads=12, nlayers=2, max_seq=256,
           ffn_mult=4, dtype=torch.bfloat16, attn_impl="flash")
STEPS = 3


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def nccl1(card):
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


@pytest.mark.parametrize("size", [1 << 20, 192 * 1000 + 7, 4096])
def test_quantizer_codes_on_the_card_equal_the_cpu(card, size):
    rs = np.random.RandomState(size)
    x = rs.randn(size).astype(np.float32)
    x[::97] *= 500.0
    qc, sc = C._quant(torch.from_numpy(x).to(card))
    qh, sh = C._quant(torch.from_numpy(x))
    assert int((qc.cpu() != qh).sum()) == 0
    assert torch.equal(sc.cpu(), sh)
    assert torch.equal(C._dequant(qc, sc).cpu(), C._dequant(qh, sh))
    xq, e = C.ef_compress(torch.from_numpy(x).to(card))
    hq, he = C.ef_compress(torch.from_numpy(x))
    assert torch.equal(xq.cpu(), hq) and torch.equal(e.cpu(), he)


def _run(kind, opts):
    cfg = GPTConfig(**CFG)
    params = init_gpt_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, cfg.max_seq),
                              generator=g, device="cuda")
             for k in ("tokens", "targets")}
    opt = adamw(3e-4)
    lf = lambda p, b: gpt_loss(p, b, cfg, remat="flash")  # noqa: E731
    if kind == "dp":
        state = opt.init(params)
        step = DataParallel(**opts).make_train_step(lf, opt)
    elif kind == "zero":
        owner = ZeroOptimizer(opt, param_dtype=cfg.dtype, **opts)
        params = owner.place_params(params)
        state = owner.init(params)
        step = owner.make_train_step(lf)
    else:
        owner = FSDP()
        params = owner.shard_params(params)
        state = opt.init(params)
        step = owner.make_overlap_train_step(lf, opt, **opts)
    for n in fa.LAUNCHES:
        fa.LAUNCHES[n] = 0
    losses = []
    for _ in range(STEPS):
        params, state, loss, _ = step(params, state, batch)
        losses.append(float(loss))
    return losses, [p.detach().clone() for p in tree_leaves(params)], \
        dict(fa.LAUNCHES)


@pytest.mark.parametrize("kind,opts", [
    ("dp", {"grad_compress": "int8"}),
    ("dp", {"grad_compress": "auto"}),
    ("zero", {"grad_compress": "int8", "gather_compress": "follow"}),
    ("fsdp", {"grad_compress": "int8"}),
])
def test_one_rank_compressed_steps_equal_the_exact_ones(nccl1, kind, opts):
    want, wparams, _ = _run(kind, {})
    got, gparams, launches = _run(kind, opts)
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(gparams, wparams))
    assert all(v == CFG["nlayers"] * STEPS for v in launches.values())
    assert all(np.isfinite(got)) and got[-1] < got[0]
