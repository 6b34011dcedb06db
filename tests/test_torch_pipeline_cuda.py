"""The pipeline on the card: one stage over a one-rank NCCL data 1 x
pipe 1 layout on a 2-layer GPT of GPT-125M's widths, and the
point-to-point helper's host path over a one-rank gloo group with CUDA
payloads.

``gpt_pipeline_1f1b`` at M 4 must hold to ``local_value_and_grad`` at
accumulation 4 (loss 1e-3 relative, every grad leaf 2 % of its largest
|grad|) with K3-K5 launched exactly layers x M times; ``gpt_pipeline_zb``
the same with its stated 3 x / 2 x / 2 x launches.  ``chip_smoke.py``'s
``pipeline_phase`` runs these at full depth and two stages as two
processes; the multi-stage exchanges are held on the CPU over gloo
(``tests/test_torch_pipeline.py``, ``tests/test_torch_pipeline_compose.py``).

Every test is ``gpu``-marked and skips without a CUDA device.  The file
imports neither JAX nor the JAX package::

    python -m pytest --noconftest -m gpu tests/test_torch_pipeline_cuda.py
"""

import socket

import pytest
import torch
import torch.distributed as dist

from torchdistpackage_tpu_torch.models import (
    GPTConfig,
    gpt_loss,
    gpt_pipeline_1f1b,
    gpt_pipeline_loss,
    gpt_pipeline_zb,
    init_gpt_params,
)
from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
from torchdistpackage_tpu_torch.ops import flash_attention as fa
from torchdistpackage_tpu_torch.parallel.data_parallel import (
    local_value_and_grad,
)

pytestmark = pytest.mark.gpu

#: GPT-125M's widths at 2 layers and S 256
CFG = dict(vocab_size=32768, dim=768, nheads=12, nlayers=2, max_seq=256,
           ffn_mult=4, dtype=torch.bfloat16, attn_impl="flash")
M, ROWS = 4, 8
LOSS_TOL, GRAD_TOL = 1e-3, 0.02


def _port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def nccl1():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torchdistpackage_tpu_torch.dist import init_distributed, tpc

    init_distributed(f"tcp://127.0.0.1:{_port()}", 1, 0, "cuda")
    try:
        tpc.setup_process_groups([("data", 1), ("pipe", 1)])
        yield tpc
    finally:
        tpc.reset()
        dist.destroy_process_group()


def _setup():
    cfg = GPTConfig(**CFG)
    params = init_gpt_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (ROWS, cfg.max_seq),
                              generator=g, device="cuda")
             for k in ("tokens", "targets")}
    ref = local_value_and_grad(
        lambda p, b: gpt_loss(p, b, cfg, remat="flash"), params, batch,
        grad_accum_iters=M)
    micro = {k: v.reshape(M, ROWS // M, -1) for k, v in batch.items()}
    return cfg, params, micro, ref


def _held(loss, grads, ref):
    rl, rg = ref
    assert abs(float(loss) - float(rl)) <= LOSS_TOL * abs(float(rl))
    for g, r in zip(tree_leaves(grads), tree_leaves(rg)):
        gap = (g.float() - r.float()).abs().max()
        assert gap <= GRAD_TOL * r.float().abs().max(), float(gap)


@pytest.mark.parametrize("sched,per", [("1f1b", (1, 1, 1)),
                                       ("zb", (3, 2, 2))])
def test_one_stage_pipeline_matches_accumulation(nccl1, sched, per):
    cfg, params, micro, ref = _setup()
    fn = gpt_pipeline_1f1b if sched == "1f1b" else gpt_pipeline_zb
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    loss, grads = fn(params, micro, cfg, M, remat="flash")
    torch.cuda.synchronize()
    L = cfg.nlayers
    assert [fa.LAUNCHES[k] for k in ("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv")] == [
        n * L * M for n in per]
    _held(loss, grads, ref)
    assert all(p.grad is None for p in tree_leaves(params))


def test_one_stage_pipeline_loss_under_autograd(nccl1):
    """``gpt_pipeline_loss`` (the fill-drain schedule, the caller's
    backward) at one stage: the accumulated loss and grads."""
    cfg, params, micro, ref = _setup()
    loss = gpt_pipeline_loss(params, micro, cfg, M, remat="flash")
    loss.backward()
    _held(loss.detach(), {k: _grad_tree(v) for k, v in params.items()}, ref)


def _grad_tree(t):
    if isinstance(t, dict):
        return {k: _grad_tree(v) for k, v in t.items()}
    return t.grad


@pytest.fixture(scope="module")
def gloo1(nccl1):
    """A one-rank gloo group beside the NCCL default group."""
    group = dist.new_group([0], backend="gloo")
    yield group


def test_host_path_over_gloo_with_cuda_payloads(gloo1):
    """Over gloo a CUDA payload travels through a counted host copy: the
    pipe all-reduce, the shape preamble and ``last_stage_value``; the
    results stay on the card."""
    from torchdistpackage_tpu_torch.parallel.pipeline_parallel import (
        _p2p,
        last_stage_value,
    )

    _p2p.reset_stats()
    t = torch.arange(6.0, device="cuda").reshape(2, 3)
    out = _p2p.all_reduce_(t.clone(), gloo1)
    assert out.is_cuda and torch.equal(out, t)
    assert _p2p.P2P_STATS["host_copies"] == 2
    assert _p2p.P2P_STATS["host_copy_bytes"] == 2 * t.numel() * 4
    shape, dtype = _p2p.shape_preamble(gloo1, t.to(torch.bfloat16),
                                       t.device)
    assert shape == (2, 3) and dtype == torch.bfloat16
    x = torch.tensor(3.0, device="cuda", requires_grad=True)
    y = last_stage_value(x, pipe_group=gloo1)
    (2 * y).backward()
    assert y.is_cuda and float(y) == 3.0 and float(x.grad) == 2.0
    assert _p2p.P2P_STATS["host_copies"] == 4
    assert _p2p.exchange(gloo1) == []
