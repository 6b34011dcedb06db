"""The training run's resilience and profiling tools on the card.

- A CUDA checkpoint (params and AdamW state) restored in place: one more
  step after it equals, bit for bit, the step of a run that never saved
  or restored.
- ``TimedScope`` with ``sync_on`` waits for the card before it stops
  the clock.
- A ``profile_blocks`` pass (one call a block) launches K3 once a block.

Every test is ``gpu``-marked and skips without a CUDA device.  The file
imports neither JAX nor the JAX package; on a machine without JAX run
it past the repo's ``tests/conftest.py`` (which imports JAX)::

    python -m pytest --noconftest -m gpu tests/test_torch_resilience_cuda.py
"""

import pytest
import torch

from torchdistpackage_tpu_torch.models import (
    GPTConfig,
    gpt_embed,
    gpt_loss,
    init_gpt_params,
)
from torchdistpackage_tpu_torch.models.gpt import layer_params
from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
from torchdistpackage_tpu_torch.ops import flash_attention as fa
from torchdistpackage_tpu_torch.parallel.data_parallel import (
    adamw,
    make_train_step,
)
from torchdistpackage_tpu_torch.parallel.tensor_parallel.layers import (
    block_forward,
)
from torchdistpackage_tpu_torch.resilience import GuardedCheckpointManager
from torchdistpackage_tpu_torch.tools import profile_blocks
from torchdistpackage_tpu_torch.utils import TimedScope

pytestmark = pytest.mark.gpu

SMALL = dict(vocab_size=512, dim=256, nheads=4, nlayers=2, max_seq=128,
             attn_impl="flash", dtype=torch.bfloat16)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(cfg, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (2, cfg.max_seq)
    return {k: torch.randint(0, cfg.vocab_size, shape, generator=g,
                             device="cuda") for k in ("tokens", "targets")}


def _run(cfg):
    params = init_gpt_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = adamw(1e-3)
    state = opt.init(params)
    step = make_train_step(lambda p, b: gpt_loss(p, b, cfg, remat="flash"),
                           opt, numerics=True)
    return params, state, step


def test_checkpoint_restored_in_place_steps_as_never_saved(cuda, tmp_path):
    cfg = GPTConfig(**SMALL)
    ref_p, ref_s, ref_step = _run(cfg)
    for i in range(3):
        ref_step(ref_p, ref_s, _batch(cfg, i))
    params, state, step = _run(cfg)
    for i in range(2):
        step(params, state, _batch(cfg, i))
    with GuardedCheckpointManager(str(tmp_path), max_to_keep=2) as mgr:
        payload = {"params": params, "opt": state, "loop": {"data_offset": 0}}
        assert mgr.save(1, payload)
        ptrs = [p.data_ptr() for p in tree_leaves(params)]
        step(params, state, _batch(cfg, 7))  # a step the restore undoes
        mgr.wait_until_finished()
        mgr.restore(1, template=payload)
    assert ptrs == [p.data_ptr() for p in tree_leaves(params)]
    step(params, state, _batch(cfg, 2))
    for a, b in zip(tree_leaves(params), tree_leaves(ref_p)):
        assert torch.equal(a, b)
    for sa, sb in zip(state.state.values(), ref_s.state.values()):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k], sb[k])


def test_timed_scope_waits_for_the_card(cuda):
    x = torch.randn(4096, 4096, device=cuda)
    for _ in range(2):
        y = x @ x
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    with TimedScope("chain") as t:
        t0.record()
        y = x
        for _ in range(20):
            y = y @ x
        t1.record()
        t.sync_on(y)
    device_ms = t0.elapsed_time(t1)
    assert t.elapsed * 1e3 >= device_ms


def test_profile_blocks_launches_k3_once_a_block(cuda):
    cfg = GPTConfig(**SMALL)
    params = init_gpt_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    blocks = [(f"blocks/{i}", lambda h, p=layer_params(params, i):
               block_forward(p, h, cfg.block)) for i in range(cfg.nlayers)]
    with torch.no_grad():
        h = gpt_embed(params, _batch(cfg, 0)["tokens"])
        before = fa.LAUNCHES["flash_fwd"]
        profs, out = profile_blocks(blocks, h, warmup=0, iters=1)
    assert fa.LAUNCHES["flash_fwd"] - before == cfg.nlayers
    assert [p.name for p in profs] == ["blocks/0", "blocks/1"]
    assert all(p.time_ms > 0 and p.act_bytes == h.numel() * 2
               for p in profs)
    assert torch.isfinite(out).all()
