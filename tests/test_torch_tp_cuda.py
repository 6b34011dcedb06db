"""Tensor and sequence parallelism on the card at world 1, through a real
one-rank NCCL ``tensor`` group (the card machine has one H100; the
multi-rank exchange is held on the CPU over gloo, tests/test_torch_tp.py
and tests/test_torch_tp_serving.py).

- every region on a CUDA tensor: at one rank each is a copy, forward and
  backward, and counts each collective it makes (the gather and the
  reduce-scatter one each way, the others one);
- the TP training step (a small bf16 GPT, flash attention, remat
  'flash') at ``sp`` False and True: losses within 1e-3 relative of
  ``make_train_step``'s over 3 steps, K3-K5 once a layer a step, each
  region's collectives as many as a step runs (``chip_smoke.py``'s
  ``tp_collectives``);
- ``ServingEngine(tp_group=)`` on a small bf16 Llama: tokens equal to the
  plain engine's (at one rank the arithmetic is the plain engine's), K1
  once a layer a device call;
- ``generate(tp_group=)``, dense and MoE: tokens equal to ``generate()``'s;
- ``gather_params`` of the shard is the tree.

Every test is ``gpu``-marked and skips without a CUDA device.  The file
imports neither JAX nor the JAX package::

    python -m pytest --noconftest -m gpu tests/test_torch_tp_cuda.py
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torchdistpackage_tpu_torch.models import (
    GPTConfig,
    generate,
    gpt_loss,
    init_gpt_moe_params,
    init_gpt_params,
    llama_config,
)
from torchdistpackage_tpu_torch.models.gpt import (
    gpt_param_specs,
    shard_gpt_params,
)
from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
from torchdistpackage_tpu_torch.ops import flash_attention as fa
from torchdistpackage_tpu_torch.ops import moe_dispatch as md
from torchdistpackage_tpu_torch.ops import paged_attention as pa
from torchdistpackage_tpu_torch.parallel import tensor_parallel as tpl
from torchdistpackage_tpu_torch.parallel.data_parallel import (
    adamw,
    make_train_step,
)

pytestmark = pytest.mark.gpu

#: a small GPT the kernels take (head dim 64)
SMALL = dict(vocab_size=512, dim=256, nheads=4, nlayers=2, max_seq=128,
             attn_impl="flash")
LLAMA = dict(vocab_size=512, dim=256, nheads=4, nlayers=2, max_seq=256,
             kv_heads=2, ffn_hidden=512, attn_impl="flash")


@pytest.fixture(scope="module")
def tensor1():
    """A one-rank NCCL group as ``tpc``'s tensor axis; yields the group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torchdistpackage_tpu_torch.dist import init_distributed, tpc

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    init_distributed(f"tcp://127.0.0.1:{port}", 1, 0, "cuda")
    try:
        tpc.setup_process_groups([("data", 1), ("tensor", 1)])
        group = tpc.get_group("tensor")
        assert dist.get_backend(group) == "nccl"
        yield group
    finally:
        tpc.reset()
        dist.destroy_process_group()


def _zero_counts():
    for counts in (fa.LAUNCHES, pa.LAUNCHES, md.LAUNCHES, tpl.COLLECTIVES):
        for name in counts:
            counts[name] = 0


@pytest.mark.parametrize("name", ["reduce_from_tp", "copy_to_tp",
                                  "gather_from_sp", "scatter_to_sp",
                                  "split_to_sp"])
def test_region_is_a_copy_at_one_rank(tensor1, name):
    fn = getattr(tpl, name)
    x = torch.randn(2, 8, 16, device="cuda", requires_grad=True)
    w = torch.randn(2, 8, 16, device="cuda")
    _zero_counts()
    y = fn(x, tensor1)
    (y * w).sum().backward()
    assert torch.equal(y, x.detach()) and torch.equal(x.grad, w)
    assert y.is_contiguous()
    # the gather and the reduce-scatter make one each way; the others one
    assert tpl.COLLECTIVES[name] == (2 if name in ("gather_from_sp",
                                                   "scatter_to_sp") else 1)


@pytest.mark.parametrize("sp", [False, True])
def test_tp_step_follows_the_serial_step(tensor1, sp):
    cfg = GPTConfig(**SMALL, dtype=torch.bfloat16, collective_matmul=sp)
    L, steps = cfg.nlayers, 3
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, cfg.max_seq),
                              generator=g, device="cuda")
             for k in ("tokens", "targets")}
    runs = {}
    for tp in (False, True):
        params = init_gpt_params(cfg, torch.Generator(device="cuda")
                                 .manual_seed(0))
        group = tensor1 if tp else None
        if tp:
            params = shard_gpt_params(params, cfg, 0, 1)
        opt = adamw(3e-4)
        state = opt.init(params)
        kw = dict(param_specs=gpt_param_specs(params), sp=sp,
                  tp_group=group) if tp else {}
        step = make_train_step(
            lambda p, b: gpt_loss(p, b, cfg, remat="flash", tp_group=group,
                                  sp=sp if tp else False), opt, **kw)
        _zero_counts()
        losses = [float(step(params, state, batch)[2]) for _ in range(steps)]
        runs[tp] = (losses, dict(fa.LAUNCHES),
                    {k: v for k, v in tpl.COLLECTIVES.items() if v})
    (base, _, _), (got, launches, coll) = runs[False], runs[True]
    assert np.isfinite(got).all()
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, base))
    assert rel <= 1e-3, (got, base)
    assert all(n == L * steps for n in launches.values()), launches
    want = ({"split_to_sp": 1, "gather_from_sp": 6 * L + 2,
             "scatter_to_sp": 5 * L, "reduce_from_tp": 2, "xent_max": 1}
            if sp else {"reduce_from_tp": 3 * L + 2, "copy_to_tp": 2 * L + 1,
                        "xent_max": 1})
    assert coll == {k: v * steps for k, v in want.items()}


def test_tp_engine_tokens_equal_the_plain_engine(tensor1):
    from torchdistpackage_tpu_torch.serving import Request, ServingEngine

    cfg = llama_config(**LLAMA, dtype=torch.bfloat16)
    params = init_gpt_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0))
    rs = np.random.RandomState(3)
    reqs = [Request(rs.randint(0, 512, n).tolist(), 12) for n in (20, 70, 130)]
    reqs.append(Request(rs.randint(0, 512, 40).tolist(), 12, temperature=0.8,
                        top_k=20, seed=5))
    out = {}
    for tp in (False, True):
        eng = ServingEngine(
            shard_gpt_params(params, cfg, 0, 1) if tp else params, cfg,
            num_slots=4, block_size=16, chunk=64, max_ctx=256,
            **({"tp_group": tensor1} if tp else {}))
        rids = [eng.submit(r) for r in reqs]
        _zero_counts()
        eng.run_until_idle()
        s = eng.serving_summary()
        calls = s["prefill_chunks"] + s["decode_steps"]
        assert pa.LAUNCHES["paged_decode_attention"] == cfg.nlayers * calls
        assert s["kv_pool"]["pool_bytes"] == s["kv_pool"][
            "pool_bytes_expected"]
        out[tp] = [eng.finished[r]["tokens"] for r in rids]
    for a, b in zip(out[False], out[True]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_tp_generate_equals_generate(tensor1, family):
    kw = dict(LLAMA, nlayers=2)
    if family == "moe":
        kw.update(moe_experts=4, moe_every=1)
    cfg = llama_config(**kw, dtype=torch.bfloat16)
    init = init_gpt_moe_params if family == "moe" else init_gpt_params
    params = init(cfg, torch.Generator(device="cuda").manual_seed(0))
    prompt = torch.from_numpy(np.random.RandomState(4).randint(
        0, 512, (2, 100))).cuda()
    want = generate(params, prompt, cfg, 10)
    _zero_counts()
    got = generate(shard_gpt_params(params, cfg, 0, 1), prompt, cfg, 10,
                   tp_group=tensor1)
    assert torch.equal(got, want)
    assert fa.LAUNCHES["flash_fwd"] == cfg.nlayers
    if family == "moe":
        assert md.LAUNCHES["fused_moe_ffn"] == cfg.nlayers * 10
    assert tpl.COLLECTIVES["full_logits"] == 10


def test_gather_params_is_the_tree(tensor1):
    cfg = GPTConfig(**SMALL, dtype=torch.bfloat16)
    params = init_gpt_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0))
    shard = shard_gpt_params(params, cfg, 0, 1)
    back = tpl.gather_params(shard, gpt_param_specs(shard), tensor1)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b)
