"""The serving compositions on the card at world 1, through real one-rank
NCCL groups (the card machine has one H100; the multi-rank exchanges are
held on the CPU over gloo, tests/test_torch_serving_compose.py):

- data groups: ``ServingEngine(dp_group=)`` over a one-rank data group
  (the step's gather then runs on the device tensor, NCCL's path) on a
  small bf16 Llama: tokens equal to the plain engine's, K1 once a layer a
  device call, each call one body launch (the split or the tensor-core
  body, by ``_build.body_launches``);
- TP x EP: a small bf16 Mixtral-style model over tensor 1 x moe_ep 1 (the
  MoE view, the replica group over both), the engine and ``generate``:
  tokens equal to the EP engine's and ``generate(ep_group=)``'s, K7 once
  an expert layer a forward call (each a K7 body's up pass, no K6 body),
  K3 once a layer at ``generate``'s prefill;
- TP x CP: the CP engine over context 1 x tensor 1: tokens equal to the
  CP engine's, K2 once a layer a device call, K1 never.

Every test is ``gpu``-marked and skips without a CUDA device.  The file
imports neither JAX nor the JAX package::

    python -m pytest --noconftest -m gpu tests/test_torch_compose_cuda.py
"""

import socket

import numpy as np
import pytest
import torch

from torchdistpackage_tpu_torch.models import (
    generate,
    init_gpt_moe_params,
    init_gpt_params,
    llama_config,
    shard_moe_params,
)
from torchdistpackage_tpu_torch.models.gpt import shard_gpt_params
from torchdistpackage_tpu_torch.ops import _build
from torchdistpackage_tpu_torch.ops import flash_attention as fa
from torchdistpackage_tpu_torch.ops import moe_dispatch as md
from torchdistpackage_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.gpu

LLAMA = dict(vocab_size=512, dim=256, nheads=4, nlayers=2, max_seq=512,
             kv_heads=2, ffn_hidden=512, attn_impl="flash")
MOE = dict(LLAMA, moe_experts=4, moe_every=1)
ENGINE = dict(num_slots=4, block_size=16, chunk=64, max_ctx=512)
#: each K1 / K2 call launches exactly one of these bodies (the split
#: body's merge aside); each K7 call one of these up passes
PAGED_BODIES = ("paged_split_kernel", "paged_tc_kernel", "paged_walk_kernel")
K7_BODIES = ("expert_ffn_up_decode_kernel", "expert_ffn_up_wgmma_kernel",
             "expert_ffn_kernel")
K6_BODIES = ("moe_ffn_up_decode_kernel", "moe_ffn_up_wgmma_kernel",
             "moe_ffn_kernel")


@pytest.fixture(scope="module")
def ctx():
    """A one-rank NCCL default group; yields ``tpc`` (each test lays it
    out anew)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import init_distributed, tpc

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    init_distributed(f"tcp://127.0.0.1:{port}", 1, 0, "cuda")
    try:
        yield tpc
    finally:
        tpc.reset()
        dist.destroy_process_group()


def _layout(tpc, config, moe_ep=False):
    tpc.reset()
    tpc.setup_process_groups(config)
    if moe_ep:
        tpc.build_moe_mesh(moe_ep_size=1)
    return tpc


def _zero_counts():
    for counts in (fa.LAUNCHES, pa.LAUNCHES, md.LAUNCHES):
        for name in counts:
            counts[name] = 0


def _bodies(lib, names):
    return {n: _build.body_launches(lib, n) for n in names}


def _requests(vocab, sampled=True):
    from torchdistpackage_tpu_torch.serving import Request

    rs = np.random.RandomState(3)
    reqs = [Request(rs.randint(0, vocab, n).tolist(), 12)
            for n in (20, 70, 130)]
    if sampled:
        reqs.append(Request(rs.randint(0, vocab, 40).tolist(), 12,
                            temperature=0.8, top_k=20, seed=5))
    return reqs


def _serve(params, cfg, reqs, **kw):
    """The engine on ``reqs``: its tokens, device calls and the K1 / K2 /
    K7 counts and body launches of the run."""
    from torchdistpackage_tpu_torch.serving import ServingEngine

    eng = ServingEngine(params, cfg, **ENGINE, **kw)
    rids = [eng.submit(r) for r in reqs]
    paged0 = _bodies("paged_attention", PAGED_BODIES)
    moe0 = _bodies("moe_dispatch", K7_BODIES + K6_BODIES)
    _zero_counts()
    eng.run_until_idle()
    s = eng.serving_summary()
    paged = {k: v - paged0[k]
             for k, v in _bodies("paged_attention", PAGED_BODIES).items()}
    moe = {k: v - moe0[k] for k, v in
           _bodies("moe_dispatch", K7_BODIES + K6_BODIES).items()}
    assert s["requests"]["completed"] == len(reqs)
    assert eng.audit(heal=False)["ok"]
    return {"tokens": [eng.finished[r]["tokens"] for r in rids],
            "calls": s["prefill_chunks"] + s["decode_steps"],
            "launches": {**pa.LAUNCHES, **md.LAUNCHES}, "paged": paged,
            "moe": moe, "summary": s}


def test_dp_engine_one_group_equals_the_plain_engine(ctx):
    cfg = llama_config(**LLAMA, dtype=torch.bfloat16)
    params = init_gpt_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0))
    reqs = _requests(cfg.vocab_size)
    want = _serve(params, cfg, reqs)
    tpc = _layout(ctx, [("data", 1), ("tensor", 1)])
    got = _serve(params, cfg, reqs, dp_group=tpc.get_group("data"))
    for a, b in zip(got["tokens"], want["tokens"]):
        np.testing.assert_array_equal(a, b)
    L, calls = cfg.nlayers, got["calls"]
    assert got["launches"]["paged_decode_attention"] == L * calls
    assert sum(got["paged"].values()) == L * calls
    assert got["summary"]["kv_pool"]["dp_groups"] == 1


def test_tp_ep_engine_and_generate_equal_ep(ctx):
    cfg = llama_config(**MOE, dtype=torch.bfloat16)
    params = init_gpt_moe_params(cfg, torch.Generator(device="cuda")
                                 .manual_seed(0))
    tpc = _layout(ctx, [("data", 1), ("tensor", 1)], moe_ep=True)
    tp, ep = tpc.get_group("tensor"), tpc.get_group("moe_ep")
    shard = shard_moe_params(params, cfg, 0, 1, tp_rank=0, tp_size=1)
    reqs = _requests(cfg.vocab_size)
    want = _serve(shard, cfg, reqs, ep_group=ep, moe_dispatch="cuda")
    got = _serve(shard, cfg, reqs, ep_group=ep, tp_group=tp,
                 replica_group=tpc.replica_group("moe"), moe_dispatch="cuda")
    for a, b in zip(got["tokens"], want["tokens"]):
        np.testing.assert_array_equal(a, b)
    L, calls = cfg.nlayers, got["calls"]
    assert got["launches"]["fused_expert_ffn"] == L * calls
    assert got["launches"]["fused_moe_ffn"] == 0
    assert sum(got["moe"][b] for b in K7_BODIES) == L * calls
    assert sum(got["moe"][b] for b in K6_BODIES) == 0
    prompt = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (2, 100))).cuda()
    plain = generate(shard, prompt, cfg, 10, ep_group=ep)
    _zero_counts()
    toks = generate(shard, prompt, cfg, 10, ep_group=ep, tp_group=tp)
    assert torch.equal(toks, plain)
    assert fa.LAUNCHES["flash_fwd"] == L
    assert md.LAUNCHES["fused_expert_ffn"] == L * 10


def test_tp_cp_engine_equals_the_cp_engine(ctx):
    cfg = llama_config(**LLAMA, dtype=torch.bfloat16)
    params = init_gpt_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0))
    tpc = _layout(ctx, [("context", 1), ("tensor", 1)])
    cp = tpc.get_group("context")
    reqs = _requests(cfg.vocab_size, sampled=False)
    want = _serve(params, cfg, reqs, cp_group=cp)
    got = _serve(shard_gpt_params(params, cfg, 0, 1), cfg, reqs, cp_group=cp,
                 tp_group=tpc.get_group("tensor"),
                 replica_group=tpc.replica_group())
    for a, b in zip(got["tokens"], want["tokens"]):
        np.testing.assert_array_equal(a, b)
    L, calls = cfg.nlayers, got["calls"]
    assert got["launches"]["paged_carry_attention"] == L * calls
    assert got["launches"]["paged_decode_attention"] == 0
    assert sum(got["paged"].values()) == L * calls
