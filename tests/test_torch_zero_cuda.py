"""The sharded training state on the card: ZeRO, the clip chain, FSDP,
the prefetched layer scan, host offload and the sharded EMA over a
one-rank NCCL data group, on a 2-layer GPT of GPT-125M's widths.

At one rank every gather and reduce-scatter is a copy, so FSDP and the
prefetched scan must equal the plain step bit for bit; ZeRO's step 1
must too (its f32 masters part ways with bf16 AdamW from step 2).
``chip_smoke.py``'s ``zero_fsdp_phase`` runs these paths at full depth;
the multi-rank exchanges are held on the CPU over gloo
(``tests/test_torch_zero.py``, ``tests/test_torch_fsdp.py``).

Every test is ``gpu``-marked and skips without a CUDA device.  The file
imports neither JAX nor the JAX package::

    python -m pytest --noconftest -m gpu tests/test_torch_zero_cuda.py
"""

import socket

import pytest
import torch
import torch.distributed as dist

from torchdistpackage_tpu_torch.models import (
    GPTConfig,
    gpt_embed,
    gpt_loss,
    init_gpt_params,
)
from torchdistpackage_tpu_torch.obs.numerics import tree_bytes, tree_leaves
from torchdistpackage_tpu_torch.ops import flash_attention as fa
from torchdistpackage_tpu_torch.parallel import (
    FSDP,
    ShardedEMA,
    ZeroOptimizer,
    adamw,
    chain,
    clip_by_global_norm_parallel,
    global_grad_norm,
    memory_report,
    offload_to_host,
    prefetched_layer_scan,
    reload_to_device,
    stacked_fsdp_specs,
)
from torchdistpackage_tpu_torch.parallel.data_parallel import (
    _unflatten_like,
    make_train_step,
)
from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
    block_forward,
    checkpoint_block,
)

pytestmark = pytest.mark.gpu

#: GPT-125M's widths at 2 layers and S 256
CFG = dict(vocab_size=32768, dim=768, nheads=12, nlayers=2, max_seq=256,
           ffn_mult=4, dtype=torch.bfloat16, attn_impl="flash")
STEPS = 3
#: f32 masters against bf16 AdamW: the largest relative loss gap allowed
ZERO_TOL = 0.05


@pytest.fixture(scope="module")
def nccl1():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
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


def _cfg():
    return GPTConfig(**CFG)


def _batch(cfg, rows=4):
    g = torch.Generator(device="cuda").manual_seed(1)
    return {k: torch.randint(0, cfg.vocab_size, (rows, cfg.max_seq),
                             generator=g, device="cuda")
            for k in ("tokens", "targets")}


def _params(cfg):
    return init_gpt_params(cfg, torch.Generator(device="cuda").manual_seed(0))


def _run(kind, steps=STEPS, opt=None, ema=None):
    """``(losses, norms, params, state, step)`` of ``steps`` steps."""
    cfg = _cfg()
    lf = lambda p, b: gpt_loss(p, b, cfg, remat="flash")  # noqa: E731
    opt = opt or adamw(1e-3)
    params = _params(cfg)
    if kind == "plain":
        state, step = opt.init(params), make_train_step(lf, opt)
    elif kind == "zero":
        zero = ZeroOptimizer(opt, param_dtype=cfg.dtype)
        params = zero.place_params(params)
        state, step = zero.init(params), zero.make_train_step(lf)
    else:
        fsdp = FSDP()
        params = fsdp.shard_params(params)
        state = opt.init(params)
        step = (fsdp.make_train_step(lf, opt) if kind == "fsdp"
                else fsdp.make_overlap_train_step(lf, opt))
    batch = _batch(cfg)
    losses, norms = [], []
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    for _ in range(steps):
        params, state, loss, gnorm = step(params, state, batch)
        losses.append(float(loss))
        norms.append(float(gnorm))
        if ema is not None:
            ema(params)
    assert all(n == cfg.nlayers * steps for n in fa.LAUNCHES.values())
    return losses, norms, params, state, lambda p, s: step(p, s, batch)


@pytest.fixture(scope="module")
def plain(nccl1):
    return _run("plain", STEPS + 1)


def test_zero_step1_bit_identical_then_close(plain):
    losses, _, params, state, _ = _run("zero")
    assert losses[0] == plain[0][0]
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, plain[0]))
    assert gap < ZERO_TOL and losses[-1] < losses[0]
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(params))
    assert all(m.dtype == torch.float32
               for m in tree_leaves(state["master"]))


def test_zero_clip_chain(plain):
    losses, norms, params, state, _ = _run(
        "zero", opt=chain(clip_by_global_norm_parallel(1.0), adamw(1e-3)))
    assert abs(norms[0] - plain[1][0]) <= 1e-3 * plain[1][0]
    assert norms[0] > 1.0  # the clip bites
    post = float(global_grad_norm([m.grad for m in tree_leaves(
        state["master"])]))
    assert post <= 1.0 + 1e-5


@pytest.mark.parametrize("kind", ["fsdp", "fsdp_overlap"])
def test_fsdp_bit_identical_to_make_train_step(nccl1, kind):
    base = _run("plain")
    losses, _, shards, _, _ = _run(kind)
    assert losses == base[0]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(shards),
                                                  tree_leaves(base[2])))


def test_prefetch_on_and_off_bit_identical(nccl1):
    cfg = _cfg()
    group = nccl1.get_group("data")
    params = _params(cfg)
    _, dims = stacked_fsdp_specs(params["blocks"], 1)
    with torch.no_grad():
        x0 = gpt_embed(params, _batch(cfg)["tokens"])

    def apply_fn(lp, h, i):
        return checkpoint_block(lambda hh: block_forward(lp, hh, cfg.block),
                                "flash")(h)

    outs = []
    for prefetch in (True, False):
        leaves = [p.detach().clone().requires_grad_()
                  for p in tree_leaves(params["blocks"])]
        stack = _unflatten_like(params["blocks"], iter(leaves))
        x = x0.clone().requires_grad_()
        y = prefetched_layer_scan(stack, x, apply_fn, group, dims,
                                  prefetch=prefetch)
        outs.append([y.detach()] + list(torch.autograd.grad(
            y.float().pow(2).mean(), leaves + [x])))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_offload_round_trip_keeps_the_optimizer(nccl1):
    """After 2 FSDP steps: the shards and the AdamW state to pinned host
    memory and back, in place (the optimizer holds the same tensor
    objects), the card's bytes lower by theirs meanwhile; step 3 equals
    a run that never offloaded."""
    base = _run("plain")
    _, _, shards, state, step = _run("fsdp", steps=2)
    ids = [id(p) for g in state.param_groups for p in g["params"]]
    moved = {"params": shards, "opt": state}
    nbytes = tree_bytes(shards) + sum(
        tree_bytes([v for v in st.values() if v.dim() > 0])
        for st in state.state.values())
    torch.cuda.synchronize()
    before = memory_report()["cuda:0"]["bytes_in_use"]
    offload_to_host(moved)
    torch.cuda.synchronize()
    assert before - memory_report()["cuda:0"]["bytes_in_use"] >= nbytes
    assert all(p.device.type == "cpu" and p.is_pinned()
               for p in tree_leaves(shards))
    assert all(v.device.type == "cpu" for st in state.state.values()
               for v in st.values() if v.dim() > 0)
    reload_to_device(moved)
    assert [id(p) for g in state.param_groups for p in g["params"]] == ids
    assert all(p.is_cuda for p in tree_leaves(shards))
    shards, state, loss, _ = step(shards, state)
    assert float(loss) == base[0][2]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(shards),
                                                  tree_leaves(base[2])))


def test_sharded_ema_exact(nccl1):
    ema = ShardedEMA(0.99)
    box = {}
    d = torch.tensor(0.99, dtype=torch.float32)

    def update(params):
        if not box:
            box["state"] = ema.init(params)
            box["dense"] = [p.detach().float().clone()
                            for p in tree_leaves(params)]
        ema.update(box["state"], params)
        with torch.no_grad():
            box["dense"] = [e * d + p.float() * (1.0 - d) for e, p in
                            zip(box["dense"], tree_leaves(params))]

    _run("zero", ema=update)
    assert ema.verify_with_gt(box["state"], box["dense"], atol=0.0)
    off = [t + 1e-3 for t in box["dense"]]
    assert not ema.verify_with_gt(box["state"], off, atol=0.0)
