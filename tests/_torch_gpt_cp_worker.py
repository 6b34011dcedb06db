"""One rank of the port's GPT under context parallelism on the CPU, for
tests/test_torch_gpt_cp.py — not a pytest file.

The parent writes the inputs (numpy, from a seed) to an ``.npz`` and
starts 4 copies of this script; each joins a gloo group through a
``file://`` rendezvous (a 120 s timeout), runs every layout below in
order and writes ``rank<r>.npz``:

- ``context 4``: ``gpt_loss(cp_group=)`` on the rank's sequence chunk,
  its loss and grads (the parent averages them over the ranks, JAX's
  ``pmean``) for the cases of JAX ``tests/test_gpt.py:476`` (ring,
  Ulysses, ring with ``xent_chunk``), :347 (ring under remat
  ``'flash'``), :1148 (rope, contiguous and zigzag) and the zigzag GPT
  with learned positions; and one planted fault: zigzag attention on
  contiguously sharded tokens.
- ``data 2 x context 2``: ``DataParallel(axis=('data', 'context'))``
  (JAX :519) and ``ZeroOptimizer(shard_axis='data',
  grad_reduce_axes=('data', 'context'))`` (JAX ``tests/test_zero.py:338``);
  ``grad_reduce_axes=('data',)`` must raise at the first step (the loss
  differs across the context group),
  2 AdamW steps each; the GPT-MoE under ring CP (JAX
  ``tests/test_moe.py:971``: capacity 4.0, aux 0), its loss and grads.
- ``pipe 2 x context 2`` (data 1): ``gpt_pipeline_1f1b(cp_group=)`` as
  ``DataParallel``'s ``value_and_grad_fn`` (JAX :573), 2 AdamW steps;
  ``balanced_stage_stack`` with ring blocks (JAX
  ``tests/test_pipeline.py:839``), the stage's grads.

Imports only the port (and numpy): never JAX.  Run as
``python tests/_torch_gpt_cp_worker.py RANK WORLD INIT_METHOD IN_NPZ
OUT_DIR``.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from _torch_moe_train_worker import (  # noqa: E402
    host,
    subtree,
    tensors,
    trainable,
)
from _torch_ring_attention_worker import ring_module  # noqa: E402

WORLD = 4
#: JAX tests/test_gpt.py:41's GPT and batch
GPT = dict(vocab_size=64, dim=32, nheads=4, nlayers=4, max_seq=16,
           ffn_mult=2)
B, S = 4, 16
#: the GPT-MoE of JAX tests/test_moe.py:971 (aux off: the serial golden)
MOE = dict(GPT, nlayers=2, moe_experts=4, moe_top_k=2, moe_every=2,
           moe_capacity_factor=4.0, moe_aux_weight=0.0)
#: the block stack of JAX tests/test_pipeline.py:839 and its weights
BLK = dict(dim=32, nheads=4, nlayers=4, ffn_mult=2, causal=True)
BSS_WEIGHTS = (3.0, 1.0, 1.0, 1.0)
M, MBS, LR, STEPS = 4, 2, 1e-2, 2
#: name -> (GPTConfig overrides, xent_chunk, remat, zigzag-permuted data)
LOSS_CASES = {
    "ring": (dict(attn_impl="ring"), None, False, False),
    "ulysses": (dict(attn_impl="ulysses"), None, False, False),
    "ring_xent2": (dict(attn_impl="ring"), 2, False, False),
    "ring_remat_flash": (dict(attn_impl="ring"), None, "flash", False),
    "rope_contiguous": (dict(attn_impl="ring", pos="rope"), None, False,
                        False),
    "rope_zigzag": (dict(attn_impl="ring", pos="rope", cp_layout="zigzag"),
                    None, False, True),
    "zigzag": (dict(attn_impl="ring", cp_layout="zigzag"), None, False,
               True),
    # planted fault: the zigzag model fed contiguous chunks
    "fault_zigzag_contiguous": (dict(attn_impl="ring", cp_layout="zigzag"),
                                None, False, False),
}


def layout(config):
    from torchdistpackage_tpu_torch.dist import tpc

    tpc.reset()
    tpc.setup_process_groups(config)
    return tpc


def gcfg(base=GPT, **kw):
    from torchdistpackage_tpu_torch.models import GPTConfig

    return GPTConfig(**dict(base, **kw))


def chunk(batch, c, n, dim=-1):
    """The c-th of n sequence chunks of every leaf."""
    def cut(t):
        s = t.shape[dim] // n
        return t.narrow(dim % t.dim(), c * s, s)
    return {k: cut(v) for k, v in batch.items()}


def local_grads(loss, params):
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves

    leaves = list(tree_leaves(params))
    for p, g in zip(leaves, torch.autograd.grad(loss, leaves)):
        p.grad = g
    return params


def loss_runs(inp):
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.models import gpt_loss, params_from_jax

    tpc = layout([("context", WORLD)])
    cp = tpc.get_group("context")
    c = dist.get_rank(cp)
    ra = ring_module()
    out = {}
    for name, (kw, xent, remat, zig) in LOSS_CASES.items():
        cfg = gcfg(**kw)
        src = "rope" if cfg.pos == "rope" else "gpt"
        params = trainable(params_from_jax(subtree(inp, f"{src}/params/"),
                                           cfg, device="cpu"))
        batch = tensors(subtree(inp, "batch/"))
        if zig:
            batch = {k: ra.zigzag_permute(v, WORLD, 1)
                     for k, v in batch.items()}
        loss = gpt_loss(params, chunk(batch, c, WORLD), cfg, remat=remat,
                        xent_chunk=xent, cp_group=cp)
        out[f"{name}/loss"] = loss.detach().numpy()
        out.update(host(local_grads(loss, params), f"{name}/grads/",
                        grads=True))
    return out


def dpcp_runs(inp):
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.models import (
        gpt_loss,
        gpt_moe_loss,
        params_from_jax,
    )
    from torchdistpackage_tpu_torch.parallel import (
        DataParallel,
        ZeroOptimizer,
        adamw,
    )
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        normalize_model_axis_grads,
    )

    tpc = layout([("data", 2), ("context", 2)])
    cp = tpc.get_group("context")
    d, c = dist.get_rank(tpc.get_group("data")), dist.get_rank(cp)
    cfg = gcfg(attn_impl="ring")
    out = {}

    def batch(i):
        rows = {k: v[d * 2:(d + 1) * 2] for k, v in tensors(
            subtree(inp, f"train{i}/")).items()}
        return chunk(rows, c, 2)

    def loss_fn(p, b):
        return gpt_loss(p, b, cfg, cp_group=cp)

    dp = DataParallel(axis=("data", "context"))
    params = trainable(params_from_jax(subtree(inp, "gpt/params/"), cfg,
                                       device="cpu"))
    opt = adamw(LR)
    state = opt.init(params)
    step = dp.make_train_step(loss_fn, opt)
    losses = []
    for i in range(STEPS):
        params, state, loss, _ = step(params, state, batch(i))
        losses.append(float(loss))
    out["dpcp/losses"] = np.asarray(losses)
    out.update(host(params, "dpcp/params/"))

    zero = ZeroOptimizer(adamw(LR), shard_axis="data",
                         grad_reduce_axes=("data", "context"))
    params = zero.place_params(trainable(params_from_jax(
        subtree(inp, "gpt/params/"), cfg, device="cpu")))
    state = zero.init(params)
    step = zero.make_train_step(loss_fn)
    losses = []
    for i in range(STEPS):
        params, state, loss, _ = step(params, state, batch(i))
        losses.append(float(loss))
    out["zerocp/losses"] = np.asarray(losses)
    out.update(host(params, "zerocp/params/"))

    # 'context' left out of the reduced axes: a GPT loss (each rank's mean
    # over its own tokens) differs across the context group, so the first
    # step raises; a loss that is the same there is accepted
    zero = ZeroOptimizer(adamw(LR), shard_axis="data",
                         grad_reduce_axes=("data",))
    params = zero.place_params(trainable(params_from_jax(
        subtree(inp, "gpt/params/"), cfg, device="cpu")))
    step = zero.make_train_step(loss_fn)
    try:
        step(params, zero.init(params), batch(0))
        out["zero_model_cp/raised"] = np.asarray("")
    except ValueError as e:
        out["zero_model_cp/raised"] = np.asarray(str(e))
    normalize_model_axis_grads(torch.tensor(2.5), None, tpc, ("data",))
    out["zero_model_cp/same_loss_ok"] = np.asarray(1)

    mcfg = gcfg(MOE, attn_impl="ring")
    params = trainable(params_from_jax(subtree(inp, "moe/params/"), mcfg,
                                       device="cpu"))
    loss = gpt_moe_loss(params, batch(0), mcfg, cp_group=cp)
    out["moecp/loss"] = loss.detach().numpy()
    out.update(host(local_grads(loss, params), "moecp/grads/", grads=True))
    return out


def ppcp_runs(inp):
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.models import (
        gpt_param_specs,
        gpt_pipeline_1f1b,
        params_from_jax,
    )
    from torchdistpackage_tpu_torch.parallel import DataParallel, adamw
    from torchdistpackage_tpu_torch.parallel.pipeline_parallel import (
        balanced_stage_stack,
        pipeline_1f1b,
        stacked_param_specs,
        stage_index,
    )
    from torchdistpackage_tpu_torch.parallel.tensor_parallel.layers import (
        TransformerConfig,
        scan_blocks,
    )

    tpc = layout([("data", 1), ("pipe", 2), ("context", 2)])
    cp = tpc.get_group("context")
    c, s = dist.get_rank(cp), stage_index()
    cfg = gcfg(attn_impl="ring")
    params = trainable(params_from_jax(subtree(inp, "gpt/params/"), cfg,
                                       device="cpu", pp_rank=s, pp_size=2))
    dp = DataParallel(axis=("data", "context"))
    opt = adamw(LR)
    state = opt.init(params)
    step = dp.make_train_step(
        value_and_grad_fn=lambda p, b: gpt_pipeline_1f1b(
            p, b, cfg, M, cp_group=cp),
        optimizer=opt, pipe_specs=gpt_param_specs(params, pipe_axis="pipe"))
    losses = []
    for i in range(STEPS):
        b = chunk(tensors(subtree(inp, f"pipe{i}/")), c, 2)
        params, state, loss, _ = step(params, state, b)
        losses.append(float(loss))
    out = {"ppcp/losses": np.asarray(losses)}
    out.update(host(params, "ppcp/params/"))

    bcfg = TransformerConfig(**BLK, attn_impl="ring")
    layers = tensors(subtree(inp, "blk/layers/"))
    stacked, mask, bounds = balanced_stage_stack(layers, BSS_WEIGHTS, 2)
    slab = trainable(_slab(stacked, s, mask.shape[1]))
    x, y = (chunk({"t": tensors(inp[f"blk/{k}"])}, c, 2, dim=2)["t"]
            for k in "xy")
    loss, grads = pipeline_1f1b(
        slab, x, y, first_fn=lambda p, mb: mb,
        stage_fn=lambda p, h: scan_blocks(p, h, bcfg, layer_mask=mask[s],
                                          cp_group=cp),
        last_fn=lambda p, o, t: torch.mean((o - t) ** 2),
        num_microbatches=M, param_specs=stacked_param_specs(slab))
    out["bss/loss"] = loss.detach().numpy()
    out["bss/bounds"] = np.asarray(bounds)
    out["stage"] = np.asarray(s)
    out.update(host(grads, "bss/grads/"))
    return out


def _slab(stacked, s, n):
    if isinstance(stacked, dict):
        return {k: _slab(v, s, n) for k, v in stacked.items()}
    return stacked[s * n:(s + 1) * n].clone()


def main(rank, world, init_method, in_npz, out_dir):
    import datetime

    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import tpc

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        inp = np.load(in_npz)
        out = loss_runs(inp)
        out.update(dpcp_runs(inp))
        out.update(ppcp_runs(inp))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        tpc.reset()
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, init, src, dst = sys.argv[1:6]
    main(int(r), int(w), init, src, dst)
