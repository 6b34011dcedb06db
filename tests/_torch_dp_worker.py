"""One rank of the port's data-parallel runs on the CPU, for
tests/test_torch_dp.py — not a pytest file.

The parent writes the inputs (numpy arrays, made with JAX) to an
``.npz``, starts ``world`` copies of this script, one a rank, and reads
each rank's ``rank<r>.npz`` back.  Every copy joins a gloo process group
through a ``file://`` rendezvous and runs:

- ``dp/<case>``: ``DataParallel.make_train_step`` over ``tpc``'s
  ``data`` axis, three AdamW steps of the tiny GPT on this rank's rows
  of three global batches, per case (accumulation, reduce op, override,
  bucket size); saves the losses, the parameters after the
  third step and the overlap counts;
- ``grads/<case>``: ``reduce_gradients`` of one batch's grads on this
  rank's rows, 'mean', 'sum' and an override to ``()``;
- ``moe_dp``: ``reduce_gradients`` with the MoE-DP override on the
  ``moe`` view (``moe_ep`` 2), on the grads of the reference's toy loss;
- ``broadcast``: parameters drawn apart on each rank, then
  ``broadcast_params``;
- ``dropout``: ``scan_blocks`` with dropout keyed by
  ``axis_unique_key(7, 'data')`` on a ``data`` x ``tensor`` layout, the
  same tokens on every rank; ``test_comm`` over that layout.

Imports only the port (and numpy): never JAX.  Run as
``python tests/_torch_dp_worker.py RANK WORLD INIT_METHOD IN_NPZ OUT_DIR``.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

#: the tiny GPT of the parity cases (f32, plain attention)
GPT = dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=16)
GLOBAL_BATCH, STEPS, LR = 8, 3, 1e-3
SMALL_BUCKET_MB = 0.01  # ~10 KB: a dozen buckets for the tiny GPT
#: case -> (grad_accum_iters, accum_reduce, reduce_op, overrides,
#: bucket_cap_mb)
DP_CASES = {
    "accum1": (1, "final", "mean", None, SMALL_BUCKET_MB),
    "accum1_microbatch": (1, "microbatch", "mean", None, SMALL_BUCKET_MB),
    "accum2_final": (2, "final", "mean", None, SMALL_BUCKET_MB),
    "accum2_microbatch": (2, "microbatch", "mean", None, SMALL_BUCKET_MB),
    "sum": (1, "final", "sum", None, SMALL_BUCKET_MB),
    "override_none": (1, "final", "mean", {"head": ()}, SMALL_BUCKET_MB),
    "one_bucket": (1, "final", "mean", None, 25),
}
#: reduce_gradients cases on one batch's grads: (reduce_op, overrides)
GRAD_CASES = {"mean": ("mean", None), "sum": ("sum", None),
              "override_none": ("mean", {"head": ()})}
DROPOUT_RATE = 0.5


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v.detach().numpy() if torch.is_tensor(v) else v
    return out


def unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def config(**kw):
    from torchdistpackage_tpu_torch.models import GPTConfig

    return GPTConfig(**GPT, dtype=torch.float32, attn_impl="naive", **kw)


def dp_runs(inp):
    from torchdistpackage_tpu_torch.models import gpt_loss, params_from_jax
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        DataParallel,
        adamw,
        reduce_gradients,
    )

    cfg = config()
    tree = unflatten({k[len("params/"):]: inp[k] for k in inp.files
                      if k.startswith("params/")})
    batches = [{"tokens": inp[f"batch{i}/tokens"],
                "targets": inp[f"batch{i}/targets"]} for i in range(STEPS)]
    out = {}
    for case, (M, acc, op, over, cap) in DP_CASES.items():
        dp = DataParallel(reduce_op=op, grad_reduce_overrides=over,
                          bucket_cap_mb=cap)
        params = dp.broadcast_params(params_from_jax(tree, cfg, device="cpu"))
        opt = adamw(LR)
        state = opt.init(params)
        step = dp.make_train_step(lambda p, b: gpt_loss(p, b, cfg), opt,
                                  grad_accum_iters=M, accum_reduce=acc)
        losses = []
        for b in batches:
            params, state, loss, _ = step(params, state,
                                          dp.shard_batch(b, device="cpu"))
            losses.append(float(loss))
        out[f"dp/{case}/losses"] = np.asarray(losses)
        out.update({f"dp/{case}/params/{k}": v
                    for k, v in flatten(params).items()})
        out.update({f"dp/{case}/stats/{k}": np.asarray(v)
                    for k, v in dp.last_stats.items()})
    dp = DataParallel()
    local = {k: v.long() for k, v in dp.shard_batch(batches[0],
                                                    device="cpu").items()}
    out["shard/tokens"] = local["tokens"].numpy()
    params = params_from_jax(tree, cfg, device="cpu")
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    g = torch.autograd.grad(gpt_loss(params, local, cfg),
                            list(tree_leaves(params)))
    grads = unflatten(dict(zip(flatten(params), g)))
    for case, (op, over) in GRAD_CASES.items():
        red = reduce_gradients(grads, reduce_op=op,
                               grad_reduce_overrides=over)
        out.update({f"grads/{case}/{k}": v
                    for k, v in flatten(red).items()})
    return out


def moe_dp_run(rank):
    """The reference's MoE-DP override case (tests/test_data_parallel.py)
    at world 4: shared grads average over the whole data group, expert
    grads sum over ``moe_dp`` and divide by the full data size."""
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        reduce_gradients,
    )

    tpc.build_moe_mesh(moe_ep_size=2)
    x = torch.arange(4.0)[rank]  # rank (dp, ep) holds x[dp * 2 + ep]
    params = {"shared": torch.ones(4, requires_grad=True),
              "expert": torch.ones(4, requires_grad=True)}
    loss = x * (params["shared"].sum() + params["expert"].sum())
    g = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    red = reduce_gradients(g, axis=("moe_dp", "moe_ep"),
                           grad_reduce_overrides={"expert": ("moe_dp",)})
    return {f"moe_dp/{k}": v.numpy() for k, v in red.items()}


def broadcast_run(rank):
    from torchdistpackage_tpu_torch.models import init_gpt_params
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )

    params = init_gpt_params(config(), torch.Generator().manual_seed(
        100 + rank), device="cpu")
    out = {f"broadcast/before/{k}": v.copy()
           for k, v in flatten(params).items()}
    DataParallel().broadcast_params(params)
    out.update({f"broadcast/after/{k}": v for k, v in
                flatten(params).items()})
    return out


def dropout_run(inp):
    """Same tokens on every rank of a data 2 x tensor 2 layout: only the
    dropout masks can make the block stack's outputs differ."""
    from torchdistpackage_tpu_torch.dist import topology, tpc
    from torchdistpackage_tpu_torch.models import gpt_embed, params_from_jax
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        scan_blocks,
    )
    from torchdistpackage_tpu_torch.utils import axis_unique_key

    tpc.reset()
    tpc.setup_process_groups([("data", 2), ("tensor", 2)])
    comm = topology.test_comm()
    cfg = config(dropout_rate=DROPOUT_RATE)
    tree = unflatten({k[len("params/"):]: inp[k] for k in inp.files
                      if k.startswith("params/")})
    params = params_from_jax(tree, cfg, device="cpu")
    tokens = torch.from_numpy(inp["batch0/tokens"][:2]).long()
    key = axis_unique_key(7, "data")
    h = scan_blocks(params["blocks"], gpt_embed(params, tokens), cfg.block,
                    dropout_key=key)
    return {"dropout/h": h.detach().numpy(),
            "dropout/comm": np.asarray(sorted(k for k, v in comm.items()
                                              if v))}


def main(rank, world, init_method, in_npz, out_dir):
    from torchdistpackage_tpu_torch.dist import init_distributed, tpc

    torch.set_num_threads(1)
    init_distributed(init_method, world, rank, "cpu")
    import torch.distributed as dist

    try:
        inp = np.load(in_npz)
        tpc.setup_process_groups([("data", world)])
        out = dp_runs(inp)
        out.update(broadcast_run(rank))
        out.update(moe_dp_run(rank))
        out.update(dropout_run(inp))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        tpc.reset()
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, init, src, dst = sys.argv[1:6]
    main(int(r), int(w), init, src, dst)
