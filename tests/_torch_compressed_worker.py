"""One rank of the port's compressed collectives on the CPU, for
tests/test_torch_compressed.py — not a pytest file.

The parent writes the inputs (numpy, from seeds) to an ``.npz`` and
starts 4 copies of this script, one a rank; each joins a gloo group
through a ``file://`` rendezvous (a 120 s timeout, so a rank that
enters a different collective fails instead of hanging), runs every job
of :data:`JOBS` in order and writes ``rank<r>.npz``:

- ``rings``: the four rings and the two ring backwards on this rank's
  own inputs, over the world (n 4), over the pairs {0, 1} / {2, 3}
  (n 2) and over a group of this rank alone (n 1); the ragged mean;
- ``dp``: ``DataParallel`` on the MLP, SGD, exact / ``'int8'`` /
  ``'int8'`` under microbatch accumulation / ``'auto'`` (an explicit
  ``CommModel``), and the overlap regimes ``'none'`` and ``'generic'``;
- ``zero``: ``ZeroOptimizer`` exact / ``'int8'`` / ``'int8_ef'`` /
  ``'auto'`` (the int8 re-gather, ``'follow'``) and ``'int8'`` under
  microbatch accumulation;
- ``fsdp``: ``gather_params(compress='int8')`` and its backward, the
  overlap step exact and ``'int8'``;
- ``tp``: a data 2 x tensor 2 layout, ``transformer_forward`` at
  ``sp=True`` with and without ``ag_compress='int8'`` (dense and GQA):
  output, loss and the whole grads;
- ``bench``: ``comm_bench.test_collection`` over the world, exact and
  int8 arms.

Imports only the port (and numpy): never JAX.  Run as
``python tests/_torch_compressed_worker.py RANK WORLD INIT_METHOD
IN_NPZ OUT_DIR``.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

WORLD = 4
#: the ring cases: name -> shape of each rank's input
RING_SHAPES = {"a": (16, 12), "b": (6, 64)}
#: (case, op, dim) of the rings; op 'pmean', 'rs', 'ag', 'psum_ag'
RING_CASES = [("a", "pmean", 0), ("b", "pmean", 0), ("a", "rs", 0),
              ("a", "rs", 1), ("b", "rs", 1), ("a", "ag", 0),
              ("a", "ag", 1), ("b", "ag", 1), ("a", "psum_ag", 0),
              ("b", "psum_ag", 1)]
RAGGED = (7,)
MLP = dict(din=16, dh=32, dout=4)
ROWS = 64       # the global batch (each rank 16 rows)
LR = 1e-2       # JAX's tests: optax.sgd(1e-2)
DP_STEPS, ZERO_STEPS = 4, 5
#: 'auto''s explicit model: alpha 1e-6 s, beta 1e9 B/s on every axis
LINK = dict(alpha_s=1e-6, beta_Bps=1e9)
AUTO_MIN = 100
#: JAX's TP golden (tests/test_compression.py:350)
TF = dict(dim=32, nheads=4, nlayers=1, ffn_mult=2)
TF_X = (2, 16, 32)
BENCH_BYTES = (1 << 12, 1 << 16)
BENCH_OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
             "ppermute", "int8_all_reduce", "int8_reduce_scatter",
             "int8_all_gather")


def sgd(lr):
    """``optax.sgd(lr)`` as a train-step handle (the port's steps take
    ``adamw()``'s ``init(params) -> torch optimizer``)."""
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
    from torchdistpackage_tpu_torch.parallel.data_parallel import AdamW

    class SGD(AdamW):
        def init(self, params):
            leaves = list(tree_leaves(params))
            for p in leaves:
                p.requires_grad_(True)
            return torch.optim.SGD(leaves, lr=self.lr)
    return SGD(lr)


def mlp_loss(params, batch):
    h = torch.tanh(batch["x"] @ params["w1"] + params["b1"])
    return torch.mean((h @ params["w2"] + params["b2"] - batch["y"]) ** 2)


def t(a):
    return torch.from_numpy(np.array(a))


def mlp_params(inp):
    return {k: t(inp[f"mlp/{k}"]) for k in ("w1", "b1", "w2", "b2")}


def local_batch(inp, rank, world):
    n = ROWS // world
    return {k: t(inp[f"batch/{k}"][rank * n:(rank + 1) * n])
            for k in ("x", "y")}


def int8_calls():
    """The int8 rings' collectives made so far (hops, gathers)."""
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        COLLECTIVES,
    )

    return COLLECTIVES["int8_hop"] + COLLECTIVES["int8_gather"]


def flat(tree, prefix):
    from torchdistpackage_tpu_torch.utils.partition import named_leaves

    return {prefix + n: v.detach().numpy() for n, v in named_leaves(tree)}


# ----------------------------------------------------------------- rings


def rings_job(inp, rank, world):
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import compressed as C

    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    singles = [dist.new_group([r]) for r in range(world)]
    groups = {4: dist.group.WORLD, 2: pairs[rank // 2], 1: singles[rank]}
    out = {}
    for n, group in groups.items():
        for case, op, dim in RING_CASES:
            x = t(inp[f"ring/{case}"][rank])
            key = f"ring/{n}/{case}/{op}/{dim}"
            if op == "pmean":
                out[key] = C.int8_ring_pmean(x, group).numpy()
            elif op == "psum_ag":
                out[key] = C.int8_psum_all_gather(x, group, dim).numpy()
            elif op == "rs":
                if x.shape[dim] % n:
                    continue
                x.requires_grad_(True)
                y = C.int8_ring_reduce_scatter(x, group, dim)
                ct = t(inp[f"ct_rs/{n}/{case}/{dim}"][rank])
                (g,) = torch.autograd.grad(y, x, ct)
                out[key], out[key + "/vjp"] = y.detach().numpy(), g.numpy()
            else:
                x.requires_grad_(True)
                y = C.int8_ring_all_gather(x, group, dim)
                ct = t(inp[f"ct_ag/{n}/{case}/{dim}"][rank])
                (g,) = torch.autograd.grad(y, x, ct)
                out[key], out[key + "/vjp"] = y.detach().numpy(), g.numpy()
        x = t(inp["ring/ragged"][rank])
        out[f"ring/{n}/ragged"] = C.int8_ring_pmean(x, group).numpy()
    return out


# -------------------------------------------------------------------- DP


def dp_job(inp, rank, world):
    from torchdistpackage_tpu_torch.dist import overlap, tpc
    from torchdistpackage_tpu_torch.obs.comm_model import AxisCost, CommModel
    from torchdistpackage_tpu_torch.obs.events import default_event_log
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )

    tpc.setup_process_groups([("data", world)])
    link = AxisCost(kind="table", **LINK)
    model = CommModel({"data": link}, default=link,
                      compressed_axis_costs={"data": link})
    arms = {"exact": dict(kw={}),
            "int8": dict(kw=dict(grad_compress="int8", compress_min_size=0)),
            "int8_micro": dict(kw=dict(grad_compress="int8",
                                       compress_min_size=0), M=2,
                               acc="microbatch"),
            "exact_micro": dict(kw={}, M=2, acc="microbatch"),
            "auto": dict(kw=dict(grad_compress="auto", comm_model=model,
                                 compress_min_size=AUTO_MIN))}
    out = {}
    batch = local_batch(inp, rank, world)
    log = default_event_log()
    for name, arm in arms.items():
        before, calls = len(log.events), int8_calls()
        dp = DataParallel(**arm["kw"])
        p = mlp_params(inp)
        opt = sgd(LR)
        state = opt.init(p)
        step = dp.make_train_step(mlp_loss, opt,
                                  grad_accum_iters=arm.get("M", 1),
                                  accum_reduce=arm.get("acc", "final"))
        losses = []
        for _ in range(DP_STEPS):
            p, state, loss, _ = step(p, state, batch)
            losses.append(float(loss))
        out[f"dp/{name}/losses"] = np.asarray(losses)
        out[f"dp/{name}/int8_calls"] = np.asarray(int8_calls() - calls)
        out.update(flat(p, f"dp/{name}/params/"))
        if name == "auto":
            ev = [e for e in list(log.events)[before:]
                  if e["kind"] == "compress_policy"]
            out["dp/auto/events"] = np.asarray(len(ev))
            for r in ev[0]["leaves"]:
                out[f"dp/auto/compress/{r['leaf']}"] = np.asarray(
                    r["compress"])
    # the overlap regimes: the same grads bit for bit
    for preset in ("none", "generic"):
        overlap.configure(preset)
        dp = DataParallel(bucket_cap_mb=0.001)  # several buckets
        p = mlp_params(inp)
        opt = sgd(LR)
        state = opt.init(p)
        step = dp.make_train_step(mlp_loss, opt)
        for _ in range(2):
            p, state, _, _ = step(p, state, batch)
        out.update(flat({k: v.grad for k, v in p.items()},
                        f"dp/overlap/{preset}/grads/"))
        out[f"dp/overlap/{preset}/buckets"] = np.asarray(
            dp.last_stats["buckets"])
    out["dp/overlap/events"] = np.asarray(sum(
        1 for e in log.events if e["kind"] == "overlap_configure"))
    overlap._ACTIVE = None
    tpc.reset()
    return out


# ------------------------------------------------------------------ ZeRO


def zero_job(inp, rank, world):
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.obs.events import default_event_log
    from torchdistpackage_tpu_torch.parallel.zero import ZeroOptimizer

    tpc.setup_process_groups([("data", world)])
    arms = {"exact": dict(), "int8": dict(grad_compress="int8"),
            "int8_ef": dict(grad_compress="int8_ef"),
            "auto": dict(grad_compress="auto"),
            "int8_micro": dict(grad_compress="int8")}
    out = {}
    batch = local_batch(inp, rank, world)
    log = default_event_log()
    for name, kw in arms.items():
        before, calls = len(log.events), int8_calls()
        zero = ZeroOptimizer(sgd(LR), compress_min_size=0, **kw)
        p = zero.place_params(mlp_params(inp))
        state = zero.init(p)
        micro = name.endswith("micro")
        step = zero.make_train_step(
            mlp_loss, grad_accum_iters=2 if micro else 1,
            accum_reduce="microbatch" if micro else "final")
        losses = []
        for _ in range(ZERO_STEPS):
            p, state, loss, _ = step(p, state, batch)
            losses.append(float(loss))
        out[f"zero/{name}/losses"] = np.asarray(losses)
        out[f"zero/{name}/int8_calls"] = np.asarray(int8_calls() - calls)
        out.update(flat(p, f"zero/{name}/params/"))
        if name == "int8_ef":
            out.update(flat(state["ef"], "zero/int8_ef/ef/"))
        if name == "auto":
            ev = [e for e in list(log.events)[before:]
                  if e["kind"] == "compress_policy"]
            out["zero/auto/events"] = np.asarray(len(ev))
            out["zero/auto/family"] = np.asarray(ev[0]["family"])
            for r in ev[0]["leaves"]:
                out[f"zero/auto/compress/{r['leaf']}"] = np.asarray(
                    r["compress"])
    try:
        ZeroOptimizer(sgd(LR), grad_compress="int8_ef").make_train_step(
            mlp_loss, grad_accum_iters=2, accum_reduce="microbatch")
        out["zero/ef_micro_refused"] = np.asarray(False)
    except ValueError as e:
        out["zero/ef_micro_refused"] = np.asarray(
            "int8_ef" in str(e) and "microbatch" in str(e))
    # expert (override) leaves never compress (JAX
    # tests/test_compression.py:685)
    moe = {"experts": {"w1": torch.zeros(8, 64, 64)},
           "dense": {"w": torch.zeros(64, 64)}}
    for mode in ("int8", "int8_ef", "auto"):
        zero = ZeroOptimizer(sgd(LR), grad_compress=mode,
                             compress_min_size=0,
                             grad_reduce_overrides={"experts": ("data",)})
        policy, _ = zero._compress_decisions(moe, zero.shard_dims(moe))
        for leaf, flag in policy.items():
            out[f"zero/override/{mode}/{leaf}"] = np.asarray(flag)
    tpc.reset()
    return out


# ------------------------------------------------------------------ FSDP


def fsdp_job(inp, rank, world):
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.parallel.fsdp import FSDP, gather_params

    tpc.setup_process_groups([("data", world)])
    out = {}
    f = FSDP()
    shards = f.shard_params(mlp_params(inp))
    dims = f.shard_dims_of(shards)
    leaves = {k: v.clone().requires_grad_(True) for k, v in shards.items()}
    full = gather_params(leaves, dims, compress="int8", compress_min_size=0)
    cts = {k: t(inp[f"fsdp/ct/{k}"][rank]) for k in full}
    grads = torch.autograd.grad([full[k] for k in full], [leaves[k]
                                                          for k in full],
                                [cts[k] for k in full])
    out.update({f"fsdp/gather/{k}": v.detach().numpy()
                for k, v in full.items()})
    out.update({f"fsdp/vjp/{k}": g.numpy() for k, g in zip(full, grads)})
    out.update({f"fsdp/dims/{k}": np.asarray(v) for k, v in dims.items()})
    batch = local_batch(inp, rank, world)
    for name, gc in (("exact", None), ("int8", "int8")):
        f = FSDP()
        shards = f.shard_params(mlp_params(inp))
        opt = sgd(LR)
        state = opt.init(shards)
        step = f.make_overlap_train_step(mlp_loss, opt, grad_compress=gc,
                                         compress_min_size=0)
        losses, calls = [], int8_calls()
        for _ in range(DP_STEPS):
            shards, state, loss, _ = step(shards, state, batch)
            losses.append(float(loss))
        out[f"fsdp/{name}/losses"] = np.asarray(losses)
        out[f"fsdp/{name}/int8_calls"] = np.asarray(int8_calls() - calls)
    tpc.reset()
    return out


# -------------------------------------------------------------- TP + SP


def tp_job(inp, rank, world):
    import dataclasses

    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        PARTIAL_UNDER_SP,
        TransformerConfig,
        gather_params,
        param_specs,
        shard_params,
        transformer_forward,
    )
    from torchdistpackage_tpu_torch.parallel.tensor_parallel.layers import (
        spec_pairs,
    )
    from torchdistpackage_tpu_torch.utils.partition import named_leaves

    tpc.setup_process_groups([("data", 2), ("tensor", 2)])
    group = tpc.get_group("tensor")
    n, r = dist.get_world_size(group), dist.get_rank(group)
    out = {}
    for family, kv in (("dense", None), ("gqa", 2)):
        tree = _tensors(_subtree(inp, f"tf/{family}/params/"))
        specs = param_specs(tree)
        x = t(inp["tf/x"])
        for arm in ("exact", "int8"):
            cfg = TransformerConfig(**TF, kv_heads=kv)
            if arm == "int8":
                cfg = dataclasses.replace(cfg, ag_compress="int8",
                                          compress_min_bytes=0)
            shard = _like(tree, iter(
                p.detach().clone().requires_grad_(True) for _, p in
                named_leaves(shard_params(tree, specs, r, n))))
            leaves = [p for _, p in named_leaves(shard)]
            y = transformer_forward(shard, x, cfg, tp_group=group, sp=True)
            loss = torch.mean(y ** 2)
            # the output is gathered whole on each rank: one cotangent
            # between them (the gather's backward sums the ranks')
            grads = torch.autograd.grad(loss / n, leaves)
            gtree = _like(shard, iter(grads))
            for (_, s), (name, g) in zip(spec_pairs(shard, specs),
                                         named_leaves(gtree)):
                if s == PARTIAL_UNDER_SP:
                    dist.all_reduce(g, group=group)
            whole = gather_params(gtree, specs, group)
            key = f"tf/{family}/{arm}"
            out[f"{key}/out"] = y.detach().numpy()
            out[f"{key}/loss"] = np.asarray(float(loss))
            out.update(flat(whole, f"{key}/grads/"))
    tpc.reset()
    return out


def _subtree(inp, prefix):
    """The nested tree (dicts, ``blocks`` a list) of the npz keys under
    ``prefix``."""
    tree = {}
    for k in inp.files:
        if not k.startswith(prefix):
            continue
        parts = k[len(prefix):].split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = inp[k]
    if "blocks" in tree:
        tree["blocks"] = [tree["blocks"][str(i)]
                          for i in range(len(tree["blocks"]))]
    return tree


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return t(tree)


def _like(tree, leaves):
    if isinstance(tree, dict):
        return {k: _like(v, leaves) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_like(v, leaves) for v in tree]
    return next(leaves)


# ----------------------------------------------------------------- bench


def bench_job(inp, rank, world):
    import json

    from torchdistpackage_tpu_torch.dist import comm_bench, tpc
    from torchdistpackage_tpu_torch.obs.comm_model import CommModel

    tpc.setup_process_groups([("data", world)])
    rows = comm_bench.test_collection(
        "data", sizes=BENCH_BYTES, ops=BENCH_OPS, verbose=False,
        warmup=0, iters=2, device="cpu")
    model = CommModel.calibrate(records=rows)
    tpc.reset()
    return {"bench/rows": np.asarray(json.dumps(rows)),
            "bench/axes": np.asarray(sorted(model.axis_costs)),
            "bench/int8_axes": np.asarray(sorted(
                model.compressed_axis_costs))}


JOBS = {"rings": rings_job, "dp": dp_job, "zero": zero_job,
        "fsdp": fsdp_job, "tp": tp_job, "bench": bench_job}


def main(rank, world, init_method, in_npz, out_dir):
    import datetime

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        inp = np.load(in_npz)
        out = {}
        for job in JOBS.values():
            out.update(job(inp, rank, world))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, init, src, dst = sys.argv[1:6]
    main(int(r), int(w), init, src, dst)
