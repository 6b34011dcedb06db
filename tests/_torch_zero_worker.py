"""One rank of the port's sharded-training-state runs on the CPU, for
tests/test_torch_zero.py and tests/test_torch_fsdp.py — not a pytest
file.

The parent writes the inputs (numpy arrays, made with JAX) to an
``.npz`` and starts ``world`` copies of this script, one a rank, each
naming the same ``job``; every copy joins a gloo process group through a
``file://`` rendezvous, runs the job's cases and writes ``rank<r>.npz``.

- ``zero`` (world 4): ``ZeroOptimizer`` over ``tpc``'s ``data`` axis on
  the MLP of tests/test_data_parallel.py, 4 AdamW steps on this rank's
  rows of 4 global batches, per case of :data:`ZERO_CASES`
  (accumulation, ``accum_reduce``, bf16 parameters with f32 masters, the
  ``value_and_grad_fn`` path, the clip chain, a tree with a whole leaf,
  hybrid ZeRO on ``build_hybrid_mesh(2)`` with and without an
  override — over the intra-node axis alone, and over both — and two
  planted faults); the losses, the norms, the
  parameters after the last step and the grads of batch 0 reduced to
  this rank's shards; the clip chain in ``DataParallel``'s and FSDP's
  steps on the MLP; ZeRO x TP on the tiny GPT over data 2 x tensor 2
  at ``sp=True`` (3 steps, the gathered parameters); the global norm
  and the clip of TP-split, ZeRO-sharded and whole leaves; the loss
  scale's MIN over the group.
- ``fsdp`` (world 4): ``FSDP.make_train_step`` and
  ``make_overlap_train_step`` with ``gather`` 'leaf' and 'none' (3
  steps, gathered parameters), the
  overlap step with its backward reduce-scatter replaced by a local
  slice (planted fault); ``prefetched_layer_scan`` with and without
  prefetch and the whole stack gathered up front (this rank's output
  rows and the stack's grads); ``ShardedEMA`` over data 2 x tensor 2.

Imports only the port (and numpy): never JAX.  Run as
``python tests/_torch_zero_worker.py JOB RANK WORLD INIT_METHOD IN_NPZ
OUT_DIR``.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from _torch_ep_worker import flatten, unflatten  # noqa: E402

MLP_STEPS, MLP_LR = 4, 1e-2
#: the clip chain's max norm: below the MLP's global norm on every
#: batch (0.35-0.48), so the clip scales every step
CLIP = 0.25
#: case -> (grad_accum_iters, accum_reduce, extra ZeroOptimizer kwargs,
#: layout: 'data' or 'hybrid')
ZERO_CASES = {
    "accum1": (1, "final", {}, "data"),
    "accum2_final": (2, "final", {}, "data"),
    "accum2_microbatch": (2, "microbatch", {}, "data"),
    "bf16": (1, "final", {"param_dtype": torch.bfloat16}, "data"),
    "vag": (1, "final", {}, "data"),
    "clip": (1, "final", {}, "data"),
    "hybrid": (1, "final", {}, "hybrid"),
    "hybrid_override": (1, "final", {
        "grad_reduce_overrides": {"w2": ("data_intra",)}}, "hybrid"),
    "hybrid_override_all": (1, "final", {
        "grad_reduce_overrides": {"w2": ("data_inter", "data_intra")}},
        "hybrid"),
    "fault_sum": (1, "final", {}, "data"),
    "fault_regather": (1, "final", {}, "data"),
}
HYBRID = dict(shard_axis="data_intra",
              grad_reduce_axes=("data_inter", "data_intra"))
#: the tiny GPT of the ZeRO x TP case (f32, plain attention)
GPT = dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=16,
           ffn_mult=2)
TP_STEPS, TP_LR = 3, 1e-3
FSDP_STEPS, FSDP_LR = 3, 1e-2
EMA_DECAY = 0.9


def mlp_loss(p, b):
    """tests/test_data_parallel.py's; bf16 parameters meet the f32 batch
    in f32, as JAX's type promotion has them."""
    p = {k: v.to(b["x"].dtype) for k, v in p.items()}
    h = torch.tanh(b["x"] @ p["w1"] + p["b1"])
    return torch.mean((h @ p["w2"] + p["b2"] - b["y"]) ** 2)


def whole_loss(p, b):
    """The FSDP overlap test's loss (tests/test_overlap.py): ``b`` has 3
    elements, so no group of 2 or 4 divides it and it stays whole."""
    h = torch.tanh(b["x"] @ p["w1"])
    return ((h @ p["w2"]) ** 2).mean() + (p["b"] ** 2).sum()


def tensors(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: tensors(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree)).to(dtype)


def subtree(inp, prefix):
    return unflatten({k[len(prefix):]: inp[k] for k in inp.files
                      if k.startswith(prefix)})


def host(tree, prefix):
    def det(t):
        if isinstance(t, dict):
            return {k: det(v) for k, v in t.items()}
        return t.detach().float().numpy()
    return {prefix + k: v for k, v in flatten(det(tree)).items()}


# ------------------------------------------------------------------- zero


def zero_case(inp, case, rank):
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.parallel import (
        ZeroOptimizer,
        adamw,
        chain,
        clip_by_global_norm_parallel,
    )
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        local_value_and_grad,
    )
    from torchdistpackage_tpu_torch.parallel.tensor_parallel.tp_utils import (
        _all_gather,
    )
    from torchdistpackage_tpu_torch.utils.data import shard_batch

    M, acc, kw, layout = ZERO_CASES[case]
    kw = dict(kw, **(HYBRID if layout == "hybrid" else {}))
    group = tpc.get_group(kw.get("grad_reduce_axes", "data"))
    opt = adamw(MLP_LR)
    if case == "clip":
        opt = chain(clip_by_global_norm_parallel(CLIP), opt)
    zero = ZeroOptimizer(opt, **kw)
    params = zero.place_params(tensors(subtree(inp, "mlp/params/")))
    state = zero.init(params)
    batches = [shard_batch(tensors(subtree(inp, f"mlp/batch{i}/")), group,
                           device="cpu") for i in range(MLP_STEPS)]
    out = {}
    # batch 0's grads reduced to this rank's shards, before any step
    _, g = local_value_and_grad(mlp_loss, params, batches[0])
    out.update(host(zero.reduce_grads_to_shard(g, zero.shard_dims(params)),
                    f"zero/{case}/gshard/"))
    if case == "vag":
        step = zero.make_train_step(
            value_and_grad_fn=lambda p, b: local_value_and_grad(mlp_loss, p,
                                                                b))
    else:
        step = zero.make_train_step(mlp_loss, grad_accum_iters=M,
                                    accum_reduce=acc)
    losses, norms = [], []
    for b in batches:
        params, state, loss, gnorm = step(params, state, b)
        losses.append(float(loss))
        norms.append(float(gnorm))
    out[f"zero/{case}/losses"] = np.asarray(losses)
    out[f"zero/{case}/norms"] = np.asarray(norms)
    out.update(host(params, f"zero/{case}/params/"))
    out[f"zero/{case}/param_dtype"] = np.asarray(str(params["w1"].dtype))
    with torch.no_grad():
        master = {k: m if d < 0 else _all_gather(m, zero.shard_group, d,
                                                 "zero_all_gather")
                  for (k, m), d in zip(state["master"].items(),
                                       zero.shard_dims(params).values())}
    out.update(host(master, f"zero/{case}/master/"))
    out[f"zero/{case}/master_dtype"] = np.asarray(str(master["w1"].dtype))
    return out


def chain_cases(inp):
    """The clip chain in ``DataParallel``'s and in FSDP's step on the MLP:
    the same math as ZeRO's ``clip`` case (the data-mean grads clipped,
    then AdamW)."""
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.parallel import (
        FSDP,
        DataParallel,
        adamw,
        chain,
        clip_by_global_norm_parallel,
        fsdp,
    )
    from torchdistpackage_tpu_torch.utils.data import shard_batch

    out = {}
    for kind in ("dp", "fsdp"):
        opt = chain(clip_by_global_norm_parallel(CLIP), adamw(MLP_LR))
        params = tensors(subtree(inp, "mlp/params/"))
        if kind == "dp":
            dp = DataParallel()
            state = opt.init(params)
            step = dp.make_train_step(mlp_loss, opt)
        else:
            fs = FSDP()
            params = fs.shard_params(params)
            state = opt.init(params)
            step = fs.make_overlap_train_step(mlp_loss, opt)
        losses = []
        for i in range(MLP_STEPS):
            b = shard_batch(tensors(subtree(inp, f"mlp/batch{i}/")),
                            tpc.get_group("data"), device="cpu")
            params, state, loss, _ = step(params, state, b)
            losses.append(float(loss))
        if kind == "fsdp":
            with torch.no_grad():
                params = fsdp.gather_params(params, fs.shard_dims_of(params))
        out[f"chain/{kind}/losses"] = np.asarray(losses)
        out.update(host(params, f"chain/{kind}/params/"))
    return out


def zero_whole_case(inp):
    """A tree with a leaf no group size divides: ``b`` stays whole."""
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.parallel import ZeroOptimizer, adamw
    from torchdistpackage_tpu_torch.utils.data import shard_batch

    zero = ZeroOptimizer(adamw(MLP_LR))
    params = zero.place_params(tensors(subtree(inp, "whole/params/")))
    state = zero.init(params)
    step = zero.make_train_step(whole_loss)
    batch = shard_batch(tensors(subtree(inp, "whole/batch/")),
                        tpc.get_group("data"), device="cpu")
    losses = []
    for _ in range(FSDP_STEPS):
        params, state, loss, _ = step(params, state, batch)
        losses.append(float(loss))
    out = {"zero/whole/losses": np.asarray(losses)}
    out.update({f"zero/whole/dims/{k}": np.asarray(d)
                for k, d in zero.shard_dims(params).items()})
    out.update(host(params, "zero/whole/params/"))
    return out


def planted(case):
    """The planted faults, as patches of ``ZeroOptimizer``: the
    reduction's mean replaced by its sum, the re-gather skipped on
    ``w1``."""
    import contextlib

    from torchdistpackage_tpu_torch.parallel import zero as Z

    @contextlib.contextmanager
    def patch(name, fn):
        old = getattr(Z.ZeroOptimizer, name)
        setattr(Z.ZeroOptimizer, name, fn(old))
        try:
            yield
        finally:
            setattr(Z.ZeroOptimizer, name, old)

    if case == "fault_sum":
        def fn(old):
            def summed(self, grads, dims, *rest):
                red = old(self, grads, dims, *rest)
                return {k: v * self.total for k, v in red.items()}
            return summed
        return patch("reduce_grads_to_shard", fn)
    if case == "fault_regather":
        def fn(old):
            def skip_w1(self, params, master, dims, *rest):
                keep = params["w1"].detach().clone()
                old(self, params, master, dims, *rest)
                with torch.no_grad():
                    params["w1"].copy_(keep)
                return params
            return skip_w1
        return patch("regather", fn)
    return contextlib.nullcontext()


def zero_tp_case(inp):
    """ZeRO beside TP: data 2 x tensor 2, the tiny GPT at ``sp=True``."""
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.models import (
        GPTConfig,
        gpt_loss,
        params_from_jax,
    )
    from torchdistpackage_tpu_torch.models.gpt import gpt_param_specs
    from torchdistpackage_tpu_torch.parallel import ZeroOptimizer, adamw
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        gather_params,
    )
    from torchdistpackage_tpu_torch.utils.data import shard_batch

    tpc.reset()
    tpc.setup_process_groups([("data", 2), ("tensor", 2)])
    group = tpc.get_group("tensor")
    cfg = GPTConfig(**GPT, dtype=torch.float32, attn_impl="naive")
    params = params_from_jax(subtree(inp, "gpt/params/"), cfg, device="cpu",
                             tp_rank=tpc.get_group_rank("tensor"),
                             tp_size=2)
    specs = gpt_param_specs(params)
    zero = ZeroOptimizer(adamw(TP_LR), param_specs=specs)
    params = zero.place_params(params)
    state = zero.init(params)
    step = zero.make_train_step(
        lambda p, b: gpt_loss(p, b, cfg, tp_group=group, sp=True), sp=True)
    losses = []
    for i in range(TP_STEPS):
        b = {k: inp[f"gpt/batch{i}/{k}"] for k in ("tokens", "targets")}
        params, state, loss, _ = step(params, state, shard_batch(
            b, tpc.get_group("data"), device="cpu"))
        losses.append(float(loss))
    out = {"zero_tp/losses": np.asarray(losses),
           "zero_tp/wqkv_dim": np.asarray(
               zero.shard_dims(params)["blocks"]["attn"]["wqkv"])}
    with torch.no_grad():
        out.update(host(gather_params(params, specs, group),
                        "zero_tp/params/"))
    return out


def clip_case(inp, rank):
    """The global norm and the clip over data 2 x tensor 2: ``tp`` split
    over the tensor group on dim 1, ``zero`` sharded over the data group
    on dim 0, ``both`` both, ``rep`` whole; then the loss scale's MIN
    over the data group with an inf on rank 3 only."""
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.parallel import (
        DynamicLossScale,
        clip_grads_by_global_norm,
        global_grad_norm,
    )

    tpc.reset()
    tpc.setup_process_groups([("data", 2), ("tensor", 2)])
    dg, tg = tpc.get_group("data"), tpc.get_group("tensor")
    d, t = tpc.get_group_rank("data"), tpc.get_group_rank("tensor")
    full = tensors(subtree(inp, "clip/grads/"))
    grads = {"tp": full["tp"].chunk(2, 1)[t],
             "zero": full["zero"].chunk(2, 0)[d],
             "both": full["both"].chunk(2, 0)[d].chunk(2, 1)[t],
             "rep": full["rep"]}
    groups = {"tp": tg, "zero": dg, "both": (dg, tg), "rep": None}
    norm = global_grad_norm(grads, groups)
    clipped, pre = clip_grads_by_global_norm(grads, 1.0, groups)
    post = global_grad_norm(clipped, groups)
    scaler = DynamicLossScale(init_scale=8.0, growth_interval=2,
                              emit_events=False)
    st = scaler.init(device="cpu")
    g = {"w": torch.ones(3) * (float("inf") if rank == 3 else 8.0)}
    g, st, finite = scaler.unscale_and_update(g, st, {"w": dg})
    return {"clip/norm": np.asarray(float(norm)),
            "clip/pre": np.asarray(float(pre)),
            "clip/post": np.asarray(float(post)),
            "scale/finite": np.asarray(bool(finite)),
            "scale/scale": np.asarray(float(st.scale)),
            "scale/grads": g["w"].numpy()}


def zero_job(inp, rank, world):
    from torchdistpackage_tpu_torch.dist import tpc

    tpc.setup_process_groups([("data", world)])
    tpc.build_hybrid_mesh(2)
    out = {}
    for case in ZERO_CASES:
        with planted(case):
            out.update(zero_case(inp, case, rank))
    out.update(chain_cases(inp))
    out.update(zero_whole_case(inp))
    out.update(zero_tp_case(inp))
    out.update(clip_case(inp, rank))
    return out


# ------------------------------------------------------------------- fsdp


def fsdp_runs(inp, kind):
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.parallel import FSDP, adamw, fsdp
    from torchdistpackage_tpu_torch.utils.data import shard_batch

    fs = FSDP()
    shards = fs.shard_params(tensors(subtree(inp, "whole/params/")))
    opt = adamw(FSDP_LR)
    state = opt.init(shards)
    if kind == "plain":
        step = fs.make_train_step(whole_loss, opt)
    elif kind == "overlap_none":  # the loss gathers the shards itself
        step = fs.make_overlap_train_step(
            lambda sh, b: whole_loss(fsdp.gather_params(
                sh, fs.shard_dims_of(sh)), b), opt, gather="none")
    else:
        step = fs.make_overlap_train_step(whole_loss, opt)
    batch = shard_batch(tensors(subtree(inp, "whole/batch/")),
                        tpc.get_group("data"), device="cpu")
    old = fsdp._Gather.backward
    if kind == "fault_local_slice":
        def local(ctx, g):  # this rank's slice, no sum over the group
            n, r = fsdp.dist.get_world_size(ctx.group), fsdp.dist.get_rank(
                ctx.group)
            return g.chunk(n, ctx.dim)[r].contiguous(), None, None, None
        fsdp._Gather.backward = staticmethod(local)
    try:
        losses = []
        for _ in range(FSDP_STEPS):
            shards, state, loss, _ = step(shards, state, batch)
            losses.append(float(loss))
    finally:
        fsdp._Gather.backward = old
    out = {f"fsdp/{kind}/losses": np.asarray(losses)}
    with torch.no_grad():
        full = fsdp.gather_params(shards, fs.shard_dims_of(shards))
    out.update(host(full, f"fsdp/{kind}/params/"))
    return out


def prefetch_runs(inp, rank):
    """This rank's output rows and the stack's grads (the sum over the
    ranks' local losses, as the reduce-scatters leave it) for the
    prefetched scan with and without prefetch, and for the whole stack
    gathered up front."""
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.parallel import (
        gather_params,
        prefetched_layer_scan,
        stacked_fsdp_specs,
    )
    from torchdistpackage_tpu_torch.parallel.zero import shard_of

    group = tpc.get_group("data")
    n = torch.distributed.get_world_size(group)
    full = tensors(subtree(inp, "scan/params/"))
    _, dims = stacked_fsdp_specs(full, n)
    x = torch.from_numpy(inp["scan/x"]).chunk(n, 0)[rank]
    out = {"scan/dims": np.asarray(dims["w"])}

    def apply_fn(lp, h, i):
        return torch.tanh(h @ lp["w"])

    def ref(st, xx):
        whole = gather_params(st, dims, group)
        for i in range(whole["w"].shape[0]):
            xx = torch.tanh(xx @ whole["w"][i])
        return xx

    variants = {
        "ref": ref,
        "prefetch": lambda st, xx: prefetched_layer_scan(
            st, xx, apply_fn, group, dims, prefetch=True),
        "no_prefetch": lambda st, xx: prefetched_layer_scan(
            st, xx, apply_fn, group, dims, prefetch=False)}
    for name, fn in variants.items():
        st = {"w": shard_of(full["w"], dims["w"], rank, n).clone()
              .requires_grad_(True)}
        y = fn(st, x)
        (y ** 2).mean().backward()
        out[f"scan/{name}/y"] = y.detach().numpy()
        out[f"scan/{name}/grad"] = st["w"].grad.numpy()
    return out


def ema_run(inp):
    """``ShardedEMA`` over data 2 x tensor 2: ``w`` split over the tensor
    group on its columns, ``b`` whole (3 elements)."""
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.parallel import ShardedEMA

    tpc.reset()
    tpc.setup_process_groups([("data", 2), ("tensor", 2)])
    t = tpc.get_group_rank("tensor")
    full = tensors(subtree(inp, "ema/params/"))
    params = {"w": full["w"].chunk(2, 1)[t].contiguous(), "b": full["b"]}
    specs = {"w": -1, "b": None}
    ema = ShardedEMA(decay=EMA_DECAY)
    state = ema.init(params, specs)
    shard_shape = np.asarray(state["w"].shape)
    # the dense f32 EMA of the same leaves by the same formula
    d = torch.tensor(EMA_DECAY, dtype=torch.float32)
    dense = {k: v.clone() for k, v in params.items()}
    for i in range(3):
        params = {k: v + 0.1 * (i + 1) for k, v in params.items()}
        state = ema.update(state, params)
        dense = {k: dense[k] * d + params[k] * (1.0 - d) for k in dense}
    sd = ema.state_dict(state)
    return {"ema/w": sd["w"], "ema/b": sd["b"],
            "ema/w_shard_shape": shard_shape,
            "ema/exact": np.asarray(ema.verify_with_gt(state, dense)),
            "ema/off": np.asarray(ema.verify_with_gt(
                state, {k: v + 1e-6 for k, v in dense.items()}))}


def fsdp_job(inp, rank, world):
    from torchdistpackage_tpu_torch.dist import tpc

    tpc.setup_process_groups([("data", world)])
    out = {}
    for kind in ("plain", "overlap", "overlap_none", "fault_local_slice"):
        out.update(fsdp_runs(inp, kind))
    out.update(prefetch_runs(inp, rank))
    out.update(ema_run(inp))
    return out


JOBS = {"zero": zero_job, "fsdp": fsdp_job}


def start(job, world, inputs, tmp):
    """The parent's side: write ``inputs``, start ``world`` ranks of
    ``job``; returns the processes (:func:`results` waits for them)."""
    import subprocess

    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r), str(world),
         f"file://{tmp / 'store'}", str(tmp / "in.npz"), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(world)]


def results(procs, tmp, timeout=300):
    """Each rank's outputs, once every process has exited 0."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(len(procs))]


def main(job, rank, world, init_method, in_npz, out_dir):
    from torchdistpackage_tpu_torch.dist import init_distributed, tpc

    torch.set_num_threads(1)
    init_distributed(init_method, world, rank, "cpu")
    import torch.distributed as dist

    try:
        out = JOBS[job](np.load(in_npz), rank, world)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        tpc.reset()
        dist.destroy_process_group()


if __name__ == "__main__":
    j, r, w, init, src, dst = sys.argv[1:7]
    main(j, int(r), int(w), init, src, dst)
