"""One rank of the port's pipeline runs on the CPU, for
tests/test_torch_pipeline.py and tests/test_torch_pipeline_compose.py —
not a pytest file.

The parent writes the inputs (numpy arrays, made with JAX) to an
``.npz`` and starts ``world`` copies of this script, one a rank, each
naming the same ``job``; every copy joins a gloo process group through a
``file://`` rendezvous (a 120 s timeout, so a rank that schedules apart
fails instead of hanging), runs the job's cases and writes
``rank<r>.npz``.

- ``sched`` (world 2, then world 4): over ``[('pipe', P)]``:
  ``shift_right`` / ``shift_left`` (plain and circular) with their
  backward, the interleaved schedule's ``M % P`` refusal,
  ``pipeline_forward`` / ``pipeline_loss`` on a 4-block stack,
  ``gpt_pipeline_1f1b`` on the tiny GPT at M 4 (and at P 4, M 2), with
  its in-flight maxima; at P 2 also ``gpt_pipeline_loss``,
  ``pipeline_1f1b(stage_returns_aux=True)``, the interleaved schedule
  (V 2), ``gpt_pipeline_zb`` (and at P 4, M 2), ZB against 1F1B under
  one dropout key, the heterogeneous bus, the balanced (skewed) stage
  stack, and two planted faults: the pipe sum of the replicated leaves
  left out, and ``last_stage_value``'s backward summing.
- ``compose`` (world 4): data 2 x pipe 2 — ``pipeline_loss`` inside
  ``DataParallel.make_train_step`` and ``gpt_pipeline_1f1b`` as its
  ``value_and_grad_fn`` (2 AdamW steps each), ZeRO x 1F1B on
  ``build_hybrid_mesh(2)`` (3 steps, plain and with the clip chain), and
  the planted fault "a cotangent sent to the wrong neighbour" (the other
  data replica's stage); pipe 2 x tensor 2 — ``gpt_pipeline_1f1b`` and
  ``gpt_pipeline_zb`` with ``tp_group`` and ``shard_transfers``.

Imports only the port (and numpy): never JAX.  Run as
``python tests/_torch_pipeline_worker.py JOB RANK WORLD INIT_METHOD
IN_NPZ OUT_DIR``.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from _torch_ep_worker import flatten, unflatten  # noqa: E402

#: the tiny GPT of JAX tests/test_zero.py:185 (f32, plain attention)
GPT = dict(vocab_size=64, dim=32, nheads=4, nlayers=4, max_seq=16,
           ffn_mult=2)
#: the block stack of JAX tests/test_pipeline.py:47
BLK = dict(dim=32, nheads=4, nlayers=4, ffn_mult=2, causal=True)
M, MBS, S = 4, 2, 16
DP_STEPS, ZERO_STEPS, LR = 2, 3, 1e-2
#: the clip chain's max norm: under the tiny GPT's grad norm, so it bites
CLIP = 0.5
DROP_KEY, DROP_RATE = 7, 0.1
#: the aux term a stage adds a microbatch: AUX_W * mean(y ** 2)
AUX_W = 0.01
#: balanced_stage_stack's declared layer costs (JAX tests/test_pipeline.py:770)
SKEW = [3.0, 1.0, 1.0, 1.0]
HET = dict(D0=8, D1=12, D2=6)


def tensors(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: tensors(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))
    return t.to(dtype) if t.is_floating_point() else t.long()


def subtree(inp, prefix):
    return unflatten({k[len(prefix):]: inp[k] for k in inp.files
                      if k.startswith(prefix)})


def host(tree, prefix):
    def det(t):
        if isinstance(t, dict):
            return {k: det(v) for k, v in t.items()}
        return t.detach().float().numpy()
    return {prefix + k: v for k, v in flatten(det(tree)).items()}


def rows(tree, a, b):
    if isinstance(tree, dict):
        return {k: rows(v, a, b) for k, v in tree.items()}
    return tree[a:b]


def trainable(tree):
    if isinstance(tree, dict):
        return {k: trainable(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def grads_of(tree):
    if isinstance(tree, dict):
        return {k: grads_of(v) for k, v in tree.items()}
    return tree.grad


def gcfg(**kw):
    from torchdistpackage_tpu_torch.models import GPTConfig

    return GPTConfig(**dict(GPT, **kw))


def bcfg():
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        TransformerConfig,
    )

    return TransformerConfig(**BLK)


def gpt_local(inp, s, P, V=1, tp=(0, 1)):
    from torchdistpackage_tpu_torch.models import params_from_jax

    return trainable(params_from_jax(
        subtree(inp, "gpt/params/"), gcfg(), device="cpu", pp_rank=s,
        pp_size=P, num_chunks=V, tp_rank=tp[0], tp_size=tp[1]))


def gpt_batch(inp, m=M, prefix="gpt/batch/"):
    b = tensors(subtree(inp, prefix))
    return {k: v[:m] for k, v in b.items()}


def stats():
    from torchdistpackage_tpu_torch.parallel.pipeline_parallel import (
        last_stats,
    )

    return np.asarray([last_stats["max_in_flight"],
                       last_stats["in_flight_bound"]])


def blk_stage_fn(stacked, x):
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        scan_blocks,
    )

    return scan_blocks(stacked, x, bcfg())


def mse(y, t):
    return torch.mean((y - t) ** 2)


def blk_slab(inp, s, P):
    full = tensors(subtree(inp, "blk/params/"))
    c = BLK["nlayers"] // P
    return trainable(rows(full, s * c, (s + 1) * c))


# ------------------------------------------------------------------ sched


def fill_drain(inp, s, P):
    """``pipeline_forward`` (outputs via ``last_stage_value``) and
    ``pipeline_loss`` with its grads, on the block stack."""
    from torchdistpackage_tpu_torch.parallel.pipeline_parallel import (
        last_stage_value,
        pipeline_forward,
        pipeline_loss,
    )

    x, y = tensors(inp["blk/x"]), tensors(inp["blk/y"])
    out = {}
    with torch.no_grad():
        o = pipeline_forward(blk_slab(inp, s, P), x, blk_stage_fn, M)
        out["fwd"] = last_stage_value(o).numpy()
    slab = blk_slab(inp, s, P)
    loss = pipeline_loss(slab, x, y, blk_stage_fn, mse, M)
    loss.backward()
    out["loss/loss"] = loss.detach().numpy()
    out.update(host(grads_of(slab), "loss/grads/"))
    return out


def gpt_run(inp, tag, fn, s, P, m=M, V=1, **kw):
    params = gpt_local(inp, s, P, V)
    loss, grads = fn(params, gpt_batch(inp, m), gcfg(), m,
                     **(dict(num_chunks=V) if V > 1 else {}), **kw)
    out = {f"{tag}/loss": loss.numpy(), f"{tag}/stats": stats()}
    out.update(host(grads, f"{tag}/grads/"))
    return out


def aux_run(inp, s, P):
    """``pipeline_1f1b(stage_returns_aux=True)``: each stage adds
    ``AUX_W * mean(y ** 2)`` of its output a microbatch."""
    from torchdistpackage_tpu_torch.parallel.pipeline_parallel import (
        pipeline_1f1b,
        stacked_param_specs,
    )

    slab = blk_slab(inp, s, P)

    def stage(p, h):
        yy = blk_stage_fn(p, h)
        return yy, AUX_W * torch.mean(yy ** 2)

    loss, grads = pipeline_1f1b(
        slab, tensors(inp["blk/x"]), tensors(inp["blk/y"]),
        first_fn=lambda p, mb: mb, stage_fn=stage,
        last_fn=lambda p, o, t: mse(o, t), num_microbatches=M,
        stage_returns_aux=True, param_specs=stacked_param_specs(slab))
    out = {"aux/loss": loss.numpy()}
    out.update(host(grads, "aux/grads/"))
    return out


def dropout_pair(inp, s, P):
    """ZB and 1F1B on the GPT with residual dropout under one key."""
    from torchdistpackage_tpu_torch.models import (
        gpt_pipeline_1f1b,
        gpt_pipeline_zb,
    )

    out = {}
    cfg = gcfg(dropout_rate=DROP_RATE)
    for tag, fn in (("drop_1f1b", gpt_pipeline_1f1b),
                    ("drop_zb", gpt_pipeline_zb)):
        loss, grads = fn(gpt_local(inp, s, P), gpt_batch(inp), cfg, M,
                         dropout_key=DROP_KEY)
        out[f"{tag}/loss"] = loss.numpy()
        out.update(host(grads, f"{tag}/grads/"))
    return out


def hetero_run(inp, s, P):
    """JAX tests/test_pipeline.py:1105: stage 0 maps D0 -> D1, stage 1 D1
    -> D2, over the bus."""
    from torchdistpackage_tpu_torch.parallel.pipeline_parallel import (
        ShapeDtype,
        make_heterogeneous_stage,
        pipeline_1f1b,
    )

    params = trainable(tensors(subtree(inp, "het/params/")))
    D = HET
    edges = [ShapeDtype((MBS, D["D0"]), torch.float32),
             ShapeDtype((MBS, D["D1"]), torch.float32),
             ShapeDtype((MBS, D["D2"]), torch.float32)]
    wf, sf, wl = make_heterogeneous_stage(
        [lambda p, x, m: torch.tanh(x @ p["w0"]),
         lambda p, x, m: torch.tanh(x @ p["w1"])], edges)
    loss, grads = pipeline_1f1b(
        params, tensors(inp["het/x"]), tensors(inp["het/y"]),
        first_fn=wf(lambda p, mb: mb), stage_fn=sf,
        last_fn=wl(lambda p, yy, t: mse(yy, t)), num_microbatches=M,
        stage_takes_mb=True)
    out = {"het/loss": loss.numpy()}
    out.update(host(grads, "het/grads/"))
    return out


def skewed_run(inp, s, P):
    """JAX tests/test_pipeline.py:744: layers assigned by
    ``balanced_stage_stack`` (bounds [(0, 1), (1, 4)]), each slab padded
    to 3 layers, ``scan_blocks(layer_mask=)``."""
    from torchdistpackage_tpu_torch.parallel.pipeline_parallel import (
        balanced_stage_stack,
        pipeline_1f1b,
        stacked_param_specs,
        unstack_stage_params,
    )
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        scan_blocks,
    )

    layers = unstack_stage_params(tensors(subtree(inp, "blk/params/")))
    stacked, mask, bounds = balanced_stage_stack(layers, SKEW, P)
    n = mask.shape[1]
    slab = trainable(rows(stacked, s * n, (s + 1) * n))
    loss, grads = pipeline_1f1b(
        slab, tensors(inp["blk/x"]), tensors(inp["blk/y"]),
        first_fn=lambda p, mb: mb,
        stage_fn=lambda p, h: scan_blocks(p, h, bcfg(), layer_mask=mask[s]),
        last_fn=lambda p, o, t: mse(o, t), num_microbatches=M,
        param_specs=stacked_param_specs(slab))
    out = {"skew/loss": loss.numpy(), "skew/mask": mask.numpy(),
           "skew/bounds": np.asarray(bounds)}
    out.update(host(grads, "skew/grads/"))
    return out


def faults(inp, s, P):
    """Planted faults, each must fail its check in the parent: the pipe
    sum of the replicated leaves left out (1F1B), and a summing
    ``last_stage_value`` backward (``gpt_pipeline_loss``)."""
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.models import (
        gpt_pipeline_1f1b,
        gpt_pipeline_loss,
    )
    from torchdistpackage_tpu_torch.parallel.pipeline_parallel import (
        _p2p,
        pipeline_sched,
    )

    out = {}
    sync = pipeline_sched._Stage.sync
    pipeline_sched._Stage.sync = lambda self, grads: None
    try:
        out.update(gpt_run(inp, "fault_nosum", gpt_pipeline_1f1b, s, P))
    finally:
        pipeline_sched._Stage.sync = sync

    back = pipeline_sched._LastStageValue.backward

    def summing(ctx, g):
        return _p2p.all_reduce_(g.clone(), dist.group.WORLD), None
    pipeline_sched._LastStageValue.backward = staticmethod(summing)
    try:
        params = gpt_local(inp, s, P)
        loss = gpt_pipeline_loss(params, gpt_batch(inp), gcfg(), M)
        loss.backward()
        out.update(host(grads_of(params),
                        "fault_lsv/grads/"))
    finally:
        pipeline_sched._LastStageValue.backward = back
    return out


def gpt_loss_run(inp, s, P):
    from torchdistpackage_tpu_torch.models import gpt_pipeline_loss

    params = gpt_local(inp, s, P)
    loss = gpt_pipeline_loss(params, gpt_batch(inp), gcfg(), M)
    loss.backward()
    out = {"gloss/loss": loss.detach().numpy()}
    out.update(host(grads_of(params), "gloss/grads/"))
    return out


def shifts(s, P):
    """``shift_right`` / ``shift_left`` (plain and circular) on ``x = s +
    1`` with ``loss = sum(y * 10 (s + 1))``: the values each stage
    receives and the grads its ``x`` gets back (the reverse shift); and
    the interleaved schedule's ``M % P`` refusal, raised before any
    message."""
    from torchdistpackage_tpu_torch.parallel.pipeline_parallel import (
        pipeline_1f1b,
        shift_left,
        shift_right,
    )

    out = {}
    for name, fn in (("right", shift_right), ("left", shift_left)):
        for circ in (False, True):
            x = torch.full((3,), float(s + 1), requires_grad=True)
            y = fn(x, circular=circ)
            (y * 10.0 * (s + 1)).sum().backward()
            out[f"shift/{name}{int(circ)}/y"] = y.detach().numpy()
            out[f"shift/{name}{int(circ)}/grad"] = x.grad.numpy()
    try:
        x = torch.zeros(P + 1, 2, 4)
        pipeline_1f1b({"w": torch.zeros(2)}, x, x, lambda p, mb: mb,
                      lambda p, h, m, v: h, lambda p, y, t: y.mean(), P + 1,
                      num_chunks=2)
        out["shift/mod_refused"] = np.asarray(False)
    except ValueError as e:
        out["shift/mod_refused"] = np.asarray("divisible by pipe size"
                                              in str(e))
    return out


def sched_job(inp, rank, world):
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.models import (
        gpt_pipeline_1f1b,
        gpt_pipeline_zb,
    )

    tpc.setup_process_groups([("pipe", world)])
    s, P = rank, world
    out = fill_drain(inp, s, P)
    out.update(shifts(s, P))
    out.update(gpt_run(inp, "1f1b_m4", gpt_pipeline_1f1b, s, P))
    if P == 2:
        out.update(gpt_loss_run(inp, s, P))
        out.update(aux_run(inp, s, P))
        out.update(gpt_run(inp, "inter", gpt_pipeline_1f1b, s, P, V=2))
        out.update(gpt_run(inp, "zb_m4", gpt_pipeline_zb, s, P))
        out.update(dropout_pair(inp, s, P))
        out.update(hetero_run(inp, s, P))
        out.update(skewed_run(inp, s, P))
        out.update(faults(inp, s, P))
    else:
        out.update(gpt_run(inp, "1f1b_m2", gpt_pipeline_1f1b, s, P, m=2))
        out.update(gpt_run(inp, "zb_m2", gpt_pipeline_zb, s, P, m=2))
    return out


# ---------------------------------------------------------------- compose


def data_rows(batch, d, n=2):
    return {k: v[:, d * MBS:(d + 1) * MBS] for k, v in batch.items()}


def dp_runs(inp, d, s):
    """Data 2 x pipe 2: ``pipeline_loss`` (the block stack, MSE) inside
    ``DataParallel.make_train_step(loss_fn)``, and ``gpt_pipeline_1f1b``
    as its ``value_and_grad_fn``; 2 AdamW steps each."""
    from torchdistpackage_tpu_torch.models import (
        gpt_param_specs,
        gpt_pipeline_1f1b,
    )
    from torchdistpackage_tpu_torch.parallel import DataParallel, adamw
    from torchdistpackage_tpu_torch.parallel.pipeline_parallel import (
        pipeline_loss,
        stacked_param_specs,
    )

    out = {}
    dp = DataParallel()
    slab = blk_slab(inp, s, 2)
    opt = adamw(LR)
    state = opt.init(slab)
    step = dp.make_train_step(
        lambda p, b: pipeline_loss(p, b["x"], b["y"], blk_stage_fn, mse, M),
        opt, pipe_specs=stacked_param_specs(slab))
    losses = []
    for i in range(DP_STEPS):
        b = data_rows(tensors(subtree(inp, f"dpblk/batch{i}/")), d)
        slab, state, loss, _ = step(slab, state, b)
        losses.append(float(loss))
    out["dp_loss/losses"] = np.asarray(losses)
    out.update(host(slab, "dp_loss/params/"))

    params = gpt_local(inp, s, 2)
    opt = adamw(LR)
    state = opt.init(params)
    cfg = gcfg()
    step = dp.make_train_step(
        value_and_grad_fn=lambda p, b: gpt_pipeline_1f1b(p, b, cfg, M),
        optimizer=opt, pipe_specs=gpt_param_specs(params, pipe_axis="pipe"))
    losses, norms = [], []
    for i in range(DP_STEPS):
        b = data_rows(gpt_batch(inp, prefix=f"dpgpt/batch{i}/"), d)
        params, state, loss, gnorm = step(params, state, b)
        losses.append(float(loss))
        norms.append(float(gnorm))
    out["dp_1f1b/losses"] = np.asarray(losses)
    out["dp_1f1b/norms"] = np.asarray(norms)
    out.update(host(params, "dp_1f1b/params/"))
    return out


def zero_runs(inp, d, s):
    """ZeRO x 1F1B on ``build_hybrid_mesh(2)`` (data_inter 1 x data_intra
    2) beside pipe 2, 3 steps: plain and with the clip chain."""
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.models import (
        gpt_param_specs,
        gpt_pipeline_1f1b,
    )
    from torchdistpackage_tpu_torch.parallel import (
        ZeroOptimizer,
        adamw,
        chain,
        clip_by_global_norm_parallel,
    )

    tpc.build_hybrid_mesh(intra_size=2)
    cfg = gcfg()
    out = {}
    for tag, opt in (("zero", adamw(LR)),
                     ("zero_clip", chain(clip_by_global_norm_parallel(CLIP),
                                         adamw(LR)))):
        params = gpt_local(inp, s, 2)
        zero = ZeroOptimizer(opt, shard_axis="data_intra",
                             grad_reduce_axes=("data_inter", "data_intra"),
                             pipe_specs=gpt_param_specs(params,
                                                        pipe_axis="pipe"))
        params = zero.place_params(params)
        state = zero.init(params)
        step = zero.make_train_step(
            value_and_grad_fn=lambda p, b: gpt_pipeline_1f1b(p, b, cfg, M))
        losses, norms = [], []
        for i in range(ZERO_STEPS):
            b = data_rows(gpt_batch(inp, prefix=f"dpgpt/batch{i}/"), d)
            params, state, loss, gnorm = step(params, state, b)
            losses.append(float(loss))
            norms.append(float(gnorm))
        out[f"{tag}/losses"] = np.asarray(losses)
        out[f"{tag}/norms"] = np.asarray(norms)
        out.update(host(params, f"{tag}/params/"))
    return out


def wrong_neighbour(inp, d, s):
    """The planted fault: every cotangent sent to (and received from) the
    neighbouring stage of the OTHER data replica; the grads reduced over
    the data group."""
    from torchdistpackage_tpu_torch.models import gpt_pipeline_1f1b
    from torchdistpackage_tpu_torch.parallel import reduce_gradients
    from torchdistpackage_tpu_torch.parallel.pipeline_parallel import _p2p

    import torch.distributed as dist

    route = _p2p.route

    def misrouted(group, peer, tag):
        r, _ = route(group, peer, tag)  # every message over the world
        return ((r + 2) % 4 if tag == _p2p.COT else r), dist.group.WORLD
    _p2p.route = misrouted
    try:
        params = gpt_local(inp, s, 2)
        b = data_rows(gpt_batch(inp, prefix="dpgpt/batch0/"), d)
        loss, grads = gpt_pipeline_1f1b(params, b, gcfg(), M)
    finally:
        _p2p.route = route
    out = {"fault_route/loss": loss.numpy()}
    out.update(host(reduce_gradients(grads, "data"), "fault_route/grads/"))
    params = gpt_local(inp, s, 2)
    loss, grads = gpt_pipeline_1f1b(params, b, gcfg(), M)
    out["route/loss"] = loss.numpy()
    out.update(host(reduce_gradients(grads, "data"), "route/grads/"))
    return out


def tp_runs(inp, rank):
    """Pipe 2 x tensor 2: the stages run tensor parallel on their shards,
    the inter-stage state sliced 1/2 over the tensor group."""
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.models import (
        gpt_param_specs,
        gpt_pipeline_1f1b,
        gpt_pipeline_zb,
    )
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        COLLECTIVES,
        gather_params,
    )

    tpc.reset()
    tpc.setup_process_groups([("pipe", 2), ("tensor", 2)])
    s, t = tpc.get_group_rank("pipe"), tpc.get_group_rank("tensor")
    tg = tpc.get_group("tensor")
    out = {}
    for tag, fn in (("tp_1f1b", gpt_pipeline_1f1b),
                    ("tp_zb", gpt_pipeline_zb)):
        params = gpt_local(inp, s, 2, tp=(t, 2))
        before = COLLECTIVES["transfer_gather"]
        loss, grads = fn(params, gpt_batch(inp), gcfg(), M, tp_group=tg,
                         shard_transfers=True)
        out[f"{tag}/gathers"] = np.asarray(COLLECTIVES["transfer_gather"]
                                           - before)
        out[f"{tag}/loss"] = loss.numpy()
        whole = gather_params(grads, gpt_param_specs(grads), tg)
        out.update(host(whole, f"{tag}/grads/"))
    return out


def compose_job(inp, rank, world):
    from torchdistpackage_tpu_torch.dist import tpc

    tpc.setup_process_groups([("data", 2), ("pipe", 2)])
    d, s = tpc.get_group_rank("data"), tpc.get_group_rank("pipe")
    out = dp_runs(inp, d, s)
    out.update(wrong_neighbour(inp, d, s))
    out.update(zero_runs(inp, d, s))
    out.update(tp_runs(inp, rank))
    return out


JOBS = {"sched": sched_job, "compose": compose_job}


def start(job, world, inputs, tmp):
    """The parent's side: write ``inputs``, start ``world`` ranks of
    ``job``; returns the processes (:func:`results` waits for them)."""
    import subprocess

    tmp.mkdir(parents=True, exist_ok=True)
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
    import datetime

    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import tpc

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = JOBS[job](np.load(in_npz), rank, world)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        tpc.reset()
        dist.destroy_process_group()


if __name__ == "__main__":
    j, r, w, init, src, dst = sys.argv[1:7]
    main(j, int(r), int(w), init, src, dst)
