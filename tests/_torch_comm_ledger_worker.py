"""One rank of the port's comm-ledger runs on the CPU, for
tests/test_torch_comm_ledger.py and tests/test_torch_parity.py — not a
pytest file.

The parent writes the inputs (numpy arrays: the tiny GPT's parameters
and batches) to an ``.npz`` and starts ``world`` copies of this script,
one a rank, each naming the same job; every copy joins a gloo group
through a ``file://`` rendezvous (a 120 s timeout, so a rank that
enters a different collective fails instead of hanging), runs the job
and writes ``rank<r>.npz``.

- ``ledger`` (world 4):
  - data 2 x tensor 2: ``DataParallel.make_train_step`` with the tensor
    group's specs at ``sp=True`` wrapped in ``Telemetry``, 3 AdamW steps,
    under the overlap regimes ``'none'`` and ``'generic'``: each run's
    RUNREPORT, ``comm_ledger``, the ``tp_utils.COLLECTIVES`` deltas over
    the recorded (first) call and the losses;
  - on that layout's tensor group, each of ``tp_utils``' five helpers
    once, then an async all-reduce waited for after a shift;
  - pipe 2 x tensor 2: ``gpt_pipeline_1f1b`` with sharded transfers, one
    call under a ``CommRecorder``: its ledger;
  - data 2 x context 2: the ring GPT's loss and backward under a
    ``CommRecorder``: its ledger, and again with the ring shift's
    ``note`` taken out (a planted fault).
- ``parity`` (world 2, data 2): ``DataParallel`` exact and
  ``grad_compress='int8'``, 3 AdamW steps each under ``Telemetry``:
  each arm's RUNREPORT, the leaves' shapes.

Imports only the port (and numpy): never JAX.  Run as
``python tests/_torch_comm_ledger_worker.py JOB RANK WORLD INIT_METHOD
IN_NPZ OUT_DIR``.  :func:`start` / :func:`results` are the parent's
side.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from _torch_ep_worker import unflatten  # noqa: E402

#: the tiny GPT (f32, plain attention); ``ring`` its context-parallel form
GPT = dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=16,
           ffn_mult=2)
#: the int8 arm's GPT: leaves of 2048-4096 elements reach the ring
PARITY_GPT = dict(vocab_size=128, dim=32, nheads=4, nlayers=2, max_seq=16,
                  ffn_mult=2)
STEPS = 3
LR = 1e-2
ROWS = 8          # global batch rows
MICRO = 2         # the pipeline's microbatches
COMPRESS_MIN = 1024


def cfg_of(kw, **extra):
    from torchdistpackage_tpu_torch.models import GPTConfig

    return GPTConfig(**kw, dtype=torch.float32, **extra)


def subtree(inp, prefix):
    return unflatten({k[len(prefix):]: inp[k] for k in inp.files
                      if k.startswith(prefix)})


def batch_of(inp, prefix, i):
    return {k: torch.from_numpy(np.array(inp[f"{prefix}{i}/{k}"])).long()
            for k in ("tokens", "targets")}


def as_json(obj):
    return np.asarray(json.dumps(obj, default=str))


def dp_tp_run(inp, regime):
    """Data 2 x tensor 2 at ``sp=True`` under ``Telemetry``."""
    from torchdistpackage_tpu_torch.dist import overlap, tpc
    from torchdistpackage_tpu_torch.models import gpt_loss, params_from_jax
    from torchdistpackage_tpu_torch.models.gpt import gpt_param_specs
    from torchdistpackage_tpu_torch.obs import Telemetry
    from torchdistpackage_tpu_torch.obs.events import set_default_event_log
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        DataParallel,
        adamw,
    )
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        COLLECTIVES,
        PARTIAL_UNDER_SP,
    )
    from torchdistpackage_tpu_torch.parallel.zero import leaf_specs
    from torchdistpackage_tpu_torch.utils.partition import named_leaves

    overlap.configure(regime)
    group = tpc.get_group("tensor")
    cfg = cfg_of(GPT)
    params = params_from_jax(subtree(inp, "gpt/params/"), cfg, device="cpu",
                             tp_rank=tpc.get_group_rank("tensor"), tp_size=2)
    specs = gpt_param_specs(params)
    dp = DataParallel(bucket_cap_mb=0.01)
    params = dp.broadcast_params(params)
    opt = adamw(LR)
    state = opt.init(params)
    tel = Telemetry(run=f"tpdp-{regime}", device="cpu", report_path="",
                    trace_path="", tokens_per_step=ROWS * cfg.max_seq,
                    flops_per_token=6e4, peak_flops=1e12)
    step = tel.wrap_step(dp.make_train_step(
        lambda p, b: gpt_loss(p, b, cfg, tp_group=group, sp=True), opt,
        param_specs=specs, sp=True))
    losses, deltas = [], None
    for i in range(STEPS):
        before = dict(COLLECTIVES)
        params, state, loss, _ = step(
            params, state, dp.shard_batch(batch_of(inp, "gpt/batch", i),
                                          device="cpu"))
        if deltas is None:
            deltas = {k: COLLECTIVES[k] - before[k] for k in COLLECTIVES
                      if COLLECTIVES[k] != before[k]}
        tel.end_step(step=i, loss=loss)
        losses.append(float(loss))
    rep = tel.finalize(write=False, print_summary=False)
    set_default_event_log(None)
    overlap.configure("auto")
    leaves = [(name, list(p.shape), p.element_size(), s == PARTIAL_UNDER_SP)
              for (name, p), s in zip(named_leaves(params),
                                      leaf_specs(params, specs))]
    tag = f"tpdp_{regime}"
    return {f"{tag}/report": as_json(rep),
            f"{tag}/ledger": as_json(tel.comm_ledger),
            f"{tag}/collectives": as_json(deltas),
            f"{tag}/leaves": as_json(leaves),
            f"{tag}/losses": np.asarray(losses)}


def pipeline_run(inp):
    """Pipe 2 x tensor 2: one 1F1B call with sharded transfers."""
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.models import (
        gpt_pipeline_1f1b,
        params_from_jax,
    )
    from torchdistpackage_tpu_torch.obs.comm_ledger import CommRecorder

    tpc.setup_process_groups([("pipe", 2), ("tensor", 2)])
    s, t = tpc.get_group_rank("pipe"), tpc.get_group_rank("tensor")
    cfg = cfg_of(GPT)
    params = params_from_jax(subtree(inp, "gpt/params/"), cfg, device="cpu",
                             pp_rank=s, pp_size=2, tp_rank=t, tp_size=2)
    for leaf in _leaves(params):
        leaf.requires_grad_(True)
    b = batch_of(inp, "gpt/batch", 0)
    batch = {k: v[:MICRO * 2].reshape(MICRO, 2, -1) for k, v in b.items()}
    with CommRecorder() as rec:
        gpt_pipeline_1f1b(params, batch, cfg, MICRO,
                          tp_group=tpc.get_group("tensor"),
                          shard_transfers=True)
    return {"pipe/ledger": as_json(rec.ledger())}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def ring_run(inp):
    """Data 2 x context 2: the ring GPT's loss and backward on the rank's
    sequence shard."""
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.models import gpt_loss, params_from_jax
    from torchdistpackage_tpu_torch.obs.comm_ledger import CommRecorder

    tpc.setup_process_groups([("data", 2), ("context", 2)])
    c = tpc.get_group_rank("context")
    cfg = cfg_of(GPT, attn_impl="ring")
    params = params_from_jax(subtree(inp, "gpt/params/"), cfg, device="cpu")
    for leaf in _leaves(params):
        leaf.requires_grad_(True)
    b = batch_of(inp, "gpt/batch", 0)
    s = cfg.max_seq // 2
    shard = {k: v[:2, c * s:(c + 1) * s].contiguous() for k, v in b.items()}
    with CommRecorder() as rec:
        gpt_loss(params, shard, cfg, cp_group=tpc.get_group("context")
                 ).backward()
    out = {"ring/ledger": as_json(rec.ledger())}
    # the planted fault: the ring shift's note taken out
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import tp_utils

    real = tp_utils.note
    tp_utils.note = lambda op, *a, **k: (
        None if op == "collective-permute" else real(op, *a, **k))
    try:
        with CommRecorder() as rec:
            gpt_loss(params, shard, cfg, cp_group=tpc.get_group("context")
                     ).backward()
    finally:
        tp_utils.note = real
    out["ring_fault/ledger"] = as_json(rec.ledger())
    return out


def helpers_run():
    """Each of ``tp_utils``' five helpers once over the tensor group of
    data 2 x tensor 2, then an async all-reduce with a shift issued
    before its wait: the ledger, the ``COLLECTIVES`` deltas and the
    operand sizes."""
    from torchdistpackage_tpu_torch.dist import overlap, tpc
    from torchdistpackage_tpu_torch.obs.comm_ledger import CommRecorder
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import tp_utils

    overlap.configure("generic")
    g = tpc.get_group("tensor")
    x = torch.arange(2 * 6 * 4, dtype=torch.float32).reshape(2, 6, 4)
    before = dict(tp_utils.COLLECTIVES)
    with CommRecorder() as rec:
        tp_utils._all_reduce(x, g, "reduce_from_tp")
        tp_utils._start_all_gather(x, g, 1, "gather_from_sp")()
        tp_utils._reduce_scatter(x, g, 1, "scatter_to_sp")
        tp_utils._shift(x, g, 1, "ring_shift")
        tp_utils._all_to_all(x.reshape(2, -1), g)
        tp_utils._count("zero_all_reduce")  # as its callers count it
        wait = tp_utils.start_all_reduce(x.clone(), g, name="zero_all_reduce")
        tp_utils._shift(x, g, 1, "ring_shift")
        wait()
    deltas = {k: v - before[k] for k, v in tp_utils.COLLECTIVES.items()
              if v != before[k]}
    return {"helpers/ledger": as_json(rec.ledger()),
            "helpers/collectives": as_json(deltas),
            "helpers/nbytes": np.asarray(x.numel() * x.element_size())}


def ledger_job(inp, rank, world):
    from torchdistpackage_tpu_torch.dist import tpc

    out = {}
    tpc.setup_process_groups([("data", 2), ("tensor", 2)])
    for regime in ("none", "generic"):
        out.update(dp_tp_run(inp, regime))
    out.update(helpers_run())
    out.update(pipeline_run(inp))
    out.update(ring_run(inp))
    return out


def parity_job(inp, rank, world):
    """Data 2: the exact and the int8 DP arms under ``Telemetry``."""
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.models import gpt_loss, params_from_jax
    from torchdistpackage_tpu_torch.obs import Telemetry
    from torchdistpackage_tpu_torch.obs.events import set_default_event_log
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        DataParallel,
        adamw,
    )
    from torchdistpackage_tpu_torch.utils.partition import named_leaves

    tpc.setup_process_groups([("data", world)])
    cfg = cfg_of(PARITY_GPT)
    out = {}
    for arm, opts in (("exact", {}),
                      ("int8", {"grad_compress": "int8",
                                "compress_min_size": COMPRESS_MIN})):
        params = params_from_jax(subtree(inp, "pgpt/params/"), cfg,
                                 device="cpu")
        dp = DataParallel(**opts)
        opt = adamw(LR)
        state = opt.init(params)
        tel = Telemetry(run=arm, device="cpu", report_path="",
                        trace_path="", tokens_per_step=ROWS * cfg.max_seq,
                        flops_per_token=6e4, peak_flops=1e12)
        step = tel.wrap_step(dp.make_train_step(
            lambda p, b: gpt_loss(p, b, cfg), opt, numerics=True))
        for i in range(STEPS):
            params, state, loss, stats = step(
                params, state, dp.shard_batch(batch_of(inp, "pgpt/batch", i),
                                              device="cpu"))
            tel.end_step(step=i, loss=loss, numerics=stats)
        rep = tel.finalize(write=False, print_summary=False)
        set_default_event_log(None)
        out[f"{arm}/report"] = as_json(rep)
    out["leaves"] = as_json([(name, list(p.shape), p.element_size())
                             for name, p in named_leaves(params)])
    return out


JOBS = {"ledger": ledger_job, "parity": parity_job}


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
    """Each rank's outputs, once every process has exited 0; JSON
    entries decoded."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    out = []
    for r in range(len(procs)):
        got = dict(np.load(tmp / f"rank{r}.npz"))
        out.append({k: json.loads(str(v)) if v.dtype.kind == "U" else v
                    for k, v in got.items()})
    return out


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
