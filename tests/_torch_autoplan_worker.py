"""One rank of the planner's executable side on the CPU, for
tests/test_torch_autoplan.py — not a pytest file.

The parent writes the inputs (numpy arrays: the tiny GPT's parameters
from JAX's init and one global batch; the plan keys to run, as JSON) to
an ``.npz`` and starts 4 copies of this script, one a rank; every copy
joins a gloo group through a ``file://`` rendezvous (a 120 s timeout),
plans the tiny GPT for 4 chips as the parent did (``executable_only``,
the same comm model and FLOP/s), and for each key builds the plan's
process groups (``build_groups``) and its step (``make_plan_step``) on
the whole tree, runs one AdamW step on the global batch, and writes the
step's loss and wall seconds to ``rank<r>.npz``.

Imports only the port (and numpy): never JAX.  Run as
``python tests/_torch_autoplan_worker.py RANK WORLD INIT_METHOD IN_NPZ
OUT_DIR``.  :func:`start` / :func:`results` are the parent's side.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from _torch_ep_worker import unflatten  # noqa: E402

#: the reference's ``tests/test_autoplan.py`` TINY (f32, plain attention)
TINY = dict(vocab_size=512, dim=128, nheads=4, nlayers=4, max_seq=128,
            ffn_mult=2)
CHIPS, BATCH = 4, 8
#: the calibrated CPU-shaped link parameters of the reference's test
ALPHA_S, BETA_BPS = 50e-6, 1e9
EFFECTIVE_FLOPS = 5e12


def cpu_model(axis_cost, comm_model):
    """The same calibrated model built from either package's classes."""
    c = axis_cost(ALPHA_S, BETA_BPS, "calibrated")
    return comm_model({"data": c, "tensor": c, "pipe": c}, default=c,
                      chip="cpu-sim", source="calibrated")


def tiny_plan(ap, config, comm_model, **kw):
    return ap.plan(config, CHIPS, BATCH, comm_model=comm_model,
                   effective_flops=EFFECTIVE_FLOPS, executable_only=True,
                   emit=False, top=64, **kw)


def run(inp, rank, world):
    from torchdistpackage_tpu_torch.dist import autoplan as ap
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.models import GPTConfig, params_from_jax
    from torchdistpackage_tpu_torch.obs.comm_model import AxisCost, CommModel

    cfg = GPTConfig(**TINY, dtype=torch.float32)
    plan = tiny_plan(ap, cfg, cpu_model(AxisCost, CommModel))
    cands = {c["key"]: c for c in plan["ranked"]}
    flat = {k[len("params/"):]: v for k, v in inp.items()
            if k.startswith("params/")}
    batch = {k: torch.from_numpy(inp[f"batch/{k}"]).long()
             for k in ("tokens", "targets")}
    out = {}
    for key in json.loads(str(inp["keys"])):
        c = cands[key]
        ctx = ap.build_groups(c, tpc)
        params = params_from_jax(unflatten(flat), cfg, device="cpu")
        run_ = ap.make_plan_step(c, cfg, ctx, params=params)
        t0 = time.perf_counter()
        _, _, loss, gnorm = run_.step(run_.params, run_.opt_state, batch)
        loss = float(loss)
        out[f"{key}/loss"] = np.float64(loss)
        out[f"{key}/gnorm"] = np.float64(float(gnorm))
        out[f"{key}/seconds"] = np.float64(time.perf_counter() - t0)
        tpc.reset()
    return out


def start(world, inputs, tmp):
    """The parent's side: write ``inputs``, start ``world`` ranks;
    returns the processes (:func:`results` waits for them)."""
    import subprocess

    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
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


def main(rank, world, init_method, in_npz, out_dir):
    import datetime

    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import tpc

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = run(np.load(in_npz), rank, world)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        tpc.reset()
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, init, src, dst = sys.argv[1:6]
    main(int(r), int(w), init, src, dst)
