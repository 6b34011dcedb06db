"""One rank of the port's two-rank resilience and numerics runs on the
CPU, for tests/test_torch_numerics.py — not a pytest file.

The parent writes the inputs (numpy arrays) to an ``.npz`` and starts
two copies of this script; each joins a gloo process group through a
``file://`` rendezvous, runs every job and writes ``rank<r>.npz``.

- ``ckpt``: a ``GuardedCheckpointManager`` on a directory both ranks
  share saves steps 0 and 1 (each rank its own ``rank<r>.pt``, process 0
  commits); then rank 1 alone sees step 1 corrupt (its view of the file
  hashes is wrong, as a flaky mount would give), and ``auto_resume``
  must condemn step 1 on both ranks, rename it on process 0 only and
  resume both from step 0.  Run again with ``utils.checkpoint._pod_any``
  replaced by the rank's own verdict (a planted fault): the ranks then
  resume from different steps.
- ``tp_numerics``: ``make_train_step(numerics=True)`` on a tiny GPT split
  over a two-rank tensor group (``params_from_jax`` at ``tp_rank``), two
  AdamW steps: each step's stats, which must be the whole model's.

Imports only the port (and numpy): never JAX.  Run as
``python tests/_torch_resilience_worker.py RANK WORLD INIT_METHOD IN_NPZ
OUT_DIR``.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from _torch_ep_worker import unflatten  # noqa: E402

#: the tiny GPT of the TP numerics job (f32, plain attention)
GPT = dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=16,
           ffn_mult=2)
LR, STEPS = 1e-2, 2


def stats_flat(stats, prefix):
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            out.update(stats_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(float(v))
    return out


def ckpt_job(inp, rank, world):
    from torchdistpackage_tpu_torch.obs import EventLog, set_default_event_log
    from torchdistpackage_tpu_torch.resilience import (
        GuardedCheckpointManager,
        ckpt_guard,
    )
    from torchdistpackage_tpu_torch.utils import checkpoint

    out = {}
    real_sha, real_any = ckpt_guard._sha256, checkpoint._pod_any
    for case in ("agreed", "planted"):
        log = EventLog()
        set_default_event_log(log)
        d = os.path.join(str(inp["dir"]), case)
        payload = lambda s: {  # noqa: E731
            "params": {"w": torch.full((4,), float(10 * rank + s))},
            "loop": {"data_offset": s}}
        with GuardedCheckpointManager(d, max_to_keep=4) as mgr:
            for s in range(2):
                mgr.save(s, payload(s), wait=True)
            out[f"{case}/files"] = np.asarray(sorted(
                f"{s}/{f}" for s in ("0", "1")
                for f in os.listdir(os.path.join(d, s))))
            if rank == 1:
                def sha(path, chunk=1 << 20):
                    bad = os.path.basename(os.path.dirname(path)) == "1"
                    return "0" * 64 if bad else real_sha(path, chunk)
                ckpt_guard._sha256 = sha
            if case == "planted":
                checkpoint._pod_any = lambda flag, n: bool(flag)
            try:
                template = payload(0)
                template["params"]["w"].zero_()
                start, state = checkpoint.auto_resume(mgr, template)
            finally:
                ckpt_guard._sha256 = real_sha
                checkpoint._pod_any = real_any
        out[f"{case}/start"] = np.asarray(start)
        out[f"{case}/w"] = state["params"]["w"].numpy()
        out[f"{case}/offset"] = np.asarray(state["loop"]["data_offset"])
        quar = log.of_kind("ckpt_quarantine")
        out[f"{case}/quarantined"] = np.asarray([e["step"] for e in quar])
        out[f"{case}/renamed"] = np.asarray(
            [e["quarantined_to"] is not None for e in quar])
        torch.distributed.barrier()
        out[f"{case}/steps_after"] = np.asarray(mgr.all_steps())
    set_default_event_log(None)
    return out


def tp_numerics_job(inp, rank, world):
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.models import (
        GPTConfig,
        gpt_loss,
        params_from_jax,
    )
    from torchdistpackage_tpu_torch.models.gpt import gpt_param_specs
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        adamw,
        make_train_step,
    )

    tpc.setup_process_groups([("tensor", world)])
    try:
        cfg = GPTConfig(**GPT, dtype=torch.float32)
        group = tpc.get_group("tensor")
        params = params_from_jax(
            unflatten({k[len("params/"):]: inp[k] for k in inp.files
                       if k.startswith("params/")}),
            cfg, device="cpu", tp_rank=rank, tp_size=world)
        opt = adamw(LR)
        state = opt.init(params)
        step = make_train_step(
            lambda p, b: gpt_loss(p, b, cfg, tp_group=group), opt,
            numerics=True, param_specs=gpt_param_specs(params),
            tp_group=group)
        out = {}
        for i in range(STEPS):
            batch = {k: torch.from_numpy(inp[f"batch{i}/{k}"]).long()
                     for k in ("tokens", "targets")}
            params, state, _, stats = step(params, state, batch)
            out.update(stats_flat(stats, f"tp/{i}/"))
        return out
    finally:
        tpc.reset()


def main(rank, world, init_method, in_npz, out_dir):
    from torchdistpackage_tpu_torch.dist import init_distributed

    torch.set_num_threads(1)
    init_distributed(init_method, world, rank, "cpu")
    import torch.distributed as dist

    try:
        inp = np.load(in_npz)
        out = {}
        for job in (ckpt_job, tp_numerics_job):
            out.update(job(inp, rank, world))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, init, src, dst = sys.argv[1:6]
    main(int(r), int(w), init, src, dst)
