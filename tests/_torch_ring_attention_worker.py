"""One rank of the port's context-parallel attention on the CPU, for
tests/test_torch_ring_attention.py — not a pytest file.

The parent writes the inputs (numpy, from a seed) to an ``.npz`` and
starts 4 copies of this script, one a rank; each joins a gloo group
through a ``file://`` rendezvous (a 120 s timeout, so a rank that
enters a different send fails instead of hanging), runs every case of
:data:`CASES` in order and writes ``rank<r>.npz``: its shard of the
output and of the grads of q, k, v for the cotangent ``do``.  A cp-4
case runs over the world, a cp-2 case over the pairs {0, 1} and {2, 3}
(both on the same inputs).  The fault case drops the lse cotangent of
every ring hop (the hop's lse detached): its grads must miss.

Imports only the port (and numpy): never JAX.  Run as
``python tests/_torch_ring_attention_worker.py RANK WORLD INIT_METHOD
IN_NPZ OUT_DIR``.  :func:`start` / :func:`results` are the parent's
side, shared by the other context-parallel test files.
"""

import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

WORLD = 4
B, H, S, D = 2, 8, 32, 16
#: name -> (impl, causal, layout, kv heads, cp); impl 'ring' (flash
#: bodies), 'einsum' (the golden bodies) or 'ulysses'
CASES = {
    "ring_causal_cp4": ("ring", True, "contiguous", H, 4),
    "ring_noncausal_cp4": ("ring", False, "contiguous", H, 4),
    "ring_zigzag_cp4": ("ring", True, "zigzag", H, 4),
    "ring_zigzag_noncausal_cp4": ("ring", False, "zigzag", H, 4),
    "ring_gqa_cp4": ("ring", True, "contiguous", 2, 4),
    "ring_zigzag_gqa_cp4": ("ring", True, "zigzag", 2, 4),
    "einsum_causal_cp4": ("einsum", True, "contiguous", H, 4),
    "einsum_noncausal_cp4": ("einsum", False, "contiguous", H, 4),
    "einsum_zigzag_cp4": ("einsum", True, "zigzag", H, 4),
    "einsum_gqa_cp4": ("einsum", True, "contiguous", 2, 4),
    "ulysses_causal_cp4": ("ulysses", True, "contiguous", H, 4),
    "ulysses_noncausal_cp4": ("ulysses", False, "contiguous", H, 4),
    "ulysses_gqa_cp4": ("ulysses", True, "contiguous", 4, 4),
    "ring_causal_cp2": ("ring", True, "contiguous", H, 2),
    "ring_zigzag_cp2": ("ring", True, "zigzag", H, 2),
    "ring_gqa_cp2": ("ring", True, "contiguous", 2, 2),
    "einsum_zigzag_cp2": ("einsum", True, "zigzag", H, 2),
    "ulysses_causal_cp2": ("ulysses", True, "contiguous", H, 2),
    "ulysses_gqa_cp2": ("ulysses", False, "contiguous", 2, 2),
}
#: the planted fault: ring_causal_cp4 with every hop's lse detached
FAULT = "fault_no_dlse_cp4"


def ring_module():
    """``ops/ring_attention.py`` (the ``ops`` package exports a function
    of the same name)."""
    import importlib

    return importlib.import_module(
        "torchdistpackage_tpu_torch.ops.ring_attention")


def run_case(inp, name, spec, group):
    import torch.distributed as dist

    ra = ring_module()

    impl, causal, layout, kv, cp = spec
    r = dist.get_rank(group)
    s = S // cp
    q, k, v, do = (torch.from_numpy(np.array(inp[f"{kv}/{n}"]))
                   for n in ("q", "k", "v", "do"))
    if layout == "zigzag":
        q, k, v, do = (ra.zigzag_permute(t, cp, seq_dim=2)
                       for t in (q, k, v, do))
    q, k, v = (t[:, :, r * s:(r + 1) * s].clone().requires_grad_()
               for t in (q, k, v))
    do = do[:, :, r * s:(r + 1) * s].contiguous()
    if impl == "ulysses":
        out = ra.ulysses_attention(q, k, v, group=group, causal=causal)
    else:
        out = ra.ring_attention(q, k, v, group=group, causal=causal,
                                use_flash=impl == "ring", layout=layout)
    grads = torch.autograd.grad(out, (q, k, v), do)
    return {f"{name}/{n}": t.detach().numpy()
            for n, t in zip(("out", "dq", "dk", "dv"), (out,) + grads)}


def main(rank, world, init_method, in_npz, out_dir):
    import datetime

    import torch.distributed as dist

    ra = ring_module()

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        inp = np.load(in_npz)
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        groups = {4: dist.group.WORLD, 2: pairs[rank // 2]}
        out = {}
        for name, spec in CASES.items():
            out.update(run_case(inp, name, spec, groups[spec[-1]]))
        real = ra.flash_attention_with_lse
        ra.flash_attention_with_lse = lambda *a, **kw: (
            lambda o, lse: (o, lse.detach()))(*real(*a, **kw))
        try:
            out.update(run_case(inp, FAULT, CASES["ring_causal_cp4"],
                                groups[4]))
        finally:
            ra.flash_attention_with_lse = real
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def start(script, inputs, tmp, world=WORLD):
    """The parent's side: write ``inputs`` and start ``world`` copies of
    ``script``; returns the processes (:func:`results` waits)."""
    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, script, str(r), str(world),
         f"file://{tmp / 'store'}", str(tmp / "in.npz"), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(world)]


def results(procs, tmp, timeout=240):
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


if __name__ == "__main__":
    r, w, init, src, dst = sys.argv[1:6]
    main(int(r), int(w), init, src, dst)
