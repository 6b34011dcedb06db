"""The port's in-step numerics against the JAX package's, on the CPU.

- ``obs.numerics.numerics_stats`` against JAX's on seeded trees (a list
  of blocks beside dict leaves) with planted values: tiny, f16-overflow
  huge, zero and dead-zone gradient entries, and a NaN; every key, the
  per-group sub-dicts included.  XLA on the CPU flushes f32 subnormals
  to zero, so JAX's ``bf16_underflow_frac`` (nonzero values below the
  f32 smallest normal: subnormals only) reads 0 whatever the grads; the
  port counts them, and that count is held against numpy's.
- ``make_train_step`` and ``DataParallel.make_train_step`` with
  ``numerics=True`` against JAX's ``DataParallel.make_train_step(
  numerics=True)`` on a one-device mesh, on a 2-layer GPT in f32 and the
  same numpy-seeded batches: every key of every step.

- One spawned two-rank gloo world (``tests/_torch_resilience_worker.py``,
  started before JAX's reference is computed): ``make_train_step(
  numerics=True)`` over a two-rank tensor group against the same JAX
  run (split leaves summed over the group), and the checkpoint layer
  across processes — a step one rank sees corrupt is condemned on both
  and renamed by process 0 alone (with the agreement taken out, the
  ranks resume apart).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchdistpackage_tpu.dist import tpc as jtpc
from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import gpt_loss as jgpt_loss
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.obs import numerics as jnum
from torchdistpackage_tpu.parallel.data_parallel import DataParallel as JDP
from torchdistpackage_tpu_torch.models import GPTConfig, gpt_loss
from torchdistpackage_tpu_torch.models.convert import params_from_jax
from torchdistpackage_tpu_torch.obs import default_group_fn, numerics_stats
from torchdistpackage_tpu_torch.parallel.data_parallel import (
    DataParallel,
    adamw,
    make_train_step,
)

sys.path.insert(0, str(Path(__file__).parent))
import _torch_resilience_worker as W  # noqa: E402
from _torch_ep_worker import flatten  # noqa: E402

WORKER = str(Path(__file__).parent / "_torch_resilience_worker.py")

#: f32 over the same values summed in other orders
STATS_TOL = dict(rtol=2e-6, atol=0.0)
GPT = dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=16,
           ffn_mult=2)
LR, STEPS, BATCH = 1e-2, 2, 2
#: two frameworks' f32 training steps: grads agree to ~1e-6 of their
#: scale; the port's update is p_after - p_before (the reference's the
#: optimizer's output), a rounding of the leaf apart, so the update norms
#: agree to ~1e-5
STEP_TOL = {"update_norm": 1e-4, "update_ratio": 1e-4}
STEP_RTOL = 2e-5


def _flat(stats, prefix=""):
    """A (nested) stats dict -> ``{key: float}``."""
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = float(np.asarray(v))
    return out


def _trees(seed, nan):
    """Grads, params and updates: ``{'emb', 'blocks': [2 x {'w', 'b'}],
    'head': {'w'}}`` in f32 with planted tiny / huge / zero entries."""
    rs = np.random.RandomState(seed)

    def tree(scale):
        t = {"emb": rs.standard_normal((6, 4)) * scale,
             "blocks": [{"w": rs.standard_normal((4, 5)) * scale,
                         "b": rs.standard_normal((5,)) * scale}
                        for _ in range(2)],
             "head": {"w": rs.standard_normal((4, 3)) * scale}}
        return jax.tree.map(lambda a: a.astype(np.float32), t)

    g = tree(1e-3)
    g["emb"][0, :2] = 1e-30           # tiny, still an f32 normal
    g["blocks"][1]["w"][2, 3] = 7e4   # over f16's max
    g["blocks"][0]["b"][:2] = 0.0     # zeros count in no fraction
    g["head"]["w"][1, 1] = 1e-9       # inside the int8 dead zone
    if nan:
        g["blocks"][0]["w"][1, 1] = np.nan
    return g, tree(1.0), tree(1e-2)


def _torch_tree(t):
    return jax.tree.map(torch.from_numpy, t)


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_numerics_stats_matches_jax(seed, nan):
    g, p, u = _trees(seed, nan)
    want = _flat(jnum.numerics_stats(jax.tree.map(jnp.asarray, g),
                                     jax.tree.map(jnp.asarray, p),
                                     jax.tree.map(jnp.asarray, u)))
    got = _flat(numerics_stats(_torch_tree(g), _torch_tree(p),
                               _torch_tree(u)))
    assert set(got) == set(want)
    assert {k[len("groups/"):].rsplit("/", 1)[0] for k in got
            if k.startswith("groups/")} == {
        "emb", "blocks/0", "blocks/1", "head"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], equal_nan=True,
                                   err_msg=k, **STATS_TOL)
    assert got["f16_overflow_frac"] > 0 and got["int8_zero_frac"] > 0
    assert got["nonfinite_grads"] == float(nan)
    # f32 subnormals: nonzero and under bf16's smallest normal
    g["emb"][0, :2] = 1e-40
    flat = np.concatenate([a.ravel() for a in jax.tree.leaves(g)])
    want_under = np.sum((np.abs(flat) > 0) & (np.abs(flat) < 1.17549435e-38))
    got_under = float(numerics_stats(_torch_tree(g))["bf16_underflow_frac"])
    assert want_under == 2 and got_under == np.float32(2 / flat.size)
    # without updates: no update keys; without params: no ratio
    part = numerics_stats(_torch_tree(g))
    assert "param_norm" not in part and "update_ratio" not in part
    assert default_group_fn(("blocks", 3, "w")) == "blocks/3"
    assert default_group_fn(()) == "params"


def batches_of(gpt):
    rs = np.random.RandomState(7)
    shape = (BATCH, gpt["max_seq"])
    return [{"tokens": rs.randint(0, gpt["vocab_size"], shape).astype(
                 np.int32),
             "targets": rs.randint(0, gpt["vocab_size"], shape).astype(
                 np.int32)}
            for _ in range(STEPS)]


def jax_numerics_run(batches):
    """JAX's ``DataParallel.make_train_step(numerics=True)`` on a
    one-device data mesh over ``batches``: the initial params (numpy) and
    each step's flattened stats."""
    jcfg = JGPTConfig(**GPT, dtype=jnp.float32)
    params = jinit(jax.random.PRNGKey(0), jcfg)
    init = jax.tree.map(np.asarray, params)
    jtpc.reset()
    jtpc.setup_process_groups([("data", 1)], devices=jax.devices()[:1])
    try:
        opt = optax.adamw(LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
        dp = JDP()
        step = dp.make_train_step(lambda q, b: jgpt_loss(q, b, jcfg), opt,
                                  numerics=True, donate=False)
        state = opt.init(params)
        stats = []
        for b in batches:
            params, state, loss, st = step(
                params, state, dp.shard_batch(jax.tree.map(jnp.asarray, b)))
            stats.append(_flat(st))
    finally:
        jtpc.reset()
    return init, stats


#: the GPT's parameter count, and the key bias's part of it: that bias's
#: grad is zero in exact arithmetic (softmax ignores a per-row constant),
#: so its entries are rounding noise that lands in or out of the int8
#: dead zone as the summation order has it
N_ELEMS = 21760
KEY_BIAS = GPT["nlayers"] * GPT["dim"]


def assert_step_stats(got, want, what, frac_elems=1):
    """One step's stats against JAX's within the tolerances above; the
    fractions within ``frac_elems`` elements' share."""
    assert set(got) == set(want), what
    for k, w in want.items():
        leaf = k.split("/")[-1]
        if leaf.endswith("_frac"):
            assert abs(got[k] - w) <= (frac_elems + 0.01) / N_ELEMS, \
                f"{what} {k}"
            continue
        np.testing.assert_allclose(got[k], w,
                                   rtol=STEP_TOL.get(leaf, STEP_RTOL),
                                   atol=1e-12, err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's run, and the two-rank world started before it: ``(init,
    batches, JAX's stats a step, each rank's outputs)``."""
    tmp = tmp_path_factory.mktemp("numerics2")
    batches = batches_of(GPT)
    init = jax.tree.map(np.asarray, jinit(
        jax.random.PRNGKey(0), JGPTConfig(**GPT, dtype=jnp.float32)))
    inputs = {f"params/{k}": v for k, v in flatten(init).items()}
    for i, b in enumerate(batches):
        inputs.update({f"batch{i}/{k}": v for k, v in b.items()})
    inputs["dir"] = np.asarray(str(tmp / "ckpt"))
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", f"file://{tmp / 'store'}",
         str(tmp / "in.npz"), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(2)]
    try:
        jinit_np, stats = jax_numerics_run(batches)
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    assert sum(a.size for a in jax.tree.leaves(init)) == N_ELEMS
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return jinit_np, batches, stats, ranks


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo group in this process for the test's length."""
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import init_distributed, tpc

    init_distributed(f"file://{tmp_path / 'store'}", 1, 0, "cpu")
    try:
        tpc.setup_process_groups([("data", 1)])
        yield tpc
    finally:
        tpc.reset()
        dist.destroy_process_group()


@pytest.mark.parametrize("path", ["make_train_step", "DataParallel"])
def test_train_step_numerics_matches_jax(jax_run, path, request):
    if path == "DataParallel":
        request.getfixturevalue("world1")
    init, batches, want, _ = jax_run
    cfg = GPTConfig(**GPT, dtype=torch.float32)
    params = params_from_jax(init, cfg, device="cpu")
    opt = adamw(LR)
    state = opt.init(params)
    loss_fn = lambda q, b: gpt_loss(q, b, cfg)  # noqa: E731
    if path == "make_train_step":
        step = make_train_step(loss_fn, opt, numerics=True)
    else:
        step = DataParallel().make_train_step(loss_fn, opt, numerics=True)
    for i, b in enumerate(batches):
        tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
        params, state, _, stats = step(params, state, tb)
        assert_step_stats(_flat(stats), want[i], f"step {i}")


# ------------------------------------------------------- two-rank world


def test_tp_numerics_two_ranks_match_jax(jax_run):
    _, _, want, ranks = jax_run
    for r, out in enumerate(ranks):
        for i in range(W.STEPS):
            got = {k[len(f"tp/{i}/"):]: float(v) for k, v in out.items()
                   if k.startswith(f"tp/{i}/")}
            # the TP step sums the key bias's noise in another order
            assert_step_stats(got, want[i], f"rank {r} step {i}",
                              frac_elems=KEY_BIAS)


def test_two_ranks_condemn_a_step_one_rank_sees_corrupt(jax_run):
    """The checkpoint layer across two processes (in this world because
    it is the one world of the slice's tests)."""
    ranks = jax_run[3]
    for r, out in enumerate(ranks):
        assert list(out["agreed/files"]) == [
            "0/meta.json", "0/rank0.pt", "0/rank1.pt", "1/meta.json",
            "1/rank0.pt", "1/rank1.pt"]
        assert int(out["agreed/start"]) == 1
        assert int(out["agreed/offset"]) == 0
        assert list(out["agreed/w"]) == [10.0 * r] * 4
        assert list(out["agreed/quarantined"]) == [1]
        assert list(out["agreed/renamed"]) == [r == 0]
        assert list(out["agreed/steps_after"]) == [0]
    # the verdict not agreed (a planted fault): the ranks resume apart
    assert [int(o["planted/start"]) for o in ranks] == [2, 1]
