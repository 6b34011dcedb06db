"""The port's topology, launch and utilities against the JAX package's,
on the CPU, in one process.

- ``ParallelContext``: a layout set up with ``world_size`` and ``rank``
  (no ``torch.distributed``: the layout and rank queries, no groups),
  its ``ranks_in_axis`` and every rank's coordinates against JAX's
  ``tpc`` on the 8 CPU devices, for ``[('data', 2), ('pipe', 2),
  ('tensor', 2)]``, a ``-1`` config and the MoE and hybrid views; the
  same ``ValueError`` cases.
- ``setup_distributed`` under a monkeypatched environment (SLURM,
  torchrun, a single process; the precedence, the idempotence, the
  ``scontrol``-less node-list expansion), ``init_distributed`` recorded
  instead of run.
- ``partition_params``, ``shard_batch`` and ``microbatch`` against
  JAX's; the integer hash behind ``fold_in`` in processes of different
  ``PYTHONHASHSEED``; ``axis_unique_key`` by coordinate.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from torchdistpackage_tpu.dist import ParallelContext as JContext
from torchdistpackage_tpu.dist import launch as jlaunch
from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.utils import microbatch as jmicrobatch
from torchdistpackage_tpu.utils import partition_params as jpartition
from torchdistpackage_tpu.utils import shard_batch as jshard_batch
from torchdistpackage_tpu_torch.dist import ParallelContext, launch, tpc
from torchdistpackage_tpu_torch.models import GPTConfig, params_from_jax
from torchdistpackage_tpu_torch.utils import (
    axis_unique_key,
    fix_rand,
    fold_in,
    microbatch,
    partition_params,
    per_axis_keys,
    shard_batch,
    split,
)

LAYOUTS = {
    "dpt": [("data", 2), ("pipe", 2), ("tensor", 2)],
    "infer": [("data", -1), ("tensor", 2)],
    "tensor_outer": [("tensor", 2), ("data", 4)],
}


def _port(config, rank=0, world=8):
    ctx = ParallelContext()
    ctx.setup_process_groups(config, world_size=world, rank=rank)
    return ctx


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_ranks_in_axis_and_coords_match_jax(devices8, name):
    config = LAYOUTS[name]
    jctx = JContext()
    jctx.setup_process_groups(config, devices=devices8)
    ctx = _port(config)
    assert ctx.axis_names == jctx.axis_names
    for axis in ctx.axis_names:
        assert ctx.ranks_in_axis(axis) == jctx.ranks_in_axis(axis), axis
        assert ctx.get_group_size(axis) == jctx.get_group_size(axis)
    for r in range(8):
        assert _port(config, r).coords() == jctx.device_coords(devices8[r])
    for what in ("get_dp_size", "get_tp_size", "get_pp_size", "get_mp_size",
                 "model_axes", "is_using_pp"):
        assert getattr(ctx, what)() == getattr(jctx, what)(), what
    for mode in ("data", "pipe", "tensor", "model"):
        assert ctx.is_mode_inited(mode) == jctx.is_mode_inited(mode), mode
    assert ctx.data_axes() == jctx.data_axes()


@pytest.mark.parametrize("view", ["moe", "hybrid"])
def test_views_match_jax(devices8, view):
    jctx = JContext()
    jctx.setup_process_groups([("data", 8)], devices=devices8)
    ctx = _port([("data", 8)], rank=5)
    if view == "moe":
        jctx.build_moe_mesh(moe_ep_size=4)
        ctx.build_moe_mesh(moe_ep_size=4)
        axes = ("moe_dp", "moe_ep")
    else:
        jctx.build_hybrid_mesh(intra_size=4)
        ctx.build_hybrid_mesh(intra_size=4)
        axes = ("data_inter", "data_intra")
    for axis in axes:
        assert ctx.ranks_in_axis(axis) == jctx.ranks_in_axis(axis), axis
        assert ctx.get_group_size(axis) == jctx.get_group_size(axis)
    assert ctx.data_axes(view) == jctx.data_axes(view) == axes
    # rank 5 = (1, 1) in both views; the flattened pair is its data rank
    assert [ctx.get_group_rank(a) for a in axes] == [1, 1]
    assert ctx.get_group_rank(axes) == ctx.get_dp_rank() == 5


def test_rank_queries_and_predicates():
    ctx = _port(LAYOUTS["dpt"], rank=6)  # (data 1, pipe 1, tensor 0)
    assert (ctx.get_dp_rank(), ctx.get_pp_rank(), ctx.get_tp_rank()) == (
        1, 1, 0)
    assert ctx.is_first_in_group("tensor") and not ctx.is_last_in_group(
        "tensor")
    assert ctx.is_last_in_pipeline_group()
    assert not ctx.is_first_in_pipeline_group()
    assert ctx.get_group_size("global") == 8
    assert ctx.get_group_size(("pipe", "tensor")) == 4
    assert ctx.get_group_rank(("pipe", "tensor")) == 2
    with pytest.raises(RuntimeError, match="no process groups"):
        ctx.get_group("data")
    ctx.reset()
    assert not ctx.is_initialized


def test_bad_configs_raise_as_jax(devices8):
    bad = [[("data", 3), ("tensor", 2)], [("data", -1), ("tensor", -1)],
           [("data", 4), ("data", 2)], [("data", 3), ("tensor", -1)]]
    for config in bad:
        with pytest.raises(ValueError):
            JContext().setup_process_groups(config, devices=devices8)
        with pytest.raises(ValueError):
            _port(config)
    with pytest.raises(RuntimeError, match="init_distributed"):
        ParallelContext().setup_process_groups([("data", 8)])
    with pytest.raises(ValueError):
        _port([("data", 8)]).build_moe_mesh(moe_ep_size=3)


# --------------------------------------------------------------- launch


ENV_KEYS = ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_NODELIST",
            "SLURM_LOCALID", "RANK", "WORLD_SIZE", "MASTER_ADDR",
            "MASTER_PORT", "LOCAL_RANK")


@pytest.fixture
def launched(monkeypatch):
    """``setup_distributed`` with a clean environment, a fresh
    initialised flag, no ``scontrol`` and ``init_distributed`` recorded
    instead of run."""
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(launch, "_INITIALIZED", False)
    calls = []
    monkeypatch.setattr(launch, "init_distributed",
                        lambda *a: calls.append(a))

    def no_scontrol(*a, **k):
        raise FileNotFoundError("scontrol")

    monkeypatch.setattr(launch.subprocess, "run", no_scontrol)
    return calls


def test_setup_distributed_from_slurm(launched, monkeypatch):
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_NTASKS", "8")
    monkeypatch.setenv("SLURM_NODELIST", "node[01-08],x")
    monkeypatch.setenv("SLURM_LOCALID", "1")
    monkeypatch.setenv("MASTER_PORT", "2345")
    # torchrun's variables too: SLURM comes first, as in the reference
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    launch.setup_distributed()
    assert launched == [("tcp://node01:2345", 8, 3, torch.device("cuda", 1))]
    launch.setup_distributed()  # idempotent
    assert len(launched) == 1


def test_setup_distributed_from_torchrun(launched, monkeypatch):
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.5")
    monkeypatch.setenv("LOCAL_RANK", "1")
    launch.setup_distributed(port=29500, device="cpu")
    assert launched == [("tcp://10.0.0.5:29500", 4, 1, "cpu")]


def test_setup_distributed_single_process(launched, monkeypatch):
    monkeypatch.setenv("SLURM_PROCID", "0")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    launch.setup_distributed()
    assert launched == [] and launch._INITIALIZED
    launch.setup_distributed()
    assert launched == []


@pytest.mark.parametrize("nodelist", ["node[01-08],x", "host1,host2",
                                      "gpu[3,5-7]", "solo"])
def test_slurm_master_addr_matches_jax(launched, monkeypatch, nodelist):
    monkeypatch.setattr(jlaunch.subprocess, "run", launch.subprocess.run)
    assert launch._slurm_master_addr(nodelist) == \
        jlaunch._slurm_master_addr(nodelist)
    assert launch.find_free_port() > 0


# ------------------------------------------------------------------ utils


@pytest.mark.parametrize("n", [1, 3, 5])
def test_partition_params_matches_jax(n):
    jcfg = JGPTConfig(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=16,
                      dtype=jnp.float32)
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp),
                         GPTConfig(vocab_size=64, dim=32, nheads=4,
                                   nlayers=2, max_seq=16), device="cpu")
    want = [[name for name, _ in part] for part in jpartition(jp, n)]
    got = [[name for name, _ in part] for part in partition_params(tp, n)]
    assert got == want
    assert [list(d) for d in partition_params(tp, n, return_dict=True)] == \
        want
    with pytest.raises(ValueError):
        partition_params(tp, 0)


@pytest.mark.parametrize("rank", range(4))
def test_shard_batch_rows_match_jax(devices8, rank):
    rs = np.random.RandomState(0)
    batch = {"tokens": rs.randint(0, 64, (8, 16)).astype(np.int32),
             "x": rs.randn(8, 3).astype(np.float32)}
    jctx = JContext()
    mesh = jctx.setup_process_groups([("data", 4)], devices=devices8[:4])
    sharded = jshard_batch(batch, mesh, P("data"))
    tpc.setup_process_groups([("data", 4)], world_size=4, rank=rank)
    try:
        got = shard_batch(batch, device="cpu")
    finally:
        tpc.reset()
    for k in batch:
        shard = next(s for s in sharded[k].addressable_shards
                     if s.device == devices8[rank])
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(shard.data))
    assert got["tokens"].dtype == torch.int64
    # without a layout the whole batch is this rank's
    assert shard_batch(batch, device="cpu")["x"].shape == (8, 3)


def test_microbatch_matches_jax():
    x = {"a": np.arange(24).reshape(6, 4)}
    np.testing.assert_array_equal(
        microbatch({"a": torch.from_numpy(x["a"])}, 3)["a"].numpy(),
        np.asarray(jmicrobatch(x, 3)["a"]))
    for fn in (jmicrobatch, microbatch):
        with pytest.raises(ValueError, match="not divisible"):
            fn({"a": np.zeros((6, 4)) if fn is jmicrobatch
                else torch.zeros(6, 4)}, 4)


def test_fold_in_is_the_same_in_every_process():
    code = ("from torchdistpackage_tpu_torch.utils import fold_in;"
            "print(fold_in(1234, 5), fold_in(fold_in(7, 0), 1))")
    outs = {subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, env={"PYTHONHASHSEED": seed, "PATH": "/usr/bin:/bin",
                         "PYTHONPATH": str(__import__("pathlib").Path(
                             __file__).parent.parent)}).stdout
        for seed in ("0", "1", "random")}
    assert len(outs) == 1
    a, b = map(int, outs.pop().split())
    assert a == fold_in(1234, 5) and b == fold_in(fold_in(7, 0), 1)
    assert 0 <= a < 2**63 and a != fold_in(1234, 6) != fold_in(1235, 5)
    assert len(set(split(99, 4))) == 4


def test_axis_unique_key_by_coordinate():
    keys = [axis_unique_key(7, "data",
                            ctx=_port([("data", 2), ("tensor", 2)], r, 4))
            for r in range(4)]
    assert keys[0] == keys[1] and keys[2] == keys[3] and keys[0] != keys[2]
    both = [axis_unique_key(7, ("data", "tensor"),
                            ctx=_port([("data", 2), ("tensor", 2)], r, 4))
            for r in range(4)]
    assert len(set(both)) == 4


def test_fix_rand_and_per_axis_keys():
    assert fix_rand(5) == 5
    a = torch.rand(3)
    fix_rand(5)
    assert torch.equal(a, torch.rand(3))
    grid = per_axis_keys(3, (2, 3))
    assert grid.shape == (2, 3) and len(set(grid.ravel().tolist())) == 6
