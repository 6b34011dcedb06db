"""The port's FSDP, prefetched layer scan, sharded EMA and host offload
against the JAX package's.

One launch of 4 ``tests/_torch_zero_worker.py`` processes (job
``fsdp``, gloo over a ``file://`` store, JAX-free) runs every multi-rank
case while this process computes JAX's oracles on 4 of the conftest's 8
CPU devices:

- ``FSDP.make_train_step`` and ``make_overlap_train_step`` against
  JAX's GSPMD step (``tests/test_fsdp.py:58``) — the overlap step with
  ``gather='leaf'`` and with ``gather='none'`` (the loss gathers the
  shards itself) — at data 4 on
  ``tests/test_overlap.py``'s setup (``b`` has 3 elements and stays
  whole), 3 ``adamw(1e-2)`` steps; the port's steps take each rank's
  rows, JAX's the global batch (a mean loss over equal shards: the same
  loss).  JAX's own explicit-gather step is its GSPMD step's drop-in
  (``tests/test_overlap.py:384`` holds the two together), but on this
  tree it can die in shard_map's replication check on the whole leaf
  (it does on some jax builds), so the GSPMD step is the oracle of both
  port steps, which are also held bit-identical to each other.  Tolerances ``tests/test_fsdp.py:84-95``'s: losses
  rtol 1e-5 / atol 1e-6, parameters rtol 2e-5 / atol 2e-6.  Planted
  fault: the gather's backward reduce-scatter replaced by this rank's
  slice of its own grad — must fail the parameter check;
- ``prefetched_layer_scan`` with and without prefetch, and the whole
  stack gathered up front, against JAX's (``tests/test_overlap.py:
  439-505``, atol 1e-5): this rank's output rows and the stack's grads;
  prefetch on and off bit-identical;
- ``ShardedEMA`` at data 2 x tensor 2 against JAX's
  (``tests/test_utils.py:101``, atol 1e-6), and exact against a dense
  EMA by the same formula.

In this process: ``fsdp_specs`` beside TP specs (``tests/test_fsdp.py:
99``), ``stacked_fsdp_specs`` and the stack-dim refusal
(``tests/test_overlap.py:439``, ``:499``), ``memory_report`` and the
offload's refusals off the card.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from torchdistpackage_tpu.compat import shard_map
from torchdistpackage_tpu.dist import tpc as jtpc
from torchdistpackage_tpu.parallel import FSDP as JFSDP
from torchdistpackage_tpu.parallel import ShardedEMA as JEMA
from torchdistpackage_tpu.parallel.fsdp import gather_params as jgather
from torchdistpackage_tpu.parallel.fsdp import prefetched_layer_scan as jscan
from torchdistpackage_tpu.parallel.fsdp import stacked_fsdp_specs as jstacked
from torchdistpackage_tpu_torch.dist.topology import ParallelContext
from torchdistpackage_tpu_torch.parallel import (
    FSDP,
    adamw,
    memory_report,
    offload_to_host,
    prefetched_layer_scan,
    reload_to_device,
    stacked_fsdp_specs,
)

sys.path.insert(0, str(Path(__file__).parent))
import _torch_zero_worker as W  # noqa: E402
from tests.test_torch_zero import _mesh, _np, _whole_params, whole_loss  # noqa: E402,E501

WORLD = 4
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=2e-5, atol=2e-6)
SCAN_TOL = dict(rtol=0, atol=1e-5)
L, D = 4, 16


@pytest.fixture(scope="module")
def inputs():
    whole, wb = _whole_params()
    key = jax.random.PRNGKey(0)
    scan_w = np.asarray(jax.random.normal(key, (L, D, D)) * 0.3)
    scan_x = np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                          (8, D)))
    ema_p = {"w": np.asarray(jax.random.normal(key, (16, 8))),
             "b": np.asarray(jax.random.normal(key, (3,)))}
    out = {f"whole/params/{k}": v for k, v in whole.items()}
    out["whole/batch/x"] = wb["x"]
    out["scan/params/w"], out["scan/x"] = scan_w, scan_x
    out.update({f"ema/params/{k}": v for k, v in ema_p.items()})
    return out, {"whole": (whole, wb), "scan": (scan_w, scan_x),
                 "ema": ema_p}


@pytest.fixture(scope="module")
def launched(tmp_path_factory, inputs):
    tmp = tmp_path_factory.mktemp("fsdp4")
    return W.start("fsdp", WORLD, inputs[0], tmp), tmp


def _jax_fsdp(params, batch):
    mesh = _mesh([("data", WORLD)])
    opt = optax.adamw(W.FSDP_LR)
    fsdp = JFSDP(mesh=mesh)
    p = fsdp.shard_params(jax.tree.map(jnp.asarray, params))
    s = opt.init(p)
    step = fsdp.make_train_step(whole_loss, opt, batch_spec={"x": P("data")})
    b = {"x": jax.device_put(jnp.asarray(batch["x"]),
                             NamedSharding(mesh, P("data")))}
    losses = []
    for _ in range(W.FSDP_STEPS):
        p, s, loss = step(p, s, b)
        losses.append(float(loss))
    return np.asarray(losses), _np(p)


def _jax_scan(w, x):
    """JAX's prefetched-scan parity test: (out, grad) per variant."""
    mesh = _mesh([("data", WORLD)])
    stacked = {"w": jnp.asarray(w)}
    specs, dims = jstacked(stacked, "data", WORLD)

    def apply_fn(lp, h, i):
        return jnp.tanh(h @ lp["w"])

    def ref(st, xx):
        full = jgather(st, dims, "data")
        for i in range(L):
            xx = jnp.tanh(xx @ full["w"][i])
        return xx

    placed = jax.tree.map(lambda v, s: jax.device_put(
        v, NamedSharding(mesh, s)), stacked, specs)

    def out_and_grad(fn):
        def loss(st, xx):
            out = fn(st, xx)
            return jax.lax.pmean((out ** 2).mean(), "data"), out

        sm = shard_map(loss, mesh=mesh, in_specs=(specs, P("data")),
                       out_specs=(P(), P("data")))
        (_, out), g = jax.jit(jax.value_and_grad(
            lambda st: sm(st, jnp.asarray(x)), has_aux=True))(placed)
        return np.asarray(out), np.asarray(g["w"])

    return {"ref": out_and_grad(ref),
            "prefetch": out_and_grad(lambda st, xx: jscan(
                st, xx, apply_fn, "data", dims, prefetch=True)),
            "no_prefetch": out_and_grad(lambda st, xx: jscan(
                st, xx, apply_fn, "data", dims, prefetch=False))}


def _jax_ema(params):
    mesh = _mesh([("data", 2), ("tensor", 2)])
    p = jax.tree.map(jnp.asarray, params)
    ema = JEMA(decay=W.EMA_DECAY, mesh=mesh)
    state = ema.init(p, {"w": P(None, "tensor"), "b": P()})
    for i in range(3):
        p = jax.tree.map(lambda v: v + 0.1 * (i + 1), p)
        state = ema.update(state, p)
    return ema.state_dict(state)


@pytest.fixture(scope="module")
def jax_runs(inputs):
    _, raw = inputs
    whole, wb = raw["whole"]
    try:
        gspmd = _jax_fsdp(whole, wb)
        ref = {"plain": gspmd, "overlap": gspmd,
               "scan": _jax_scan(*raw["scan"]),
               "ema": _jax_ema(raw["ema"])}
    finally:
        jtpc.reset()
    ref["fault_local_slice"] = ref["overlap_none"] = ref["overlap"]
    return ref


@pytest.fixture(scope="module")
def world4(launched, jax_runs):
    return W.results(*launched)


def check_fsdp(got, want, kind, rank):
    losses, params = want
    np.testing.assert_allclose(got[f"fsdp/{kind}/losses"], losses,
                               err_msg=f"rank {rank} losses", **LOSS_TOL)
    for k, v in params.items():
        np.testing.assert_allclose(got[f"fsdp/{kind}/params/{k}"], v,
                                   err_msg=f"rank {rank} {k}", **PARAM_TOL)


@pytest.mark.parametrize("kind", ["plain", "overlap", "overlap_none"])
def test_fsdp_world4_matches_jax(world4, jax_runs, kind):
    """Both steps against JAX's; every rank holds the same gathered
    parameters, and the two steps agree with each other bit for bit."""
    for r, got in enumerate(world4):
        check_fsdp(got, jax_runs[kind], kind, r)
        for k in jax_runs[kind][1]:
            np.testing.assert_array_equal(got[f"fsdp/{kind}/params/{k}"],
                                          world4[0][f"fsdp/{kind}/params/{k}"])
            np.testing.assert_array_equal(got[f"fsdp/{kind}/params/{k}"],
                                          got[f"fsdp/plain/params/{k}"])


def test_planted_fault_local_slice_fails(world4, jax_runs):
    """The backward's reduce-scatter replaced by this rank's slice: each
    shard moves on its own rank's grads only."""
    with pytest.raises(AssertionError):
        check_fsdp(world4[0], jax_runs["fault_local_slice"],
                   "fault_local_slice", 0)


@pytest.mark.parametrize("variant", ["ref", "prefetch", "no_prefetch"])
def test_prefetched_layer_scan_matches_jax(world4, jax_runs, variant):
    """This rank's rows of the output, and its shard of the stack's grad
    (the sum over the ranks' local losses, / 4 for JAX's mean), against
    JAX's; the stack is sharded past its layer dim."""
    want_y, want_g = jax_runs["scan"][variant]
    for r, got in enumerate(world4):
        assert int(got["scan/dims"]) == 1
        np.testing.assert_allclose(got[f"scan/{variant}/y"],
                                   np.array_split(want_y, WORLD)[r],
                                   **SCAN_TOL)
        np.testing.assert_allclose(got[f"scan/{variant}/grad"] / WORLD,
                                   np.array_split(want_g, WORLD, 1)[r],
                                   **SCAN_TOL)


def test_prefetch_on_and_off_bit_identical(world4):
    for got in world4:
        for what in ("y", "grad"):
            np.testing.assert_array_equal(got[f"scan/prefetch/{what}"],
                                          got[f"scan/no_prefetch/{what}"])


def test_sharded_ema_matches_jax(world4, jax_runs):
    """data 2 x tensor 2: ``w`` (split on its columns over the tensor
    group) sharded over data on its rows, ``b`` whole; the full state of
    this tensor rank against JAX's, and exact against the dense EMA."""
    want = jax_runs["ema"]
    for r, got in enumerate(world4):
        t = r % 2
        assert list(got["ema/w_shard_shape"]) == [8, 4]
        np.testing.assert_allclose(got["ema/w"],
                                   np.array_split(want["w"], 2, 1)[t],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["ema/b"], want["b"], rtol=0,
                                   atol=1e-6)
        assert bool(got["ema/exact"]) and not bool(got["ema/off"])


# ------------------------------------------------------------- in process


def _layout(axes):
    ctx = ParallelContext()
    ctx.setup_process_groups(axes, world_size=int(np.prod(
        [s for _, s in axes])), rank=0)
    return ctx


def test_fsdp_specs_beside_tp_match_jax():
    """``tests/test_fsdp.py:99``: the shard axis on the first free dim
    of each TP-split leaf; a leaf no group size divides stays whole."""
    key = jax.random.PRNGKey(0)
    params = {"w1": np.zeros((16, 32)), "w2": np.zeros((32, 16)),
              "b": np.zeros((16,)), "ln": np.zeros((7,))}
    mesh = _mesh([("data", 4), ("tensor", 2)])
    try:
        want = JFSDP(mesh=mesh).fsdp_specs(
            jax.tree.map(jnp.asarray, params),
            {"w1": P(None, "tensor"), "w2": P("tensor", None), "b": P(),
             "ln": P()})
    finally:
        jtpc.reset()
    del key
    got = FSDP(ctx=_layout([("data", 4), ("tensor", 2)])).fsdp_specs(
        {k: torch.from_numpy(v) for k, v in params.items()},
        {"w1": -1, "w2": 0, "b": None, "ln": None})
    assert got == {k: tuple(v) for k, v in want.items()}
    assert got["w1"] == ("data", "tensor") and got["ln"] == ()


def test_stacked_fsdp_specs_match_jax():
    stacked = {"w": np.zeros((8, 16, 16)), "s": np.zeros((8,)),
               "wt": np.zeros((8, 16, 12))}
    jspecs, jdims = jstacked(jax.tree.map(jnp.asarray, stacked), "data", 8,
                             {"w": P(), "s": P(), "wt": P(None, "tensor")})
    specs, dims = stacked_fsdp_specs(
        {k: torch.from_numpy(v) for k, v in stacked.items()}, 8,
        {"w": None, "s": None, "wt": 1})
    assert dims == dict(jdims) and dims["w"] == 1 and dims["s"] == -1
    assert specs == {k: tuple(v) for k, v in jspecs.items()}


def test_prefetched_layer_scan_refuses_stack_sharding():
    with pytest.raises(ValueError, match="stack"):
        prefetched_layer_scan({"w": torch.zeros(4, 8, 8)}, torch.zeros(2, 8),
                              lambda lp, h, i: h, None, {"w": 0})


def test_offload_off_the_card():
    """Without a card: ``memory_report`` is ``{}`` (JAX's on its CPU sim),
    host tensors stay put, and an optimizer's state moves only in place."""
    assert memory_report("cpu") == {}
    t = torch.ones(3, requires_grad=True)
    opt = adamw(1e-3).init({"t": t})
    assert offload_to_host({"t": t, "opt": opt})["t"] is t
    assert reload_to_device({"t": t}, device="cpu")["t"] is t
    with pytest.raises(TypeError, match="in place"):
        offload_to_host(opt, donate=False)
