"""The port's ZeRO-1/2, parallel clip and dynamic loss scale against the
JAX package's.

One launch of 4 ``tests/_torch_zero_worker.py`` processes (job
``zero``, gloo over a ``file://`` store, JAX-free) runs every multi-rank
case while this process computes JAX's oracles on 4 of the conftest's 8
CPU devices (``jax.devices()[:4]``):

- ZeRO at data 4 on the MLP of ``tests/test_data_parallel.py`` against
  JAX's ``ZeroOptimizer(optax.adamw(1e-2))`` (``tests/test_zero.py:87``),
  4 steps: accumulation 1, 2 reduced at the end and 2 reduced a
  microbatch, the ``value_and_grad_fn`` path (against the accumulation-1
  run: the same step), bf16 parameters with f32 masters, the clip chain
  against ``optax.chain(clip_by_global_norm_parallel(0.25),
  optax.adamw)`` (0.25: under the MLP's norm, so it clips every step),
  a tree with a leaf that stays whole; hybrid ZeRO on
  ``build_hybrid_mesh(2)`` (``tests/test_zero.py:122``), plain and with
  ``w2`` overridden to both data axes;
- the clip chain in ``DataParallel``'s and FSDP's steps against the same
  ZeRO clip oracle (the same math);
- the grads of one batch reduced to each rank's shards, against JAX's
  per-rank grads combined in numpy — among them ``w2`` overridden to the
  intra-node axis alone, which sums over the rank's intra-node peers and
  divides by the full group size (JAX's step cannot run that override:
  the masters would differ across ``data_inter``, and its shard_map's
  replication check refuses the step);
- ZeRO x TP 2 x data 2 on the tiny GPT with ``gpt_param_specs`` at
  ``sp=True`` against the serial ``optax.adamw`` trajectory
  (``tests/test_zero.py:268``);
- ``global_grad_norm`` / ``clip_grads_by_global_norm`` on TP-split,
  ZeRO-sharded and whole leaves against numpy (``tests/test_clip.py:34``)
  and the loss scale's MIN over the group;
- planted faults: the reduction's mean replaced by its sum, the
  re-gather skipped on one leaf — each must fail its check.

In this process: ``zero_partition_spec`` on ``tests/test_zero.py:31``'s
table, the refusals, and ``DynamicLossScale``'s trajectory against
JAX's (``tests/test_clip.py:65``).  Tolerances are
``tests/test_zero.py``'s: losses rtol 1e-4 / atol 1e-5, parameters rtol
1e-3 / atol 1e-5 (see each case for the rest).
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

from torchdistpackage_tpu.dist import tpc as jtpc
from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import gpt_loss as jgpt_loss
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.parallel.clip import DynamicLossScale as JDLS
from torchdistpackage_tpu.parallel.clip import (
    clip_by_global_norm_parallel as jclip,
)
from torchdistpackage_tpu.parallel.zero import ZeroOptimizer as JZero
from torchdistpackage_tpu.parallel.zero import zero_partition_spec as jzps
from torchdistpackage_tpu_torch.dist.topology import ParallelContext
from torchdistpackage_tpu_torch.obs.events import default_event_log
from torchdistpackage_tpu_torch.parallel import (
    DynamicLossScale,
    FSDP,
    ZeroOptimizer,
    adamw,
    chain,
    clip_by_global_norm_parallel,
    prefetched_layer_scan,
    zero_partition_spec,
)
from tests.test_data_parallel import _data, make_mlp_params, mlp_loss

sys.path.insert(0, str(Path(__file__).parent))
import _torch_zero_worker as W  # noqa: E402

WORLD = 4
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
#: f32 grads and norms summed in other orders
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mesh(axes):
    jtpc.reset()
    n = int(np.prod([s for _, s in axes]))
    jtpc.setup_process_groups(axes, devices=jax.devices()[:n])
    return jtpc.get_view()


# ----------------------------------------------------------------- inputs


def _whole_params():
    """``tests/test_overlap.py``'s FSDP setup: ``b`` (3 elements) is
    divisible by no group size and stays whole."""
    key = jax.random.PRNGKey(0)
    return _np({"w1": jax.random.normal(key, (16, 16)),
                "w2": jax.random.normal(jax.random.fold_in(key, 1), (16, 16)),
                "b": jnp.zeros((3,))}), {
        "x": np.asarray(jax.random.normal(jax.random.fold_in(key, 2),
                                          (16, 16)))}


def whole_loss(p, b):
    h = jnp.tanh(b["x"] @ p["w1"])
    return ((h @ p["w2"]) ** 2).mean() + (p["b"] ** 2).sum()


def _gcfg():
    return JGPTConfig(**W.GPT, dtype=jnp.float32, attn_impl="naive")


@pytest.fixture(scope="module")
def inputs():
    out = {}
    mlp = _np(make_mlp_params(jax.random.PRNGKey(0)))
    batches = [_np(_data(jax.random.PRNGKey(100 + i)))
               for i in range(W.MLP_STEPS)]
    out.update({f"mlp/params/{k}": v for k, v in mlp.items()})
    for i, b in enumerate(batches):
        out.update({f"mlp/batch{i}/{k}": v for k, v in b.items()})
    whole, wb = _whole_params()
    out.update({f"whole/params/{k}": v for k, v in whole.items()})
    out["whole/batch/x"] = wb["x"]
    gpt = _np(jinit(jax.random.PRNGKey(0), _gcfg()))
    out.update({f"gpt/params/{k}": v for k, v in W.flatten(gpt).items()})
    rs = np.random.RandomState(0)
    gpt_batches = [{k: rs.randint(0, W.GPT["vocab_size"], (8, W.GPT[
        "max_seq"])).astype(np.int32) for k in ("tokens", "targets")}
        for _ in range(W.TP_STEPS)]
    for i, b in enumerate(gpt_batches):
        out.update({f"gpt/batch{i}/{k}": v for k, v in b.items()})
    clip = {"tp": rs.standard_normal((8, 6)),
            "zero": rs.standard_normal((4, 5)),
            "both": rs.standard_normal((8, 6)),
            "rep": rs.standard_normal((7,))}
    out.update({f"clip/grads/{k}": v.astype(np.float32)
                for k, v in clip.items()})
    return out, {"mlp": mlp, "batches": batches, "whole": (whole, wb),
                 "gpt": gpt, "gpt_batches": gpt_batches}


@pytest.fixture(scope="module")
def launched(tmp_path_factory, inputs):
    tmp = tmp_path_factory.mktemp("zero4")
    return W.start("zero", WORLD, inputs[0], tmp), tmp


# --------------------------------------------------------- JAX's oracles


def _jax_zero(params, batches, loss_fn=mlp_loss, M=1, acc="final",
              hybrid=False, opt=None, **kw):
    """JAX's ZeroOptimizer at data 4 (or hybrid 2 x 2): the losses, the
    parameters before each step and after the last, the masters."""
    view = _mesh([("data", WORLD)])
    spec = P("data")
    if hybrid:
        view = jtpc.build_hybrid_mesh(intra_size=2)
        spec = P(("data_inter", "data_intra"))
        kw.update(mesh=view, shard_axis="data_intra",
                  grad_reduce_axes=("data_inter", "data_intra"))
    zero = JZero(opt or optax.adamw(W.MLP_LR), **kw)
    zp = zero.place_params(jax.tree.map(jnp.asarray, params))
    zs = zero.init(zp)
    step = zero.make_train_step(loss_fn, grad_accum_iters=M,
                                accum_reduce=acc)
    losses, hist = [], [_np(zp)]
    for b in batches:
        b = jax.tree.map(lambda x: jax.device_put(
            jnp.asarray(x), NamedSharding(view, spec)), b)
        zp, zs, loss = step(zp, zs, b)
        losses.append(float(loss))
        hist.append(_np(zp))
    return np.asarray(losses), hist, _np(zs["master"])


def _jax_serial_gpt(params, batches):
    cfg = _gcfg()
    opt = optax.adamw(W.TP_LR)

    @jax.jit
    def step(p, s, b):
        loss, g = jax.value_and_grad(lambda q: jgpt_loss(q, b, cfg))(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    p = jax.tree.map(jnp.asarray, params)
    s = opt.init(p)
    losses = []
    for b in batches:
        p, s, loss = step(p, s, jax.tree.map(jnp.asarray, b))
        losses.append(float(loss))
    return np.asarray(losses), _np(p)


@pytest.fixture(scope="module")
def jax_runs(inputs):
    _, raw = inputs
    mlp, batches = raw["mlp"], raw["batches"]
    ref = {}
    try:
        ref["accum1"] = _jax_zero(mlp, batches)
        ref["accum2_final"] = _jax_zero(mlp, batches, M=2)
        ref["accum2_microbatch"] = _jax_zero(mlp, batches, M=2,
                                             acc="microbatch")
        ref["bf16"] = _jax_zero(mlp, batches, param_dtype=jnp.bfloat16)
        ref["clip"] = _jax_zero(mlp, batches, opt=optax.chain(
            jclip(W.CLIP), optax.adamw(W.MLP_LR)))
        ref["hybrid"] = _jax_zero(mlp, batches, hybrid=True)
        ref["hybrid_override_all"] = _jax_zero(
            mlp, batches, hybrid=True,
            grad_reduce_overrides={"w2": ("data_inter", "data_intra")})
        whole, wb = raw["whole"]
        ref["whole"] = _jax_zero(whole, [wb] * W.FSDP_STEPS, whole_loss)
        ref["gpt"] = _jax_serial_gpt(raw["gpt"], raw["gpt_batches"])
    finally:
        jtpc.reset()
    for case in ("vag", "fault_sum", "fault_regather"):
        ref[case] = ref["accum1"]
    return ref


@pytest.fixture(scope="module")
def world4(launched, jax_runs):
    """The workers' outputs (started before JAX's oracles ran)."""
    return W.results(*launched)


# ------------------------------------------------------------- checks


def _rows(batch, r, n=WORLD):
    return jax.tree.map(lambda x: np.array_split(x, n)[r], batch)


def _local_grads(params, batch):
    """Each rank's grads of its own rows, [WORLD, ...] per leaf (f64)."""
    per = [_np(jax.grad(mlp_loss)(jax.tree.map(jnp.asarray, params),
                                  jax.tree.map(jnp.asarray, _rows(batch, r))))
           for r in range(WORLD)]
    return {k: np.stack([g[k] for g in per]).astype(np.float64)
            for k in per[0]}


def _norm(tree):
    return float(np.sqrt(sum(np.sum(np.square(np.asarray(v, np.float64)))
                             for v in tree.values())))


def check_zero(got, want, case, rank):
    """Losses, parameters, masters and norms of one rank of a ZeRO case
    against JAX's run."""
    losses, hist, master = want
    np.testing.assert_allclose(got[f"zero/{case}/losses"], losses,
                               err_msg=f"rank {rank} losses", **LOSS_TOL)
    final = hist[-1]
    for k, v in final.items():
        g = got[f"zero/{case}/params/{k}"]
        if case == "bf16":
            # the parameter is its master rounded to bf16, exactly; JAX's
            # within one bf16 ulp
            m = torch.from_numpy(got[f"zero/{case}/master/{k}"])
            np.testing.assert_array_equal(
                g, m.to(torch.bfloat16).float().numpy(),
                err_msg=f"rank {rank} {k}")
            v = np.asarray(v, np.float32)
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 1e-30)))
                          - 7)
            assert (np.abs(g - v) <= ulp).all(), f"rank {rank} {k}"
        else:
            np.testing.assert_allclose(g, v, err_msg=f"rank {rank} {k}",
                                       **PARAM_TOL)
        np.testing.assert_allclose(got[f"zero/{case}/master/{k}"],
                                   master[k], err_msg=f"rank {rank} master "
                                   f"{k}", **PARAM_TOL)


def check_norms(got, want, batches, case, rank):
    """The step's norm: the global norm of the data-mean grads at the
    parameters before each step (JAX's trajectory)."""
    _, hist, _ = want
    exp = [_norm(_np(jax.grad(mlp_loss)(jax.tree.map(jnp.asarray, p),
                                        jax.tree.map(jnp.asarray, b))))
           for p, b in zip(hist[:-1], batches)]
    np.testing.assert_allclose(got[f"zero/{case}/norms"], exp,
                               err_msg=f"rank {rank} norms", **GRAD_TOL)


def check_gshard(got, mlp, batch, case, rank):
    """Batch 0's grads reduced to the rank's shard: the data mean (or,
    for the override leaf, the sum over the rank's intra-node peers
    divided by the full group size), sliced on dim 0."""
    local = _local_grads(mlp, batch)
    hybrid = case.startswith("hybrid")
    n, i = (2, rank % 2) if hybrid else (WORLD, rank)
    for k, g in local.items():
        if case == "hybrid_override" and k == "w2":
            inter = rank // 2
            red = g[2 * inter:2 * inter + 2].sum(0) / WORLD
        else:
            red = g.mean(0)
        np.testing.assert_allclose(
            got[f"zero/{case}/gshard/{k}"], np.array_split(red, n)[i],
            err_msg=f"rank {rank} {k}", **GRAD_TOL)


CASES = ["accum1", "accum2_final", "accum2_microbatch", "bf16", "vag",
         "clip", "hybrid", "hybrid_override_all"]


@pytest.mark.parametrize("case", CASES)
def test_zero_world4_matches_jax_zero(world4, jax_runs, case):
    """Every rank: losses, parameters (the same on every rank, bit for
    bit) and masters against JAX's ZeroOptimizer."""
    for r, got in enumerate(world4):
        check_zero(got, jax_runs[case], case, r)
        for k in (k for k in got if k.startswith(f"zero/{case}/params/")):
            np.testing.assert_array_equal(got[k], world4[0][k],
                                          err_msg=f"rank {r} {k}")
        assert str(got[f"zero/{case}/master_dtype"]) == "torch.float32"
    want_dtype = "torch.bfloat16" if case == "bf16" else "torch.float32"
    assert str(world4[0][f"zero/{case}/param_dtype"]) == want_dtype


@pytest.mark.parametrize("case", ["accum1", "accum2_final",
                                  "accum2_microbatch", "vag", "clip",
                                  "hybrid"])
def test_zero_world4_norms(world4, jax_runs, inputs, case):
    """The step's ``gnorm`` (before the clip, for ``clip``) is the global
    norm of the data-mean grads."""
    for r, got in enumerate(world4):
        check_norms(got, jax_runs[case], inputs[1]["batches"], case, r)


@pytest.mark.parametrize("case", ["accum1", "hybrid", "hybrid_override"])
def test_zero_reduces_grads_to_the_owner_shard(world4, inputs, case):
    mlp, batches = inputs[1]["mlp"], inputs[1]["batches"]
    for r, got in enumerate(world4):
        check_gshard(got, mlp, batches[0], case, r)


@pytest.mark.parametrize("kind", ["dp", "fsdp"])
def test_clip_chain_in_the_other_steps(world4, jax_runs, kind):
    """``chain(clip_by_global_norm_parallel(0.25), adamw)`` in
    ``DataParallel``'s and FSDP's steps: the same math as ZeRO's clip
    case, so JAX's ZeRO run with ``optax.chain`` is the oracle."""
    losses, hist, _ = jax_runs["clip"]
    for r, got in enumerate(world4):
        np.testing.assert_allclose(got[f"chain/{kind}/losses"], losses,
                                   err_msg=f"rank {r}", **LOSS_TOL)
        for k, v in hist[-1].items():
            np.testing.assert_allclose(got[f"chain/{kind}/params/{k}"], v,
                                       err_msg=f"rank {r} {k}", **PARAM_TOL)


def test_zero_whole_leaf(world4, jax_runs):
    """``b`` (3 elements) stays whole on every rank, its grad averaged;
    the sharded leaves as ever."""
    losses, hist, _ = jax_runs["whole"]
    for r, got in enumerate(world4):
        assert {k: int(got[f"zero/whole/dims/{k}"]) for k in hist[-1]} == {
            "w1": 0, "w2": 0, "b": -1}
        np.testing.assert_allclose(got["zero/whole/losses"], losses,
                                   **LOSS_TOL)
        for k, v in hist[-1].items():
            np.testing.assert_allclose(got[f"zero/whole/params/{k}"], v,
                                       err_msg=f"rank {r} {k}", **PARAM_TOL)


def test_zero_beside_tp_matches_serial(world4, jax_runs):
    """ZeRO x TP 2 x data 2 at ``sp=True``: the gathered parameters
    against the serial trajectory; the stacked ``wqkv`` is ZeRO-sharded
    on its layer dim, as JAX's rule puts it."""
    losses, params = jax_runs["gpt"]
    jdim = jzps((2, 3, 32, 32), P(None, None, None, "tensor"), "data", 2)[1]
    for r, got in enumerate(world4):
        assert int(got["zero_tp/wqkv_dim"]) == jdim == 0
        np.testing.assert_allclose(got["zero_tp/losses"], losses,
                                   err_msg=f"rank {r}", **LOSS_TOL)
        for k, want in W.flatten(params).items():
            g = got[f"zero_tp/params/{k}"]
            if k.endswith("blocks/attn/bqkv"):
                # the key bias's grad is 0 in exact arithmetic: Adam moves
                # its rounding noise by up to lr a step
                np.testing.assert_allclose(g[:, 1], want[:, 1], rtol=0,
                                           atol=2 * W.TP_LR * W.TP_STEPS)
                g, want = g[:, 0::2], want[:, 0::2]
            np.testing.assert_allclose(g, want, err_msg=f"rank {r} {k}",
                                       **PARAM_TOL)


def test_global_norm_and_clip_on_split_leaves(world4, inputs):
    """TP-split, ZeRO-sharded, both and whole leaves over data 2 x tensor
    2: the norm of the full arrays, the same on every rank; the clipped
    norm at most 1."""
    full = {k[len("clip/grads/"):]: v for k, v in inputs[0].items()
            if k.startswith("clip/grads/")}
    want = _norm(full)
    assert want > 1.0
    for got in world4:
        np.testing.assert_allclose(float(got["clip/norm"]), want, rtol=1e-5)
        np.testing.assert_allclose(float(got["clip/pre"]), want, rtol=1e-5)
        assert float(got["clip/post"]) <= 1.0 + 1e-5


def test_loss_scale_min_over_the_group(world4):
    """An inf on rank 3 only: every rank of its data group zeroes its
    grads and halves the scale; the other group steps on."""
    # data 2 x tensor 2, tensor innermost: rank 3's data group is {1, 3}
    for r, got in enumerate(world4):
        bad = r in (1, 3)
        assert bool(got["scale/finite"]) is (not bad)
        assert float(got["scale/scale"]) == (4.0 if bad else 8.0)
        np.testing.assert_array_equal(got["scale/grads"],
                                      np.zeros(3) if bad else np.ones(3))


# ---------------------------------------------------------- planted faults


def test_planted_fault_sum_fails(world4, jax_runs, inputs):
    """The reduction's mean replaced by its sum: the reduced grads and
    the norms are 4x; Adam's update hardly sees a grad's scale, so the
    grad-level checks are the ones that must catch it."""
    mlp, batches = inputs[1]["mlp"], inputs[1]["batches"]
    with pytest.raises(AssertionError):
        check_gshard(world4[0], mlp, batches[0], "fault_sum", 0)
    with pytest.raises(AssertionError):
        check_norms(world4[0], jax_runs["fault_sum"], batches, "fault_sum",
                    0)


def test_planted_fault_regather_fails(world4, jax_runs):
    """The re-gather skipped on ``w1``: the parameter stays where it
    started while its master moves."""
    with pytest.raises(AssertionError):
        check_zero(world4[0], jax_runs["fault_regather"], "fault_regather",
                   0)
    start = jax_runs["fault_regather"][1][0]["w1"]
    np.testing.assert_array_equal(world4[0]["zero/fault_regather/params/w1"],
                                  start)


# ------------------------------------------------------------- in process


@pytest.mark.parametrize("shape,tp,want_spec", [
    ((32, 16), None, P("data")),
    ((30, 16), None, P(None, "data")),
    ((30, 15), None, P()),
    ((32, 16), 0, P("tensor", "data")),
])
def test_zero_partition_spec_matches_jax(shape, tp, want_spec):
    """``tests/test_zero.py:31``'s table at 8 ranks: the port's dim is
    JAX's, and JAX's spec is the one that test asserts."""
    jspec = P("tensor") if tp is not None else P()
    spec, d = jzps(shape, jspec, "data", 8)
    assert spec == want_spec
    assert zero_partition_spec(shape, tp, 8) == d
    if tp is not None:  # counted from the end, as TP_SPLIT_DIMS counts
        assert zero_partition_spec(shape, tp - len(shape), 8) == d


def _layout(axes):
    ctx = ParallelContext()
    ctx.setup_process_groups(axes, world_size=int(np.prod(
        [s for _, s in axes])), rank=0)
    return ctx


@pytest.mark.parametrize("kw,unknown", [
    ({"grad_compress": "int8"}, {"grad_compress": "int4"}),
    ({"grad_compress": "int8_ef"}, {"grad_compress": "int8ef"}),
    ({"grad_compress": "auto"}, {"grad_compress": "always"}),
    ({"gather_compress": "int8"}, {"gather_compress": "int4"}),
])
def test_zero_refuses_what_waits(kw, unknown):
    """JAX's compression modes are accepted (the layout-only context then
    stops at the process groups it lacks; the modes run in
    tests/test_torch_compressed.py); an unknown mode is a ValueError."""
    with pytest.raises(RuntimeError, match="no process groups"):
        ZeroOptimizer(adamw(), ctx=_layout([("data", 4)]), **kw)
    with pytest.raises(ValueError, match="unknown"):
        ZeroOptimizer(adamw(), ctx=_layout([("data", 4)]), **unknown)


@pytest.mark.parametrize("axes,item", [
    ([("data", 2), ("pipe", 2)], None),
    ([("data", 2), ("context", 2)], None),
])
def test_model_axes_wait_for_their_items(axes, item):
    """Beside 1F1B (a ``pipe`` axis: tests/test_torch_pipeline_compose.py)
    and beside context parallelism (a ``context`` axis:
    tests/test_torch_gpt_cp.py) ZeRO and DataParallel's rule accept the
    layout; no model axis of the port waits for a queue-A item now."""
    ctx = _layout(axes)
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        normalize_model_axis_grads,
    )

    if item is None:  # past the refusal, to the groups a layout lacks
        with pytest.raises(RuntimeError, match="no process groups"):
            ZeroOptimizer(adamw(), ctx=ctx)
        assert normalize_model_axis_grads(None, None, ctx) == (None, ())
        return
    with pytest.raises(NotImplementedError, match=item):
        ZeroOptimizer(adamw(), ctx=ctx)
    with pytest.raises(NotImplementedError, match=item):
        normalize_model_axis_grads(None, None, ctx)


def test_zero_override_refusals_match_jax():
    """JAX's own ValueErrors (``tests/test_zero.py:493``): an override
    without the shard axis, and one with axes outside
    ``grad_reduce_axes``."""
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    with pytest.raises(ValueError, match="must contain"):
        JZero(optax.adam(1e-2), mesh=mesh, grad_reduce_overrides={
            "experts": ()})
    with pytest.raises(ValueError, match="must contain"):
        ZeroOptimizer(adamw(), ctx=_layout([("data", 4)]),
                      grad_reduce_overrides={"experts": ()})
    with pytest.raises(ValueError, match="not in grad_reduce_axes"):
        ZeroOptimizer(adamw(), ctx=_layout([("data", 4)]),
                      grad_reduce_overrides={"w": ("data", "tensor")})


def test_compression_refusals_elsewhere():
    """FSDP's int8 gathers and the prefetched scan's are accepted (an
    unknown mode is a ValueError; the int8 runs are in
    tests/test_torch_compressed.py); a handle other than adamw() or the
    chain is a TypeError (``DataParallel``'s own modes are in
    tests/test_torch_dp.py)."""
    fsdp = FSDP(ctx=_layout([("data", 4)]))
    assert callable(fsdp.make_overlap_train_step(
        lambda p, b: 0, adamw(), grad_compress="int8"))
    with pytest.raises(ValueError, match="grad_compress"):
        fsdp.make_overlap_train_step(lambda p, b: 0, adamw(),
                                     grad_compress="int4")
    # whole leaves (dim -1) gather nothing: the scan runs without a group
    seen = []
    out = prefetched_layer_scan({"w": torch.ones(4, 8, 8)},
                                torch.zeros(2, 8),
                                lambda lp, h, i: seen.append(i) or h + lp[
                                    "w"].sum(), None, {"w": -1},
                                compress="int8")
    assert seen == [0, 1, 2, 3] and float(out[0, 0]) == 256.0
    with pytest.raises(ValueError, match="compress"):
        prefetched_layer_scan({"w": torch.zeros(4, 8, 8)}, torch.zeros(2, 8),
                              lambda lp, h, i: h, None, {"w": 1},
                              compress="int4")
    with pytest.raises(TypeError, match="adamw"):
        ZeroOptimizer(torch.optim.SGD, ctx=_layout([("data", 4)]))
    with pytest.raises(TypeError, match="chain takes"):
        chain(adamw(), clip_by_global_norm_parallel(1.0))


def test_dynamic_loss_scale_matches_jax():
    """The scale and good-step trajectory over a fixed finite / inf
    sequence, the unscaled (or zeroed) grads, and a ``loss_scale`` event
    at each change."""
    seq = [True, True, False, True, True, True, False, False, True, True]
    jd, td = JDLS(init_scale=8.0, growth_interval=2, emit_events=False), \
        DynamicLossScale(init_scale=8.0, growth_interval=2)
    js, ts = jd.init(), td.init(device="cpu")
    seen = len(default_event_log().as_list())
    changes = 0
    for i, ok in enumerate(seq):
        g = np.array([1.0, 2.0, 3.0 + i], np.float32) * float(js.scale)
        if not ok:
            g[1] = np.inf
        jg, js2, jf = jd.unscale_and_update({"w": jnp.asarray(g)}, js)
        tg, ts, tf = td.unscale_and_update({"w": torch.from_numpy(g)}, ts)
        changes += float(js2.scale) != float(js.scale)
        js = js2
        assert bool(tf) == bool(jf) == ok
        assert float(ts.scale) == float(js.scale)
        assert int(ts.good_steps) == int(js.good_steps)
        np.testing.assert_array_equal(tg["w"].numpy(), np.asarray(jg["w"]))
    kinds = [e["kind"] for e in default_event_log().as_list()[seen:]]
    assert kinds == ["loss_scale"] * changes and changes >= 3
