"""The port's compressed collectives (``dist/compressed.py``, the int8
modes of DP, ZeRO, FSDP and TP + SP, the alpha-beta model, the comm
benchmark, the overlap regime) against the JAX package, on the CPU.

One launch of 4 ``tests/_torch_compressed_worker.py`` processes (gloo,
JAX-free; what they run is in the worker's docstring) starts in a module
fixture before this process computes JAX's oracles, so the two overlap.
Each rank feeds its own numpy-seeded inputs.  The JAX oracles run under
``jax.shard_map`` on 4 of the conftest's 8 CPU devices, each program
jitted once.

Tolerances:

- the quantizer (``_group_size``, ``_quant``, ``_dequant``,
  ``ef_compress``): bit-equal to JAX's;
- the rings and their backwards: within ``hops x amax / 127`` of JAX's,
  ``amax`` the largest |partial sum| a hop can quantize (a rounding tie
  may flip one code a hop); the share of bit-equal elements is printed;
- the DP / ZeRO / TP + SP steps: JAX's own tolerances
  (``tests/test_compression.py``): losses within 5 % relative (:220,
  :260, :296, :330), TP's output within 5 % and its grads within 15 % of
  each leaf's largest |value| (:380-392);
- FSDP: JAX's overlap step fails its vma check on jax 0.9, so
  ``gather_params(compress='int8')`` and its backward are held to JAX's
  at the ring bound, and the port's int8 overlap step to its own exact
  one within 5 %;
- the policy, ``predict_compressed``, ``compressed_wire_bytes`` and
  ``fit_alpha_beta``: equal to JAX's.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from torchdistpackage_tpu.dist import comm_bench as jbench
from torchdistpackage_tpu.dist import compressed as JC
from torchdistpackage_tpu.obs import comm_model as JM
from torchdistpackage_tpu.parallel.data_parallel import DataParallel as JDP
from torchdistpackage_tpu.parallel.fsdp import gather_params as jgather
from torchdistpackage_tpu.parallel.tensor_parallel import (
    TransformerConfig as JTC,
)
from torchdistpackage_tpu.parallel.tensor_parallel import (
    init_transformer_params,
    transformer_forward,
    transformer_param_specs,
)
from torchdistpackage_tpu.parallel.zero import ZeroOptimizer as JZero

from torchdistpackage_tpu_torch.dist import comm_bench as pbench
from torchdistpackage_tpu_torch.dist import compressed as C
from torchdistpackage_tpu_torch.dist.topology import ParallelContext
from torchdistpackage_tpu_torch.obs import comm_model as M

sys.path.insert(0, str(Path(__file__).parent))
import _torch_compressed_worker as W  # noqa: E402
import _torch_ring_attention_worker as RW  # noqa: E402
from _torch_ep_worker import flatten  # noqa: E402

LOSS_RTOL = 0.05        # JAX tests/test_compression.py:220, :260, :296
TP_OUT, TP_GRAD = 0.05, 0.15   # of scale (:380, :391)
SHARE = {}              # bit-equal shares of the ring cases, printed


def jmlp_loss(params, batch):
    h = jnp.tanh(batch["x"] @ params["w1"] + params["b1"])
    return jnp.mean((h @ params["w2"] + params["b2"] - batch["y"]) ** 2)


def _inputs():
    rs = np.random.RandomState(0)
    f32 = np.float32
    inp = {}
    for case, shape in W.RING_SHAPES.items():
        x = rs.randn(W.WORLD, *shape).astype(f32)
        x.reshape(W.WORLD, -1)[:, ::37] *= 100.0  # outlier groups
        inp[f"ring/{case}"] = x
    for n in (4, 2, 1):
        for case, op, dim in W.RING_CASES:
            shape = list(W.RING_SHAPES[case])
            if op == "rs" and shape[dim] % n == 0:
                shape[dim] //= n
                inp[f"ct_rs/{n}/{case}/{dim}"] = rs.randn(
                    W.WORLD, *shape).astype(f32)
            elif op == "ag":
                shape[dim] *= n
                inp[f"ct_ag/{n}/{case}/{dim}"] = rs.randn(
                    W.WORLD, *shape).astype(f32)
    inp["ring/ragged"] = rs.randn(W.WORLD, *W.RAGGED).astype(f32)
    din, dh, dout = W.MLP["din"], W.MLP["dh"], W.MLP["dout"]
    mlp = {"w1": 0.1 * rs.randn(din, dh), "b1": 0.1 * rs.randn(dh),
           "w2": 0.1 * rs.randn(dh, dout), "b2": 0.1 * rs.randn(dout)}
    for k, v in mlp.items():
        inp[f"mlp/{k}"] = v.astype(f32)
        inp[f"fsdp/ct/{k}"] = rs.randn(W.WORLD, *v.shape).astype(f32)
    inp["batch/x"] = rs.randn(W.ROWS, din).astype(f32)
    inp["batch/y"] = rs.randn(W.ROWS, dout).astype(f32)
    for family, kv in (("dense", None), ("gqa", 2)):
        cfg = JTC(**W.TF, kv_heads=kv)
        shapes = jax.eval_shape(
            lambda c=cfg: init_transformer_params(jax.random.PRNGKey(0), c))
        tree = jax.tree.map(
            lambda sd: (0.1 * rs.randn(*sd.shape)).astype(f32), shapes)
        inp.update(flatten(tree, f"tf/{family}/params/"))
    inp["tf/x"] = rs.randn(*W.TF_X).astype(f32)
    return inp


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs and the 4 ranks' results (the workers started first)."""
    inp = _inputs()
    tmp = tmp_path_factory.mktemp("compressed")
    procs = RW.start(str(Path(__file__).parent / "_torch_compressed_worker.py"),
                     inp, tmp)
    return inp, procs, tmp


@pytest.fixture(scope="module")
def ranks(run):
    inp, procs, tmp = run
    return RW.results(procs, tmp, timeout=300)


def _mlp(inp):
    return {k: inp[f"mlp/{k}"] for k in ("w1", "b1", "w2", "b2")}


# --------------------------------------------------------------- quantizer


@pytest.mark.parametrize("size", [256, 192, 7, 1000, 4096, 1])
def test_quantizer_bit_equal_to_jax(size):
    rs = np.random.RandomState(size)
    x = rs.randn(size).astype(np.float32)
    x[::29] *= 300.0  # outlier groups
    assert C._group_size(size) == JC._group_size(size)
    jq, js = (np.asarray(a) for a in JC._quant(jnp.asarray(x)))
    q, s = C._quant(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(
        C._dequant(q, s).numpy(), np.asarray(JC._dequant(jq, js)))


def test_group_size_and_ef_compress_bit_equal_to_jax():
    assert [C._group_size(n) for n in range(1, 2049)] == [
        JC._group_size(n) for n in range(1, 2049)]
    assert C.GROUP == JC.GROUP == M.COMPRESS_GROUP == JM.COMPRESS_GROUP
    assert C.COMPRESS_MODES == JC.COMPRESS_MODES
    rs = np.random.RandomState(0)
    for shape in [(17, 33), (8, 256), (5,)]:
        x = (rs.randn(*shape) * 2.0).astype(np.float32)
        x.reshape(-1)[::11] *= 50.0
        jxq, je = JC.ef_compress(jnp.asarray(x))
        xq, e = C.ef_compress(torch.from_numpy(x))
        np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))
        assert e.dtype == torch.float32
        # the residual within a quantization step of the group
        assert float(e.abs().max()) <= float(np.abs(x).max()) / 127.0 * 1.01


# ------------------------------------------------------------------ rings


def _ring_mesh(n):
    devs = np.array(jax.devices()[:4])
    if n == 4:
        return Mesh(devs, ("d",)), P("d")
    return Mesh(devs.reshape(2, 2), ("p", "d")), P(("p", "d"))


@pytest.fixture(scope="module")
def jax_rings(run):
    """JAX's rings and their VJPs on every rank's input: one jitted
    shard_map program per group size."""
    inp = run[0]
    out = {}
    for n in (4, 2):
        mesh, spec = _ring_mesh(n)
        keys = [(case, op, dim) for case, op, dim in W.RING_CASES
                if not (op == "rs" and W.RING_SHAPES[case][dim] % n)]

        def body(xs, cts, keys=keys):
            res = {}
            for case, op, dim in keys:
                x = xs[case][0]
                k = f"ring/{n}/{case}/{op}/{dim}"
                if op == "pmean":
                    res[k] = JC.int8_ring_pmean(x, "d")
                elif op == "psum_ag":
                    res[k] = JC.int8_psum_all_gather(x, "d", dim)
                else:
                    fn = (JC.int8_ring_reduce_scatter if op == "rs"
                          else JC.int8_ring_all_gather)
                    y, vjp = jax.vjp(lambda v: fn(v, "d", dim), x)
                    res[k] = y
                    res[k + "/vjp"] = vjp(cts[k][0])[0]
            return {k: v[None] for k, v in res.items()}

        xs = {case: jnp.asarray(inp[f"ring/{case}"])
              for case in W.RING_SHAPES}
        cts = {}
        for case, op, dim in keys:
            tag = "ct_rs" if op == "rs" else "ct_ag"
            if op in ("rs", "ag"):
                cts[f"ring/{n}/{case}/{op}/{dim}"] = jnp.asarray(
                    inp[f"{tag}/{n}/{case}/{dim}"])
        fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                                   out_specs=spec, check_vma=False))
        out.update({k: np.asarray(v) for k, v in fn(xs, cts).items()})
    return out


def _members(n, r):
    return [r] if n == 1 else (list(range(4)) if n == 4
                               else [2 * (r // 2), 2 * (r // 2) + 1])


def _hops_amax(inp, n, case, op, dim, r):
    """(hops, amax): the quantizations on the way to an element and the
    largest |value| any of them can see (the group's summed |inputs|)."""
    src = {"rs/vjp": "ct_rs", "ag/vjp": "ct_ag"}.get(op)
    if src is None:
        a = np.abs(inp[f"ring/{case}"][_members(n, r)])
    else:
        a = np.abs(inp[f"{src}/{n}/{case}/{dim}"][_members(n, r)])
    hops = {"pmean": n, "rs": n - 1, "ag": 1, "psum_ag": 1,
            "rs/vjp": 1, "ag/vjp": n - 1}[op]
    return hops, float(a.sum(0).max())


@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("case,op,dim", W.RING_CASES)
def test_rings_and_vjps_match_jax(ranks, run, jax_rings, n, case, op, dim):
    inp = run[0]
    key = f"ring/{n}/{case}/{op}/{dim}"
    for sub in ([""] + (["/vjp"] if op in ("rs", "ag") else [])):
        want = jax_rings[key + sub]
        for r in range(4):
            got = ranks[r][key + sub]
            assert got.shape == want[r].shape, (key + sub, got.shape)
            hops, amax = _hops_amax(inp, n, case, op + sub, dim, r)
            bound = hops * amax / 127.0 * 1.01
            err = float(np.abs(got - want[r]).max())
            assert err <= bound, (key + sub, r, err, bound)
            SHARE[key + sub + f"/rank{r}"] = float(
                (got == want[r]).mean())
        print(f"{key + sub}: bit-equal share by rank "
              + ", ".join(f"{SHARE[key + sub + f'/rank{r}']:.4f}"
                          for r in range(4)))


def test_ring_fallbacks(ranks, run):
    """One member: every ring returns its input; a flat size the group
    does not divide: the exact mean."""
    inp = run[0]
    for r in range(4):
        for case, op, dim in W.RING_CASES:
            key = f"ring/1/{case}/{op}/{dim}"
            np.testing.assert_array_equal(ranks[r][key],
                                          inp[f"ring/{case}"][r])
            if op in ("rs", "ag"):
                tag = "ct_rs" if op == "rs" else "ct_ag"
                np.testing.assert_array_equal(
                    ranks[r][key + "/vjp"], inp[f"{tag}/1/{case}/{dim}"][r])
        for n in (4, 2):
            want = inp["ring/ragged"][_members(n, r)].mean(0)
            np.testing.assert_allclose(ranks[r][f"ring/{n}/ragged"], want,
                                       rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(ranks[r]["ring/1/ragged"],
                                      inp["ring/ragged"][r])


# ------------------------------------------------------------------ steps


def _jbatch(inp, mesh):
    return {k: jax.device_put(jnp.asarray(inp[f"batch/{k}"]),
                              NamedSharding(mesh, P("data")))
            for k in ("x", "y")}


def _link():
    link = JM.AxisCost(kind="table", **W.LINK)
    return JM.CommModel({"data": link}, default=link,
                        compressed_axis_costs={"data": link})


@pytest.fixture(scope="module")
def jax_dp(run):
    inp = run[0]
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    opt = optax.sgd(W.LR)
    arms = {"exact": ({}, 1, "final"),
            "int8": (dict(grad_compress="int8", compress_min_size=0), 1,
                     "final"),
            "int8_micro": (dict(grad_compress="int8", compress_min_size=0),
                           2, "microbatch"),
            "exact_micro": ({}, 2, "microbatch"),
            "auto": (dict(grad_compress="auto", comm_model=_link(),
                          compress_min_size=W.AUTO_MIN), 1, "final")}
    out = {}
    for name, (kw, m, acc) in arms.items():
        dp = JDP(mesh=mesh, **kw)
        p = dp.broadcast_params(_mlp(inp))
        s = opt.init(p)
        step = dp.make_train_step(jmlp_loss, opt, grad_accum_iters=m,
                                  accum_reduce=acc)
        batch = _jbatch(inp, mesh)
        losses = []
        for _ in range(W.DP_STEPS):
            p, s, loss = step(p, s, batch)
            losses.append(float(loss))
        out[name] = np.asarray(losses)
    leaves = [(k, v.shape, 4) for k, v in _mlp(inp).items()]
    out["auto_policy"], _ = JC.auto_compress_policy(
        leaves, "all_reduce", ("data",), mesh, model=_link(),
        min_size=W.AUTO_MIN)
    return out


@pytest.mark.parametrize("arm", ["int8", "int8_micro", "auto"])
def test_dp_int8_steps_match_jax(ranks, jax_dp, arm):
    got = ranks[0][f"dp/{arm}/losses"]
    for r in ranks:  # the logged loss is the data group's mean
        np.testing.assert_array_equal(r[f"dp/{arm}/losses"], got)
    np.testing.assert_allclose(got, jax_dp[arm], rtol=LOSS_RTOL)
    exact = "exact_micro" if arm.endswith("micro") else "exact"
    np.testing.assert_allclose(got, ranks[0][f"dp/{exact}/losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(ranks[0][f"dp/{exact}/losses"], jax_dp[exact],
                               rtol=1e-5)
    assert got[-1] < got[0]
    # the rings ran (an arm that fell back to the exact path would pass
    # the loss bounds)
    assert int(ranks[0][f"dp/{arm}/int8_calls"]) > 0
    assert int(ranks[0][f"dp/{exact}/int8_calls"]) == 0
    print(f"dp {arm}: losses {got.tolist()} (JAX {jax_dp[arm].tolist()})")


def test_dp_auto_policy_event_matches_jax(ranks, jax_dp):
    for r in ranks:
        assert int(r["dp/auto/events"]) == 1  # at the step's first call
        flags = {k[len("dp/auto/compress/"):]: bool(v) for k, v in r.items()
                 if k.startswith("dp/auto/compress/")}
        assert flags == jax_dp["auto_policy"]
    assert any(jax_dp["auto_policy"].values())
    assert not all(jax_dp["auto_policy"].values())


def test_overlap_regimes_bit_identical(ranks):
    for r in ranks:
        none = {k.split("/")[-1]: v for k, v in r.items()
                if k.startswith("dp/overlap/none/grads/")}
        gen = {k.split("/")[-1]: v for k, v in r.items()
               if k.startswith("dp/overlap/generic/grads/")}
        assert none.keys() == gen.keys() and len(none) == 4
        for k in none:
            np.testing.assert_array_equal(none[k], gen[k])
        assert int(r["dp/overlap/none/buckets"]) > 1
        assert int(r["dp/overlap/events"]) == 2


@pytest.fixture(scope="module")
def jax_zero(run):
    inp = run[0]
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    opt = optax.sgd(W.LR)
    out = {}
    for name, kw in (("exact", {}), ("int8", dict(grad_compress="int8")),
                     ("int8_ef", dict(grad_compress="int8_ef")),
                     ("auto", dict(grad_compress="auto")),
                     ("int8_micro", dict(grad_compress="int8"))):
        zero = JZero(opt, mesh=mesh, compress_min_size=0, **kw)
        zp = zero.place_params(_mlp(inp))
        zs = zero.init(zp)
        micro = name.endswith("micro")
        step = zero.make_train_step(
            jmlp_loss, grad_accum_iters=2 if micro else 1,
            accum_reduce="microbatch" if micro else "final")
        batch = _jbatch(inp, mesh)
        losses = []
        for _ in range(W.ZERO_STEPS):
            zp, zs, loss = step(zp, zs, batch)
            losses.append(float(loss))
        out[name] = np.asarray(losses)
        if name == "auto":
            _, _, sdims = zero._specs_for(_mlp(inp))
            out["auto_policy"], _ = zero._compress_decisions(_mlp(inp),
                                                             sdims)
    moe = {"experts": {"w1": jnp.zeros((8, 64, 64))},
           "dense": {"w": jnp.zeros((64, 64))}}
    for mode in ("int8", "int8_ef", "auto"):
        zero = JZero(opt, mesh=mesh, grad_compress=mode, compress_min_size=0,
                     grad_reduce_overrides={"experts": ("data",)})
        _, _, sdims = zero._specs_for(moe)
        out[f"override/{mode}"], _ = zero._compress_decisions(moe, sdims)
    return out


@pytest.mark.parametrize("arm", ["int8", "int8_ef", "auto", "int8_micro"])
def test_zero_int8_steps_match_jax(ranks, jax_zero, arm):
    got = ranks[0][f"zero/{arm}/losses"]
    for r in ranks:
        np.testing.assert_array_equal(r[f"zero/{arm}/losses"], got)
    np.testing.assert_allclose(got, jax_zero[arm], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got, ranks[0]["zero/exact/losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(ranks[0]["zero/exact/losses"],
                               jax_zero["exact"], rtol=1e-5)
    assert got[-1] < got[0]
    assert int(ranks[0][f"zero/{arm}/int8_calls"]) > 0
    assert int(ranks[0]["zero/exact/int8_calls"]) == 0
    # every rank holds the same parameters (the int8 re-gather's values)
    for k in ("w1", "b1", "w2", "b2"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"zero/{arm}/params/{k}"],
                                          ranks[0][f"zero/{arm}/params/{k}"])
    print(f"zero {arm}: losses {got.tolist()} (JAX "
          f"{jax_zero[arm].tolist()})")


def test_zero_ef_residual_carried_and_policy(ranks, jax_zero, run):
    inp = run[0]
    for r in ranks:
        for k in ("w1", "b1", "w2", "b2"):
            e = r[f"zero/int8_ef/ef/{k}"]
            assert e.shape == inp[f"mlp/{k}"].shape and e.dtype == np.float32
        # alive after lossy steps: a zero residual means no feedback
        assert float(np.abs(r["zero/int8_ef/ef/w1"]).max()) > 0.0
        assert bool(r["zero/ef_micro_refused"])
        assert int(r["zero/auto/events"]) == 1
        assert str(r["zero/auto/family"]) == "zero"
        flags = {k[len("zero/auto/compress/"):]: bool(v) for k, v in r.items()
                 if k.startswith("zero/auto/compress/")}
        assert flags == {k: bool(v) for k, v in
                         jax_zero["auto_policy"].items()}
        for mode in ("int8", "int8_ef", "auto"):
            got = {k[len(f"zero/override/{mode}/"):]: bool(v)
                   for k, v in r.items()
                   if k.startswith(f"zero/override/{mode}/")}
            want = {k: bool(v) for k, v in
                    jax_zero[f"override/{mode}"].items()}
            assert got == want and got["experts/w1"] is False \
                and got["dense/w"] is True, (mode, got)


# ------------------------------------------------------------------- FSDP


def test_fsdp_int8_gather_and_backward_match_jax(ranks, run):
    inp = run[0]
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    dims = {k: int(ranks[0][f"fsdp/dims/{k}"]) for k in ("w1", "b1", "w2",
                                                          "b2")}
    shards = {k: np.stack([np.split(inp[f"mlp/{k}"], 4, axis=d)[r]
                           for r in range(4)]) if d >= 0 else
              np.stack([inp[f"mlp/{k}"]] * 4) for k, d in dims.items()}
    cts = {k: jnp.asarray(inp[f"fsdp/ct/{k}"]) for k in dims}

    def body(ps, cs):
        ps = {k: v[0] for k, v in ps.items()}
        full, vjp = jax.vjp(lambda t: jgather(
            t, dims, "data", compress="int8", compress_min_size=0), ps)
        (g,) = vjp({k: v[0] for k, v in cs.items()})
        return ({k: v[None] for k, v in full.items()},
                {k: v[None] for k, v in g.items()})

    full, grads = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")), check_vma=False))(
        {k: jnp.asarray(v) for k, v in shards.items()}, cts)
    for k, d in dims.items():
        assert d >= 0, k  # every MLP leaf divides by 4
        for r in range(4):
            amax = float(np.abs(shards[k]).max())
            np.testing.assert_allclose(
                ranks[r][f"fsdp/gather/{k}"], np.asarray(full[k][r]),
                rtol=0, atol=amax / 127.0 * 1.01)
            hops, camax = 3, float(np.abs(inp[f"fsdp/ct/{k}"]).sum(0).max())
            np.testing.assert_allclose(
                ranks[r][f"fsdp/vjp/{k}"], np.asarray(grads[k][r]),
                rtol=0, atol=hops * camax / 127.0 * 1.01)


def test_fsdp_int8_overlap_step_tracks_its_exact_step(ranks):
    got, exact = (ranks[0][f"fsdp/{a}/losses"] for a in ("int8", "exact"))
    np.testing.assert_allclose(got, exact, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["fsdp/int8/losses"], got)
    assert int(ranks[0]["fsdp/int8/int8_calls"]) > 0
    assert int(ranks[0]["fsdp/exact/int8_calls"]) == 0


# ---------------------------------------------------------------- TP + SP


@pytest.fixture(scope="module")
def jax_tp(run):
    """JAX's golden (tests/test_compression.py:340): one
    value_and_grad(has_aux) program per family and arm, tensor 2."""
    import functools

    from _torch_ep_worker import unflatten

    inp = run[0]
    mesh = Mesh(np.array(jax.devices()[:2]), ("tensor",))
    out = {}
    for family, kv in (("dense", None), ("gqa", 2)):
        cfg = JTC(**W.TF, kv_heads=kv)
        params = unflatten({k[len(f"tf/{family}/params/"):]: v
                            for k, v in inp.items()
                            if k.startswith(f"tf/{family}/params/")})
        params = jax.tree.map(jnp.asarray, params)
        specs = transformer_param_specs(cfg, axis="tensor")
        sharded = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), params,
            specs)
        x = jax.device_put(jnp.asarray(inp["tf/x"]),
                           NamedSharding(mesh, P()))
        for arm in ("exact", "int8"):
            c = cfg if arm == "exact" else JTC(
                **W.TF, kv_heads=kv, ag_compress="int8",
                compress_min_bytes=0)

            def loss_with_out(p, xx, c=c):
                o = jax.shard_map(
                    functools.partial(transformer_forward, cfg=c,
                                      axis="tensor", sp=True,
                                      gather_output=False),
                    mesh=mesh, in_specs=(specs, P()),
                    out_specs=P(None, "tensor", None))(p, xx)
                return jnp.mean(o ** 2), o

            (loss, o), g = jax.jit(jax.value_and_grad(
                loss_with_out, has_aux=True))(sharded, x)
            key = f"tf/{family}/{arm}"
            out[f"{key}/loss"] = float(loss)
            out[f"{key}/out"] = np.asarray(o)
            out.update(flatten(jax.device_get(g), f"{key}/grads/"))
    return out


@pytest.mark.parametrize("family", ["dense", "gqa"])
def test_tp_sp_int8_boundaries_match_jax(ranks, jax_tp, family):
    key = f"tf/{family}"
    for r in ranks:
        for arm in ("exact", "int8"):
            k = f"{key}/{arm}"
            out, want = r[f"{k}/out"], jax_tp[f"{k}/out"]
            scale = float(np.abs(want).max())
            tol = TP_OUT * scale if arm == "int8" else 1e-5 * scale
            np.testing.assert_allclose(out, want, rtol=0, atol=tol)
            np.testing.assert_allclose(float(r[f"{k}/loss"]),
                                       jax_tp[f"{k}/loss"],
                                       rtol=LOSS_RTOL if arm == "int8"
                                       else 1e-5)
            names = [n for n in jax_tp if n.startswith(f"{k}/grads/")]
            assert names
            for n in names:
                ref = float(np.abs(jax_tp[n]).max())
                tol = (max(ref, 1e-3) * TP_GRAD if arm == "int8"
                       else 1e-4 * max(ref, 1e-3))
                np.testing.assert_allclose(r[n], jax_tp[n], rtol=0,
                                           atol=tol, err_msg=n)
        # the compressed arm really is another computation
        assert not np.array_equal(r[f"{key}/int8/out"],
                                  r[f"{key}/exact/out"])


# --------------------------------------------------- policy and the model


def _layout(n):
    ctx = ParallelContext()
    ctx.setup_process_groups([("data", n)], world_size=n, rank=0)
    return ctx


@pytest.mark.parametrize("explicit", [True, False])
def test_auto_compress_policy_matches_jax(explicit):
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    leaves = [("big", (256, 64), 4), ("mid", (128, 3), 4),
              ("small", (8,), 4), ("bf16", (512, 512), 2),
              ("odd", (7, 13), 4)]
    jkw = dict(model=_link()) if explicit else {}
    pkw = {}
    if explicit:
        link = M.AxisCost(kind="table", **W.LINK)
        pkw = dict(model=M.CommModel({"data": link}, default=link,
                                     compressed_axis_costs={"data": link}))
    for op in ("all_reduce", "reduce_scatter"):
        jpol, jrec = JC.auto_compress_policy(leaves, op, ("data",), mesh,
                                             min_size=1024, **jkw)
        pol, rec = C.auto_compress_policy(leaves, op, ("data",), _layout(8),
                                          min_size=1024, **pkw)
        assert pol == jpol and rec == jrec
        assert pol["big"] is True and pol["small"] is False


def test_predict_compressed_wire_bytes_and_fit_match_jax():
    link = (1e-6, 1e9)
    jm = JM.CommModel({"data": JM.AxisCost(*link)},
                      default=JM.AxisCost(*link))
    pm = M.CommModel({"data": M.AxisCost(*link)}, default=M.AxisCost(*link))
    for op in ("all_reduce", "reduce_scatter", "all_gather"):
        for n in (1, 2, 4, 8):
            for payload in (1 << 10, 4096 * 4, 1 << 24):
                for eb in (2, 4):
                    assert M.compressed_wire_bytes(op, payload, n, eb) == \
                        JM.compressed_wire_bytes(op, payload, n, eb)
                    assert M.compressed_ledger_bytes(op, payload, n, eb) == \
                        JM.compressed_ledger_bytes(op, payload, n, eb)
                    assert pm.predict_compressed(
                        op, payload, n, axes=("data",), elem_bytes=eb) == \
                        jm.predict_compressed(op, payload, n, axes=("data",),
                                              elem_bytes=eb)
    for op in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
               "ppermute"):
        assert pm.predict(op, 1 << 20, 4, ("data",)) == jm.predict(
            op, 1 << 20, 4, ("data",))
        assert M.steps_for(op, 4) == JM.steps_for(op, 4)
        assert M.wire_bytes(op, 1 << 20, 4) == JM.wire_bytes(op, 1 << 20, 4)
    with pytest.raises(ValueError, match="no int8 ring"):
        pm.predict_compressed("all_to_all", 1024, 4)
    rs = np.random.RandomState(0)
    for _ in range(3):
        steps = rs.randint(1, 16, 8).astype(float)
        wire = rs.rand(8) * 1e8
        samples = list(zip(steps, wire, steps * 3e-6 + wire / 2e10
                           + rs.rand(8) * 1e-5))
        np.testing.assert_allclose(M.fit_alpha_beta(samples),
                                   JM.fit_alpha_beta(samples), rtol=1e-12)
    lat = [(1.0, 0.0, 1e-5), (2.0, 0.0, 2e-5)]  # all latency
    assert M.fit_alpha_beta(lat) == JM.fit_alpha_beta(lat)


def test_comm_bench_records_schema_and_busbw(ranks):
    import json

    for n in range(2, 9):
        for op, f in pbench._BUSBW_FACTOR.items():
            assert f(n) == jbench._BUSBW_FACTOR[op](n)
    rows = json.loads(str(ranks[0]["bench/rows"]))
    assert len(rows) == len(W.BENCH_OPS) * len(W.BENCH_BYTES)
    for row in rows:
        assert row["type"] == "comm" and row["schema"] == "tdp-comm-record/v1"
        assert row["axis"] == "data" and row["axis_size"] == 4
        assert row["time_s"] > 0
        np.testing.assert_allclose(
            row["busbw_GBps"],
            row["algbw_GBps"] * pbench._BUSBW_FACTOR[row["op"]](4),
            rtol=1e-12)
        np.testing.assert_allclose(
            row["algbw_GBps"], row["bytes"] / row["time_s"] / 1e9,
            rtol=1e-12)
        if row["op"].startswith("int8_"):
            assert row["compressed"] is True and row["elem_bytes"] == 2
            assert row["base_op"] == row["op"][len("int8_"):]
        assert row["bytes"] in (1 << 12, 1 << 16)  # divisible by 4 and 16
    assert list(ranks[0]["bench/axes"]) == ["data"]
    assert list(ranks[0]["bench/int8_axes"]) == ["data"]


def test_overlap_presets():
    from torchdistpackage_tpu_torch.dist import overlap
    from torchdistpackage_tpu_torch.obs.events import (
        EVENT_KINDS,
        default_event_log,
    )

    assert {"compress_policy", "overlap_configure"} <= EVENT_KINDS
    assert set(overlap.PRESETS) == {"none", "generic"}
    assert overlap.resolve_preset("auto") == "generic"
    with pytest.raises(ValueError, match="unknown overlap preset"):
        overlap.resolve_preset("v5e")
    try:
        rec = overlap.configure("none")
        assert rec == {"preset": "none", "async_collectives": False}
        assert overlap.waits() and overlap.active() == rec
        ev = default_event_log().as_list()[-1]
        assert ev["kind"] == "overlap_configure" and ev["preset"] == "none"
        assert not overlap.configure("generic")["preset"] == "none"
        assert not overlap.waits()
    finally:
        overlap._ACTIVE = None
