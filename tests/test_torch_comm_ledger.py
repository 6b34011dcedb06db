"""The port's comm ledger and comm reports against the JAX package's, on
the CPU.

- The reports over the same ledger dicts: JAX's ``ledger_from_hlo``
  builds them from the synthetic HLO of ``tests/test_comm_obs.py`` and
  ``tests/test_overlap.py`` (and a context-axis ring), and the port's
  ``CommModel.predict_ledger``, ``comm_report``, ``compression_report``,
  ``render_table``, ``tp_pp_overlap`` and ``cp_ring_overlap`` must give
  JAX's outputs key for key (floats to 1e-12).  ``comm_report``'s
  ``verdict_basis`` names the compute estimate the port has (the hand
  formula's FLOPs, where JAX reads XLA's count).
- The recorder in one launch of 4 JAX-free
  ``tests/_torch_comm_ledger_worker.py`` processes over gloo: a data 2 x
  tensor 2 TP + SP + DP step of the tiny GPT under ``Telemetry`` (its
  ``dp`` bytes are the reduced grads', its op counts by ``op_name`` the
  ``COLLECTIVES`` deltas, JAX's ledger of the same step on the same mesh
  beside it), the two overlap regimes, each of ``tp_utils``' five
  helpers, a two-stage pipeline's ``tp_pp_overlap`` and a cp-2 training
  ring's hop count (and the planted fault of a ring shift that bypasses
  the recorder).
"""

import math
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from torchdistpackage_tpu.dist import tpc as jtpc
from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import gpt_loss as jgpt_loss
from torchdistpackage_tpu.models import gpt_param_specs as jspecs
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.obs import comm_ledger as jcl
from torchdistpackage_tpu.obs import comm_model as jcm
from torchdistpackage_tpu.obs import report as jrep
from torchdistpackage_tpu.parallel.data_parallel import DataParallel as JDP
from torchdistpackage_tpu_torch.obs import comm_ledger as tcl
from torchdistpackage_tpu_torch.obs import comm_model as tcm
from torchdistpackage_tpu_torch.obs import validate_runreport

sys.path.insert(0, str(Path(__file__).parent))
import _torch_comm_ledger_worker as W  # noqa: E402
from _torch_ep_worker import flatten  # noqa: E402

# ------------------------------------------------------ synthetic ledgers


class _Dev:
    def __init__(self, i):
        self.id = i


def _mesh(**axes):
    """A mesh stand-in for JAX's ledger: devices in C order over
    ``axes`` (the last axis innermost)."""
    names, shape = tuple(axes), tuple(axes.values())
    ids = np.arange(int(np.prod(shape))).reshape(shape)
    devices = np.empty(shape, dtype=object)
    for idx in np.ndindex(shape):
        devices[idx] = _Dev(int(ids[idx]))

    class M:
        pass

    m = M()
    m.devices, m.axis_names, m.shape = devices, names, dict(axes)
    return m


#: tests/test_comm_obs.py:59-176 and tests/test_overlap.py:613's HLO,
#: with the meshes they are read on, plus a context-axis ring
HLO = {
    "literal": ("%all-reduce.1 = f32[2,16]{1,0} all-reduce(f32[2,16]{1,0} "
                "%x), channel_id=1, replica_groups={{0,2,4,6},{1,3,5,7}}, "
                "use_global_device_ids=true, to_apply=%add, "
                'metadata={op_name="jit(f)/psum"}',
                dict(data=4, tensor=2)),
    "allgather": ("%all-gather.1 = f32[4,16]{1,0} all-gather(f32[2,16]{1,0} "
                  "%x), channel_id=2, replica_groups={{0,1},{2,3}}, "
                  "dimensions={0}", dict(data=2, tensor=2)),
    "alltoall": ("\n".join([
        "%all-to-all.2 = (f32[4,2]{1,0}, f32[4,2]{1,0}) "
        "all-to-all(f32[4,2]{1,0} %a, f32[4,2]{1,0} %b), channel_id=1, "
        "replica_groups={{0,1}}",
        "%gte = f32[4,2]{1,0} get-tuple-element((f32[4,2]{1,0}, "
        "f32[4,2]{1,0}) %all-to-all.2), index=0",
        "%all-gather-done.1 = f32[8]{0} all-gather-done(f32[8]{0} %ags)",
        "ROOT %t = (f32[4,2]{1,0}) tuple(f32[4,2]{1,0} %gte)"]),
        dict(moe_ep=2)),
    "async_start": ("\n".join([
        "%ar-start = f32[8]{0} all-reduce-start(f32[8]{0} %x), "
        "channel_id=5, replica_groups={{0,1,2,3}}",
        "%ar-done = f32[8]{0} all-reduce-done(f32[8]{0} %ar-start)"]),
        dict(data=4)),
    "pp_window": ("\n".join([
        "%cp-start = f32[8]{0} collective-permute-start(f32[8]{0} %x), "
        "channel_id=1, source_target_pairs={{0,2},{2,0},{1,3},{3,1}}",
        "%ag = f32[16]{0} all-gather(f32[8]{0} %a), channel_id=2, "
        "replica_groups={{0,1},{2,3}}, dimensions={0}",
        "%rs = f32[8]{0} reduce-scatter(f32[16]{0} %b), channel_id=3, "
        "replica_groups={{0,1},{2,3}}, dimensions={0}, to_apply=%add",
        "%cp-done = f32[8]{0} collective-permute-done(f32[8]{0} %cp-start)",
        "%ag2 = f32[16]{0} all-gather(f32[8]{0} %c), channel_id=4, "
        "replica_groups={{0,1},{2,3}}, dimensions={0}"]),
        dict(pipe=2, tensor=2)),
    "async_hlo": ("\n".join([
        "%ags = f32[8]{0} all-gather-start(f32[2]{0} %x), channel_id=1, "
        "replica_groups={{0,1,2,3}}, dimensions={0}",
        "%a = f32[8]{0} add(f32[8]{0} %y, f32[8]{0} %y)",
        "%b = f32[8]{0} multiply(f32[8]{0} %a, f32[8]{0} %a)",
        "%agd = f32[8]{0} all-gather-done(f32[8]{0} %ags)",
        "%ar = f32[8]{0} all-reduce(f32[8]{0} %b), channel_id=2, "
        "replica_groups={{0,1,2,3}}, to_apply=%add",
        "%cps = f32[8]{0} collective-permute-start(f32[8]{0} %b), "
        "channel_id=3, source_target_pairs={{0,1},{1,0}}",
        "%cpd = f32[8]{0} collective-permute-done(f32[8]{0} %cps)"]),
        None),
    "cp_ring": ("\n".join([
        "%h0 = f32[2,4,8,16]{3,2,1,0} collective-permute-start("
        "f32[2,4,8,16]{3,2,1,0} %kv), channel_id=1, "
        "source_target_pairs={{0,2},{2,0},{1,3},{3,1}}",
        "%ag = f32[16]{0} all-gather(f32[8]{0} %a), channel_id=2, "
        "replica_groups={{0,1},{2,3}}, dimensions={0}",
        "%m = f32[8]{0} multiply(f32[8]{0} %a, f32[8]{0} %a)",
        "%h0d = f32[2,4,8,16]{3,2,1,0} collective-permute-done("
        "f32[2,4,8,16]{3,2,1,0} %h0)",
        "%h1 = f32[2,4,8,16]{3,2,1,0} collective-permute("
        "f32[2,4,8,16]{3,2,1,0} %h0d), channel_id=3, "
        "source_target_pairs={{0,2},{2,0},{1,3},{3,1}}",
        "%ar = f32[4,8]{1,0} all-reduce(f32[4,8]{1,0} %l), channel_id=4, "
        "replica_groups={{0,2},{1,3}}, to_apply=%add"]),
        dict(context=2, tensor=2)),
}


def _ledger(name):
    text, axes = HLO[name]
    return jcl.ledger_from_hlo(text, mesh=None if axes is None
                               else _mesh(**axes))


def _models(axes=("data", "tensor", "pipe", "moe_ep", "context")):
    """The same alpha-beta parameters in both packages' ``CommModel``."""
    costs = {a: (1e-6 * (i + 1), 1e9 * (i + 2)) for i, a in enumerate(axes)}
    default = (2e-6, 5e10)
    j = jcm.CommModel({a: jcm.AxisCost(*c) for a, c in costs.items()},
                      default=jcm.AxisCost(*default), chip="test")
    t = tcm.CommModel({a: tcm.AxisCost(*c) for a, c in costs.items()},
                      default=tcm.AxisCost(*default), chip="test")
    return j, t


def _close(got, want, path="$"):
    """Key for key, floats to 1e-12 (relative or absolute)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            path, sorted(set(got) ^ set(want)))
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert math.isclose(got, want, rel_tol=1e-12, abs_tol=1e-12), (
            path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name", sorted(HLO))
def test_predict_ledger_equal_jax(name):
    led = _ledger(name)
    j, t = _models()
    _close(t.predict_ledger(led), j.predict_ledger(led))


@pytest.mark.parametrize("name", sorted(HLO))
@pytest.mark.parametrize("inputs", ["step_and_flops", "step", "none"])
def test_comm_report_equal_jax(name, inputs):
    led = _ledger(name)
    j, t = _models()
    step = None if inputs == "none" else 1e-4
    flops = 3e7 if inputs == "step_and_flops" else None
    want = jcm.comm_report(led, step, model=j, xla_flops=flops,
                           peak_flops=1e12)
    got = tcm.comm_report(led, step, model=t, flops=flops, peak_flops=1e12)
    if flops is not None:
        # the port's compute estimate is the hand formula's FLOPs
        assert "formula" in got.pop("verdict_basis")
        assert want.pop("verdict_basis") == "modeled comm vs modeled compute"
    # the port's achieved overlap counts ledger entries, the reference's
    # HLO instructions: the same arithmetic over either
    assert "ledger entries" in got["overlap"].pop("basis")
    want["overlap"].pop("basis")
    _close(got, want)


@pytest.mark.parametrize("name", sorted(HLO))
def test_render_and_overlap_summaries_equal_jax(name):
    led = _ledger(name)
    assert tcl.render_table(led) == jcl.render_table(led)
    assert tcl.tp_pp_overlap(led) == jcl.tp_pp_overlap(led)
    assert tcl.cp_ring_overlap(led) == jcl.cp_ring_overlap(led)
    assert tcl.classify_axes(led["collectives"][0]["axes"]) == \
        jcl.classify_axes(led["collectives"][0]["axes"])


def test_empty_and_missing_ledgers_equal_jax():
    for led in (None, {"collectives": [], "n_collectives": 0}):
        assert tcl.render_table(led) == jcl.render_table(led)
        assert tcl.tp_pp_overlap(led) == jcl.tp_pp_overlap(led)
        assert tcl.cp_ring_overlap(led) == jcl.cp_ring_overlap(led)
    assert tcm.comm_report(None, 1.0) is None


@pytest.mark.parametrize("n", [2, 4])
def test_compression_report_equal_jax(n):
    """A ``compress_policy`` event (the port's ``auto_compress_policy``
    records, the reference model's ledger-convention predictions) and a
    ledger with collectives on two axis sets: the same section."""
    j, t = _models()
    leaves = []
    for i, (elems, compress) in enumerate(((1 << 20, True), (4096, False),
                                           (3 << 18, True))):
        pred = t.predict_compressed("all_reduce", 4 * elems, n,
                                    axes=("data",))
        leaves.append({"leaf": f"l{i}", "elems": elems, "bytes": 4 * elems,
                       "op": "all_reduce", "axes": ["data"],
                       "compress": compress,
                       "ledger_bytes_exact": pred["ledger_bytes_exact"],
                       "ledger_bytes_compressed":
                           pred["ledger_bytes_compressed"]})
    events = [{"kind": "compress_policy", "leaves": leaves[:2]},
              {"leaves": leaves[2:]}]
    led = _ledger("literal")
    led["collectives"].append(dict(led["collectives"][0], axes=[]))
    _close(tcm.compression_report("auto", events, led),
           jcm.compression_report("auto", events, led))
    _close(tcm.compression_report("int8"), jcm.compression_report("int8"))
    assert tcm.COMPRESSION_SCHEMA == jcm.COMPRESSION_SCHEMA


def test_schemas_and_axis_names_equal_jax():
    assert tcl.LEDGER_SCHEMA == jcl.LEDGER_SCHEMA
    assert tcl.AXIS_DIM == jcl.AXIS_DIM
    assert tcl.COLLECTIVE_OPS[:5] == jcl.COLLECTIVE_OPS
    for axes in (("data",), ("tensor",), ("pipe",), ("moe_ep",),
                 ("context",), ("data", "tensor"), (), ("batch", "fsdp")):
        assert tcl.classify_axes(axes) == jcl.classify_axes(axes)


# ------------------------------------------------------------ the recorder


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(0)
    out = {}
    for tag, kw in (("gpt", W.GPT), ("pgpt", W.PARITY_GPT)):
        p = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0),
                                           JGPTConfig(**kw,
                                                      dtype=jnp.float32)))
        out.update({f"{tag}/params/{k}": v for k, v in flatten(p).items()})
        for i in range(W.STEPS):
            for k in ("tokens", "targets"):
                out[f"{tag}/batch{i}/{k}"] = rs.randint(
                    0, kw["vocab_size"], (W.ROWS, kw["max_seq"])
                ).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory, inputs):
    """The 4 ranks, started before JAX's compile so that the two
    overlap."""
    tmp = tmp_path_factory.mktemp("ledger4")
    return W.start("ledger", 4, inputs, tmp), tmp


@pytest.fixture(scope="module")
def world4(launched):
    return W.results(*launched)


@pytest.fixture(scope="module")
def jax_step_hlo(launched, inputs):
    """JAX's ``DataParallel`` with the TP specs at ``sp=True`` on a data 2
    x tensor 2 mesh of the conftest's CPU devices, the same GPT and batch:
    the compiled step's HLO text and its ledger."""
    cfg = JGPTConfig(**W.GPT, dtype=jnp.float32)
    jtpc.reset()
    jtpc.setup_process_groups([("data", 2), ("tensor", 2)],
                              devices=jax.devices()[:4])
    mesh = jtpc.get_view()
    specs = jspecs(cfg, tp_axis="tensor")
    dp = JDP(mesh=mesh)
    opt = optax.adamw(W.LR)
    params = jax.tree.map(jnp.asarray, jinit(jax.random.PRNGKey(0), cfg))
    p = dp.broadcast_params(params, param_specs=specs)
    step = dp.make_train_step(
        lambda q, b: jgpt_loss(q, b, cfg, axis="tensor", sp=True), opt,
        param_specs=specs)
    b = {k: inputs[f"gpt/batch0/{k}"] for k in ("tokens", "targets")}
    hlo = jax.jit(step).lower(p, opt.init(p), dp.shard_batch(b)
                              ).compile().as_text()
    led = jcl.ledger_from_hlo(hlo, mesh=mesh)
    jtpc.reset()
    return hlo, led


def _data_axis_bytes(hlo):
    """The data-axis all-reduce bytes of a compiled data 2 x tensor 2
    step, read from each instruction's RESULT type (an all-reduce's
    result has its operands' shapes): jax 0.9's compiled HLO prints
    operands without their types, which JAX's own parser reads as 0
    bytes."""
    total = 0
    for line in hlo.splitlines():
        m = jcl._INSTR_RE.match(line)
        if m is None or m.group("op") != "all-reduce":
            continue
        gm = jcl._REPLICA_GROUPS_RE.search(line)
        groups = jcl._expand_replica_groups(gm.group(1)) if gm else []
        if sorted(map(sorted, groups)) != [[0, 2], [1, 3]]:
            continue
        total += sum(jcl._shape_bits(d, s) for d, s in
                     jcl._SHAPE_RE.findall(m.group("res"))) // 8
    return total


def test_jax_ledger_of_the_same_step(jax_step_hlo, world4):
    """JAX's ``DataParallel`` with the TP specs at ``sp=True`` on a data 2
    x tensor 2 mesh, the same GPT: its data-axis all-reduce carries every
    grad (the SP partial leaves' too, already summed over the tensor
    axis) and the loss, which the port splits into the ``dp`` bytes and
    the one ``other`` collective over both axes — the same bytes.  Its
    ledger counts XLA's combined all-reduce once and the scanned layers'
    collectives once (the while body), and on jax 0.9's HLO text it reads 0
    bytes (operands printed without types): ROADMAP C."""
    hlo, led = jax_step_hlo
    assert {c["dim"] for c in led["collectives"]} == {"dp", "tp"}
    for out in world4:
        port = out["tpdp_none/ledger"]["per_dim"]
        assert _data_axis_bytes(hlo) == \
            port["dp"]["bytes"] + port["other"]["bytes"]
        assert port["dp"]["ops"] > led["per_dim"]["dp"]["ops"]
        assert port["tp"]["ops"] > led["per_dim"]["tp"]["ops"]


def _leaf_bytes(leaves, partial):
    return sum(int(np.prod(shape)) * size for _, shape, size, p in leaves
               if p == partial)


@pytest.mark.parametrize("regime", ["none", "generic"])
def test_dp_bytes_are_the_reduced_grads(world4, regime):
    """Data 2 x tensor 2 at ``sp=True``: the ``dp`` bytes are every
    reduced grad's bytes (the rank's shards) plus the mean loss's 4; the
    SP partial leaves' grads reduce over data and tensor at once (one
    collective over both axes, dimension ``other``)."""
    for r, out in enumerate(world4):
        led = out[f"tpdp_{regime}/ledger"]
        leaves = out[f"tpdp_{regime}/leaves"]
        assert led["per_dim"]["dp"]["bytes"] == \
            _leaf_bytes(leaves, False) + 4, r
        assert led["per_dim"]["other"]["bytes"] == _leaf_bytes(leaves, True)
        assert {tuple(c["axes"]) for c in led["collectives"]} == {
            ("data",), ("tensor",), ("data", "tensor")}
        assert led["mesh_axes"] == {"data": 2, "tensor": 2}
        assert led["schema"] == "tdp-comm-ledger/v1"


@pytest.mark.parametrize("regime", ["none", "generic"])
def test_op_counts_equal_the_collectives_deltas(world4, regime):
    for out in world4:
        led = out[f"tpdp_{regime}/ledger"]
        by_name = Counter(c["op_name"] for c in led["collectives"]
                          if c["op_name"] is not None)
        assert dict(by_name) == out[f"tpdp_{regime}/collectives"]
        tp = [c for c in led["collectives"] if c["dim"] == "tp"]
        assert {c["op_name"] for c in tp} >= set(
            out[f"tpdp_{regime}/collectives"])


def test_overlap_regimes_differ_in_async_only(world4):
    """``'none'`` waits every collective where it is issued (no async
    entry); ``'generic'`` leaves the DP buckets' all-reduces async with
    later entries inside their windows.  Everything else — each entry's
    op, bytes and axes, and the losses bit for bit — is the same."""
    for out in world4:
        a, b = out["tpdp_none/ledger"], out["tpdp_generic/ledger"]
        assert a["async"]["ops"] == 0 and b["async"]["ops"] > 0
        assert a["async"] != b["async"]
        assert b["async"]["mean_sched_distance"] > 0
        key = [("op", "bytes", "axes", "group_size", "op_name")]
        strip = [{k: c[k] for k in key[0]} for c in a["collectives"]]
        assert strip == [{k: c[k] for k in key[0]}
                         for c in b["collectives"]]
        assert a["total_bytes"] == b["total_bytes"]
        np.testing.assert_array_equal(out["tpdp_none/losses"],
                                      out["tpdp_generic/losses"])
        rep = out["tpdp_generic/report"]
        assert rep["comm"]["overlap"]["async_ops"] == b["async"]["ops"]
        assert rep["comm"]["overlap"]["hidden_ops"] > 0


def test_runreport_comm_section_validates(world4):
    for out in world4:
        for regime in ("none", "generic"):
            rep = out[f"tpdp_{regime}/report"]
            assert validate_runreport(rep) == []
            assert jrep.validate_runreport(rep) == []
            assert rep["comm"]["ledger"]["per_dim"] == \
                out[f"tpdp_{regime}/ledger"]["per_dim"]
            assert rep["comm"]["verdict"] in ("comm-bound", "compute-bound")
            assert "formula" in rep["comm"]["verdict_basis"]


def test_five_helpers_note_their_operands(world4):
    """Each helper once over the tensor group (2 ranks): the op, the
    payload (an all-gather's n shards), the region name; the async
    all-reduce has the shift issued before its wait in its window."""
    for out in world4:
        led, nb = out["helpers/ledger"], int(out["helpers/nbytes"])
        got = [(c["op"], c["bytes"], c["op_name"], c["axes"], c["async"])
               for c in led["collectives"]]
        assert got == [
            ("all-reduce", nb, "reduce_from_tp", ["tensor"], False),
            ("all-gather", 2 * nb, "gather_from_sp", ["tensor"], True),
            ("reduce-scatter", nb, "scatter_to_sp", ["tensor"], False),
            ("collective-permute", nb, "ring_shift", ["tensor"], False),
            ("all-to-all", nb, None, ["tensor"], False),
            ("all-reduce", nb, "zero_all_reduce", ["tensor"], True),
            ("collective-permute", nb, "ring_shift", ["tensor"], False)]
        assert led["collectives"][5]["sched_distance"] == 1
        assert led["collectives"][5]["overlapped_idx"] == [6]
        assert led["collectives"][1]["sched_distance"] == 0
        assert dict(Counter(c["op_name"] for c in led["collectives"]
                            if c["op_name"] is not None)
                    ) == out["helpers/collectives"]


def test_pipeline_tp_pp_overlap(world4):
    """Pipe 2 x tensor 2, 1F1B with sharded transfers: the stage's sends
    are ``pp`` collective-permutes (``MICRO`` a stage: activations
    forward from stage 0, cotangents back from stage 1, each the state
    sliced over the tensor group), the transfers' gathers ``tp``; the
    exchanges wait where they are posted, so ``tp_pp_overlap`` reports no
    async window."""
    cfg = W.GPT
    state = 2 * cfg["max_seq"] * cfg["dim"] * 4 // 2
    for out in world4:
        led = out["pipe/ledger"]
        perms = [c for c in led["collectives"]
                 if c["op"] == "collective-permute"]
        assert len(perms) == W.MICRO
        assert all(c["dim"] == "pp" and c["bytes"] == state for c in perms)
        assert led["per_dim"]["tp"]["ops"] > 0
        ov = tcl.tp_pp_overlap(led)
        assert ov == jcl.tp_pp_overlap(led)
        assert ov["pp_async_ops"] == 0 and ov["tp_ops_in_pp_windows"] == 0


def test_cp_ring_hops_counted_per_trip(world4):
    """Data 2 x context 2, the ring GPT's loss and backward: each layer's
    ring sends (k, v) stacked ``cp - 1`` hops forward and ``cp - 1``
    back — ``2 L (cp - 1)`` hops of ``2 B Hkv s hd`` f32 each.  With the
    shift's note taken out the count misses."""
    cp, L = 2, W.GPT["nlayers"]
    s, hd = W.GPT["max_seq"] // cp, W.GPT["dim"] // W.GPT["nheads"]
    hop = 2 * 2 * W.GPT["nheads"] * s * hd * 4
    for out in world4:
        ov = tcl.cp_ring_overlap(out["ring/ledger"])
        assert ov == jcl.cp_ring_overlap(out["ring/ledger"])
        assert ov["cp_hops"] == 2 * L * (cp - 1)
        assert ov["cp_hop_bytes"] == 2 * L * (cp - 1) * hop
        assert out["ring/ledger"]["per_dim"] == {
            "cp": {"bytes": 2 * L * (cp - 1) * hop,
                   "ops": 2 * L * (cp - 1)}}
        assert tcl.cp_ring_overlap(out["ring_fault/ledger"])["cp_hops"] \
            != 2 * L * (cp - 1)


