"""The port's planner (``dist/autoplan.py``), its command line
(``tools/autoplan.py``), ``transformer_param_specs`` and the SLURM
babysitter (``tools/slurm_job_monitor.py``) against the JAX package's, on
the CPU.

- Modeled side, on the reference's ``TINY`` and ``MOE_TINY``, the
  transformer family, awkward chip counts and pipeline candidates: both
  packages get the same comm-model table (``AxisCost`` / ``CommModel``
  of each package, the same numbers) and the same ``effective_flops``;
  the port's ``plan`` and ``plan_prefill_tier`` must give JAX's
  candidate keys, ranked order, pruned set and verdict, and every
  per-term time within 1e-9 relative (the same formulas, summed in the
  same order).  Memory is compared with the reference's f32 moments
  (``opt_itemsize=4``); the port's own rule (moments in the parameters'
  dtype) is held byte for byte against its ``MemoryModel``, and
  ``spec_table`` against ``plan_param_specs``.
- Executable side, in one launch of 4 JAX-free
  ``tests/_torch_autoplan_worker.py`` processes over gloo: every
  executable plan of ``TINY`` for 4 chips (the top 3 first) built by
  ``build_groups`` / ``make_plan_step`` on JAX's initial weights, one
  AdamW step each on one global batch; each loss within 1e-5 relative of
  JAX's serial ``gpt_loss`` on the same weights and batch (f32; the
  plans sum in other orders).  The measured seconds go through
  ``attach_measured`` into a section that must validate; their order is
  disclosed, not gated (steps over gloo are unsteady).
- The CLI's table and JSON line (the JSON equal to JAX's CLI on the same
  config), exit 1 on all-OOM and 2 on an unreadable config; the SLURM
  monitor with ``subprocess`` mocked, as JAX's ``tests/test_tools.py``.
"""

import json
import math
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.dist import autoplan as jap
from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import gpt_loss as jgpt_loss
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.obs.comm_model import AxisCost as JAxisCost
from torchdistpackage_tpu.obs.comm_model import CommModel as JCommModel
from torchdistpackage_tpu_torch.dist import autoplan as ap
from torchdistpackage_tpu_torch.models import GPTConfig
from torchdistpackage_tpu_torch.obs.comm_model import AxisCost, CommModel
from torchdistpackage_tpu_torch.obs.events import default_event_log
from torchdistpackage_tpu_torch.obs.report import _validate_autoplan

sys.path.insert(0, str(Path(__file__).parent))
import _torch_autoplan_worker as W  # noqa: E402
from _torch_ep_worker import flatten  # noqa: E402

#: the same model both packages plan
TINY_DICT = {**W.TINY, "dtype": "float32"}
TINY = GPTConfig(**W.TINY, dtype=torch.float32)
JTINY = JGPTConfig(**W.TINY, dtype=jnp.float32)
MOE = dict(vocab_size=64, dim=32, nheads=4, nlayers=4, max_seq=32,
           moe_experts=4, moe_top_k=2, moe_every=2, moe_capacity_factor=2.0)
MOE_TINY = GPTConfig(**MOE, dtype=torch.float32)
JMOE_TINY = JGPTConfig(**MOE, dtype=jnp.float32)
#: awkward chip counts: every shardable dim divisible by 2 and 3
WIDE = dict(TINY_DICT, nheads=12, dim=96, vocab_size=768)
TRANSFORMER = {"dim": 64, "nheads": 4, "nlayers": 3, "ffn_mult": 4,
               "seq": 128, "dtype": "float32"}
LLAMA = dict(vocab_size=256, dim=64, nheads=8, nlayers=2, max_seq=64,
             kv_heads=2, pos="rope", norm="rms", act="swiglu",
             ffn_hidden=96, dtype="bfloat16")
#: per-term seconds: the same formulas in the same order
REL = 1e-9
#: the plans' step-1 losses against JAX's serial loss (f32, ~6.2)
LOSS_REL = 1e-5


def _models():
    return (W.cpu_model(JAxisCost, JCommModel),
            W.cpu_model(AxisCost, CommModel))


def _close(a, b):
    return math.isclose(a, b, rel_tol=REL, abs_tol=1e-300)


def _assert_same_plan(j, t):
    """Keys, order, pruned set, verdict, counts, and every time."""
    assert t["verdict"] == j["verdict"]
    assert (t["n_candidates"], t["n_pruned_oom"]) == (j["n_candidates"],
                                                      j["n_pruned_oom"])
    assert [p["key"] for p in t["pruned"]] == [p["key"] for p in j["pruned"]]
    for pt, pj in zip(t["pruned"], j["pruned"]):
        assert pt["total_bytes"] == pj["total_bytes"], pt["key"]
    assert [r["key"] for r in t["ranked"]] == [r["key"] for r in j["ranked"]]
    for rt, rj in zip(t["ranked"], j["ranked"]):
        for k in ("compute_s", "comm_s", "step_s"):
            assert _close(rt[k], rj[k]), (rt["key"], k)
        for k in ("dp", "tp", "pp", "layout", "mesh_axes", "compress",
                  "pp_schedule", "bubble_fraction"):
            assert rt[k] == rj[k], (rt["key"], k)
        for k in ("params_bytes", "grads_bytes", "opt_bytes", "act_bytes",
                  "total_bytes", "verdict"):
            assert rt["memory"][k] == rj["memory"][k], (rt["key"], k)
    if j["chosen"]:
        tt, tj = t["chosen"]["terms"], j["chosen"]["terms"]
        assert [x["name"] for x in tt] == [x["name"] for x in tj]
        for xt, xj in zip(tt, tj):
            assert (xt["op"], xt["axes"], xt["n"], xt["payload_bytes"],
                    xt["count"], xt["compressed"]) == (
                xj["op"], xj["axes"], xj["n"], xj["payload_bytes"],
                xj["count"], xj["compressed"])
            for k in ("per_op_s", "total_s", "exact_s"):
                if k in xj:
                    assert _close(xt[k], xj[k]), (xt["name"], k)
        assert t["chosen"]["param_specs"] == j["chosen"]["param_specs"]
    assert _close(t["basis"]["flops_per_token"], j["basis"]["flops_per_token"])


# ------------------------------------------------- the 4-rank world, first


@pytest.fixture(scope="module")
def inputs():
    params = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), JTINY))
    rs = np.random.RandomState(0)
    batch = {k: rs.randint(0, W.TINY["vocab_size"],
                           (W.BATCH, W.TINY["max_seq"])).astype(np.int32)
             for k in ("tokens", "targets")}
    out = {f"params/{k}": v for k, v in flatten(params).items()}
    out.update({f"batch/{k}": v for k, v in batch.items()})
    plan = W.tiny_plan(ap, TINY, W.cpu_model(AxisCost, CommModel))
    out["keys"] = np.asarray(json.dumps([r["key"] for r in plan["ranked"]]))
    return {"npz": out, "params": params, "batch": batch, "plan": plan}


@pytest.fixture(scope="module")
def launched(tmp_path_factory, inputs):
    """The 4 ranks, started before JAX's compile so that the two
    overlap."""
    tmp = tmp_path_factory.mktemp("autoplan4")
    return W.start(4, inputs["npz"], tmp), tmp


@pytest.fixture(scope="module")
def world4(launched):
    return W.results(*launched)


@pytest.fixture(scope="module")
def jax_loss(launched, inputs):
    """JAX's serial ``gpt_loss`` of the initial weights on the batch."""
    params = jax.tree.map(jnp.asarray, inputs["params"])
    batch = {k: jnp.asarray(v) for k, v in inputs["batch"].items()}
    return float(jax.jit(lambda p, b: jgpt_loss(p, b, JTINY))(params, batch))


def test_every_executable_plan_trains_with_the_serial_loss(world4, jax_loss,
                                                           inputs):
    """Every executable plan of TINY at 4 chips — dp (exact and int8
    grads), fsdp, TP + SP, the 1F1B pipe, and their compositions — takes
    one step whose loss is JAX's serial loss within 1e-5 relative, the
    same on every rank; the top 3 are structurally distinct."""
    keys = [r["key"] for r in inputs["plan"]["ranked"]]
    assert {"dp4", "fsdp4", "dp2·tp2", "dp1·pp4"} <= set(keys)
    top3 = inputs["plan"]["ranked"][:3]
    assert len({(r["tp"], r["pp"], r["layout"]) for r in top3}) == 3
    for key in keys:
        losses = [float(r[f"{key}/loss"]) for r in world4]
        assert max(losses) == min(losses), (key, losses)
        assert abs(losses[0] - jax_loss) <= LOSS_REL * abs(jax_loss), (
            key, losses[0], jax_loss)
        assert all(np.isfinite(float(r[f"{key}/gnorm"])) for r in world4)


def test_attach_measured_records_the_top3(world4, inputs):
    """The top 3's modeled step against each one's measured step (rank
    0's wall seconds): rel errors and both orders recorded, the section
    valid; the orders are disclosed, not gated."""
    result = json.loads(json.dumps(inputs["plan"]))
    rows = [{"key": r["key"], "modeled_step_s": r["step_s"],
             "measured_step_s": float(world4[0][f"{r['key']}/seconds"])}
            for r in result["ranked"][:3]]
    ap.attach_measured(result, rows)
    mvm = result["modeled_vs_measured"]
    assert _validate_autoplan(result) == []
    assert len(mvm["rows"]) == 3 and all(r["rel_err"] is not None
                                         for r in mvm["rows"])
    assert sorted(mvm["measured_order"]) == sorted(mvm["modeled_order"])


# ------------------------------------------------------------ modeled side


@pytest.mark.parametrize("config,n_chips,batch,kw", [
    (TINY_DICT, 8, 8, {}),
    (TINY_DICT, 8, 8, {"capacity_bytes": 6_000_000}),
    (TINY_DICT, 8, 8, {"executable_only": True}),
    (TINY_DICT, 4, 8, {"allow_pp": False, "compression": False}),
    (WIDE, 6, 12, {}),
    (WIDE, 24, 24, {}),
    (TRANSFORMER, 4, 8, {}),
    (LLAMA, 8, 16, {"capacity_bytes": 2_500_000, "microbatches": 4}),
    (TINY_DICT, 8, 8, {"capacity_bytes": 4096}),
], ids=["tiny8", "tiny8-pruned", "tiny8-exec", "tiny4-nopp", "wide6",
        "wide24", "transformer4", "llama8-pruned", "all-oom"])
def test_plan_matches_jax(config, n_chips, batch, kw):
    jm, tm = _models()
    common = dict(memory="analytic", emit=False, top=1000,
                  effective_flops=W.EFFECTIVE_FLOPS, **kw)
    j = jap.plan(config, n_chips, batch, comm_model=jm, **common)
    t = ap.plan(config, n_chips, batch, comm_model=tm, opt_itemsize=4,
                **common)
    assert j["ranked"] or j["verdict"] == "all_oom"
    _assert_same_plan(j, t)
    assert _validate_autoplan(t) == []


@pytest.mark.parametrize("name", ["tiny", "moe"])
def test_plan_over_real_configs_matches_jax(name):
    """Config objects (``memory='auto'``: the MemoryModel over each
    package's own spec tree) plan alike, MoE's ep arms and their
    all-to-all terms included."""
    jm, tm = _models()
    jcfg, tcfg = (JTINY, TINY) if name == "tiny" else (JMOE_TINY, MOE_TINY)
    kw = dict(emit=False, top=1000, effective_flops=W.EFFECTIVE_FLOPS,
              capacity_bytes=10**9)
    j = jap.plan(jcfg, 8, 8, comm_model=jm, **kw)
    t = ap.plan(tcfg, 8, 8, comm_model=tm, opt_itemsize=4, **kw)
    assert t["basis"]["memory"] == j["basis"]["memory"] == "memory-model"
    _assert_same_plan(j, t)
    if name == "moe":
        assert {1, 2, 4} <= {r.get("ep", 1) for r in t["ranked"]}
        d = ap.model_dims(tcfg)
        ep = next(r for r in t["ranked"] if r["ep"] > 1)
        a2a = [x for x in ap.comm_terms(d, ep, 8, tm)
               if x["name"] == "moe-all-to-all"]
        assert a2a and a2a[0]["count"] == 4 * d.n_moe_layers


def test_plan_prefill_tier_matches_jax():
    cfg = {"dim": 32, "nheads": 4, "nlayers": 1, "max_seq": 131072,
           "vocab_size": 64, "kv_heads": 2, "dtype": "float32"}
    jm, tm = _models()
    kw = dict(context_len=131072, chunk=512, block_size=512,
              cp_widths=(1, 2, 3, 4, 8), capacity_bytes=40_000_000,
              effective_flops=W.EFFECTIVE_FLOPS, emit=False)
    j = jap.plan_prefill_tier(cfg, comm_model=jm, **kw)
    t = ap.plan_prefill_tier(cfg, comm_model=tm, **kw)
    assert t["skipped_widths"] == j["skipped_widths"] == [3]
    assert [p["key"] for p in t["pruned"]] == [p["key"] for p in j["pruned"]]
    assert [r["key"] for r in t["ranked"]] == [r["key"] for r in j["ranked"]]
    assert t["chosen"]["key"] == j["chosen"]["key"]
    for rt, rj in zip(t["ranked"], j["ranked"]):
        for k in ("ttft_s", "compute_s", "ring_s"):
            assert _close(rt[k], rj[k]), (rt["key"], k)
        for k in ("ring_hops", "ring_bytes", "mem_bytes", "num_blocks",
                  "memory"):
            assert rt[k] == rj[k], (rt["key"], k)
    for xt, xj in zip(t["chosen"]["terms"], j["chosen"]["terms"]):
        assert xt["name"] == xj["name"] and _close(xt["total_s"],
                                                   xj["total_s"])
    bad = ap.plan_prefill_tier(cfg, **dict(kw, cp_widths=(2, 4),
                                           capacity_bytes=1_000_000),
                               comm_model=tm)
    assert bad["verdict"] == "all_oom" and bad["n_pruned_oom"] == 2


def test_shape_table_matches_both_inits():
    """The shape table is each package's real tree: leaf count and bytes
    equal the port's ``_shapes_for_config`` (meta tensors) and the rows
    equal JAX's table field for field."""
    from torchdistpackage_tpu_torch.obs.mem_ledger import _shapes_for_config
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        TransformerConfig,
    )

    llama = GPTConfig(**{**LLAMA, "dtype": torch.float32})
    tfm = TransformerConfig(dim=64, nheads=4, nlayers=3, ffn_mult=4)
    for cfg in (TINY, llama, tfm, MOE_TINY):
        d = ap.model_dims(cfg)
        leaves = list(tree_leaves(_shapes_for_config(cfg)))
        table = ap.param_table(d)
        assert sum(r.count for r in table) == len(leaves)
        assert sum(r.count * math.prod(r.shape) * d.dtype_size
                   for r in table) == sum(l.numel() * l.element_size()
                                          for l in leaves)
    for cfg in (TINY_DICT, LLAMA, TRANSFORMER, {**MOE, "dtype": "float32"}):
        assert ([dataclasses_astuple(r) for r in ap.param_table(
            ap.model_dims(cfg))] == [dataclasses_astuple(r) for r in
                                     jap.param_table(jap.model_dims(cfg))])
        assert ap.flops_per_token(ap.model_dims(cfg)) == jap.flops_per_token(
            jap.model_dims(cfg))


def dataclasses_astuple(row):
    import dataclasses

    return dataclasses.astuple(row)


@pytest.mark.parametrize("opt_itemsize", [None, 4])
def test_analytic_memory_equals_memory_model(opt_itemsize):
    """The analytic mirror equals the port's ``MemoryModel`` over
    ``plan_param_specs`` byte for byte for every candidate — moments in
    the parameters' dtype (the port's AdamW) or f32."""
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        TransformerConfig,
    )

    tfm = TransformerConfig(dim=64, nheads=4, nlayers=3, ffn_mult=4,
                            dtype=torch.bfloat16)
    for cfg, seq in ((TINY, None), (MOE_TINY, None), (tfm, 128),
                     (GPTConfig(**{**LLAMA, "dtype": torch.bfloat16}),
                      None)):
        d = ap.model_dims(cfg)
        for c in ap.enumerate_candidates(d, 8, 8):
            kw = dict(seq_len=seq, capacity_bytes=10**9,
                      opt_itemsize=opt_itemsize)
            a = ap.estimate_memory_analytic(d, c, 8, **kw)
            m = ap.estimate_memory_model(cfg, c, 8, **kw)
            for k in ("params_bytes", "grads_bytes", "opt_bytes",
                      "act_bytes", "total_bytes", "verdict"):
                assert a[k] == m[k], (type(cfg).__name__, c["key"], k)


def test_spec_table_matches_plan_param_specs_and_jax():
    """Leaf by leaf, the port's ``plan_param_specs`` gives the shard
    counts ``spec_table`` renders, and the same axis on the same dim as
    JAX's ``plan_param_specs`` (its PartitionSpec, padded)."""
    from torchdistpackage_tpu.obs.mem_ledger import (
        _shapes_for_config as jshapes,
    )
    from torchdistpackage_tpu_torch.obs.mem_ledger import (
        _shapes_for_config,
        _shard_count,
        _spec_leaves,
    )
    from torchdistpackage_tpu_torch.obs.numerics import tree_paths

    for tcfg, jcfg in ((TINY, JTINY), (MOE_TINY, JMOE_TINY)):
        d = ap.model_dims(tcfg)
        shapes = _shapes_for_config(tcfg)
        jflat, tdef = jax.tree_util.tree_flatten_with_path(jshapes(jcfg))
        for c in ap.enumerate_candidates(d, 8, 8):
            specs = _spec_leaves(shapes, ap.plan_param_specs(c, tcfg))
            got = {}
            for (path, leaf), spec in zip(tree_paths(shapes), specs):
                got[tuple(str(p) for p in path)] = (tuple(leaf.shape), spec)
            total = sum(-(-math.prod(s) // _shard_count(sp, c["mesh_axes"]))
                        for s, sp in got.values())
            assert total == sum(
                r.count * -(-math.prod(r.shape) // ap._leaf_shards(r, c))
                for r in ap.param_table(d)), c["key"]
            jspecs = tdef.flatten_up_to(jap.plan_param_specs(c, jcfg))
            want = {}
            for (path, leaf), spec in zip(jflat, jspecs):
                key = tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                            for p in path)
                entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
                want[key] = (tuple(leaf.shape), tuple(entries))
            assert got == want, c["key"]


def test_transformer_param_specs_match_jax():
    from torchdistpackage_tpu.parallel.tensor_parallel import (
        TransformerConfig as JTransformerConfig,
    )
    from torchdistpackage_tpu.parallel.tensor_parallel import (
        transformer_param_specs as jspecs,
    )
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        TransformerConfig,
        transformer_param_specs,
    )

    for kw in ({}, {"kv_heads": 2, "norm": "rms", "act": "swiglu"}):
        t = transformer_param_specs(TransformerConfig(dim=64, nheads=4,
                                                      nlayers=2, **kw), "tp")
        j = jspecs(JTransformerConfig(dim=64, nheads=4, nlayers=2, **kw),
                   "tp")
        jflat, _ = jax.tree_util.tree_flatten_with_path(
            j, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        want = {tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path): tuple(spec) for path, spec in jflat}
        got = {}
        # the port's tuples are full-rank; JAX's P(...) drops trailing
        # replicated dims

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (str(k),))
            elif isinstance(node, list):
                for i, v in enumerate(node):
                    walk(v, path + (str(i),))
            else:
                got[path] = node
        walk(t, ())
        assert got.keys() == want.keys()
        for path, spec in got.items():
            j = want[path]
            assert spec == j + (None,) * (len(spec) - len(j)), path


def test_events_verdicts_and_compute_basis():
    """An all-OOM plan emits one ``plan_rejected_oom`` a candidate and no
    winner, and validates; a chosen plan emits one ``plan_selected``; a
    recognised card's compute basis is its own measured fraction."""
    log = default_event_log()
    oom0, sel0 = (len(log.of_kind(k)) for k in ("plan_rejected_oom",
                                                  "plan_selected"))
    res = ap.plan(TINY_DICT, 8, 8, memory="analytic", capacity_bytes=4096)
    assert res["verdict"] == "all_oom" and res["chosen"] is None
    assert len(log.of_kind("plan_rejected_oom")) - oom0 == res[
        "n_candidates"]
    assert _validate_autoplan(res) == []
    res = ap.plan(TINY_DICT, 8, 8, memory="analytic")
    assert len(log.of_kind("plan_selected")) == sel0 + 1
    assert log.of_kind("plan_selected")[-1]["key"] == res["chosen"]["key"]
    h100 = ap.plan(TINY_DICT, 8, 8, memory="analytic", emit=False,
                   device_kind="NVIDIA H100 80GB HBM3")
    assert h100["basis"]["compute"] == "peak-table@0.1701"
    assert h100["basis"]["effective_flops"] == 0.1701 * 989e12
    assert ap.plan(TINY_DICT, 8, 8, memory="analytic", emit=False)[
        "basis"]["compute"] == "assumed"
    bad = dict(res, verdict="maybe")
    assert any("verdict" in e for e in _validate_autoplan(bad))


def test_compression_only_when_the_model_approves():
    exact = AxisCost(1e-6, 50e9, "calibrated")
    fast8 = CommModel({"data": exact}, default=exact, source="calibrated",
                      compressed_axis_costs={
                          "data": AxisCost(1e-6, 200e9, "calibrated-int8")})
    slow8 = CommModel({"data": exact}, default=exact, source="calibrated",
                      compressed_axis_costs={
                          "data": AxisCost(5e-4, 1e8, "calibrated-int8")})
    kw = dict(memory="analytic", emit=False, executable_only=True)
    win = ap.plan(TINY_DICT, 8, 8, comm_model=fast8, **kw)["chosen"]
    assert win["compress"]["grads"] is True
    assert next(t for t in win["terms"] if t["compressed"])[
        "model_approves"] is True
    assert ap.plan(TINY_DICT, 8, 8, comm_model=slow8, **kw)["chosen"][
        "compress"]["grads"] is False


def test_build_groups_and_batch_slices_refuse_a_wrong_world():
    """``build_groups`` raises without a world of the plan's size; the
    batch slices of dp 1 and of an MoE plan's ``('data', 'ep')``."""
    c = next(c for c in ap.enumerate_candidates(ap.model_dims(TINY), 4, 8)
             if c["key"] == "dp4")
    with pytest.raises(ValueError, match="plan wants 4"):
        ap.build_groups(c)
    assert ap.batch_partition_spec(dict(c, dp=1)) == ((), 0, 1)
    moe = next(c for c in ap.enumerate_candidates(ap.model_dims(MOE_TINY),
                                                  8, 8) if c["ep"] == 2)
    assert ap.batch_partition_spec(moe)[0] == ("data", "ep")


# --------------------------------------------------------------------- CLI


def test_cli_table_and_json_match_jax(tmp_path, capsys):
    from torchdistpackage_tpu.tools.autoplan import main as jmain
    from torchdistpackage_tpu_torch.tools.autoplan import main

    cfg = tmp_path / "model.json"
    cfg.write_text(json.dumps(TINY_DICT))
    argv = ["--config", str(cfg), "--chips", "8", "--batch", "16",
            "--hbm-gb", "1", "--effective-tflops", "5"]
    assert main(argv + ["--opt-itemsize", "4"]) == 0
    out = capsys.readouterr().out
    assert "chosen:" in out
    line = json.loads(out.strip().splitlines()[-1])
    assert jmain(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == want
    assert line["metric"] == "autoplan" and line["verdict"] == "ok"


def test_cli_all_oom_and_unreadable(tmp_path, capsys):
    from torchdistpackage_tpu_torch.tools.autoplan import main

    cfg = tmp_path / "model.json"
    cfg.write_text(json.dumps(TINY_DICT))
    assert main(["--config", str(cfg), "--chips", "8",
                 "--hbm-gb", "0.00001"]) == 1
    out = capsys.readouterr().out
    assert "NO PLAN FITS" in out
    line = json.loads(out.strip().splitlines()[-1])
    assert line["verdict"] == "all_oom" and line["chosen"] is None
    assert main(["--config", str(tmp_path / "missing.json"),
                 "--chips", "8"]) == 2
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2]")
    assert main(["--config", str(bad), "--chips", "8"]) == 2
    capsys.readouterr()


def test_cli_runs_as_a_module_without_a_card(tmp_path):
    cfg = tmp_path / "model.json"
    cfg.write_text(json.dumps(TINY_DICT))
    proc = subprocess.run(
        [sys.executable, "-m", "torchdistpackage_tpu_torch.tools.autoplan",
         "--config", str(cfg), "--chips", "4"], capture_output=True,
        text=True, timeout=120, cwd=Path(__file__).parent.parent,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["verdict"] == "ok"


# ----------------------------------------------------------- SLURM monitor


def _fake_run(stdout_map):
    def run(cmd, **kw):
        return subprocess.CompletedProcess(cmd, 0,
                                           stdout=stdout_map.get(cmd[0], ""),
                                           stderr="")
    return run


def test_slurm_launch_and_state_parsing():
    from torchdistpackage_tpu_torch.tools import slurm_job_monitor as sjm
    from torchdistpackage_tpu_torch.tools import (
        determine_job_is_alive,
        launch_job,
    )

    with mock.patch.object(sjm.subprocess, "run", side_effect=_fake_run(
            {"sbatch": "Submitted batch job 4242\n"})):
        assert launch_job("train.sbatch") == "4242"
    with mock.patch.object(sjm.subprocess, "run", side_effect=_fake_run(
            {"sacct": "4242  RUNNING\n4242.batch  RUNNING\n"})):
        assert sjm.get_job_state("4242") == "RUNNING"
        assert determine_job_is_alive("4242")
    with mock.patch.object(sjm.subprocess, "run", side_effect=_fake_run(
            {"sacct": "4242  FAILED\n"})):
        assert not determine_job_is_alive("4242")
    with mock.patch.object(sjm.subprocess, "run", side_effect=_fake_run(
            {"sacct": "4242  CANCELLED+\n"})):
        assert sjm.get_job_state("4242") == "CANCELLED"
    with mock.patch.object(sjm.subprocess, "run", side_effect=OSError):
        assert sjm.get_job_state("4242") is None  # sacct down: unknown
    with mock.patch.object(sjm.subprocess, "run", side_effect=_fake_run(
            {"sbatch": "nothing\n"})):
        with pytest.raises(RuntimeError, match="job id"):
            launch_job("train.sbatch")


def test_slurm_monitor_relaunches_until_completed():
    from torchdistpackage_tpu_torch.tools import slurm_job_monitor as sjm

    states = iter(["FAILED", "RUNNING", "COMPLETED"])
    submitted = []

    def run(cmd, **kw):
        if cmd[0] == "sbatch":
            submitted.append(cmd)
            return subprocess.CompletedProcess(
                cmd, 0, stdout=f"Submitted batch job {100 + len(submitted)}"
                               f"\n", stderr="")
        if cmd[0] == "sacct":
            return subprocess.CompletedProcess(
                cmd, 0, stdout=f"{cmd[2]}  {next(states)}\n", stderr="")
        return subprocess.CompletedProcess(cmd, 0, stdout="", stderr="")

    with mock.patch.object(sjm.subprocess, "run", side_effect=run), \
            mock.patch.object(sjm.time, "sleep"):
        assert sjm.monitor_job("train.sbatch", max_relaunches=3) == "102"
    assert len(submitted) == 2
    def always_failed(cmd, **kw):
        out = {"sbatch": "Submitted batch job 7\n",
               "sacct": "7  FAILED\n"}.get(cmd[0], "")
        return subprocess.CompletedProcess(cmd, 0, stdout=out, stderr="")

    with mock.patch.object(sjm.subprocess, "run",
                           side_effect=always_failed), \
            mock.patch.object(sjm.time, "sleep"):
        with pytest.raises(RuntimeError, match="giving up"):
            sjm.monitor_job("train.sbatch", max_relaunches=1)
