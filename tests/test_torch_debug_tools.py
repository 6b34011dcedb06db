"""The port's debug and observability tools against the JAX package's, on
the CPU.

- ``tools.debug_nan``: ``check_tensors`` paths and counts, and
  ``find_nan_block``'s answer and ``nan_block_located`` event, equal to
  JAX's on the same numpy trees and block functions; ``nan_guard`` and
  ``enable_nan_debug`` (the port's eager guard and autograd's anomaly
  mode).
- ``tools.profiler``: ``aggregate_levels`` / ``report_prof`` /
  ``report_tree`` equal to JAX's on the same profiles; ``profile_blocks``
  and ``find_nan_block`` over a tiny GPT's blocks.
- ``obs.mem_ledger.MemoryModel`` against JAX's on a stand-in mesh, as
  exact integers, params given and derived from the config (the port on
  the ``meta`` device).
- ``obs.trace.ProfilerStepWindow``'s events against JAX's
  ``XlaStepTrace`` over the same step loop, and its ``Telemetry`` wiring.
- ``pipeline_zb_1f1b``'s ``zb_*`` events: JAX's fields (JAX
  ``zero_bubble.py:148-160``) at (M, P) from JAX's own tick functions.
- ``utils.profiling``: ``TimedScope``, ``scope_decorator``, the
  ``prof_start`` / ``prof_stop`` window.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import gpt_param_specs as jspecs
from torchdistpackage_tpu.obs import aggregate as jagg
from torchdistpackage_tpu.obs import events as jevents
from torchdistpackage_tpu.obs.mem_ledger import MemoryModel as JMemoryModel
from torchdistpackage_tpu.obs.trace import XlaStepTrace
from torchdistpackage_tpu.parallel.pipeline_parallel import zero_bubble as jzb
from torchdistpackage_tpu.tools import debug_nan as jdbg
from torchdistpackage_tpu.tools import profiler as jprof
from torchdistpackage_tpu_torch.models import GPTConfig, init_gpt_params
from torchdistpackage_tpu_torch.models.gpt import gpt_param_specs, layer_params
from torchdistpackage_tpu_torch.obs import (
    EventLog,
    MemoryModel,
    ProfilerStepWindow,
    Telemetry,
    set_default_event_log,
)
from torchdistpackage_tpu_torch.parallel.pipeline_parallel import (
    zero_bubble as tzb,
)
from torchdistpackage_tpu_torch.parallel.tensor_parallel.layers import (
    block_forward,
)
from torchdistpackage_tpu_torch.tools import debug_nan as tdbg
from torchdistpackage_tpu_torch.tools import profiler as tprof
from torchdistpackage_tpu_torch.utils import (
    TimedScope,
    prof_start,
    prof_stop,
    scope_decorator,
)

GPT = dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=16,
           ffn_mult=2)


@pytest.fixture()
def logs():
    jlog, tlog = jevents.EventLog(), EventLog()
    jevents.set_default_event_log(jlog)
    set_default_event_log(tlog)
    yield {"jax": jlog, "torch": tlog}
    jevents.set_default_event_log(None)
    set_default_event_log(None)


def _events(log, kinds):
    return [{k: v for k, v in e.items() if k not in ("t_mono", "t_wall",
                                                     "process", "type")}
            for e in log.as_list() if e["kind"] in kinds]


# ------------------------------------------------------------- debug_nan


def _nan_tree():
    rs = np.random.RandomState(0)
    t = {"a": rs.standard_normal((3, 4)).astype(np.float32),
         "blocks": [{"w": rs.standard_normal(5).astype(np.float32)},
                    {"w": rs.standard_normal(5).astype(np.float32)}],
         "ids": np.arange(4, dtype=np.int32)}
    t["a"][1, 2] = np.nan
    t["blocks"][1]["w"][[0, 3]] = [np.inf, -np.inf]
    return t


def test_check_tensors_paths_match_jax(logs):
    t = _nan_tree()
    want = jdbg.check_tensors(jax.tree.map(jnp.asarray, t), name="grads",
                              emit=True)
    got = tdbg.check_tensors(jax.tree.map(torch.from_numpy, t),
                             name="grads", emit=True)
    assert got == want == ["grads/a (nan=1, inf=0)",
                           "grads/blocks/1/w (nan=0, inf=2)"]
    assert _events(logs["torch"], {"nan_watchdog"}) == \
        _events(logs["jax"], {"nan_watchdog"})
    with pytest.raises(FloatingPointError):
        tdbg.check_model_params(jax.tree.map(torch.from_numpy, t),
                                raise_on_bad=True)
    clean = {"w": torch.ones(3)}
    assert tdbg.check_tensors(clean) == []


def test_find_nan_block_matches_jax(logs):
    x = np.linspace(-1, 1, 6, dtype=np.float32)
    jblocks = [("enc/0", lambda v: v * 2), ("enc/1", lambda v: jnp.log(v)),
               ("head", lambda v: v + 1)]
    tblocks = [("enc/0", lambda v: v * 2), ("enc/1", lambda v: torch.log(v)),
               ("head", lambda v: v + 1)]
    jname, jout = jdbg.find_nan_block(jblocks, jnp.asarray(x))
    tname, tout = tdbg.find_nan_block(tblocks, torch.from_numpy(x))
    assert tname == jname == "enc/1"
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert _events(logs["torch"], {"nan_block_located"}) == \
        _events(logs["jax"], {"nan_block_located"})
    none, _ = tdbg.find_nan_block(tblocks[:1], torch.from_numpy(x))
    assert none is None


def test_nan_guard_and_anomaly_mode(logs):
    @tdbg.nan_guard(name="fwd")
    def fwd(x):
        return {"y": x / x.sum(), "n": torch.arange(3)}

    assert torch.allclose(fwd(torch.ones(4))["y"], torch.full((4,), 0.25))
    with pytest.raises(FloatingPointError, match="fwd"):
        fwd(torch.zeros(4))
    ev = _events(logs["torch"], {"nan_watchdog"})
    assert ev == [{"kind": "nan_watchdog", "fn": "fwd", "source": "nan_guard",
                   "n_bad": 1, "n_leaves": 1}]
    tdbg.enable_nan_debug(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        tdbg.enable_nan_debug(False)
    assert not torch.is_anomaly_enabled()


# -------------------------------------------------------------- profiler


def _profiles(mod):
    rs = np.random.RandomState(1)
    names = ["enc/blocks/0/attn", "enc/blocks/0/mlp", "enc/blocks/1/attn",
             "enc/blocks/1/mlp", "enc/ln", "head", "loss"]
    return [mod.BlockProfile(name=n, time_ms=float(rs.uniform(0.1, 2)),
                             act_bytes=int(rs.randint(1, 10**7)),
                             flops=float(rs.uniform(0, 1e9)),
                             bytes_accessed=float(rs.uniform(0, 1e8)),
                             temp_bytes=int(rs.randint(0, 10**6)))
            for n in names]


def test_aggregate_levels_and_reports_match_jax():
    want = jprof.aggregate_levels(_profiles(jprof))
    got = tprof.aggregate_levels(_profiles(tprof))
    assert sorted(got) == sorted(want) == [1, 2, 3, 4]
    for d in want:
        assert [dataclasses.astuple(p) for p in got[d]] == \
            [dataclasses.astuple(p) for p in want[d]]
    assert tprof.report_tree(_profiles(tprof)) == \
        jprof.report_tree(_profiles(jprof))
    assert tprof.report_prof(_profiles(tprof), sort_by_ratio=False) == \
        jprof.report_prof(_profiles(jprof), sort_by_ratio=False)
    assert tprof.aggregate_levels([]) == {}


def _gpt_blocks(params, cfg):
    return [(f"blocks/{i}", lambda h, p=layer_params(params, i):
             block_forward(p, h, cfg.block))
            for i in range(cfg.nlayers)]


def test_profile_blocks_and_nan_block_on_a_gpt(logs):
    cfg = GPTConfig(**GPT, dtype=torch.float32)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    h = torch.randn(2, cfg.max_seq, cfg.dim,
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        profs, out = tprof.profile_blocks(_gpt_blocks(params, cfg), h,
                                          warmup=0, iters=1)
        assert [p.name for p in profs] == ["blocks/0", "blocks/1"]
        assert all(p.act_bytes == h.numel() * 4 and p.time_ms > 0
                   and p.flops == 0.0 == p.bytes_accessed for p in profs)
        assert torch.isfinite(out).all()
        got = tprof.get_model_profile(_gpt_blocks(params, cfg), h,
                                      warmup=0, iters=1, print_report=False)
        assert len(got) == 2
        params["blocks"]["mlp"]["w1"][1, 0, 0] = float("nan")
        name, _ = tdbg.find_nan_block(_gpt_blocks(params, cfg), h)
    assert name == "blocks/1"
    ev = logs["torch"].of_kind("nan_block_located")
    assert ev[0]["index"] == 1 and ev[0]["n_bad"] == 1
    with pytest.raises(ValueError):
        tprof.profile_blocks(_gpt_blocks(params, cfg), h, iters=0)


# ----------------------------------------------------------- MemoryModel


class _Mesh:
    """JAX's MemoryModel reads ``axis_names`` and ``shape``."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


@pytest.mark.parametrize("layout", [
    (("data", 2), ("tensor", 2)), (("pipe", 2), ("tensor", 4)),
    (("data", 8),)])
def test_memory_model_matches_jax(layout):
    sizes = dict(layout)
    tp = "tensor" if "tensor" in sizes else None
    pp = "pipe" if "pipe" in sizes else None
    jcfg = JGPTConfig(**GPT, dtype=jnp.float32)
    cfg = GPTConfig(**GPT, dtype=torch.float32)
    meta = init_gpt_params(cfg, torch.Generator().manual_seed(0),
                           device="meta")
    specs = gpt_param_specs(meta, pipe_axis=pp, tp_axis=tp) \
        if (tp or pp) else None
    want = JMemoryModel(capacity_bytes=10**6).estimate(
        jcfg, _Mesh(sizes), jspecs(jcfg, tp_axis=tp, pipe_axis=pp)
        if (tp or pp) else None, batch_per_device=2, seq_len=16)
    for kw in ({}, {"params": meta}):
        got = MemoryModel(capacity_bytes=10**6).estimate(
            cfg, sizes, specs, batch_per_device=2, seq_len=16, **kw)
        for k in ("params_bytes", "grads_bytes", "opt_bytes", "act_bytes",
                  "total_bytes", "frac", "headroom_frac", "verdict",
                  "replicated_leaves", "mesh_axes"):
            assert got[k] == want[k], k
        assert sorted(got["per_leaf"], key=lambda r: r["path"]) == \
            sorted(want["per_leaf"], key=lambda r: r["path"])


def test_memory_model_bf16_moments_and_context(tmp_path):
    """The port's AdamW keeps its moments in the params' dtype: bf16
    params give bf16 moments (``opt_itemsize`` None); a ParallelContext
    layout without process groups gives the axis sizes."""
    from torchdistpackage_tpu_torch.dist.topology import ParallelContext

    cfg = GPTConfig(**GPT, dtype=torch.bfloat16)
    got = MemoryModel().estimate(cfg, {"data": 1}, None)
    n = sum(p.numel() for p in jax.tree.leaves(
        init_gpt_params(cfg, torch.Generator().manual_seed(0),
                        device="meta"), is_leaf=torch.is_tensor))
    assert got["params_bytes"] == 2 * n and got["opt_bytes"] == 4 * n
    assert MemoryModel(opt_itemsize=4).estimate(
        cfg, {"data": 1}, None)["opt_bytes"] == 8 * n
    ctx = ParallelContext()
    ctx.setup_process_groups([("data", 2), ("tensor", 2)], world_size=4,
                             rank=0)
    assert MemoryModel().estimate(cfg, ctx, None)["mesh_axes"] == {
        "data": 2, "tensor": 2}


# ------------------------------------------------------- the step window


def test_profiler_window_events_match_xla_step_trace(tmp_path, logs):
    jt = XlaStepTrace(str(tmp_path / "jax"), trace_steps=(1, 2))
    win = ProfilerStepWindow(str(tmp_path / "torch"), trace_steps=(1, 2))
    for i in range(4):
        jt.on_step_start(i)
        win.on_step_start(i)
        jax.block_until_ready(jnp.ones(3) * i)
        torch.ones(3).mul_(i)
        jt.on_step_end(i)
        win.on_step_end(i)
    rename = {"xla_trace_start": "profile_window_start",
              "xla_trace_stop": "profile_window_stop"}
    want = [(rename[e["kind"]], e["step"]) for e in logs["jax"].as_list()]
    got = [(e["kind"], e["step"]) for e in logs["torch"].as_list()]
    assert got == want == [("profile_window_start", 1),
                           ("profile_window_stop", 2)]
    assert os.path.getsize(win.trace_file) > 0 and win.done
    with pytest.raises(ValueError):
        ProfilerStepWindow(str(tmp_path), trace_steps=(3, 2))


def test_profiler_window_through_telemetry(tmp_path, logs, monkeypatch):
    """``Telemetry(profile_window=)`` opens the window before the wrapped
    call of step ``first`` and closes it at step ``last``'s end; a window
    still open at ``finalize`` is closed there; a profiler that cannot
    start emits ``profile_window_failed`` and the run goes on."""
    win = ProfilerStepWindow(str(tmp_path / "a"), trace_steps=(1, 2))
    tel = Telemetry(device="cpu", profile_window=win, report_path="",
                    trace_path="", event_log=logs["torch"])
    step = tel.wrap_step(lambda x: x * 2)
    for i in range(4):
        step(torch.ones(2))
        tel.end_step(step=i, loss=1.0)
    late = ProfilerStepWindow(str(tmp_path / "b"), trace_steps=(3, 9))
    tel2 = Telemetry(device="cpu", profile_window=late, report_path="",
                     trace_path="", event_log=logs["torch"])
    step2 = tel2.wrap_step(lambda x: x * 2)
    for i in range(4):
        step2(torch.ones(2))
        tel2.end_step(step=i, loss=1.0)
    tel2.finalize(print_summary=False)

    def broken(*a, **k):
        raise RuntimeError("no profiler here")
    monkeypatch.setattr(torch.profiler, "profile", broken)
    bad = ProfilerStepWindow(str(tmp_path / "c"), trace_steps=(0, 0))
    bad.on_step_start(0)
    bad.on_step_end(0)
    got = [(e["kind"], e["step"]) for e in logs["torch"].as_list()
           if e["kind"].startswith("profile_window")]
    assert got == [("profile_window_start", 1), ("profile_window_stop", 2),
                   ("profile_window_start", 3), ("profile_window_stop", 9),
                   ("profile_window_failed", 0)]
    assert os.path.exists(win.trace_file) and os.path.exists(late.trace_file)
    assert bad.done and not bad.active and bad.trace_file is None


# --------------------------------------------------------- zero bubble


@pytest.mark.parametrize("M,P", [(4, 2), (8, 4), (3, 3)])
def test_zb_events_carry_jax_fields(logs, monkeypatch, M, P):
    """The fields the reference's trace-time emission carries (its tick
    functions and bubble arithmetic), once for each call of the port's
    eager schedule (the schedule itself stubbed out)."""
    monkeypatch.setattr(tzb, "_group", lambda axis, group: None)
    monkeypatch.setattr(tzb, "num_stages", lambda axis, group: P)
    monkeypatch.setattr(tzb, "_make_stage", lambda *a: None)
    monkeypatch.setattr(tzb, "_run_stage", lambda *a: ("loss", "grads"))
    for _ in range(2):
        assert tzb.pipeline_zb_1f1b(None, None, None, None, None, None, M) \
            == ("loss", "grads")
    T1, T2 = jzb.zb_schedule_ticks(M, P)
    want = [
        {"kind": "zb_wgrad_deferred", "units": M, "pipe_size": P,
         "queue_slots": M,
         "note": "wgrad work items (x, g, dx) queued per microbatch at "
                 "trace time; executed in the drain scan"},
        {"kind": "zb_cooldown_filled", "main_ticks": T1, "wgrad_ticks": T2,
         "pipe_size": P, "num_microbatches": M,
         "bubble_fraction": jagg.pipeline_bubble_fraction(M, P,
                                                          schedule="zb"),
         "bubble_fraction_1f1b": jagg.pipeline_bubble_fraction(
             M, P, schedule="1f1b")}] * 2
    assert _events(logs["torch"], {"zb_wgrad_deferred",
                                   "zb_cooldown_filled"}) == want


# ------------------------------------------------------------- profiling


def test_profiling_ranges_and_timed_scope(tmp_path):
    @scope_decorator(name="my_block")
    def block(x):
        return x @ x

    x = torch.randn(16, 16)
    with torch.profiler.profile() as prof:
        block(x)
    assert "my_block" in {e.name for e in prof.events()}
    with TimedScope("fwd") as t:
        y = block(x)
        t.sync_on(y)
    assert t.elapsed is not None and t.elapsed > 0
    prof_start(str(tmp_path / "win"))
    with pytest.raises(RuntimeError):
        prof_start(str(tmp_path / "again"))
    block(x)
    path = prof_stop()
    assert os.path.getsize(path) > 0 and prof_stop() is None
