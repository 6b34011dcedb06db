"""The observability layer on the card, at a small width: a 2-layer
llama engine (bf16, 4 slots, blocks of 16, chunk 64) with and without a
``Telemetry``, a ``Watchdog`` and a metrics sink.

- ``live_memory()`` reports on the card: the caching allocator's live
  and peak bytes and the card's capacity;
- telemetry changes nothing: the same tokens, the same K1 launches (and
  the same count of each K1 body, by the library's own counts), one
  decode signature and no ``recompile``; every decode tick's ``decode``
  and ``fetch`` phases are above 0 (the step's enqueue mark splits the
  call) and the phases make ``tick_s``; the RUNREPORT validates with
  the card's memory reported and the pool's accounting matched;
- ``Telemetry(device=None)`` refuses when no card is seen, as
  ``resolve_device`` does.

Every test is ``gpu``-marked and skips without a CUDA device.  The file
imports neither JAX nor the JAX package::

    python -m pytest --noconftest -m gpu tests/test_torch_obs_cuda.py
"""

import numpy as np
import pytest
import torch

from torchdistpackage_tpu_torch.models import init_gpt_params, llama_config
from torchdistpackage_tpu_torch.obs import (
    JsonlSink,
    Telemetry,
    device_capacity,
    live_memory,
    set_default_event_log,
    validate_runreport,
)
from torchdistpackage_tpu_torch.ops import _build
from torchdistpackage_tpu_torch.ops import paged_attention as pa
from torchdistpackage_tpu_torch.resilience import Watchdog
from torchdistpackage_tpu_torch.serving import Request, ServingEngine

pytestmark = pytest.mark.gpu

BODIES = ("paged_tc_kernel", "paged_split_kernel", "paged_merge_kernel",
          "paged_walk_kernel")
ENGINE = dict(num_slots=4, block_size=16, chunk=64, max_ctx=512)


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = llama_config(vocab_size=512, dim=256, nheads=4, nlayers=2,
                       max_seq=1024, kv_heads=1, ffn_hidden=512,
                       dtype=torch.bfloat16)
    params = init_gpt_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0))
    rs = np.random.RandomState(0)
    reqs = [Request(rs.randint(0, 512, n).tolist(), 10)
            for n in (28, 75, 130, 9, 200)]
    return {"cfg": cfg, "params": params, "reqs": reqs}


def _counts():
    return {"K1": pa.LAUNCHES["paged_decode_attention"],
            **{b: _build.body_launches("paged_attention", b)
               for b in BODIES}}


def _serve(model, **kw):
    eng = ServingEngine(model["params"], model["cfg"], **ENGINE, **kw)
    rids = [eng.submit(r) for r in model["reqs"]]
    before = _counts()
    eng.run_until_idle()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _counts().items()}
    return eng, launched, [eng.finished[r]["tokens"] for r in rids]


def test_live_memory_reports_on_the_card(model):
    mem = live_memory()
    assert mem["reported"] and mem["live_bytes"] > 0
    assert mem["peak_bytes"] >= mem["live_bytes"]
    cap = torch.cuda.get_device_properties(0).total_memory
    assert device_capacity() == cap == mem["per_device"][0]["bytes_limit"]
    assert 0 < mem["peak_frac"] < 1


def test_telemetry_changes_no_token_and_no_launch(model, tmp_path):
    plain, want_k, want = _serve(model)
    tel = Telemetry(run="obs-cuda", report_path=str(tmp_path / "R.json"),
                    trace_path="")
    try:
        with Watchdog(timeout_s=60) as dog:
            eng, got_k, got = _serve(
                model, telemetry=tel, watchdog=dog,
                metrics_sink=JsonlSink(str(tmp_path / "m.jsonl")))
        tel.record_serving(eng.serving_summary())
        rep = tel.finalize(print_summary=False)
    finally:
        set_default_event_log(None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got_k == want_k and got_k["K1"] > 0
    s = eng.serving_summary()
    assert got_k["K1"] == model["cfg"].nlayers * (
        s["prefill_chunks"] + s["decode_steps"])
    assert s["decode_signatures"] == 1
    kinds = [e["kind"] for e in tel.events.as_list()]
    assert kinds.count("compile") == 1 and "recompile" not in kinds
    assert rep["backend"] == "gpu"
    assert rep["chip"] == torch.cuda.get_device_name(0)
    assert validate_runreport(rep) == []
    assert rep["memory"]["reported"]
    assert rep["memory"]["kv_pool"]["accounting_match"] is True
    decode_ticks = [r for r in eng.tick_records if r["decode_slots"]]
    assert decode_ticks
    for r in eng.tick_records:
        assert abs(sum(r["phases"].values()) - r["tick_s"]) < 1e-6
    for r in decode_ticks:
        assert r["phases"]["decode"] > 0 and r["phases"]["fetch"] > 0


def test_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Telemetry()
