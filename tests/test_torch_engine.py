"""The PyTorch serving engine against the JAX engine, on the CPU.

Both engines get the same weights (initialised by JAX, carried over by
``params_from_jax``) and the same staggered request stream; greedy tokens
must be EQUAL.  Two families: a GPT (MHA, learned positions, LayerNorm,
GELU) and a Llama preset with GQA and a sliding window shorter than the
prompts.  The JAX engine runs its gather path (``attn_impl='gather'``);
the port's CPU path is the plain version of the CUDA kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.models import llama_config as jllama
from torchdistpackage_tpu.serving import Request as JRequest
from torchdistpackage_tpu.serving import ServingEngine as JEngine
from torchdistpackage_tpu_torch.models import GPTConfig, llama_config
from torchdistpackage_tpu_torch.models.convert import params_from_jax
from torchdistpackage_tpu_torch.ops.paged_attention import LAUNCHES
from torchdistpackage_tpu_torch.serving import Request, ServingEngine

SMALL = dict(vocab_size=64, dim=64, nheads=4, nlayers=2, max_seq=64)
FAMILIES = {
    "gpt": (lambda: JGPTConfig(**SMALL, dtype=jnp.float32),
            lambda: GPTConfig(**SMALL, dtype=torch.float32)),
    "llama_gqa_window": (
        lambda: jllama(**SMALL, kv_heads=2, ffn_hidden=96,
                       dtype=jnp.float32, sliding_window=6),
        lambda: llama_config(**SMALL, kv_heads=2, ffn_hidden=96,
                             dtype=torch.float32, sliding_window=6)),
}
ENGINE = dict(num_slots=3, block_size=4, chunk=8, max_ctx=48)
PROMPT_LENS = (5, 13, 20)  # one chunk, two chunks, three chunks
NEW = 6


def _prompts():
    rs = np.random.RandomState(0)
    return [rs.randint(0, SMALL["vocab_size"], n).tolist()
            for n in PROMPT_LENS]


def _run_staggered(eng, make_req):
    """Request 0 decodes while 1 and 2 arrive and prefill."""
    prompts = _prompts()
    rids = [eng.submit(make_req(prompts[0], NEW))]
    eng.step()
    eng.step()
    rids += [eng.submit(make_req(p, NEW)) for p in prompts[1:]]
    eng.run_until_idle(max_ticks=500)
    return [np.asarray(eng.finished[r]["tokens"]) for r in rids]


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def pair(request):
    jcfg_fn, tcfg_fn = FAMILIES[request.param]
    jcfg, tcfg = jcfg_fn(), tcfg_fn()
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    jeng = JEngine(jparams, jcfg, attn_impl="gather", **ENGINE)
    want = _run_staggered(jeng, JRequest)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    teng = ServingEngine(tparams, tcfg, device="cpu", **ENGINE)
    got = _run_staggered(teng, Request)
    return {"name": request.param, "want": want, "got": got, "eng": teng,
            "tparams": tparams, "tcfg": tcfg}


def test_greedy_tokens_equal_jax_engine(pair):
    for i, (w, g) in enumerate(zip(pair["want"], pair["got"])):
        np.testing.assert_array_equal(
            g, w, err_msg=f"{pair['name']} request {i}")


def test_audit_clean_and_pool_freed(pair):
    eng = pair["eng"]
    assert eng.audit(heal=False) == {"ok": True, "violations": []}
    assert eng._alloc.in_use == 0
    assert eng._alloc.n_free == eng._alloc.n_usable
    assert eng.stats["faults_detected"] == 0


def test_summary_reports_the_run(pair):
    s = pair["eng"].serving_summary()
    assert s["requests"]["completed"] == len(PROMPT_LENS)
    assert s["generated_tokens"] == NEW * len(PROMPT_LENS)
    assert s["attn_impl"] == "gather"
    assert s["decode_signatures"] == 1 and s["prefill_signatures"] == 1
    # the CPU path is the plain version: the kernel never launched
    assert s["kernel_launches"] == {"paged_decode_attention": 0}
    assert s["kv_pool"]["pool_bytes"] == s["kv_pool"]["pool_bytes_expected"]
    assert set(s["ttft_s"]) == {"p50", "p95", "p99"}
    kinds = {e["kind"] for e in pair["eng"]._ev.as_list()}
    assert {"request_submitted", "request_admitted", "prefill_chunk",
            "request_retired"} <= kinds


def test_int8_pool_greedy_tokens_equal_jax_engine():
    """The int8 block pool (kv_quant=True): same quantisation, same
    tokens as the JAX engine's int8 pool."""
    jcfg_fn, tcfg_fn = FAMILIES["llama_gqa_window"]
    jcfg, tcfg = jcfg_fn(), tcfg_fn()
    jparams = jinit(jax.random.PRNGKey(1), jcfg)
    jeng = JEngine(jparams, jcfg, attn_impl="gather", kv_quant=True,
                   **ENGINE)
    want = _run_staggered(jeng, JRequest)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    teng = ServingEngine(tparams, tcfg, device="cpu", kv_quant=True,
                         **ENGINE)
    got = _run_staggered(teng, Request)
    assert teng.cache["k"][0].dtype == torch.int8
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_sampled_streams_are_deterministic_per_seed(pair):
    """Sampled tokens cannot match JAX's threefry bits; the port's own
    streams depend only on the request's seed, not on its neighbours."""
    cfg, params = pair["tcfg"], pair["tparams"]
    prompts = _prompts()

    def run(extra):
        eng = ServingEngine(params, cfg, device="cpu", **ENGINE)
        reqs = [Request(prompts[0], NEW, temperature=0.8, top_k=20,
                        top_p=0.9, seed=7)] + extra
        rids = [eng.submit(r) for r in reqs]
        eng.run_until_idle(max_ticks=500)
        return np.asarray(eng.finished[rids[0]]["tokens"])

    alone = run([])
    crowded = run([Request(p, NEW, temperature=1.0, seed=11)
                   for p in prompts[1:]])
    np.testing.assert_array_equal(alone, crowded)
    assert len(alone) == len(prompts[0]) + NEW


def test_cancel_frees_blocks(pair):
    cfg, params = pair["tcfg"], pair["tparams"]
    eng = ServingEngine(params, cfg, device="cpu", **ENGINE)
    prompts = _prompts()
    rids = [eng.submit(Request(prompts[i % 3], NEW)) for i in range(4)]
    eng.step()  # three slots admitted, the fourth request queued
    assert eng.cancel(rids[0]) and eng.cancel(rids[3])
    assert eng.cancel(rids[0]) is False
    eng.run_until_idle(max_ticks=500)
    assert eng.finished[rids[0]]["reason"] == "cancelled"
    assert eng.finished[rids[3]]["new_tokens"] == 0
    assert [eng.finished[r]["reason"] for r in rids[1:3]] == [
        "max_tokens", "max_tokens"]
    assert eng.stats["cancelled"] == 2
    assert eng._alloc.in_use == 0
    assert eng.audit(heal=False)["ok"]


def test_audit_heals_a_corrupted_table(pair):
    """A slot whose table row drifted from its owned blocks is caught by
    the per-tick audit, retired, requeued and replayed to the same greedy
    tokens; the pool ends conserved."""
    cfg, params = pair["tcfg"], pair["tparams"]
    prompt = _prompts()[1]

    def run(corrupt):
        eng = ServingEngine(params, cfg, device="cpu", **ENGINE)
        rid = eng.submit(Request(prompt, NEW))
        eng.step()
        if corrupt:
            slot = next(i for i, s in enumerate(eng._slots) if s.rid == rid)
            eng._tables[slot, 0] = eng._tables[slot, 1]
            kinds = {v["kind"] for v in eng.audit(heal=False)["violations"]}
            assert kinds == {"table_mismatch"}
        eng.run_until_idle(max_ticks=500)
        assert eng.audit(heal=False)["ok"] and eng._alloc.in_use == 0
        return eng, np.asarray(eng.finished[rid]["tokens"])

    healed, got = run(corrupt=True)
    assert healed.stats["faults_detected"] == healed.stats["faults_healed"] == 1
    np.testing.assert_array_equal(got, run(corrupt=False)[1])


def test_engine_refuses_queued_options():
    cfg = GPTConfig(**SMALL)
    with pytest.raises(NotImplementedError, match="prefix_cache"):
        ServingEngine(None, cfg, device="cpu", prefix_cache=True)
    # spec_k serves (tests/test_torch_spec_engine.py); a negative one is
    # refused as in the reference
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(None, cfg, device="cpu", spec_k=-1)
    with pytest.raises(TypeError):
        ServingEngine(None, cfg, device="cpu", no_such_option=1)
    eng = ServingEngine(None, cfg, device="cpu", **ENGINE)
    with pytest.raises(NotImplementedError, match="deadline_s"):
        eng.submit(Request([1, 2], 2, deadline_s=1.0))
    with pytest.raises(NotImplementedError, match="preemption"):
        eng.submit(Request([1, 2], 2, priority=1))
    for method in (eng.drain, eng.resume, eng.export_slot, eng.import_slot):
        with pytest.raises(NotImplementedError, match=method.__name__):
            method()
    assert not eng.queue
    # the MoE family serves; what still refuses: expert parallelism on the
    # engine, the non-causal expert-choice router, and moe_dispatch on a
    # dense model
    moe = GPTConfig(**SMALL, moe_experts=4)
    with pytest.raises(NotImplementedError, match="ep_axis"):
        ServingEngine(None, moe, device="cpu", ep_axis="ep", **ENGINE)
    with pytest.raises(ValueError, match="expert_choice"):
        GPTConfig(**SMALL, moe_experts=4, moe_router="expert_choice")
    with pytest.raises(ValueError, match="no MoE"):
        ServingEngine(None, cfg, device="cpu", moe_dispatch="gather",
                      **ENGINE)


def test_default_device_is_the_card():
    """No device argument means CUDA; without a card that is an error,
    never a silent fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(None, GPTConfig(**SMALL), **ENGINE)
    assert LAUNCHES["paged_decode_attention"] == 0
