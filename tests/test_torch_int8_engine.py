"""The int8 weight-only serving slice against the JAX engine, on the CPU,
in f32 at small widths, with staggered admission: the port's
``ServingEngine`` gives greedy tokens EQUAL to JAX's ``ServingEngine``.

- **Mixtral-style, int8 experts** (RMSNorm, RoPE, GQA, SwiGLU experts in
  every block; every expert layer's weights ``quantize_moe_experts``
  pairs).  The port serves them through ``moe_dispatch='cuda'`` (on the
  CPU, K6's int8 plain version).  JAX's engine cannot run int8 expert
  leaves on this tree (its ragged arm raises AttributeError, its Pallas
  arm does not build), so it runs the ``'gather'`` arm on the same
  experts ``_dequant``-ed to f32 — the same function.  The ``moe``
  summaries are equal too.
- **The same, fully int8**: ``quantize_decode_params`` on top (attention
  ``wq`` / ``wkv`` / ``wo`` and the head), which JAX's engine runs.
- **Dense GPT under ``quantize_decode_params``** (stacked fused ``wqkv``,
  scales ``[L, 3, 1, D]``): JAX's engine on the same tree.

One JAX engine per family, in a module fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import init_gpt_moe_params as jinit_moe
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.models import llama_config as jllama
from torchdistpackage_tpu.ops import moe_dispatch as jmd
from torchdistpackage_tpu.serving import Request as JRequest
from torchdistpackage_tpu.serving import ServingEngine as JEngine
from torchdistpackage_tpu.tools import surgery as js
from torchdistpackage_tpu_torch.models import GPTConfig, llama_config
from torchdistpackage_tpu_torch.models.convert import params_from_jax
from torchdistpackage_tpu_torch.obs.numerics import tree_bytes
from torchdistpackage_tpu_torch.serving import Request, ServingEngine
from torchdistpackage_tpu_torch.tools.surgery import QuantizedLinear

MIXTRAL_STYLE = dict(vocab_size=64, dim=64, nheads=4, nlayers=2,
                     max_seq=32, kv_heads=2, ffn_hidden=96, moe_experts=4,
                     moe_every=1)
GPT = dict(vocab_size=64, dim=64, nheads=4, nlayers=2, max_seq=32)
ENGINE = dict(num_slots=3, block_size=4, chunk=4, max_ctx=32)
PROMPT_LENS = (5, 9, 13)  # two, three and four prefill chunks
NEW = 6
MIN_SIZE = 1024  # quantize_decode_params' floor, cut to these widths


def _prompts():
    rs = np.random.RandomState(0)
    return [rs.randint(0, 64, n).tolist() for n in PROMPT_LENS]


def _run_staggered(eng, make_req):
    """Request 0 prefills and decodes while 1 and 2 arrive."""
    prompts = _prompts()
    rids = [eng.submit(make_req(prompts[0], NEW))]
    eng.step()
    eng.step()
    rids += [eng.submit(make_req(p, NEW)) for p in prompts[1:]]
    eng.run_until_idle(max_ticks=500)
    return [np.asarray(eng.finished[r]["tokens"]) for r in rids]


def _moe_trees(decode_int8):
    """(JAX tree with int8 experts, the same with the experts
    ``_dequant``-ed to f32): what the port serves, what JAX's engine
    serves."""
    jcfg = jllama(**MIXTRAL_STYLE, dtype=jnp.float32)
    jparams = jinit_moe(jax.random.PRNGKey(0), jcfg)
    for b in jparams["blocks"]:
        b["moe"]["experts"] = jmd.quantize_moe_experts(b["moe"]["experts"])
    if decode_int8:
        jparams = js.quantize_decode_params(jparams, min_size=MIN_SIZE)
    deq = dict(jparams, blocks=[
        dict(b, moe=dict(b["moe"], experts=dict(
            b["moe"]["experts"],
            w1=jmd._dequant(b["moe"]["experts"]["w1"]),
            w2=jmd._dequant(b["moe"]["experts"]["w2"]))))
        for b in jparams["blocks"]])
    return jcfg, jparams, deq


FAMILIES = ("mixtral_int8_experts", "mixtral_int8_all", "gpt_int8_decode")


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    name = request.param
    if name == "gpt_int8_decode":
        jcfg = JGPTConfig(**GPT, dtype=jnp.float32)
        tcfg = GPTConfig(**GPT, dtype=torch.float32)
        served = js.quantize_decode_params(
            jinit(jax.random.PRNGKey(0), jcfg), min_size=MIN_SIZE)
        jeng = JEngine(served, jcfg, attn_impl="gather", **ENGINE)
        kw = {}
    else:
        jcfg, served, deq = _moe_trees(name == "mixtral_int8_all")
        tcfg = llama_config(**MIXTRAL_STYLE, dtype=torch.float32)
        jeng = JEngine(deq, jcfg, attn_impl="gather", moe_dispatch="gather",
                       **ENGINE)
        kw = {"moe_dispatch": "cuda"}
    want = _run_staggered(jeng, JRequest)
    tparams = params_from_jax(jax.tree.map(np.asarray, served), tcfg,
                              device="cpu")
    eng = ServingEngine(tparams, tcfg, device="cpu", **ENGINE, **kw)
    got = _run_staggered(eng, Request)
    return {"name": name, "want": want, "got": got, "eng": eng,
            "jsummary": jeng.serving_summary(), "tparams": tparams,
            "tcfg": tcfg}


def test_greedy_tokens_equal_jax_engine(family):
    for i, (w, g) in enumerate(zip(family["want"], family["got"])):
        np.testing.assert_array_equal(
            g, w, err_msg=f"{family['name']} request {i}")


def test_int8_leaves_served_and_summary(family):
    """The tree the engine served really is int8 where it should be, the
    run is clean, the CPU path launched no kernel, and for the MoE
    families the expert-load block equals JAX's."""
    tp, eng = family["tparams"], family["eng"]
    s = eng.serving_summary()
    assert s["requests"]["completed"] == len(PROMPT_LENS)
    assert set(s["kernel_launches"].values()) == {0}
    assert eng.audit(heal=False)["ok"] and eng._alloc.in_use == 0
    blocks = tp["blocks"]
    attn = (blocks[0] if isinstance(blocks, list) else blocks)["attn"]
    int8_attn = family["name"] != "mixtral_int8_experts"
    assert all(isinstance(w, QuantizedLinear) == int8_attn
               for k, w in attn.items() if k.startswith("w"))
    assert isinstance(tp["head"], QuantizedLinear) == int8_attn
    if family["name"] == "gpt_int8_decode":
        assert tuple(attn["wqkv"].scale.shape) == (2, 3, 1, 64)
        assert "moe" not in s
        return
    for b in blocks:
        q, scale = b["moe"]["experts"]["w1"]
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
    moe, want = dict(s["moe"]), dict(family["jsummary"]["moe"])
    assert moe.pop("dispatch") == "cuda" and want.pop("dispatch") == "gather"
    for key in want:
        np.testing.assert_allclose(moe[key], want[key], rtol=1e-12,
                                   err_msg=key)
    # int8 experts take half the bytes of bf16, a quarter of f32
    ex = blocks[0]["moe"]["experts"]
    n = sum(ex[k][0].numel() for k in ("w1", "w2"))
    assert tree_bytes([ex["w1"], ex["w2"]]) == n + 4 * sum(
        ex[k][1].numel() for k in ("w1", "w2"))


def test_gather_arm_refuses_int8_experts():
    """``moe_dispatch='gather'`` (and ``'auto'`` on the CPU) meets int8
    expert leaves with an error that names ``'cuda'``."""
    _, served, _ = _moe_trees(False)
    tcfg = llama_config(**MIXTRAL_STYLE, dtype=torch.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, served), tcfg,
                              device="cpu")
    for arm in ("gather", "auto"):
        eng = ServingEngine(tparams, tcfg, device="cpu", moe_dispatch=arm,
                            **ENGINE)
        eng.submit(Request(_prompts()[0], 2))
        with pytest.raises(TypeError, match="'cuda'"):
            eng.step()
