"""The port's MoE serving path against the JAX package, on the CPU, in
f32 at small widths: ``paged_forward_moe`` logits through a chunked
prefill and decode, the weights ``params_from_jax`` carries over from
JAX's ``init_gpt_moe_params``, and the whole slice — the port's
``ServingEngine`` emits greedy tokens EQUAL to the JAX engine's ragged
``moe_dispatch='gather'`` arm, with staggered admission, through both
port arms (``'gather'`` and ``'cuda'``, whose CPU path is K6's plain
version), and the same ``serving_summary()['moe']``.

Two families: the GELU GPT-MoE of ``tests/test_serving.py`` (learned
positions, LayerNorm, an expert layer every second block) and a
Mixtral-style Llama (RMSNorm, RoPE, GQA, SwiGLU experts in every block).
The JAX engines are built once per family (module-scope fixture)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import init_gpt_moe_params as jinit
from torchdistpackage_tpu.models import llama_config as jllama
from torchdistpackage_tpu.serving import Request as JRequest
from torchdistpackage_tpu.serving import ServingEngine as JEngine
from torchdistpackage_tpu.serving import paged_cache as jpc
from torchdistpackage_tpu_torch.models import (
    GPTConfig,
    init_gpt_moe_params,
    is_moe_block,
    llama_config,
    mixtral_8x7b_config,
)
from torchdistpackage_tpu_torch.models.convert import params_from_jax
from torchdistpackage_tpu_torch.serving import Request, ServingEngine
from torchdistpackage_tpu_torch.serving import paged_cache as tpc

GPT_MOE = dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=32,
               moe_experts=4, moe_top_k=2, moe_every=2,
               moe_capacity_factor=2.0)
MIXTRAL_STYLE = dict(vocab_size=64, dim=64, nheads=4, nlayers=2,
                     max_seq=32, kv_heads=2, ffn_hidden=96, moe_experts=4,
                     moe_every=1)
FAMILIES = {
    "gpt_moe": (lambda: JGPTConfig(**GPT_MOE, dtype=jnp.float32),
                lambda: GPTConfig(**GPT_MOE, dtype=torch.float32)),
    "mixtral_style": (lambda: jllama(**MIXTRAL_STYLE, dtype=jnp.float32),
                      lambda: llama_config(**MIXTRAL_STYLE,
                                           dtype=torch.float32)),
}
ENGINE = dict(num_slots=3, block_size=4, chunk=4, max_ctx=32)
PROMPT_LENS = (5, 9, 13)  # two, three and four prefill chunks
NEW = 6
ARMS = ("gather", "cuda")


def _prompts(cfg):
    rs = np.random.RandomState(0)
    return [rs.randint(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]


def _run_staggered(eng, make_req, prompts):
    """Request 0 prefills and decodes while 1 and 2 arrive."""
    rids = [eng.submit(make_req(prompts[0], NEW))]
    eng.step()
    eng.step()
    rids += [eng.submit(make_req(p, NEW)) for p in prompts[1:]]
    eng.run_until_idle(max_ticks=500)
    return [np.asarray(eng.finished[r]["tokens"]) for r in rids]


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    jcfg_fn, tcfg_fn = FAMILIES[request.param]
    jcfg, tcfg = jcfg_fn(), tcfg_fn()
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    prompts = _prompts(tcfg)
    jeng = JEngine(jparams, jcfg, attn_impl="gather", moe_dispatch="gather",
                   **ENGINE)
    want = _run_staggered(jeng, JRequest, prompts)
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(np_params, tcfg, device="cpu")
    out = {"name": request.param, "jcfg": jcfg, "tcfg": tcfg,
           "jparams": jparams, "np_params": np_params, "tparams": tparams,
           "want": want, "jsummary": jeng.serving_summary(), "got": {},
           "eng": {}}
    for arm in ARMS:
        eng = ServingEngine(tparams, tcfg, device="cpu", moe_dispatch=arm,
                            **ENGINE)
        out["got"][arm] = _run_staggered(eng, Request, prompts)
        out["eng"][arm] = eng
    return out


@pytest.mark.parametrize("arm", ARMS)
def test_greedy_tokens_equal_jax_engine(family, arm):
    for i, (w, g) in enumerate(zip(family["want"], family["got"][arm])):
        np.testing.assert_array_equal(
            g, w, err_msg=f"{family['name']} {arm} request {i}")


@pytest.mark.parametrize("arm", ARMS)
def test_moe_summary_equals_jax(family, arm):
    """Routing does not depend on the arm: the expert-load block equals
    the JAX engine's, key for key (``dispatch`` names the arm), and the
    counts add up to top-k choices of every row the expert layers saw."""
    eng = family["eng"][arm]
    s = eng.serving_summary()
    want = dict(family["jsummary"]["moe"])
    got = dict(s["moe"])
    assert got.pop("dispatch") == arm == eng.moe_dispatch
    assert want.pop("dispatch") == "gather"
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12,
                                   err_msg=key)
    cfg = family["tcfg"]
    n_moe = sum(is_moe_block(cfg, i) for i in range(cfg.nlayers))
    rows = (s["prefill_chunks"] * eng.num_slots * eng.chunk
            + s["decode_steps"] * eng.num_slots)
    assert sum(got["expert_tokens"]) == cfg.moe_top_k * rows * n_moe
    assert got["dropped_token_rate"] == 0.0
    assert eng.moe_imbalance() == pytest.approx(got["imbalance"])
    # the CPU path is the plain version of both kernels
    assert s["kernel_launches"] == {"paged_decode_attention": 0,
                                    "fused_moe_ffn": 0,
                                    "fused_moe_ffn_int8": 0,
                                    "fused_expert_ffn": 0,
                                    "fused_expert_ffn_int8": 0}
    assert eng.audit(heal=False)["ok"] and eng._alloc.in_use == 0


def test_paged_forward_moe_matches_jax(family):
    """Two slots through a two-chunk prefill at different offsets, then two
    decode steps, on one pool: logits of both port arms against JAX's
    ragged arm, and the per-step expert counts."""
    jcfg, tcfg = family["jcfg"], family["tcfg"]
    jp, tp = family["jparams"], family["tparams"]
    B, BS, MB = 2, 4, 6
    nb = 1 + B * MB
    tables = np.arange(1, nb, dtype=np.int32).reshape(B, MB)[:, ::-1].copy()
    rs = np.random.RandomState(3)
    steps = [
        (rs.randint(0, 64, (B, 8)).astype(np.int32),
         np.asarray([0, 0], np.int32), np.asarray([7, 2], np.int32)),
        (rs.randint(0, 64, (B, 8)).astype(np.int32),
         np.asarray([8, 3], np.int32), np.asarray([5, 7], np.int32)),
        (rs.randint(0, 64, (B, 1)).astype(np.int32),
         np.asarray([14, 11], np.int32), None),
        (rs.randint(0, 64, (B, 1)).astype(np.int32),
         np.asarray([15, 12], np.int32), None),
    ]
    jcache = jpc.init_paged_kv(jcfg, nb, BS)
    tcaches = {arm: tpc.init_paged_kv(tcfg, nb, BS, device="cpu")
               for arm in ARMS}
    for tokens, offs, last in steps:
        jcache, jlog, jmet = jpc.paged_forward_moe(
            jp, jnp.asarray(tokens), jcfg, jcache, jnp.asarray(tables),
            jnp.asarray(offs),
            last_idx=None if last is None else jnp.asarray(last),
            moe_dispatch="gather", moe_stats=True)
        for arm in ARMS:
            tcaches[arm], tlog, tmet = tpc.paged_forward_moe(
                tp, torch.from_numpy(tokens), tcfg, tcaches[arm],
                torch.from_numpy(tables), torch.from_numpy(offs),
                last_idx=None if last is None else torch.from_numpy(last),
                moe_dispatch=arm, moe_stats=True)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       rtol=1e-5, atol=1e-5, err_msg=arm)
            np.testing.assert_array_equal(tmet["expert_tokens"].numpy(),
                                          np.asarray(jmet["expert_tokens"]))
            assert float(tmet["dropped_token_rate"]) == 0.0
    for arm in ARMS:
        for name in ("k", "v"):
            np.testing.assert_allclose(tcaches[arm][name].numpy(),
                                       np.asarray(jcache[name]), rtol=1e-5,
                                       atol=1e-5)


def test_params_from_jax_carries_moe_blocks(family):
    """The per-block list stays a list of dicts, expert blocks carry
    ``moe`` (router + stacked experts) and every leaf is carried exactly;
    the port's own init builds the same tree, and ``num_params`` counts
    it."""
    tcfg, np_params, tp = family["tcfg"], family["np_params"], family[
        "tparams"]
    assert isinstance(tp["blocks"], list)
    assert len(tp["blocks"]) == tcfg.nlayers
    for i, (jb, tb) in enumerate(zip(np_params["blocks"], tp["blocks"])):
        assert ("moe" in tb) == is_moe_block(tcfg, i) == ("mlp" not in tb)
        want = jax.tree_util.tree_flatten_with_path(jb)[0]
        for path, leaf in want:
            got = tb
            for key in path:
                got = got[key.key]
            np.testing.assert_array_equal(got.numpy(), leaf)
    own = init_gpt_moe_params(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), own)
    assert shapes == jax.tree.map(lambda t: tuple(t.shape), tp)
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(np_params))
    assert tcfg.num_params() == n
    with pytest.raises(TypeError, match="per-block list"):
        params_from_jax(dict(np_params, blocks=np_params["blocks"][0]),
                        tcfg, device="cpu")
    dense = dataclasses.replace(tcfg, moe_experts=0)
    with pytest.raises(TypeError, match="MoE config"):
        params_from_jax(np_params, dense, device="cpu")


def test_engine_refuses_what_the_moe_slice_does_not_serve():
    cfg = GPTConfig(**GPT_MOE)
    dense = GPTConfig(**dict(GPT_MOE, moe_experts=0))
    with pytest.raises(ValueError, match="no MoE"):
        ServingEngine(None, dense, device="cpu", moe_dispatch="gather",
                      **ENGINE)
    with pytest.raises(ValueError, match="moe_dispatch"):
        ServingEngine(None, cfg, device="cpu", moe_dispatch="pallas",
                      **ENGINE)
    with pytest.raises(NotImplementedError, match="ep_axis"):
        ServingEngine(None, cfg, device="cpu", ep_axis="ep", **ENGINE)
    with pytest.raises(ValueError, match="expert_choice"):
        GPTConfig(**GPT_MOE, moe_router="expert_choice")
    with pytest.raises(ValueError, match="init_gpt_moe_params"):
        from torchdistpackage_tpu_torch.models import init_gpt_params
        init_gpt_params(cfg, device="cpu")
    eng = ServingEngine(None, cfg, device="cpu", **ENGINE)
    assert eng.moe_dispatch == "gather"  # 'auto' on the CPU
    assert "moe" in eng.serving_summary()


def test_mixtral_preset_is_the_published_config():
    cfg = mixtral_8x7b_config()
    assert (cfg.dim, cfg.nlayers, cfg.nheads, cfg.kv_heads,
            cfg.block.head_dim) == (4096, 32, 32, 8, 128)
    assert (cfg.block.ffn_dim, cfg.moe_experts, cfg.moe_top_k,
            cfg.moe_every) == (14336, 8, 2, 1)
    assert (cfg.vocab_size, cfg.max_seq, cfg.rope_theta, cfg.norm_eps,
            cfg.sliding_window) == (32000, 32768, 1e6, 1e-5, None)
    assert (cfg.norm, cfg.act, cfg.pos, cfg.dtype) == (
        "rms", "swiglu", "rope", torch.bfloat16)
    assert round(cfg.num_params() / 1e9, 1) == 46.7
    cut = mixtral_8x7b_config(nlayers=16)
    assert round(cut.num_params() / 1e9, 2) == 23.49
    assert all(is_moe_block(cut, i) for i in range(16))


def test_moe_entry_points_default_to_the_card():
    """No device argument means CUDA: without a card the MoE init and the
    engine raise, never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    cfg = GPTConfig(**GPT_MOE)
    with pytest.raises(RuntimeError, match="cuda"):
        init_gpt_moe_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(None, cfg, **ENGINE)
