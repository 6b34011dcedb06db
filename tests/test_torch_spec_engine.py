"""The port's speculative serving path against the JAX package, on the
CPU, in f32 at small widths: ``paged_forward(all_logits=True)`` and
``paged_forward_moe(all_logits=True)`` logits against JAX's (atol 1e-4,
as the paged forward's own parity test), ``ServingEngine(spec_k=K)``
greedy tokens EQUAL to JAX's serial engine with the same ``spec_k``
(``prefix_cache=False``) and to the port's own engine without it, the
``spec`` summary's counts equal to JAX's, sampled spec rows replaying bit
for bit from the same seeds, and the verify sampler's marginal against
the filtered distribution by a chi-square test.

Prompts repeat a short segment, so the n-gram drafter's proposals are
accepted often, and rejected too.  Weights come from JAX's init through
``params_from_jax``; the JAX engines are built once per family.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import init_gpt_moe_params as jinit_moe
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.models import llama_config as jllama
from torchdistpackage_tpu.serving import Request as JRequest
from torchdistpackage_tpu.serving import ServingEngine as JEngine
from torchdistpackage_tpu.serving import paged_cache as jpc
from torchdistpackage_tpu_torch.models import GPTConfig, llama_config
from torchdistpackage_tpu_torch.models.convert import params_from_jax
from torchdistpackage_tpu_torch.serving import Request, ServingEngine
from torchdistpackage_tpu_torch.serving import paged_cache as tpc
from torchdistpackage_tpu_torch.serving.engine import _filtered_logits
from torchdistpackage_tpu_torch.serving.sim import TorchDeviceStep

SMALL = dict(vocab_size=64, dim=64, nheads=4, nlayers=2, max_seq=64)
FAMILIES = {
    "gpt": (lambda: JGPTConfig(**SMALL, dtype=jnp.float32),
            lambda: GPTConfig(**SMALL, dtype=torch.float32), jinit),
    "llama_window": (
        lambda: jllama(**SMALL, kv_heads=2, ffn_hidden=96,
                       sliding_window=6, dtype=jnp.float32),
        lambda: llama_config(**SMALL, kv_heads=2, ffn_hidden=96,
                             sliding_window=6, dtype=torch.float32), jinit),
    "moe": (
        lambda: jllama(**SMALL, kv_heads=2, ffn_hidden=96, moe_experts=4,
                       moe_every=1, dtype=jnp.float32),
        lambda: llama_config(**SMALL, kv_heads=2, ffn_hidden=96,
                             moe_experts=4, moe_every=1,
                             dtype=torch.float32), jinit_moe),
}
ENGINE = dict(num_slots=3, block_size=4, chunk=8, max_ctx=48)
NEW = 10
SPEC_KS = (2, 3)


def _prompts():
    """A 5-token segment repeated (the drafter's bigrams recur), with a
    different head on each prompt."""
    rs = np.random.RandomState(0)
    seg = rs.randint(0, 64, 5).tolist()
    return [rs.randint(0, 64, 3).tolist() + seg * n for n in (2, 3, 4)]


def _run_staggered(eng, make_req, sampled=False):
    """Request 0 decodes while 1 and 2 arrive and prefill."""
    def req(p, i):
        if sampled:
            return make_req(p, NEW, temperature=0.9, top_k=20, top_p=0.95,
                            seed=7 + i)
        return make_req(p, NEW)

    prompts = _prompts()
    rids = [eng.submit(req(prompts[0], 0))]
    eng.step()
    eng.step()
    rids += [eng.submit(req(p, i + 1)) for i, p in enumerate(prompts[1:])]
    eng.run_until_idle(max_ticks=500)
    return [np.asarray(eng.finished[r]["tokens"]) for r in rids]


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    jcfg_fn, tcfg_fn, init = FAMILIES[request.param]
    jcfg, tcfg = jcfg_fn(), tcfg_fn()
    jparams = init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    disp = dict(moe_dispatch="gather") if tcfg.moe_experts else {}
    out = {"name": request.param, "jcfg": jcfg, "tcfg": tcfg,
           "jparams": jparams, "tparams": tparams, "want": {}, "got": {},
           "jspec": {}, "eng": {}}
    plain = ServingEngine(tparams, tcfg, device="cpu", **disp, **ENGINE)
    out["plain"] = _run_staggered(plain, Request)
    for k in SPEC_KS:
        jeng = JEngine(jparams, jcfg, attn_impl="gather", spec_k=k,
                       prefix_cache=False, **disp, **ENGINE)
        out["want"][k] = _run_staggered(jeng, JRequest)
        out["jspec"][k] = jeng.serving_summary()
        eng = ServingEngine(tparams, tcfg, device="cpu", spec_k=k, **disp,
                            **ENGINE)
        out["got"][k] = _run_staggered(eng, Request)
        out["eng"][k] = eng
    return out


@pytest.mark.parametrize("k", SPEC_KS)
def test_spec_greedy_tokens_equal_jax_and_plain_engine(family, k):
    for i, (w, g, p) in enumerate(zip(family["want"][k], family["got"][k],
                                      family["plain"])):
        np.testing.assert_array_equal(
            g, w, err_msg=f"{family['name']} spec_k {k} request {i}")
        np.testing.assert_array_equal(g, p)


@pytest.mark.parametrize("k", SPEC_KS)
def test_spec_summary_counts_equal_jax(family, k):
    s = family["eng"][k].serving_summary()
    js = family["jspec"][k]
    assert s["spec"] == js["spec"]
    assert s["spec"]["k"] == k and s["spec"]["drafted"] > 0
    assert 0 < s["spec"]["accepted"] < s["spec"]["drafted"]
    assert s["spec_accept_rate"] == pytest.approx(js["spec_accept_rate"])
    assert s["decode_steps"] == js["decode_steps"]
    assert s["decode_signatures"] == 1
    assert s["generated_tokens"] == 3 * NEW
    eng = family["eng"][k]
    assert eng.audit(heal=False)["ok"] and eng._alloc.in_use == 0
    # the table covers max_ctx + spec_k positions
    assert eng.max_blocks == -(-(ENGINE["max_ctx"] + k) // 4)


def test_spec_sampled_rows_replay_bit_for_bit(family):
    tcfg, tparams = family["tcfg"], family["tparams"]
    disp = dict(moe_dispatch="gather") if tcfg.moe_experts else {}

    def run():
        eng = ServingEngine(tparams, tcfg, device="cpu", spec_k=3, **disp,
                            **ENGINE)
        return _run_staggered(eng, Request, sampled=True), eng

    (a, eng), (b, _) = run(), run()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert len(x) > NEW and (0 <= x).all() and (x < 64).all()
    assert eng.serving_summary()["requests"]["completed"] == 3


@pytest.mark.parametrize("family_name", ["gpt", "moe"])
@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_paged_forward_all_logits_match_jax(family_name, quantized):
    """A two-slot prefill chunk, then a 4-row verify step at per-slot
    offsets with ``all_logits``: logits [B, 4, V] within 1e-4."""
    jcfg_fn, tcfg_fn, init = FAMILIES[family_name]
    jcfg, tcfg = jcfg_fn(), tcfg_fn()
    jparams = init(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    tables = np.asarray([[3, 1, 7, 2, 9, 0], [4, 11, 5, 6, 8, 10]],
                        np.int32)
    jcache = jpc.init_paged_kv(jcfg, 12, 4, quantized=quantized)
    tcache = tpc.init_paged_kv(tcfg, 12, 4, quantized=quantized,
                               device="cpu")
    rs = np.random.RandomState(2)
    if tcfg.moe_experts:
        jfwd, tfwd = jpc.paged_forward_moe, tpc.paged_forward_moe
        kw = dict(moe_dispatch="gather")
    else:
        jfwd, tfwd, kw = jpc.paged_forward, tpc.paged_forward, {}
    steps = [(rs.randint(0, 64, (2, 8)).astype(np.int32),
              np.asarray([0, 0], np.int32), False),
             (rs.randint(0, 64, (2, 4)).astype(np.int32),
              np.asarray([8, 6], np.int32), True)]
    for tokens, offs, every in steps:
        jcache, jlog = jfwd(jparams, jnp.asarray(tokens), jcfg, jcache,
                            jnp.asarray(tables), jnp.asarray(offs),
                            all_logits=every, **kw)
        tcache, tlog = tfwd(tparams, torch.from_numpy(tokens), tcfg, tcache,
                            torch.from_numpy(tables), torch.from_numpy(offs),
                            all_logits=every, **kw)
        assert tlog.shape == jlog.shape
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-4, rtol=0)


# chi-square critical value at p = 1e-3 for 7 degrees of freedom (8
# surviving tokens): a correct sampler fails one run in a thousand
CHI2_CRIT_7DOF = 24.322


def test_verify_sampler_marginal_matches_the_filtered_distribution():
    """4096 slots, each its own generator, one synthetic logit row at K+1
    positions, the same draft: the first emitted token (the draft when
    accepted, else the residual draw) must follow the filtered
    distribution p (temperature 0.7, top-k 8 of 32) — rejection sampling
    against a point-mass draft is exact.  Pearson's chi-square over the 8
    surviving tokens against p, at p-value 1e-3; the bonus column (all
    drafts accepted) likewise from the last position's p."""
    n, K, V = 4096, 2, 32
    cfg = GPTConfig(vocab_size=V, dim=16, nheads=2, nlayers=1, max_seq=8)
    dev = TorchDeviceStep(cfg, device="cpu")
    row = torch.from_numpy(np.random.RandomState(4).randn(V).astype(
        np.float32)) * 2
    logits = row.expand(n, K + 1, V).clone()
    samp = {"temperature": np.full(n, 0.7, np.float32),
            "top_k": np.full(n, 8, np.int32),
            "top_p": np.ones(n, np.float32)}
    p = torch.softmax(_filtered_logits(
        row[None], torch.tensor([0.7]), torch.tensor([8]),
        torch.tensor([1.0])), -1)[0]
    support = torch.nonzero(p > 0)[:, 0]
    assert len(support) == 8
    draft = int(p.argmax())  # so that many rows accept both drafts
    tokens = torch.full((n, K + 1), draft, dtype=torch.long)
    gens = [torch.Generator().manual_seed(1000 + i) for i in range(n)]
    ver, acc = dev.judge(logits, tokens, samp, gens)
    first = torch.where(acc[:, 0], torch.tensor(draft), ver[:, 0])
    for tok in (first, ver[acc.all(1), K]):
        counts = torch.bincount(tok, minlength=V).double()
        assert counts[p == 0].sum() == 0  # nothing outside the support
        expect = p[support].double() * len(tok)
        chi2 = float(((counts[support] - expect) ** 2 / expect).sum())
        assert chi2 < CHI2_CRIT_7DOF, chi2
    # a greedy slot (no generator) accepts exactly while draft == argmax
    g_ver, g_acc = dev.judge(logits[:2], tokens[:2], samp, [None, None])
    assert torch.equal(g_ver, logits[:2].argmax(-1))
    assert torch.equal(g_acc, tokens[:2, 1:] == logits[:2, :K].argmax(-1))
