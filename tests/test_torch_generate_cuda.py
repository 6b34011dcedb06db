"""The ``generate()`` family and the speculative engine on the card, at a
small width (a 2-layer Llama, d 256, 4 query heads of 64 over one KV
head: GQA group 4, bf16, ``attn_impl='flash'``).

- Greedy ``generate`` on a 100-token prompt (no multiple of any tile):
  K3 launches once a layer for the prefill call and never in a decode
  step; each emitted token's teacher-forced logit (``gpt_forward``, K3
  over the whole sequence) is within 5 % of its row's scale of the row's
  maximum; ``speculative_generate`` launches K3 for its two prefills
  only.
- ``ServingEngine(spec_k=K)``: K1 launches exactly once a layer a device
  call, verify calls included, at K 3 (R = 4 x 4 = 16 rows a KV head:
  the split decode body) and K 4 (R = 20: ``paged_tc_kernel``), the
  body the wrapper routes to (and torch.profiler's kernel names, when it
  reads any).

Every test is ``gpu``-marked and skips without a CUDA device.  The file
imports neither JAX nor the JAX package::

    python -m pytest --noconftest -m gpu tests/test_torch_generate_cuda.py
"""

import numpy as np
import pytest
import torch

from torchdistpackage_tpu_torch.models import (
    generate,
    gpt_forward,
    init_gpt_params,
    llama_config,
    speculative_generate,
)
from torchdistpackage_tpu_torch.ops import flash_attention as fa
from torchdistpackage_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.gpu

SMALL = dict(vocab_size=512, dim=256, nheads=4, nlayers=2, max_seq=512,
             kv_heads=1, ffn_hidden=512, attn_impl="flash")
#: teacher-forced tolerance: a row's top logit minus the emitted token's,
#: relative to the row's largest |logit|
TF_TOL = 0.05


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = llama_config(**SMALL, dtype=torch.bfloat16)
    params = init_gpt_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0))
    return cfg, params


def _reset():
    for counts in (fa.LAUNCHES, pa.LAUNCHES):
        for name in counts:
            counts[name] = 0


def _teacher_forced_gap(params, cfg, seq, P):
    """Per emitted token: (row max - its logit) / row max |logit|."""
    with torch.no_grad():
        logits = gpt_forward(params, seq, cfg).float()[:, P - 1:-1]
    tok = seq[:, P:]
    got = logits.gather(-1, tok[..., None])[..., 0]
    return (logits.amax(-1) - got) / logits.abs().amax(-1)


def test_generate_launches_k3_for_the_prefill_only(model):
    cfg, params = model
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, 512, (2, 100))).cuda()
    _reset()
    out = generate(params, prompt, cfg, 16)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd"] == cfg.nlayers  # one prefill call
    assert pa.LAUNCHES["paged_decode_attention"] == 0
    assert out.shape == (2, 116)
    assert float(_teacher_forced_gap(params, cfg, out, 100).max()) <= TF_TOL
    _reset()
    spec = speculative_generate(params, params, prompt[:1], cfg, 16,
                                num_draft=3)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd"] == 2 * cfg.nlayers  # target + draft
    assert float(_teacher_forced_gap(params, cfg, spec, 100).max()) <= TF_TOL


def _kernel_names(fn):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return " ".join(e.key for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)


@pytest.mark.parametrize("k,body", [(3, "paged_split_kernel"),
                                    (4, "paged_tc_kernel")])
def test_spec_engine_k1_launches_and_body(model, k, body):
    from torchdistpackage_tpu_torch.serving import Request, ServingEngine

    cfg, params = model
    rs = np.random.RandomState(k)
    seg = rs.randint(0, 512, 16).tolist()
    reqs = [Request(rs.randint(0, 512, 5).tolist() + seg * n, 24)
            for n in (3, 5, 8)]
    eng = ServingEngine(params, cfg, num_slots=4, block_size=16, chunk=64,
                        max_ctx=256, spec_k=k)
    for r in reqs:
        eng.submit(r)
    _reset()
    eng.run_until_idle()
    torch.cuda.synchronize()
    s = eng.serving_summary()
    calls = s["prefill_chunks"] + s["decode_steps"]
    assert pa.LAUNCHES["paged_decode_attention"] == cfg.nlayers * calls
    assert s["requests"]["completed"] == 3 and s["spec"]["drafted"] > 0
    assert s["decode_signatures"] == 1
    for f in eng.finished.values():
        gap = _teacher_forced_gap(params, cfg, torch.from_numpy(
            f["tokens"][None]).cuda().long(), f["prompt_len"])
        assert float(gap.max()) <= TF_TOL
    # the verify call's K1 body: R = (H / Hkv) (K + 1) rows a KV head
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(2, 4, k + 1, 64, generator=g, device="cuda").to(
        torch.bfloat16)
    pool = torch.randn(9, 1, 16, 64, generator=g, device="cuda").to(
        torch.bfloat16)
    tables = torch.arange(1, 9, dtype=torch.int32, device="cuda").reshape(
        2, 4)
    offs = torch.tensor([20, 40], dtype=torch.int32, device="cuda")
    nsplit = pa._workspace(2, 1, 4 * (k + 1), 64, 4, "cuda")[0]
    assert (nsplit > 0) == (body == "paged_split_kernel")
    # torch.profiler has read an empty kernel list late in a long process;
    # when it sees kernels, the routed body must be among them
    names = _kernel_names(lambda: pa.paged_decode_attention(
        q, pool, pool, tables, offs))
    assert not names or body in names, names
