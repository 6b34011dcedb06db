"""The fleet on the card, at a small width: a Router over two CUDA
engines (a prefill and a decode replica) serving four greedy requests.

- The prefill replica launches only K1's tensor-core prefill body
  (``paged_tc_kernel``), the decode replica only the split decode body
  and its merge, by the library's own counts
  (``_build.body_launches``); each replica's K1 launches are one a layer
  a device call.
- The tokens equal one engine's serving the same requests alone, or at
  a difference the emitted token is within 5 % of its teacher-forced
  row's scale of the row's maximum.
- A planted transport that ships every live block but the last fails
  that gate.
- The chunked wire (host-staged chunks, SHA-256 manifests) serves the
  same tokens as the loopback.

Every test is ``gpu``-marked and skips without a CUDA device.  The file
imports neither JAX nor the JAX package::

    python -m pytest --noconftest -m gpu tests/test_torch_fleet_cuda.py
"""

import numpy as np
import pytest
import torch

from torchdistpackage_tpu_torch.models import (
    gpt_forward,
    init_gpt_params,
    llama_config,
)
from torchdistpackage_tpu_torch.ops import _build
from torchdistpackage_tpu_torch.ops import paged_attention as pa
from torchdistpackage_tpu_torch.serving import (
    ChunkedWireTransport,
    LoopbackTransport,
    Request,
    Router,
    ServingEngine,
)

pytestmark = pytest.mark.gpu

BODIES = ("paged_tc_kernel", "paged_split_kernel", "paged_merge_kernel",
          "paged_walk_kernel")
TF_TOL = 0.05
ENGINE = dict(num_slots=4, block_size=16, chunk=64, max_ctx=512)
NEW = 12


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
    reqs = [Request(rs.randint(0, 512, n).tolist(), NEW)
            for n in (28, 30, 75, 130)]
    solo = ServingEngine(params, cfg, **ENGINE)
    assert solo.attn_impl == "cuda"
    rids = [solo.submit(r) for r in reqs]
    solo.run_until_idle()
    return {"cfg": cfg, "params": params, "reqs": reqs,
            "want": [solo.finished[r]["tokens"] for r in rids]}


def _counted(engines):
    """Per replica, its steps' K1 launches and K1 bodies."""
    def now():
        return {"K1": pa.LAUNCHES["paged_decode_attention"],
                **{b: _build.body_launches("paged_attention", b)
                   for b in BODIES}}
    per = [dict.fromkeys(now(), 0) for _ in engines]
    for eng, row in zip(engines, per):
        def step(_inner=eng.step, _row=row):
            before = now()
            out = _inner()
            for k, v in now().items():
                _row[k] += v - before[k]
            return out
        eng.step = step
    return per


def _fleet(model, transport=None):
    engines = [ServingEngine(model["params"], model["cfg"], **ENGINE)
               for _ in range(2)]
    router = Router(engines, roles=["prefill", "decode"],
                    transport=transport)
    per = _counted(engines)
    rids = [router.submit(r) for r in model["reqs"]]
    while router.has_work():
        router.step()
        assert router.audit()["ok"]
    torch.cuda.synchronize()
    return router, engines, per, [router.finished[r]["tokens"]
                                  for r in rids]


def _worst_gap(model, got):
    """The largest teacher-forced gap (of its row's scale) of an emitted
    token, over the requests whose tokens differ from one engine's."""
    worst = 0.0
    for g, w, r in zip(got, model["want"], model["reqs"]):
        if np.array_equal(g, w):
            continue
        seq = torch.from_numpy(np.asarray(g)[None]).cuda().long()
        logits = gpt_forward(model["params"], seq, model["cfg"]).float()
        P = len(r.tokens)
        rows = logits[:, P - 1:-1]
        chosen = rows.gather(-1, seq[:, P:, None])[..., 0]
        gaps = (rows.amax(-1) - chosen) / rows.abs().amax(-1)
        worst = max(worst, float(gaps.max()))
    return worst


def test_tiers_launch_their_own_bodies_and_tokens_hold(model):
    router, (pre, dec), per, got = _fleet(model)
    cfg = model["cfg"]
    assert pre.stats["decode_steps"] == 0 and dec.stats["prefill_chunks"] == 0
    assert per[0]["K1"] == cfg.nlayers * pre.stats["prefill_chunks"] > 0
    assert per[1]["K1"] == cfg.nlayers * dec.stats["decode_steps"] > 0
    assert per[0]["paged_tc_kernel"] > 0
    assert per[0]["paged_split_kernel"] == per[0]["paged_merge_kernel"] == 0
    assert per[1]["paged_split_kernel"] == per[1]["paged_merge_kernel"] > 0
    assert per[1]["paged_tc_kernel"] == 0
    assert per[0]["paged_walk_kernel"] == per[1]["paged_walk_kernel"] == 0
    assert _worst_gap(model, got) <= TF_TOL
    assert router.summary()["fleet"]["migrations"]["handoffs"] == 4
    assert pre._alloc.in_use == dec._alloc.in_use == 0


def test_chunked_wire_serves_the_loopback_tokens(model):
    _, _, _, loop = _fleet(model)
    router, _, _, wire = _fleet(model, ChunkedWireTransport())
    for a, b in zip(loop, wire):
        np.testing.assert_array_equal(a, b)
    st = router.transport.stats
    assert st["chunks"] == router.stats["migration_blocks"] > 0
    assert st["wire_bytes"] == router.stats["migration_bytes"]


def test_planted_short_tail_transport_fails_the_gate(model):
    class ShortTail(LoopbackTransport):
        def deliver(self, handle, dst_cache, src_ids, dst_ids):
            return super().deliver(handle, dst_cache, src_ids[:-1],
                                   dst_ids[:-1])

    _, _, _, got = _fleet(model, ShortTail())
    assert _worst_gap(model, got) > TF_TOL
