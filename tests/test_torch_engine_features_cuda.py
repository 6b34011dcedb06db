"""The engine features' device work on the card: K1 at the prefill
shapes the prefix cache adds, the copy-on-write and ``migrate_blocks`` on
CUDA pools, a generator's state round trip, and a small engine with the
prefix cache on.

- K1 (bf16, GQA 4, hd 128 and 64, window 4096 and none) at a prefix-hit
  chunk — rows starting at a block boundary inside the prompt, a
  multiple of 16 and not of the chunk (2048 + 16 k) — and at a COW
  admission: one live row at offset P - 1 = 2047, the other slots idle
  on NULL tables, the chunk's pad rows running past the prompt into the
  clamp.  Held row by row against the plain version in f32: 2 bf16 ulps
  of the row's largest |value| (``chip_smoke.py``'s rule).
- ``copy_blocks`` and ``migrate_blocks`` (bf16 and int8 ``(q8, scale)``
  pools, ``compress=True``, a ``PoolSnapshot`` source) equal the same
  copies on CPU copies of the pools, bit for bit.
- A CUDA ``torch.Generator``'s state (Philox seed and offset) survives
  a JSON round trip and continues the stream.
- A 2-layer engine with ``prefix_cache=True``: K1 launches exactly once
  a layer a device call (a COW adds a copy, not a forward), the hits
  and copies the schedule implies, no block leaked.

Every test is ``gpu``-marked and skips without a CUDA device.  The file
imports neither JAX nor the JAX package::

    python -m pytest --noconftest -m gpu tests/test_torch_engine_features_cuda.py
"""

import json

import numpy as np
import pytest
import torch

from torchdistpackage_tpu_torch.models import init_gpt_params, llama_config
from torchdistpackage_tpu_torch.ops import paged_attention as pa
from torchdistpackage_tpu_torch.serving import (
    PoolSnapshot,
    Request,
    ServingEngine,
    copy_blocks,
    migrate_blocks,
)
from torchdistpackage_tpu_torch.serving.sim import TorchDeviceStep

pytestmark = pytest.mark.gpu

BS, HKV, G = 16, 8, 4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(offsets, S_in, hd, seed, live=None):
    """Random bf16 q and pool; slot b's table covers its rows.  ``live``:
    only these slots hold blocks, the others a NULL row (idle slots in
    an engine's prefill call)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B = len(offsets)
    mb = -(-(max(offsets) + S_in) // BS)
    nb = 1 + B * mb
    tables = (torch.randperm(nb - 1, generator=g, device="cuda") + 1)
    tables = tables.reshape(B, mb).to(torch.int32)
    if live is not None:
        for b in range(B):
            if b not in live:
                tables[b] = 0
    tables = tables.contiguous()
    q = torch.randn(B, HKV * G, S_in, hd, generator=g,
                    device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(nb, HKV, BS, hd, generator=g,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    offs = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    return q, k, v, tables, offs


def _held(got, q, k, v, tables, offs, window):
    want = pa.paged_decode_attention_reference(
        q.float(), k.float(), v.float(), tables, offs, window=window)
    scale = want.abs().amax(-1).clamp_min(2.0 ** -100)
    tol = 2.0 * torch.exp2(torch.floor(torch.log2(scale)) - 7)
    err = (got.float() - want).abs().amax(-1)
    assert torch.isfinite(got).all()
    ratio = float((err / tol).max())
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("window", [4096, None])
@pytest.mark.parametrize("hd", [128, 64])
@pytest.mark.parametrize("S_in", [512, 128])
def test_k1_prefix_hit_rows(cuda, S_in, hd, window):
    """Prefill rows from a block boundary inside the prompt: offsets
    2048 + 16 k (a multiple of 16, not of the chunk)."""
    offs = [2048 + 16 * k for k in (1, 3, 7, 13, 0, 5, 31, 2)]
    q, k, v, tables, o = _case(offs, S_in, hd, seed=S_in + hd)
    before = pa.LAUNCHES["paged_decode_attention"]
    got = pa.paged_decode_attention(q, k, v, tables, o, window=window)
    assert pa.LAUNCHES["paged_decode_attention"] == before + 1
    _held(got, q, k, v, tables, o, window)


@pytest.mark.parametrize("window", [4096, None])
@pytest.mark.parametrize("hd", [128, 64])
@pytest.mark.parametrize("S_in", [512, 1])
def test_k1_cow_admission_row(cuda, S_in, hd, window):
    """One live slot at offset P - 1 = 2047 (a whole-prompt hit
    recomputing its last token), its chunk's pad rows past the prompt;
    the other slots idle on NULL tables at offset 0."""
    offs = [0, 0, 2047, 0, 0, 0, 0, 0]
    q, k, v, tables, o = _case(offs, S_in, hd, seed=7 + hd, live={2})
    got = pa.paged_decode_attention(q, k, v, tables, o, window=window)
    _held(got, q, k, v, tables, o, window)


def _pools(quantized, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (2, 12, HKV, BS, 128)
    if quantized:
        def entry():
            return (torch.randint(-127, 128, shape, generator=g,
                                  device="cuda", dtype=torch.int8),
                    torch.rand(shape[:-1], generator=g, device="cuda"))
        return {"k": entry(), "v": entry()}
    return {n: torch.randn(shape, generator=g, device="cuda")
            .to(torch.bfloat16) for n in ("k", "v")}


def _cpu(pool):
    return {n: (tuple(t.cpu() for t in x) if isinstance(x, tuple)
                else x.cpu()) for n, x in pool.items()}


def _same(a, b):
    for n in ("k", "v"):
        xa, xb = a[n], b[n]
        for ta, tb in zip(xa if isinstance(xa, tuple) else (xa,),
                          xb if isinstance(xb, tuple) else (xb,)):
            assert torch.equal(ta.cpu(), tb.cpu())


SRC = np.array([3, 5, 0, 0, 9, 0, 0, 0], np.int32)
DST = np.array([7, 2, 0, 0, 3, 0, 0, 0], np.int32)


@pytest.mark.parametrize("quantized", [False, True])
def test_copy_blocks_on_the_card(cuda, quantized):
    pool = _pools(quantized, 1)
    ref = copy_blocks(_cpu(pool), SRC, DST)
    _same(copy_blocks(pool, SRC, DST), ref)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("quantized", [False, True])
def test_migrate_blocks_on_the_card(cuda, quantized, compress):
    """From a snapshot whose source was reused, bit for bit the copy made
    on the card from the untouched pool; against the CPU copy, bit for
    bit too, except the int8 wire of a bf16 pool (``compress``), where
    the card and the CPU may quantise a tie to neighbouring levels."""
    src, dst = _pools(quantized, 2), _pools(quantized, 3)
    ref = migrate_blocks({n: (tuple(t.clone() for t in x)
                              if isinstance(x, tuple) else x.clone())
                          for n, x in src.items()},
                         {n: (tuple(t.clone() for t in x)
                              if isinstance(x, tuple) else x.clone())
                          for n, x in dst.items()}, SRC, DST,
                         compress=compress)
    cpu = migrate_blocks(_cpu(src), _cpu(dst), SRC, DST, compress=compress)
    snap = PoolSnapshot(src, [3, 5, 9])
    for leaf in (src["k"] if quantized else (src["k"],)):
        leaf.zero_()  # the source reuses its blocks before the copy
    got = migrate_blocks(snap, dst, SRC, DST, compress=compress)
    _same(got, ref)
    if quantized or not compress:
        _same(got, cpu)
    else:
        # x / scale may round to the other int8 level on a tie: one
        # quantisation step (the vector's amax / 127) plus a bf16 ulp
        for n in ("k", "v"):
            a, b = got[n].float().cpu(), cpu[n].float()
            step = b.abs().amax(-1, keepdim=True) / 127.0
            assert ((a - b).abs() <= step + b.abs() * 2.0 ** -8).all()


def test_cuda_generator_state_round_trip(cuda):
    dev = TorchDeviceStep(llama_config(vocab_size=64, dim=64, nheads=4,
                                       nlayers=1, max_seq=64),
                          device="cuda")
    g = dev.stream(3)
    torch.rand(1000, generator=g, device="cuda")
    state = json.loads(json.dumps(dev.stream_state(g)))
    h = dev.restore_stream(state)
    assert torch.equal(torch.rand(77, generator=g, device="cuda"),
                       torch.rand(77, generator=h, device="cuda"))


def test_prefix_cache_engine_on_the_card(cuda):
    cfg = llama_config(vocab_size=512, dim=256, nheads=4, nlayers=2,
                       max_seq=1024, kv_heads=1, ffn_hidden=512,
                       dtype=torch.bfloat16)
    params = init_gpt_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0))
    eng = ServingEngine(params, cfg, num_slots=4, block_size=BS, chunk=64,
                        max_ctx=512, prefix_cache=True)
    assert eng.attn_impl == "cuda"
    rs = np.random.RandomState(0)
    sysp = rs.randint(0, 512, 128).tolist()
    eng.submit(Request(sysp + [1, 2, 3], 8))
    eng.run_until_idle()
    for i in range(3):
        eng.submit(Request(sysp + rs.randint(0, 512, 5 + i).tolist(), 8))
    eng.submit(Request(sysp, 8))  # whole-prompt hit: COW
    pa.LAUNCHES["paged_decode_attention"] = 0
    eng.reset_metrics()
    eng.run_until_idle()
    s = eng.serving_summary()
    calls = s["prefill_chunks"] + s["decode_steps"]
    assert pa.LAUNCHES["paged_decode_attention"] == cfg.nlayers * calls
    assert s["prefix_cache"]["hits"] == 4
    assert s["prefix_cache"]["cow_copies"] == 1
    assert s["prefix_cache"]["cached_tokens"] == 3 * 128 + 127
    assert eng.audit(heal=False)["ok"] and eng._alloc.in_use == 0
    for f in eng.finished.values():
        assert f["reason"] == "max_tokens"
