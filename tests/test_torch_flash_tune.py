"""The tuner's knobs and harness on the CPU (``tools/flash_tune.py``,
K3's ``block_q`` / ``block_k`` / ``stages``, K1's and K2's ``nsplit``).

- K1 with an explicit ``nsplit``, every width from 1 to the table
  width, against JAX's K1 (``paged_decode_attention`` in interpret mode)
  on numpy-seeded inputs, within 1e-5 (f32; the splits merge in another
  order); K2 finished likewise; widths outside ``[1, mb]`` and prefill
  rows refused.
- K3's tiles: every built tile's forward and gradients on the CPU are
  the plain version's (the tile is the kernel's alone), within 1e-5 of
  JAX's ``flash_attention`` (interpret mode); a tile not built and an
  explicit tile on f32 refused.
- The harness: candidates that resolve to one tile timed once, the
  report fastest first with ``rel``, error rows for tiles not built and
  widths out of range, the rule's own width among the split candidates,
  a pool block size the kernel does not take refused, and the command
  line in both modes.  On the CPU every candidate runs the plain
  version, so these times say nothing of the kernels.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.ops.flash_attention import (
    flash_attention as jflash_attention,
)
from torchdistpackage_tpu.ops import paged_attention as jpa
from torchdistpackage_tpu_torch.ops import flash_attention as fa
from torchdistpackage_tpu_torch.ops import paged_attention as pa
from torchdistpackage_tpu_torch.tools import flash_tune

B, HKV, G, HD, BS, MB = 2, 2, 4, 16, 16, 6
NB = 1 + B * MB
OFFS = np.asarray([20, 90], np.int32)
TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def decode_case():
    rs = np.random.RandomState(0)
    q = rs.randn(B, HKV * G, 1, HD).astype(np.float32)
    k = rs.randn(NB, HKV, BS, HD).astype(np.float32)
    v = rs.randn(NB, HKV, BS, HD).astype(np.float32)
    tables = (rs.permutation(NB - 1) + 1).reshape(B, MB).astype(np.int32)
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(OFFS), window=48))
    return [_t(a) for a in (q, k, v, tables, OFFS)], want


@pytest.mark.parametrize("nsplit", range(1, MB + 1))
def test_k1_and_k2_at_every_nsplit_match_jax(decode_case, nsplit):
    (q, k, v, tables, offs), want = decode_case
    got = pa.paged_decode_attention(q, k, v, tables, offs, window=48,
                                    nsplit=nsplit)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    carry = pa.paged_carry_attention(q, k, v, tables, offs, window=48,
                                     nsplit=nsplit)
    np.testing.assert_allclose(
        pa.finalize_paged_carry(carry, B, HKV * G, 1, HD,
                                torch.float32).numpy(), want,
        rtol=TOL, atol=TOL)


def test_nsplit_refusals(decode_case):
    (q, k, v, tables, offs), _ = decode_case
    for bad in (0, MB + 1):
        with pytest.raises(ValueError, match="nsplit"):
            pa.paged_decode_attention(q, k, v, tables, offs, nsplit=bad)
    rows = q.expand(B, HKV * G, 5, HD).contiguous()  # R = 20 > 16
    with pytest.raises(ValueError, match="decode rows"):
        pa.paged_decode_attention(rows, k, v, tables, offs, nsplit=2)
    assert pa.check_nsplit(None, 99, 1) is None  # the default: the rule


def test_k3_tiles_on_cpu_are_the_plain_version_and_match_jax():
    rs = np.random.RandomState(1)
    q, k, v = (rs.randn(1, 2, 96, 64).astype(np.float32) for _ in range(3))
    want = np.asarray(jflash_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=True))
    base = None
    for bq, bk, ns in fa.FWD_TILES:
        qt, kt, vt = (_t(a).to(torch.bfloat16).float().requires_grad_(True)
                      for a in (q, k, v))
        qb, kb, vb = (t.detach().to(torch.bfloat16).requires_grad_(True)
                      for t in (qt, kt, vt))
        o = fa.flash_attention(qb, kb, vb, block_q=bq, block_k=bk,
                               stages=ns)
        o.float().sum().backward()
        grads = [t.grad for t in (qb, kb, vb)]
        if base is None:
            base = (o, grads)
        assert torch.equal(o, base[0]) and all(
            torch.equal(a, b) for a, b in zip(grads, base[1]))
    o32 = fa.flash_attention(*(_t(a) for a in (q, k, v)))
    np.testing.assert_allclose(o32.numpy(), want, rtol=TOL, atol=TOL)
    x = _t(q)
    with pytest.raises(ValueError, match="not built"):
        fa.flash_attention(x.bfloat16(), x.bfloat16(), x.bfloat16(),
                           block_k=256)
    with pytest.raises(ValueError, match="one tile"):
        fa.flash_attention(x, x, x, stages=2)
    assert fa.default_tiles("cpu") == (128, 128, 2)
    assert fa.resolve_tiles(x.bfloat16()) == (128, 128, 2)


def test_tune_flash_blocks_dedups_ranks_and_reports_errors():
    cands = [(128, 128), (128, 128, 2), (None, 64, 3), (128, 64, 3),
             (128, 256), (64, 64, 2)]
    best, report = flash_tune.tune_flash_blocks(
        batch=1, heads=2, seq=64, head_dim=64, candidates=cands, steps=1,
        warmup=0, device="cpu")
    timed = [r for r in report if r["ms"] is not None]
    errors = [r for r in report if r["ms"] is None]
    assert sorted((r["block_k"], r["stages"]) for r in timed) == [
        (64, 3), (128, 2)]
    assert [(r["block_q"], r["block_k"]) for r in errors] == [
        (128, 256), (64, 64)]
    assert all("not built" in r["error"] for r in errors)
    assert report[:len(timed)] == timed  # errors last
    assert [r["ms"] for r in timed] == sorted(r["ms"] for r in timed)
    assert timed[0]["rel"] == 1.0 and all(r["rel"] >= 1.0 for r in timed)
    assert best == (timed[0]["block_q"], timed[0]["block_k"],
                    timed[0]["stages"])
    assert [r["default"] for r in timed if r["block_k"] == 128] == [True]
    assert timed[0]["bwd_tiles"] == fa.BWD_TILES[64]
    with pytest.raises(RuntimeError, match="no flash tile"):
        flash_tune.tune_flash_blocks(batch=1, heads=1, seq=16, head_dim=64,
                                     candidates=[(128, 256)], steps=1,
                                     warmup=0, device="cpu")


def test_tune_paged_params_covers_the_rule_and_both_shapes():
    best, report = flash_tune.tune_paged_params(
        num_slots=2, kv_heads=2, groups=4, head_dim=16, max_blocks=6,
        spec_k=3, candidates=[1, 3, 3, 6, 7], steps=1, warmup=0,
        device="cpu")
    timed = [r for r in report if r["ms"] is not None]
    assert sorted(r["nsplit"] for r in timed) == [1, 3, 6]
    assert [r["nsplit"] for r in report if r["ms"] is None] == [7]
    for r in timed:
        assert r["ms"] == r["decode_ms"] + r["verify_ms"]
    assert best == {"nsplit": timed[0]["nsplit"]} and timed[0]["rel"] == 1.0
    _, report = flash_tune.tune_paged_params(
        num_slots=2, kv_heads=2, groups=4, head_dim=16, max_blocks=8,
        spec_k=3, steps=1, warmup=0, device="cpu")
    rule = [r["nsplit"] for r in report if r["rule"]]
    inputs = flash_tune.paged_inputs(num_slots=2, kv_heads=2, groups=4,
                                     head_dim=16, max_blocks=8,
                                     device="cpu")
    assert rule == [flash_tune.rule_nsplit(inputs)]
    assert {r["nsplit"] for r in report} >= {1, 2, 4, 8}
    assert inputs["q"]["verify"].shape[2] == 4
    with pytest.raises(ValueError, match="blocks of 16"):
        flash_tune.paged_inputs(block_size=32, device="cpu")


@pytest.mark.parametrize("argv", [
    ["--batch", "1", "--heads", "1", "--seq", "32"],
    ["--paged", "--slots", "2", "--kv-heads", "2", "--head-dim", "16",
     "--max-blocks", "4"]], ids=["flash", "paged"])
def test_cli_on_the_cpu(argv, capsys):
    assert flash_tune.main(argv + ["--steps", "1", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu" and out["report"][0]["rel"] == 1.0
    assert out["kernel"] == ("paged_decode_attention" if "--paged" in argv
                             else "flash_attention")
