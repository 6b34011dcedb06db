"""The port's context-parallel (CP) slice against the JAX package, on the
CPU, in f32 at small widths, in one process.

- K2's plain version (``paged_carry_attention`` on CPU tensors) against
  JAX's own K2 (``paged_carry_attention`` in interpret mode, called
  outside ``shard_map``) and ``finalize_paged_carry``: one hop over the
  whole pool and a two-hop carry chain over half-pool slices through
  re-based tables; GQA 4/2, windows None and 6, ``S_in`` 1 and a chunk;
  and a four-hop chain over quarter slices at the card's tensor-core
  tile shapes (``S_in`` 80 and 200, window 48).
- ``ring_paged_write`` / ``ring_paged_attend`` through a one-rank gloo
  group against JAX's gather arm under ``shard_map`` on a one-device
  ``context`` mesh.
- ``ServingEngine(cp_group=)`` at world 1: greedy tokens EQUAL to JAX's
  serial engine and to JAX's ``ServingEngine(cp_axis='context',
  attn_impl='gather')`` on the ``dense`` and ``sliding`` families of
  ``tests/test_cp_prefill.py``; the ``long_context`` block at cp 1.
- The refusals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import _torch_cp_worker as W
from torchdistpackage_tpu.dist import tpc
from torchdistpackage_tpu.ops import paged_attention as jpa
from torchdistpackage_tpu.ops import ring_paged as jrp
from torchdistpackage_tpu.serving import Request as JRequest
from torchdistpackage_tpu.serving import ServingEngine as JEngine
from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.models import llama_config as jllama
from torchdistpackage_tpu_torch.dist import build_cp_group, init_distributed
from torchdistpackage_tpu_torch.models.convert import params_from_jax
from torchdistpackage_tpu_torch.ops import paged_attention as pa
from torchdistpackage_tpu_torch.ops import ring_paged as rp
from torchdistpackage_tpu_torch.serving import Request, ServingEngine

B, HKV, G, HD, BS, MB = 2, 2, 4, 16, 16, 4
NB = 1 + B * MB  # 9 blocks: the halves of a two-hop chain are 5 and 4 (+1)


def jax_config(family):
    if family == "dense":
        return JGPTConfig(**W.FAMILIES[family])
    return jllama(**W.FAMILIES[family], dtype=jnp.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _k2_inputs(s_in, seed=0):
    """q [B, 8, s_in, 16] and a pool of NB blocks of 16 positions; slot 0's
    rows start at 3, slot 1's at 40, so a window of 6 masks whole blocks
    and the chunk's rows cross a block edge."""
    rs = np.random.RandomState(seed)
    q = rs.randn(B, HKV * G, s_in, HD).astype(np.float32)
    k = rs.randn(NB, HKV, BS, HD).astype(np.float32)
    v = rs.randn(NB, HKV, BS, HD).astype(np.float32)
    tables = (rs.permutation(NB - 1) + 1).reshape(B, MB).astype(np.int32)
    return q, k, v, tables, np.asarray([3, 40], np.int32)


def _hops(k, v, tables, n):
    """The pool cut into ``n`` slices (the last padded with zero blocks),
    each with the table re-based by its first block."""
    per = -(-NB // n)
    pad = np.zeros((per * n - NB,) + k.shape[1:], np.float32)
    k, v = np.concatenate([k, pad]), np.concatenate([v, pad])
    return [(k[i * per:(i + 1) * per], v[i * per:(i + 1) * per],
             tables - i * per) for i in range(n)]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=what)


# ------------------------------------------------------------------ K2


@pytest.mark.parametrize("s_in", [1, 5], ids=["decode", "chunk"])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("n_hops", [1, 2])
def test_k2_plain_matches_jax_k2(n_hops, window, s_in):
    """The carry after every hop and the finished output, within 1e-5.
    After a hop where a row met no owned key, JAX's interim carry counts
    the masked keys (its ``m`` stays NEG_INF) where the port keeps
    ``(0, NEG_INF, 0)``; the next owned key wipes JAX's counts, so such
    rows are compared on ``m`` only, and the final carry on every row."""
    q, k, v, tables, offs = _k2_inputs(s_in)
    R = G * s_in
    jcarry = tcarry = None
    hops = _hops(k, v, tables, n_hops)
    before = dict(pa.LAUNCHES)
    for i, (ks, vs, tab) in enumerate(hops):
        jcarry = jpa.paged_carry_attention(
            jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs),
            jnp.asarray(tab), jnp.asarray(offs), carry=jcarry, window=window)
        tcarry = pa.paged_carry_attention(
            _t(q), _t(ks), _t(vs), _t(tab), _t(offs), carry=tcarry,
            window=window)
        acc, m, l = (t.numpy() for t in tcarry)
        jacc = np.asarray(jcarry[0])[:, :, :R]
        jm, jl = (np.asarray(x)[:, :, :R, 0] for x in jcarry[1:])
        _close(m, jm, f"m after hop {i}")
        met = jm > -1e29 if i < n_hops - 1 else np.ones_like(jm, bool)
        _close(l[met], jl[met], f"l after hop {i}")
        _close(acc[met], jacc[met], f"acc after hop {i}")
    assert pa.LAUNCHES == before  # CPU tensors: the plain version
    H = HKV * G
    got = pa.finalize_paged_carry(tcarry, B, H, s_in, HD, torch.float32)
    want = jpa.finalize_paged_carry(jcarry, B, H, s_in, HD, jnp.float32)
    _close(got.numpy(), np.asarray(want), "finished output")
    # and the finished chain is the one-hop answer
    one = pa.paged_carry_attention(_t(q), _t(k), _t(v), _t(tables),
                                   _t(offs), window=window)
    _close(got.numpy(), pa.finalize_paged_carry(
        one, B, H, s_in, HD, torch.float32).numpy(), "chain vs one hop")


@pytest.mark.parametrize("s_in,window", [(80, 48), (200, 48), (200, None)])
def test_k2_plain_matches_jax_k2_on_quarter_slices(s_in, window):
    """At the card's tensor-core tile shapes (S_in 80 and 200, a window of
    48): a four-hop chain over quarter-pool slices of a randomly permuted
    pool, so every 4-block key tile mixes owned and other ranks' blocks,
    against JAX's K2 hop by hop (interim hops on rows with a real m) and
    finished."""
    mb = 20
    nb = 1 + B * mb
    rs = np.random.RandomState(s_in)
    q = rs.randn(B, HKV * G, s_in, HD).astype(np.float32)
    k, v = (rs.randn(nb, HKV, BS, HD).astype(np.float32) for _ in range(2))
    tables = (rs.permutation(nb - 1) + 1).reshape(B, mb).astype(np.int32)
    offs = np.asarray([0, 70], np.int32)
    per = -(-nb // 4)
    pad = np.zeros((per * 4 - nb,) + k.shape[1:], np.float32)
    k, v = np.concatenate([k, pad]), np.concatenate([v, pad])
    hops = [(k[i * per:(i + 1) * per], v[i * per:(i + 1) * per],
             tables - i * per) for i in range(4)]
    owned = [(t >= 0) & (t < per) for _, _, t in hops]
    tiles = np.stack(owned).reshape(4, B, mb // 4, 4)
    assert (tiles.any(-1) & ~tiles.all(-1)).mean() > 0.5  # mixed tiles
    R = G * s_in
    jcarry = tcarry = None
    for i, (ks, vs, tab) in enumerate(hops):
        jcarry = jpa.paged_carry_attention(
            jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs),
            jnp.asarray(tab), jnp.asarray(offs), carry=jcarry, window=window)
        tcarry = pa.paged_carry_attention(
            _t(q), _t(ks), _t(vs), _t(tab), _t(offs), carry=tcarry,
            window=window)
        acc, m, l = (t.numpy() for t in tcarry)
        jacc = np.asarray(jcarry[0])[:, :, :R]
        jm, jl = (np.asarray(x)[:, :, :R, 0] for x in jcarry[1:])
        _close(m, jm, f"m after hop {i}")
        met = jm > -1e29 if i < 3 else np.ones_like(jm, bool)
        _close(l[met], jl[met], f"l after hop {i}")
        _close(acc[met], jacc[met], f"acc after hop {i}")
    H = HKV * G
    got = pa.finalize_paged_carry(tcarry, B, H, s_in, HD, torch.float32)
    want = jpa.finalize_paged_carry(jcarry, B, H, s_in, HD, jnp.float32)
    _close(got.numpy(), np.asarray(want), "finished output")


def test_k2_carry_seed_and_empty_rows():
    """Without a carry the state starts at (0, NEG_INF, 0); a hop over a
    slice that owns none of a row's blocks leaves an incoming carry as it
    was; int8 pools raise, as in the reference."""
    q, k, v, tables, offs = _k2_inputs(5)
    remote = np.full_like(tables, NB + 3)  # every entry another rank's
    acc, m, l = pa.paged_carry_attention(_t(q), _t(k), _t(v), _t(remote),
                                         _t(offs))
    assert (acc == 0).all() and (l == 0).all() and (m == pa.NEG_INF).all()
    carry = pa.paged_carry_attention(_t(q), _t(k), _t(v), _t(tables),
                                     _t(offs))
    again = pa.paged_carry_attention(_t(q), _t(k), _t(v), _t(remote),
                                     _t(offs), carry=carry)
    for a, b in zip(again, carry):
        assert torch.equal(a, b)
    pair = (_t(k).to(torch.int8), torch.ones(NB, HKV, BS))
    with pytest.raises(NotImplementedError, match="int8"):
        pa.paged_carry_attention(_t(q), pair, pair, _t(tables), _t(offs))
    with pytest.raises(NotImplementedError, match="int8"):
        pa.paged_carry_attention_reference(_t(q), pair, pair, _t(tables),
                                           _t(offs))


def test_k2_rounding_scale_is_the_weighted_value_norm():
    """``paged_carry_rounding_scale`` over a two-hop chain equals
    ``sqrt(Σ (p v)²)`` computed from the normalised probabilities of the
    dense masked attention."""
    q, k, v, tables, offs = _k2_inputs(5, seed=3)
    window = 6
    got = pa.paged_carry_rounding_scale(
        _t(q), [tuple(map(_t, h)) for h in _hops(k, v, tables, 2)],
        _t(offs), window=window).numpy()
    kk = k[tables].transpose(0, 2, 1, 3, 4).reshape(B, HKV, MB * BS, HD)
    vv = v[tables].transpose(0, 2, 1, 3, 4).reshape(B, HKV, MB * BS, HD)
    kk, vv = np.repeat(kk, G, 1), np.repeat(vv, G, 1)
    s = np.einsum("bhqd,bhkd->bhqk", q, kk) / np.sqrt(HD)
    qpos = offs[:, None] + np.arange(5)
    kpos = np.arange(MB * BS)
    keep = ((kpos <= qpos[..., None]) & (kpos > qpos[..., None] - window))
    s = np.where(keep[:, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.sqrt(np.einsum("bhqk,bhkd->bhqd", p ** 2, vv ** 2))
    _close(got, want, "rounding scale")


# ------------------------------------------------------------ world 1


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A one-rank gloo group in this process, torn down after the
    module."""
    store = tmp_path_factory.mktemp("cp1") / "store"
    init_distributed(f"file://{store}", 1, 0, "cpu")
    try:
        yield build_cp_group(1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("prefill", [True, False], ids=["prefill", "decode"])
@pytest.mark.parametrize("window", [None, 6])
def test_ring_paged_world1_matches_jax_shard_map(world1, window, prefill):
    """The write then the attend (both arms) on the whole pool at cp 1,
    against JAX's ring under ``shard_map`` on a one-device mesh: the pool
    after the write exactly, the output within 1e-5; one hop, nothing
    sent."""
    s_in = 5 if prefill else 1
    q, k, v, tables, offs = _k2_inputs(s_in, seed=4)
    rs = np.random.RandomState(5)
    kval, vval = (rs.randn(B, HKV, s_in, HD).astype(np.float32)
                  for _ in range(2))
    mesh = Mesh(np.array(jax.devices()[:1]), ("context",))

    def f(ck, cv, qq, kv, vv, o, tab):
        kw = dict(tables=tab, cp_axis="context", prefill=prefill)
        ck = jrp.ring_paged_write(ck, kv, o, **kw)
        cv = jrp.ring_paged_write(cv, vv, o, **kw)
        return ck, cv, jrp.ring_paged_attend(qq, ck, cv, o, window=window,
                                             impl="gather", **kw)

    jck, jcv, jout = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P("context"), P("context")) + (P(),) * 5,
        out_specs=(P("context"), P("context"), P()), check_vma=False))(
        *map(jnp.asarray, (k, v, q, kval, vval, offs, tables)))
    sent = rp.RING_PAYLOADS["sent"]
    for impl in ("cuda", "gather"):
        ck, cv = _t(k).clone(), _t(v).clone()
        kw = dict(tables=_t(tables), group=world1, prefill=prefill)
        ck = rp.ring_paged_write(ck, _t(kval), _t(offs), **kw)
        cv = rp.ring_paged_write(cv, _t(vval), _t(offs), **kw)
        out = rp.ring_paged_attend(_t(q), ck, cv, _t(offs), window=window,
                                   impl=impl, **kw)
        np.testing.assert_array_equal(ck.numpy(), np.asarray(jck))
        np.testing.assert_array_equal(cv.numpy(), np.asarray(jcv))
        _close(out.numpy(), np.asarray(jout), impl)
    assert rp.RING_PAYLOADS["sent"] == sent
    assert rp.ring_hops_per_chunk(2, 1) == jrp.ring_hops_per_chunk(2, 1) == 0


def test_ring_models_match_the_reference():
    """The host-side ring models are the reference's, number for number."""
    for cp in (1, 2, 4, 8):
        assert rp.ring_hops_per_chunk(32, cp) == jrp.ring_hops_per_chunk(
            32, cp)
        kw = dict(nlayers=32, cp=cp, batch=4, kv_heads=8, head_dim=128,
                  chunk=512, nb_local=8193 // cp, block_size=16, itemsize=2)
        assert rp.ring_chunk_bytes(**kw) == jrp.ring_chunk_bytes(**kw)
        kw = dict(kv_heads=8, head_dim=128, block_size=16,
                  nb_local=8192 // cp, chunk=512, cp=cp, batch=4,
                  attend_temp_bytes=1 << 20)
        assert (rp.modeled_cp_working_set_bytes(**kw)
                == jrp.modeled_cp_working_set_bytes(**kw))


@pytest.fixture(scope="module")
def goldens():
    """Per family: JAX params, and the greedy tokens of JAX's serial
    engine and of its cp-1 engine (``cp_axis='context'``, gather arm, as
    ``tests/test_cp_prefill.py`` builds it), chunk 4."""
    out = {}
    for fam in W.FAMILIES:
        cfg = jax_config(fam)
        params = jinit(jax.random.PRNGKey(0), cfg)
        prompts = W.prompts(cfg.vocab_size)
        serial = W.run_requests(
            JEngine(params, cfg, chunk=4, attn_impl="gather", **W.ENGINE),
            JRequest, prompts)
        tpc.setup_process_groups([("context", 1)],
                                 devices=jax.devices()[:1])
        try:
            eng = JEngine(params, cfg, chunk=4, attn_impl="gather",
                          mesh=tpc.get_view(), cp_axis="context", **W.ENGINE)
            cp1 = W.run_requests(eng, JRequest, prompts)
            lc = eng.serving_summary()["long_context"]
        finally:
            tpc.reset()
        out[fam] = {"np": jax.tree.map(np.asarray, params), "serial": serial,
                    "cp1": cp1, "long_context": lc}
    return out


@pytest.mark.parametrize("arm", ["cuda", "gather"])
@pytest.mark.parametrize("family", sorted(W.FAMILIES))
def test_cp_engine_world1_equals_jax_engines(goldens, world1, family, arm):
    """Tokens equal JAX's serial engine and its cp-1 engine; the
    ``long_context`` block reads cp 1 and no ring traffic, as JAX's does;
    no kernel launched (CPU tensors) and the pool is conserved."""
    gold = goldens[family]
    cfg = W.torch_config(family)
    eng = ServingEngine(params_from_jax(gold["np"], cfg, device="cpu"), cfg,
                        device="cpu", cp_group=world1, attn_impl=arm,
                        chunk=4, **W.ENGINE)
    assert eng.cp == 1 and eng.attn_impl == arm
    got = W.run_requests(eng, Request, W.prompts(cfg.vocab_size))
    for i, (g, s, c) in enumerate(zip(got, gold["serial"], gold["cp1"])):
        np.testing.assert_array_equal(g, s, err_msg=f"{family} {arm} {i}")
        np.testing.assert_array_equal(g, c, err_msg=f"{family} {arm} {i}")
    summ = eng.serving_summary()
    lc, jlc = summ["long_context"], gold["long_context"]
    assert lc == {k: jlc[k] for k in lc}
    assert lc["cp"] == 1 and lc["ring_hops"] == lc["ring_bytes"] == 0
    assert lc["prefill_chunks"] > 0
    assert summ["kernel_launches"] == {"paged_decode_attention": 0,
                                       "paged_carry_attention": 0}
    assert eng.audit(heal=False)["ok"] and eng._alloc.in_use == 0


def test_cp_engine_refusals(world1):
    """What context parallelism does not serve is refused with the
    reference's reasons; ``mesh=`` / ``cp_axis=`` name ``cp_group``."""
    cfg = W.torch_config("sliding")
    kw = dict(device="cpu", cp_group=world1, **W.ENGINE)
    cases = [
        (dict(kv_quant=True), "kv_quant"),
        (dict(spec_k=2), "speculative"),
        (dict(prefix_cache=True), "prefix_cache"),
        (dict(ep_group=world1), "ep_group"),
    ]
    for extra, match in cases:
        with pytest.raises(NotImplementedError, match=match):
            ServingEngine(None, cfg, **kw, **extra)
    moe = dataclasses.replace(cfg, moe_experts=4)
    with pytest.raises(NotImplementedError, match="MoE"):
        ServingEngine(None, moe, **kw)
    for extra in ({"cp_axis": "context"}, {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="cp_group"):
            ServingEngine(None, cfg, device="cpu", **extra, **W.ENGINE)
    with pytest.raises(ValueError, match="does not divide"):
        build_cp_group(3)
    with pytest.raises(ValueError, match="'cuda' or 'gather'"):
        rp.ring_paged_attend(torch.zeros(1, 2, 1, 16),
                             torch.zeros(2, 1, 16, 16),
                             torch.zeros(2, 1, 16, 16), torch.zeros(1),
                             tables=torch.zeros(1, 1, dtype=torch.int32),
                             group=world1, impl="pallas")
