"""The prefix cache's pieces against the JAX package, on the CPU:
``BlockAllocator`` over seeded operation sequences (equal block ids,
counters and audit reports at every step), ``chain_block_hashes``,
``copy_blocks`` and ``migrate_blocks`` (fp and int8 ``(q8, scale)``
pools, ``compress=True``) and ``migration_wire_bytes`` — all EXACT — a
warm chunk's logits over a shared prefix block against the reference's
(f32, within 2e-5 of the logits' scale), and the real-model engine with
``prefix_cache=True`` (``'gather'``, the CPU path) giving the reference
engine's greedy tokens, COW admissions and stats."""

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
from torchdistpackage_tpu.serving import paged_cache as jpc
from torchdistpackage_tpu_torch.models import GPTConfig, llama_config
from torchdistpackage_tpu_torch.models.convert import params_from_jax
from torchdistpackage_tpu_torch.serving import Request, ServingEngine
from torchdistpackage_tpu_torch.serving import paged_cache as tpc

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


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_np(a) for a in x)
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------- allocator


def _alloc_step(rs, a, owned, hashes):
    """One seeded operation on allocator ``a``; ``owned`` is the list of
    ownership references held (one entry a reference).  Returns what the
    operation returned, for comparison."""
    op = rs.choice(["alloc", "alloc", "free", "share", "register",
                    "match", "audit", "pop", "reclaim"],
                   p=[.2, .1, .2, .15, .15, .08, .05, .04, .03])
    if op == "alloc":
        got = a.alloc(int(rs.randint(0, 5)))
        owned.extend(got or [])
        return op, got
    if op == "free" and owned:
        b = owned.pop(int(rs.randint(len(owned))))
        a.free([b])
        return op, b
    if op == "share":
        resident = sorted(set(a._ref) | set(a._cached))
        if resident:
            b = resident[int(rs.randint(len(resident)))]
            a.share(b)
            owned.append(b)
            return op, b
    if op == "register" and owned:
        b = owned[int(rs.randint(len(owned)))]
        return op, a.register(b, hashes[int(rs.randint(len(hashes)))])
    if op == "match":
        k = int(rs.randint(1, 4))
        return op, a.match([hashes[int(i)] for i in
                            rs.randint(0, len(hashes), k)])
    if op == "audit":
        return op, a.audit([[b] for b in owned])
    if op == "pop":
        return op, a.pop_evicted()
    if op == "reclaim" and owned:
        b = owned[int(rs.randint(len(owned)))]
        healed = a.reclaim([b, 0])
        while b in owned:
            owned.remove(b)
        return op, healed
    return "noop", None


@pytest.mark.parametrize("seed", range(4))
def test_allocator_sequence_equals_jax(seed):
    """Equal results, free lists, refcounts, the LRU order and the
    counters after every one of 300 seeded operations."""
    j, t = jpc.BlockAllocator(12), tpc.BlockAllocator(12)
    jo, to = [], []
    hashes = jpc.chain_block_hashes(np.arange(40) % 7, 4)
    rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
    for n in range(300):
        a = _alloc_step(rj, j, jo, hashes)
        b = _alloc_step(rt, t, to, hashes)
        assert a == b, f"op {n}"
        assert (t._free, t._ref, list(t._cached), t._hash_of, t._by_hash,
                t.cache_evictions, t.peak_in_use, t.in_use, t.n_cached) == (
            j._free, j._ref, list(j._cached), j._hash_of, j._by_hash,
            j.cache_evictions, j.peak_in_use, j.in_use, j.n_cached), n
    assert t.audit([[b] for b in to]) == j.audit([[b] for b in jo])


@pytest.mark.parametrize("n", [0, 3, 4, 17, 64])
def test_chain_block_hashes_equal_jax(n):
    toks = np.random.RandomState(n).randint(0, 1000, n)
    assert tpc.chain_block_hashes(toks, 4) == jpc.chain_block_hashes(toks, 4)
    assert tpc.chain_block_hashes(toks.tolist(), 4) == \
        jpc.chain_block_hashes(toks, 4)


# ------------------------------------------------------------ block copies

CCFG = (JGPTConfig(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=32,
                   dtype=jnp.float32),
        GPTConfig(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=32))
NBLK, BS = 9, 4


def _pools(quantized, seed):
    """The same random contents as a JAX pool and a torch pool."""
    jcfg, tcfg = CCFG
    shape = (2, NBLK, 4, BS, 8)
    rs = np.random.RandomState(seed)
    if quantized:
        def entry():
            return (rs.randint(-127, 128, shape).astype(np.int8),
                    rs.rand(*shape[:-1]).astype(np.float32))
        base = {"k": entry(), "v": entry()}
    else:
        base = {"k": rs.randn(*shape).astype(np.float32),
                "v": rs.randn(*shape).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, base)
    tp = {k: (tuple(torch.from_numpy(a.copy()) for a in v)
              if isinstance(v, tuple) else torch.from_numpy(v.copy()))
          for k, v in base.items()}
    return jp, tp


LANES = (np.array([3, 5, 0, 0, 8], np.int32),   # src
         np.array([6, 2, 0, 0, 3], np.int32))   # dst: 3 is read then written


def _equal(tpool, jpool):
    jax.tree.map(np.testing.assert_array_equal, _np(tpool),
                 jax.tree.map(np.asarray, jpool))


@pytest.mark.parametrize("quantized", [False, True])
def test_copy_blocks_equal_jax(quantized):
    jp, tp = _pools(quantized, 0)
    src, dst = LANES
    want = jpc.copy_blocks(jp, jnp.asarray(src), jnp.asarray(dst))
    got = tpc.copy_blocks(tp, src, dst)
    assert got is tp  # in place
    _equal(got, want)
    # lanes as a device tensor take the same path
    _, tp2 = _pools(quantized, 0)
    _equal(tpc.copy_blocks(tp2, torch.from_numpy(src), torch.from_numpy(dst)),
           want)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("quantized", [False, True])
def test_migrate_blocks_equal_jax(quantized, compress):
    jsrc, tsrc = _pools(quantized, 1)
    jdst, tdst = _pools(quantized, 2)
    src, dst = LANES
    want = jpc.migrate_blocks(jsrc, jdst, jnp.asarray(src), jnp.asarray(dst),
                              compress=compress)
    got = tpc.migrate_blocks(tsrc, tdst, src, dst, compress=compress)
    _equal(got, want)
    _equal(tsrc, jsrc)  # the source is read only


@pytest.mark.parametrize("quantized", [False, True])
def test_migrate_from_a_snapshot_after_the_pool_is_reused(quantized):
    """A :class:`PoolSnapshot` keeps the exported blocks when the source
    pool's blocks are overwritten; ``migrate_blocks`` reads it through
    the source's block ids, NULL pad lanes included."""
    jsrc, tsrc = _pools(quantized, 3)
    jdst, tdst = _pools(quantized, 4)
    src, dst = LANES
    want = jpc.migrate_blocks(jsrc, jdst, jnp.asarray(src), jnp.asarray(dst))
    snap = tpc.PoolSnapshot(tsrc, [3, 5, 8])
    for leaf in tpc._leaves(tsrc):
        leaf.zero_()  # the source engine reuses every block
    got = tpc.migrate_blocks(snap, tdst, src, dst)
    _equal(got, want)
    assert tpc.block_size_of(snap) == BS
    with pytest.raises(ValueError, match="not in this snapshot"):
        tpc.migrate_blocks(snap, tdst, [4], [1])


@pytest.mark.parametrize("kw", [{}, {"quantized": True},
                                {"compressed": True}, {"axis_size": 2},
                                {"quantized": True, "compressed": True}])
def test_migration_wire_bytes_equal_jax(kw):
    jcfg, tcfg = CCFG
    for n in (0, 1, 5):
        assert tpc.migration_wire_bytes(tcfg, n, BS, **kw) == \
            jpc.migration_wire_bytes(jcfg, n, BS, **kw)


# ------------------------------------------------------ warm admission logits


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_warm_chunk_logits_over_a_shared_block(family):
    """A chunk whose prefix block was written by another table row (the
    prefix-hit shape: the chunk starts at a block boundary inside the
    prompt) gives the reference's logits, and the port's cold run's."""
    jcfg, tcfg = (f() for f in FAMILIES[family])
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    prompt = np.random.RandomState(5).randint(0, 64, 8).astype(np.int32)
    last = np.array([3], np.int32)

    def run(forward, pool, tab, toks, off, conv):
        return forward(tp if conv is torch.from_numpy else jp,
                       conv(toks[None]), tcfg if conv is torch.from_numpy
                       else jcfg, pool, conv(tab), conv(np.array([off],
                                                                 np.int32)),
                       last_idx=conv(last))

    t0, t1 = prompt[:4], prompt[4:]
    cold, warm = np.array([[1, 2, 0]], np.int32), np.array([[1, 3, 0]],
                                                           np.int32)
    jpool = jpc.init_paged_kv(jcfg, 8, 4)
    jpool, _ = run(jpc.paged_forward, jpool, cold, t0, 0, jnp.asarray)
    jpool, jlog = run(jpc.paged_forward, jpool, warm, t1, 4, jnp.asarray)
    tpool = tpc.init_paged_kv(tcfg, 8, 4, device="cpu")
    tpool, _ = run(tpc.paged_forward, tpool, cold, t0, 0, torch.from_numpy)
    tpool, tcold = run(tpc.paged_forward, tpool, cold, t1, 4,
                       torch.from_numpy)
    tpool, twarm = run(tpc.paged_forward, tpool, warm, t1, 4,
                       torch.from_numpy)
    scale = float(np.abs(np.asarray(jlog)).max())
    np.testing.assert_allclose(twarm.numpy(), np.asarray(jlog), rtol=0,
                               atol=2e-5 * scale)
    assert torch.equal(twarm, tcold)  # sharing is table indirection only


# ---------------------------------------------------- the real-model engine

ENGINE = dict(num_slots=3, block_size=4, chunk=8, max_ctx=48,
              num_blocks=1 + 22, prefix_cache=True)
NEW = 5


def _trace(eng, R):
    """Two system prompts, their warm tails, a whole-prompt hit (COW),
    two COWs of one block in one wave, a preemption over shared blocks,
    and eviction pressure; returns every rid in submit order."""
    rs = np.random.RandomState(7)
    sysp = [rs.randint(0, 64, 12).tolist() for _ in range(2)]
    rids = [eng.submit(R(s + [3], NEW)) for s in sysp]
    eng.run_until_idle(max_ticks=300)
    rids += [eng.submit(R(sysp[i % 2] + rs.randint(0, 64, 2 + i).tolist(),
                          NEW)) for i in range(3)]
    rids += [eng.submit(R(sysp[0], NEW)), eng.submit(R(sysp[0], NEW))]
    eng.step()
    rids.append(eng.submit(R(rs.randint(0, 64, 20).tolist(), NEW,
                             priority=1)))
    eng.run_until_idle(max_ticks=300)
    rids += [eng.submit(R(rs.randint(0, 64, 18).tolist(), NEW))
             for _ in range(3)]
    eng.run_until_idle(max_ticks=300)
    return rids


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def engines(request):
    jcfg, tcfg = (f() for f in FAMILIES[request.param])
    jp = jinit(jax.random.PRNGKey(1), jcfg)
    jeng = JEngine(jp, jcfg, attn_impl="gather", **ENGINE)
    jrids = _trace(jeng, JRequest)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    teng = ServingEngine(tp, tcfg, device="cpu", **ENGINE)
    trids = _trace(teng, Request)
    return {"name": request.param, "jax": (jeng, jrids),
            "torch": (teng, trids)}


def test_prefix_engine_greedy_tokens_equal_jax(engines):
    (jeng, jrids), (teng, trids) = engines["jax"], engines["torch"]
    assert trids == jrids
    for r in trids:
        np.testing.assert_array_equal(
            teng.finished[r]["tokens"], jeng.finished[r]["tokens"],
            err_msg=f"{engines['name']} request {r}")


def test_prefix_engine_stats_and_blocks_equal_jax(engines):
    (jeng, _), (teng, _) = engines["jax"], engines["torch"]
    st = teng.stats
    assert st == {k: v for k, v in jeng.stats.items()}
    assert st["prefix_hits"] >= 4 and st["cow_copies"] >= 2
    assert st["preempted"] >= 1 and st["cache_evictions"] > 0
    ja = jeng._allocs[0]
    assert (teng._alloc._free, list(teng._alloc._cached),
            teng._alloc._by_hash) == (ja._free, list(ja._cached), ja._by_hash)
    assert teng.audit(heal=False)["ok"] and teng._alloc.in_use == 0
    s, js = teng.serving_summary(), jeng.serving_summary()
    for key in ("prefix_hit_rate", "prefix_cache", "requests", "verdict"):
        assert s[key] == js[key], key
