"""The port's context-parallel (CP) serving across ranks, against the JAX
package, on the CPU, in f32 at small widths.

- At world 4 over gloo (4 processes of ``tests/_torch_cp_worker.py``,
  JAX-free, started once for the module): ``ServingEngine(cp_group=)``
  greedy tokens EQUAL to JAX's serial engine on the ``dense`` and
  ``sliding`` families of ``tests/test_cp_prefill.py``, K2's arm and the
  plain arm, at a chunk of 4 (one row a rank: the sub-chunk is one row
  and still rides the ring) and of 8; the ``long_context`` hops and bytes
  equal the reference's ``ring_hops_per_chunk`` / ``ring_chunk_bytes``
  times the prefill chunks, and the ring's own payload counter agrees;
  the default pool rounds up to a multiple of cp and the refusals of a
  chunk or a pool cp does not divide; ``cp_paged_forward``'s logits
  against JAX's serial ``paged_forward``, and each rank's pool slice
  holding exactly its own blocks' rows.
- At world 2 (CP groups {0, 1} and {2, 3} of the same 4 processes):
  ``ring_paged_write`` + ``ring_paged_attend`` on per-rank pool slices
  against JAX's gather arm under ``shard_map`` on 2 CPU devices.
"""

import ast
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import _torch_cp_worker as W
from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.models import llama_config as jllama
from torchdistpackage_tpu.ops import ring_paged as jrp
from torchdistpackage_tpu.serving import Request as JRequest
from torchdistpackage_tpu.serving import ServingEngine as JEngine
from torchdistpackage_tpu.serving import paged_cache as jpc

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_cp_worker.py")
WORLD = 4
RUNS = [f"{fam}-{arm}-c{chunk}" for fam in W.FAMILIES
        for arm, chunk in W.ENGINE_RUNS]


def jax_config(family):
    if family == "dense":
        return JGPTConfig(**W.FAMILIES[family])
    return jllama(**W.FAMILIES[family], dtype=jnp.float32)


@pytest.fixture(scope="module")
def families():
    """Per family: the JAX params (numpy) and its serial engine's greedy
    tokens at each chunk the world-4 runs use."""
    out = {}
    for fam in W.FAMILIES:
        cfg = jax_config(fam)
        params = jinit(jax.random.PRNGKey(0), cfg)
        want = {}
        for chunk in sorted({c for _, c in W.ENGINE_RUNS}):
            eng = JEngine(params, cfg, chunk=chunk, attn_impl="gather",
                          **W.ENGINE)
            want[chunk] = W.run_requests(eng, JRequest,
                                         W.prompts(cfg.vocab_size))
        out[fam] = {"cfg": cfg, "params": params,
                    "np": jax.tree.map(np.asarray, params), "want": want}
    return out


def _forward_inputs():
    B, C, MB = W.FWD["B"], W.FWD["C"], W.FWD["MB"]
    rs = np.random.RandomState(11)
    # slot 0 on blocks 1..6, slot 1 on 12..7: every rank holds some
    tables = np.stack([np.arange(1, 1 + MB),
                       np.arange(2 * MB, MB, -1)]).astype(np.int32)
    toks = [rs.randint(0, 64, (B, n)).astype(np.int32) for n in (C, C, 1)]
    return tables, toks


def _ring2_inputs():
    R = W.RING
    rs = np.random.RandomState(12)

    def rnd(*shape):
        return rs.randn(*shape).astype(np.float32)

    tables = np.asarray([[1, 7, 2, 8, 3], [11, 4, 10, 5, 9]], np.int32)
    out = {"k_pool": rnd(R["NB"], R["HKV"], R["BS"], R["HD"]),
           "v_pool": rnd(R["NB"], R["HKV"], R["BS"], R["HD"]),
           "tables": tables}
    for phase, S, offs in (("prefill", R["C"], [0, 5]),
                           ("decode", 1, [6, 11])):
        out[f"{phase}/q"] = rnd(R["B"], R["H"], S, R["HD"])
        out[f"{phase}/k"] = rnd(R["B"], R["HKV"], S, R["HD"])
        out[f"{phase}/v"] = rnd(R["B"], R["HKV"], S, R["HD"])
        out[f"{phase}/offsets"] = np.asarray(offs, np.int32)
    return out


@pytest.fixture(scope="module")
def world4(tmp_path_factory, families):
    """Every multi-rank run at once: 4 worker processes over gloo."""
    d = tmp_path_factory.mktemp("cp4")
    inp = {}
    for fam, f in families.items():
        inp.update({f"{fam}/{k}": v for k, v in W.flatten(f["np"]).items()})
    tables, toks = _forward_inputs()
    inp["forward/tables"] = tables
    inp.update({f"forward/tok{i}": t for i, t in enumerate(toks)})
    inp.update({f"ring2/{k}": v for k, v in _ring2_inputs().items()})
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD),
         f"file://{d / 'store'}", str(d / "in.npz"), str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def _run(name):
    fam, arm, chunk = name.split("-")
    return fam, f"engine/{fam}/{arm}/{chunk}", int(chunk[1:])


# ------------------------------------------------------------ the engine


@pytest.mark.parametrize("name", RUNS)
def test_cp_engine_world4_equals_jax_serial_engine(families, world4, name):
    """Four ranks, each holding a quarter of the pool, serve the same
    requests: every rank's greedy tokens equal JAX's serial engine's, the
    pool is conserved, and nothing launched a kernel on the CPU."""
    fam, tag, chunk = _run(name)
    for r, res in enumerate(world4):
        for i, w in enumerate(families[fam]["want"][chunk]):
            np.testing.assert_array_equal(res[f"{tag}/tokens{i}"], w,
                                          err_msg=f"{name} rank {r} req {i}")
        assert bool(res[f"{tag}/audit_ok"]), f"{name} rank {r}"
        assert int(res[f"{tag}/launches"]) == 0


@pytest.mark.parametrize("name", RUNS)
def test_cp_engine_world4_ring_counts_match_the_model(families, world4,
                                                      name):
    """``long_context`` reads cp 4 and hops / bytes equal to the
    reference's analytic model times the prefill chunks; the ring sent
    exactly that many payloads from every rank, and one
    ``cp_prefill_chunk`` / ``cp_ring_hop`` pair was emitted a chunk."""
    fam, tag, chunk = _run(name)
    cfg = families[fam]["cfg"]
    for r, res in enumerate(world4):
        lc = json.loads(str(res[f"{tag}/long_context"]))
        n = lc["prefill_chunks"]
        assert n > 0 and lc["cp"] == WORLD and lc["chunk"] == chunk
        hops = n * jrp.ring_hops_per_chunk(cfg.nlayers, WORLD)
        assert lc["ring_hops"] == hops == int(res[f"{tag}/payloads"])
        assert lc["ring_bytes"] == n * jrp.ring_chunk_bytes(
            nlayers=cfg.nlayers, cp=WORLD, batch=W.ENGINE["num_slots"],
            kv_heads=cfg.block.kv_head_count, head_dim=cfg.block.head_dim,
            chunk=chunk, nb_local=W.ENGINE["num_blocks"] // WORLD,
            block_size=W.ENGINE["block_size"], itemsize=4)
        ev = json.loads(str(res[f"{tag}/events"]))
        kinds = [e["kind"] for e in ev]
        assert kinds == ["cp_prefill_chunk", "cp_ring_hop"] * n
        assert all(e["sub_chunk"] == chunk // WORLD for e in ev[0::2])
        assert sum(e["hops"] for e in ev[1::2]) == hops
        assert sum(e["bytes"] for e in ev[1::2]) == lc["ring_bytes"]


def test_cp_engine_world4_pool_sizing_and_refusals(world4):
    """The default pool (1 + 3 slots x 6 blocks = 19) rounds up to 20, a
    rank holds 5 blocks and its pool bytes are the slice's; a chunk or an
    explicit pool that 4 does not divide is refused."""
    for res in world4:
        assert int(res["sizing/num_blocks"]) == 20
        assert int(res["sizing/local_blocks"]) == 5
        kv = json.loads(str(res["sizing/pool_bytes"]))
        assert kv["pool_bytes"] == kv["pool_bytes_expected"] > 0
        refused = str(res["sizing/refused_chunk"])
        assert "chunk (6) must be divisible" in refused
        assert "num_blocks (18) must be divisible" in str(
            res["sizing/refused_num_blocks"])


# ------------------------------------------------------- cp_paged_forward


def test_cp_paged_forward_world4_matches_jax_serial(families, world4):
    """Two prefill chunks and a decode step of two slots whose blocks lie
    on all four ranks: every rank's logits equal JAX's serial
    ``paged_forward`` (the head row on one rank, summed over the group),
    and rank r's slice equals blocks [4 r, 4 r + 4) of JAX's pool — its own
    blocks' rows written, every other block untouched."""
    fam = families["sliding"]
    cfg, params = fam["cfg"], fam["params"]
    tables, toks = _forward_inputs()
    C = W.FWD["C"]
    nb = W.fwd_blocks(WORLD)
    cache = jpc.init_paged_kv(cfg, nb, W.FWD["BS"])
    steps = ((toks[0], [0, 0], [C - 1, 5]), (toks[1], [C, C], [4, C - 1]),
             (toks[2], [2 * C, 2 * C], None))
    want = []
    for tok, off, last in steps:
        cache, logits = jpc.paged_forward(
            params, jnp.asarray(tok), cfg, cache, jnp.asarray(tables),
            jnp.asarray(off, jnp.int32),
            last_idx=None if last is None else jnp.asarray(last),
            attn_impl="gather")
        want.append(np.asarray(logits))
    nbl = nb // WORLD
    for r, res in enumerate(world4):
        for i, w in enumerate(want):
            np.testing.assert_allclose(res[f"forward/logits{i}"], w,
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} step {i}")
        for name in ("k", "v"):
            np.testing.assert_allclose(
                res[f"forward/{name}"],
                np.asarray(cache[name])[:, r * nbl:(r + 1) * nbl],
                rtol=1e-5, atol=1e-6, err_msg=f"rank {r} {name} slice")
    # every rank's slice was written
    assert all(np.abs(res["forward/k"]).max() > 0 for res in world4)


# --------------------------------------------------------- the ring at 2


@pytest.fixture(scope="module")
def jax_ring2():
    """JAX's ``ring_paged_write`` then gather-arm ``ring_paged_attend``
    under ``shard_map`` on a 2-device ``context`` mesh: per phase the
    pool (block dim sharded) and the output (prefill: rows sharded)."""
    R = W.RING
    inp = {k: jnp.asarray(v) for k, v in _ring2_inputs().items()}
    mesh = Mesh(np.array(jax.devices()[:2]), ("context",))
    out = {}
    for phase, prefill in (("prefill", True), ("decode", False)):
        def f(ck, cv, q, kval, vval, offs, tables, prefill=prefill):
            kw = dict(tables=tables, cp_axis="context", prefill=prefill)
            ck = jrp.ring_paged_write(ck, kval, offs, **kw)
            cv = jrp.ring_paged_write(cv, vval, offs, **kw)
            o = jrp.ring_paged_attend(q, ck, cv, offs, window=R["WINDOW"],
                                      impl="gather", **kw)
            return ck, cv, o

        rows = P(None, None, "context", None) if prefill else P()
        ck, cv, o = jax.jit(jax.shard_map(
            f, mesh=mesh,
            in_specs=(P("context"), P("context"), rows, rows, rows, P(), P()),
            out_specs=(P("context"), P("context"), rows),
            check_vma=False))(
            inp["k_pool"], inp["v_pool"], inp[f"{phase}/q"],
            inp[f"{phase}/k"], inp[f"{phase}/v"], inp[f"{phase}/offsets"],
            inp["tables"])
        out[phase] = (np.asarray(ck), np.asarray(cv), np.asarray(o))
    return out


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_ring_paged_world2_matches_jax_shard_map(world4, jax_ring2, phase):
    """Each rank of a CP group of 2 (both pairs of the 4 processes) holds
    half the pool: after the write ring its slice equals JAX's, and its
    output rows (both arms) equal JAX's gather arm — a prefill rank its
    sub-chunk, a decode rank the combined row."""
    ck, cv, o = jax_ring2[phase]
    nbl = W.RING["NB"] // 2
    sub = W.RING["C"] // 2
    for rank, res in enumerate(world4):
        r = rank % 2
        np.testing.assert_allclose(res[f"ring2/{phase}/k_slice"],
                                   ck[r * nbl:(r + 1) * nbl], rtol=0, atol=0)
        np.testing.assert_allclose(res[f"ring2/{phase}/v_slice"],
                                   cv[r * nbl:(r + 1) * nbl], rtol=0, atol=0)
        want = o[:, :, r * sub:(r + 1) * sub] if phase == "prefill" else o
        for impl in ("cuda", "gather"):
            np.testing.assert_allclose(
                res[f"ring2/{phase}/{impl}/out"], want, rtol=1e-5,
                atol=1e-5, err_msg=f"rank {rank} {impl}")


def test_cp_worker_and_ring_import_no_jax():
    """The worker and the ring module import the port and numpy only."""
    here = os.path.dirname(os.path.abspath(__file__))
    for path in (WORKER, os.path.join(os.path.dirname(here),
                                      "torchdistpackage_tpu_torch", "ops",
                                      "ring_paged.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "torchdistpackage_tpu"), (path, name)
