"""One rank of the port's context-parallel (CP) runs on the CPU, for
tests/test_torch_cp.py — not a pytest file.

The parent writes the inputs (numpy arrays, made with JAX) to an
``.npz``, starts ``world`` copies of this script, one a rank, and reads
each rank's ``rank<r>.npz`` back.  Every copy joins a gloo process group
through a ``file://`` rendezvous and runs:

- ``engine/<family>/<arm>/c<chunk>``: ``ServingEngine(cp_group=...)`` over
  all ranks on the family's converted weights, serving the prompts of
  :func:`prompts`; saves each request's tokens, the ``long_context``
  summary, the ring's own payload count (``RING_PAYLOADS``) and the
  ``cp_prefill_chunk`` / ``cp_ring_hop`` events;
- ``sizing/*``: the default pool size, the slice each rank holds, and the
  refusals of a chunk or a pool that cp does not divide;
- ``forward/*``: ``cp_paged_forward`` on two prefill chunks and a decode
  step of the ``sliding`` family — the logits and the rank's pool slice;
- ``ring2/*``: ``ring_paged_write`` then ``ring_paged_attend`` (both
  arms) of a prefill chunk and a decode row on CP groups of 2 (ranks
  {0, 1} and {2, 3}, each pair on the same inputs).

Imports only the port (and numpy): never JAX.  Run as
``python tests/_torch_cp_worker.py RANK WORLD INIT_METHOD IN_NPZ OUT_DIR``.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

#: the families of tests/test_cp_prefill.py (its dense and sliding ones)
FAMILIES = {
    "dense": dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=64),
    "sliding": dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=64,
                    kv_heads=2, ffn_hidden=48, sliding_window=6),
}
#: the engine shape of tests/test_cp_prefill.py; at cp 4 a chunk of 4 is
#: one row a rank
ENGINE = dict(num_slots=2, block_size=4, num_blocks=16)
PROMPT_LENS = (9, 14)
NEW = 6
#: the world-4 engine runs: (attn_impl, chunk)
ENGINE_RUNS = (("cuda", 4), ("gather", 4), ("cuda", 8))
#: the cp_paged_forward case: slots, block size, chunk, table width
FWD = dict(B=2, BS=4, C=8, MB=6)
#: the two-rank ring case: slots, query heads, kv heads, chunk, head dim,
#: block size, blocks, table width, window
RING = dict(B=2, H=4, HKV=2, C=6, HD=16, BS=4, NB=12, MB=5, WINDOW=7)


def fwd_blocks(world):
    """The forward case's pool: its slots' blocks and the NULL block,
    rounded up to a multiple of the CP size."""
    need = 1 + FWD["B"] * FWD["MB"]
    return -(-need // world) * world


def torch_config(family):
    from torchdistpackage_tpu_torch.models import GPTConfig, llama_config

    if family == "dense":
        return GPTConfig(**FAMILIES[family], dtype=torch.float32)
    return llama_config(**FAMILIES[family], dtype=torch.float32)


def prompts(vocab):
    rs = np.random.RandomState(7)
    return [rs.randint(0, vocab, n).tolist() for n in PROMPT_LENS]


def run_requests(eng, make_req, prompt_list):
    rids = [eng.submit(make_req(p, NEW)) for p in prompt_list]
    eng.run_until_idle(max_ticks=500)
    return [np.asarray(eng.finished[r]["tokens"]) for r in rids]


def unflatten(flat):
    """``{'a/b': array}`` -> nested dicts."""
    root = {}
    for path, arr in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return root


def flatten(tree, prefix=""):
    """:func:`unflatten`'s inverse."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def family_params(inp, family):
    from torchdistpackage_tpu_torch.models.convert import params_from_jax

    tree = unflatten({k[len(family) + 1:]: inp[k] for k in inp.files
                      if k.startswith(family + "/")})
    return params_from_jax(tree, torch_config(family), device="cpu")


def engine_runs(group, inp):
    from torchdistpackage_tpu_torch.obs.events import default_event_log
    from torchdistpackage_tpu_torch.ops.ring_paged import RING_PAYLOADS
    from torchdistpackage_tpu_torch.serving import Request, ServingEngine

    out = {}
    log = default_event_log()
    for family in FAMILIES:
        cfg = torch_config(family)
        params = family_params(inp, family)
        for arm, chunk in ENGINE_RUNS:
            tag = f"engine/{family}/{arm}/c{chunk}"
            eng = ServingEngine(params, cfg, device="cpu", cp_group=group,
                                attn_impl=arm, chunk=chunk, **ENGINE)
            n0, sent0 = len(log.as_list()), RING_PAYLOADS["sent"]
            for i, t in enumerate(run_requests(eng, Request,
                                               prompts(cfg.vocab_size))):
                out[f"{tag}/tokens{i}"] = t
            s = eng.serving_summary()
            out[f"{tag}/long_context"] = np.asarray(
                json.dumps(s["long_context"]))
            out[f"{tag}/payloads"] = np.asarray(RING_PAYLOADS["sent"] - sent0)
            ev = log.as_list()[n0:]
            out[f"{tag}/events"] = np.asarray(json.dumps(
                [{k: e[k] for k in ("kind", "hops", "bytes", "cp",
                                    "sub_chunk") if k in e}
                 for e in ev if e["kind"].startswith("cp_")]))
            out[f"{tag}/audit_ok"] = np.asarray(
                eng.audit(heal=False)["ok"] and eng._alloc.in_use == 0)
            out[f"{tag}/launches"] = np.asarray(
                sum(s["kernel_launches"].values()))
    return out


def sizing_runs(group):
    from torchdistpackage_tpu_torch.serving import ServingEngine

    cfg = torch_config("dense")
    out = {}
    eng = ServingEngine(None, cfg, device="cpu", cp_group=group,
                        num_slots=3, block_size=4, chunk=4, max_ctx=24)
    out["sizing/num_blocks"] = np.asarray(eng.num_blocks)
    out["sizing/local_blocks"] = np.asarray(eng.cache["k"].shape[1])
    out["sizing/pool_bytes"] = np.asarray(json.dumps(
        {k: eng.serving_summary()["kv_pool"][k]
         for k in ("pool_bytes", "pool_bytes_expected")}))
    for name, kw in (("chunk", dict(chunk=6)),
                     ("num_blocks", dict(chunk=4, num_blocks=18))):
        try:
            ServingEngine(None, cfg, device="cpu", cp_group=group,
                          num_slots=2, block_size=4, **kw)
            msg = ""
        except ValueError as e:
            msg = str(e)
        out[f"sizing/refused_{name}"] = np.asarray(msg)
    return out


def forward_runs(group, inp):
    """Two prefill chunks of two slots whose blocks lie on every rank,
    then a decode step."""
    from torchdistpackage_tpu_torch.serving.paged_cache import (
        cp_paged_forward,
        init_paged_kv,
    )

    cfg = torch_config("sliding")
    params = family_params(inp, "sliding")
    world = group.size()
    B, BS, C, MB = (FWD[k] for k in ("B", "BS", "C", "MB"))
    cache = init_paged_kv(cfg, fwd_blocks(world), BS, device="cpu",
                          cp=world)
    tables = torch.from_numpy(inp["forward/tables"])
    out = {}
    for step, (tok, off, last) in enumerate((
            (inp["forward/tok0"], [0, 0], [C - 1, 5]),
            (inp["forward/tok1"], [C, C], [4, C - 1]),
            (inp["forward/tok2"], [2 * C, 2 * C], None))):
        cache, logits = cp_paged_forward(
            params, torch.from_numpy(tok), cfg, cache, tables,
            torch.tensor(off, dtype=torch.int32), cp_group=group,
            last_idx=None if last is None else torch.tensor(last),
            attn_impl="cuda")
        out[f"forward/logits{step}"] = logits.numpy()
    out["forward/k"] = cache["k"].numpy()
    out["forward/v"] = cache["v"].numpy()
    return out


def ring2_runs(inp):
    """``ring_paged_write`` + ``ring_paged_attend`` on CP groups of 2."""
    from torchdistpackage_tpu_torch.dist import build_cp_group
    from torchdistpackage_tpu_torch.ops.ring_paged import (
        ring_paged_attend,
        ring_paged_write,
    )

    group = build_cp_group(2)
    r = group.rank()
    nbl = RING["NB"] // 2
    window = RING["WINDOW"]
    t = {k[len("ring2/"):]: torch.from_numpy(inp[k]) for k in inp.files
         if k.startswith("ring2/")}
    out = {}
    for phase, prefill in (("prefill", True), ("decode", False)):
        ck = t["k_pool"][r * nbl:(r + 1) * nbl].clone()
        cv = t["v_pool"][r * nbl:(r + 1) * nbl].clone()
        q, kval, vval = t[f"{phase}/q"], t[f"{phase}/k"], t[f"{phase}/v"]
        if prefill:  # this rank's sub-chunk of the chunk's rows
            sub = q.shape[2] // 2
            q, kval, vval = (x[:, :, r * sub:(r + 1) * sub]
                             for x in (q, kval, vval))
        offs, tables = t[f"{phase}/offsets"], t["tables"]
        ck = ring_paged_write(ck, kval, offs, tables=tables, group=group,
                              prefill=prefill)
        cv = ring_paged_write(cv, vval, offs, tables=tables, group=group,
                              prefill=prefill)
        for impl in ("cuda", "gather"):
            out[f"ring2/{phase}/{impl}/out"] = ring_paged_attend(
                q, ck, cv, offs, tables=tables, group=group, window=window,
                impl=impl, prefill=prefill).numpy()
        out[f"ring2/{phase}/k_slice"] = ck.numpy()
        out[f"ring2/{phase}/v_slice"] = cv.numpy()
    return out


def main(rank, world, init_method, in_npz, out_dir):
    from torchdistpackage_tpu_torch.dist import (
        build_cp_group,
        init_distributed,
    )

    torch.set_num_threads(1)
    init_distributed(init_method, world, rank, "cpu")
    import torch.distributed as dist

    try:
        group = build_cp_group(world)
        inp = np.load(in_npz)
        out = engine_runs(group, inp)
        out.update(sizing_runs(group))
        out.update(forward_runs(group, inp))
        out.update(ring2_runs(inp))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, init, src, dst = sys.argv[1:6]
    main(int(r), int(w), init, src, dst)
