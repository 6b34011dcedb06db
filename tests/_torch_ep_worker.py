"""One rank of the port's expert-parallel runs on the CPU, for
tests/test_torch_ep.py — not a pytest file.

The parent writes the inputs (numpy arrays, made with JAX) to an
``.npz``, starts ``world`` copies of this script, one a rank, and reads
each rank's ``rank<r>.npz`` back.  Every copy joins a gloo process group
through a ``file://`` rendezvous, builds the expert-parallel group over
all ranks and runs:

- ``layer/<case>``: ``moe_forward`` on the rank's own tokens
  (``x<r>``) with its share of the experts, per case (dispatch, capacity
  factor, causal), saving ``y``, ``aux`` and the router metrics;
- ``engine/<family>/<arm>``: ``ServingEngine(ep_group=...)`` over the
  rank's share of the family's converted weights (``params_from_jax``
  with ``ep_rank``), serving the staggered requests; saves each request's
  tokens and the ``moe`` summary.

Imports only the port (and numpy): never JAX.  Run as
``python tests/_torch_ep_worker.py RANK WORLD INIT_METHOD IN_NPZ OUT_DIR``.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

# the families and the engine shape of tests/test_torch_moe_engine.py
GPT_MOE = dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=32,
               moe_experts=4, moe_top_k=2, moe_every=2,
               moe_capacity_factor=2.0)
MIXTRAL_STYLE = dict(vocab_size=64, dim=64, nheads=4, nlayers=2,
                     max_seq=32, kv_heads=2, ffn_hidden=96, moe_experts=4,
                     moe_every=1)
ENGINE = dict(num_slots=3, block_size=4, chunk=4, max_ctx=32)
PROMPT_LENS = (5, 9, 13)  # two, three and four prefill chunks
NEW = 6
#: the moe_forward cases: (dispatch, capacity factor, causal); E / k = 4
#: is the no-drop factor
LAYER_CASES = {"sorted_nodrop": ("sorted", 4.0, False),
               "cuda_nodrop": ("cuda", 4.0, False),
               "sorted_drops": ("sorted", 1.0, False),
               "cuda_drops_causal": ("cuda", 1.0, True)}
#: 8 experts: two a rank at world 4, so the exchange's transposes matter
LAYER = dict(dim=32, ffn_dim=48, num_experts=8, top_k=2, act="swiglu")
ENGINE_ARMS = ("sorted", "cuda")


def torch_config(family):
    from torchdistpackage_tpu_torch.models import GPTConfig, llama_config

    if family == "gpt_moe":
        return GPTConfig(**GPT_MOE, dtype=torch.float32)
    return llama_config(**MIXTRAL_STYLE, dtype=torch.float32)


def prompts(vocab):
    rs = np.random.RandomState(0)
    return [rs.randint(0, vocab, n).tolist() for n in PROMPT_LENS]


def run_staggered(eng, make_req, prompt_list):
    """Request 0 prefills and decodes while 1 and 2 arrive."""
    rids = [eng.submit(make_req(prompt_list[0], NEW))]
    eng.step()
    eng.step()
    rids += [eng.submit(make_req(p, NEW)) for p in prompt_list[1:]]
    eng.run_until_idle(max_ticks=500)
    return [np.asarray(eng.finished[r]["tokens"]) for r in rids]


def flatten(tree, prefix=""):
    """A nested dict / list / (q8, scale) tree -> ``{path: array}``, with
    ``/`` between keys and ``#0`` / ``#1`` for a pair's halves."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            out[f"{prefix[:-1]}#{i}"] = np.asarray(v)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten(flat):
    """:func:`flatten`'s inverse (numeric keys become list indices)."""
    root = {}
    for path, arr in flat.items():
        path, _, half = path.partition("#")
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if half:
            pair = node.setdefault(keys[-1], [None, None])
            pair[int(half)] = arr
        else:
            node[keys[-1]] = arr

    def fix(node):
        if isinstance(node, list):
            return tuple(node)
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [fix(node[str(i)]) for i in range(len(node))]
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def layer_runs(rank, world, group, inp):
    from torchdistpackage_tpu_torch.parallel.moe import (
        MoEConfig,
        moe_forward,
        shard_experts,
    )

    full = unflatten({k[len("layer_params/"):]: inp[k] for k in inp.files
                      if k.startswith("layer_params/")})
    params = shard_experts(
        {"router": {"w": torch.from_numpy(full["router"]["w"])},
         "experts": {k: torch.from_numpy(v)
                     for k, v in full["experts"].items()}}, rank, world)
    x = torch.from_numpy(inp[f"x{rank}"])
    out = {}
    for name, (disp, cf, causal) in LAYER_CASES.items():
        cfg = MoEConfig(**LAYER, capacity_factor=cf, dispatch=disp)
        y, aux, met = moe_forward(params, x, cfg, ep_group=group,
                                  causal=causal, return_metrics=True)
        out[f"layer/{name}/y"] = y.numpy()
        out[f"layer/{name}/aux"] = aux.numpy()
        for k, v in met.items():
            out[f"layer/{name}/{k}"] = v.numpy()
    return out


def engine_runs(rank, world, group, inp):
    from torchdistpackage_tpu_torch.models.convert import params_from_jax
    from torchdistpackage_tpu_torch.serving import Request, ServingEngine

    out = {}
    for family in ("gpt_moe", "mixtral_style"):
        cfg = torch_config(family)
        tree = unflatten({k[len(family) + 1:]: inp[k] for k in inp.files
                          if k.startswith(family + "/")})
        params = params_from_jax(tree, cfg, device="cpu", ep_rank=rank,
                                 ep_size=world)
        for arm in ENGINE_ARMS:
            eng = ServingEngine(params, cfg, device="cpu", moe_dispatch=arm,
                                ep_group=group, **ENGINE)
            toks = run_staggered(eng, Request, prompts(cfg.vocab_size))
            for i, t in enumerate(toks):
                out[f"engine/{family}/{arm}/tokens{i}"] = t
            moe = eng.serving_summary()["moe"]
            out[f"engine/{family}/{arm}/moe"] = np.asarray(json.dumps(moe))
    return out


def main(rank, world, init_method, in_npz, out_dir):
    from torchdistpackage_tpu_torch.dist import (
        build_moe_groups,
        init_distributed,
    )

    torch.set_num_threads(1)
    init_distributed(init_method, world, rank, "cpu")
    import torch.distributed as dist

    try:
        group = build_moe_groups(world)
        inp = np.load(in_npz)
        out = layer_runs(rank, world, group, inp)
        out.update(engine_runs(rank, world, group, inp))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, init, src, dst = sys.argv[1:6]
    main(int(r), int(w), init, src, dst)
