"""One rank of the port's expert-parallel ``generate()`` runs on the CPU,
for tests/test_torch_generate.py — not a pytest file.

The parent writes the MoE weights (numpy arrays, made with JAX) to an
``.npz`` and starts ``WORLD`` copies of this script, one a rank.  Every
copy joins a gloo process group through a ``file://`` rendezvous, takes
its share of the experts (``params_from_jax`` with ``ep_rank``) and runs,
on its OWN prompt (:func:`rank_prompt`): ``forward_cached_moe(ep_group=)``
over the prompt (saving the logits) and greedy ``generate(ep_group=)``
(saving the tokens), into ``rank<r>.npz``.

Imports only the port (and numpy): never JAX.  Run as
``python tests/_torch_generate_worker.py RANK WORLD INIT_METHOD IN_NPZ
OUT_DIR``.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from _torch_ep_worker import flatten, unflatten  # noqa: E402,F401

WORLD = 4
#: a Mixtral-style MoE with 8 experts: two a rank at world 4, so the
#: exchange's transposes matter
EP_MOE = dict(vocab_size=64, dim=64, nheads=4, nlayers=2, max_seq=64,
              kv_heads=2, ffn_hidden=96, moe_experts=8, moe_every=1)
P, NEW = 13, 6


def rank_prompt(rank):
    return np.random.RandomState(50 + rank).randint(0, 64, (1, P))


def main(rank, world, init_method, in_npz, out_dir):
    from torchdistpackage_tpu_torch.dist import (
        build_moe_groups,
        init_distributed,
    )
    from torchdistpackage_tpu_torch.models import (
        forward_cached_moe,
        generate,
        init_kv_cache,
        llama_config,
    )
    from torchdistpackage_tpu_torch.models.convert import params_from_jax

    torch.set_num_threads(1)
    init_distributed(init_method, world, rank, "cpu")
    import torch.distributed as dist

    try:
        group = build_moe_groups(world)
        cfg = llama_config(**EP_MOE, dtype=torch.float32)
        tree = unflatten(dict(np.load(in_npz)))
        params = params_from_jax(tree, cfg, device="cpu", ep_rank=rank,
                                 ep_size=world)
        prompt = torch.from_numpy(rank_prompt(rank))
        cache = init_kv_cache(cfg, 1, P + NEW, device="cpu")
        _, logits = forward_cached_moe(params, prompt, cfg, cache, 0,
                                       ep_group=group)
        tokens = generate(params, prompt, cfg, NEW, ep_group=group,
                          device="cpu")
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 prefill=logits.numpy(), tokens=tokens.numpy())
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, init, src, dst = sys.argv[1:6]
    main(int(r), int(w), init, src, dst)
