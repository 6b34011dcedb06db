"""One rank of the port's ViT / ViT-MoE runs on the CPU, for
tests/test_torch_vit.py — not a pytest file.

The parent writes the inputs (numpy, from a seed) to an ``.npz`` and
starts 4 copies of this script; each joins a gloo group through a
``file://`` rendezvous (a 120 s timeout), runs every layout below in
order and writes ``rank<r>.npz``:

- ``context 4``: ``vit_loss(cp_group=)`` with ring and with Ulysses
  attention (JAX ``tests/test_vit.py:142``), the loss and every leaf's
  grad on every rank; ``data 2 x context 2``: the same at cp 2 (both
  data replicas on the same batch), ring.
- ``data 2 x tensor 2``: ``vit_forward`` / ``vit_loss`` under TP + SP
  (JAX :69), the rank's class columns of the logits and the loss.
- ``data 4``: ``DataParallel`` on ``vit_loss``, 2 AdamW steps (JAX :103).
- ``pipe 2 x tensor 2``: ``vit_pipeline_1f1b`` with TP + SP as
  ``DataParallel``'s ``value_and_grad_fn``, 2 SGD steps (JAX :179,
  ``optax.sgd``); the tensor shards gathered before they are written.
- ``pipe 2 x context 2``: ``vit_pipeline_1f1b(cp_group=)`` with the
  context axis a MODEL axis (``DataParallel(axis='data')``), 2 SGD steps
  (JAX :258).
- ``data 4 -> moe_dp 2 x moe_ep 2``: ViT-MoE with the expert-choice
  router under EP, ``DataParallel(axis=('moe_dp', 'moe_ep'),
  grad_reduce_overrides=moe_grad_reduce_overrides())``, 2 AdamW steps
  (JAX :397).

Imports only the port (and numpy): never JAX.  Run as
``python tests/_torch_vit_worker.py RANK WORLD INIT_METHOD IN_NPZ
OUT_DIR``.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from _torch_gpt_cp_worker import layout, local_grads  # noqa: E402
from _torch_moe_train_worker import (  # noqa: E402
    host,
    subtree,
    tensors,
    trainable,
)

WORLD = 4
#: JAX tests/test_vit.py:35's ViT (16 patches of 8 x 8 x 3)
VIT = dict(image_size=32, patch_size=8, channels=3, num_classes=16, dim=64,
           nheads=4, nlayers=2, ffn_mult=2)
#: the ViT-MoE of JAX tests/test_vit.py:397 (expert choice, under EP)
VIT_MOE_EP = dict(VIT, dim=32, moe_experts=4, moe_every=2,
                  moe_capacity_factor=4.0, moe_router="expert_choice")
B, M, MBS, LR, STEPS = 8, 4, 2, 1e-2, 2
#: JAX's 1F1B ViT tests (:179, :258) train with optax.sgd(5e-2)
SGD_LR = 5e-2


def sgd(lr):
    """``optax.sgd(lr)`` as a train-step optimizer handle: the port's
    steps take ``adamw()``'s ``init(params) -> torch optimizer``."""
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
    from torchdistpackage_tpu_torch.parallel.data_parallel import AdamW

    class SGD(AdamW):
        def init(self, params):
            leaves = list(tree_leaves(params))
            for p in leaves:
                p.requires_grad_(True)
            return torch.optim.SGD(leaves, lr=self.lr)
    return SGD(lr)


def vcfg(base=VIT, **kw):
    from torchdistpackage_tpu_torch.models import ViTConfig

    return ViTConfig(**dict(base, **kw))


def rows(batch, d, n):
    return {k: v[d * n:(d + 1) * n] for k, v in batch.items()}


def cp_runs(inp):
    """The loss and every leaf's grad under ring / Ulysses CP; at cp 2 the
    grads are a ``DataParallel(axis='data')`` step's (both data replicas
    on the same batch), whose per-layer taps must let the context
    group's pre-pool regions through."""
    from torchdistpackage_tpu_torch.models import (
        vit_loss,
        vit_params_from_jax,
    )
    from torchdistpackage_tpu_torch.parallel import DataParallel, adamw

    out = {}
    for tag, config, attn in (("ring_cp4", [("context", 4)], "ring"),
                              ("ulysses_cp4", [("context", 4)], "ulysses"),
                              ("ring_cp2", [("data", 2), ("context", 2)],
                               "ring")):
        tpc = layout(config)
        cfg = vcfg(attn_impl=attn)
        params = trainable(vit_params_from_jax(subtree(inp, "vit/params/"),
                                               cfg, device="cpu"))
        batch = tensors(subtree(inp, "batch/"))

        def loss_fn(p, b):
            return vit_loss(p, b, cfg, remat=True,
                            cp_group=tpc.get_group("context"))

        if tag == "ring_cp2":
            opt = adamw(LR)
            step = DataParallel(axis="data").make_train_step(loss_fn, opt)
            params, _, loss, _ = step(params, opt.init(params), batch)
        else:
            loss = loss_fn(params, batch)
            local_grads(loss, params)
        out[f"{tag}/loss"] = loss.detach().numpy()
        out.update(host(params, f"{tag}/grads/", grads=True))
    return out


def tp_runs(inp):
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.models import (
        vit_forward,
        vit_loss,
        vit_params_from_jax,
    )

    tpc = layout([("data", 2), ("tensor", 2)])
    tp = tpc.get_group("tensor")
    cfg = vcfg()
    params = vit_params_from_jax(subtree(inp, "vit/params/"), cfg,
                                 device="cpu", tp_rank=dist.get_rank(tp),
                                 tp_size=2)
    batch = tensors(subtree(inp, "batch/"))
    with torch.no_grad():
        logits = vit_forward(params, batch["images"], cfg, tp_group=tp,
                             sp=True)
        loss = vit_loss(params, batch, cfg, tp_group=tp, sp=True)
    return {"tp/logits": logits.numpy(), "tp/loss": loss.numpy(),
            "tp/rank": np.asarray(dist.get_rank(tp))}


def dp_runs(inp):
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.models import (
        vit_loss,
        vit_params_from_jax,
    )
    from torchdistpackage_tpu_torch.parallel import DataParallel, adamw

    tpc = layout([("data", WORLD)])
    d = dist.get_rank(tpc.get_group("data"))
    cfg = vcfg()
    params = trainable(vit_params_from_jax(subtree(inp, "vit/params/"), cfg,
                                           device="cpu"))
    dp = DataParallel()
    opt = adamw(LR)
    state = opt.init(params)
    step = dp.make_train_step(lambda p, b: vit_loss(p, b, cfg), opt)
    losses = []
    for i in range(STEPS):
        b = rows(tensors(subtree(inp, f"train{i}/")), d, B // WORLD)
        params, state, loss, _ = step(params, state, b)
        losses.append(float(loss))
    out = {"dp/losses": np.asarray(losses)}
    out.update(host(params, "dp/params/"))
    return out


def pipe_runs(inp):
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.models import (
        gpt_param_specs,
        vit_param_specs,
        vit_params_from_jax,
        vit_pipeline_1f1b,
    )
    from torchdistpackage_tpu_torch.parallel import DataParallel, adamw
    from torchdistpackage_tpu_torch.parallel.pipeline_parallel import (
        stage_index,
    )
    from torchdistpackage_tpu_torch.parallel.tensor_parallel.layers import (
        gather_params,
    )

    out = {}
    for tag, config, kw in (("pp_tp", [("data", 1), ("pipe", 2),
                                       ("tensor", 2)], dict(sp=True)),
                            ("pp_cp", [("data", 1), ("pipe", 2),
                                       ("context", 2)], {})):
        tpc = layout(config)
        s = stage_index()
        tp = tpc.get_group("tensor") if tag == "pp_tp" else None
        cp = tpc.get_group("context") if tag == "pp_cp" else None
        cfg = vcfg(attn_impl="ring" if cp is not None else "naive")
        params = trainable(vit_params_from_jax(
            subtree(inp, "vit/params/"), cfg, device="cpu",
            tp_rank=dist.get_rank(tp) if tp is not None else 0,
            tp_size=2 if tp is not None else 1, pp_rank=s, pp_size=2))
        specs = vit_param_specs(params) if tp is not None else None
        dp = DataParallel(axis="data")
        opt = sgd(SGD_LR)
        state = opt.init(params)
        step = dp.make_train_step(
            value_and_grad_fn=lambda p, b: vit_pipeline_1f1b(
                p, b, cfg, M, tp_group=tp, cp_group=cp, **kw),
            optimizer=opt, param_specs=specs, sp=bool(kw),
            pipe_specs=gpt_param_specs(params, pipe_axis="pipe"))
        losses = []
        for i in range(STEPS):
            params, state, loss, _ = step(
                params, state, tensors(subtree(inp, f"pipe{i}/")))
            losses.append(float(loss))
        if tp is not None:
            params = gather_params(params, specs, tp)
        out[f"{tag}/losses"] = np.asarray(losses)
        out[f"{tag}/stage"] = np.asarray(s)
        out.update(host(params, f"{tag}/params/"))
    return out


def moe_runs(inp):
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.models import (
        vit_moe_loss,
        vit_params_from_jax,
    )
    from torchdistpackage_tpu_torch.parallel import DataParallel, adamw
    from torchdistpackage_tpu_torch.parallel.moe import (
        moe_grad_reduce_overrides,
    )

    tpc = layout([("data", WORLD)])
    tpc.build_moe_mesh(moe_ep_size=2)
    ep = tpc.get_group("moe_ep")
    er = dist.get_rank(ep)
    d = dist.get_rank(tpc.get_group(("moe_dp", "moe_ep")))
    cfg = vcfg(VIT_MOE_EP)
    params = trainable(vit_params_from_jax(
        subtree(inp, "moe/params/"), cfg, device="cpu", ep_rank=er,
        ep_size=2))
    dp = DataParallel(axis=("moe_dp", "moe_ep"),
                      grad_reduce_overrides=moe_grad_reduce_overrides())
    opt = adamw(LR)
    state = opt.init(params)
    step = dp.make_train_step(
        lambda p, b: vit_moe_loss(p, b, cfg, ep_group=ep), opt)
    losses = []
    for i in range(STEPS):
        b = rows(tensors(subtree(inp, f"train{i}/")), d, B // WORLD)
        params, state, loss, _ = step(params, state, b)
        losses.append(float(loss))
    out = {"moe_ep/losses": np.asarray(losses),
           "moe_ep/ep_rank": np.asarray(er)}
    out.update(host(params, "moe_ep/params/"))
    return out


def main(rank, world, init_method, in_npz, out_dir):
    import datetime

    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import tpc

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        inp = np.load(in_npz)
        out = cp_runs(inp)
        for fn in (tp_runs, dp_runs, pipe_runs, moe_runs):
            out.update(fn(inp))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        tpc.reset()
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, init, src, dst = sys.argv[1:6]
    main(int(r), int(w), init, src, dst)
