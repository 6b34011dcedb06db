"""One rank of the port's MoE training runs on the CPU, for
tests/test_torch_moe_train_dist.py — not a pytest file.

The parent writes the inputs (numpy arrays, made with JAX) to an
``.npz`` and starts 4 copies of this script, one a rank; every copy joins
a gloo process group through a ``file://`` rendezvous (a 120 s timeout,
so a rank that schedules apart fails instead of hanging), runs every
case below in order and writes ``rank<r>.npz``:

- ``layer`` (data 4 -> moe_dp 2 x moe_ep 2, the MoE layer of JAX
  ``tests/test_moe.py:39``): ``DataParallel(axis=('moe_dp', 'moe_ep'),
  grad_reduce_overrides=moe_grad_reduce_overrides())`` on ``moe_forward``
  under ``ep_group``, 2 AdamW steps, ``'sorted'`` and ``'cuda'`` (K7's
  plain version under autograd); ``ZeroOptimizer`` over ``moe_dp``
  beside the experts (3 steps); the expert-choice router under EP (its
  output and reduced grads); and two planted faults, their step-1 grads:
  the exchange's backward left out (the cotangent passed through
  unexchanged) and the expert grads reduced over ``moe_ep`` as well.
- ``tpsp`` (data 2 x tensor 2 -> moe_ep 2): the 2-layer GPT-MoE of
  ``tests/test_moe.py:354`` under tensor and sequence parallelism beside
  EP through ``DataParallel.make_train_step(param_specs=, sp=True)``, 2
  steps, and its ``last_stats``.
- ``pipe`` (pipe 2 x data 2 -> moe_ep 2): ``gpt_moe_pipeline_1f1b`` as
  ``DataParallel``'s ``value_and_grad_fn`` (aux on; remat True, and
  'flash' with flash attention and ``'cuda'``), the interleaved schedule
  on the 8-layer model (V 2, converted from JAX's stacked layout), and
  ZeRO x EP x 1F1B (2 steps).
- ``tppp`` (pipe 2 x tensor 2, moe_ep 1): the MoE 1F1B with ``tp_group``
  and sharded transfers (``tests/test_moe.py:1028``).

Imports only the port (and numpy): never JAX.  Run as
``python tests/_torch_moe_train_worker.py RANK WORLD INIT_METHOD IN_NPZ
OUT_DIR``.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from _torch_ep_worker import flatten, unflatten  # noqa: E402

#: JAX tests/test_moe.py:39's layer
LAYER = dict(dim=16, ffn_dim=32, num_experts=4, top_k=2, capacity_factor=4.0)
#: the expert-choice case of tests/test_moe.py:825 (C 4 < T 16 a rank)
EC_CF = 1.0
#: the GPT-MoE of tests/test_moe.py:354 (aux off: the full-batch golden)
GPT2 = dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=16,
            ffn_mult=2, moe_experts=4, moe_top_k=2, moe_every=2,
            moe_capacity_factor=4.0, moe_aux_weight=0.0)
#: the pipelined GPT-MoE of tests/test_moe.py:485 (aux on)
GPT4 = dict(GPT2, nlayers=4, moe_aux_weight=1e-2)
#: the interleaved one of tests/test_moe.py:675 (each slab [dense, expert])
GPT8 = dict(GPT4, nlayers=8)
M, MBS, S = 4, 2, 16
LR, STEPS, ZERO_STEPS = 1e-2, 2, 3
WORLD = 4
#: the data ranks' rows of a layer batch ([8, 8, 16]) and a GPT batch
LAYER_ROWS, GPT_ROWS = 2, 4


def tensors(tree, trainable=False):
    if isinstance(tree, dict):
        return {k: tensors(v, trainable) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tensors(v, trainable) for v in tree]
    t = torch.from_numpy(np.array(tree))
    if not t.is_floating_point():
        return t.long()
    return t.requires_grad_(True) if trainable else t


def trainable(tree):
    if isinstance(tree, dict):
        return {k: trainable(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [trainable(v) for v in tree]
    return tree.detach().clone().requires_grad_(True)


def subtree(inp, prefix):
    return unflatten({k[len(prefix):]: inp[k] for k in inp.files
                      if k.startswith(prefix)})


def host(tree, prefix, grads=False):
    def det(t):
        if isinstance(t, dict):
            return {k: det(v) for k, v in t.items()}
        if isinstance(t, list):
            return [det(v) for v in t]
        return (t.grad if grads else t).detach().float().numpy().copy()
    return {prefix + k: v for k, v in flatten(det(tree)).items()}


def rows(batch, d, n, dim=0):
    return {k: v.narrow(dim, d * n, n) for k, v in batch.items()}


def layout(config, ep):
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import tpc

    tpc.reset()
    tpc.setup_process_groups(config)
    tpc.build_moe_mesh(moe_ep_size=ep)
    return tpc, dist.get_rank(tpc.get_group("moe_ep"))


def layer_runs(inp):
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.parallel import (
        DataParallel,
        ZeroOptimizer,
        adamw,
        reduce_gradients,
    )
    from torchdistpackage_tpu_torch.parallel import moe as tmoe
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import tp_utils

    tpc, er = layout([("data", WORLD)], 2)
    ep = tpc.get_group("moe_ep")
    d = dist.get_rank(tpc.get_group(("moe_dp", "moe_ep")))
    ovr = tmoe.moe_grad_reduce_overrides()

    def local():
        return trainable(tmoe.shard_experts(
            tensors(subtree(inp, "layer/params/")), er, 2))

    def batch(i):
        return rows(tensors(subtree(inp, f"layer/batch{i}/")), d, LAYER_ROWS)

    def loss_of(disp):
        cfg = tmoe.MoEConfig(**LAYER, dispatch=disp)

        def loss_fn(p, b):
            y, _ = tmoe.moe_forward(p, b["x"], cfg, ep_group=ep)
            return ((y - b["y"]) ** 2).mean()
        return loss_fn

    out = {}
    arms = (("dp", "sorted", ovr, STEPS), ("dp_cuda", "cuda", ovr, STEPS),
            ("fault_ep_reduced", "sorted", {"experts": ("moe_dp", "moe_ep")},
             1),
            ("fault_exchange", "sorted", ovr, 1))
    exchange_backward = tp_utils._AllToAll.backward
    for tag, disp, overrides, steps in arms:
        if tag == "fault_exchange":  # the cotangent passed through
            tp_utils._AllToAll.backward = staticmethod(lambda ctx, g: (g, None))
        try:
            params = local()
            opt = adamw(LR)
            state = opt.init(params)
            dp = DataParallel(axis=("moe_dp", "moe_ep"),
                              grad_reduce_overrides=overrides)
            step = dp.make_train_step(loss_of(disp), opt)
            losses = []
            for i in range(steps):
                params, state, loss, _ = step(params, state, batch(i))
                losses.append(float(loss))
                if i == 0:
                    out.update(host(params, f"{tag}/grads1/", grads=True))
        finally:
            tp_utils._AllToAll.backward = exchange_backward
        out[f"{tag}/losses"] = np.asarray(losses)
        out.update(host(params, f"{tag}/params/"))

    params = local()
    zero = ZeroOptimizer(adamw(LR), shard_axis="moe_dp",
                         grad_reduce_axes=("moe_dp", "moe_ep"),
                         grad_reduce_overrides=ovr)
    params = zero.place_params(params)
    state = zero.init(params)
    step = zero.make_train_step(loss_of("cuda"))
    losses = []
    for i in range(ZERO_STEPS):
        params, state, loss, _ = step(params, state, batch(i))
        losses.append(float(loss))
    out["zero/losses"] = np.asarray(losses)
    out.update(host(params, "zero/params/"))
    out["zero/master_w1_shape"] = np.asarray(
        state["master"]["experts"]["w1"].shape)

    for disp in ("dense", "sorted"):
        cfg = tmoe.MoEConfig(**dict(LAYER, capacity_factor=EC_CF),
                             router="expert_choice", dispatch=disp)
        p = local()
        x = batch(0)["x"]
        y, aux = tmoe.moe_forward(p, x, cfg, ep_group=ep)
        leaves = [p["router"]["w"]] + [p["experts"][n] for n in
                                       ("w1", "b1", "w2", "b2")]
        g = torch.autograd.grad((y * y).mean(), leaves)
        grads = reduce_gradients(
            {"router": {"w": g[0]}, "experts": dict(zip(
                ("w1", "b1", "w2", "b2"), g[1:]))},
            axis=("moe_dp", "moe_ep"), grad_reduce_overrides=ovr)
        out[f"ec_{disp}/y"] = y.detach().numpy()
        out[f"ec_{disp}/aux"] = aux.detach().numpy()
        out.update({f"ec_{disp}/grads/{k}": v
                    for k, v in flatten(_np(grads)).items()})
    return out


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy()


def gcfg(base, **kw):
    from torchdistpackage_tpu_torch.models import GPTConfig

    return GPTConfig(**dict(base, **kw))


def tpsp_runs(inp):
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.models import (
        gpt_moe_loss,
        gpt_moe_param_specs,
        params_from_jax,
    )
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
    from torchdistpackage_tpu_torch.parallel import DataParallel, adamw
    from torchdistpackage_tpu_torch.parallel.moe import (
        moe_grad_reduce_overrides,
    )

    tpc, er = layout([("data", 2), ("tensor", 2)], 2)
    tp, ep = tpc.get_group("tensor"), tpc.get_group("moe_ep")
    d = dist.get_rank(tpc.get_group(("moe_dp", "moe_ep")))
    cfg = gcfg(GPT2, moe_dispatch="cuda")
    params = trainable(params_from_jax(
        subtree(inp, "gpt2/params/"), cfg, device="cpu", ep_rank=er,
        ep_size=2, tp_rank=dist.get_rank(tp), tp_size=2))
    dp = DataParallel(axis=("moe_dp", "moe_ep"),
                      grad_reduce_overrides=moe_grad_reduce_overrides())
    opt = adamw(LR)
    state = opt.init(params)
    step = dp.make_train_step(
        lambda p, b: gpt_moe_loss(p, b, cfg, tp_group=tp, sp=True,
                                  ep_group=ep),
        opt, param_specs=gpt_moe_param_specs(params, "moe_ep"), sp=True)
    losses = []
    for i in range(STEPS):
        b = rows(tensors(subtree(inp, f"gpt2/batch{i}/")), d, GPT_ROWS)
        params, state, loss, _ = step(params, state, b)
        losses.append(float(loss))
    out = {"tpsp/losses": np.asarray(losses),
           "tpsp/stats": np.asarray([dp.last_stats["bytes"], sum(
               p.numel() * p.element_size() for p in tree_leaves(params))])}
    out.update(host(params, "tpsp/params/"))
    return out


def pipe_runs(inp):
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.models import (
        gpt_moe_pipeline_1f1b,
        gpt_moe_pipeline_param_specs,
        params_from_jax,
    )
    from torchdistpackage_tpu_torch.parallel import (
        DataParallel,
        ZeroOptimizer,
        adamw,
    )
    from torchdistpackage_tpu_torch.parallel.moe import (
        moe_grad_reduce_overrides,
    )
    from torchdistpackage_tpu_torch.parallel.pipeline_parallel import (
        stage_index,
    )

    tpc, er = layout([("pipe", 2), ("data", 2)], 2)
    ep = tpc.get_group("moe_ep")
    d = dist.get_rank(tpc.get_group(("moe_dp", "moe_ep")))
    s = stage_index()
    ovr = moe_grad_reduce_overrides()
    out = {}

    def stage(tag, base, V=1, **kw):
        cfg = gcfg(base, **kw)
        src = "gpt8/stacked/" if V > 1 else "gpt4/params/"
        return cfg, trainable(params_from_jax(
            subtree(inp, src), cfg, device="cpu", ep_rank=er, ep_size=2,
            pp_rank=s, pp_size=2, num_chunks=V))

    def batch(prefix):
        return rows(tensors(subtree(inp, prefix)), d, MBS, dim=1)

    for tag, base, V, remat, kw in (
            ("1f1b", GPT4, 1, True, {"moe_dispatch": "sorted"}),
            ("1f1b_flash", GPT4, 1, "flash",
             {"moe_dispatch": "cuda", "attn_impl": "flash"}),
            ("interleaved", GPT8, 2, True, {"moe_dispatch": "dense"})):
        cfg, params = stage(tag, base, V, **kw)
        dp = DataParallel(axis=("moe_dp", "moe_ep"),
                          grad_reduce_overrides=ovr)
        step = dp.make_train_step(
            value_and_grad_fn=lambda p, b, cfg=cfg, V=V, remat=remat:
            gpt_moe_pipeline_1f1b(p, b, cfg, M, ep_group=ep, remat=remat,
                                  num_chunks=V),
            optimizer=adamw(LR),
            pipe_specs=gpt_moe_pipeline_param_specs(params))
        params, _, loss, _ = step(params, adamw(LR).init(params),
                                  batch("gpt8/batch/" if V > 1
                                        else "gpt4/batch0/"))
        out[f"{tag}/loss"] = np.asarray(float(loss))
        out.update(host(params, f"{tag}/grads/", grads=True))

    cfg, params = stage("zero", GPT4, moe_dispatch="sorted")
    zero = ZeroOptimizer(adamw(LR), shard_axis="moe_dp",
                         grad_reduce_axes=("moe_dp", "moe_ep"),
                         grad_reduce_overrides=ovr,
                         pipe_specs=gpt_moe_pipeline_param_specs(params))
    params = zero.place_params(params)
    state = zero.init(params)
    step = zero.make_train_step(value_and_grad_fn=lambda p, b:
                                gpt_moe_pipeline_1f1b(p, b, cfg, M,
                                                      ep_group=ep))
    losses = []
    for i in range(STEPS):
        params, state, loss, _ = step(params, state, batch(f"gpt4/batch{i}/"))
        losses.append(float(loss))
        if i == 0:  # the reduced shard grads stay the masters' .grad
            out.update(host(state["master"], "zero_1f1b/grads1/",
                            grads=True))
    out["zero_1f1b/losses"] = np.asarray(losses)
    out.update(host(params, "zero_1f1b/params/"))
    return out


def tppp_runs(inp):
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.models import (
        gpt_moe_pipeline_1f1b,
        params_from_jax,
    )
    from torchdistpackage_tpu_torch.parallel.pipeline_parallel import (
        stage_index,
    )

    tpc, er = layout([("pipe", 2), ("data", 1), ("tensor", 2)], 1)
    tp = tpc.get_group("tensor")
    cfg = gcfg(GPT4, moe_dispatch="sorted")
    params = trainable(params_from_jax(
        subtree(inp, "gpt4/params/"), cfg, device="cpu",
        tp_rank=dist.get_rank(tp), tp_size=2, pp_rank=stage_index(),
        pp_size=2))
    b = rows(tensors(subtree(inp, "gpt4/batch0/")), 0, MBS, dim=1)
    loss, grads = gpt_moe_pipeline_1f1b(params, b, cfg, M, tp_group=tp,
                                        ep_group=tpc.get_group("moe_ep"))
    out = {"tppp/loss": np.asarray(float(loss))}
    out.update({f"tppp/grads/{k}": v for k, v in flatten(
        _tree_np(grads)).items()})
    return out


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_np(v) for v in tree]
    return tree.detach().numpy()


def start(inputs, tmp):
    """The parent's side: write ``inputs``, start the 4 ranks; returns the
    processes (:func:`results` waits for them)."""
    import subprocess

    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
         f"file://{tmp / 'store'}", str(tmp / "in.npz"), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(WORLD)]


def results(procs, tmp, timeout=240):
    """Each rank's outputs, once every process has exited 0."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(len(procs))]


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
        out = layer_runs(inp)
        out.update(tpsp_runs(inp))
        out.update(pipe_runs(inp))
        out.update(tppp_runs(inp))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        tpc.reset()
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, init, src, dst = sys.argv[1:6]
    main(int(r), int(w), init, src, dst)
