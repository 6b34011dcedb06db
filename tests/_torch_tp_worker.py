"""One rank of the port's tensor- and sequence-parallel runs on the CPU,
for tests/test_torch_tp.py and tests/test_torch_tp_serving.py — not a
pytest file.

The parent writes the inputs (numpy arrays, made with JAX) to an
``.npz`` and starts ``world`` copies of this script, one a rank, each
naming the same ``job``; every copy joins a gloo process group through a
``file://`` rendezvous, runs the job's cases and writes ``rank<r>.npz``.

- ``train`` (world 2, ``tpc`` ``[('data', 1), ('tensor', 2)]``): the
  five regions
  and both rings on per-rank inputs (outputs and input / weight grads),
  the fused counterparts of the rings; ``gpt_loss`` of the tiny GPT and
  of the tiny Llama at ``sp`` False / True (and the rings,
  ``collective_matmul`` with ``cm_min_bytes=0``), its grads after
  ``make_train_step``'s backward and SP sum (``adamw(0.0)``: nothing
  moves), gathered to full leaves; the same with ``copy_to_tp``'s
  backward all-reduce taken out, and with the SP sum taken out (planted
  faults); the shard / gather round trip and ``params_from_jax``'s TP
  shard; SP dropout; ``transformer_forward`` on the block list.
- ``tpdp`` (world 4, ``[('data', 2), ('tensor', 2)]``):
  ``DataParallel.make_train_step`` with the tensor group's specs at
  ``sp=True``, three AdamW steps, losses and the gathered parameters.
- ``serve`` (world 2): ``paged_forward`` logits (gathered), the engine's
  greedy tokens and pool bytes for the gqa and sliding families;
  ``generate(tp_group=)`` for the dense Llama, the MoE family and the
  int8 KV cache.

Imports only the port (and numpy): never JAX.  Run as
``python tests/_torch_tp_worker.py JOB RANK WORLD INIT_METHOD IN_NPZ
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

#: the training configs: (kind, kwargs) — 'gpt' is GPTConfig (LayerNorm,
#: GELU, learned positions), 'llama' llama_config (RMSNorm, SwiGLU,
#: RoPE, GQA); both f32, plain attention
TRAIN_CFGS = {
    "gpt": ("gpt", dict(vocab_size=64, dim=32, nheads=4, nlayers=2,
                        max_seq=16, ffn_mult=2)),
    "llama": ("llama", dict(vocab_size=64, dim=32, nheads=4, nlayers=2,
                            max_seq=16, kv_heads=2, ffn_hidden=48)),
}
#: (config, sp, collective_matmul, xent_chunk) of the gpt_loss cases
LOSS_CASES = {"gpt/tp": ("gpt", False, False, None),
              "gpt/sp": ("gpt", True, False, None),
              "gpt/cm": ("gpt", True, True, None),
              "gpt/tp_xent": ("gpt", False, False, 8),
              "gpt/sp_xent": ("gpt", True, False, 8),
              "llama/tp": ("llama", False, False, None),
              "llama/cm": ("llama", True, True, None)}
#: the serving families of tests/test_serving.py (dense GQA, sliding)
SERVE_CFGS = {
    "gqa": ("llama", dict(vocab_size=64, dim=32, nheads=4, nlayers=2,
                          max_seq=32, kv_heads=2, ffn_hidden=48)),
    "sliding": ("llama", dict(vocab_size=64, dim=32, nheads=4, nlayers=2,
                              max_seq=32, kv_heads=2, ffn_hidden=48,
                              sliding_window=6)),
}
#: the generate families of tests/test_generate.py
GEN_CFGS = {
    "llama": ("llama", dict(vocab_size=64, dim=32, nheads=4, nlayers=3,
                            max_seq=24, kv_heads=2, ffn_hidden=48)),
    "mixtral": ("llama", dict(vocab_size=64, dim=32, nheads=4, nlayers=4,
                              max_seq=24, kv_heads=2, ffn_hidden=48,
                              moe_experts=4, moe_top_k=2, moe_every=2,
                              moe_capacity_factor=2.0)),
}
#: (family, kv_quant) of the generate cases
GEN_CASES = {"llama": ("llama", False), "mixtral": ("mixtral", False),
             "llama_int8": ("llama", True)}
GEN_NEW = 8
SERVE_NEW = 6
DP_STEPS, DP_LR = 3, 1e-3
DROPOUT_RATE = 0.5
#: per-rank region inputs: [B, S, D] with S divisible by 2 and 4
RB, RS, RD, RF = 2, 8, 6, 10
#: the block list of ``transformer_forward`` (JAX
#: tests/test_tensor_parallel.py's config)
TRANSFORMER = dict(dim=32, nheads=4, nlayers=2, ffn_mult=2, causal=True)


def config(name, table):
    from torchdistpackage_tpu_torch.models import GPTConfig, llama_config

    kind, kw = table[name]
    if kind == "gpt":
        return GPTConfig(**kw, dtype=torch.float32)
    return llama_config(**kw, dtype=torch.float32)


def tflat(tree, prefix):
    """A tree of tensors (dicts / lists) -> ``{prefix + path: array}``."""
    def det(t):
        if isinstance(t, dict):
            return {k: det(v) for k, v in t.items()}
        if isinstance(t, list):
            return [det(v) for v in t]
        return t.detach().numpy()
    return {prefix + k: v for k, v in flatten(det(tree)).items()}


def subtree(inp, prefix):
    return unflatten({k[len(prefix):]: inp[k] for k in inp.files
                      if k.startswith(prefix)})


def grads_of(tree):
    if isinstance(tree, dict):
        return {k: grads_of(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [grads_of(v) for v in tree]
    return tree.grad


# ------------------------------------------------------------------ train


def region_runs(inp, rank):
    """Each region on this rank's input, the loss ``sum(y * w_r)``."""
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        copy_to_tp,
        gather_from_sp,
        reduce_from_tp,
        ring_ag_matmul,
        ring_matmul_rs,
        scatter_to_sp,
        split_to_sp,
    )

    out = {}
    fns = {"reduce_from_tp": reduce_from_tp, "copy_to_tp": copy_to_tp,
           "gather_from_sp": gather_from_sp, "scatter_to_sp": scatter_to_sp,
           "split_to_sp": split_to_sp}
    for name, fn in fns.items():
        x = torch.from_numpy(inp[f"regions/{name}/x"][rank]).requires_grad_()
        y = fn(x)
        (y * torch.from_numpy(inp[f"regions/{name}/w"][rank])).sum().backward()
        out[f"regions/{name}/y"] = y.detach().numpy()
        out[f"regions/{name}/gx"] = x.grad.numpy()
    for name in ("ring_ag_matmul", "ring_matmul_rs"):
        for mode in ("ring", "fused"):
            x = torch.from_numpy(
                inp[f"regions/{name}/x"][rank]).requires_grad_()
            m = torch.from_numpy(
                inp[f"regions/{name}/m"][rank]).requires_grad_()

            def mm(c, m=m):
                return torch.tanh(c @ m)

            if name == "ring_ag_matmul":
                y = (ring_ag_matmul(x, mm) if mode == "ring"
                     else mm(gather_from_sp(x)))
            else:
                y = (ring_matmul_rs(x, lambda c: c @ m) if mode == "ring"
                     else scatter_to_sp(x @ m))
            (y * torch.from_numpy(inp[f"regions/{name}/w"][rank])
             ).sum().backward()
            key = f"regions/{name}/{mode}"
            out[f"{key}/y"] = y.detach().numpy()
            out[f"{key}/gx"] = x.grad.numpy()
            out[f"{key}/gm"] = m.grad.numpy()
    return out


def tp_grads(inp, cfg_name, sp, cm, xent, rank, size, fault=None):
    """``(loss, full grads)`` of one ``make_train_step`` backward (lr 0)
    of this rank's shard over ``tpc``'s tensor group."""
    import dataclasses

    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.models import gpt_loss, params_from_jax
    from torchdistpackage_tpu_torch.models.gpt import gpt_param_specs
    from torchdistpackage_tpu_torch.parallel import data_parallel
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        gather_params,
        tp_utils,
    )

    cfg = config(cfg_name, TRAIN_CFGS)
    if cm:
        cfg = dataclasses.replace(cfg, collective_matmul=True,
                                  cm_min_bytes=0)
    group = tpc.get_group("tensor")
    params = params_from_jax(subtree(inp, f"train/{cfg_name}/params/"), cfg,
                             device="cpu", tp_rank=rank, tp_size=size)
    specs = gpt_param_specs(params)
    batch = {k: torch.from_numpy(inp[f"train/batch/{k}"]).long()
             for k in ("tokens", "targets")}
    opt = data_parallel.adamw(0.0)
    state = opt.init(params)
    step = data_parallel.make_train_step(
        lambda p, b: gpt_loss(p, b, cfg, xent_chunk=xent, tp_group=group,
                              sp=sp), opt,
        param_specs=specs, sp=sp, tp_group=group)
    saved = (tp_utils._CopyToTP.backward, data_parallel.PARTIAL_UNDER_SP)
    try:
        if fault == "copy_to_tp":
            tp_utils._CopyToTP.backward = staticmethod(
                lambda ctx, g: (g, None))
        elif fault == "sp_sum":
            data_parallel.PARTIAL_UNDER_SP = "no leaf"
        _, _, loss, _ = step(params, state, batch)
    finally:
        tp_utils._CopyToTP.backward = staticmethod(saved[0])
        data_parallel.PARTIAL_UNDER_SP = saved[1]
    return float(loss), gather_params(grads_of(params), specs, group)


def shard_runs(inp, rank, size):
    """``shard_gpt_params`` / ``gather_params`` round trip and
    ``params_from_jax``'s TP shard against the cut of the whole tree."""
    from torchdistpackage_tpu_torch.models import params_from_jax
    from torchdistpackage_tpu_torch.models.gpt import (
        gpt_param_specs,
        shard_gpt_params,
    )
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        gather_params,
    )

    out = {}
    for name in TRAIN_CFGS:
        cfg = config(name, TRAIN_CFGS)
        tree = subtree(inp, f"train/{name}/params/")
        full = params_from_jax(tree, cfg, device="cpu")
        shard = shard_gpt_params(full, cfg, rank, size)
        conv = params_from_jax(tree, cfg, device="cpu", tp_rank=rank,
                               tp_size=size)
        same = all(torch.equal(a, b) for a, b in zip(
            flatten_t(shard), flatten_t(conv)))
        back = gather_params(shard, gpt_param_specs(shard))
        out[f"shard/{name}/convert_equal"] = np.asarray(same)
        out.update(tflat(back, f"shard/{name}/back/"))
        out.update(tflat(shard, f"shard/{name}/mine/"))
    return out


def flatten_t(tree):
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves

    return list(tree_leaves(tree))


def dropout_run(inp, rank):
    """The tiny GPT's hidden under SP with residual dropout 0.5 keyed by
    ``axis_unique_key(7, 'data')`` (tensor ranks agree), gathered, the
    same at rate 0, and layer 0's first mask on this rank's rows."""
    import dataclasses

    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.models import gpt_hidden, params_from_jax
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        gather_from_sp,
    )
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import dropout
    from torchdistpackage_tpu_torch.utils import axis_unique_key
    from torchdistpackage_tpu_torch.utils.random import fold_in, split

    group = tpc.get_group("tensor")
    out = {}
    for rate in (0.0, DROPOUT_RATE):
        cfg = dataclasses.replace(config("gpt", TRAIN_CFGS),
                                  dropout_rate=rate)
        params = params_from_jax(subtree(inp, "train/gpt/params/"), cfg,
                                 device="cpu", tp_rank=rank, tp_size=2)
        tokens = torch.from_numpy(inp["train/batch/tokens"]).long()
        with torch.no_grad():
            h = gpt_hidden(params, tokens, cfg, tp_group=group, sp=True,
                           dropout_key=axis_unique_key(7, "data"))
            out[f"dropout/{rate}"] = gather_from_sp(h, group).numpy()
    # the first site's mask on this rank's rows, under the key layer 0's
    # attention branch draws with
    k_attn = split(fold_in(axis_unique_key(7, "data"), 0))[0]
    local = (tokens.shape[0], tokens.shape[1] // 2, cfg.dim)
    out["dropout/mask"] = (dropout(torch.ones(local), DROPOUT_RATE, k_attn)
                           == 0).numpy()
    return out


def transformer_run(inp, rank, size):
    """``transformer_forward`` of this rank's shard of the block list on
    the full input, ``sp`` False and True (gathered at the end)."""
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        TransformerConfig,
        param_specs,
        shard_params,
        transformer_forward,
    )

    def tensors(t):
        if isinstance(t, dict):
            return {k: tensors(v) for k, v in t.items()}
        if isinstance(t, list):
            return [tensors(v) for v in t]
        return torch.from_numpy(np.array(t))

    tree = tensors(subtree(inp, "tf/params/"))
    shard = shard_params(tree, param_specs(tree), rank, size)
    x = torch.from_numpy(inp["tf/x"])
    cfg = TransformerConfig(**TRANSFORMER)
    with torch.no_grad():
        return {f"tf/{sp}": transformer_forward(
            shard, x, cfg, tp_group=tpc.get_group("tensor"), sp=sp).numpy()
            for sp in (False, True)}


def train_job(inp, rank, world):
    from torchdistpackage_tpu_torch.dist import tpc

    tpc.setup_process_groups([("data", 1), ("tensor", world)])
    out = region_runs(inp, rank)
    for case, (name, sp, cm, xent) in LOSS_CASES.items():
        loss, grads = tp_grads(inp, name, sp, cm, xent, rank, world)
        out[f"loss/{case}"] = np.asarray(loss)
        out.update(tflat(grads, f"grads/{case}/"))
    for fault, case in (("copy_to_tp", "gpt/tp"), ("sp_sum", "gpt/sp")):
        name, sp, cm, xent = LOSS_CASES[case]
        _, grads = tp_grads(inp, name, sp, cm, xent, rank, world,
                            fault=fault)
        out.update(tflat(grads, f"fault/{fault}/"))
    out.update(shard_runs(inp, rank, world))
    out.update(dropout_run(inp, rank))
    out.update(transformer_run(inp, rank, world))
    return out


def tpdp_job(inp, rank, world):
    """TP 2 x DP 2: three AdamW steps of the tiny GPT at ``sp=True``."""
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.models import gpt_loss, params_from_jax
    from torchdistpackage_tpu_torch.models.gpt import gpt_param_specs
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        DataParallel,
        adamw,
    )
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        gather_params,
    )

    tpc.setup_process_groups([("data", 2), ("tensor", 2)])
    tp_rank = tpc.get_group_rank("tensor")
    group = tpc.get_group("tensor")
    cfg = config("gpt", TRAIN_CFGS)
    params = params_from_jax(subtree(inp, "train/gpt/params/"), cfg,
                             device="cpu", tp_rank=tp_rank, tp_size=2)
    specs = gpt_param_specs(params)
    dp = DataParallel(bucket_cap_mb=0.01)
    params = dp.broadcast_params(params)
    opt = adamw(DP_LR)
    state = opt.init(params)
    step = dp.make_train_step(
        lambda p, b: gpt_loss(p, b, cfg, tp_group=group, sp=True), opt,
        param_specs=specs, sp=True)
    losses, norms = [], []
    for i in range(DP_STEPS):
        batch = {k: inp[f"tpdp/batch{i}/{k}"] for k in ("tokens", "targets")}
        params, state, loss, gnorm = step(params, state,
                                          dp.shard_batch(batch, device="cpu"))
        losses.append(float(loss))
        norms.append(float(gnorm))
    out = {"tpdp/losses": np.asarray(losses), "tpdp/norms": np.asarray(norms)}
    with torch.no_grad():
        out.update(tflat(gather_params(params, specs, group), "tpdp/params/"))
    return out


# ------------------------------------------------------------------ serve


def serve_job(inp, rank, world):
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.models import generate, params_from_jax
    from torchdistpackage_tpu_torch.models.generate import _full_logits
    from torchdistpackage_tpu_torch.serving import Request, ServingEngine
    from torchdistpackage_tpu_torch.serving.paged_cache import (
        init_paged_kv,
        paged_forward,
        pool_bytes,
    )

    tpc.setup_process_groups([("tensor", world)])
    group = tpc.get_group("tensor")
    out = {}
    for fam in SERVE_CFGS:
        cfg = config(fam, SERVE_CFGS)
        params = params_from_jax(subtree(inp, f"serve/{fam}/params/"), cfg,
                                 device="cpu", tp_rank=rank, tp_size=world)
        prompts = inp[f"serve/{fam}/prompts"]
        # one 4-row prefill chunk of the first two prompts through the pool
        cache = init_paged_kv(cfg, 9, 4, device="cpu", axis_size=world)
        tables = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
        with torch.no_grad():
            _, logits = paged_forward(
                params, torch.from_numpy(prompts[:2, :4]).long(), cfg, cache,
                tables, torch.zeros(2, dtype=torch.int32), tp_group=group,
                all_logits=True)
            out[f"paged/{fam}/logits"] = _full_logits(
                logits, cfg, group).numpy()
        out[f"paged/{fam}/pool_bytes"] = np.asarray(pool_bytes(cache))
        eng = ServingEngine(params, cfg, num_slots=4, block_size=4, chunk=4,
                            device="cpu", tp_group=group)
        rids = [eng.submit(Request(p.tolist(), SERVE_NEW)) for p in prompts]
        eng.run_until_idle()
        out[f"engine/{fam}/tokens"] = np.stack(
            [eng.finished[r]["tokens"] for r in rids])
        pool = eng.serving_summary()["kv_pool"]
        out[f"engine/{fam}/pool"] = np.asarray(
            [pool["pool_bytes"], pool["pool_bytes_expected"]])
    for case, (fam, quant) in GEN_CASES.items():
        cfg = config(fam, GEN_CFGS)
        params = params_from_jax(subtree(inp, f"gen/{fam}/params/"), cfg,
                                 device="cpu", tp_rank=rank, tp_size=world)
        prompt = torch.from_numpy(inp["gen/prompt"]).long()
        out[f"gen/{case}/tokens"] = generate(
            params, prompt, cfg, GEN_NEW, tp_group=group, kv_quant=quant,
            device="cpu").numpy()
    return out


JOBS = {"train": train_job, "tpdp": tpdp_job, "serve": serve_job}


def main(job, rank, world, init_method, in_npz, out_dir):
    from torchdistpackage_tpu_torch.dist import init_distributed, tpc

    torch.set_num_threads(1)
    init_distributed(init_method, world, rank, "cpu")
    import torch.distributed as dist

    try:
        out = JOBS[job](np.load(in_npz), rank, world)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        tpc.reset()
        dist.destroy_process_group()


if __name__ == "__main__":
    j, r, w, init, src, dst = sys.argv[1:7]
    main(j, int(r), int(w), init, src, dst)
