"""One rank of the port's composed serving layouts on the CPU, for
tests/test_torch_serving_compose.py — not a pytest file.

The parent writes the inputs (numpy arrays, made with JAX) to an
``.npz`` and starts 4 copies of this script, one a rank; every copy
joins a gloo process group through a ``file://`` rendezvous, lays the
ranks out once per composition with ``tpc`` (every rank builds every
group together), runs the cases and writes ``rank<r>.npz``:

- ``dptp/<fam>``: data 2 x tensor 2, ``ServingEngine(dp_group=,
  tp_group=)`` on four requests (the gqa and sliding families): tokens,
  the ``kv_pool`` summary and the audit; ``dptp/<fam>/features``: every
  prompt twice with the prefix cache and ``spec_k`` on, drained after
  four ticks and resumed;
- ``tpep/*``: tensor 2 x moe_ep 2 (``build_moe_mesh`` on data 2 x
  tensor 2): the last-row logits of ``forward_cached_moe(tp_group=,
  ep_group=)`` gathered, ``generate`` and the engine (``replica_group``);
- ``tpcp/gqa``: context 2 x tensor 2, the CP engine with ``tp_group``;
- ``dpep/mixtral``: moe_dp 2 x moe_ep 2, ``dp_group`` beside ``ep_group``;
- planted faults: ``fault/other_rows`` (a rank runs the other data
  group's rows), ``fault/one_axis`` (a TP x EP engine whose ranks of
  moe_ep rank 1 see a perturbed argmax, its tokens broadcast over the
  tensor group only; beside it ``fault/replica``, the same perturbation
  under the replica group), ``fault/experts_split`` (the experts also
  cut over the tensor group);
- ``clock/refused``: every grouped engine refuses ``deadline_s``.

Imports only the port (and numpy): never JAX.  Run as
``python tests/_torch_compose_worker.py RANK WORLD INIT_METHOD IN_NPZ
OUT_DIR``.
"""

import datetime
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from _torch_ep_worker import unflatten  # noqa: E402

WORLD = 4
#: the serving families of tests/test_serving.py (dense GQA, sliding)
#: and the MoE family of tests/test_generate.py (4 experts: 2 a rank at
#: EP 2, so the exchange's transposes matter)
CFGS = {
    "gqa": dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=32,
                kv_heads=2, ffn_hidden=48),
    "sliding": dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=32,
                    kv_heads=2, ffn_hidden=48, sliding_window=6),
    "mixtral": dict(vocab_size=64, dim=32, nheads=4, nlayers=4, max_seq=32,
                    kv_heads=2, ffn_hidden=48, moe_experts=4, moe_top_k=2,
                    moe_every=2, moe_capacity_factor=2.0),
    # tests/test_cp_prefill.py's gqa family (max_seq 64)
    "cp_gqa": dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=64,
                   kv_heads=2, ffn_hidden=48),
}
DP_FAMS = ("gqa", "sliding")
#: the engine of tests/test_serving.py's tp_dp case
ENGINE = dict(num_slots=4, block_size=4, chunk=4)
#: the CP engine of tests/test_cp_prefill.py
CP_ENGINE = dict(num_slots=2, block_size=4, chunk=4, num_blocks=16)
NEW, GEN_NEW, CP_NEW = 6, 8, 6
#: the token the planted one-axis fault pushes up on moe_ep rank 1
PERTURBED = 7


def config(name):
    from torchdistpackage_tpu_torch.models import llama_config

    return llama_config(**CFGS[name], dtype=torch.float32)


def subtree(inp, prefix):
    return unflatten({k[len(prefix):]: inp[k] for k in inp.files
                      if k.startswith(prefix)})


def serve(eng, prompts, new=NEW):
    from torchdistpackage_tpu_torch.serving import Request

    rids = [eng.submit(Request(p.tolist(), new)) for p in prompts]
    eng.run_until_idle(max_ticks=500)
    return np.stack([eng.finished[r]["tokens"] for r in rids])


def layout(config_, moe_ep=None):
    from torchdistpackage_tpu_torch.dist import tpc

    tpc.reset()
    tpc.setup_process_groups(config_)
    if moe_ep:
        tpc.build_moe_mesh(moe_ep_size=moe_ep)
    return tpc


def grouped_refuses_deadline(eng) -> bool:
    from torchdistpackage_tpu_torch.serving import Request

    try:
        eng.submit(Request([1, 2, 3], 2, deadline_s=1.0))
    except NotImplementedError as e:
        return "host clock" in str(e)
    return False


def dptp_cases(inp, out):
    """data 2 x tensor 2: the engine per family, then the features."""
    from torchdistpackage_tpu_torch.models import params_from_jax
    from torchdistpackage_tpu_torch.serving import Request, ServingEngine

    tpc = layout([("data", 2), ("tensor", 2)])
    dp, tp = tpc.get_group("data"), tpc.get_group("tensor")
    tr = tpc.get_tp_rank()
    clock = []
    for fam in DP_FAMS:
        cfg = config(fam)
        params = params_from_jax(subtree(inp, f"{fam}/params/"), cfg,
                                 device="cpu", tp_rank=tr, tp_size=2)
        prompts = inp[f"{fam}/prompts"]
        eng = ServingEngine(params, cfg, device="cpu", dp_group=dp,
                            tp_group=tp, **ENGINE)
        out[f"dptp/{fam}/tokens"] = serve(eng, prompts)
        s = eng.serving_summary()
        pool = s["kv_pool"]
        out[f"dptp/{fam}/pool"] = np.asarray([
            pool["dp_groups"], pool["num_blocks"], pool["pool_bytes"],
            pool["pool_bytes_expected"], pool["pool_bytes_all_groups"],
            eng.slots_per_group, s["decode_signatures"]])
        out[f"dptp/{fam}/audit"] = np.asarray(
            [eng.audit(heal=False)["ok"]]
            + [a.in_use for a in eng._allocs])
        clock.append(grouped_refuses_deadline(eng))
        # the prefix cache and spec_k, drained mid-run and resumed
        feng = ServingEngine(params, cfg, device="cpu", dp_group=dp,
                             tp_group=tp, prefix_cache=True, spec_k=2,
                             **ENGINE)
        shared = np.concatenate([prompts, prompts])  # every prompt twice
        rids = [feng.submit(Request(p.tolist(), NEW)) for p in shared]
        for _ in range(4):
            feng.step()
        payload = feng.drain()
        groups = sorted({d["group"] for d in payload["requests"]
                         if "group" in d})
        feng.resume(payload)
        feng.run_until_idle(max_ticks=500)
        out[f"dptp/{fam}/features"] = np.stack(
            [f["tokens"] for f in feng.finished.values()
             if f["reason"] == "max_tokens"])
        fs = feng.serving_summary()
        out[f"dptp/{fam}/features_stats"] = np.asarray([
            fs["prefix_cache"]["hits"], fs["spec"]["drafted"], len(rids),
            len(groups)])
    return clock


def tpep_cases(inp, out):
    """tensor 2 x moe_ep 2 on the MoE view of data 2 x tensor 2."""
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.models import generate, params_from_jax
    from torchdistpackage_tpu_torch.models.generate import (
        _full_logits,
        forward_cached_moe,
        init_kv_cache,
    )
    from torchdistpackage_tpu_torch.serving import ServingEngine, sim

    tpc = layout([("data", 2), ("tensor", 2)], moe_ep=2)
    tp, ep = tpc.get_group("tensor"), tpc.get_group("moe_ep")
    replica = tpc.replica_group("moe")
    tr, er = tpc.get_tp_rank(), tpc.get_group_rank("moe_ep")
    cfg = config("mixtral")
    tree = subtree(inp, "mixtral/params/")
    params = params_from_jax(tree, cfg, device="cpu", ep_rank=er, ep_size=2,
                             tp_rank=tr, tp_size=2)
    prompt = torch.from_numpy(inp["mixtral/prompt"]).long()
    with torch.no_grad():
        cache = init_kv_cache(cfg, prompt.shape[0], prompt.shape[1],
                              device="cpu", axis_size=2)
        _, lg = forward_cached_moe(params, prompt, cfg, cache, 0,
                                   tp_group=tp, ep_group=ep)
        out["tpep/logits"] = _full_logits(lg, cfg, tp).numpy()
    out["tpep/generate"] = generate(params, prompt, cfg, GEN_NEW,
                                    tp_group=tp, ep_group=ep,
                                    device="cpu").numpy()
    prompts = inp["mixtral/prompts"]
    eng = ServingEngine(params, cfg, device="cpu", tp_group=tp, ep_group=ep,
                        replica_group=replica, **ENGINE)
    out["tpep/engine"] = serve(eng, prompts)
    clock = [grouped_refuses_deadline(eng)]
    try:  # composed groups without the replica's group
        ServingEngine(params, cfg, device="cpu", tp_group=tp, ep_group=ep,
                      **ENGINE)
        out["tpep/needs_replica"] = np.asarray(False)
    except ValueError as e:
        out["tpep/needs_replica"] = np.asarray("replica_group" in str(e))

    # planted: the ranks of moe_ep rank 1 see token PERTURBED on top
    real = sim._full_logits

    def perturbed(logits, cfg_, group=None):
        full = real(logits, cfg_, group)
        if er == 1:
            full = full.clone()
            full[..., PERTURBED] += 1e3
        return full

    sim._full_logits = perturbed
    try:
        for name, rg in (("replica", replica), ("one_axis", tp)):
            eng = ServingEngine(params, cfg, device="cpu", tp_group=tp,
                                ep_group=ep, replica_group=rg, **ENGINE)
            out[f"fault/{name}"] = serve(eng, prompts)
    finally:
        sim._full_logits = real
    # planted: the experts also cut over the tensor group (their F
    # columns), each tensor rank's FFN a partial sum nobody adds up
    split = params_from_jax(tree, cfg, device="cpu", ep_rank=er, ep_size=2,
                            tp_rank=tr, tp_size=2)
    for bp in split["blocks"]:
        if "moe" not in bp:
            continue
        ex = bp["moe"]["experts"]
        F = ex["w2"].shape[-2] // 2
        ex["w1"] = ex["w1"][..., tr * F:(tr + 1) * F]
        ex["b1"] = ex["b1"][..., tr * F:(tr + 1) * F]
        ex["w2"] = ex["w2"][..., tr * F:(tr + 1) * F, :]
    try:
        out["fault/experts_split"] = generate(
            split, prompt, cfg, GEN_NEW, tp_group=tp, ep_group=ep,
            device="cpu").numpy()
    except Exception:  # noqa: BLE001 — a refusal fails the fault too
        out["fault/experts_split"] = np.full((1, 1), -1)
    dist.barrier()
    return clock


def tpcp_cases(inp, out):
    """context 2 x tensor 2: the CP engine with the tensor group."""
    from torchdistpackage_tpu_torch.models import params_from_jax
    from torchdistpackage_tpu_torch.ops.ring_paged import RING_PAYLOADS
    from torchdistpackage_tpu_torch.serving import ServingEngine

    tpc = layout([("context", 2), ("tensor", 2)])
    cp, tp = tpc.get_group("context"), tpc.get_group("tensor")
    cfg = config("cp_gqa")
    params = params_from_jax(subtree(inp, "cp_gqa/params/"), cfg,
                             device="cpu", tp_rank=tpc.get_tp_rank(),
                             tp_size=2)
    eng = ServingEngine(params, cfg, device="cpu", cp_group=cp, tp_group=tp,
                        replica_group=tpc.replica_group(), **CP_ENGINE)
    RING_PAYLOADS["sent"] = 0
    out["tpcp/tokens"] = serve(eng, inp["cp_gqa/prompts"], CP_NEW)
    lc = eng.serving_summary()["long_context"]
    out["tpcp/ring"] = np.asarray([lc["ring_hops"], RING_PAYLOADS["sent"],
                                   lc["ring_bytes"], lc["prefill_chunks"]])
    return [grouped_refuses_deadline(eng)]


def dpep_cases(inp, out):
    """moe_dp 2 x moe_ep 2: data groups beside expert groups."""
    from torchdistpackage_tpu_torch.models import params_from_jax
    from torchdistpackage_tpu_torch.serving import ServingEngine

    tpc = layout([("data", 4)], moe_ep=2)
    dp, ep = tpc.get_group("moe_dp"), tpc.get_group("moe_ep")
    cfg = config("mixtral")
    params = params_from_jax(subtree(inp, "mixtral/params/"), cfg,
                             device="cpu",
                             ep_rank=tpc.get_group_rank("moe_ep"), ep_size=2)
    eng = ServingEngine(params, cfg, device="cpu", dp_group=dp, ep_group=ep,
                        **ENGINE)
    out["dpep/engine"] = serve(eng, inp["mixtral/prompts"])
    out["dpep/moe"] = np.asarray(
        eng.serving_summary()["moe"]["expert_tokens"])
    return [grouped_refuses_deadline(eng)]


def other_rows_fault(inp, out):
    """A rank that runs the other data group's rows (DP x TP, gqa)."""
    from torchdistpackage_tpu_torch.models import params_from_jax
    from torchdistpackage_tpu_torch.serving import ServingEngine, sim

    tpc = layout([("data", 2), ("tensor", 2)])
    cfg = config("gqa")
    params = params_from_jax(subtree(inp, "gqa/params/"), cfg, device="cpu",
                             tp_rank=tpc.get_tp_rank(), tp_size=2)
    real = sim.TorchDeviceStep.bind

    def bind(self, engine):
        spg = engine.slots_per_group
        g = (self.group_index + 1) % self.dp
        self.rows = slice(g * spg, (g + 1) * spg)

    sim.TorchDeviceStep.bind = bind
    try:
        eng = ServingEngine(params, cfg, device="cpu",
                            dp_group=tpc.get_group("data"),
                            tp_group=tpc.get_group("tensor"), **ENGINE)
        out["fault/other_rows"] = serve(eng, inp["gqa/prompts"])
    finally:
        sim.TorchDeviceStep.bind = real


def main(rank, world, init_method, in_npz, out_dir):
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import tpc

    torch.set_num_threads(1)
    # a planted fault that made the ranks schedule apart must fail within
    # the test's limit, not wait out gloo's default half hour
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    inp = np.load(in_npz)
    out = {}
    try:
        clock = dptp_cases(inp, out)
        clock += tpep_cases(inp, out)
        clock += tpcp_cases(inp, out)
        clock += dpep_cases(inp, out)
        other_rows_fault(inp, out)
        out["clock/refused"] = np.asarray(clock)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        tpc.reset()
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, init, src, dst = sys.argv[1:6]
    main(int(r), int(w), init, src, dst)
