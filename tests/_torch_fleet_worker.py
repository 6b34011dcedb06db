"""One rank of the port's long-prompt fleet tier on the CPU, for
tests/test_torch_fleet_cp.py — not a pytest file.

The parent writes the weights (numpy, JAX's init of the ``gqa`` family
of tests/test_cp_prefill.py) and the prompts to an ``.npz``, starts
``world`` copies of this script, one a rank, and reads each rank's
``rank<r>.npz`` back.  Every copy joins a gloo process group through a
``file://`` rendezvous and runs, on its own copy of the Router:

- ``handoff``: a CP prefill replica (``ServingEngine(cp_group=)`` over
  every rank, each holding its block slice of the pool) and a plain
  decode replica, ``Router(roles=['prefill', 'decode'],
  long_ctx_threshold=8)``; saves each request's tokens, the
  ``kv_handoff_long`` events, both replicas' tier counters, the
  collectives of the CP export's gather, the audit after every tick
  and ``_validate_router``;
- ``refusals``: a third replica (a second decode target) and an
  attached ``Autoscaler`` raise NotImplementedError naming the clock.

Imports only the port (and numpy): never JAX.  Run as
``python tests/_torch_fleet_worker.py RANK WORLD INIT_METHOD IN_NPZ
OUT_DIR``.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from _torch_cp_worker import unflatten  # noqa: E402

#: the gqa family of tests/test_cp_prefill.py
FAMILY = dict(vocab_size=64, dim=32, nheads=4, nlayers=2, max_seq=64,
              kv_heads=2, ffn_hidden=48)
#: the engine shape of tests/test_cp_prefill.py
ENGINE = dict(num_slots=2, block_size=4, chunk=4, num_blocks=16)
NEW = 6
THRESHOLD = 8
#: the kv_handoff_long fields saved (the event's whole record but its
#: timestamps and router rid)
LONG_FIELDS = ("src_replica", "dst_replica", "length", "n_blocks", "bytes",
               "cp")


def handoff(group, params, cfg, prompts):
    from torchdistpackage_tpu_torch.obs.events import (
        EventLog,
        set_default_event_log,
    )
    from torchdistpackage_tpu_torch.obs.report import _validate_router
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        tp_utils,
    )
    from torchdistpackage_tpu_torch.serving import (
        Request,
        Router,
        ServingEngine,
    )

    log = EventLog()
    set_default_event_log(log)
    pre = ServingEngine(params, cfg, cp_group=group, device="cpu", **ENGINE)
    dec = ServingEngine(params, cfg, device="cpu", **ENGINE)
    router = Router([pre, dec], roles=["prefill", "decode"],
                    long_ctx_threshold=THRESHOLD)
    gathers0 = tp_utils.COLLECTIVES["cp_export"]
    rids = [router.submit(Request(p.tolist(), NEW)) for p in prompts]
    audits_ok = True
    while router.has_work():
        router.step()
        audits_ok &= router.audit()["ok"]
    set_default_event_log(None)
    long_ev = [[e[k] for k in LONG_FIELDS] for e in log.as_list()
               if e["kind"] == "kv_handoff_long"]
    out = {f"tokens{i}": np.asarray(router.finished[r]["tokens"])
           for i, r in enumerate(rids)}
    out["replica"] = np.asarray([router.finished[r]["replica"]
                                 for r in rids])
    out["long_events"] = np.asarray(long_ev, np.int64)
    out["tiers"] = np.asarray([
        pre.stats["decode_steps"], pre.stats["prefill_chunks"],
        dec.stats["prefill_chunks"], dec.stats["decode_steps"],
        pre.stats["migrated_out"], dec.stats["migrated_in"]])
    out["cp_export_gathers"] = np.asarray(
        tp_utils.COLLECTIVES["cp_export"] - gathers0)
    out["audits_ok"] = np.asarray(audits_ok)
    s = router.summary()
    out["validation"] = np.asarray(json.dumps(_validate_router(s)))
    out["pre_cp"] = np.asarray(s["replicas"][0]["long_context"]["cp"])
    out["migration_bytes"] = np.asarray(
        s["fleet"]["migrations"]["bytes"])
    out["pools_conserved"] = np.asarray(
        pre._alloc.in_use == 0 and dec._alloc.in_use == 0)
    return out


def refusals(group, params, cfg):
    from torchdistpackage_tpu_torch.serving import (
        Autoscaler,
        Router,
        ServingEngine,
    )

    def engines(n_plain):
        return ([ServingEngine(params, cfg, cp_group=group, device="cpu",
                               **ENGINE)]
                + [ServingEngine(params, cfg, device="cpu", **ENGINE)
                   for _ in range(n_plain)])

    msgs = []
    try:
        Router(engines(2), roles=["prefill", "decode", "decode"])
    except NotImplementedError as e:
        msgs.append(str(e))
    try:
        Autoscaler(Router(engines(1), roles=["prefill", "decode"]))
    except NotImplementedError as e:
        msgs.append(str(e))
    return {"refusals": np.asarray(json.dumps(msgs))}


def main(rank, world, init_method, in_npz, out_dir):
    from torchdistpackage_tpu_torch.dist import (
        build_cp_group,
        init_distributed,
    )
    from torchdistpackage_tpu_torch.models import llama_config
    from torchdistpackage_tpu_torch.models.convert import params_from_jax

    torch.set_num_threads(1)
    init_distributed(init_method, world, rank, "cpu")
    import torch.distributed as dist

    try:
        group = build_cp_group(world)
        inp = np.load(in_npz)
        cfg = llama_config(**FAMILY, dtype=torch.float32)
        params = params_from_jax(
            unflatten({k[len("params/"):]: inp[k] for k in inp.files
                       if k.startswith("params/")}), cfg, device="cpu")
        out = handoff(group, params, cfg, inp["prompts"])
        out.update(refusals(group, params, cfg))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, init, src, dst = sys.argv[1:6]
    main(int(r), int(w), init, src, dst)
