"""One rank of the port's cross-process guards on the CPU, for
tests/test_torch_watchdog.py — not a pytest file.

Each copy joins a gloo process group through a ``file://`` rendezvous
and runs, on its own event log:

- ``check_consistency`` over step, config, code and a seeded parameter
  tree, every rank alike (agrees), then again with rank 1's parameters
  perturbed by one element (``desync_detected`` must name ``params``);
- ``cross_host_step_stats`` with rank 1's steps four times as slow
  (the ``straggler`` event must name it);
- ``Telemetry.finalize``, whose ``hosts`` section is the same gather.

It writes ``rank<r>.json``.  Imports only the port (and numpy): never
JAX.  Run as ``python tests/_torch_watchdog_worker.py RANK WORLD
INIT_METHOD OUT_DIR``.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

CONFIG = {"model": "llama", "dim": 64, "layers": [2, 4], "lr": 3e-4}
STEP_S = 0.125
#: rank 1's slowdown: at two ranks the median is their mean, so the
#: slow rank's ratio is 2 SLOW / (1 + SLOW), 1.6 > the 1.5 factor
SLOW = 4


def params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"embed": torch.randn(16, 8, generator=g),
            "blocks": [{"w": torch.randn(8, 8, generator=g),
                        "b": torch.zeros(8)} for _ in range(2)]}


def main(rank, world, init_method, out_dir):
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import init_distributed
    from torchdistpackage_tpu_torch.obs import (
        EventLog,
        Telemetry,
        cross_host_step_stats,
    )
    from torchdistpackage_tpu_torch.resilience import check_consistency

    torch.set_num_threads(1)
    init_distributed(init_method, world, rank, "cpu")
    try:
        log = EventLog()
        p = params()
        agree = check_consistency(step=7, config=CONFIG, params=p,
                                  code=True, event_log=log)
        if rank == 1:
            p["blocks"][1]["w"][3, 5] += 1e-3
        drift = check_consistency(step=7, config=CONFIG, params=p,
                                  event_log=log)
        times = [STEP_S * (SLOW if rank == 1 else 1)] * 8
        hosts = cross_host_step_stats(times, event_log=log)
        tel = Telemetry(run="guards", device="cpu", event_log=log,
                        report_path="", trace_path="")
        step = tel.wrap_step(lambda x: x + 1)
        for _ in range(3):
            step(torch.ones(2))
            tel.end_step()
        rep = tel.finalize(print_summary=False)
        out = {"agree": agree, "drift": drift, "hosts": hosts,
               "report_hosts": rep["hosts"],
               "n_processes": rep["n_processes"],
               "events": [{k: v for k, v in e.items()
                           if k not in ("t_wall", "t_mono")}
                          for e in log.as_list()
                          if e["kind"] in ("desync_detected",
                                           "straggler")]}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, init, dst = sys.argv[1:5]
    main(int(r), int(w), init, dst)
