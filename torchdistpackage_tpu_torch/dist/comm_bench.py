"""Collective bandwidth benchmark — the port's counterpart of
``torchdistpackage_tpu/dist/comm_bench.py`` (itself the reference's
``py_comm_test.py``): each collective timed over the group of one axis
of ``tpc``, reported as algorithm and bus bandwidth with the
nccl-tests correction factors:

- all_reduce:      busbw = algbw * 2 * (n-1)/n
- all_gather:      busbw = algbw * (n-1)/n
- reduce_scatter:  busbw = algbw * (n-1)/n
- all_to_all:      busbw = algbw * (n-1)/n
- ppermute (ring p2p): busbw = algbw

algbw = bytes / time, ``bytes`` the whole (global) payload, as in
nccl-tests.  The int8 arms (``int8_all_reduce``,
``int8_reduce_scatter``, ``int8_all_gather``) time the rings of
``dist/compressed.py`` through the same harness; their records keep
``bytes`` at the original payload (comparable to the exact arm's row)
and add ``compressed`` / ``base_op`` / ``elem_bytes``, which
``obs.comm_model.CommModel.calibrate`` reads to fit the rings against
their compressed wire bytes.  Results are ``obs.comm_ledger.comm_record``
dicts.  On a card each call is timed between two device
synchronisations; a record's ``time_s`` is the median of ``iters``
calls.  Over gloo a CUDA payload goes through the host
(``tp_utils.HOST_STAGING``), which the time includes.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..obs.comm_ledger import comm_record
from ..parallel.tensor_parallel import tp_utils
from .topology import tpc

_BUSBW_FACTOR = {
    "all_reduce": lambda n: 2 * (n - 1) / n,
    "all_gather": lambda n: (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_to_all": lambda n: (n - 1) / n,
    "ppermute": lambda n: 1.0,
    # the int8 arms: the base op's factor over the ORIGINAL payload — an
    # effective bus bandwidth comparable to the exact arm's row
    "int8_all_reduce": lambda n: 2 * (n - 1) / n,
    "int8_reduce_scatter": lambda n: (n - 1) / n,
    "int8_all_gather": lambda n: (n - 1) / n,
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timeit(fn: Callable[[], Any], device: torch.device, warmup: int = 2,
            iters: int = 10) -> float:
    """Median wall time of ``fn()`` between device synchronisations,
    seconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def bench_collective(op: str, axis: str, nbytes: int = 1 << 24, ctx=None,
                     dtype: torch.dtype = torch.bfloat16, warmup: int = 2,
                     iters: int = 10, device=None) -> Dict[str, Any]:
    """Time one collective over ``axis`` of ``ctx`` (default ``tpc``) and
    return its comm record (``{op, axis, axis_size, bytes, time_s,
    algbw_GBps, busbw_GBps}``).  ``nbytes`` is the global payload; the
    tensors live on ``device`` (default: the card).  Every rank of the
    axis's group calls it."""
    from ..device import resolve_device

    ctx = tpc if ctx is None else ctx
    device = resolve_device(device)
    group = ctx.get_group(axis)
    n = dist.get_world_size(group)
    elem = torch.empty((), dtype=dtype).element_size()
    # divisible by n (by n * n for all_to_all's [n, count / n / n] blocks)
    quantum = n * n if op == "all_to_all" else n
    count = max(quantum, nbytes // elem // quantum * quantum)
    local = count // n
    x = torch.ones(count if op in ("all_reduce", "reduce_scatter",
                                   "int8_all_reduce", "int8_reduce_scatter")
                   else local, dtype=dtype, device=device)

    if op == "all_reduce":
        def body():
            return tp_utils._all_reduce(x, group, "comm_bench")
    elif op == "all_gather":
        def body():
            return tp_utils._all_gather(x, group, 0, "comm_bench")
    elif op == "reduce_scatter":
        def body():
            return tp_utils._reduce_scatter(x, group, 0, "comm_bench")
    elif op == "all_to_all":
        def body():
            return tp_utils._all_to_all(x.reshape(n, -1), group)
    elif op == "ppermute":
        def body():
            return tp_utils._shift(x, group, 1, "comm_bench")
    elif op == "int8_all_reduce":
        from .compressed import int8_ring_pmean

        def body():
            return int8_ring_pmean(x, group) * n  # the sum, as all_reduce
    elif op == "int8_reduce_scatter":
        from .compressed import int8_ring_reduce_scatter

        def body():
            return int8_ring_reduce_scatter(x, group, 0)
    elif op == "int8_all_gather":
        from .compressed import int8_ring_all_gather

        def body():
            return int8_ring_all_gather(x, group, 0)
    else:
        raise ValueError(f"unknown collective {op!r}")

    with torch.no_grad():
        t = _timeit(body, device, warmup=warmup, iters=iters)
    size = count * elem
    algbw = size / t / 1e9
    extra = ({"compressed": True, "base_op": op[len("int8_"):],
              "elem_bytes": elem} if op.startswith("int8_") else {})
    return comm_record(op=op, axis=axis, nbytes=size, axis_size=n,
                       time_s=t, algbw_GBps=algbw,
                       busbw_GBps=algbw * _BUSBW_FACTOR[op](n), **extra)


def test_collection(axis: str, sizes: Sequence[int] = (1 << 20, 1 << 24),
                    ops: Sequence[str] = ("all_reduce", "all_gather",
                                          "reduce_scatter", "all_to_all",
                                          "ppermute"),
                    ctx=None, verbose: bool = True, sink: Any = None,
                    dtype: torch.dtype = torch.bfloat16, warmup: int = 2,
                    iters: int = 10, device=None) -> List[Dict[str, Any]]:
    """Every op of ``ops`` at every size of ``sizes`` over ``axis`` — the
    reference's ``test_collection``.  ``sink``: anything with
    ``write(record)``, or a path to append each record to as a JSON line
    (rank 0 of the world writes); ``verbose`` prints a line a record on
    rank 0."""
    master = not dist.is_initialized() or dist.get_rank() == 0
    rows = []
    for op in ops:
        for nbytes in sizes:
            row = bench_collective(op, axis, nbytes=nbytes, ctx=ctx,
                                   dtype=dtype, warmup=warmup, iters=iters,
                                   device=device)
            rows.append(row)
            if sink is not None and master:
                if isinstance(sink, str):
                    with open(sink, "a") as f:
                        f.write(json.dumps(row) + "\n")
                else:
                    sink.write(row)
            if verbose and master:
                print(f"{op:>19} axis={axis}({row['axis_size']}) "
                      f"{row['bytes'] / 2**20:8.1f} MiB  "
                      f"{row['time_s'] * 1e3:8.3f} ms  "
                      f"alg {row['algbw_GBps']:7.2f} GB/s  "
                      f"bus {row['busbw_GBps']:7.2f} GB/s", flush=True)
    return rows
