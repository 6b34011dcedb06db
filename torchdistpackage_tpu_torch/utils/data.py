"""Input pipeline helpers — the port's counterpart of
``torchdistpackage_tpu/utils/data.py``.

The reference places a global host batch on a device mesh; the port is
one process a rank, so :func:`shard_batch` cuts this rank's rows out of
the global batch (rank ``r`` of the data group takes rows ``[r B/n, (r +
1) B/n)``, the rows ``P('data')`` gives device ``r`` there) and moves
them to the rank's device.  :func:`prefetch_to_sharding` keeps the next
batches' host-to-card copies in flight: pinned host memory, copies on a
side stream, and an event the consumer's stream waits on before use.

The reference's ``global_batch_from_local`` has no counterpart: a rank's
tensors already are its local batch.
"""

from __future__ import annotations

import collections
import itertools
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _rows(x, rank: int, n: int):
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch dim {b} not divisible by the data group's "
                         f"size {n}")
    per = b // n
    return x[rank * per:(rank + 1) * per]


def _group_rank_size(group):
    import torch.distributed as dist

    if group is None:
        from ..dist.topology import tpc

        if not tpc.is_initialized:
            return 0, 1
        return tpc.get_dp_rank(), tpc.get_dp_size()
    return dist.get_rank(group), dist.get_world_size(group)


def local_rows(batch: Any, group=None) -> Any:
    """This rank's rows of every leaf (numpy arrays or tensors, left
    where they are).  ``group``: a ``ProcessGroup``, or None for the
    ``data`` axis of ``tpc`` (the whole batch when ``tpc`` is not set
    up)."""
    rank, n = _group_rank_size(group)
    return _map(lambda x: _rows(x, rank, n), batch)


def _to_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.kind in "iu":
        arr = arr.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(arr))


def shard_batch(batch: Any, group=None, device: DeviceLike = None) -> Any:
    """This rank's rows of the global ``batch`` over the data group, as
    tensors on ``device`` (default: the card).  Integer numpy leaves
    become int64 tensors (token ids index an embedding)."""
    dev = resolve_device(device)
    return _map(lambda x: _to_tensor(x).to(dev),
                local_rows(batch, group))


def _pinned_copy(batch: Any, dev: torch.device, stream) -> Any:
    """Host rows -> pinned memory -> the card on ``stream``; returns the
    device tree and the event recorded after the copies."""
    host = _map(lambda x: _to_tensor(x).pin_memory(), batch)
    with torch.cuda.stream(stream):
        out = _map(lambda t: t.to(dev, non_blocking=True), host)
        ev = torch.cuda.Event()
        ev.record(stream)
    return out, ev


def prefetch_to_sharding(it: Iterable[Any], group=None, prefetch: int = 2,
                         device: DeviceLike = None) -> Iterator[Any]:
    """Iterate this rank's rows of each global batch on ``device``,
    keeping ``prefetch`` batches' copies in flight ahead of the consumer
    (the counterpart of the reference's mesh prefetch).  On the card the
    rows go through pinned host memory, are copied on a side stream, and
    the consumer's stream waits on the copy's event before a batch is
    handed out; ``prefetch=0`` (or the CPU) places each batch when it is
    asked for."""
    dev = resolve_device(device)
    if prefetch <= 0 or dev.type != "cuda":
        for b in it:
            yield shard_batch(b, group, dev)
        return
    side = torch.cuda.Stream(device=dev)
    it = iter(it)
    buf: collections.deque = collections.deque()
    for b in itertools.islice(it, prefetch):
        buf.append(_pinned_copy(local_rows(b, group), dev, side))
    _end = object()  # a None batch must not end the stream
    while buf:
        nxt = next(it, _end)
        if nxt is not _end:
            buf.append(_pinned_copy(local_rows(nxt, group), dev, side))
        out, ev = buf.popleft()
        cur = torch.cuda.current_stream(dev)
        cur.wait_event(ev)
        # the tensors were allocated on the side stream: tell the caching
        # allocator the consumer's stream uses them too
        _map(lambda t: t.record_stream(cur), out)
        yield out


def microbatch(batch: Any, num_microbatches: int) -> Any:
    """Reshape every leaf's leading dim B into ``[M, B/M]`` — the layout
    the pipelined losses consume."""

    def split(x):
        b = x.shape[0]
        if b % num_microbatches != 0:
            raise ValueError(
                f"batch dim {b} not divisible by num_microbatches "
                f"{num_microbatches}")
        return x.reshape(num_microbatches, b // num_microbatches,
                         *x.shape[1:])

    return _map(split, batch)
