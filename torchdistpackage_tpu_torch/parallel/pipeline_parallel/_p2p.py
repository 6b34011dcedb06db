"""Point-to-point exchanges over the pipe group — the role of the
reference's ``pipeline_parallel/comm.py``, which the JAX package dropped
(its schedules move activations by ``ppermute`` inside one program).

:func:`exchange` posts every send and receive of one schedule step in a
single ``dist.batch_isend_irecv`` and waits for all of them, so two
neighbours never block on each other: a stage's send forward goes out
with its receive backward, its send backward with its receive forward.
Within a batch the ops keep one order on every rank (activations, then
cotangents; sends before receives) and carry their channel as the tag,
so two messages between the same pair in one step cannot cross.

Over NCCL the payload is the device tensor.  Over gloo (the CPU tests,
and two processes sharing one card) a CUDA payload travels as a host
copy: gloo's point-to-point takes CPU tensors only.  Each such copy
(``tp_utils.to_host`` / ``from_host``, the helpers the ring shift and
the all-to-all use too) is counted in :data:`P2P_STATS`
(``host_copies``, ``host_copy_bytes``); it
carries the payload only, the compute stays on the card.

The shape rule: the schedules exchange one state tensor whose shape and
dtype every stage keeps (``stage_fn`` must preserve them, and the
heterogeneous bus makes any edge one shape), so one preamble a step is
enough — stage 0 computes its first stage input and broadcasts its
shape and dtype over the pipe group (:func:`shape_preamble`) before any
stage posts a receive.  Cotangents have their activations' shapes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ...obs.comm_ledger import note
from ..tensor_parallel import tp_utils
from ..tensor_parallel.tp_utils import from_host, host_path, to_host

#: message tags: the forward (activation) and backward (cotangent) channels
ACT, COT = 0, 1

#: point-to-point traffic since the last :func:`reset_stats`: messages and
#: payload bytes sent and received, the host copies gloo needed for CUDA
#: payloads (each way) and their bytes, the shape preambles, and the pipe
#: group's all-reduces (the loss, the replicated leaves' grads)
P2P_STATS: Dict[str, int] = dict.fromkeys(
    ("sends", "recvs", "bytes_sent", "bytes_recv", "host_copies",
     "host_copy_bytes", "preambles", "all_reduces"), 0)

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int32, torch.int64, torch.int8, torch.uint8, torch.bool)
_META = 10  # ndim, dtype, up to 8 dims


def reset_stats() -> None:
    for k in P2P_STATS:
        P2P_STATS[k] = 0


def route(group, peer: int, tag: int):
    """``(global rank, group)`` a message to or from ``peer`` (a rank of
    ``group``) on channel ``tag`` travels by."""
    return dist.get_global_rank(group, peer), group


def exchange(group, sends: Sequence[Tuple[torch.Tensor, int, int]] = (),
             recvs: Sequence[Tuple[int, int, Tuple[int, ...], torch.dtype,
                                   torch.device]] = ()
             ) -> List[torch.Tensor]:
    """One step's messages: ``sends`` ``(tensor, peer, tag)`` and ``recvs``
    ``(peer, tag, shape, dtype, device)`` (peers are ranks of ``group``),
    all posted in one ``batch_isend_irecv`` and all waited for.  Returns
    the received tensors, in ``recvs``' order, on their devices."""
    ops, keep, outs = [], [], []
    for t, peer, tag in sends:
        t = (to_host(t, P2P_STATS) if host_path(group, t.device)
             else t.detach().contiguous())
        keep.append(t)
        dst, via = route(group, peer, tag)
        note("collective-permute", t, via)
        ops.append(dist.P2POp(dist.isend, t, dst, via, tag))
        P2P_STATS["sends"] += 1
        P2P_STATS["bytes_sent"] += t.numel() * t.element_size()
    for peer, tag, shape, dtype, device in recvs:
        dev = torch.device("cpu") if host_path(group, device) else device
        buf = torch.empty(shape, dtype=dtype, device=dev)
        outs.append((buf, device))
        ops.append(dist.P2POp(dist.irecv, buf, *route(group, peer, tag),
                              tag))
        P2P_STATS["recvs"] += 1
        P2P_STATS["bytes_recv"] += buf.numel() * buf.element_size()
    if not ops:
        return []
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    del keep
    got = []
    for buf, device in outs:
        if buf.device != device:
            buf = from_host(buf, device, P2P_STATS)
        got.append(buf)
    return got


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` in place (through a host copy counted
    in :data:`P2P_STATS` for a CUDA tensor over gloo)."""
    P2P_STATS["all_reduces"] += 1
    return tp_utils.all_reduce_(t, group, stats=P2P_STATS)


def shape_preamble(group, x: Optional[torch.Tensor],
                   device: torch.device) -> Tuple[Tuple[int, ...],
                                                  torch.dtype]:
    """``(shape, dtype)`` of the state: stage 0 passes its first stage
    input ``x``, every other stage None; one broadcast from stage 0 over
    ``group`` (every stage calls it before its first receive)."""
    on = torch.device("cpu") if (dist.get_backend(group) == "gloo"
                                 or device.type != "cuda") else device
    meta = torch.zeros(_META, dtype=torch.int64, device=on)
    if x is not None:
        if x.dim() > _META - 2:
            raise ValueError(f"a state of {x.dim()} dims (at most "
                             f"{_META - 2})")
        meta[0], meta[1] = x.dim(), _DTYPES.index(x.dtype)
        meta[2:2 + x.dim()] = torch.tensor(tuple(x.shape), dtype=torch.int64)
    P2P_STATS["preambles"] += 1
    note("broadcast", meta, group)
    dist.broadcast(meta, src=dist.get_global_rank(group, 0), group=group)
    m = meta.tolist()
    return tuple(int(d) for d in m[2:2 + m[0]]), _DTYPES[m[1]]
