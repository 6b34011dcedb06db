"""The zero-bubble (ZB-H1-shaped) schedule — the port's counterpart of
``torchdistpackage_tpu/parallel/pipeline_parallel/zero_bubble.py``.

The backward splits in two (MPMD Pipeline Parallelism, arXiv 2412.14374;
Qi et al.'s ZB-H1):

- **dgrad**, the grad with respect to the stage INPUT, must flow upstream
  on the 1F1B wavefront: it is the backward pipeline's critical path;
- **wgrad**, the grad with respect to the PARAMETERS, is needed only by
  the step's accumulator and can run any time after its dgrad.

The JAX package runs a main scan of ``M + 2(P - 1)`` ticks (a forward
unit and a dgrad unit a tick) and then a drain of exactly ``M`` wgrad
ticks; the port runs the same ticks on each stage (one batch of messages
a tick, as ``pipeline_sched._ticks``), then the drain without messages.
The memory shape is JAX's: the forward unit keeps no graph, only its
input ``x``; the dgrad unit recomputes the stage from ``x`` and
differentiates with respect to ``x`` alone (``torch.autograd.grad(y,
x, g)``: autograd skips every weight-grad product), queueing ``(x, g,
dx)``; the wgrad unit recomputes again and differentiates with respect to
the parameters alone (``x`` detached), and on stage 0 ``first_fn``'s
grads come from its own vjp seeded with the queued ``dx``.  A queue of
``M`` retained graphs would hold M stages' activations; this one holds
three activation-sized tensors a microbatch.  The recomputes call
``stage_fn`` with the same microbatch index, so dropout keys folded from
it replay the same masks.

Launches of the flash kernels (remat ``'flash'`` inside the stage, the
GPT stages of ``models.gpt_pipeline_zb``): each layer of a stage runs K3
three times a microbatch (the forward unit, the dgrad recompute, the
wgrad recompute; each backward replays its forward's ``(o, lse)``) and
K4 and K5 twice (the dgrad's and the wgrad's backward) — against once
each in ``pipeline_1f1b``, whose forward unit keeps its graph.  With
remat ``True`` the backward's recompute runs K3 again: five a layer and
microbatch.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ...dist.topology import PIPE_AXIS
from .pipeline_sched import (
    _group,
    _make_stage,
    _run_stage,
    num_stages,
    _Stage,
    _take,
    _transfer_of,
)


def zb_schedule_ticks(num_microbatches: int, pipe_size: int):
    """``(main_ticks, wgrad_ticks)``: ``M + 2(P - 1)`` wavefront ticks (a
    forward and a dgrad unit each) and exactly ``M`` drain ticks."""
    M, P = int(num_microbatches), int(pipe_size)
    return M + 2 * (P - 1), M


def _zb(st: _Stage) -> None:
    P, s, M = st.P, st.s, st.M
    T1, _ = zb_schedule_ticks(M, P)
    qx, qg, qdx = [None] * M, [None] * M, [None] * M
    with torch.no_grad():
        x0 = st.begin()
    act = cot = None

    def fwd_m(t):
        k = t - s
        return k if 0 <= k < M else None

    def bwd_m(t):
        k = t - (P - 1 - s) - (P - 1)
        return k if 0 <= k < M else None

    for t in range(T1):
        send_act = send_cot = None
        m = fwd_m(t)
        if m is not None:
            with torch.no_grad():
                x = ((x0 if m == 0 else st.stage_input(m)) if st.first
                     else act)
                y = st.call_stage(st.params, x, m, 0)
            if tuple(y.shape) != st.shape or y.dtype != st.dtype:
                raise ValueError(
                    f"stage_fn must preserve activation shape/dtype for "
                    f"pipelining: {st.shape}/{st.dtype} -> "
                    f"{tuple(y.shape)}/{y.dtype}")
            qx[m] = x
            st.live += 1
            st.max_live = max(st.max_live, st.live)
            if not st.last:
                send_act = y
        m = bwd_m(t)
        if m is not None:
            xx = qx[m].detach().requires_grad_(True)
            with torch.enable_grad():
                y = st.call_stage(st.params, xx, m, 0)
                if st.last:
                    yl = y.detach().requires_grad_(True)
                    loss_m = st.last_fn(st.params, yl, _take(st.targets, m))
                    (g,) = torch.autograd.grad(loss_m, yl)
                    st.loss = st.loss + loss_m.detach().float()
                else:
                    g = cot
                (dx,) = torch.autograd.grad(y, xx, g)
            qg[m], qdx[m] = g, dx
            if not st.first:
                send_cot = dx
        nf, nb = fwd_m(t + 1), bwd_m(t + 1)
        act, cot = st.comm(send_act=send_act,
                           recv_act=nf is not None and not st.first,
                           send_cot=send_cot,
                           recv_cot=nb is not None and not st.last)
    # the wgrad drain: every stage's own units, no messages
    for j in range(M):
        with torch.enable_grad():
            y2 = st.call_stage(st.params, qx[j], j, 0)
            outs, seeds = [y2], [qg[j]]
            if st.last:
                l2 = st.last_fn(st.params, y2.detach(), _take(st.targets, j))
                outs.append(l2)
                seeds.append(torch.ones_like(l2))
            if st.first:
                outs.append(st.stage_input(j))
                seeds.append(qdx[j])
            torch.autograd.backward(outs, seeds)
        qx[j] = qg[j] = qdx[j] = None
        st.live -= 1


def pipeline_zb_1f1b(params, inputs, targets, first_fn: Callable,
                     stage_fn: Callable, last_fn: Callable,
                     num_microbatches: int, pipe_axis: str = PIPE_AXIS,
                     stage_takes_mb: bool = False,
                     transfer_shard_axis: Optional[str] = None,
                     pipe_group=None, param_specs: Any = None,
                     transfer_shard_group=None):
    """Zero-bubble 1F1B: ``(loss, grads)`` with ``pipeline_1f1b``'s
    contract and arguments (no ``num_chunks``, no ``stage_returns_aux``,
    as in the JAX package).  ``last_stats['max_in_flight']`` counts the
    queued ``(x, g, dx)`` units (at most M: every wgrad waits for the
    drain).

    Emits ``zb_wgrad_deferred`` and ``zb_cooldown_filled`` with the
    reference's fields (JAX :148-160) once a call: the reference emits
    them once a trace, and the eager port has no trace."""
    from ...obs.aggregate import pipeline_bubble_fraction
    from ...obs.events import emit_event

    group = _group(pipe_axis, pipe_group)
    M, P = num_microbatches, num_stages(pipe_axis, group)
    T1, T2 = zb_schedule_ticks(M, P)
    emit_event(
        "zb_wgrad_deferred", units=M, pipe_size=P, queue_slots=M,
        note="wgrad work items (x, g, dx) queued per microbatch at trace "
             "time; executed in the drain scan")
    emit_event(
        "zb_cooldown_filled", main_ticks=T1, wgrad_ticks=T2, pipe_size=P,
        num_microbatches=M,
        bubble_fraction=pipeline_bubble_fraction(M, P, schedule="zb"),
        bubble_fraction_1f1b=pipeline_bubble_fraction(M, P, schedule="1f1b"))
    if stage_takes_mb:
        call_stage = lambda p, x, m, v: stage_fn(p, x, m)  # noqa: E731
    else:
        call_stage = lambda p, x, m, v: stage_fn(p, x)  # noqa: E731
    st = _make_stage(params, inputs, targets, first_fn, call_stage, last_fn,
                     num_microbatches, group, 1, False,
                     _transfer_of(transfer_shard_axis, transfer_shard_group),
                     param_specs, pipe_axis, False)
    return _run_stage(st, _zb, "zb", num_microbatches)
