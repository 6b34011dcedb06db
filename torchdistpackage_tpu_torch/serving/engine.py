"""Continuous-batching serving engine over the paged KV cache — the
PyTorch counterpart of ``torchdistpackage_tpu/serving/engine.py``.

The scheduler is the reference's, on one device:

- **Fixed slots.**  The decode batch is ``num_slots`` rows; a request
  holds a slot from admission to retirement, and freed slots refill from
  the queue on the next tick.  Every device call has one of two shapes —
  ``[num_slots, chunk]`` prefill, ``[num_slots, 1]`` decode — and host
  code between ticks only rewrites small int32 tables
  (``serving_summary()['decode_signatures']`` is the evidence).
- **Chunked prefill.**  Prompts enter in ``chunk``-token slices, one per
  tick, batched across every prefilling slot; the final slice samples the
  first token at the true last prompt row (``last_idx``).
- **Per-slot sampling.**  Temperature <= 0 is greedy argmax; otherwise
  the reference's temperature -> top-k -> top-p filter and a draw from the
  slot's own ``torch.Generator``, seeded from ``Request.seed``.  Those
  streams are not JAX's threefry bits: token parity with the JAX engine
  holds for greedy requests only.
- **Retirement** on EOS or ``max_new_tokens`` frees the blocks the same
  tick; every tick starts with the block-conservation audit, which heals
  what it finds by requeueing the poisoned slot.
- **Prefix cache** (``prefix_cache=True``).  ``BlockAllocator`` carries
  refcounts and a content-hash index chained over full prompt blocks;
  admission maps the longest resident prefix of a prompt into the new
  slot's table (``prefix_hit``: chunked prefill starts after the cached
  boundary), a whole-prompt hit copy-on-writes its last block
  (``block_cow``, one :func:`~.paged_cache.copy_blocks` call before the
  next prefill, on the pool's stream) so the last token's logits are
  recomputed without writing a shared block, retirement and preemption
  decrement rather than free, and refcount-0 cached blocks stay on an LRU
  until allocation pressure evicts them (``cache_evict``).
- **Priorities and preemption.**  ``Request.priority`` orders the queue
  (higher first, FIFO within a class).  When the head cannot be placed,
  the lowest-priority running slot strictly below it is evicted and its
  request requeued for replay from its seed (or its carried stream
  state), so its final tokens equal an uninterrupted run's.
- **Deadlines and shedding.**  ``Request.deadline_s`` is a TTFT budget
  from submit: :meth:`ServingEngine.estimate_ttft` (prefill work ahead x
  the measured tick EWMA x the calibration bias) sheds a request that
  cannot make it, ``max_queue`` bounds the queue, and a queued request
  whose budget lapses expires — each a verdict in ``engine.rejected``.
- **Drain / resume and migration.**  :meth:`ServingEngine.drain` unwinds
  the queue and every slot into restartable descriptors (prompt, emitted
  tokens, sampling parameters, the stream's state), optionally persisted
  with a SHA-256 manifest; :meth:`ServingEngine.resume` replays them
  exactly.  :meth:`ServingEngine.export_slot` /
  :meth:`ServingEngine.import_slot` move a decoding slot with its KV
  (``migrate_blocks``) to another engine.
- **Speculative decoding** (``spec_k=K``).  A host-side n-gram drafter
  (:meth:`ServingEngine._draft`: the tokens that followed the last
  bigram's, else the last unigram's, most recent earlier occurrence,
  else the last token repeated) proposes K tokens a decoding slot each
  tick, and one verify call (``TorchDeviceStep.verify``) scores all K+1
  positions through the paged forward's ``all_logits``: greedy rows
  accept while the draft equals the argmax (tokens equal plain decode),
  sampled rows run residual rejection sampling from the slot's stream.
  A slot advances 1..K+1 tokens a tick; a rejection truncates host-side
  (the stale KV tail is overwritten before it is attended).  Every
  table covers ``max_ctx + spec_k`` positions for the overshoot writes.

Every device touch goes through the ``device_step`` seam
(:mod:`.sim`): :class:`~.sim.TorchDeviceStep` by default, or the
host-only :class:`~.sim.StubDeviceStep` (``params=None``) that the policy
tests run on.  Paged attention runs through the hand-written CUDA kernel
on the card (``attn_impl='auto'`` resolves to ``'cuda'`` there,
``'gather'`` on the CPU).  An MoE model (``cfg.moe_experts > 0``, e.g.
Mixtral) serves through ``paged_forward_moe``: its expert layers run the
fused dispatch kernel K6 on the card (``moe_dispatch='auto'`` ->
``'cuda'``) or the ragged plain path (``'gather'``), and
``serving_summary()['moe']`` reports the live expert load.  With
``ep_group`` its experts are sharded over a ``torch.distributed`` group
(expert parallelism, K7 on the card).  With ``cp_group`` a dense model's
pool is sharded by blocks over a ``torch.distributed`` group and every
prefill chunk is split across its ranks (context parallelism: ring paged
attention, K2 on the card, and ``serving_summary()['long_context']``).
With ``tp_group`` the model (dense or MoE) is tensor-parallel over a
``torch.distributed`` group: each rank holds its shard and ``Hkv / tp``
heads of the pool, and every step gathers the full logits; it composes
with ``ep_group`` (TP x EP: attention over ``tensor``, experts over
``moe_ep``) and with ``cp_group`` (TP x CP: the rings over ``context``
at ``Hkv / tp`` heads), both with ``replica_group``.  With ``dp_group``
the slots and the pool split over data-parallel groups (the
reference's ``dp_axis``): one ``BlockAllocator`` a group, block ids
local to the group, each group's rows run by its own replica.

A replica is a set of processes, each running this scheduler: every
rank must take the same decisions every tick.  Admission and slot
choice follow from the submits; the sampled tokens are one rank's
(``replica_group``, gathered over ``dp_group``); and a decision that
reads the host clock would not, so an engine over any process group
refuses ``Request.deadline_s`` (deadline shedding and queue expiry)
at submit.

``chaos=`` takes a :class:`~..resilience.ChaosMonkey`: its engine faults
fire at the top of a tick (before the audit) and on the fetched tokens,
and the audit and the token check heal them.  The reference's ``mesh`` /
``axis`` / ``dp_axis`` / ``ep_axis`` / ``cp_axis`` stay refused (the
groups take their place; NotImplementedError).

**Observability** (the reference's, JAX :319-353).  Every tick is split
host-side into :data:`~.tracing.TICK_PHASES` — ``audit``, ``sched``
(expiry, admission, the copy-on-write), ``prefill`` and ``decode`` (each
call's enqueue: up to :class:`~.sim.TorchDeviceStep`'s ``t_enqueued``
mark, set just before its one read-back), ``draft``, ``fetch`` (the
read-back's wait, and ``Telemetry.end_step``) and the residual ``host``
— kept on ``tick_records``, emitted as an ``engine_tick`` event with the
rids each phase served (when the tick did work), rolled up in
``serving_summary()['tick_accounting']`` and, with ``metrics_sink=``,
written as a ``serving_metrics`` record every ``metrics_every`` ticks.
``telemetry=`` (an :class:`~..obs.Telemetry`) wraps the decode / verify
step (a new signature is a ``recompile``), closes a telemetry step
after each, and takes the engine's events onto its timeline;
``watchdog=`` (a :class:`~..resilience.Watchdog`, started by the caller)
is beaten once a tick.  None of it adds a device launch or a sync: the
tokens are on the host when ``end_step`` runs.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.gpt import GPTConfig
from ..obs.aggregate import moe_load_stats, percentiles
from ..obs.events import EventLog, default_event_log
from ..ops import moe_dispatch as _moe_ops
from ..ops import paged_attention as _attn_ops
from .tracing import TICK_PHASES, serving_metrics_record
from .paged_cache import (
    BlockAllocator,
    PoolSnapshot,
    chain_block_hashes,
    expected_pool_bytes,
    pool_bytes,
)

# slot lifecycle
FREE, PREFILL, DECODE = "free", "prefill", "decode"

#: drain-payload schema tag (the reference's, JAX :166)
DRAIN_SCHEMA = "tdp-engine-drain/v1"


@dataclasses.dataclass
class Request:
    """One serving request.  ``temperature=0`` is greedy; otherwise
    ``seed`` starts the slot's private sampling stream.  ``eos_id`` retires
    the request early.  ``priority`` orders the queue and arms
    preemption (a waiting request may evict a running slot of strictly
    lower priority); ``deadline_s`` is a TTFT budget from submit, which
    admission sheds on and a queued request expires by."""

    tokens: Sequence[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_id: Optional[int] = None
    seed: int = 0
    priority: int = 0
    deadline_s: Optional[float] = None
    rid: int = -1  # assigned at submit()

    def __post_init__(self) -> None:
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if len(self.tokens) < 1:
            raise ValueError("empty prompt")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0, got {self.deadline_s}")


def _filtered_logits(x: torch.Tensor, temperature: torch.Tensor,
                     top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-row temperature -> top-k -> top-p filter on f32 [N, V] logits
    (the reference's semantics, including the rank-0-always-kept nucleus
    edge): masked entries become -inf, survivors are scaled by
    1/temperature."""
    V = x.shape[-1]
    neg = float("-inf")
    xs = x / temperature.clamp_min(1e-6)[:, None]
    k = top_k.long().clamp(1, V)[:, None]
    sorted_x = torch.sort(xs, dim=-1, descending=True).values
    kth = torch.gather(sorted_x, -1, k - 1)
    xs = torch.where(xs < kth, neg, xs)
    ranks = torch.arange(V, device=x.device)[None, :]
    sorted_x = torch.where(ranks < k, sorted_x, neg)
    cum = torch.cumsum(torch.softmax(sorted_x, dim=-1), dim=-1)
    before = torch.roll(cum, 1, dims=-1)
    before[:, 0] = 0.0
    keep = before < top_p[:, None]
    keep[:, 0] = True  # argmax always survives (top_p -> 0)
    cutoff = torch.where(keep, sorted_x, float("inf")).min(
        dim=-1, keepdim=True).values
    return torch.where(xs < cutoff, neg, xs)


def _slot_sample(logits: torch.Tensor,
                 gens: Sequence[Optional[torch.Generator]],
                 temperature: torch.Tensor, top_k: torch.Tensor,
                 top_p: torch.Tensor) -> torch.Tensor:
    """Per-slot sampler on [B, V] logits: the f32 argmax where
    ``temperature <= 0`` or ``gens[i] is None`` (a greedy slot, or one
    that emits nothing this call — the engine passes no generator), else
    a Gumbel-max draw from the slot's filtered logits with its own
    generator.  No value is read back to the host."""
    x = logits.float()
    tok = torch.argmax(x, dim=-1)
    rows = [i for i, g in enumerate(gens) if g is not None]
    if rows:
        # uploaded without a stream sync (see TorchDeviceStep._to_dev)
        idx = torch.tensor(rows).to(x.device, non_blocking=True)
        xs = _filtered_logits(x[idx], temperature[idx], top_k[idx],
                              top_p[idx])
        u = torch.stack([torch.rand(x.shape[-1], generator=gens[i],
                                    device=x.device) for i in rows])
        tiny = torch.finfo(torch.float32).tiny
        drawn = torch.argmax(xs - torch.log(-torch.log(u.clamp_min(tiny))),
                             dim=-1)
        tok[idx] = torch.where(temperature[idx] > 0.0, drawn, tok[idx])
    return tok




class _SlotState:
    """Host-side bookkeeping for one slot.  ``orig_prompt_len`` /
    ``pre_gen`` account for a resumed or imported request whose admitted
    prompt carries an already-emitted prefix."""

    __slots__ = ("state", "rid", "req", "blocks", "prompt", "off",
                 "generated", "t_submit", "t_admit", "t_last", "ttft_s",
                 "tpot_s", "orig_prompt_len", "pre_gen")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.state = FREE
        self.rid = -1
        self.req: Optional[Request] = None
        self.blocks: List[int] = []
        self.prompt: Optional[np.ndarray] = None
        self.off = 0
        self.generated: List[int] = []
        self.t_submit = self.t_admit = self.t_last = 0.0
        self.ttft_s: Optional[float] = None
        self.tpot_s: List[float] = []
        self.orig_prompt_len = 0
        self.pre_gen = 0


_TP = ("tensor parallelism takes tp_group= (a torch.distributed process "
       "group), not mesh= / axis=")
_DP = ("data parallelism takes dp_group= (a torch.distributed process "
       "group, this rank's data group), not mesh= / dp_axis=")
_EP = ("expert parallelism takes ep_group= (a torch.distributed process "
       "group), not mesh= / ep_axis=")
_CP = ("context parallelism takes cp_group= (a torch.distributed process "
       "group, dist.build_cp_group), not mesh= / cp_axis=")

#: constructor options of the reference engine that the port does not
#: serve yet: the value that means "off", and what each waits for
_QUEUED_OPTIONS = {
    "mesh": (None, (_TP, _DP, _EP, _CP)), "axis": (None, (_TP,)),
    "dp_axis": (None, (_DP,)), "ep_axis": (None, (_EP,)),
    "cp_axis": (None, (_CP,)),
}


#: why a grouped engine refuses ``Request.deadline_s``
_CLOCK = ("deadline_s is refused by an engine over a process group: "
          "deadline shedding and queue expiry read the host clock, which "
          "differs from rank to rank, and ranks that decide differently "
          "schedule apart and hang in the next collective")


def _check_cp(cfg: GPTConfig, cp_group, chunk: int,
              num_blocks: Optional[int], kv_quant: bool, ep_group, dp_group,
              on: set) -> int:
    """The size of the CP group, after the reference's refusals of what
    context parallelism does not serve (JAX ``engine.py:407-436``)."""
    if dp_group is not None:
        raise NotImplementedError(
            "cp_group cannot be combined with dp_group: the pool's block "
            "dim carries exactly one axis (run a CP prefill tier as its own "
            "replica)")
    if ep_group is not None:
        raise NotImplementedError(
            "cp_group cannot be combined with ep_group: context parallelism "
            "serves dense models only")
    if "spec_k" in on:
        raise NotImplementedError(
            "cp_group + speculative decoding is not supported (a CP prefill "
            "tier hands off before decode; run spec_k on the decode replica)")
    if "prefix_cache" in on:
        raise NotImplementedError(
            "cp_group + prefix_cache is not supported (block hashes would "
            "need cross-rank content)")
    if kv_quant:
        raise NotImplementedError(
            "cp_group + kv_quant is not supported (the ring rotates fp pool "
            "slices)")
    if cfg.moe_experts:
        raise NotImplementedError("cp_group + MoE serving is not supported "
                                  "yet")
    cp = dist.get_world_size(cp_group)
    if chunk % cp:
        raise ValueError(
            f"chunk ({chunk}) must be divisible by the CP group size ({cp}) "
            f"— each rank prefills chunk/cp rows")
    if num_blocks is not None and num_blocks % cp:
        raise ValueError(
            f"num_blocks ({num_blocks}) must be divisible by the CP group "
            f"size ({cp}) — the pool's block dim is sharded over the group")
    return cp


class ServingEngine:
    """Paged-KV continuous-batching engine on one device.  Typical
    use::

        eng = ServingEngine(params, cfg, num_slots=8, block_size=16)
        eng.submit(Request(prompt_ids, max_new_tokens=64))
        eng.run_until_idle()
        out = eng.finished[0]["tokens"]          # prompt + generated

    Parameters
    ----------
    params: the model dict (``models.init_gpt_params`` or
        ``models.convert.params_from_jax``) on ``device``; None with a
        host-only ``device_step``.
    num_slots: decode-batch width.
    block_size: KV positions per pool block.
    num_blocks: pool blocks including the NULL block; default sizes the
        pool so every slot can hold ``max_ctx``.
    max_ctx: per-request ceiling on prompt + generated tokens; sets the
        block-table width.  Default ``cfg.max_seq``.
    chunk: prefill tokens per slot per tick.
    kv_quant: int8 block pool.
    max_queue: bound on the waiting queue; a submit past it is shed with
        a ``queue_full`` verdict.  None: unbounded.
    prefix_cache: map resident prompt prefixes into new slots (see the
        module docstring); ``serving_summary()['prefix_cache']``.
    attn_impl: ``'cuda'`` (the kernel), ``'gather'`` (the plain version,
        the oracle arm) or ``'auto'``: by the device.  Recorded in
        ``serving_summary()['attn_impl']``.
    moe_dispatch: for an MoE model, ``'cuda'`` (the fused dispatch
        kernel), ``'gather'`` (the ragged plain path, the oracle arm) or
        ``'auto'`` (by the device); None defers to ``cfg.moe_dispatch``.
        Resolved once; recorded in ``serving_summary()['moe']['dispatch']``.
        Set on a dense model it raises.
    ep_group: expert parallelism — a ``torch.distributed`` process group
        (``dist.build_moe_groups``) whose ranks each hold ``E / ep`` of
        every expert layer's experts (``models.shard_moe_params``) and run
        this engine on the same requests in the same order (replicated
        tokens).  The expert layers exchange their capacity slots over the
        group (``parallel.moe.moe_forward`` at the no-drop capacity), the
        FFN in K7 under ``'cuda'`` or the index dispatch ``'sorted'`` (to
        which ``'gather'`` maps), and every tick takes rank 0's sampled
        tokens, so the ranks schedule alike.  The counterpart of the
        reference's ``mesh=`` + ``ep_axis=``, which stay refused.
    cp_group: context parallelism for a dense model — a
        ``torch.distributed`` process group (``dist.build_cp_group``)
        whose ranks run this engine on the same requests in the same
        order.  Rank ``r`` holds global blocks ``[r nb_local, (r + 1)
        nb_local)`` of the pool (``nb_local = num_blocks / cp``; the
        allocator and the tables stay global), embeds ``chunk / cp`` rows
        of every prefill chunk, and every attend runs the ring
        (``ops/ring_paged.py``): K2 under ``'cuda'``, K1 never.  Every
        tick takes rank 0's sampled tokens.  ``chunk`` and an explicit
        ``num_blocks`` must be divisible by cp (the default rounds up);
        ``kv_quant``, MoE, ``spec_k``, ``prefix_cache``, ``ep_group`` and
        ``dp_group`` are refused.  With ``tp_group`` each rank's slice
        holds its ``Hkv / tp`` heads and the rings run at them.  The
        counterpart of the reference's ``mesh=`` + ``cp_axis=``, which
        stay refused.
    tp_group: tensor parallelism — a ``torch.distributed`` process group
        whose ranks each hold their shard of ``params``
        (``models.gpt.shard_gpt_params``, or ``params_from_jax(tp_rank=,
        tp_size=)``; an MoE model's router and experts whole) and run
        this engine on the same requests in the same order.  Each rank's
        pool holds ``Hkv / tp`` KV heads (K1 over them), every block sums
        its row-parallel products over the group, and every step gathers
        the full logits and takes rank 0's sampled tokens.  Works with
        ``kv_quant``, ``spec_k``, ``prefix_cache`` and the MoE family,
        beside ``ep_group`` (the rank's ``moe_ep`` group;
        ``models.shard_moe_params(..., tp_rank=, tp_size=)``) and beside
        ``cp_group`` (the rank's ``context`` group).  The counterpart of
        the reference's ``mesh=`` + ``axis=``, which stay refused.
    dp_group: data parallelism — this rank's data group
        (``tpc.get_group('data')``, or ``'moe_dp'`` on the MoE view).  The
        ``num_slots`` rows split into ``dp`` groups of ``slots_per_group``;
        group ``g`` (this rank's rank in ``dp_group``) runs rows ``[g spg,
        (g + 1) spg)`` on its own pool of ``num_blocks`` blocks (per
        group; default sized for its slots), and every group keeps one
        ``BlockAllocator`` of its own, so block ids are group-local.
        Every rank runs the whole scheduler on the same requests; each
        step gathers the groups' tokens over ``dp_group``.  Composes with
        ``tp_group`` and ``ep_group`` (the replica's groups), not with
        ``cp_group`` (as in the reference).  The counterpart of the
        reference's ``dp_axis``, which stays refused.
    replica_group: the group over every rank of one replica (every axis
        but the data one, ``dist.ParallelContext.replica_group``): the
        step broadcasts its first rank's tokens over it.  Required when
        ``tp_group`` is composed with ``ep_group`` or ``cp_group``; None
        otherwise means the one group given.
    spec_k: draft tokens a decoding slot a tick (0: off); see the module
        docstring.  Works with the MoE family and ``ep_group``;
        ``serving_summary()['spec']`` counts drafted and accepted tokens.
    device: where the pool and the step live (default: the card).
    device_step: a :class:`~.sim.DeviceStep` holding the engine's device
        touches; None builds :class:`~.sim.TorchDeviceStep` on ``device``.
        A host-only step (:class:`~.sim.StubDeviceStep`) takes
        ``params=None`` and no process group; it then sets the device,
        ``attn_impl`` and ``moe_dispatch``.
    chaos: a :class:`~..resilience.ChaosMonkey` driven each tick (its
        ``ENGINE_FAULT_KINDS``): ``before_engine_tick`` at the top of
        :meth:`step`, ``perturb_engine_tokens`` on every fetched token
        row.  ``alloc_exhaust`` and ``table_corrupt`` are found and healed
        by the tick's audit, ``nan_logits`` by the token check; the
        co-batched requests are untouched.  ``slot_stall`` sleeps inside
        the tick: a ``watchdog`` escalates it.
    telemetry: an :class:`~..obs.Telemetry` — decode / verify calls
        become its steps (wrapped unless the device step sets
        ``wrap_steps = False``; prefill calls are not, as in the
        reference), and the engine's events land on its timeline.
    snapshot_every: a ``slots_snapshot`` event every N ticks (0: never).
    watchdog: a :class:`~..resilience.Watchdog`, beaten once a tick, so
        a wedged tick escalates to ``hang_suspected`` / abort.  The
        caller starts and stops it (a context manager).
    metrics_sink: any exporter sink (``write(record)``:
        :class:`~..obs.exporters.PrometheusTextfileSink`, ``JsonlSink``,
        ``MultiSink``); every ``metrics_every``-th tick writes a
        ``serving_metrics`` record (:data:`~.tracing.SERVING_METRICS_SCHEMA`).
        A sink's OSError is swallowed: the engine's work comes first.
    tick_history: bound on ``tick_records`` (oldest dropped first).

    ``hold_decode`` (an attribute, False by default) makes the engine a
    disaggregated prefill tier: decode ticks are skipped, so a slot that
    finishes prefill parks in DECODE until :meth:`export_slot` hands it
    to a decode engine.
    """

    def __init__(
        self,
        params: Any,
        cfg: GPTConfig,
        *,
        num_slots: int = 4,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        max_ctx: Optional[int] = None,
        chunk: int = 16,
        kv_quant: bool = False,
        max_queue: Optional[int] = None,
        prefix_cache: bool = False,
        attn_impl: str = "auto",
        moe_dispatch: Optional[str] = None,
        ep_group=None,
        cp_group=None,
        tp_group=None,
        dp_group=None,
        replica_group=None,
        spec_k: int = 0,
        device=None,
        device_step: Optional[Any] = None,
        chaos: Optional[Any] = None,
        telemetry: Optional[Any] = None,
        snapshot_every: int = 16,
        watchdog: Optional[Any] = None,
        metrics_sink: Optional[Any] = None,
        metrics_every: int = 1,
        tick_history: int = 4096,
        **queued: Any,
    ) -> None:
        unknown = set(queued) - set(_QUEUED_OPTIONS)
        if unknown:
            raise TypeError(f"unexpected engine options {sorted(unknown)}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        on = sorted(k for k, v in queued.items()
                    if v != _QUEUED_OPTIONS[k][0])
        cp = 1
        if cp_group is not None:
            cp = _check_cp(cfg, cp_group, chunk, num_blocks, kv_quant,
                           ep_group, dp_group, set(on)
                           | ({"spec_k"} if spec_k else set())
                           | ({"prefix_cache"} if prefix_cache else set()))
        if on:
            why = "; ".join(dict.fromkeys(
                m for k in on for m in _QUEUED_OPTIONS[k][1]))
            raise NotImplementedError(
                f"engine options {on} are not ported to the PyTorch engine "
                f"yet ({why})")
        if num_slots < 1 or chunk < 1 or block_size < 1:
            raise ValueError(
                f"num_slots/chunk/block_size must be >= 1, got "
                f"{num_slots}/{chunk}/{block_size}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 or None, got {max_queue}")
        if metrics_every < 1:
            raise ValueError(
                f"metrics_every must be >= 1, got {metrics_every}")
        if moe_dispatch is not None:
            if not cfg.moe_experts:
                raise ValueError(
                    "moe_dispatch is set but the model has no MoE layers "
                    "(cfg.moe_experts == 0)")
            if moe_dispatch not in ("gather", "cuda", "auto") and not (
                    ep_group is not None and moe_dispatch == "sorted"):
                raise ValueError(
                    f"engine moe_dispatch must be 'gather', 'cuda' or "
                    f"'auto' ('sorted' too with ep_group), got "
                    f"{moe_dispatch!r}")
        if ep_group is not None and not cfg.moe_experts:
            raise ValueError(
                "ep_group is set but the model has no MoE layers "
                "(cfg.moe_experts == 0)")
        self.cfg = cfg
        self.params = params
        self.num_slots = num_slots
        self.block_size = block_size
        self.chunk = chunk
        self.kv_quant = kv_quant
        self.max_queue = max_queue
        self.prefix_cache = bool(prefix_cache)
        self.spec_k = int(spec_k)
        #: disaggregated prefill tier: skip decode ticks, park slots in
        #: DECODE for export_slot (plain host scheduler state)
        self.hold_decode = False
        #: the run's Telemetry, or None; its timeline takes our events
        self.telemetry = telemetry
        self._ev: EventLog = (telemetry.events if telemetry is not None
                              else default_event_log())
        #: the fault-injection harness (resilience.ChaosMonkey) or None
        self.chaos = chaos
        self.snapshot_every = int(snapshot_every)
        self.watchdog = watchdog
        self.metrics_sink = metrics_sink
        self.metrics_every = int(metrics_every)
        self.tick_history = int(tick_history)

        if device_step is None:
            from .sim import TorchDeviceStep

            device_step = TorchDeviceStep(cfg, device, attn_impl,
                                          moe_dispatch, ep_group, cp_group,
                                          tp_group, dp_group, replica_group)
        elif getattr(device_step, "host_only", False) and any(
                g is not None for g in (ep_group, cp_group, tp_group,
                                        dp_group, replica_group)):
            raise ValueError(
                "a host-only DeviceStep cannot run over a process group")
        #: the device seam (serving/sim.py): every device touch goes here
        self.device_step = device_step
        # the decode and verify calls, as Telemetry steps when given one
        # (prefill calls the device step unwrapped, as the reference does)
        self._decode_fn, self._verify_fn = device_step.step, \
            device_step.verify
        if telemetry is not None and getattr(device_step, "wrap_steps",
                                             True):
            self._decode_fn = telemetry.wrap_step(self._decode_fn)
            self._verify_fn = telemetry.wrap_step(self._verify_fn)
        #: the expert-parallel group (None: every expert on this device)
        self.ep_group = ep_group
        #: the context-parallel group and its size (None / 1: the whole
        #: pool on this device)
        self.cp_group = cp_group
        self.cp = cp
        #: the tensor-parallel group and its size (None / 1: whole
        #: weights and every KV head on this device)
        self.tp_group = tp_group
        self.tp = 1 if tp_group is None else dist.get_world_size(tp_group)
        #: the data-parallel group and its size (None / 1: every slot on
        #: this replica)
        self.dp_group = dp_group
        self.dp = 1 if dp_group is None else dist.get_world_size(dp_group)
        if num_slots % self.dp:
            raise ValueError(
                f"num_slots {num_slots} not divisible by dp {self.dp}")
        self.slots_per_group = num_slots // self.dp
        #: any process group: the clock's decisions are refused
        self._grouped = any(g is not None for g in (
            ep_group, cp_group, tp_group, dp_group, replica_group))
        # the kernels this engine's step can launch
        # (a CP engine's attends all run the ring: K2, and K1 never — it
        # reports K1 too, to show it)
        attn = ["paged_decode_attention"] + (
            ["paged_carry_attention"] if cp_group is not None else [])
        self._launch_counts = [(_attn_ops.LAUNCHES, attn)] + (
            [(_moe_ops.LAUNCHES, list(_moe_ops.LAUNCHES))]
            if cfg.moe_experts else [])

        self.max_ctx = int(max_ctx if max_ctx is not None else cfg.max_seq)
        # spec slack: a verify step writes up to spec_k positions past the
        # committed length, so the table covers max_ctx + spec_k positions
        # (else the clamp in _scatter_positions folds an overshoot write
        # back onto a real block)
        self.max_blocks = -(-(self.max_ctx + self.spec_k) // block_size)
        if num_blocks is None:
            num_blocks = 1 + self.slots_per_group * self.max_blocks
            num_blocks = -(-num_blocks // cp) * cp  # shards evenly over cp
        #: pool blocks a data group (each CP rank holds num_blocks / cp
        #: of them)
        self.num_blocks = num_blocks
        #: one allocator a data group; slot i's is _allocs[i // spg]
        self._allocs = [BlockAllocator(num_blocks) for _ in range(self.dp)]
        device_step.bind(self)
        self.device = device_step.device
        self.attn_impl = device_step.attn_impl
        #: the resolved MoE dispatch ('cuda' | 'gather', or 'cuda' |
        #: 'sorted' under EP); None when dense
        self.moe_dispatch = device_step.moe_dispatch
        self.cache = device_step.init_cache(num_blocks, block_size, kv_quant)

        # host-visible device state, one row per slot
        V = cfg.vocab_size
        self._tables = np.zeros((num_slots, self.max_blocks), np.int32)
        self._lengths = np.zeros(num_slots, np.int32)
        self._last_tok = np.zeros(num_slots, np.int32)
        self._temps = np.zeros(num_slots, np.float32)
        self._top_k = np.full(num_slots, V, np.int32)
        self._top_p = np.ones(num_slots, np.float32)
        #: each slot's sampling stream (the device step's kind)
        self._streams: List[Any] = [None] * num_slots

        self._slots = [_SlotState() for _ in range(num_slots)]
        self.queue: List[Tuple[Request, float]] = []
        self._next_rid = 0
        self._seq: Dict[int, int] = {}  # rid -> FIFO age (survives requeue)
        self._inject: Dict[int, Dict[str, Any]] = {}  # resume state/prefix
        self._draining = False
        #: EWMA of the wall time of ticks that decoded, and of measured /
        #: estimated TTFT: measurement state, not reset by reset_metrics
        self._tick_ewma: Optional[float] = None
        self._ttft_bias: Optional[float] = None
        self._pending_cow: List[Tuple[int, int, int]] = []  # slot, src, dst
        # the tick being accounted: seconds by phase, the rids each
        # phase served, the tokens it emitted
        self._phase: Dict[str, float] = dict.fromkeys(TICK_PHASES, 0.0)
        self._tick_prefill_rids: List[int] = []
        self._tick_decode_rids: List[int] = []
        self._tick_emitted = 0
        self.reset_metrics()

    # ---------------------------------------------------------------- admission

    def _group(self, i: int) -> int:
        """The data group of slot ``i``."""
        return i // self.slots_per_group

    def _alloc_of(self, i: int) -> BlockAllocator:
        """The allocator of slot ``i``'s data group."""
        return self._allocs[i // self.slots_per_group]

    @property
    def _alloc(self) -> BlockAllocator:
        """The allocator of an engine with one data group."""
        if self.dp != 1:
            raise AttributeError(
                "a data-parallel engine keeps one allocator a group: "
                "_allocs[g]")
        return self._allocs[0]

    def _blocks_needed(self, req: Request) -> int:
        # + spec_k: a verify step writes drafts up to spec_k positions
        # past the committed length
        return -(-(len(req.tokens) + req.max_new_tokens + self.spec_k)
                 // self.block_size)

    def _prefix_hashes(self, tokens) -> List[Any]:
        return (chain_block_hashes(tokens, self.block_size)
                if self.prefix_cache else [])

    def _prefill_chunks(self, tokens) -> int:
        """Prefill ticks a prompt costs net of prefix-cache hits (a
        whole-prompt hit still recomputes its last token), so warm
        traffic is not shed on its cold estimate."""
        p_len = len(tokens)
        cached = 0
        if self.prefix_cache:
            hashes = self._prefix_hashes(tokens)
            if hashes:
                n_hit = max(len(a.match(hashes)) for a in self._allocs)
                cached = min(n_hit * self.block_size, p_len - 1)
        return -(-(p_len - cached) // self.chunk)

    def _queue_sort(self) -> None:
        """Priority order, FIFO within a class: the sort key is
        (-priority, submit age) and ages survive requeue, so a preempted
        request rejoins ahead of younger peers of its class."""
        self.queue.sort(key=lambda e: (-e[0].priority, self._seq[e[0].rid]))

    def _slo_row(self, priority: int) -> Dict[str, int]:
        """Per-priority SLO accumulator: completed / met / missed service
        and the refused demand (shed / expired), which attainment counts
        as misses."""
        return self._slo_by_prio.setdefault(int(priority), {
            "completed": 0, "met": 0, "missed": 0,
            "shed": 0, "expired": 0, "goodput_tokens": 0})

    def _resolve_ttft(self, rid: int, actual: float, priority: int) -> None:
        """Close one admission-time TTFT prediction: the calibration bias
        EWMA learns measured / raw estimate, and the relative error of the
        (biased) estimate admission used is recorded."""
        pred = self._ttft_pred.pop(rid, None)
        if pred is None or actual <= 0 or pred["raw"] <= 0:
            return
        ratio = actual / pred["raw"]
        self._ttft_bias = (ratio if self._ttft_bias is None
                           else 0.8 * self._ttft_bias + 0.2 * ratio)
        self._calib_n += 1
        self._calib_by_prio.setdefault(int(priority), []).append(
            abs(actual - pred["est"]) / actual)

    def estimate_ttft(self, prompt_len: int,
                      tokens: Optional[Sequence[int]] = None
                      ) -> Optional[float]:
        """Estimated seconds until a request of ``prompt_len`` submitted
        now samples its first token (JAX :883): its own prefill chunks,
        the queue's unstarted prefill work and, when every slot is busy,
        the ticks until the earliest busy slot can retire — times the
        EWMA of the ticks that decoded, times the calibration bias.  With
        the prefix cache on, resident chunks are subtracted (``tokens``
        given, and for every queued request).  None until a tick has been
        measured: an unmeasured engine admits everything."""
        if self._tick_ewma is None:
            return None
        if self.prefix_cache and tokens is not None:
            ticks = self._prefill_chunks(tokens)
        else:
            ticks = -(-prompt_len // self.chunk)
        for q, _t in self.queue:
            ticks += self._prefill_chunks(q.tokens)
        if not any(s.state == FREE for s in self._slots):
            remaining = []
            for s in self._slots:
                if s.state == FREE or s.req is None:
                    continue
                pre = (-(-(len(s.prompt) - s.off) // self.chunk)
                       if s.state == PREFILL else 0)
                remaining.append(
                    max(0, pre + s.req.max_new_tokens - len(s.generated)))
            if remaining:
                ticks += min(remaining)
        raw = ticks * self._tick_ewma
        return raw * (self._ttft_bias if self._ttft_bias is not None else 1.0)

    def _shed(self, req: Request, reason: str, **extra: Any) -> None:
        """Refuse admission with a verdict in ``self.rejected[rid]`` and
        a ``request_shed`` event."""
        verdict = {
            "rid": req.rid, "reason": reason, "priority": req.priority,
            "deadline_s": req.deadline_s, "queue_depth": len(self.queue),
            **extra,
        }
        self.rejected[req.rid] = verdict
        self._rejected_order.append(req.rid)
        self.stats["shed"] += 1
        self._slo_row(req.priority)["shed"] += 1
        self._ttft_pred.pop(req.rid, None)
        self._ev.emit("request_shed", **verdict)

    def submit(self, req: Request) -> int:
        """Enqueue; returns the request id.  Raises if the request can
        never fit the engine's context or pool.  A request the engine
        cannot afford now — queue at ``max_queue``, estimated TTFT past
        ``deadline_s``, engine draining — is shed: the rid is returned
        with its verdict in ``self.rejected[rid]``."""
        P, N = len(req.tokens), req.max_new_tokens
        need = self._blocks_needed(req)
        if P + N > self.max_ctx:
            raise ValueError(
                f"prompt {P} + max_new {N} exceeds max_ctx {self.max_ctx}")
        if need > self._allocs[0].n_usable:
            raise ValueError(
                f"request needs {need} blocks, pool has "
                f"{self._allocs[0].n_usable} per group")
        if self._grouped and req.deadline_s is not None:
            raise NotImplementedError(_CLOCK)
        if self.cfg.pos == "learned" and P + N > self.cfg.max_seq:
            raise ValueError(
                f"P + max_new_tokens = {P + N} exceeds the learned position "
                f"table ({self.cfg.max_seq})")
        req = dataclasses.replace(req, rid=self._next_rid)
        self._next_rid += 1
        self._seq[req.rid] = req.rid  # submit order IS the FIFO age
        t_submit = time.perf_counter()
        self._ev.emit(
            "request_submitted", rid=req.rid, prompt_len=int(P),
            max_new_tokens=int(N), priority=req.priority,
            deadline_s=req.deadline_s)
        # the admission model's prediction, kept for calibration: the
        # biased estimate is what the deadline gate trusts, the raw one
        # what the bias learns against
        est = self.estimate_ttft(P, tokens=req.tokens)
        if est is not None and est > 0:
            self._ttft_pred[req.rid] = {
                "est": est,
                "raw": est / (self._ttft_bias
                              if self._ttft_bias is not None else 1.0)}
        if self._draining:
            self._shed(req, "draining")
            return req.rid
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self._shed(req, "queue_full", max_queue=self.max_queue)
            return req.rid
        if (req.deadline_s is not None and est is not None
                and est > req.deadline_s):
            self._shed(req, "deadline_unmeetable", est_ttft_s=round(est, 6))
            return req.rid
        self.queue.append((req, t_submit))
        self._queue_sort()
        return req.rid

    def _expire_queue(self, now: float) -> int:
        """Drop queued requests whose TTFT deadline has passed."""
        keep, expired = [], 0
        for req, t_submit in self.queue:
            if req.deadline_s is not None and now - t_submit > req.deadline_s:
                expired += 1
                self.stats["expired"] += 1
                self._slo_row(req.priority)["expired"] += 1
                verdict = {
                    "rid": req.rid, "reason": "expired",
                    "priority": req.priority, "deadline_s": req.deadline_s,
                    "waited_s": round(now - t_submit, 6)}
                self.rejected[req.rid] = verdict
                self._rejected_order.append(req.rid)
                self._inject.pop(req.rid, None)
                self._ttft_pred.pop(req.rid, None)
                self._ev.emit("request_expired", **verdict)
            else:
                keep.append((req, t_submit))
        self.queue = keep
        return expired

    def _pick_victim(self, req: Request) -> Optional[int]:
        """The slot to evict so ``req`` can run: lowest priority strictly
        below ``req``'s; among equals the most recently admitted."""
        best = None
        for i, s in enumerate(self._slots):
            if s.state == FREE or s.req is None:
                continue
            if s.req.priority >= req.priority:
                continue
            key = (s.req.priority, -s.t_admit)
            if best is None or key < best[0]:
                best = (key, i)
        return None if best is None else best[1]

    def _preempt(self, i: int, by: Request) -> None:
        s = self._slots[i]
        self.stats["preempted"] += 1
        self._ev.emit(
            "request_preempted", rid=s.rid, slot=i,
            priority=s.req.priority, by_rid=by.rid, by_priority=by.priority,
            discarded_tokens=len(s.generated), blocks_freed=len(s.blocks))
        self._requeue_slot(i)

    def _requeue_slot(self, i: int) -> int:
        """Evict slot ``i`` back to the queue at its original FIFO age:
        blocks released refcount-aware (tolerantly: a poisoned slot's
        ownership may be inconsistent), output discarded, the prompt
        replayed later from the request's seed (or its injected stream
        state), so the final tokens equal the uninterrupted run's."""
        s = self._slots[i]
        rid, req, t_submit = s.rid, s.req, s.t_submit
        self._release_blocks(self._alloc_of(i), s.blocks)
        self._clear_slot_rows(i)
        s.reset()
        # the prediction's premise was undone by scheduling, not by a
        # misestimate: drop it rather than teach the bias
        self._ttft_pred.pop(rid, None)
        self.queue.append((req, t_submit))
        self._queue_sort()
        return rid

    @staticmethod
    def _release_blocks(alloc: BlockAllocator, blocks: List[int]) -> None:
        """Release a slot's blocks one by one, refcount-aware: ``free``
        decrements (a co-owner keeps a shared block), and only a block
        ``free`` refuses (an inconsistency a fault made) is reclaimed."""
        for b in blocks:
            try:
                alloc.free([b])
            except ValueError:
                alloc.reclaim([b])

    def _clear_slot_rows(self, i: int) -> None:
        self._tables[i] = 0
        self._lengths[i] = 0
        self._last_tok[i] = 0
        self._temps[i] = 0.0
        self._top_k[i] = self.cfg.vocab_size
        self._top_p[i] = 1.0
        self._streams[i] = None

    def _free_slots_by_group(self) -> List[int]:
        """The first free slot of each data group, in slot order: every
        slot of a group shares its allocator, so a request that fails
        for one free slot of a group fails for all of them."""
        out, seen = [], set()
        for i, s in enumerate(self._slots):
            if s.state == FREE and self._group(i) not in seen:
                seen.add(self._group(i))
                out.append(i)
        return out

    @staticmethod
    def _claim_blocks(alloc: BlockAllocator, hit: List[int], pin: List[int],
                      n_fresh: int) -> Optional[List[int]]:
        """Share the resident blocks ``hit`` (refcount + 1 each), pin
        ``pin`` while ``n_fresh`` fresh blocks are allocated (eviction must
        not take it), then unpin; when the allocation fails every share
        is reverted, so nothing is half admitted.  Returns the fresh
        blocks or None."""
        for b in hit + pin:
            alloc.share(b)
        fresh = alloc.alloc(n_fresh)
        if fresh is None:
            for b in hit:
                alloc.free([b])
        for b in pin:
            alloc.free([b])
        return fresh

    def _try_place(self, req: Request):
        """A free slot and blocks for ``req`` (JAX :1092), as ``(slot,
        shared, cow_src, fresh)``, or None (back-pressure): the first
        free slot whose data group's pool can cover it.  With the prefix
        cache on, the longest resident prefix of the prompt's full blocks
        in that group is shared and only the rest allocated; a
        whole-prompt hit keeps all but its last block and copy-on-writes
        that one (the last token's logits are recomputed, and its write
        may not land in a block others read), its source pinned while
        the fresh blocks are allocated.  The copy is enqueued before the
        next device call."""
        hashes = self._prefix_hashes(req.tokens)
        for i in self._free_slots_by_group():
            alloc = self._alloc_of(i)
            hit = alloc.match(hashes) if hashes else []
            cow_src = None
            if hit and len(hit) * self.block_size >= len(req.tokens):
                cow_src, hit = hit[-1], hit[:-1]
            fresh = self._claim_blocks(
                alloc, hit, [] if cow_src is None else [cow_src],
                self._blocks_needed(req) - len(hit))
            if fresh is not None:
                return i, hit, cow_src, fresh
        return None

    def _admit(self) -> int:
        """Priority admission: the head of the queue takes the first free
        slot it can be placed in (:meth:`_try_place`).  When it cannot be
        placed, the lowest-priority running slot strictly below it is
        preempted and admission retries; head-of-line blocking within a
        class is deliberate (skipping ahead would starve long
        requests)."""
        admitted = 0
        while self.queue:
            req, t_submit = self.queue[0]
            P, N = len(req.tokens), req.max_new_tokens
            need = self._blocks_needed(req)
            placed = self._try_place(req)
            if placed is None:
                victim = self._pick_victim(req)
                if victim is None:
                    break
                self._preempt(victim, req)
                continue  # blocks and/or a slot freed: retry the head
            self.queue.pop(0)
            i, shared, cow_src, fresh = placed
            evicted = self._alloc_of(i).pop_evicted()
            blocks = shared + fresh
            s = self._slots[i]
            s.state, s.rid, s.req, s.blocks = PREFILL, req.rid, req, blocks
            s.prompt = np.asarray(req.tokens, np.int32)
            # chunked prefill starts after the cached boundary (a COW
            # admission recomputes only the last prompt token)
            s.off = (P - 1) if cow_src is not None else (
                len(shared) * self.block_size)
            s.generated = []
            s.t_submit, s.t_admit = t_submit, time.perf_counter()
            s.ttft_s, s.tpot_s = None, []
            s.orig_prompt_len, s.pre_gen = P, 0
            self._tables[i] = 0
            self._tables[i, :need] = blocks
            self._lengths[i] = 0
            if evicted:
                self.stats["cache_evictions"] += len(evicted)
                self._ev.emit("cache_evict", tick=self._tick,
                              n_blocks=len(evicted), group=self._group(i))
            if self.prefix_cache:
                self.stats["prefix_prompt_tokens"] += P
            if s.off:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_cached_tokens"] += int(s.off)
                self._ev.emit(
                    "prefix_hit", rid=req.rid, slot=i,
                    blocks=len(shared) + (1 if cow_src is not None else 0),
                    cached_tokens=int(s.off), cow=cow_src is not None)
            if cow_src is not None:
                self._pending_cow.append((i, int(cow_src), int(fresh[0])))
                self.stats["cow_copies"] += 1
                self._ev.emit("block_cow", rid=req.rid, slot=i,
                              src_block=int(cow_src),
                              dst_block=int(fresh[0]))
            self._temps[i] = req.temperature
            self._top_k[i] = (req.top_k if req.top_k is not None
                              else self.cfg.vocab_size)
            self._top_p[i] = req.top_p if req.top_p is not None else 1.0
            self._streams[i] = self.device_step.stream(req.seed)
            inj = self._inject.get(req.rid)
            if inj is not None:
                # drain/resume: the admitted prompt carries the emitted
                # prefix; the carried stream state continues the stream
                if inj.get("key") is not None:
                    self._streams[i] = self.device_step.restore_stream(
                        inj["key"])
                s.orig_prompt_len = int(inj["orig_prompt_len"])
                s.pre_gen = int(inj["pre_gen"])
            self._ev.emit(
                "request_admitted", rid=req.rid, slot=i, prompt_len=int(P),
                max_new_tokens=int(N), blocks=need, priority=req.priority,
                queue_wait_s=round(s.t_admit - t_submit, 6))
            admitted += 1
        self._apply_cow()
        return admitted

    def _apply_cow(self) -> None:
        """This admission wave's copy-on-writes as one block copy of
        fixed-width lanes (``[num_slots]``, NULL-padded), enqueued on the
        pool's stream before the next prefill call writes the copied
        block — the stream orders them; nothing is read back."""
        if not self._pending_cow:
            return
        src = np.zeros(self.num_slots, np.int32)
        dst = np.zeros(self.num_slots, np.int32)
        for slot, s_blk, d_blk in self._pending_cow:
            src[slot], dst[slot] = s_blk, d_blk
        self._pending_cow.clear()
        self.cache = self.device_step.cow(self.cache, src, dst)
        self._cow_sigs.add(("cow", self.num_slots))

    # -------------------------------------------------------------------- ticks

    def _masked(self, state: str):
        """Table rows of slots NOT in ``state`` zeroed (the NULL block), so
        a phase's step never touches another phase's blocks."""
        m = np.array([s.state == state for s in self._slots], bool)
        t = np.where(m[:, None], self._tables, 0).astype(np.int32)
        return m, t

    def _samp(self) -> Dict[str, np.ndarray]:
        return {"temperature": self._temps, "top_k": self._top_k,
                "top_p": self._top_p}

    def _sig(self, tokens: np.ndarray) -> tuple:
        return (tokens.shape, str(tokens.dtype), self.num_slots,
                self.max_blocks)

    def _charge(self, phase: str, t_disp: float) -> float:
        """Charge a device call that began at ``t_disp`` and has returned:
        its enqueue, up to the step's ``t_enqueued`` mark (set just before
        its one read-back), to ``phase``; returns the mark, where the
        ``fetch`` phase starts.  A step without a mark inside the call (a
        stub) charges the whole call to ``phase``."""
        t_ret = time.perf_counter()
        mark = getattr(self.device_step, "t_enqueued", None)
        split = mark if mark is not None and t_disp <= mark <= t_ret \
            else t_ret
        self._phase[phase] += split - t_disp
        return split

    def _token_poisoned(self, tok: int) -> bool:
        """An out-of-range token is the host-visible face of a poisoned
        logit row."""
        return not (0 <= tok < self.cfg.vocab_size)

    def _poisoned_token_recover(self, i: int, tok: int) -> None:
        s = self._slots[i]
        self.stats["faults_detected"] += 1
        self._ev.emit("engine_fault_detected", fault="invalid_token", slot=i,
                      rid=s.rid, token=int(tok), tick=self._tick)
        rid = self._requeue_slot(i)
        self.stats["faults_healed"] += 1
        self._ev.emit("engine_recovered", fault="invalid_token", slot=i,
                      rid=rid, action="requeued", tick=self._tick)

    def _prefill_tick(self) -> int:
        """One ``chunk``-token slice for EVERY prefilling slot, batched in
        one call.  Slots whose slice covers the last prompt row sample
        their first token (TTFT), register their full prompt blocks in
        the prefix index, and move to DECODE."""
        mask, tables = self._masked(PREFILL)
        if not mask.any():
            return 0
        B, C = self.num_slots, self.chunk
        tokens = np.zeros((B, C), np.int32)
        offsets = np.zeros(B, np.int32)
        last_idx = np.zeros(B, np.int32)
        streams: List[Any] = [None] * B
        for i, s in enumerate(self._slots):
            if s.state != PREFILL:
                continue
            sl = s.prompt[s.off:s.off + C]
            tokens[i, :len(sl)] = sl
            offsets[i] = s.off
            last_idx[i] = min(len(s.prompt) - 1 - s.off, C - 1)
            if s.off + C >= len(s.prompt):
                streams[i] = self._streams[i]  # final slice: emits a token
        t_disp = time.perf_counter()
        self.cache, tok, moe = self.device_step.step(
            self.params, self.cache, tokens, tables, offsets, last_idx,
            self._samp(), streams)
        split = self._charge("prefill", t_disp)
        self._absorb_moe_stats(moe)
        self._prefill_sigs.add(("prefill",) + self._sig(tokens))
        self._phase["fetch"] += time.perf_counter() - split
        if self.chaos is not None:
            tok = self.chaos.perturb_engine_tokens(self._tick, tok)
        now = time.perf_counter()
        rids = []
        for i, s in enumerate(self._slots):
            if s.state != PREFILL:
                continue
            rids.append(s.rid)
            s.off += C
            if s.off >= len(s.prompt):  # final slice: first token sampled
                if self._token_poisoned(int(tok[i])):
                    self._poisoned_token_recover(i, int(tok[i]))
                    continue
                s.state = DECODE
                if self.prefix_cache:
                    # every full prompt block is written now: bind it to
                    # its chain hash (first registration wins; a COW copy
                    # of a registered block stays unregistered)
                    for bh, blk in zip(
                            chain_block_hashes(s.prompt, self.block_size),
                            s.blocks):
                        self._alloc_of(i).register(blk, bh)
                s.ttft_s = now - s.t_submit
                self._resolve_ttft(s.rid, s.ttft_s, int(s.req.priority))
                s.t_last = now
                self._lengths[i] = len(s.prompt)
                self._last_tok[i] = tok[i]
                s.generated.append(int(tok[i]))
                self._tick_emitted += 1
                self._maybe_retire(i, int(tok[i]), now)
        self.stats["prefill_chunks"] += 1
        self._tick_prefill_rids = rids
        self._ev.emit("prefill_chunk", rids=rids, chunk=C, n_slots=len(rids))
        if self.cp > 1:
            # the modeled ring traffic of the chunk from each rank (host
            # math, ops/ring_paged.py; a rank's Hkv / tp heads under TP);
            # the ring's own counter is RING_PAYLOADS
            from ..ops.ring_paged import ring_chunk_bytes, ring_hops_per_chunk

            hops = ring_hops_per_chunk(self.cfg.nlayers, self.cp)
            bts = ring_chunk_bytes(
                nlayers=self.cfg.nlayers, cp=self.cp, batch=self.num_slots,
                kv_heads=self.cfg.block.kv_head_count // self.tp,
                head_dim=self.cfg.block.head_dim, chunk=C,
                nb_local=self.num_blocks // self.cp,
                block_size=self.block_size,
                itemsize=torch.empty((), dtype=self.cfg.dtype).element_size())
            self.stats["cp_ring_hops"] += hops
            self.stats["cp_ring_bytes"] += bts
            self._ev.emit("cp_prefill_chunk", rids=rids, chunk=C, cp=self.cp,
                          sub_chunk=C // self.cp)
            self._ev.emit("cp_ring_hop", tick=self._tick, hops=hops,
                          bytes=bts)
        return len(rids)

    def _decode_tick(self) -> int:
        if self.hold_decode:
            # disaggregated prefill tier: parked slots wait for export_slot
            return 0
        if self.spec_k:
            return self._spec_decode_tick()
        mask, tables = self._masked(DECODE)
        n_active = int(mask.sum())
        if n_active == 0:
            return 0
        tokens = np.where(mask, self._last_tok, 0).astype(np.int32)[:, None]
        offsets = np.where(mask, self._lengths, 0).astype(np.int32)
        last_idx = np.zeros(self.num_slots, np.int32)
        streams = [g if m else None for g, m in zip(self._streams, mask)]
        self._tick_decode_rids = [
            s.rid for s in self._slots if s.state == DECODE]
        t_disp = time.perf_counter()
        self.cache, tok, moe = self._decode_fn(
            self.params, self.cache, tokens, tables, offsets, last_idx,
            self._samp(), streams)
        split = self._charge("decode", t_disp)
        if self.telemetry is not None:
            self.telemetry.end_step(active_slots=n_active)
        self._absorb_moe_stats(moe)
        self._decode_sigs.add(("decode",) + self._sig(tokens))
        self._phase["fetch"] += time.perf_counter() - split
        if self.chaos is not None:
            tok = self.chaos.perturb_engine_tokens(self._tick, tok)
        now = time.perf_counter()
        for i, s in enumerate(self._slots):
            if s.state != DECODE:
                continue
            if self._token_poisoned(int(tok[i])):
                self._poisoned_token_recover(i, int(tok[i]))
                continue
            self._lengths[i] += 1
            self._last_tok[i] = tok[i]
            s.generated.append(int(tok[i]))
            self._tick_emitted += 1
            s.tpot_s.append(now - s.t_last)
            s.t_last = now
            self._maybe_retire(i, int(tok[i]), now)
        self.stats["decode_steps"] += 1
        self.stats["decode_slot_steps"] += n_active
        return n_active

    # ------------------------------------------------------ speculative decode

    def _draft(self, s: _SlotState) -> List[int]:
        """The host-side n-gram drafter (JAX :1417): the ``spec_k`` tokens
        that followed the most recent earlier occurrence of the slot's
        last bigram in its own history (prompt + generated, the last 256
        tokens), else of its last unigram, padded by repeating the last
        token.  A bad draft costs only acceptance."""
        hist = (list(int(t) for t in s.prompt) + s.generated)[-256:]
        K = self.spec_k
        cand: Optional[List[int]] = None
        if len(hist) >= 3:
            a, b = hist[-2], hist[-1]
            for j in range(len(hist) - 3, -1, -1):
                if hist[j] == a and hist[j + 1] == b:
                    cand = hist[j + 2:j + 2 + K]
                    break
        if not cand:
            last = hist[-1]
            for j in range(len(hist) - 2, -1, -1):
                if hist[j] == last:
                    cand = hist[j + 1:j + 1 + K]
                    break
        cand = list(cand or [])
        while len(cand) < K:
            cand.append(cand[-1] if cand else hist[-1])
        return cand[:K]

    def _spec_decode_tick(self) -> int:
        """The speculative decode tick (JAX :1445): K drafts a decoding
        slot, one verify call over the K+1 positions, then the host walks
        the accept bits — the accepted prefix plus the model's correction
        (or the bonus token when every draft survives) advance the slot;
        a rejection needs no rollback (the stale tail is overwritten
        before it is attended).  1..K+1 tokens a slot a tick, at one
        decode signature."""
        mask, tables = self._masked(DECODE)
        n_active = int(mask.sum())
        if n_active == 0:
            return 0
        K = self.spec_k
        tokens = np.zeros((self.num_slots, K + 1), np.int32)
        offsets = np.where(mask, self._lengths, 0).astype(np.int32)
        t_draft = time.perf_counter()
        rids = []
        for i, s in enumerate(self._slots):
            if s.state != DECODE:
                continue
            rids.append(s.rid)
            tokens[i, 0] = self._last_tok[i]
            tokens[i, 1:] = self._draft(s)
        self._phase["draft"] += time.perf_counter() - t_draft
        self._tick_decode_rids = rids
        self._ev.emit("spec_draft", k=K, n_slots=len(rids), rids=rids)
        streams = [g if m else None for g, m in zip(self._streams, mask)]
        t_disp = time.perf_counter()
        self.cache, verify, accept = self._verify_fn(
            self.params, self.cache, tokens, tables, offsets, self._samp(),
            streams)
        split = self._charge("decode", t_disp)
        if self.telemetry is not None:
            self.telemetry.end_step(active_slots=n_active)
        self._decode_sigs.add(("decode",) + self._sig(tokens))
        self._phase["fetch"] += time.perf_counter() - split
        if self.chaos is not None:
            verify = self.chaos.perturb_engine_tokens(self._tick, verify)
        now = time.perf_counter()
        emitted_total = accepted_total = 0
        for i, s in enumerate(self._slots):
            if s.state != DECODE:
                continue
            emitted: List[int] = []
            for j in range(K):
                if accept[i, j]:
                    emitted.append(int(tokens[i, j + 1]))
                else:
                    emitted.append(int(verify[i, j]))
                    break
            else:
                emitted.append(int(verify[i, K]))
            self.stats["spec_drafted"] += K
            bad = [t for t in [int(verify[i, 0])] + emitted
                   if self._token_poisoned(t)]
            if bad:
                self._poisoned_token_recover(i, bad[0])
                continue
            req = s.req
            took, done, reason = 0, False, "max_tokens"
            for t in emitted:
                s.generated.append(t)
                took += 1
                if req.eos_id is not None and t == req.eos_id:
                    done, reason = True, "eos"
                    break
                if len(s.generated) >= req.max_new_tokens:
                    done = True
                    break
            self.stats["spec_accepted"] += took - 1
            accepted_total += took - 1
            emitted_total += took
            self._tick_emitted += took
            self._lengths[i] += took
            self._last_tok[i] = s.generated[-1]
            s.tpot_s.extend([(now - s.t_last) / took] * took)
            s.t_last = now
            if done:
                self._finish_slot(i, reason, now)
        self._ev.emit("spec_verify", k=K, n_slots=len(rids),
                      emitted=emitted_total, accepted=accepted_total)
        self.stats["decode_steps"] += 1
        self.stats["decode_slot_steps"] += n_active
        return n_active

    # --------------------------------------------------------------- retirement

    def _maybe_retire(self, i: int, tok: int, now: float) -> None:
        s = self._slots[i]
        req = s.req
        done_eos = req.eos_id is not None and tok == req.eos_id
        # req.max_new_tokens is the budget left at THIS admission (a
        # resumed request's total lives in its descriptor)
        done_len = len(s.generated) >= req.max_new_tokens
        if done_eos or done_len:
            self._finish_slot(i, "eos" if done_eos else "max_tokens", now)

    def _finish_slot(self, i: int, reason: str, now: float) -> None:
        """Terminal slot exit (EOS / max-token / cancel): record, release
        the blocks (a shared block decrements), reset — the same tick.
        Only completed requests feed the latency percentiles and the
        SLO rows."""
        s = self._slots[i]
        completed = reason in ("eos", "max_tokens")
        new_tokens = s.pre_gen + len(s.generated)
        self._finished_order.append(s.rid)
        self.finished[s.rid] = {
            "rid": s.rid,
            "tokens": np.concatenate(
                [s.prompt, np.asarray(s.generated, np.int32)]),
            "prompt_len": int(s.orig_prompt_len),
            "new_tokens": new_tokens,
            "reason": reason,
            "priority": int(s.req.priority),
            "resumed": s.pre_gen > 0,
            "ttft_s": s.ttft_s,
            "tpot_s": list(s.tpot_s),
            "t_submit": s.t_submit,
            "t_done": now,
        }
        self._inject.pop(s.rid, None)
        self._ttft_pred.pop(s.rid, None)
        if completed:
            self._ttfts.append(s.ttft_s)
            self._tpots.extend(s.tpot_s)
            prio = int(s.req.priority)
            if s.ttft_s is not None:
                self._ttfts_by_prio.setdefault(prio, []).append(s.ttft_s)
            self._tpots_by_prio.setdefault(prio, []).extend(s.tpot_s)
            # a request without a deadline meets by definition; only
            # deadline-meeting service counts as goodput
            met = (s.req.deadline_s is None
                   or (s.ttft_s is not None
                       and s.ttft_s <= s.req.deadline_s))
            row = self._slo_row(prio)
            row["completed"] += 1
            row["met" if met else "missed"] += 1
            if met:
                row["goodput_tokens"] += len(s.generated)
            self.stats["generated_tokens"] += len(s.generated)
            self._t_first = min(self._t_first, s.t_submit)
            self._t_last_done = max(self._t_last_done, now)
            self._ev.emit(
                "request_retired", rid=s.rid, slot=i, reason=reason,
                new_tokens=new_tokens, priority=prio,
                ttft_s=round(s.ttft_s, 6) if s.ttft_s is not None else None)
        else:
            self.stats["cancelled"] += 1
            self._ev.emit(
                "request_cancelled", rid=s.rid, slot=i, where="slot",
                emitted_tokens=new_tokens, blocks_freed=len(s.blocks))
        self._alloc_of(i).free(s.blocks)
        self._clear_slot_rows(i)
        s.reset()

    def cancel(self, rid: int) -> bool:
        """Retire request ``rid`` wherever it is — queued (removed, no
        service) or in flight (slot retired, its blocks released this
        tick, a shared block only decremented, the partial output kept in
        ``finished[rid]`` with reason ``cancelled``).  Returns False when
        the rid is unknown or already terminal."""
        for idx, (req, t_submit) in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[idx]
                self.stats["cancelled"] += 1
                self._finished_order.append(rid)
                self.finished[rid] = {
                    "rid": rid,
                    "tokens": np.asarray(req.tokens, np.int32),
                    "prompt_len": len(req.tokens),
                    "new_tokens": 0,
                    "reason": "cancelled",
                    "priority": int(req.priority),
                    "resumed": False,
                    "ttft_s": None,
                    "tpot_s": [],
                    "t_submit": t_submit,
                    "t_done": time.perf_counter(),
                }
                self._inject.pop(rid, None)
                self._ttft_pred.pop(rid, None)
                self._ev.emit("request_cancelled", rid=rid, where="queued",
                              emitted_tokens=0, blocks_freed=0)
                return True
        for i, s in enumerate(self._slots):
            if s.state != FREE and s.rid == rid:
                self._finish_slot(i, "cancelled", time.perf_counter())
                return True
        return False

    # ------------------------------------------------------------ invariant audit

    def audit(self, heal: bool = True) -> Dict[str, Any]:
        """Per-tick block-conservation check, per data group (JAX :1647):
        every active slot's table row equals its owned blocks (padded with
        NULL), every owned block is live in its group's allocator with
        refcount-weighted ownership (as many of the group's slots
        reference a block as its refcount says), no in-use block is
        orphaned, inactive rows are all-NULL, and unique in-use + cached
        + free == usable.  ``heal=True`` requeues poisoned slots, reclaims
        orphans and zeroes stale rows, bracketed by
        ``engine_fault_detected`` / ``engine_recovered`` events.  Pure
        host arithmetic.  A violation names its ``group`` when the engine
        has more than one."""
        violations: List[Dict[str, Any]] = []
        poisoned: List[int] = []
        stale_rows: List[int] = []
        orphans: Dict[int, List[int]] = {}
        tag = (lambda g: {"group": g}) if self.dp > 1 else (lambda g: {})
        for g, alloc in enumerate(self._allocs):
            lo, hi = g * self.slots_per_group, (g + 1) * self.slots_per_group
            owned_lists = []
            for i in range(lo, hi):
                s = self._slots[i]
                row = self._tables[i]
                if s.state == FREE:
                    if row.any():
                        violations.append(
                            {"kind": "stale_table_row", "slot": i})
                        stale_rows.append(i)
                    continue
                owned_lists.append(s.blocks)
                want = np.zeros(self.max_blocks, np.int32)
                want[:len(s.blocks)] = s.blocks
                if not np.array_equal(row, want):
                    violations.append({
                        "kind": "table_mismatch", "slot": i, "rid": s.rid,
                        "row": row.tolist(), "owned": list(s.blocks)})
                    poisoned.append(i)
            rep = alloc.audit(owned_lists)
            for b in rep["shared"]:
                refs = [i for i in range(lo, hi)
                        if b in self._slots[i].blocks]
                violations.append({"kind": "shared_block", "block": int(b),
                                   **tag(g), "slots": refs})
                poisoned.extend(i for i in refs if i not in poisoned)
            if rep["orphaned"]:
                violations.append({"kind": "orphaned_blocks", **tag(g),
                                   "blocks": rep["orphaned"]})
                orphans[g] = rep["orphaned"]
            for b in rep["unknown"]:
                violations.append({"kind": "unowned_block", **tag(g),
                                   "block": int(b)})
                poisoned.extend(i for i in range(lo, hi)
                                if b in self._slots[i].blocks
                                and i not in poisoned)
            if not rep["conserved"]:
                violations.append({
                    "kind": "conservation", **tag(g), "in_use": rep["in_use"],
                    "n_free": rep["n_free"], "n_usable": alloc.n_usable})
        if violations and heal:
            self.stats["faults_detected"] += len(violations)
            self._ev.emit(
                "engine_fault_detected", fault="invariant_audit",
                tick=self._tick, n_violations=len(violations),
                kinds=sorted({v["kind"] for v in violations}),
                slots=sorted(poisoned))
            requeued = [self._requeue_slot(i) for i in sorted(poisoned)]
            for i in stale_rows:
                self._tables[i] = 0
            reclaimed = sum(len(self._allocs[g].reclaim(blocks))
                            for g, blocks in orphans.items())
            self.stats["faults_healed"] += len(violations)
            self._ev.emit(
                "engine_recovered", fault="invariant_audit",
                tick=self._tick, requeued_rids=requeued,
                blocks_reclaimed=reclaimed)
        return {"ok": not violations, "violations": violations}

    # -------------------------------------------------------------- public API

    @property
    def n_busy(self) -> int:
        return sum(s.state != FREE for s in self._slots)

    def step(self) -> Dict[str, int]:
        """One engine tick, in the reference's order: the chaos hook ->
        invariant audit (heal) -> queue expiry -> admit (with preemption
        and the copy-on-write) -> one prefill slice -> one decode step.
        A tick that decoded updates the tick-time EWMA ``estimate_ttft``
        reads.  The tick is accounted by phase (:meth:`_record_tick`),
        the watchdog beaten.  Returns what happened (all zeros = idle)."""
        t0 = time.perf_counter()
        self._tick += 1
        self._phase = dict.fromkeys(TICK_PHASES, 0.0)
        self._tick_prefill_rids = []
        self._tick_decode_rids = []
        self._tick_emitted = 0
        if self.chaos is not None:
            self.chaos.before_engine_tick(self._tick, self)
        self.stats["audits"] += 1
        t = time.perf_counter()
        self.audit(heal=True)
        self._phase["audit"] += time.perf_counter() - t
        t = time.perf_counter()
        expired = self._expire_queue(time.perf_counter())
        admitted = self._admit()
        self._phase["sched"] += time.perf_counter() - t
        prefilled = self._prefill_tick()
        decoded = self._decode_tick()
        busy = self.n_busy
        self._occ_sum += busy / self.num_slots
        util = float(np.mean([a.utilization() for a in self._allocs]))
        self._util_sum += util
        self._occ_ticks += 1
        if self.snapshot_every and self._tick % self.snapshot_every == 0:
            self._ev.emit(
                "slots_snapshot", tick=self._tick, busy=busy,
                queued=len(self.queue), pool_utilization=round(util, 4))
        if self.watchdog is not None:
            self.watchdog.beat(self._tick)
        t_end = time.perf_counter()
        if decoded:
            dt = t_end - t0
            self._tick_ewma = (dt if self._tick_ewma is None
                               else 0.8 * self._tick_ewma + 0.2 * dt)
        self._record_tick(t0, t_end, admitted=admitted, expired=expired,
                          prefilled=prefilled, decoded=decoded, busy=busy,
                          util=util)
        return {"admitted": admitted, "prefill_slots": prefilled,
                "decode_slots": decoded, "busy": busy, "expired": expired}

    def _record_tick(self, t_start: float, t_end: float, *, admitted: int,
                     expired: int, prefilled: int, decoded: int, busy: int,
                     util: float) -> None:
        """The tick's accounting record (JAX :1806): the phase split (the
        residual ``host`` is what the named phases did not cover — queue
        sorts, table rewrites, retirement walks) and the tick's gauges.
        Appended to ``tick_records``, emitted as an ``engine_tick`` event
        when the tick did work (idle polls stay off the timeline), and
        written to ``metrics_sink`` every ``metrics_every`` ticks."""
        st = self.stats
        named = sum(self._phase[k] for k in TICK_PHASES if k != "host")
        phases = {k: round(self._phase[k], 9)
                  for k in TICK_PHASES if k != "host"}
        phases["host"] = round(max(0.0, (t_end - t_start) - named), 9)
        rec = {
            "tick": self._tick,
            "t_start": t_start,
            "t_end": t_end,
            "tick_s": round(t_end - t_start, 9),
            "phases": phases,
            "queue_depth": len(self.queue),
            "busy": busy,
            "admitted": admitted,
            "expired": expired,
            "prefill_slots": prefilled,
            "decode_slots": decoded,
            "batch_util": round(decoded / self.num_slots, 4),
            "pool_util": round(util, 4),
            "emitted_tokens": self._tick_emitted,
            "prefix_hit_rate": round(
                st["prefix_cached_tokens"] / st["prefix_prompt_tokens"], 4)
            if st["prefix_prompt_tokens"] else 0.0,
            "spec_accept_rate": round(
                st["spec_accepted"] / st["spec_drafted"], 4)
            if st["spec_drafted"] else 0.0,
        }
        self.tick_records.append(rec)
        if admitted or expired or prefilled or decoded or busy or self.queue:
            self._ev.emit(
                "engine_tick", spec=bool(self.spec_k),
                prefill_rids=list(self._tick_prefill_rids),
                decode_rids=list(self._tick_decode_rids), **rec)
        if (self.metrics_sink is not None
                and self._tick % self.metrics_every == 0):
            try:
                self.metrics_sink.write(serving_metrics_record(rec))
            except OSError:
                pass  # a full disk / read-only path: serving comes first

    def run_until_idle(self, max_ticks: int = 100_000,
                       stop: Optional[Any] = None,
                       persist_path: Optional[str] = None) -> None:
        """Drain the queue and every in-flight slot.  ``stop`` is a
        :class:`~..utils.preemption.GracefulShutdown` (or anything with a
        ``requested`` flag): when it trips, the engine :meth:`drain`\\ s
        (to ``persist_path`` when given) instead of finishing."""
        while self.queue or self.n_busy:
            if stop is not None and getattr(stop, "requested", False):
                self.drain(persist_path=persist_path)
                return
            self.step()
            if self._tick > max_ticks:
                raise RuntimeError(
                    f"engine did not drain within {max_ticks} ticks "
                    f"(queued={len(self.queue)}, busy={self.n_busy})")

    # ----------------------------------------------------------- drain / resume

    def _group_key(self, i: int) -> Dict[str, int]:
        """``{'group': g}`` of slot ``i`` on an engine with more than one
        data group (a descriptor names where the slot's blocks were); {}
        on one."""
        return {"group": self._group(i)} if self.dp > 1 else {}

    def _descriptor(self, req: Request, *, emitted: Sequence[int],
                    key: Optional[List[int]], orig_prompt_len: int,
                    pre_gen: int, **extra: Any) -> Dict[str, Any]:
        """One restartable request descriptor (JAX :1881): the original
        prompt, every token emitted so far, the original budget, the
        sampling parameters and ``key``, the state of the stream that
        samples the next token (None: start from the seed)."""
        prompt = [int(t) for t in req.tokens]
        pre = prompt[orig_prompt_len:]
        return {
            "prompt": prompt[:orig_prompt_len],
            "emitted": [int(t) for t in pre] + [int(t) for t in emitted],
            "max_new_tokens": int(req.max_new_tokens) + pre_gen,
            "temperature": float(req.temperature),
            "top_k": req.top_k,
            "top_p": req.top_p,
            "eos_id": req.eos_id,
            "seed": int(req.seed),
            "priority": int(req.priority),
            "deadline_s": req.deadline_s,
            "orig_rid": int(req.rid),
            "key": None if key is None else [int(v) for v in key],
            **extra,
        }

    def _queued_descriptor(self, req: Request) -> Dict[str, Any]:
        """A queued request's descriptor: no emitted tokens of this
        engine; an injected prefix and stream state travel on."""
        inj = self._inject.pop(req.rid, None)
        self._ttft_pred.pop(req.rid, None)
        return self._descriptor(
            req, emitted=[], key=inj["key"] if inj else None,
            orig_prompt_len=(inj["orig_prompt_len"] if inj
                             else len(req.tokens)),
            pre_gen=inj["pre_gen"] if inj else 0)

    def drain(self, persist_path: Optional[str] = None) -> Dict[str, Any]:
        """Preemption-safe shutdown (JAX :1908): stop admitting (later
        submits are shed ``draining``) and unwind every slot and queued
        request into restartable descriptors.  A DECODE slot carries its
        stream's state after its last draw; a PREFILL slot has drawn
        nothing, so it carries None (its seed) or the state it was
        resumed with; with more than one data group an in-flight
        descriptor names its slot's ``group``.  Blocks are released and
        slots reset.
        ``persist_path`` writes the payload as JSON with a
        ``<path>.manifest.json`` SHA-256 sidecar; :meth:`resume` replays
        it."""
        self._draining = True
        descs: List[Dict[str, Any]] = []
        n_inflight = 0
        for i, s in enumerate(self._slots):
            if s.state == FREE:
                continue
            n_inflight += 1
            key = (self.device_step.stream_state(self._streams[i])
                   if s.state == DECODE else None)
            inj = self._inject.get(s.rid)
            if key is None and inj is not None:
                key = inj.get("key")
            descs.append(self._descriptor(
                s.req, emitted=s.generated, key=key,
                orig_prompt_len=s.orig_prompt_len, pre_gen=s.pre_gen,
                **self._group_key(i)))
            self._release_blocks(self._alloc_of(i), s.blocks)
            self._clear_slot_rows(i)
            self._inject.pop(s.rid, None)
            self._ttft_pred.pop(s.rid, None)
            s.reset()
        n_queued = len(self.queue)
        descs.extend(self._queued_descriptor(req) for req, _t in self.queue)
        self.queue = []
        payload = {"schema": DRAIN_SCHEMA, "n": len(descs),
                   "requests": descs}
        if persist_path is not None:
            self._persist_drain(persist_path, payload)
        self._ev.emit(
            "engine_drained", n_inflight=n_inflight, n_queued=n_queued,
            persisted=persist_path is not None, path=persist_path)
        return payload

    @staticmethod
    def _persist_drain(path: str, payload: Dict[str, Any]) -> None:
        """Atomic JSON, then its manifest (size and SHA-256)."""
        import json
        import os

        from ..resilience.ckpt_guard import _sha256

        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        manifest = {"schema": DRAIN_SCHEMA + "-manifest",
                    "size": os.path.getsize(path), "sha256": _sha256(path)}
        mtmp = path + ".manifest.json.tmp"
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, path + ".manifest.json")

    @staticmethod
    def _load_drain(path: str) -> Dict[str, Any]:
        """The payload at ``path``, verified against its manifest BEFORE
        it is parsed (CheckpointCorruptError on a size or digest
        mismatch)."""
        import json
        import os

        from ..resilience.ckpt_guard import CheckpointCorruptError, _sha256

        mpath = path + ".manifest.json"
        if os.path.exists(mpath):
            with open(mpath) as f:
                manifest = json.load(f)
            size = os.path.getsize(path)
            if size != manifest.get("size"):
                raise CheckpointCorruptError(
                    f"drain payload {path}: size {size} != manifest "
                    f"{manifest.get('size')}")
            if _sha256(path) != manifest.get("sha256"):
                raise CheckpointCorruptError(
                    f"drain payload {path}: sha256 mismatch")
        with open(path) as f:
            return json.load(f)

    def resume(self, source: Any) -> List[int]:
        """Re-submit a drain payload (a dict from :meth:`drain`, or a path
        it persisted, verified first).  Each descriptor is replayed as
        prompt + emitted prefix through chunked prefill with its carried
        stream state injected, so the stream continues where the drained
        engine stopped.  Returns the new rids, in descriptor order."""
        if isinstance(source, str):
            source = self._load_drain(source)
        if not isinstance(source, dict) or source.get("schema") != DRAIN_SCHEMA:
            raise ValueError(
                f"not a {DRAIN_SCHEMA} payload: "
                f"{type(source).__name__}/{(source or {}).get('schema')!r}")
        self._draining = False
        rids: List[int] = []
        for d in source["requests"]:
            emitted = [int(t) for t in d.get("emitted") or []]
            remaining = int(d["max_new_tokens"]) - len(emitted)
            req = Request(
                tokens=[int(t) for t in d["prompt"]] + emitted,
                max_new_tokens=max(1, remaining),
                temperature=float(d.get("temperature", 0.0)),
                top_k=d.get("top_k"), top_p=d.get("top_p"),
                eos_id=d.get("eos_id"), seed=int(d.get("seed", 0)),
                priority=int(d.get("priority", 0)),
                deadline_s=d.get("deadline_s"))
            rid = self.submit(req)
            self._ev.emit("request_resumed", rid=rid,
                          orig_rid=int(d.get("orig_rid", -1)),
                          emitted_tokens=len(emitted),
                          shed=rid in self.rejected)
            if rid in self.rejected:
                rids.append(rid)
                continue
            if emitted or d.get("key") is not None:
                self._inject[rid] = {
                    "key": d.get("key"),
                    "orig_prompt_len": len(d["prompt"]),
                    "pre_gen": len(emitted)}
            self.stats["resumed"] += 1
            rids.append(rid)
        return rids

    # ------------------------------------------------- cross-replica migration

    def prefix_lookup(self, tokens: Sequence[int]) -> int:
        """Prompt tokens of ``tokens`` resident in this engine's prefix
        cache (the longest chained full-block match, capped as admission
        caps it); 0 with the cache off.  A pure host read."""
        if not self.prefix_cache:
            return 0
        hashes = self._prefix_hashes(tokens)
        if not hashes:
            return 0
        n_hit = max(len(a.match(hashes)) for a in self._allocs)
        return min(n_hit * self.block_size, max(0, len(tokens) - 1))

    def decode_slots(self) -> List[Tuple[int, int]]:
        """``(rid, slot)`` of every slot in DECODE: what a disaggregating
        router scans for requests ready to hand off."""
        return [(s.rid, i) for i, s in enumerate(self._slots)
                if s.state == DECODE]

    def export_slot(self, rid: int) -> Tuple[Dict[str, Any], PoolSnapshot]:
        """Unwind one DECODE slot into a migration descriptor (JAX :2063):
        the drain descriptor (with the stream's state) plus the slot's
        block list, committed ``length`` and ``n_live`` (the blocks that
        hold KV, positions ``0..length-1``).  Returns ``(desc, source)``:
        ``source`` is a :class:`~.paged_cache.PoolSnapshot` of the live
        blocks, copied out on the pool's device before the slot is
        released — a torch pool is overwritten in place once these blocks
        are reused, so the snapshot, not the pool, is the
        ``migrate_blocks`` source.  The request now lives only in the
        descriptor, to be imported or resumed, never both.  With more
        than one data group the descriptor names the slot's ``group``:
        only that group's ranks hold its blocks, so elsewhere the
        snapshot holds none (``migrate_blocks`` from it raises).  A CP
        engine's rank holds only its block slice of the pool, so its
        export gathers the live blocks over ``cp_group``
        (:meth:`_cp_snapshot`): every rank gets the whole snapshot."""
        for i, s in enumerate(self._slots):
            if s.state == DECODE and s.rid == rid:
                break
        else:
            raise ValueError(
                f"rid {rid} is not a decoding slot (only DECODE-state "
                f"requests carry migratable KV — queued requests move "
                f"KV-free via drain descriptors)")
        length = int(self._lengths[i])
        n_live = -(-length // self.block_size)
        desc = self._descriptor(
            s.req, emitted=s.generated,
            key=self.device_step.stream_state(self._streams[i]),
            orig_prompt_len=s.orig_prompt_len, pre_gen=s.pre_gen,
            **self._group_key(i))
        desc.update({
            "length": length,
            "blocks": [int(b) for b in s.blocks],
            "n_live": n_live,
            "t_submit": s.t_submit,
            "ttft_s": s.ttft_s,
            "tpot_s": [float(t) for t in s.tpot_s],
        })
        if self.cp_group is not None:
            source = self._cp_snapshot(s.blocks[:n_live])
        else:
            mine = self._group(i) == getattr(self.device_step,
                                             "group_index", 0)
            source = PoolSnapshot(self.cache,
                                  s.blocks[:n_live] if mine else [])
        self._release_blocks(self._alloc_of(i), s.blocks)
        self._clear_slot_rows(i)
        self._inject.pop(s.rid, None)
        self._ttft_pred.pop(s.rid, None)
        s.reset()
        self.stats["migrated_out"] += 1
        self._ev.emit("request_exported", rid=rid, length=length,
                      n_live=n_live,
                      emitted_tokens=len(desc.get("emitted") or []))
        return desc, source

    def _cp_snapshot(self, blocks: Sequence[int]) -> PoolSnapshot:
        """The whole :class:`~.paged_cache.PoolSnapshot` of global blocks
        ``blocks`` (and the NULL block) on every rank of ``cp_group``.
        Rank ``r`` holds global blocks ``[r nb_local, (r + 1) nb_local)``
        only: each rank fills the rows it owns of a zeroed ``[2, L, 1 +
        n, ...]`` buffer (k and v), one all-gather over the group (through
        the host over gloo, counted by ``tp_utils``) collects every
        rank's, and each row is taken from its owner's."""
        from ..parallel.tensor_parallel.tp_utils import _all_gather

        ids = np.asarray([0] + [int(b) for b in blocks], np.int64)
        nb_local = self.num_blocks // self.cp
        owner, local = ids // nb_local, ids % nb_local
        k, v = self.cache["k"], self.cache["v"]
        dev = k.device
        mine = np.nonzero(owner == dist.get_rank(self.cp_group))[0]
        part = k.new_zeros((2, k.shape[0], len(ids)) + tuple(k.shape[2:]))
        rows = torch.from_numpy(mine).to(dev)
        src = torch.from_numpy(local[mine]).to(dev)
        part[0][:, rows] = k[:, src]
        part[1][:, rows] = v[:, src]
        every = _all_gather(part[None], self.cp_group, 0, "cp_export")
        whole = every[torch.from_numpy(owner).to(dev), :, :,
                      torch.arange(len(ids), device=dev)].movedim(0, 2)
        return PoolSnapshot.from_rows({"k": whole[0], "v": whole[1]},
                                      ids.tolist())

    def import_slot(self, desc: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Admit an :meth:`export_slot` descriptor straight into DECODE
        (JAX :2115): a free slot, the longest resident prefix of the
        written context shared (equal hash, equal KV), the rest
        allocated, the rows written (table, length, last token, sampling
        parameters, restored stream).  Migrated full blocks are
        registered.  Returns ``{rid, slot, blocks, n_shared, n_live}`` —
        the caller copies source blocks ``[n_shared:n_live]`` onto these
        ``blocks[n_shared:n_live]`` (``migrate_blocks``) before this
        engine's next step — or None (no capacity; nothing admitted).
        The slot is the first free one whose data group can hold it; with
        more than one group the answer names its ``group``, whose ranks
        alone copy."""
        emitted = [int(t) for t in desc.get("emitted") or []]
        if not emitted:
            raise ValueError(
                "import_slot needs an emitted prefix (a request with no "
                "sampled token has no decode state — resume() it instead)")
        if desc.get("key") is None:
            raise ValueError("import_slot descriptor lacks the carried key")
        prompt_full = [int(t) for t in desc["prompt"]] + emitted
        remaining = int(desc["max_new_tokens"]) - len(emitted)
        if remaining < 1:
            raise ValueError(
                f"descriptor has no budget left ({desc['max_new_tokens']} "
                f"total, {len(emitted)} emitted) — it should have retired")
        req = Request(
            tokens=prompt_full, max_new_tokens=remaining,
            temperature=float(desc.get("temperature", 0.0)),
            top_k=desc.get("top_k"), top_p=desc.get("top_p"),
            eos_id=desc.get("eos_id"), seed=int(desc.get("seed", 0)),
            priority=int(desc.get("priority", 0)),
            deadline_s=desc.get("deadline_s"))
        if len(prompt_full) + remaining > self.max_ctx:
            raise ValueError(
                f"context {len(prompt_full)} + remaining {remaining} "
                f"exceeds max_ctx {self.max_ctx}")
        # the committed KV length: the last emitted token's KV is written
        # by the next decode step
        length = int(desc["length"])
        if length != len(prompt_full) - 1:
            raise ValueError(
                f"descriptor length {length} inconsistent with context "
                f"{len(prompt_full)} (expect length == context - 1: the "
                f"pending token's KV is not written yet)")
        need = self._blocks_needed(req)
        n_live = -(-length // self.block_size)
        # match over the written context only: the pending token's block
        # has no KV for it yet
        hashes = self._prefix_hashes(prompt_full[:length])
        for i in self._free_slots_by_group():
            alloc = self._alloc_of(i)
            hit = alloc.match(hashes) if hashes else []
            fresh = self._claim_blocks(alloc, hit, [], need - len(hit))
            if fresh is not None:
                break
        else:
            return None
        evicted = alloc.pop_evicted()
        blocks = hit + fresh
        rid = self._next_rid
        self._next_rid += 1
        self._seq[rid] = rid
        now = time.perf_counter()
        s = self._slots[i]
        s.state, s.rid = DECODE, rid
        s.req = dataclasses.replace(req, rid=rid)
        s.blocks = blocks
        s.prompt = np.asarray(prompt_full, np.int32)
        s.off = length
        s.generated = []
        s.t_submit = float(desc.get("t_submit", now))
        s.t_admit = s.t_last = now
        s.ttft_s = desc.get("ttft_s")
        s.tpot_s = [float(t) for t in desc.get("tpot_s") or []]
        s.orig_prompt_len = len(desc["prompt"])
        s.pre_gen = len(emitted)
        self._tables[i] = 0
        self._tables[i, :need] = blocks
        self._lengths[i] = length
        self._last_tok[i] = emitted[-1]
        self._temps[i] = req.temperature
        self._top_k[i] = (req.top_k if req.top_k is not None
                          else self.cfg.vocab_size)
        self._top_p[i] = req.top_p if req.top_p is not None else 1.0
        self._streams[i] = self.device_step.restore_stream(desc["key"])
        if self.prefix_cache:
            # migrated full blocks now hold KV for their chain hashes
            for j, bh in enumerate(hashes):
                if j >= len(hit):
                    alloc.register(blocks[j], bh)
            self.stats["prefix_prompt_tokens"] += length
            if hit:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_cached_tokens"] += (
                    len(hit) * self.block_size)
        if evicted:
            self.stats["cache_evictions"] += len(evicted)
            self._ev.emit("cache_evict", tick=self._tick,
                          n_blocks=len(evicted), group=self._group(i))
        self.stats["migrated_in"] += 1
        self._ev.emit(
            "request_imported", rid=rid,
            orig_rid=int(desc.get("orig_rid", -1)), length=length,
            n_shared=len(hit), n_live=n_live, emitted_tokens=len(emitted))
        return {"rid": rid, "slot": i, "blocks": list(blocks),
                "n_shared": len(hit), "n_live": n_live,
                **self._group_key(i)}

    def abort_import(self, rid: int, n_valid: int = 0) -> None:
        """Unwind an :meth:`import_slot` whose KV never arrived: the hashes
        of blocks past ``n_valid`` are dropped before release (no later
        import may share a block the wire never filled), shared blocks
        release refcount-aware, and the slot returns to FREE."""
        for i, s in enumerate(self._slots):
            if s.state != FREE and s.rid == rid:
                break
        else:
            raise ValueError(f"abort_import: rid {rid} holds no slot")
        alloc = self._alloc_of(i)
        for b in s.blocks[n_valid:]:
            alloc._drop_hash(int(b))
        self._release_blocks(alloc, s.blocks)
        self._clear_slot_rows(i)
        self._seq.pop(s.rid, None)
        self._inject.pop(s.rid, None)
        self._ttft_pred.pop(s.rid, None)
        s.reset()
        self.stats["imports_aborted"] += 1
        self._ev.emit("import_aborted", rid=rid, n_valid=int(n_valid))

    def steal_queued(self, max_n: int) -> List[Dict[str, Any]]:
        """Pop up to ``max_n`` queued requests off the tail of the priority
        order (the youngest of the lowest class) into drain descriptors,
        for a router to :meth:`resume` on another engine."""
        out: List[Dict[str, Any]] = []
        while self.queue and len(out) < max_n:
            req, _t = self.queue.pop()
            out.append(self._queued_descriptor(req))
            self.stats["migrated_out"] += 1
        return out

    # ------------------------------------------------------------------ metrics

    def reset_metrics(self) -> None:
        """Zero the serving metrics (a warm-up / measure split); the pool,
        the queue, the tick EWMA and the calibration bias are untouched."""
        self.stats = {"decode_steps": 0, "prefill_chunks": 0,
                      "decode_slot_steps": 0, "generated_tokens": 0,
                      "shed": 0, "expired": 0, "cancelled": 0,
                      "preempted": 0, "resumed": 0, "faults_detected": 0,
                      "faults_healed": 0, "audits": 0,
                      "prefix_hits": 0, "prefix_cached_tokens": 0,
                      "prefix_prompt_tokens": 0, "cow_copies": 0,
                      "cache_evictions": 0,
                      "spec_drafted": 0, "spec_accepted": 0,
                      "migrated_in": 0, "migrated_out": 0,
                      "imports_aborted": 0,
                      "cp_ring_hops": 0, "cp_ring_bytes": 0}
        self._decode_sigs: set = set()
        self._prefill_sigs: set = set()
        self._cow_sigs: set = set()
        self._ttfts: List[Optional[float]] = []
        self._tpots: List[float] = []
        self._ttfts_by_prio: Dict[int, List[float]] = {}
        self._tpots_by_prio: Dict[int, List[float]] = {}
        #: unresolved admission-time TTFT predictions, rid -> {est, raw}
        self._ttft_pred: Dict[int, Dict[str, float]] = {}
        self._calib_by_prio: Dict[int, List[float]] = {}
        self._calib_n = 0
        self._slo_by_prio: Dict[int, Dict[str, int]] = {}
        #: bounded per-tick accounting records (serving/tracing.py)
        self.tick_records: collections.deque = collections.deque(
            maxlen=self.tick_history)
        self._tick = 0
        self._occ_sum = self._util_sum = 0.0
        self._occ_ticks = 0
        self._t_first = float("inf")
        self._t_last_done = 0.0
        self._launches0 = self._launches()
        self.finished: Dict[int, Dict[str, Any]] = {}
        self.rejected: Dict[int, Dict[str, Any]] = {}
        self._finished_order: List[int] = []
        self._rejected_order: List[int] = []
        for a in self._allocs:
            a.peak_in_use = a.in_use
        # live MoE expert load: per-expert routed-token counts summed over
        # the measured steps, and the mean drop rate
        self._moe_expert_tokens: Optional[np.ndarray] = None
        self._moe_dropped_sum = 0.0
        self._moe_steps = 0

    def _launches(self) -> Dict[str, int]:
        return {k: counts[k] for counts, names in self._launch_counts
                for k in names}

    def _absorb_moe_stats(self, moe) -> None:
        """Fold one step's ``(expert_tokens [E], dropped_token_rate)`` into
        the accumulators (None: a dense model's step)."""
        if moe is None:
            return
        et, dr = moe
        et = np.asarray(et, np.float64)
        if self._moe_expert_tokens is None:
            self._moe_expert_tokens = et.copy()
        else:
            self._moe_expert_tokens += et
        self._moe_dropped_sum += float(dr)
        self._moe_steps += 1

    def moe_imbalance(self) -> float:
        """Live expert-load imbalance (``max/mean - 1`` over the summed
        per-expert counts; 0.0 when balanced, unknown, or not an MoE
        model)."""
        if self._moe_expert_tokens is None:
            return 0.0
        return float(moe_load_stats(self._moe_expert_tokens)["imbalance"])

    def _slo_summary(self, span: float, completed: int) -> Dict[str, Any]:
        """The ``slo`` block (JAX :2437-2478): per-priority deadline
        attainment (refused demand counts as missed), goodput (tokens of
        deadline-meeting requests) and the TTFT calibration record."""
        prios: Dict[str, Any] = {}
        met_total = demand_total = goodput_tokens = 0
        for p in sorted(self._slo_by_prio):
            row = dict(self._slo_by_prio[p])
            demand = row["completed"] + row["shed"] + row["expired"]
            row["attainment"] = (round(row["met"] / demand, 4)
                                 if demand else None)
            prios[str(p)] = row
            met_total += row["met"]
            demand_total += demand
            goodput_tokens += row["goodput_tokens"]
        calib = {
            str(p): {"n": len(errs),
                     **{f"rel_err_{k}": round(v, 4) for k, v in
                        percentiles(errs, ps=(50, 95)).items()}}
            for p, errs in sorted(self._calib_by_prio.items())}
        return {
            "goodput_tokens": goodput_tokens,
            "goodput_tok_s": (goodput_tokens / span
                              if span > 0 and completed else 0.0),
            "attainment": (round(met_total / demand_total, 4)
                           if demand_total else None),
            "priorities": prios,
            "calibration": {
                "n": self._calib_n,
                "bias": (round(self._ttft_bias, 6)
                         if self._ttft_bias is not None else None),
                "pending": len(self._ttft_pred),
                "priorities": calib,
            },
        }

    def serving_summary(self) -> Dict[str, Any]:
        """The reference's ``serving`` report (JAX :2395): request counts
        (shed, expired, cancelled, preempted, resumed, migrated),
        generated tokens, tokens/s, TTFT/TPOT percentiles overall and by
        priority, the ``healthy | degraded | overloaded`` verdict with its
        evidence, the ``slo`` block, ``tick_accounting`` (the ticks on
        ``tick_records``, their mean seconds and each phase's mean), the
        pool, the attention
        implementation, the kernel launches since :meth:`reset_metrics`,
        the call signatures, the ``prefix_cache`` and ``spec`` blocks and,
        where they apply, ``moe`` and ``long_context``.
        ``kv_pool.pool_bytes`` is this rank's slice and
        ``pool_bytes_expected`` its shape math; ``num_blocks`` is a data
        group's, ``dp_groups`` the number of groups, and
        ``pool_bytes_all_groups`` the reference's ``pool_bytes``: every
        group's pool, every head (``dp * num_blocks`` blocks)."""
        span = self._t_last_done - self._t_first
        completed = sum(1 for f in self.finished.values()
                        if f["reason"] in ("eos", "max_tokens"))
        st = self.stats
        if st["shed"] + st["expired"] > 0:
            verdict = "overloaded"
            basis = (f"demand refused: shed={st['shed']}, "
                     f"expired={st['expired']}")
            evidence = {"shed": st["shed"], "expired": st["expired"]}
        elif st["preempted"] + st["faults_detected"] > 0:
            verdict = "degraded"
            basis = (f"served by degrading: preempted={st['preempted']}, "
                     f"faults_detected={st['faults_detected']}")
            evidence = {"preempted": st["preempted"],
                        "faults_detected": st["faults_detected"]}
        else:
            verdict = "healthy"
            basis = "no shed/expired demand, no preemptions, no faults"
            evidence = {}
        priorities = {
            str(p): {
                "completed": len(self._ttfts_by_prio.get(p, [])),
                "ttft_s": percentiles(self._ttfts_by_prio.get(p, [])),
                "tpot_s": percentiles(self._tpots_by_prio.get(p, [])),
            }
            for p in sorted(set(self._ttfts_by_prio)
                            | set(self._tpots_by_prio))}
        moe = None
        if self.cfg.moe_experts:
            from ..parallel.moe import check_expert_overflow

            moe = moe_load_stats(
                self._moe_expert_tokens
                if self._moe_expert_tokens is not None
                else [0.0] * self.cfg.moe_experts,
                dropped_rate=(self._moe_dropped_sum / self._moe_steps
                              if self._moe_steps else 0.0))
            moe["dispatch"] = self.moe_dispatch
            check_expert_overflow(moe, where="serving_summary")
        ticks = list(self.tick_records)
        tick_accounting = {
            "ticks": len(ticks),
            "mean_tick_s": (float(np.mean([t["tick_s"] for t in ticks]))
                            if ticks else 0.0),
            "phases_mean_s": {
                name: round(float(np.mean(
                    [t["phases"].get(name, 0.0) for t in ticks])), 9)
                for name in (TICK_PHASES if ticks else ())},
        }
        return {
            "requests": {"completed": completed, "queued": len(self.queue),
                         "in_flight": self.n_busy,
                         "shed": st["shed"], "expired": st["expired"],
                         "cancelled": st["cancelled"],
                         "preempted": st["preempted"],
                         "resumed": st["resumed"],
                         "migrated_in": st["migrated_in"],
                         "migrated_out": st["migrated_out"],
                         "imports_aborted": st["imports_aborted"]},
            "generated_tokens": st["generated_tokens"],
            "tokens_per_sec": (st["generated_tokens"] / span
                               if span > 0 and completed else 0.0),
            "ttft_s": percentiles([t for t in self._ttfts if t is not None]),
            "tpot_s": percentiles(self._tpots),
            "priorities": priorities,
            "verdict": verdict,
            "verdict_basis": basis,
            "verdict_evidence": evidence,
            "slo": self._slo_summary(span, completed),
            "tick_accounting": tick_accounting,
            "faults": {"detected": st["faults_detected"],
                       "healed": st["faults_healed"],
                       "audits": st["audits"]},
            "drained": self._draining,
            "slot_occupancy": {
                "mean": (self._occ_sum / self._occ_ticks
                         if self._occ_ticks else 0.0),
                "num_slots": self.num_slots,
            },
            "kv_pool": {
                "num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "mean_utilization": (self._util_sum / self._occ_ticks
                                     if self._occ_ticks else 0.0),
                "dp_groups": self.dp,
                "peak_utilization": (max(a.peak_in_use for a in self._allocs)
                                     / self._allocs[0].n_usable),
                "pool_bytes": pool_bytes(self.cache),
                "pool_bytes_expected": expected_pool_bytes(
                    self.cfg, self.num_blocks // self.cp, self.block_size,
                    quantized=self.kv_quant, axis_size=self.tp),
                "pool_bytes_all_groups": expected_pool_bytes(
                    self.cfg, self.dp * self.num_blocks, self.block_size,
                    quantized=self.kv_quant),
            },
            "attn_impl": self.attn_impl,
            "device": str(self.device),
            "kernel_launches": {k: v - self._launches0.get(k, 0)
                                for k, v in self._launches().items()},
            "decode_steps": st["decode_steps"],
            "prefill_chunks": st["prefill_chunks"],
            "decode_batch_mean": (
                st["decode_slot_steps"] / st["decode_steps"]
                if st["decode_steps"] else 0.0),
            "decode_signatures": len(self._decode_sigs),
            "prefill_signatures": len(self._prefill_sigs),
            "prefix_hit_rate": (
                st["prefix_cached_tokens"] / st["prefix_prompt_tokens"]
                if st["prefix_prompt_tokens"] else 0.0),
            "spec_accept_rate": (st["spec_accepted"] / st["spec_drafted"]
                                 if st["spec_drafted"] else 0.0),
            "prefix_cache": {
                "enabled": self.prefix_cache,
                "hits": st["prefix_hits"],
                "cached_tokens": st["prefix_cached_tokens"],
                "cow_copies": st["cow_copies"],
                "evictions": st["cache_evictions"],
                "cached_blocks": sum(a.n_cached for a in self._allocs),
                "cow_signatures": len(self._cow_sigs),
            },
            "spec": {"k": self.spec_k, "drafted": st["spec_drafted"],
                     "accepted": st["spec_accepted"]},
            **({"long_context": {
                "cp": self.cp,
                "max_ctx": self.max_ctx,
                "chunk": self.chunk,
                "prefill_chunks": st["prefill_chunks"],
                "ring_hops": st["cp_ring_hops"],
                "ring_bytes": st["cp_ring_bytes"],
            }} if self.cp_group is not None else {}),
            **({"moe": moe} if moe is not None else {}),
        }
