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

Paged attention runs through the hand-written CUDA kernel on the card
(``attn_impl='auto'`` resolves to ``'cuda'`` there, ``'gather'`` on the
CPU).  An MoE model (``cfg.moe_experts > 0``, e.g. Mixtral) serves
through ``paged_forward_moe``: its expert layers run the fused dispatch
kernel K6 on the card (``moe_dispatch='auto'`` -> ``'cuda'``) or the
ragged plain path (``'gather'``), and ``serving_summary()['moe']``
reports the live expert load.  With ``ep_group`` its experts are sharded
over a ``torch.distributed`` group (expert parallelism, K7 on the card).
Tensor / data / context parallelism, the prefix cache,
speculative decoding, telemetry, chaos, the watchdog, metrics export,
deadline shedding, preemption and drain/resume are not ported yet
(ROADMAP queue A); the constructor refuses them with NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.gpt import GPTConfig
from ..obs.aggregate import moe_load_stats, percentiles
from ..obs.events import EventLog, default_event_log
from ..ops import moe_dispatch as _moe_ops
from ..ops import paged_attention as _attn_ops
from .paged_cache import BlockAllocator, expected_pool_bytes, pool_bytes

# slot lifecycle
FREE, PREFILL, DECODE = "free", "prefill", "decode"


@dataclasses.dataclass
class Request:
    """One serving request.  ``temperature=0`` is greedy; otherwise
    ``seed`` starts the slot's private sampling stream.  ``eos_id`` retires
    the request early.  ``priority`` and ``deadline_s`` keep the
    reference's interface but are refused at submit: preemption and
    shedding are not ported yet."""

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
        idx = torch.tensor(rows, device=x.device)
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
    """Host-side bookkeeping for one slot."""

    __slots__ = ("state", "rid", "req", "blocks", "prompt", "off",
                 "generated", "t_submit", "t_admit", "t_last", "ttft_s",
                 "tpot_s")

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


#: constructor options of the reference engine that this slice does not
#: serve yet, with the value that means "off"
_QUEUED_OPTIONS = {
    "mesh": None, "axis": None, "dp_axis": None, "ep_axis": None,
    "cp_axis": None, "prefix_cache": False, "spec_k": 0, "telemetry": None,
    "chaos": None, "watchdog": None, "metrics_sink": None,
}


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
        ``models.convert.params_from_jax``) on ``device``.
    num_slots: decode-batch width.
    block_size: KV positions per pool block.
    num_blocks: pool blocks including the NULL block; default sizes the
        pool so every slot can hold ``max_ctx``.
    max_ctx: per-request ceiling on prompt + generated tokens; sets the
        block-table width.  Default ``cfg.max_seq``.
    chunk: prefill tokens per slot per tick.
    kv_quant: int8 block pool.
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
    device: where the pool and the step live (default: the card).
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
        attn_impl: str = "auto",
        moe_dispatch: Optional[str] = None,
        ep_group=None,
        device=None,
        **queued: Any,
    ) -> None:
        unknown = set(queued) - set(_QUEUED_OPTIONS)
        if unknown:
            raise TypeError(f"unexpected engine options {sorted(unknown)}")
        on = sorted(k for k, v in queued.items() if v != _QUEUED_OPTIONS[k])
        if on:
            ep = ("; expert parallelism takes ep_group= (a torch.distributed "
                  "process group), not mesh= / ep_axis="
                  if {"mesh", "ep_axis"} & set(on) else "")
            raise NotImplementedError(
                f"engine options {on} are not ported to the PyTorch engine "
                f"yet (ROADMAP queue A){ep}")
        if num_slots < 1 or chunk < 1 or block_size < 1:
            raise ValueError(
                f"num_slots/chunk/block_size must be >= 1, got "
                f"{num_slots}/{chunk}/{block_size}")
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
        self._ev: EventLog = default_event_log()

        from .sim import TorchDeviceStep

        self._dev = TorchDeviceStep(cfg, device, attn_impl, moe_dispatch,
                                    ep_group)
        #: the expert-parallel group (None: every expert on this device)
        self.ep_group = ep_group
        self.device = self._dev.device
        self.attn_impl = self._dev.attn_impl
        #: the resolved MoE dispatch ('cuda' | 'gather', or 'cuda' |
        #: 'sorted' under EP); None when dense
        self.moe_dispatch = self._dev.moe_dispatch
        # the kernels this engine's step can launch
        self._launch_counts = [_attn_ops.LAUNCHES] + (
            [_moe_ops.LAUNCHES] if cfg.moe_experts else [])

        self.max_ctx = int(max_ctx if max_ctx is not None else cfg.max_seq)
        self.max_blocks = -(-self.max_ctx // block_size)
        if num_blocks is None:
            num_blocks = 1 + num_slots * self.max_blocks
        self.num_blocks = num_blocks
        self._alloc = BlockAllocator(num_blocks)
        self.cache = self._dev.init_cache(num_blocks, block_size, kv_quant)

        # host-visible device state, one row per slot
        V = cfg.vocab_size
        self._tables = np.zeros((num_slots, self.max_blocks), np.int32)
        self._lengths = np.zeros(num_slots, np.int32)
        self._last_tok = np.zeros(num_slots, np.int32)
        self._temps = np.zeros(num_slots, np.float32)
        self._top_k = np.full(num_slots, V, np.int32)
        self._top_p = np.ones(num_slots, np.float32)
        self._gens: List[Optional[torch.Generator]] = [None] * num_slots

        self._slots = [_SlotState() for _ in range(num_slots)]
        self.queue: List[Tuple[Request, float]] = []
        self._next_rid = 0
        self._seq: Dict[int, int] = {}  # rid -> FIFO age (survives requeue)
        self.reset_metrics()

    # ---------------------------------------------------------------- admission

    def _blocks_needed(self, req: Request) -> int:
        return -(-(len(req.tokens) + req.max_new_tokens) // self.block_size)

    def _queue_sort(self) -> None:
        """Priority order, FIFO within a class: the sort key is
        (-priority, submit age) and ages survive requeue."""
        self.queue.sort(key=lambda e: (-e[0].priority, self._seq[e[0].rid]))

    def submit(self, req: Request) -> int:
        """Enqueue; returns the request id.  Raises if the request can
        never fit the engine's context or pool."""
        if req.deadline_s is not None:
            raise NotImplementedError(
                "deadline_s shedding and expiry are not ported to the "
                "PyTorch engine yet (ROADMAP queue A)")
        if req.priority != 0:
            raise NotImplementedError(
                "priority classes and the preemption they arm are not "
                "ported to the PyTorch engine yet (ROADMAP queue A)")
        P, N = len(req.tokens), req.max_new_tokens
        need = self._blocks_needed(req)
        if P + N > self.max_ctx:
            raise ValueError(
                f"prompt {P} + max_new {N} exceeds max_ctx {self.max_ctx}")
        if need > self._alloc.n_usable:
            raise ValueError(
                f"request needs {need} blocks, pool has "
                f"{self._alloc.n_usable}")
        if self.cfg.pos == "learned" and P + N > self.cfg.max_seq:
            raise ValueError(
                f"P + max_new_tokens = {P + N} exceeds the learned position "
                f"table ({self.cfg.max_seq})")
        req = dataclasses.replace(req, rid=self._next_rid)
        self._next_rid += 1
        self._seq[req.rid] = req.rid  # submit order IS the FIFO age
        self._ev.emit(
            "request_submitted", rid=req.rid, prompt_len=int(P),
            max_new_tokens=int(N), priority=req.priority)
        self.queue.append((req, time.perf_counter()))
        self._queue_sort()
        return req.rid

    def _requeue_slot(self, i: int) -> int:
        """Evict slot ``i`` back to the queue at its original FIFO age:
        blocks released (tolerantly — a poisoned slot's ownership may be
        inconsistent), output discarded, prompt replayed later."""
        s = self._slots[i]
        rid, req, t_submit = s.rid, s.req, s.t_submit
        for b in s.blocks:
            try:
                self._alloc.free([b])
            except ValueError:
                self._alloc.reclaim([b])
        self._clear_slot_rows(i)
        s.reset()
        self.queue.append((req, t_submit))
        self._queue_sort()
        return rid

    def _clear_slot_rows(self, i: int) -> None:
        self._tables[i] = 0
        self._lengths[i] = 0
        self._last_tok[i] = 0
        self._temps[i] = 0.0
        self._top_k[i] = self.cfg.vocab_size
        self._top_p[i] = 1.0
        self._gens[i] = None

    def _try_place(self, req: Request):
        """The first free slot and fresh blocks for ``req``, as
        ``(slot, blocks)``, or None (back-pressure)."""
        for i, s in enumerate(self._slots):
            if s.state != FREE:
                continue
            blocks = self._alloc.alloc(self._blocks_needed(req))
            return None if blocks is None else (i, blocks)
        return None

    def _admit(self) -> int:
        """The head of the (priority-ordered) queue takes the first free
        slot; when it cannot be placed admission stops (head-of-line
        blocking within a class is deliberate — skipping ahead would
        starve long requests)."""
        admitted = 0
        while self.queue:
            req, t_submit = self.queue[0]
            placed = self._try_place(req)
            if placed is None:
                break
            self.queue.pop(0)
            i, blocks = placed
            s = self._slots[i]
            s.state, s.rid, s.req, s.blocks = PREFILL, req.rid, req, blocks
            s.prompt = np.asarray(req.tokens, np.int32)
            s.off = 0
            s.generated = []
            s.t_submit, s.t_admit = t_submit, time.perf_counter()
            s.ttft_s, s.tpot_s = None, []
            self._tables[i] = 0
            self._tables[i, :len(blocks)] = blocks
            self._lengths[i] = 0
            self._temps[i] = req.temperature
            self._top_k[i] = (req.top_k if req.top_k is not None
                              else self.cfg.vocab_size)
            self._top_p[i] = req.top_p if req.top_p is not None else 1.0
            self._gens[i] = self._dev.generator(req.seed)
            self._ev.emit(
                "request_admitted", rid=req.rid, slot=i,
                prompt_len=len(req.tokens),
                max_new_tokens=int(req.max_new_tokens), blocks=len(blocks),
                priority=req.priority,
                queue_wait_s=round(s.t_admit - t_submit, 6))
            admitted += 1
        return admitted

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
        their first token (TTFT) and move to DECODE."""
        mask, tables = self._masked(PREFILL)
        if not mask.any():
            return 0
        B, C = self.num_slots, self.chunk
        tokens = np.zeros((B, C), np.int32)
        offsets = np.zeros(B, np.int32)
        last_idx = np.zeros(B, np.int32)
        gens: List[Optional[torch.Generator]] = [None] * B
        for i, s in enumerate(self._slots):
            if s.state != PREFILL:
                continue
            sl = s.prompt[s.off:s.off + C]
            tokens[i, :len(sl)] = sl
            offsets[i] = s.off
            last_idx[i] = min(len(s.prompt) - 1 - s.off, C - 1)
            if s.off + C >= len(s.prompt) and self._temps[i] > 0.0:
                gens[i] = self._gens[i]  # final slice: draws a token
        self.cache, tok, moe = self._dev.step(
            self.params, self.cache, tokens, tables, offsets, last_idx,
            self._samp(), gens)
        self._absorb_moe_stats(moe)
        self._prefill_sigs.add(("prefill",) + self._sig(tokens))
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
                s.ttft_s = now - s.t_submit
                s.t_last = now
                self._lengths[i] = len(s.prompt)
                self._last_tok[i] = tok[i]
                s.generated.append(int(tok[i]))
                self._maybe_retire(i, int(tok[i]), now)
        self.stats["prefill_chunks"] += 1
        self._ev.emit("prefill_chunk", rids=rids, chunk=C, n_slots=len(rids))
        return len(rids)

    def _decode_tick(self) -> int:
        mask, tables = self._masked(DECODE)
        n_active = int(mask.sum())
        if n_active == 0:
            return 0
        tokens = np.where(mask, self._last_tok, 0).astype(np.int32)[:, None]
        offsets = np.where(mask, self._lengths, 0).astype(np.int32)
        last_idx = np.zeros(self.num_slots, np.int32)
        gens = [g if m and t > 0.0 else None
                for g, m, t in zip(self._gens, mask, self._temps)]
        self.cache, tok, moe = self._dev.step(
            self.params, self.cache, tokens, tables, offsets, last_idx,
            self._samp(), gens)
        self._absorb_moe_stats(moe)
        self._decode_sigs.add(("decode",) + self._sig(tokens))
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
            s.tpot_s.append(now - s.t_last)
            s.t_last = now
            self._maybe_retire(i, int(tok[i]), now)
        self.stats["decode_steps"] += 1
        self.stats["decode_slot_steps"] += n_active
        return n_active

    def _maybe_retire(self, i: int, tok: int, now: float) -> None:
        s = self._slots[i]
        req = s.req
        done_eos = req.eos_id is not None and tok == req.eos_id
        done_len = len(s.generated) >= req.max_new_tokens
        if done_eos or done_len:
            self._finish_slot(i, "eos" if done_eos else "max_tokens", now)

    def _finish_slot(self, i: int, reason: str, now: float) -> None:
        """Terminal slot exit (EOS / max-token / cancel): record, free the
        blocks, reset — the same tick.  Only completed requests feed the
        latency percentiles."""
        s = self._slots[i]
        completed = reason in ("eos", "max_tokens")
        self._finished_order.append(s.rid)
        self.finished[s.rid] = {
            "rid": s.rid,
            "tokens": np.concatenate(
                [s.prompt, np.asarray(s.generated, np.int32)]),
            "prompt_len": len(s.prompt),
            "new_tokens": len(s.generated),
            "reason": reason,
            "priority": int(s.req.priority),
            "ttft_s": s.ttft_s,
            "tpot_s": list(s.tpot_s),
            "t_submit": s.t_submit,
            "t_done": now,
        }
        if completed:
            self._ttfts.append(s.ttft_s)
            self._tpots.extend(s.tpot_s)
            self.stats["generated_tokens"] += len(s.generated)
            self._t_first = min(self._t_first, s.t_submit)
            self._t_last_done = max(self._t_last_done, now)
            self._ev.emit(
                "request_retired", rid=s.rid, slot=i, reason=reason,
                new_tokens=len(s.generated), priority=int(s.req.priority),
                ttft_s=round(s.ttft_s, 6) if s.ttft_s is not None else None)
        else:
            self.stats["cancelled"] += 1
            self._ev.emit(
                "request_cancelled", rid=s.rid, slot=i, where="slot",
                emitted_tokens=len(s.generated), blocks_freed=len(s.blocks))
        self._alloc.free(s.blocks)
        self._clear_slot_rows(i)
        s.reset()

    def cancel(self, rid: int) -> bool:
        """Retire request ``rid`` wherever it is — queued (removed, no
        service) or in flight (slot retired, blocks freed this tick, the
        partial output kept in ``finished[rid]`` with reason
        ``cancelled``).  Returns False when the rid is unknown or already
        terminal."""
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
                    "ttft_s": None,
                    "tpot_s": [],
                    "t_submit": t_submit,
                    "t_done": time.perf_counter(),
                }
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
        """Per-tick block-conservation check: every active slot's table row
        equals its owned blocks (padded with NULL), every owned block is
        live in the allocator and owned once, no in-use block is
        orphaned, inactive rows are all-NULL, and in-use + free == usable.
        ``heal=True`` requeues poisoned slots, reclaims orphans and zeroes
        stale rows, bracketed by ``engine_fault_detected`` /
        ``engine_recovered`` events.  Pure host arithmetic."""
        violations: List[Dict[str, Any]] = []
        poisoned: List[int] = []
        stale_rows: List[int] = []
        owned_lists = []
        for i, s in enumerate(self._slots):
            row = self._tables[i]
            if s.state == FREE:
                if row.any():
                    violations.append({"kind": "stale_table_row", "slot": i})
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
        rep = self._alloc.audit(owned_lists)
        for kind, blocks in (("shared_block", rep["shared"]),
                             ("unowned_block", rep["unknown"])):
            for b in blocks:
                refs = [i for i, s in enumerate(self._slots)
                        if b in s.blocks]
                violations.append({"kind": kind, "block": int(b),
                                   "slots": refs})
                poisoned.extend(i for i in refs if i not in poisoned)
        if rep["orphaned"]:
            violations.append({"kind": "orphaned_blocks",
                               "blocks": rep["orphaned"]})
        if not rep["conserved"]:
            violations.append({
                "kind": "conservation", "in_use": rep["in_use"],
                "n_free": rep["n_free"], "n_usable": self._alloc.n_usable})
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
            reclaimed = len(self._alloc.reclaim(rep["orphaned"]))
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
        """One engine tick: invariant audit (heal) -> admit -> one prefill
        slice -> one decode step.  Returns what happened (all zeros =
        idle)."""
        self._tick += 1
        self.stats["audits"] += 1
        self.audit(heal=True)
        admitted = self._admit()
        prefilled = self._prefill_tick()
        decoded = self._decode_tick()
        busy = self.n_busy
        self._occ_sum += busy / self.num_slots
        self._util_sum += self._alloc.utilization()
        self._occ_ticks += 1
        return {"admitted": admitted, "prefill_slots": prefilled,
                "decode_slots": decoded, "busy": busy}

    def run_until_idle(self, max_ticks: int = 100_000) -> None:
        """Drain the queue and every in-flight slot."""
        while self.queue or self.n_busy:
            self.step()
            if self._tick > max_ticks:
                raise RuntimeError(
                    f"engine did not drain within {max_ticks} ticks "
                    f"(queued={len(self.queue)}, busy={self.n_busy})")

    # ----------------------------------------------------- not ported yet

    def _not_ported(self, what: str):
        raise NotImplementedError(
            f"{what} is not ported to the PyTorch engine yet (ROADMAP "
            f"queue A)")

    def drain(self, *args, **kwargs):
        self._not_ported("drain")

    def resume(self, *args, **kwargs):
        self._not_ported("resume")

    def export_slot(self, *args, **kwargs):
        self._not_ported("export_slot")

    def import_slot(self, *args, **kwargs):
        self._not_ported("import_slot")

    # ------------------------------------------------------------------ metrics

    def reset_metrics(self) -> None:
        """Zero the serving metrics (a warm-up / measure split); the pool
        and the queue are untouched."""
        self.stats = {"decode_steps": 0, "prefill_chunks": 0,
                      "decode_slot_steps": 0, "generated_tokens": 0,
                      "cancelled": 0, "faults_detected": 0,
                      "faults_healed": 0, "audits": 0}
        self._decode_sigs: set = set()
        self._prefill_sigs: set = set()
        self._ttfts: List[Optional[float]] = []
        self._tpots: List[float] = []
        self._tick = 0
        self._occ_sum = self._util_sum = 0.0
        self._occ_ticks = 0
        self._t_first = float("inf")
        self._t_last_done = 0.0
        self._launches0 = self._launches()
        self.finished: Dict[int, Dict[str, Any]] = {}
        self._finished_order: List[int] = []
        self._alloc.peak_in_use = self._alloc.in_use
        # live MoE expert load: per-expert routed-token counts summed over
        # the measured steps, and the mean drop rate
        self._moe_expert_tokens: Optional[np.ndarray] = None
        self._moe_dropped_sum = 0.0
        self._moe_steps = 0

    def _launches(self) -> Dict[str, int]:
        return {k: v for counts in self._launch_counts
                for k, v in counts.items()}

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

    def serving_summary(self) -> Dict[str, Any]:
        """The reference's ``serving`` report, the subset this slice
        serves: request counts, generated tokens, tokens/s, TTFT/TPOT
        percentiles, the attention implementation, the call signatures,
        the kernel launches since :meth:`reset_metrics` and, for an MoE
        model, the ``moe`` expert-load block (its overflow tripwire fires
        here)."""
        span = self._t_last_done - self._t_first
        completed = sum(1 for f in self.finished.values()
                        if f["reason"] in ("eos", "max_tokens"))
        st = self.stats
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
        return {
            "requests": {"completed": completed, "queued": len(self.queue),
                         "in_flight": self.n_busy,
                         "cancelled": st["cancelled"]},
            "generated_tokens": st["generated_tokens"],
            "tokens_per_sec": (st["generated_tokens"] / span
                               if span > 0 and completed else 0.0),
            "ttft_s": percentiles([t for t in self._ttfts if t is not None]),
            "tpot_s": percentiles(self._tpots),
            "faults": {"detected": st["faults_detected"],
                       "healed": st["faults_healed"],
                       "audits": st["audits"]},
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
                "peak_utilization": (self._alloc.peak_in_use
                                     / self._alloc.n_usable),
                "pool_bytes": pool_bytes(self.cache),
                "pool_bytes_expected": expected_pool_bytes(
                    self.cfg, self.num_blocks, self.block_size,
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
            **({"moe": moe} if moe is not None else {}),
        }
