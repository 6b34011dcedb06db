"""The engine's device touches behind one seam — the PyTorch counterpart
of ``torchdistpackage_tpu/serving/sim.py`` (``DeviceStep`` :54,
``CompiledDeviceStep`` :101, ``LatencyModel`` :136, ``StubDeviceStep``
:168, ``host_migrate_blocks`` :273).

``ServingEngine`` touches the device in five places: the pool
allocation, the shared prefill/decode step, the speculative verify step
(``spec_k``), the copy-on-write of the prefix cache and the per-slot
sampling streams.  :class:`DeviceStep` names them; everything else in
the engine is host-side scheduling, so the same queue, admission,
preemption, shedding, allocator and audit run against either
implementation:

- :class:`TorchDeviceStep` — the real one on a torch device (default:
  the card), built by the engine when no ``device_step=`` is given.  Its
  sampling stream is a ``torch.Generator``; the stream's state is the
  generator's ``get_state()`` (on CUDA Philox seed and offset, on the CPU
  the MT19937 state) as a list of ints.
- :class:`StubDeviceStep` — the host-only double: no model (the engine
  takes ``params=None``), a tiny numpy pool with the real block layout,
  tokens from a deterministic hash and a :class:`LatencyModel` of what
  each call would have cost.  Its stream is the reference stub's
  two-word key with the same hash and LCG advance, so on the same
  requests the port's engine on this stub replays the reference's engine
  on the reference's stub token for token, sampled rows included.

The engine hands a step the streams of the rows that emit a token in
that call (``None`` for the others); a step advances exactly those
streams (the real step draws only for rows with temperature > 0), so a
stream's state is the reference's carried key at the same moments.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.generate import _full_logits
from ..models.gpt import GPTConfig
from ..obs.comm_ledger import note
from ..ops.paged_attention import resolve_attn_impl
from .engine import _filtered_logits, _slot_sample
from .paged_cache import (
    PoolSnapshot,
    copy_blocks,
    cp_paged_forward,
    init_paged_kv,
    paged_forward,
    paged_forward_moe,
    resolve_serving_dispatch,
)

MoEStats = Optional[Tuple[np.ndarray, float]]

#: mix constants of the stub's token hash and key advance — the
#: reference stub's (JAX ``sim.py:45-48``), so both stubs agree
_MIX_A = np.uint64(2654435761)
_MIX_B = np.uint64(0x9E3779B97F4A7C15)
_LCG_MUL = np.uint64(6364136223846793005)
_LCG_ADD = np.uint64(1442695040888963407)


class DeviceStep:
    """The interface between ``ServingEngine`` and its device programs.

    ``bind(engine)`` is called once from the engine's constructor, after
    its shape attributes (``num_slots``, ``block_size``, ``num_blocks``,
    ``max_blocks``) are set and before the pool is made; it keeps no
    reference to the engine.  An
    implementation also carries ``device``, ``attn_impl`` and
    ``moe_dispatch`` (what the engine reports) and ``host_only`` (True:
    it never touches a device, and the engine refuses it with a process
    group).

    Streams: ``stream(seed)`` starts a request's sampling stream,
    ``stream_state(s)`` is its state as a JSON-serialisable list of ints
    (what a drain or an export carries), and ``restore_stream(state)``
    continues from such a state.  ``step`` and ``verify`` advance the
    streams they are given, and only those.

    ``t_enqueued``: a step that enqueues its device work and then waits
    for one read-back sets this to the host clock
    (``time.perf_counter()``) between the two, so the engine's tick
    accounting charges the enqueue to the call's phase and the wait to
    ``fetch``; a step that leaves it None (the stub) is charged whole to
    its phase."""

    host_only = False
    t_enqueued: Optional[float] = None
    device: torch.device
    attn_impl: str
    moe_dispatch: Optional[str] = None

    def bind(self, engine: Any) -> None:
        """Read what the implementation needs off the engine; keep no
        reference to it (the engine holds the step, and a cycle would
        keep a freed engine's pool alive until the cyclic collector
        runs)."""

    def init_cache(self, num_blocks: int, block_size: int,
                   quantized: bool) -> Any:
        raise NotImplementedError

    def step(self, params: Any, cache: Any, tokens: np.ndarray,
             tables: np.ndarray, offsets: np.ndarray, last_idx: np.ndarray,
             samp: Dict[str, np.ndarray], streams: List[Any]
             ) -> Tuple[Any, np.ndarray, MoEStats]:
        """``tokens [B, S]`` at per-slot offsets -> ``(cache, tok [B],
        moe)``: the shared prefill-chunk / decode step."""
        raise NotImplementedError

    def verify(self, params: Any, cache: Any, tokens: np.ndarray,
               tables: np.ndarray, offsets: np.ndarray,
               samp: Dict[str, np.ndarray], streams: List[Any]
               ) -> Tuple[Any, np.ndarray, np.ndarray]:
        """``tokens [B, K+1]`` -> ``(cache, verify [B, K+1], accept [B,
        K])``: the speculative verify step."""
        raise NotImplementedError

    def cow(self, cache: Any, src: np.ndarray, dst: np.ndarray) -> Any:
        """Copy blocks ``src[i] -> dst[i]`` (lane vectors, NULL-padded)
        before the next step: the prefix cache's copy-on-write."""
        raise NotImplementedError

    def stream(self, seed: int) -> Any:
        raise NotImplementedError

    def stream_state(self, stream: Any) -> List[int]:
        raise NotImplementedError

    def restore_stream(self, state: Sequence[int]) -> Any:
        raise NotImplementedError


def _sampled(streams: List[Any], samp: Dict[str, np.ndarray]) -> List[Any]:
    """The streams of the rows that draw: given a stream and a
    temperature > 0 (a greedy row's stream is not drawn from)."""
    temps = samp["temperature"]
    return [g if g is not None and temps[i] > 0.0 else None
            for i, g in enumerate(streams)]


class TorchDeviceStep(DeviceStep):
    """The pool, the step and the sampling streams on one torch device
    (default: the card).  ``attn_impl`` is resolved from the device
    (``'auto'``: the kernel on the card, the plain version on the CPU);
    so is ``moe_dispatch`` for an MoE config (None defers to
    ``cfg.moe_dispatch``), once, here.  ``ep_group``: the expert-parallel
    group the MoE layers exchange over; ``cp_group``: the context-parallel
    group whose ranks each hold a block slice of the pool (the step is
    then :func:`~.paged_cache.cp_paged_forward`); ``tp_group``: the
    tensor-parallel group whose ranks each hold their shard of the
    parameters and ``Hkv / tp`` heads of the pool — the step gathers the
    full logits (``models.generate._full_logits``) before it samples.
    ``tp_group`` composes with ``ep_group`` or ``cp_group``.

    The ranks of these groups form one replica, and every step makes the
    replica take its first rank's sampled tokens by one broadcast over
    the replica's group: the one group given, or, when ``tp_group`` is
    composed with ``ep_group`` or ``cp_group``, ``replica_group``
    (``dist.ParallelContext.replica_group``: every axis but the data
    one), which is then required.  A broadcast over one axis of a TP x EP
    or TP x CP replica alone would leave the ranks of the other axis free
    to differ at a near-tie, and ranks that schedule differently hang in
    the next collective.

    ``dp_group``: the engine's data-parallel slot groups (JAX
    ``dp_axis``) — this rank is replica ``g = dist.get_rank(dp_group)``
    of ``dp``, its pool is group ``g``'s (block ids local to the group),
    and it runs only slot rows ``[g spg, (g + 1) spg)``; the sampled
    tokens (with the verify / accept rows and the MoE statistics) are
    then gathered over the data group, so every rank's host holds every
    group's results.  Over gloo the gather moves the host copy the step
    reads back anyway; over NCCL the device tensor."""

    def __init__(self, cfg: GPTConfig, device=None,
                 attn_impl: str = "auto",
                 moe_dispatch: Optional[str] = None, ep_group=None,
                 cp_group=None, tp_group=None, dp_group=None,
                 replica_group=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.attn_impl = resolve_attn_impl(attn_impl, self.device)
        self.moe_dispatch = None
        self.ep_group = ep_group
        self.cp_group = cp_group
        self.tp_group = tp_group
        self.dp_group = dp_group
        self.cp = 1 if cp_group is None else dist.get_world_size(cp_group)
        self.tp = 1 if tp_group is None else dist.get_world_size(tp_group)
        self.dp = 1 if dp_group is None else dist.get_world_size(dp_group)
        #: this rank's data group, and its slot rows (set by bind)
        self.group_index = 0 if dp_group is None else dist.get_rank(dp_group)
        self.rows = slice(None)
        groups = [g for g in (tp_group, ep_group, cp_group)
                  if g is not None]
        if replica_group is None and len(groups) > 1:
            raise ValueError(
                "tp_group beside ep_group or cp_group needs replica_group= "
                "(dist.ParallelContext.replica_group): the group over every "
                "rank of the replica, whose first rank's tokens they all "
                "take")
        #: the group whose first rank's tokens every rank of it takes
        self.replica_group = (replica_group if replica_group is not None
                              else (groups[0] if groups else None))
        if cfg.moe_experts:
            self.moe_dispatch = resolve_serving_dispatch(
                cfg.moe_dispatch if moe_dispatch is None else moe_dispatch,
                self.device, ep=ep_group is not None)

    def bind(self, engine: Any) -> None:
        spg = engine.slots_per_group
        self.rows = slice(self.group_index * spg,
                          (self.group_index + 1) * spg)

    def init_cache(self, num_blocks: int, block_size: int,
                   quantized: bool) -> Any:
        return init_paged_kv(self.cfg, num_blocks, block_size,
                             quantized=quantized, device=self.device,
                             cp=self.cp, axis_size=self.tp)

    def stream(self, seed: int) -> torch.Generator:
        """A request's private sampling stream, seeded from its seed."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def stream_state(self, stream: torch.Generator) -> List[int]:
        """The generator's state as ints (a host read: on CUDA the Philox
        seed and offset the host keeps, no device sync)."""
        return [int(b) for b in stream.get_state().tolist()]

    def restore_stream(self, state: Sequence[int]) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.set_state(torch.tensor(list(state), dtype=torch.uint8))
        return g

    def cow(self, cache: Any, src: np.ndarray, dst: np.ndarray) -> Any:
        """:func:`~.paged_cache.copy_blocks` on the pool's stream, ordered
        before the next step's writes by the stream itself; under
        ``dp_group`` the lanes of this rank's group only (its pool)."""
        return copy_blocks(cache, src[self.rows], dst[self.rows])

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the step's device, without a stream sync: a
        blocking upload would wait for every kernel queued before it (the
        sampling inputs are uploaded after the forward's launches), so the
        host would stall there instead of at the one read-back.  From
        pageable memory the copy takes the bytes before it returns, so
        the engine may rewrite ``a`` at once."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, non_blocking=True)

    def _local(self, samp: Dict[str, np.ndarray], streams: List[Any],
               *arrays: np.ndarray):
        """This rank's rows of the step's inputs, and the sampled streams
        of the other data groups' rows: :meth:`_skip` advances them by
        the draws their own group takes, so a stream's state — what a
        drain or an export reads on any rank — is the same on every
        rank."""
        r = self.rows
        local = [a[r] for a in arrays]
        samp_l = {k: v[r] for k, v in samp.items()}
        if self.dp_group is None:
            return local, samp_l, streams, []
        mine = set(range(len(streams))[r])
        others = [g for i, g in enumerate(_sampled(streams, samp))
                  if i not in mine and g is not None]
        return local, samp_l, streams[r], others

    def _skip(self, others: List[torch.Generator], n: int) -> None:
        for g in others:
            torch.rand(n, generator=g, device=self.device)

    def _agree(self, t: torch.Tensor) -> None:
        """Every rank of the replica takes its first rank's ``t``: a
        near-tied argmax may flip on one rank only (EP: the f32 walks sum
        by atomics; CP: each rank's combine sums in its own order)."""
        if self.replica_group is not None:
            note("broadcast", t, self.replica_group)
            dist.broadcast(t, src=dist.get_global_rank(self.replica_group, 0),
                           group=self.replica_group)

    def _gather(self, t: torch.Tensor) -> np.ndarray:
        """``t`` [n, ...] of every data group, stacked [dp, n, ...] on the
        host (one read-back); the rank's own without a data group."""
        if self.dp_group is None:
            return t.cpu().numpy()[None]
        if dist.get_backend(self.dp_group) == "gloo":
            t = t.cpu()
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.dp)]
        note("all-gather", t, self.dp_group)
        dist.all_gather(parts, t, group=self.dp_group)
        return torch.stack(parts).cpu().numpy()

    @torch.no_grad()
    def step(self, params: Any, cache: Any, tokens: np.ndarray,
             tables: np.ndarray, offsets: np.ndarray, last_idx: np.ndarray,
             samp: Dict[str, np.ndarray],
             streams: List[Optional[torch.Generator]]
             ) -> Tuple[Any, np.ndarray, MoEStats]:
        """ONE step serves both phases: ``tokens [B, 1]`` is decode,
        ``[B, chunk]`` a prefill slice.  Host arrays in, host tokens
        ``[B]`` out; everything between runs on the device.  For an MoE
        config the third element is the step's ``(expert_tokens [E],
        dropped_token_rate)``, read back in the same host copy as the
        tokens (one read-back a step, ``t_enqueued`` marked just before
        it) — under ``dp_group`` the groups'
        counts summed and their drop rates averaged (JAX's host does the
        same with its per-group out_specs rows); None for a dense
        config."""
        (tokens, tables, offsets, last_idx), samp, streams, others = \
            self._local(samp, streams, tokens, tables, offsets, last_idx)
        args = (params, self._to_dev(tokens), self.cfg, cache,
                self._to_dev(tables), self._to_dev(offsets))
        kw = dict(last_idx=self._to_dev(last_idx), attn_impl=self.attn_impl,
                  tp_group=self.tp_group)
        moe = None
        if self.cfg.moe_experts:
            cache, logits, moe = paged_forward_moe(
                *args, moe_dispatch=self.moe_dispatch, moe_stats=True,
                ep_group=self.ep_group, **kw)
        elif self.cp_group is not None:
            cache, logits = cp_paged_forward(*args, cp_group=self.cp_group,
                                             **kw)
        else:
            cache, logits = paged_forward(*args, **kw)
        tok = _slot_sample(_full_logits(logits, self.cfg, self.tp_group),
                           _sampled(streams, samp),
                           self._to_dev(samp["temperature"]),
                           self._to_dev(samp["top_k"]),
                           self._to_dev(samp["top_p"]))
        self._skip(others, self.cfg.vocab_size)
        self._agree(tok)
        B = tok.shape[0]
        if moe is None:
            self.t_enqueued = time.perf_counter()
            host = self._gather(tok.to(torch.int32))
            return cache, host.reshape(-1), None
        # float64 holds every int32 token id exactly
        both = torch.cat([tok.double(), moe["expert_tokens"].double(),
                          moe["dropped_token_rate"].double().reshape(1)])
        self.t_enqueued = time.perf_counter()
        host = self._gather(both)
        return (cache, host[:, :B].reshape(-1).astype(np.int32),
                (host[:, B:-1].sum(0), float(host[:, -1].mean())))

    @torch.no_grad()
    def verify(self, params: Any, cache: Any, tokens: np.ndarray,
               tables: np.ndarray, offsets: np.ndarray,
               samp: Dict[str, np.ndarray],
               streams: List[Optional[torch.Generator]]
               ) -> Tuple[Any, np.ndarray, np.ndarray]:
        """The speculative verify step (JAX ``engine.py:703-790``):
        ``tokens [B, K+1]`` is each slot's last token and its K drafts at
        offsets ``length..length+K``, run through the paged forward with
        ``all_logits`` (every position's distribution in one call, one
        K1 launch a layer), then judged by :meth:`judge`.  Host arrays
        in; ``(cache, verify [B, K+1], accept [B, K])`` out, in one
        read-back, ``t_enqueued`` marked just before it.  The replica takes its first rank's verdict, as
        :meth:`step` takes its tokens, and a data group's rows are
        gathered alike."""
        K1 = tokens.shape[1]
        (tokens, tables, offsets), samp, streams, others = self._local(
            samp, streams, tokens, tables, offsets)
        tok = self._to_dev(tokens)
        args = (params, tok, self.cfg, cache, self._to_dev(tables),
                self._to_dev(offsets))
        kw = dict(attn_impl=self.attn_impl, all_logits=True,
                  tp_group=self.tp_group)
        if self.cfg.moe_experts:
            cache, logits = paged_forward_moe(
                *args, moe_dispatch=self.moe_dispatch,
                ep_group=self.ep_group, **kw)
        else:
            cache, logits = paged_forward(*args, **kw)
        ver, acc = self.judge(_full_logits(logits, self.cfg, self.tp_group),
                              tok, samp, _sampled(streams, samp))
        self._skip(others, K1 - 1 + K1 * self.cfg.vocab_size)
        both = torch.cat([ver, acc.long()], dim=1)
        self._agree(both)
        self.t_enqueued = time.perf_counter()
        host = self._gather(both.to(torch.int32))
        host = host.reshape(-1, host.shape[-1])
        return cache, host[:, :K1], host[:, K1:]

    def judge(self, logits: torch.Tensor, tokens: torch.Tensor,
              samp: Dict[str, np.ndarray],
              gens: List[Optional[torch.Generator]]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each slot's verdict on its drafts ``tokens[:, 1:]`` from the
        logits ``[B, K+1, V]`` at its K+1 positions.  Greedy rows (no
        generator: temperature <= 0, or an idle slot) accept while the
        draft equals the argmax, and ``verify`` is the argmax row —
        exact, so greedy output equals plain decode.  Sampled rows run
        residual rejection sampling against the ``_filtered_logits``
        distribution p (a draft is a point mass: accept draft i iff u_i <
        p(draft_i); a rejection draws from p with the draft's mass
        removed, or the filtered argmax when nothing is left), with a
        fixed 2K + 1 draws from the slot's generator a call — K
        uniforms, K residual draws and one bonus draw, each draw a
        Gumbel-max over V uniforms — taken by one ``torch.rand``, so a
        replay consumes the stream alike.  Returns ``(verify [B, K+1],
        accept [B, K] bool)`` on the device: ``verify[:, i]`` is the
        token emitted when draft i is the first rejection, column K the
        bonus when every draft survives."""
        x = logits.float()
        B, K1, V = x.shape
        K = K1 - 1
        greedy = torch.argmax(x, dim=-1)
        drafts = tokens[:, 1:].long()
        ver, acc = greedy.clone(), drafts == greedy[:, :K]
        rows = [i for i, g in enumerate(gens) if g is not None]
        if not rows:
            return ver, acc
        idx = torch.tensor(rows).to(x.device, non_blocking=True)
        temp = self._to_dev(samp["temperature"])[idx]
        xf = _filtered_logits(
            x[idx].reshape(-1, V), temp.repeat_interleave(K1),
            self._to_dev(samp["top_k"])[idx].repeat_interleave(K1),
            self._to_dev(samp["top_p"])[idx].repeat_interleave(K1)
        ).reshape(len(rows), K1, V)
        d = drafts[idx]
        p_draft = torch.softmax(xf[:, :K], dim=-1).gather(
            -1, d[..., None])[..., 0]
        r = torch.stack([torch.rand(K + K1 * V, generator=gens[i],
                                    device=x.device) for i in rows])
        u = r[:, :K]
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(
            r[:, K:].reshape(len(rows), K1, V).clamp_min(tiny)))
        xr = xf[:, :K].scatter(-1, d[..., None], float("-inf"))
        resid = torch.argmax(xr + gumbel[:, :K], dim=-1)
        has = xr.amax(-1) > float("-inf")
        resid = torch.where(has, resid, torch.argmax(xf[:, :K], dim=-1))
        bonus = torch.argmax(xf[:, K] + gumbel[:, K], dim=-1)
        sampled = (temp > 0.0)[:, None]
        ver[idx] = torch.where(sampled, torch.cat([resid, bonus[:, None]],
                                                  dim=1), ver[idx])
        acc[idx] = torch.where(sampled, u < p_draft, acc[idx])
        return ver, acc


class LatencyModel:
    """Predicted seconds a stub call (JAX :136): an affine model a
    program, ``base_s + per_token_s * rows * width`` — dispatch overhead
    plus linear token work.  The defaults are CPU-scale magnitudes, good
    for relative policy curves, not for absolute TTFT claims."""

    def __init__(self, prefill_base_s: float = 4e-4,
                 prefill_per_token_s: float = 6e-6,
                 decode_base_s: float = 3e-4,
                 decode_per_token_s: float = 2e-5,
                 verify_base_s: float = 4e-4,
                 verify_per_token_s: float = 8e-6,
                 cow_s: float = 1e-4) -> None:
        self.coeffs = {
            "prefill": (prefill_base_s, prefill_per_token_s),
            "decode": (decode_base_s, decode_per_token_s),
            "verify": (verify_base_s, verify_per_token_s),
            "cow": (cow_s, 0.0),
        }

    def step_s(self, kind: str, rows: int, width: int = 1) -> float:
        base, per_tok = self.coeffs[kind]
        return base + per_tok * rows * width


class StubStream:
    """The stub's sampling stream: the reference stub's two-word key
    (``uint32[2]``, the threefry layout), advanced in place."""

    __slots__ = ("key",)

    def __init__(self, key) -> None:
        self.key = np.asarray(key, np.uint32).reshape(2).copy()


class StubDeviceStep(DeviceStep):
    """Host-only :class:`DeviceStep` (JAX :168): a numpy pool, hash
    tokens, modeled latency.  A greedy row's token depends only on (its
    input token, its position) — both restored by a drain descriptor or
    an export — and a sampled row's also on its stream's key, which the
    descriptors carry; so an interrupted request continues on the stub
    exactly as it does on the real step.  ``calls`` / ``sim_s`` count
    the calls and their modeled device seconds (``sim_summary()``)."""

    host_only = True

    def __init__(self, latency: Optional[LatencyModel] = None) -> None:
        self.latency = latency if latency is not None else LatencyModel()
        self.calls: Dict[str, int] = {
            "prefill": 0, "decode": 0, "verify": 0, "cow": 0}
        self.sim_s = 0.0
        self.device = torch.device("cpu")
        self.attn_impl = resolve_attn_impl("auto", self.device)

    def bind(self, engine: Any) -> None:
        self.vocab_size = engine.cfg.vocab_size
        if engine.cfg.moe_experts:
            self.moe_dispatch = resolve_serving_dispatch(
                engine.cfg.moe_dispatch, self.device)

    def _charge(self, kind: str, rows: int, width: int = 1) -> None:
        self.calls[kind] += 1
        self.sim_s += self.latency.step_s(kind, rows, width)

    def sim_summary(self) -> Dict[str, Any]:
        return {"sim_device_s": round(self.sim_s, 6),
                "calls": dict(self.calls)}

    def init_cache(self, num_blocks: int, block_size: int,
                   quantized: bool) -> Any:
        # the real block layout at one byte a position: dim 1 is the block
        # dim the lane copies index, shape[3] the block size
        shape = (1, num_blocks, 1, block_size, 1)
        return {"k": np.zeros(shape, np.int8), "v": np.zeros(shape, np.int8)}

    # ------------------------------------------------------------ tokens

    def _keys(self, streams: List[Optional[StubStream]]) -> np.ndarray:
        return np.stack([s.key if s is not None
                         else np.zeros(2, np.uint32) for s in streams])

    def _tokens(self, keys: np.ndarray, last_tok: np.ndarray,
                pos: np.ndarray, temps: np.ndarray) -> np.ndarray:
        vocab = np.uint64(self.vocab_size)
        h = (last_tok.astype(np.uint64) * _MIX_A) ^ (
            pos.astype(np.uint64) * _MIX_B)
        h_sampled = h ^ (keys[:, 0].astype(np.uint64) << np.uint64(17)) ^ (
            keys[:, 1].astype(np.uint64))
        h = np.where(temps <= 0.0, h, h_sampled)
        return (h % vocab).astype(np.int32)

    @staticmethod
    def _advance(streams: List[Optional[StubStream]]) -> None:
        live = [s for s in streams if s is not None]
        if not live:
            return
        keys = np.stack([s.key for s in live])
        mixed = (keys[:, 0].astype(np.uint64) * _LCG_MUL
                 + keys[:, 1].astype(np.uint64) * _LCG_ADD + np.uint64(1))
        for s, m in zip(live, mixed):
            s.key = np.array([m >> np.uint64(32), m & np.uint64(0xFFFFFFFF)],
                             np.uint32)

    # ---------------------------------------------------------- programs

    def step(self, params, cache, tokens, tables, offsets, last_idx, samp,
             streams):
        B, S = tokens.shape
        self._charge("prefill" if S > 1 else "decode", B, S)
        last_tok = tokens[np.arange(B), last_idx]
        tok = self._tokens(self._keys(streams), last_tok,
                           offsets + last_idx, samp["temperature"])
        self._advance(streams)
        return cache, tok, None

    def verify(self, params, cache, tokens, tables, offsets, samp, streams):
        B, K1 = tokens.shape
        K = K1 - 1
        self._charge("verify", B, K1)
        temps = samp["temperature"]
        keys = self._keys(streams)
        # position j's token from (token j, offset + j): the plain step's
        # function, so a greedy verify equals plain stub decode
        ver = np.stack([self._tokens(keys, tokens[:, j], offsets + j, temps)
                        for j in range(K1)], axis=1).astype(np.int32)
        acc = (tokens[:, 1:] == ver[:, :K]).astype(np.int32)
        acc[temps > 0.0] = 0  # no acceptance distribution is modeled
        self._advance(streams)
        return cache, ver, acc

    def cow(self, cache, src, dst):
        self._charge("cow", len(src))
        for leaf in (cache["k"], cache["v"]):
            leaf[:, dst] = leaf[:, src]
        return cache

    def stream(self, seed: int) -> StubStream:
        # the threefry key layout of the seed, [hi32, lo32]
        s = np.uint64(int(seed) & 0xFFFFFFFFFFFFFFFF)
        return StubStream([s >> np.uint64(32), s & np.uint64(0xFFFFFFFF)])

    def stream_state(self, stream: StubStream) -> List[int]:
        return [int(v) for v in stream.key]

    def restore_stream(self, state: Sequence[int]) -> StubStream:
        return StubStream(state)


def host_migrate_blocks(src_cache: Dict[str, Any], dst_cache: Dict[str, Any],
                        src_ids, dst_ids, compress: bool = False
                        ) -> Dict[str, Any]:
    """Numpy twin of :func:`~.paged_cache.migrate_blocks` for host-only
    pools (JAX :273): ``dst[:, dst_ids[i]] = src[:, src_ids[i]]`` a leaf.
    ``src_cache`` may be a :class:`~.paged_cache.PoolSnapshot`.
    ``compress`` is accepted for the signature: the int8 stub pool is at
    wire precision already."""
    del compress
    if isinstance(src_cache, PoolSnapshot):
        src_ids = src_cache.rows(src_ids)
    src_ids, dst_ids = np.asarray(src_ids), np.asarray(dst_ids)
    for name, d_leaf in dst_cache.items():
        d_leaf[:, dst_ids] = src_cache[name][:, src_ids]
    return dst_cache
