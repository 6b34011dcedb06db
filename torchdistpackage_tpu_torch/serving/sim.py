"""The engine's device touches on one torch device — the PyTorch
counterpart of ``torchdistpackage_tpu/serving/sim.py`` (``DeviceStep``
:54, ``CompiledDeviceStep`` :101).

``ServingEngine`` touches the device in four places: the pool
allocation, the shared prefill/decode step, the speculative verify step
(``spec_k``) and the per-request sampling stream.
:class:`TorchDeviceStep` holds all four, and the engine builds it
itself.  The reference puts its step behind a ``DeviceStep`` seam so
that a host-only ``StubDeviceStep`` can stand in; neither the seam nor
the stub is ported yet (ROADMAP queue A).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.gpt import GPTConfig
from ..ops.paged_attention import resolve_attn_impl
from .engine import _filtered_logits, _slot_sample
from .paged_cache import (
    cp_paged_forward,
    init_paged_kv,
    paged_forward,
    paged_forward_moe,
    resolve_serving_dispatch,
)

MoEStats = Optional[Tuple[np.ndarray, float]]


class TorchDeviceStep:
    """The pool, the step and the sampling streams on one torch device
    (default: the card).  ``attn_impl`` is resolved from the device
    (``'auto'``: the kernel on the card, the plain version on the CPU);
    so is ``moe_dispatch`` for an MoE config (None defers to
    ``cfg.moe_dispatch``), once, here.  ``ep_group``: the expert-parallel
    group the MoE layers exchange over; ``cp_group``: the context-parallel
    group whose ranks each hold a block slice of the pool (the step is
    then :func:`~.paged_cache.cp_paged_forward`).  With either, each step
    broadcasts the group's rank 0's sampled tokens to the group."""

    def __init__(self, cfg: GPTConfig, device=None,
                 attn_impl: str = "auto",
                 moe_dispatch: Optional[str] = None, ep_group=None,
                 cp_group=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.attn_impl = resolve_attn_impl(attn_impl, self.device)
        self.moe_dispatch = None
        self.ep_group = ep_group
        self.cp_group = cp_group
        self.cp = 1 if cp_group is None else dist.get_world_size(cp_group)
        if cfg.moe_experts:
            self.moe_dispatch = resolve_serving_dispatch(
                cfg.moe_dispatch if moe_dispatch is None else moe_dispatch,
                self.device, ep=ep_group is not None)

    def init_cache(self, num_blocks: int, block_size: int,
                   quantized: bool) -> Any:
        return init_paged_kv(self.cfg, num_blocks, block_size,
                             quantized=quantized, device=self.device,
                             cp=self.cp)

    def generator(self, seed: int) -> torch.Generator:
        """A request's private sampling stream, seeded from its seed."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.no_grad()
    def step(self, params: Any, cache: Any, tokens: np.ndarray,
             tables: np.ndarray, offsets: np.ndarray, last_idx: np.ndarray,
             samp: Dict[str, np.ndarray],
             gens: List[Optional[torch.Generator]]
             ) -> Tuple[Any, np.ndarray, MoEStats]:
        """ONE step serves both phases: ``tokens [B, 1]`` is decode,
        ``[B, chunk]`` a prefill slice.  Host arrays in, host tokens
        ``[B]`` out; everything between runs on the device.  For an MoE
        config the third element is the step's ``(expert_tokens [E],
        dropped_token_rate)``, read back in the same host copy as the
        tokens (one read-back a step); None for a dense config."""
        args = (params, self._to_dev(tokens), self.cfg, cache,
                self._to_dev(tables), self._to_dev(offsets))
        kw = dict(last_idx=self._to_dev(last_idx), attn_impl=self.attn_impl)
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
        tok = _slot_sample(logits, gens, self._to_dev(samp["temperature"]),
                           self._to_dev(samp["top_k"]),
                           self._to_dev(samp["top_p"]))
        group = self.ep_group if self.ep_group is not None else self.cp_group
        if group is not None:
            # every rank takes rank 0's tokens (the reference's pmax): a
            # row whose argmax is a near-tie may flip on one rank only (EP:
            # the F-tile atomics sum in another order; CP: each rank's
            # combine sums in its own order), and ranks that schedule
            # differently hang in the next collective
            dist.broadcast(tok, src=dist.get_global_rank(group, 0),
                           group=group)
        if moe is None:
            return cache, tok.to(torch.int32).cpu().numpy(), None
        # float64 holds every int32 token id exactly
        host = torch.cat([tok.double(), moe["expert_tokens"].double(),
                          moe["dropped_token_rate"].double().reshape(1)]
                         ).cpu().numpy()
        B = tok.shape[0]
        return (cache, host[:B].astype(np.int32),
                (host[B:-1], float(host[-1])))

    @torch.no_grad()
    def verify(self, params: Any, cache: Any, tokens: np.ndarray,
               tables: np.ndarray, offsets: np.ndarray,
               samp: Dict[str, np.ndarray],
               gens: List[Optional[torch.Generator]]
               ) -> Tuple[Any, np.ndarray, np.ndarray]:
        """The speculative verify step (JAX ``engine.py:703-790``):
        ``tokens [B, K+1]`` is each slot's last token and its K drafts at
        offsets ``length..length+K``, run through the paged forward with
        ``all_logits`` (every position's distribution in one call, one
        K1 launch a layer), then judged by :meth:`judge`.  Host arrays
        in; ``(cache, verify [B, K+1], accept [B, K])`` out, in one
        read-back.  Under EP every rank takes rank 0's verdict, as
        :meth:`step` takes its tokens."""
        tok = self._to_dev(tokens)
        args = (params, tok, self.cfg, cache, self._to_dev(tables),
                self._to_dev(offsets))
        kw = dict(attn_impl=self.attn_impl, all_logits=True)
        if self.cfg.moe_experts:
            cache, logits = paged_forward_moe(
                *args, moe_dispatch=self.moe_dispatch,
                ep_group=self.ep_group, **kw)
        else:
            cache, logits = paged_forward(*args, **kw)
        ver, acc = self.judge(logits, tok, samp, gens)
        both = torch.cat([ver, acc.long()], dim=1)
        if self.ep_group is not None:
            dist.broadcast(both, src=dist.get_global_rank(self.ep_group, 0),
                           group=self.ep_group)
        host = both.to(torch.int32).cpu().numpy()
        K1 = tokens.shape[1]
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
        idx = torch.tensor(rows, device=x.device)
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
