"""The engine's device touches on one torch device — the PyTorch
counterpart of ``torchdistpackage_tpu/serving/sim.py`` (``DeviceStep``
:54, ``CompiledDeviceStep`` :101).

``ServingEngine`` touches the device in three places: the pool
allocation, the shared prefill/decode step, and the per-request sampling
stream.  :class:`TorchDeviceStep` holds all three, and the engine builds
it itself.  The reference puts its step behind a ``DeviceStep`` seam so
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
from .engine import _slot_sample
from .paged_cache import (
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
    group the MoE layers exchange over; each step then broadcasts rank
    0's sampled tokens to the group."""

    def __init__(self, cfg: GPTConfig, device=None,
                 attn_impl: str = "auto",
                 moe_dispatch: Optional[str] = None, ep_group=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.attn_impl = resolve_attn_impl(attn_impl, self.device)
        self.moe_dispatch = None
        self.ep_group = ep_group
        if cfg.moe_experts:
            self.moe_dispatch = resolve_serving_dispatch(
                cfg.moe_dispatch if moe_dispatch is None else moe_dispatch,
                self.device, ep=ep_group is not None)

    def init_cache(self, num_blocks: int, block_size: int,
                   quantized: bool) -> Any:
        return init_paged_kv(self.cfg, num_blocks, block_size,
                             quantized=quantized, device=self.device)

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
        else:
            cache, logits = paged_forward(*args, **kw)
        tok = _slot_sample(logits, gens, self._to_dev(samp["temperature"]),
                           self._to_dev(samp["top_k"]),
                           self._to_dev(samp["top_p"]))
        if self.ep_group is not None:
            # every rank takes rank 0's tokens: a row whose argmax is a
            # near-tie may flip on one rank only (the F-tile atomics sum in
            # another order), and ranks that schedule differently hang
            # in the next exchange
            dist.broadcast(tok, src=dist.get_global_rank(self.ep_group, 0),
                           group=self.ep_group)
        if moe is None:
            return cache, tok.to(torch.int32).cpu().numpy(), None
        # float64 holds every int32 token id exactly
        host = torch.cat([tok.double(), moe["expert_tokens"].double(),
                          moe["dropped_token_rate"].double().reshape(1)]
                         ).cpu().numpy()
        B = tok.shape[0]
        return (cache, host[:B].astype(np.int32),
                (host[B:-1], float(host[-1])))
