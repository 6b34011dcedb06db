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

from ..device import resolve_device
from ..models.gpt import GPTConfig
from ..ops.paged_attention import resolve_attn_impl
from .engine import _slot_sample
from .paged_cache import init_paged_kv, paged_forward


class TorchDeviceStep:
    """The pool, the step and the sampling streams on one torch device
    (default: the card).  ``attn_impl`` is resolved from the device
    (``'auto'``: the kernel on the card, the plain version on the CPU)."""

    def __init__(self, cfg: GPTConfig, device=None,
                 attn_impl: str = "auto") -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.attn_impl = resolve_attn_impl(attn_impl, self.device)

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
             gens: List[Optional[torch.Generator]]) -> Tuple[Any, np.ndarray]:
        """ONE step serves both phases: ``tokens [B, 1]`` is decode,
        ``[B, chunk]`` a prefill slice.  Host arrays in, host tokens
        ``[B]`` out; everything between runs on the device."""
        cache, logits = paged_forward(
            params, self._to_dev(tokens), self.cfg, cache,
            self._to_dev(tables), self._to_dev(offsets),
            last_idx=self._to_dev(last_idx), attn_impl=self.attn_impl)
        tok = _slot_sample(logits, gens, self._to_dev(samp["temperature"]),
                           self._to_dev(samp["top_k"]),
                           self._to_dev(samp["top_p"]))
        return cache, tok.to(torch.int32).cpu().numpy()
