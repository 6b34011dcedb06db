"""The train step — the single-device branch of
``torchdistpackage_tpu/parallel/data_parallel.py``'s
``DataParallel.make_train_step`` (:443) and of ``bench.py``'s step
(:421-427).  Data parallelism over several cards is queued (ROADMAP A4).

The optimizer is optax's ``adamw`` as ``torch.optim.AdamW``:
:func:`adamw` keeps optax's defaults (betas 0.9 / 0.999, eps 1e-8,
weight decay 1e-4 on every leaf — torch's own default is 1e-2), and the
moments take the parameters' dtype, as optax's do.  Both update
``p <- p - lr * (m̂ / (sqrt(v̂) + eps) + wd * p)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from ..obs.numerics import global_grad_norm, tree_leaves


#: optax ``adamw``'s defaults (torch's own weight decay default is 1e-2)
BETAS, EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax-style handle: ``opt_state = adamw(3e-4).init(params)``."""

    lr: float = 3e-4

    def init(self, params: Dict[str, Any]) -> torch.optim.AdamW:
        """Marks every leaf of ``params`` as trainable and returns the
        optimizer over them (its state is the optax state's
        counterpart)."""
        leaves = list(tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        return torch.optim.AdamW(leaves, lr=self.lr, betas=BETAS, eps=EPS,
                                 weight_decay=WEIGHT_DECAY)


def adamw(lr: float = 3e-4) -> AdamW:
    """optax ``adamw(lr)`` with its defaults (see the module note)."""
    return AdamW(lr=lr)


def make_train_step(loss_fn: Callable[[Dict[str, Any], Dict[str, Any]],
                                      torch.Tensor],
                    optimizer: AdamW, numerics: bool = False):
    """``step(params, opt_state, batch) -> (params, opt_state, loss,
    gnorm)``: the loss and its gradients by autograd, the global gradient
    norm, one AdamW update.  ``opt_state`` is ``optimizer.init(params)``.

    Unlike the reference's functional step, the update is in place: the
    returned ``params`` is the same dict, its leaves updated, and the
    optimizer's moments live in ``opt_state``.  ``loss`` and ``gnorm`` are
    0-dim tensors on the device (reading them syncs).  ``numerics=True``
    returns a dict instead of ``gnorm``: ``grad_norm``, ``param_norm``
    (before the update) and ``nonfinite_grads``."""
    if not isinstance(optimizer, AdamW):
        raise TypeError(
            f"optimizer must be the port's adamw(), got {type(optimizer)}")

    def step(params: Dict[str, Any], opt_state: torch.optim.AdamW,
             batch: Dict[str, Any]) -> Tuple[Dict[str, Any], Any,
                                             torch.Tensor, Any]:
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch)
        loss.backward()
        grads = [p.grad for p in tree_leaves(params)]
        if any(g is None for g in grads):
            # AdamW would skip the leaf, weight decay included, where
            # optax decays every leaf
            raise RuntimeError("a parameter leaf got no gradient")
        gnorm = global_grad_norm(grads)
        if numerics:
            with torch.no_grad():
                stats = {
                    "grad_norm": gnorm,
                    "param_norm": global_grad_norm(
                        [p.detach() for p in tree_leaves(params)]),
                    "nonfinite_grads": sum(
                        (~torch.isfinite(g)).sum() for g in grads),
                }
        opt_state.step()
        return params, opt_state, loss.detach(), stats if numerics else gnorm

    return step
