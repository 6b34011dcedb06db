"""Mixture-of-Experts — the PyTorch counterpart of
``torchdistpackage_tpu/parallel/moe.py``: :class:`MoEConfig` (:48), the
dispatch resolution (``_DENSE_DISPATCH_MAX``, ``_use_sorted``, :113-131),
``_top_k_route`` (:134), ``_dense_topk_tensors`` (:183),
``_expert_choice_dispatch`` (:199), ``_load_balance_loss`` (:227),
``_expert_ffn`` (:242), ``_router_metrics`` (:254),
``check_expert_overflow`` (:297), ``moe_forward`` (:323) with its
expert-parallel exchange, ``moe_serve_forward`` (:501),
``init_moe_params`` (:608), ``moe_param_specs`` (:632, and its placement
as slices, :func:`shard_experts`) and ``moe_grad_reduce_overrides``
(:649).

``moe_serve_forward`` routes every token to its top-k experts with no
capacity (exact, no drops) and runs the expert FFN through one of two
arms: ``'gather'`` sorts the ``T k`` assignments by expert and runs one
product per expert over its row group (the reference's ragged path,
plain PyTorch), ``'cuda'`` hands the routing to the fused kernel K6
(``ops/moe_dispatch.py``) at the no-drop capacity ``C = T``, float or
int8 weight-only experts.  ``'auto'`` picks ``'cuda'`` on a CUDA device
and ``'gather'`` on the CPU.  The port's ``'cuda'`` stands where the
reference says ``'pallas'``.

``moe_forward`` is the capacity path, forward and backward: the
token-choice router (top-k at a capacity of ``ceil(T k cf / E)`` slots
an expert, drops past it) or the expert-choice router (each expert picks
its top ``ceil(T cf / E)`` tokens; non-causal, refused under
``causal=True``), materialised as ``'dense'`` ``[T, E, C]`` one-hot
products, the ``'sorted'`` index dispatch into an ``[E, C, D]`` slot
layout, or ``'cuda'`` (token-choice only): K6 on the routing directly,
or under expert parallelism the sorted layout with K7 on the exchanged
groups.  Under expert parallelism (``ep_group``, a ``torch.distributed``
process group) every rank holds ``E / ep`` experts (:func:`shard_experts`)
and the slots go to their experts' ranks and back by two
``all_to_all_single`` exchanges (``tp_utils.all_to_all``), each an
autograd Function whose backward is the same exchange of the cotangent
(the transpose of the reference's ``all_to_all``).  An expert's grad on its rank then holds
every EP peer's tokens — the overcount that the data-parallel reduction
divides out (expert grads summed over ``moe_dp`` only, divided by the
whole data group: :func:`moe_grad_reduce_overrides`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..dist.topology import EXPERT_AXIS, MOE_DATA_AXIS
from ..ops.moe_dispatch import (
    _is_q,
    ffn_rows,
    fused_expert_ffn,
    fused_moe_ffn,
    resolve_moe_dispatch,
)
from .tensor_parallel.layers import _normal
from .tensor_parallel.tp_utils import all_to_all

Params = Dict[str, Any]

#: Above this many dense-dispatch elements (``T E C``) ``'auto'`` takes
#: the index (``'sorted'``) dispatch where it does not take the kernel —
#: the reference's threshold.
_DENSE_DISPATCH_MAX = 1 << 24


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference's ``MoEConfig``.  ``dtype`` is a ``torch.dtype``.
    ``router``: ``'topk'`` (token choice) | ``'expert_choice'``.
    ``dispatch``: ``'auto'`` | ``'gather'`` (the serving path's ragged
    arm) | ``'dense'`` / ``'sorted'`` (the capacity path's one-hot and
    index materialisations) | ``'cuda'`` (the reference's ``'pallas'``:
    K6, or K7 under EP; token choice only).  ``act``: ``'gelu'`` |
    ``'swiglu'`` (stacked ``[E, 2, D, F]`` gate/up, the Mixtral
    expert)."""

    dim: int
    ffn_dim: int
    num_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2
    dtype: torch.dtype = torch.float32
    router: str = "topk"
    dispatch: str = "auto"
    act: str = "gelu"

    def __post_init__(self):
        if self.router not in ("topk", "expert_choice"):
            raise ValueError(f"unknown MoE router {self.router!r}")
        if self.dispatch not in ("auto", "gather", "dense", "sorted",
                                 "cuda"):
            raise ValueError(f"unknown MoE dispatch {self.dispatch!r}")
        if self.dispatch == "cuda" and self.router != "topk":
            raise ValueError(
                "dispatch='cuda' consumes a _top_k_route decision; the "
                "expert_choice router has no (gate_idx, slot, keep) form")
        if self.act not in ("gelu", "swiglu"):
            raise ValueError(f"unknown MoE act {self.act!r}")
        if not 1 <= self.top_k <= self.num_experts:
            raise ValueError(
                f"top_k must be in [1, {self.num_experts}], got {self.top_k}")


def _top_k_gates(probs: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each token's top-k experts and their gates, renormalised over the
    k choices with ``max(sum, 1e-9)``."""
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    return (gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9),
            gate_idx)


def _top_k_route(probs: torch.Tensor, k: int, capacity: int,
                 priority: str = "choice"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """The routing decision.  probs ``[T, E]`` -> ``gate_vals`` [T, k]
    (renormalised over the choices, ``max(sum, 1e-9)``), ``gate_idx``
    [T, k], ``slot`` int32 [T, k] (the choice's place in its expert's
    capacity) and ``keep`` [T, k, E] (one-hot of the choices that fit).
    ``priority='choice'`` ranks all first choices before any second one
    (Switch/GShard); ``'token'`` ranks token by token (causally safe under
    drops)."""
    T, E = probs.shape
    gate_vals, gate_idx = _top_k_gates(probs, k)
    onehot = F.one_hot(gate_idx, E)  # [T, k, E] int64
    if priority == "choice":
        flat = onehot.transpose(0, 1).reshape(k * T, E)
        pos = (flat.cumsum(0) - flat).reshape(k, T, E).transpose(0, 1)
    elif priority == "token":
        flat = onehot.reshape(T * k, E)
        pos = (flat.cumsum(0) - flat).reshape(T, k, E)
    else:
        raise ValueError(f"unknown routing priority {priority!r}")
    keep = (onehot * (pos < capacity)).to(probs.dtype)
    slot = (pos * onehot).sum(-1).to(torch.int32)
    return gate_vals, gate_idx, slot, keep


#: Dropped-token rate above which :func:`check_expert_overflow` records an
#: ``expert_overflow`` event (the reference's threshold).
EXPERT_OVERFLOW_THRESHOLD = 0.05


def check_expert_overflow(metrics: Dict[str, Any],
                          threshold: float = EXPERT_OVERFLOW_THRESHOLD,
                          where: str = "") -> bool:
    """Host-side overflow tripwire over concrete router metrics (any
    mapping with a ``dropped_token_rate``): past ``threshold`` it records
    an ``expert_overflow`` event and returns True."""
    rate = metrics.get("dropped_token_rate")
    rate = 0.0 if rate is None else float(rate)
    if rate > threshold:
        from ..obs.events import default_event_log

        default_event_log().emit("expert_overflow", dropped_token_rate=rate,
                                 threshold=threshold, where=where)
        return True
    return False


def _ragged_ffn(experts: Params, tokens: torch.Tensor,
                gate_vals: torch.Tensor, gate_idx: torch.Tensor
                ) -> torch.Tensor:
    """The ``'gather'`` arm's expert FFN: the ``T k`` (token, choice)
    assignments sorted by expert (stable, so ties keep token order), the
    rows gathered, one product per expert and weight over its row group in
    the model dtype, then the gate-weighted scatter-add per token.  The
    group sizes are read back to the host to cut the groups."""
    if _is_q(experts["w1"]) or _is_q(experts["w2"]):
        # the reference's ragged arm dies here with an AttributeError
        # (parallel/moe.py:588); it never dequantises silently, nor does this
        raise TypeError(
            "int8 (q8, scale) expert weights run only in the fused kernel: "
            "use moe_dispatch='cuda' (the 'gather' arm takes float experts)")
    T, D = tokens.shape
    k = gate_idx.shape[1]
    E = experts["w2"].shape[0]
    flat = gate_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_tok = order // k
    rows = tokens[sorted_tok]  # [T k, D], grouped by expert
    sizes = torch.bincount(flat, minlength=E).tolist()
    out = torch.cat([
        ffn_rows(rows_e, *(experts[n][e] for n in ("w1", "b1", "w2", "b2")))
        for e, rows_e in enumerate(torch.split(rows, sizes)) if sizes[e]])
    g = gate_vals.reshape(-1)[order].to(out.dtype)
    y = torch.zeros(T, D, dtype=out.dtype, device=tokens.device)
    return y.index_add_(0, sorted_tok, g[:, None] * out)


def _load_balance_loss(probs: torch.Tensor,
                       dispatched: torch.Tensor) -> torch.Tensor:
    """Switch-style aux loss: ``E sum_e mean_t(dispatched_e) mean_t(p_e)``
    over ``dispatched [T, E]``, the kept choices of each token."""
    E = probs.shape[-1]
    return E * torch.sum(dispatched.mean(0) * probs.mean(0))


def _expert_ffn(experts: Params, x: torch.Tensor) -> torch.Tensor:
    """The per-expert FFN on stacked experts, ``x [E, G, D] -> [E, G,
    D]`` in the experts' dtype — the ``'sorted'`` arm's plain path.  Float
    experts only: the reference's ``_expert_ffn`` reads ``.ndim`` on an
    int8 pair and dies, so it serves int8 experts under EP only through
    its kernel, as this does."""
    if _is_q(experts["w1"]) or _is_q(experts["w2"]):
        raise TypeError(
            "int8 (q8, scale) expert weights run only in the fused kernel: "
            "use dispatch='cuda' (the 'sorted' arm takes float experts)")
    return ffn_rows(x, *(experts[n] for n in ("w1", "b1", "w2", "b2")))


def _use_sorted(cfg: MoEConfig, T: int, capacity: int) -> bool:
    """Whether the plain capacity path takes the index dispatch: always
    under ``'sorted'``, never under ``'dense'``; under ``'auto'`` once the
    dense tensors pass :data:`_DENSE_DISPATCH_MAX` elements — the
    reference's ``_use_sorted``."""
    if cfg.dispatch == "auto":
        return T * cfg.num_experts * capacity > _DENSE_DISPATCH_MAX
    return cfg.dispatch == "sorted"


def _forward_dispatch(cfg: MoEConfig, device, T: int, capacity: int) -> str:
    """``moe_forward``'s arm: ``'cuda'`` (the kernels), ``'dense'`` or
    ``'sorted'``.  ``'auto'`` takes ``'cuda'`` for the token-choice router
    on a CUDA device, else the plain arm by size (:func:`_use_sorted`; the
    expert-choice router has no kernel, as the reference's ``_use_pallas``
    is False for it), recorded as a ``moe_dispatch_selected`` event."""
    if cfg.dispatch == "gather":
        raise ValueError(
            "moe dispatch 'gather' is the serving path's ragged arm "
            "(moe_serve_forward); moe_forward takes 'dense', 'sorted', "
            "'cuda' or 'auto'")
    if cfg.dispatch != "auto":
        return cfg.dispatch
    if cfg.router == "topk" and torch.device(device).type == "cuda":
        chosen = "cuda"
    else:
        chosen = "sorted" if _use_sorted(cfg, T, capacity) else "dense"
    from ..obs.events import default_event_log

    default_event_log().emit("moe_dispatch_selected", requested="auto",
                             chosen=chosen, device=str(device))
    return chosen


def _dense_topk_tensors(gate_vals: torch.Tensor, slot: torch.Tensor,
                        keep: torch.Tensor, capacity: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense ``[T, E, C]`` dispatch / combine of a :func:`_top_k_route`
    decision: ``dispatch[t, e, c]`` 1 where token t holds slot c of
    expert e, ``combine`` its gate there (0 for a dropped choice, whose
    slot index lies past C and so hits no column)."""
    slot_oh = (slot.long()[..., None] == torch.arange(
        capacity, device=slot.device)).to(keep.dtype)  # [T, k, C]
    dispatch = torch.einsum("tke,tkc->tec", keep, slot_oh)
    combine = torch.einsum("tk,tke,tkc->tec", gate_vals, keep, slot_oh)
    return dispatch, combine


def _expert_choice_dispatch(probs: torch.Tensor, capacity: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-choice dispatch / combine ``[T, E, C]`` (Zhou et al. 2022):
    each expert picks its top ``capacity`` tokens by router probability,
    so every expert is full and a token may be picked by none or many;
    ``combine`` carries the raw probability of each pick.  Not causal:
    an expert ranks the whole sequence."""
    T = probs.shape[0]
    gate, tok_idx = torch.topk(probs.t(), capacity, dim=-1)  # [E, C]
    tok_oh = F.one_hot(tok_idx, T).to(probs.dtype)  # [E, C, T]
    return (tok_oh.permute(2, 0, 1),
            (tok_oh * gate[..., None]).permute(2, 0, 1))


def _router_metrics(probs: torch.Tensor, keep: Optional[torch.Tensor],
                    top_k: int, ec_tok_idx: Optional[torch.Tensor] = None,
                    capacity: int = 0) -> Dict[str, torch.Tensor]:
    """The capacity path's counters (f32, outside autograd): the mean
    per-token router entropy over ``log E``; token choice (``keep``): the
    kept choices per expert and the share of the ``T k`` choices dropped
    past capacity; expert choice (``ec_tok_idx [E, C]``): every expert
    full at ``capacity``, and the share of tokens no expert picked.  Per
    rank under EP."""
    probs = probs.detach()
    T, E = probs.shape
    plogp = torch.where(probs > 0, probs * torch.log(probs),
                        torch.zeros_like(probs))
    entropy = -plogp.sum(-1).mean() / math.log(max(E, 2))
    if keep is not None:
        keep = keep.detach()
        expert_tokens = keep.sum((0, 1))
        dropped = 1.0 - keep.sum() / (T * top_k)
    else:
        expert_tokens = torch.full((E,), float(capacity),
                                   device=probs.device)
        covered = torch.bincount(ec_tok_idx.reshape(-1), minlength=T) > 0
        dropped = 1.0 - covered.float().mean()
    return {"router_entropy": entropy.float(),
            "expert_tokens": expert_tokens.float(),
            "dropped_token_rate": dropped.float()}


def moe_forward(params: Params, x: torch.Tensor, cfg: MoEConfig,
                ep_group=None, causal: bool = False,
                return_metrics: bool = False):
    """The MoE FFN of the capacity path, forward and backward: ``x [B, S,
    D]`` (the rank's own tokens under EP) -> ``(y [B, S, D], aux)``,
    ``aux`` the f32 load-balance loss (0 for expert choice; add
    ``cfg.aux_loss_weight * aux`` to the loss), plus the router's
    counters (:func:`_router_metrics`, outside autograd) with
    ``return_metrics=True``.  Dropped tokens add zero: use the output as
    a residual.

    Token choice: each expert takes ``C = ceil(T k cf / E)`` slots, ``T``
    the rank's tokens; ``causal=True`` ranks the capacity token by token,
    so token t's output depends on tokens <= t only.  Expert choice: each
    expert picks its top ``C = min(ceil(T cf / E), T)`` tokens over the
    whole sequence, which ``causal=True`` refuses (a future-token leak).

    ``cfg.dispatch`` (:func:`_forward_dispatch`): ``'dense'``,
    ``'sorted'``, ``'cuda'`` (K6 on the routing without a group, K7 on
    the exchanged groups with one) or ``'auto'``.  ``ep_group``: a
    ``torch.distributed`` group of ``ep`` ranks, each holding ``E / ep``
    experts (:func:`shard_experts`); the ``[E, C, D]`` slots go to their
    experts' ranks as ``[ep, E / ep, C, D]`` blocks, each rank runs its
    experts on ``[E / ep, ep C, D]`` rows, and the inverse exchange brings
    the outputs back."""
    B, S, D = x.shape
    T, E = B * S, cfg.num_experts
    tokens = x.reshape(T, D)
    probs = torch.softmax((tokens @ params["router"]["w"]).float(), dim=-1)
    experts = params["experts"]
    if cfg.router == "expert_choice":
        if causal:
            raise ValueError(
                "router='expert_choice' is incompatible with causal=True: "
                "each expert picks its top-capacity tokens over the whole "
                "sequence, so token t's routing depends on tokens > t (a "
                "future-information leak in an autoregressive model). Use "
                "router='topk' for causal LMs.")
        capacity = min(max(1, int(math.ceil(T * cfg.capacity_factor / E))),
                       T)
        disp = _forward_dispatch(cfg, x.device, T, capacity)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        gate_ec, tok_idx = torch.topk(probs.t(), capacity, dim=-1)  # [E, C]
        metrics = (_router_metrics(probs, None, cfg.top_k, tok_idx, capacity)
                   if return_metrics else None)
        if disp == "sorted":
            # the pick is a gather spec: tok_idx[e, c] is slot c's token
            expert_in = tokens[tok_idx]

            def combine_out(out):
                # a token picked by several experts sums their outputs,
                # one picked by none stays 0
                w = gate_ec.to(out.dtype)[..., None] * out
                return out.new_zeros(T, D).index_add(
                    0, tok_idx.reshape(-1), w.reshape(E * capacity, D))
        else:
            dispatch, combine = (t.to(x.dtype) for t in
                                 _expert_choice_dispatch(probs, capacity))
            expert_in = torch.einsum("tec,td->ecd", dispatch, tokens)

            def combine_out(out):
                return torch.einsum("tec,ecd->td", combine, out)
    else:
        k = cfg.top_k
        capacity = max(1, int(math.ceil(T * k * cfg.capacity_factor / E)))
        disp = _forward_dispatch(cfg, x.device, T, capacity)
        gate_vals, gate_idx, slot, keep = _top_k_route(
            probs, k, capacity, priority="token" if causal else "choice")
        aux = _load_balance_loss(probs, keep.sum(1)).float()
        metrics = (_router_metrics(probs, keep, k) if return_metrics
                   else None)
        if disp == "cuda" and ep_group is None:
            y = fused_moe_ffn(experts, tokens, gate_vals, gate_idx, slot,
                              keep, capacity)
            return _done(y, x, aux, metrics, return_metrics)
        if disp == "dense":
            dispatch, combine = (t.to(x.dtype) for t in _dense_topk_tensors(
                gate_vals, slot, keep, capacity))
            expert_in = torch.einsum("tec,td->ecd", dispatch, tokens)

            def combine_out(out):
                return torch.einsum("tec,ecd->td", combine, out)
        else:
            # the sorted dispatch (also the exchange's layout under
            # 'cuda'): kept choice (t, j) writes token t into flat slot
            # e C + c; dropped choices land on a dumpster row E C, cut off
            kept = keep.sum(-1)  # [T, k]: 1 iff the choice fit
            dest = torch.where(kept > 0, gate_idx * capacity + slot.long(),
                               E * capacity)  # [T, k]
            src = tokens[:, None, :].expand(T, k, D).reshape(T * k, D)
            expert_in = tokens.new_zeros(E * capacity + 1, D).index_add(
                0, dest.reshape(-1), src)[:E * capacity].reshape(
                E, capacity, D)
            gates = (gate_vals * kept).to(x.dtype)  # [T, k]

            def combine_out(out):
                out_flat = torch.cat([out.reshape(E * capacity, D),
                                      out.new_zeros(1, D)])  # dumpster -> 0
                return (gates[..., None] * out_flat[dest]).sum(1)
    ffn = fused_expert_ffn if disp == "cuda" else _expert_ffn
    if ep_group is None:
        expert_out = ffn(experts, expert_in)
    else:
        ep = ep_group.size()
        if E % ep != 0:
            raise ValueError(f"num_experts {E} not divisible by EP size {ep}")
        e_loc = E // ep
        held = experts["w2"][0] if _is_q(experts["w2"]) else experts["w2"]
        if held.shape[0] != e_loc:
            raise ValueError(
                f"this rank holds {held.shape[0]} experts, EP {ep} of {E} "
                f"needs {e_loc}: shard them with shard_experts")
        recv = all_to_all(expert_in.reshape(ep, e_loc, capacity, D),
                          ep_group)
        # the local experts see ep C slots, C from every EP peer
        grouped = recv.transpose(0, 1).reshape(e_loc, ep * capacity, D)
        out = ffn(experts, grouped)
        back = out.reshape(e_loc, ep, capacity, D).transpose(0, 1)
        expert_out = all_to_all(back, ep_group).reshape(E, capacity, D)
    return _done(combine_out(expert_out), x, aux, metrics, return_metrics)


def _done(y: torch.Tensor, x: torch.Tensor, aux: torch.Tensor, metrics,
          return_metrics: bool):
    out = (y.reshape(x.shape).to(x.dtype), aux)
    return out + (metrics,) if return_metrics else out


def moe_serve_forward(params: Params, x: torch.Tensor, cfg: MoEConfig,
                      dispatch: Optional[str] = None,
                      return_metrics: bool = False):
    """Serving-time MoE FFN, ``[B, S, D] -> [B, S, D]``: exact top-k
    routing with no capacity (no drops, so causally safe), the router's
    product in the model dtype and its softmax in f32.  ``dispatch``
    overrides ``cfg.dispatch``: ``'gather'`` (the ragged plain path, the
    oracle arm; float experts only), ``'cuda'`` (K6 at ``C = T``; all-empty
    capacity tiles exit at once; float experts or the int8 ``(q8, scale)``
    pairs of ``quantize_moe_experts``) or ``'auto'`` (by the device).  ``return_metrics=True``
    also returns ``{'expert_tokens': [E] f32 (bincount of the choices of
    all T rows), 'dropped_token_rate': 0}``."""
    if cfg.router != "topk":
        raise NotImplementedError(
            f"moe_serve_forward supports router='topk' (got {cfg.router!r})")
    B, S, D = x.shape
    T, E, k = B * S, cfg.num_experts, cfg.top_k
    tokens = x.reshape(T, D)
    disp = resolve_moe_dispatch(cfg.dispatch if dispatch is None
                                else dispatch, x.device)
    probs = torch.softmax((tokens @ params["router"]["w"]).float(), dim=-1)
    gate_vals, gate_idx = _top_k_gates(probs, k)
    if disp == "cuda":
        # C = T is the static no-drop bound (a token holds at most one slot
        # of an expert), so keep is the full choice one-hot and this arm
        # routes exactly the (token, expert) set of the ragged arm
        gv, gi, slot, keep = _top_k_route(probs, k, T)
        y = fused_moe_ffn(params["experts"], tokens, gv, gi, slot, keep, T)
    else:
        y = _ragged_ffn(params["experts"], tokens, gate_vals, gate_idx)
    y = y.reshape(B, S, D).to(x.dtype)
    if not return_metrics:
        return y
    metrics = {
        "expert_tokens": torch.bincount(gate_idx.reshape(-1),
                                        minlength=E).float(),
        "dropped_token_rate": torch.zeros((), device=x.device),
    }
    return y, metrics


def _stack_normal(shape, std: float, dtype: torch.dtype,
                  gen: torch.Generator, device) -> torch.Tensor:
    """N(0, std²) drawn in f32 one expert at a time, so an expert stack of
    many GB never needs an f32 copy of itself."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = _normal(shape[1:], std, dtype, gen, device)
    return out


def init_moe_params(gen: torch.Generator, cfg: MoEConfig,
                    device=None) -> Params:
    """Router ``w`` [D, E] ~ N(0, 1/D); experts ``w1`` [E, D, F] (GELU) or
    [E, 2, D, F] (SwiGLU) ~ N(0, 1/D), ``w2`` [E, F, D] ~ N(0, 1/F), zero
    biases — the reference's layouts and scales, drawn from ``gen`` on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    D, Fd, E, dt = cfg.dim, cfg.ffn_dim, cfg.num_experts, cfg.dtype
    s1, s2 = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fd)
    if cfg.act == "swiglu":
        experts = {"w1": _stack_normal((E, 2, D, Fd), s1, dt, gen, dev),
                   "b1": torch.zeros(E, 2, Fd, dtype=dt, device=dev)}
    else:
        experts = {"w1": _stack_normal((E, D, Fd), s1, dt, gen, dev),
                   "b1": torch.zeros(E, Fd, dtype=dt, device=dev)}
    experts["w2"] = _stack_normal((E, Fd, D), s2, dt, gen, dev)
    experts["b2"] = torch.zeros(E, D, dtype=dt, device=dev)
    return {"router": {"w": _normal((D, E), s1, dt, gen, dev)},
            "experts": experts}


def shard_experts(params: Params, rank: int, size: int) -> Params:
    """This EP rank's share of an MoE layer's params — the reference's
    ``moe_param_specs`` (:632) placement, as slices: every expert leaf
    (both halves of an int8 ``(q8, scale)`` pair too) cut along E to its
    ``[E / size, ...]`` block ``rank`` (EP ranks hold contiguous
    experts); the router stays whole.  The slices are views (no copy);
    ``.clone()`` them to free the full stack.  Raises unless ``size``
    divides E."""
    if not 0 <= rank < size:
        raise ValueError(f"EP rank {rank} not in [0, {size})")
    experts = params["experts"]
    E = (experts["w2"][0] if _is_q(experts["w2"]) else experts["w2"]).shape[0]
    if E % size != 0:
        raise ValueError(f"num_experts {E} not divisible by EP size {size}")
    e_loc = E // size
    lo = rank * e_loc

    def cut(leaf):
        if isinstance(leaf, tuple):
            return tuple(cut(t) for t in leaf)
        return leaf[lo:lo + e_loc]

    return dict(params, experts={n: cut(v) for n, v in experts.items()})


def moe_param_specs(ep_axis: Optional[str] = EXPERT_AXIS) -> Params:
    """The reference's ``moe_param_specs`` (:632) in the port's spec form
    (``models.gpt_moe.gpt_moe_param_specs``): the router replicated (None),
    every expert leaf split along E over ``ep_axis`` — its spec the axis
    name, which the tensor-parallel helpers read as replicated;
    :func:`shard_experts` cuts it.  ``ep_axis=None``: all replicated."""
    return {"router": {"w": None},
            "experts": {n: ep_axis for n in ("w1", "b1", "w2", "b2")}}


def moe_grad_reduce_overrides(moe_dp_axis: str = MOE_DATA_AXIS
                              ) -> Dict[str, Tuple[str, ...]]:
    """The override dict of ``DataParallel`` / ``ZeroOptimizer`` for an
    expert-parallel model (the reference's :649): expert grads reduce over
    ``moe_dp`` only — each EP rank owns different experts — and, under
    ``'mean'``, divide by the whole data group, which cancels the EP
    exchange's overcount (an expert's grad holds every EP peer's
    tokens); every other leaf reduces over the whole data group."""
    return {"experts": (moe_dp_axis,)}
