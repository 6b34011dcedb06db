"""The alpha-beta (Hockney) cost model of a collective — the part of
``torchdistpackage_tpu/obs/comm_model.py`` that the compression policy
and the comm benchmark read: ``t = steps(op, n) * alpha + wire_bytes /
beta``, ``steps`` the latency terms of the ring algorithm and
``wire_bytes`` the nccl-tests bus factors of ``dist.comm_bench``:

====================  ==============  =====================
op                    steps(n)        wire_bytes / payload
====================  ==============  =====================
all_reduce            ``2(n-1)``      ``2(n-1)/n``
all_gather            ``n-1``         ``(n-1)/n``
reduce_scatter        ``n-1``         ``(n-1)/n``
all_to_all            ``n-1``         ``(n-1)/n``
ppermute              ``1``           ``1``
====================  ==============  =====================

Two parameter sources: :meth:`CommModel.from_defaults`, a prior keyed
on the CUDA device's name (the reference keys TPU generations on their
ICI figures, which do not carry over), and :meth:`CommModel.calibrate`,
a least-squares fit of measured comm records.  The int8 rings
(``dist/compressed.py``) are costed by :func:`compressed_wire_bytes`
and :meth:`CommModel.predict_compressed`, the ``grad_compress='auto'``
decision primitive.

Over a :mod:`.comm_ledger` ledger (recorded from the port's own
collectives): :meth:`CommModel.predict_ledger` times every entry,
:func:`comm_report` makes the RUNREPORT ``comm`` section (modeled comm
time per dimension against the measured step, the comm- or
compute-bound verdict, the overlap headroom and the achieved overlap of
the async entries) and :func:`compression_report` the ``compression``
section (the compress policy's predicted bytes against the ledger's,
per axis).  The port has no XLA FLOP count: :func:`comm_report`'s
compute estimate is the hand formula's FLOPs a step, and its
``verdict_basis`` says so.  ``broadcast``, which the port's ledger has
and the reference's does not, is costed as nccl-tests costs it: ``n - 1``
steps, the payload once on the wire.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# Prior link parameters by CUDA device name (a substring of
# ``torch.cuda.get_device_name``, lower case): the one-direction
# bandwidth of all of a card's links to its peers, and an
# order-of-magnitude startup latency.  calibrate() replaces both with
# measurements.
CUDA_DEFAULTS: List[Tuple[str, Dict[str, float]]] = [
    # NVIDIA H100 80GB HBM3 (SXM5, 700 W power limit), public spec
    # figure: NVLink 4, 18 links, 900 GB/s a card both ways together,
    # so 450 GB/s each way
    ("h100 80gb hbm3", {"link_bw_GBps": 450.0, "link_lat_us": 2.0}),
]
# The inter-node network of an H100 80GB HBM3 (700 W) node, public spec
# figure: one ConnectX-7 NDR InfiniBand port a card, 400 Gb/s = 50 GB/s
# each way; the latency an order of magnitude
INTER_NODE_DEFAULTS = {"inter_bw_GBps": 50.0, "inter_lat_us": 10.0}
# any other device (the CPU over gloo included): the reference's
# fallback for an unknown chip
UNKNOWN_DEFAULTS = {"link_bw_GBps": 100.0, "link_lat_us": 1.0}

# Steps (latency terms) and wire-bytes factor of the ring algorithms;
# op names in comm_bench's underscore convention.
_STEPS = {
    "all_reduce": lambda n: 2 * (n - 1),
    "all_gather": lambda n: n - 1,
    "reduce_scatter": lambda n: n - 1,
    "all_to_all": lambda n: n - 1,
    "ppermute": lambda n: 1,
    "broadcast": lambda n: n - 1,
}
_WIRE_FACTOR = {
    "all_reduce": lambda n: 2 * (n - 1) / n,
    "all_gather": lambda n: (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_to_all": lambda n: (n - 1) / n,
    "ppermute": lambda n: 1.0,
    "broadcast": lambda n: 1.0,
}

# the reference ledger's hyphenated op names -> the model's
_HLO_OP = {
    "all-reduce": "all_reduce",
    "all-gather": "all_gather",
    "reduce-scatter": "reduce_scatter",
    "all-to-all": "all_to_all",
    "collective-permute": "ppermute",
}

# ------------------------------------------------- compressed-ring costing
# The int8 rings carry 1 byte an element plus one f32 scale per
# COMPRESS_GROUP elements; the group size mirrors dist.compressed.GROUP
# (obs imports nothing of dist; tests/test_torch_compressed.py pins the
# two together).

COMPRESS_GROUP = 256

COMPRESSION_SCHEMA = "tdp-compression/v1"

#: ops the int8 rings implement (model-op spelling)
_COMPRESSIBLE_OPS = ("all_reduce", "reduce_scatter", "all_gather")

#: comm_bench's int8 arm names -> the exact op each one replaces
INT8_BENCH_OPS = {
    "int8_all_reduce": "all_reduce",
    "int8_reduce_scatter": "reduce_scatter",
    "int8_all_gather": "all_gather",
}


def compressed_payload_bytes(payload_bytes: float, elem_bytes: int = 4,
                             group: int = COMPRESS_GROUP) -> float:
    """Quantized logical payload: 1 byte an element plus the f32 scale
    sideband."""
    elems = payload_bytes / max(1, elem_bytes)
    return elems * (1.0 + 4.0 / group)


def compressed_wire_bytes(op: str, payload_bytes: float, n: int,
                          elem_bytes: int = 4,
                          group: int = COMPRESS_GROUP) -> float:
    """Per-link bytes the int8 ring moves for a full ``payload_bytes``
    collective: one ring pass, ``(n-1)/n`` of the quantized payload, for
    ``reduce_scatter`` / ``all_gather``; ``3(n-1)/n`` for ``all_reduce``
    (the reference's ring pass plus a masked int8 psum gather, itself an
    all-reduce of the quantized payload)."""
    op = _HLO_OP.get(op, op)
    if op not in _COMPRESSIBLE_OPS:
        raise ValueError(f"no int8 ring for {op!r}")
    if n <= 1:
        return 0.0
    q = compressed_payload_bytes(payload_bytes, elem_bytes, group)
    factor = 3.0 if op == "all_reduce" else 1.0
    return factor * q * (n - 1) / n


def compressed_ledger_bytes(op: str, payload_bytes: float, n: int,
                            elem_bytes: int = 4,
                            group: int = COMPRESS_GROUP) -> float:
    """Bytes the reference's HLO comm ledger counts for one int8 ring
    collective (its per-instruction payload convention): the ring pass's
    ``n-1`` hops of a ``1/n`` quantized chunk, plus, for ``all_reduce``,
    the masked psum of the whole quantized payload, counted once."""
    op = _HLO_OP.get(op, op)
    if op not in _COMPRESSIBLE_OPS:
        raise ValueError(f"no int8 ring for {op!r}")
    if n <= 1:
        return 0.0
    q = compressed_payload_bytes(payload_bytes, elem_bytes, group)
    extra = q if op == "all_reduce" else 0.0
    return q * (n - 1) / n + extra


def steps_for(op: str, n: int) -> int:
    return int(_STEPS[op](max(2, n))) if n > 1 else 0


def wire_bytes(op: str, payload_bytes: float, n: int) -> float:
    """Per-link bytes serialized for a full ``payload_bytes`` collective
    over ``n`` participants (nccl-tests bus convention)."""
    if n <= 1:
        return 0.0
    return payload_bytes * _WIRE_FACTOR[op](n)


def fit_alpha_beta(samples: Sequence[Tuple[float, float, float]]
                   ) -> Tuple[float, float]:
    """Least-squares fit of ``t = steps * alpha + wire / beta`` to rows
    ``(steps, wire_bytes, time_s)``: ``(alpha_s, beta_Bps)``.  Rows are
    weighted by ``1/t`` (relative residuals, so the large samples'
    noise does not swamp the alpha the small ones constrain); a negative
    alpha is clipped to 0 and beta refit; all-latency timings give an
    infinite beta."""
    arr = np.asarray(list(samples), dtype=np.float64)
    if arr.ndim != 2 or arr.shape[0] < 1 or arr.shape[1] != 3:
        raise ValueError(f"need rows of (steps, wire_bytes, time_s); got "
                         f"{arr.shape}")
    A = arr[:, :2]
    t = arr[:, 2]
    w = np.where(t > 0, 1.0 / np.maximum(t, 1e-12), 1.0)
    sol, *_ = np.linalg.lstsq(A * w[:, None], t * w, rcond=None)
    alpha, inv_beta = float(sol[0]), float(sol[1])
    if alpha < 0 or inv_beta <= 0:
        alpha = max(0.0, alpha)
        resid = (t - alpha * A[:, 0]) * w
        wired = A[:, 1] * w
        denom = float(wired @ wired)
        inv_beta = float(wired @ resid) / denom if denom > 0 else 0.0
    if inv_beta <= 0:
        alpha = float(np.mean(t / np.maximum(A[:, 0], 1.0)))
        return alpha, float("inf")
    return alpha, 1.0 / inv_beta


@dataclasses.dataclass
class AxisCost:
    """An axis's link parameters: startup latency and bus bandwidth."""

    alpha_s: float
    beta_Bps: float
    kind: str = "table"  # 'table' | 'inter-node-table' | 'calibrated'

    def as_dict(self) -> Dict[str, Any]:
        return {
            "alpha_s": self.alpha_s,
            "beta_GBps": (self.beta_Bps / 1e9
                          if math.isfinite(self.beta_Bps) else None),
            "kind": self.kind,
        }


def _device_kind() -> str:
    import torch

    return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "cpu"


def _fit_records(records: Sequence[Dict[str, Any]]
                 ) -> Tuple[Dict[str, AxisCost], Dict[str, AxisCost]]:
    """Per-axis ``(exact, int8)`` costs fitted from comm records: an
    exact record is one ``(steps, wire_bytes, time)`` sample of its op,
    an int8 arm's (``compressed``) one of its base op against the
    compressed wire bytes."""
    exact: Dict[str, List[Tuple[float, float, float]]] = {}
    quant: Dict[str, List[Tuple[float, float, float]]] = {}
    for r in records:
        n = int(r["axis_size"])
        if n <= 1 or "time_s" not in r:
            continue
        if r.get("compressed"):
            base = r.get("base_op", INT8_BENCH_OPS.get(r["op"]))
            quant.setdefault(r["axis"], []).append((
                float(steps_for(base, n)),
                compressed_wire_bytes(base, r["bytes"], n,
                                      elem_bytes=r.get("elem_bytes", 4)),
                r["time_s"]))
        else:
            exact.setdefault(r["axis"], []).append((
                float(steps_for(r["op"], n)),
                wire_bytes(r["op"], r["bytes"], n), r["time_s"]))
    costs = {a: AxisCost(*fit_alpha_beta(s), kind="calibrated")
             for a, s in exact.items()}
    q_costs = {a: AxisCost(*fit_alpha_beta(s), kind="calibrated-int8")
               for a, s in quant.items()}
    return costs, q_costs


class CommModel:
    """Per-axis alpha-beta model.  ``axis_costs`` maps an axis name to
    its :class:`AxisCost`; ``default`` covers a collective whose axes are
    unknown; a collective over several known axes takes the bottleneck
    (largest alpha, smallest beta)."""

    def __init__(self, axis_costs: Dict[str, AxisCost],
                 default: Optional[AxisCost] = None, chip: str = "unknown",
                 source: str = "table",
                 compressed_axis_costs: Optional[Dict[str, AxisCost]] = None
                 ) -> None:
        self.axis_costs = dict(axis_costs)
        self.default = default or AxisCost(1e-6, 100e9, "table")
        self.chip = chip
        self.source = source
        #: per-axis alpha / beta fitted from the int8 rings' records:
        #: the quantized rings' effective parameters, the quantizer's
        #: cost folded into the bandwidth.  Empty: the exact parameters
        #: serve (the same link, fewer bytes).
        self.compressed_axis_costs = dict(compressed_axis_costs or {})

    # ------------------------------------------------------------- builders

    @classmethod
    def from_defaults(cls, axes: Sequence[str] = (),
                      device_kind: Optional[str] = None,
                      inter_node_axes: Sequence[str] = (),
                      ctx=None) -> "CommModel":
        """The prior: every axis (``axes``, or every axis of ``ctx``) gets
        the device's link parameters (:data:`CUDA_DEFAULTS`, else
        :data:`UNKNOWN_DEFAULTS`) except ``inter_node_axes``, which get
        :data:`INTER_NODE_DEFAULTS`.  ``device_kind`` defaults to card
        0's name (``'cpu'`` without a card)."""
        if device_kind is None:
            device_kind = _device_kind()
        dk = device_kind.lower()
        link = next((p for sub, p in CUDA_DEFAULTS if sub in dk),
                    UNKNOWN_DEFAULTS)
        intra = AxisCost(alpha_s=link["link_lat_us"] * 1e-6,
                         beta_Bps=link["link_bw_GBps"] * 1e9, kind="table")
        inter = AxisCost(alpha_s=INTER_NODE_DEFAULTS["inter_lat_us"] * 1e-6,
                         beta_Bps=INTER_NODE_DEFAULTS["inter_bw_GBps"] * 1e9,
                         kind="inter-node-table")
        if not axes and ctx is not None:
            axes = ctx.axis_names
        costs = {str(a): inter if str(a) in inter_node_axes else intra
                 for a in axes}
        return cls(costs, default=intra, chip=device_kind, source="table")

    @classmethod
    def calibrate(cls, ctx=None, axes: Optional[Sequence[str]] = None,
                  sizes: Sequence[int] = (1 << 16, 1 << 20, 1 << 23),
                  ops: Sequence[str] = ("all_reduce", "all_gather",
                                        "ppermute"),
                  iters: int = 5, warmup: int = 1,
                  compressed_ops: Sequence[str] = (),
                  records: Optional[Sequence[Dict[str, Any]]] = None,
                  device=None) -> "CommModel":
        """Alpha / beta per axis fitted (:func:`fit_alpha_beta`) from
        comm records: ``records`` when given, else measured here with
        ``dist.comm_bench.bench_collective`` for each (op, size) over
        each axis of ``ctx`` (default ``tpc``) larger than 1 — a
        collective: every rank calls it.  ``compressed_ops`` (names of
        :data:`INT8_BENCH_OPS`) also times the int8 rings and fits their
        own parameters against the compressed wire bytes, so that
        :meth:`predict_compressed` scores them from measurement."""
        if records is None:
            from ..dist.comm_bench import bench_collective
            from ..dist.topology import tpc

            ctx = tpc if ctx is None else ctx
            names = [str(a) for a in (axes if axes is not None
                                      else ctx.axis_names)]
            records = [bench_collective(op, axis, nbytes=nbytes, ctx=ctx,
                                        warmup=warmup, iters=iters,
                                        device=device)
                       for axis in names if ctx.get_group_size(axis) > 1
                       for op in tuple(ops) + tuple(compressed_ops)
                       for nbytes in sizes]
        costs, q_costs = _fit_records(records)
        default = next(iter(costs.values()), None)
        return cls(costs, default=default, chip=_device_kind(),
                   source="calibrated", compressed_axis_costs=q_costs)

    # ------------------------------------------------------------ prediction

    def _cost_for(self, axes: Sequence[str]) -> AxisCost:
        known = [self.axis_costs[a] for a in axes if a in self.axis_costs]
        if not known:
            return self.default
        return AxisCost(alpha_s=max(c.alpha_s for c in known),
                        beta_Bps=min(c.beta_Bps for c in known),
                        kind=known[0].kind)

    def _compressed_cost_for(self, axes: Sequence[str]
                             ) -> Tuple[AxisCost, str]:
        """``(the int8 rings' link parameters over axes, basis)``:
        calibrated int8 parameters where there are any, else the exact
        ones."""
        known = [self.compressed_axis_costs[a] for a in axes
                 if a in self.compressed_axis_costs]
        if known:
            return AxisCost(alpha_s=max(c.alpha_s for c in known),
                            beta_Bps=min(c.beta_Bps for c in known),
                            kind=known[0].kind), "calibrated-int8"
        return self._cost_for(axes), "exact-params"

    def predict_compressed(self, op: str, payload_bytes: float, n: int,
                           axes: Sequence[str] = (), elem_bytes: int = 4,
                           group: int = COMPRESS_GROUP) -> Dict[str, Any]:
        """The int8 ring scored against the exact collective for one
        payload: the ring keeps the exact op's latency term (the same hop
        count) while its bytes shrink (:func:`compressed_wire_bytes`).
        Returns ``{op, n, axes, payload_bytes, exact_s, compressed_s,
        speedup, compress, wire_bytes_exact, wire_bytes_compressed,
        ledger_bytes_exact, ledger_bytes_compressed, basis}``."""
        op = _HLO_OP.get(op, op)
        if op not in _COMPRESSIBLE_OPS:
            raise ValueError(f"no int8 ring for {op!r}; compressible: "
                             f"{_COMPRESSIBLE_OPS}")
        exact_s = self.predict(op, payload_bytes, n, axes=axes)
        out: Dict[str, Any] = {
            "op": op, "n": int(n), "axes": list(axes),
            "payload_bytes": payload_bytes,
            "exact_s": exact_s,
            "wire_bytes_exact": wire_bytes(op, payload_bytes, n),
            "ledger_bytes_exact": payload_bytes if n > 1 else 0.0,
        }
        if n <= 1:
            out.update(compressed_s=0.0, wire_bytes_compressed=0.0,
                       ledger_bytes_compressed=0.0, speedup=1.0,
                       compress=False, basis="single-member axis")
            return out
        q_wire = compressed_wire_bytes(op, payload_bytes, n, elem_bytes,
                                       group)
        c, basis = self._compressed_cost_for(axes)
        t = steps_for(op, n) * c.alpha_s
        if math.isfinite(c.beta_Bps) and c.beta_Bps > 0:
            t += q_wire / c.beta_Bps
        out.update(
            compressed_s=t,
            wire_bytes_compressed=q_wire,
            ledger_bytes_compressed=compressed_ledger_bytes(
                op, payload_bytes, n, elem_bytes, group),
            speedup=(exact_s / t) if t > 0 else float("inf"),
            compress=t < exact_s,
            basis=basis,
        )
        return out

    def predict(self, op: str, payload_bytes: float, n: int,
                axes: Sequence[str] = ()) -> float:
        """Predicted seconds of one collective."""
        op = _HLO_OP.get(op, op)
        if op not in _STEPS:
            raise ValueError(f"unknown collective {op!r}")
        if n <= 1:
            return 0.0
        c = self._cost_for(axes)
        t = steps_for(op, n) * c.alpha_s
        if math.isfinite(c.beta_Bps) and c.beta_Bps > 0:
            t += wire_bytes(op, payload_bytes, n) / c.beta_Bps
        return t

    def predict_ledger(self, ledger: Dict[str, Any]) -> Dict[str, Any]:
        """Per-collective and per-dimension predicted times of a
        :mod:`.comm_ledger` ledger (serialised: no overlap assumed)."""
        per_dim: Dict[str, float] = {}
        rows: List[Dict[str, Any]] = []
        total = 0.0
        for c in ledger.get("collectives", []):
            n = int(c.get("group_size") or 0)
            t = self.predict(c["op"], c["bytes"], n, axes=c.get("axes", ()))
            rows.append({
                "op": c["op"], "dim": c["dim"], "axes": c.get("axes", []),
                "bytes": c["bytes"], "pred_s": t,
            })
            per_dim[c["dim"]] = per_dim.get(c["dim"], 0.0) + t
            total += t
        return {
            "per_collective": rows,
            "per_dim_s": {k: round(v, 9) for k, v in per_dim.items()},
            "total_s": total,
            "params": {a: c.as_dict() for a, c in self.axis_costs.items()},
            "source": self.source,
            "chip": self.chip,
        }


def comm_report(
    ledger: Optional[Dict[str, Any]],
    step_time_s: Optional[float],
    model: Optional[CommModel] = None,
    flops: Optional[float] = None,
    peak_flops: Optional[float] = None,
    ctx=None,
) -> Optional[Dict[str, Any]]:
    """The RUNREPORT ``comm`` section: the ledger's aggregates, modeled
    comm time against the measured step, the bound verdict and the
    overlap headroom (JAX :511).

    - ``t_comm`` — modeled serialised collective time
      (:meth:`CommModel.predict_ledger`; ``model`` default
      :meth:`CommModel.from_defaults` over ``ctx``'s axes);
    - ``t_comp`` — ``flops`` (the hand formula's FLOPs a step, where the
      reference reads XLA's count) over ``peak_flops``; None without
      both;
    - verdict — ``comm-bound`` when even perfectly overlapped comm
      exceeds compute (``t_comm > t_comp``); with no compute estimate the
      comm fraction of the measured step decides (> 0.5);
    - ``overlap_headroom_s`` — the measured step less ``max(t_comm,
      t_comp)``;
    - ``overlap`` — the achieved side: the async entries, those with at
      least one ledger entry issued inside their window counted hidden,
      time-weighted by the model's predictions."""
    if ledger is None:
        return None
    if model is None:
        model = CommModel.from_defaults(ctx=ctx)
    pred = model.predict_ledger(ledger)
    t_comm = pred["total_s"]
    out: Dict[str, Any] = {
        "ledger": {
            "per_dim": ledger.get("per_dim", {}),
            "total_bytes": ledger.get("total_bytes", 0),
            "n_collectives": ledger.get("n_collectives", 0),
            "mesh_axes": ledger.get("mesh_axes"),
            "collectives": ledger.get("collectives", []),
        },
        "model": {
            "per_dim_s": pred["per_dim_s"],
            "total_s": t_comm,
            "params": pred["params"],
            "source": pred["source"],
            "chip": pred["chip"],
        },
        "modeled_comm_s": t_comm,
    }
    colls = ledger.get("collectives", [])
    t_hidden = 0.0
    n_async = n_hidden = 0
    distances: List[float] = []
    for c, row in zip(colls, pred["per_collective"]):
        if not c.get("async"):
            continue
        n_async += 1
        d = c.get("sched_distance")
        if d is not None:
            distances.append(d)
        if d is not None and d > 0:
            n_hidden += 1
            t_hidden += row["pred_s"]
    achieved = (t_hidden / t_comm) if t_comm > 0 else 0.0
    effective_comm_s = max(0.0, t_comm - t_hidden)
    out["overlap"] = {
        "async_ops": n_async,
        "sync_ops": len(colls) - n_async,
        "hidden_ops": n_hidden,
        "mean_sched_distance": (
            round(sum(distances) / len(distances), 2) if distances else None
        ),
        "achieved_fraction": round(achieved, 4),
        "hidden_comm_s": t_hidden,
        "effective_comm_s": effective_comm_s,
        "basis": "ledger entries issued between an async collective's "
                 "start and its wait, time-weighted by the alpha-beta "
                 "model",
    }
    t_comp = None
    if flops and peak_flops:
        t_comp = flops / peak_flops
        out["modeled_compute_s"] = t_comp
    if step_time_s and step_time_s > 0:
        out["measured_step_s"] = step_time_s
        out["comm_fraction"] = round(min(1.0, t_comm / step_time_s), 4)
        out["comm_fraction_effective"] = round(
            min(1.0, effective_comm_s / step_time_s), 4)
        floor = max(t_comm, t_comp) if t_comp else t_comm
        out["overlap_headroom_s"] = max(0.0, step_time_s - floor)
    if t_comp is not None:
        out["verdict"] = "comm-bound" if t_comm > t_comp else "compute-bound"
        out["verdict_basis"] = ("modeled comm vs modeled compute (the hand "
                                "formula's FLOPs a step)")
    elif step_time_s and step_time_s > 0:
        out["verdict"] = (
            "comm-bound" if out["comm_fraction"] > 0.5 else "compute-bound")
        out["verdict_basis"] = "modeled comm fraction of measured step"
    else:
        out["verdict"] = "unknown"
        out["verdict_basis"] = "no measured step time"
    return out


def compression_report(
    mode: str,
    policy_events: Sequence[Dict[str, Any]] = (),
    ledger: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The RUNREPORT ``compression`` section (JAX :621): the compress
    policy's choices beside predicted and ledger-measured bytes per axis.
    ``policy_events``: ``compress_policy`` events (or bare ``{leaves:
    [...]}`` dicts), as ``DataParallel`` / ``ZeroOptimizer`` emit them
    under ``grad_compress='auto'``; each leaf row carries its choice and
    both byte predictions in the ledger's convention
    (``CommModel.predict_compressed``).  ``ledger``: the step's comm
    ledger; the measured bytes are its collectives aggregated by the axis
    set they span — the WHOLE step's traffic on that axis (the loss's
    reduction rides it too), so ``rel_err`` reconciles, it does not
    bound."""
    leaves: List[Dict[str, Any]] = []
    for ev in policy_events:
        leaves.extend(ev.get("leaves") or [])
    predicted: Dict[str, float] = {}
    for leaf in leaves:
        key = "+".join(leaf.get("axes") or []) or "?"
        b = (leaf["ledger_bytes_compressed"] if leaf.get("compress")
             else leaf["ledger_bytes_exact"])
        predicted[key] = predicted.get(key, 0.0) + float(b)
    measured: Dict[str, int] = {}
    for c in (ledger or {}).get("collectives", []):
        key = "+".join(c.get("axes") or []) or "?"
        measured[key] = measured.get(key, 0) + int(c.get("bytes", 0))
    rows: List[Dict[str, Any]] = []
    for key in sorted(set(predicted) | set(measured)):
        pred = predicted.get(key)
        meas = measured.get(key)
        row: Dict[str, Any] = {"axes": key}
        if pred is not None:
            row["predicted_bytes"] = int(round(pred))
        if meas is not None:
            row["measured_bytes"] = meas
        if pred and meas is not None:
            row["rel_err"] = round((meas - pred) / pred, 4)
        rows.append(row)
    return {
        "schema": COMPRESSION_SCHEMA,
        "mode": str(mode),
        "policy": {
            "n_leaves": len(leaves),
            "n_compressed": sum(1 for leaf in leaves if leaf.get("compress")),
            # a bounded table; the full records are on the event timeline
            "leaves": [dict(leaf) for leaf in leaves[:64]],
        },
        "per_axis": rows,
    }
