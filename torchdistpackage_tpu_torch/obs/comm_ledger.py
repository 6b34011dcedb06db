"""The per-step collective ledger — the port's
``torchdistpackage_tpu/obs/comm_ledger.py``, recorded from the port's own
collectives where the reference parses a compiled step's HLO.

The port runs eagerly and has no HLO.  Every helper that issues a
collective (``tp_utils``' five, the pipeline's point-to-point, the DP
parameter broadcast and the serving paths) calls :func:`note` once per
collective; while a :class:`CommRecorder` is active each note becomes a
record, and :func:`ledger_from_records` turns the records into the
reference's ledger dict (``tdp-comm-ledger/v1``): every collective with
its payload bytes, the axes its group spans and its parallelism
dimension, plus per-dimension aggregates.  With no recorder active a
note costs one check.

Payload convention (the reference's, matching ``dist.comm_bench``'s
nccl-tests-style ``bytes``): the FULL logical payload of the collective
— the operand bytes, times the group size for an all-gather (whose
operand is the local shard).  The per-link wire bytes are the cost
model's business (:mod:`.comm_model`).  Host staging of CUDA payloads
over gloo is counted apart (``tp_utils.HOST_STAGING``), never here.

Axes: a process group maps to the axis names it was built for through
a registry (:func:`register_group`) that ``dist.topology`` fills — each
axis group ``ParallelContext`` builds, ``build_moe_groups``'
(``moe_ep``) and ``build_cp_group``'s (``context``).  Where one group
serves several axes (their partitions of the ranks coincide, as with
size-1 axes), the axes whose size exceeds 1 name it, the reference's
rule (the mesh axes whose coordinate varies within the group); a group
no axis varies over is named by every axis it serves.  A group the
registry does not know gets axes ``()`` and dimension ``'other'``, as
the reference's mesh-less ledger does.

Two differences from the HLO ledger, both of counting:

- an eager ledger counts every EXECUTION: a pipeline's point-to-point
  and a ring's hops are counted once a trip, where the reference counts
  a ``while`` body's instruction once;
- ``sched_distance`` of an async entry (``start_all_reduce`` /
  ``tp_utils._start_all_gather`` with ``async_op``) is the number of
  LEDGER ENTRIES issued between its start and its wait (the
  reference's: HLO instructions between ``-start`` and ``-done``), and
  ``overlapped_idx`` their indices.

The port adds one op the HLO ledger has no name for, ``broadcast``
(``dist.broadcast``: parameters, pipeline shape preambles, serving
tokens).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

LEDGER_SCHEMA = "tdp-comm-ledger/v1"

# One record shape for every comm measurement/annotation in the repo:
# dist.comm_bench emits these per (op, size) cell, CommModel.calibrate
# consumes them.
COMM_RECORD_SCHEMA = "tdp-comm-record/v1"


def comm_record(
    op: str,
    axis: str,
    nbytes: float,
    axis_size: int = 0,
    time_s: Optional[float] = None,
    algbw_GBps: Optional[float] = None,
    busbw_GBps: Optional[float] = None,
    **extra: Any,
) -> Dict[str, Any]:
    """The shared comm record: ``{type, schema, op, axis, axis_size,
    bytes, ...}``.  ``op`` in comm_bench's underscore spelling
    (``all_reduce``); ``axis`` the axis name (several joined with '+').
    The measurement fields are optional (an annotation has bytes but no
    time)."""
    rec: Dict[str, Any] = {
        "type": "comm",
        "schema": COMM_RECORD_SCHEMA,
        "op": str(op),
        "axis": str(axis),
        "axis_size": int(axis_size),
        "bytes": int(nbytes),
    }
    if time_s is not None:
        rec["time_s"] = float(time_s)
    if algbw_GBps is not None:
        rec["algbw_GBps"] = float(algbw_GBps)
    if busbw_GBps is not None:
        rec["busbw_GBps"] = float(busbw_GBps)
    rec.update(extra)
    return rec


#: the reference's five collective families, then the port's broadcast
COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
    "broadcast",
)

# Axis name -> parallelism dimension: the package's canonical names
# (dist.topology) and their view factorings; anything else (or a
# collective spanning axes of DIFFERENT dimensions) lands in 'other'.
AXIS_DIM: Dict[str, str] = {
    "data": "dp",
    "moe_dp": "dp",
    "data_inter": "dp",
    "data_intra": "dp",
    "batch": "dp",
    "fsdp": "dp",
    "tensor": "tp",
    "model": "tp",
    "pipe": "pp",
    "stage": "pp",
    "moe_ep": "moe",
    "expert": "moe",
    "context": "cp",
}


def classify_axes(axes: Sequence[str]) -> str:
    """Axis-name set -> parallelism dimension.  One unanimous dimension
    wins; an empty set or a mix (e.g. a sum over ('data', 'tensor'))
    is 'other'."""
    dims = {AXIS_DIM.get(a, "other") for a in axes}
    return dims.pop() if len(dims) == 1 else "other"


# ------------------------------------------------------------ the registry

#: process group -> [(axes, the axes of size > 1 among them), ...], one
#: entry per axis set the group was built for
_GROUP_AXES: Dict[Any, List[Tuple[Tuple[str, ...], Tuple[str, ...]]]] = {}


def register_group(group: Any, axes: Sequence[str],
                   sizes: Sequence[int]) -> None:
    """Name ``group`` by ``axes`` (``sizes``: each axis's size in the
    layout).  A group built for several axis sets keeps them all (see the
    module docstring)."""
    if group is None:
        return
    axes = tuple(str(a) for a in axes)
    varying = tuple(a for a, s in zip(axes, sizes) if int(s) > 1)
    entries = _GROUP_AXES.setdefault(group, [])
    if (axes, varying) not in entries:
        entries.append((axes, varying))


def group_axes(group: Any) -> Tuple[str, ...]:
    """The axis names ``group`` spans: the axes of size > 1 among the
    axis sets it was built for, else all of them; ``()`` for a group the
    registry does not know."""
    if group is None:
        import torch.distributed as dist

        group = dist.group.WORLD
    entries = _GROUP_AXES.get(group)
    if not entries:
        return ()
    names: List[str] = []
    for _, varying in entries:
        names.extend(a for a in varying if a not in names)
    if not names:
        for axes, _ in entries:
            names.extend(a for a in axes if a not in names)
    return tuple(names)


# ------------------------------------------------------------ the recorder

_ACTIVE: Optional["CommRecorder"] = None


class CommRecorder:
    """While active (``with CommRecorder() as rec:``), every
    :func:`note` appends a record to ``rec.records``; :meth:`ledger`
    builds the ledger.  One recorder is active at a time; entering one
    inside another suspends the outer until the inner exits."""

    def __init__(self) -> None:
        self.records: List[Dict[str, Any]] = []
        self._outer: Optional[CommRecorder] = None

    def __enter__(self) -> "CommRecorder":
        global _ACTIVE
        self._outer, _ACTIVE = _ACTIVE, self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE, self._outer = self._outer, None

    def ledger(self, ctx=None) -> Dict[str, Any]:
        return ledger_from_records(self.records, ctx=ctx)


def note(op: str, tensor: Any, group: Any = None,
         name: Optional[str] = None, async_op: bool = False
         ) -> Optional[Tuple["CommRecorder", int]]:
    """One collective ``op`` (a name of :data:`COLLECTIVE_OPS`) of
    ``tensor`` (its operand: the local shard of an all-gather, the whole
    input of a reduce-scatter, one send of a point-to-point) over
    ``group``, counted under ``name`` (a ``tp_utils.COLLECTIVES`` region;
    None: a collective no region counts).  ``async_op``: the collective
    was started without waiting; pass the returned token to
    :func:`note_done` where it is waited for.  Returns None when no
    recorder is active."""
    rec = _ACTIVE
    if rec is None:
        return None
    import torch.distributed as dist

    n = dist.get_world_size(group)
    nbytes = tensor.numel() * tensor.element_size()
    if op == "all-gather":
        nbytes *= n  # the operand is this rank's shard
    idx = len(rec.records)
    rec.records.append({
        "op": op, "bytes": int(nbytes), "axes": group_axes(group),
        "group_size": int(n), "op_name": name, "async": bool(async_op),
        "done_at": None,
    })
    return (rec, idx) if async_op else None


def note_done(token: Optional[Tuple["CommRecorder", int]]) -> None:
    """The wait of an async collective :func:`note` returned ``token``
    for: fixes its scheduling window at the entries issued so far."""
    if token is None:
        return
    rec, idx = token
    if rec.records[idx]["done_at"] is None:
        rec.records[idx]["done_at"] = len(rec.records)


def _mesh_axes(ctx) -> Optional[Dict[str, int]]:
    if ctx is None:
        from ..dist.topology import tpc

        ctx = tpc
    if not ctx.is_initialized:
        return None
    view = ctx.get_view()
    return {str(a): int(view.shape[a]) for a in view.axis_names}


def ledger_from_records(records: Sequence[Dict[str, Any]],
                        ctx=None) -> Dict[str, Any]:
    """The ledger of a recorder's records, in the reference's form:
    ``{schema, collectives, per_dim, total_bytes, n_collectives, async,
    mesh_axes}``.  ``ctx`` (default ``dist.topology.tpc``) gives
    ``mesh_axes``, the default layout's ``{axis: size}`` (None when it is
    not set up).  An async entry never waited for while recording has
    every later entry in its window and no ``sched_distance``."""
    collectives: List[Dict[str, Any]] = []
    per_dim: Dict[str, Dict[str, int]] = {}
    total = 0
    end = len(records)
    for i, r in enumerate(records):
        axes = tuple(r.get("axes") or ())
        dim = classify_axes(axes) if axes else "other"
        sched = over = None
        if r.get("async"):
            done = r.get("done_at")
            stop = end if done is None else int(done)
            over = list(range(i + 1, stop))
            sched = None if done is None else len(over)
        entry = {
            "op": r["op"],
            "bytes": int(r["bytes"]),
            "axes": list(axes),
            "dim": dim,
            "group_size": int(r.get("group_size") or 0),
            "channel_id": None,
            "op_name": r.get("op_name"),
            "async": bool(r.get("async")),
            "sched_distance": sched,
            "overlapped_idx": over,
        }
        collectives.append(entry)
        d = per_dim.setdefault(dim, {"bytes": 0, "ops": 0})
        d["bytes"] += entry["bytes"]
        d["ops"] += 1
        total += entry["bytes"]
    async_recs = [c for c in collectives if c["async"]]
    distances = [c["sched_distance"] for c in async_recs
                 if c["sched_distance"] is not None]
    async_bytes = int(sum(c["bytes"] for c in async_recs))
    return {
        "schema": LEDGER_SCHEMA,
        "collectives": collectives,
        "per_dim": per_dim,
        "total_bytes": int(total),
        "n_collectives": len(collectives),
        "async": {
            "ops": len(async_recs),
            "bytes": async_bytes,
            "sync_ops": len(collectives) - len(async_recs),
            "sync_bytes": int(total - async_bytes),
            "mean_sched_distance": (
                round(sum(distances) / len(distances), 2)
                if distances else None),
        },
        "mesh_axes": _mesh_axes(ctx),
    }


# ------------------------------------------------------- overlap evidence


def tp_pp_overlap(ledger: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """TP-under-PP overlap evidence from a ledger: for every async
    pipeline collective-permute, which tensor-dimension collectives were
    issued inside its start->wait window.  The port's pipeline posts
    each step's messages and waits for them at once (``_p2p.exchange``),
    so ``pp_async_ops`` is 0 and the rest vacuously 0, as on the
    reference's CPU sim."""
    out = {
        "pp_async_ops": 0,
        "pp_windows_with_tp": 0,
        "tp_ops_in_pp_windows": 0,
        "tp_bytes_in_pp_windows": 0,
        "mean_pp_sched_distance": None,
    }
    if not ledger or not ledger.get("collectives"):
        return out
    colls = ledger["collectives"]
    distances = []
    for c in colls:
        if c["dim"] != "pp" or not c["async"]:
            continue
        out["pp_async_ops"] += 1
        if c["sched_distance"] is not None:
            distances.append(c["sched_distance"])
        inside = [colls[i] for i in (c.get("overlapped_idx") or [])
                  if i < len(colls)]
        tp_inside = [o for o in inside if o["dim"] == "tp"]
        if tp_inside:
            out["pp_windows_with_tp"] += 1
        out["tp_ops_in_pp_windows"] += len(tp_inside)
        out["tp_bytes_in_pp_windows"] += sum(o["bytes"] for o in tp_inside)
    if distances:
        out["mean_pp_sched_distance"] = round(
            sum(distances) / len(distances), 2)
    return out


def cp_ring_overlap(ledger: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Context-parallel ring evidence from a ledger: every hop of a ring
    over the ``context`` axis is its own ``collective-permute`` entry
    (``cp_hops``, ``cp_hop_bytes``), and for every hop started async,
    which non-cp ops were issued inside its window.  The port's hops wait
    where they are issued, so ``cp_async_hops`` is 0; the hop COUNT is
    the evidence."""
    out = {
        "cp_hops": 0,
        "cp_hop_bytes": 0,
        "cp_async_hops": 0,
        "cp_windows_with_compute_comm": 0,
        "ops_in_cp_windows": 0,
        "mean_cp_sched_distance": None,
    }
    if not ledger or not ledger.get("collectives"):
        return out
    colls = ledger["collectives"]
    distances = []
    for c in colls:
        if c["dim"] != "cp" or c["op"] != "collective-permute":
            continue
        out["cp_hops"] += 1
        out["cp_hop_bytes"] += c["bytes"]
        if not c["async"]:
            continue
        out["cp_async_hops"] += 1
        if c["sched_distance"] is not None:
            distances.append(c["sched_distance"])
        inside = [colls[i] for i in (c.get("overlapped_idx") or [])
                  if i < len(colls)]
        other_inside = [o for o in inside if o["dim"] != "cp"]
        if other_inside:
            out["cp_windows_with_compute_comm"] += 1
        out["ops_in_cp_windows"] += len(inside)
    if distances:
        out["mean_cp_sched_distance"] = round(
            sum(distances) / len(distances), 2)
    return out


def render_table(ledger: Optional[Dict[str, Any]]) -> str:
    """Human summary table of a ledger."""
    if not ledger or not ledger.get("n_collectives"):
        return ("comm ledger: no collectives in the compiled step "
                "(single-device program?)")
    L = ["comm ledger (per compiled step):",
         f"{'dim':>6} {'ops':>4} {'bytes':>12}  breakdown"]
    by_dim: Dict[str, Dict[Any, Dict[str, int]]] = {}
    for c in ledger["collectives"]:
        d = by_dim.setdefault(c["dim"], {})
        key = (c["op"], tuple(c["axes"]))
        e = d.setdefault(key, {"ops": 0, "bytes": 0})
        e["ops"] += 1
        e["bytes"] += c["bytes"]
    order = ("dp", "tp", "pp", "cp", "moe", "other")
    for dim in sorted(by_dim,
                      key=lambda d: order.index(d) if d in order else 99):
        stats = ledger["per_dim"][dim]
        parts = ", ".join(
            f"{op}x{e['ops']}@{_fmt_bytes(e['bytes'])}"
            f"{('[' + ','.join(ax) + ']') if ax else ''}"
            for (op, ax), e in sorted(by_dim[dim].items()))
        L.append(f"{dim:>6} {stats['ops']:>4} "
                 f"{_fmt_bytes(stats['bytes']):>12}  {parts}")
    L.append(f"{'total':>6} {ledger['n_collectives']:>4} "
             f"{_fmt_bytes(ledger['total_bytes']):>12}")
    return "\n".join(L)


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"
