"""A/B run-parity diff — the port's
``torchdistpackage_tpu/tools/parity_diff.py``: compare two runs'
artifacts into a drift verdict.

    python -m torchdistpackage_tpu_torch.tools.parity_diff RUN_A RUN_B
        [--key loss] [--rtol 0.05] [--atol 1e-9] [--label-a exact]
        [--label-b int8]

``RUN_A`` / ``RUN_B`` are ``RUNREPORT.json`` files (the per-step stream
comes from their ``numerics.timeline``) or ``JsonlSink`` record files
(one JSON step record per line).  The tool prints:

- the per-step drift table (downsampled) with the ``exact | bounded |
  diverged`` verdict of :func:`...obs.parity.compare_streams`;
- when both reports carry a per-dtype ledger, its shift between the
  arms (:func:`dtype_shift`; the port's reports have none —
  ``numerics.dtype_ledgers`` is ``[]`` — so this table is the
  reference's alone);
- when both reports carry a ``comm`` section, the per-AXIS collective
  bytes of their ledgers (``obs.comm_ledger``) and the ratio between
  the arms: the evidence that a compressed arm compressed, on the axis
  it claims;
- one final JSON line with the verdict and the headline deltas.

Exit code: 0 for ``exact`` / ``bounded``, 1 for ``diverged``, 2 for
usage or input errors.  It reads artifacts only (no torch, no card),
hence the bare prints.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

from ..obs.parity import PARITY_VERDICTS, compare_streams, stream_of


def load_run(path: str) -> Tuple[Any, Optional[Dict[str, Any]]]:
    """(stream source, report-or-None) from a RUNREPORT.json or a records
    JSONL file.  A JSON object is a report; anything else is parsed line
    by line as JSONL records."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
        if isinstance(doc, dict):
            return doc, doc
        if isinstance(doc, list):
            return doc, None
    except ValueError:
        pass
    records: List[Dict[str, Any]] = []
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln:
            continue
        try:
            rec = json.loads(ln)
        except ValueError:
            continue
        if isinstance(rec, dict):
            records.append(rec)
    if not records:
        raise ValueError(f"{path}: neither a JSON report nor JSONL records")
    return records, None


def dtype_shift(
    rep_a: Optional[Dict[str, Any]], rep_b: Optional[Dict[str, Any]]
) -> Optional[List[Dict[str, Any]]]:
    """Per-dtype byte/FLOP deltas between two reports' primary dtype
    ledgers; None when either side lacks one."""
    def primary(rep):
        leds = ((rep or {}).get("numerics") or {}).get("dtype_ledgers") or []
        return leds[0].get("per_dtype") if leds else None

    pa, pb = primary(rep_a), primary(rep_b)
    if not pa or not pb:
        return None
    rows = []
    for dt in sorted(set(pa) | set(pb)):
        a = pa.get(dt, {"bytes": 0, "ops": 0, "flops": 0})
        b = pb.get(dt, {"bytes": 0, "ops": 0, "flops": 0})
        rows.append({
            "dtype": dt,
            "bytes_a": a["bytes"], "bytes_b": b["bytes"],
            "bytes_delta": b["bytes"] - a["bytes"],
            "flops_a": a["flops"], "flops_b": b["flops"],
            "flops_delta": b["flops"] - a["flops"],
        })
    return rows


def comm_axis_shift(
    rep_a: Optional[Dict[str, Any]], rep_b: Optional[Dict[str, Any]]
) -> Optional[List[Dict[str, Any]]]:
    """Per-axis collective-bytes deltas between two reports' comm ledgers
    (collectives aggregated by the mesh-axis set they span); None when
    either side lacks a ledger.  The compressed-bytes evidence: an int8
    arm's compressed axis shows its bytes divided by the wire win, while
    untouched axes match — a drop appearing on the WRONG axis (or none at
    all) means the compression didn't land where claimed."""
    def per_axis(rep):
        colls = (((rep or {}).get("comm") or {}).get("ledger") or {}).get(
            "collectives")
        if not colls:
            return None
        agg: Dict[str, Dict[str, int]] = {}
        for c in colls:
            key = "+".join(c.get("axes") or []) or "?"
            e = agg.setdefault(key, {"bytes": 0, "ops": 0})
            e["bytes"] += int(c.get("bytes", 0))
            e["ops"] += 1
        return agg

    pa, pb = per_axis(rep_a), per_axis(rep_b)
    if pa is None or pb is None:
        return None
    rows = []
    for ax in sorted(set(pa) | set(pb)):
        a = pa.get(ax, {"bytes": 0, "ops": 0})
        b = pb.get(ax, {"bytes": 0, "ops": 0})
        rows.append({
            "axes": ax,
            "bytes_a": a["bytes"], "bytes_b": b["bytes"],
            "ops_a": a["ops"], "ops_b": b["ops"],
            "ratio": round(a["bytes"] / b["bytes"], 3) if b["bytes"] else None,
        })
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m torchdistpackage_tpu_torch.tools.parity_diff",
        description="Compare two runs' per-step streams into an "
                    "exact|bounded|diverged verdict (nonzero exit on "
                    "diverged).")
    ap.add_argument("run_a", help="RUNREPORT.json or records.jsonl of arm A")
    ap.add_argument("run_b", help="RUNREPORT.json or records.jsonl of arm B")
    ap.add_argument("--key", default="loss",
                    help="step-record scalar to compare (default: loss)")
    ap.add_argument("--rtol", type=float, default=0.05,
                    help="relative drift bound for 'bounded' (default 0.05)")
    ap.add_argument("--atol", type=float, default=1e-9,
                    help="absolute drift floor (default 1e-9)")
    ap.add_argument("--label-a", default="a", help="display name for arm A")
    ap.add_argument("--label-b", default="b", help="display name for arm B")
    args = ap.parse_args(argv)

    try:
        src_a, rep_a = load_run(args.run_a)
        src_b, rep_b = load_run(args.run_b)
    except (OSError, ValueError) as e:
        print(f"parity_diff: {e}", file=sys.stderr)
        return 2
    sa = stream_of(src_a, key=args.key)
    sb = stream_of(src_b, key=args.key)
    cmp = compare_streams(sa, sb, key=args.key, rtol=args.rtol,
                          atol=args.atol)
    assert cmp["verdict"] in PARITY_VERDICTS

    print(f"parity: {args.label_a} ({len(sa)} steps) vs "
          f"{args.label_b} ({len(sb)} steps), key={args.key!r}, "
          f"{cmp['n_common']} common")
    if cmp["n_common"]:
        print(f"{'step':>6} {'|a-b|':>12} {'rel':>10}")
        for row in cmp["drift_curve"]:
            d, r = row["delta"], row["rel"]
            print(f"{row['step']:>6} "
                  + (f"{d:>12.4e}" if d is not None else f"{'nonfinite':>12}")
                  + (f" {r:>10.3e}" if r is not None else f" {'-':>10}"))
        print(f"max |a-b| = {cmp['max_abs_delta']:.4e}, "
              f"max rel = {cmp['max_rel_delta']:.3e} "
              f"(bound: atol {args.atol:g} + rtol {args.rtol:g})")
        if cmp.get("first_mismatch_step") is not None:
            print(f"first out-of-bound step: {cmp['first_mismatch_step']}")

    shift = dtype_shift(rep_a, rep_b)
    if shift:
        print(f"\ndtype ledger shift ({args.label_a} -> {args.label_b}):")
        print(f"{'dtype':>8} {'bytes A':>14} {'bytes B':>14} "
              f"{'flops A':>12} {'flops B':>12}")
        for r in shift:
            print(f"{r['dtype']:>8} {r['bytes_a']:>14,} {r['bytes_b']:>14,} "
                  f"{r['flops_a']:>12.3e} {r['flops_b']:>12.3e}")

    cshift = comm_axis_shift(rep_a, rep_b)
    if cshift:
        print(f"\ncomm ledger shift per axis "
              f"({args.label_a} -> {args.label_b}):")
        print(f"{'axes':>16} {'bytes A':>14} {'bytes B':>14} "
              f"{'A/B':>7} {'ops A':>6} {'ops B':>6}")
        for r in cshift:
            ratio = f"{r['ratio']:.2f}x" if r["ratio"] else "-"
            print(f"{r['axes']:>16} {r['bytes_a']:>14,} {r['bytes_b']:>14,} "
                  f"{ratio:>7} {r['ops_a']:>6} {r['ops_b']:>6}")

    line = {
        "metric": "parity",
        "key": args.key,
        "verdict": cmp["verdict"],
        "n_common": cmp["n_common"],
        "max_abs_delta": cmp.get("max_abs_delta"),
        "max_rel_delta": cmp.get("max_rel_delta"),
        "labels": [args.label_a, args.label_b],
    }
    if shift:
        line["dtype_bytes_delta"] = {
            r["dtype"]: r["bytes_delta"] for r in shift if r["bytes_delta"]}
    if cshift:
        line["comm_axis_bytes"] = {
            r["axes"]: {"a": r["bytes_a"], "b": r["bytes_b"],
                        "ratio": r["ratio"]}
            for r in cshift}
    print(json.dumps(line))
    if cmp["verdict"] == "diverged":
        print(f"\n!!! DIVERGED: {args.label_b} drifted past the bound vs "
              f"{args.label_a} (key {args.key!r})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
