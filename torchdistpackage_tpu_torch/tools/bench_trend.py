"""Bench trajectory — the port's ``torchdistpackage_tpu/tools/bench_trend.py``:
compare bench rounds (``BENCH_r*.json``-shaped files).

A round file is ``{"n", "tail", "parsed"}``: the bench harness's stdout
tail holds one JSON line per measured metric.

    python -m torchdistpackage_tpu_torch.tools.bench_trend [--dir DIR]
        [--threshold 0.05] [--glob 'BENCH_r*.json']

parses every round, groups the metric lines per series (the ``metric``
key), prints the per-round values with round-over-round deltas, and
exits NONZERO with a ``REGRESSION`` warning when the newest round lost
more than ``--threshold`` (default 5%) against the best earlier round of
the same series.  Stale lines (``"stale": true``: the accelerator was
unreachable and the harness replayed the last good record) are shown
but never counted as fresh evidence.  ``--dir`` defaults to the
checkout's root.  It reads artifacts only, hence the bare prints.
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import sys
from typing import Any, Dict, List, Tuple

#: JSON-line keys shown beside the headline value when present (only
#: ``value`` gates): the secondary metrics that say HOW a headline was
#: earned — MFU and memory headroom, the final grad norm (a held
#: throughput that trained garbage), the comm bytes per dimension
#: (rendered as their total, ``comm_bytes=``), serving's shed and
#: preempt counts, prefix-hit and speculative-accept rates, SLO
#: attainment and goodput, the planner's modeled step, the pipeline's
#: bubble fraction and schedule, the fleet's affinity, migration and
#: autoscaling counts, MoE expert imbalance, and the long-context TTFT.
AUX_KEYS = ("mfu", "mfu_xla", "peak_hbm_bytes", "mem_headroom_frac",
            "grad_norm_final", "comm_bytes_per_dim", "shed_rate",
            "preempt_count", "prefix_hit_rate", "spec_accept_rate",
            "slo_attainment", "goodput_tok_s", "paged_pallas_tok_s",
            "autoplan_tok_s", "plan_modeled_step_s", "bubble_fraction",
            "plan_pp_schedule", "fleet_goodput_tok_s", "affinity_hit_rate",
            "migration_bytes", "fleet_slo_attainment", "migration_count",
            "moe_pallas_tok_s", "expert_imbalance",
            "autoscale_actions", "migration_retry_count",
            "transport_fallback_count",
            "cp_prefill_ttft_s", "long_ctx_tok_s")


def _aux_str(key: str, val: Any) -> str:
    if key == "comm_bytes_per_dim" and isinstance(val, dict):
        return f"comm_bytes={sum(v for v in val.values() if isinstance(v, (int, float))):,.0f}"
    return f"{key}={val}"


def _metric_lines(tail: str) -> List[Dict[str, Any]]:
    """Every parseable JSON object in a round's stdout tail that looks
    like a bench line (has metric + numeric value)."""
    out = []
    for ln in tail.splitlines():
        ln = ln.strip()
        if not ln.startswith("{"):
            continue
        try:
            rec = json.loads(ln)
        except ValueError:
            continue
        if isinstance(rec, dict) and isinstance(
                rec.get("value"), (int, float)) and rec.get("metric"):
            out.append(rec)
    return out


def load_rounds(paths: List[str]) -> List[Tuple[int, List[Dict[str, Any]]]]:
    """[(round_number, [metric lines...])], sorted by round."""
    rounds = []
    for p in paths:
        try:
            with open(p) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"bench_trend: skipping unreadable {p}: {e}",
                  file=sys.stderr)
            continue
        lines = _metric_lines(doc.get("tail", "") or "")
        parsed = doc.get("parsed")
        if isinstance(parsed, dict) and isinstance(
                parsed.get("value"), (int, float)) and parsed.get("metric"):
            # the round's own pick of the headline line; dedup by identity
            if not any(l.get("metric") == parsed["metric"]
                       and l.get("value") == parsed["value"] for l in lines):
                lines.append(parsed)
        n = doc.get("n")
        if not isinstance(n, int):
            # fall back to the digits in the filename (BENCH_r07.json -> 7)
            digits = "".join(c for c in os.path.basename(p) if c.isdigit())
            n = int(digits) if digits else len(rounds)
        rounds.append((n, lines))
    return sorted(rounds)


def trend(
    rounds: List[Tuple[int, List[Dict[str, Any]]]], threshold: float = 0.05
) -> Tuple[List[str], List[str]]:
    """(report_lines, regression_warnings) over the per-metric series."""
    series: Dict[str, List[Tuple[int, Dict[str, Any]]]] = {}
    for n, lines in rounds:
        for rec in lines:
            series.setdefault(rec["metric"], []).append((n, rec))
    report: List[str] = []
    warnings: List[str] = []
    for metric in sorted(series):
        rows = series[metric]
        report.append(f"{metric}:")
        prev_val = None
        for n, rec in rows:
            val = rec["value"]
            stale = rec.get("stale")
            delta = (
                f" ({(val - prev_val) / prev_val:+.1%})"
                if (prev_val and not stale) else "")
            aux = " ".join(
                _aux_str(k, rec[k]) for k in AUX_KEYS if k in rec)
            report.append(
                f"  r{n:02d}  {val:>12,.1f}{delta}"
                + ("  [STALE]" if stale else "")
                + (f"  {aux}" if aux else "")
                + f"  {rec.get('config', '')}")
            if not stale:
                prev_val = val
        fresh = [(n, r["value"]) for n, r in rows if not r.get("stale")]
        if len(fresh) >= 2:
            best_prior = max(v for _, v in fresh[:-1])
            last_n, last = fresh[-1]
            if best_prior > 0 and (best_prior - last) / best_prior > threshold:
                warnings.append(
                    f"REGRESSION {metric}: r{last_n:02d} = {last:,.1f} is "
                    f"{(best_prior - last) / best_prior:.1%} below the best "
                    f"earlier round ({best_prior:,.1f}) — past the "
                    f"{threshold:.0%} gate")
    return report, warnings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m torchdistpackage_tpu_torch.tools.bench_trend",
        description="Per-metric deltas across the checked-in bench rounds; "
                    "nonzero exit + loud warning on >threshold regressions.")
    ap.add_argument("--dir", default=None,
                    help="repo dir holding the round files (default: the "
                         "package checkout root)")
    ap.add_argument("--glob", default="BENCH_r*.json",
                    help="round-file pattern (default BENCH_r*.json)")
    ap.add_argument("--threshold", type=float, default=0.05,
                    help="relative loss vs the best earlier round that "
                         "trips the regression gate (default 0.05)")
    args = ap.parse_args(argv)
    root = args.dir or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    paths = sorted(_glob.glob(os.path.join(root, args.glob)))
    if not paths:
        print(f"bench_trend: no files match {args.glob} under {root}",
              file=sys.stderr)
        return 2
    report, warnings = trend(load_rounds(paths), threshold=args.threshold)
    for ln in report:
        print(ln)
    for w in warnings:
        print(f"\n!!! {w}", file=sys.stderr)
    return 1 if warnings else 0


if __name__ == "__main__":
    sys.exit(main())
