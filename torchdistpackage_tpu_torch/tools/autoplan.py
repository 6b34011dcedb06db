"""The planner's command line — the port's
``torchdistpackage_tpu/tools/autoplan.py``: plan from a JSON model config
and a chip count.

    python -m torchdistpackage_tpu_torch.tools.autoplan --config model.json \
        --chips 8 [--batch 64] [--hbm-gb 80] [--chip "NVIDIA H100 80GB HBM3"] \
        [--effective-tflops 168] [--no-pp] [--executable-only] [--top 8]

``model.json`` holds the model's dims under the ``GPTConfig`` /
``TransformerConfig`` field names: ``{"vocab_size": 32768, "dim": 768,
"nheads": 12, "nlayers": 12, "max_seq": 2048, "ffn_mult": 4, "dtype":
"bfloat16"}`` (no ``vocab_size``: the transformer family).  The tool
enumerates layouts x int8 arms (``dist/autoplan.py``), prunes those over
the ``--hbm-gb`` budget, scores the rest by the alpha-beta comm model of
``--chip`` and the 6N + 12LSD compute term, prints the ranked table and
then ONE JSON line (the machine-readable result).

Exit code: 0 a plan was chosen, 1 every candidate is over the memory
budget (the clean all-OOM verdict; the table shows by how much), 2 a
usage error or an unreadable config.

It needs no card and no ``transformers`` (the analytic memory mirror,
pinned byte for byte to ``MemoryModel`` by the CPU tests, and the comm
model's tables), hence the bare prints.  Plan in-process with
``dist.autoplan.plan(..., comm_model=CommModel.calibrate(...))`` for a
calibrated comm model.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from ..dist import autoplan as _ap


def _fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"


def render_table(result: Dict[str, Any]) -> List[str]:
    """Human ranked table + pruned roll-up for one plan() result."""
    L: List[str] = []
    p = result["params"]
    basis = result["basis"]
    L.append(
        f"autoplan: {p['n_chips']} chip(s), global batch "
        f"{p['global_batch']}, seq {p['seq_len']} — "
        f"{result['n_candidates']} candidate(s), "
        f"{result['n_pruned_oom']} pruned over-budget "
        f"(comm {basis['comm']}, compute {basis['compute']}, "
        f"memory {basis['memory']})")
    ranked = result.get("ranked") or []
    if ranked:
        L.append(
            f"  {'rank':>4}  {'plan':24s} {'step':>10} {'compute':>10} "
            f"{'comm':>10} {'resident':>10}  verdict")
        for i, r in enumerate(ranked):
            mem = r.get("memory") or {}
            L.append(
                f"  {i + 1:>4}  {r['key']:24s} "
                f"{r['step_s'] * 1e3:>8.3f}ms {r['compute_s'] * 1e3:>8.3f}ms "
                f"{r['comm_s'] * 1e3:>8.3f}ms "
                f"{_fmt_bytes(mem.get('total_bytes')):>10}  "
                f"{mem.get('verdict', '?')}")
    for row in result.get("pruned") or []:
        frac = row.get("frac")
        L.append(
            f"  OOM   {row['key']:24s} {_fmt_bytes(row['total_bytes']):>10}"
            f" of {_fmt_bytes(row.get('capacity_bytes'))}"
            + (f" ({frac:.0%})" if isinstance(frac, (int, float)) else ""))
    chosen = result.get("chosen")
    if chosen:
        L.append(f"  chosen: {chosen['key']} — modeled step "
                 f"{chosen['step_s'] * 1e3:.3f} ms, mesh "
                 f"{chosen['mesh_axes']}")
        for t in chosen.get("terms", []):
            tag = " int8" if t.get("compressed") else ""
            L.append(
                f"    {t['name']:>18}{tag}: {t['count']} x {t['op']} over "
                f"{'+'.join(t['axes'])} ({t['payload_bytes']:,} B) -> "
                f"{t['total_s'] * 1e3:.3f} ms")
    else:
        L.append("  NO PLAN FITS: every candidate exceeds the memory "
                 "budget (verdict all_oom)")
    return L


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m torchdistpackage_tpu_torch.tools.autoplan",
        description="Rank parallelism plans for a JSON model config + chip "
                    "count; nonzero exit when no plan fits the memory "
                    "budget.")
    ap.add_argument("--config", required=True,
                    help="JSON file of model dims (GPTConfig field names)")
    ap.add_argument("--chips", type=int, required=True,
                    help="number of devices to plan for")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: chips)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default: config max_seq)")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="per-device HBM budget in GB (default: no budget, "
                         "nothing prunes)")
    ap.add_argument("--chip", default=None,
                    help="CUDA device name for the comm / compute tables, "
                         "e.g. 'NVIDIA H100 80GB HBM3' (default: generic "
                         "link parameters)")
    ap.add_argument("--effective-tflops", type=float, default=None,
                    help="sustained TFLOP/s a card for the compute term "
                         "(default: a recognised card's peak times its "
                         "measured fraction, else 1 TFLOP/s 'assumed')")
    ap.add_argument("--optimizer-slots", type=int, default=2,
                    help="optimizer moment buffers a parameter (AdamW 2), "
                         "each in the parameters' dtype unless "
                         "--opt-itemsize says otherwise")
    ap.add_argument("--opt-itemsize", type=int, default=None,
                    help="bytes a moment element (default: the "
                         "parameters' dtype, the port's AdamW; 4 for f32 "
                         "moments)")
    ap.add_argument("--act-factor", type=float, default=1.0,
                    help="activation multiplier per layer boundary")
    ap.add_argument("--microbatches", type=int, default=8,
                    help="microbatch count assumed for pipeline plans")
    ap.add_argument("--no-pp", action="store_true",
                    help="skip pipeline-parallel candidates")
    ap.add_argument("--no-compress", action="store_true",
                    help="skip int8 compression arms")
    ap.add_argument("--executable-only", action="store_true",
                    help="restrict to the plans make_plan_step builds")
    ap.add_argument("--top", type=int, default=8,
                    help="ranked alternatives to keep (default 8)")
    args = ap.parse_args(argv)

    try:
        with open(args.config) as f:
            cfg = json.load(f)
        if not isinstance(cfg, dict):
            raise ValueError(f"config is {type(cfg).__name__}, expected "
                             f"a JSON object")
    except (OSError, ValueError) as e:
        print(f"autoplan: unreadable config {args.config}: {e}",
              file=sys.stderr)
        return 2
    try:
        result = _ap.plan(
            cfg,
            args.chips,
            global_batch=args.batch if args.batch else args.chips,
            seq_len=args.seq,
            capacity_bytes=(int(args.hbm_gb * 1e9) if args.hbm_gb else None),
            effective_flops=(args.effective_tflops * 1e12
                             if args.effective_tflops else None),
            optimizer_slots=args.optimizer_slots,
            opt_itemsize=args.opt_itemsize,
            act_factor=args.act_factor,
            microbatches=args.microbatches,
            allow_pp=not args.no_pp,
            compression=not args.no_compress,
            executable_only=args.executable_only,
            memory="analytic",  # the mirror pinned to MemoryModel
            device_kind=args.chip,
            top=args.top,
            emit=False,  # a command line: no event timeline to land on
        )
    except ValueError as e:
        print(f"autoplan: {e}", file=sys.stderr)
        return 2
    for ln in render_table(result):
        print(ln)
    chosen = result.get("chosen")
    line = {
        "metric": "autoplan",
        "verdict": result["verdict"],
        "n_candidates": result["n_candidates"],
        "n_pruned_oom": result["n_pruned_oom"],
        "chosen": (None if chosen is None else {
            k: chosen[k] for k in ("key", "mesh_axes", "layout", "compress",
                                   "step_s", "compute_s", "comm_s")
        }),
        "basis": result["basis"],
    }
    print(json.dumps(line))
    return 0 if chosen is not None else 1


if __name__ == "__main__":
    sys.exit(main())
