"""The attention kernels' tuner — the port's
``torchdistpackage_tpu/tools/flash_tune.py``: time the knobs each kernel
exposes on the attached card and rank them.

- K3 (``ops/flash_attention.py``): the bf16 forward's tile, ``(block_q,
  block_k, stages)`` of :data:`~..ops.flash_attention.FWD_TILES` (the
  instantiations ``csrc/flash_attention.cu`` builds), timed forward +
  backward; K4's and K5's tiles are fixed and the report names them.
  The reference tunes its Pallas kernel's ``(block_q, block_k)`` and
  clamps each to a divisor of S; here the candidates that launch the
  same instantiation are timed once.
- K1 (``ops/paged_attention.py``): the decode rows' split width
  ``nsplit`` (the reference tunes ``fetch_width`` / ``q_pad_to``), timed
  at both serving shapes, ``S_in = 1`` and the speculative verify's
  ``S_in = spec_k + 1``, the rule's own :func:`decode_splits` among the
  candidates.

Usage::

    from torchdistpackage_tpu_torch.tools import tune_flash_blocks
    best, report = tune_flash_blocks(batch=16, heads=12, seq=2048,
                                     head_dim=64)

or ``python -m torchdistpackage_tpu_torch.tools.flash_tune [--paged]``.
Times come from CUDA events around ``steps`` calls after ``warmup`` (K1's
from ``steps`` replays of a CUDA graph of the call: eager, a decode
call's host cost would hide its kernel); the report names the card and
its power limit.  A tile the report finds
faster is not made the default here: the tuned rows
(``_TUNED_TILES``, ``decode_splits``) change on a measured gain of their
own.  ``device='cpu'`` runs each candidate's plain version, which checks
the harness and nothing of the kernels' speed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device
from ..ops import flash_attention as fa
from ..ops import paged_attention as pa

#: K3 candidates, ``(block_q, block_k)`` or ``(block_q, block_k,
#: stages)`` (None entries take the default's value): every built tile
DEFAULT_CANDIDATES: Tuple[Tuple[int, ...], ...] = fa.FWD_TILES


def card_of(device: torch.device) -> Dict[str, Any]:
    """The device's name and, for a card, ``nvidia-smi``'s name and power
    limit (every time the tuner reports stands beside them)."""
    if device.type != "cuda":
        return {"device": str(device)}
    out = {"device": torch.cuda.get_device_name(device)}
    try:
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out["nvidia_smi"] = f"unavailable ({e!r})"
    return out


def _time_ms(fn: Callable[[], Any], steps: int, warmup: int,
             device: torch.device, graph: bool = False) -> float:
    """Milliseconds a call of ``fn``: CUDA events around ``steps`` calls
    after ``warmup`` on a card, the host clock on the CPU.  ``graph``:
    on a card, ``fn`` captured once in a CUDA graph and the graph
    replayed ``steps`` times — the device's time without the host's cost
    of launching (a decode call's host time is as long as its kernel's)."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        call = fn
        if graph:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn()
            call = g.replay
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            call()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / steps
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / steps


def _ranked(rows: List[Dict[str, Any]], what: str
            ) -> List[Dict[str, Any]]:
    """Rows with a time sorted fastest first with ``rel`` (time over the
    fastest), then the error rows, as the reference orders them."""
    ok = [r for r in rows if r.get("ms") is not None]
    if not ok:
        raise RuntimeError(f"no {what} candidate succeeded: {rows}")
    ok.sort(key=lambda r: r["ms"])
    for r in ok:
        r["rel"] = round(r["ms"] / ok[0]["ms"], 4)
    return ok + [r for r in rows if r.get("ms") is None]


def tune_flash_blocks(
    batch: int = 16,
    heads: int = 12,
    seq: int = 2048,
    head_dim: int = 64,
    causal: bool = True,
    dtype: torch.dtype = torch.bfloat16,
    candidates: Sequence[Tuple[Optional[int], ...]] = DEFAULT_CANDIDATES,
    steps: int = 10,
    warmup: int = 2,
    seed: int = 0,
    device=None,
) -> Tuple[Tuple[int, int, int], List[Dict[str, Any]]]:
    """Time forward + backward of ``flash_attention`` at ``[batch, heads,
    seq, head_dim]`` for each K3 tile of ``candidates``.

    Returns ``(best, report)``: ``best`` the fastest ``(block_q, block_k,
    stages)``; ``report`` rows ``{"block_q", "block_k", "stages", "ms",
    "rel", "default", "bwd_tiles"}`` fastest first (``rel``: time over the
    fastest), then ``{"block_q", "block_k", "stages", "ms": None,
    "error"}`` for each candidate that failed (a tile not built).  Two
    candidates that resolve to the same tile are timed once."""
    device = resolve_device(device)
    g = torch.Generator(device="cpu").manual_seed(seed)
    shape = (batch, heads, seq, head_dim)
    q, k, v = (torch.randn(shape, generator=g).to(device=device, dtype=dtype)
               .requires_grad_(True) for _ in range(3))
    default = fa.resolve_tiles(q)
    bwd = fa.BWD_TILES.get(head_dim)
    seen, rows = set(), []
    for cand in candidates:
        cand = tuple(cand) + (None,) * (3 - len(cand))
        try:
            tile = fa.resolve_tiles(q, *cand)
        except ValueError as e:  # not built: an error row, as JAX's
            rows.append({"block_q": cand[0], "block_k": cand[1],
                         "stages": cand[2], "ms": None,
                         "error": repr(e)[:200]})
            continue
        if tile in seen:
            continue
        seen.add(tile)

        def fwd_bwd(tile=tile):
            o = fa.flash_attention(q, k, v, causal=causal, block_q=tile[0],
                                   block_k=tile[1], stages=tile[2])
            o.float().sum().backward()
            q.grad = k.grad = v.grad = None

        rows.append({"block_q": tile[0], "block_k": tile[1],
                     "stages": tile[2],
                     "ms": _time_ms(fwd_bwd, steps, warmup, device),
                     "default": tile == default, "bwd_tiles": bwd})
    report = _ranked(rows, "flash tile")
    best = report[0]
    return (best["block_q"], best["block_k"], best["stages"]), report


# ------------------------------------------------- paged-attention tuner


def paged_inputs(num_slots: int = 8, kv_heads: int = 8, groups: int = 4,
                 head_dim: int = 128, block_size: int = pa.BLOCK,
                 max_blocks: int = 128, spec_k: int = 3, seed: int = 0,
                 device=None) -> Dict[str, Any]:
    """A bf16 decode step's inputs at a serving shape (JAX :191): a pool of
    ``max_blocks * num_slots + 1`` blocks, each slot's table a slice of a
    random permutation, live depths between a quarter of the context and
    all of it, and q at ``S_in = 1`` (``"decode"``) and ``spec_k + 1``
    (``"verify"``).  A pool block size the kernel does not take raises."""
    if block_size != pa.BLOCK:
        raise ValueError(f"the paged kernel takes pool blocks of "
                         f"{pa.BLOCK} positions, got {block_size}")
    device = resolve_device(device)
    g = torch.Generator(device="cpu").manual_seed(seed)
    bf = dict(device=device, dtype=torch.bfloat16)
    nb = max_blocks * num_slots + 1
    pools = [torch.randn((nb, kv_heads, block_size, head_dim), generator=g
                         ).to(**bf) for _ in range(2)]
    tables = (torch.randperm(nb - 1, generator=g)[:num_slots * max_blocks]
              + 1).reshape(num_slots, max_blocks).to(torch.int32)
    ctx = max_blocks * block_size
    offsets = torch.randint(ctx // 4, ctx - spec_k - 1, (num_slots,),
                            generator=g).to(torch.int32)
    H = kv_heads * groups
    q = {name: torch.randn((num_slots, H, s_in, head_dim), generator=g
                           ).to(**bf)
         for name, s_in in (("decode", 1), ("verify", spec_k + 1))}
    return {"k_pool": pools[0], "v_pool": pools[1],
            "tables": tables.to(device), "offsets": offsets.to(device),
            "q": q}


def rule_nsplit(inputs: Dict[str, Any]) -> int:
    """The split width the wrapper picks by itself for these inputs
    (:func:`~..ops.paged_attention.decode_splits` on the card's SM count,
    132 on the CPU)."""
    kp, tables = inputs["k_pool"], inputs["tables"]
    bh = tables.shape[0] * kp.shape[1]
    if kp.device.type == "cuda":
        return pa._splits_for(bh, tables.shape[1], kp.device)
    return pa.decode_splits(bh, tables.shape[1])


def tune_paged_params(
    num_slots: int = 8,
    kv_heads: int = 8,
    groups: int = 4,
    head_dim: int = 128,
    block_size: int = pa.BLOCK,
    max_blocks: int = 128,
    spec_k: int = 3,
    candidates: Optional[Sequence[int]] = None,
    steps: int = 200,
    warmup: int = 3,
    seed: int = 0,
    device=None,
) -> Tuple[Dict[str, int], List[Dict[str, Any]]]:
    """Time K1's decode rows at each ``nsplit`` of ``candidates`` (default:
    1, 2, 4, ... up to the table width, and the rule's own width) at both
    serving shapes of :func:`paged_inputs`, each timed as ``steps``
    replays of a CUDA graph of the call on a card.  Returns ``(best, report)``:
    ``best`` ``{"nsplit": n}``; ``report`` rows ``{"nsplit", "ms"
    (decode + verify), "decode_ms", "verify_ms", "rel", "rule"}`` fastest
    first, then ``{"nsplit", "ms": None, "error"}`` for each that failed
    (a width outside ``[1, max_blocks]``)."""
    inputs = paged_inputs(num_slots, kv_heads, groups, head_dim, block_size,
                          max_blocks, spec_k, seed, device)
    device = inputs["k_pool"].device
    rule = rule_nsplit(inputs)
    if candidates is None:
        candidates = sorted({1 << i for i in range(max_blocks.bit_length())
                             if 1 << i <= max_blocks} | {rule})
    rows = []
    for n in dict.fromkeys(int(c) for c in candidates):
        row: Dict[str, Any] = {"nsplit": n}
        try:
            for name, q in inputs["q"].items():
                row[f"{name}_ms"] = _time_ms(
                    lambda q=q: pa.paged_decode_attention(
                        q, inputs["k_pool"], inputs["v_pool"],
                        inputs["tables"], inputs["offsets"], nsplit=n),
                    steps, warmup, device, graph=True)
        except ValueError as e:
            rows.append({"nsplit": n, "ms": None, "error": repr(e)[:200]})
            continue
        row["ms"] = row["decode_ms"] + row["verify_ms"]
        row["rule"] = n == rule
        rows.append(row)
    report = _ranked(rows, "nsplit")
    return {"nsplit": report[0]["nsplit"]}, report


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m torchdistpackage_tpu_torch.tools.flash_tune",
        description="Time K3's tiles (default) or K1's split widths "
                    "(--paged) on the card and print the ranking as JSON.")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--head-dim", type=int, default=None,
                    help="default 64 (K3, bench.py's shape), 128 with "
                         "--paged (Mistral-7B's)")
    ap.add_argument("--steps", type=int, default=None,
                    help="timed calls: default 10 (K3), 200 graph replays "
                         "(--paged)")
    ap.add_argument("--no-causal", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default the card; 'cpu' checks the harness only")
    ap.add_argument("--paged", action="store_true",
                    help="tune K1's decode split width at the serving "
                         "shapes instead of K3's tile")
    ap.add_argument("--slots", type=int, default=8,
                    help="--paged: decode batch width")
    ap.add_argument("--kv-heads", type=int, default=8,
                    help="--paged: KV heads (q heads = groups x kv heads)")
    ap.add_argument("--groups", type=int, default=4,
                    help="--paged: query heads a KV head")
    ap.add_argument("--block-size", type=int, default=pa.BLOCK,
                    help="--paged: pool block size (the kernel's 16)")
    ap.add_argument("--max-blocks", type=int, default=128,
                    help="--paged: table width (context / block size)")
    ap.add_argument("--spec-k", type=int, default=3,
                    help="--paged: the verify shape's drafts (S_in = K+1)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.paged:
        best, report = tune_paged_params(
            num_slots=args.slots, kv_heads=args.kv_heads, groups=args.groups,
            head_dim=args.head_dim or 128,
            block_size=args.block_size, max_blocks=args.max_blocks,
            spec_k=args.spec_k, steps=args.steps or 200, device=device)
        out = {"kernel": "paged_decode_attention", **card_of(device),
               "shape": {"num_slots": args.slots, "kv_heads": args.kv_heads,
                         "groups": args.groups,
                         "block_size": args.block_size,
                         "max_blocks": args.max_blocks,
                         "spec_k": args.spec_k},
               "best": best, "report": report}
    else:
        best, report = tune_flash_blocks(
            batch=args.batch, heads=args.heads, seq=args.seq,
            head_dim=args.head_dim or 64, causal=not args.no_causal,
            steps=args.steps or 10, device=device)
        out = {"kernel": "flash_attention", **card_of(device),
               "shape": [args.batch, args.heads, args.seq,
                         args.head_dim or 64],
               "best": dict(zip(("block_q", "block_k", "stages"), best)),
               "report": report}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
