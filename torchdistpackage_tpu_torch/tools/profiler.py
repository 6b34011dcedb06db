"""Per-block model profiler — the port's
``torchdistpackage_tpu/tools/profiler.py`` (the reference's
``module_profiler``).

A model is profiled as a sequence of named block functions, each fed the
previous block's output: per block its time (CUDA events around
``iters`` calls on the card after ``warmup`` ones; the host clock on the
CPU), its activation bytes (the output tensors' bytes: what remat would
not keep) and, on the card, its temporary bytes (the allocator's peak
during the calls above what was allocated before them).  The report
ranks blocks by activation MB per ms of recompute, the reference's
remat-placement metric.

There is no compiled cost analysis: ``flops`` and ``bytes_accessed`` stay
0.0, as the reference leaves them when its backend reports none
(``torch.utils.flop_counter`` does not see the ctypes-launched
kernels).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

PyTree = Any


@dataclasses.dataclass
class BlockProfile:
    name: str
    time_ms: float
    act_bytes: int
    flops: float
    bytes_accessed: float
    temp_bytes: int

    @property
    def act_mb(self) -> float:
        return self.act_bytes / 1e6

    @property
    def mb_per_ms(self) -> float:
        """Activation memory freed per ms of recompute paid."""
        return self.act_mb / self.time_ms if self.time_ms > 0 else float("inf")


def _tensors(tree: PyTree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _tree_bytes(tree: PyTree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _device(tree: PyTree):
    for t in _tensors(tree):
        if t.is_cuda:
            return t.device
    return None


def profile_blocks(blocks: Sequence[Tuple[str, Callable]], x: PyTree,
                   warmup: int = 1, iters: int = 3
                   ) -> Tuple[List[BlockProfile], PyTree]:
    """Run ``x`` through ``[(name, fn), ...]`` in order, profiling each
    (JAX :86); returns the profiles and the last output.  Each block is
    called ``warmup + iters`` times (``warmup=0, iters=1``: once)."""
    if iters < 1:
        raise ValueError("iters must be >= 1")
    profiles: List[BlockProfile] = []
    for name, fn in blocks:
        dev = _device(x)
        for _ in range(warmup):
            fn(x)
        if dev is not None:
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0.record()
            for _ in range(iters):
                out = fn(x)
            t1.record()
            t1.synchronize()
            dt_ms = t0.elapsed_time(t1) / iters
            temp = max(0, torch.cuda.max_memory_allocated(dev) - base
                       - _tree_bytes(out))
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(x)
            dt_ms = (time.perf_counter() - t0) / iters * 1e3
            temp = 0
        profiles.append(BlockProfile(name=name, time_ms=dt_ms,
                                     act_bytes=_tree_bytes(out), flops=0.0,
                                     bytes_accessed=0.0, temp_bytes=temp))
        x = out
    return profiles, x


def report_prof(profiles: Sequence[BlockProfile],
                sort_by_ratio: bool = True) -> str:
    """Formatted table, MB/ms-sorted (JAX :128): the top rows are the best
    remat candidates."""
    rows = list(profiles)
    if sort_by_ratio:
        rows = sorted(rows, key=lambda p: -p.mb_per_ms)
    header = (
        f"{'block':<24}{'time_ms':>10}{'act_MB':>10}{'MB/ms':>10}"
        f"{'GFLOP':>10}{'GB_touched':>12}{'temp_MB':>10}")
    lines = [header, "-" * len(header)]
    for p in rows:
        lines.append(
            f"{p.name:<24}{p.time_ms:>10.3f}{p.act_mb:>10.3f}"
            f"{p.mb_per_ms:>10.3f}{p.flops / 1e9:>10.3f}"
            f"{p.bytes_accessed / 1e9:>12.4f}{p.temp_bytes / 1e6:>10.3f}")
    total_t = sum(p.time_ms for p in profiles)
    total_mb = sum(p.act_mb for p in profiles)
    lines.append("-" * len(header))
    lines.append(f"{'TOTAL':<24}{total_t:>10.3f}{total_mb:>10.3f}")
    return "\n".join(lines)


def aggregate_levels(profiles: Sequence[BlockProfile]
                     ) -> Dict[int, List[BlockProfile]]:
    """Per-depth roll-up over slash-path block names (JAX :154): depth d
    groups by the first d path segments, summing time, activation bytes,
    FLOPs and bytes, and taking the max of the temporaries (blocks run
    one after another); a name shallower than d aggregates as itself."""
    if not profiles:
        return {}
    out: Dict[int, List[BlockProfile]] = {}
    max_depth = max(p.name.count("/") + 1 for p in profiles)
    for d in range(1, max_depth + 1):
        groups: Dict[str, BlockProfile] = {}
        for p in profiles:
            key = "/".join(p.name.split("/")[:d])
            g = groups.get(key)
            if g is None:
                groups[key] = dataclasses.replace(p, name=key)
            else:
                g.time_ms += p.time_ms
                g.act_bytes += p.act_bytes
                g.flops += p.flops
                g.bytes_accessed += p.bytes_accessed
                g.temp_bytes = max(g.temp_bytes, p.temp_bytes)
        out[d] = list(groups.values())
    return out


def report_tree(profiles: Sequence[BlockProfile]) -> str:
    """One MB/ms-sorted table per depth level (JAX :190)."""
    sections = []
    for depth, rows in sorted(aggregate_levels(profiles).items()):
        sections.append(f"== level {depth} ==")
        sections.append(report_prof(rows))
    return "\n".join(sections)


def get_model_profile(blocks: Sequence[Tuple[str, Callable]], x: PyTree,
                      warmup: int = 1, iters: int = 3,
                      print_report: bool = True) -> List[BlockProfile]:
    """Profile and report in one call (JAX :201): slash-path names get the
    per-level tree report, flat names the single table."""
    profiles, _ = profile_blocks(blocks, x, warmup=warmup, iters=iters)
    if print_report:
        from ..utils.logging import master_print

        tree = any("/" in p.name for p in profiles)
        master_print(report_tree(profiles) if tree else report_prof(profiles))
    return profiles
