"""Hang detection and cross-process consistency guards — the port's
``torchdistpackage_tpu/resilience/watchdog.py``.

- **Hangs.**  A collective whose peer died blocks forever, and a
  babysitter sees a live process.  :class:`Watchdog` runs a daemon
  heartbeat thread: the loop (or ``ServingEngine(watchdog=)``, once a
  tick) calls :meth:`Watchdog.beat`, and a beat gap over ``timeout_s``
  escalates ``hang_suspected`` -> (with ``abort=True``, after a further
  grace) ``hang_abort`` and ``os._exit`` so the babysitter can relaunch.
- **Silent desync.**  Ranks that should agree drift apart (stale code on
  one host, a data loader serving a shard twice).  :func:`check_consistency`
  all-gathers a small per-rank fingerprint — step, config hash, code
  hash, random state, a parameter checksum — over a ``torch.distributed``
  group and turns any disagreement into a ``desync_detected`` event that
  names the field.

The fingerprint travels as float64 (``obs.aggregate.gather_f64_rows``),
exact on every backend, where the reference splits it into int32 lanes
for a device without float64; the verdicts are the same.  Without a
process group both guards take a collective-free path.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# --------------------------------------------------------------- watchdog


class Watchdog:
    """Heartbeat-gap detector (daemon thread; context manager), JAX :41::

        with Watchdog(timeout_s=300, abort=True) as dog:
            for step in range(start, total):
                dog.beat(step)
                ...

    - gap > ``timeout_s``    -> ``hang_suspected`` event (once an episode)
    - a beat after one       -> ``hang_resolved`` event
    - gap > ``timeout_s + abort_grace_s`` with ``abort=True`` ->
      ``hang_abort`` event, then ``_exit(exit_code)`` (``os._exit`` unless
      a test replaces it): the process must die, not unwind, since a
      stuck collective would swallow an exception.

    Events go to the process default log (a ``Telemetry`` installs its
    own there)."""

    def __init__(
        self,
        timeout_s: float = 300.0,
        poll_s: Optional[float] = None,
        abort: bool = False,
        abort_grace_s: Optional[float] = None,
        exit_code: int = 87,
        _exit: Optional[Callable[[int], None]] = None,  # test seam
    ) -> None:
        self.timeout_s = float(timeout_s)
        self.poll_s = (poll_s if poll_s is not None
                       else max(0.05, timeout_s / 4.0))
        self.abort = abort
        self.abort_grace_s = (float(abort_grace_s)
                              if abort_grace_s is not None
                              else self.timeout_s)
        self.exit_code = exit_code
        self._exit = _exit or os._exit
        self._last_beat = time.perf_counter()
        self._last_step: Optional[int] = None
        self._suspected = False
        self._stalled_since = self._last_beat
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.n_suspected = 0

    def beat(self, step: Optional[int] = None) -> None:
        """The loop is alive; call once an iteration (thread-safe)."""
        self._last_beat = time.perf_counter()
        if step is not None:
            self._last_step = int(step)

    def start(self) -> "Watchdog":
        if self._thread is not None:
            return self
        self._last_beat = time.perf_counter()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._watch, name="tdp-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _watch(self) -> None:
        from ..obs.events import emit_event

        while not self._stop.wait(self.poll_s):
            age = time.perf_counter() - self._last_beat
            if not self._suspected and age > self.timeout_s:
                self._suspected = True
                self.n_suspected += 1
                self._stalled_since = self._last_beat
                emit_event(
                    "hang_suspected", age_s=round(age, 3),
                    timeout_s=self.timeout_s, last_step=self._last_step,
                    will_abort=self.abort)
            elif self._suspected and age <= self.timeout_s:
                self._suspected = False
                emit_event(
                    "hang_resolved", last_step=self._last_step,
                    stalled_for_s=round(
                        self._last_beat - self._stalled_since, 3))
            if (self.abort and self._suspected
                    and age > self.timeout_s + self.abort_grace_s):
                emit_event(
                    "hang_abort", age_s=round(age, 3),
                    last_step=self._last_step, exit_code=self.exit_code)
                self._exit(self.exit_code)
                return  # reached only with a replaced exit hook


# ----------------------------------------------------- consistency guards


def config_fingerprint(obj: Any) -> str:
    """Stable SHA-256 of any config-ish object (dict / dataclass / str),
    JAX :147: are the ranks running the same experiment."""
    try:
        blob = json.dumps(obj, sort_keys=True, default=repr)
    except TypeError:
        blob = repr(obj)
    return hashlib.sha256(blob.encode()).hexdigest()


_CODE_FP: Optional[str] = None


def code_fingerprint(root: Optional[str] = None) -> str:
    """SHA-256 over a package's ``.py`` sources (sorted relative path +
    contents), JAX :157: catches a rank running stale code.  ``root``
    None is the port's own package, hashed once a process."""
    global _CODE_FP
    if root is None and _CODE_FP is not None:
        return _CODE_FP
    base = root or os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))
    h = hashlib.sha256()
    paths = []
    for dirpath, _dirs, files in os.walk(base):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                paths.append(os.path.join(dirpath, f))
    for p in sorted(paths):
        h.update(os.path.relpath(p, base).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()
    if root is None:
        _CODE_FP = digest
    return digest


def param_checksum(tree: Any) -> float:
    """Sum of ``|x|`` in float64 over every tensor (and array or number)
    of a parameter tree, JAX :186: in-sync ranks holding the same values
    give the same sum, a drifted one another.  A cheap tripwire, not a
    digest; one read-back a leaf (an int8 weight's two tensors)."""
    from ..obs.numerics import tree_leaves

    total = 0.0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += float(leaf.detach().to(torch.float64).abs().sum())
        elif hasattr(leaf, "dtype") or np.isscalar(leaf):
            total += float(np.sum(np.abs(np.asarray(leaf, np.float64))))
    return total


def _hash_parts(hexdigest: str) -> List[float]:
    """Two 16-bit chunks of a hash as exact small floats (JAX's)."""
    v = int(hexdigest[:16], 16)
    return [float(v % 65521), float((v // 65521) % 65521)]


def _rng_sum(rng_key: Any) -> float:
    """A random state's values summed as float64: a ``torch.Generator``'s
    state bytes, or a key tensor / array / number."""
    if isinstance(rng_key, torch.Generator):
        data = rng_key.get_state().numpy()
    elif isinstance(rng_key, torch.Tensor):
        data = rng_key.detach().cpu().numpy()
    else:
        data = rng_key
    return float(np.asarray(data, np.float64).sum())


def consistency_fingerprint(
    step: Optional[int] = None,
    config: Any = None,
    params: Any = None,
    rng_key: Any = None,
    code: bool = False,
) -> Tuple[List[str], List[float]]:
    """(labels, values) — the per-rank vector :func:`check_consistency`
    gathers (JAX :228).  Only the components passed are included."""
    labels: List[str] = []
    values: List[float] = []
    if step is not None:
        labels.append("step")
        values.append(float(int(step)))
    if config is not None:
        labels += ["config_a", "config_b"]
        values += _hash_parts(config_fingerprint(config))
    if code:
        labels += ["code_a", "code_b"]
        values += _hash_parts(code_fingerprint())
    if rng_key is not None:
        labels.append("rng")
        values.append(_rng_sum(rng_key))
    if params is not None:
        labels.append("params")
        values.append(param_checksum(params))
    return labels, values


def check_consistency(
    step: Optional[int] = None,
    config: Any = None,
    params: Any = None,
    rng_key: Any = None,
    code: bool = False,
    event_log=None,
    group=None,
    _gathered: Optional[np.ndarray] = None,
) -> Dict[str, Any]:
    """Cross-rank agreement check (JAX :265); a collective over ``group``
    (None: the default group) when one is initialised — call it on every
    rank.  Returns ``{"ok", "n_hosts", "labels", "mismatched",
    "per_host"}``; a component on which ranks disagree lands in
    ``mismatched`` and one ``desync_detected`` event (on ``event_log`` or
    the process default) carries every rank's value of it.  ``_gathered``
    is a test seam: a pre-gathered ``(n_ranks, n_components)`` array."""
    labels, values = consistency_fingerprint(
        step=step, config=config, params=params, rng_key=rng_key, code=code)
    if not labels:
        raise ValueError("check_consistency: nothing to check "
                         "(pass step/config/params/rng_key/code)")
    if _gathered is not None:
        gathered = np.asarray(_gathered, np.float64).reshape(-1, len(labels))
    elif dist.is_available() and dist.is_initialized() \
            and dist.get_world_size(group) > 1:
        from ..obs.aggregate import gather_f64_rows

        gathered = gather_f64_rows(values, group)
    else:
        gathered = np.asarray([values], np.float64)

    mismatched = [labels[i] for i in range(len(labels))
                  if not np.all(gathered[:, i] == gathered[0, i])]
    out = {
        "ok": not mismatched,
        "n_hosts": int(gathered.shape[0]),
        "labels": labels,
        "mismatched": mismatched,
        "per_host": gathered.tolist(),
    }
    if mismatched:
        from ..obs.events import default_event_log

        (event_log or default_event_log()).emit(
            "desync_detected",
            step=step,
            mismatched=mismatched,
            per_host={
                lab: [float(gathered[h, labels.index(lab)])
                      for h in range(out["n_hosts"])]
                for lab in mismatched
            },
        )
    return out
