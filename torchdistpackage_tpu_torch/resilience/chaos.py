"""Deterministic fault injection — the PyTorch counterpart of
``torchdistpackage_tpu/resilience/chaos.py``, the harness the serving
engine's heal paths and the fleet's migration wire are proven with.

Faults are declared up front (a list of :class:`Fault` records) and
seed-driven: every random choice (a checkpoint's bit-flip offset, the
bogus block of a ``table_corrupt``) comes from ``random.Random(seed)``,
the reference's generator, so a plan fires the same faults at the same
places in both packages.  Every injection lands on the timeline as a
``fault_injected`` event.

Fault kinds (``Fault.kind``), as in the reference:

- training: ``ckpt_corrupt`` (truncate or bit-flip a committed
  checkpoint's largest file), ``sigterm``, ``nan_spike`` (poison a
  fetched loss or a dict of grads), ``stall``, ``host_dropout``;
- the engine (:data:`ENGINE_FAULT_KINDS`; ``Fault.step`` is the engine
  tick, ``Fault.slot`` the victim slot or data group):
  ``slot_stall`` (a sleep inside a tick, which an engine's
  ``watchdog=`` escalates to ``hang_suspected``), ``alloc_exhaust`` (an ownerless grab of every free
  block: a leak the audit reclaims), ``table_corrupt`` (a live slot's
  table entry pointed at a block it does not own: the audit requeues
  the slot) and ``nan_logits`` (one slot's fetched token replaced by an
  out-of-range sentinel: the validity check replays the slot);
- the migration wire (:data:`TRANSPORT_FAULT_KINDS`; ``Fault.step`` is
  the k-th send of :class:`~..serving.transport.ChunkedWireTransport`,
  ``Fault.slot`` the victim chunk): ``chunk_drop``, ``chunk_corrupt``,
  ``transport_stall`` (past the transport's timeout) and
  ``replica_death_midmigration``.  A fault fires once unless
  ``repeat=True``.

A :class:`ChaosMonkey` with no faults (or ``enabled=False``) is inert.
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal
import time
from typing import Any, Dict, List, Optional, Sequence

#: Faults the serving engine injects and heals (``Fault.step`` = tick).
ENGINE_FAULT_KINDS = (
    "slot_stall", "alloc_exhaust", "table_corrupt", "nan_logits")

#: Faults the KV-migration wire injects (``Fault.step`` = the send's
#: sequence number, ``Fault.slot`` = the victim chunk of that send).
TRANSPORT_FAULT_KINDS = (
    "chunk_drop", "chunk_corrupt", "transport_stall",
    "replica_death_midmigration")

FAULT_KINDS = (
    "ckpt_corrupt", "sigterm", "nan_spike", "stall", "host_dropout",
) + ENGINE_FAULT_KINDS + TRANSPORT_FAULT_KINDS


@dataclasses.dataclass
class Fault:
    """One declared fault, fired at ``step`` (see the module docstring
    for what a step counts); once, unless ``repeat=True``."""

    kind: str
    step: int
    mode: str = "truncate"            # ckpt_corrupt: "truncate" | "bitflip"
    value: float = float("nan")       # nan_spike: injected value
    duration_s: float = 0.0           # stall / slot_stall / transport_stall
    process: Optional[int] = None     # restrict to one process (None = all)
    target_step: Optional[int] = None  # ckpt_corrupt: ckpt step (None = latest)
    exit_code: int = 42               # host_dropout
    slot: Optional[int] = None        # engine: victim slot / group; wire: chunk
    repeat: bool = False
    fired: int = dataclasses.field(default=0, compare=False)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")


def _data_files(step_dir: str) -> List[str]:
    """Every regular file of a checkpoint step, largest first."""
    out = []
    for root, _dirs, files in os.walk(step_dir):
        for f in files:
            out.append(os.path.join(root, f))
    out.sort(key=lambda p: (-os.path.getsize(p), p))
    return out


def corrupt_checkpoint(directory: str, step: Optional[int] = None,
                       mode: str = "truncate",
                       rng: Optional[random.Random] = None) -> str:
    """Corrupt a committed checkpoint under ``directory`` (numbered step
    directories): truncate the largest file of ``step`` (None: the
    newest) to half, or flip one byte at a seed-chosen offset.  Returns
    the corrupted file's path (JAX :133)."""
    rng = rng or random.Random(0)
    steps = sorted(
        int(d) for d in os.listdir(directory)
        if d.isdigit() and os.path.isdir(os.path.join(directory, d)))
    if not steps:
        raise FileNotFoundError(f"no checkpoint steps under {directory}")
    step = steps[-1] if step is None else int(step)
    files = _data_files(os.path.join(directory, str(step)))
    if not files:
        raise FileNotFoundError(f"checkpoint step {step} has no files")
    victim = files[0]
    size = os.path.getsize(victim)
    if mode == "truncate":
        with open(victim, "r+b") as f:
            f.truncate(max(0, size // 2))
    elif mode == "bitflip":
        pos = rng.randrange(max(1, size))
        with open(victim, "r+b") as f:
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([(b[0] if b else 0) ^ 0xFF]))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    from ..obs.events import emit_event

    emit_event("fault_injected", fault="ckpt_corrupt", target_step=step,
               mode=mode, file=os.path.relpath(victim, directory))
    return victim


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


class ChaosMonkey:
    """Drives a declared fault plan.  A training loop calls
    :meth:`before_step` at the top of each step and passes its fetched
    loss through :meth:`perturb_loss` (its grads through
    :meth:`perturb_grads`); the serving engine calls
    :meth:`before_engine_tick` and :meth:`perturb_engine_tokens`
    (``ServingEngine(chaos=)``); the chunked migration wire calls
    :meth:`transport_faults_due` and :meth:`fire`.  ``ckpt_dir`` names
    the checkpoint root of ``ckpt_corrupt`` faults."""

    def __init__(self, faults: Sequence[Fault] = (), seed: int = 0,
                 ckpt_dir: Optional[str] = None,
                 enabled: bool = True) -> None:
        self.faults = [dataclasses.replace(f) for f in faults]
        self.rng = random.Random(seed)
        self.ckpt_dir = ckpt_dir
        self.enabled = enabled

    # ------------------------------------------------------------- plumbing

    @property
    def fired_count(self) -> int:
        return sum(f.fired for f in self.faults)

    def _due(self, step: int, kinds: Sequence[str]) -> List[Fault]:
        if not self.enabled:
            return []
        proc = _process_index()
        return [f for f in self.faults
                if f.kind in kinds and f.step == step
                and not (f.fired and not f.repeat)
                and (f.process is None or f.process == proc)]

    def _emit(self, fault: Fault, **extra: Any) -> None:
        fault.fired += 1
        from ..obs.events import emit_event

        emit_event("fault_injected", fault=fault.kind, step=fault.step,
                   **extra)

    # ------------------------------------------------------------ injectors

    def before_step(self, step: int) -> None:
        """Fire the pre-step faults due at ``step``, in the reference's
        order: stall, checkpoint corruption, SIGTERM, host dropout."""
        for f in self._due(step, ("stall",)):
            self._emit(f, duration_s=f.duration_s)
            time.sleep(f.duration_s)
        for f in self._due(step, ("ckpt_corrupt",)):
            if self.ckpt_dir is None:
                raise RuntimeError(
                    "ckpt_corrupt fault needs ChaosMonkey(ckpt_dir=...)")
            f.fired += 1  # corrupt_checkpoint emits the event itself
            corrupt_checkpoint(self.ckpt_dir, step=f.target_step,
                               mode=f.mode, rng=self.rng)
        for f in self._due(step, ("sigterm",)):
            self._emit(f)
            os.kill(os.getpid(), signal.SIGTERM)
        for f in self._due(step, ("host_dropout",)):
            self._emit(f, exit_code=f.exit_code)
            os._exit(f.exit_code)

    # ------------------------------------------- serving-engine injectors

    def before_engine_tick(self, tick: int, engine: Any) -> None:
        """Fire the engine faults due at ``tick`` (JAX :283): the engine
        calls this at the top of ``step``, before its audit, so every
        injected inconsistency is on the table when the audit runs.
        ``nan_logits`` fires later, through
        :meth:`perturb_engine_tokens`."""
        for f in self._due(tick, ("slot_stall",)):
            self._emit(f, duration_s=f.duration_s)
            time.sleep(f.duration_s)
        for f in self._due(tick, ("alloc_exhaust",)):
            g = f.slot or 0
            alloc = engine._allocs[g % len(engine._allocs)]
            stolen = alloc.alloc(alloc.n_free) or []
            # recorded nowhere the engine can see: live blocks with no
            # owner, what a leak looks like
            self._emit(f, group=g, stolen_blocks=len(stolen))
        for f in self._due(tick, ("table_corrupt",)):
            victims = [i for i, s in enumerate(engine._slots)
                       if s.state != "free"]
            if not victims:
                continue  # nothing live to corrupt this tick; stays armed
            slot = f.slot if f.slot is not None else victims[0]
            # a block the slot does not own: seed-chosen from its group's
            # free list when it has one, else the last pool block
            alloc = engine._allocs[slot // engine.slots_per_group]
            pool = alloc._free or [engine.num_blocks - 1]
            bogus = pool[self.rng.randrange(len(pool))]
            engine._tables[slot, 0] = bogus
            self._emit(f, slot=slot, entry=0, bogus_block=int(bogus))

    # ---------------------------------------- migration-wire injectors

    def transport_faults_due(self, seq: int) -> List[Fault]:
        """The wire faults due on send ``seq``, consulted once a fetch
        attempt: a one-shot fault is consumed by its first firing (the
        re-request then succeeds), a repeating one exhausts the retry
        budget.  The transport applies the fault and reports it through
        :meth:`fire`."""
        return self._due(seq, TRANSPORT_FAULT_KINDS)

    def fire(self, fault: Fault, **extra: Any) -> None:
        """Record a fault an injector applied itself: count it and land
        its ``fault_injected`` event."""
        self._emit(fault, **extra)

    def perturb_engine_tokens(self, tick: int, tokens: Any) -> Any:
        """One slot's host-fetched token replaced by the int32 minimum
        when a ``nan_logits`` fault is due — the stand-in for a NaN
        logit row that the engine's validity check must catch; the
        device state is untouched."""
        due = self._due(tick, ("nan_logits",))
        if not due:
            return tokens
        import numpy as np

        tokens = np.array(tokens, copy=True)
        for f in due:
            slot = f.slot if f.slot is not None else 0
            tokens[slot] = np.iinfo(np.int32).min
            self._emit(f, slot=slot, target="sampled_token")
        return tokens

    def perturb_loss(self, step: int, loss: float) -> float:
        """The fetched loss replaced by the fault's value when a
        ``nan_spike`` is due."""
        for f in self._due(step, ("nan_spike",)):
            self._emit(f, value=repr(f.value), target="loss")
            loss = f.value
        return loss

    def perturb_grads(self, step: int, grads: Dict[str, Any]
                      ) -> Dict[str, Any]:
        """Every floating tensor of a (nested) dict of grads filled with
        the fault's value when a ``nan_spike`` is due (new tensors; the
        given ones are untouched)."""
        due = self._due(step, ("nan_spike",))
        if not due:
            return grads
        import torch

        def fill(g, value):
            if isinstance(g, dict):
                return {k: fill(v, value) for k, v in g.items()}
            if isinstance(g, torch.Tensor) and g.is_floating_point():
                return torch.full_like(g, value)
            return g

        for f in due:
            self._emit(f, value=repr(f.value), target="grads")
            grads = fill(grads, f.value)
        return grads
