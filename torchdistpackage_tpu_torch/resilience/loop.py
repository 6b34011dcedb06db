"""Self-healing training loop — the port's
``torchdistpackage_tpu/resilience/loop.py``: divergence detection,
rollback, a retry budget.

1. **detect** — :class:`DivergenceMonitor` checks every step's loss and
   grad norm: a non-finite value trips at once, a finite loss more than
   ``zmax`` rolling standard deviations above the window's mean trips as
   a spike.
2. **rewind** — the newest GOOD checkpoint is restored
   (``utils.checkpoint.auto_resume``: verify, quarantine, walk back).
3. **advance** — the data stream shifts past the poisoned window
   (``make_batch(step + data_offset)``); the offset is in the checkpoint
   payload, so a preemption mid-recovery resumes right.
4. **budget** — each rollback spends one of ``max_rollbacks``; when none
   is left the loop aborts cleanly (``resilience_abort``, verdict
   ``"aborted"``, checkpoints intact).

The port trains in place: the step updates the parameter tensors and
the optimizer it is handed, so a poisoned step's update has already
happened when the loop sees its loss (the reference's functional step
just drops its outputs).  The loop therefore restores INTO the live
tensors — from a checkpoint, or from a host copy of the initial state
taken when :meth:`ResilientLoop.run` starts (the rollback of last
resort) — and after an abort it rebuilds the last healthy state the same
way plus a replay of the healthy steps after that checkpoint, each at
the data offset it ran at (:attr:`ResilientLoop.step_offsets`), so
``LoopResult.params`` / ``opt_state`` are what the reference returns.
A replay that needs a step this run did not record (older than the
resumed checkpoint) raises instead of returning a state the run never
had.

With no fault fired the loop's trajectory is bit-identical to a plain
hand loop over the same ``step_fn`` and ``make_batch``: it reads the
loss and touches nothing else.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import signal as _signal
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ..utils.checkpoint import (
    CheckpointManager,
    auto_resume,
    restore_into,
    to_host,
)
from ..utils.preemption import GracefulShutdown

PyTree = Any


class DivergenceMonitor:
    """Loss-stream health check (JAX :50): non-finite trip plus a rolling
    z-score spike.

    - ``check(loss, grad_norm=None)`` -> ``"ok"`` | ``"nonfinite"`` |
      ``"spike"``; spikes need ``min_history`` healthy observations.
    - ``observe(loss)`` — commit a healthy value to the window.
    - ``reset()`` — clear the window (after a rollback).
    """

    def __init__(self, window: int = 32, zmax: float = 6.0,
                 min_history: int = 8, max_loss: Optional[float] = None):
        self.window = int(window)
        self.zmax = float(zmax)
        self.min_history = int(min_history)
        self.max_loss = max_loss
        self._hist: collections.deque = collections.deque(maxlen=self.window)

    def check(self, loss: float, grad_norm: Optional[float] = None) -> str:
        vals = [float(loss)] + ([float(grad_norm)]
                                if grad_norm is not None else [])
        if not all(math.isfinite(v) for v in vals):
            return "nonfinite"
        if self.max_loss is not None and float(loss) > self.max_loss:
            return "spike"
        if len(self._hist) >= self.min_history:
            arr = np.asarray(self._hist, np.float64)
            std = float(arr.std())
            if std > 0 and (float(loss) - float(arr.mean())) / std > self.zmax:
                return "spike"
        return "ok"

    def observe(self, loss: float) -> None:
        self._hist.append(float(loss))

    def reset(self) -> None:
        self._hist.clear()


@dataclasses.dataclass
class LoopResult:
    params: PyTree
    opt_state: PyTree
    losses: Dict[int, float]
    summary: Dict[str, Any]
    aborted: bool = False
    preempted: bool = False

    @property
    def verdict(self) -> str:
        return self.summary.get("verdict", "unknown")


def _scalars(out: Tuple) -> Tuple[float, Optional[float], Optional[dict]]:
    """``(loss, grad norm, numerics dict)`` of a step's outputs past the
    state: the port's steps return ``(params, opt_state, loss,
    gnorm_or_stats)``; a ``loss`` dict with ``"loss"`` / ``"grad_norm"``
    (the reference's form) is read too."""
    loss, aux = out[2], (out[3] if len(out) > 3 else None)
    numerics = aux if isinstance(aux, dict) else None
    grad_norm = aux.get("grad_norm") if numerics is not None else aux
    if isinstance(loss, dict):
        grad_norm = loss.get("grad_norm", grad_norm)
        loss = loss["loss"]
    return (float(loss), None if grad_norm is None else float(grad_norm),
            numerics)


class ResilientLoop:
    """The resilience pieces in one training loop (JAX :104)::

        loop = ResilientLoop(step_fn, make_batch, mgr, total_steps=1000,
                             save_every=50, max_rollbacks=2,
                             telemetry=tel, watchdog=dog, chaos=chaos)
        result = loop.run(params, opt_state)

    - ``step_fn(params, opt_state, batch) -> (params, opt_state, loss,
      gnorm)`` — what ``make_train_step`` returns (``numerics=True``: the
      fourth value is the stats dict, its ``grad_norm`` goes to the
      monitor and the dict to ``Telemetry.end_step``).  A three-value
      step with a loss dict (the reference's form) works too.
    - ``make_batch(index)`` — the batch for stream index ``step +
      data_offset``.
    - ``mgr`` — a :class:`~..utils.checkpoint.CheckpointManager` (a
      :class:`~.ckpt_guard.GuardedCheckpointManager` for verified
      restores): the loop auto-resumes from it on entry, saves after
      every ``save_every`` steps that passed the monitor, and forces the
      save of the last step and of a step in the preemption grace window.
    - ``chaos`` (``before_step`` / ``perturb_loss``), ``watchdog``
      (``start`` / ``beat`` / ``stop``), ``consistency_every`` (a
      ``check_consistency`` every N steps and at the start),
      ``telemetry`` (``wrap_step``, ``end_step`` of each kept step,
      ``record_resilience``).
    """

    def __init__(
        self,
        step_fn: Callable[[PyTree, PyTree, Any], Tuple],
        make_batch: Callable[[int], Any],
        mgr: CheckpointManager,
        total_steps: int,
        save_every: int = 1,
        monitor: Optional[DivergenceMonitor] = None,
        max_rollbacks: int = 2,
        chaos: Optional[Any] = None,
        telemetry: Optional[Any] = None,
        watchdog: Optional[Any] = None,
        consistency_every: int = 0,
        consistency_config: Any = None,
        shutdown_signals: Sequence = (_signal.SIGTERM, _signal.SIGINT),
    ) -> None:
        self.step_fn = step_fn
        self.make_batch = make_batch
        self.mgr = mgr
        self.total_steps = int(total_steps)
        self.save_every = int(save_every)
        self.monitor = monitor or DivergenceMonitor()
        self.max_rollbacks = int(max_rollbacks)
        self.chaos = chaos
        if chaos is not None and getattr(chaos, "ckpt_dir", None) is None:
            chaos.ckpt_dir = mgr.directory
        self.telemetry = telemetry
        self.watchdog = watchdog
        self.consistency_every = int(consistency_every)
        self.consistency_config = consistency_config
        self.shutdown_signals = shutdown_signals
        #: the data offset each kept step of :meth:`run`'s current
        #: lineage ran at (a rollback drops the steps after its target):
        #: what the abort's replay feeds each step
        self.step_offsets: Dict[int, int] = {}

    @staticmethod
    def _payload(params, opt_state, data_offset: int) -> Dict[str, Any]:
        return {"params": params, "opt": opt_state,
                "loop": {"data_offset": int(data_offset)}}

    # ----------------------------------------------------------------- run

    def run(self, params: PyTree, opt_state: PyTree) -> LoopResult:
        from ..obs.events import emit_event

        step_fn = self.step_fn
        if self.telemetry is not None:
            step_fn = self.telemetry.wrap_step(self.step_fn)

        # the rollback of last resort, before the first checkpoint: the
        # step trains in place, so keep a host copy of the initial state
        initial = to_host(self._payload(params, opt_state, 0))
        start, restored = auto_resume(
            self.mgr, self._payload(params, opt_state, 0))
        data_offset = int(restored["loop"]["data_offset"])

        if self.consistency_every:
            from .watchdog import check_consistency

            check_consistency(step=start, params=params,
                              config=self.consistency_config)

        losses: Dict[int, float] = {}
        self.step_offsets = {}
        rollbacks = 0
        faults_seen = 0
        aborted = preempted = False
        last_good_ckpt: Optional[int] = self.mgr.latest_step()
        if self.watchdog is not None:
            self.watchdog.start()

        step = start
        with GracefulShutdown(self.shutdown_signals) as stop:
            while step < self.total_steps:
                if self.watchdog is not None:
                    self.watchdog.beat(step)
                if self.chaos is not None:
                    self.chaos.before_step(step)
                batch = self.make_batch(step + data_offset)
                out = step_fn(params, opt_state, batch)
                loss_f, grad_norm, numerics = _scalars(out)
                if self.chaos is not None:
                    loss_f = float(self.chaos.perturb_loss(step, loss_f))
                    faults_seen = self.chaos.fired_count

                verdict = self.monitor.check(loss_f, grad_norm)
                if verdict != "ok":
                    # the alert lands on the timeline before the recovery
                    # decision: cause, then action
                    emit_event(
                        "numerics_alert", step=step,
                        reason=("nonfinite_loss" if verdict == "nonfinite"
                                else "loss_spike"),
                        value=loss_f, source="divergence_monitor")
                    if rollbacks >= self.max_rollbacks:
                        emit_event(
                            "resilience_abort", step=step, reason=verdict,
                            loss=loss_f, rollbacks_used=rollbacks,
                            max_rollbacks=self.max_rollbacks)
                        aborted = True
                        params, opt_state = self._last_healthy(
                            params, opt_state, step, data_offset, initial)
                        break
                    step, data_offset = self._rollback(
                        params, opt_state, step, verdict, loss_f,
                        data_offset, initial, rollbacks)
                    rollbacks += 1
                    losses = {s: v for s, v in losses.items() if s < step}
                    self.step_offsets = {s: o for s, o in
                                         self.step_offsets.items()
                                         if s < step}
                    self.monitor.reset()
                    continue

                params, opt_state = out[0], out[1]
                self.monitor.observe(loss_f)
                losses[step] = loss_f
                self.step_offsets[step] = data_offset
                if self.telemetry is not None:
                    self.telemetry.end_step(step=step, loss=loss_f,
                                            numerics=numerics)

                if (self.consistency_every
                        and (step + 1) % self.consistency_every == 0):
                    from .watchdog import check_consistency

                    check_consistency(step=step, params=params,
                                      config=self.consistency_config)

                last = step == self.total_steps - 1
                if stop.requested or last or (step + 1) % self.save_every == 0:
                    # the grace-window and final saves must not be declined
                    # by the manager's save interval
                    must_save = bool(stop.requested or last)
                    saved = self.mgr.save(
                        step, self._payload(params, opt_state, data_offset),
                        wait=bool(stop.requested), force=must_save)
                    if saved:
                        last_good_ckpt = step
                    elif must_save:
                        emit_event("checkpoint_save_skipped", step=step,
                                   forced=True,
                                   last_checkpoint=last_good_ckpt)
                if stop.requested:
                    preempted = True
                    break
                step += 1
            self.mgr.wait_until_finished()
        if self.watchdog is not None:
            self.watchdog.stop()

        if aborted:
            verdict_str = "aborted"
        elif preempted:
            verdict_str = "preempted"
        elif rollbacks:
            verdict_str = "recovered"
        else:
            verdict_str = "clean"
        summary = {
            "verdict": verdict_str,
            "rollbacks": rollbacks,
            "max_rollbacks": self.max_rollbacks,
            "faults_injected": faults_seen,
            "last_step": max(losses) if losses else None,
            "data_offset": data_offset,
            "last_checkpoint": last_good_ckpt,
            "hang_suspected": (
                self.watchdog.n_suspected if self.watchdog is not None
                else 0),
        }
        if self.telemetry is not None:
            self.telemetry.record_resilience(summary)
        return LoopResult(params=params, opt_state=opt_state, losses=losses,
                          summary=summary, aborted=aborted,
                          preempted=preempted)

    # ------------------------------------------------------------ rollback

    def _restore_good(self, params, opt_state, data_offset: int,
                      initial: PyTree) -> int:
        """The newest good checkpoint written into the live state (or the
        initial host copy when none is left); returns its step (-1: the
        initial state)."""
        template = self._payload(params, opt_state, data_offset)
        resume_step, _ = auto_resume(self.mgr, template)
        if resume_step == 0:
            restore_into(template, initial)
        return resume_step - 1

    def _rollback(self, params, opt_state, step: int, reason: str,
                  loss_f: float, data_offset: int, initial: PyTree,
                  rollbacks_used: int) -> Tuple[int, int]:
        """Restore the newest good state, shift the data stream past the
        poisoned window, emit ``rollback``; returns ``(next_step,
        new_data_offset)``."""
        from ..obs.events import emit_event

        self.mgr.wait_until_finished()
        good = self._restore_good(params, opt_state, data_offset, initial)
        # every batch index consumed in (good, step] is poisoned-adjacent
        delta = step - good
        new_offset = data_offset + delta
        emit_event("rollback", from_step=step, to_step=good, reason=reason,
                   loss=loss_f, data_offset=new_offset, skipped=delta,
                   rollbacks_used=rollbacks_used + 1)
        return good + 1, new_offset

    def _last_healthy(self, params, opt_state, step: int, data_offset: int,
                      initial: PyTree) -> Tuple[PyTree, PyTree]:
        """After an abort at ``step``: the state after step ``step - 1``
        (the reference's result), rebuilt in place — the newest good
        checkpoint, then the steps after it replayed, each on the batch
        of the offset it ran at (:attr:`step_offsets`; a walk-back past
        the last rollback's target reaches steps that ran at an older
        offset).  Raises if a step to replay ran before :meth:`run`
        began (a resumed run whose checkpoints were lost): its offset
        was never recorded."""
        self.mgr.wait_until_finished()
        good = self._restore_good(params, opt_state, data_offset, initial)
        missing = [s for s in range(good + 1, step)
                   if s not in self.step_offsets]
        if missing:
            raise RuntimeError(
                f"abort at step {step}: the newest good state is step "
                f"{good}, and steps {missing[0]}..{missing[-1]} ran before "
                f"this run recorded their data offsets; the last healthy "
                f"state cannot be rebuilt")
        for s in range(good + 1, step):
            params, opt_state = self.step_fn(
                params, opt_state,
                self.make_batch(s + self.step_offsets[s]))[:2]
        return params, opt_state
