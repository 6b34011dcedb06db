"""Goodput-driven autoscaler — the elastic-fleet control loop, the
PyTorch counterpart of ``torchdistpackage_tpu/serving/autoscale.py``.

The router has the actuator (``set_alive``, with ``replica_up`` /
``replica_down`` events) and the sensors (per-replica SLO attainment,
goodput, queue depth and the TTFT calibration bias); an
:class:`Autoscaler` attaches to a :class:`~.router.Router` and is ticked
from ``Router.step()`` after collection:

- every ``eval_every`` fleet ticks it reads a windowed delta of each
  replica's SLO counters, the live queue depths, and each replica's
  TTFT bias;
- under pressure (window attainment below target, queues past the
  high-water mark, or a blown-out bias) it **scales up**: the first
  parked replica re-enters rotation warm; with ``retier=True`` on a
  disaggregated fleet its role is re-planned from the window's
  prefill:decode token mix;
- in a calm window with idle surplus it **scales down** one idle
  replica above ``min_alive`` through the drain -> resume path (exact
  replay, so a scale-down leaves the token streams unchanged);
- every evaluation, hold included, is one ``scale_decision`` event
  carrying its evidence.

``summary()`` is the RUNREPORT ``router.fleet.autoscale`` subsection:
``static`` (never acted), ``elastic`` (acted within budget) or
``thrashing`` (more actions than ``thrash_at``).  Its windows read the
host clock (attainment of deadlines, the TTFT bias), so a fleet with a
replica over a process group refuses it (``Router.refuse_clock``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

#: Autoscaler verdicts (``summary()['verdict']``).
AUTOSCALE_VERDICTS = ("static", "elastic", "thrashing")


class Autoscaler:
    """Attach with ``Autoscaler(router)`` — the constructor registers
    itself as ``router.autoscaler``; ``Router.step()`` ticks it.

    Parameters
    ----------
    router: the fleet to control.
    attainment_target: window SLO attainment below this is pressure.
    eval_every: fleet ticks between evaluations (the control period).
    cooldown: ticks after a scale action before the next evaluation —
        the anti-thrash guard (a freshly revived replica needs a window
        to absorb load before the controller judges again).
    min_alive: never scale below this many live replicas.
    queue_high: mean queued-per-live-submit-target above this is
        pressure even while attainment holds (backlog leads latency).
    bias_alarm: pressure when any live replica's TTFT calibration bias
        exceeds ``1 + bias_alarm`` (admission systematically optimistic).
    thrash_at: more than this many scale actions → verdict "thrashing".
    retier: re-plan a revived replica's prefill/decode role from the
        observed prefill:decode token mix (disaggregated fleets only).
    """

    def __init__(self, router: Any, *, attainment_target: float = 0.9,
                 eval_every: int = 16, cooldown: int = 48,
                 min_alive: int = 1, queue_high: float = 8.0,
                 bias_alarm: float = 0.5, thrash_at: int = 12,
                 retier: bool = False) -> None:
        self.router = router
        self.attainment_target = float(attainment_target)
        self.eval_every = max(1, int(eval_every))
        self.cooldown = int(cooldown)
        self.min_alive = max(1, int(min_alive))
        self.queue_high = float(queue_high)
        self.bias_alarm = float(bias_alarm)
        self.thrash_at = int(thrash_at)
        self.retier = bool(retier)
        router.refuse_clock("an attached Autoscaler")
        self._tick = 0
        self._cooldown_until = 0
        self._snap = [self._read(r) for r in router.replicas]
        self.stats = {"evals": 0, "scale_ups": 0, "scale_downs": 0,
                      "holds": 0, "retiers": 0}
        self.last_decision: Optional[Dict[str, Any]] = None
        router.autoscaler = self

    # ------------------------------------------------------------- sensors

    @staticmethod
    def _read(eng: Any) -> Dict[str, int]:
        """Monotonic counters the window deltas are taken over."""
        met = demand = goodput = 0
        for row in eng._slo_by_prio.values():
            met += row["met"]
            demand += (row["completed"] + row["shed"] + row["expired"])
        return {"met": met, "demand": demand, "goodput": goodput
                + sum(r["goodput_tokens"]
                      for r in eng._slo_by_prio.values()),
                "prefill_chunks": eng.stats["prefill_chunks"],
                "generated_tokens": eng.stats["generated_tokens"]}

    def _window(self) -> Dict[str, Any]:
        """One evaluation window: per-replica deltas since the last
        evaluation plus the live (instantaneous) queue/bias state —
        the evidence every ``scale_decision`` carries."""
        r = self.router
        met = demand = goodput = prefill_tok = decode_tok = 0
        queued = 0
        worst_bias = None
        per_replica: List[Dict[str, Any]] = []
        for i, eng in enumerate(r.replicas):
            now = self._read(eng)
            prev = self._snap[i]
            d_met = now["met"] - prev["met"]
            d_dem = now["demand"] - prev["demand"]
            d_good = now["goodput"] - prev["goodput"]
            d_pref = now["prefill_chunks"] - prev["prefill_chunks"]
            d_gen = now["generated_tokens"] - prev["generated_tokens"]
            self._snap[i] = now
            met += d_met
            demand += d_dem
            goodput += d_good
            prefill_tok += d_pref * eng.chunk
            decode_tok += d_gen
            bias = eng._ttft_bias
            if r.alive[i]:
                queued += len(eng.queue)
                if bias is not None and (
                        worst_bias is None or bias > worst_bias):
                    worst_bias = bias
            per_replica.append({
                "replica": i, "alive": r.alive[i], "met": d_met,
                "demand": d_dem, "goodput_tokens": d_good,
                "queued": len(eng.queue), "busy": eng.n_busy,
                "ttft_bias": round(bias, 4) if bias is not None else None,
            })
        return {
            "attainment": round(met / demand, 4) if demand else None,
            "window_demand": demand,
            "goodput_tokens": goodput,
            "queued": queued,
            "worst_ttft_bias": (round(worst_bias, 4)
                                if worst_bias is not None else None),
            "prefill_tokens": prefill_tok,
            "decode_tokens": decode_tok,
            "n_alive": sum(r.alive),
            "per_replica": per_replica,
        }

    # ------------------------------------------------------------ actuators

    def _revivable(self) -> List[int]:
        return [i for i, a in enumerate(self.router.alive) if not a]

    def _parkable(self, win: Dict[str, Any]) -> List[int]:
        """Live replicas safe to park: idle (no queue, no busy slots),
        above the ``min_alive`` floor, and not the last of a capability
        the fleet needs (submit targets for admission; import targets
        while a prefill tier exists)."""
        r = self.router
        if sum(r.alive) <= self.min_alive:
            return []
        out = []
        for i, eng in enumerate(r.replicas):
            if not r.alive[i] or eng.queue or eng.n_busy:
                continue
            submit = [j for j in r._submit_targets() if j != i]
            imports = [j for j, role in enumerate(r.roles)
                       if r.alive[j] and j != i
                       and role in ("both", "decode")]
            if not submit:
                continue
            if "prefill" in r.roles and not imports:
                continue
            out.append(i)
        # park the one that served the least this window first
        served = {p["replica"]: p["goodput_tokens"] + p["met"]
                  for p in win["per_replica"]}
        out.sort(key=lambda i: (served.get(i, 0), i))
        return out

    def _plan_role(self, i: int, win: Dict[str, Any]) -> Optional[str]:
        """Re-plan revived replica ``i``'s tier from the observed
        prefill:decode token mix.  Only meaningful on a disaggregated
        fleet; returns the new role or None to keep the current one."""
        r = self.router
        roles = [r.roles[j] for j in range(len(r.replicas))
                 if r.alive[j] or j == i]
        if not self.retier or "prefill" not in roles or (
                "decode" not in roles and "both" not in roles):
            return None
        total = win["prefill_tokens"] + win["decode_tokens"]
        if total <= 0:
            return None
        want_decode = win["decode_tokens"] / total
        n = len(roles)
        have_decode = sum(1 for x in roles if x in ("decode", "both")) / n
        new_role = "decode" if have_decode < want_decode else "prefill"
        if new_role == r.roles[i]:
            return None
        # never retier away the last member of either capability
        others = [r.roles[j] for j in range(len(r.replicas))
                  if r.alive[j] and j != i]
        if new_role == "decode" and not any(
                x in ("both", "prefill") for x in others):
            return None
        if new_role == "prefill" and not any(
                x in ("both", "decode") for x in others):
            return None
        return new_role

    def _scale_up(self, i: int, win: Dict[str, Any],
                  reasons: List[str]) -> Dict[str, Any]:
        r = self.router
        new_role = self._plan_role(i, win)
        if new_role is not None:
            old = r.roles[i]
            r.roles[i] = new_role
            r.replicas[i].hold_decode = new_role == "prefill"
            self.stats["retiers"] += 1
            reasons = reasons + [f"retier:{old}->{new_role}"]
        # a replica parked by a scale-down still holds its drain latch;
        # lift it so admission works again (prefix cache intact: warm)
        r.replicas[i]._draining = False
        r.set_alive(i, True, reason="scale_up")
        self.stats["scale_ups"] += 1
        return {"action": "scale_up", "replica": i,
                "role": r.roles[i], "reasons": reasons}

    def _scale_down(self, i: int, reasons: List[str]) -> Dict[str, Any]:
        r = self.router
        payload = r.replicas[i].drain()
        r.set_alive(i, False, reason="scale_down")
        moved = r._resume_descs(payload["requests"], i, "scale_down")
        self.stats["scale_downs"] += 1
        return {"action": "scale_down", "replica": i,
                "rehomed": moved, "reasons": reasons}

    # ----------------------------------------------------------------- loop

    def tick(self) -> Optional[Dict[str, Any]]:
        """One control tick (called from ``Router.step()``).  Returns the
        decision record on evaluation ticks, None between them."""
        self._tick += 1
        if self._tick % self.eval_every or self._tick < self._cooldown_until:
            return None
        win = self._window()
        self.stats["evals"] += 1
        reasons: List[str] = []
        att = win["attainment"]
        if att is not None and att < self.attainment_target:
            reasons.append(
                f"attainment {att} < target {self.attainment_target}")
        n_submit = max(1, len(self.router._submit_targets()))
        if win["queued"] / n_submit > self.queue_high:
            reasons.append(
                f"queue backlog {win['queued']} over {n_submit} "
                f"targets > {self.queue_high}/replica")
        bias = win["worst_ttft_bias"]
        if bias is not None and bias > 1.0 + self.bias_alarm:
            reasons.append(
                f"ttft bias {bias} > {1.0 + self.bias_alarm} "
                f"(admission optimistic)")
        decision: Dict[str, Any]
        if reasons:
            spare = self._revivable()
            if spare:
                decision = self._scale_up(spare[0], win, reasons)
                self._cooldown_until = self._tick + self.cooldown
            else:
                decision = {"action": "hold", "replica": None,
                            "reasons": reasons + ["no spare replica"]}
                self.stats["holds"] += 1
        else:
            idle_ok = (win["window_demand"] == 0 or (
                att is not None and att >= self.attainment_target))
            parkable = self._parkable(win) if (
                idle_ok and win["queued"] == 0) else []
            if parkable:
                decision = self._scale_down(
                    parkable[0], ["calm window, idle surplus"])
                self._cooldown_until = self._tick + self.cooldown
            else:
                decision = {"action": "hold", "replica": None,
                            "reasons": ["within target"]}
                self.stats["holds"] += 1
        decision["tick"] = self._tick
        decision["evidence"] = {k: v for k, v in win.items()
                                if k != "per_replica"}
        decision["per_replica"] = win["per_replica"]
        self.last_decision = decision
        self.router._ev.emit("scale_decision", **decision)
        return decision

    # -------------------------------------------------------------- summary

    @property
    def actions(self) -> int:
        return self.stats["scale_ups"] + self.stats["scale_downs"]

    def summary(self) -> Dict[str, Any]:
        """The RUNREPORT ``router.fleet.autoscale`` subsection —
        validated by ``obs.report._validate_router`` (verdict vs action
        counts, both directions)."""
        if self.actions == 0:
            verdict = "static"
            basis = f"0 scale actions over {self.stats['evals']} evals"
        elif self.actions > self.thrash_at:
            verdict = "thrashing"
            basis = (f"{self.actions} scale actions > thrash_at "
                     f"{self.thrash_at}")
        else:
            verdict = "elastic"
            basis = (f"{self.stats['scale_ups']} up / "
                     f"{self.stats['scale_downs']} down over "
                     f"{self.stats['evals']} evals")
        return {
            "verdict": verdict,
            "basis": basis,
            "actions": self.actions,
            "evals": self.stats["evals"],
            "scale_ups": self.stats["scale_ups"],
            "scale_downs": self.stats["scale_downs"],
            "retiers": self.stats["retiers"],
            "holds": self.stats["holds"],
            "target_attainment": self.attainment_target,
            "thrash_at": self.thrash_at,
            "eval_every": self.eval_every,
            "cooldown": self.cooldown,
            "min_alive": self.min_alive,
            "n_alive": sum(self.router.alive),
            "last": self.last_decision,
        }
