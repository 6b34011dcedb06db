"""Multi-replica serving router — the PyTorch counterpart of
``torchdistpackage_tpu/serving/router.py``: prefix-affinity routing,
prefill/decode disaggregation and cross-replica KV migration over N
:class:`~.engine.ServingEngine` replicas.

- **Prefix-affinity routing.**  Every submit ranks the live submit
  targets by the longest resident prefix of the prompt
  (:meth:`ServingEngine.prefix_lookup`), then the replica's own biased
  :meth:`~.engine.ServingEngine.estimate_ttft`, then its load; a replica
  that sheds the submit falls through to the next, and only when every
  candidate refused is the request a router-level rejection.
- **Rebalancing (KV-free).**  A replica whose refused demand grows, or
  whose queue runs ``rebalance_watermark`` deeper than the shallowest
  peer's, gives up queued requests through
  :meth:`~.engine.ServingEngine.steal_queued` ->
  :meth:`~.engine.ServingEngine.resume` on the target: the drain
  descriptor replays exactly.
- **Prefill/decode disaggregation.**  ``'prefill'`` replicas admit and
  prefill (``hold_decode``: their slots park at the first token), then
  the router hands each request to a ``'decode'`` replica:
  :meth:`~.engine.ServingEngine.export_slot` (descriptor and
  :class:`~.paged_cache.PoolSnapshot`) ->
  :meth:`~.engine.ServingEngine.import_slot` (admitted into DECODE, its
  resident prefix shared) -> :func:`~.paged_cache.migrate_blocks` of the
  unshared tail, carried by the transport.  A prompt of
  ``long_ctx_threshold`` tokens or more also emits ``kv_handoff_long``
  (the CP prefill tier's handoff: a ``cp_group`` engine's export
  gathers its ranks' slices).
- **Migration pricing.**  With a ``comm_model`` and per-replica
  ``zones``, a zone-crossing leg is priced through
  ``CommModel.predict_compressed`` and ships the int8 wire format when
  the model approves.
- **Replica failure.**  ``evacuate_on_fault=True`` drains a replica whose
  ``faults_detected`` moves, takes it out of rotation, and resumes its
  requests on the survivors; a transfer the wire declares dead falls
  back to re-prefill (``migration_fallback``).
- **Decision ledger.**  Every decision is one registered event carrying
  its inputs (``route_decision``, ``handoff_decision``,
  ``rebalance_decision``, ``replica_up`` / ``replica_down``); each
  replica's engine events carry its index (``tag_events``).
- **Audit across allocators.**  :meth:`Router.audit` runs every
  replica's block audit plus the cross-replica invariant: a request is
  live on at most one ownership site, an in-flight transfer counting as
  one.

Where the port differs from the reference: ``migrate_blocks`` is a
direct copy from the export's snapshot (there is no compiled program to
keep at one signature, so the lanes are not padded), whose (replica
pair, wire format) keys ``summary()['fleet']['migrations']
['signatures']`` counts as the reference counts its programs; and a
replica over a process group (``cp_group``, ``dp_group``, ``tp_group``,
``ep_group``) is refused in a placement that reads the host clock (see
:class:`Router`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..obs.events import EventLog, default_event_log, tag_events
from .engine import DRAIN_SCHEMA, Request, ServingEngine
from .paged_cache import migrate_blocks, migration_wire_bytes
from .sim import host_migrate_blocks
from .transport import (
    LoopbackTransport,
    MigrationTransport,
    ReplicaDiedError,
    TransportDeadError,
)

#: Fleet balance verdicts (``summary()['fleet']['balance']`` — the
#: FLEETREPORT half of the fleet verdict): ``balanced`` = work spread
#: within :data:`IMBALANCE_SKEWED_AT` of even, ``skewed`` = one replica
#: carries disproportionate load while the fleet still serves, and
#: ``degraded`` = the fleet itself is unhealthy (replica down or a
#: replica verdict worse than healthy) — balance is moot until it heals.
FLEET_BALANCE_VERDICTS = ("balanced", "skewed", "degraded")

#: Load-imbalance index (max over mean of per-alive-replica served
#: tokens, >= 1.0) above which the fleet balance verdict is ``skewed``.
IMBALANCE_SKEWED_AT = 1.5

#: Replica roles.  ``'both'`` replicas admit, prefill, and decode (the
#: pure-routing fleet); ``'prefill'`` replicas admit + prefill and hand
#: every request off at its first token; ``'decode'`` replicas only ever
#: receive imports.
ROLES = ("both", "prefill", "decode")

# fleet verdict = the worst replica verdict under this ordering
_VERDICT_RANK = {"healthy": 0, "degraded": 1, "overloaded": 2}

#: why a fleet with a replica over a process group refuses a placement
#: that reads the host clock
_GROUPED = ("a replica over a process group (cp_group, dp_group, "
            "tp_group or ep_group) runs one copy of the Router on each of "
            "its ranks, and every rank must take the same decisions; {what} "
            "reads the host clock (estimate_ttft's tick EWMA, the "
            "autoscaler's windows), which differs from rank to rank, and "
            "ranks that decide differently hang in the next collective")


class Router:
    """Host-side router over N :class:`~.engine.ServingEngine` replicas —
    see the module docstring for the design.  Typical use::

        router = Router([eng_a, eng_b])
        rid = router.submit(Request(prompt_ids, max_new_tokens=64))
        router.run_until_idle()
        out = router.finished[rid]["tokens"]

    Parameters
    ----------
    replicas: the engine replicas.  Migration requires identical
        geometry (block_size / max_blocks / kv_quant / spec_k) — checked.
    roles: per-replica role in :data:`ROLES` (default all ``'both'``).
        Any ``'prefill'`` replica requires at least one import-capable
        (``'decode'`` or ``'both'``) peer.
    zones: per-replica placement label (default all ``'local'``).  A
        migration between different zones is DCN-crossing: priced through
        ``comm_model.predict_compressed`` and shipped int8 when approved.
    comm_model: an ``obs.CommModel`` for migration pricing; None =
        never compress, no pricing recorded.
    dcn_axis: the comm-model axis name the DCN leg is priced on
        (default ``'dcn'`` — calibrate or table that axis).
    rebalance_every: router ticks between queue-depth rebalance scans
        (degradation-triggered rebalances run every tick regardless).
    rebalance_watermark: queue-depth spread (deepest - shallowest) that
        triggers a rebalance.
    evacuate_on_fault: drain-and-redistribute a replica whose
        ``faults_detected`` counter moves (the chaos / dead-replica
        policy).  Off by default: the engines self-heal routine faults.
    transport: a :class:`~.transport.MigrationTransport` carrying the
        handoff KV copies (default :class:`~.transport.LoopbackTransport`
        — the in-process bit-exact wire).  A prestaging transport (the
        chunked wire) pulls and verifies chunk bytes BEFORE the import
        admits anything; a transport declared dead falls back to
        re-prefill on a survivor (``migration_fallback``).
    long_ctx_threshold: prompt length (tokens) at or above which a
        handoff also emits ``kv_handoff_long``.

    A fleet with a replica over a process group refuses, at
    construction, more than one submit target or more than one import
    target (NotImplementedError): ranking them reads the replicas'
    clock-driven TTFT estimates.  An :class:`~.autoscale.Autoscaler` on
    such a fleet is refused for its clock-driven windows.  The one
    prefill, one decode fleet of a CP prefill tier reads no clock.
    """

    def __init__(
        self,
        replicas: Sequence[ServingEngine],
        *,
        roles: Optional[Sequence[str]] = None,
        zones: Optional[Sequence[str]] = None,
        comm_model: Optional[Any] = None,
        dcn_axis: str = "dcn",
        rebalance_every: int = 8,
        rebalance_watermark: int = 4,
        evacuate_on_fault: bool = False,
        transport: Optional[MigrationTransport] = None,
        long_ctx_threshold: int = 8192,
    ) -> None:
        if not replicas:
            raise ValueError("Router needs at least one replica")
        self.replicas: List[ServingEngine] = list(replicas)
        n = len(self.replicas)
        self.roles = list(roles) if roles is not None else ["both"] * n
        if len(self.roles) != n or any(r not in ROLES for r in self.roles):
            raise ValueError(
                f"roles must be {n} of {ROLES}, got {self.roles}")
        if "prefill" in self.roles and not any(
                r in ("both", "decode") for r in self.roles):
            raise ValueError(
                "a 'prefill' replica needs a 'decode'/'both' peer to hand "
                "off to")
        self.zones = list(zones) if zones is not None else ["local"] * n
        if len(self.zones) != n:
            raise ValueError(f"zones must have {n} entries")
        ref = self.replicas[0]
        for i, r in enumerate(self.replicas):
            if (r.block_size, r.max_blocks, r.kv_quant, r.spec_k) != (
                    ref.block_size, ref.max_blocks, ref.kv_quant,
                    ref.spec_k):
                raise ValueError(
                    f"replica {i} geometry (block_size/max_blocks/kv_quant/"
                    f"spec_k) differs from replica 0 — KV migration needs "
                    f"identical pool geometry")
        if self._grouped():
            n_submit = sum(r in ("both", "prefill") for r in self.roles)
            n_import = sum(r in ("both", "decode") for r in self.roles)
            if n_submit > 1 or n_import > 1:
                raise NotImplementedError(_GROUPED.format(
                    what=f"ranking {n_submit} submit targets and "
                         f"{n_import} import targets"))
        self.comm_model = comm_model
        self.dcn_axis = dcn_axis
        self.rebalance_every = int(rebalance_every)
        self.rebalance_watermark = int(rebalance_watermark)
        self.evacuate_on_fault = bool(evacuate_on_fault)
        #: prompt length (tokens) at/above which a prefill->decode handoff
        #: additionally emits ``kv_handoff_long`` — the long-document
        #: marker trace_replay's mixed-traffic scenario and FLEETREPORT
        #: consumers key on (the CP prefill tier's handoff)
        self.long_ctx_threshold = int(long_ctx_threshold)
        self._ev: EventLog = default_event_log()
        self.alive = [True] * n
        for i, role in enumerate(self.roles):
            # the prefill tier never dispatches its decode program: slots
            # that finish prefill PARK (first token sampled, KV complete)
            # until the handoff exports them — engine.hold_decode
            self.replicas[i].hold_decode = role == "prefill"
            # every engine event on the shared timeline carries which
            # replica emitted it — what lets the fleet trace split the
            # one log back into per-replica request streams and stitch
            # a migrated request's instances into ONE journey
            self.replicas[i]._ev = tag_events(
                self.replicas[i]._ev, replica=i)
        #: the (src, dst, compress) signatures migrate_blocks has run
        self._mig_sigs: Set[Tuple[int, int, bool]] = set()
        #: the migration wire: loopback = the bit-exact in-process
        #: copy; the chunked wire adds manifests,
        #: bounded-backoff re-requests, and the re-prefill fallback
        self.transport: MigrationTransport = (
            transport if transport is not None else LoopbackTransport())
        self.transport.bind(self)
        #: the elastic-fleet control loop (``serving/autoscale.py``
        #: attaches itself here); ``step()`` ticks it after collection
        self.autoscaler: Optional[Any] = None
        self.reset_metrics()

    # ------------------------------------------------------------- bookkeeping

    def _grouped(self) -> bool:
        """Whether a replica runs over a process group."""
        return any(getattr(r, "_grouped", False) for r in self.replicas)

    def refuse_clock(self, what: str) -> None:
        """Raise for a placement that reads the host clock when a
        replica runs over a process group."""
        if self._grouped():
            raise NotImplementedError(_GROUPED.format(what=what))

    def reset_metrics(self) -> None:
        """Zero router counters and every replica's serving metrics (the
        bench warmup/measure split); the migration copies, prefix caches,
        and rid counters survive."""
        for r in self.replicas:
            r.reset_metrics()
        self._next_rid = getattr(self, "_next_rid", 0)
        #: (replica_idx, replica_rid) -> router rid, across migrations
        self._map: Dict[Tuple[int, int], int] = {}
        self.finished: Dict[int, Dict[str, Any]] = {}
        self.rejected: Dict[int, Dict[str, Any]] = {}
        # consumption pointers into each replica's arrival-ordered
        # _finished_order/_rejected_order lists — _collect walks only
        # the tail, so a 10^5-request replay stays O(completions) total
        # instead of O(ticks * completions)
        self._fin_ptr: List[int] = [0] * len(self.replicas)
        self._rej_ptr: List[int] = [0] * len(self.replicas)
        self._last_faults = [0] * len(self.replicas)
        self._last_refused = [0] * len(self.replicas)
        self._tick = 0
        self._t_first = float("inf")
        self._t_last_done = 0.0
        self.stats = {
            "routed": 0, "affinity_routed": 0, "router_shed": 0,
            "fallbacks": 0, "rebalances": 0, "rebalanced_requests": 0,
            "evacuations": 0, "evacuated_requests": 0,
            "handoffs": 0, "handoffs_deferred": 0,
            "migration_blocks": 0, "migration_shared_blocks": 0,
            "migration_bytes": 0, "migrations_compressed": 0,
            "transport_fallbacks": 0,
        }
        #: router_rid -> {src, dst, src_rid} for every transfer whose
        #: request currently lives ONLY in its exported descriptor —
        #: the ownership site :meth:`audit` counts across the
        #: export→import window
        self._inflight: Dict[int, Dict[str, Any]] = {}

    def _track(self, replica: int, replica_rid: int, router_rid: int) -> None:
        self._map[(replica, replica_rid)] = router_rid

    def _submit_targets(self) -> List[int]:
        return [i for i, role in enumerate(self.roles)
                if self.alive[i] and role in ("both", "prefill")]

    def _import_targets(self, exclude: int) -> List[int]:
        return [i for i, role in enumerate(self.roles)
                if self.alive[i] and i != exclude
                and role in ("both", "decode")]

    # ------------------------------------------------------------------ submit

    def _load_index(self, i: int) -> float:
        """Replica ``i``'s load index: queue depth + busy slots, inflated
        by the live expert-load imbalance on MoE replicas — a replica
        whose hottest expert sees 2x its fair share (imbalance 1.0)
        finishes its expert FFNs that much later than a balanced peer at
        equal occupancy, so it counts as proportionally more loaded.
        Dense replicas (``moe_imbalance`` absent or 0) are unchanged."""
        r = self.replicas[i]
        load = float(len(r.queue) + r.n_busy)
        imb = getattr(r, "moe_imbalance", None)
        if callable(imb):
            load *= 1.0 + float(imb())
        return load

    def _score(self, i: int, tokens: Sequence[int]) -> Tuple:
        """Routing sort key for replica ``i`` (smaller = better): longest
        resident prefix first (negated), then the replica's own biased
        TTFT estimate (None = unmeasured = 0: no evidence to avoid it
        on), then the imbalance-weighted load index (:meth:`_load_index`),
        then index (determinism)."""
        r = self.replicas[i]
        aff = r.prefix_lookup(tokens)
        est = r.estimate_ttft(len(tokens), tokens=tokens)
        return (-aff, est if est is not None else 0.0,
                self._load_index(i), i)

    def _candidate_table(self, targets: List[int],
                         tokens: Sequence[int]) -> List[Dict[str, Any]]:
        """The decision ledger's input table: one row per candidate
        replica with every signal :meth:`_score` ranks on.  Rows keep
        the caller's (ranked) order — what makes a placement
        attributable after the fact."""
        rows = []
        for i in targets:
            r = self.replicas[i]
            est = r.estimate_ttft(len(tokens), tokens=tokens)
            row = {
                "replica": i, "role": self.roles[i],
                "affinity_tokens": int(r.prefix_lookup(tokens)),
                "est_ttft_s": round(est, 6) if est is not None else None,
                "load": round(self._load_index(i), 4),
            }
            imb = getattr(r, "moe_imbalance", None)
            if callable(imb):
                row["expert_imbalance"] = round(float(imb()), 4)
            rows.append(row)
        return rows

    def submit(self, req: Request) -> int:
        """Route one request: candidates ranked by (affinity, estimated
        TTFT, load), tried best-first; a replica that sheds falls through
        to the next.  Returns the ROUTER rid; if every candidate refused,
        the last structured verdict lands in ``self.rejected[rid]``.
        Every outcome — placed, fallthrough, or shed — lands on the
        timeline as ONE ``route_decision`` record carrying the ranked
        candidate table the decision was made from."""
        rid = self._next_rid
        self._next_rid += 1
        targets = self._submit_targets()
        if not targets:
            self.stats["router_shed"] += 1
            self._ev.emit(
                "route_decision", rid=rid, outcome="shed",
                reason="no_replicas", candidates=[], fallthrough=[],
                chosen=None, n_alive=sum(self.alive))
            self.rejected[rid] = {"rid": rid, "reason": "no_replicas"}
            return rid
        scored = sorted(targets, key=lambda i: self._score(i, req.tokens))
        candidates = self._candidate_table(scored, req.tokens)
        fallthrough: List[Dict[str, Any]] = []
        last_verdict: Dict[str, Any] = {}
        for rank, i in enumerate(scored):
            r = self.replicas[i]
            aff = r.prefix_lookup(req.tokens)
            rrid = r.submit(req)
            if rrid in r.rejected:
                last_verdict = dict(r.rejected[rrid], replica=i)
                fallthrough.append(
                    {"replica": i,
                     "reason": last_verdict.get("reason", "shed")})
                continue
            self._track(i, rrid, rid)
            self.stats["routed"] += 1
            if aff > 0:
                self.stats["affinity_routed"] += 1
            if rank > 0:
                self.stats["fallbacks"] += 1
            est = r.estimate_ttft(len(req.tokens), tokens=req.tokens)
            self._ev.emit(
                "route_decision", rid=rid, outcome="routed", chosen=i,
                replica_rid=rrid, fallback_rank=rank,
                candidates=candidates, fallthrough=fallthrough,
                n_alive=sum(self.alive))
            self._ev.emit(
                "request_routed", rid=rid, replica=i, replica_rid=rrid,
                affinity_tokens=int(aff), fallback_rank=rank,
                est_ttft_s=round(est, 6) if est is not None else None,
                queue_depth=len(r.queue))
            return rid
        self.stats["router_shed"] += 1
        self._ev.emit(
            "route_decision", rid=rid, outcome="shed",
            reason=last_verdict.get("reason", "shed"),
            candidates=candidates, fallthrough=fallthrough, chosen=None,
            n_alive=sum(self.alive))
        self.rejected[rid] = dict(last_verdict, rid=rid,
                                  reason=last_verdict.get("reason", "shed"),
                                  routed=False)
        return rid

    # --------------------------------------------------------------- migration

    def _price_migration(self, src: int, dst: int,
                         n_blocks: int) -> Dict[str, Any]:
        """Price one migration leg and decide its wire format.  Same-zone
        legs ship the pool format; a zone-crossing leg is scored through
        ``CommModel.predict_compressed`` on the DCN axis (the leg is one
        all-gather hop of the block payload across the 2-member src/dst
        pair) and ships int8 iff the model approves.  int8 pools are
        already wire-compressed — nothing to decide."""
        ref = self.replicas[0]
        fp_bytes = migration_wire_bytes(
            ref.cfg, n_blocks, ref.block_size, quantized=ref.kv_quant)
        out: Dict[str, Any] = {
            "compress": False, "wire_bytes": fp_bytes, "basis": None,
            "dcn_crossing": self.zones[src] != self.zones[dst],
        }
        if (not out["dcn_crossing"] or self.comm_model is None
                or ref.kv_quant or n_blocks == 0):
            return out
        pred = self.comm_model.predict_compressed(
            "all_gather", float(fp_bytes), 2, axes=(self.dcn_axis,))
        out.update(
            pred_exact_s=round(pred["exact_s"], 9),
            pred_compressed_s=round(pred["compressed_s"], 9),
            basis=pred["basis"],
        )
        if pred["compress"]:
            out["compress"] = True
            out["wire_bytes"] = migration_wire_bytes(
                ref.cfg, n_blocks, ref.block_size, compressed=True)
        return out

    def _lane_copy(self, src: int, dst: int, src_cache: Any, dst_cache: Any,
                   src_ids: Sequence[int], dst_ids: Sequence[int],
                   compress: bool) -> Any:
        """The block copy for replica pair (src, dst) and wire format:
        :func:`~.paged_cache.migrate_blocks` from the export's snapshot
        (:func:`~.sim.host_migrate_blocks` for host-only stub pools).
        Shared by :class:`~.transport.LoopbackTransport` and the
        same-replica bounce path.  Each (pair, wire format) is one
        signature, as each is one compiled program in the reference
        (JAX :418); ``summary()['fleet']['migrations']['signatures']``
        counts them."""
        self._mig_sigs.add((src, dst, compress))
        copy = (host_migrate_blocks
                if getattr(self.replicas[dst].device_step, "host_only",
                           False) else migrate_blocks)
        return copy(src_cache, dst_cache, np.asarray(src_ids, np.int64),
                    np.asarray(dst_ids, np.int64), compress=compress)

    def _migration_fallback(self, router_rid: int, desc: Dict[str, Any],
                            src: int, dst: int, err: BaseException) -> bool:
        """The transport declared a handoff transfer dead: give up on
        moving the KV and RE-PREFILL the request from its descriptor on
        a surviving replica instead — correct-but-slower (the
        descriptor replay is exact, so the token stream still BIT-matches
        the unfaulted run; only the prefill work is repeated).  A
        destination that DIED mid-transfer additionally leaves rotation
        here, before placement reruns."""
        self._inflight.pop(router_rid, None)
        self.stats["transport_fallbacks"] += 1
        if isinstance(err, ReplicaDiedError) and self.alive[err.replica]:
            # full evacuation, not a bare rotation flip: requests already
            # RESIDENT on the corpse (earlier successful migrations) must
            # be rehomed too, or they leak with no terminal record
            self.evacuate(err.replica, reason="died_midmigration")
        self._ev.emit(
            "migration_fallback", rid=router_rid, src_replica=src,
            dst_replica=dst, error=repr(err),
            replica_died=isinstance(err, ReplicaDiedError),
            transport=self.transport.kind)
        landed = self._resume_descs(
            [desc], dst, "migration_fallback", origin=src)
        return landed > 0

    def _handoff(self, src: int, rid: int) -> bool:
        """Move one just-prefilled (or decoding) request from replica
        ``src`` to the best import target: export → import (prefix-
        matched on arrival) → ``migrate_blocks`` of the unshared live
        tail, carried by ``self.transport``.  A prestaging transport
        pulls and verifies the tail BEFORE the import, so every wire
        failure lands while the destination still holds nothing; a dead
        transfer falls back to re-prefill (:meth:`_migration_fallback`).
        Returns False (and leaves the request where it is) when no
        target has capacity."""
        p = self.replicas[src]
        slot = next((s for s in p._slots
                     if s.state == "decode" and s.rid == rid), None)
        if slot is None:
            return False
        tokens_full = [int(t) for t in slot.prompt] + list(slot.generated)
        need = len(slot.blocks)
        targets = sorted(
            self._import_targets(src),
            key=lambda i: (-self.replicas[i].prefix_lookup(tokens_full),
                           len(self.replicas[i].queue)
                           + self.replicas[i].n_busy, i))
        candidates = []
        for i in targets:
            t = self.replicas[i]
            candidates.append({
                "replica": i,
                "affinity_tokens": int(t.prefix_lookup(tokens_full)),
                "load": len(t.queue) + t.n_busy,
                "has_slot": any(s.state == "free" for s in t._slots),
                "blocks_free": min(a.n_free + a.n_cached
                                   for a in t._allocs),
            })
        router_rid = self._map.get((src, rid), -1)
        dst = next(
            (i for i in targets
             if any(s.state == "free" for s in self.replicas[i]._slots)
             and all(a.n_free + a.n_cached >= need
                     for a in self.replicas[i]._allocs)),
            None)
        if dst is None:
            if not targets and self.roles[src] == "prefill":
                # the last import-capable peer is gone (e.g. it died
                # mid-migration): collapse the tier rather than park
                # forever — this replica serves both phases until the
                # autoscaler revives a decode peer.  Correct, merely
                # un-disaggregated; the ledger records the collapse.
                self.roles[src] = "both"
                p.hold_decode = False
                self._ev.emit(
                    "replica_degraded", replica=src,
                    reason="tier_collapse", action="undisaggregate",
                    n_alive=sum(self.alive))
                return False
            self.stats["handoffs_deferred"] += 1
            self._ev.emit(
                "handoff_decision", rid=router_rid, src_replica=src,
                outcome="deferred", chosen=None, need_blocks=need,
                candidates=candidates)
            return False
        desc, src_cache = p.export_slot(rid)
        # the in-flight window opens: until the import lands, the request
        # exists ONLY in `desc` — audit() counts this record as its one
        # allowed ownership site
        self._inflight[router_rid] = {"src": src, "dst": dst,
                                      "src_rid": rid}
        tr = self.transport
        handle = None
        if tr.prestage:
            # probe the destination's expected prefix share and pull the
            # estimated unshared tail over the wire BEFORE the import:
            # a transfer that dies here leaves dst completely untouched
            ctx = tokens_full[:desc["length"]]
            exp_shared = (self.replicas[dst].prefix_lookup(ctx)
                          // p.block_size)
            est_price = self._price_migration(
                src, dst, max(0, desc["n_live"] - exp_shared))
            try:
                handle = tr.begin(src_cache, desc, src=src, dst=dst,
                                  compress=est_price["compress"])
                tr.fetch(handle, desc["blocks"][exp_shared:desc["n_live"]])
            except TransportDeadError as e:
                self._ev.emit(
                    "handoff_decision", rid=router_rid, src_replica=src,
                    outcome="transport_dead", chosen=dst,
                    need_blocks=need, candidates=candidates)
                return self._migration_fallback(router_rid, desc, src,
                                                dst, e)
        else:
            handle = tr.begin(src_cache, desc, src=src, dst=dst,
                              compress=False)
        d = self.replicas[dst]
        res = d.import_slot(desc)
        bounced = res is None
        if bounced:  # capacity raced away: put it back where it was
            res = p.import_slot(desc)
            assert res is not None, "export_slot freed this capacity"
            dst, d = src, p
        self._inflight.pop(router_rid, None)  # admitted: a slot owns it
        self._ev.emit(
            "handoff_decision", rid=router_rid, src_replica=src,
            outcome="bounced" if bounced else "handoff", chosen=dst,
            need_blocks=need, candidates=candidates)
        self._track(dst, res["rid"], router_rid)
        n_mig = res["n_live"] - res["n_shared"]
        price = self._price_migration(src, dst, n_mig)
        if n_mig > 0:
            mig_src = desc["blocks"][res["n_shared"]:res["n_live"]]
            mig_dst = res["blocks"][res["n_shared"]:res["n_live"]]
            if tr.prestage and not bounced:
                price["compress"] = handle["compress"]  # what shipped
                try:
                    # cache eviction raced between probe and import: the
                    # import expected to `share` these blocks but found
                    # the hashes gone — RE-SHIP them (never trust a stale
                    # hash; the wire holds the bytes)
                    tr.fetch(handle, mig_src, reship=True)
                    d.cache = tr.deliver(handle, d.cache, mig_src,
                                         mig_dst)
                except TransportDeadError as e:
                    # unwind the admission: garbage-tail hashes dropped,
                    # blocks released, slot freed — then fall back
                    d.abort_import(res["rid"], res["n_shared"])
                    self._map.pop((dst, res["rid"]), None)
                    self._inflight[router_rid] = {
                        "src": src, "dst": dst, "src_rid": rid}
                    return self._migration_fallback(router_rid, desc,
                                                    src, dst, e)
            elif bounced:
                # a bounce never crosses the wire: same-replica lane copy
                d.cache = self._lane_copy(src, dst, src_cache, d.cache,
                                          mig_src, mig_dst,
                                          price["compress"])
            else:
                handle["compress"] = price["compress"]
                d.cache = tr.deliver(handle, d.cache, mig_src, mig_dst)
        self.stats["handoffs"] += 1
        self.stats["migration_blocks"] += n_mig
        self.stats["migration_shared_blocks"] += res["n_shared"]
        self.stats["migration_bytes"] += (
            price["wire_bytes"] if n_mig > 0 else 0)
        if price["compress"]:
            self.stats["migrations_compressed"] += 1
        self._ev.emit(
            "blocks_migrated", rid=router_rid, src_replica=src,
            dst_replica=dst, n_blocks=n_mig, n_shared=res["n_shared"],
            bytes=int(price["wire_bytes"]) if n_mig > 0 else 0,
            compressed=price["compress"], dcn=price["dcn_crossing"],
            basis=price.get("basis"),
            pred_exact_s=price.get("pred_exact_s"),
            pred_compressed_s=price.get("pred_compressed_s"))
        self._ev.emit(
            "request_migrated", rid=router_rid, src_replica=src,
            dst_replica=dst, mode="prefill_handoff",
            src_rid=rid, dst_rid=res["rid"],
            emitted_tokens=len(desc.get("emitted") or []))
        if int(desc["length"]) >= self.long_ctx_threshold:
            # long-document handoff: the CP-prefill -> narrow-decode
            # shape of the long-prompt tier
            self._ev.emit(
                "kv_handoff_long", rid=router_rid, src_replica=src,
                dst_replica=dst, length=int(desc["length"]),
                n_blocks=n_mig,
                bytes=int(price["wire_bytes"]) if n_mig > 0 else 0,
                cp=int(getattr(p, "cp", 1)))
        return True

    def _resume_descs(self, descs: List[Dict[str, Any]], exclude: int,
                      kind: str, origin: Optional[int] = None) -> int:
        """Resume drain descriptors onto the least-loaded surviving
        replicas (affinity-ranked per descriptor), bouncing a shed
        descriptor to the next candidate; a descriptor every survivor
        refused becomes a router-level rejection.  Returns how many
        landed.  ``origin`` names the replica the descriptors' rids map
        from when it differs from the one being avoided (the
        migration-fallback path excludes the DEAD destination while the
        rids belong to the export source — which stays a legitimate
        landing spot)."""
        origin = exclude if origin is None else origin
        landed = 0
        for desc in descs:
            tokens_full = ([int(t) for t in desc["prompt"]]
                           + [int(t) for t in desc.get("emitted") or []])
            router_rid = self._map.get((origin, desc.get("orig_rid", -1)))
            if router_rid is None:
                router_rid = self._next_rid
                self._next_rid += 1
            targets = sorted(
                (i for i in self._submit_targets() if i != exclude),
                key=lambda i: self._score(i, tokens_full))
            placed = False
            for i in targets:
                r = self.replicas[i]
                (rrid,) = r.resume(
                    {"schema": DRAIN_SCHEMA, "n": 1, "requests": [desc]})
                if rrid in r.rejected:
                    continue
                self._track(i, rrid, router_rid)
                self._ev.emit(
                    "request_migrated", rid=router_rid,
                    src_replica=origin, dst_replica=i, mode=kind,
                    src_rid=desc.get("orig_rid"), dst_rid=rrid,
                    emitted_tokens=len(desc.get("emitted") or []))
                landed += 1
                placed = True
                break
            if not placed:
                self.stats["router_shed"] += 1
                self.rejected[router_rid] = {
                    "rid": router_rid, "reason": "migration_shed",
                    "kind": kind, "src_replica": exclude}
        return landed

    def rebalance(self, src: int, trigger: str = "manual") -> int:
        """Move queued work off replica ``src``: steal the tail of its
        queue (half the depth spread, at least 1) and resume it on the
        best surviving replicas.  KV-free, exact-parity (the
        drain/resume contract).  Returns requests moved.  Every attempt
        — including one that found nothing to steal — lands as a
        ``rebalance_decision`` record carrying the queue depths it saw
        and what triggered the scan."""
        targets = self._submit_targets()
        depths = [len(self.replicas[i].queue) for i in targets]
        if not depths:
            return 0
        spread = len(self.replicas[src].queue) - min(depths)
        n = max(1, spread // 2)
        descs = self.replicas[src].steal_queued(n)
        moved = self._resume_descs(descs, src, "rebalance") if descs else 0
        self._ev.emit(
            "rebalance_decision", src_replica=src, trigger=trigger,
            depths=[[i, d] for i, d in zip(targets, depths)],
            spread=int(spread), watermark=self.rebalance_watermark,
            stolen=len(descs), moved=moved)
        if not descs:
            return 0
        self.stats["rebalances"] += 1
        self.stats["rebalanced_requests"] += moved
        return moved

    def set_alive(self, i: int, alive: bool, reason: str = "manual") -> None:
        """Flip replica ``i``'s rotation bit, emitting ``replica_up`` /
        ``replica_down`` with the reason — the ledger half of the
        rotation switch (flipped by evacuations, by hand and by the
        :class:`~.autoscale.Autoscaler`).  Bringing a
        replica back up re-enters it into routing with whatever engine
        state it still holds; a drained replica comes back EMPTY (its
        requests were rehomed) but keeps its prefix cache, so revived
        capacity is warm.  No-op when the bit already matches."""
        alive = bool(alive)
        if self.alive[i] == alive:
            return
        self.alive[i] = alive
        self._ev.emit(
            "replica_up" if alive else "replica_down", replica=i,
            reason=reason, role=self.roles[i], zone=self.zones[i],
            n_alive=sum(self.alive))

    def evacuate(self, i: int, reason: str = "manual") -> int:
        """Kill replica ``i``: drain it (queue + in-flight unwound into
        exact-parity descriptors), take it out of rotation
        (``replica_down`` on the ledger), and resume everything on the
        survivors.  Returns requests rehomed."""
        self._ev.emit("replica_degraded", replica=i, reason=reason,
                      action="evacuate",
                      faults=self.replicas[i].stats["faults_detected"],
                      queued=len(self.replicas[i].queue),
                      in_flight=self.replicas[i].n_busy)
        payload = self.replicas[i].drain()
        self.set_alive(i, False, reason=reason)
        moved = self._resume_descs(payload["requests"], i, "evacuation")
        self.stats["evacuations"] += 1
        self.stats["evacuated_requests"] += moved
        return moved

    # ------------------------------------------------------------------- ticks

    def _health_scan(self) -> None:
        """Per-tick degradation watch: a replica whose fault counter
        moved is evacuated when the policy says so; new refused demand
        (shed/expired — the 'overloaded' verdict evidence) triggers an
        immediate KV-free rebalance of its queue."""
        for i, r in enumerate(self.replicas):
            if not self.alive[i]:
                continue
            faults = r.stats["faults_detected"]
            refused = r.stats["shed"] + r.stats["expired"]
            if faults > self._last_faults[i] and self.evacuate_on_fault:
                self._last_faults[i] = faults
                self.evacuate(i, reason="faults_detected")
                continue
            if faults > self._last_faults[i]:
                self._ev.emit(
                    "replica_degraded", replica=i, reason="faults_detected",
                    action="observed", faults=faults)
            self._last_faults[i] = faults
            if refused > self._last_refused[i] and r.queue and len(
                    self._submit_targets()) > 1:
                self._ev.emit(
                    "replica_degraded", replica=i, reason="overloaded",
                    action="rebalance",
                    shed=r.stats["shed"], expired=r.stats["expired"])
                self.rebalance(i, trigger="overloaded")
            self._last_refused[i] = refused

    def _watermark_scan(self) -> None:
        targets = self._submit_targets()
        if len(targets) < 2:
            return
        depths = {i: len(self.replicas[i].queue) for i in targets}
        deepest = max(depths, key=lambda i: depths[i])
        if depths[deepest] - min(depths.values()) > self.rebalance_watermark:
            self.rebalance(deepest, trigger="watermark")

    def _collect(self) -> None:
        for i, r in enumerate(self.replicas):
            for rrid in r._finished_order[self._fin_ptr[i]:]:
                rec = r.finished[rrid]
                router_rid = self._map.get((i, rrid))
                if router_rid is None:
                    continue  # warmup traffic submitted around the router
                self.finished[router_rid] = dict(rec, replica=i,
                                                 rid=router_rid)
                self._t_first = min(self._t_first, rec["t_submit"])
                self._t_last_done = max(self._t_last_done, rec["t_done"])
            self._fin_ptr[i] = len(r._finished_order)
            for rrid in r._rejected_order[self._rej_ptr[i]:]:
                verdict = r.rejected[rrid]
                router_rid = self._map.get((i, rrid))
                if router_rid is not None and router_rid not in self.finished:
                    # a replica refused AFTER admission routing (queued
                    # deadline expiry): surface it at the router level
                    self.rejected[router_rid] = dict(verdict, replica=i,
                                                     rid=router_rid)
            self._rej_ptr[i] = len(r._rejected_order)

    def step(self) -> Dict[str, int]:
        """One fleet tick: health/degradation scan → (periodic) queue
        rebalance → step every replica that has work → disaggregation
        handoffs off the prefill tier → collect finished/rejected.
        Idle replicas are NOT stepped — fleet cost tracks live load, not
        fleet size."""
        self._tick += 1
        self._health_scan()
        if self.rebalance_every and self._tick % self.rebalance_every == 0:
            self._watermark_scan()
        stepped = busy = 0
        for i, r in enumerate(self.replicas):
            if not self.alive[i] or not (r.queue or r.n_busy):
                continue
            r.step()
            stepped += 1
            if self.roles[i] == "prefill":
                for rid, _slot in r.decode_slots():
                    self._handoff(i, rid)
            busy += r.n_busy
        self._collect()
        if self.autoscaler is not None:
            self.autoscaler.tick()
        return {"stepped": stepped, "busy": busy,
                "queued": sum(len(r.queue) for r in self.replicas)}

    @property
    def n_busy(self) -> int:
        return sum(r.n_busy for i, r in enumerate(self.replicas)
                   if self.alive[i])

    def has_work(self) -> bool:
        return any(self.alive[i] and (r.queue or r.n_busy)
                   for i, r in enumerate(self.replicas))

    def run_until_idle(self, max_ticks: int = 100_000) -> None:
        while self.has_work():
            self.step()
            if self._tick > max_ticks:
                raise RuntimeError(
                    f"fleet did not drain within {max_ticks} ticks")

    # ------------------------------------------------------------------- audit

    def audit(self) -> Dict[str, Any]:
        """The cross-replica conservation audit: every replica's own
        block audit (heal=False — pure report) PLUS the invariant only a
        migration could break: each router-tracked request is live
        (queued, in a slot, OR riding an in-flight transfer) on AT MOST
        one ownership site.  A double-owned request means an
        export/import or drain/resume landed twice — its two copies
        would both decode and both free blocks.  In-flight transfer
        records (:attr:`_inflight` — the export→import window, during
        which the request exists only in its descriptor) count as an
        ownership site: a request both in flight and live on a replica
        is exactly the double-delivery a wire retry could cause."""
        violations: List[Dict[str, Any]] = []
        per_replica = []
        for i, r in enumerate(self.replicas):
            rep = r.audit(heal=False)
            per_replica.append(rep)
            if not rep["ok"]:
                violations.append(
                    {"kind": "replica_audit", "replica": i,
                     "violations": rep["violations"]})
        live: Dict[int, List[Any]] = {}
        for router_rid, rec in self._inflight.items():
            live.setdefault(router_rid, []).append(
                f"inflight:{rec['src']}->{rec['dst']}")
        for i, r in enumerate(self.replicas):
            rids = {req.rid for req, _t in r.queue}
            rids |= {s.rid for s in r._slots if s.state != "free"}
            for rrid in rids:
                router_rid = self._map.get((i, rrid))
                if router_rid is not None:
                    live.setdefault(router_rid, []).append(i)
        for router_rid, where in live.items():
            if len(where) > 1:
                violations.append({"kind": "double_owned",
                                   "rid": router_rid, "replicas": where})
        return {"ok": not violations, "violations": violations,
                "inflight": len(self._inflight),
                "per_replica": per_replica}

    # ----------------------------------------------------------------- summary

    def summary(self) -> Dict[str, Any]:
        """The RUNREPORT ``router`` section
        (``obs.report._validate_router`` checks it): one full
        ``serving_summary()`` per replica (tagged with index / role /
        zone / liveness) and the fleet roll-up — fleet tokens/s and
        goodput over the ROUTER's span (necessarily ≤ the sum of
        replica rates, which validation enforces), affinity hit rate,
        migration count/bytes, rebalance/evacuation counts, the
        per-replica verdict list, plus the FLEETREPORT additions: a
        ``slo`` block (fleet attainment, per-priority aggregation
        across replicas, per-replica attainment/goodput) and a cited
        ``balance`` verdict (``balanced|skewed|degraded`` off the
        served-token imbalance index — :data:`IMBALANCE_SKEWED_AT`)."""
        replicas = []
        for i, r in enumerate(self.replicas):
            s = r.serving_summary()
            replicas.append(dict(s, index=i, role=self.roles[i],
                                 zone=self.zones[i], alive=self.alive[i]))
        span = self._t_last_done - self._t_first
        gen = sum(r["generated_tokens"] for r in replicas)
        goodput_tokens = sum(
            (r.get("slo") or {}).get("goodput_tokens", 0) for r in replicas)
        met = demand = 0
        per_prio: Dict[Any, Dict[str, int]] = {}
        per_replica_slo = []
        for r in replicas:
            for prio, row in (((r.get("slo") or {}).get("priorities")
                               or {}).items()):
                agg = per_prio.setdefault(
                    prio, {"met": 0, "completed": 0, "shed": 0,
                           "expired": 0})
                for k in agg:
                    agg[k] += row.get(k, 0)
                met += row.get("met", 0)
                demand += (row.get("completed", 0) + row.get("shed", 0)
                           + row.get("expired", 0))
            per_replica_slo.append({
                "index": r["index"],
                "attainment": (r.get("slo") or {}).get("attainment"),
                "goodput_tok_s": (r.get("slo") or {}).get(
                    "goodput_tok_s", 0.0),
            })
        for prio, agg in per_prio.items():
            d = agg["completed"] + agg["shed"] + agg["expired"]
            agg["attainment"] = round(agg["met"] / d, 4) if d else None
        st = self.stats
        verdicts = [r["verdict"] for r in replicas]
        fleet_verdict = max(verdicts, key=lambda v: _VERDICT_RANK[v])
        if not all(self.alive):
            fleet_verdict = max(fleet_verdict, "degraded",
                                key=lambda v: _VERDICT_RANK[v])
        # FLEETREPORT balance verdict: cited, like the engine's own
        # verdict_basis — degraded fleets don't get a balance opinion.
        # Served tokens are only comparable between replicas of the SAME
        # role (a disaggregated prefill tier generates no decode tokens
        # by design), so the index is max-over-role-groups of max/mean
        # within the group; past the line = skewed.
        loads = [r["generated_tokens"] for r in replicas if r["alive"]]
        imbalance = None
        for role in ROLES:
            group = [r["generated_tokens"] for r in replicas
                     if r["alive"] and r["role"] == role]
            mean_load = (sum(group) / len(group)) if group else 0.0
            if mean_load > 0:
                idx = max(group) / mean_load
                imbalance = idx if imbalance is None else max(imbalance,
                                                              idx)
        if fleet_verdict != "healthy":
            balance_verdict = "degraded"
            basis = (f"fleet verdict {fleet_verdict} "
                     f"({sum(self.alive)}/{len(self.replicas)} alive, "
                     f"replica verdicts {verdicts})")
        elif imbalance is not None and imbalance > IMBALANCE_SKEWED_AT:
            balance_verdict = "skewed"
            basis = (f"imbalance index {imbalance:.2f} > "
                     f"{IMBALANCE_SKEWED_AT} (per-replica served tokens "
                     f"{loads}, max/mean within role groups)")
        else:
            balance_verdict = "balanced"
            basis = (f"imbalance index "
                     f"{imbalance:.2f} <= {IMBALANCE_SKEWED_AT}"
                     if imbalance is not None
                     else "no tokens served yet")
        fleet = {
            "n_replicas": len(self.replicas),
            "n_alive": sum(self.alive),
            "verdict": fleet_verdict,
            "verdicts": verdicts,
            "generated_tokens": gen,
            "tokens_per_sec": (gen / span if span > 0 and gen else 0.0),
            "goodput_tokens": goodput_tokens,
            "goodput_tok_s": (
                goodput_tokens / span if span > 0 and gen else 0.0),
            "attainment": round(met / demand, 4) if demand else None,
            "slo": {
                "attainment": round(met / demand, 4) if demand else None,
                "priorities": {str(k): v for k, v in per_prio.items()},
                "per_replica": per_replica_slo,
            },
            "balance": {
                "verdict": balance_verdict,
                "imbalance_index": (round(imbalance, 4)
                                    if imbalance is not None else None),
                "loads": loads,
                "basis": basis,
            },
            "affinity": {
                "routed": st["routed"],
                "affinity_routed": st["affinity_routed"],
                "hit_rate": (st["affinity_routed"] / st["routed"]
                             if st["routed"] else 0.0),
                "fallbacks": st["fallbacks"],
                "router_shed": st["router_shed"],
            },
            "rebalances": st["rebalances"],
            "rebalanced_requests": st["rebalanced_requests"],
            "evacuations": st["evacuations"],
            "evacuated_requests": st["evacuated_requests"],
            "migrations": {
                "handoffs": st["handoffs"],
                "deferred": st["handoffs_deferred"],
                "blocks": st["migration_blocks"],
                "shared_blocks": st["migration_shared_blocks"],
                "bytes": st["migration_bytes"],
                "compressed": st["migrations_compressed"],
                # one migrate_blocks copy per (replica pair, wire
                # format) ever used
                "signatures": len(self._mig_sigs),
                # the fault-tolerant wire: per-chunk re-requests
                # healed by bounded backoff, and transfers declared dead
                # that fell back to the re-prefill path
                "retries": self.transport.stats["retries"],
                "fallbacks": st["transport_fallbacks"],
                "transport": dict(self.transport.stats,
                                  kind=self.transport.kind),
            },
        }
        if self.autoscaler is not None:
            fleet["autoscale"] = self.autoscaler.summary()
        return {"replicas": replicas, "fleet": fleet}
