"""Serving trace vocabulary — of ``torchdistpackage_tpu/serving/tracing.py``
only :data:`ROUTER_EVENT_KINDS` (JAX :521), which ``tools.trace_replay``
keys its ledger on.  The request-lifecycle and fleet trace assembly and
the Perfetto renderers wait for ROADMAP queue A's "Obs, resilience,
tools, utils and HF conversion"."""

#: Event kinds emitted by the Router itself (the decision ledger, the
#: routing and migration records, the autoscaler's evaluations and the
#: migration wire's retry / fallback records).  On a fleet timeline they
#: stay on the router's lane; everything else carrying a ``replica`` tag
#: is an engine event of that replica.
ROUTER_EVENT_KINDS = frozenset({
    "route_decision", "request_routed", "handoff_decision",
    "rebalance_decision", "request_migrated", "blocks_migrated",
    "replica_degraded", "replica_up", "replica_down",
    "scale_decision", "migration_retry", "migration_fallback",
})
