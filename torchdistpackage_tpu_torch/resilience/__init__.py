"""Resilience — survive faults instead of merely observing them (the
port's ``torchdistpackage_tpu/resilience``):

- :mod:`.chaos` — deterministic, seed-driven fault injection for the
  training loop, the serving engine and the migration wire, every
  injection a ``fault_injected`` event;
- :mod:`.ckpt_guard` — hardened checkpoint I/O: bounded retries,
  integrity manifests written at commit and verified before a restore,
  quarantine of a bad step, :class:`GuardedCheckpointManager`;
- :mod:`.loop` — :class:`ResilientLoop`: divergence monitor -> rollback
  to the newest good checkpoint -> the data stream advanced past the
  poisoned window -> a clean abort once the retry budget is spent;
- :mod:`.watchdog` — heartbeat hang detection and the cross-process
  consistency check.
"""

from .chaos import (
    ENGINE_FAULT_KINDS,
    FAULT_KINDS,
    TRANSPORT_FAULT_KINDS,
    ChaosMonkey,
    Fault,
    corrupt_checkpoint,
)
from .ckpt_guard import (
    CheckpointCorruptError,
    GuardedCheckpointManager,
    manifest_path,
    quarantine_checkpoint,
    quarantine_dir,
    tree_spec,
    verify_checkpoint,
    verify_template,
    with_retries,
    write_manifest,
)
from .loop import DivergenceMonitor, LoopResult, ResilientLoop
from .watchdog import (
    Watchdog,
    check_consistency,
    code_fingerprint,
    config_fingerprint,
    consistency_fingerprint,
    param_checksum,
)

__all__ = [
    "ENGINE_FAULT_KINDS", "FAULT_KINDS", "TRANSPORT_FAULT_KINDS",
    "ChaosMonkey", "Fault", "corrupt_checkpoint", "CheckpointCorruptError",
    "GuardedCheckpointManager", "manifest_path", "quarantine_checkpoint",
    "quarantine_dir", "tree_spec", "verify_checkpoint", "verify_template",
    "with_retries", "write_manifest", "DivergenceMonitor", "LoopResult",
    "ResilientLoop", "Watchdog", "check_consistency", "code_fingerprint",
    "config_fingerprint", "consistency_fingerprint", "param_checksum",
]
