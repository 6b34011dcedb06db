"""Resilience — the integrity pieces the serving engine's drain file
uses and the bounded retry the migration wire re-requests under
(``ckpt_guard``), the chaos harness (``chaos``) that drives the
engine's heal paths and the wire's faults, and the hang watchdog and
cross-rank consistency check (``watchdog``).  The reference's resilient
training loop and guarded checkpoint manager come with the training
slice of ROADMAP queue A's "Obs, resilience, tools, utils and HF
conversion"."""

from .chaos import (
    ENGINE_FAULT_KINDS,
    FAULT_KINDS,
    TRANSPORT_FAULT_KINDS,
    ChaosMonkey,
    Fault,
    corrupt_checkpoint,
)
from .ckpt_guard import CheckpointCorruptError, with_retries
from .watchdog import (
    Watchdog,
    check_consistency,
    code_fingerprint,
    config_fingerprint,
    consistency_fingerprint,
    param_checksum,
)

__all__ = ["CheckpointCorruptError", "ChaosMonkey", "ENGINE_FAULT_KINDS",
           "FAULT_KINDS", "Fault", "TRANSPORT_FAULT_KINDS", "Watchdog",
           "check_consistency", "code_fingerprint", "config_fingerprint",
           "consistency_fingerprint", "corrupt_checkpoint",
           "param_checksum", "with_retries"]
