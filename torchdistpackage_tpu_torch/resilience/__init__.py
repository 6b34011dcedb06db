"""Resilience — the integrity pieces the serving engine's drain file
uses and the bounded retry the migration wire re-requests under
(``ckpt_guard``), and the chaos harness (``chaos``) that drives the
engine's heal paths and the wire's faults.  The rest of the
reference's ``resilience/`` (the resilient loop, the watchdog, the
guarded checkpoint manager) waits for ROADMAP queue A's "Obs,
resilience, tools, utils and HF conversion"."""

from .chaos import (
    ENGINE_FAULT_KINDS,
    FAULT_KINDS,
    TRANSPORT_FAULT_KINDS,
    ChaosMonkey,
    Fault,
    corrupt_checkpoint,
)
from .ckpt_guard import CheckpointCorruptError, with_retries

__all__ = ["CheckpointCorruptError", "ChaosMonkey", "ENGINE_FAULT_KINDS",
           "FAULT_KINDS", "Fault", "TRANSPORT_FAULT_KINDS",
           "corrupt_checkpoint", "with_retries"]
