"""The overlap regime — the port's counterpart of
``torchdistpackage_tpu/dist/overlap.py``.

The reference's lever is ``XLA_FLAGS``: curated presets that turn on
XLA's latency-hiding scheduler and async collectives, merged into the
user's flags and probed in a subprocess before they are written.  XLA's
flags have no PyTorch counterpart, and the port's overlap is already
in its code: ``DataParallel`` starts each bucket's all-reduce
asynchronously from the backward's hooks, FSDP's
``prefetched_layer_scan`` starts the next layer's gathers before this
layer's compute, and ``tp_utils._start_all_gather`` /
``start_all_reduce`` return the call that waits.  So a preset here is
the switch of that regime:

- ``'none'``: every collective is waited on where it is issued (the
  calling stream waits on NCCL's at once; nothing overlaps);
- ``'generic'`` (and ``'auto'``, its other name, on a card or the
  CPU): today's asynchronous behaviour.

Both regimes give the same numbers bit for bit: only where a wait
happens moves.  :func:`configure` records an ``overlap_configure``
event; :func:`active` returns the last record.  The reference's
``merge_xla_flags``, ``validate_flags`` and ``cpu_sim`` have no
counterpart (no flags to merge or probe, and the CPU needs no
simulated devices: a gloo group of processes is the port's CPU world).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..parallel.tensor_parallel import tp_utils

__all__ = ["PRESETS", "active", "configure", "resolve_preset", "waits"]

#: preset name -> the regime it sets
PRESETS: Dict[str, Dict[str, bool]] = {
    "none": {"async_collectives": False},
    "generic": {"async_collectives": True},
}

_ACTIVE: Optional[Dict[str, Any]] = None


def resolve_preset(preset: str = "auto") -> str:
    """``'auto'`` -> ``'generic'``; any other name is checked against
    :data:`PRESETS`."""
    if preset == "auto":
        return "generic"
    if preset not in PRESETS:
        raise ValueError(f"unknown overlap preset {preset!r}; known: "
                         f"{sorted(PRESETS)} or 'auto'")
    return preset


def configure(preset: str = "auto") -> Dict[str, Any]:
    """Set the overlap regime for this process and return (and keep, see
    :func:`active`) its record ``{'preset', 'async_collectives'}``; an
    ``overlap_configure`` event records it on the event log."""
    global _ACTIVE
    name = resolve_preset(preset)
    record: Dict[str, Any] = {"preset": name, **PRESETS[name]}
    _ACTIVE = record
    tp_utils.SYNC_COLLECTIVES = not record["async_collectives"]
    from ..obs.events import default_event_log

    default_event_log().emit("overlap_configure", **record)
    return dict(record)


def active() -> Optional[Dict[str, Any]]:
    """The record of the last :func:`configure` call in this process, or
    None when the regime was never configured (then collectives are
    asynchronous, as under ``'generic'``)."""
    return None if _ACTIVE is None else dict(_ACTIVE)


def waits() -> bool:
    """True under ``'none'``: every collective is waited on where it is
    issued."""
    return tp_utils.SYNC_COLLECTIVES
