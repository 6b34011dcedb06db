"""Fault-tolerant KV-migration transport — the PyTorch counterpart of
``torchdistpackage_tpu/serving/transport.py``: the wire under the
router's ``export_slot`` -> ``import_slot`` -> ``migrate_blocks``
handoff.

- :class:`MigrationTransport` — what the router speaks: ``begin`` opens a
  transfer for one exported request, ``fetch`` stages block payloads (a
  prestaging transport pulls them before the import lands, so a dead
  wire leaves the destination untouched), ``deliver`` writes staged
  blocks into the destination pool.
- :class:`LoopbackTransport` — the in-process wire (default): ``deliver``
  is the router's cached per-pair ``migrate_blocks``
  (``Router._lane_copy``), device to device.
- :class:`ChunkedWireTransport` — the wire format, in process: one chunk
  a migrated block (every pool leaf's block slice as host bytes, the
  int8 ``(q8, scale)`` payload of ``_kv_quant`` when the comm model
  approved compression), a sender-side manifest of each chunk's SHA-256
  and byte count, the receiver's check of every chunk against it, and
  ``with_retries`` re-requesting a chunk that drops, rots or times out.
  A :class:`~..resilience.ChaosMonkey` injects
  ``TRANSPORT_FAULT_KINDS`` per fetch attempt.

Failure taxonomy: :class:`TransportError` (one chunk attempt failed;
retried), :class:`TransportDeadError` (the retry budget is spent: the
router re-prefills the request on a survivor) and
:class:`ReplicaDiedError` (the destination died mid-transfer: terminal,
and it names the replica the router takes out of rotation).

The chunked wire stages every chunk on the host: a block of a pool on
the card is copied to host memory, hashed, and copied back onto the
destination's device by ``deliver``.  One card has no peer to send to,
so the wire between two replicas of one process is that host copy.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.events import default_event_log
from ..resilience.ckpt_guard import with_retries
from .paged_cache import PoolSnapshot


class TransportError(RuntimeError):
    """One chunk attempt failed (dropped / corrupt / timed out) —
    retryable: the bounded-backoff loop re-requests the chunk."""


class TransportDeadError(RuntimeError):
    """The transfer failed terminally (retry budget exhausted).  The
    router falls back to re-prefill on a survivor — it does not retry."""


class ReplicaDiedError(TransportDeadError):
    """The destination replica died mid-transfer.  Carries ``replica``
    so the router can take it out of rotation before falling back."""

    def __init__(self, replica: int, message: str) -> None:
        super().__init__(message)
        self.replica = int(replica)


def _leaf_items(cache: Dict[str, Any]) -> List[Tuple[str, Optional[int], Any]]:
    """Deterministic ``(name, sub-leaf index, array)`` walk of a pool:
    plain leaves give ``(name, None, leaf)``, a quantized ``(q8, scale)``
    pair one entry a member; sorted by name so sender and receiver agree
    on a chunk's byte layout."""
    out: List[Tuple[str, Optional[int], Any]] = []
    for name in sorted(cache):
        leaf = cache[name]
        if isinstance(leaf, tuple):
            out.extend((name, j, sub) for j, sub in enumerate(leaf))
        else:
            out.append((name, None, leaf))
    return out


def _host_bytes(a: Any) -> bytes:
    """The bytes of a host array (numpy, or a CPU tensor of any dtype,
    bf16 included)."""
    if isinstance(a, np.ndarray):
        return a.tobytes()
    return a.contiguous().view(torch.uint8).numpy().tobytes()


class MigrationTransport:
    """Interface between :class:`~.router.Router` and the migration wire
    (JAX :100).  One transfer = ``begin`` (a handle) -> ``fetch`` (stage
    block payloads; a prestaging transport raises here on a dead wire,
    before the destination admits anything) -> ``deliver`` (write staged
    blocks into the destination pool at the import's block ids).
    ``bind(router)`` is called once from the router's constructor."""

    kind = "abstract"
    prestage = False

    def __init__(self) -> None:
        self._router: Optional[Any] = None
        self.stats: Dict[str, int] = {
            "sends": 0, "chunks": 0, "wire_bytes": 0, "retries": 0,
            "reshipped_blocks": 0, "dead_transfers": 0,
        }

    def bind(self, router: Any) -> "MigrationTransport":
        self._router = router
        return self

    def emit(self, kind: str, **fields: Any) -> None:
        """Land a transport event on the bound router's timeline (the
        default event log when unbound)."""
        ev = (self._router._ev if self._router is not None
              else default_event_log())
        ev.emit(kind, **fields)

    def begin(self, src_cache: Any, desc: Dict[str, Any], *, src: int,
              dst: int, compress: bool) -> Dict[str, Any]:
        raise NotImplementedError

    def fetch(self, handle: Dict[str, Any], block_ids: Sequence[int],
              reship: bool = False) -> None:
        raise NotImplementedError

    def deliver(self, handle: Dict[str, Any], dst_cache: Any,
                src_ids: Sequence[int], dst_ids: Sequence[int]) -> Any:
        raise NotImplementedError


class LoopbackTransport(MigrationTransport):
    """The in-process wire (JAX :149): ``deliver`` runs the router's
    cached per-(pair, wire-format) ``migrate_blocks``, so a loopback fleet
    copies device to device and its signature accounting
    (``summary()['fleet']['migrations']['signatures']``) counts the
    pairs."""

    kind = "loopback"
    prestage = False

    def begin(self, src_cache: Any, desc: Dict[str, Any], *, src: int,
              dst: int, compress: bool) -> Dict[str, Any]:
        self.stats["sends"] += 1
        return {"src_cache": src_cache, "src": src, "dst": dst,
                "compress": bool(compress)}

    def fetch(self, handle: Dict[str, Any], block_ids: Sequence[int],
              reship: bool = False) -> None:
        return None  # nothing to stage: deliver copies pool to pool

    def deliver(self, handle: Dict[str, Any], dst_cache: Any,
                src_ids: Sequence[int], dst_ids: Sequence[int]) -> Any:
        assert self._router is not None, "LoopbackTransport is unbound"
        self.stats["chunks"] += len(src_ids)
        return self._router._lane_copy(
            handle["src"], handle["dst"], handle["src_cache"], dst_cache,
            src_ids, dst_ids, handle["compress"])


class ChunkedWireTransport(MigrationTransport):
    """Chunked, checksummed, retrying wire for cross-replica KV (JAX
    :178).  One chunk a migrated block: the concatenated host bytes of
    every pool leaf's block slice, int8 ``(q8, scale)`` when the transfer
    was opened with ``compress=True`` (the router passes the comm model's
    verdict; the payload ``migrate_blocks(compress=True)`` would write).
    The sender records each chunk's SHA-256 and byte count in the
    manifest when it first reads the block; every arrival is checked
    against it, so a corrupt chunk fails like a dropped one
    (:class:`TransportError`) and ``with_retries`` re-requests it
    (``migration_retry`` an attempt, ``retries`` a chunk).

    Fault injection: ``chaos.transport_faults_due(seq)`` on every fetch
    attempt (``seq``: this transfer's send number; ``Fault.slot``: the
    victim chunk).  A stall longer than ``timeout_s`` is a timeout
    (modeled: nothing sleeps); ``replica_death_midmigration`` raises
    :class:`ReplicaDiedError` once chunks have started flowing.  The
    backoff delays default to 0 (in-process retries are instant)."""

    kind = "chunked_wire"
    prestage = True

    def __init__(self, *, retries: int = 3, base_delay_s: float = 0.0,
                 max_delay_s: float = 0.0, timeout_s: float = 0.5,
                 chaos: Optional[Any] = None) -> None:
        super().__init__()
        self.retries = int(retries)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.timeout_s = float(timeout_s)
        self.chaos = chaos
        self._seq = 0

    # sender side ----------------------------------------------------------

    def begin(self, src_cache: Any, desc: Dict[str, Any], *, src: int,
              dst: int, compress: bool) -> Dict[str, Any]:
        seq = self._seq
        self._seq += 1
        self.stats["sends"] += 1
        # an int8 pool is at wire precision already
        compress = bool(compress) and not isinstance(src_cache["k"], tuple)
        return {"src_cache": src_cache, "src": src, "dst": dst,
                "compress": compress, "seq": seq, "rid": desc.get("orig_rid"),
                "staged": {}, "manifest": {}}

    def _read_block(self, handle: Dict[str, Any],
                    b: int) -> Tuple[Dict[Any, Any], bytes]:
        """Sender-side read of block ``b``: the per-leaf host payloads
        (what ``deliver`` writes) and the chunk bytes the manifest
        hashes.  A :class:`~.paged_cache.PoolSnapshot` source is read
        through its rows."""
        cache = handle["src_cache"]
        row = (int(cache.rows([b])[0]) if isinstance(cache, PoolSnapshot)
               else b)
        payload: Dict[Any, Any] = {}
        parts: List[bytes] = []
        for name, j, leaf in _leaf_items(cache):
            arr = leaf[:, row]
            arr = (arr.copy() if isinstance(arr, np.ndarray)
                   else arr.detach().to("cpu"))
            floating = (arr.dtype.kind == "f" if isinstance(arr, np.ndarray)
                        else arr.is_floating_point())
            if handle["compress"] and floating:
                from ..models.generate import _kv_quant

                q, scale = _kv_quant(torch.as_tensor(arr))
                payload[(name, j)] = (q, scale)
                parts.append(_host_bytes(q))
                parts.append(_host_bytes(scale))
            else:
                payload[(name, j)] = arr
                parts.append(_host_bytes(arr))
        return payload, b"".join(parts)

    # receiver side --------------------------------------------------------

    def fetch(self, handle: Dict[str, Any], block_ids: Sequence[int],
              reship: bool = False) -> None:
        """Stage ``block_ids`` (skipping blocks already staged;
        ``reship=True`` marks a post-import top-up re-requesting blocks
        the import expected to share but found evicted).  Each chunk is
        fetched under its own ``with_retries`` budget: exhaustion raises
        :class:`TransportDeadError`, a destination death
        :class:`ReplicaDiedError` at once."""
        ids = [int(b) for b in block_ids if int(b) not in handle["staged"]]
        if reship:
            self.stats["reshipped_blocks"] += len(ids)
        for idx, b in enumerate(ids):
            self._fetch_chunk(handle, b, idx, len(ids))

    def _fetch_chunk(self, handle: Dict[str, Any], b: int, idx: int,
                     total: int) -> None:
        def attempt() -> None:
            faults = (self.chaos.transport_faults_due(handle["seq"])
                      if self.chaos is not None else [])
            for f in faults:
                if f.kind != "replica_death_midmigration":
                    continue
                # the peer dies once chunks have started flowing: on the
                # second chunk of a multi-chunk send, at once on one
                if idx >= min(1, total - 1):
                    self.chaos.fire(f, seq=handle["seq"], chunk=idx,
                                    dst_replica=handle["dst"])
                    raise ReplicaDiedError(
                        handle["dst"],
                        f"replica {handle['dst']} died mid-migration "
                        f"(send {handle['seq']}, chunk {idx}/{total})")
            payload, raw = self._read_block(handle, b)
            man = handle["manifest"].setdefault(
                b, {"sha256": hashlib.sha256(raw).hexdigest(),
                    "bytes": len(raw)})
            for f in faults:
                if (f.slot or 0) % max(1, total) != idx:
                    continue
                if f.kind == "chunk_drop":
                    self.chaos.fire(f, seq=handle["seq"], chunk=idx,
                                    block=b)
                    raise TransportError(
                        f"chunk {idx} (block {b}) dropped on send "
                        f"{handle['seq']}")
                if f.kind == "chunk_corrupt":
                    self.chaos.fire(f, seq=handle["seq"], chunk=idx,
                                    block=b)
                    raw = bytes([raw[0] ^ 0xFF]) + raw[1:]
                if f.kind == "transport_stall":
                    self.chaos.fire(f, seq=handle["seq"], chunk=idx,
                                    block=b, duration_s=f.duration_s)
                    if f.duration_s > self.timeout_s:
                        raise TransportError(
                            f"chunk {idx} (block {b}) timed out: stalled "
                            f"{f.duration_s}s > timeout {self.timeout_s}s")
            if (hashlib.sha256(raw).hexdigest() != man["sha256"]
                    or len(raw) != man["bytes"]):
                raise TransportError(
                    f"chunk {idx} (block {b}) failed SHA-256 manifest "
                    f"check on send {handle['seq']}")
            handle["staged"][b] = payload
            self.stats["chunks"] += 1
            self.stats["wire_bytes"] += man["bytes"]

        def on_retry(attempt_n: int, delay: float, err: BaseException) -> None:
            self.stats["retries"] += 1
            self.emit(
                "migration_retry", seq=handle["seq"], block=int(b),
                chunk=idx, attempt=attempt_n, retries=self.retries,
                delay_s=round(delay, 6), error=repr(err),
                src_replica=handle["src"], dst_replica=handle["dst"])

        try:
            with_retries(
                attempt, retries=self.retries,
                base_delay_s=self.base_delay_s,
                max_delay_s=self.max_delay_s, jitter=0.0,
                retry_on=(TransportError,), on_retry=on_retry)
        except TransportError as e:
            self.stats["dead_transfers"] += 1
            raise TransportDeadError(
                f"transfer {handle['seq']} dead: chunk {idx} (block {b}) "
                f"failed {self.retries + 1} attempts: {e}") from e

    def deliver(self, handle: Dict[str, Any], dst_cache: Any,
                src_ids: Sequence[int], dst_ids: Sequence[int]) -> Any:
        """Write staged blocks into the destination pool at the import's
        block ids, in place: a numpy (stub) pool on the host, a torch
        pool by one indexed copy a leaf from the host payload onto the
        pool's device."""
        pairs = [(int(s), int(d)) for s, d in zip(src_ids, dst_ids)]
        missing = [s for s, _ in pairs if s not in handle["staged"]]
        if missing:
            raise TransportDeadError(
                f"deliver before fetch: blocks {missing} never staged on "
                f"send {handle['seq']}")
        for name in dst_cache:
            leaf = dst_cache[name]
            for j, sub in (enumerate(leaf) if isinstance(leaf, tuple)
                           else ((None, leaf),)):
                self._write_leaf(sub, (name, j), pairs, handle)
        return dst_cache

    @staticmethod
    def _write_leaf(leaf: Any, key: Tuple[str, Optional[int]],
                    pairs: List[Tuple[int, int]],
                    handle: Dict[str, Any]) -> None:
        vals = []
        for s, _d in pairs:
            v = handle["staged"][s][key]
            if isinstance(v, tuple):  # int8 wire payload: dequantize
                q, scale = v
                v = q.float() * scale[..., None]
            vals.append(v)
        idxs = [d for _s, d in pairs]
        if isinstance(leaf, np.ndarray):  # host-only pool
            leaf[:, idxs] = np.stack(
                [np.asarray(v) for v in vals], axis=1).astype(leaf.dtype)
            return
        stacked = torch.stack([torch.as_tensor(v) for v in vals], dim=1)
        leaf[:, torch.as_tensor(idxs, device=leaf.device)] = stacked.to(
            device=leaf.device, dtype=leaf.dtype)
