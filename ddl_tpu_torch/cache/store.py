"""The shard cache: a byte-budgeted RAM LRU over a verified disk spill
tier (port of ``ddl_tpu/cache/store.py``).

- **RAM tier** — an LRU of decoded shard arrays under a byte budget.
  Entries are read-only (``writeable=False``), so a reader that shuffled
  a cached array in place would fail loudly instead of corrupting every
  later epoch.
- **Disk spill tier** — write-through: every insert is also persisted
  under ``spill_dir`` (temp file, then ``os.replace``), so a RAM
  eviction is a drop and the tier holds everything decoded so far.  An
  entry is ``<I`` meta length, JSON meta, the payload (optionally through
  a codec), then the ring-slot trailer of :mod:`ddl_tpu_torch.integrity`
  (payload CRC and a digest-derived ``seq``,
  :func:`~ddl_tpu_torch.integrity.blob_seq`).  It is verified on read: a
  corrupt or aliased file is quarantined (renamed aside, counted) and
  reported as a miss, so the caller refetches from source.  The tier
  survives the process, which lets a resumed run warm-start.

An entry file is byte for byte the JAX package's, and the keys
(:class:`CacheKey`) digest to the same hex, so a spill dir written by
one package is served by the other.

Counters ``cache.hits/misses/evictions/spills/spill_hits/
spill_evictions/quarantined`` and gauges ``cache.resident_bytes`` /
``cache.spill_bytes`` land on the store's :class:`Metrics`.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import json
import logging
import os
import struct
import threading
from typing import Callable, Dict, Optional

import numpy as np

from ddl_tpu_torch import integrity, wire
from ddl_tpu_torch.concurrency import named_lock, named_rlock
from ddl_tpu_torch.exceptions import DecodeError
from ddl_tpu_torch.faults import fault_point
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics

logger = logging.getLogger("ddl_tpu_torch")

#: Bump when the key construction or the entry layout changes: old spill
#: dirs stop matching (checkpoint manifests carry it, so a resumed run
#: never adopts a tier written under another schema).
KEY_SCHEMA_VERSION = 1

#: Entry suffix (``<digest>.ddlc`` under the spill dir).
SPILL_SUFFIX = ".ddlc"
#: Quarantined entries become ``<digest>.quarantined`` (kept for a
#: post-mortem, never read again).
QUARANTINE_SUFFIX = ".quarantined"
#: Only the newest this-many quarantined files are kept, so recurring
#: corruption cannot grow the spill dir without bound.
QUARANTINE_KEEP = 4

_META_LEN_FMT = "<I"
_META_LEN_BYTES = struct.calcsize(_META_LEN_FMT)


@dataclasses.dataclass(frozen=True)
class CacheKey:
    """Content-addressed identity of one decoded shard.

    ``source`` is the backend's content fingerprint, not the path, so a
    rewritten shard gets a new key; ``shard`` the shard's path;
    ``reader`` the reader class's qualified name plus every parameter
    that changes the decoded bytes; ``transform`` the reader's
    decode-logic version."""

    source: str
    shard: str
    reader: str
    transform: str = ""

    @functools.cached_property
    def digest(self) -> str:
        """Hex sha256 over the schema version and every key field (the
        JSON, key order sorted and default separators, is the format)."""
        blob = json.dumps(
            {
                "schema": KEY_SCHEMA_VERSION,
                "source": self.source,
                "shard": self.shard,
                "reader": self.reader,
                "transform": self.transform,
            },
            sort_keys=True,
        ).encode()
        return hashlib.sha256(blob).hexdigest()


class CacheStore:
    """Byte-budgeted RAM LRU over an integrity-checked disk spill tier.

    Thread-safe: producer threads, the warmer and the consumer may all
    share one store.  It does not pickle: spawned producers each build
    their own from the ``DDL_TORCH_CACHE*`` environment
    (:func:`ddl_tpu_torch.cache.default_store`), and a deep copy is the
    same store, so THREAD workers share it."""

    def __init__(
        self,
        ram_budget_bytes: int = 256 << 20,
        spill_dir: Optional[str] = None,
        spill_budget_bytes: int = 1 << 30,
        metrics: Optional[Metrics] = None,
        codec: Optional[str] = None,
        codec_level: int = 6,
    ):
        self.ram_budget_bytes = int(ram_budget_bytes)
        self.spill_dir = os.path.abspath(spill_dir) if spill_dir else None
        self.spill_budget_bytes = int(spill_budget_bytes)
        self.metrics = metrics or default_metrics()
        # A lossless codec for disk entries only: the RAM tier stays
        # decoded, so a hit stays a view.  Validated here, not at the
        # first spill.
        self.codec = codec if codec and codec != "none" else None
        if self.codec:
            wire.get_codec(self.codec)
        self.codec_level = int(codec_level)
        # _lock guards the LRU only, so a RAM hit never waits on disk
        # I/O; _spill_lock serialises the disk tier's writes, trims and
        # quarantines.  _lock may be held when _spill_lock is taken (the
        # eviction's spill backstop), never the reverse.
        self._lock = named_rlock("cache.store")
        self._spill_lock = named_lock("cache.store.spill")
        self._ram: "collections.OrderedDict[str, np.ndarray]" = (
            collections.OrderedDict()
        )
        self._ram_bytes = 0
        self._spill_bytes = 0
        if self.spill_dir:
            os.makedirs(self.spill_dir, exist_ok=True)
            # Warm start: adopt whatever an earlier run spilled (keys are
            # content-addressed, so stale files never match).
            self._spill_bytes = self._scan_spill_bytes()
            self.metrics.set_gauge("cache.spill_bytes", self._spill_bytes)

    def _scan_spill_bytes(self) -> int:
        total = 0
        for name in os.listdir(self.spill_dir):
            if name.endswith(SPILL_SUFFIX):
                try:
                    total += os.path.getsize(
                        os.path.join(self.spill_dir, name)
                    )
                except OSError:
                    pass
        return total

    def attach_spill_dir(self, spill_dir: str) -> bool:
        """Late-bind a disk tier onto a RAM-only store (a THREAD resume:
        the loader checkpoint is applied after the shared store exists).
        The directory's entries are adopted.  Refused when a different
        spill dir is already attached: adoption never re-routes a live
        tier."""
        spill_dir = os.path.abspath(spill_dir)
        with self._spill_lock:
            if self.spill_dir is not None:
                return self.spill_dir == spill_dir
            try:
                os.makedirs(spill_dir, exist_ok=True)
            except OSError:
                return False
            self.spill_dir = spill_dir
            self._spill_bytes = self._scan_spill_bytes()
            self.metrics.set_gauge("cache.spill_bytes", self._spill_bytes)
        return True

    def __deepcopy__(self, memo) -> "CacheStore":
        # THREAD channels deep-copy producer functions to stand in for
        # the process boundary; the store is shared process state.
        return self

    # -- public API --------------------------------------------------------

    def get(self, key: CacheKey) -> Optional[np.ndarray]:
        """RAM tier, then disk tier; ``None`` on a miss.  A disk hit is
        verified and promoted into RAM; a corrupt entry is quarantined
        and reported as a miss.  The disk read runs outside the LRU lock
        (entries publish atomically)."""
        digest = key.digest
        with self._lock:
            arr = self._ram.get(digest)
            if arr is not None:
                self._ram.move_to_end(digest)
                self.metrics.incr("cache.hits")
                return arr
        arr = self._disk_get(digest)
        if arr is not None:
            self.metrics.incr("cache.hits")
            self.metrics.incr("cache.spill_hits")
            with self._lock:
                return self._insert(digest, arr, from_disk=True)
        self.metrics.incr("cache.misses")
        return None

    def put(self, key: CacheKey, arr: np.ndarray) -> np.ndarray:
        """Insert ``arr`` under ``key`` and return the stored read-only
        array (use it: every consumer then shares one copy).  The store
        takes ownership: a contiguous ``arr`` is marked read-only in
        place, not copied."""
        digest = key.digest
        with self._lock:
            existing = self._ram.get(digest)
            if existing is not None:
                self._ram.move_to_end(digest)
                return existing
        arr = np.ascontiguousarray(arr)
        arr.setflags(write=False)
        self._spill(digest, arr)
        with self._lock:
            existing = self._ram.get(digest)
            if existing is not None:  # raced another inserter: share theirs
                self._ram.move_to_end(digest)
                return existing
            return self._insert(digest, arr, persisted=True)

    def get_or_load(
        self, key: CacheKey, loader: Callable[[], np.ndarray]
    ) -> np.ndarray:
        """``get``, or on a miss fetch-decode-insert through ``loader``."""
        arr = self.get(key)
        if arr is None:
            arr = self.put(key, loader())
        return arr

    def contains(self, key: CacheKey) -> bool:
        """Tier membership without touching the hit/miss counters (the
        warmer's probe)."""
        digest = key.digest
        with self._lock:
            if digest in self._ram:
                return True
        return bool(
            self.spill_dir and os.path.exists(self._spill_path(digest))
        )

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._ram_bytes

    def stats(self) -> Dict[str, float]:
        """Point-in-time tier sizes (the counters live in ``metrics``)."""
        with self._lock:
            return {
                "entries": float(len(self._ram)),
                "resident_bytes": float(self._ram_bytes),
                "spill_bytes": float(self._spill_bytes),
            }

    def clear(self) -> None:
        """Drop the RAM tier (disk entries stay and re-verify on read)."""
        with self._lock:
            self._ram.clear()
            self._ram_bytes = 0
            self.metrics.set_gauge("cache.resident_bytes", 0)

    # -- RAM tier ----------------------------------------------------------

    def _insert(
        self,
        digest: str,
        arr: np.ndarray,
        from_disk: bool = False,
        persisted: bool = False,
    ) -> np.ndarray:
        # Caller holds _lock.  Re-check residency first: two threads can
        # race a miss on one digest, and a second insert would count its
        # bytes twice.
        existing = self._ram.get(digest)
        if existing is not None:
            self._ram.move_to_end(digest)
            return existing
        arr.setflags(write=False)
        if not from_disk and not persisted:
            self._spill(digest, arr)
        if arr.nbytes > self.ram_budget_bytes:
            return arr  # too big for the RAM tier: disk-only residency
        self._ram[digest] = arr
        self._ram_bytes += arr.nbytes
        self._evict_over_budget()
        self.metrics.set_gauge("cache.resident_bytes", self._ram_bytes)
        return arr

    def _evict_over_budget(self) -> None:
        while self._ram_bytes > self.ram_budget_bytes and len(self._ram) > 1:
            old_digest, old = self._ram.popitem(last=False)
            self._ram_bytes -= old.nbytes
            self.metrics.incr("cache.evictions")
            # Backstop: write-through already persisted the entry unless
            # that spill failed transiently.
            self._spill(old_digest, old)

    # -- disk tier ---------------------------------------------------------

    def _spill_path(self, digest: str) -> str:
        return os.path.join(self.spill_dir or "", digest + SPILL_SUFFIX)

    def _spill(self, digest: str, arr: np.ndarray) -> None:
        if not self.spill_dir:
            return
        path = self._spill_path(digest)
        if os.path.exists(path):
            return  # content-addressed: same digest, same bytes
        meta_d = {
            "schema": KEY_SCHEMA_VERSION,
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
        }
        payload = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
        if self.codec:
            packed = wire.get_codec(self.codec).encode_bytes(
                payload.tobytes(), level=self.codec_level
            )
            payload = np.frombuffer(packed, np.uint8)
            meta_d["codec"] = self.codec
        meta = json.dumps(meta_d).encode()
        off = _META_LEN_BYTES + len(meta)
        total = off + payload.nbytes + integrity.HEADER_BYTES
        if total > self.spill_budget_bytes:
            # Bigger than the whole tier: writing it would only make the
            # trim evict every valid entry and the new file itself.
            logger.warning(
                "cache: entry %s… (%d bytes) exceeds the spill budget "
                "(%d); not persisted",
                digest[:12], total, self.spill_budget_bytes,
            )
            return
        blob = np.empty(total, np.uint8)
        blob[:_META_LEN_BYTES] = np.frombuffer(
            struct.pack(_META_LEN_FMT, len(meta)), np.uint8
        )
        blob[_META_LEN_BYTES:off] = np.frombuffer(meta, np.uint8)
        blob[off : off + payload.nbytes] = payload
        integrity.write_header(
            blob[off:],
            payload.nbytes,
            seq=integrity.blob_seq(digest),
            producer_idx=0,
            crc=integrity.window_crc(payload),
        )
        # Atomic publish: a crash mid-write leaves only a temp file that
        # no reader matches.
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with self._spill_lock:
            if os.path.exists(path):
                return  # a concurrent insert of the same digest won
            try:
                blob.tofile(tmp)
                os.replace(tmp, path)
            except OSError as e:
                logger.warning(
                    "cache: spill of %s failed: %s", digest[:12], e
                )
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return
            self._spill_bytes += blob.nbytes
            self.metrics.incr("cache.spills")
            self._trim_spill_tier()
            self.metrics.set_gauge("cache.spill_bytes", self._spill_bytes)

    def _trim_spill_tier(self) -> None:
        """Oldest-first disk eviction over budget (caller holds
        ``_spill_lock``)."""
        if not self.spill_dir or self._spill_bytes <= self.spill_budget_bytes:
            return
        entries = []
        for name in os.listdir(self.spill_dir):
            if not name.endswith(SPILL_SUFFIX):
                continue
            p = os.path.join(self.spill_dir, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            entries.append((st.st_mtime_ns, st.st_size, p))
        entries.sort()
        for _, size, p in entries:
            if self._spill_bytes <= self.spill_budget_bytes:
                break
            try:
                os.unlink(p)
            except OSError:
                continue
            self._spill_bytes -= size
            self.metrics.incr("cache.spill_evictions")

    def _disk_get(self, digest: str) -> Optional[np.ndarray]:
        if not self.spill_dir:
            return None
        path = self._spill_path(digest)
        try:
            raw = np.fromfile(path, np.uint8)
        except OSError:
            return None
        # Fault site: flips bytes of the entry just read, as at-rest
        # corruption would.
        fault_point("cache.disk_read", view=raw)
        try:
            if len(raw) < _META_LEN_BYTES:
                raise ValueError("short entry (no meta length)")
            (meta_len,) = struct.unpack(
                _META_LEN_FMT, raw[:_META_LEN_BYTES].tobytes()
            )
            off = _META_LEN_BYTES + meta_len
            payload_bytes = len(raw) - off - integrity.HEADER_BYTES
            if meta_len <= 0 or payload_bytes < 0:
                raise ValueError("truncated entry")
            meta = json.loads(raw[_META_LEN_BYTES:off].tobytes())
            if meta.get("schema") != KEY_SCHEMA_VERSION:
                raise ValueError(f"key-schema {meta.get('schema')} entry")
            err = integrity.verify_window(
                raw[off:],
                payload_bytes,
                expect_seq=integrity.blob_seq(digest),
                expect_producer=0,
            )
            if err:
                raise ValueError(err)
            stored = raw[off : off + payload_bytes]
            if meta.get("codec"):
                # The CRC verified the stored bytes; a codec failure past
                # it quarantines like any corrupt entry.  The decode is
                # bounded by the shape the meta declares.
                dtype = np.dtype(meta["dtype"])
                bound = int(np.prod(meta["shape"])) * dtype.itemsize
                try:
                    stored = np.frombuffer(
                        wire.get_codec(meta["codec"]).decode_bytes(
                            stored.tobytes(), max_output=bound
                        ),
                        np.uint8,
                    )
                except DecodeError as e:
                    raise ValueError(f"codec decode failed: {e}") from e
            arr = stored.view(np.dtype(meta["dtype"])).reshape(meta["shape"])
        except (ValueError, KeyError, TypeError) as e:
            self._quarantine(path, digest, str(e))
            return None
        return arr

    def _quarantine(self, path: str, digest: str, reason: str) -> None:
        """Move a corrupt entry aside and count it; the caller reports a
        miss and the reader refetches from source."""
        logger.warning(
            "cache: quarantining corrupt disk entry %s…: %s",
            digest[:12], reason,
        )
        self.metrics.incr("cache.quarantined")
        with self._spill_lock:
            try:
                size = os.path.getsize(path)
                os.replace(
                    path, path[: -len(SPILL_SUFFIX)] + QUARANTINE_SUFFIX
                )
                self._spill_bytes = max(0, self._spill_bytes - size)
                self.metrics.set_gauge("cache.spill_bytes", self._spill_bytes)
            except OSError:
                pass
            # Keep only the newest QUARANTINE_KEEP post-mortem files: they
            # sit outside the budget's accounting.
            q = []
            for name in os.listdir(self.spill_dir or ""):
                if not name.endswith(QUARANTINE_SUFFIX):
                    continue
                p = os.path.join(self.spill_dir, name)
                try:
                    q.append((os.stat(p).st_mtime_ns, p))
                except OSError:
                    continue
            q.sort()
            for _, p in q[: max(0, len(q) - QUARANTINE_KEEP)]:
                try:
                    os.unlink(p)
                except OSError:
                    pass
