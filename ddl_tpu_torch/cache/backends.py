"""Pluggable storage backends: every shard read goes through one of these
(port of ``ddl_tpu/cache/backends.py``).

:class:`StorageBackend` is the seam between the file-based producers of
:mod:`ddl_tpu_torch.readers` (and the cache tier) and wherever shard
bytes live: a two-method protocol, ``open`` / ``fingerprint``.

- :class:`LocalBackend` — the local filesystem (the default).  Its
  fingerprint is the JAX package's string, character for character, so
  the cache keys (and so a spill dir) are shared by both packages.
- :class:`ThrottledBackend` — wraps another backend with a per-open
  latency and a deterministic transient-failure schedule: a slow, flaky
  source without a network, for the cold-vs-warm A/B and the chaos runs.
- :class:`CodecBackend` — decodes codec-compressed shard files
  (``.zz``/``.gz`` zlib, ``.zst``, ``.lz4``) once per fetch, with the
  ``wire.decode`` fault site.

Transient failures surface as
:class:`~ddl_tpu_torch.exceptions.BackendFetchError`; :func:`open_with_retry`
is the one retry site (bounded attempts, exponential backoff, sleeps
that watch for an abort, the ``backend.fetch`` fault site).  Exhaustion
escalates to :class:`~ddl_tpu_torch.exceptions.IntegrityError`.
"""

from __future__ import annotations

import io
import os
import time
from typing import BinaryIO, Optional, Protocol, runtime_checkable

from ddl_tpu_torch import wire
from ddl_tpu_torch.concurrency import named_lock
from ddl_tpu_torch.exceptions import (
    BackendFetchError,
    DecodeError,
    IntegrityError,
    ShutdownRequested,
)
from ddl_tpu_torch.faults import fault_point


@runtime_checkable
class StorageBackend(Protocol):
    """What the cache and the file-based readers need from a shard store.
    Whole-shard reads are spelled ``open(path).read()`` by callers."""

    def open(self, path: str) -> BinaryIO:
        """Open ``path`` for streaming binary reads (seekable)."""
        ...

    def fingerprint(self, path: str) -> str:
        """A cheap content-version fingerprint for ``path``: cache keys
        embed it, so a rewritten shard never aliases a stale decode."""
        ...


class LocalBackend:
    """The local filesystem (the default)."""

    name = "local"

    def open(self, path: str) -> BinaryIO:
        return open(path, "rb")

    def fingerprint(self, path: str) -> str:
        st = os.stat(path)
        return f"local:{st.st_size}:{st.st_mtime_ns}"


class ThrottledBackend:
    """A backend wrapper simulating a slow, transiently flaky remote store.

    ``latency_s`` sleeps on every ``open``; ``fail_every=N`` makes every
    N-th open raise :class:`BackendFetchError` once (the retry's next
    attempt is a new open and passes) — deterministic, so a test can
    assert exact retry counts.  ``fingerprint`` delegates unchanged: the
    key reflects the content, not the transport in front of it.

    Picklable: the open counter and its lock are per-process state and
    reset on unpickle (and on the deep copy a THREAD worker gets, so
    count a run's fetches on the store's ``cache.*`` counters, not on
    ``opens``)."""

    name = "throttled"

    def __init__(
        self,
        inner: Optional[StorageBackend] = None,
        latency_s: float = 0.0,
        fail_every: int = 0,
    ):
        self.inner = inner or LocalBackend()
        self.latency_s = float(latency_s)
        self.fail_every = int(fail_every)
        self._opens = 0
        self._lock = named_lock("cache.backend")

    def __getstate__(self):
        return {
            "inner": self.inner,
            "latency_s": self.latency_s,
            "fail_every": self.fail_every,
        }

    def __setstate__(self, state):
        self.__init__(**state)

    def _gate(self, path: str) -> None:
        with self._lock:
            self._opens += 1
            n = self._opens
        if self.fail_every and n % self.fail_every == 0:
            raise BackendFetchError(
                f"simulated transient fetch failure for {path!r} "
                f"(open #{n}, fail_every={self.fail_every})"
            )
        if self.latency_s > 0:
            time.sleep(self.latency_s)

    @property
    def opens(self) -> int:
        """Opens this instance observed."""
        with self._lock:
            return self._opens

    def open(self, path: str) -> BinaryIO:
        self._gate(path)
        return self.inner.open(path)

    def fingerprint(self, path: str) -> str:
        return self.inner.fingerprint(path)


#: The codec :class:`CodecBackend` infers from a file's suffix.
CODEC_SUFFIXES = {".zz": "zlib", ".gz": "zlib", ".zst": "zstd", ".lz4": "lz4"}


class CodecBackend:
    """A backend wrapper that decodes codec-compressed shard files.

    ``open(path)`` reads the inner backend's bytes and, when the path
    carries a known codec suffix (``shard_000.npy.zz`` → zlib) or
    ``codec=`` forces one, returns the DECODED bytes as a seekable
    stream, so every reader consumes compressed shards unchanged and the
    decode runs once per fetch.  The decode is bounded (``max_output``);
    a failure raises :class:`BackendFetchError` — the transient type on
    purpose, so a torn object from a flaky store rides
    :func:`open_with_retry`'s retries and only a persistent failure
    escalates.  The ``wire.decode`` fault site fires per attempt.

    ``fingerprint`` appends the codec to the inner fingerprint, so a
    shard recompressed under another codec never aliases its cached
    decode.  Picklable: it carries only names and bounds."""

    name = "codec"

    def __init__(
        self,
        inner: Optional[StorageBackend] = None,
        codec: Optional[str] = None,
        max_output: int = 1 << 31,
    ):
        self.inner = inner or LocalBackend()
        self.codec = codec
        self.max_output = int(max_output)
        if codec:
            wire.get_codec(codec)  # fail at construction, not first shard

    def _codec_for(self, path: str) -> Optional[str]:
        if self.codec:
            return self.codec
        for suffix, name in CODEC_SUFFIXES.items():
            if path.endswith(suffix):
                return name
        return None

    def open(self, path: str) -> BinaryIO:
        name = self._codec_for(path)
        if name is None:
            return self.inner.open(path)
        with self.inner.open(path) as f:
            raw = f.read()
        try:
            fault_point("wire.decode")
            return io.BytesIO(
                wire.get_codec(name).decode_bytes(
                    raw, max_output=self.max_output
                )
            )
        except DecodeError as e:
            raise BackendFetchError(
                f"codec decode of {path!r} failed ({name}): {e}"
            ) from e

    def fingerprint(self, path: str) -> str:
        name = self._codec_for(path)
        inner = self.inner.fingerprint(path)
        return f"{inner}:codec={name}" if name else inner


def open_with_retry(
    backend: StorageBackend,
    path: str,
    retries: int = 3,
    backoff_s: float = 0.05,
    metrics=None,
    should_abort=None,
) -> BinaryIO:
    """Open ``path`` on ``backend`` with bounded retry and exponential
    backoff: the one retry site for shard fetches (cold reads, cache-miss
    refills, warmer prefetches).

    :class:`BackendFetchError` and ``OSError`` retry up to ``retries``
    times after ``backoff_s * 2**attempt`` sleeps, each counted in
    ``cache.backend_retries``; exhaustion counts
    ``cache.backend_failures`` and raises :class:`IntegrityError`.  The
    sleeps poll ``should_abort``, so a closing warmer never serves out a
    backoff schedule (:class:`ShutdownRequested`).  The ``backend.fetch``
    fault site fires before every attempt."""
    attempt = 0
    while True:
        if should_abort is not None and should_abort():
            raise ShutdownRequested(f"fetch of {path!r} aborted")
        try:
            fault_point("backend.fetch", should_abort=should_abort)
            return backend.open(path)
        except (BackendFetchError, OSError) as e:
            attempt += 1
            if metrics is not None:
                metrics.incr("cache.backend_retries")
            if attempt > retries:
                if metrics is not None:
                    metrics.incr("cache.backend_failures")
                raise IntegrityError(
                    f"persistent backend failure fetching {path!r} "
                    f"({attempt} attempts, backend "
                    f"{getattr(backend, 'name', type(backend).__name__)}): {e}"
                ) from e
            delay = backoff_s * (2 ** (attempt - 1))
            deadline = time.monotonic() + delay
            while time.monotonic() < deadline:
                if should_abort is not None and should_abort():
                    raise ShutdownRequested(
                        f"fetch retry backoff for {path!r} aborted"
                    )
                time.sleep(min(0.01, delay))
