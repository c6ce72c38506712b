"""Staged ingest engine: reusable page-locked staging buffers and a
background transfer worker (port of ``ddl_tpu/staging.py``).

The inline ingest path pays two hidden costs per window or batch: the
copy to the card runs on the consumer thread, and a window stream holds
its ring slot until the copy has landed.  This module removes both:

- :class:`StagingPool` — shape/dtype-keyed recycled host buffers,
  page-locked where the ingestor feeds a card (``torch.empty(...,
  pin_memory=True)``, handed out as numpy views).  A staging copy lands
  in a pooled buffer; the buffer returns to the pool once the copy to the
  card sourcing it has completed, checked by a deferred non-blocking
  sweep over its CUDA event, never a blocking wait
  (``staging.pool_hits`` / ``staging.pool_misses``).
- :class:`TransferExecutor` — ONE background worker draining a bounded
  queue of copy→transfer jobs, so the slot→staging copy and the transfer
  overlap the caller's compute.  Each job yields a
  :class:`StagedTransfer` with two completion edges: ``copy_done`` (the
  job no longer reads the ring slot: the consumer may release it early)
  and ``ready`` (the value can be popped).
- **The alias route** (``DDL_TORCH_SHM_STAGING``, on by default): where
  the slot itself is page-locked — a THREAD ring's pinned slots, or a
  shared-memory ring the consumer registered with ``cudaHostRegister`` —
  the transfer sources the slot directly, with no staging copy, and
  ``copy_done`` fires once the copy's CUDA event has.  The window then
  crosses host→device once, by DMA out of the slot the producer wrote.

A job's transfer runs on whichever thread claims it (the worker, or a
consumer stealing the oldest job), and a thread's current CUDA stream is
the default stream: the transfer functions the ingestor hands in
(``DeviceIngestor.put_window``, ``batch_transfer_fn``) enter the
ingestor's side stream explicitly and record the event on it.

``DDL_TORCH_STAGED=0`` disables the engine: every consumer takes the
inline path.  Counters and timers: ``staging.pool_hits``,
``staging.pool_misses``, ``staging.pool_alias_drops``,
``staging.alias_windows``, ``staging.alias_fallbacks``,
``staging.retries``, ``staging.inline_fallbacks``,
``integrity.staging_verify_failures``, ``ingest.stage_copy``,
``ingest.transfer``, ``ingest.stall``; gauges ``staging.inflight`` and
``staging.queue_depth``.  Fault sites (:mod:`ddl_tpu_torch.faults`):
``staging.copy`` before each staging copy, ``staging.transfer`` before
each transfer attempt.  Spans (:mod:`ddl_tpu_torch.obs`):
``staging.copy`` and ``staging.transfer``, keyed on the job's window;
each transfer attempt runs under ``profiling.annotate(
"ddl.staging_transfer")`` with the window as the thread's span context,
so the nested ``ingest.transfer`` span keys on it too.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from ddl_tpu_torch import envspec, integrity
from ddl_tpu_torch.concurrency import named_condition, named_lock
from ddl_tpu_torch.exceptions import (
    IntegrityError,
    ShutdownRequested,
    StallTimeoutError,
)
from ddl_tpu_torch.faults import fault_point
from ddl_tpu_torch.obs import spans as obs_spans
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
from ddl_tpu_torch.utils import value_ready, wait_value

logger = logging.getLogger("ddl_tpu_torch")

# The registered defaults of the three staging knobs.  The envspec table
# states them as literals (envspec cannot import this module: faults and
# obs read envspec while this module imports them);
# tests/test_torch_api_surface.py holds the two equal.

#: Per-(shape, dtype) cap on retained free buffers
#: (``DDL_TORCH_STAGING_POOL_CAP``): the pool bounds worst-case host
#: memory.
DEFAULT_POOL_CAP = 8

#: Bounded executor queue depth (``DDL_TORCH_STAGING_QUEUE``):
#: backpressure instead of unbounded host memory when producers outrun
#: the link.
DEFAULT_QUEUE_DEPTH = 4

#: Bounded retries per staged job phase before the inline fallback
#: (``DDL_TORCH_STAGING_RETRIES``).
DEFAULT_MAX_RETRIES = 2

#: Bounded retries' exponential backoff, base and cap: a persistently
#: failing link must not turn each window into a minutes-long stall
#: before the inline fallback engages.
_RETRY_BACKOFF_BASE_S = 0.05
_RETRY_BACKOFF_CAP_S = 1.0


def staged_enabled(override: Optional[bool] = None) -> bool:
    """The ``DDL_TORCH_STAGED`` gate (default ON; ``0`` = inline path)."""
    return envspec.flag("DDL_TORCH_STAGED", override)


def shm_staging_enabled(override: Optional[bool] = None) -> bool:
    """The ``DDL_TORCH_SHM_STAGING`` gate (default ON): staged window-
    stream jobs may source a page-locked ring slot directly (the alias
    route).  ``0`` restores the copying pool everywhere."""
    return envspec.flag("DDL_TORCH_SHM_STAGING", override)


def _flat_u8(arr: np.ndarray) -> Optional[np.ndarray]:
    """Flat uint8 alias of an array; None when the layout allows none."""
    try:
        return arr.reshape(-1).view(np.uint8)
    except (ValueError, AttributeError):
        return None


class StagingPool:
    """Thread-safe pool of reusable host staging buffers.

    ``acquire`` hands out a buffer of exactly (shape, dtype) — recycled
    when one is free (``staging.pool_hits``), freshly allocated otherwise
    (``staging.pool_misses``), page-locked under ``pin_memory``.  Callers
    return buffers directly (:meth:`release`) or deferred against an
    in-flight transfer (:meth:`recycle_when_ready` + :meth:`sweep`).
    """

    def __init__(self, metrics: Optional[Metrics] = None,
                 max_per_key: Optional[int] = None,
                 pin_memory: bool = False):
        self.metrics = metrics or default_metrics()
        self.max_per_key = (
            envspec.get("DDL_TORCH_STAGING_POOL_CAP")
            if max_per_key is None else max_per_key
        )
        self.pin_memory = pin_memory
        self._lock = named_lock("staging.pool")
        # At most max_per_key free buffers per geometry, and a run's
        # geometries are a small closed set: bounded by construction.
        self._free: Dict[Tuple[Tuple[int, ...], Any], List[np.ndarray]] = {}
        #: FIFO of (transfer to poll, buffer, dispatch timestamp).
        self._inflight: Deque[Tuple[Any, np.ndarray, float]] = (
            collections.deque()
        )
        #: (address, shape, dtype) of buffers PROVEN copied (not aliased)
        #: by a transfer: skips the per-transfer alias check.
        self._copied_keys: set = set()

    def _allocate(self, shape: Tuple[int, ...], dtype: np.dtype) -> np.ndarray:
        if not self.pin_memory:
            return np.empty(shape, dtype)
        import torch

        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        # The numpy view keeps its page-locked tensor alive.
        return torch.empty(shape, dtype=tdtype, pin_memory=True).numpy()

    def acquire(self, shape: Tuple[int, ...], dtype: Any) -> np.ndarray:
        key = (tuple(shape), np.dtype(dtype))
        with self._lock:
            free = self._free.get(key)
            buf = free.pop() if free else None
        if buf is not None:
            self.metrics.incr("staging.pool_hits")
            return buf
        self.metrics.incr("staging.pool_misses")
        return self._allocate(*key)

    def set_max_per_key(self, max_per_key: int) -> None:
        """Retune the per-geometry free-list cap live (:mod:`ddl_tpu_torch.
        tune`).  A shrink trims each free list at once, so a revert
        returns memory; a growth lets later releases keep more."""
        cap = max(1, int(max_per_key))
        with self._lock:
            self.max_per_key = cap
            for free in self._free.values():
                del free[cap:]

    def release(self, buf: np.ndarray) -> None:
        """Return a buffer nothing references anymore."""
        key = (buf.shape, buf.dtype)
        with self._lock:
            free = self._free.setdefault(key, [])
            if len(free) < self.max_per_key:
                free.append(buf)

    def recycle_when_ready(self, buf: np.ndarray, dev: Any) -> None:
        """Queue ``buf`` for recycling once ``dev``'s transfer completes.

        Non-blocking: a later :meth:`sweep` recycles it.  A buffer the
        transfer ALIASED into its result (a CPU "device" value living in
        the staging memory) is dropped instead, counted in
        ``staging.pool_alias_drops``: reuse would corrupt the value.
        """
        key = (buf.ctypes.data, buf.shape, buf.dtype)
        with self._lock:
            known_copied = key in self._copied_keys
        if not known_copied:
            if _may_alias(dev, buf):
                self.metrics.incr("staging.pool_alias_drops")
                return
            # Only the safe verdict is cached: an address that once
            # aliased may be freed and reused, so it is checked again.
            with self._lock:
                if len(self._copied_keys) > 4096:
                    self._copied_keys.clear()
                self._copied_keys.add(key)
        with self._lock:
            self._inflight.append((dev, buf, time.perf_counter()))

    def sweep(self, block: bool = False) -> int:
        """Recycle the FIFO prefix of in-flight buffers whose transfer
        has completed; with ``block=True`` (shutdown, flush) wait for all
        of them.  Returns the number recycled.  The dispatch→ready span
        accumulates into ``ingest.transfer`` (an upper bound: the sweep
        cadence adds slack)."""
        if not block and len(self._inflight) < 2:
            # Amortised fast path: a lone in-flight transfer rides until
            # the next submission; the pool cap absorbs the lag.
            return 0
        done = 0
        while True:
            with self._lock:
                if not self._inflight:
                    break
                dev, buf, t0 = self._inflight[0]
                if not block and not _is_ready(dev):
                    break
                self._inflight.popleft()
            if block:
                _block_ready(dev)
            self.metrics.add_time("ingest.transfer", time.perf_counter() - t0)
            self.release(buf)
            done += 1
        with self._lock:
            depth = len(self._inflight)
        self.metrics.set_gauge("staging.inflight", float(depth))
        return done

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "free_buffers": float(sum(len(v) for v in self._free.values())),
                "inflight": float(len(self._inflight)),
            }


def _host_arrays(dev: Any) -> List[Any]:
    """The arrays a transfer result holds: a ``Transfer``'s value, a
    ``ShardedArray``'s shards, a tuple's members, or the value itself."""
    dev = getattr(dev, "value", dev)
    if dev is None:
        return []
    if isinstance(dev, (tuple, list)):
        return [a for d in dev for a in _host_arrays(d)]
    shards = getattr(dev, "shards", None)
    if shards is not None:
        return [s.data for s in shards]
    return [dev]


def _faulted_transfer(job: Any, src: np.ndarray) -> Any:
    """One attempt of a job's transfer, behind the ``staging.transfer``
    fault site (a failure or a delay, retried like a real one), under the
    ``ddl.staging_transfer`` range with the job's window as this thread's
    span context (the attempt runs on whichever thread claimed it)."""
    from ddl_tpu_torch.profiling import annotate

    fault_point("staging.transfer")
    obs_spans.set_window(*(job.span_key or (None, None)))
    try:
        with annotate("ddl.staging_transfer"):
            return job.transfer(src)
    finally:
        obs_spans.clear_window()


def _may_alias(dev: Any, buf: np.ndarray) -> bool:
    """Does any array of ``dev`` live inside ``buf``'s memory?

    A copy to a card never does; a CPU tensor or numpy array does when
    its data pointer lies in the buffer (a "transfer" that wrapped the
    host memory instead of copying it).  Anything unprovable counts as
    aliasing: dropping a recyclable buffer costs one allocation,
    recycling an aliased one corrupts served data.
    """
    import torch

    lo = buf.ctypes.data
    hi = lo + buf.nbytes
    for arr in _host_arrays(dev):
        if isinstance(arr, torch.Tensor):
            if arr.device.type != "cpu":
                continue
            ptr = arr.data_ptr()
        elif isinstance(arr, np.ndarray):
            ptr = arr.ctypes.data
        else:
            return True
        if lo <= ptr < hi:
            return True
    return False


def _is_ready(dev: Any) -> bool:
    """Has ``dev``'s transfer completed?  Its CUDA event's ``query()``; a
    transfer without an event (the CPU) finished when it returned."""
    return value_ready(getattr(dev, "done", None), default=True)


def _block_ready(dev: Any) -> None:
    wait_value(getattr(dev, "done", None))


class StagedTransfer:
    """Handle for one staged copy→transfer job.

    ``copy_done`` fires when the job no longer reads the caller's source
    (a ring-slot view), so the slot may be released early; ``ready``
    when the value can be popped with :meth:`result`.  ``salvage`` holds
    a verified host copy of the window when the transfer exhausted its
    retries, so the consumer can redo it down the inline path — the
    failure costs latency, never data.
    """

    __slots__ = ("copy_done", "ready", "error", "salvage", "_value", "_job")

    def __init__(self) -> None:
        self.copy_done = threading.Event()
        self.ready = threading.Event()
        self.error: Optional[BaseException] = None
        self.salvage: Optional[np.ndarray] = None
        self._value: Any = None
        self._job: Any = None  # back-ref for work stealing

    def result(self, timeout_s: Optional[float] = None) -> Any:
        """The transfer's value; raises the job's error (e.g.
        :class:`ShutdownRequested` when the executor closed mid-queue)."""
        if not self.ready.wait(timeout_s):
            raise StallTimeoutError(
                f"staged transfer not ready within {timeout_s}s"
            )
        if self.error is not None:
            raise self.error
        return self._value

    @property
    def worker_executed(self) -> bool:
        """Did the background worker (vs a stealing consumer) run this?"""
        return bool(self._job is not None and self._job.worker)


#: A transfer callable: staging buffer (or slot view) -> (the consumer's
#: value, the transfer whose ``done`` event gates recycling).
TransferFn = Callable[[np.ndarray], Tuple[Any, Any]]


class _Job:
    __slots__ = ("handle", "src", "transfer", "expected_crc", "claimed",
                 "worker", "alias_src", "span_key")

    def __init__(self, handle: StagedTransfer, src: np.ndarray,
                 transfer: TransferFn, expected_crc: Optional[int] = None,
                 alias_src: bool = False,
                 span_key: Optional[Tuple[int, int]] = None):
        self.handle = handle
        #: The window's ``(producer_idx, seq)``: what its spans key on.
        self.span_key = span_key
        self.src = src
        self.transfer = transfer
        #: The committed payload CRC: the staging copy is verified against
        #: it before the slot may be released (the pipeline's second
        #: integrity check).
        self.expected_crc = expected_crc
        #: The alias route: the transfer sources ``src`` (a page-locked
        #: slot) directly, and ``copy_done`` waits for its event.
        self.alias_src = alias_src
        self.claimed = False
        #: True when the background worker (not a stealing consumer) ran
        #: the job.
        self.worker = False


class TransferExecutor:
    """Background worker + work stealing for copy→transfer jobs.

    One worker thread drains a bounded deque from the NEWEST end; a
    consumer that needs a job's result now steals it from the OLDEST end
    and runs it on its own thread (:meth:`complete`).  The opposed ends
    keep the two off each other's job: the consumer's path costs what the
    inline path costs, and whatever the worker finishes is overlap.  The
    bound backpressures :meth:`submit` instead of growing host memory
    when producers outrun the link.
    """

    def __init__(self, pool: StagingPool, metrics: Optional[Metrics] = None,
                 max_queue: Optional[int] = None):
        self.pool = pool
        self.metrics = metrics or default_metrics()
        depth = (envspec.get("DDL_TORCH_STAGING_QUEUE")
                 if max_queue is None else max_queue)
        self._max_queue = max(1, depth)
        self._max_retries = envspec.get("DDL_TORCH_STAGING_RETRIES")
        #: Set when a job exhausted its retries: later windows take the
        #: inline path (``StagedIngestEngine.faulted``).
        self.faulted = False
        #: Latched once a transfer PROVED it wraps host memory instead of
        #: copying it: later alias jobs take the copying pool.
        self.alias_unsafe = False
        self._dq: Deque[_Job] = collections.deque()
        self._cv = named_condition("staging.executor.cv")
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        #: The job the worker is executing (single writer) — what
        #: flush_copies waits on.
        self._active: Optional[_Job] = None
        #: Queue depth at which the worker takes a job (from the newest
        #: end): 2 leaves the oldest for the consumer's steal.  Clamped to
        #: max_queue, or a bound of 1 would deadlock submit against a
        #: worker that never drains.
        self.worker_min_depth = min(2, self._max_queue)

    def set_max_queue(self, max_queue: int) -> None:
        """Retune the submission-queue bound live (:mod:`ddl_tpu_torch.
        tune`): re-clamps ``worker_min_depth`` to the new bound and wakes
        every waiter, so a submitter blocked on the old bound re-checks."""
        with self._cv:
            self._max_queue = max(1, int(max_queue))
            self.worker_min_depth = min(self.worker_min_depth,
                                        self._max_queue)
            self._cv.notify_all()

    def submit(self, src: np.ndarray, transfer: TransferFn,
               expected_crc: Optional[int] = None,
               alias_src: bool = False,
               span_key: Optional[Tuple[int, int]] = None) -> StagedTransfer:
        """Enqueue one job: copy ``src`` into a pooled buffer, then run
        ``transfer`` on it.  ``src`` may be a live ring-slot view: the
        caller keeps the slot until ``handle.copy_done``.
        ``expected_crc`` verifies the copy before that release.
        ``alias_src=True`` skips the copy: the transfer sources ``src``
        and ``copy_done`` fires at transfer completion (ignored once
        ``alias_unsafe`` latched).  ``span_key`` is the window's
        ``(producer_idx, seq)`` for its spans.  Blocks while the queue is
        full."""
        handle = StagedTransfer()
        job = _Job(handle, src, transfer, expected_crc,
                   alias_src=alias_src and not self.alias_unsafe,
                   span_key=span_key)
        handle._job = job
        with self._cv:
            if self._closed:
                raise ShutdownRequested("transfer executor is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="ddl-torch-staging", daemon=True
                )
                self._thread.start()
            while len(self._dq) >= self._max_queue and not self._closed:
                self._cv.wait(0.5)
            if self._closed:
                raise ShutdownRequested("transfer executor is closed")
            self._dq.append(job)
            depth = len(self._dq)
            if depth >= self.worker_min_depth:
                self._cv.notify_all()
        self.metrics.set_gauge("staging.queue_depth", float(depth))
        return handle

    def complete(self, handle: StagedTransfer,
                 timeout_s: Optional[float] = None) -> Any:
        """The handle's result, stealing its job if still unclaimed: an
        unstarted job runs here; a worker-claimed one is a genuine wait,
        counted into ``ingest.stall``."""
        job = handle._job
        if job is not None and self._claim(job):
            self._execute(job)
            # The stealing thread recycles too: where the consumer steals
            # every job, a worker-only sweep would never run.
            self.pool.sweep()
            return handle.result(timeout_s)
        with self.metrics.timed("ingest.stall"):
            return handle.result(timeout_s)

    def flush_copies(self, timeout_s: float = 30.0) -> None:
        """Force every submitted job past its read of the source: the
        slot-safety barrier before releasing a slot queued jobs may still
        view.  Unclaimed jobs run here; the worker's active job is waited
        on through its ``copy_done``."""
        while True:
            with self._cv:
                job = self._dq.popleft() if self._dq else None
            if job is None:
                break
            if self._claim(job):
                self._execute(job)
        active = self._active
        if active is not None and not active.handle.copy_done.wait(timeout_s):
            # A barrier that silently failed would let the caller release
            # a slot the worker still reads: corruption, not delay.
            raise StallTimeoutError(
                f"staging copy still in flight after {timeout_s}s; "
                "cannot safely release the source slot"
            )

    def has_capacity(self) -> bool:
        """Would :meth:`submit` accept a job without blocking now?"""
        return len(self._dq) < self._max_queue

    def _claim(self, job: _Job) -> bool:
        """Atomically take ownership of a queued job (and unqueue it)."""
        with self._cv:
            if job.claimed:
                return False
            job.claimed = True
            try:
                self._dq.remove(job)
                if len(self._dq) == self._max_queue - 1:
                    self._cv.notify_all()  # freed a full queue
            except ValueError:
                pass  # already popped by the worker
            return True

    def close(self) -> None:
        """Stop the worker; pending jobs fail with ShutdownRequested.
        Idempotent.  Completed transfers' buffers are swept back
        (blocking), so a closed executor leaks nothing."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            t = self._thread
            self._cv.notify_all()
        if t is not None:
            t.join(timeout=30.0)
        while True:
            with self._cv:
                job = self._dq.popleft() if self._dq else None
            if job is None:
                break
            if not self._claim(job):
                continue
            job.handle.error = ShutdownRequested(
                "transfer executor closed mid-queue"
            )
            job.handle.copy_done.set()
            job.handle.ready.set()
        self.pool.sweep(block=True)

    @property
    def closed(self) -> bool:
        return self._closed

    # -- execution ---------------------------------------------------------

    def _retrying(self, phase: str, fn):
        """Run one job phase with bounded exponential-backoff retries;
        exhaustion marks the executor ``faulted`` and re-raises for the
        caller's salvage path.  Shutdown signals are never retried."""
        delay = _RETRY_BACKOFF_BASE_S
        for attempt in range(self._max_retries + 1):
            try:
                return fn()
            except (ShutdownRequested, KeyboardInterrupt):
                raise
            except Exception as e:
                if attempt >= self._max_retries or self._closed:
                    self.faulted = True
                    raise
                self.metrics.incr("staging.retries")
                logger.warning(
                    "staged %s failed (%s: %s) — retry %d/%d after %.2fs",
                    phase, type(e).__name__, e, attempt + 1,
                    self._max_retries, delay,
                )
                time.sleep(delay)
                delay = min(delay * 2, _RETRY_BACKOFF_CAP_S)

    def _execute(self, job: _Job) -> None:
        """Run one claimed job to completion (worker or stealing thread)."""
        handle = job.handle
        key = job.span_key or (None, None)

        def copy_phase():
            t0 = time.perf_counter()
            fault_point("staging.copy", view=_flat_u8(job.src))
            np.copyto(buf, job.src, casting="no")
            if job.expected_crc is not None:
                # Second integrity check: the slot is still held, so a
                # torn or overwritten copy is caught BEFORE the early
                # release (a retry copies again from the slot).
                flat = _flat_u8(buf)
                got = integrity.window_crc(flat) if flat is not None else None
                if got is not None and got != job.expected_crc:
                    self.metrics.incr("integrity.staging_verify_failures")
                    raise IntegrityError(
                        f"staging copy crc32 0x{got:08x} != committed "
                        f"0x{job.expected_crc:08x} (torn slot read)"
                    )
            self.metrics.add_time("ingest.stage_copy", time.perf_counter() - t0)
            obs_spans.record("staging.copy", key[0], key[1], t0)

        try:
            if job.alias_src:
                handle._value = self._execute_alias(job)
                return
            buf = self.pool.acquire(job.src.shape, job.src.dtype)
            self._retrying("copy", copy_phase)
            handle.copy_done.set()  # the slot may be released now
            try:
                span_t0 = obs_spans.t0()
                value, base = self._retrying(
                    "transfer", lambda: _faulted_transfer(job, buf))
                obs_spans.record("staging.transfer", key[0], key[1], span_t0)
            except (ShutdownRequested, KeyboardInterrupt):
                raise
            except Exception:
                # The copy landed (and verified): keep it, so the consumer
                # can redo the window on the inline path.
                handle.salvage = buf
                raise
            self.pool.recycle_when_ready(buf, base)
            handle._value = value
        except Exception as e:
            # ShutdownRequested included: the consumer's result()
            # re-raises it; swallowing it would hang result() forever.
            handle.error = e
        finally:
            handle.copy_done.set()
            handle.ready.set()

    def _execute_alias(self, job: _Job) -> Any:
        """Run one alias job: the transfer sources the page-locked slot
        directly, with no staging copy.

        ``copy_done`` (set by ``_execute``'s ``finally``) may fire only
        once nothing reads the slot: after the transfer's CUDA event has
        fired, or after the copying-pool redo where the transfer's result
        turned out to wrap the slot's memory (checked per transfer; the
        check firing latches ``alias_unsafe``).  The event wait runs on
        the worker, or on a consumer that needed the value now anyway.
        """

        def salvage_slot(buf: Optional[np.ndarray] = None) -> None:
            """Terminal failure with the slot STILL held: keep a host copy
            of the window for ``complete_or_salvage``'s inline redo."""
            if buf is None:
                buf = self.pool.acquire(job.src.shape, job.src.dtype)
                np.copyto(buf, job.src, casting="no")
            job.handle.salvage = buf

        t0 = time.perf_counter()
        try:
            value, base = self._retrying(
                "transfer", lambda: _faulted_transfer(job, job.src))
        except (ShutdownRequested, KeyboardInterrupt):
            raise
        except Exception:
            salvage_slot()
            raise
        if _may_alias(base, job.src):
            # The result lives in the slot's memory: releasing the slot
            # would let the producer overwrite it.  Redo through the
            # copying pool and stop submitting alias jobs.
            self.alias_unsafe = True
            self.metrics.incr("staging.alias_fallbacks")
            logger.warning(
                "alias staging: the transfer wraps host memory; falling "
                "back to the copying staging pool"
            )
            buf = self.pool.acquire(job.src.shape, job.src.dtype)
            np.copyto(buf, job.src, casting="no")
            try:
                value, base = self._retrying(
                    "transfer", lambda: _faulted_transfer(job, buf))
            except (ShutdownRequested, KeyboardInterrupt):
                raise
            except Exception:
                salvage_slot(buf)
                raise
            self.pool.recycle_when_ready(buf, base)
            return value
        _block_ready(base)
        self.metrics.add_time("ingest.transfer", time.perf_counter() - t0)
        key = job.span_key or (None, None)
        obs_spans.record("staging.transfer", key[0], key[1], t0)
        self.metrics.incr("staging.alias_windows")
        return value

    def _run(self) -> None:
        while True:
            with self._cv:
                # Take work only at worker_min_depth, from the NEWEST end:
                # the oldest job is left for the consumer's steal.
                while len(self._dq) < self.worker_min_depth and not self._closed:
                    self._cv.wait(0.5)
                if self._closed:
                    break
                job = self._dq.pop()
                # Published under the same lock as the pop: a live job is
                # always visible in the deque or in _active, so
                # flush_copies cannot miss one about to read a slot.
                self._active = job
                if len(self._dq) == self._max_queue - 1:
                    self._cv.notify_all()  # freed a full queue
            if not self._claim_popped(job):
                self._active = None
                continue
            job.worker = True
            self._execute(job)
            self._active = None
            self.pool.sweep()

    def _claim_popped(self, job: _Job) -> bool:
        """Claim a job the worker already removed from the deque."""
        with self._cv:
            if job.claimed:
                return False
            job.claimed = True
            return True


class StagedIngestEngine:
    """Pool + executor pair owned by one :class:`~ddl_tpu_torch.ingest.
    DeviceIngestor`; ``pin_memory`` page-locks the pool's buffers (an
    ingestor feeding a card)."""

    def __init__(self, metrics: Optional[Metrics] = None,
                 pin_memory: bool = False):
        self.metrics = metrics or default_metrics()
        self.pool = StagingPool(metrics=self.metrics, pin_memory=pin_memory)
        self.executor = TransferExecutor(self.pool, metrics=self.metrics)
        # Adaptive-offload state of PrefetchIterator: here, not on the
        # iterator, because a consumer builds a fresh iterator per epoch.
        self.stolen_streak = 0
        self.direct_left = 0

    @property
    def faulted(self) -> bool:
        """True once a staged job exhausted its retries: every later
        window takes the inline path."""
        return self.executor.faulted

    def complete_or_salvage(self, handle: StagedTransfer,
                            inline_put: Callable[[np.ndarray], Any],
                            timeout_s: Optional[float] = None) -> Any:
        """:meth:`TransferExecutor.complete`, with the fallback: a handle
        whose transfer exhausted its retries (its verified host copy on
        ``handle.salvage``) is redone through ``inline_put``.  Shutdown
        and deadline expiry propagate; errors with nothing to salvage
        re-raise."""
        try:
            return self.executor.complete(handle, timeout_s)
        except (ShutdownRequested, KeyboardInterrupt, StallTimeoutError):
            raise
        except Exception as e:
            if handle.salvage is None:
                raise
            logger.error(
                "staged transfer failed after retries (%s: %s) — falling "
                "back to the inline path", type(e).__name__, e,
            )
            self.metrics.incr("staging.inline_fallbacks")
            return inline_put(handle.salvage)

    def submit(self, src: np.ndarray, transfer: TransferFn,
               expected_crc: Optional[int] = None,
               alias_src: bool = False,
               span_key: Optional[Tuple[int, int]] = None) -> StagedTransfer:
        return self.executor.submit(src, transfer, expected_crc,
                                    alias_src=alias_src, span_key=span_key)

    def close(self) -> None:
        self.executor.close()
