"""Consumer API: the distributed dataloader (port of
``ddl_tpu/dataloader.py`` along the slice's paths).

- Batch iteration: ``len(loader)`` is the current producer's
  ``batches_per_window`` (one epoch == one window), ``loader[i]`` the
  column tuple of batch ``i``, ``prefetch()`` the device-batch iterator;
  the user calls ``mark(END_OF_BATCH)`` / ``mark(END_OF_EPOCH)``.
- Window streaming (``windows(lookahead)``): each epoch-window crosses
  to the device as ONE copy straight out of the ring slot, the next
  window's copy already in flight while the caller computes.  Staged
  (the default on the card), a background worker runs the copies and a
  slot returns to its producer as soon as nothing reads it; inline, the
  slot release is deferred onto the copy's event (the release backlog),
  and a fused-step caller can gate it on its consuming step as well
  (:meth:`DistributedDataLoader.gate_release_on`).
- PROCESS mode: the rings are shared-memory rings of spawned producer
  processes.  A loader feeding a card page-locks each one it attaches
  (``cudaHostRegister``) and unlocks it at shutdown, after every copy
  that may read a slot has completed.
- Sharded targets (``sharding=``, ``distribute=``): windows and batches
  land on a mesh of positions, through the ICI fan-out tier or the plain
  route (:class:`~ddl_tpu_torch.ingest.DeviceIngestor`).

Every acquire verifies the window's integrity trailer.  A corrupt head
window is quarantined and replayed: the loader asks its producer (in an
acked envelope) to rewind to that window, discards the quarantined slot
and the stale successors committed behind it, and serves the
re-committed window — byte-identical, exactly once — up to
``DDL_TORCH_MAX_REPLAYS`` attempts; past them, or while a cross-instance
exchange is active (whose rows no local rewind regenerates), it raises
:class:`IntegrityError`.  Counters ``integrity.corrupt_windows``,
``integrity.replays`` and ``integrity.replay_exhausted``; timer
``integrity.replay`` (quarantine to the replayed window).

A wire-encoded producer's windows (:mod:`ddl_tpu_torch.wire`, its
``wire_dtype`` from the handshake) are decoded at this edge into a fresh
host array: counters ``wire.decoded_windows``, ``wire.encoded_bytes``
(slot bytes that traveled) and ``wire.payload_bytes`` (the decoded
bytes served).  A failed decode (the ``wire.decode`` fault site's
``DECODE_FAIL``) is retried once and counted in ``wire.decode_fails``,
then raises :class:`IntegrityError`.  A decoded window is not the slot's
bytes, so a staged stream copies it through the staging pool instead of
taking the alias route.

Observability (:mod:`ddl_tpu_torch.obs`): ``consumer.admission``,
``consumer.acquire``, ``wire.decode``, ``consumer.yield`` and
``consumer.release`` events keyed on each window's ``(producer_idx,
seq)``, the ``consumer.window_latency`` histogram (blocking head
acquires) and, with an admission gate bound (:meth:`bind_admission`),
``consumer.admission_wait``.  PROCESS producers' ObsReports are merged
at every window boundary and at shutdown (:meth:`drain_obs_reports`).
The flight recorder dumps at a corrupt window, an undecodable window and
an exhausted replay.  The acquire runs under
``profiling.annotate("ddl.window_acquire")`` (timer ``consumer.wait``),
its ring wait under ``ddl.ring_wait`` and its CRC check under
``ddl.integrity_verify``.

Loader pools (:mod:`ddl_tpu_torch.cluster`): ``cluster=`` (an
``ElasticCluster``, or a bare ``ClusterSupervisor``) makes the loader
consume whatever :class:`~ddl_tpu_torch.cluster.pool.LoaderPool` the
cluster view publishes.  :meth:`DistributedDataLoader.apply_pool` only
records a pool (it runs on the supervisor's thread); the consumer thread
applies it at the next window boundary.  Every rotation goes through
``_next_target``, the pool's ``next_member``, and a cluster-managed
acquire waits in slices, so a consumer blocked on a ring the view dropped
moves to a survivor at the view change instead of at its ``timeout_s``.
Counter ``consumer.pool_updates``, gauge ``consumer.pool_size``.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ddl_tpu_torch import envspec, integrity, wire
from ddl_tpu_torch.datasetwrapper import ProducerFunctionSkeleton
from ddl_tpu_torch.exceptions import (
    DecodeError,
    DoesNotMatchError,
    IntegrityError,
    LoaderStateError,
    ShutdownRequested,
    StallTimeoutError,
)
from ddl_tpu_torch.faults import fault_point
from ddl_tpu_torch.obs import spans as obs_spans
from ddl_tpu_torch.obs.recorder import flight_dump
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
from ddl_tpu_torch.profiling import annotate
from ddl_tpu_torch.transport.connection import ConsumerConnection
from ddl_tpu_torch.types import Marker, MetaData_Consumer_To_Producer
from ddl_tpu_torch.utils import value_ready, wait_value

logger = logging.getLogger("ddl_tpu_torch")


def _transfer_ready(done: Any) -> bool:
    """Non-blocking completion probe: ``torch.cuda.Event.query()`` over
    the copy event (and, once gated, the consuming step's event).
    Unprobeable values report not-ready; the forced flush still frees
    the slot."""
    return value_ready(done, default=False)


class _CorruptAhead(Exception):
    """Internal: integrity verification failed on a LOOKAHEAD acquire.
    Held slots forbid out-of-FIFO handling, so the stream stops
    deepening; the window re-verifies when it reaches the head."""


class _TargetRevoked(Exception):
    """Internal: the target being acquired left the loader pool (a
    cluster view change dropped its host mid-acquire).  The acquire
    paths apply the published pool and retry on a member; never escapes
    the loader."""


class DistributedDataLoader:
    """Map-style loader over producer window rings.

    Construction performs the consumer half of the handshake: broadcast
    the producer function + batch geometry, gather per-producer window
    specs, attach rings.  The first window is acquired lazily.
    """

    def __init__(
        self,
        data_producer_function: ProducerFunctionSkeleton,
        batch_size: int,
        connection: ConsumerConnection,
        n_epochs: int = 1,
        global_shuffle_fraction_exchange: float = 0.0,
        exchange_method: str = "sendrecv_replace",
        output: str = "torch",
        device: Any = "cuda",
        metrics: Optional[Metrics] = None,
        timeout_s: float = 300.0,
        sharding: Any = None,
        distribute: str = "auto",
        staged: Optional[bool] = None,
        cluster: Any = None,
    ):
        if output not in ("torch", "numpy", "device"):
            raise ValueError(f"output must be torch|numpy|device, got {output!r}")
        self.batch_size = batch_size
        self.n_epochs = n_epochs
        self.connection = connection
        self.output = output
        self.metrics = metrics or default_metrics()
        self.timeout_s = timeout_s
        self._shuffle_fraction = global_shuffle_fraction_exchange
        self._max_replays = envspec.get("DDL_TORCH_MAX_REPLAYS")
        connection.control_metrics = self.metrics
        self._epoch = 0
        self._batches_in_window = 0
        self._served_in_epoch = 0
        self._target = 0  # index into connection.rings, round-robin
        self._cur_slot: Optional[int] = None
        self._cur_array: Optional[np.ndarray] = None
        self._stream_token: Optional[object] = None  # active windows() stream
        self._finalized = False
        self._ingestor = None
        # Yielded stream windows whose slots wait on their copy event:
        # [target, slot, done, wkey] in yield (== per-ring FIFO) order.
        self._release_backlog: list = []
        # The most recently yielded stream window's backlog entry, so
        # gate_release_on can add the consuming step's event to it.
        self._last_stream_entry: Any = None
        self._last_acquired_seq: Optional[int] = None
        self._last_window_key: Any = None
        # Staged windows whose slots were released early (nothing reads
        # them any more) but which no stream has yielded yet: an abandoned
        # stream's lookahead survives here and the next stream serves it
        # first (the break-resume contract, kept under staging).
        self._staged_orphans: list = []
        # Shared-memory rings this loader page-locked (unlocked at
        # shutdown).
        self._page_locked: list = []
        # The loader pool (apply_pool): the APPLIED pool this loader
        # rotates over, None for every ring.  A pool from the cluster's
        # thread waits in _pending_pool until the consumer thread applies
        # it at a window boundary: rotation state has one writer.
        self._pool: Any = None
        self._pool_generation = -1
        self._pending_pool: Any = None
        self._cluster = cluster
        # Multi-tenant admission gate (bind_admission), and the merger of
        # PROCESS producers' ObsReports (built at the first report).
        self._admission: Any = None
        self._obs_merger: Any = None
        # The job's integrity namespace (serve/jobs.py): producers stamp
        # trailer seqs at seq_base + iteration and this consumer expects
        # that slice, so a window leaking across jobs fails verification.
        self._seq_base = int(
            getattr(data_producer_function, "seq_base", 0) or 0)
        if output == "device":
            from ddl_tpu_torch.ingest import DeviceIngestor

            # ``sharding`` (a NamedSharding) lands windows and batches as
            # ShardedArrays over its mesh positions; ``distribute="auto"``
            # takes the ICI fan-out tier on a CUDA mesh and the plain route
            # on the CPU.
            self._ingestor = DeviceIngestor(
                device=device, metrics=self.metrics, sharding=sharding,
                distribute=distribute, staged=staged,
            )

        # -- handshake -----------------------------------------------------
        t0 = time.perf_counter()
        connection.send_metadata(
            MetaData_Consumer_To_Producer(
                data_producer_function=data_producer_function,
                batch_size=batch_size,
                n_epochs=n_epochs,
                global_shuffle_fraction_exchange=global_shuffle_fraction_exchange,
                exchange_method=exchange_method,
            )
        )
        replies = connection.recv_metadata_as_consumer()
        if not replies:
            raise DoesNotMatchError(0, "no producers connected")
        # Per-producer epoch lengths (unequal windows: weighted rotation).
        self._lens = [r.batches_per_window for r in replies]
        self._integrity = all(r.integrity for r in replies)
        # Per producer: slots of an encoded producer are decoded at this
        # edge (_slot_array).
        self._wire_dtypes = [r.wire_dtype or "raw" for r in replies]
        # Commits discarded by quarantine replays, per ring: the logical
        # window number of a slot is its released count minus these.
        self._seq_skew = [0] * len(replies)
        self.splits_per_producer = [tuple(r.splits) for r in replies]
        self.shapes = [tuple(r.shape) for r in replies]
        self.dtypes = [np.dtype(r.dtype) for r in replies]
        rings = connection.attach_rings()
        self.metrics.add_time("consumer.handshake", time.perf_counter() - t0)
        for ring in rings:
            self.metrics.incr(f"transport.rings.{type(ring).__name__}")
        if self._ingestor is not None and self._ingestor.device.type == "cuda":
            self._page_lock(rings)
        # Consume whatever loader pool the cluster view publishes: an
        # ElasticCluster wires the whole ladder, a bare supervisor only
        # the pool.
        if cluster is not None:
            if hasattr(cluster, "attach_loader"):
                cluster.attach_loader(self)
            else:
                cluster.add_listener(
                    lambda _old, new, _dead: self.apply_pool(
                        new.loader_pool()))
                self.apply_pool(cluster.view.loader_pool())

    def _page_lock(self, rings) -> None:
        """Register each attached shared-memory ring's whole mapping with
        the card (once per ring, not per window), so a window's copy is a
        DMA out of its slot.  A failed registration raises."""
        from ddl_tpu_torch.ops import host_register

        for ring in rings:
            if ring.page_locked or not hasattr(ring, "mapping"):
                continue
            host_register.page_lock(ring, self._ingestor.device)
            self._page_locked.append(ring)
            self.metrics.incr("ingest.registered_rings")

    # -- iteration protocol ------------------------------------------------

    @property
    def n_producers(self) -> int:
        return self.connection.n_producers

    @property
    def epoch(self) -> int:
        """Epochs (one window each) completed by ``mark(END_OF_EPOCH)``."""
        return self._epoch

    @property
    def batches_per_window(self) -> int:
        """Epoch length of the CURRENT target producer: with mixed window
        sizes it changes as the rotation advances."""
        return self._lens[self._target]

    def __len__(self) -> int:
        """Epoch length of the CURRENT target producer."""
        return self._lens[self._target]

    def _host_batch(self, idx: int) -> np.ndarray:
        """Zero-copy view of batch ``idx`` in the current window."""
        if not isinstance(idx, (int, np.integer)):
            raise ValueError(f"index must be int, got {type(idx)}")
        if (
            self._cur_array is None
            and self._batches_in_window == 0
            and self._served_in_epoch
        ):
            # This epoch's window was fully served and released; the
            # next window belongs to the next epoch.
            raise IndexError(idx)
        if idx < 0 or idx >= self._lens[self._target]:
            raise IndexError(idx)
        if self._finalized:
            raise LoaderStateError("loader is finalized")
        if self._cur_array is None:
            self._acquire_current()
        start = self.batch_size * idx
        batch = self._cur_array[start : start + self.batch_size]
        self.metrics.incr("consumer.samples", self.batch_size)
        self._served_in_epoch += 1
        return batch

    def __getitem__(self, idx: int) -> Tuple[Any, ...]:
        splits = self.splits_per_producer[self._target]
        if self.output == "device":
            return self._ingestor.put_batch(self._host_batch(idx), splits)
        cols = _split_columns(self._host_batch(idx), splits)
        if self.output == "numpy":
            return cols
        import torch

        # Zero-copy over the ring slot.
        return tuple(torch.from_numpy(c) for c in cols)

    def prefetch(self, depth: Optional[int] = None):
        """Iterate one epoch's device batches with ``depth`` transfers in
        flight (``output="device"`` only).  Each batch is copied out of
        the slot at enqueue time, so lookahead never outlives the slot.
        ``mark()`` stays the caller's job."""
        if self._ingestor is None:
            raise LoaderStateError("prefetch requires output='device'")
        from ddl_tpu_torch.ingest import PrefetchIterator

        splits = self.splits_per_producer[self._target]

        def host_iter():
            for idx in range(self._lens[self._target]):
                yield self._host_batch(idx)

        # A staged ingestor enqueues slot views to the background
        # executor and pops ready device batches; ``put`` serves the
        # inline path and the staged iterator's direct fills.
        return PrefetchIterator(
            host_iter(), lambda b: self._ingestor.put_batch(b, splits), depth,
            ingestor=self._ingestor,
            transfer=self._ingestor.batch_transfer_fn(splits),
        )

    def windows(self, lookahead: int = 1):
        """Stream whole windows onto the device, one per epoch
        (``output="device"``).

        Two disciplines, picked by ``DeviceIngestor.stream_staged``:

        - **Staged** (the default on the card; ``staged=True`` forces it):
          the background executor runs each window's copy.  Where the slot
          is page-locked (a pinned THREAD ring, a registered shared-memory
          ring) the copy to the card sources the slot itself (the alias
          route, ``DDL_TORCH_SHM_STAGING``); elsewhere the window is first
          copied into a pooled staging buffer, whose CRC is verified
          against the trailer's.  Either way the slot returns to its
          producer as soon as nothing reads it — before the window is
          yielded, where the worker got there first.
        - **Inline** (``DDL_TORCH_STAGED=0``, the default on the CPU): the
          copy sources the slot directly.  On CUDA the slot is held until
          the copy event fires, but the HOST never waits for it: windows
          yield as tensors the current stream is ordered after, and slot
          release is gated on a non-blocking event probe (forced only when
          a ring runs out of slots).  On the CPU the window is copied at
          once and its slot released at yield.

        ``lookahead`` (default 1) acquires window k+1 and starts its copy
        before window k is yielded — a NON-BLOCKING try, so producer
        slowness never delays a yield.  Needs ``nslots >= 2`` or several
        producers to take effect.

        Yields tensors of shape ``(batches_per_window, batch_size,
        *features)`` — :class:`~ddl_tpu_torch.parallel.mesh.ShardedArray`
        s of that global shape under a ``sharding`` — and the caller calls
        ``mark(Marker.END_OF_EPOCH)`` after each.  One live stream per
        loader: a new call supersedes the old.
        """
        if self._ingestor is None:
            raise LoaderStateError("windows() requires output='device'")
        from ddl_tpu_torch.staging import StagedTransfer
        from ddl_tpu_torch.utils import wait_value

        ingestor = self._ingestor
        engine = ingestor.engine() if ingestor.stream_staged else None
        rings = self.connection.rings
        held: collections.Counter = collections.Counter()
        # A previous stream's yielded-but-unreleased windows still hold
        # ring slots; count them so drain lookahead skips past them.
        for entry in self._release_backlog:
            held[entry[0]] += 1
        # FIFO of [slot, target, payload, samples, released, wkey] in
        # flight: payload is a Transfer (inline) or a StagedTransfer.
        pending: collections.deque = collections.deque()
        # Generator-local rotation cursor: self._target only advances when
        # a window is yielded, so an abandoned stream needs no rollback
        # (acquisition has no ring side effect; only release does).  It
        # moves only through _next_target.
        cursor = self._target
        token = object()
        self._stream_token = token

        def start_one(timeout_s: float):
            nonlocal cursor
            self._apply_pending_pool()
            cursor = self._next_target(cursor, include=True)
            target = cursor
            with annotate("ddl.window_acquire", self.metrics,
                          timer="consumer.wait"):
                while True:
                    try:
                        try:
                            slot = self._acquire_verified(
                                target, held[target], timeout_s)
                        except _CorruptAhead:
                            if timeout_s <= 0 or not held[target]:
                                raise
                            # A corrupt window behind held slots (deferred
                            # inline releases): free them, so it is the
                            # head, where quarantine runs.
                            self._flush_release_backlog(held, target=target,
                                                        every=True)
                            slot = self._acquire_verified(
                                target, held[target], timeout_s)
                        break
                    except _TargetRevoked:
                        # The target's host left the view mid-acquire:
                        # apply the published pool, retry on a member.
                        self._apply_pending_pool()
                        cursor = self._next_target(cursor, include=True)
                        target = cursor
            ring = rings[target]
            # Window identity: the integrity trailer's (producer_idx, seq).
            wkey = (target + 1, self._last_acquired_seq)
            bpw = self._lens[target]
            served = bpw * self.batch_size
            window = self._slot_array(target, slot)[:served].reshape(
                bpw, self.batch_size, *self.shapes[target][1:]
            )
            if engine is not None and not engine.faulted:
                # The alias route needs a page-locked slot (a copy out of
                # pageable memory would block the host) holding the
                # window's own bytes: a decoded window is a fresh array.
                alias = (ingestor.stream_alias and ring.page_locked
                         and self._wire_dtypes[target] == "raw"
                         and not engine.executor.alias_unsafe)
                # The committed CRC certifies the staging copy when the
                # served rows span the whole payload.
                expected_crc = None
                if (not alias and self._integrity
                        and self._wire_dtypes[target] == "raw"
                        and window.nbytes == ring.slot_payload(slot)):
                    expected_crc = integrity.read_header(
                        ring.slot_view(slot), ring.slot_payload(slot)).crc

                def transfer(buf):
                    t = ingestor.put_window(buf, defer_metrics=True)
                    return t, t

                payload = engine.submit(window, transfer,
                                        expected_crc=expected_crc,
                                        alias_src=alias, span_key=wkey)
            else:
                # The nested transfer and fan-out spans run on this thread
                # and key on the window through this context.
                obs_spans.set_window(*wkey)
                try:
                    payload = ingestor.put_window(window, defer_metrics=True)
                finally:
                    obs_spans.clear_window()
            held[target] += 1
            cursor = self._next_target(cursor)
            return [slot, target, payload, served, False, wkey]

        def release_early():
            """Hand back the slots of pending staged windows nothing reads
            any more, in FIFO order, stopping at the first still read.
            Such a window lives on only in flight or in staging, so it is
            recorded in ``_staged_orphans`` until yielded."""
            for entry in pending:
                slot, target, payload, _served, released = entry[:5]
                if released:
                    continue
                if not isinstance(payload, StagedTransfer):
                    # An inline window holds its slot until yield, and
                    # release order is FIFO.
                    break
                if not payload.copy_done.is_set():
                    break
                rings[target].release(slot)
                obs_spans.mark("consumer.release", *entry[5])
                held[target] -= 1
                entry[4] = True
                self._staged_orphans.append(entry)

        def finish(entry):
            slot, target, payload, served, released, wkey = entry
            if isinstance(payload, StagedTransfer):
                def inline_put(buf):
                    t = ingestor.put_window(buf, defer_metrics=True)
                    wait_value(t.done)  # the salvage buffer is not pooled
                    return t

                # An unstarted job runs here (work stealing); a transfer
                # that exhausted its retries is redone inline from its
                # verified host copy.
                transfer = engine.complete_or_salvage(
                    payload, inline_put, self.timeout_s)
            else:
                transfer = payload
            dev = ingestor.hand_off(transfer)
            self.metrics.incr("ingest.bytes", float(dev.nbytes))
            self.metrics.incr("ingest.windows")
            self.metrics.incr("consumer.windows")
            self.metrics.incr("consumer.samples", served)
            self._last_stream_entry = None
            if released:
                # Yielded after its early release: no longer an orphan.
                if self._staged_orphans and self._staged_orphans[0] is entry:
                    self._staged_orphans.pop(0)
            elif (isinstance(payload, StagedTransfer)
                  or ingestor.window_source_detached()):
                # Nothing reads the slot any more (a completed staged job,
                # or the CPU's immediate copy): hand it back now.
                rings[target].release(slot)
                obs_spans.mark("consumer.release", *wkey)
                held[target] -= 1
            else:
                # Inline on CUDA: the copy still reads the slot.  Defer the
                # release onto its event (_sweep_release_backlog),
                # remembered so a fused-step consumer can gate it on its
                # step as well.
                backlog_entry = [target, slot, transfer.done, wkey]
                self._release_backlog.append(backlog_entry)
                self._last_stream_entry = backlog_entry
            # This window is now SERVED: commit the rotation.
            self._target = self._next_target(target)
            self._last_window_key = wkey
            obs_spans.mark("consumer.yield", *wkey)
            return dev

        # Inherit an abandoned stream's early-released windows: they are,
        # by FIFO construction, exactly the next unserved windows.
        pending.extend(self._staged_orphans)
        if pending:
            cursor = self._next_target(pending[-1][1])

        remaining = self.n_epochs - self._epoch
        for i in range(remaining):
            if self._stream_token is not token:
                raise LoaderStateError(
                    "this windows() stream was superseded by a newer "
                    "windows() call on the same loader; iterate one "
                    "stream at a time"
                )
            if self._finalized:
                break
            # PROCESS producers' ObsReports merge at the window boundary.
            self._drain_obs_once()
            if self._release_backlog:
                self._sweep_release_backlog(held)
            if not pending:
                if held[cursor] >= rings[cursor].nslots:
                    # Every slot of the head ring awaits its gated
                    # release: wait out the oldest deferred one.
                    self._flush_release_backlog(held, target=cursor)
                pending.append(start_one(self.timeout_s))
            if engine is not None:
                # Early releases first: a lower held[cursor] admits a
                # deeper pipeline on the same nslots.
                release_early()
            # Deepen up to `lookahead` extra windows, each a non-blocking
            # try: the first not-yet-committed window ends the round, and
            # so does a full executor queue (deepening never blocks).
            while (
                len(pending) <= lookahead
                and i + len(pending) < remaining
                and not self._finalized
                and held[cursor] < rings[cursor].nslots
                and (engine is None or engine.faulted
                     or engine.executor.has_capacity())
            ):
                if not rings[cursor].poll_drain_ready(held[cursor]):
                    break
                try:
                    pending.append(start_one(0.0))
                except (StallTimeoutError, _CorruptAhead):
                    break
            yield finish(pending.popleft())

    def gate_release_on(self, done: Any) -> None:
        """Fused-step protocol: gate the most recently yielded stream
        window's deferred slot release on the CONSUMING step's
        done-event as well as its copy event.

        ``done`` is a ``torch.cuda.Event`` recorded after the step that
        consumed the window (or a tuple of them).  The non-blocking sweep
        then frees the slot only once both have fired.  A no-op when the
        window's slot was already released at yield (the CPU), and
        consumed by the call: it applies to the last yielded window.
        """
        entry = self._last_stream_entry
        self._last_stream_entry = None
        if entry is None or done is None:
            return
        for e in self._release_backlog:
            if e is entry:
                e[2] = (e[2], done)
                self.metrics.incr("ingest.fused_gated")
                return

    def last_window_key(self) -> Any:
        """Identity ``(producer_idx, seq)`` of the most recently yielded
        stream window (the trainer's consume spans key on it).  None
        before the first yield."""
        return self._last_window_key

    def bind_admission(self, admission: Any) -> None:
        """Attach an admission gate (``None`` unbinds): ``admit(
        timeout_s)`` blocks until this consumer may take its next window
        (raising :class:`StallTimeoutError` on a non-blocking probe,
        ``timeout_s <= 0``, like a window not committed yet),
        ``note_served(nbytes)`` charges the acquired window's bytes, and
        the optional ``note_aborted()`` returns a grant whose acquire
        failed.  Every acquisition passes the gate, and its wait feeds
        the ``consumer.admission_wait`` histogram and the
        ``consumer.admission`` span."""
        self._admission = admission

    # -- cross-process observability ---------------------------------------

    def _obs_reports_possible(self) -> bool:
        """Could this loader's producers ship ObsReports at all: shipping
        enabled and a producer in another process."""
        from ddl_tpu_torch.obs import ship_every
        from ddl_tpu_torch.transport.connection import ThreadChannel

        return ship_every() > 0 and any(
            not isinstance(ch, ThreadChannel)
            for ch in self.connection.channels)

    def drain_obs_reports(self, timeout_s: float = 0.0,
                          wait_for_all: bool = False) -> int:
        """Merge the producers' pending ObsReports into this registry
        under ``producer.<idx>.*``, waiting up to ``timeout_s`` for
        stragglers (a producer's final report races teardown).
        ``wait_for_all`` returns as soon as a report applied after this
        call started has arrived from every producer.  Returns the
        reports applied."""
        import threading

        deadline = time.monotonic() + timeout_s
        waiter = threading.Event()
        start = (self._obs_merger.fence_state()
                 if self._obs_merger is not None else {})
        applied = 0
        while True:
            applied += self._drain_obs_once()
            if wait_for_all and self._obs_merger is not None:
                state = self._obs_merger.fence_state()
                if all(t in state and state[t] != start.get(t)
                       for t in range(self.n_producers)):
                    return applied
            if timeout_s <= 0 or time.monotonic() >= deadline:
                return applied
            waiter.wait(0.02)

    def _drain_obs_once(self) -> int:
        """Route the control channel once (acks to their senders, reports
        to the inbox) and apply every report in the inbox."""
        self.connection.drain_acks()
        applied = 0
        for report in self.connection.take_obs_reports():
            if self._obs_merger is None:
                from ddl_tpu_torch.obs import ReportMerger

                self._obs_merger = ReportMerger(self.metrics, obs_spans.log)
            if self._obs_merger.apply(report):
                applied += 1
        return applied

    # -- progress marks ------------------------------------------------------

    def mark(self, marker: Marker) -> None:
        """Report progress."""
        if marker is Marker.END_OF_BATCH:
            self._batches_in_window += 1
            if self._batches_in_window >= self._lens[self._target]:
                self._batches_in_window = 0
                self._release_current()
                self._advance_to_next_producer()
        elif marker is Marker.END_OF_EPOCH:
            self._served_in_epoch = 0
            if self._batches_in_window:
                # Epoch ended mid-window: discard the partial window so
                # the next epoch starts on a fresh window boundary.
                self._batches_in_window = 0
                self._release_current()
                self._advance_to_next_producer()
            self._epoch += 1
            if self._epoch >= self.n_epochs:
                self.shutdown()
        else:
            raise ValueError(f"unknown marker {marker!r}")

    # -- window rotation and the loader pool ---------------------------------

    def _advance_to_next_producer(self) -> None:
        self._apply_pending_pool()
        self._target = self._next_target(self._target)

    def _next_target(self, t: int, include: bool = False) -> int:
        """The next ACTIVE ring target cyclically after ``t`` (or ``t``
        itself when ``include`` and it is active).  Every rotation goes
        through here, and with a pool applied through its
        :meth:`~ddl_tpu_torch.cluster.pool.LoaderPool.next_member` — one
        rotation rule, so the pool seam cannot be bypassed."""
        if self._pool is None:
            return t % self.n_producers if include else (
                (t + 1) % self.n_producers)
        return self._pool.next_member(t, include=include)

    def _target_revoked(self, target: int) -> bool:
        """True when ``target`` is outside the applied pool or about to be
        dropped by a pending one: the sliced acquire polls this, so a
        consumer blocked on a departed host's ring moves at the view
        change instead of at its full timeout."""
        if self._pool is not None and target not in self._pool:
            return True
        pool = self._pending_pool
        return (pool is not None and pool.generation > self._pool_generation
                and target not in pool)

    def apply_pool(self, pool: Any) -> None:
        """Adopt a published :class:`~ddl_tpu_torch.cluster.pool.LoaderPool`.

        Thread-safe (the cluster supervisor's sweep thread calls it): the
        pool is only RECORDED here; rotation state changes on the
        consumer thread at the next window boundary
        (``_apply_pending_pool``), and a consumer blocked on a ring the
        new pool drops is unblocked by target revocation inside the
        sliced acquire.  Generations at or below the applied one are
        ignored — the epoch fence."""
        cur = self._pending_pool
        if cur is not None and cur.generation >= pool.generation:
            return  # a newer pool is already pending
        if pool.generation <= self._pool_generation:
            return  # stale against what was already applied
        self._pending_pool = pool

    def _apply_pending_pool(self) -> None:
        """The consumer thread's half of :meth:`apply_pool`."""
        pool = self._pending_pool
        if pool is None:
            return
        self._pending_pool = None
        if pool.generation <= self._pool_generation:
            return  # view N never undoes view N+1
        from ddl_tpu_torch.cluster.pool import LoaderPool

        members = tuple(m for m in pool.members if 0 <= m < self.n_producers)
        if not members:
            raise LoaderStateError(
                "loader pool update left no local ring targets "
                f"(pool={pool.members}, rings={self.n_producers})")
        self._pool = LoaderPool(members=members, generation=pool.generation)
        self._pool_generation = pool.generation
        self.metrics.incr("consumer.pool_updates")
        self.metrics.set_gauge("consumer.pool_size", len(members))
        if self._target not in self._pool:
            # The current target's host left: drop a partly served window
            # (its shards moved to the survivors by adoption) and rotate
            # onto the pool.
            self._batches_in_window = 0
            self._release_current()
            self._target = self._next_target(self._target)

    def _slot_array(self, target: int, slot: int) -> np.ndarray:
        """Window array of an acquired slot, shaped for ``target``: a
        zero-copy view of a raw slot, or the consumer-edge decode of an
        encoded one into a fresh array (never a shared scratch: the
        lookahead holds several windows of one target at once).  A failed
        decode is retried once, then raises :class:`IntegrityError`."""
        ring = self.connection.rings[target]
        nbytes = ring.slot_payload(slot)
        if self._wire_dtypes[target] == "raw":
            return (
                ring.slot_view(slot)[:nbytes]
                .view(self.dtypes[target])
                .reshape(self.shapes[target])
            )
        view = ring.slot_view(slot)
        hdr = integrity.read_header(view, nbytes)
        scales = (integrity.read_scales(view, nbytes, hdr.scale_bytes)
                  if hdr.scale_bytes else None)
        span_t0 = obs_spans.t0()
        for attempt in (1, 2):
            try:
                fault_point("wire.decode", view=view[:nbytes])
                # The slot is held while it decodes: no copy of it first.
                dec = wire.decode_window(
                    view[:nbytes], scales, self.shapes[target],
                    self.dtypes[target], hdr.wire_dtype,
                )
                break
            except DecodeError as e:
                self.metrics.incr("wire.decode_fails")
                if attempt == 2:
                    flight_dump("wire.undecodable", producer_idx=target + 1,
                                seq=hdr.seq, metrics=self.metrics,
                                extra={"wire_dtype": hdr.wire_dtype})
                    raise IntegrityError(
                        f"window from producer {target + 1} undecodable "
                        f"after retry ({hdr.wire_dtype} wire): {e}"
                    ) from e
        obs_spans.record("wire.decode", target + 1, hdr.seq, span_t0)
        self.metrics.incr("wire.decoded_windows")
        self.metrics.incr("wire.encoded_bytes",
                          float(nbytes + hdr.scale_bytes))
        self.metrics.incr("wire.payload_bytes", float(dec.nbytes))
        return dec

    # -- deferred (event-gated) slot release -------------------------------

    def _sweep_release_backlog(self, held=None) -> None:
        """Release yielded stream windows whose copies (and gating steps)
        have COMPLETED, in per-ring FIFO order — a not-yet-ready entry
        blocks only later entries of the same ring."""
        blocked: set = set()
        remaining = []
        for entry in self._release_backlog:
            target, slot, done = entry[:3]
            if target not in blocked and _transfer_ready(done):
                self.connection.rings[target].release(slot)
                obs_spans.mark("consumer.release", *entry[3])
                if held is not None:
                    held[target] -= 1
            else:
                blocked.add(target)
                remaining.append(entry)
        self._release_backlog = remaining

    def _flush_release_backlog(self, held=None, target=None,
                               every: bool = False) -> None:
        """BLOCKING release of backlog entries: all of them (teardown),
        only the oldest entry of ``target`` (a ring out of free slots),
        or, ``every``, all of ``target``'s.  The wait is accounted as
        ``ingest.release_wait``."""
        remaining = []
        done_one = False
        for entry in self._release_backlog:
            t, slot, done = entry[:3]
            if (done_one and not every) or (target is not None
                                            and t != target):
                remaining.append(entry)
                continue
            with self.metrics.timed("ingest.release_wait"):
                wait_value(done)
            self.connection.rings[t].release(slot)
            obs_spans.mark("consumer.release", *entry[3])
            if held is not None:
                held[t] -= 1
            if target is not None:
                done_one = True
        self._release_backlog = remaining

    # -- end-to-end integrity ----------------------------------------------

    def _expected_seq(self, target: int, ahead: int) -> int:
        """Logical window number of the slot ``acquire_drain_ahead(ahead)``
        returns on ``target``: released count plus lookahead, minus the
        commits past quarantine replays discarded, offset into the job's
        integrity namespace (``seq_base``)."""
        ring = self.connection.rings[target]
        return (self._seq_base + int(ring.stats()["released"]) + ahead
                - self._seq_skew[target])

    def _verify_slot(self, target: int, slot: int, seq: int) -> Optional[str]:
        ring = self.connection.rings[target]
        return integrity.verify_window(
            ring.slot_view(slot), ring.slot_payload(slot),
            expect_seq=seq, expect_producer=target + 1,
        )

    def _acquire_verified(self, target: int, ahead: int, timeout_s: float) -> int:
        """Acquire the next committed slot on ``target``, integrity-
        verified, behind the admission gate when one is bound.  Admission
        runs first (no ring wait before the grant) and spends from the
        same ``timeout_s``; a grant whose acquire fails is returned
        through ``note_aborted``."""
        if self._admission is None:
            return self._acquire_slot_verified(target, ahead, timeout_s)
        t_admit = time.monotonic()
        span_t0 = obs_spans.t0()
        self._admission.admit(timeout_s)
        admit_wait = time.monotonic() - t_admit
        if timeout_s > 0:
            timeout_s = max(0.0, timeout_s - admit_wait)
        try:
            slot = self._acquire_slot_verified(target, ahead, timeout_s)
        except BaseException:
            abort = getattr(self._admission, "note_aborted", None)
            if abort is not None:
                abort()
            raise
        # Keyed on the window the grant bought (its seq is known only
        # after the acquire).
        obs_spans.record("consumer.admission", target + 1,
                         self._last_acquired_seq, span_t0,
                         span_t0 + admit_wait if span_t0 else None)
        self.metrics.observe("consumer.admission_wait", admit_wait)
        self._admission.note_served(
            int(self.connection.rings[target].slot_payload(slot)))
        return slot

    def _acquire_slot_verified(self, target: int, ahead: int,
                               timeout_s: float) -> int:
        """Acquire the next committed slot on ``target`` and verify its
        integrity trailer.  A corrupt head window enters
        quarantine-and-replay; corruption found while deepening the
        lookahead (``ahead > 0`` or a non-blocking probe) raises
        :class:`_CorruptAhead`, uncounted: held slots forbid out-of-FIFO
        quarantine, so the window re-verifies at the head.  Records a
        ``consumer.acquire`` span and, for blocking head acquires only
        (lookahead probes would dilute it), the
        ``consumer.window_latency`` histogram."""
        span_t0 = obs_spans.t0()
        t0 = time.perf_counter() if ahead == 0 and timeout_s > 0 else 0.0
        ring = self.connection.rings[target]
        with annotate("ddl.ring_wait"):
            if (self._cluster is None and self._pool is None
                    and self._pending_pool is None):
                slot = ring.acquire_drain_ahead(ahead, timeout_s)
            else:
                slot = self._acquire_sliced(ring, target, ahead, timeout_s)
        seq = self._expected_seq(target, ahead)
        if self._integrity:
            with annotate("ddl.integrity_verify"):
                err = self._verify_slot(target, slot, seq)
            if err is not None:
                if ahead or timeout_s <= 0:
                    raise _CorruptAhead(err)
                self.metrics.incr("integrity.corrupt_windows")
                # The post-mortem names the quarantined window.
                flight_dump("integrity.corrupt_window",
                            producer_idx=target + 1, seq=seq,
                            metrics=self.metrics,
                            extra={"verify_error": err})
                with self.metrics.timed("integrity.replay"):
                    slot = self._quarantine_and_replay(target, seq, err,
                                                       timeout_s)
        if t0:
            self.metrics.observe("consumer.window_latency",
                                 time.perf_counter() - t0)
        obs_spans.record("consumer.acquire", target + 1, seq, span_t0)
        self._last_acquired_seq = seq
        # The window boundary is the control plane's heartbeat: re-send
        # due envelopes and route the producers' acks.
        self.connection.drain_acks()
        return slot

    def _acquire_sliced(self, ring: Any, target: int, ahead: int,
                        timeout_s: float) -> int:
        """A pool-managed acquire (head and lookahead), in slices of at
        most 0.25 s: a view change that drops ``target`` mid-wait revokes
        it promptly (the departed host's producer never commits again).
        A shut-down ring under a revoking pool is the same revocation,
        not run teardown."""
        deadline = time.monotonic() + timeout_s
        while True:
            if self._target_revoked(target):
                raise _TargetRevoked(target)
            try:
                return ring.acquire_drain_ahead(
                    ahead, min(0.25, max(0.0, deadline - time.monotonic())))
            except StallTimeoutError:
                if time.monotonic() >= deadline:
                    raise
            except ShutdownRequested:
                if self._target_revoked(target):
                    raise _TargetRevoked(target) from None
                raise

    def _discard_head(self, target: int) -> None:
        """Hand ``target``'s head slot back unserved.  A slot returns to
        its producer only once no copy reads it: on the staged route the
        barrier waits out every submitted job's read (an alias job's
        ``copy_done`` fires after its DMA's event), so a replayed fill can
        never overwrite a slot a copy is still reading."""
        ring = self.connection.rings[target]
        engine = self._ingestor._engine if self._ingestor is not None else None
        if engine is not None:
            engine.executor.flush_copies()
        ring.release(int(ring.stats()["released"]) % ring.nslots)
        self._seq_skew[target] += 1

    def _quarantine_and_replay(self, target: int, seq: int, err: str,
                               timeout_s: float) -> int:
        """The corrupt-slot recovery ladder.

        The head slot of ``target`` failed verification as logical window
        ``seq``.  Re-request ``seq`` from the producer, discard the
        quarantined slot and any stale successors, and return the slot
        of the re-committed window.  Up to ``DDL_TORCH_MAX_REPLAYS``
        attempts; none while a cross-instance exchange is active.  The
        caller's head slot is this method's from entry: every discard
        releases it and acquires the next commit."""
        ring = self.connection.rings[target]
        for attempt in range(1, self._max_replays + 1):
            if self._shuffle_fraction > 0.0:
                raise IntegrityError(
                    f"corrupt window {seq} from producer {target + 1} "
                    f"({err}); not replayable: cross-instance exchange "
                    "contributed rows no local rewind can regenerate"
                )
            logger.error(
                "ddl_tpu_torch: corrupt window %d from producer %d (%s) — "
                "quarantined; replay attempt %d/%d",
                seq, target + 1, err, attempt, self._max_replays,
            )
            self.metrics.incr("integrity.replays")
            self.connection.request_replay(target, seq)
            deadline = time.monotonic() + max(timeout_s, 1.0)
            last_request = time.monotonic()
            reattempt = False
            while not reattempt:
                # The producer re-commits seq, seq+1, ... behind what it
                # committed before the request reached it: discard the
                # head until the replayed seq arrives.
                self._discard_head(target)
                while True:
                    now = time.monotonic()
                    if now >= deadline:
                        raise IntegrityError(
                            f"replayed window {seq} from producer "
                            f"{target + 1} never arrived within {timeout_s}s"
                        )
                    if now - last_request >= 2.0:
                        # The request is lost if the producer died (or was
                        # respawned on a fresh channel) before reading it;
                        # a rewind is idempotent, so ask again.
                        self.connection.request_replay(target, seq)
                        last_request = now
                    self.connection.drain_acks()
                    try:
                        slot = ring.acquire_drain(min(2.0, deadline - now))
                        break
                    except StallTimeoutError:
                        continue
                hdr = integrity.read_header(ring.slot_view(slot),
                                            ring.slot_payload(slot))
                if not hdr.valid_magic or hdr.seq != seq:
                    continue  # a stale successor: discard it too
                err = self._verify_slot(target, slot, seq)
                if err is None:
                    logger.warning("ddl_tpu_torch: window %d from producer "
                                   "%d recovered by replay", seq, target + 1)
                    return slot
                # The replayed copy is corrupt again: burn an attempt.
                self.metrics.incr("integrity.corrupt_windows")
                reattempt = True
        self.metrics.incr("integrity.replay_exhausted")
        flight_dump("integrity.replay_exhausted", producer_idx=target + 1,
                    seq=seq, metrics=self.metrics,
                    extra={"verify_error": err})
        raise IntegrityError(
            f"window {seq} from producer {target + 1} still corrupt after "
            f"{self._max_replays} replay(s): {err}"
        )

    def _acquire_current(self) -> None:
        if self._release_backlog:
            # The batch path tracks no hold counter: a stream's deferred
            # releases must land first.
            self._flush_release_backlog()
        if self._staged_orphans:
            # The next unserved windows live in flight or in staging (an
            # abandoned staged stream released their slots early); the
            # batch path serves slot views and cannot reach them.
            raise LoaderStateError(
                "an abandoned windows() stream left staged windows in "
                "flight; drain them with a new windows() stream before "
                "batch iteration"
            )
        self._apply_pending_pool()
        with annotate("ddl.window_acquire", self.metrics,
                      timer="consumer.wait"):
            while True:
                try:
                    slot = self._acquire_verified(self._target, 0,
                                                  self.timeout_s)
                    break
                except _TargetRevoked:
                    # The target's host left the view mid-acquire: apply
                    # the published pool and retry on a survivor.
                    self._apply_pending_pool()
                    self._target = self._next_target(self._target,
                                                     include=True)
        self._cur_slot = slot
        self._cur_array = self._slot_array(self._target, slot)
        self.metrics.incr("consumer.windows")

    def fast_forward(self, n_windows: int) -> None:
        """Discard ``n_windows`` windows without serving them (resume):
        producers regenerate their window sequence from their seeds, so
        skipping the windows a run already consumed puts the pipeline at
        the data position where it stopped (one window per epoch)."""
        if self._release_backlog:
            self._flush_release_backlog()
        # Resume replay is bookkeeping, not service: the discarded windows
        # never reach the tenant, so they neither pass nor are charged at
        # the admission gate (a byte-budgeted tenant would otherwise spend
        # history/budget seconds replaying).
        admission, self._admission = self._admission, None
        try:
            self._fast_forward_unadmitted(n_windows)
        finally:
            self._admission = admission

    def _fast_forward_unadmitted(self, n_windows: int) -> None:
        for _ in range(n_windows):
            if self._staged_orphans:
                # An early-released staged window: already off the ring.
                self._staged_orphans.pop(0)
            else:
                self._acquire_current()
                self._release_current()
            self._advance_to_next_producer()
            self.metrics.incr("consumer.windows_skipped")

    def _release_current(self) -> None:
        if self._cur_slot is not None:
            if self._ingestor is not None and self._ingestor._engine is not None:
                # Slot-safety barrier: a staged prefetch may still hold
                # queued jobs viewing this window (a mid-epoch break).
                # Their copies land before the producer may overwrite it.
                self._ingestor._engine.executor.flush_copies()
            self.connection.rings[self._target].release(self._cur_slot)
            self._cur_slot = None
            self._cur_array = None

    # -- shutdown ------------------------------------------------------------

    def shutdown(self) -> None:
        if self._finalized:
            return
        self._finalized = True
        # Deferred stream releases first: their copies must complete
        # before the rings go away.
        self._flush_release_backlog()
        self._release_current()
        if self._ingestor is not None:
            # Stop the staging executor (pending jobs fail with
            # ShutdownRequested) and wait for every copy in flight: then
            # nothing reads a slot, and the rings may be unlocked.
            self._ingestor.close()
        if self._page_locked:
            from ddl_tpu_torch.ops import host_register

            for ring in self._page_locked:
                host_register.page_unlock(ring)
            self._page_locked = []
        self.connection.shutdown_operation()
        # PROCESS producers ship a last cumulative report on their way
        # out: a short bounded wait, ended as soon as every producer's
        # has landed (a crashed producer never ships).
        if self._obs_reports_possible():
            try:
                self.drain_obs_reports(timeout_s=0.5, wait_for_all=True)
            except (OSError, EOFError, ValueError) as e:
                # A producer gone first: its report is best-effort.
                logger.debug("consumer: final obs drain cut short (%s)", e)
        self.connection.finalize()
        logger.debug("consumer: shutdown complete after epoch %d", self._epoch)

    def __del__(self) -> None:  # pragma: no cover - best effort
        try:
            self.shutdown()
        except ShutdownRequested:
            pass
        except Exception:
            # GC-time shutdown may run after state it needs is gone.
            pass


def _split_columns(
    batch: np.ndarray, splits: Sequence[int]
) -> Tuple[np.ndarray, ...]:
    """Split a (B, sum(splits)) window slice into zero-copy column views."""
    out: List[np.ndarray] = []
    off = 0
    for w in splits:
        out.append(batch[:, off : off + w])
        off += w
    return tuple(out)
