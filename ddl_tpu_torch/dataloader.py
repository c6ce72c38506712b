"""Consumer API: the distributed dataloader (port of
``ddl_tpu/dataloader.py`` along the slice's paths).

- Batch iteration: ``len(loader)`` is the current producer's
  ``batches_per_window`` (one epoch == one window), ``loader[i]`` the
  column tuple of batch ``i``, ``prefetch()`` the device-batch iterator;
  the user calls ``mark(END_OF_BATCH)`` / ``mark(END_OF_EPOCH)``.
- Window streaming (``windows(lookahead)``): each epoch-window crosses
  to the device as ONE copy straight out of the ring slot, the next
  window's copy already in flight while the caller computes.  On CUDA
  the slot release is deferred onto the copy's event (the release
  backlog), and a fused-step caller can gate it on its consuming step as
  well (:meth:`DistributedDataLoader.gate_release_on`).
- Sharded targets (``sharding=``, ``distribute=``): windows and batches
  land on a mesh of positions, through the ICI fan-out tier or the plain
  route (:class:`~ddl_tpu_torch.ingest.DeviceIngestor`).

Every acquire verifies the window's integrity trailer.  A corrupt head
window raises :class:`IntegrityError`; the quarantine-and-replay ladder,
the staged ingest engine, loader pools, admission and observability
shipping of the JAX package are later slices.
"""

from __future__ import annotations

import collections
import logging
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ddl_tpu_torch import integrity
from ddl_tpu_torch.datasetwrapper import ProducerFunctionSkeleton
from ddl_tpu_torch.exceptions import (
    DoesNotMatchError,
    IntegrityError,
    LoaderStateError,
    ShutdownRequested,
    StallTimeoutError,
)
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
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
    ):
        if output not in ("torch", "numpy", "device"):
            raise ValueError(f"output must be torch|numpy|device, got {output!r}")
        self.batch_size = batch_size
        self.n_epochs = n_epochs
        self.connection = connection
        self.output = output
        self.metrics = metrics or default_metrics()
        self.timeout_s = timeout_s
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
        if output == "device":
            from ddl_tpu_torch.ingest import DeviceIngestor

            # ``sharding`` (a NamedSharding) lands windows and batches as
            # ShardedArrays over its mesh positions; ``distribute="auto"``
            # takes the ICI fan-out tier on a CUDA mesh and the plain route
            # on the CPU.
            self._ingestor = DeviceIngestor(
                device=device, metrics=self.metrics, sharding=sharding,
                distribute=distribute,
            )

        # -- handshake -----------------------------------------------------
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
        self.splits_per_producer = [tuple(r.splits) for r in replies]
        self.shapes = [tuple(r.shape) for r in replies]
        self.dtypes = [np.dtype(r.dtype) for r in replies]
        connection.attach_rings()

    # -- iteration protocol ------------------------------------------------

    @property
    def n_producers(self) -> int:
        return self.connection.n_producers

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

        return PrefetchIterator(
            host_iter(), lambda b: self._ingestor.put_batch(b, splits), depth,
        )

    def windows(self, lookahead: int = 1):
        """Stream whole windows onto the device, one per epoch
        (``output="device"``).

        Each window's copy sources the ring slot directly (no host
        memcpy between producer fill and device).  On CUDA the slot is
        held until the copy event fires, but the HOST never waits for
        it: windows yield as tensors the current stream is ordered
        after, and slot release is gated on a non-blocking event probe
        (forced only when a ring runs out of slots).  On the CPU the
        window is copied at once and its slot released at yield.

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
        rings = self.connection.rings
        held: collections.Counter = collections.Counter()
        # A previous stream's yielded-but-unreleased windows still hold
        # ring slots; count them so drain lookahead skips past them.
        for entry in self._release_backlog:
            held[entry[0]] += 1
        # FIFO of [slot, target, transfer, samples, wkey] in flight.
        pending: collections.deque = collections.deque()
        # Generator-local rotation cursor: self._target only advances when
        # a window is yielded, so an abandoned stream needs no rollback
        # (acquisition has no ring side effect; only release does).
        cursor = self._target
        token = object()
        self._stream_token = token

        def start_one(timeout_s: float):
            nonlocal cursor
            target = cursor
            with self.metrics.timed("consumer.wait"):
                slot = self._acquire_verified(target, held[target], timeout_s)
            # Window identity: the integrity trailer's (producer_idx, seq).
            wkey = (target + 1, self._last_acquired_seq)
            bpw = self._lens[target]
            served = bpw * self.batch_size
            window = self._slot_array(target, slot)[:served].reshape(
                bpw, self.batch_size, *self.shapes[target][1:]
            )
            transfer = self._ingestor.put_window(window, defer_metrics=True)
            held[target] += 1
            cursor = (cursor + 1) % self.n_producers
            return [slot, target, transfer, served, wkey]

        def finish(entry):
            slot, target, transfer, served, wkey = entry
            dev = self._ingestor.hand_off(transfer)
            self.metrics.incr("ingest.bytes", float(dev.nbytes))
            self.metrics.incr("ingest.windows")
            self.metrics.incr("consumer.windows")
            self.metrics.incr("consumer.samples", served)
            self._last_stream_entry = None
            if self._ingestor.window_source_detached():
                # CPU: the copy is already complete; hand the slot back.
                rings[target].release(slot)
                held[target] -= 1
            else:
                # CUDA: the copy still reads the slot.  Defer the release
                # onto its event (_sweep_release_backlog), remembered so a
                # fused-step consumer can gate it on its step as well.
                backlog_entry = [target, slot, transfer.done, wkey]
                self._release_backlog.append(backlog_entry)
                self._last_stream_entry = backlog_entry
            # This window is now SERVED: commit the rotation.
            self._target = (target + 1) % self.n_producers
            self._last_window_key = wkey
            return dev

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
            if self._release_backlog:
                self._sweep_release_backlog(held)
            if not pending:
                if held[cursor] >= rings[cursor].nslots:
                    # Every slot of the head ring awaits its gated
                    # release: wait out the oldest deferred one.
                    self._flush_release_backlog(held, target=cursor)
                pending.append(start_one(self.timeout_s))
            # Deepen up to `lookahead` extra windows, each a non-blocking
            # try: the first not-yet-committed window ends the round.
            while (
                len(pending) <= lookahead
                and i + len(pending) < remaining
                and not self._finalized
                and held[cursor] < rings[cursor].nslots
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
        stream window.  None before the first yield."""
        return self._last_window_key

    # -- progress marks ------------------------------------------------------

    def mark(self, marker: Marker) -> None:
        """Report progress."""
        if marker is Marker.END_OF_BATCH:
            self._batches_in_window += 1
            if self._batches_in_window >= self._lens[self._target]:
                self._batches_in_window = 0
                self._release_current()
                self._target = (self._target + 1) % self.n_producers
        elif marker is Marker.END_OF_EPOCH:
            self._served_in_epoch = 0
            if self._batches_in_window:
                # Epoch ended mid-window: discard the partial window so
                # the next epoch starts on a fresh window boundary.
                self._batches_in_window = 0
                self._release_current()
                self._target = (self._target + 1) % self.n_producers
            self._epoch += 1
            if self._epoch >= self.n_epochs:
                self.shutdown()
        else:
            raise ValueError(f"unknown marker {marker!r}")

    # -- window rotation -----------------------------------------------------

    def _slot_array(self, target: int, slot: int) -> np.ndarray:
        """Zero-copy window view of an acquired slot, shaped for ``target``."""
        ring = self.connection.rings[target]
        nbytes = ring.slot_payload(slot)
        return (
            ring.slot_view(slot)[:nbytes]
            .view(self.dtypes[target])
            .reshape(self.shapes[target])
        )

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
                if held is not None:
                    held[target] -= 1
            else:
                blocked.add(target)
                remaining.append(entry)
        self._release_backlog = remaining

    def _flush_release_backlog(self, held=None, target=None) -> None:
        """BLOCKING release of backlog entries: all of them (teardown),
        or only the oldest entry of ``target`` (a ring out of free
        slots).  The wait is accounted as ``ingest.release_wait``."""
        remaining = []
        done_one = False
        for entry in self._release_backlog:
            t, slot, done = entry[:3]
            if done_one or (target is not None and t != target):
                remaining.append(entry)
                continue
            with self.metrics.timed("ingest.release_wait"):
                wait_value(done)
            self.connection.rings[t].release(slot)
            if held is not None:
                held[t] -= 1
            if target is not None:
                done_one = True
        self._release_backlog = remaining

    # -- end-to-end integrity ----------------------------------------------

    def _expected_seq(self, target: int, ahead: int) -> int:
        """Logical window number of the slot ``acquire_drain_ahead(ahead)``
        returns on ``target``."""
        ring = self.connection.rings[target]
        return int(ring.stats()["released"]) + ahead

    def _acquire_verified(self, target: int, ahead: int, timeout_s: float) -> int:
        """Acquire the next committed slot on ``target`` and verify its
        integrity trailer.  A corrupt head window raises
        :class:`IntegrityError`; corruption found while deepening the
        lookahead (``ahead > 0`` or a non-blocking probe) raises
        :class:`_CorruptAhead` so the window re-verifies at the head."""
        ring = self.connection.rings[target]
        slot = ring.acquire_drain_ahead(ahead, timeout_s)
        seq = self._expected_seq(target, ahead)
        if self._integrity:
            err = integrity.verify_window(
                ring.slot_view(slot), ring.slot_payload(slot),
                expect_seq=seq, expect_producer=target + 1,
            )
            if err is not None:
                if ahead or timeout_s <= 0:
                    raise _CorruptAhead(err)
                self.metrics.incr("integrity.corrupt_windows")
                raise IntegrityError(
                    f"corrupt window {seq} from producer {target + 1}: {err}"
                )
        self._last_acquired_seq = seq
        return slot

    def _acquire_current(self) -> None:
        if self._release_backlog:
            # The batch path tracks no hold counter: a stream's deferred
            # releases must land first.
            self._flush_release_backlog()
        with self.metrics.timed("consumer.wait"):
            slot = self._acquire_verified(self._target, 0, self.timeout_s)
        self._cur_slot = slot
        self._cur_array = self._slot_array(self._target, slot)
        self.metrics.incr("consumer.windows")

    def _release_current(self) -> None:
        if self._cur_slot is not None:
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
        self.connection.shutdown_operation()
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
