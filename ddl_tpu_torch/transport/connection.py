"""Connection: handshake control plane + per-producer rings (port of
``ddl_tpu/transport/connection.py``).

Channel realisations:
- THREAD mode: ``queue.Queue`` pairs (consumer and producers share a
  process); the producer's ring is a :class:`ThreadRing` handed over by
  reference.
- PROCESS mode: a ``multiprocessing.Pipe`` per producer (the handshake
  pickles across it); the producer creates a shared-memory ring and the
  consumer opens it by name.

A respawned producer re-runs the handshake over a fresh channel
(:meth:`ConsumerConnection.rejoin_producer`) and attaches the ring its
predecessor left; commands to producers (replay requests) ride the acked
envelopes of :mod:`ddl_tpu_torch.transport.envelope`.
"""

from __future__ import annotations

import abc
import copy
import logging
import queue as queue_mod
import threading
from typing import Any, List, Optional, Sequence

from ddl_tpu_torch.concurrency import named_rlock
from ddl_tpu_torch.exceptions import StallTimeoutError, TransportError
from ddl_tpu_torch.transport.ring import ThreadRing, WindowRing
from ddl_tpu_torch.types import (
    MetaData_Consumer_To_Producer,
    MetaData_Producer_To_Consumer,
)

logger = logging.getLogger("ddl_tpu_torch")

_HANDSHAKE_TIMEOUT_S = 600.0

#: Sentinel returned by :meth:`ControlChannel.try_recv` when nothing is
#: pending — distinct from None, which is a legal message payload.
NOTHING = object()


class ControlChannel(abc.ABC):
    """One bidirectional control-plane link (consumer ↔ one producer)."""

    @abc.abstractmethod
    def send(self, obj: Any) -> None: ...

    @abc.abstractmethod
    def recv(self, timeout_s: float = _HANDSHAKE_TIMEOUT_S) -> Any: ...

    @abc.abstractmethod
    def try_recv(self) -> Any:
        """Non-blocking receive: a pending message or :data:`NOTHING`.
        A broken channel reads as "nothing pending": channel death is
        detected by the blocking paths and the ring shutdown flag."""

    def alive(self) -> bool:
        """False only when the link is positively known dead."""
        return True

    def close(self) -> None:
        pass


class ThreadChannel(ControlChannel):
    """In-process control channel endpoint over a pair of queues."""

    def __init__(self, tx: "queue_mod.Queue[Any]", rx: "queue_mod.Queue[Any]"):
        self._tx, self._rx = tx, rx

    @staticmethod
    def pair() -> tuple["ThreadChannel", "ThreadChannel"]:
        a: "queue_mod.Queue[Any]" = queue_mod.Queue()
        b: "queue_mod.Queue[Any]" = queue_mod.Queue()
        return ThreadChannel(a, b), ThreadChannel(b, a)

    def send(self, obj: Any) -> None:
        self._tx.put(obj)

    def recv(self, timeout_s: float = _HANDSHAKE_TIMEOUT_S) -> Any:
        try:
            return self._rx.get(timeout=timeout_s)
        except queue_mod.Empty as e:
            raise StallTimeoutError(f"control recv exceeded {timeout_s}s") from e

    def try_recv(self) -> Any:
        try:
            return self._rx.get_nowait()
        except queue_mod.Empty:
            return NOTHING


class PipeChannel(ControlChannel):
    """Cross-process channel over one end of a ``multiprocessing.Pipe``."""

    def __init__(self, conn: Any):
        self._conn = conn

    @staticmethod
    def pair() -> tuple["PipeChannel", "PipeChannel"]:
        import multiprocessing as mp

        a, b = mp.Pipe(duplex=True)
        return PipeChannel(a), PipeChannel(b)

    def send(self, obj: Any) -> None:
        self._conn.send(obj)

    def recv(self, timeout_s: float = _HANDSHAKE_TIMEOUT_S) -> Any:
        if not self._conn.poll(timeout_s):
            raise StallTimeoutError(f"control recv exceeded {timeout_s}s")
        try:
            return self._conn.recv()
        except (EOFError, ConnectionResetError) as e:
            # The peer process died with the channel open: fail fast
            # instead of pretending the handshake may still complete.
            raise TransportError("control channel peer closed (process died)") from e

    def try_recv(self) -> Any:
        try:
            if not self._conn.poll(0):
                return NOTHING
            return self._conn.recv()
        except (EOFError, OSError):
            return NOTHING

    def alive(self) -> bool:
        return not self._conn.closed

    def close(self) -> None:
        self._conn.close()


def _resolve_ring(reply: MetaData_Producer_To_Consumer) -> WindowRing:
    """A handshake reply's ring: the object itself (THREAD mode) or the
    shm ring its name opens (PROCESS mode)."""
    ref = reply.ring_ref
    if isinstance(ref, WindowRing):
        return ref
    if isinstance(ref, str):
        from ddl_tpu_torch.transport.shm_ring import open_shm_ring

        return open_shm_ring(ref)
    raise TransportError(f"producer {reply.producer_idx} sent no ring")


class ConsumerConnection:
    """Consumer endpoint: broadcasts metadata, collects replies, owns rings."""

    def __init__(self, channels: Sequence[ControlChannel]):
        self.channels = list(channels)
        self.rings: List[WindowRing] = []
        self.replies: List[MetaData_Producer_To_Consumer] = []
        self._sent_meta: Optional[MetaData_Consumer_To_Producer] = None
        # One acked sender per target, built on first use, each stamping
        # the current fencing term (set_control_fence).
        self._senders: dict = {}
        self._control_fence = 0
        #: Registry for the senders' ``ctrl.*`` counters (the loader
        #: attaches its own).
        self.control_metrics: Any = None
        # Serialises the watchdog's channel swap (rejoin_producer)
        # against the consumer's sends, shutdown and finalize.
        self._lock = named_rlock("transport.connection")
        self._finalized = False
        # ObsReports the control router met, in arrival order, until the
        # loader takes them (take_obs_reports): the router never drops a
        # report, and the loader's drain never takes an ack.
        self._obs_reports: List[Any] = []

    @property
    def n_producers(self) -> int:
        return len(self.channels)

    @staticmethod
    def _send_meta(ch: ControlChannel, meta: MetaData_Consumer_To_Producer
                   ) -> None:
        """Each producer gets its own copy of the metadata (and with it
        the user's producer function): a shared instance would race on
        user state (shard cursors, RNGs) across producer threads.  A
        pipe copies by pickling, so only thread channels deep-copy."""
        ch.send(copy.deepcopy(meta) if isinstance(ch, ThreadChannel)
                else meta)

    def send_metadata(self, meta: MetaData_Consumer_To_Producer) -> None:
        self._sent_meta = meta  # kept for the rejoin handshakes
        for ch in self.channels:
            self._send_meta(ch, meta)

    def recv_metadata_as_consumer(self) -> List[MetaData_Producer_To_Consumer]:
        replies = [ch.recv() for ch in self.channels]
        # Record the valid replies FIRST so shutdown_operation can still
        # reach the healthy producers' rings after a partial handshake.
        self.replies = sorted(
            (r for r in replies if isinstance(r, MetaData_Producer_To_Consumer)),
            key=lambda r: r.producer_idx,
        )
        for i, r in enumerate(replies):
            if isinstance(r, Exception):
                raise TransportError(f"producer {i} failed during handshake") from r
            if not isinstance(r, MetaData_Producer_To_Consumer):
                raise TransportError(f"bad handshake reply from producer {i}: {r!r}")
        return self.replies

    def attach_rings(self) -> List[WindowRing]:
        """Adopt every producer's ring (by name or by in-process
        reference)."""
        self.rings = [_resolve_ring(r) for r in self.replies]
        return self.rings

    def rejoin_producer(self, producer_idx: int, channel: ControlChannel
                        ) -> MetaData_Producer_To_Consumer:
        """Re-run the handshake with a RESPAWNED producer over its fresh
        ``channel``.  The replacement derives its geometry from the same
        metadata and attaches the surviving ring, so it must report what
        its predecessor reported: the consumer's window bookkeeping
        cannot change mid-run.  The ring stays attached (and, on a card,
        registered) as it was."""
        i = producer_idx - 1
        if self._sent_meta is None:
            raise TransportError("rejoin before the initial handshake")
        old = self.replies[i]
        self._send_meta(channel, self._sent_meta)
        reply = channel.recv()
        if isinstance(reply, Exception):
            raise TransportError(
                f"producer {producer_idx} failed during rejoin") from reply
        if not isinstance(reply, MetaData_Producer_To_Consumer):
            raise TransportError(f"bad rejoin reply: {reply!r}")
        if (reply.batches_per_window != old.batches_per_window
                or tuple(reply.shape) != tuple(old.shape)
                or tuple(reply.splits) != tuple(old.splits)
                or reply.dtype != old.dtype):
            raise TransportError(
                f"respawned producer {producer_idx} reported different "
                "geometry than its predecessor")
        if reply.integrity != old.integrity:
            raise TransportError(
                f"respawned producer {producer_idx} disagrees with its "
                "predecessor about integrity headers (DDL_TORCH_INTEGRITY "
                "changed between incarnations)")
        with self._lock:
            if self._finalized:
                # The run ended while this rejoin's recv was in flight.
                # The replacement validated and has been serving the ring
                # directly: a recovery that raced the end of the run, not
                # a failure.  Drop the channel rather than swap it into a
                # closed connection.
                channel.close()
                logger.info("rejoin of producer %d completed after "
                            "finalize; replacement channel dropped",
                            producer_idx)
                return reply
            try:
                self.channels[i].close()
            except OSError:
                pass  # the dead producer's pipe is already broken
            self.channels[i] = channel
            self.replies[i] = reply
        return reply

    def try_recv_control(self, target: int) -> Any:
        """Non-blocking receive of a producer's control message (an ack):
        :data:`NOTHING` when idle, finalized or broken."""
        with self._lock:
            if self._finalized:
                return NOTHING
            try:
                return self.channels[target].try_recv()
            except (OSError, EOFError, ValueError):
                return NOTHING

    def send_control(self, target: int, msg: Any) -> None:
        """Send a raw control message to producer ``target`` (0-based),
        under the lock a concurrent channel swap takes.  Commands go
        through :meth:`send_control_acked`."""
        with self._lock:
            self.channels[target].send(msg)

    def control_sender(self, target: int) -> Any:
        """The acked sender of ``target``, built on first use.  Its wire
        closure reads ``self.channels[target]`` at send time."""
        from ddl_tpu_torch.transport.envelope import ControlSender

        with self._lock:
            s = self._senders.get(target)
            if s is None:
                s = ControlSender(
                    lambda msg, t=target: self.send_control(t, msg),
                    target=target, metrics=self.control_metrics,
                )
                s.fence = self._control_fence
                self._senders[target] = s
            return s

    def set_control_fence(self, fence: int) -> None:
        """Stamp ``fence`` on every later acked send (a supervisor
        promotion raises the term; receivers drop older ones)."""
        with self._lock:
            self._control_fence = int(fence)
            for s in self._senders.values():
                s.fence = self._control_fence

    def send_control_acked(self, target: int, msg: Any) -> int:
        """Send ``msg`` in an acked envelope (retried until acked).
        Returns the envelope's seq, or -1 after finalize."""
        with self._lock:
            if self._finalized:
                return -1
            return self.control_sender(target).send(msg)

    def pump_control(self, now: Optional[float] = None) -> int:
        """Re-send every due unacked envelope.  Returns the count."""
        with self._lock:
            if self._finalized:
                return 0
            return sum(s.pump(now) for s in self._senders.values())

    def note_ack(self, ack: Any) -> bool:
        """Route a :class:`~ddl_tpu_torch.types.ControlAck` to its
        sender (``ack.producer_idx`` is 1-based, targets 0-based)."""
        with self._lock:
            s = self._senders.get(ack.producer_idx - 1)
            return s.ack(ack) if s is not None else False

    def drain_acks(self) -> int:
        """Re-send due envelopes, then route everything the producers sent
        back (:data:`~ddl_tpu_torch.types.PRODUCER_TO_CONSUMER_CONTROL`):
        each :class:`~ddl_tpu_torch.types.ControlAck` to its sender, each
        :class:`~ddl_tpu_torch.types.ObsReport` to the report inbox the
        loader drains (:meth:`take_obs_reports`).  Returns the acks
        routed."""
        from ddl_tpu_torch.types import ControlAck, ObsReport

        self.pump_control()
        routed = 0
        for target in range(self.n_producers):
            while True:
                msg = self.try_recv_control(target)
                if msg is NOTHING:
                    break
                if isinstance(msg, ControlAck):
                    self.note_ack(msg)
                    routed += 1
                elif isinstance(msg, ObsReport):
                    with self._lock:
                        self._obs_reports.append(msg)
                else:
                    logger.warning("consumer: ignoring unexpected producer "
                                   "message %r on channel %d",
                                   type(msg).__name__, target)
        return routed

    def take_obs_reports(self) -> List[Any]:
        """The ObsReports routed so far, in arrival order; the inbox is
        emptied.  Acks never land here."""
        with self._lock:
            out, self._obs_reports = self._obs_reports, []
        return out

    def request_replay(self, target: int, seq: int) -> None:
        """Ask producer ``target`` (0-based) to rewind and re-commit its
        window stream from logical window ``seq``, in an acked
        envelope."""
        from ddl_tpu_torch.types import ReplayRequest

        self.send_control_acked(target, ReplayRequest(seq=seq))

    def shutdown_operation(self) -> None:
        """Wake every producer with the ring shutdown flag (idempotent).
        When rings were never attached (the handshake failed midway), the
        recorded replies still reach the healthy producers' rings."""
        with self._lock:
            rings = self.rings
            if not rings:
                rings = []
                for r in self.replies:
                    try:
                        rings.append(_resolve_ring(r))
                    except (TransportError, OSError):
                        # Best effort: that producer's bounded wait still
                        # times out.
                        pass
            for ring in rings:
                ring.shutdown()

    def finalize(self) -> None:
        """Close and unlink every ring, then close the channels.  The
        unlink backs up a producer that crashed and was never respawned:
        a crash leaves the ring's name linked for a replacement to attach
        (idempotent for producers that unlinked their own)."""
        with self._lock:
            self._finalized = True
            for ring in self.rings:
                ring.close()
                try:
                    ring.unlink()
                except (TransportError, OSError):
                    pass  # the name is already gone
            for ch in self.channels:
                ch.close()


class ProducerConnection:
    """Producer endpoint: one control channel + this producer's ring.

    ``cross_process`` (PROCESS mode) makes :meth:`create_ring` create a
    named shared-memory ring; otherwise it is a :class:`ThreadRing`,
    page-locked with ``pin_memory``.  ``retired`` is set when a THREAD
    producer that stopped making progress is replaced: its waits that
    observe an abort (a hang, an exchange wait) end, and the thread exits
    without touching the ring its replacement takes over.
    """

    def __init__(self, channel: ControlChannel, producer_idx: int,
                 pin_memory: bool = False, cross_process: bool = False):
        self.channel = channel
        self.producer_idx = producer_idx
        self.pin_memory = pin_memory
        self.cross_process = cross_process
        self.ring: Optional[WindowRing] = None
        self._ring_ref: Any = None
        self.retired = threading.Event()

    def recv_metadata_as_producer(self) -> MetaData_Consumer_To_Producer:
        meta = self.channel.recv()
        if not isinstance(meta, MetaData_Consumer_To_Producer):
            raise TransportError(f"bad handshake metadata: {meta!r}")
        return meta

    def create_ring(self, nslots: int, slot_bytes: int) -> WindowRing:
        if self.cross_process:
            from ddl_tpu_torch.transport.shm_ring import (
                create_shm_ring,
                make_ring_name,
            )

            name = make_ring_name(f"ddl-torch-p{self.producer_idx}")
            self.ring = create_shm_ring(name, nslots, slot_bytes)
            self._ring_ref = name
        else:
            self.ring = ThreadRing(nslots, slot_bytes,
                                   pin_memory=self.pin_memory)
            self._ring_ref = self.ring
        return self.ring

    def attach_ring(self, ring_ref: Any) -> WindowRing:
        """Adopt an existing ring: by shm name across processes, by
        object in-process."""
        if isinstance(ring_ref, WindowRing):
            self.ring = ring_ref
        else:
            from ddl_tpu_torch.transport.shm_ring import open_shm_ring

            self.ring = open_shm_ring(ring_ref)
        self._ring_ref = ring_ref
        return self.ring

    def send_metadata(self, reply: MetaData_Producer_To_Consumer) -> None:
        reply.ring_ref = self._ring_ref
        self.channel.send(reply)

    def finalize(self, unlink: bool = True) -> None:
        """Close this end: the ring handle (unlinking a cross-process
        ring's name unless ``unlink=False``), then the channel."""
        if self.ring is not None:
            self.ring.close()
            if self.cross_process and unlink:
                self.ring.unlink()
        self.channel.close()
