"""Connection: handshake control plane + per-producer rings (port of
``ddl_tpu/transport/connection.py``).

Channel realisations:
- THREAD mode: ``queue.Queue`` pairs (consumer and producers share a
  process); the producer's ring is a :class:`ThreadRing` handed over by
  reference.
- PROCESS mode: a ``multiprocessing.Pipe`` per producer (the handshake
  pickles across it); the producer creates a shared-memory ring and the
  consumer opens it by name.

Elastic rejoin and the acked control envelopes are later slices.
"""

from __future__ import annotations

import abc
import copy
import queue as queue_mod
from typing import Any, List, Optional, Sequence

from ddl_tpu_torch.concurrency import named_rlock
from ddl_tpu_torch.exceptions import StallTimeoutError, TransportError
from ddl_tpu_torch.transport.ring import ThreadRing, WindowRing
from ddl_tpu_torch.types import (
    MetaData_Consumer_To_Producer,
    MetaData_Producer_To_Consumer,
)

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
        self._lock = named_rlock("transport.connection")

    @property
    def n_producers(self) -> int:
        return len(self.channels)

    def send_metadata(self, meta: MetaData_Consumer_To_Producer) -> None:
        """Each producer gets its own copy of the metadata (and with it
        the user's producer function): a shared instance would race on
        user state (shard cursors, RNGs) across producer threads.  A
        pipe copies by pickling, so only thread channels deep-copy."""
        for ch in self.channels:
            ch.send(copy.deepcopy(meta) if isinstance(ch, ThreadChannel)
                    else meta)

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

    def send_control(self, target: int, msg: Any) -> None:
        """Send a control message to producer ``target`` (0-based)."""
        with self._lock:
            self.channels[target].send(msg)

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
        unlink backs up producers that crashed before unlinking their
        own ring's name (idempotent for those that did)."""
        with self._lock:
            for ring in self.rings:
                ring.close()
                ring.unlink()
            for ch in self.channels:
                ch.close()


class ProducerConnection:
    """Producer endpoint: one control channel + this producer's ring.

    ``cross_process`` (PROCESS mode) makes :meth:`create_ring` create a
    named shared-memory ring; otherwise it is a :class:`ThreadRing`,
    page-locked with ``pin_memory``.
    """

    def __init__(self, channel: ControlChannel, producer_idx: int,
                 pin_memory: bool = False, cross_process: bool = False):
        self.channel = channel
        self.producer_idx = producer_idx
        self.pin_memory = pin_memory
        self.cross_process = cross_process
        self.ring: Optional[WindowRing] = None
        self._ring_ref: Any = None

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
