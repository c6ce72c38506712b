"""Connection: handshake control plane + per-producer rings (port of
``ddl_tpu/transport/connection.py`` in the THREAD case).

Consumer and producers share a process; each link is a pair of
``queue.Queue`` objects.  The PROCESS-mode pipe channel, elastic rejoin
and the acked control envelopes are later slices.
"""

from __future__ import annotations

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

#: Sentinel returned by :meth:`ThreadChannel.try_recv` when nothing is
#: pending — distinct from None, which is a legal message payload.
NOTHING = object()


class ThreadChannel:
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


class ConsumerConnection:
    """Consumer endpoint: broadcasts metadata, collects replies, owns rings."""

    def __init__(self, channels: Sequence[ThreadChannel]):
        self.channels = list(channels)
        self.rings: List[WindowRing] = []
        self.replies: List[MetaData_Producer_To_Consumer] = []
        self._lock = named_rlock("transport.connection")

    @property
    def n_producers(self) -> int:
        return len(self.channels)

    def send_metadata(self, meta: MetaData_Consumer_To_Producer) -> None:
        """Each producer gets a DEEP COPY of the metadata (and with it the
        user's producer function): a shared instance would race on user
        state (shard cursors, RNGs) across producer threads."""
        for ch in self.channels:
            ch.send(copy.deepcopy(meta))

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
        """Adopt every producer's ring (by in-process reference)."""
        rings = []
        for r in self.replies:
            if not isinstance(r.ring_ref, WindowRing):
                raise TransportError(f"producer {r.producer_idx} sent no ring")
            rings.append(r.ring_ref)
        self.rings = rings
        return self.rings

    def send_control(self, target: int, msg: Any) -> None:
        """Send a control message to producer ``target`` (0-based)."""
        with self._lock:
            self.channels[target].send(msg)

    def shutdown_operation(self) -> None:
        """Wake every producer with the ring shutdown flag (idempotent)."""
        with self._lock:
            rings = self.rings or [
                r.ring_ref for r in self.replies
                if isinstance(r.ring_ref, WindowRing)
            ]
            for ring in rings:
                ring.shutdown()


class ProducerConnection:
    """Producer endpoint: one control channel + this producer's ring."""

    def __init__(self, channel: ThreadChannel, producer_idx: int,
                 pin_memory: bool = False):
        self.channel = channel
        self.producer_idx = producer_idx
        self.pin_memory = pin_memory
        self.ring: Optional[WindowRing] = None

    def recv_metadata_as_producer(self) -> MetaData_Consumer_To_Producer:
        meta = self.channel.recv()
        if not isinstance(meta, MetaData_Consumer_To_Producer):
            raise TransportError(f"bad handshake metadata: {meta!r}")
        return meta

    def create_ring(self, nslots: int, slot_bytes: int) -> WindowRing:
        self.ring = ThreadRing(nslots, slot_bytes, pin_memory=self.pin_memory)
        return self.ring

    def send_metadata(self, reply: MetaData_Producer_To_Consumer) -> None:
        reply.ring_ref = self.ring
        self.channel.send(reply)
