"""SPSC window ring (port of ``ddl_tpu/transport/ring.py``: the
:class:`WindowRing` interface and :class:`ThreadRing`; the cross-process
rings are in ``shm_ring.py``).

Producer side: ``acquire_fill() -> slot``, write into ``slot_view``,
``commit(slot, nbytes)``.  Consumer side: ``acquire_drain() -> slot``,
read ``slot_view``, ``release(slot)``.  Slots hand off in FIFO order; a
shutdown flag wakes every blocked wait with :class:`ShutdownRequested`.
``acquire_fill`` and ``acquire_drain`` pass the ``ring.fill`` /
``ring.drain`` fault sites (in all three ring classes).

Where the consumer feeds a CUDA card, the slots are page-locked
(``pin_memory=True``): the loader's host-to-device copy then runs
asynchronously out of the slot itself, and the slot is released only
once that copy's CUDA event has fired.
"""

from __future__ import annotations

import abc
import time
from typing import Dict

import numpy as np

from ddl_tpu_torch.concurrency import named_condition
from ddl_tpu_torch.exceptions import ShutdownRequested, StallTimeoutError
from ddl_tpu_torch.faults import fault_point

#: Default wait deadline (a lost peer must not hang forever).
DEFAULT_TIMEOUT_S = 300.0


class WindowRing(abc.ABC):
    """SPSC ring of fixed-size window slots."""

    nslots: int
    slot_bytes: int
    #: Are the slots page-locked host memory?  Then a ``non_blocking``
    #: copy to a card is a DMA straight out of the slot that returns
    #: before the bytes have moved (the staged engine's alias route).
    page_locked: bool = False

    @abc.abstractmethod
    def acquire_fill(self, timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
        """Block until a free slot is available; return its index."""

    @abc.abstractmethod
    def commit(self, slot: int, payload_bytes: int) -> None:
        """Publish a filled slot to the consumer."""

    @abc.abstractmethod
    def acquire_drain(self, timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
        """Block until a committed slot is available; return its index."""

    @abc.abstractmethod
    def acquire_drain_ahead(
        self, ahead: int, timeout_s: float = DEFAULT_TIMEOUT_S
    ) -> int:
        """Acquire the next committed slot while still holding ``ahead``
        drained-but-unreleased slots.  ``ahead == 0`` is
        :meth:`acquire_drain`.  Release order stays FIFO."""

    def poll_drain_ready(self, ahead: int = 0) -> bool:
        """Non-blocking: would :meth:`acquire_drain_ahead` succeed now?"""
        s = self.stats()
        return s["committed"] - s["released"] > ahead

    @abc.abstractmethod
    def release(self, slot: int) -> None:
        """Return a drained slot to the producer."""

    @abc.abstractmethod
    def slot_view(self, slot: int) -> np.ndarray:
        """Zero-copy uint8 view of the slot payload region."""

    @abc.abstractmethod
    def slot_payload(self, slot: int) -> int:
        """Committed payload byte count of the slot."""

    @abc.abstractmethod
    def shutdown(self) -> None:
        """Wake every blocked wait with :class:`ShutdownRequested`."""

    @abc.abstractmethod
    def is_shutdown(self) -> bool: ...

    @abc.abstractmethod
    def stats(self) -> Dict[str, float]:
        """Stall/progress counters: producer_stall_s, consumer_stall_s,
        committed, released."""

    def close(self) -> None:
        """Drop this endpoint's handle (cross-process rings)."""

    def unlink(self) -> None:
        """Remove the ring's name (cross-process rings)."""


class ThreadRing(WindowRing):
    """In-process ring over host buffers and a condition variable (THREAD
    mode, where producers are threads of the trainer process).

    ``pin_memory=True`` allocates the slots page-locked through PyTorch's
    host allocator, so a ``non_blocking`` copy to the card sources the
    slot directly and returns before the bytes have moved.
    """

    def __init__(self, nslots: int, slot_bytes: int, pin_memory: bool = False):
        if nslots < 1:
            raise ValueError("nslots must be >= 1")
        self.nslots = nslots
        self.slot_bytes = slot_bytes
        self.page_locked = bool(pin_memory)
        if self.page_locked:
            import torch

            # The torch tensors own the page-locked memory; the numpy
            # views alias it.  Both live as long as the ring.
            self._owners = [
                torch.zeros(slot_bytes, dtype=torch.uint8, pin_memory=True)
                for _ in range(nslots)
            ]
            self._slots = [t.numpy() for t in self._owners]
        else:
            self._slots = [
                np.zeros(slot_bytes, dtype=np.uint8) for _ in range(nslots)
            ]
        self._payload = [0] * nslots
        self._committed = 0
        self._released = 0
        self._shutdown = False
        self._cond = named_condition("transport.ring.cond")
        self._prod_stall = 0.0
        self._cons_stall = 0.0

    def _wait(self, pred, timeout_s: float, stall_attr: str) -> None:
        t0 = time.perf_counter()
        try:
            with self._cond:
                # Shutdown first: post-shutdown, trailing committed slots
                # are dropped, not drained.
                while True:
                    if self._shutdown:
                        raise ShutdownRequested()
                    if pred():
                        break
                    remaining = timeout_s - (time.perf_counter() - t0)
                    if remaining <= 0:
                        raise StallTimeoutError(
                            f"ring wait exceeded {timeout_s}s (committed="
                            f"{self._committed} released={self._released})"
                        )
                    self._cond.wait(min(remaining, 0.5))
        finally:
            setattr(
                self, stall_attr,
                getattr(self, stall_attr) + time.perf_counter() - t0,
            )

    def acquire_fill(self, timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
        fault_point("ring.fill", should_abort=self.is_shutdown)
        self._wait(
            lambda: self._committed - self._released < self.nslots,
            timeout_s,
            "_prod_stall",
        )
        return self._committed % self.nslots

    def commit(self, slot: int, payload_bytes: int) -> None:
        with self._cond:
            if slot != self._committed % self.nslots:
                raise ValueError(f"out-of-order commit of slot {slot}")
            self._payload[slot] = payload_bytes
            self._committed += 1
            self._cond.notify_all()

    def acquire_drain(self, timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
        fault_point("ring.drain", should_abort=self.is_shutdown)
        return self.acquire_drain_ahead(0, timeout_s)

    def acquire_drain_ahead(
        self, ahead: int, timeout_s: float = DEFAULT_TIMEOUT_S
    ) -> int:
        if not 0 <= ahead < self.nslots:
            raise ValueError(
                f"ahead must be in [0, nslots={self.nslots}), got {ahead}"
            )
        self._wait(
            lambda: self._committed > self._released + ahead,
            timeout_s,
            "_cons_stall",
        )
        return (self._released + ahead) % self.nslots

    def release(self, slot: int) -> None:
        with self._cond:
            if slot != self._released % self.nslots:
                raise ValueError(f"out-of-order release of slot {slot}")
            self._released += 1
            self._cond.notify_all()

    def slot_view(self, slot: int) -> np.ndarray:
        return self._slots[slot]

    def slot_payload(self, slot: int) -> int:
        return self._payload[slot]

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    def is_shutdown(self) -> bool:
        return self._shutdown

    def stats(self) -> Dict[str, float]:
        return {
            "producer_stall_s": self._prod_stall,
            "consumer_stall_s": self._cons_stall,
            "committed": float(self._committed),
            "released": float(self._released),
        }
