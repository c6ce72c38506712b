"""Acked control envelopes: at-least-once delivery with dedup for the
control plane (port of ``ddl_tpu/transport/envelope.py``).

- **At-least-once.**  :class:`ControlSender` wraps each payload in a
  :class:`~ddl_tpu_torch.types.ControlEnvelope` carrying ``(incarnation,
  seq)`` and re-sends it until acked, the backoff doubling from
  ``DDL_TORCH_CTRL_BACKOFF_S`` up to ``DDL_TORCH_CTRL_RETRIES`` re-sends.
- **Dedup.**  :class:`EnvelopeReceiver` suppresses re-deliveries by
  ``(incarnation, seq)``: a duplicate is acked again (the sender's
  retries must end) but never applied twice.
- **Fencing.**  Every envelope carries the sender's fencing term; a
  receiver that has seen a newer one drops the payload unapplied and
  still acks it.

:class:`ControlSender` holds no lock: the
:class:`~ddl_tpu_torch.transport.connection.ConsumerConnection` runs every
sender operation under its ``transport.connection`` lock.
:class:`EnvelopeReceiver` lives on the producer's one control thread
(``DataPusher._poll_control``) and needs none.  Each wire attempt passes
the ``transport.control_send`` fault site (:mod:`ddl_tpu_torch.faults`).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ddl_tpu_torch import envspec
from ddl_tpu_torch.exceptions import TransportError
from ddl_tpu_torch.faults import FaultKind, fault_point
from ddl_tpu_torch.types import ControlAck, ControlEnvelope


class _Pending:
    """One unacked envelope: wire attempts so far and next retry due."""

    __slots__ = ("envelope", "attempts", "due", "backoff_s")

    def __init__(self, envelope: ControlEnvelope, due: float, backoff_s: float):
        self.envelope = envelope
        self.attempts = 1
        self.due = due
        self.backoff_s = backoff_s


class ControlSender:
    """Acked sender from the consumer to one producer.

    ``raw_send`` is the wire primitive (a closure over the live channel
    slot, so an elastic channel swap is transparent to pending retries);
    ``target`` names the producer for diagnostics.
    """

    def __init__(
        self,
        raw_send: Callable[[Any], None],
        target: int,
        incarnation: int = 0,
        metrics: Any = None,
        retries: Optional[int] = None,
        backoff_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._raw_send = raw_send
        self.target = target
        self.incarnation = int(incarnation)
        self.metrics = metrics
        self.retries = int(envspec.get("DDL_TORCH_CTRL_RETRIES", retries))
        self.backoff_s = float(envspec.get("DDL_TORCH_CTRL_BACKOFF_S",
                                           backoff_s))
        self._clock = clock
        self.fence = 0
        self._next_seq = 0
        # seq -> retry state; acks and the retry cap clear entries.
        self._pending: Dict[int, _Pending] = {}
        #: Envelopes that exhausted the retry cap unacked.
        self.exhausted: List[ControlEnvelope] = []

    def send(self, payload: Any) -> int:
        """Wrap ``payload`` in a fenced envelope, register it pending and
        make the first wire attempt.  Returns the envelope's seq."""
        seq = self._next_seq
        self._next_seq += 1
        env = ControlEnvelope(seq=seq, incarnation=self.incarnation,
                              fence=self.fence, payload=payload)
        self._pending[seq] = _Pending(
            env, due=self._clock() + self.backoff_s, backoff_s=self.backoff_s
        )
        self._wire(env)
        return seq

    def _wire(self, env: ControlEnvelope) -> None:
        """One wire attempt.  A lost attempt (a broken or closed pipe
        mid-swap, or the ``transport.control_send`` site's drop or
        partition) leaves the envelope pending for :meth:`pump`; the
        site's ``CONTROL_MSG_DUP`` sends it twice, for the receiver's
        dedup to absorb."""
        try:
            fired = fault_point("transport.control_send",
                                producer_idx=self.target)
            self._raw_send(env)
            if fired and FaultKind.CONTROL_MSG_DUP.value in fired:
                self._raw_send(env)
                self._incr("ctrl.wire_dups")
        except (TransportError, OSError, ValueError):
            self._incr("ctrl.wire_drops")

    def pump(self, now: Optional[float] = None) -> int:
        """Re-send every due unacked envelope, doubling its backoff.
        Past the retry cap an envelope moves to :attr:`exhausted` and is
        counted.  Returns the number re-sent."""
        now = self._clock() if now is None else now
        resent = 0
        for seq in sorted(self._pending):
            p = self._pending.get(seq)
            if p is None or p.due > now:
                continue
            if p.attempts > self.retries:
                del self._pending[seq]
                self.exhausted.append(p.envelope)
                self._incr("ctrl.send_exhausted")
                continue
            p.attempts += 1
            p.backoff_s *= 2.0
            p.due = now + p.backoff_s
            self._wire(p.envelope)
            resent += 1
        if resent:
            self._incr("ctrl.retries", resent)
        return resent

    def ack(self, ack: ControlAck) -> bool:
        """Route one :class:`ControlAck` back; True when it cleared a
        pending envelope (stale or foreign acks are counted)."""
        if ack.incarnation != self.incarnation:
            self._incr("ctrl.stale_acks")
            return False
        p = self._pending.pop(ack.seq, None)
        if p is None:
            self._incr("ctrl.stale_acks")
            return False
        self._incr("ctrl.acked")
        if ack.dup:
            self._incr("ctrl.acked_dup")
        if ack.fence_rejected:
            self._incr("ctrl.fence_rejected")
        return True

    def pending_count(self) -> int:
        return len(self._pending)

    def _incr(self, name: str, value: float = 1.0) -> None:
        if self.metrics is not None:
            self.metrics.incr(name, value)


class EnvelopeReceiver:
    """Producer-side unwrap: dedup, fencing and the ack.

    ``accept`` returns ``(payload, ack)``: ``payload`` is the command to
    apply once (``None`` for a duplicate or a fenced-off command), and
    ``ack`` always goes back on the wire.
    """

    #: Per-incarnation dedup window: seqs this far behind the newest are
    #: forgotten.
    WINDOW = 4096

    def __init__(self, producer_idx: int = 0):
        self.producer_idx = int(producer_idx)
        #: Highest fencing term observed; commands below it are dropped.
        self.fence = 0
        self.dups = 0
        self.fence_drops = 0
        self.accepted = 0
        # incarnation -> seen seqs; the two newest incarnations only.
        self._seen: Dict[int, Set[int]] = {}

    def _seen_set(self, incarnation: int) -> Set[int]:
        seen = self._seen.get(incarnation)
        if seen is None:
            seen = self._seen[incarnation] = set()
            if len(self._seen) > 2:
                for inc in sorted(self._seen)[:-2]:
                    del self._seen[inc]
        return seen

    def _mark(self, seen: Set[int], seq: int) -> None:
        seen.add(seq)
        if len(seen) > self.WINDOW:
            seen.discard(min(seen))

    def accept(self, env: ControlEnvelope) -> Tuple[Optional[Any], ControlAck]:
        ack = ControlAck(seq=env.seq, incarnation=env.incarnation,
                         producer_idx=self.producer_idx)
        if env.fence < self.fence:
            self.fence_drops += 1
            ack.fence_rejected = True
            return None, ack
        self.fence = max(self.fence, env.fence)
        seen = self._seen_set(env.incarnation)
        if env.seq in seen:
            self.dups += 1
            ack.dup = True
            return None, ack
        self._mark(seen, env.seq)
        self.accepted += 1
        return env.payload, ack

    def seed(self, incarnation: int, seq: int) -> None:
        """Pre-mark ``(incarnation, seq)`` as applied, so a retry of a
        command applied before a rebuild dedups here."""
        self._mark(self._seen_set(incarnation), int(seq))
