"""The port's acked control envelopes against the JAX package's
(``ddl_tpu.transport.envelope``): the same scripted wire — lost attempts,
duplicated deliveries, fenced-off senders, restarted incarnations — runs
through both packages' ``ControlSender`` and ``EnvelopeReceiver`` on a
fake clock, and every observable (what reached the wire, what was
applied, each ack, pending and exhausted envelopes, the ``ctrl.*``
counters) must be equal.  Exact comparison: the protocol has no floats
but the clock, which both runs share.
"""

import dataclasses

import pytest

from ddl_tpu.observability import Metrics as JaxMetrics
from ddl_tpu.transport import envelope as jenv
from ddl_tpu.types import ControlEnvelope as JaxEnvelope
from ddl_tpu_torch import envspec
from ddl_tpu_torch.observability import Metrics
from ddl_tpu_torch.transport import envelope as tenv
from ddl_tpu_torch.types import ControlAck, ControlEnvelope

COUNTERS = ("ctrl.wire_drops", "ctrl.retries", "ctrl.acked",
            "ctrl.acked_dup", "ctrl.stale_acks", "ctrl.fence_rejected",
            "ctrl.send_exhausted")

PACKAGES = {
    "jax": (jenv, JaxMetrics, JaxEnvelope),
    "torch": (tenv, Metrics, ControlEnvelope),
}


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _run_script(pkg, script, drop_attempts=(), retries=3, backoff_s=0.1):
    """Drive one package through ``script``: a list of ``("send",
    payload)``, ``("tick", dt)`` (advance the clock, pump), ``("deliver",
    n)`` (the receiver takes the oldest ``n`` wire items, duplicates
    included, and acks each back), ``("dup",)`` (re-deliver the newest
    wire item twice).  ``drop_attempts`` are the 1-based wire attempts
    that are lost.  Returns the trace of every observable."""
    mod, metrics_cls, _ = PACKAGES[pkg]
    wire, attempts, trace = [], [0], []

    def raw_send(env):
        attempts[0] += 1
        if attempts[0] in drop_attempts:
            raise OSError("wire attempt lost")
        wire.append(env)

    m, clock = metrics_cls(), Clock()
    tx = mod.ControlSender(raw_send, target=1, metrics=m, retries=retries,
                           backoff_s=backoff_s, clock=clock)
    rx = mod.EnvelopeReceiver(producer_idx=2)
    for step in script:
        if step[0] == "send":
            trace.append(("seq", tx.send(step[1])))
        elif step[0] == "tick":
            clock.t += step[1]
            trace.append(("resent", tx.pump()))
        elif step[0] == "dup":
            wire.append(wire[-1])
        else:
            for _ in range(step[1]):
                env = wire.pop(0)
                payload, ack = rx.accept(env)
                trace.append(("applied", payload,
                              dataclasses.astuple(ack), tx.ack(ack)))
        trace.append(("pending", tx.pending_count(), len(wire),
                      [dataclasses.astuple(e) for e in tx.exhausted]))
    trace.append(("counters", [m.counter(c) for c in COUNTERS],
                  rx.dups, rx.fence_drops, rx.accepted))
    return trace


SCRIPTS = {
    # A lost first attempt is absorbed by the backoff retry.
    "drop_then_retry": (
        [("send", "replay-3"), ("tick", 0.05), ("tick", 0.1),
         ("deliver", 1)], (1,)),
    # Two lost attempts inside a partition, then the link heals.
    "partition_heals": (
        [("send", "replay-1"), ("tick", 0.15), ("tick", 0.25),
         ("tick", 0.45), ("deliver", 1)], (1, 2)),
    # A duplicated delivery is applied once, acked twice.
    "duplicate": (
        [("send", "replay-0"), ("dup",), ("deliver", 2)], ()),
    # Every attempt lost: the cap moves the envelope to exhausted.
    "exhausted": (
        [("send", "replay-7")] + [("tick", 1.0)] * 6, tuple(range(1, 99))),
    # Acks out of order, then a retry whose ack is already stale.
    "interleaved": (
        [("send", "a"), ("send", "b"), ("tick", 0.11), ("deliver", 2),
         ("deliver", 2), ("tick", 5.0)], ()),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_sender_and_receiver_match_the_reference(name):
    script, drops = SCRIPTS[name]
    assert _run_script("torch", script, drops) == \
        _run_script("jax", script, drops)


def _receive(pkg, envelopes, seeds=()):
    mod, _, env_cls = PACKAGES[pkg]
    rx = mod.EnvelopeReceiver(producer_idx=1)
    for inc, seq in seeds:
        rx.seed(inc, seq)
    out = []
    for seq, inc, fence in envelopes:
        payload, ack = rx.accept(env_cls(seq=seq, incarnation=inc,
                                         fence=fence, payload=(seq, inc)))
        out.append((payload, dataclasses.astuple(ack), rx.fence))
    return out, (rx.dups, rx.fence_drops, rx.accepted)


@pytest.mark.parametrize("envelopes,seeds", [
    # The fence rule: a newer term drops an older sender's commands,
    # acked as fence_rejected.
    ([(0, 1, 2), (5, 0, 1), (1, 1, 2), (6, 0, 3)], ()),
    # Dedup per incarnation; a restarted sender's seq 0 applies again.
    ([(0, 0, 0), (0, 0, 0), (0, 1, 0), (1, 1, 0), (0, 1, 0)], ()),
    # Only the two newest incarnations are remembered.
    ([(0, 0, 0), (0, 1, 0), (0, 2, 0), (0, 0, 0), (0, 1, 0)], ()),
    # A seeded (already applied) envelope dedups on first sight.
    ([(3, 4, 0), (4, 4, 0)], ((4, 3),)),
])
def test_receiver_dedup_and_fence_match_the_reference(envelopes, seeds):
    assert _receive("torch", envelopes, seeds) == \
        _receive("jax", envelopes, seeds)


def test_dedup_window_forgets_the_oldest_like_the_reference():
    n = tenv.EnvelopeReceiver.WINDOW + 2
    assert n == jenv.EnvelopeReceiver.WINDOW + 2
    envelopes = [(s, 0, 0) for s in range(n)] + [(0, 0, 0), (n - 1, 0, 0)]
    got, counts = _receive("torch", envelopes)
    assert (got, counts) == _receive("jax", envelopes)
    assert got[-2][0] == (0, 0)  # forgotten: applied again
    assert got[-1][1][3]  # the newest still dedups


def test_knobs_keep_the_reference_defaults(monkeypatch):
    for name in ("DDL_TORCH_CTRL_RETRIES", "DDL_TORCH_CTRL_BACKOFF_S"):
        monkeypatch.delenv(name, raising=False)
    tx = tenv.ControlSender(lambda e: None, target=0)
    ref = jenv.ControlSender(lambda e: None, target=0)
    assert (tx.retries, tx.backoff_s) == (ref.retries, ref.backoff_s) == \
        (5, 0.02)
    monkeypatch.setenv("DDL_TORCH_CTRL_RETRIES", "9")
    monkeypatch.setenv("DDL_TORCH_CTRL_BACKOFF_S", "0.5")
    tx = tenv.ControlSender(lambda e: None, target=0)
    assert (tx.retries, tx.backoff_s) == (9, 0.5)
    assert envspec.get("DDL_TORCH_CTRL_BACKOFF_S") == 0.5
    # Explicit arguments win over the environment.
    tx = tenv.ControlSender(lambda e: None, target=0, retries=1,
                            backoff_s=0.25)
    assert (tx.retries, tx.backoff_s) == (1, 0.25)


def test_connection_routes_acks_to_the_senders():
    """The consumer's acked seam end to end over thread channels: a
    replay request reaches the producer end in an envelope, the
    producer's ack routes back through ``drain_acks`` and clears the
    pending send; an ack for an unknown producer is ignored."""
    from ddl_tpu_torch.transport.connection import (
        NOTHING, ConsumerConnection, ThreadChannel,
    )
    from ddl_tpu_torch.types import ReplayRequest

    a, b = ThreadChannel.pair()
    conn = ConsumerConnection([a])
    conn.control_metrics = m = Metrics()
    conn.request_replay(0, 7)
    env = b.recv(timeout_s=5)
    assert isinstance(env, ControlEnvelope)
    assert env.payload == ReplayRequest(seq=7)
    assert conn.control_sender(0).pending_count() == 1
    payload, ack = tenv.EnvelopeReceiver(producer_idx=1).accept(env)
    b.send(ack)
    assert conn.drain_acks() == 1
    assert conn.control_sender(0).pending_count() == 0
    assert m.counter("ctrl.acked") == 1
    assert not conn.note_ack(ControlAck(seq=0, incarnation=0,
                                        producer_idx=9))
    conn.finalize()
    assert conn.send_control_acked(0, "late") == -1
    assert conn.try_recv_control(0) is NOTHING
