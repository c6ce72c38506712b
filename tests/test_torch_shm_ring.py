"""The port's shared-memory rings (``ddl_tpu_torch/transport/shm_ring.py``
over its own copy of ``shm_ring.cpp``) against the JAX package's.

The native ring and the Python fallback run the same operation script
and must agree step for step; a ring either package creates opens in the
other and serves the same slot bytes, payload counts and integrity
trailers (so the copied C layout stays the reference's); shutdown wakes a
blocked waiter; and a producer in a second process pumps windows through
a ring the test process drains.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from ddl_tpu import integrity as jint
from ddl_tpu.transport import shm_ring as jring
from ddl_tpu_torch import integrity as tint
from ddl_tpu_torch.exceptions import ShutdownRequested, StallTimeoutError
from ddl_tpu_torch.transport import shm_ring as tring

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = {"native": tring.NativeShmRing, "py": tring.PyShmRing}


@pytest.fixture
def make_ring():
    """Creates port rings by kind; unlinks their names afterwards."""
    made = []

    def make(kind, nslots=3, slot_bytes=64):
        ring = KINDS[kind].create(tring.make_ring_name("ddl-torch-test"),
                                  nslots, slot_bytes)
        made.append(ring)
        return ring

    yield make
    for ring in made:
        ring.unlink()


def _script(ring):
    """A fixed operation script over one ring; returns everything it saw."""
    seen = []
    for w in range(5):
        slot = ring.acquire_fill(timeout_s=1.0)
        ring.slot_view(slot)[:8] = w + 1
        ring.commit(slot, 8 + w)
        seen.append(("fill", slot))
        if w % 2:
            head = ring.acquire_drain(timeout_s=1.0)
            seen.append(("drain", head, ring.slot_payload(head),
                         bytes(ring.slot_view(head)[:8])))
            ring.release(head)
    # 5 committed, 2 released: the 3 slots are full.
    with pytest.raises(StallTimeoutError):
        ring.acquire_fill(timeout_s=0.0)
    seen.append(("ready", ring.poll_drain_ready(0), ring.poll_drain_ready(2),
                 ring.poll_drain_ready(3)))
    ahead = ring.acquire_drain_ahead(2, timeout_s=1.0)
    seen.append(("ahead", ahead, ring.slot_payload(ahead)))
    with pytest.raises(ValueError):
        ring.acquire_drain_ahead(ring.nslots)
    while ring.poll_drain_ready(0):
        head = ring.acquire_drain(timeout_s=1.0)
        seen.append(("drain", head, ring.slot_payload(head),
                     bytes(ring.slot_view(head)[:8])))
        ring.release(head)
    st = ring.stats()
    seen.append(("stats", st["committed"], st["released"]))
    assert st["producer_stall_s"] >= 0 and st["consumer_stall_s"] >= 0
    return seen


def test_native_and_python_rings_run_the_same_script(make_ring):
    native = _script(make_ring("native"))
    py = _script(make_ring("py"))
    assert native == py
    assert native[-1] == ("stats", 5.0, 5.0)
    assert ("drain", 1, 9, bytes([2] * 8)) in native


@pytest.mark.parametrize("kind", ["native", "py"])
def test_shutdown_wakes_a_blocked_waiter(make_ring, kind):
    ring = make_ring(kind, nslots=2)
    errors = []

    def wait():
        try:
            ring.acquire_drain(timeout_s=30.0)
        except ShutdownRequested as e:
            errors.append(e)

    t = threading.Thread(target=wait)
    t.start()
    t.join(0.2)
    assert t.is_alive()  # parked on an empty ring
    ring.shutdown()
    t.join(10)
    assert not t.is_alive()
    assert len(errors) == 1 and ring.is_shutdown()


@pytest.mark.parametrize("kind", ["native", "py"])
@pytest.mark.parametrize("creator", ["reference", "port"])
def test_rings_interoperate_with_the_reference(kind, creator):
    """A ring created by one package opens in the other: the same slot
    bytes, payload counts and trailers, each side's counters moving the
    other's."""
    name = tring.make_ring_name("ddl-torch-interop")
    ref_cls = {"native": jring.NativeShmRing, "py": jring.PyShmRing}[kind]
    port_cls = KINDS[kind]
    if creator == "reference":
        prod = ref_cls.create(name, 2, 4096 + 32)
        cons = port_cls.open(name)
        stamp, verify = jint.write_header, tint.verify_window
    else:
        prod = port_cls.create(name, 2, 4096 + 32)
        cons = ref_cls.open(name)
        stamp, verify = tint.write_header, jint.verify_window
    try:
        assert (cons.nslots, cons.slot_bytes) == (2, 4096 + 32)
        rng = np.random.default_rng(7)
        for seq in range(4):
            slot = prod.acquire_fill(timeout_s=1.0)
            view = prod.slot_view(slot)
            view[:4096] = rng.integers(0, 256, 4096, dtype=np.uint8)
            stamp(view, 4096, seq=seq, producer_idx=3,
                  crc=tint.window_crc(view[:4096]))
            prod.commit(slot, 4096)
            got = cons.acquire_drain(timeout_s=1.0)
            assert got == slot
            assert cons.slot_payload(got) == 4096
            assert bytes(cons.slot_view(got)) == bytes(view)
            assert verify(cons.slot_view(got), 4096, expect_seq=seq,
                          expect_producer=3) is None
            cons.release(got)
        assert prod.stats()["released"] == 4.0
        cons.shutdown()
        assert prod.is_shutdown()
    finally:
        prod.unlink()


def test_mapping_covers_every_slot(make_ring):
    for kind in KINDS:
        ring = make_ring(kind, nslots=3, slot_bytes=1000)
        base, nbytes = ring.mapping()
        assert base % 4096 == 0
        for slot in range(3):
            addr = ring.slot_base(slot)
            assert addr == ring.slot_view(slot).ctypes.data
            assert base <= addr and addr + 1000 <= base + nbytes


_PRODUCER = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from ddl_tpu_torch import integrity
from ddl_tpu_torch.exceptions import ShutdownRequested
from ddl_tpu_torch.transport.shm_ring import NativeShmRing

ring = NativeShmRing.open(sys.argv[2])
try:
    for seq in range(int(sys.argv[3])):
        slot = ring.acquire_fill(timeout_s=30.0)
        view = ring.slot_view(slot)
        view[:256] = np.arange(256, dtype=np.uint8) ^ (seq & 0xFF)
        integrity.write_header(view, 256, seq=seq, producer_idx=1,
                               crc=integrity.window_crc(view[:256]))
        ring.commit(slot, 256)
    ring.acquire_fill(timeout_s=30.0)  # the ring is full: parks here
    sys.exit(3)  # not reached: the consumer shuts the ring down
except ShutdownRequested:
    sys.exit(0)
"""


def test_two_process_pump(make_ring):
    """A second process fills windows into a native ring the test drains
    and verifies; the consumer's shutdown wakes it, parked on a full
    ring, and it exits 0."""
    ring = make_ring("native", nslots=2, slot_bytes=256 + tint.HEADER_BYTES)
    n = 16
    # The child commits two windows past the n drained: the ring is full.
    child = subprocess.Popen(
        [sys.executable, "-c", _PRODUCER, REPO, ring.name, str(n + 2)],
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    try:
        for seq in range(n):
            slot = ring.acquire_drain(timeout_s=60.0)
            view = ring.slot_view(slot)
            assert tint.verify_window(view, ring.slot_payload(slot),
                                      expect_seq=seq, expect_producer=1) is None
            want = np.arange(256, dtype=np.uint8) ^ (seq & 0xFF)
            assert np.array_equal(view[:256], want)
            ring.release(slot)
        while ring.stats()["committed"] - ring.stats()["released"] < 2:
            assert child.poll() is None
            threading.Event().wait(0.01)
        ring.shutdown()
        assert child.wait(timeout=60) == 0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(10)


def test_producer_connection_creates_and_attaches_rings():
    """A PROCESS producer's connection creates a named shm ring and hands
    the consumer its name; another endpoint attaches to it by that name;
    a clean finalize unlinks the name."""
    from ddl_tpu_torch.transport.connection import (
        ProducerConnection,
        ThreadChannel,
    )
    from ddl_tpu_torch.types import MetaData_Producer_To_Consumer

    mine, theirs = ThreadChannel.pair()
    conn = ProducerConnection(mine, 1, cross_process=True)
    ring = conn.create_ring(2, 64)
    reply = MetaData_Producer_To_Consumer(1, 4, 4, (4, 4), (4,), 1)
    conn.send_metadata(reply)
    name = theirs.recv(timeout_s=5).ring_ref
    assert isinstance(name, str) and name == ring.name
    other = ProducerConnection(ThreadChannel.pair()[0], 1, cross_process=True)
    attached = other.attach_ring(name)
    slot = ring.acquire_fill(timeout_s=1.0)
    ring.slot_view(slot)[:3] = [7, 8, 9]
    ring.commit(slot, 3)
    assert attached.acquire_drain(timeout_s=1.0) == slot
    assert bytes(attached.slot_view(slot)[:3]) == bytes([7, 8, 9])
    conn.finalize(unlink=True)
    assert not os.path.exists(f"/dev/shm/{name.lstrip('/')}")
