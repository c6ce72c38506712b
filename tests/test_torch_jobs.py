"""A job's integrity namespace in the port's pusher and loader, against
the JAX package's (``ddl_tpu/serve/jobs.py``; ``datapusher.py`` stamps
``seq_base + iteration``, ``dataloader.py`` expects that slice).

- A producer function carrying ``seq_base = integrity_namespace(job)``
  stamps trailers byte-equal to the JAX package's, in THREAD mode and
  across a spawn (PROCESS mode), and the loader serves the stream
  untouched with the namespaced seqs as Python ints — bases reach
  2^64 - 2^32, past any signed 64-bit integer.
- A window stamped under one job's base, drained by a loader that
  expects another's, fails verification and takes the reference's
  quarantine ladder (re-requests, then ``IntegrityError``) with the
  reference's counters.
- A corrupt window under a namespace replays from the producer's own
  position: the replay request names the namespaced seq, the producer
  subtracts its base.
"""

import importlib

import numpy as np
import pytest

from ddl_tpu import faults as jfaults
from ddl_tpu_torch import faults as tfaults
from torch_recovery_producers import TagProducer

ROOTS = {"jax": "ddl_tpu", "torch": "ddl_tpu_torch"}


def _mod(pkg, name):
    return importlib.import_module(f"{ROOTS[pkg]}.{name}")


def _drain(pkg, producer, mode="thread", n_epochs=5, plan=None,
           timeout_s=30.0):
    """Drain ``n_epochs`` one-window epochs from one producer; per window
    the served bytes, the slot's trailer bytes and the loader's window
    seq; plus the integrity counters."""
    root = importlib.import_module(ROOTS[pkg])
    integrity = _mod(pkg, "integrity")
    m = _mod(pkg, "observability").Metrics()
    kw = {"pin_memory": False} if pkg == "torch" else {}

    @root.distributed_dataloader(n_producers=1, mode=mode, **kw)
    def main(env):
        loader = root.DistributedDataLoader(
            producer, batch_size=16, connection=env.connection,
            n_epochs=n_epochs, output="numpy", timeout_s=timeout_s,
            metrics=m)
        out = []
        for _ in range(n_epochs):
            for (win, _tag) in loader:
                ring = loader.connection.rings[loader._target]
                slot = loader._cur_slot
                at = ring.slot_payload(slot)
                trailer = bytes(ring.slot_view(slot)[
                    at:at + integrity.HEADER_BYTES])
                hdr = integrity.read_header(ring.slot_view(slot), at)
                out.append((np.array(win, copy=True).tobytes(), trailer,
                            hdr.seq))
                loader.mark(root.Marker.END_OF_BATCH)
            loader.mark(root.Marker.END_OF_EPOCH)
        return out

    if plan is None:
        out = main()
    else:
        with plan[0].armed(plan[1]):
            out = main()
    counters = {k: m.counter(k) for k in (
        "integrity.corrupt_windows", "integrity.replays",
        "integrity.replay_exhausted")}
    return out, counters


def _namespaced(pkg, job_id, **kw):
    p = TagProducer(pkg=ROOTS[pkg], fault_at=0, **kw)
    p.seq_base = _mod(pkg, "serve.jobs").integrity_namespace(job_id)
    return p


@pytest.mark.parametrize("job_id", ["job-b", "job-7"])
def test_thread_trailers_byte_equal_to_the_reference(job_id):
    base = _mod("torch", "serve.jobs").integrity_namespace(job_id)
    assert base == _mod("jax", "serve.jobs").integrity_namespace(job_id)
    got, counters = _drain("torch", _namespaced("torch", job_id))
    want, jcounters = _drain("jax", _namespaced("jax", job_id))
    assert got == want
    assert counters == jcounters and counters["integrity.corrupt_windows"] == 0
    seqs = [w[2] for w in got]
    assert seqs == [base + k for k in range(len(got))]
    assert all(type(s) is int for s in seqs)


def test_job_b_base_is_past_signed_64_bits():
    base = _mod("torch", "serve.jobs").integrity_namespace("job-b")
    assert 2 ** 63 < base < 2 ** 64 and base % 2 ** 32 == 0


def test_process_trailers_byte_equal_to_the_reference():
    """The base rides the producer function across the spawn: a spawned
    producer stamps the trailers the JAX package's THREAD producer does."""
    got, counters = _drain("torch", _namespaced("torch", "job-b"),
                           mode="process")
    want, _ = _drain("jax", _namespaced("jax", "job-b"))
    assert got == want
    assert counters["integrity.corrupt_windows"] == 0


class _Leak:
    """A producer whose namespace the consumer and the pusher read
    differently — the consumer (which reads it first, at construction)
    expects ``job-a``'s slice while the pusher stamps ``job-b``'s: every
    window arrives from the wrong job."""

    reads = 0

    def __init__(self, pkg):
        self.inner = TagProducer(pkg=ROOTS[pkg], fault_at=0)
        self.bases = [_mod(pkg, "serve.jobs").integrity_namespace(j)
                      for j in ("job-a", "job-b")]

    @property
    def seq_base(self):
        type(self).reads += 1
        return self.bases[0] if type(self).reads == 1 else self.bases[1]

    def on_init(self, **kw):
        return self.inner.on_init(**kw)

    def post_init(self, my_ary, **kw):
        return self.inner.post_init(my_ary, **kw)

    def execute_function(self, my_ary, **kw):
        return self.inner.execute_function(my_ary, **kw)

    def fast_forward(self, n, **kw):
        return self.inner.fast_forward(n, **kw)


def _leak(pkg):
    _Leak.reads = 0
    exc = _mod(pkg, "exceptions")
    with pytest.raises(exc.IntegrityError) as err:
        # Each re-request waits out the acquire's deadline for a window
        # that never comes: a short one keeps the ladder quick.
        _drain(pkg, _Leak(pkg), n_epochs=2, timeout_s=2.0)
    assert _Leak.reads == 2
    return str(err.value).split(":")[0], type(err.value).__name__


def test_window_from_another_job_is_quarantined_as_the_reference_does():
    got = _leak("torch")
    assert got == _leak("jax")
    assert got[1] == "IntegrityError"


def test_corrupt_window_under_a_namespace_replays_byte_identical():
    """RING_CORRUPTION of the second window of a ``job-b`` stream: the
    loader re-requests the namespaced seq, the producer replays from its
    own position, and the stream equals the clean one — as in the JAX
    package."""
    def run(pkg, fmod):
        plan = fmod.FaultPlan([fmod.FaultSpec(
            "producer.commit", fmod.FaultKind.RING_CORRUPTION, at=2,
            param=4)])
        return _drain(pkg, _namespaced(pkg, "job-b"), plan=(fmod, plan))

    got, counters = run("torch", tfaults)
    want, jcounters = run("jax", jfaults)
    clean, _ = _drain("torch", _namespaced("torch", "job-b"))
    assert [w[0] for w in got] == [w[0] for w in clean]
    assert got == want
    assert counters == jcounters
    assert counters["integrity.replays"] == 1
