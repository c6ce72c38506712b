"""The port's staged ingest engine (``ddl_tpu_torch/staging.py``) on the
CPU: the cases of the JAX package's ``tests/test_staging.py``, with torch
CPU tensors for device values and ``Transfer`` objects (value + event)
for the transfers the pool and executor poll.

Pool and executor run against fake events (``query``/``synchronize``),
so their concurrency contract is checked in microseconds; the loader
halves force ``staged=True`` (the CPU default keeps the stream inline)
and hold the port's staged streams to its inline ones and to the JAX
package's staged streams.
"""

import time

import numpy as np
import pytest
import torch

import ddl_tpu
import ddl_tpu_torch
from ddl_tpu_torch import DataProducerOnInitReturn, ProducerFunctionSkeleton
from ddl_tpu_torch.exceptions import LoaderStateError, ShutdownRequested
from ddl_tpu_torch.ingest import DeviceIngestor, Transfer
from ddl_tpu_torch.observability import Metrics
from ddl_tpu_torch.staging import (
    StagedIngestEngine,
    StagingPool,
    TransferExecutor,
    shm_staging_enabled,
    staged_enabled,
)


class FakeEvent:
    """A CUDA event's completion interface."""

    def __init__(self, ready=True):
        self.ready = ready

    def query(self):
        return self.ready

    def synchronize(self):
        self.ready = True


def _done(value=None, ready=True):
    return Transfer(value, FakeEvent(ready))


# -- StagingPool ----------------------------------------------------------------


def test_pool_miss_then_reuse_hit():
    m = Metrics()
    pool = StagingPool(metrics=m)
    a = pool.acquire((4, 4), np.float32)
    assert m.counter("staging.pool_misses") == 1
    pool.recycle_when_ready(a, _done())
    pool.recycle_when_ready(pool.acquire((4, 4), np.float32), _done())
    assert pool.sweep() == 2
    b = pool.acquire((4, 4), np.float32)
    assert m.counter("staging.pool_hits") == 1
    assert b.shape == (4, 4) and b.dtype == np.float32
    pool.acquire((8,), np.int32)  # another geometry: fresh
    assert m.counter("staging.pool_misses") == 3


def test_pool_cap_bounds_the_free_list():
    pool = StagingPool(metrics=Metrics(), max_per_key=2)
    for b in [pool.acquire((2,), np.float32) for _ in range(4)]:
        pool.release(b)
    assert pool.stats()["free_buffers"] == 2


def test_pool_defers_recycling_until_the_event_fires():
    m = Metrics()
    pool = StagingPool(metrics=m)
    dev = _done(ready=False)
    pool.recycle_when_ready(pool.acquire((4,), np.float32), dev)
    pool.recycle_when_ready(pool.acquire((4,), np.float32), dev)
    assert pool.sweep() == 0  # the copy still reads the buffers
    dev.done.ready = True
    assert pool.sweep() == 2
    pool.acquire((4,), np.float32)
    assert m.counter("staging.pool_hits") == 1
    assert m.timer("ingest.transfer").count == 2


def test_pool_drops_a_buffer_the_transfer_aliased():
    """A value living in the staging memory (a CPU tensor over it) must
    never return to the pool: reuse would corrupt it."""
    m = Metrics()
    pool = StagingPool(metrics=m)
    a = pool.acquire((4,), np.float32)
    pool.recycle_when_ready(a, Transfer(torch.from_numpy(a)))
    b = pool.acquire((4,), np.float32)
    pool.recycle_when_ready(b, Transfer(torch.from_numpy(b.copy())))
    pool.sweep(block=True)
    assert m.counter("staging.pool_alias_drops") == 1
    assert pool.stats()["free_buffers"] == 1


# -- TransferExecutor -----------------------------------------------------------


def _np_transfer(results):
    """A transfer that copies into a fresh CPU tensor, like device_put."""

    def transfer(buf):
        out = torch.from_numpy(buf.copy())
        results.append(out)
        return out, Transfer(out)

    return transfer


def _executor(max_queue=4):
    m = Metrics()
    return TransferExecutor(StagingPool(metrics=m), metrics=m,
                            max_queue=max_queue)


def test_executor_completes_jobs_in_fifo_order():
    ex = _executor(8)
    tr = _np_transfer([])
    handles = [ex.submit(np.full((4,), i, np.float32), tr) for i in range(6)]
    assert [float(ex.complete(h)[0]) for h in handles] == [0, 1, 2, 3, 4, 5]
    ex.close()


def test_copy_done_precedes_the_result():
    ex = _executor()
    h = ex.submit(np.zeros((2,), np.float32), _np_transfer([]))
    ex.complete(h)
    assert h.copy_done.is_set()
    ex.close()


def test_shutdown_mid_queue_propagates():
    """close() with a queued, unclaimed job: its handle raises
    ShutdownRequested (never hangs), and later submits refuse."""
    ex = _executor()
    # One job stays below worker_min_depth (2): guaranteed unclaimed.
    h = ex.submit(np.zeros((2,), np.float32), _np_transfer([]))
    ex.close()
    with pytest.raises(ShutdownRequested):
        h.result(timeout_s=5)
    assert h.copy_done.is_set()
    with pytest.raises(ShutdownRequested):
        ex.submit(np.zeros((2,), np.float32), _np_transfer([]))


def test_worker_takes_jobs_from_a_deep_queue():
    ex = _executor(8)
    ex.worker_min_depth = 1  # eager worker: deterministic
    handles = [ex.submit(np.full((4,), i, np.float32), _np_transfer([]))
               for i in range(4)]
    deadline = time.time() + 10
    while not all(h.ready.is_set() for h in handles):
        assert time.time() < deadline, "worker never drained the queue"
        time.sleep(0.01)
    assert [float(ex.complete(h)[0]) for h in handles] == [0, 1, 2, 3]
    assert all(h.worker_executed for h in handles)
    ex.close()


def test_max_queue_one_does_not_deadlock():
    ex = _executor(1)
    tr = _np_transfer([])
    for i in range(3):
        h = ex.submit(np.full((2,), i, np.float32), tr)
        assert float(ex.complete(h, timeout_s=10)[0]) == float(i)
    ex.close()


def test_flush_copies_forces_queued_copies():
    """flush_copies is the slot-release barrier: a queued job's copy has
    happened by its return, so the source slot may be overwritten."""
    ex = _executor()
    results = []
    src = np.full((4,), 7.0, np.float32)
    h = ex.submit(src, _np_transfer(results))
    ex.flush_copies()
    assert h.copy_done.is_set()
    src[:] = 0.0  # the producer refills after the release
    np.testing.assert_array_equal(results[0].numpy(), np.full((4,), 7.0))
    ex.close()


def test_transfer_error_propagates():
    ex = _executor()
    ex._max_retries = 0

    def boom(buf):
        raise ValueError("bad transfer")

    h = ex.submit(np.zeros((2,), np.float32), boom)
    with pytest.raises(ValueError, match="bad transfer"):
        ex.complete(h)
    assert ex.faulted
    ex.close()


def test_copy_crc_mismatch_is_retried_then_counted():
    """The staging copy is verified against the committed CRC; a copy
    that never matches fails after its retries, each counted."""
    ex = _executor()
    ex._max_retries = 1
    h = ex.submit(np.zeros((4,), np.float32), _np_transfer([]),
                  expected_crc=12345)
    with pytest.raises(ddl_tpu_torch.exceptions.IntegrityError):
        ex.complete(h)
    assert ex.metrics.counter("integrity.staging_verify_failures") == 2
    assert ex.metrics.counter("staging.retries") == 1
    ex.close()


# -- the alias route --------------------------------------------------------------


def test_alias_job_skips_the_pool_and_waits_for_the_event():
    m = Metrics()
    ex = TransferExecutor(StagingPool(metrics=m), metrics=m, max_queue=4)
    src = np.arange(16, dtype=np.float32)
    calls, events = [], []

    def transfer(buf):
        calls.append(buf)
        out = torch.from_numpy(np.array(buf))
        t = _done(out, ready=False)
        events.append(t.done)
        return out, t

    h = ex.submit(src, transfer, alias_src=True)
    val = ex.complete(h, timeout_s=10)
    np.testing.assert_array_equal(val.numpy(), src)
    assert calls[0] is src  # sourced the slot itself
    assert events[0].ready  # copy_done came after the event's wait
    assert h.copy_done.is_set()
    assert m.counter("staging.pool_misses") == 0
    assert m.counter("staging.alias_windows") == 1
    assert not ex.alias_unsafe
    ex.close()


def test_aliasing_transfer_is_detected_and_latched():
    m = Metrics()
    ex = TransferExecutor(StagingPool(metrics=m), metrics=m, max_queue=4)
    src = np.arange(16, dtype=np.float32)
    seen = []

    def transfer(buf):
        seen.append(buf)
        out = torch.from_numpy(buf)  # wraps the host memory: no copy
        return out, Transfer(out)

    h = ex.submit(src, transfer, alias_src=True)
    val = ex.complete(h, timeout_s=10)
    np.testing.assert_array_equal(val.numpy(), src)
    assert ex.alias_unsafe
    assert m.counter("staging.alias_fallbacks") == 1
    assert len(seen) == 2 and seen[0] is src and seen[1] is not src
    h2 = ex.submit(src, transfer, alias_src=True)
    ex.complete(h2, timeout_s=10)
    assert seen[2] is not src  # later alias jobs take the pool
    assert m.counter("staging.alias_windows") == 0
    ex.close()


def test_alias_transfer_failure_salvages_a_copy_of_the_slot():
    eng = StagedIngestEngine(metrics=Metrics())
    eng.executor._max_retries = 0
    src = np.arange(16, dtype=np.float32)

    def transfer(buf):
        raise RuntimeError("link down")

    h = eng.submit(src, transfer, alias_src=True)
    served = eng.complete_or_salvage(h, lambda buf: np.array(buf, copy=True),
                                     timeout_s=10)
    np.testing.assert_array_equal(served, src)
    assert h.salvage is not None and not np.shares_memory(h.salvage, src)
    assert eng.faulted
    assert eng.metrics.counter("staging.inline_fallbacks") == 1
    eng.close()


# -- the staged loader ------------------------------------------------------------


class TaggedWindowProducer(ProducerFunctionSkeleton):
    """Each window uniformly tagged producer_idx * 1000 + iteration."""

    inplace_fill = True

    def on_init(self, producer_idx=0, **kw):
        self.idx = producer_idx
        self.iteration = 0
        return DataProducerOnInitReturn(nData=32, nValues=4, shape=(32, 4),
                                        splits=(3, 1))

    def post_init(self, my_ary, **kw):
        my_ary[:] = self.idx * 1000

    def execute_function(self, my_ary, **kw):
        self.iteration += 1
        my_ary[:] = self.idx * 1000 + self.iteration


class JaxTaggedWindowProducer(ddl_tpu.ProducerFunctionSkeleton):
    inplace_fill = True

    def on_init(self, producer_idx=0, **kw):
        self.idx = producer_idx
        self.iteration = 0
        return ddl_tpu.DataProducerOnInitReturn(nData=32, nValues=4,
                                                shape=(32, 4), splits=(3, 1))

    def post_init(self, my_ary, **kw):
        my_ary[:] = self.idx * 1000

    def execute_function(self, my_ary, **kw):
        self.iteration += 1
        my_ary[:] = self.idx * 1000 + self.iteration


class SeqProducer(ProducerFunctionSkeleton):
    def on_init(self, producer_idx=0, **kw):
        return DataProducerOnInitReturn(nData=32, nValues=4, shape=(32, 4),
                                        splits=(3, 1))

    def post_init(self, my_ary, **kw):
        my_ary[:, -1] = np.arange(32)
        my_ary[:, :-1] = np.arange(32)[:, None] * 0.5


def _tags(win):
    vals = np.unique(np.asarray(win))
    assert len(vals) == 1
    return float(vals[0])


def _window_tags(n_epochs, lookahead, metrics=None, **loader_kw):
    @ddl_tpu_torch.distributed_dataloader(n_producers=2, mode="thread",
                                          nslots=4, pin_memory=False)
    def main(env):
        loader = ddl_tpu_torch.DistributedDataLoader(
            TaggedWindowProducer(), batch_size=8, connection=env.connection,
            n_epochs=n_epochs, output="device", device="cpu",
            metrics=metrics or Metrics(), **loader_kw,
        )
        tags = []
        for win in loader.windows(lookahead=lookahead):
            tags.append(_tags(win))
            loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
        return tags

    return main()


def _jax_window_tags(n_epochs, lookahead):
    @ddl_tpu.distributed_dataloader(n_producers=2, mode="thread", nslots=4)
    def main(env):
        loader = ddl_tpu.DistributedDataLoader(
            JaxTaggedWindowProducer(), batch_size=8,
            connection=env.connection, n_epochs=n_epochs, output="jax",
            staged=True,
        )
        tags = []
        for win in loader.windows(lookahead=lookahead):
            tags.append(_tags(win))
            loader.mark(ddl_tpu.Marker.END_OF_EPOCH)
        return tags

    return main()


def test_staged_and_inline_window_streams_equal_the_reference():
    m = Metrics()
    staged = _window_tags(6, 2, metrics=m, staged=True)
    inline = _window_tags(6, 2, staged=False)
    assert staged == inline == _jax_window_tags(6, 2) == [
        1001.0, 2001.0, 1002.0, 2002.0, 1003.0, 2003.0]
    assert m.counter("staging.pool_misses") + m.counter("staging.pool_hits") == 6


def test_staged_prefetch_matches_inline_batches():
    def run(staged):
        @ddl_tpu_torch.distributed_dataloader(n_producers=2, mode="thread",
                                              pin_memory=False)
        def main(env):
            loader = ddl_tpu_torch.DistributedDataLoader(
                SeqProducer(), batch_size=8, connection=env.connection,
                n_epochs=2, output="device", device="cpu", staged=staged,
                metrics=Metrics(),
            )
            out = []
            for _ in range(2):
                for x, y in loader.prefetch(2):
                    out.append((x.numpy().tobytes(), y.numpy().tobytes()))
                    loader.mark(ddl_tpu_torch.Marker.END_OF_BATCH)
                loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
            return out

        return main()

    staged = run(True)
    assert len(staged) == 8
    assert staged == run(False)


def test_staged_break_resume_serves_the_orphan_stash():
    """An early-released, never-yielded lookahead window survives in the
    loader's orphan stash, and the next stream serves it first."""

    @ddl_tpu_torch.distributed_dataloader(n_producers=1, mode="thread",
                                          nslots=4, pin_memory=False)
    def main(env):
        loader = ddl_tpu_torch.DistributedDataLoader(
            TaggedWindowProducer(), batch_size=8, connection=env.connection,
            n_epochs=6, output="device", device="cpu", staged=True,
            metrics=Metrics(),
        )
        # An eager worker completes the lookahead copies in the
        # background, which arms the early release.
        loader._ingestor.engine().executor.worker_min_depth = 1
        tags = []
        stream = loader.windows(lookahead=2)
        for _ in range(2):
            tags.append(_tags(next(stream)))
            loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
        deadline = time.time() + 10
        while not loader._staged_orphans:
            assert time.time() < deadline, "early release never armed"
            time.sleep(0.05)
            tags.append(_tags(next(stream)))
            loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
        orphaned = len(loader._staged_orphans)
        # The batch path cannot serve windows that left their slots.
        with pytest.raises(LoaderStateError, match="staged windows"):
            loader._host_batch(0)
        for win in loader.windows(lookahead=2):  # abandon, then resume
            tags.append(_tags(win))
            loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
        return tags, orphaned, loader._staged_orphans

    tags, orphaned, left = main()
    assert tags == [1001.0, 1002.0, 1003.0, 1004.0, 1005.0, 1006.0]
    assert orphaned >= 1 and left == []


def test_shutdown_closes_the_engine():
    @ddl_tpu_torch.distributed_dataloader(n_producers=1, mode="thread",
                                          nslots=2, pin_memory=False)
    def main(env):
        loader = ddl_tpu_torch.DistributedDataLoader(
            TaggedWindowProducer(), batch_size=8, connection=env.connection,
            n_epochs=6, output="device", device="cpu", staged=True,
            metrics=Metrics(),
        )
        next(loader.windows(lookahead=1))
        loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
        loader.shutdown()
        engine = loader._ingestor._engine
        assert engine is not None and engine.executor.closed
        assert engine.pool.stats()["inflight"] == 0

    main()


def test_alias_stream_over_page_locked_slots(monkeypatch):
    """The alias route forced on the CPU (slots claimed page-locked): every
    window's transfer sources its slot, the per-transfer alias check finds
    the copy genuine, and the stream equals the inline one."""
    monkeypatch.setattr(DeviceIngestor, "stream_alias",
                        property(lambda self: True))
    m = Metrics()

    @ddl_tpu_torch.distributed_dataloader(n_producers=2, mode="thread",
                                          nslots=4, pin_memory=False)
    def main(env):
        loader = ddl_tpu_torch.DistributedDataLoader(
            TaggedWindowProducer(), batch_size=8, connection=env.connection,
            n_epochs=6, output="device", device="cpu", metrics=m,
            staged=True,
        )
        for ring in loader.connection.rings:
            ring.page_locked = True
        tags = []
        for win in loader.windows(lookahead=2):
            tags.append(_tags(win))
            loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
        return tags

    assert main() == [1001.0, 2001.0, 1002.0, 2002.0, 1003.0, 2003.0]
    assert m.counter("staging.alias_windows") == 6
    assert m.counter("staging.alias_fallbacks") == 0
    assert m.counter("staging.pool_misses") == 0


# -- gates ------------------------------------------------------------------------


def test_env_gates(monkeypatch):
    monkeypatch.delenv("DDL_TORCH_STAGED", raising=False)
    monkeypatch.delenv("DDL_TORCH_SHM_STAGING", raising=False)
    assert staged_enabled() is True and shm_staging_enabled() is True
    assert staged_enabled(False) is False
    monkeypatch.setenv("DDL_TORCH_STAGED", "0")
    monkeypatch.setenv("DDL_TORCH_SHM_STAGING", "off")
    assert staged_enabled() is False and shm_staging_enabled() is False
    assert staged_enabled(True) is True
    assert DeviceIngestor(device="cpu").stream_staged is False


def test_cpu_defaults_inline_unless_forced():
    ing = DeviceIngestor(device="cpu")
    assert ing.staged and not ing.stream_staged and not ing.batch_staged
    assert not ing.stream_alias
    forced = DeviceIngestor(device="cpu", staged=True)
    assert forced.stream_staged and forced.batch_staged
    assert not forced.stream_alias  # the alias route is the card's
    assert not DeviceIngestor(device="cpu", staged=False).stream_staged


def test_knob_defaults_match_the_reference():
    from ddl_tpu import envspec as jenv
    from ddl_tpu_torch import envspec as tenv

    for name in ("FORCE_PY_RING", "STAGED", "SHM_STAGING",
                 "STAGING_POOL_CAP", "STAGING_QUEUE", "STAGING_RETRIES"):
        assert (tenv.require(f"DDL_TORCH_{name}").default
                == jenv.require(f"DDL_TPU_{name}").default), name
