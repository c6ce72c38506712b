"""The port's global-shuffle host tier against the JAX package's.

The same seeded pools go through ``ddl_tpu.shuffle`` and
``ddl_tpu_torch.shuffle``: the partner permutation, the post-exchange
pools (the four ``TestSeedParity`` geometries of
``tests/test_device_shuffle.py``), the peer-loss and suspension rungs of
the ladder, and a two-instance ``DataPusher`` + ``DistributedDataLoader``
drain must all agree byte for byte.  The drain harness here serves
``tests/test_torch_device_shuffle.py`` as well.
"""

import threading

import numpy as np
import pytest

from ddl_tpu import shuffle as jsh
from ddl_tpu_torch import shuffle as tsh
from ddl_tpu_torch.exceptions import DDLError, DoesNotMatchError, ShutdownRequested
from ddl_tpu_torch.observability import Metrics

SEED = 7
#: (n instances, pool rows, num_exchange): tests/test_device_shuffle.py:111-116.
GEOMETRIES = [(2, 16, 7), (3, 10, 10), (5, 9, 5), (8, 12, 6)]


def pools(n, rows, width=3):
    """Per-instance pools whose values encode (instance, row, col)."""
    return [
        np.arange(rows * width, dtype=np.float32).reshape(rows, width)
        + 10_000.0 * i
        for i in range(n)
    ]


def run_rounds(n, arys, rounds, make_shuffler, hooks=None, timeout=60):
    """One worker thread per instance, each running every round;
    ``hooks(round, shuffler)`` runs before each round."""
    shufs = [make_shuffler(i) for i in range(n)]
    errors = []

    def worker(i):
        try:
            for r in range(rounds):
                if hooks is not None:
                    hooks(r, shufs[i])
                shufs[i].global_shuffle(arys[i])
        except Exception as e:  # ddl-lint: disable=DDL007
            # Worker thread: capture, assert in the main thread.
            errors.append((i, e))

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "exchange workers hung"
    assert not errors, errors
    return shufs


def topology(pkg, n, i, mode="thread"):
    types = _pkg(pkg)["types"]
    return types.Topology(n_instances=n, instance_idx=i, n_producers=1,
                          mode=types.RunMode(mode))


def host_run(pkg, n, rows, num_exchange, rounds, arys=None, **kw):
    """Host-tier rounds of package ``pkg`` ("jax" | "torch")."""
    sh = jsh if pkg == "jax" else tsh
    rdv = sh.Rendezvous()
    arys = pools(n, rows) if arys is None else arys

    def make(i):
        s = sh.ThreadExchangeShuffler(topology(pkg, n, i), 1, num_exchange,
                                      rendezvous=rdv, seed=SEED, **kw)
        s.metrics = _pkg(pkg)["Metrics"]()
        return s

    return arys, run_rounds(n, arys, rounds, make)


def _pkg(pkg):
    """The modules of one package the harness drives."""
    if pkg == "jax":
        from ddl_tpu import datapusher, dataloader, types
        from ddl_tpu.datasetwrapper import DataProducerOnInitReturn
        from ddl_tpu.observability import Metrics as M
        from ddl_tpu.transport import connection
    else:
        from ddl_tpu_torch import datapusher, dataloader, types
        from ddl_tpu_torch.datasetwrapper import DataProducerOnInitReturn
        from ddl_tpu_torch.observability import Metrics as M
        from ddl_tpu_torch.transport import connection
    return dict(datapusher=datapusher, dataloader=dataloader, types=types,
                connection=connection, Init=DataProducerOnInitReturn, Metrics=M)


def producer_connection(pkg, end):
    conn = _pkg(pkg)["connection"]
    if pkg == "jax":
        return conn.ProducerConnection(end, 1, cross_process=False)
    return conn.ProducerConnection(end, 1)


class Tagged:
    """Rows tagged ``instance * 1000 + row``; each refill adds 1."""

    def __init__(self, init_cls, instance_idx, n_data):
        self.init_cls = init_cls
        self.instance_idx = instance_idx
        self.n_data = n_data

    def on_init(self, **kw):
        return self.init_cls(nData=self.n_data, nValues=2,
                             shape=(self.n_data, 2), splits=(1, 1))

    def post_init(self, my_ary, **kw):
        my_ary[:] = (self.instance_idx * 1000.0
                     + np.arange(self.n_data, dtype=np.float32)[:, None])

    def execute_function(self, my_ary, **kw):
        my_ary += 1.0


def drain(pkg, factory_of, n_instances=2, epochs=2, n_data=16,
          fraction=0.5, producer_of=None, output="numpy"):
    """Drain ``n_instances`` THREAD instances (one producer and one loader
    each) exchanging through ``factory_of()``: returns ``{instance:
    (served rows, pusher)}`` — the two-instance drain of
    tests/test_device_shuffle.py:404-489, for either package."""
    m = _pkg(pkg)
    types, conn = m["types"], m["connection"]
    producer_of = producer_of or (
        lambda i: Tagged(m["Init"], i, n_data))
    out, errors = {}, []

    def run_instance(i):
        try:
            topo = topology(pkg, n_instances, i)
            cons_end, prod_end = conn.ThreadChannel.pair()
            pconn = producer_connection(pkg, prod_end)
            pushers = {}

            def producer():
                pushers[i] = m["datapusher"].DataPusher(
                    pconn, topo, 1, shuffler_factory=factory_of(),
                    metrics=m["Metrics"](),
                )
                pushers[i].push_data()

            pt = threading.Thread(target=producer, daemon=True)
            pt.start()
            kw = {"device": "cpu"} if pkg == "torch" else {}
            loader = m["dataloader"].DistributedDataLoader(
                producer_of(i), batch_size=n_data,
                connection=conn.ConsumerConnection([cons_end]),
                n_epochs=epochs, output=output,
                global_shuffle_fraction_exchange=fraction,
                metrics=m["Metrics"](), **kw,
            )
            rows = []
            for _ in range(epochs):
                for (a, *_rest) in loader:
                    rows.append(np.array(a, copy=True))
                    loader.mark(types.Marker.END_OF_BATCH)
                loader.mark(types.Marker.END_OF_EPOCH)
            out[i] = (np.concatenate(rows), pushers.get(i))
            loader.shutdown()
            pt.join(30)
        except Exception as e:  # ddl-lint: disable=DDL007
            # Worker thread: capture, assert in the main thread.
            errors.append((i, e))

    ts = [threading.Thread(target=run_instance, args=(i,))
          for i in range(n_instances)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors
    return out


# -- the permutation ----------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 10))
def test_permutation_bit_identical(n):
    for seed in (0, 7, 12345, 2**31 + 5, 2**40 + 3):
        for round_ in (0, 1, 2, 17, 2**31 + 3):
            want = jsh.exchange_permutation(n, seed, round_)
            got = tsh.exchange_permutation(n, seed, round_)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(tsh.inverse_permutation(got),
                                          jsh.inverse_permutation(want))
            if n > 2:
                assert not np.any(got == np.arange(n))
                assert not np.any(got[got] == np.arange(n))


def test_exchange_slices_and_methods():
    assert tsh.EXCHANGE_METHODS == jsh.EXCHANGE_METHODS
    for k in range(12):
        assert tsh.exchange_slices(k) == jsh.exchange_slices(k)


# -- the host exchange ----------------------------------------------------------


@pytest.mark.parametrize("n,rows,num_exchange", GEOMETRIES)
def test_host_pools_byte_identical(n, rows, num_exchange):
    want, _ = host_run("jax", n, rows, num_exchange, rounds=3)
    got, shufs = host_run("torch", n, rows, num_exchange, rounds=3)
    for i in range(n):
        np.testing.assert_array_equal(got[i], want[i],
                                      err_msg=f"instance {i} diverged")
    # Rows really moved: every pool holds rows of another instance.
    for i in range(n):
        assert set((got[i][:, 0] // 10_000).astype(int)) - {i}
    assert all(s.exchange_round == 3 for s in shufs)


def test_exchange_conserves_samples():
    n, rows = 4, 12
    got, _ = host_run("torch", n, rows, 8, rounds=5)
    before = np.sort(np.concatenate(pools(n, rows)), axis=0)
    np.testing.assert_array_equal(np.sort(np.concatenate(got), axis=0), before)


def _lone(pkg, rounds=3, **kw):
    """A declared 2-instance topology with only instance 0 running."""
    sh = jsh if pkg == "jax" else tsh
    s = sh.ThreadExchangeShuffler(topology(pkg, 2, 0), 1, 6,
                                  rendezvous=sh.Rendezvous(), seed=SEED,
                                  max_peer_losses=2, exchange_timeout_s=0.2,
                                  **kw)
    s.metrics = _pkg(pkg)["Metrics"]()
    ary = pools(1, 10)[0]
    for _ in range(rounds):
        s.global_shuffle(ary)
    return ary, s


def test_peer_loss_degrades_like_the_reference():
    want, _ = _lone("jax")
    got, s = _lone("torch")
    np.testing.assert_array_equal(got, want)
    assert s.metrics.counter("shuffle.degraded") == 2
    assert s._degraded and s.exchange_round == 3


def test_peer_loss_raises_when_degrade_is_off():
    s = tsh.ThreadExchangeShuffler(topology("torch", 2, 0), 1, 6,
                                   rendezvous=tsh.Rendezvous(),
                                   exchange_timeout_s=0.05,
                                   degrade_on_peer_loss=False)
    with pytest.raises(DDLError, match="timed out"):
        s.global_shuffle(pools(1, 10)[0])


def test_suspend_resume_and_rejoin_like_the_reference():
    """Rounds 1-2 suspended (node-local), round 3 resumed; then a split
    run rejoined at round 2 equals the uninterrupted one."""
    def hooks(r, s):
        if r == 1:
            s.suspend_exchange()
        if r == 3:
            s.resume_exchange()

    results = {}
    for pkg, sh in (("jax", jsh), ("torch", tsh)):
        arys = pools(3, 10)
        rdv = sh.Rendezvous()
        shufs = run_rounds(3, arys, 5, lambda i: sh.ThreadExchangeShuffler(
            topology(pkg, 3, i), 1, 6, rendezvous=rdv, seed=SEED), hooks)
        results[pkg] = arys
        assert all(s.exchange_round == 5 and not s.exchange_suspended
                   for s in shufs)
    for a, b in zip(results["torch"], results["jax"]):
        np.testing.assert_array_equal(a, b)

    full, _ = host_run("torch", 3, 10, 6, rounds=4)
    split, _ = host_run("torch", 3, 10, 6, rounds=2)
    rdv = tsh.Rendezvous()

    def rejoined(i):
        s = tsh.ThreadExchangeShuffler(topology("torch", 3, i), 1, 6,
                                       rendezvous=rdv, seed=SEED)
        s.rejoin(2)
        return s

    run_rounds(3, split, 2, rejoined)
    for a, b in zip(split, full):
        np.testing.assert_array_equal(a, b)


def test_rendezvous_abort_retention_and_discard():
    rdv = tsh.Rendezvous()
    with pytest.raises(ShutdownRequested):
        rdv.take((1, 0, 0), timeout_s=5, should_abort=lambda: True)
    rows = np.arange(4.0)
    rdv.put((1, 0, 0), rows)
    assert rdv.take((1, 0, 0)) is rows
    assert rdv.take((1, 0, 0), timeout_s=0.01) is rows  # replayed take
    rdv.retire((1, 0, 0))
    with pytest.raises(DDLError, match="timed out"):
        rdv.take((1, 0, 0), timeout_s=0.01)
    rdv.put((1, 2, 0), rows)
    rdv.discard((1, 2, 0))
    with pytest.raises(DDLError):
        rdv.take((1, 2, 0), timeout_s=0.01)


def test_wire_formats_and_bad_method_are_refused():
    topo = topology("torch", 2, 0)
    with pytest.raises(NotImplementedError, match="wire.py"):
        tsh.ThreadExchangeShuffler(topo, 1, 4, wire_dtype="int8")
    with pytest.raises(NotImplementedError, match="wire.py"):
        tsh.ThreadExchangeShuffler.factory(codec="zlib")
    with pytest.raises(NotImplementedError):
        tsh.ThreadExchangeShuffler(topo, 1, 4, exchange_method="gossip")
    # raw is the only wire, named or defaulted
    assert tsh.ThreadExchangeShuffler(topo, 1, 4, wire_dtype="raw").span == "thread"


# -- the DataPusher hook ----------------------------------------------------------


class _Writer:
    """A write-once producer (advertises or forces inplace fill)."""

    def __init__(self, init_cls, forced):
        self.init_cls = init_cls
        if forced:
            self.inplace_fill = True
        else:
            self.supports_inplace_fill = True

    def on_init(self, **kw):
        return self.init_cls(nData=8, nValues=2, shape=(8, 2), splits=(2,))

    def execute_function(self, my_ary, **kw):
        my_ary[:] = 1.0


def _pusher(pkg, forced, fraction, n_instances=2):
    """Handshake one DataPusher of ``pkg`` without a running loader."""
    m = _pkg(pkg)
    cons_end, prod_end = m["connection"].ThreadChannel.pair()
    cons_end.send(m["types"].MetaData_Consumer_To_Producer(
        data_producer_function=_Writer(m["Init"], forced), batch_size=4,
        global_shuffle_fraction_exchange=fraction))
    sh = jsh if pkg == "jax" else tsh
    return m["datapusher"].DataPusher(
        producer_connection(pkg, prod_end), topology(pkg, n_instances, 0), 1,
        metrics=m["Metrics"](),
        shuffler_factory=sh.ThreadExchangeShuffler.factory(sh.Rendezvous()))


@pytest.mark.parametrize("fraction,n_instances", [(0.5, 2), (0.0, 2), (0.5, 1)])
def test_auto_inplace_resolves_like_the_reference(fraction, n_instances):
    """A write-once producer fills slots directly unless a shuffler is
    active; the shuffler gets the pusher's registry."""
    want = _pusher("jax", False, fraction, n_instances)
    got = _pusher("torch", False, fraction, n_instances)
    assert got.inplace_fill == want.inplace_fill
    assert (got.shuffler is None) == (want.shuffler is None)
    if got.shuffler is not None:
        assert got.shuffler.metrics is got.metrics
        assert got.shuffler.num_exchange == want.shuffler.num_exchange == 4
        assert got.callbacks[-1] is got.shuffler


def test_forced_inplace_with_a_shuffler_raises_like_the_reference():
    from ddl_tpu.exceptions import DoesNotMatchError as JaxMismatch

    with pytest.raises(JaxMismatch):
        _pusher("jax", True, 0.5)
    with pytest.raises(DoesNotMatchError, match="inplace_fill"):
        _pusher("torch", True, 0.5)
    assert _pusher("torch", True, 0.0).inplace_fill  # no shuffler: allowed


# -- end to end ------------------------------------------------------------------


def test_two_instance_host_drain_equals_the_reference():
    rdv_j, rdv_t = jsh.Rendezvous(), tsh.Rendezvous()
    want = drain("jax", lambda: jsh.ThreadExchangeShuffler.factory(rdv_j))
    got = drain("torch", lambda: tsh.ThreadExchangeShuffler.factory(rdv_t))
    for i in (0, 1):
        np.testing.assert_array_equal(got[i][0], want[i][0])
        origins = set((got[i][0][:, 0] // 1000).astype(int))
        assert origins == {0, 1}, f"instance {i} saw only {origins}"
        assert got[i][1].shuffler.exchange_round >= 2


def test_decorator_passes_the_factory_and_exchange_runs_first():
    """``distributed_dataloader(shuffler_factory=)`` reaches every
    producer; per refill the exchange runs before execute_function."""
    import ddl_tpu_torch
    from ddl_tpu_torch.datasetwrapper import DataProducerOnInitReturn
    from ddl_tpu_torch.env import WorkerSet

    calls = []

    class Recorder:
        def __init__(self, producer_idx, num_exchange, **kw):
            self.producer_idx, self.num_exchange = producer_idx, num_exchange

        def global_shuffle(self, my_ary, should_abort, **kw):
            assert not should_abort()
            calls.append(("shuffle", self.producer_idx))

    class P(Tagged):
        def execute_function(self, my_ary, **kw):
            calls.append(("fill", None))

    topo = ddl_tpu_torch.Topology(n_instances=2, instance_idx=0, n_producers=1)
    workers = WorkerSet(topo, 2, shuffler_factory=lambda **kw: Recorder(**kw))
    loader = ddl_tpu_torch.DistributedDataLoader(
        P(DataProducerOnInitReturn, 0, 8), batch_size=8,
        connection=workers.connection, n_epochs=3, output="numpy",
        global_shuffle_fraction_exchange=0.5, metrics=Metrics())
    for _ in range(3):
        for _batch in loader:
            loader.mark(ddl_tpu_torch.Marker.END_OF_BATCH)
        loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
    workers.abort()
    workers.join(timeout_s=30)
    assert calls[:4] == [("shuffle", 1), ("fill", None)] * 2
