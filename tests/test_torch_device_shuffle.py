"""The port's global-shuffle device tier against the JAX package's.

On the CPU the port's ``DeviceExchangeShuffler`` runs over a fabric on
``devices=["cpu"] * n``, where the exchange wrapper takes its plain
version.  It must give pools byte-identical to the reference's
``ThreadExchangeShuffler`` and to its ``DeviceExchangeShuffler(impl=
"xla")`` on the conftest's virtual CPU mesh (the reference's Pallas ring
is known-red in interpret mode, so it is no oracle here), and
``exchange_plain`` must equal the reference's ``exchange_xla`` on the
same global input.  The ladder (a failing device leg, an unplannable
ring — latched on the CPU ring, raised on a card ring — and a missing
peer), the resolution surface and two end-to-end drains follow.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import pickle
import threading
import time

import jax
import numpy as np
import pytest
import torch

from ddl_tpu import shuffle as jsh
from ddl_tpu.ops import device_shuffle as jdsh
from ddl_tpu_torch import shuffle as tsh
from ddl_tpu_torch.exceptions import DDLError, ShutdownRequested
from ddl_tpu_torch.observability import Metrics
from ddl_tpu_torch.ops import device_shuffle as tdsh
from ddl_tpu_torch.parallel import mesh as tmesh
from test_torch_shuffle import (
    GEOMETRIES,
    SEED,
    _pkg,
    drain,
    host_run,
    pools,
    run_rounds,
    topology,
)


def _device_shuffler(n, i, num_exchange, fabric, start_round=0, **kw):
    s = tsh.DeviceExchangeShuffler(topology("torch", n, i), 1, num_exchange,
                                   fabric=fabric, seed=SEED, **kw)
    s.metrics = Metrics()
    s.rejoin(start_round)
    return s


def device_run(n, rows, num_exchange, rounds, fabric=None, arys=None,
               start_round=0, **kw):
    """The port's device tier over ``fabric`` (default: ``["cpu"] * n``)."""
    fabric = fabric or tsh.DeviceExchangeFabric(devices=["cpu"] * n)
    rdv = tsh.Rendezvous()
    arys = pools(n, rows) if arys is None else arys
    return arys, run_rounds(n, arys, rounds, lambda i: _device_shuffler(
        n, i, num_exchange, fabric, start_round, rendezvous=rdv, **kw))


def device_round_errors(n, fabric):
    """One round of ``n`` device shufflers over ``fabric``, each in its own
    thread: returns (the exception each raised, the pools, the shufflers)."""
    rdv = tsh.Rendezvous()
    arys = pools(n, 10)
    shufs = [_device_shuffler(n, i, 6, fabric, rendezvous=rdv,
                              exchange_timeout_s=10.0) for i in range(n)]
    errors = {}

    def worker(i):
        try:
            shufs[i].global_shuffle(arys[i])
        except Exception as e:  # ddl-lint: disable=DDL007
            # Worker thread: capture, assert in the main thread.
            errors[i] = e

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts), "exchange workers hung"
    return errors, arys, shufs


def ref_device_run(n, rows, num_exchange, rounds):
    """The reference's device tier on its ``impl="xla"`` baseline."""
    from ddl_tpu.observability import Metrics as JaxMetrics

    fabric = jsh.DeviceExchangeFabric(impl="xla")
    rdv = jsh.Rendezvous()
    arys = pools(n, rows)

    def make(i):
        s = jsh.DeviceExchangeShuffler(topology("jax", n, i), 1, num_exchange,
                                       rendezvous=rdv, fabric=fabric,
                                       seed=SEED)
        s.metrics = JaxMetrics()
        return s

    run_rounds(n, arys, rounds, make)
    return arys


# -- the exchange function ------------------------------------------------------


@pytest.mark.parametrize("n,half,cols,dtype",
                         [(2, 3, 4, "float32"), (3, 5, 3, "int32"),
                          (5, 2, 7, "uint8"), (8, 4, 16, "float32")])
def test_exchange_plain_equals_reference_xla(n, half, cols, dtype):
    rng = np.random.default_rng(n)
    blocks = [rng.integers(0, 250, (2 * half, cols)).astype(dtype)
              for _ in range(n)]
    p = jsh.exchange_permutation(n, SEED, 3)
    routes = np.stack([p, jsh.inverse_permutation(p)])
    devices = jax.devices()[:n]
    want = np.asarray(jdsh.exchange_xla(
        jdsh.as_exchange_input(blocks, devices), devices, p))
    gin = tdsh.as_exchange_input(blocks, ["cpu"] * n)
    before = tdsh.exchange_ring.launches
    for got in (tdsh.exchange_plain(gin, routes),
                tdsh.exchange_ring(gin, ["cpu"] * n, routes)):
        assert got.dtype == gin.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    assert tdsh.exchange_ring.launches == before  # the CPU takes no kernel
    np.testing.assert_array_equal(
        np.concatenate(tdsh.exchange_output_blocks(
            tdsh.exchange_ring(gin, ["cpu"] * n, routes), ["cpu"] * n)), want)


def test_exchange_surface_refuses_bad_arguments():
    gin = torch.zeros(8, 2)
    with pytest.raises(ValueError, match="permutations"):
        tdsh.exchange_plain(gin, [[0, 0], [1, 0]])
    with pytest.raises(ValueError, match=r"\(2, 2\)"):
        tdsh.exchange_plain(gin, [[1, 0]])
    with pytest.raises(ValueError, match="n \\* 2\\*half"):
        tdsh.exchange_plain(torch.zeros(6, 2), [[1, 0], [1, 0]])
    with pytest.raises(ValueError, match="one lane block"):
        tdsh.as_exchange_input([np.zeros((2, 2))], ["cpu"] * 2)
    with pytest.raises(ValueError, match="share"):
        tdsh.as_exchange_input([np.zeros((2, 2)), np.zeros((2, 3))],
                               ["cpu"] * 2)
    with pytest.raises(NotImplementedError, match="multi-card"):
        tmesh.one_card(["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="mix"):
        tmesh.one_card(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="at least one"):
        tmesh.one_card([])


@pytest.mark.parametrize("n,nex,cols,dtype",
                         [(4, 8, 16, np.float32), (3, 7, 5, np.uint8),
                          (1, 8, 4, np.int32), (4, 1, 4, np.float32)])
def test_wire_bytes_match_the_reference(n, nex, cols, dtype):
    assert (tdsh.exchange_wire_bytes(n, nex // 2, cols, dtype)
            == jdsh.exchange_wire_bytes(n, nex // 2, cols, dtype))


# -- seed parity ----------------------------------------------------------------


@pytest.mark.parametrize("n,rows,num_exchange", GEOMETRIES)
def test_device_pools_byte_identical(n, rows, num_exchange):
    host, _ = host_run("jax", n, rows, num_exchange, rounds=3)
    ref_xla = ref_device_run(n, rows, num_exchange, rounds=3)
    got, shufs = device_run(n, rows, num_exchange, rounds=3)
    for i in range(n):
        np.testing.assert_array_equal(got[i], host[i])
        np.testing.assert_array_equal(got[i], ref_xla[i])
    for s in shufs:
        assert s.device_exchange_active and s.span == "device"
        assert s.metrics.counter("shuffle.device_fallbacks") == 0
        assert s.metrics.counter("shuffle.device_rounds") == 3


def test_nd_pools_flatten_through_the_exchange():
    n, rounds = 3, 2
    host = [np.arange(8 * 2 * 3, dtype=np.float32).reshape(8, 2, 3) + 100 * i
            for i in range(n)]
    dev = [a.copy() for a in host]
    rdv = jsh.Rendezvous()
    run_rounds(n, host, rounds, lambda i: jsh.ThreadExchangeShuffler(
        topology("jax", n, i), 1, 6, rendezvous=rdv, seed=SEED))
    device_run(n, 8, 6, rounds, arys=dev)
    for a, b in zip(dev, host):
        np.testing.assert_array_equal(a, b)


def test_resume_round_coherence():
    full, _ = host_run("jax", 3, 10, 6, rounds=4)
    split = pools(3, 10)
    _, shufs = device_run(3, 10, 6, rounds=2, arys=split)
    assert all(s.exchange_round == 2 for s in shufs)
    _, shufs = device_run(3, 10, 6, rounds=2, arys=split, start_round=2)
    assert all(s.exchange_round == 4 for s in shufs)
    for a, b in zip(split, full):
        np.testing.assert_array_equal(a, b)


# -- the ladder -------------------------------------------------------------------


class _FailingFabric(tsh.DeviceExchangeFabric):
    def _device_exchange(self, rnd):
        raise RuntimeError("device leg failed")


@pytest.mark.parametrize("fabric_of", [
    lambda n: _FailingFabric(devices=["cpu"] * n),
    lambda n: tsh.DeviceExchangeFabric(devices=["cpu"]),  # unplannable ring
], ids=["leg-raises", "unplannable"])
def test_failed_device_leg_latches_every_participant(fabric_of):
    """On the CPU ring the round fails for all before any lane mutates;
    every participant latches the host exchange and re-runs the SAME
    round over it, so the pools equal a host-only run."""
    n, rows, nex, rounds = 3, 10, 6, 3
    host, _ = host_run("jax", n, rows, nex, rounds)
    fabric = fabric_of(n)
    got, shufs = device_run(n, rows, nex, rounds, fabric=fabric)
    for a, b in zip(got, host):
        np.testing.assert_array_equal(a, b)
    assert fabric.legs == 0
    for s in shufs:
        assert not s.device_exchange_active and s.span == "thread"
        assert s.metrics.counter("shuffle.device_fallbacks") == 1
        assert s.metrics.counter("shuffle.degraded") == 0
        assert s.exchange_round == rounds


@pytest.mark.parametrize("fabric_of", [
    lambda n: _FailingFabric(devices=["cuda:0"] * n),
    lambda n: tsh.DeviceExchangeFabric(devices=["cuda:0"]),  # unplannable
], ids=["leg-raises", "unplannable"])
def test_failed_device_leg_on_a_card_ring_raises(fabric_of):
    """On a card ring a failed device leg raises out of every
    participant's round: no latch to the host, no lane mutated."""
    n = 3
    fabric = fabric_of(n)
    assert fabric.on_card
    errors, arys, shufs = device_round_errors(n, fabric)
    assert sorted(errors) == list(range(n))
    assert all(isinstance(e, tsh.DeviceExchangeError) for e in errors.values())
    for a, b in zip(arys, pools(n, 10)):
        np.testing.assert_array_equal(a, b)
    for s in shufs:
        assert s.device_exchange_active
        assert s.metrics.counter("shuffle.device_fallbacks") == 0
    assert fabric.legs == 0


def test_devices_none_resolves_the_distinct_cards(monkeypatch):
    """``devices=None`` is ``cuda:0..count-1``: with no card the fabric
    refuses at construction; with fewer cards than instances every round
    raises; over several cards the fabric refuses at construction —
    never a silent fallback."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(tsh.DeviceExchangeError, match="no CUDA card"):
        tsh.DeviceExchangeFabric()
    with pytest.raises(tsh.DeviceExchangeError, match="no CUDA card"):
        tsh.DeviceExchangeShuffler.factory()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    errors, _, _ = device_round_errors(2, tsh.DeviceExchangeFabric())
    assert sorted(errors) == [0, 1]
    assert all("unplannable" in str(e) for e in errors.values())
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError, match="multi-card"):
        tsh.DeviceExchangeFabric()
    with pytest.raises(NotImplementedError, match="multi-card"):
        tsh.DeviceExchangeFabric(devices=["cuda:0", "cuda:1"])


def test_peer_loss_degrades_node_locally_like_the_reference():
    """A declared 2-instance topology with only instance 0 running: each
    round times out waiting for the peer and degrades to the seeded
    node-local shuffle — the reference's host and device tiers give the
    same pool under the same missing peer."""
    from ddl_tpu import faults
    from ddl_tpu.faults import FaultKind, FaultPlan, FaultSpec

    def lone(sh, pkg, **kw):
        s = sh(topology(pkg, 2, 0), 1, 6, seed=SEED, max_peer_losses=2,
               exchange_timeout_s=0.2, **kw)
        s.metrics = _pkg(pkg)["Metrics"]()
        ary = pools(1, 10)[0]
        for _ in range(3):
            s.global_shuffle(ary)
        return ary, s

    want_host, _ = lone(jsh.ThreadExchangeShuffler, "jax",
                        rendezvous=jsh.Rendezvous())
    plan = FaultPlan([FaultSpec("shuffle.device_exchange",
                                FaultKind.SHUFFLE_PEER_LOSS, count=999)])
    with faults.armed(plan):
        want_dev, _ = lone(jsh.DeviceExchangeShuffler, "jax",
                           rendezvous=jsh.Rendezvous(),
                           fabric=jsh.DeviceExchangeFabric(impl="xla"))
    got, s = lone(tsh.DeviceExchangeShuffler, "torch",
                  rendezvous=tsh.Rendezvous(),
                  fabric=tsh.DeviceExchangeFabric(devices=["cpu"] * 2))
    np.testing.assert_array_equal(got, want_host)
    np.testing.assert_array_equal(got, want_dev)
    assert s.metrics.counter("shuffle.degraded") == 2
    assert s.metrics.counter("shuffle.device_fallbacks") == 0
    assert s._degraded and not s._device_latched
    assert s.exchange_round == 3


# -- resolution surface ------------------------------------------------------------


def _shuffler(mode="thread", **kw):
    kw.setdefault("fabric", tsh.DeviceExchangeFabric(devices=["cpu"] * 2))
    return tsh.DeviceExchangeShuffler(topology("torch", 2, 0, mode), 1, 4,
                                      rendezvous=tsh.Rendezvous(), **kw)


def test_resolution_surface(monkeypatch):
    sh = _shuffler()
    assert sh.device_exchange_active and sh.span == "device"
    sh._device_latched = True
    assert sh.span == "thread"
    assert not _shuffler(device_shuffle="off").device_exchange_active
    assert not _shuffler(fabric=None).device_exchange_active
    assert not _shuffler(mode="process").device_exchange_active
    monkeypatch.setenv("DDL_TORCH_DEVICE_SHUFFLE", "0")
    assert not _shuffler().device_exchange_active
    assert _shuffler(device_shuffle="auto").device_exchange_active
    assert not tsh.DeviceExchangeFabric(devices=["cpu"]).on_card
    with pytest.raises(NotImplementedError, match="wire.py"):
        _shuffler(wire_dtype="bf16")


def test_factory_drops_the_fabric_at_the_pickle_boundary():
    fac = tsh.DeviceExchangeShufflerFactory(
        fabric=tsh.DeviceExchangeFabric(devices=["cpu"] * 2), seed=3)
    sh = fac(topology("torch", 2, 0), 1, 4)
    assert sh.device_exchange_active and sh.seed == 3
    fac2 = pickle.loads(pickle.dumps(fac))
    assert fac2.fabric is None and fac.fabric is not None
    sh2 = fac2(topology("torch", 2, 0, "process"), 1, 4)
    assert not sh2.device_exchange_active and sh2.seed == 3
    assert sh2.metrics.counter("shuffle.device_fallbacks") == 0


def test_fabric_shutdown_wakes_a_waiter():
    fabric = tsh.DeviceExchangeFabric(devices=["cpu"] * 2)
    flag = {"down": False}

    def aborter():
        time.sleep(0.15)
        flag["down"] = True

    threading.Thread(target=aborter, daemon=True).start()
    t0 = time.monotonic()
    with pytest.raises(ShutdownRequested):
        fabric.exchange(producer_idx=1, round_=0, instance_idx=0, n=2,
                        block=np.zeros((4, 2), np.float32), seed=SEED,
                        timeout_s=30.0, should_abort=lambda: flag["down"])
    assert time.monotonic() - t0 < 5.0
    with pytest.raises(DDLError, match="waiting for peers"):
        fabric.exchange(producer_idx=2, round_=0, instance_idx=0, n=2,
                        block=np.zeros((4, 2), np.float32), seed=SEED,
                        timeout_s=0.05)


def test_replayed_take_is_idempotent():
    n = 2
    fabric = tsh.DeviceExchangeFabric(devices=["cpu"] * n)
    blocks = [np.arange(8, dtype=np.float32).reshape(4, 2) + 100 * i
              for i in range(n)]
    outs = {}

    def worker(i):
        outs[i] = fabric.exchange(producer_idx=1, round_=0, instance_idx=i,
                                  n=n, block=blocks[i], seed=SEED,
                                  timeout_s=30.0)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    replay = fabric.exchange(producer_idx=1, round_=0, instance_idx=0, n=n,
                             block=blocks[0], seed=SEED, timeout_s=5.0)
    np.testing.assert_array_equal(outs[0], replay)
    np.testing.assert_array_equal(outs[0], blocks[1])  # n=2 swap
    assert fabric.legs == 1


# -- end to end -------------------------------------------------------------------


def test_device_drain_equals_the_reference_host_drain():
    """The two-instance drain of tests/test_device_shuffle.py:404-489:
    the port's device tier on the CPU against the reference's host
    tier, byte for byte."""
    rdv = jsh.Rendezvous()
    want = drain("jax", lambda: jsh.ThreadExchangeShuffler.factory(rdv))
    fabric = tsh.DeviceExchangeFabric(devices=["cpu"] * 2)
    got = drain("torch",
                lambda: tsh.DeviceExchangeShuffler.factory(fabric=fabric))
    for i in (0, 1):
        np.testing.assert_array_equal(got[i][0], want[i][0])
        pusher = got[i][1]
        assert pusher.metrics.counter("shuffle.device_fallbacks") == 0
        assert pusher.metrics.counter("shuffle.device_rounds") >= 1


class _Pool:
    """The chip path's producer at a small size: column 0 is
    ``instance * 1e6 + row``, the rest seeded values; each refill
    shuffles the rows in place."""

    def __init__(self, init_cls, instance_idx, rows=64, cols=8):
        self.init_cls, self.instance_idx = init_cls, instance_idx
        self.rows, self.cols = rows, cols

    def on_init(self, **kw):
        self._rng = np.random.default_rng(100 + self.instance_idx)
        return self.init_cls(nData=self.rows, nValues=self.cols,
                             shape=(self.rows, self.cols),
                             splits=(self.cols,))

    def post_init(self, my_ary, **kw):
        my_ary[:, 1:] = self._rng.standard_normal(
            (self.rows, self.cols - 1)).astype(np.float32)
        my_ary[:, 0] = self.instance_idx * 1e6 + np.arange(self.rows)

    def execute_function(self, my_ary, **kw):
        self._rng.shuffle(my_ary)


def test_four_instance_pool_drain_device_equals_host():
    """The chip path's shape on the CPU: four instances of a pool
    producer, ``output="device"`` on the CPU; both tiers serve the same
    stream, windows after the first mix instances, one fabric leg per
    round and no fallback."""
    from ddl_tpu_torch.datasetwrapper import DataProducerOnInitReturn as Init

    n, epochs = 4, 4
    rdv = tsh.Rendezvous()
    kw = dict(n_instances=n, epochs=epochs, n_data=16, output="device",
              producer_of=lambda i: _Pool(Init, i))
    host = drain("torch", lambda: tsh.ThreadExchangeShuffler.factory(rdv),
                 **kw)
    fabric = tsh.DeviceExchangeFabric(devices=["cpu"] * n)
    dev = drain("torch",
                lambda: tsh.DeviceExchangeShuffler.factory(fabric=fabric), **kw)
    rounds = []
    for i in range(n):
        np.testing.assert_array_equal(dev[i][0], host[i][0])
        origin = (dev[i][0][:, 0] // 1e6).astype(int).reshape(epochs, -1)
        assert all(set(e) - {i} for e in origin[1:])
        m = dev[i][1].metrics
        assert m.counter("shuffle.device_fallbacks") == 0
        assert m.counter("shuffle.device_rounds") >= epochs
        rounds.append(m.counter("shuffle.device_rounds"))
    assert min(rounds) <= fabric.legs <= max(rounds)
