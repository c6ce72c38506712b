"""The cross-process global shuffle in the port against the JAX package:
``ShmRendezvous``, its session sweep, the PROCESS-mode exchange and the
elastic respawn during one (``ddl_tpu/shuffle.py`` ``ShmRendezvous``,
``tests/test_elastic.py``, ``tests/test_shuffle.py``).

- Mailboxes: round trip (and across the packages: the same file layout),
  abort, timeout, retention until ``retire``, lazy directory, cleanup,
  pickling — each against the JAX package's behaviour.
- The stale-session sweep removes exactly the directories the JAX
  package's sweep removes.
- Spawned processes exchanging over one session conserve the row
  multiset and leave pools byte-equal to the JAX package's in-process
  exchange at the same seed (n = 2, one round; n = 3, two rounds).
- A producer that dies during an exchange is respawned: every round's
  windows still partition the rows, and the served streams equal the JAX
  package's under the same fault.
- The handshake refusals (a thread rendezvous across processes, a host
  fabric across hosts, a rejoin without replay support or with one slot,
  a ring without trailer room), with the JAX package's messages.

Every root is a ``tmp_path``, never ``/dev/shm``.
"""

import multiprocessing as mp
import os
import pickle
import time

import numpy as np
import pytest

import ddl_tpu
import ddl_tpu_torch
from ddl_tpu import shuffle as jsh
from ddl_tpu.exceptions import DDLError as JaxDDLError
from ddl_tpu_torch import shuffle as tsh
from ddl_tpu_torch.exceptions import DDLError, ShutdownRequested
from ddl_tpu_torch.observability import Metrics
from torch_recovery_producers import ExchangeProducer, exchange_worker

KEY = (1, 4, 0)


def test_round_trip_within_and_across_the_packages(tmp_path):
    rows = np.arange(24, dtype=np.float32).reshape(6, 4)
    session = tsh.make_session("t-rt")
    port = tsh.ShmRendezvous(session, root=str(tmp_path))
    ref = jsh.ShmRendezvous(session, root=str(tmp_path))
    assert port._path(KEY) == ref._path(KEY)
    port.put(KEY, rows)
    got = ref.take(KEY, timeout_s=5)  # the port posts, the JAX package takes
    ref.put((1, 5, 0), rows * 2)
    back = port.take((1, 5, 0), timeout_s=5)
    assert got.tobytes() == rows.tobytes()
    assert back.tobytes() == (rows * 2).tobytes()
    port.cleanup()
    assert not os.path.exists(port._dir)


@pytest.mark.parametrize("mod", [tsh, jsh], ids=["torch", "jax"])
def test_retained_until_retire(mod, tmp_path):
    rdv = mod.ShmRendezvous(mod.make_session("t-ret"), root=str(tmp_path))
    assert not os.path.exists(rdv._dir)  # lazy: no directory yet
    rows = np.ones((3, 2), np.int32)
    rdv.put(KEY, rows)
    first = rdv.take(KEY, timeout_s=5)
    again = rdv.take(KEY, timeout_s=5)  # a replayed take
    assert first.tobytes() == again.tobytes() == rows.tobytes()
    rdv.put(KEY, rows + 1)  # a replayed re-put nobody takes
    rdv.retire(KEY)
    assert os.listdir(rdv._dir) == []
    with pytest.raises((DDLError, JaxDDLError), match="timed out"):
        rdv.take(KEY, timeout_s=0.05)
    rdv.put(KEY, rows)
    rdv.discard(KEY)
    assert os.listdir(rdv._dir) == []
    rdv.cleanup()


@pytest.mark.parametrize("mod", [tsh, jsh], ids=["torch", "jax"])
def test_take_observes_an_abort(mod, tmp_path):
    from ddl_tpu.exceptions import ShutdownRequested as JaxShutdown

    rdv = mod.ShmRendezvous(mod.make_session("t-abort"), root=str(tmp_path))
    t0 = time.monotonic()
    with pytest.raises((ShutdownRequested, JaxShutdown)):
        rdv.take(KEY, timeout_s=30, should_abort=lambda: True)
    assert time.monotonic() - t0 < 5


def test_pickles_as_its_session_and_root(tmp_path):
    rdv = tsh.ShmRendezvous("sess-1", root=str(tmp_path))
    back = pickle.loads(pickle.dumps(rdv))
    assert (back.session, back.root, back.span) == ("sess-1", str(tmp_path),
                                                    "process")
    assert vars(back) == vars(rdv) == vars(jsh.ShmRendezvous(
        "sess-1", root=str(tmp_path)))
    factory = pickle.loads(pickle.dumps(
        tsh.ThreadExchangeShuffler.factory(rendezvous=rdv, seed=3)))
    assert factory.rendezvous.session == "sess-1" and factory.seed == 3


def test_session_names_have_the_reference_shape():
    name = tsh.make_session("run")
    assert name.startswith(f"run-{os.getpid()}-")
    assert tsh._SESSION_RE.match(f"ddl-rdv-{name}")
    assert jsh._SESSION_RE.match(f"ddl-rdv-{name}")
    assert tsh.STALE_SESSION_S == jsh.STALE_SESSION_S == 3600.0


def _dead_pid():
    p = mp.get_context("spawn").Process(target=time.sleep, args=(0,))
    p.start()
    p.join(30)
    return p.pid


def _sweep_layout(root, dead):
    old = time.time() - 2 * tsh.STALE_SESSION_S
    names = {
        "dead-old": f"ddl-rdv-x-{dead}-{'a' * 12}",
        "dead-young": f"ddl-rdv-x-{dead}-{'b' * 12}",
        "live-old": f"ddl-rdv-x-{os.getpid()}-{'c' * 12}",
        "hand-named": "ddl-rdv-mine",
        "other": f"other-{dead}-{'d' * 12}",
    }
    for tag, name in names.items():
        path = os.path.join(root, name)
        os.makedirs(path)
        with open(os.path.join(path, "p1-t0-d0.npy"), "wb") as f:
            f.write(b"x")
        if tag != "dead-young":
            os.utime(path, (old, old))
    return names


def test_stale_session_sweep_matches_the_reference(tmp_path):
    dead = _dead_pid()
    kept = {}
    for mod in (tsh, jsh):
        root = tmp_path / mod.__name__
        root.mkdir()
        names = _sweep_layout(str(root), dead)
        mod._sweep_stale_sessions(str(root))
        kept[mod.__name__] = sorted(
            tag for tag, name in names.items() if (root / name).exists())
    assert kept["ddl_tpu_torch.shuffle"] == kept["ddl_tpu.shuffle"] == [
        "dead-young", "hand-named", "live-old", "other"]


def test_first_put_sweeps_its_root(tmp_path, monkeypatch):
    dead = _dead_pid()
    names = _sweep_layout(str(tmp_path), dead)
    monkeypatch.setattr(tsh, "_swept_roots", set())
    tsh.ShmRendezvous(tsh.make_session("t-sweep"),
                      root=str(tmp_path)).put(KEY, np.zeros(2))
    assert not (tmp_path / names["dead-old"]).exists()
    assert (tmp_path / names["live-old"]).exists()


def _reference_pools(pools, seed, rounds):
    """The JAX package's host exchange in threads of this process."""
    import threading

    from ddl_tpu.types import RunMode, Topology

    n, rdv, out = len(pools), jsh.Rendezvous(), [p.copy() for p in pools]

    def run(i):
        topo = Topology(n_instances=n, instance_idx=i, n_producers=1,
                        mode=RunMode.THREAD)
        sh = jsh.ThreadExchangeShuffler(topo, 1, num_exchange=len(out[i]) // 2,
                                        rendezvous=rdv, seed=seed)
        for r in range(rounds):
            sh.global_shuffle(my_ary=out[i], iteration=r)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    return out


@pytest.mark.parametrize("n,rounds", [(2, 1), (3, 2)])
def test_spawned_exchange_conserves_rows_like_the_reference(n, rounds,
                                                           tmp_path):
    rng = np.random.default_rng(n)
    pools = []
    for i in range(n):
        pool = rng.standard_normal((12, 3)).astype(np.float32)
        pool[:, 0] = i * 1000 + np.arange(12)
        pools.append(pool)
        np.save(tmp_path / f"pool{i}.npy", pool)
    session = tsh.make_session("t-xproc")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=exchange_worker, args=(
        n, i, session, str(tmp_path), 7, rounds, str(tmp_path / f"pool{i}.npy"),
        str(tmp_path / f"out{i}.npy"))) for i in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    assert [p.exitcode for p in procs] == [0] * n
    got = [np.load(tmp_path / f"out{i}.npy") for i in range(n)]
    want = _reference_pools(pools, 7, rounds)
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    assert sorted(np.concatenate(got)[:, 0].tolist()) == sorted(
        np.concatenate(pools)[:, 0].tolist())
    if rounds == 1:  # a second n = 3 round may send every row home
        assert all((g[:, 0] // 1000 != i).any() for i, g in enumerate(got))
    tsh.ShmRendezvous(session, root=str(tmp_path)).cleanup()


def _respawn_during_exchange(pkg, mode, sentinel, root, n_epochs=5):
    """Two instances of one producer each over a shm session; instance
    0's producer dies once mid-run and a watchdog respawns it.  Returns
    the served (epoch, instance) windows and the respawns."""
    if pkg == "torch":
        from ddl_tpu_torch.env import WorkerSet
        from ddl_tpu_torch.types import RunMode, Topology
        from ddl_tpu_torch.watchdog import Watchdog
        mod, shm = ddl_tpu_torch, tsh
    else:
        from ddl_tpu.env import WorkerSet
        from ddl_tpu.types import RunMode, Topology
        from ddl_tpu.watchdog import Watchdog
        mod, shm = ddl_tpu, jsh
    session = shm.make_session(f"t-el-{pkg}")
    factory = shm.ThreadExchangeShuffler.factory(
        rendezvous=shm.ShmRendezvous(session, root=root))
    sets, loaders = [], []
    try:
        for i in range(2):
            topo = Topology(n_instances=2, instance_idx=i, n_producers=1,
                            mode=RunMode(mode))
            kw = {"pin_memory": False} if pkg == "torch" else {}
            ws = WorkerSet(topo, nslots=2, shuffler_factory=factory, **kw)
            sets.append(ws)
            loaders.append(mod.DistributedDataLoader(
                ExchangeProducer(i, sentinel, pkg=mod.__name__),
                batch_size=16, connection=ws.connection, n_epochs=n_epochs,
                output="numpy", global_shuffle_fraction_exchange=0.5,
                timeout_s=120.0,
                **({"metrics": Metrics()} if pkg == "torch" else {})))
        wd = Watchdog(sets[0], poll_interval_s=0.2, stall_budget_s=60.0,
                      respawn=True).start()
        served = []
        try:
            for _ in range(n_epochs):
                pair = []
                for loader in loaders:
                    (x, y) = loader[0]
                    pair.append(np.concatenate([x, y], axis=1).copy())
                    loader.mark(mod.Marker.END_OF_BATCH)
                    loader.mark(mod.Marker.END_OF_EPOCH)
                served.append(pair)
        finally:
            wd.stop()
    finally:
        for loader in loaders:
            loader.shutdown()
        for ws in sets:
            ws.abort()
            ws.join(30.0)
    shm.ShmRendezvous(session, root=root).cleanup()
    assert not os.path.exists(shm.ShmRendezvous(session, root=root)._dir)
    return served, list(wd.respawns), list(wd.failures)


def test_respawn_during_a_shm_exchange_serves_the_reference_stream(tmp_path):
    all_tags = sorted(float(t) for i in (0, 1)
                      for t in (i * 1000 + np.arange(16)))
    got, respawns, failures = _respawn_during_exchange(
        "torch", "process", str(tmp_path / "fired-torch"), str(tmp_path))
    want, jrespawns, _ = _respawn_during_exchange(
        "jax", "thread", str(tmp_path / "fired-jax"), str(tmp_path))
    assert respawns == jrespawns == [1] and failures == []
    assert os.path.exists(tmp_path / "fired-torch")
    crossed = False
    for g, w in zip(got, want):
        assert [a.tobytes() for a in g] == [a.tobytes() for a in w]
        tags = sorted(float(t) for t in np.concatenate(g)[:, 0])
        assert tags == all_tags  # each round partitions the rows
        crossed = crossed or bool((g[0][:, 0] >= 1000).any())
    assert crossed


# -- handshake refusals -------------------------------------------------------


class _NoRetentionFabric:
    """put/take/discard only: a fabric without consumed-box retention."""

    span = "thread"

    def put(self, key, rows):
        pass

    def take(self, key, timeout_s=60.0, should_abort=None):
        raise AssertionError("never reached")

    def discard(self, key):
        pass


def _handshake(pkg, mode, factory, nslots=2, rejoin=False, headroom=True):
    """One pusher's handshake; returns it or the refusal's message."""
    if pkg == "torch":
        from ddl_tpu_torch import integrity
        from ddl_tpu_torch.datapusher import DataPusher
        from ddl_tpu_torch.transport.connection import (
            ProducerConnection, ThreadChannel,
        )
        from ddl_tpu_torch.transport.ring import ThreadRing
        from ddl_tpu_torch.types import (
            MetaData_Consumer_To_Producer, RunMode, Topology,
        )
        pkg_mod = "ddl_tpu_torch"
    else:
        from ddl_tpu import integrity
        from ddl_tpu.datapusher import DataPusher
        from ddl_tpu.transport.connection import (
            ProducerConnection, ThreadChannel,
        )
        from ddl_tpu.transport.ring import ThreadRing
        from ddl_tpu.types import (
            MetaData_Consumer_To_Producer, RunMode, Topology,
        )
        pkg_mod = "ddl_tpu"
    cons, prod = ThreadChannel.pair()
    cons.send(MetaData_Consumer_To_Producer(
        data_producer_function=ExchangeProducer(0, pkg=pkg_mod),
        batch_size=8, n_epochs=1, global_shuffle_fraction_exchange=0.5,
        exchange_method="sendrecv_replace"))
    topo = Topology(n_instances=2, instance_idx=0, n_producers=1,
                    mode=RunMode(mode))
    ring = None
    if rejoin:
        ring = ThreadRing(nslots, 16 * 2 * 4 + (
            integrity.HEADER_BYTES if headroom else 0))
    try:
        pusher = DataPusher(
            ProducerConnection(prod, 1, cross_process=mode != "thread"),
            topo, 1, nslots=nslots, shuffler_factory=factory,
            rejoin_ring=ring)
    except (ShutdownRequested, KeyboardInterrupt):
        raise
    except Exception as e:
        assert type(e).__name__ == "DoesNotMatchError"
        return str(e)
    pusher.connection.finalize()
    return pusher


@pytest.mark.parametrize("case", [
    "process_thread_rdv", "multihost_shm", "rejoin_no_retention",
    "rejoin_one_slot", "rejoin_no_headroom",
])
def test_handshake_refusals_match_the_reference(case, tmp_path):
    def factory(shm):
        if case == "process_thread_rdv":
            return shm.ThreadExchangeShuffler.factory()
        if case == "rejoin_no_retention":
            return shm.ThreadExchangeShuffler.factory(
                rendezvous=_NoRetentionFabric())
        return shm.ThreadExchangeShuffler.factory(
            rendezvous=shm.ShmRendezvous("t-refuse", root=str(tmp_path)))

    mode = {"process_thread_rdv": "process",
            "multihost_shm": "multihost"}.get(case, "thread")
    kw = dict(rejoin=case.startswith("rejoin"),
              nslots=1 if case == "rejoin_one_slot" else 2,
              headroom=case != "rejoin_no_headroom")
    got = _handshake("torch", mode, factory(tsh), **kw)
    want = _handshake("jax", mode, factory(jsh), **kw)
    assert isinstance(got, str) and isinstance(want, str)
    expect = {
        "process_thread_rdv": "in-process Rendezvous",
        "multihost_shm": "cannot span hosts",
        "rejoin_no_retention": "supports_elastic_replay",
        "rejoin_one_slot": "nslots >= 2",
        "rejoin_no_headroom": "integrity-header headroom",
    }[case]
    assert expect in got and expect in want
    # The port's message is the reference's first sentence, knob renamed.
    assert want.replace("DDL_TPU_", "DDL_TORCH_").startswith(
        got.split(";")[0].split(" (")[0])


def test_process_mode_accepts_a_shm_rendezvous(tmp_path):
    rdv = tsh.ShmRendezvous(tsh.make_session("t-ok"), root=str(tmp_path))
    pusher = _handshake("torch", "process",
                        tsh.ThreadExchangeShuffler.factory(rendezvous=rdv))
    assert not isinstance(pusher, str)
    assert pusher.shuffler.span == "process"
    assert pusher.shuffler.supports_elastic_replay
    assert not os.path.exists(rdv._dir)  # nothing posted, nothing created
