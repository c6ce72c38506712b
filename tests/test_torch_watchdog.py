"""The port's watchdog and elastic respawn against the JAX package's
(``ddl_tpu.watchdog``, ``WorkerSet.respawn``, ``rejoin_producer``).

- A producer that dies mid-run (a crash in THREAD and PROCESS mode, a
  SIGKILL in PROCESS mode) is respawned; the replacement rejoins the
  surviving ring and the served tags are exactly the JAX package's
  ``[1..6]`` under the same fault — no gap, no repeat, no failure.
- A hung PROCESS producer is terminated and respawned.
- A producer that dies in every incarnation exhausts the respawn budget
  and falls through to ``on_failure``, as in the JAX package.
- The watchdog's timing rules (the widened replay budget, one failure
  per budget crossing, no failure during shutdown) give the JAX
  package's outcomes on the same ring doubles.
- The rejoin handshake's finalize race and geometry check.
- ``Trainer(watchdog_respawn=True)`` recovers a crashed producer with
  losses bit-equal to an undisturbed fit.

Spawning tests keep to one or two producer processes each and bound
every wait: the watchdog polls every 0.2 s, rings time out at 120 s.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import ddl_tpu
import ddl_tpu_torch
from ddl_tpu.watchdog import Watchdog as JaxWatchdog
from ddl_tpu_torch.exceptions import TransportError
from ddl_tpu_torch.observability import Metrics
from ddl_tpu_torch.watchdog import Watchdog
from torch_recovery_producers import AlwaysCrash, CrashOnceWrapper, TagProducer

PKGS = {"jax": (ddl_tpu, JaxWatchdog), "torch": (ddl_tpu_torch, Watchdog)}


def _drain_tags(pkg, mode, producer, n_epochs=6, stall_budget_s=60.0):
    """Drain ``producer`` through one package's batch path under a
    respawning watchdog; returns (tags, respawns, failures)."""
    mod, wd_cls = PKGS[pkg]
    extra = {"pin_memory": False} if pkg == "torch" else {}
    m = Metrics() if pkg == "torch" else None

    @mod.distributed_dataloader(n_producers=1, mode=mode, **extra)
    def main(env):
        wd = wd_cls(env.workers, poll_interval_s=0.2,
                    stall_budget_s=stall_budget_s, respawn=True,
                    **({"metrics": m} if m is not None else {})).start()
        try:
            loader = mod.DistributedDataLoader(
                producer, batch_size=16, connection=env.connection,
                n_epochs=n_epochs, output="numpy", timeout_s=120.0,
                **({"metrics": Metrics()} if pkg == "torch" else {}))
            tags = []
            for _ in range(n_epochs):
                for x, _y in loader:
                    tags.append(float(x[0, 0]))
                    loader.mark(mod.Marker.END_OF_BATCH)
                loader.mark(mod.Marker.END_OF_EPOCH)
        finally:
            wd.stop()
        return tags, list(wd.respawns), list(wd.failures)

    out = main()
    if m is not None:
        assert m.counter("watchdog.respawns") == len(out[1])
        assert m.timer("watchdog.respawn").count == len(out[1])
    return out


@pytest.fixture(scope="module")
def jax_crash_tags(tmp_path_factory):
    sentinel = str(tmp_path_factory.mktemp("jax-crash") / "fired")
    tags, respawns, failures = _drain_tags(
        "jax", "thread", TagProducer(sentinel, pkg="ddl_tpu"))
    assert respawns == [1] and failures == []
    return tags


@pytest.mark.parametrize("mode,fault", [
    ("thread", "raise"), ("process", "raise"), ("process", "sigkill"),
])
def test_crash_respawn_serves_the_reference_tags(mode, fault, tmp_path,
                                                 jax_crash_tags):
    sentinel = str(tmp_path / "fired")
    tags, respawns, failures = _drain_tags(
        "torch", mode, TagProducer(sentinel, fault=fault))
    assert tags == jax_crash_tags == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    assert respawns == [1]
    assert failures == []
    assert os.path.exists(sentinel)  # the fault really fired


def test_hung_process_producer_is_terminated_and_respawned(tmp_path):
    sentinel = str(tmp_path / "hung")
    want, _, _ = _drain_tags("jax", "thread", TagProducer(pkg="ddl_tpu"),
                             n_epochs=5)
    tags, respawns, failures = _drain_tags(
        "torch", "process", TagProducer(sentinel, fault_at=3, fault="hang"),
        n_epochs=5, stall_budget_s=4.0)
    assert tags == want == [1.0, 2.0, 3.0, 4.0, 5.0]
    assert respawns == [1] and failures == []
    assert os.path.exists(sentinel)


def _exhaust(pkg):
    mod, wd_cls = PKGS[pkg]
    extra = {"pin_memory": False} if pkg == "torch" else {}
    failures = []

    @mod.distributed_dataloader(n_producers=1, mode="thread", **extra)
    def main(env):
        wd = wd_cls(env.workers, poll_interval_s=0.1, respawn=True,
                    max_respawns=2, on_failure=failures.append).start()
        try:
            with pytest.raises(Exception):
                loader = mod.DistributedDataLoader(
                    AlwaysCrash(pkg=mod.__name__), batch_size=16,
                    connection=env.connection, n_epochs=2, output="numpy",
                    timeout_s=8.0)
                for _ in range(2):
                    for _b in loader:
                        loader.mark(mod.Marker.END_OF_BATCH)
                    loader.mark(mod.Marker.END_OF_EPOCH)
            deadline = time.monotonic() + 10
            while not failures and time.monotonic() < deadline:
                time.sleep(0.05)
        finally:
            wd.stop()
        return len(wd.respawns)

    return main(), failures


def test_respawn_budget_exhaustion_falls_through_to_on_failure():
    got = _exhaust("torch")
    want = _exhaust("jax")
    assert got[0] == want[0] == 2
    assert len(got[1]) == len(want[1]) == 1
    assert got[1][0] == want[1][0]  # the same reason


def test_respawn_refuses_a_live_thread():
    @ddl_tpu_torch.distributed_dataloader(n_producers=1, mode="thread",
                                          pin_memory=False)
    def main(env):
        loader = ddl_tpu_torch.DistributedDataLoader(
            TagProducer(), batch_size=16, connection=env.connection,
            n_epochs=1, output="numpy", metrics=Metrics())
        with pytest.raises(TransportError, match="still alive"):
            env.workers.respawn(1)
        for _ in loader:
            loader.mark(ddl_tpu_torch.Marker.END_OF_BATCH)
        loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)

    main()


# -- timing rules on ring doubles, both packages ---------------------------


class _Ring:
    def __init__(self, committed=0.0, released=0.0, down=False):
        self.committed, self.released, self.down = committed, released, down

    def stats(self):
        return {"committed": self.committed, "released": self.released,
                "producer_stall_s": 0.0, "consumer_stall_s": 0.0}

    def is_shutdown(self):
        return self.down


class _Workers:
    """A WorkerSet double whose respawn "succeeds" without reviving the
    worker."""

    def __init__(self, rings, dead_threads=0):
        self.connection = type("Conn", (), {})()
        self.connection.rings = rings
        self.threads, self.processes = [], []
        self.respawn_calls, self.aborted = [], False
        for _ in range(dead_threads):
            t = threading.Thread(target=lambda: None)
            t.start()
            t.join(5.0)
            self.threads.append(t)

    def respawn(self, idx):
        self.respawn_calls.append(idx)

    def abort(self):
        self.aborted = True


def _settle(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)


def _metrics(pkg):
    from ddl_tpu.observability import Metrics as JaxMetrics

    return JaxMetrics() if pkg == "jax" else Metrics()


def _replay_budget(pkg):
    ring = _Ring(5.0, 5.0)
    wd = PKGS[pkg][1](_Workers([ring]), stall_budget_s=1.0, respawn=True)
    wd._replaying[0] = ring.committed
    wd._last_progress[0] = (ring.committed, ring.released)
    wd._last_change[0] = time.monotonic() - 5.0
    out = [wd.check_once(), 0 in wd._replaying]
    ring.committed = 6.0
    out += [wd.check_once(), 0 in wd._replaying]
    ring.released = 6.0
    wd.check_once()
    wd._last_change[0] = time.monotonic() - 5.0
    out.append(wd.check_once())
    return out


def test_replay_budget_widens_until_the_first_new_commit():
    got, want = _replay_budget("torch"), _replay_budget("jax")
    assert got == want
    assert got[:4] == [None, True, None, False]
    assert "no progress" in got[4]


def _exhaustion(pkg):
    m, failures = _metrics(pkg), []
    w = _Workers([_Ring()], dead_threads=1)
    wd = PKGS[pkg][1](w, poll_interval_s=0.02, respawn=True, max_respawns=2,
                      on_failure=failures.append, metrics=m).start()
    try:
        _settle(lambda: failures)
        time.sleep(0.1)
    finally:
        wd.stop()
    return (w.respawn_calls, failures, len(wd.respawns),
            m.counter("watchdog.respawns"), m.counter("watchdog.failures"))


def test_respawn_exhaustion_escalates_exactly_once():
    got = _exhaustion("torch")
    assert got == _exhaustion("jax")
    assert got == ([1, 1], ["producer thread 1 died"], 2, 2.0, 1.0)


def _death_in_shutdown(pkg):
    m = _metrics(pkg)
    w = _Workers([_Ring(down=True)], dead_threads=1)
    wd = PKGS[pkg][1](w, poll_interval_s=0.02, respawn=True,
                      metrics=m).start()
    time.sleep(0.3)
    wd.stop()
    return (w.respawn_calls, wd.failures, w.aborted,
            m.counter("watchdog.respawns"), m.counter("watchdog.failures"))


def test_producer_death_during_shutdown_is_not_a_failure():
    got = _death_in_shutdown("torch")
    assert got == _death_in_shutdown("jax") == ([], [], False, 0.0, 0.0)


def _stall_once(pkg):
    m, failures = _metrics(pkg), []
    wd = PKGS[pkg][1](_Workers([_Ring()]), poll_interval_s=0.02,
                      stall_budget_s=0.15, on_failure=failures.append,
                      metrics=m).start()
    try:
        _settle(lambda: failures)
        time.sleep(0.3)  # a looping monitor would fire again here
    finally:
        wd.stop()
    return len(failures), "no progress" in failures[0], \
        m.counter("watchdog.failures")


def test_a_stall_is_counted_once_per_budget_crossing():
    assert _stall_once("torch") == _stall_once("jax") == (1, True, 1.0)


# -- the rejoin handshake ----------------------------------------------------


def _handshaken(pkg):
    from ddl_tpu.transport import connection as jconn
    from ddl_tpu.types import (
        MetaData_Consumer_To_Producer as JMeta,
        MetaData_Producer_To_Consumer as JReply,
    )
    from ddl_tpu_torch.transport import connection as tconn
    from ddl_tpu_torch.types import (
        MetaData_Consumer_To_Producer as TMeta,
        MetaData_Producer_To_Consumer as TReply,
    )

    conn_mod, meta, reply = ((jconn, JMeta, JReply) if pkg == "jax"
                             else (tconn, TMeta, TReply))
    a, b = conn_mod.ThreadChannel.pair()
    conn = conn_mod.ConsumerConnection([a])
    conn.send_metadata(meta(data_producer_function=None, batch_size=16,
                            n_epochs=6))
    b.recv(timeout_s=5)
    geometry = dict(producer_idx=1, n_data=16, n_values=4, shape=(16, 4),
                    splits=(3, 1), batches_per_window=1)
    b.send(reply(**geometry))
    conn.recv_metadata_as_consumer()
    return conn_mod, conn, reply, geometry, a


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_rejoin_racing_the_end_of_the_run_is_a_success(pkg):
    conn_mod, conn, reply, geometry, a = _handshaken(pkg)
    conn.finalize()
    a2, b2 = conn_mod.ThreadChannel.pair()
    late = reply(**geometry)
    b2.send(late)
    assert conn.rejoin_producer(1, a2) is late
    assert conn.channels[0] is a  # nothing swapped into the dead connection


@pytest.mark.parametrize("field,value", [("shape", (8, 8)),
                                         ("integrity", True)])
def test_rejoin_refuses_a_replacement_that_disagrees(field, value):
    msgs = []
    for pkg in ("jax", "torch"):
        conn_mod, conn, reply, geometry, _ = _handshaken(pkg)
        a2, b2 = conn_mod.ThreadChannel.pair()
        b2.send(reply(**{**geometry, field: value}))
        with pytest.raises(Exception, match="respawned producer 1") as e:
            conn.rejoin_producer(1, a2)
        msgs.append(str(e.value).replace("DDL_TPU_", "DDL_TORCH_"))
    assert msgs[0] == msgs[1]


# -- the trainer -------------------------------------------------------------


def _tiny_fit(token_file, mode, producer, respawn):
    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.trainer import Trainer

    cfg = llama.LlamaConfig(vocab=96, d_model=32, n_layers=1, n_heads=4,
                            n_kv_heads=2, d_ff=64, max_seq=16,
                            dtype=torch.float32)
    trainer = Trainer(
        loss_fn=lambda p, b: llama.next_token_loss(p, b[0], cfg),
        optimizer=adamw(3e-3),
        init_params=llama.init_params(cfg, seed=0, device="cpu"),
        device="cpu", metrics=Metrics(), watchdog_respawn=respawn)
    return trainer.fit(producer, config=LoaderConfig(
        batch_size=4, n_epochs=6, n_producers=2, mode=mode,
        window_stream=True, ring_timeout_s=120.0))


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_trainer_respawns_a_crashed_producer_with_equal_losses(mode,
                                                               tmp_path):
    from ddl_tpu_torch.readers import TokenStreamProducer

    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(2).integers(0, 96, 8_000,
                                      dtype=np.int32).tofile(path)
    tokens = TokenStreamProducer(path, 16, 8, seed=1)
    clean = _tiny_fit(path, "thread", tokens, respawn=False)
    sentinel = str(tmp_path / "fired")
    res = _tiny_fit(path, mode, CrashOnceWrapper(tokens, sentinel,
                                                 fault_at=2), respawn=True)
    assert os.path.exists(sentinel)
    assert res.losses == clean.losses
    m = res.metrics
    assert m.counter("watchdog.respawns") == 1
    assert m.counter("watchdog.failures") == 0
    assert m.counter("consumer.windows") == 6


def test_fit_refuses_an_exchange_fraction_without_a_factory():
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.trainer import Trainer

    trainer = Trainer(lambda p, b: 0, adamw(1e-3), {}, device="cpu")
    with pytest.raises(ValueError, match="requires a shuffler_factory"):
        trainer.fit(TagProducer(), batch_size=16, n_epochs=1,
                    global_shuffle_fraction_exchange=0.5)
