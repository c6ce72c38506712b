"""Quarantine-and-replay in the port against the JAX package
(``ddl_tpu/dataloader.py`` ``_quarantine_and_replay``, the pusher's
``ReplayRequest`` rewind).

A committed window is corrupted after its trailer was stamped; the
consumer's drain-time check quarantines it, asks the producer (in an
acked envelope) to rewind, discards the stale successors and serves the
re-committed window.  Byte-exact: the served stream equals the JAX
loader's under the same corruption and the clean stream, on the
``windows()`` path (inline, and through the staged engine) and on the
batch path, in THREAD and PROCESS mode.  Persistent corruption exhausts
``DDL_TORCH_MAX_REPLAYS`` with the JAX package's error; an active
cross-instance exchange refuses a local replay.  The producers' default
``fast_forward`` replays ``TokenStreamProducer`` and
``PackedTokenProducer`` exactly.
"""

import contextlib
import os
import time

import numpy as np
import pytest

import ddl_tpu
import ddl_tpu_torch
from ddl_tpu import integrity as jint
from ddl_tpu.readers import PackedTokenProducer as JaxPacked
from ddl_tpu.readers import TokenStreamProducer as JaxTokens
from ddl_tpu.transport.ring import ThreadRing as JaxRing
from ddl_tpu_torch import integrity as tint
from ddl_tpu_torch.exceptions import IntegrityError
from ddl_tpu_torch.observability import Metrics
from ddl_tpu_torch.readers import PackedTokenProducer as TorchPacked
from ddl_tpu_torch.readers import TokenStreamProducer as TorchTokens
from ddl_tpu_torch.transport.ring import ThreadRing as TorchRing

SEQ, ROWS, BATCH, EPOCHS = 16, 8, 4, 6
PKGS = {"jax": (ddl_tpu, JaxRing, jint), "torch": (ddl_tpu_torch, TorchRing,
                                                   tint)}


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tok") / "tokens.bin")
    np.random.default_rng(5).integers(0, 50_000, 20_000,
                                      dtype=np.int32).tofile(path)
    return path


@contextlib.contextmanager
def corrupt_commits(pkg, producer, seq, times=1):
    """Flip one payload byte of producer ``producer``'s commit of window
    ``seq``, after its trailer was stamped, the first ``times`` times it
    is committed (``times=None``: every time)."""
    _, ring_cls, integ = PKGS[pkg]
    original = ring_cls.commit
    fired = []

    def commit(self, slot, payload_bytes):
        hdr = integ.read_header(self.slot_view(slot), payload_bytes)
        if (hdr.producer_idx == producer and hdr.seq == seq
                and (times is None or len(fired) < times)):
            self.slot_view(slot)[3] ^= 0xFF
            fired.append(seq)
        return original(self, slot, payload_bytes)

    ring_cls.commit = commit
    try:
        yield fired
    finally:
        ring_cls.commit = original


def _stream(pkg, producer, mode="thread", path="windows", staged=None,
            lookahead=1, n_producers=2, metrics=None):
    """The served stream of one package, one bytes object per window."""
    mod = PKGS[pkg][0]
    m = (metrics or Metrics()) if pkg == "torch" else None
    extra = {"pin_memory": False} if pkg == "torch" else {}

    @mod.distributed_dataloader(n_producers=n_producers, mode=mode, nslots=2,
                                **extra)
    def main(env):
        kw = {}
        if pkg == "torch":
            kw = dict(metrics=m, device="cpu", staged=staged)
        output = "numpy" if path == "batches" else (
            "jax" if pkg == "jax" else "device")
        if path == "batches":
            kw.pop("device", None)
            kw.pop("staged", None)
        loader = mod.DistributedDataLoader(
            producer, batch_size=BATCH, connection=env.connection,
            n_epochs=EPOCHS, output=output, timeout_s=60.0, **kw)
        out = []
        if path == "batches":
            for _ in range(EPOCHS):
                out.append(b"".join(np.asarray(x).tobytes()
                                    for (x,) in _batches(loader, mod)))
                loader.mark(mod.Marker.END_OF_EPOCH)
        else:
            for win in loader.windows(lookahead=lookahead):
                out.append(np.asarray(win).tobytes())
                loader.mark(mod.Marker.END_OF_EPOCH)
        return out

    return main(), m


def _batches(loader, mod):
    for idx in range(len(loader)):
        yield loader[idx]
        loader.mark(mod.Marker.END_OF_BATCH)


@pytest.mark.parametrize("path,staged,lookahead", [
    ("windows", None, 1), ("windows", True, 2), ("batches", None, 0),
])
def test_corrupt_thread_slot_replays_to_the_reference_stream(
        token_file, path, staged, lookahead):
    clean, _ = _stream("torch", TorchTokens(token_file, SEQ, ROWS, seed=3),
                       path=path, staged=staged, lookahead=lookahead)
    with corrupt_commits("torch", producer=2, seq=1) as fired:
        got, m = _stream("torch", TorchTokens(token_file, SEQ, ROWS, seed=3),
                         path=path, staged=staged, lookahead=lookahead)
    with corrupt_commits("jax", producer=2, seq=1) as jfired:
        want, _ = _stream("jax", JaxTokens(token_file, SEQ, ROWS, seed=3),
                          path=path, lookahead=lookahead)
    assert fired == jfired == [1]
    assert got == want == clean
    assert m.counter("integrity.corrupt_windows") == 1
    assert m.counter("integrity.replays") == 1
    assert m.counter("integrity.replay_exhausted") == 0
    assert m.counter("ctrl.acked") >= 1  # the request's envelope was acked


def test_corrupt_process_slot_replays_across_the_pipe(token_file):
    """PROCESS mode: the slot is corrupted in shared memory after the
    producer committed it; the replay request crosses the pipe in an
    envelope, the child rewinds, and the ack comes back."""
    tokens = TorchTokens(token_file, SEQ, ROWS, seed=3)
    clean, _ = _stream("torch", tokens)
    m = Metrics()

    @ddl_tpu_torch.distributed_dataloader(n_producers=2, mode="process",
                                          nslots=2, pin_memory=False)
    def main(env):
        loader = ddl_tpu_torch.DistributedDataLoader(
            tokens, batch_size=BATCH, connection=env.connection,
            n_epochs=EPOCHS, output="device", device="cpu", metrics=m,
            timeout_s=60.0)
        ring = loader.connection.rings[0]
        deadline = time.monotonic() + 60
        while ring.stats()["committed"] < 1:
            assert time.monotonic() < deadline, "no commit"
            time.sleep(0.005)
        ring.slot_view(0)[5] ^= 0xFF  # window 0 of producer 1
        out = []
        for win in loader.windows(lookahead=1):
            out.append(win.numpy().tobytes())
            loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
        return out, env

    got, env = main()
    assert got == clean
    assert env.workers.exitcodes == [0, 0]
    assert m.counter("integrity.replays") == 1
    assert m.counter("ctrl.acked") >= 1


def _exhausted(pkg, token_file, monkeypatch, max_replays):
    mod = PKGS[pkg][0]
    knob = "DDL_TPU_MAX_REPLAYS" if pkg == "jax" else "DDL_TORCH_MAX_REPLAYS"
    monkeypatch.setenv(knob, str(max_replays))
    prod = (JaxTokens if pkg == "jax" else TorchTokens)(token_file, SEQ,
                                                        ROWS, seed=3)
    m = Metrics()
    with corrupt_commits(pkg, producer=1, seq=2, times=None):
        with pytest.raises(Exception) as e:
            _stream(pkg, prod, path="batches", n_producers=1, metrics=m)
    monkeypatch.delenv(knob)
    return e.value, m


@pytest.mark.parametrize("max_replays", [1, 2])
def test_persistent_corruption_exhausts_the_replays(token_file, monkeypatch,
                                                   max_replays):
    from ddl_tpu.exceptions import IntegrityError as JaxIntegrityError

    got, m = _exhausted("torch", token_file, monkeypatch, max_replays)
    want, _ = _exhausted("jax", token_file, monkeypatch, max_replays)
    assert isinstance(got, IntegrityError)
    assert isinstance(want, JaxIntegrityError)
    msg = f"window 2 from producer 1 still corrupt after {max_replays} replay"
    assert msg in str(got) and msg in str(want)
    assert m.counter("integrity.replays") == max_replays
    assert m.counter("integrity.corrupt_windows") == max_replays + 1
    assert m.counter("integrity.replay_exhausted") == 1


def test_no_local_replay_while_an_exchange_is_active(tmp_path):
    """A corrupt window of a shuffling loader is not replayable (peers'
    rows cannot be regenerated locally): IntegrityError at once, no
    replay request sent."""
    from ddl_tpu_torch.env import WorkerSet
    from ddl_tpu_torch.shuffle import Rendezvous, ThreadExchangeShuffler
    from ddl_tpu_torch.types import RunMode, Topology
    from torch_recovery_producers import ExchangeProducer

    rdv = Rendezvous()
    sets, loaders, metrics = [], [], []
    with corrupt_commits("torch", producer=1, seq=0, times=None):
        try:
            for i in range(2):
                ws = WorkerSet(Topology(n_instances=2, instance_idx=i,
                                        n_producers=1, mode=RunMode.THREAD),
                               nslots=2, shuffler_factory=(
                                   ThreadExchangeShuffler.factory(rdv)))
                sets.append(ws)
                metrics.append(Metrics())
                loaders.append(ddl_tpu_torch.DistributedDataLoader(
                    ExchangeProducer(i), batch_size=16,
                    connection=ws.connection, n_epochs=3, output="numpy",
                    global_shuffle_fraction_exchange=0.5,
                    metrics=metrics[-1], timeout_s=30.0))
            with pytest.raises(IntegrityError, match="not replayable"):
                loaders[0][0]
        finally:
            for loader in loaders:
                loader.shutdown()
            for ws in sets:
                ws.abort()
                ws.join(30.0)
    assert metrics[0].counter("integrity.replays") == 0
    assert metrics[0].counter("integrity.corrupt_windows") == 1


@pytest.mark.parametrize("kind", ["tokens", "packed"])
def test_fast_forward_replays_the_readers_exactly(token_file, kind):
    """``fast_forward(n)`` then one refill gives window n, as the hot
    loop's refills do, in both packages and byte-equal between them."""
    def windows(cls, ff):
        p = (cls(token_file, SEQ, ROWS, seed=3) if kind == "tokens"
             else cls(token_file, SEQ, ROWS, delimiter=7, seed=3))
        geo = p.on_init(producer_idx=1, n_producers=2)
        ary = np.zeros(geo.shape, np.int32)
        p.post_init(my_ary=ary)
        if ff:
            p.fast_forward(4, my_ary=ary)
            p.execute_function(my_ary=ary, iteration=4)
            return ary.copy()
        for i in range(5):
            p.execute_function(my_ary=ary, iteration=i)
        return ary.copy()

    port = TorchTokens if kind == "tokens" else TorchPacked
    ref = JaxTokens if kind == "tokens" else JaxPacked
    a, b = windows(port, True), windows(port, False)
    assert a.tobytes() == b.tobytes() == windows(ref, True).tobytes()


def test_replay_request_rewinds_the_pusher_like_the_reference(token_file):
    """The producer side alone: a ``ReplayRequest`` envelope read by the
    pusher's control poll rewinds it and is acked; a duplicate is acked
    and not applied twice.  The JAX pusher answers the same envelopes
    the same way."""
    from ddl_tpu.datapusher import DataPusher as JaxPusher
    from ddl_tpu.transport import connection as jconn
    from ddl_tpu.types import ControlEnvelope as JEnv
    from ddl_tpu.types import MetaData_Consumer_To_Producer as JMeta
    from ddl_tpu.types import ReplayRequest as JReplay
    from ddl_tpu.types import RunMode as JRunMode
    from ddl_tpu.types import Topology as JTopology
    from ddl_tpu_torch.datapusher import DataPusher
    from ddl_tpu_torch.transport import connection as tconn
    from ddl_tpu_torch.types import (
        ControlEnvelope, MetaData_Consumer_To_Producer, ReplayRequest,
        Topology,
    )

    def run(pusher_cls, conn_mod, meta, env_cls, replay_cls, topo, prod):
        cons, prod_end = conn_mod.ThreadChannel.pair()
        cons.send(meta(data_producer_function=prod, batch_size=BATCH))
        kw = {} if conn_mod is tconn else {"cross_process": False}
        pusher = pusher_cls(conn_mod.ProducerConnection(prod_end, 1, **kw),
                            topo, 1)
        cons.recv(timeout_s=5)  # the handshake reply
        pusher._iteration = 5
        env = env_cls(seq=0, incarnation=0, fence=0, payload=replay_cls(2))
        cons.send(env)
        cons.send(env)
        pusher._poll_control()
        acks = [cons.recv(timeout_s=5), cons.recv(timeout_s=5)]
        pusher.connection.finalize()
        return pusher._iteration, [(a.seq, a.dup) for a in acks]

    got = run(DataPusher, tconn, MetaData_Consumer_To_Producer,
              ControlEnvelope, ReplayRequest, Topology(n_producers=1),
              TorchTokens(token_file, SEQ, ROWS, seed=3))
    want = run(JaxPusher, jconn, JMeta, JEnv, JReplay,
               JTopology(n_producers=1, mode=JRunMode.THREAD),
               JaxTokens(token_file, SEQ, ROWS, seed=3))
    assert got == want == (2, [(0, False), (0, True)])


def test_replay_budget_knob_keeps_the_reference_default(monkeypatch):
    from ddl_tpu import envspec as jspec
    from ddl_tpu_torch import envspec

    monkeypatch.delenv("DDL_TORCH_MAX_REPLAYS", raising=False)
    assert envspec.get("DDL_TORCH_MAX_REPLAYS") == \
        jspec.get("DDL_TPU_MAX_REPLAYS") == 2
    assert os.environ.get("DDL_TORCH_MAX_REPLAYS") is None


def test_corrupt_window_behind_held_slots_replays(token_file, monkeypatch):
    """Inline windows on the card keep their slots until their copies
    complete, so a corrupt window can reach the blocking acquire behind
    held slots.  The loader frees them and quarantines it at the head
    (the slot hold of a card copy is forced here on the CPU)."""
    from ddl_tpu_torch.ingest import DeviceIngestor

    monkeypatch.setattr(DeviceIngestor, "window_source_detached",
                        lambda self: False)
    tokens = TorchTokens(token_file, SEQ, ROWS, seed=3)
    clean, _ = _stream("torch", tokens, n_producers=1)
    with corrupt_commits("torch", producer=1, seq=2):
        got, m = _stream("torch", tokens, n_producers=1)
    assert got == clean
    assert m.counter("integrity.replays") == 1
    assert m.timer("integrity.replay").count == 1


def test_loader_fast_forward_skips_windows_like_the_reference(token_file):
    """``fast_forward(n)`` discards the next n windows unserved; the
    stream then continues where a full run would be."""
    def run(pkg, skip):
        mod = PKGS[pkg][0]
        prod = (JaxTokens if pkg == "jax" else TorchTokens)(token_file, SEQ,
                                                            ROWS, seed=3)
        extra = {"pin_memory": False} if pkg == "torch" else {}

        @mod.distributed_dataloader(n_producers=2, mode="thread", nslots=2,
                                    **extra)
        def main(env):
            kw = {"metrics": Metrics()} if pkg == "torch" else {}
            loader = mod.DistributedDataLoader(
                prod, batch_size=BATCH, connection=env.connection,
                n_epochs=EPOCHS, output="numpy", **kw)
            loader.fast_forward(skip)
            out = []
            for _ in range(EPOCHS - skip):
                out.append(b"".join(np.asarray(x).tobytes()
                                    for (x,) in _batches(loader, mod)))
                loader.mark(mod.Marker.END_OF_EPOCH)
            return out

        return main()

    full = run("torch", 0)
    assert run("torch", 3) == run("jax", 3) == full[3:]
