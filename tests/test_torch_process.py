"""PROCESS mode in the port: spawned producer processes over native
shared-memory rings, against the port's THREAD mode and the JAX package.

- The ``windows()`` stream of ``TokenStreamProducer`` and of
  ``PackedTokenProducer`` is byte-identical across the port's PROCESS
  and THREAD modes and the JAX package's stream, for the same file and
  seed; so are the committed slots, trailers included.
- A producer's handshake-time error reaches the consumer; the consumer's
  abort wakes producers parked on full rings, which exit 0.
- A 2-layer ``Trainer.fit`` in PROCESS mode tracks the JAX trainer at
  ``rtol 1e-4``, as ``tests/test_torch_trainer.py`` holds THREAD mode.

The spawned producers are ``ddl_tpu_torch.readers`` classes, so a child
never imports this module (nor JAX).  Every join is bounded: the
decorator joins each producer with a timeout and records its exit code.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import ddl_tpu
import ddl_tpu_torch
from ddl_tpu import integrity as jint
from ddl_tpu.config import LoaderConfig as JaxLoaderConfig
from ddl_tpu.models import llama as jllama
from ddl_tpu.parallel.mesh import make_mesh
from ddl_tpu.readers import PackedTokenProducer as JaxPacked
from ddl_tpu.readers import TokenStreamProducer as JaxTokens
from ddl_tpu.trainer import Trainer as JaxTrainer
from ddl_tpu_torch import integrity as tint
from ddl_tpu_torch.config import LoaderConfig
from ddl_tpu_torch.env import detect_topology
from ddl_tpu_torch.exceptions import TransportError
from ddl_tpu_torch.models import llama as tllama
from ddl_tpu_torch.observability import Metrics
from ddl_tpu_torch.parallel.train import adamw
from ddl_tpu_torch.readers import PackedTokenProducer as TorchPacked
from ddl_tpu_torch.readers import TokenStreamProducer as TorchTokens
from ddl_tpu_torch.trainer import Trainer
from ddl_tpu_torch.transport.shm_ring import PyShmRing
from ddl_tpu_torch.types import RunMode

SEQ, ROWS, BATCH, EPOCHS = 32, 8, 4, 6


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = os.path.join(tmp_path_factory.mktemp("tok"), "tokens.bin")
    np.random.default_rng(5).integers(0, 50_000, 40_000,
                                      dtype=np.int32).tofile(path)
    return path


@pytest.fixture(scope="module")
def docs_file(tmp_path_factory):
    """Documents of 4-29 tokens, each closed by the delimiter 0."""
    rng = np.random.default_rng(4)
    docs = [rng.integers(1, 60, size=int(n)).tolist() + [0]
            for n in rng.integers(4, 30, size=400)]
    path = os.path.join(tmp_path_factory.mktemp("docs"), "docs.bin")
    np.asarray([t for d in docs for t in d], np.int32).tofile(path)
    return path


def _producers(kind, path):
    if kind == "tokens":
        return TorchTokens(path, SEQ, ROWS, seed=3), JaxTokens(path, SEQ, ROWS, seed=3)
    return (TorchPacked(path, SEQ, ROWS, delimiter=0, seed=3),
            JaxPacked(path, SEQ, ROWS, delimiter=0, seed=3))


def _torch_windows(producer, mode):
    metrics = Metrics()

    @ddl_tpu_torch.distributed_dataloader(n_producers=2, mode=mode, nslots=2,
                                          pin_memory=False)
    def run(env):
        loader = ddl_tpu_torch.DistributedDataLoader(
            producer, batch_size=BATCH, connection=env.connection,
            n_epochs=EPOCHS, output="device", device="cpu", metrics=metrics,
        )
        out = []
        for win in loader.windows(lookahead=2):
            out.append(win.numpy().copy())
            loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
        return out, env

    out, env = run()
    return out, env.workers.exitcodes, metrics


def _jax_windows(producer):
    @ddl_tpu.distributed_dataloader(n_producers=2, mode="thread", nslots=2)
    def run(env):
        loader = ddl_tpu.DistributedDataLoader(
            producer, batch_size=BATCH, connection=env.connection,
            n_epochs=EPOCHS, output="jax",
        )
        out = []
        for win in loader.windows(lookahead=2):
            out.append(np.asarray(win).copy())
            loader.mark(ddl_tpu.Marker.END_OF_EPOCH)
        return out

    return run()


def test_detect_topology_takes_process_mode():
    """PROCESS mode, and MULTIHOST (ported): without an initialised
    process group a MULTIHOST topology is one instance, as the reference
    reads ``jax.process_count() == 1`` without ``jax.distributed``."""
    assert detect_topology(3, "process").mode is RunMode.PROCESS
    topo = detect_topology(1, "multihost")
    assert topo.mode is RunMode.MULTIHOST
    assert (topo.n_instances, topo.instance_idx) == (1, 0)


@pytest.mark.parametrize("kind", ["tokens", "packed"])
def test_process_window_stream_equals_thread_and_reference(
        kind, token_file, docs_file):
    path = token_file if kind == "tokens" else docs_file
    tprod, jprod = _producers(kind, path)
    got, codes, m = _torch_windows(tprod, "process")
    thread, _, _ = _torch_windows(tprod, "thread")
    want = _jax_windows(jprod)
    assert codes == [0, 0]
    assert m.counter("transport.rings.NativeShmRing") == 2
    assert m.counter("integrity.corrupt_windows") == 0
    assert len(got) == len(thread) == len(want) == EPOCHS
    width = SEQ if kind == "tokens" else 2 * SEQ
    for g, t, w in zip(got, thread, want):
        assert g.shape == (ROWS // BATCH, BATCH, width)
        assert g.tobytes() == t.tobytes() == w.tobytes()


def _slots(loader, marker, n):
    """The committed bytes of ``n`` windows, payload and trailer, read
    from each acquired slot while the batch path serves it."""
    out = []
    for _ in range(n):
        for idx in range(len(loader)):
            loader[idx]
            if idx == 0:
                ring = loader.connection.rings[loader._target]
                payload = ring.slot_payload(loader._cur_slot)
                out.append(bytes(ring.slot_view(loader._cur_slot)[
                    :payload + tint.HEADER_BYTES]))
            loader.mark(marker.END_OF_BATCH)
        loader.mark(marker.END_OF_EPOCH)
    return out


def test_process_slots_and_trailers_equal_thread_and_reference(token_file):
    assert tint.HEADER_BYTES == jint.HEADER_BYTES

    def port(mode):
        @ddl_tpu_torch.distributed_dataloader(n_producers=2, mode=mode,
                                              nslots=2, pin_memory=False)
        def run(env):
            loader = ddl_tpu_torch.DistributedDataLoader(
                TorchTokens(token_file, SEQ, ROWS, seed=3), batch_size=BATCH,
                connection=env.connection, n_epochs=EPOCHS, output="numpy",
                metrics=Metrics())
            return _slots(loader, ddl_tpu_torch.Marker, EPOCHS), env

        slots, env = run()
        return slots, env.workers.exitcodes

    @ddl_tpu.distributed_dataloader(n_producers=2, mode="thread", nslots=2)
    def reference(env):
        loader = ddl_tpu.DistributedDataLoader(
            JaxTokens(token_file, SEQ, ROWS, seed=3), batch_size=BATCH,
            connection=env.connection, n_epochs=EPOCHS, output="numpy")
        return _slots(loader, ddl_tpu.Marker, EPOCHS)

    got, codes = port("process")
    thread, _ = port("thread")
    want = reference()
    assert codes == [0, 0]
    assert len(got) == EPOCHS
    assert got == thread == want
    for seq, raw in enumerate(got):
        view = np.frombuffer(raw, np.uint8)
        assert jint.verify_window(view, len(raw) - jint.HEADER_BYTES,
                                  expect_seq=seq // 2,
                                  expect_producer=seq % 2 + 1) is None


def test_handshake_error_in_a_child_reaches_the_consumer(tmp_path):
    missing = os.path.join(tmp_path, "no-such-file.bin")

    @ddl_tpu_torch.distributed_dataloader(n_producers=2, mode="process",
                                          nslots=2, pin_memory=False)
    def run(env):
        ddl_tpu_torch.DistributedDataLoader(
            TorchTokens(missing, SEQ, ROWS), batch_size=BATCH,
            connection=env.connection, n_epochs=1, output="numpy",
            metrics=Metrics())

    t0 = time.perf_counter()
    with pytest.raises(TransportError, match="failed during handshake") as e:
        run()
    assert isinstance(e.value.__cause__, FileNotFoundError)
    assert time.perf_counter() - t0 < 60  # failed fast, not at a timeout


def test_abort_wakes_producers_parked_on_full_rings(token_file, monkeypatch):
    """After one window the consumer returns without shutting the loader
    down: the decorator's abort must wake both producers, parked on
    full rings, and both must exit 0.  The producers run on the Python
    ring: ``DDL_TORCH_FORCE_PY_RING`` reaches them through the
    environment they inherit."""
    monkeypatch.setenv("DDL_TORCH_FORCE_PY_RING", "1")

    @ddl_tpu_torch.distributed_dataloader(n_producers=2, mode="process",
                                          nslots=2, pin_memory=False)
    def run(env):
        loader = ddl_tpu_torch.DistributedDataLoader(
            TorchTokens(token_file, SEQ, ROWS, seed=3), batch_size=BATCH,
            connection=env.connection, n_epochs=EPOCHS, output="device",
            device="cpu", metrics=Metrics())
        next(loader.windows(lookahead=0))
        deadline = time.perf_counter() + 60
        rings = loader.connection.rings
        assert all(isinstance(r, PyShmRing) for r in rings)
        while any(r.stats()["committed"] - r.stats()["released"] < r.nslots
                  for r in rings):
            assert time.perf_counter() < deadline, "rings never filled"
            time.sleep(0.01)
        return env

    env = run()
    assert env.workers.exitcodes == [0, 0]
    assert all(not p.is_alive() for p in env.workers.processes)


def test_process_fit_tracks_the_jax_trainer(token_file):
    jcfg = jllama.LlamaConfig(vocab=96, d_model=32, n_layers=2, n_heads=4,
                              n_kv_heads=2, d_ff=64, max_seq=SEQ,
                              dtype=jnp.float32)
    tcfg = tllama.LlamaConfig(vocab=96, d_model=32, n_layers=2, n_heads=4,
                              n_kv_heads=2, d_ff=64, max_seq=SEQ,
                              dtype=torch.float32)
    path = token_file + ".small.bin"
    np.random.default_rng(2).integers(0, jcfg.vocab, 20_000,
                                      dtype=np.int32).tofile(path)
    params = jax.tree.map(np.asarray, jllama.init_params(jcfg, jax.random.key(1)))
    lr, epochs = 3e-3, 3
    want = JaxTrainer(
        loss_fn=lambda p, b: jllama.next_token_loss(p, b[0], jcfg),
        optimizer=optax.adamw(lr),
        mesh=make_mesh({"dp": 1}, devices=jax.local_devices()[:1]),
        param_specs=jllama.param_specs(jcfg),
        init_params=jax.tree.map(jnp.asarray, params),
        batch_spec=P(("dp",)),
    ).fit(JaxTokens(path, SEQ, ROWS), config=JaxLoaderConfig(
        batch_size=BATCH, n_epochs=epochs, n_producers=2,
        window_stream=True)).losses
    res = Trainer(
        loss_fn=lambda p, b: tllama.next_token_loss(p, b[0], tcfg),
        optimizer=adamw(lr),
        init_params=tllama.params_from_numpy(params, device="cpu"),
        device="cpu", metrics=Metrics(),
    ).fit(TorchTokens(path, SEQ, ROWS), config=LoaderConfig(
        batch_size=BATCH, n_epochs=epochs, n_producers=2, mode="process",
        window_stream=True))
    np.testing.assert_allclose(res.losses, want, rtol=1e-4)
    m = res.metrics
    assert res.state.step == epochs * ROWS // BATCH
    assert m.counter("producer.exits_clean") == 2
    assert m.counter("producer.exits_failed") == 0
    assert m.counter("transport.rings.NativeShmRing") == 2
    assert m.timer("trainer.first_window").count == 1
    assert m.timer("trainer.windows").count == 1
    assert m.timer("consumer.handshake").count == 1


def test_spawned_producers_import_no_torch_with_shm_shuffle_and_envelopes(
        tmp_path):
    """A spawned producer stays free of torch (and of JAX) with a
    ``ShmRendezvous`` shuffler factory pickled to it and the envelope
    receiver answering a command: every window reports the child's
    ``sys.modules``, and the command's ack comes back."""
    from ddl_tpu_torch.env import WorkerSet
    from ddl_tpu_torch.shuffle import (
        ShmRendezvous, ThreadExchangeShuffler, make_session,
    )
    from ddl_tpu_torch.types import Topology
    from torch_recovery_producers import ModulesProducer

    rdv = ShmRendezvous(make_session("t-modules"), root=str(tmp_path))
    factory = ThreadExchangeShuffler.factory(rendezvous=rdv)
    sets, loaders, metrics = [], [], []
    try:
        for i in range(2):
            ws = WorkerSet(Topology(n_instances=2, instance_idx=i,
                                    n_producers=1, mode=RunMode.PROCESS),
                           nslots=2, shuffler_factory=factory)
            sets.append(ws)
            metrics.append(Metrics())
            loaders.append(ddl_tpu_torch.DistributedDataLoader(
                ModulesProducer(), batch_size=16, connection=ws.connection,
                n_epochs=4, output="numpy",
                global_shuffle_fraction_exchange=0.5, metrics=metrics[-1],
                timeout_s=60.0))
        # A command the pushers cannot apply while shuffling: unwrapped,
        # refused and acked all the same.
        loaders[0].connection.request_replay(0, 1)
        seen = []
        for _ in range(3):
            for loader in loaders:
                (flags, jax_flags) = loader[0]
                seen.append((float(flags.max()), float(jax_flags.max())))
                loader.mark(ddl_tpu_torch.Marker.END_OF_BATCH)
                loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
        # The pusher polls its channel once per window: the ack may come
        # after the last window this test drains.
        deadline = time.monotonic() + 30
        while (metrics[0].counter("ctrl.acked") < 1
               and time.monotonic() < deadline):
            loaders[0].connection.drain_acks()
            time.sleep(0.01)
    finally:
        for loader in loaders:
            loader.shutdown()
        for ws in sets:
            ws.abort()
            ws.join(30.0)
        rdv.cleanup()
    assert seen == [(0.0, 0.0)] * 6
    assert metrics[0].counter("ctrl.acked") == 1
    assert [ws.exitcodes for ws in sets] == [[0], [0]]
