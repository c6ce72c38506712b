"""The port's THREAD-mode loader against the JAX package's.

Both packages serve the same ``TokenStreamProducer`` file with the same
seeds, integrity on; the port's ``windows()`` stream (lookahead 2) and its
batch stream must be byte-identical to the JAX package's, and so must the
two-column ``PackedTokenProducer`` stream (tokens and segment ids).  Integrity
trailers are byte-identical too: a window stamped by either package
verifies in the other's ``verify_window``, and a flipped byte fails both.
"""

import os

import numpy as np
import pytest

import ddl_tpu
import ddl_tpu_torch
from ddl_tpu import integrity as jint
from ddl_tpu.readers import PackedTokenProducer as JaxPacked
from ddl_tpu.readers import TokenStreamProducer as JaxTokens
from ddl_tpu_torch import integrity as tint
from ddl_tpu_torch.readers import PackedTokenProducer as TorchPacked
from ddl_tpu_torch.readers import TokenStreamProducer as TorchTokens
from ddl_tpu_torch.transport.ring import ThreadRing

SEQ, ROWS, BATCH, EPOCHS = 32, 8, 4, 6


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = os.path.join(tmp_path_factory.mktemp("tok"), "tokens.bin")
    np.random.default_rng(5).integers(0, 50_000, 40_000, dtype=np.int32).tofile(path)
    return path


def _jax_windows(path, lookahead, producer=None):
    @ddl_tpu.distributed_dataloader(n_producers=2, mode="thread", nslots=2)
    def run(env):
        loader = ddl_tpu.DistributedDataLoader(
            producer or JaxTokens(path, SEQ, ROWS, seed=3), batch_size=BATCH,
            connection=env.connection, n_epochs=EPOCHS, output="jax",
        )
        out = []
        for win in loader.windows(lookahead=lookahead):
            out.append(np.asarray(win).copy())
            loader.mark(ddl_tpu.Marker.END_OF_EPOCH)
        return out

    return run()


def _torch_windows(path, lookahead, producer=None):
    @ddl_tpu_torch.distributed_dataloader(n_producers=2, mode="thread",
                                          nslots=2, pin_memory=False)
    def run(env):
        loader = ddl_tpu_torch.DistributedDataLoader(
            producer or TorchTokens(path, SEQ, ROWS, seed=3), batch_size=BATCH,
            connection=env.connection, n_epochs=EPOCHS, output="device",
            device="cpu",
        )
        out = []
        for win in loader.windows(lookahead=lookahead):
            out.append(win.numpy().copy())
            loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
        assert loader.last_window_key() == (2, EPOCHS // 2 - 1)
        return out, loader.metrics.counter("integrity.corrupt_windows")

    return run()


@pytest.mark.parametrize("lookahead", [2, 3])
def test_window_stream_byte_identical(token_file, lookahead):
    want = _jax_windows(token_file, lookahead)
    got, corrupt = _torch_windows(token_file, lookahead)
    assert corrupt == 0
    assert len(got) == len(want) == EPOCHS
    for g, w in zip(got, want):
        assert g.shape == w.shape == (ROWS // BATCH, BATCH, SEQ)
        assert g.dtype == w.dtype
        assert g.tobytes() == w.tobytes()


def test_packed_window_stream_byte_identical(tmp_path):
    """PackedTokenProducer windows, both column blocks (tokens, then
    row-local segment ids), byte-identical to the JAX package's."""
    rng = np.random.default_rng(6)
    docs = [rng.integers(1, 60, size=int(n)).tolist() + [0]
            for n in rng.integers(4, 30, size=600)]
    path = str(tmp_path / "docs.bin")
    np.asarray([t for d in docs for t in d], np.int32).tofile(path)
    want = _jax_windows(path, 2, JaxPacked(path, SEQ, ROWS, delimiter=0,
                                           seed=3))
    got, corrupt = _torch_windows(path, 2, TorchPacked(path, SEQ, ROWS,
                                                       delimiter=0, seed=3))
    assert corrupt == 0
    assert len(got) == len(want) == EPOCHS
    for g, w in zip(got, want):
        assert g.shape == w.shape == (ROWS // BATCH, BATCH, 2 * SEQ)
        assert g.tobytes() == w.tobytes()
    seg = np.concatenate(got)[..., SEQ:]
    assert seg.max() > 0 and (np.diff(seg, axis=-1) >= 0).all()


def _batches(pkg, tokens_cls, path, **kw):
    @pkg.distributed_dataloader(n_producers=2, mode="thread", nslots=2, **kw)
    def run(env):
        loader = pkg.DistributedDataLoader(
            tokens_cls(path, SEQ, ROWS, seed=9), batch_size=BATCH,
            connection=env.connection, n_epochs=4, output="numpy",
        )
        out = []
        for _ in range(4):
            for (tok,) in loader:
                out.append(np.array(tok))
                loader.mark(pkg.Marker.END_OF_BATCH)
            loader.mark(pkg.Marker.END_OF_EPOCH)
        return out

    return run()


def test_batch_stream_byte_identical(token_file):
    want = _batches(ddl_tpu, JaxTokens, token_file)
    got = _batches(ddl_tpu_torch, TorchTokens, token_file, pin_memory=False)
    assert len(got) == len(want) == 4 * ROWS // BATCH
    assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))


@pytest.mark.parametrize("stamper,verifier", [(tint, jint), (jint, tint)])
def test_trailer_interop(stamper, verifier):
    rng = np.random.default_rng(1)
    payload = 1000
    slot = np.zeros(payload + tint.HEADER_BYTES, np.uint8)
    slot[:payload] = rng.integers(0, 256, payload, dtype=np.uint8)
    stamper.write_header(slot, payload, seq=41, producer_idx=2,
                         crc=stamper.window_crc(slot[:payload]))
    assert verifier.verify_window(slot, payload, 41, 2) is None
    assert "seq" in verifier.verify_window(slot, payload, 40, 2)
    assert "producer" in verifier.verify_window(slot, payload, 41, 1)
    slot[17] ^= 0x20
    assert "crc32" in verifier.verify_window(slot, payload, 41, 2)


def test_trailer_bytes_identical():
    slot_a = np.zeros(64 + 32, np.uint8)
    slot_b = np.zeros(64 + 32, np.uint8)
    tint.write_header(slot_a, 64, seq=2**40 + 3, producer_idx=7, crc=0xDEADBEEF)
    jint.write_header(slot_b, 64, seq=2**40 + 3, producer_idx=7, crc=0xDEADBEEF)
    assert slot_a.tobytes() == slot_b.tobytes()
    assert tint.read_header(slot_b, 64) == tint.WindowHeader(
        *jint.read_header(slot_b, 64).__dict__.values())


def test_corrupt_window_raises_integrity_error(token_file, monkeypatch):
    """A flipped byte in a committed slot fails the drain-time verify.
    With replays off (``DDL_TORCH_MAX_REPLAYS=0``) the quarantine ladder
    has no rung left and raises at once; the replay itself is held to
    the JAX package in ``tests/test_torch_replay.py``."""
    from ddl_tpu_torch.exceptions import IntegrityError

    monkeypatch.setenv("DDL_TORCH_MAX_REPLAYS", "0")

    @ddl_tpu_torch.distributed_dataloader(n_producers=1, mode="thread",
                                          nslots=2, pin_memory=False)
    def run(env):
        loader = ddl_tpu_torch.DistributedDataLoader(
            TorchTokens(token_file, SEQ, ROWS), batch_size=BATCH,
            connection=env.connection, n_epochs=2, output="numpy",
        )
        ring = env.connection.rings[0]
        slot = ring.acquire_drain(timeout_s=30)
        ring.slot_view(slot)[5] ^= 0xFF  # corrupt in place, then serve
        with pytest.raises(IntegrityError, match="crc32"):
            loader[0]
        loader.shutdown()

    run()


def test_thread_ring_lookahead_and_shutdown():
    from ddl_tpu_torch.exceptions import ShutdownRequested, StallTimeoutError

    ring = ThreadRing(nslots=2, slot_bytes=8)
    for i in range(2):
        s = ring.acquire_fill(timeout_s=1)
        ring.slot_view(s)[0] = i
        ring.commit(s, 8)
    assert ring.acquire_drain(timeout_s=1) == 0
    assert ring.acquire_drain_ahead(1, timeout_s=1) == 1
    assert not ring.poll_drain_ready(2)
    with pytest.raises(StallTimeoutError):
        ring.acquire_fill(timeout_s=0.01)
    with pytest.raises(ValueError):
        ring.release(1)  # out of FIFO order
    ring.release(0)
    assert ring.acquire_fill(timeout_s=1) == 0
    ring.shutdown()
    with pytest.raises(ShutdownRequested):
        ring.acquire_drain(timeout_s=1)
