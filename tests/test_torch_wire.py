"""The port's wire formats (``ddl_tpu_torch/wire.py``) against the JAX
package's (``ddl_tpu/wire.py``), on the CPU.

- Codecs and the quantizer: the host ``encode_window`` in bf16 and int8
  byte-identical to the reference's (bf16 over ties, subnormals, infs
  and the largest finite values; a NaN encodes as the reference's quiet
  NaN ``0x7FC0``/``0xFFC0`` with its sign, compared as bit patterns);
  ``decode_window`` bit-identical.
- ``pack_rows`` envelopes byte-identical across wire dtype x codec;
  malformed envelopes raise ``DecodeError``.
- The integrity trailer's wire extension: stamped slots byte-identical,
  the CRC over the encoded payload and the scales, raw headers as before.
- The slot wire through THREAD and PROCESS loaders: the served stream
  byte-identical to the reference loader's under the same wire, its
  drift against raw bounded and nonzero, the handshake refusals, and a
  loss-parity check of a linear probe trained on the torch streams.
- Wire chaos: ``WIRE_CORRUPTION`` quarantined and replayed, ``DECODE_FAIL``
  retried once, and the exchange's raw-fallback latch.
- The exchange lanes: pools byte-identical to the reference's exchange on
  every wire; ``plan_exchange`` equal to the reference's.
- The ICI wire: plans equal to the reference's ``plan_distribution``, and
  the values landed on the port's CPU mesh equal the host decode of the
  host encode (the bf16 case is held to the host ``encode_window``, not
  to the reference's intermittent ICI drift test).
- Compressed shards: zlib ``.npy``/TFRecord/tar shards through
  ``CodecBackend`` serve the JAX package's raw stream (THREAD, PROCESS,
  cached); compressed disk-tier entries byte-identical to the
  reference's and quarantined when corrupt.
"""

import os
import re
import threading
import zlib as _zlib

import numpy as np
import pytest
import torch

import ddl_tpu
import ddl_tpu.observability
import ddl_tpu.readers
import ddl_tpu.shuffle
import ddl_tpu.types
import ddl_tpu_torch
import ddl_tpu_torch.observability
import ddl_tpu_torch.readers
import ddl_tpu_torch.shuffle
import ddl_tpu_torch.types
from ddl_tpu import faults as jfaults
from ddl_tpu import integrity as jint
from ddl_tpu import wire as jw
from ddl_tpu.observability import Metrics as JaxMetrics
from ddl_tpu_torch import faults as tfaults
from ddl_tpu_torch import integrity as tint
from ddl_tpu_torch import wire as tw
from ddl_tpu_torch.exceptions import (
    DecodeError,
    DoesNotMatchError,
    TransportError,
)
from ddl_tpu_torch.observability import Metrics

PKGS = {"jax": ddl_tpu, "torch": ddl_tpu_torch}

#: float32 bit patterns the bf16 rounding must treat as the reference
#: does: ties to even, subnormals, the largest finite values (which round
#: to inf), infs, 1 - ulp.
SPECIAL_BITS = np.array([
    0x3F808000, 0x3F818000, 0x3F808001, 0x00008000, 0x00018000, 0x00000001,
    0x807FFFFF, 0x007FFFFF, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F800000, 0xFF800000,
    0x3F7FFFFF, 0x00000000, 0x80000000, 0x47FFF000,
], np.uint32)
NAN_BITS = np.array([0x7FC00001, 0xFFC00001, 0x7F800001, 0xFF812345,
                     0x7FFFFFFF], np.uint32)


def _windows(rng):
    """The shapes the quantizer meets: a block multiple, a ragged last
    block, one narrow row, 3-D."""
    return [
        rng.standard_normal((8, 512)).astype(np.float32),
        (rng.standard_normal((16, 700)) * 1e3).astype(np.float32),
        rng.standard_normal((64, 48)).astype(np.float32),
        rng.standard_normal((4, 3, 100)).astype(np.float32),
        rng.standard_normal((5, 1)).astype(np.float32),
    ]


# -- codecs ------------------------------------------------------------------


class TestCodecs:
    def test_zlib_always_available_and_roundtrips(self):
        assert "zlib" in tw.available_codecs()
        c = tw.get_codec("zlib")
        data = bytes(range(256)) * 64
        enc = c.encode_bytes(data, level=3)
        assert enc == jw.get_codec("zlib").encode_bytes(data, level=3)
        assert c.decode_bytes(enc, max_output=len(data)) == data

    def test_decode_is_bounded(self):
        c = tw.get_codec("zlib")
        enc = c.encode_bytes(b"x" * 10000, level=1)
        with pytest.raises(DecodeError):
            c.decode_bytes(enc, max_output=100)

    def test_zlib_decode_reads_gzip_frames_too(self):
        import gzip

        data = bytes(range(256)) * 16
        assert tw.get_codec("zlib").decode_bytes(
            gzip.compress(data), max_output=len(data)) == data

    def test_truncated_stream_raises_not_partial_output(self):
        c = tw.get_codec("zlib")
        enc = c.encode_bytes(b"y" * 50000, level=1)
        with pytest.raises(DecodeError, match="truncated"):
            c.decode_bytes(enc[: len(enc) // 2], max_output=1 << 20)

    def test_unknown_and_gated_codecs_named(self):
        with pytest.raises(ValueError, match="unknown codec"):
            tw.get_codec("brotli")
        assert tw.available_codecs() == jw.available_codecs()
        for name in ("zstd", "lz4"):
            if name in tw.available_codecs():
                continue
            with pytest.raises(ValueError, match="available here"):
                tw.get_codec(name)

    def test_resolve_wire_codec_and_dtype(self, monkeypatch):
        monkeypatch.delenv("DDL_TORCH_WIRE_CODEC", raising=False)
        monkeypatch.delenv("DDL_TORCH_WIRE_DTYPE", raising=False)
        assert tw.resolve_wire_codec(None) is None
        assert tw.resolve_wire_codec("none") is None
        assert tw.resolve_wire_codec("zlib") == "zlib"
        monkeypatch.setenv("DDL_TORCH_WIRE_CODEC", "zlib")
        assert tw.resolve_wire_codec("junk") == "zlib"  # env wins
        monkeypatch.delenv("DDL_TORCH_WIRE_CODEC")
        with pytest.raises(ValueError):
            tw.resolve_wire_codec("junk")
        assert tw.resolve_wire_dtype("int8") == "int8"
        monkeypatch.setenv("DDL_TORCH_WIRE_DTYPE", "raw")
        assert tw.resolve_wire_dtype("int8") == "raw"  # the kill switch
        monkeypatch.setenv("DDL_TORCH_WIRE_DTYPE", "")
        assert tw.resolve_wire_dtype("bf16") == "bf16"  # empty: no opinion
        with pytest.raises(ValueError, match="wire_dtype"):
            tw.check_wire_dtype("fp8")


# -- the quantizer and the window encode --------------------------------------


class TestQuantizer:
    @pytest.mark.parametrize("wd", ["raw", "bf16", "int8"])
    def test_encode_window_byte_identical_to_reference(self, rng, wd):
        for x in _windows(rng):
            jp, js = jw.encode_window(x, wd)
            tp, ts = tw.encode_window(x, wd)
            assert tp.dtype == np.uint8 and tp.tobytes() == jp.tobytes()
            assert (ts is None) == (js is None)
            if ts is not None:
                assert ts.dtype == np.float32 and ts.tobytes() == js.tobytes()
            assert tp.nbytes == tw.encoded_nbytes(x.shape, x.dtype, wd)
            assert (0 if ts is None else ts.nbytes) == tw.scale_bytes_for(
                x.shape, wd)

    def test_bf16_special_values_byte_identical(self):
        x = SPECIAL_BITS.view(np.float32).reshape(1, -1)
        assert tw.encode_window(x, "bf16")[0].tobytes() == \
            jw.encode_window(x, "bf16")[0].tobytes()
        # NaN payloads: both give the quiet NaN with the input's sign —
        # compared as bit patterns (NaN != NaN as floats).
        nan = NAN_BITS.view(np.float32).reshape(1, -1)
        with np.errstate(invalid="ignore"):
            want = jw.encode_window(nan, "bf16")[0].view(np.uint16)
        got = tw.encode_window(nan, "bf16")[0].view(np.uint16)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, [0x7FC0, 0xFFC0, 0x7FC0, 0xFFC0, 0x7FC0])

    @pytest.mark.parametrize("wd", ["raw", "bf16", "int8"])
    def test_decode_window_bit_identical_to_reference(self, rng, wd):
        for x in _windows(rng):
            payload, scales = jw.encode_window(x, wd)
            want = jw.decode_window(payload, scales, x.shape, x.dtype, wd)
            got = tw.decode_window(payload, scales, x.shape, x.dtype, wd)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()

    def test_roundtrip_drift_bounded_and_nonzero(self, rng):
        x = rng.standard_normal((16, 700)).astype(np.float32)
        q, s = tw.quantize_rows(x)
        assert q.dtype == np.int8 and s.shape == (16, 3)  # ceil(700/256)
        jq, js = jw.quantize_rows(x)
        assert q.tobytes() == jq.tobytes() and s.tobytes() == js.tobytes()
        back = tw.dequantize_rows(q, s)
        drift = np.abs(back - x).max() / np.abs(x).max()
        assert 0.0 < drift < 1.5 / 127.0

    def test_zero_blocks_exact(self):
        x = np.zeros((4, 512), np.float32)
        q, s = tw.quantize_rows(x)
        assert np.array_equal(tw.dequantize_rows(q, s), x)
        assert np.all(s == 1.0)

    def test_lossy_needs_float(self):
        toks = np.arange(64, dtype=np.int32).reshape(8, 8)
        with pytest.raises(ValueError, match="float window"):
            tw.encode_window(toks, "int8")
        assert not tw.lossy_supported(np.int32)
        assert tw.lossy_supported(np.float32)

    def test_decode_into_out_buffer(self, rng):
        x = rng.standard_normal((4, 256)).astype(np.float32)
        payload, scales = tw.encode_window(x, "int8")
        out = np.empty_like(x)
        got = tw.decode_window(payload, scales, x.shape, x.dtype, "int8",
                               out=out)
        assert got is out and np.abs(out - x).max() < 0.05
        with pytest.raises(DecodeError, match="scales"):
            tw.decode_window(payload, None, x.shape, x.dtype, "int8")


# -- the exchange envelope ------------------------------------------------------


class TestEnvelope:
    @pytest.mark.parametrize("wd", ["raw", "bf16", "int8"])
    @pytest.mark.parametrize("codec", [None, "zlib"])
    def test_pack_rows_byte_identical_to_reference(self, rng, wd, codec):
        rows = rng.standard_normal((12, 40)).astype(np.float32)
        m, jm = Metrics(), JaxMetrics()
        buf = tw.pack_rows(rows, wd, codec=codec, level=3, metrics=m)
        want = jw.pack_rows(rows, wd, codec=codec, level=3, metrics=jm)
        assert buf.tobytes() == want.tobytes()
        out = tw.unpack_rows(buf, metrics=m)
        assert out.tobytes() == jw.unpack_rows(want).tobytes()
        assert out.shape == rows.shape and out.dtype == rows.dtype
        if wd == "raw":
            assert np.array_equal(out, rows)
        else:
            assert 0.0 < np.abs(out - rows).max() < 0.1
        assert m.counter("wire.encoded_bytes") == buf.nbytes
        assert m.counter("wire.payload_bytes") == rows.nbytes
        assert m.counter("wire.decoded_windows") == 1

    def test_int_rows_pack_like_the_reference(self):
        rows = np.arange(96, dtype=np.int64).reshape(12, 8)
        for codec in (None, "zlib"):
            assert tw.pack_rows(rows, "raw", codec=codec).tobytes() == \
                jw.pack_rows(rows, "raw", codec=codec).tobytes()

    def test_malformed_envelopes_raise_decode_error(self, rng):
        rows = rng.standard_normal((4, 8)).astype(np.float32)
        buf = tw.pack_rows(rows, "int8", codec="zlib", level=1)
        with pytest.raises(DecodeError):  # truncated
            tw.unpack_rows(buf[:10])
        bad = buf.copy()
        bad[0] ^= 0xFF  # magic
        with pytest.raises(DecodeError):
            tw.unpack_rows(bad)
        corrupt = buf.copy()
        corrupt[-3] ^= 0xFF  # compressed payload byte
        with pytest.raises(DecodeError):
            tw.unpack_rows(corrupt)

    def test_corruption_in_header_fields_still_raises_decode_error(self, rng):
        rows = rng.standard_normal((4, 8)).astype(np.float32)
        buf = tw.pack_rows(rows, "int8")
        for off in range(tw._PACK_BYTES, tw._PACK_BYTES + 24):
            bad = buf.copy()
            bad[off] ^= 0xFF
            try:
                tw.unpack_rows(bad)
            except DecodeError:
                pass  # the only acceptable failure type

    def test_unpack_respects_max_output(self, rng):
        rows = rng.integers(0, 4, (64, 64)).astype(np.float32)
        buf = tw.pack_rows(rows, "raw", codec="zlib", level=6)
        with pytest.raises(DecodeError):
            tw.unpack_rows(buf, max_output=64)


# -- the integrity trailer's wire extension -----------------------------------


def _stamp(mod, w, win, wd, seq=5, producer=2):
    """A slot stamped the way the pusher's encoded commit does it."""
    payload, scales = w.encode_window(win, wd)
    sb = scales.nbytes if scales is not None else 0
    slot = np.zeros(win.nbytes + mod.HEADER_BYTES, np.uint8)
    enc = payload.nbytes
    slot[:enc] = payload
    if scales is not None:
        mod.write_scales(slot, enc, scales)
    mod.write_header(slot, enc, seq=seq, producer_idx=producer,
                     crc=mod.wire_crc(slot, enc, sb),
                     wire_code=w.WIRE_CODES[wd], scale_bytes=sb)
    return slot, enc, sb


class TestTrailerExtension:
    @pytest.mark.parametrize("wd", ["raw", "bf16", "int8"])
    def test_stamped_slots_byte_identical(self, rng, wd):
        win = rng.standard_normal((8, 300)).astype(np.float32)
        got, enc, sb = _stamp(tint, tw, win, wd)
        want, _, _ = _stamp(jint, jw, win, wd)
        assert got.tobytes() == want.tobytes()
        hdr = tint.read_header(got, enc)
        assert hdr.valid_magic and hdr.wire_dtype == wd
        assert hdr.scale_bytes == sb == tw.scale_bytes_for(win.shape, wd)
        # Each package verifies the other's slot.
        assert tint.verify_window(want, enc, 5, 2) is None
        assert jint.verify_window(got, enc, 5, 2) is None

    def test_roundtrip_with_scales(self, rng):
        win = rng.standard_normal((8, 300)).astype(np.float32)
        slot, enc, sb = _stamp(tint, tw, win, "int8")
        scales = tint.read_scales(slot, enc, sb)
        assert scales.tobytes() == jint.read_scales(slot, enc, sb).tobytes()
        dec = tw.decode_window(slot[:enc], scales, win.shape, win.dtype,
                               tint.read_header(slot, enc).wire_dtype)
        assert 0.0 < np.abs(dec - win).max() < 0.05

    def test_crc_covers_encoded_payload_and_scales(self, rng):
        win = rng.standard_normal((8, 300)).astype(np.float32)
        slot, enc, sb = _stamp(tint, tw, win, "int8")
        slot[3] ^= 0xFF  # encoded payload byte
        assert "crc" in tint.verify_window(slot, enc, 5, 2)
        slot[3] ^= 0xFF
        slot[enc + tint.HEADER_BYTES + 1] ^= 0xFF  # scale byte
        err = tint.verify_window(slot, enc, 5, 2)
        assert "crc" in err and "int8" in err

    def test_raw_headers_backcompat(self, rng):
        win = rng.standard_normal((4, 64)).astype(np.float32)
        slot = np.zeros(win.nbytes + tint.HEADER_BYTES, np.uint8)
        slot[: win.nbytes] = win.view(np.uint8).reshape(-1)
        tint.write_header(slot, win.nbytes, seq=0, producer_idx=1,
                          crc=tint.window_crc(slot[: win.nbytes]))
        hdr = tint.read_header(slot, win.nbytes)
        assert hdr.wire_dtype == "raw" and hdr.scale_bytes == 0
        assert tint.verify_window(slot, win.nbytes, 0, 1) is None


# -- the slot wire end to end --------------------------------------------------


DATA = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)


def _producer(pkg, wd, data=DATA, window_size=16, seed=1):
    prod = PKGS[pkg].readers.ArrayProducer(data, window_size=window_size,
                                           seed=seed)
    prod.wire_dtype = wd
    return prod


def _stream(pkg, prod, n_epochs=4, n_producers=2, batch_size=8,
            mode="thread"):
    """The served batches of a loader of package ``pkg``, concatenated,
    and its metrics."""
    p = PKGS[pkg]
    out = []
    metrics = p.observability.Metrics()

    @p.distributed_dataloader(n_producers=n_producers, mode=mode)
    def main(env):
        kw = {"device": "cpu"} if pkg == "torch" else {}
        loader = p.DistributedDataLoader(
            prod, batch_size=batch_size, connection=env.connection,
            n_epochs=n_epochs, output="numpy", metrics=metrics, **kw)
        for _ in range(n_epochs):
            for i in range(len(loader)):
                cols = loader[i]
                out.append(np.concatenate([np.array(c) for c in cols], axis=1))
                loader.mark(p.Marker.END_OF_BATCH)
            loader.mark(p.Marker.END_OF_EPOCH)

    main()
    return np.concatenate(out), metrics


class TestSlotWire:
    @pytest.mark.parametrize("wd", ["bf16", "int8"])
    def test_stream_byte_identical_to_reference(self, wd):
        want, _ = _stream("jax", _producer("jax", wd))
        got, m = _stream("torch", _producer("torch", wd))
        assert got.tobytes() == want.tobytes()
        assert m.counter("wire.decoded_windows") == 4
        assert m.counter("integrity.corrupt_windows") == 0

    def test_drift_bounded_and_nonzero(self):
        raw, _ = _stream("torch", _producer("torch", "raw"))
        for wd, tol in (("int8", 0.02), ("bf16", 0.05)):
            enc, m = _stream("torch", _producer("torch", wd))
            drift = np.abs(raw - enc).max() / np.abs(raw).max()
            assert 0.0 < drift < tol, (wd, drift)
            assert m.counter("wire.decoded_windows") > 0
            assert 0 < m.counter("wire.encoded_bytes") < m.counter(
                "wire.payload_bytes")

    def test_served_stream_is_the_host_decode_of_the_host_encode(self):
        """Every served window equals ``decode(encode(raw window))``."""
        raw, _ = _stream("torch", _producer("torch", "raw"))
        for wd in ("bf16", "int8"):
            enc, _ = _stream("torch", _producer("torch", wd))
            for w in range(0, raw.shape[0], 16):
                win = raw[w:w + 16]
                payload, scales = tw.encode_window(win, wd)
                want = tw.decode_window(payload, scales, win.shape,
                                        win.dtype, wd)
                assert enc[w:w + 16].tobytes() == want.tobytes()

    def test_process_mode_stream_equals_thread_mode(self):
        want, _ = _stream("torch", _producer("torch", "int8"))
        got, m = _stream("torch", _producer("torch", "int8"),
                         mode="process")
        assert got.tobytes() == want.tobytes()
        assert m.counter("wire.decoded_windows") == 4

    def test_parity_gate_on_a_linear_probe(self):
        """The lossy wire's license, as in the reference: a linear probe
        trained on the raw stream and on the int8-wire stream keeps the
        reference's loss-parity gate, with nonzero drift."""
        from ddl_tpu.parallel.optimizer import loss_parity

        def train(stream):
            y = torch.sin(torch.arange(stream.shape[1], dtype=torch.float32))
            w = torch.zeros(stream.shape[-1], requires_grad=True)
            losses = []
            for x in stream:
                x = torch.from_numpy(np.ascontiguousarray(x))
                loss = torch.mean((x @ w - y[: x.shape[0]]) ** 2)
                (g,) = torch.autograd.grad(loss, w)
                with torch.no_grad():
                    w -= 1e-4 * g
                losses.append(float(loss.detach()))
            return losses

        raw, _ = _stream("torch", _producer("torch", "raw"))
        enc, _ = _stream("torch", _producer("torch", "int8"))
        parity = loss_parity(train(raw.reshape(-1, 8, 8)),
                             train(enc.reshape(-1, 8, 8)), rel_tol=2e-2)
        assert parity["parity"], parity
        assert parity["max_rel_drift"] > 0.0

    def test_env_override_kills_reader_capability(self, monkeypatch):
        monkeypatch.setenv("DDL_TORCH_WIRE_DTYPE", "raw")
        raw_ref, _ = _stream("torch", _producer("torch", "raw"))
        forced, m = _stream("torch", _producer("torch", "int8"))
        assert np.array_equal(raw_ref, forced)
        assert m.counter("wire.decoded_windows") == 0

    def test_env_forces_the_wire_on_a_raw_reader(self, monkeypatch):
        monkeypatch.setenv("DDL_TORCH_WIRE_DTYPE", "bf16")
        got, m = _stream("torch", _producer("torch", "raw"))
        monkeypatch.delenv("DDL_TORCH_WIRE_DTYPE")
        want, _ = _stream("torch", _producer("torch", "bf16"))
        assert got.tobytes() == want.tobytes()
        assert m.counter("wire.decoded_windows") == 4

    @pytest.mark.parametrize("case", ["no_integrity", "forced_inplace",
                                      "degenerate", "int_window"])
    def test_refused_at_the_handshake(self, case, monkeypatch):
        """Each refusal of the reference, as a typed handshake failure."""
        prod = _producer("torch", "int8")
        if case == "no_integrity":
            monkeypatch.setenv("DDL_TORCH_INTEGRITY", "0")
        elif case == "forced_inplace":
            prod.inplace_fill = True
        elif case == "degenerate":
            # int8 at one value per row: 4 scale bytes per 1-byte value.
            prod = _producer("torch", "int8", data=DATA[:, :1].copy())
        else:
            prod = _producer("torch", "int8",
                             data=np.arange(512, dtype=np.int32).reshape(64, 8))
        with pytest.raises(TransportError, match="handshake") as err:
            _stream("torch", prod, n_epochs=1)
        assert isinstance(err.value.__cause__, DoesNotMatchError)
        assert re.search("wire_dtype|INTEGRITY", str(err.value.__cause__))

    def test_auto_inplace_is_skipped_under_a_lossy_wire(self):
        from ddl_tpu_torch import datapusher as tdp
        from ddl_tpu_torch.transport.connection import (
            ConsumerConnection,
            ProducerConnection,
            ThreadChannel,
        )
        from ddl_tpu_torch.types import MetaData_Consumer_To_Producer, Topology

        pushers = {}
        for wd in ("raw", "int8"):
            cons, prod_end = ThreadChannel.pair()
            ConsumerConnection([cons]).send_metadata(
                MetaData_Consumer_To_Producer(
                    data_producer_function=_producer("torch", wd),
                    batch_size=8, n_epochs=1,
                    global_shuffle_fraction_exchange=0.0,
                    exchange_method="sendrecv_replace"))
            pushers[wd] = tdp.DataPusher(
                ProducerConnection(prod_end, 1), Topology(n_producers=1), 1,
                metrics=Metrics())
        assert pushers["raw"].inplace_fill
        assert not pushers["int8"].inplace_fill
        assert pushers["int8"].wire_dtype == "int8"


# -- wire chaos ----------------------------------------------------------------


class TestWireChaos:
    def test_wire_corruption_quarantined_and_replayed(self):
        """WIRE_CORRUPTION flips encoded slot bytes after the CRC stamp:
        the drain-time check quarantines, the replay re-encodes, and the
        stream equals the undisturbed one byte for byte."""
        clean, _ = _stream("torch", _producer("torch", "int8"))
        # Producer 1's second window (seq 1), which the drain serves: a
        # spec on any producer could land on a window committed ahead and
        # never served.
        plan = tfaults.FaultPlan([tfaults.FaultSpec(
            "wire.encode", tfaults.FaultKind.WIRE_CORRUPTION, at=2,
            producer_idx=1, param=8)])
        with tfaults.armed(plan):
            got, m = _stream("torch", _producer("torch", "int8"))
        assert plan.fired
        assert m.counter("integrity.corrupt_windows") >= 1
        assert m.counter("integrity.replays") >= 1
        assert got.tobytes() == clean.tobytes()

    def test_decode_fail_retried_once(self):
        clean, _ = _stream("torch", _producer("torch", "int8"))
        plan = tfaults.FaultPlan([tfaults.FaultSpec(
            "wire.decode", tfaults.FaultKind.DECODE_FAIL, at=2)])
        with tfaults.armed(plan):
            got, m = _stream("torch", _producer("torch", "int8"))
        assert plan.fired
        assert m.counter("wire.decode_fails") == 1
        assert got.tobytes() == clean.tobytes()

    def test_persistent_decode_fail_raises_integrity_error(self):
        from ddl_tpu_torch.exceptions import IntegrityError

        plan = tfaults.FaultPlan([tfaults.FaultSpec(
            "wire.decode", tfaults.FaultKind.DECODE_FAIL, at=1, count=2)])
        with tfaults.armed(plan):
            with pytest.raises(IntegrityError, match="undecodable"):
                _stream("torch", _producer("torch", "int8"), n_epochs=1)

    def test_exchange_decode_fail_latches_raw_fallback(self):
        """Persistent DECODE_FAIL on the exchange wire: after the retry
        the shuffler latches its outgoing lanes to raw (wire.fallbacks),
        the round degrades node-locally, and the rounds go on."""
        from ddl_tpu_torch.shuffle import Rendezvous, ThreadExchangeShuffler
        from ddl_tpu_torch.types import Topology

        rdv = Rendezvous()
        metrics = [Metrics(), Metrics()]
        done = [None, None]
        plan = tfaults.FaultPlan([tfaults.FaultSpec(
            "wire.decode", tfaults.FaultKind.DECODE_FAIL, at=1, count=2)])

        def worker(i):
            topo = Topology(n_instances=2, instance_idx=i, n_producers=1)
            sh = ThreadExchangeShuffler(topo, 1, num_exchange=8,
                                        rendezvous=rdv, seed=3,
                                        wire_dtype="int8",
                                        exchange_timeout_s=10.0)
            sh.metrics = metrics[i]
            ary = np.random.default_rng(20 + i).standard_normal(
                (16, 4)).astype(np.float32)
            for _ in range(3):
                sh.global_shuffle(ary)
            done[i] = (ary, sh)

        with tfaults.armed(plan):
            ts = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30.0)
        assert all(d is not None for d in done), "a worker died"
        assert sum(m.counter("wire.fallbacks") for m in metrics) >= 1
        assert [sh for _, sh in done if sh._wire_raw]
        assert all(sh.exchange_round == 3 for _, sh in done)

    def test_wire_fallback_never_fires_undisturbed(self):
        pools, shufs = _exchange("torch", "int8", None)
        assert all(s.metrics.counter("wire.fallbacks") == 0 for s in shufs)
        assert all(s.metrics.counter("wire.decode_fails") == 0 for s in shufs)


# -- the exchange lanes --------------------------------------------------------


def _exchange(pkg, wd, codec, n=2, rounds=4, seed=5, dtype=np.float32):
    """``rounds`` host-exchange rounds of ``n`` instances of package
    ``pkg``; returns each instance's pool after every round, and the
    shufflers."""
    p = PKGS[pkg]
    rdv = p.shuffle.Rendezvous()
    outs = [[] for _ in range(n)]
    shufs = [None] * n
    errors = []

    def worker(i):
        try:
            topo = p.types.Topology(n_instances=n, instance_idx=i,
                                    n_producers=1)
            sh = p.shuffle.ThreadExchangeShuffler(
                topo, 1, num_exchange=8, rendezvous=rdv, seed=seed,
                wire_dtype=wd, codec=codec, exchange_timeout_s=30.0)
            sh.metrics = p.observability.Metrics()
            shufs[i] = sh
            ary = (np.random.default_rng(30 + i).standard_normal((16, 8))
                   * 100).astype(dtype)
            for _ in range(rounds):
                sh.global_shuffle(ary)
                outs[i].append(ary.copy())
        except Exception as e:  # ddl-lint: disable=DDL007
            # Worker thread: capture, assert in the main thread.
            errors.append((i, e))

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60.0)
    assert not errors, errors
    assert all(len(o) == rounds for o in outs)
    return outs, shufs


class TestExchangeWire:
    @pytest.mark.parametrize("wd,codec", [("raw", "zlib"), ("int8", None),
                                          ("bf16", None), ("int8", "zlib")])
    @pytest.mark.parametrize("n", [2, 3])
    def test_pools_byte_identical_to_reference(self, wd, codec, n):
        want, _ = _exchange("jax", wd, codec, n=n)
        got, shufs = _exchange("torch", wd, codec, n=n)
        for i in range(n):
            for a, b in zip(got[i], want[i]):
                assert a.tobytes() == b.tobytes()
        assert shufs[0].metrics.counter("wire.encoded_bytes") > 0

    def test_lossless_codec_byte_identical_to_raw(self):
        raw, _ = _exchange("torch", "raw", None)
        zz, shufs = _exchange("torch", "raw", "zlib")
        for i in range(2):
            for a, b in zip(raw[i], zz[i]):
                assert a.tobytes() == b.tobytes()

    def test_int8_exchange_drift_bounded(self):
        raw, _ = _exchange("torch", "raw", None)
        i8, shufs = _exchange("torch", "int8", None)
        for i in range(2):
            for a, b in zip(raw[i], i8[i]):
                assert np.abs(a - b).max() / max(np.abs(a).max(), 1e-9) < 0.05
        m = shufs[0].metrics
        assert 0 < m.counter("wire.encoded_bytes") < m.counter(
            "wire.payload_bytes")

    def test_int_lanes_keep_raw_under_lossy_request(self):
        from ddl_tpu_torch.shuffle import ThreadExchangeShuffler
        from ddl_tpu_torch.types import Topology

        topo = Topology(n_instances=2, instance_idx=0, n_producers=1)
        sh = ThreadExchangeShuffler(topo, 1, num_exchange=8,
                                    wire_dtype="int8")
        rows = np.arange(32, dtype=np.int64).reshape(4, 8)
        assert sh._wire_active(rows) == ("raw", None)
        got, _ = _exchange("torch", "int8", "zlib", dtype=np.int32)
        want, _ = _exchange("jax", "int8", "zlib", dtype=np.int32)
        assert all(a.tobytes() == b.tobytes()
                   for i in range(2) for a, b in zip(got[i], want[i]))

    @pytest.mark.parametrize("wd", [None, "raw", "bf16", "int8"])
    @pytest.mark.parametrize("dtype", [np.float32, np.int32])
    def test_plan_exchange_equals_reference(self, wd, dtype):
        from ddl_tpu.ops import device_shuffle as jds
        from ddl_tpu_torch.ops import device_shuffle as tds

        for args in ((4, 4096, 256), (2, 7, 3), (1, 8, 4), (3, 1, 5)):
            for n_devices in (None, 2):
                kw = dict(wire_dtype=wd, n_devices=n_devices)
                assert tds.plan_exchange(*args, dtype, **kw) == \
                    jds.plan_exchange(*args, dtype, **kw)


# -- the ICI wire ---------------------------------------------------------------


def _shardings(axes, spec, n_pos=None):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ddl_tpu_torch.parallel import mesh as tmesh

    shape = [s for _, s in axes]
    names = [a for a, _ in axes]
    n = int(np.prod(shape))
    jsh = NamedSharding(Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             names), P(*spec))
    tsh = tmesh.NamedSharding(tmesh.make_mesh(dict(axes), ["cpu"] * n),
                              tmesh.P(*spec))
    return jsh, tsh


ICI_CASES = [
    ((("dp", 8),), ("dp", None)),
    ((("dp", 8),), (None, None)),
    ((("dp", 4), ("fsdp", 2)), ("dp", None)),
    ((("dp", 4), ("fsdp", 2)), (None, "dp")),
]


class TestIciWireAccounting:
    @pytest.mark.parametrize("wd", ["raw", "bf16", "int8"])
    @pytest.mark.parametrize("axes,spec", ICI_CASES)
    @pytest.mark.parametrize("shape", [(64, 512), (64, 48)])
    def test_plans_equal_reference(self, wd, axes, spec, shape):
        from ddl_tpu.parallel import ici as jici
        from ddl_tpu_torch.parallel import ici as tici

        jsh, tsh = _shardings(axes, spec)
        for n_slots in (1, 2):
            want = jici.plan_distribution(shape, np.float32, jsh,
                                          wire_dtype=wd, n_slots=n_slots)
            got = tici.plan_distribution(shape, np.float32, tsh,
                                         wire_dtype=wd, n_slots=n_slots)
            for field in ("mode", "wire_bytes", "payload_bytes",
                          "peak_bytes", "dst_shard_bytes", "peak_factor",
                          "wire_dtype", "encoded_bytes"):
                assert getattr(got, field) == getattr(want, field), field
            assert got.legs == tuple(tici.RedistLeg(**vars(leg))
                                     for leg in want.legs)

    def test_replicate_wire_bytes_hand_check(self):
        from ddl_tpu_torch.ops import ici_fanout
        from ddl_tpu_torch.parallel.ici import plan_distribution

        _, sh = _shardings((("dp", 8),), (None, None))
        raw = plan_distribution((64, 512), np.float32, sh)
        p = plan_distribution((64, 512), np.float32, sh, wire_dtype="int8")
        enc = 64 * (512 + 4 * 2)
        assert p.encoded_bytes == enc
        assert p.wire_bytes == ici_fanout.wire_bytes("replicate", enc, 8, 4,
                                                     rows=64)
        assert p.wire_bytes < raw.wire_bytes
        assert p.payload_bytes == raw.payload_bytes

    def test_wire_ordering_int8_lt_bf16_lt_raw(self):
        from ddl_tpu_torch.parallel.ici import plan_distribution

        _, sh = _shardings((("dp", 8),), ("dp", None))
        sizes = {wd: plan_distribution((64, 512), np.float32, sh,
                                       wire_dtype=wd).wire_bytes
                 for wd in ("raw", "bf16", "int8")}
        assert sizes["int8"] < sizes["bf16"] < sizes["raw"]

    def test_int_window_plans_raw_silently(self):
        from ddl_tpu_torch.parallel.ici import plan_distribution, wire_cols

        _, sh = _shardings((("dp", 8),), ("dp", None))
        assert plan_distribution((64, 512), np.int32, sh,
                                 wire_dtype="int8").wire_dtype == "raw"
        assert plan_distribution((64, 512), torch.int32, sh,
                                 wire_dtype="bf16").wire_dtype == "raw"
        assert wire_cols(260, np.float32, "int8") == 260 + 4 * 2
        assert wire_cols(48, np.float32, "bf16") == 96


def _host_roundtrip(win, wd):
    payload, scales = tw.encode_window(win, wd)
    return tw.decode_window(payload, scales, win.shape, win.dtype, wd)


class TestIciWireTransport:
    @pytest.mark.parametrize("wd", ["int8", "bf16"])
    @pytest.mark.parametrize("axes,spec", ICI_CASES + [
        ((("dp", 4),), (None, "dp", None)),
    ])
    def test_values_equal_host_decode_of_host_encode(self, wd, axes, spec):
        from ddl_tpu_torch.parallel.ici import IciDistributor
        from ddl_tpu_torch.ingest import device_put

        _, sh = _shardings(axes, spec)
        shape = (64, 48) if len(spec) == 2 else (16, 8, 12)
        win = np.random.default_rng(0).standard_normal(shape).astype(
            np.float32)
        m = Metrics()
        dist = IciDistributor(sh, metrics=m, wire_dtype=wd)
        out = dist.put(torch.from_numpy(win), device_put)
        # The landed window is the host decode of the host encode of the
        # window's 2-D view along the split axis.
        plan = dist.plan(win.shape, win.dtype)
        split = 0 if plan.split_dim is None else plan.split_dim
        view = np.moveaxis(win, split, 0).reshape(win.shape[split], -1)
        want = np.moveaxis(
            _host_roundtrip(view, wd).reshape(
                (win.shape[split],) + tuple(np.delete(win.shape, split))),
            0, split)
        assert out.numpy().tobytes() == np.ascontiguousarray(want).tobytes()
        for s in out.shards:
            assert s.data.is_contiguous()
            assert s.data.numpy().tobytes() == np.ascontiguousarray(
                want[s.index]).tobytes()
        d = np.abs(out.numpy() - win).max() / np.abs(win).max()
        assert (0.0 < d < 0.02) if wd == "int8" else (0.0 < d < 0.01)
        assert m.counter("ici.fallbacks") == 0
        assert m.counter("ici.bytes") == plan.wire_bytes
        assert m.counter("wire.encoded_bytes") == plan.encoded_bytes
        assert 0 < m.counter("wire.encoded_bytes") < m.counter(
            "wire.payload_bytes")

    @pytest.mark.parametrize("wd", ["int8", "bf16"])
    def test_device_encode_equals_host_encode_on_cpu_tensors(self, wd, rng):
        """The torch encode (the card's form) against the host encode, on
        the CPU: byte for byte, payload and scales, and its decode bit
        for bit."""
        from ddl_tpu_torch.parallel.ici import decode2d, encode2d

        for rows, cols in ((65, 256), (64, 48), (8, 700), (3, 1)):
            x = (rng.standard_normal((rows, cols)) * 10).astype(np.float32)
            x.reshape(-1)[:3] = [0.0, -0.0, 1e-40]
            w = encode2d(torch.from_numpy(x), wd)
            payload, scales = tw.encode_window(x, wd)
            if wd == "bf16":
                want = payload.reshape(rows, -1)
            else:
                want = np.concatenate(
                    [payload.reshape(rows, cols),
                     scales.view(np.uint8).reshape(rows, -1)], axis=1)
            assert w.numpy().tobytes() == want.tobytes()
            back = decode2d(w, cols, torch.float32, wd).numpy()
            assert back.tobytes() == tw.decode_window(
                payload, scales, x.shape, x.dtype, wd).tobytes()

    def test_raw_stays_byte_identical(self):
        from ddl_tpu_torch.ingest import device_put
        from ddl_tpu_torch.parallel.ici import IciDistributor

        _, sh = _shardings((("dp", 8),), ("dp", None))
        win = np.random.default_rng(1).standard_normal((64, 48)).astype(
            np.float32)
        out = IciDistributor(sh, wire_dtype="raw").put(
            torch.from_numpy(win), device_put)
        assert np.array_equal(out.numpy(), win)

    def test_env_knob_sets_the_distributors_wire(self, monkeypatch):
        from ddl_tpu_torch.parallel.ici import IciDistributor

        _, sh = _shardings((("dp", 8),), ("dp", None))
        monkeypatch.setenv("DDL_TORCH_WIRE_DTYPE", "int8")
        assert IciDistributor(sh).wire_dtype == "int8"
        monkeypatch.delenv("DDL_TORCH_WIRE_DTYPE")
        assert IciDistributor(sh).wire_dtype == "raw"


# -- accounting and economics ---------------------------------------------------


class TestWireReport:
    def test_wire_report_helper(self):
        m, jm = Metrics(), JaxMetrics()
        for reg in (m, jm):
            reg.incr("wire.fallbacks")
            reg.incr("wire.encoded_bytes", 100.0)
        assert tw.wire_report(m) == jw.wire_report(jm)

    def test_break_even_and_pick_equal_reference(self):
        stats = {
            "bf16": {"ratio": 0.5, "encode_bytes_per_s": 2e9,
                     "decode_bytes_per_s": 4e9},
            "int8": {"ratio": 0.2578, "encode_bytes_per_s": 5e8,
                     "decode_bytes_per_s": 1e9},
            "zlib-l1": {"ratio": 0.9, "encode_bytes_per_s": 1e8,
                        "decode_bytes_per_s": 3e8},
            "bloat": {"ratio": 1.2, "encode_bytes_per_s": 1e9,
                      "decode_bytes_per_s": 1e9},
            "shard": [1, 2, 3],
        }
        for link in (None, 1e7, 1e8, 1e9, 1e11):
            assert tw.break_even_table(stats, link) == \
                jw.break_even_table(stats, link)
            if link is not None:
                assert tw.pick_wire_format(stats, link) == \
                    jw.pick_wire_format(stats, link)

    def test_measure_wire_stats_shape(self, rng):
        sample = rng.standard_normal((64, 256)).astype(np.float32)
        got = tw.measure_wire_stats(sample, codecs=("zlib",))
        assert set(got) == {"bf16", "int8", "zlib-l1"}
        assert got["bf16"]["ratio"] == 0.5
        assert got["int8"]["ratio"] == round(
            (sample.size + tw.scale_bytes_for(sample.shape, "int8"))
            / sample.nbytes, 4)
        assert 0.0 < got["int8"]["max_rel_drift"] < 0.01
        assert tw.measure_wire_stats(sample, deadline=0.0) == {}
        assert tw.measure_wire_stats(sample.astype(np.int32)) == {}


def test_reference_wire_knob_does_not_steer_the_port(monkeypatch):
    """Each package reads its own prefix only."""
    monkeypatch.setenv("DDL_TPU_WIRE_DTYPE", "int8")
    monkeypatch.delenv("DDL_TORCH_WIRE_DTYPE", raising=False)
    assert tw.resolve_wire_dtype(None) == "raw"
    assert jw.resolve_wire_dtype(None) == "int8"
    assert os.environ.get("DDL_TORCH_WIRE_DTYPE") is None


def test_crc_fold_is_zlib_crc32_continued(rng):
    win = rng.standard_normal((8, 300)).astype(np.float32)
    slot, enc, sb = _stamp(tint, tw, win, "int8")
    start = enc + tint.HEADER_BYTES
    want = _zlib.crc32(slot[start:start + sb].tobytes(),
                       _zlib.crc32(slot[:enc].tobytes())) & 0xFFFFFFFF
    assert tint.wire_crc(slot, enc, sb) == want
    assert jfaults.armed_plan() is None and tfaults.armed_plan() is None


# -- compressed shards and compressed cache entries ---------------------------


def _compress_file(src, dst, level=6):
    with open(src, "rb") as f:
        raw = f.read()
    with open(dst, "wb") as f:
        f.write(_zlib.compress(raw, level))


def _shard_stream(pkg, make_prod, mode="thread", epochs=3, batch_size=4):
    """Every batch of a one-producer loader, one row per batch."""
    p = ddl_tpu if pkg == "jax" else ddl_tpu_torch
    kw = {} if pkg == "jax" else {"pin_memory": False}
    extra = {} if pkg == "jax" else {"device": "cpu", "metrics": Metrics()}
    out = []

    @p.distributed_dataloader(n_producers=1, mode=mode, **kw)
    def main(env):
        loader = p.DistributedDataLoader(
            make_prod(), batch_size=batch_size, connection=env.connection,
            n_epochs=epochs, output="numpy", **extra)
        for _ in range(epochs):
            for i in range(len(loader)):
                cols = loader[i]
                out.append(np.concatenate(
                    [np.atleast_2d(np.asarray(c).copy()) for c in cols],
                    axis=-1))
                loader.mark(p.Marker.END_OF_BATCH)
            loader.mark(p.Marker.END_OF_EPOCH)

    main()
    return np.concatenate([o.reshape(1, -1) for o in out], axis=0)


class TestCompressedShardMatrix:
    """The reference's ``TestCompressedShardMatrix``: zlib shards through
    ``CodecBackend`` serve the raw shards' stream, equal to the JAX
    package's; zstd only where the library is installed."""

    def _npy(self, tmp_path, n=3, rows=8, cols=16, codec="zlib"):
        rng = np.random.default_rng(0)
        for i in range(n):
            np.save(tmp_path / f"shard_{i}.npy",
                    rng.integers(0, 16, (rows, cols)).astype(np.float32))
            src = tmp_path / f"shard_{i}.npy"
            if codec == "zlib":
                _compress_file(src, tmp_path / f"shard_{i}.npy.zz")
            else:
                enc = tw.get_codec(codec).encode_bytes(src.read_bytes(), 3)
                (tmp_path / f"shard_{i}.npy.zst").write_bytes(enc)
        return str(tmp_path / "shard_*.npy")

    @pytest.mark.parametrize("cache_on", [False, True])
    def test_fileshard_thread(self, tmp_path, cache_on):
        from ddl_tpu_torch.cache import CacheStore, CodecBackend
        from ddl_tpu_torch.readers import FileShardProducer

        raw_glob = self._npy(tmp_path)

        def zz_prod():
            cache = (CacheStore(ram_budget_bytes=64 << 20, metrics=Metrics())
                     if cache_on else False)
            return FileShardProducer(raw_glob + ".zz", seed=0,
                                     backend=CodecBackend(), cache=cache,
                                     warm=False)

        ref = _shard_stream("jax", lambda: ddl_tpu.readers.FileShardProducer(
            raw_glob, seed=0, cache=False, warm=False))
        raw = _shard_stream("torch", lambda: FileShardProducer(
            raw_glob, seed=0, cache=False, warm=False))
        zz = _shard_stream("torch", zz_prod)
        assert raw.tobytes() == ref.tobytes()
        assert zz.tobytes() == ref.tobytes()
        if cache_on:
            assert _shard_stream("torch", zz_prod).tobytes() == ref.tobytes()

    def test_fileshard_process(self, tmp_path):
        """The CodecBackend crosses the spawn by pickle and decodes in the
        spawned producer: the THREAD raw stream."""
        from ddl_tpu_torch.cache import CodecBackend
        from ddl_tpu_torch.readers import FileShardProducer

        raw_glob = self._npy(tmp_path, n=2, cols=8)
        raw = _shard_stream("torch", lambda: FileShardProducer(
            raw_glob, seed=0, cache=False, warm=False), epochs=2)
        zz = _shard_stream("torch", lambda: FileShardProducer(
            raw_glob + ".zz", seed=0, backend=CodecBackend(), cache=False,
            warm=False), mode="process", epochs=2)
        assert raw.tobytes() == zz.tobytes()

    def test_fileshard_zstd_where_installed(self, tmp_path):
        if "zstd" not in tw.available_codecs():
            pytest.skip("zstandard is not installed on this host")
        from ddl_tpu_torch.cache import CodecBackend
        from ddl_tpu_torch.readers import FileShardProducer

        raw_glob = self._npy(tmp_path, codec="zstd")
        raw = _shard_stream("torch", lambda: FileShardProducer(
            raw_glob, seed=0, cache=False))
        zst = _shard_stream("torch", lambda: FileShardProducer(
            raw_glob + ".zst", seed=0, backend=CodecBackend(), cache=False))
        assert raw.tobytes() == zst.tobytes()

    def test_tfrecord_thread(self, tmp_path):
        from datagen import encode_example_int64, write_tfrecord

        from ddl_tpu_torch.cache import CodecBackend
        from ddl_tpu_torch.readers import TFRecordTokenProducer

        payloads = [encode_example_int64("input_ids",
                                         list(range(20 * i, 20 * i + 20)))
                    for i in range(4)]
        path = str(tmp_path / "toks.tfrecord")
        write_tfrecord(path, payloads)
        _compress_file(path, path + ".zz")
        ref = _shard_stream("jax", lambda: ddl_tpu.readers.TFRecordTokenProducer(
            path, seq_len=8, window_rows=4, warm=False))
        zz = _shard_stream("torch", lambda: TFRecordTokenProducer(
            path + ".zz", seq_len=8, window_rows=4, backend=CodecBackend(),
            warm=False))
        assert zz.tobytes() == ref.tobytes()

    def test_webdataset_thread(self, tmp_path):
        from datagen import write_image_shard

        from ddl_tpu_torch.cache import CodecBackend
        from ddl_tpu_torch.readers import WebDatasetProducer

        path = str(tmp_path / "imgs.tar")
        write_image_shard(path, [(f"s{i:03d}", i % 3) for i in range(4)],
                          size=8)
        _compress_file(path, path + ".zz")
        ref = _shard_stream("jax", lambda: ddl_tpu.readers.WebDatasetProducer(
            path, image_size=8, window_rows=4, warm=False))
        zz = _shard_stream("torch", lambda: WebDatasetProducer(
            path + ".zz", image_size=8, window_rows=4,
            backend=CodecBackend(), warm=False))
        assert zz.tobytes() == ref.tobytes()

    def test_codec_fingerprint_and_suffixes_are_the_references(self,
                                                               tmp_path):
        from ddl_tpu import cache as jcache
        from ddl_tpu_torch import cache as tcache

        raw_glob = self._npy(tmp_path, n=1)
        for path in (raw_glob.replace("*", "0"),
                     raw_glob.replace("*", "0") + ".zz"):
            assert (tcache.CodecBackend().fingerprint(path)
                    == jcache.CodecBackend().fingerprint(path))
        assert tcache.backends.CODEC_SUFFIXES == jcache.backends.CODEC_SUFFIXES

    def test_truly_corrupt_compressed_file_fails_decode(self, tmp_path):
        from ddl_tpu_torch.cache import CodecBackend
        from ddl_tpu_torch.exceptions import BackendFetchError

        (tmp_path / "bad.npy.zz").write_bytes(b"not a zlib stream")
        with pytest.raises(BackendFetchError):
            CodecBackend().open(str(tmp_path / "bad.npy.zz"))

    def test_bad_forced_codec_fails_at_construction(self):
        from ddl_tpu_torch.cache import CodecBackend

        with pytest.raises(ValueError):
            CodecBackend(codec="brotli")


class TestCompressedCacheEntries:
    def test_spill_entries_compressed_and_identical(self, tmp_path):
        from ddl_tpu.cache import CacheStore as JStore
        from ddl_tpu_torch.cache import CacheStore

        arr = np.random.default_rng(0).integers(0, 8, (64, 64)).astype(
            np.float32)
        digest = "ab" * 32
        store = CacheStore(spill_dir=str(tmp_path / "t"), codec="zlib",
                           codec_level=6, metrics=Metrics())
        store._spill(digest, arr)
        size = os.path.getsize(store._spill_path(digest))
        assert size < arr.nbytes
        assert np.array_equal(store._disk_get(digest), arr)
        ref = JStore(spill_dir=str(tmp_path / "j"), codec="zlib",
                     codec_level=6)
        ref._spill(digest, arr)
        with open(store._spill_path(digest), "rb") as a, \
                open(ref._spill_path(digest), "rb") as b:
            assert a.read() == b.read()

    def test_corrupt_compressed_entry_quarantines(self, tmp_path):
        from ddl_tpu_torch.cache import CacheStore

        arr = np.random.default_rng(1).integers(0, 8, (32, 32)).astype(
            np.float32)
        store = CacheStore(spill_dir=str(tmp_path / "spill"), codec="zlib",
                           metrics=Metrics())
        digest = "cd" * 32
        store._spill(digest, arr)
        path = store._spill_path(digest)
        blob = np.fromfile(path, np.uint8)
        blob[len(blob) // 2] ^= 0xFF
        blob.tofile(path)
        assert store._disk_get(digest) is None
        assert store.metrics.counter("cache.quarantined") == 1

    def test_bad_codec_name_fails_at_construction(self, tmp_path):
        from ddl_tpu_torch.cache import CacheStore

        with pytest.raises(ValueError):
            CacheStore(spill_dir=str(tmp_path), codec="brotli")
        assert CacheStore(codec="none", metrics=Metrics()).codec is None
