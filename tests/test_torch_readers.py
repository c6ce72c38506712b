"""The port's readers against the JAX package's.

- ``ArrayProducer``: the same data and seed give the same draws and
  bytes, worker by worker, and the same window stream through both
  loaders.
- The file readers' pieces: the shard assignment, the ``tf.Example``
  micro-decoder, the TFRecord framing, and the WebDataset pairing (out of
  order members, sidecars, stragglers), each equal to the reference's.
"""

import numpy as np
import pytest

import ddl_tpu
import ddl_tpu_torch
from ddl_tpu.readers import ArrayProducer as JaxArray
from ddl_tpu_torch.readers import ArrayProducer as TorchArray


def _data(n, f, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal((n, f)).astype(dtype)
    return rng.integers(0, 1000, (n, f)).astype(dtype)


@pytest.mark.parametrize("n,window,producer,n_producers,instance,n_instances,dtype", [
    (64, 16, 1, 2, 0, 1, "float32"),
    (64, 16, 2, 2, 0, 1, "int32"),
    (40, 32, 1, 3, 1, 2, "float32"),  # the shard is tiled up to the window
    (100, 8, 3, 4, 0, 1, "uint8"),
])
def test_array_producer_fills_equal_reference(n, window, producer, n_producers,
                                              instance, n_instances, dtype):
    data = _data(n, 5, dtype, seed=n)
    kw = dict(producer_idx=producer, n_producers=n_producers,
              instance_idx=instance, n_instances=n_instances)
    ref, port = JaxArray(data, window, seed=7), TorchArray(data, window, seed=7)
    rinit, pinit = ref.on_init(**kw), port.on_init(**kw)
    for field in ("nData", "nValues", "shape", "splits"):
        assert getattr(pinit, field) == getattr(rinit, field)
    assert np.dtype(pinit.dtype) == np.dtype(rinit.dtype)
    want = np.zeros(rinit.shape, dtype)
    got = np.zeros(pinit.shape, dtype)
    ref.post_init(want)
    port.post_init(got)
    assert got.tobytes() == want.tobytes()
    for _ in range(3):
        ref.execute_function(want)
        port.execute_function(got)
        assert got.tobytes() == want.tobytes()


def test_array_producer_splits_and_capability():
    data = _data(32, 6, "float32")
    p = TorchArray(data, 8, splits=(4, 2))
    assert p.on_init().splits == (4, 2) == JaxArray(data, 8, (4, 2)).on_init().splits
    assert TorchArray.supports_inplace_fill and JaxArray.supports_inplace_fill


def _stream(pkg, cls, data, **kw):
    @pkg.distributed_dataloader(n_producers=2, mode="thread", nslots=2, **kw)
    def run(env):
        output = "jax" if pkg is ddl_tpu else "device"
        extra = {} if pkg is ddl_tpu else {"device": "cpu"}
        loader = pkg.DistributedDataLoader(
            cls(data, window_size=24, seed=5), batch_size=6,
            connection=env.connection, n_epochs=4, output=output, **extra,
        )
        out = []
        for win in loader.windows(lookahead=2):
            out.append(np.asarray(win).copy() if pkg is ddl_tpu
                       else win.numpy().copy())
            loader.mark(pkg.Marker.END_OF_EPOCH)
        return out

    return run()


def test_array_producer_stream_byte_identical():
    data = _data(96, 7, "float32", seed=3)
    want = _stream(ddl_tpu, JaxArray, data)
    got = _stream(ddl_tpu_torch, TorchArray, data, pin_memory=False)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape == (4, 6, 7)
        assert g.tobytes() == w.tobytes()


# -- the file readers' pieces -------------------------------------------------

import glob  # noqa: E402
import io  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tarfile  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
from datagen import (  # noqa: E402
    encode_example_int64,
    encode_varint,
    write_tfrecord,
)
from ddl_tpu import readers as jreaders  # noqa: E402
from ddl_tpu_torch import readers as treaders  # noqa: E402


@pytest.mark.parametrize("n_paths,producer,n_producers,instance,n_instances", [
    (8, 1, 2, 0, 1), (8, 2, 2, 0, 1), (9, 3, 4, 1, 2), (5, 1, 1, 0, 1),
])
def test_glob_my_shards_equals_the_reference(tmp_path, n_paths, producer,
                                             n_producers, instance,
                                             n_instances):
    for i in range(n_paths):
        (tmp_path / f"p{i:02d}.bin").write_bytes(b"x")
    args = (str(tmp_path / "p*.bin"), producer, n_producers, instance,
            n_instances)
    assert treaders._glob_my_shards(*args) == jreaders._glob_my_shards(*args)


def _ld(field, payload):
    return encode_varint((field << 3) | 2) + encode_varint(len(payload)) + payload


def _example_unpacked(key, values):
    """A tf.Example whose int64 list is written unpacked (one varint field
    per value), with a float feature beside it."""
    int64_list = b"".join(encode_varint(1 << 3) + encode_varint(v)
                          for v in values)
    float_feat = _ld(2, _ld(1, b"\x00\x00\x80\x3f"))
    entries = (_ld(1, _ld(1, b"other") + _ld(2, float_feat))
               + _ld(1, _ld(1, key.encode()) + _ld(2, _ld(3, int64_list))))
    return _ld(1, entries)


@pytest.mark.parametrize("payload,key", [
    (encode_example_int64("input_ids", [0, 1, 127, 128, 300, 2**31 - 1]),
     "input_ids"),
    (encode_example_int64("input_ids", []), "input_ids"),
    (encode_example_int64("input_ids", [5, 6]), "absent"),
    (_example_unpacked("input_ids", [7, 128001, 42]), "input_ids"),
    (_example_unpacked("tokens", list(range(200))), "tokens"),
])
def test_example_decoder_equals_the_reference(payload, key):
    got = treaders.example_int64_feature(payload, key)
    want = jreaders.example_int64_feature(payload, key)
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("verify", [True, False])
def test_iter_tfrecords_equals_the_reference(tmp_path, verify):
    rng = np.random.default_rng(1)
    payloads = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in rng.integers(0, 5000, 12)]
    path = str(tmp_path / "r.tfrecord")
    write_tfrecord(path, payloads)
    got = list(treaders.iter_tfrecords(path, verify_crc=verify))
    assert got == list(jreaders.iter_tfrecords(path, verify_crc=verify))
    assert got == payloads
    with open(path, "rb") as f:
        assert list(treaders.iter_tfrecords("label", verify_crc=verify,
                                            fileobj=f)) == payloads


def _png(seed):
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 255, (6, 6, 3),
                                               dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_webdataset_pairing_equals_the_reference(tmp_path):
    """Members out of order, a ``.json`` sidecar, a directory, a key
    whose label comes first and a straggler after a key has paired: both
    packages pair, skip and decode the same rows."""
    members = [
        ("b.cls", b"2"), ("a.png", _png(1)), ("a.json", b"{}"),
        ("dir", None), ("b.png", _png(2)), ("a.cls", b" 1\n"),
        ("a.png", _png(3)), ("c.jpeg", None), ("d.PNG", _png(4)),
        ("d.cls", b"4"),
    ]
    path = str(tmp_path / "w.tar")
    with tarfile.open(path, "w") as tf:
        for name, data in members:
            info = tarfile.TarInfo(name)
            if data is None:
                info.type = tarfile.DIRTYPE
                tf.addfile(info)
                continue
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    rows = []
    for r in (jreaders, treaders):
        p = r.WebDatasetProducer(path, image_size=4, window_rows=3,
                                 cache=False)
        ret = p.on_init(producer_idx=1)
        ary = np.zeros(ret.shape, np.float32)
        p.post_init(my_ary=ary)
        rows.append(ary.copy())
        assert ret.splits == (48, 1)
    assert rows[1].tobytes() == rows[0].tobytes()
    assert list(rows[1][:, -1]) == [2.0, 1.0, 4.0]


def test_chip_smoke_tfrecord_writer_equals_the_fixture_writer(tmp_path):
    """``chip_smoke.py``'s corpus writer (vectorised varints, a batched
    masked CRC32C) writes the bytes ``tests/datagen.py``'s one-record-at-a-
    time writer does for the same documents, and the port reads them back
    as the documents' tokens."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke

    rng = np.random.default_rng(4)
    tokens = np.concatenate([
        rng.integers(0, 128, 500), rng.integers(0, 1 << 21, 3000),
        (rng.zipf(1.2, 20_000) - 1) % 128256]).astype(np.int32)
    lens = chip_smoke._doc_lengths(np.random.default_rng(4), len(tokens))
    pattern, per_shard = chip_smoke.write_tfrecord_corpus(
        str(tmp_path), tokens, lens, 3)
    ends = np.minimum(np.cumsum(lens), len(tokens))
    starts = np.concatenate([[0], ends[:-1]])
    keep = ends > starts
    docs = [tokens[a:b] for a, b in zip(starts[keep], ends[keep])]
    shard_of = np.arange(len(docs)) * 3 // len(docs)
    paths = sorted(glob.glob(pattern))
    assert len(paths) == 3 and sum(per_shard) == len(tokens)
    for s, path in enumerate(paths):
        ref = str(tmp_path / f"ref{s}.bin")
        write_tfrecord(ref, [encode_example_int64("input_ids", d.tolist())
                             for d, o in zip(docs, shard_of) if o == s])
        with open(path, "rb") as a, open(ref, "rb") as b:
            assert a.read() == b.read()
    got = np.concatenate([
        treaders.example_int64_feature(p, "input_ids")
        for path in paths for p in treaders.iter_tfrecords(path)])
    assert got.tobytes() == tokens.astype(np.int64).tobytes()
    bufs = [d.tobytes() for d in docs[:50]] + [b"", b"123456789"]
    assert list(chip_smoke.masked_crc32c_many(bufs)) == [
        jreaders.masked_crc32c(b) for b in bufs]
