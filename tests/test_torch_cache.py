"""The port's shard cache (``ddl_tpu_torch/cache/``) and its file readers
against the JAX package's (``tests/test_cache.py``), on the CPU.

- Keys: the same ``CacheKey`` digests, and a reader's key moves with its
  decode parameters.
- The RAM tier (LRU under a byte budget, read-only entries), the disk
  tier (write-through, promote, quarantine, trim, the oversized guard,
  late attach, warm start): the same counters as the reference for the
  same operations.
- Spill entry files byte for byte the reference's, and a spill dir
  written by each package served by the other.
- Backends: the failure schedule, pickling, retry, exhaustion, an abort
  in the backoff, ``LocalBackend``'s fingerprint string.
- Cold, warm and uncached streams of all three readers byte for byte the
  reference's; the fault matrix; the warmer; the checkpoint manifest;
  ``cache=False``; the config export; THREAD and PROCESS loaders end to
  end with no warmer thread left behind, also when a hung THREAD
  producer is retired and respawned.
"""

import dataclasses
import glob
import json
import os
import pickle
import shutil
import sys
import threading
import time
import types

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from datagen import (  # noqa: E402
    encode_example_int64,
    write_image_shard,
    write_tfrecord,
)

import ddl_tpu  # noqa: E402
import ddl_tpu.cache as jcache  # noqa: E402
import ddl_tpu.checkpoint as jcheckpoint  # noqa: E402
import ddl_tpu.exceptions as jexc  # noqa: E402
import ddl_tpu.faults as jfaults  # noqa: E402
import ddl_tpu.readers as jreaders  # noqa: E402
from ddl_tpu.cache import store as jstore  # noqa: E402
from ddl_tpu.observability import Metrics as JMetrics  # noqa: E402

import ddl_tpu_torch  # noqa: E402
import ddl_tpu_torch.cache as tcache  # noqa: E402
import ddl_tpu_torch.checkpoint as tcheckpoint  # noqa: E402
import ddl_tpu_torch.exceptions as texc  # noqa: E402
import ddl_tpu_torch.faults as tfaults  # noqa: E402
import ddl_tpu_torch.readers as treaders  # noqa: E402
from ddl_tpu_torch.cache import store as tstore  # noqa: E402
from ddl_tpu_torch.config import LoaderConfig  # noqa: E402
from ddl_tpu_torch.env import export_cache_knobs  # noqa: E402
from ddl_tpu_torch.observability import Metrics  # noqa: E402

#: Each package's namespace, so one test body drives either.
PKG = {
    "jax": types.SimpleNamespace(
        name="jax", cache=jcache, store=jstore, readers=jreaders,
        exc=jexc, faults=jfaults, checkpoint=jcheckpoint, Metrics=JMetrics,
        prefix="DDL_TPU_"),
    "torch": types.SimpleNamespace(
        name="torch", cache=tcache, store=tstore, readers=treaders,
        exc=texc, faults=tfaults, checkpoint=tcheckpoint, Metrics=Metrics,
        prefix="DDL_TORCH_"),
}
BOTH = pytest.mark.parametrize("pkg", ["jax", "torch"])

COUNTERS = ("cache.hits", "cache.misses", "cache.evictions", "cache.spills",
            "cache.spill_hits", "cache.spill_evictions", "cache.quarantined",
            "cache.backend_retries", "cache.backend_failures",
            "cache.warmed")


def _counters(m):
    return {k: m.counter(k) for k in COUNTERS}


def _store(pkg, tmp_path=None, budget=64 << 20, sub="spill", **kw):
    p = PKG[pkg]
    m = p.Metrics()
    spill = str(tmp_path / sub) if tmp_path is not None else None
    return p.cache.CacheStore(ram_budget_bytes=budget, spill_dir=spill,
                              metrics=m, **kw), m


def _npy_shards(tmp_path, n=4, rows=16, cols=8, seed=0, dtype=np.float32):
    d = tmp_path / "shards"
    d.mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        np.save(d / f"s{i}.npy",
                rng.standard_normal((rows, cols)).astype(dtype))
    return str(d / "s*.npy")


def _tfrecord_shards(tmp_path, n=2, records=8, length=50, seed=0):
    rng = np.random.default_rng(seed)
    for s in range(n):
        payloads = [
            encode_example_int64("input_ids",
                                 rng.integers(0, 1000, length).tolist())
            for _ in range(records)
        ]
        write_tfrecord(str(tmp_path / f"c4-{s}.tfrecord"), payloads)
    return str(tmp_path / "c4-*.tfrecord")


def _image_shards(tmp_path, n=2, per=6):
    for s in range(n):
        write_image_shard(
            str(tmp_path / f"shard-{s}.tar"),
            [(f"s{s}k{i}", s * 10 + i) for i in range(per)],
        )
    return str(tmp_path / "shard-*.tar")


def _drive(producer, n_fills, producer_idx=1, **kw):
    """on_init + post_init + n_fills-1 refills; the stacked windows."""
    ret = producer.on_init(producer_idx=producer_idx, **kw)
    ary = np.zeros(ret.shape, ret.dtype or np.float32)
    producer.post_init(my_ary=ary)
    out = [ary.copy()]
    for _ in range(n_fills - 1):
        producer.execute_function(my_ary=ary)
        out.append(ary.copy())
    producer.on_push_end()
    return np.stack(out)


def _reader(pkg, kind, pattern, **kw):
    r = PKG[pkg].readers
    if kind == "fileshard":
        return r.FileShardProducer(pattern, seed=7, **kw)
    if kind == "tfrecord":
        return r.TFRecordTokenProducer(pattern, seq_len=16, window_rows=8,
                                       **kw)
    return r.WebDatasetProducer(pattern, image_size=8, window_rows=4, **kw)


def _pattern(kind, tmp_path):
    return {"fileshard": _npy_shards, "tfrecord": _tfrecord_shards,
            "webdataset": _image_shards}[kind](tmp_path)


#: (reader, fills): two epochs over one worker's shards.
READERS = [("fileshard", 8), ("tfrecord", 12), ("webdataset", 6)]


@pytest.fixture(autouse=True)
def _clean_cache_env(monkeypatch):
    """No test sees another's cache knobs or default store: each knob is
    unset for the test and restored after it, also where the code under
    test (an export, an adoption) sets it."""
    for prefix in ("DDL_TPU_", "DDL_TORCH_"):
        for k in ("CACHE", "CACHE_RAM_MB", "CACHE_SPILL_DIR",
                  "CACHE_SPILL_MB", "CACHE_WARM", "CACHE_CODEC",
                  "CACHE_RETRIES", "CACHE_BACKOFF_S", "TFRECORD_CRC"):
            monkeypatch.setenv(prefix + k, "")  # recorded, so restored
            monkeypatch.delenv(prefix + k)
    jcache.reset_default_store()
    tcache.reset_default_store()
    yield
    jcache.reset_default_store()
    tcache.reset_default_store()


# -- keys ---------------------------------------------------------------------


class TestCacheKey:
    @pytest.mark.parametrize("fields", [
        ("src:1:2", "a.npy", "R(p=1)", "1"),
        ("local:4096:1700000000000000000", "/data/shard-000.tar",
         "WebDatasetProducer(image_size=32)", "1"),
        ("local:1:2:codec=zlib", "c4.tfrecord.zz",
         "TFRecordTokenProducer(feature_key=input_ids)", ""),
        ("ü", "π", "R()", "2"),
    ])
    def test_digests_equal_the_reference(self, fields):
        assert (tcache.CacheKey(*fields).digest
                == jcache.CacheKey(*fields).digest)
        assert tcache.KEY_SCHEMA_VERSION == jcache.KEY_SCHEMA_VERSION == 1

    def test_any_field_change_moves_the_digest(self):
        base = tcache.CacheKey("src:1:2", "a.npy", "R(p=1)", "1")
        for variant in (
            tcache.CacheKey("src:1:3", "a.npy", "R(p=1)", "1"),
            tcache.CacheKey("src:1:2", "b.npy", "R(p=1)", "1"),
            tcache.CacheKey("src:1:2", "a.npy", "R(p=2)", "1"),
            tcache.CacheKey("src:1:2", "a.npy", "R(p=1)", "2"),
        ):
            assert variant.digest != base.digest

    @pytest.mark.parametrize("kind", ["fileshard", "tfrecord", "webdataset"])
    def test_reader_keys_equal_the_reference(self, tmp_path, kind):
        """The key covers the reader's qualified name, its params and the
        backend's fingerprint: both packages build the same one."""
        pattern = _pattern(kind, tmp_path)
        path = sorted(glob.glob(pattern))[0]
        keys = []
        for pkg in ("jax", "torch"):
            p = _reader(pkg, kind, pattern, cache=None)
            p._cache_init()
            keys.append(p._shard_key(path))
        assert dataclasses.astuple(keys[0]) == dataclasses.astuple(keys[1])
        assert keys[0].digest == keys[1].digest
        assert keys[1].reader.startswith(type(p).__qualname__)

    def test_reader_params_feed_the_key(self, tmp_path):
        path = _npy_shards(tmp_path, n=1).replace("s*", "s0")
        a = treaders.WebDatasetProducer("x", image_size=8, cache=None)
        b = treaders.WebDatasetProducer("x", image_size=16, cache=None)
        for p in (a, b):
            p._cache_init()
        assert a._shard_key(path).digest != b._shard_key(path).digest


# -- the RAM tier -------------------------------------------------------------


def _lru_ops(pkg):
    p = PKG[pkg]
    store, m = _store(pkg, budget=3500)
    keys = [p.cache.CacheKey("s", f"k{i}", "R()") for i in range(5)]
    for k in keys:
        store.put(k, np.zeros(1000, np.uint8))
    present = [store.get(k) is not None for k in keys]
    return store, m, present


class TestRamTier:
    def test_lru_eviction_under_byte_budget(self):
        store, m, present = _lru_ops("torch")
        assert store.resident_bytes <= 3500
        assert m.counter("cache.evictions") == 2
        assert present == [False, False, True, True, True]
        assert m.gauge("cache.resident_bytes.max") <= 3500
        _, jm, jpresent = _lru_ops("jax")
        assert present == jpresent and _counters(m) == _counters(jm)

    @BOTH
    def test_get_refreshes_recency(self, pkg):
        p = PKG[pkg]
        store, _ = _store(pkg, budget=2500)
        ka, kb, kc = (p.cache.CacheKey("s", k, "R()") for k in "abc")
        store.put(ka, np.zeros(1000, np.uint8))
        store.put(kb, np.zeros(1000, np.uint8))
        assert store.get(ka) is not None
        store.put(kc, np.zeros(1000, np.uint8))
        assert store.get(ka) is not None
        assert store.get(kb) is None

    def test_entries_are_read_only_and_shared(self):
        store, _ = _store("torch")
        src = np.arange(8)
        arr = store.put(tcache.CacheKey("s", "a", "R()"), src)
        assert arr is src  # ownership: contiguous input is not copied
        with pytest.raises(ValueError):
            arr[0] = 99
        again = store.put(tcache.CacheKey("s", "a", "R()"), np.arange(8))
        assert again is arr

    def test_deepcopy_is_the_same_store(self):
        import copy

        store, _ = _store("torch")
        assert copy.deepcopy(store) is store
        assert copy.deepcopy({"cache": store})["cache"] is store

    def test_store_does_not_pickle(self):
        store, _ = _store("torch")
        with pytest.raises(TypeError):
            pickle.dumps(store)


# -- the disk tier ------------------------------------------------------------


class TestDiskTier:
    @BOTH
    def test_write_through_spill_and_promote(self, tmp_path, pkg):
        p = PKG[pkg]
        store, m = _store(pkg, tmp_path)
        k = p.cache.CacheKey("s", "a", "R()")
        orig = np.arange(256, dtype=np.int64).reshape(16, 16)
        store.put(k, orig)
        assert m.counter("cache.spills") == 1
        store.clear()
        got = store.get(k)
        assert got is not None and np.array_equal(got, orig)
        assert got.dtype == orig.dtype and got.shape == orig.shape
        assert m.counter("cache.spill_hits") == 1
        assert not got.flags.writeable

    def _flip_and_get(self, pkg, tmp_path):
        p = PKG[pkg]
        store, m = _store(pkg, tmp_path, sub=f"spill-{pkg}")
        k = p.cache.CacheKey("s", "a", "R()")
        store.put(k, np.arange(1000, dtype=np.float64))
        store.clear()
        path = store._spill_path(k.digest)
        raw = bytearray(open(path, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(path, "wb").write(bytes(raw))
        got = store.get(k)
        return store, m, k, path, got

    def test_corrupt_disk_entry_is_quarantined(self, tmp_path):
        store, m, k, path, got = self._flip_and_get("torch", tmp_path)
        assert got is None
        assert m.counter("cache.quarantined") == 1
        assert not os.path.exists(path)
        assert os.path.exists(path[:-5] + ".quarantined")
        store.put(k, np.arange(1000, dtype=np.float64))
        store.clear()
        assert store.get(k) is not None
        _, jm, *_ = self._flip_and_get("jax", tmp_path)
        assert m.counter("cache.quarantined") == jm.counter("cache.quarantined")

    @BOTH
    def test_entry_cannot_alias_a_foreign_key(self, tmp_path, pkg):
        p = PKG[pkg]
        store, m = _store(pkg, tmp_path)
        ka = p.cache.CacheKey("s", "a", "R()")
        kb = p.cache.CacheKey("s", "b", "R()")
        store.put(ka, np.arange(64))
        shutil.copy(store._spill_path(ka.digest),
                    store._spill_path(kb.digest))
        store.clear()
        assert store.get(kb) is None
        assert m.counter("cache.quarantined") == 1

    @pytest.mark.parametrize("damage", ["truncate", "empty", "meta",
                                        "schema"])
    def test_malformed_entries_quarantine_like_the_reference(
            self, tmp_path, damage):
        outcomes = []
        for pkg in ("jax", "torch"):
            p = PKG[pkg]
            store, m = _store(pkg, tmp_path, sub=f"spill-{pkg}")
            k = p.cache.CacheKey("s", "a", "R()")
            store.put(k, np.arange(100, dtype=np.int32))
            store.clear()
            path = store._spill_path(k.digest)
            raw = open(path, "rb").read()
            if damage == "truncate":
                raw = raw[:10]
            elif damage == "empty":
                raw = b""
            elif damage == "meta":
                raw = raw[:5] + b"#" + raw[6:]  # the meta is not JSON
            else:
                raw = raw.replace(b'"schema": 1', b'"schema": 7')
            open(path, "wb").write(raw)
            outcomes.append((store.get(k) is None,
                             m.counter("cache.quarantined"),
                             os.path.exists(path)))
        assert outcomes[0] == outcomes[1] == (True, 1, False)

    @BOTH
    def test_spill_budget_trims_oldest(self, tmp_path, pkg):
        p = PKG[pkg]
        store, m = _store(pkg, tmp_path, spill_budget_bytes=4000)
        for i in range(6):
            store.put(p.cache.CacheKey("s", f"k{i}", "R()"),
                      np.zeros(1000, np.uint8))
            time.sleep(0.01)  # distinct mtimes for oldest-first order
        assert m.counter("cache.spill_evictions") > 0
        files = sorted(f for f in os.listdir(store.spill_dir)
                       if f.endswith(".ddlc"))
        assert 0 < len(files) < 6
        newest = p.cache.CacheKey("s", "k5", "R()").digest + ".ddlc"
        assert newest in files

    @BOTH
    def test_oversized_entry_skips_spill_tier(self, tmp_path, pkg):
        p = PKG[pkg]
        store, m = _store(pkg, tmp_path, spill_budget_bytes=2000)
        small = p.cache.CacheKey("s", "small", "R()")
        store.put(small, np.zeros(500, np.uint8))
        big = p.cache.CacheKey("s", "big", "R()")
        store.put(big, np.zeros(5000, np.uint8))
        assert os.path.exists(store._spill_path(small.digest))
        assert not os.path.exists(store._spill_path(big.digest))
        assert m.counter("cache.spill_evictions") == 0

    def test_oversized_for_ram_is_disk_only(self, tmp_path):
        store, m = _store("torch", tmp_path, budget=1000)
        k = tcache.CacheKey("s", "big", "R()")
        store.put(k, np.zeros(5000, np.uint8))
        assert store.resident_bytes == 0
        assert store.get(k) is not None  # served from disk
        assert m.counter("cache.spill_hits") == 1

    def test_quarantine_retention_is_bounded(self, tmp_path):
        assert tstore.QUARANTINE_KEEP == jstore.QUARANTINE_KEEP == 4
        store, m = _store("torch", tmp_path)
        for i in range(tstore.QUARANTINE_KEEP + 3):
            k = tcache.CacheKey("s", f"bad{i}", "R()")
            store.put(k, np.arange(64))
            store.clear()
            p = store._spill_path(k.digest)
            raw = bytearray(open(p, "rb").read())
            raw[len(raw) // 2] ^= 0xFF
            open(p, "wb").write(bytes(raw))
            time.sleep(0.01)
            assert store.get(k) is None
        q = [f for f in os.listdir(store.spill_dir)
             if f.endswith(".quarantined")]
        assert len(q) == tstore.QUARANTINE_KEEP
        assert m.counter("cache.quarantined") == tstore.QUARANTINE_KEEP + 3

    @BOTH
    def test_attach_spill_dir_late_binds_a_tier(self, tmp_path, pkg):
        p = PKG[pkg]
        donor, _ = _store(pkg, tmp_path)
        k = p.cache.CacheKey("s", "a", "R()")
        donor.put(k, np.arange(128))
        ram_only = p.cache.CacheStore(ram_budget_bytes=1 << 20,
                                      metrics=p.Metrics())
        assert ram_only.get(k) is None
        assert ram_only.attach_spill_dir(str(tmp_path / "spill"))
        assert ram_only.get(k) is not None
        assert ram_only.attach_spill_dir(str(tmp_path / "spill"))
        other = tmp_path / "other"
        other.mkdir()
        assert not ram_only.attach_spill_dir(str(other))

    def test_warm_start_adopts_existing_spill_dir(self, tmp_path):
        store, _ = _store("torch", tmp_path)
        k = tcache.CacheKey("s", "a", "R()")
        store.put(k, np.arange(32))
        store2 = tcache.CacheStore(ram_budget_bytes=1 << 20,
                                   spill_dir=str(tmp_path / "spill"),
                                   metrics=Metrics())
        assert store2.get(k) is not None
        assert store2._spill_bytes == store._spill_bytes > 0
        assert store2.metrics.gauge("cache.spill_bytes") == store2._spill_bytes

    def test_contains_leaves_the_counters_alone(self, tmp_path):
        store, m = _store("torch", tmp_path)
        k = tcache.CacheKey("s", "a", "R()")
        assert not store.contains(k)
        store.put(k, np.arange(4))
        assert store.contains(k)
        store.clear()
        assert store.contains(k)  # on disk
        assert m.counter("cache.hits") == m.counter("cache.misses") == 0


# -- the entry format, across packages ---------------------------------------


ENTRY_ARRAYS = [
    np.arange(256, dtype=np.int64).reshape(16, 16),
    np.linspace(-1, 1, 96, dtype=np.float32).reshape(4, 3, 8),
    np.arange(300, dtype=np.int32),  # a TFRecord shard's tokens
    np.zeros(0, np.int32),  # an empty shard
    np.arange(24, dtype=np.uint8).reshape(2, 12),
]


class TestCrossPackageEntries:
    @pytest.mark.parametrize("codec", [None, "zlib"])
    @pytest.mark.parametrize("i", range(len(ENTRY_ARRAYS)))
    def test_spill_files_byte_identical(self, tmp_path, i, codec):
        arr = ENTRY_ARRAYS[i]
        blobs = []
        for pkg in ("jax", "torch"):
            p = PKG[pkg]
            store, _ = _store(pkg, tmp_path, sub=f"spill-{pkg}", codec=codec)
            k = p.cache.CacheKey("local:1:2", f"shard{i}", "R(x=1)", "1")
            store.put(k, arr.copy())
            blobs.append(open(store._spill_path(k.digest), "rb").read())
        assert blobs[0] == blobs[1]

    @pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                               ("torch", "jax")])
    @pytest.mark.parametrize("codec", [None, "zlib"])
    def test_spill_dir_written_by_one_served_by_the_other(
            self, tmp_path, writer, reader, codec):
        w, r = PKG[writer], PKG[reader]
        store, _ = _store(writer, tmp_path, codec=codec)
        for i, arr in enumerate(ENTRY_ARRAYS):
            store.put(w.cache.CacheKey("src", f"s{i}", "R()"), arr.copy())
        other, m = _store(reader, tmp_path)
        for i, arr in enumerate(ENTRY_ARRAYS):
            got = other.get(r.cache.CacheKey("src", f"s{i}", "R()"))
            assert got is not None
            assert got.dtype == arr.dtype and got.tobytes() == arr.tobytes()
        assert m.counter("cache.spill_hits") == len(ENTRY_ARRAYS)
        assert m.counter("cache.quarantined") == 0

    @pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                               ("torch", "jax")])
    def test_reader_warm_from_the_other_packages_spill_dir(
            self, tmp_path, writer, reader):
        """A FileShardProducer of one package fills the disk tier; the
        other's serves the same stream from it without a miss."""
        pattern = _npy_shards(tmp_path, n=4)
        store, _ = _store(writer, tmp_path)
        want = _drive(_reader(writer, "fileshard", pattern, cache=store,
                              warm=False), 4)
        other, m = _store(reader, tmp_path)
        got = _drive(_reader(reader, "fileshard", pattern, cache=other,
                             warm=False), 4)
        assert got.tobytes() == want.tobytes()
        assert m.counter("cache.misses") == 0
        assert m.counter("cache.spill_hits") == 4

    def test_blob_seq_equals_the_reference(self):
        from ddl_tpu import integrity as jint
        from ddl_tpu_torch import integrity as tint

        for d in (tcache.CacheKey("a", "b", "c").digest, "f" * 64,
                  "0" * 64):
            assert tint.blob_seq(d) == jint.blob_seq(d)


# -- backends -----------------------------------------------------------------


class TestBackends:
    def test_local_fingerprint_is_the_reference_string(self, tmp_path):
        path = _npy_shards(tmp_path, n=1).replace("s*", "s0")
        fp = tcache.LocalBackend().fingerprint(path)
        assert fp == jcache.LocalBackend().fingerprint(path)
        st = os.stat(path)
        assert fp == f"local:{st.st_size}:{st.st_mtime_ns}"
        assert tcache.ThrottledBackend().fingerprint(path) == fp
        assert (tcache.CodecBackend(codec="zlib").fingerprint(path)
                == jcache.CodecBackend(codec="zlib").fingerprint(path)
                == fp + ":codec=zlib")

    def test_throttled_failure_schedule_is_deterministic(self, tmp_path):
        path = _npy_shards(tmp_path, n=1).replace("s*", "s0")
        be = tcache.ThrottledBackend(fail_every=2)
        be.open(path).close()
        with pytest.raises(texc.BackendFetchError):
            be.open(path)
        be.open(path).close()
        assert be.opens == 3

    def test_throttled_backend_pickles(self):
        be = tcache.ThrottledBackend(latency_s=0.5, fail_every=3)
        be.open = None  # instance state that must not cross
        be2 = pickle.loads(pickle.dumps(be))
        assert (be2.latency_s, be2.fail_every) == (0.5, 3)
        assert be2.opens == 0
        assert isinstance(be2.inner, tcache.LocalBackend)

    @BOTH
    def test_retry_heals_transient_failures(self, tmp_path, pkg):
        p = PKG[pkg]
        path = _npy_shards(tmp_path, n=1).replace("s*", "s0")
        m = p.Metrics()
        be = p.cache.ThrottledBackend(fail_every=2)
        be.open(path).close()
        with p.cache.open_with_retry(be, path, retries=3, backoff_s=0.001,
                                     metrics=m) as f:
            assert f.read(1)
        assert m.counter("cache.backend_retries") == 1

    @BOTH
    def test_persistent_failure_is_integrity_error(self, tmp_path, pkg):
        p = PKG[pkg]
        path = _npy_shards(tmp_path, n=1).replace("s*", "s0")
        m = p.Metrics()
        be = p.cache.ThrottledBackend(fail_every=1)
        with pytest.raises(p.exc.IntegrityError):
            p.cache.open_with_retry(be, path, retries=2, backoff_s=0.001,
                                    metrics=m)
        assert m.counter("cache.backend_failures") == 1
        assert m.counter("cache.backend_retries") == 3

    def test_missing_file_exhausts_as_integrity_error(self, tmp_path):
        m = Metrics()
        with pytest.raises(texc.IntegrityError):
            tcache.open_with_retry(tcache.LocalBackend(),
                                   str(tmp_path / "nope.npy"), retries=1,
                                   backoff_s=0.001, metrics=m)
        assert m.counter("cache.backend_retries") == 2

    def test_retry_backoff_observes_abort(self, tmp_path):
        path = _npy_shards(tmp_path, n=1).replace("s*", "s0")
        be = tcache.ThrottledBackend(fail_every=1)
        t0 = time.monotonic()
        with pytest.raises(texc.ShutdownRequested):
            tcache.open_with_retry(
                be, path, retries=50, backoff_s=10.0,
                should_abort=lambda: time.monotonic() - t0 > 0.05,
            )
        assert time.monotonic() - t0 < 5.0

    def test_storage_backend_protocol(self):
        for be in (tcache.LocalBackend(), tcache.ThrottledBackend(),
                   tcache.CodecBackend()):
            assert isinstance(be, tcache.StorageBackend)

    @pytest.mark.parametrize("retries,backoff", [(None, None), ("5", "0.5")])
    def test_retry_knobs_read_as_the_reference(self, monkeypatch, retries,
                                               backoff):
        for prefix in ("DDL_TPU_", "DDL_TORCH_"):
            if retries is not None:
                monkeypatch.setenv(prefix + "CACHE_RETRIES", retries)
                monkeypatch.setenv(prefix + "CACHE_BACKOFF_S", backoff)
        assert (tcache.retry_settings_from_env()
                == jcache.retry_settings_from_env())


# -- cold, warm and uncached streams ------------------------------------------


class TestColdWarmByteIdentity:
    """The cache may change speed, never data: cold, warm and uncached
    streams equal each other and the reference's."""

    @pytest.mark.parametrize("kind,n_fills", READERS)
    def test_streams_equal_the_reference(self, tmp_path, kind, n_fills):
        pattern = _pattern(kind, tmp_path)
        ref = _drive(_reader("jax", kind, pattern, cache=False, warm=False),
                     n_fills)
        plain = _drive(_reader("torch", kind, pattern, cache=False,
                               warm=False), n_fills)
        store, m = _store("torch")
        be = tcache.ThrottledBackend()
        cached = _drive(_reader("torch", kind, pattern, cache=store,
                                backend=be, warm=False), n_fills)
        assert plain.tobytes() == ref.tobytes()
        assert cached.tobytes() == ref.tobytes()
        n_shards = len(glob.glob(pattern))
        assert be.opens == n_shards  # each shard fetched and decoded once
        assert m.counter("cache.misses") == n_shards
        assert m.counter("cache.hits") >= n_shards
        # A second producer on the warm store: hits only, same bytes.
        warm_be = tcache.ThrottledBackend()
        warm = _drive(_reader("torch", kind, pattern, cache=store,
                              backend=warm_be, warm=False), n_fills)
        assert warm.tobytes() == ref.tobytes()
        assert warm_be.opens == 0
        assert m.counter("cache.misses") == n_shards

    @pytest.mark.parametrize("kind,n_fills", READERS)
    def test_counters_equal_the_reference(self, tmp_path, kind, n_fills):
        pattern = _pattern(kind, tmp_path)
        got = {}
        for pkg in ("jax", "torch"):
            store, m = _store(pkg, tmp_path, sub=f"spill-{pkg}")
            out = _drive(_reader(pkg, kind, pattern, cache=store,
                                 warm=False), n_fills)
            got[pkg] = (out.tobytes(), _counters(m),
                        sorted(os.listdir(store.spill_dir)))
        assert got["torch"] == got["jax"]

    @pytest.mark.parametrize("verify", [True, False])
    def test_tfrecord_crc_modes_serve_the_reference_stream(self, tmp_path,
                                                           verify):
        pattern = _tfrecord_shards(tmp_path, n=3, records=5, length=37)
        want = _drive(jreaders.TFRecordTokenProducer(
            pattern, seq_len=16, window_rows=4, verify_crc=verify,
            cache=False), 10)
        got = _drive(treaders.TFRecordTokenProducer(
            pattern, seq_len=16, window_rows=4, verify_crc=verify,
            cache=False), 10)
        assert got.tobytes() == want.tobytes()

    def test_tfrecord_raw_int32_records(self, tmp_path):
        rng = np.random.default_rng(3)
        payloads = [rng.integers(0, 1 << 20, 33).astype("<i4").tobytes()
                    for _ in range(6)]
        write_tfrecord(str(tmp_path / "raw.tfrecord"), payloads)
        kw = dict(seq_len=8, window_rows=4, feature_key=None, cache=False)
        want = _drive(jreaders.TFRecordTokenProducer(
            str(tmp_path / "raw.tfrecord"), **kw), 5)
        got = _drive(treaders.TFRecordTokenProducer(
            str(tmp_path / "raw.tfrecord"), **kw), 5)
        assert got.tobytes() == want.tobytes()

    @pytest.mark.parametrize("n_instances,instance,n_producers,producer", [
        (1, 0, 2, 1), (1, 0, 2, 2), (2, 1, 2, 1), (1, 0, 4, 3)])
    def test_fileshard_worker_assignment(self, tmp_path, n_instances,
                                         instance, n_producers, producer):
        pattern = _npy_shards(tmp_path, n=8)
        kw = dict(producer_idx=producer, n_producers=n_producers,
                  instance_idx=instance, n_instances=n_instances)
        want = _drive(jreaders.FileShardProducer(pattern, seed=2,
                                                 cache=False), 4, **kw)
        got = _drive(treaders.FileShardProducer(pattern, seed=2,
                                                cache=False), 4, **kw)
        assert got.tobytes() == want.tobytes()

    def test_too_few_shards_and_no_match_raise_as_the_reference(self,
                                                                tmp_path):
        pattern = _npy_shards(tmp_path, n=2)
        with pytest.raises(ValueError, match="fewer than one per worker"):
            treaders.FileShardProducer(pattern, cache=False).on_init(
                producer_idx=3, n_producers=4)
        with pytest.raises(FileNotFoundError):
            treaders.FileShardProducer(str(tmp_path / "none*.npy")).on_init(
                producer_idx=1)

    def test_warm_fill_never_writes_through_a_cached_array(self, tmp_path):
        """The in-place fill path: the window is a live slot, the cached
        shard read-only; refills leave the cached bytes as they were."""
        pattern = _npy_shards(tmp_path, n=2)
        store, _ = _store("torch")
        p = treaders.FileShardProducer(pattern, seed=1, cache=store,
                                       warm=False)
        ret = p.on_init(producer_idx=1)
        slot = np.zeros(ret.shape, ret.dtype)
        for _ in range(5):
            p.execute_function(my_ary=slot)
            slot[:] = -1.0  # the consumer's side writing over the slot
        assert len(store._ram) == 2
        for path in sorted(glob.glob(pattern)):
            v = store._ram[p._shard_key(path).digest]
            assert not v.flags.writeable
            assert v.tobytes() == np.load(path).tobytes()
        assert treaders.FileShardProducer.supports_inplace_fill
        assert treaders.TFRecordTokenProducer.supports_inplace_fill
        assert treaders.WebDatasetProducer.supports_inplace_fill

    def test_dry_tfrecord_shards_raise(self, tmp_path):
        payloads = [encode_example_int64("input_ids", []) for _ in range(3)]
        for s in range(2):
            write_tfrecord(str(tmp_path / f"dry-{s}.tfrecord"), payloads)
        for r in (jreaders, treaders):
            p = r.TFRecordTokenProducer(str(tmp_path / "dry-*.tfrecord"),
                                        seq_len=4, window_rows=2,
                                        cache=False)
            ret = p.on_init(producer_idx=1)
            with pytest.raises(ValueError, match="no tokens in any of 2"):
                p.post_init(my_ary=np.zeros(ret.shape, np.int32))

    def test_tfrecord_missing_feature_raises(self, tmp_path):
        write_tfrecord(str(tmp_path / "x.tfrecord"),
                       [encode_example_int64("other", [1, 2, 3])])
        p = treaders.TFRecordTokenProducer(str(tmp_path / "x.tfrecord"),
                                           seq_len=2, window_rows=1,
                                           cache=False)
        ret = p.on_init(producer_idx=1)
        with pytest.raises(ValueError, match="input_ids"):
            p.post_init(my_ary=np.zeros(ret.shape, np.int32))


# -- the fault matrix ---------------------------------------------------------


class TestFaultMatrix:
    """Corruption → quarantine and refetch; a flaky backend → bounded
    retry; a persistent failure → IntegrityError, as in the reference."""

    @BOTH
    def test_corrupt_disk_entry_quarantines_and_refetches(self, tmp_path,
                                                          pkg):
        p = PKG[pkg]
        pattern = _npy_shards(tmp_path, n=3)
        store, m = _store(pkg, tmp_path)
        baseline = _drive(p.readers.FileShardProducer(
            pattern, seed=3, cache=store, warm=False), 3)
        store.clear()  # the next reads go through the disk tier
        plan = p.faults.FaultPlan([p.faults.FaultSpec(
            "cache.disk_read", p.faults.FaultKind.CACHE_CORRUPTION,
            at=1, count=1, param=16)])
        with p.faults.armed(plan):
            replay = _drive(p.readers.FileShardProducer(
                pattern, seed=3, cache=store, warm=False), 3)
        assert plan.fired
        assert m.counter("cache.quarantined") == 1
        assert replay.tobytes() == baseline.tobytes()

    @BOTH
    def test_transient_backend_fault_heals_in_reader(self, tmp_path, pkg,
                                                     monkeypatch):
        p = PKG[pkg]
        pattern = _npy_shards(tmp_path, n=2)
        store, m = _store(pkg)
        plan = p.faults.FaultPlan([p.faults.FaultSpec(
            "backend.fetch", p.faults.FaultKind.BACKEND_FETCH_FAIL,
            at=2, count=2)])
        monkeypatch.setenv(p.prefix + "CACHE_BACKOFF_S", "0.001")
        with p.faults.armed(plan):
            out = _drive(p.readers.FileShardProducer(
                pattern, seed=1, cache=store, warm=False), 2)
        assert len(plan.fired) == 2
        assert m.counter("cache.backend_retries") == 2
        assert out.shape[0] == 2

    @BOTH
    def test_persistent_backend_fault_raises_integrity_error(
            self, tmp_path, pkg, monkeypatch):
        p = PKG[pkg]
        pattern = _npy_shards(tmp_path, n=2)
        store, m = _store(pkg)
        plan = p.faults.FaultPlan([p.faults.FaultSpec(
            "backend.fetch", p.faults.FaultKind.BACKEND_FETCH_FAIL,
            at=1, count=999)])
        monkeypatch.setenv(p.prefix + "CACHE_BACKOFF_S", "0.001")
        with p.faults.armed(plan):
            with pytest.raises(p.exc.IntegrityError):
                p.readers.FileShardProducer(
                    pattern, cache=store, warm=False).on_init(producer_idx=1)
        assert m.counter("cache.backend_failures") == 1
        assert m.counter("cache.backend_retries") == 4  # 1 + 3 retries

    def test_backend_fetch_fail_raises_the_real_type(self):
        plan = tfaults.FaultPlan([tfaults.FaultSpec(
            "backend.fetch", tfaults.FaultKind.BACKEND_FETCH_FAIL)])
        with tfaults.armed(plan), pytest.raises(texc.BackendFetchError):
            tfaults.fault_point("backend.fetch")

    @pytest.mark.parametrize("kind", ["fileshard", "tfrecord", "webdataset"])
    def test_transient_fault_stream_equals_undisturbed(self, tmp_path, kind,
                                                       monkeypatch):
        pattern = _pattern(kind, tmp_path)
        n_fills = dict(READERS)[kind]
        want = _drive(_reader("torch", kind, pattern, cache=False), n_fills)
        store, m = _store("torch", tmp_path)
        plan = tfaults.FaultPlan([
            tfaults.FaultSpec("backend.fetch",
                              tfaults.FaultKind.BACKEND_FETCH_FAIL, at=2),
        ])
        monkeypatch.setenv("DDL_TORCH_CACHE_BACKOFF_S", "0.001")
        with tfaults.armed(plan):
            got = _drive(_reader("torch", kind, pattern, cache=store,
                                 warm=False), n_fills)
        assert got.tobytes() == want.tobytes()
        assert m.counter("cache.backend_retries") == 1


# -- the warmer ---------------------------------------------------------------


def _wait_dead(w, timeout=10.0):
    deadline = time.monotonic() + timeout
    while w.alive and time.monotonic() < deadline:
        time.sleep(0.01)


class TestWarmer:
    def test_warmer_prefetches_in_epoch_order(self, tmp_path):
        pattern = _npy_shards(tmp_path, n=3)
        store, m = _store("torch")
        p = treaders.FileShardProducer(pattern, cache=store, warm=True)
        p.on_init(producer_idx=1)
        w = p._warmer
        assert w is not None
        _wait_dead(w)
        assert not w.alive
        assert m.counter("cache.warmed") == 2  # on_init decoded #0
        be = tcache.ThrottledBackend()
        _drive(treaders.FileShardProducer(pattern, cache=store, backend=be,
                                          warm=False), 3)
        assert be.opens == 0
        p.on_push_end()
        assert p._warmer is None

    def test_warmer_order_is_the_epoch_order(self, tmp_path):
        store, _ = _store("torch")
        seen = []

        def job(i):
            def load(should_abort):
                seen.append(i)
                return np.zeros(8, np.uint8)
            return (tcache.CacheKey("s", f"k{i}", "R()"), load)

        w = tcache.CacheWarmer(store, [job(i) for i in range(6)])
        _wait_dead(w)
        assert w.close()
        assert seen == list(range(6))

    def test_warmer_key_thunk_runs_on_the_warmer_thread(self):
        store, _ = _store("torch")
        threads = []

        def key():
            threads.append(threading.current_thread().name)
            return tcache.CacheKey("s", "k", "R()")

        w = tcache.CacheWarmer(store, [(key, lambda a: np.zeros(4))],
                               name="ddl-cache-warmer-thunk")
        _wait_dead(w)
        assert w.close()
        assert threads == ["ddl-cache-warmer-thunk"]

    def test_warmer_shutdown_mid_prefetch(self, tmp_path):
        pattern = _npy_shards(tmp_path, n=6)
        store, _ = _store("torch")
        before = set(threading.enumerate())
        p = treaders.FileShardProducer(
            pattern, cache=store,
            backend=tcache.ThrottledBackend(latency_s=0.2), warm=True)
        p.on_init(producer_idx=1)
        w = p._warmer
        assert w is not None and w.alive
        t0 = time.monotonic()
        p.on_push_end()
        assert time.monotonic() - t0 < 10.0
        assert not w.alive
        assert p._warmer is None
        leaked = set(threading.enumerate()) - before
        assert not {t for t in leaked if "warmer" in t.name}, leaked

    def test_warmer_respects_byte_budget(self):
        store, _ = _store("torch")
        seen = []

        def job(i):
            def load(should_abort):
                seen.append(i)
                return np.zeros((64, 64), np.float32)  # 16 KiB
            return (tcache.CacheKey("s", f"k{i}", "R()"), load)

        w = tcache.CacheWarmer(store, [job(i) for i in range(6)],
                               budget_bytes=40_000)
        _wait_dead(w)
        assert w.close()
        assert len(seen) == 3
        assert w.warmed_bytes >= 40_000

    def test_warmer_skips_a_failed_shard(self):
        store, m = _store("torch")

        def bad(should_abort):
            raise OSError("gone")

        w = tcache.CacheWarmer(store, [
            (tcache.CacheKey("s", "bad", "R()"), bad),
            (tcache.CacheKey("s", "ok", "R()"), lambda a: np.zeros(4)),
        ])
        _wait_dead(w)
        assert w.close()
        assert m.counter("cache.warmed") == 1
        assert store.contains(tcache.CacheKey("s", "ok", "R()"))

    @pytest.mark.parametrize("gate,started", [("0", False), ("1", True)])
    def test_warm_gate(self, tmp_path, monkeypatch, gate, started):
        pattern = _npy_shards(tmp_path, n=2)
        monkeypatch.setenv("DDL_TORCH_CACHE_WARM", gate)
        store, _ = _store("torch")
        p = treaders.FileShardProducer(pattern, cache=store)
        p.on_init(producer_idx=1)
        assert (p._warmer is not None) == started
        p.on_push_end()


# -- the checkpoint manifest --------------------------------------------------


class _L:
    _epoch, _target, _batches_in_window = 2, 1, 3


class TestCheckpointManifest:
    def test_capture_and_roundtrip(self, tmp_path):
        store, _ = _store("torch", tmp_path)
        ck = tcheckpoint.LoaderCheckpoint.capture(_L(), cache=store)
        assert ck.cache_spill_dir == store.spill_dir
        assert ck.cache_key_schema == tcache.KEY_SCHEMA_VERSION
        path = str(tmp_path / "ck" / "loader.json")
        ck.save(path)
        assert tcheckpoint.LoaderCheckpoint.load(path) == ck

    def test_capture_file_equals_the_reference(self, tmp_path):
        tstore_, _ = _store("torch", tmp_path)
        jstore_, _ = _store("jax", tmp_path)
        tcheckpoint.LoaderCheckpoint.capture(_L(), cache=tstore_).save(
            str(tmp_path / "t.json"))
        jcheckpoint.LoaderCheckpoint.capture(_L(), cache=jstore_).save(
            str(tmp_path / "j.json"))
        assert (json.loads((tmp_path / "t.json").read_text())
                == json.loads((tmp_path / "j.json").read_text()))

    def test_capture_builds_no_store(self):
        ck = tcheckpoint.LoaderCheckpoint.capture(_L())
        assert ck.cache_spill_dir is None and ck.cache_key_schema == 0
        assert tcache.active_store() is None

    def test_apply_adopts_manifest(self, tmp_path, monkeypatch):
        spill = tmp_path / "spill"
        spill.mkdir()
        ck = tcheckpoint.LoaderCheckpoint(
            cache_spill_dir=str(spill),
            cache_key_schema=tcache.KEY_SCHEMA_VERSION)
        loader = _L()
        ck.apply(loader)
        assert loader._epoch == 0
        assert os.environ.get("DDL_TORCH_CACHE_SPILL_DIR") == str(spill)
        monkeypatch.setenv("DDL_TORCH_CACHE", "1")
        assert tcache.default_store().spill_dir == str(spill)

    @pytest.mark.parametrize("why", ["schema", "missing_dir"])
    def test_apply_refusal_is_a_cold_cache_not_an_error(self, tmp_path, why):
        spill = tmp_path / "spill"
        if why == "schema":
            spill.mkdir()
        ck = tcheckpoint.LoaderCheckpoint(
            epoch=5, cache_spill_dir=str(spill),
            cache_key_schema=tcache.KEY_SCHEMA_VERSION
            + (1 if why == "schema" else 0))
        loader = _L()
        ck.apply(loader)
        assert loader._epoch == 5
        assert os.environ.get("DDL_TORCH_CACHE_SPILL_DIR") is None

    def test_apply_refuses_to_reroute_a_live_tier(self, tmp_path,
                                                  monkeypatch):
        monkeypatch.setenv("DDL_TORCH_CACHE_SPILL_DIR", str(tmp_path / "a"))
        live = tcache.default_store()
        assert live.spill_dir == str(tmp_path / "a")
        (tmp_path / "b").mkdir()
        assert not tcache.adopt_manifest(str(tmp_path / "b"),
                                         tcache.KEY_SCHEMA_VERSION)
        assert live.spill_dir == str(tmp_path / "a")

    def test_apply_attaches_tier_to_live_store(self, tmp_path):
        live = tcache.default_store()
        assert live.spill_dir is None
        donor, _ = _store("torch", tmp_path)
        k = tcache.CacheKey("s", "a", "R()")
        donor.put(k, np.arange(32))
        tcheckpoint.LoaderCheckpoint(
            cache_spill_dir=donor.spill_dir,
            cache_key_schema=tcache.KEY_SCHEMA_VERSION).apply(_L())
        assert live.spill_dir == donor.spill_dir
        assert live.get(k) is not None

    def test_adopt_cache_manifest_prespawn_helper(self, tmp_path):
        spill = tmp_path / "spill"
        spill.mkdir()
        path = str(tmp_path / "loader.json")
        tcheckpoint.LoaderCheckpoint(
            cache_spill_dir=str(spill),
            cache_key_schema=tcache.KEY_SCHEMA_VERSION).save(path)
        assert tcheckpoint.adopt_cache_manifest(path)
        assert os.environ["DDL_TORCH_CACHE_SPILL_DIR"] == str(spill)
        assert not tcheckpoint.adopt_cache_manifest(str(tmp_path / "no.json"))
        tcheckpoint.LoaderCheckpoint().save(path)
        assert not tcheckpoint.adopt_cache_manifest(path)
        (tmp_path / "junk.json").write_text("{not json")
        assert not tcheckpoint.adopt_cache_manifest(str(tmp_path / "junk.json"))

    def test_reference_checkpoint_adopted_by_the_port(self, tmp_path):
        """A loader.json the JAX package captured warm-starts the port."""
        jstore_, _ = _store("jax", tmp_path)
        k = jcache.CacheKey("s", "a", "R()")
        jstore_.put(k, np.arange(16))
        path = str(tmp_path / "loader.json")
        jcheckpoint.LoaderCheckpoint.capture(_L(), cache=jstore_).save(path)
        assert tcheckpoint.adopt_cache_manifest(path)
        os.environ["DDL_TORCH_CACHE"] = "1"
        got = tcache.default_store().get(tcache.CacheKey("s", "a", "R()"))
        assert got is not None and got.tobytes() == np.arange(16).tobytes()

    def test_old_checkpoints_still_load(self, tmp_path):
        p = tmp_path / "old.json"
        p.write_text(json.dumps({"epoch": 1, "target": 2,
                                 "batches_in_window": 3,
                                 "shuffle_round": 4}))
        ck = tcheckpoint.LoaderCheckpoint.load(str(p))
        assert ck.epoch == 1 and ck.cache_spill_dir is None


# -- the cache=False override and the config export ---------------------------


class TestCacheFalseOverride:
    @BOTH
    def test_cache_false_wins_over_env_gate(self, tmp_path, monkeypatch,
                                            pkg):
        p = PKG[pkg]
        pattern = _npy_shards(tmp_path, n=2)
        monkeypatch.setenv(p.prefix + "CACHE", "1")
        a = p.readers.FileShardProducer(pattern, cache=False, warm=False)
        a.on_init(producer_idx=1)
        assert a._cache is None
        b = p.readers.FileShardProducer(pattern, warm=False)
        b.on_init(producer_idx=1)
        assert b._cache is p.cache.default_store()
        explicit, _ = _store(pkg)
        c = p.readers.FileShardProducer(pattern, cache=explicit, warm=False)
        c.on_init(producer_idx=1)
        assert c._cache is explicit

    def test_env_gate_off_means_no_store(self, tmp_path):
        pattern = _npy_shards(tmp_path, n=2)
        p = treaders.FileShardProducer(pattern, warm=False)
        p.on_init(producer_idx=1)
        assert p._cache is None and tcache.active_store() is None

    @pytest.mark.parametrize("env", [
        {}, {"CACHE_RAM_MB": "8", "CACHE_SPILL_MB": "16"},
        {"CACHE_CODEC": "zlib"}])
    def test_settings_read_as_the_reference(self, tmp_path, monkeypatch,
                                            env):
        for k, v in env.items():
            monkeypatch.setenv("DDL_TPU_" + k, v)
            monkeypatch.setenv("DDL_TORCH_" + k, v)
        monkeypatch.setenv("DDL_TPU_CACHE_SPILL_DIR", str(tmp_path))
        monkeypatch.setenv("DDL_TORCH_CACHE_SPILL_DIR", str(tmp_path))
        assert tcache.settings_from_env() == jcache.settings_from_env()


class TestConfigExport:
    def test_config_cache_fields_export_to_env(self, monkeypatch):
        export_cache_knobs(LoaderConfig())
        assert "DDL_TORCH_CACHE" not in os.environ
        export_cache_knobs(None)
        assert "DDL_TORCH_CACHE" not in os.environ
        export_cache_knobs(LoaderConfig(
            cache=True, cache_ram_mb=64, cache_spill_dir="/tmp/spill",
            cache_spill_mb=128, cache_warm=False, cache_codec="zlib"))
        assert os.environ["DDL_TORCH_CACHE"] == "1"
        assert os.environ["DDL_TORCH_CACHE_RAM_MB"] == "64"
        assert os.environ["DDL_TORCH_CACHE_SPILL_DIR"] == "/tmp/spill"
        assert os.environ["DDL_TORCH_CACHE_SPILL_MB"] == "128"
        assert os.environ["DDL_TORCH_CACHE_WARM"] == "0"
        assert os.environ["DDL_TORCH_CACHE_CODEC"] == "zlib"
        export_cache_knobs(LoaderConfig(cache=True))
        assert "DDL_TORCH_CACHE_SPILL_DIR" not in os.environ
        assert "DDL_TORCH_CACHE_CODEC" not in os.environ
        export_cache_knobs(LoaderConfig(cache=False))
        assert os.environ["DDL_TORCH_CACHE"] == "0"

    @pytest.mark.parametrize("cfg", [
        dict(), dict(cache=True), dict(cache=True, cache_spill_dir="/s",
                                       cache_ram_mb=7, cache_warm=False),
        dict(cache=False, cache_spill_dir="/s")])
    def test_export_mirrors_the_reference(self, monkeypatch, cfg):
        from ddl_tpu.config import LoaderConfig as JLoaderConfig
        from ddl_tpu.env import _export_cache_knobs

        for prefix in ("DDL_TPU_", "DDL_TORCH_"):
            monkeypatch.setenv(prefix + "CACHE", "1")
            monkeypatch.setenv(prefix + "CACHE_SPILL_DIR", "/stale")
        _export_cache_knobs(JLoaderConfig(**cfg))
        export_cache_knobs(LoaderConfig(**cfg))
        ref = {k[len("DDL_TPU_"):]: v for k, v in os.environ.items()
               if k.startswith("DDL_TPU_CACHE")}
        port = {k[len("DDL_TORCH_"):]: v for k, v in os.environ.items()
                if k.startswith("DDL_TORCH_CACHE")}
        assert port == ref

    def test_decorator_exports_before_the_producers_start(self, tmp_path):
        """``distributed_dataloader(config=...)`` exports the cache fields
        before any producer's ``on_init`` reads them."""
        pattern = _npy_shards(tmp_path, n=2)
        spill = str(tmp_path / "spill")
        cfg = LoaderConfig(cache=True, cache_spill_dir=spill,
                           n_producers=2, cache_warm=False)

        @ddl_tpu_torch.distributed_dataloader(config=cfg, pin_memory=False)
        def main(env):
            loader = ddl_tpu_torch.DistributedDataLoader(
                treaders.FileShardProducer(pattern, seed=1),
                batch_size=8, connection=env.connection, n_epochs=1,
                output="numpy", device="cpu", metrics=Metrics())
            for i in range(len(loader)):
                loader[i]
                loader.mark(ddl_tpu_torch.Marker.END_OF_BATCH)
            loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
            return env.topology.n_producers

        assert main() == 2
        assert tcache.active_store().spill_dir == spill
        assert len([f for f in os.listdir(spill) if f.endswith(".ddlc")]) == 2


# -- end to end ---------------------------------------------------------------


def _loader_stream(pkg, make, n_epochs=2, mode="thread", n_producers=2,
                   config=None, metrics=None, batch_size=8):
    """Every batch of ``n_epochs`` epochs through a real loader, flat."""
    p = ddl_tpu if pkg == "jax" else ddl_tpu_torch
    kw = {} if pkg == "jax" else {"pin_memory": False, "config": config}
    extra = {} if pkg == "jax" else {"device": "cpu",
                                     "metrics": metrics or Metrics()}

    @p.distributed_dataloader(n_producers=n_producers, mode=mode, **kw)
    def main(env):
        loader = p.DistributedDataLoader(
            make(), batch_size=batch_size, connection=env.connection,
            n_epochs=n_epochs, output="numpy", **extra)
        out = []
        for _ in range(n_epochs):
            for i in range(len(loader)):
                out.append(np.concatenate(
                    [np.asarray(c).ravel() for c in loader[i]]))
                loader.mark(p.Marker.END_OF_BATCH)
            loader.mark(p.Marker.END_OF_EPOCH)
        return np.concatenate(out), env

    return main()


def _warmers_alive(before=frozenset()):
    return {t.name for t in threading.enumerate()
            if t.name.startswith("ddl-cache-warmer") and t.is_alive()} - before


def _no_warmer_left(before=frozenset(), timeout=10.0):
    deadline = time.monotonic() + timeout
    while _warmers_alive(before) and time.monotonic() < deadline:
        time.sleep(0.05)
    return not _warmers_alive(before)


class TestEndToEnd:
    @pytest.mark.parametrize("kind", ["fileshard", "tfrecord"])
    def test_thread_stream_equals_the_reference_and_no_leaked_threads(
            self, tmp_path, kind):
        # Shards small enough that each producer cycles its own.
        pattern = (_npy_shards(tmp_path) if kind == "fileshard"
                   else _tfrecord_shards(tmp_path, records=2, length=40))

        def make(pkg, cache):
            return lambda: _reader(pkg, kind, pattern, cache=cache,
                                   warm=cache is not False)

        want, _ = _loader_stream("jax", make("jax", False))
        plain, _ = _loader_stream("torch", make("torch", False))
        store, m = _store("torch", tmp_path)
        before = frozenset(_warmers_alive())
        cached, _ = _loader_stream("torch", make("torch", store))
        assert plain.tobytes() == want.tobytes()
        assert cached.tobytes() == want.tobytes()
        assert m.counter("cache.hits") > 0
        assert m.counter("cache.quarantined") == 0
        assert _no_warmer_left(before)

    def test_webdataset_thread_stream_equals_the_reference(self, tmp_path):
        pattern = _image_shards(tmp_path)

        def make(pkg, cache):
            return lambda: _reader(pkg, "webdataset", pattern, cache=cache,
                                   warm=False)

        want, _ = _loader_stream("jax", make("jax", False), batch_size=2,
                                 n_producers=2)
        store, m = _store("torch")
        got, _ = _loader_stream("torch", make("torch", store), batch_size=2,
                                n_producers=2)
        assert got.tobytes() == want.tobytes()
        assert m.counter("cache.misses") == 2

    def test_process_producers_build_their_store_from_the_env(self,
                                                              tmp_path):
        """PROCESS producers cannot take a store: each builds its own from
        the exported environment and writes the shared spill dir; a
        second run serves from that dir, both equal to the THREAD run."""
        pattern = _npy_shards(tmp_path, n=4)
        spill = str(tmp_path / "spill")

        def make():
            return treaders.FileShardProducer(pattern, seed=5)

        want, _ = _loader_stream("torch", lambda: treaders.FileShardProducer(
            pattern, seed=5, cache=False))
        cfg = LoaderConfig(mode="process", n_producers=2, cache=True,
                           cache_spill_dir=spill, cache_warm=False)
        cold, env = _loader_stream("torch", make, mode="process",
                                   config=cfg)
        assert env.workers.exitcodes == [0, 0]
        entries = sorted(f for f in os.listdir(spill) if f.endswith(".ddlc"))
        assert len(entries) == 4
        mtimes = [os.stat(os.path.join(spill, f)).st_mtime_ns
                  for f in entries]
        warm, env = _loader_stream("torch", make, mode="process",
                                   config=cfg)
        assert env.workers.exitcodes == [0, 0]
        assert cold.tobytes() == want.tobytes() == warm.tobytes()
        # The warm run rewrote nothing: every shard came off the disk tier.
        assert [os.stat(os.path.join(spill, f)).st_mtime_ns
                for f in entries] == mtimes

    def test_retired_thread_producers_warmer_is_closed(self, tmp_path):
        """A hung THREAD producer is retired and respawned: the retired
        incarnation's ``on_push_end`` closes its warmer, the stream equals
        the undisturbed one, and no warmer thread is left."""
        from ddl_tpu_torch.watchdog import Watchdog

        pattern = _npy_shards(tmp_path, n=4)
        store, m = _store("torch", tmp_path)
        closed = []
        close = tcache.CacheWarmer.close

        def counting_close(self, timeout_s=10.0):
            ok = close(self, timeout_s)
            closed.append((threading.current_thread().name, ok))
            return ok

        # Slow warmers, so each incarnation's is still running when its
        # producer ends.
        be = tcache.ThrottledBackend(latency_s=0.3)

        def make():
            return treaders.FileShardProducer(pattern, seed=4, cache=store,
                                              backend=be, warm=True)

        want, _ = _loader_stream("torch", lambda: treaders.FileShardProducer(
            pattern, seed=4, cache=False), n_epochs=8)
        before = frozenset(_warmers_alive())
        plan = tfaults.FaultPlan([tfaults.FaultSpec(
            "producer.fill", tfaults.FaultKind.PRODUCER_HANG, at=2,
            producer_idx=1)])
        respawned = []

        @ddl_tpu_torch.distributed_dataloader(n_producers=2, mode="thread",
                                              pin_memory=False)
        def main(env):
            wd = Watchdog(env.workers, poll_interval_s=0.1, respawn=True,
                          stall_budget_s=3.0, metrics=m)
            wd.start()
            try:
                loader = ddl_tpu_torch.DistributedDataLoader(
                    make(), batch_size=8, connection=env.connection,
                    n_epochs=8, output="numpy", device="cpu", metrics=m)
                out = []
                for _ in range(8):
                    for i in range(len(loader)):
                        out.append(np.concatenate(
                            [np.asarray(c).ravel() for c in loader[i]]))
                        loader.mark(ddl_tpu_torch.Marker.END_OF_BATCH)
                    loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
                respawned.extend(wd.respawns)
                return np.concatenate(out)
            finally:
                wd.stop()

        orig = tcache.CacheWarmer.close
        tcache.CacheWarmer.close = counting_close
        try:
            with tfaults.armed(plan):
                got = main()
        finally:
            tcache.CacheWarmer.close = orig
        assert got.tobytes() == want.tobytes()
        assert respawned == [1]
        # Three incarnations ended (two producers and the replacement),
        # the retired one among them, each closing its own warmer.
        assert len(closed) == 3, closed
        assert all(ok for _, ok in closed)
        assert any(name.startswith("ddl-torch-producer-1")
                   and not name.endswith("-respawn") for name, _ in closed)
        assert _no_warmer_left(before)
