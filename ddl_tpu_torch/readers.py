"""Producer-function library (port of ``ddl_tpu/readers.py``): ready-made
readers for the common data layouts, each sharded deterministically by
``(instance_idx, producer_idx)`` and serving the JAX package's bytes for
the same inputs and seed.

- :class:`ArrayProducer` — an in-memory (N, F) array.
- :class:`TokenStreamProducer` / :class:`PackedTokenProducer` — a flat
  token file, unpacked or with packed-document segment ids.
- :class:`FileShardProducer` — ``.npy`` shard files, one per refill.
- :class:`WebDatasetProducer` — WebDataset-style image ``.tar`` shards
  (Pillow, imported when a producer starts).
- :class:`TFRecordTokenProducer` — C4-style tokenized TFRecord shards,
  parsed by the stdlib-only framing and ``tf.Example`` readers below.

The three file readers fetch shard bytes through the storage backends of
:mod:`ddl_tpu_torch.cache` and keep decoded shards in its shard cache
when it is on (``DDL_TORCH_CACHE=1`` or an explicit ``cache=`` store):
epochs after the first then skip the fetch and the decode, and a
background warmer prefetches upcoming shards (:class:`_ShardCacheMixin`).
"""

from __future__ import annotations

import glob as glob_mod
import io
import struct
from typing import Any, BinaryIO, Callable, Optional, Sequence

import numpy as np

from ddl_tpu_torch import cache as cache_mod
from ddl_tpu_torch.datasetwrapper import (
    DataProducerOnInitReturn,
    ProducerFunctionSkeleton,
)
from ddl_tpu_torch.exceptions import IntegrityError


def _my_shard(n_items: int, producer_idx: int, n_producers: int,
              instance_idx: int, n_instances: int) -> np.ndarray:
    """Deterministic strided shard of [0, n_items) for this worker."""
    worker = instance_idx * n_producers + (producer_idx - 1)
    total = n_instances * n_producers
    return np.arange(worker % total, n_items, total)


def _glob_my_shards(pattern: str, producer_idx: int, n_producers: int,
                    instance_idx: int, n_instances: int) -> list:
    """Glob plus the strided per-worker shard assignment shared by the
    file-shard producers, with at least one shard per worker."""
    paths = sorted(glob_mod.glob(pattern))
    if not paths:
        raise FileNotFoundError(f"no shards match {pattern!r}")
    mine = _my_shard(len(paths), producer_idx, n_producers,
                     instance_idx, n_instances)
    if len(mine) == 0:
        raise ValueError(
            f"{len(paths)} shard(s) matching {pattern!r} is fewer than "
            f"one per worker ({n_instances * n_producers} workers)"
        )
    return [paths[i] for i in mine]


class _ShardCacheMixin:
    """Backend and cache plumbing shared by the shard-file producers.

    Every shard byte goes through a :class:`~ddl_tpu_torch.cache.
    StorageBackend` (``backend=``; default the local filesystem) with
    bounded retry, and with the cache on, decoded shards are kept in a
    :class:`~ddl_tpu_torch.cache.CacheStore` under content-addressed keys
    (source fingerprint, shard, reader class and params, transform
    version).  A :class:`~ddl_tpu_torch.cache.CacheWarmer` prefetches
    this worker's shards in epoch order; ``on_push_end`` (run by the
    pusher's teardown, also for a retired THREAD incarnation) closes it
    with a bounded join.

    The cache is resolved on the worker, in ``on_init``: an explicit
    ``cache=`` store wins (THREAD mode and tests: a store does not cross
    a spawn); ``cache=False`` is off whatever the environment says;
    otherwise the ``DDL_TORCH_CACHE`` gate picks the process-default
    store, which spawned producers build from the environment.

    Subclasses set ``backend``, ``cache`` and ``warm`` in their
    constructors, ``transform_version`` (bumped when the decoded bytes
    change), and override ``_reader_params`` with every constructor
    parameter that changes them.
    """

    #: Decode-logic version: part of the key, so a bump orphans (never
    #: aliases) entries decoded by older logic.
    transform_version = 1

    def _cache_init(self) -> None:
        """Resolve the backend, the store and the retry policy (early in
        ``on_init``)."""
        self._backend = self.backend or cache_mod.LocalBackend()
        if self.cache is False:
            self._cache = None
        elif self.cache is not None:
            self._cache = self.cache
        elif cache_mod.cache_enabled():
            self._cache = cache_mod.default_store()
        else:
            self._cache = None
        self._retry = cache_mod.retry_settings_from_env()
        if not hasattr(self, "_warmer"):
            self._warmer = None

    def _reader_params(self) -> str:
        """Constructor params that change decoded bytes (key material)."""
        return ""

    def _shard_key(self, path: str):
        return cache_mod.CacheKey(
            source=self._backend.fingerprint(path),
            shard=path,
            reader=f"{type(self).__qualname__}({self._reader_params()})",
            transform=str(self.transform_version),
        )

    def _open_shard(self, path: str, should_abort=None) -> BinaryIO:
        """Backend open through the one bounded retry policy."""
        m = self._cache.metrics if self._cache is not None else None
        return cache_mod.open_with_retry(
            self._backend, path, metrics=m, should_abort=should_abort,
            **self._retry,
        )

    def _cached_shard(
        self, path: str, decode: Callable[[str, BinaryIO], np.ndarray]
    ) -> np.ndarray:
        """Whole-shard get-or-decode (``decode(path, open_file)``).  A miss
        (a quarantined disk entry included) refetches from source and
        re-inserts.  A cached array is read-only and shared."""
        if self._cache is None:
            with self._open_shard(path) as f:
                return decode(path, f)
        key = self._shard_key(path)
        arr = self._cache.get(key)
        if arr is None:
            with self._open_shard(path) as f:
                arr = self._cache.put(key, decode(path, f))
        return arr

    def _start_warmer(
        self,
        paths: Sequence[str],
        decode: Callable[[str, BinaryIO], np.ndarray],
    ) -> None:
        """Start the epoch-order prefetch of ``paths`` (idempotent; nothing
        without a cache or with warming off)."""
        if (
            self._cache is None
            or self._warmer is not None
            or not cache_mod.warm_enabled(self.warm)
        ):
            return

        def job(path):
            def load(should_abort):
                with self._open_shard(path, should_abort=should_abort) as f:
                    return decode(path, f)

            # The key as a thunk: its fingerprint is paid on the warmer
            # thread, not serially on the producer's init path.
            return (lambda p=path: self._shard_key(p), load)

        self._warmer = cache_mod.CacheWarmer(
            self._cache,
            [job(p) for p in paths],
            name=f"ddl-cache-warmer-{type(self).__name__}",
        )

    def on_push_end(self, **kw: Any) -> None:
        """Producer teardown hook: stop the warmer (bounded join)."""
        w = getattr(self, "_warmer", None)
        if w is not None:
            w.close()
            self._warmer = None


class ArrayProducer(ProducerFunctionSkeleton):
    """Serve a host-resident (N, F) array — the ``TensorDataset`` analog.

    Each worker owns a strided shard; every window is a fresh sample of
    ``window_size`` rows from the shard (reshuffled per refill).  Draws
    and bytes equal the JAX package's reader for the same data and seed.
    """

    #: Every fill fully rewrites the window — safe to hand a live ring
    #: slot (write-once producer discipline).
    supports_inplace_fill = True

    def __init__(self, data: np.ndarray, window_size: int,
                 splits: Optional[Sequence[int]] = None, seed: int = 0):
        self.data = np.ascontiguousarray(data)
        self.window_size = window_size
        self.splits = tuple(splits) if splits else (data.shape[1],)
        self.seed = seed

    def on_init(self, producer_idx=0, n_producers=1, instance_idx=0,
                n_instances=1, **kw) -> DataProducerOnInitReturn:
        idx = _my_shard(len(self.data), producer_idx, n_producers,
                        instance_idx, n_instances)
        self._shard = self.data[idx]
        if len(self._shard) < self.window_size:
            reps = -(-self.window_size // max(len(self._shard), 1))
            self._shard = np.tile(self._shard, (reps, 1))
        self._rng = np.random.default_rng(
            [self.seed, instance_idx, producer_idx]
        )
        return DataProducerOnInitReturn(
            nData=self.window_size,
            nValues=self.data.shape[1],
            shape=(self.window_size, self.data.shape[1]),
            splits=self.splits,
            dtype=self.data.dtype,
        )

    def _fill(self, my_ary: np.ndarray) -> None:
        pick = self._rng.choice(len(self._shard), self.window_size,
                                replace=False)
        # Gather straight into the (possibly ring-slot) window; mode="clip"
        # (indices are in range) keeps numpy from buffering the output.
        self._shard.take(pick, axis=0, out=my_ary, mode="clip")

    def post_init(self, my_ary, **kw):
        self._fill(my_ary)

    def execute_function(self, my_ary, **kw):
        self._fill(my_ary)


class FileShardProducer(_ShardCacheMixin, ProducerFunctionSkeleton):
    """Stream ``.npy`` shard files matching a glob, shard-per-worker.

    Each worker round-robins its own shards, one per window refill, with
    a seeded permutation of the shard's rows per refill, so the served
    stream is the same whether a shard came from source or from the
    cache.  Reads go through the backend and the shard cache
    (:class:`_ShardCacheMixin`).
    """

    #: Each refill is one full permutation gather into the window: a
    #: live ring slot may be handed over (write-once).
    supports_inplace_fill = True

    def __init__(self, pattern: str, splits: Optional[Sequence[int]] = None,
                 seed: int = 0, backend: Any = None, cache: Any = None,
                 warm: Optional[bool] = None):
        self.pattern = pattern
        self.splits = tuple(splits) if splits else None
        self.seed = seed
        self.backend = backend
        self.cache = cache
        self.warm = warm

    def on_init(self, producer_idx=0, n_producers=1, instance_idx=0,
                n_instances=1, **kw) -> DataProducerOnInitReturn:
        self._paths = _glob_my_shards(
            self.pattern, producer_idx, n_producers, instance_idx,
            n_instances,
        )
        self._cursor = 0
        self._rng = np.random.default_rng([self.seed, producer_idx])
        self._cache_init()
        first = self._cached_shard(self._paths[0], self._decode)
        self._start_warmer(self._paths, self._decode)
        n_values = int(np.prod(first.shape[1:]))
        return DataProducerOnInitReturn(
            nData=first.shape[0],
            nValues=n_values,
            shape=(first.shape[0], n_values),
            splits=self.splits or (n_values,),
            dtype=first.dtype,
        )

    @staticmethod
    def _decode(path: str, f: BinaryIO) -> np.ndarray:
        return np.load(f)

    def _load_next(self, my_ary: np.ndarray) -> None:
        path = self._paths[self._cursor % len(self._paths)]
        self._cursor += 1
        # A cached array is shared and read-only: the reshuffle is a
        # permutation gather straight into the window (the ring slot on
        # the in-place path), never a shuffle of the source.  mode="clip"
        # (a permutation is in range) keeps numpy from buffering the
        # output.
        arr = self._cached_shard(path, self._decode).reshape(my_ary.shape)
        perm = self._rng.permutation(len(arr))
        arr.take(perm, axis=0, out=my_ary, mode="clip")

    def post_init(self, my_ary, **kw):
        self._load_next(my_ary)

    def execute_function(self, my_ary, **kw):
        self._load_next(my_ary)


class TokenStreamProducer(ProducerFunctionSkeleton):
    """Serve fixed-length token sequences from a flat token array on disk.

    A memory-mapped 1-D token file; each window is ``window_rows``
    sequences of ``seq_len`` tokens drawn (seeded, per worker) from this
    worker's strided region.  Output splits are ``(seq_len,)``.  Draws
    and bytes equal the JAX package's reader for the same file and seed.
    """

    #: Row-wise full rewrite per refill (and PackedTokenProducer's
    #: segment pass reads only what the same call wrote) — live-slot safe.
    supports_inplace_fill = True

    def __init__(self, token_file: str, seq_len: int, window_rows: int,
                 dtype: Any = np.int32, seed: int = 0):
        self.token_file = token_file
        self.seq_len = seq_len
        self.window_rows = window_rows
        self.dtype = np.dtype(dtype)
        self.seed = seed

    def on_init(self, producer_idx=0, n_producers=1, instance_idx=0,
                n_instances=1, **kw) -> DataProducerOnInitReturn:
        self._tokens = np.memmap(self.token_file, dtype=self.dtype, mode="r")
        n_seqs = len(self._tokens) // self.seq_len
        mine = _my_shard(n_seqs, producer_idx, n_producers,
                         instance_idx, n_instances)
        if len(mine) == 0:
            raise ValueError("token file smaller than one sequence per worker")
        self._mine = mine
        self._rng = np.random.default_rng([self.seed, instance_idx, producer_idx])
        return DataProducerOnInitReturn(
            nData=self.window_rows,
            nValues=self.seq_len,
            shape=(self.window_rows, self.seq_len),
            splits=(self.seq_len,),
            dtype=self.dtype,
        )

    def _fill(self, my_ary: np.ndarray) -> None:
        pick = self._rng.choice(
            self._mine, self.window_rows, replace=len(self._mine) < self.window_rows
        )
        for row, seq_idx in enumerate(pick):
            start = int(seq_idx) * self.seq_len
            my_ary[row] = self._tokens[start : start + self.seq_len]

    def post_init(self, my_ary, **kw):
        self._fill(my_ary)

    def execute_function(self, my_ary, **kw):
        self._fill(my_ary)


class PackedTokenProducer(TokenStreamProducer):
    """Token stream with PACKED-DOCUMENT segment ids.

    Streaming packing, the standard LM-pretraining layout: each row is
    ``seq_len`` consecutive tokens spanning document boundaries, and a
    second column block carries row-local segment ids that increment
    after every ``delimiter`` token (EOS).  Feed the columns to the
    segment-aware loss so attention resets at document boundaries::

        loss = lambda p, b: llama.next_token_loss(
            p, b[0], cfg, segment_ids=b[1])

    Window layout: ``(window_rows, 2*seq_len)``, splits ``(seq_len,
    seq_len)`` — column 0 tokens, column 1 segment ids.  Bytes equal the
    JAX package's reader for the same file and seed.
    """

    def __init__(self, token_file: str, seq_len: int, window_rows: int,
                 delimiter: int = 0, dtype: Any = np.int32, seed: int = 0):
        super().__init__(token_file, seq_len, window_rows, dtype, seed)
        self.delimiter = int(delimiter)

    def on_init(self, producer_idx=0, n_producers=1, instance_idx=0,
                n_instances=1, **kw) -> DataProducerOnInitReturn:
        base = super().on_init(
            producer_idx=producer_idx, n_producers=n_producers,
            instance_idx=instance_idx, n_instances=n_instances, **kw,
        )
        return DataProducerOnInitReturn(
            nData=base.nData,
            nValues=2 * self.seq_len,
            shape=(self.window_rows, 2 * self.seq_len),
            splits=(self.seq_len, self.seq_len),
            dtype=self.dtype,
        )

    def _fill(self, my_ary: np.ndarray) -> None:
        tokens = my_ary[:, : self.seq_len]
        super()._fill(tokens)
        # Row-local segment ids: a token belongs to the document OPENED
        # by the most recent delimiter strictly before it (the delimiter
        # itself closes its document).
        ends = tokens == self.delimiter
        seg = np.zeros_like(tokens)
        seg[:, 1:] = np.cumsum(ends[:, :-1], axis=1)
        my_ary[:, self.seq_len :] = seg


class WebDatasetProducer(_ShardCacheMixin, ProducerFunctionSkeleton):
    """WebDataset-style tar-shard image reader.

    Each shard is a ``.tar`` whose members pair by basename:
    ``<key>.jpg`` / ``.jpeg`` / ``.png`` (the image) and ``<key>.cls`` (an
    ascii integer label).  Images decode with Pillow, resize to
    ``(image_size, image_size)`` RGB, scale to [0, 1] float32 and
    flatten; each window row is ``[pixels..., label]`` (splits
    ``(H*W*3, 1)``).  Shards are read as tar streams, sample by sample
    (a shard is never materialised whole), cycling forever.

    With the cache on, a shard's decoded rows land in the cache as one
    ``(n_samples, H*W*3+1)`` float32 array, so warm epochs skip the tar
    read and every image decode.  Pillow is imported when a producer
    starts, never when this module is imported.
    """

    _IMG_EXT = (".jpg", ".jpeg", ".png")

    #: Every fill writes each window row once: live-slot safe.
    supports_inplace_fill = True

    def __init__(self, pattern: str, image_size: int = 32,
                 window_rows: int = 64, backend: Any = None,
                 cache: Any = None, warm: Optional[bool] = None):
        self.pattern = pattern
        self.image_size = image_size
        self.window_rows = window_rows
        self.backend = backend
        self.cache = cache
        self.warm = warm

    def _reader_params(self) -> str:
        return f"image_size={self.image_size}"

    def on_init(self, producer_idx=0, n_producers=1, instance_idx=0,
                n_instances=1, **kw) -> DataProducerOnInitReturn:
        try:
            from PIL import Image  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "WebDatasetProducer needs Pillow for image decoding"
            ) from e
        self._shards = _glob_my_shards(
            self.pattern, producer_idx, n_producers, instance_idx,
            n_instances,
        )
        self._cache_init()
        self._n_px = self.image_size * self.image_size * 3
        self._iter = self._stream_rows()
        self._start_warmer(self._shards, self._decode_shard)
        return DataProducerOnInitReturn(
            nData=self.window_rows,
            nValues=self._n_px + 1,
            shape=(self.window_rows, self._n_px + 1),
            splits=(self._n_px, 1),
        )

    def _stream_pairs(self, f):
        """Yield (image_bytes, label) from ONE open tar stream, pairing
        members by key; ``pending`` holds only incomplete keys."""
        import tarfile

        with tarfile.open(fileobj=f, mode="r|*") as tf:
            pending: dict = {}
            done: set = set()  # keys already yielded this shard
            for m in tf:
                if not m.isfile():
                    continue
                stem, dot, ext = m.name.rpartition(".")
                ext = dot + ext.lower()
                # Only pairing members buffer (a .json/.txt sidecar would
                # leak), and a key that has yielded drops its stragglers.
                if ext not in self._IMG_EXT and ext != ".cls":
                    continue
                if stem in done:
                    continue
                d = pending.setdefault(stem, {})
                d[ext] = tf.extractfile(m).read()
                img = next((d[e] for e in self._IMG_EXT if e in d), None)
                if img is not None and ".cls" in d:
                    del pending[stem]
                    done.add(stem)
                    yield img, int(d[".cls"].decode().strip())

    def _row(self, img_bytes: bytes, label: int) -> np.ndarray:
        row = np.empty(self._n_px + 1, np.float32)
        row[:-1] = self._decode(img_bytes)
        row[-1] = float(label)
        return row

    def _decode_shard(self, path: str, f) -> np.ndarray:
        """Whole-shard decode to (n_samples, n_px+1) rows (the warmer's)."""
        rows = [self._row(img, lab) for img, lab in self._stream_pairs(f)]
        if not rows:
            raise ValueError(f"shard {path} holds no (image, .cls) pairs")
        return np.stack(rows)

    def _stream_rows(self):
        """Yield decoded window rows, cycling shards forever.  A warm
        shard comes out of the cache; a cold one streams row by row and
        is inserted whole at its end (an abandoned stream caches
        nothing)."""
        shard_i = 0
        while True:
            path = self._shards[shard_i % len(self._shards)]
            shard_i += 1
            cached = (
                self._cache.get(self._shard_key(path))
                if self._cache is not None else None
            )
            if cached is not None:
                if len(cached) == 0:
                    raise ValueError(
                        f"shard {path} holds no (image, .cls) pairs"
                    )
                yield from cached
                continue
            collect = [] if self._cache is not None else None
            collect_bytes = 0
            n = 0
            with self._open_shard(path) as f:
                for img, label in self._stream_pairs(f):
                    row = self._row(img, label)
                    n += 1
                    if collect is not None:
                        collect.append(row)
                        collect_bytes += row.nbytes
                        if collect_bytes > self._cache.ram_budget_bytes:
                            # Bigger than either tier keeps: stop
                            # buffering, keep streaming.
                            collect = None
                    yield row
            if n == 0:
                raise ValueError(
                    f"shard {path} holds no (image, .cls) pairs"
                )
            if collect is not None:
                self._cache.put(self._shard_key(path), np.stack(collect))

    def _decode(self, img_bytes: bytes) -> np.ndarray:
        from PIL import Image

        im = Image.open(io.BytesIO(img_bytes)).convert("RGB")
        if im.size != (self.image_size, self.image_size):
            im = im.resize((self.image_size, self.image_size))
        return np.asarray(im, np.float32).reshape(-1) / 255.0

    def _fill(self, my_ary: np.ndarray) -> None:
        for row in range(self.window_rows):
            my_ary[row] = next(self._iter)

    def post_init(self, my_ary, **kw):
        self._fill(my_ary)

    def execute_function(self, my_ary, **kw):
        self._fill(my_ary)


# -- TFRecord / tf.Example (stdlib-only parsers) ------------------------------

# CRC32C (Castagnoli), the TFRecord framing checksum, with numpy tables
# and no native dependency; crc32c(b"123456789") == 0xE3069283 (the
# spec's check vector).  Slicing-by-K with a wide stripe (K = 2048): each
# Python-loop step folds a whole stripe with one table gather and one XOR
# reduction.  A byte-at-a-time loop runs at ~1 MiB/s in numpy.

_CRC32C_POLY = 0x82F63B78  # reversed Castagnoli polynomial
_CRC32C_STRIPE = 2048  # bytes per vectorised step (table: K*256*4 = 2 MiB)
_crc32c_byte_table: Optional[np.ndarray] = None
_crc32c_stripe_table: Optional[np.ndarray] = None


def _make_crc32c_tables() -> tuple:
    t0 = np.empty(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_CRC32C_POLY if c & 1 else 0)
        t0[i] = c
    # stripe[j] is the table of the byte at position j of a K-byte
    # stripe: that byte followed by K-1-j zero bytes.
    stripe = np.empty((_CRC32C_STRIPE, 256), np.uint32)
    prev = t0
    stripe[_CRC32C_STRIPE - 1] = t0
    for m in range(1, _CRC32C_STRIPE):
        prev = t0[prev & 0xFF] ^ (prev >> np.uint32(8))
        stripe[_CRC32C_STRIPE - 1 - m] = prev
    return t0, stripe


def _crc32c_update_bytes(crc: int, buf: np.ndarray, t0: np.ndarray) -> int:
    """Per-byte update of a tail shorter than one stripe."""
    for b in buf:
        crc = int(t0[(crc ^ int(b)) & 0xFF]) ^ (crc >> 8)
    return crc


def crc32c(data) -> int:
    """CRC32C of a bytes-like object or uint8 array.

    Whole stripes fold with one numpy gather and ``bitwise_xor.reduce``
    each (the running CRC XORed into the stripe's first 4 bytes, as in
    slicing-by-N); the tail takes the per-byte loop."""
    global _crc32c_byte_table, _crc32c_stripe_table
    if _crc32c_byte_table is None:
        _crc32c_byte_table, _crc32c_stripe_table = _make_crc32c_tables()
    t0, stripe = _crc32c_byte_table, _crc32c_stripe_table
    buf = np.frombuffer(memoryview(data), np.uint8)
    crc = 0xFFFFFFFF
    K = _CRC32C_STRIPE
    nstripes = len(buf) // K
    if nstripes:
        # One flat gather (an int add and a 1-D take) beats the 2-D
        # fancy index.
        flat = stripe.ravel()
        offs = np.arange(K, dtype=np.int64) * 256
        for s in range(nstripes):
            block = buf[s * K : (s + 1) * K]
            head = block[:4] ^ np.frombuffer(
                crc.to_bytes(4, "little"), np.uint8
            )
            crc = int(
                np.bitwise_xor.reduce(flat[offs[:4] + head])
                ^ np.bitwise_xor.reduce(flat[offs[4:] + block[4:]])
            )
    crc = _crc32c_update_bytes(crc, buf[nstripes * K :], t0)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data) -> int:
    """The TFRecord "masked" CRC: rotate right 15 and add a constant, so
    a CRC of CRCs does not look valid."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord_crc_enabled(override: Optional[bool] = None) -> bool:
    """The ``DDL_TORCH_TFRECORD_CRC`` gate (default on); off is for
    trusted local data, where the parse rate matters more than catching
    corruption at rest."""
    from ddl_tpu_torch import envspec

    return envspec.flag("DDL_TORCH_TFRECORD_CRC", override)


def iter_tfrecords(
    path: str,
    verify_crc: Optional[bool] = None,
    fileobj: Optional[BinaryIO] = None,
):
    """Yield raw record payloads from a TFRecord file.

    Framing: u64le length, u32 masked length CRC, payload, u32 masked
    payload CRC.  Both CRCs are checked (a mismatch raises
    :class:`~ddl_tpu_torch.exceptions.IntegrityError` naming the file and
    offset) unless ``verify_crc=False`` or ``DDL_TORCH_TFRECORD_CRC=0``.
    A truncated final record ends the stream in both modes: the knob
    changes whether records are checked, never which are served.
    ``fileobj`` reads an open stream (a backend's handle; ``path`` then
    only labels errors, and the caller closes it)."""
    if fileobj is not None:
        yield from _iter_tfrecord_stream(path, fileobj, verify_crc)
        return
    with open(path, "rb") as f:
        yield from _iter_tfrecord_stream(path, f, verify_crc)


def _iter_tfrecord_stream(path: str, f: BinaryIO,
                          verify_crc: Optional[bool]):
    verify = tfrecord_crc_enabled(verify_crc)
    offset = 0
    while True:
        head = f.read(12)
        if len(head) < 12:
            return
        (length,) = struct.unpack("<Q", head[:8])
        if verify:
            (got_len_crc,) = struct.unpack("<I", head[8:12])
            want_len_crc = masked_crc32c(head[:8])
            if got_len_crc != want_len_crc:
                raise IntegrityError(
                    f"{path}: corrupt TFRecord length-crc at offset "
                    f"{offset} (0x{got_len_crc:08x} != "
                    f"0x{want_len_crc:08x})"
                )
        payload = f.read(length)
        if len(payload) < length:
            return
        tail = f.read(4)
        if len(tail) < 4:
            return  # truncated trailer: end of stream in both modes
        if verify:
            (got_crc,) = struct.unpack("<I", tail)
            want_crc = masked_crc32c(payload)
            if got_crc != want_crc:
                raise IntegrityError(
                    f"{path}: corrupt TFRecord payload at offset "
                    f"{offset} ({length} bytes; crc 0x{got_crc:08x} "
                    f"!= 0x{want_crc:08x})"
                )
        offset += 12 + length + 4
        yield payload


def _read_varint(buf: bytes, pos: int):
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def example_int64_feature(payload: bytes, key: str) -> Optional[np.ndarray]:
    """Extract an int64-list feature from a serialized ``tf.Example``.

    A micro-decoder for the three nested messages involved
    (Example.features → Features.feature map → Feature.int64_list),
    stdlib only.  Returns None when ``key`` is absent."""

    def fields(buf):
        pos = 0
        while pos < len(buf):
            tag, pos = _read_varint(buf, pos)
            field, wire = tag >> 3, tag & 7
            if wire == 2:  # length-delimited
                n, pos = _read_varint(buf, pos)
                yield field, buf[pos : pos + n]
                pos += n
            elif wire == 0:  # varint
                v, pos = _read_varint(buf, pos)
                yield field, v
            elif wire == 5:  # 32-bit
                pos += 4
            elif wire == 1:  # 64-bit
                pos += 8
            else:
                raise ValueError(f"unsupported wire type {wire}")

    for f_ex, features in fields(payload):
        if f_ex != 1:  # Example.features
            continue
        for f_map, entry in fields(features):
            if f_map != 1:  # Features.feature (map entry)
                continue
            k = v = None
            for f_e, val in fields(entry):
                if f_e == 1:
                    k = val.decode()
                elif f_e == 2:
                    v = val
            if k != key or v is None:
                continue
            for f_feat, lst in fields(v):
                if f_feat != 3:  # Feature.int64_list
                    continue
                values = []
                for f_l, packed in fields(lst):
                    if f_l != 1:
                        continue
                    if isinstance(packed, int):  # unpacked varint
                        values.append(packed)
                    else:  # packed repeated varints
                        pos = 0
                        while pos < len(packed):
                            v_, pos = _read_varint(packed, pos)
                            values.append(v_)
                return np.array(values, np.int64)
    return None


class TFRecordTokenProducer(_ShardCacheMixin, ProducerFunctionSkeleton):
    """C4-style tokenized TFRecord stream.

    Shard files matching ``pattern`` are assigned per worker and parsed
    by the stdlib-only readers above.  With ``feature_key`` (default
    ``"input_ids"``) each record is a ``tf.Example`` whose int64-list
    feature holds the tokens; with ``feature_key=None`` a record's
    payload is raw little-endian int32 tokens.  The token streams
    concatenate and cut into ``seq_len`` rows.

    With the cache on, a shard's tokens land in the cache as ONE int32
    array, so warm epochs skip the framing walk, both CRC passes and the
    protobuf decode; the stream is the same bytes either way.
    """

    #: ``_fill`` streams token chunks straight into the flat window view,
    #: rewriting it whole: live-slot safe.
    supports_inplace_fill = True

    def __init__(self, pattern: str, seq_len: int, window_rows: int,
                 feature_key: Optional[str] = "input_ids",
                 verify_crc: Optional[bool] = None, backend: Any = None,
                 cache: Any = None, warm: Optional[bool] = None):
        self.pattern = pattern
        self.seq_len = seq_len
        self.window_rows = window_rows
        self.feature_key = feature_key
        #: None defers to the ``DDL_TORCH_TFRECORD_CRC`` gate (default on).
        self.verify_crc = verify_crc
        self.backend = backend
        self.cache = cache
        self.warm = warm

    def _reader_params(self) -> str:
        return f"feature_key={self.feature_key}"

    def on_init(self, producer_idx=0, n_producers=1, instance_idx=0,
                n_instances=1, **kw) -> DataProducerOnInitReturn:
        self._shards = _glob_my_shards(
            self.pattern, producer_idx, n_producers, instance_idx,
            n_instances,
        )
        self._cache_init()
        self._records = self._stream_records()
        self._buf = np.zeros((0,), np.int32)
        self._dry_shards = 0
        self._start_warmer(self._shards, self._decode_shard)
        return DataProducerOnInitReturn(
            nData=self.window_rows,
            nValues=self.seq_len,
            shape=(self.window_rows, self.seq_len),
            splits=(self.seq_len,),
            dtype=np.int32,
        )

    def _decode_shard(self, path: str, f) -> np.ndarray:
        """Whole-shard parse to one token array (the warmer's).  A shard
        with no tokens caches as a zero-length array."""
        chunks = [
            self._tokens_from(p)
            for p in iter_tfrecords(path, verify_crc=self.verify_crc,
                                    fileobj=f)
        ]
        chunks = [c for c in chunks if len(c)]
        return np.concatenate(chunks) if chunks else np.zeros(0, np.int32)

    def _stream_records(self):
        """Yield token chunks record by record, cycling shards forever:
        memory is bounded by one record on the cold path (the cache
        insert assembles the shard's tokens once, at its end).  A warm
        shard yields its whole token array as one chunk."""
        shard_i = 0
        while True:
            path = self._shards[shard_i % len(self._shards)]
            shard_i += 1
            grew = False
            cached = (
                self._cache.get(self._shard_key(path))
                if self._cache is not None else None
            )
            if cached is not None:
                if len(cached):
                    grew = True
                    yield cached
            else:
                collect = [] if self._cache is not None else None
                collect_bytes = 0
                with self._open_shard(path) as f:
                    for payload in iter_tfrecords(
                        path, verify_crc=self.verify_crc, fileobj=f
                    ):
                        toks = self._tokens_from(payload)
                        if len(toks):
                            grew = True
                            if collect is not None:
                                collect.append(toks)
                                collect_bytes += toks.nbytes
                                if (collect_bytes
                                        > self._cache.ram_budget_bytes):
                                    # Too big for either tier: stream on
                                    # without buffering.
                                    collect = None
                            yield toks
                if collect is not None:
                    self._cache.put(
                        self._shard_key(path),
                        np.concatenate(collect)
                        if collect else np.zeros(0, np.int32),
                    )
            if not grew:
                # Consecutive dry shards: an all-empty shard set raises
                # instead of cycling forever.
                self._dry_shards += 1
                if self._dry_shards >= len(self._shards):
                    raise ValueError(
                        f"no tokens in any of {len(self._shards)} TFRecord "
                        f"shard(s) (last: {path})"
                    )
            else:
                self._dry_shards = 0

    def _tokens_from(self, payload: bytes) -> np.ndarray:
        if self.feature_key is None:
            return np.frombuffer(payload, "<i4").astype(np.int32)
        toks = example_int64_feature(payload, self.feature_key)
        if toks is None:
            raise ValueError(
                f"record lacks int64 feature {self.feature_key!r}"
            )
        return toks.astype(np.int32)

    def _fill(self, my_ary: np.ndarray) -> None:
        # Write-once: chunks land straight in the flat window view (a
        # ring slot on the in-place path); a cached chunk is only read.
        flat = my_ary.reshape(-1)
        need = flat.size
        take = min(len(self._buf), need)
        if take:
            flat[:take] = self._buf[:take]
        rest = self._buf[take:]
        pos = take
        while pos < need:
            toks = next(self._records)
            take = min(len(toks), need - pos)
            flat[pos : pos + take] = toks[:take]
            rest = toks[take:]
            pos += take
        self._buf = rest

    def post_init(self, my_ary, **kw):
        self._fill(my_ary)

    def execute_function(self, my_ary, **kw):
        self._fill(my_ary)
