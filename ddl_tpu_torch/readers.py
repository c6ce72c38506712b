"""Producer-function library (port of ``ddl_tpu/readers.py``:
:class:`ArrayProducer`, :class:`TokenStreamProducer` and
:class:`PackedTokenProducer`; the other readers are later slices).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from ddl_tpu_torch.datasetwrapper import (
    DataProducerOnInitReturn,
    ProducerFunctionSkeleton,
)


def _my_shard(n_items: int, producer_idx: int, n_producers: int,
              instance_idx: int, n_instances: int) -> np.ndarray:
    """Deterministic strided shard of [0, n_items) for this worker."""
    worker = instance_idx * n_producers + (producer_idx - 1)
    total = n_instances * n_producers
    return np.arange(worker % total, n_items, total)


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
