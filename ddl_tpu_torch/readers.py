"""Producer-function library (port of ``ddl_tpu/readers.py``:
:class:`TokenStreamProducer` only; the other readers are later slices).
"""

from __future__ import annotations

from typing import Any

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


class TokenStreamProducer(ProducerFunctionSkeleton):
    """Serve fixed-length token sequences from a flat token array on disk.

    A memory-mapped 1-D token file; each window is ``window_rows``
    sequences of ``seq_len`` tokens drawn (seeded, per worker) from this
    worker's strided region.  Output splits are ``(seq_len,)``.  Draws
    and bytes equal the JAX package's reader for the same file and seed.
    """

    #: Row-wise full rewrite per refill — live-slot safe.
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
