"""The window stream a cell's loader must serve, regenerated from its input
files and the seed, independently of the loader.

The loader takes windows from its producers in turn (producer 1, 2, ...,
1, ...), and each producer fills its windows as its reader documents;
the traffic source's module (``benchmark/sources/<source>.py``,
``windows``) regenerates one producer's windows.

A producer fills once when it starts and again before each window it
publishes, so its first fill is never served.

Windows are compared by their rows' sums of 32-bit words (the int32 view
of every value, summed in int64): any altered value, row or row order
changes them.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List

import numpy as np


def row_sums(rows: np.ndarray) -> np.ndarray:
    """(rows, features) of 4-byte values -> int64 sums of their words."""
    return rows.reshape(rows.shape[0], -1).view(np.int32).sum(
        axis=1, dtype=np.int64)


def windows(inputs: Dict[str, Any], traffic: Dict[str, Any],
            seed: int) -> Iterator[tuple]:
    """The served windows in order: (row sums, a thunk giving the window
    whole as (rows, features))."""
    from benchmark import sources

    make = sources.load(traffic["source"]).windows
    streams = [make(inputs, traffic, seed, p)
               for p in range(1, int(traffic["producers"]) + 1)]
    for s in streams:
        next(s)  # the start-up fill
    while True:
        for s in streams:
            yield next(s)


def expected(inputs: Dict[str, Any], traffic: Dict[str, Any], seed: int,
             n_windows: int, keep: int) -> tuple:
    """(row sums of the first ``n_windows`` windows, the first ``keep``
    windows whole)."""
    sums: List[np.ndarray] = []
    whole: List[np.ndarray] = []
    it = windows(inputs, traffic, seed)
    for k in range(max(n_windows, keep)):
        win_sums, win = next(it)
        if k < n_windows:
            sums.append(win_sums)
        if k < keep:
            whole.append(np.array(win()))
    return np.stack(sums) if sums else np.zeros((0, 0), np.int64), whole
