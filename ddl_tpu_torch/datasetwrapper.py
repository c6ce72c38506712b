"""User extension surface: the producer-function skeleton (port of
``ddl_tpu/datasetwrapper.py``).

Users subclass :class:`ProducerFunctionSkeleton`, override ``on_init``
(load the dataset, report geometry), ``post_init`` (write the first
window) and ``execute_function`` (refill each iteration).  Instances are
built on the consumer and deep-copied to each producer worker, so a
subclass carries no shared mutable state.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass
class DataProducerOnInitReturn:
    """Geometry a producer function reports from ``on_init``.

    ``nData`` rows (samples) per window, ``nValues`` flattened features
    per row, the full window ``shape``, the column ``splits`` the
    consumer re-splits a batch into, and the window ``dtype``.
    """

    nData: int
    nValues: int
    shape: tuple[int, ...]
    splits: tuple[int, ...]
    dtype: Any = np.float32


class ProducerFunctionSkeleton(abc.ABC):
    """Abstract producer function.

    Lifecycle inside a producer worker: ``on_init(producer_idx=...,
    n_producers=..., instance_idx=..., n_instances=...)`` →
    ``post_init(my_ary=...)`` (first window) → ``execute_function(
    my_ary=..., iteration=...)`` once per refill.

    ``inplace_fill`` forces ``my_ary`` to be a view of the next free ring
    slot (no commit copy; every call must fully rewrite it).
    ``supports_inplace_fill`` is the soft form: the pusher fills in place
    unless ``DDL_TORCH_INPLACE=0``.
    """

    inplace_fill: bool = False
    supports_inplace_fill: bool = False

    @abc.abstractmethod
    def on_init(self, **kwargs: Any) -> DataProducerOnInitReturn:
        raise NotImplementedError

    def post_init(self, **kwargs: Any) -> None:
        """Fill the first window. Default: no-op (stream-style producers)."""

    def execute_function(self, **kwargs: Any) -> None:
        """Refill/refresh the window before each handoff. Default: no-op."""

    def fast_forward(self, n: int, **kwargs: Any) -> None:
        """Advance the data position by ``n`` windows without publishing
        them.  Default: ``n`` ordinary ``execute_function`` calls."""
        for i in range(n):
            self.execute_function(iteration=i, **kwargs)
