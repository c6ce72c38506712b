"""Run configuration (the slice's subset of ``ddl_tpu/config.py``).

``LoaderConfig`` keeps the fields the THREAD-mode window-stream path
reads; ``TrainConfig`` the one training field the slice's ``Trainer``
reads.  The other fields of the JAX package (cache, wire, shuffle,
host identity, remat, pipeline and distributed-optimizer knobs) belong
to later slices.
"""

from __future__ import annotations

import dataclasses

from ddl_tpu_torch.types import RunMode


@dataclasses.dataclass
class LoaderConfig:
    """Everything the pipeline needs, in one place."""

    # topology
    mode: str = RunMode.THREAD.value
    n_producers: int = 2
    nslots: int = 2
    # batch geometry
    batch_size: int = 32
    n_epochs: int = 1
    # zero-copy window streaming (Trainer.fit window_stream)
    window_stream: bool = False
    # failure detection
    ring_timeout_s: float = 300.0
    # device transfers kept in flight by the batch prefetcher
    prefetch_depth: int = 2


@dataclasses.dataclass
class TrainConfig:
    """Training hot-path knobs the slice reads."""

    #: Gradient-accumulation microbatches per optimizer update.
    accum_steps: int = 1
