"""Shared types (the slice's subset of ``ddl_tpu/types.py``).

The control-plane messages of the JAX package (replay requests, shard
adoption, acked envelopes, observability reports) belong to features
outside this slice and are not ported yet.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import TYPE_CHECKING, Any, Sequence

if TYPE_CHECKING:  # pragma: no cover
    from ddl_tpu_torch.datasetwrapper import ProducerFunctionSkeleton


class Marker(enum.Enum):
    """Progress markers the user reports to the dataloader:
    ``mark(END_OF_BATCH)`` after every step, ``mark(END_OF_EPOCH)`` after
    every epoch (one window of the current producer)."""

    END_OF_BATCH = 1
    END_OF_EPOCH = 2


class RunMode(enum.Enum):
    """How producer workers are realised.  The port runs THREAD mode;
    PROCESS and MULTIHOST are later slices (ROADMAP.md)."""

    THREAD = "thread"
    PROCESS = "process"
    MULTIHOST = "multihost"


@dataclasses.dataclass
class MetaData_Consumer_To_Producer:
    """Handshake payload: consumer → every producer."""

    data_producer_function: "ProducerFunctionSkeleton"
    batch_size: int
    n_epochs: int = 1
    global_shuffle_fraction_exchange: float = 0.0
    exchange_method: str = "sendrecv_replace"


@dataclasses.dataclass
class MetaData_Producer_To_Consumer:
    """Handshake payload: each producer → consumer (window geometry)."""

    producer_idx: int
    n_data: int
    n_values: int
    shape: tuple[int, ...]
    splits: tuple[int, ...]
    batches_per_window: int
    dtype: str = "float32"
    ring_ref: Any = None  # the producer's ThreadRing
    #: The producer stamps checksummed trailers past each slot payload
    #: (ddl_tpu_torch.integrity); the consumer verifies at drain.
    integrity: bool = False


@dataclasses.dataclass(frozen=True)
class Topology:
    """Process/worker topology: ``n_producers`` workers per consumer."""

    n_instances: int = 1
    instance_idx: int = 0
    n_producers: int = 2
    mode: RunMode = RunMode.THREAD

    def __post_init__(self) -> None:
        if self.n_instances < 1 or self.n_producers < 1:
            raise ValueError(
                f"need >=1 instance and >=1 producer, got "
                f"{self.n_instances=} {self.n_producers=}"
            )
        if not (0 <= self.instance_idx < self.n_instances):
            raise ValueError(f"{self.instance_idx=} out of range")


@dataclasses.dataclass
class DDL_Env:
    """Per-run environment handed to the user's decorated main."""

    topology: Topology
    connection: Any  # ddl_tpu_torch.transport.ConsumerConnection
    workers: Any = None  # ddl_tpu_torch.env.WorkerSet


def normalize_splits(splits: Sequence[int] | int, n_values: int) -> tuple[int, ...]:
    """Validate/normalise the column-split spec against the value width."""
    if isinstance(splits, int):
        splits = (splits,)
    splits = tuple(int(s) for s in splits)
    if sum(splits) != n_values:
        from ddl_tpu_torch.exceptions import DoesNotMatchError

        raise DoesNotMatchError(
            splits, f"splits must sum to n_values={n_values}, got sum={sum(splits)}"
        )
    return splits

