"""Shared types (the slice's subset of ``ddl_tpu/types.py``).

The control plane carries replay requests inside acked envelopes
(:mod:`ddl_tpu_torch.transport.envelope`).  Shard adoption and the
observability reports of the JAX package belong to the cluster and
observability tiers, later slices.
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
    """How producer workers are realised: THREAD (threads of the trainer
    process) or PROCESS (spawned processes over shared-memory rings).
    MULTIHOST is a later slice (ROADMAP.md)."""

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
    #: The producer's ring: the ThreadRing itself (THREAD mode) or the
    #: name of its shared-memory ring (PROCESS mode).
    ring_ref: Any = None
    #: The producer stamps checksummed trailers past each slot payload
    #: (ddl_tpu_torch.integrity); the consumer verifies at drain.
    integrity: bool = False


@dataclasses.dataclass
class ReplayRequest:
    """Consumer → producer: re-commit the window stream from ``seq``.

    Sent when drain-time integrity verification quarantines a corrupt
    slot.  The producer rewinds with the recipe a respawned producer
    uses (``on_init`` → ``post_init`` → ``fast_forward(seq)``) and
    re-commits windows ``seq, seq+1, ...``; the consumer discards the
    in-flight successors until the replayed ``seq`` arrives.
    """

    seq: int


@dataclasses.dataclass
class ControlEnvelope:
    """Consumer → producer: one sequenced, fenced, acknowledged control
    command.  ``(incarnation, seq)`` identifies the send across sender
    restarts, so the receiver suppresses duplicates while still acking
    them; ``fence`` is the sender's fencing term — a receiver that has
    seen a newer one drops the payload unapplied but acks it."""

    seq: int
    incarnation: int
    fence: int
    payload: Any


@dataclasses.dataclass
class ControlAck:
    """Producer → consumer: acknowledgement of one
    :class:`ControlEnvelope`.  ``(incarnation, seq)`` echoes the
    envelope's key; ``dup`` marks a suppressed duplicate and
    ``fence_rejected`` a payload dropped by the fencing rule — both end
    the sender's retries.  ``producer_idx`` (1-based) names the acking
    producer."""

    seq: int
    incarnation: int
    producer_idx: int = 0
    dup: bool = False
    fence_rejected: bool = False


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

