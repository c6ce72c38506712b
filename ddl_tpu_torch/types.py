"""Shared types (port of ``ddl_tpu/types.py``).

The control plane carries replay requests and shard adoptions inside
acked envelopes (:mod:`ddl_tpu_torch.transport.envelope`); producers
send acks and observability reports back.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import TYPE_CHECKING, Any, Optional, Sequence

import numpy as np

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
    process), PROCESS (spawned processes over shared-memory rings) or
    MULTIHOST (PROCESS producers under each consumer process of a
    ``torch.distributed`` group; the instances are the group's ranks)."""

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
    #: The slot's wire dtype (ddl_tpu_torch.wire): the consumer decodes
    #: an encoded producer's windows at its edge.
    wire_dtype: str = "raw"


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
class ShardAdoption:
    """Consumer → producer: adopt shard ``ranges`` as of cluster view
    ``view_epoch`` (cross-host elastic recovery,
    :mod:`ddl_tpu_torch.cluster`).

    Sent when a view change re-partitions a dead host's shard range
    across the survivors.  ``ranges`` is the receiving producer's
    HOST-level range list (half-open ``(start, stop)`` shard-index
    pairs); ``peer_idx``/``n_peers`` locate the producer among its
    host's loader ranks, so a host of several producers can subdivide.
    ``suspend_exchange``: ``True`` degrades the cross-instance shuffle to
    node-local until rejoin, ``False`` resumes it, ``None`` leaves it
    alone.  The producer ignores a ``view_epoch`` at or below the last
    one it applied.
    """

    ranges: tuple
    view_epoch: int
    peer_idx: int = 0
    n_peers: int = 1
    suspend_exchange: Optional[bool] = None


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


@dataclasses.dataclass
class ObsReport:
    """Producer → consumer: one cross-process observability report
    (:mod:`ddl_tpu_torch.obs.aggregate`), on the control channel the
    acks ride.  ``snapshot`` is the producer registry's CUMULATIVE
    ``Metrics.snapshot()`` (the consumer's merge replaces, so it cannot
    double-count), ``hists`` its ``Metrics.hist_state()``, ``spans`` the
    armed span log's events since the last report (empty when tracing is
    disarmed).  ``report_idx`` is monotone per producer incarnation: the
    consumer drops stale reports.  ``view_epoch`` is the last cluster
    view epoch the producer applied (-1 before any adoption)."""

    producer_idx: int
    report_idx: int
    pid: int
    snapshot: dict
    hists: dict = dataclasses.field(default_factory=dict)
    spans: list = dataclasses.field(default_factory=list)
    view_epoch: int = 0


#: The control-channel protocol, per direction.  The consumer's ABORT
#: broadcast is a ``str`` sentinel (``env.ABORT``), outside these tuples.
CONSUMER_TO_PRODUCER_CONTROL = (ReplayRequest, ShardAdoption, ControlEnvelope)
PRODUCER_TO_CONSUMER_CONTROL = (ObsReport, ControlAck)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Process/worker topology: ``n_producers`` workers per consumer."""

    n_instances: int = 1
    instance_idx: int = 0
    n_producers: int = 2
    mode: RunMode = RunMode.THREAD
    #: Physical host identity: with several consumer processes a host,
    #: ``instance_idx`` over-counts hosts (``env.detect_host_identity``).
    host_id: int = 0
    n_hosts: int = 1

    def __post_init__(self) -> None:
        if self.n_instances < 1 or self.n_producers < 1:
            raise ValueError(
                f"need >=1 instance and >=1 producer, got "
                f"{self.n_instances=} {self.n_producers=}"
            )
        if not (0 <= self.instance_idx < self.n_instances):
            raise ValueError(f"{self.instance_idx=} out of range")
        if self.n_hosts < 1 or not (0 <= self.host_id < self.n_hosts):
            raise ValueError(
                f"{self.host_id=} out of range for {self.n_hosts=}"
            )

    @property
    def world_size(self) -> int:
        """Total worker count: ``1 + n_producers`` per instance."""
        return self.n_instances * (self.n_producers + 1)


@dataclasses.dataclass
class DDL_Env:
    """Per-run environment handed to the user's decorated main."""

    topology: Topology
    connection: Any  # ddl_tpu_torch.transport.ConsumerConnection
    workers: Any = None  # ddl_tpu_torch.env.WorkerSet

    @property
    def is_consumer(self) -> bool:
        return True  # the decorated main only ever runs on consumers


@dataclasses.dataclass
class WindowSpec:
    """Geometry of one producer's window (one ring slot payload):
    ``shape`` is (n_data, n_values), rows are samples and the columns
    re-split by ``splits``."""

    shape: tuple[int, ...]
    dtype: np.dtype
    splits: tuple[int, ...]
    batch_size: int

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * np.dtype(self.dtype).itemsize

    @property
    def batches_per_window(self) -> int:
        return int(self.shape[0]) // self.batch_size


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

