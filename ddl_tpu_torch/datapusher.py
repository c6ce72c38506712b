"""Producer runtime: the worker-side window-fill loop (port of
``ddl_tpu/datapusher.py``: handshake, first fill, then fill → stamp →
commit until shutdown).

The window the user fills (``my_ary``) is either a private array whose
committed copy lands in the next free ring slot, or — for producers that
set ``inplace_fill`` or advertise ``supports_inplace_fill`` — a view of
the next free slot itself (write-once fill: acquire before fill, trailer
stamped strictly after it).

The pusher runs in a producer thread (THREAD mode) or in a spawned
producer process (PROCESS mode), where the slots are those of the
shared-memory ring it created; it never touches CUDA.  On the way out it
closes its end of the connection, unlinking the ring's name after a
clean shutdown (the consumer keeps its own mapping).

With a ``shuffler_factory`` and several instances, each refill first runs
the cross-instance exchange (``global_shuffle``) on the private array,
then the user's ``execute_function``.

Recovery: a respawned pusher (``rejoin_ring=``) attaches the ring its
predecessor left and fast-forwards its producer function to the logical
position in the last committed slot's trailer; with a shuffler it also
restores ``my_ary`` from that slot and re-enters the exchange schedule.
A :class:`~ddl_tpu_torch.types.ReplayRequest` from the consumer rewinds
the stream to a quarantined window.  Wire encoding and cross-process
observability are later slices.
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional

import numpy as np

from ddl_tpu_torch import envspec, integrity
from ddl_tpu_torch.datasetwrapper import DataProducerOnInitReturn
from ddl_tpu_torch.exceptions import DoesNotMatchError, ShutdownRequested
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
from ddl_tpu_torch.transport.connection import NOTHING, ProducerConnection
from ddl_tpu_torch.transport.envelope import EnvelopeReceiver
from ddl_tpu_torch.types import (
    ControlEnvelope,
    MetaData_Consumer_To_Producer,
    MetaData_Producer_To_Consumer,
    ReplayRequest,
    RunMode,
    Topology,
    normalize_splits,
)
from ddl_tpu_torch.utils import execute_callbacks

logger = logging.getLogger("ddl_tpu_torch")

#: Default ring depth. 2 = double buffering.
DEFAULT_NSLOTS = 2


def inplace_enabled(override: Optional[bool] = None) -> bool:
    """The ``DDL_TORCH_INPLACE`` gate (default ON): producers that
    advertise ``supports_inplace_fill`` write straight into ring slots."""
    return envspec.flag("DDL_TORCH_INPLACE", override)


class DataPusher:
    """One producer worker: handshake, then fill windows until shutdown."""

    def __init__(
        self,
        connection: ProducerConnection,
        topology: Topology,
        producer_idx: int,
        nslots: int = DEFAULT_NSLOTS,
        metrics: Optional[Metrics] = None,
        shuffler_factory: Any = None,
        rejoin_ring: Any = None,
    ):
        """``rejoin_ring`` (elastic recovery): attach a predecessor's
        surviving ring (shm name or in-process ring) instead of creating
        one, and fast-forward the producer function to where the ring's
        last committed window left it."""
        self.connection = connection
        self.topology = topology
        self.producer_idx = producer_idx
        self.nslots = nslots
        self.metrics = metrics or default_metrics()
        self._iteration = 0
        self._integrity = integrity.integrity_enabled()
        # Acked control envelopes: dedup, fencing, and an ack per
        # envelope so the consumer's retries end.
        self._envelope_rx = EnvelopeReceiver(producer_idx=producer_idx)

        meta: MetaData_Consumer_To_Producer = connection.recv_metadata_as_producer()
        self.batch_size = meta.batch_size
        # The user's producer function is callbacks[0].
        self.callbacks: List[Any] = [meta.data_producer_function]
        init_ret = execute_callbacks(
            self.callbacks,
            "on_init",
            producer_idx=producer_idx,
            n_producers=topology.n_producers,
            instance_idx=topology.instance_idx,
            n_instances=topology.n_instances,
            batch_size=meta.batch_size,
        )
        if not isinstance(init_ret, DataProducerOnInitReturn):
            raise DoesNotMatchError(
                init_ret, "on_init must return DataProducerOnInitReturn"
            )
        self.shape = tuple(int(s) for s in init_ret.shape)
        self.dtype = np.dtype(init_ret.dtype)
        self.splits = normalize_splits(init_ret.splits, init_ret.nValues)
        if self.shape[0] != init_ret.nData:
            raise DoesNotMatchError(
                self.shape, f"shape[0] must equal nData={init_ret.nData}"
            )
        self.batches_per_window = init_ret.nData // meta.batch_size
        if self.batches_per_window < 1:
            raise DoesNotMatchError(
                meta.batch_size,
                f"batch_size {meta.batch_size} exceeds window nData "
                f"{init_ret.nData}",
            )
        self.window_nbytes = int(np.prod(self.shape)) * self.dtype.itemsize

        fn = meta.data_producer_function
        forced_inplace = bool(getattr(fn, "inplace_fill", False))

        # Global shuffler: an extra callback when the topology and the
        # consumer's handshake ask for one.
        self.shuffler = None
        if (
            topology.n_instances > 1
            and meta.global_shuffle_fraction_exchange > 0.0
            and shuffler_factory is not None
        ):
            num_exchange = int(
                init_ret.nData * meta.global_shuffle_fraction_exchange
            )
            if num_exchange > 0:
                if forced_inplace:
                    # The exchange would work on nslots-stale slot content
                    # and the required full rewrite would then destroy it.
                    raise DoesNotMatchError(
                        type(fn).__name__,
                        "global shuffle is incompatible with inplace_fill "
                        "producers (the exchange needs a persistent my_ary; "
                        "use the default copy fill)",
                    )
                self.shuffler = shuffler_factory(
                    topology=topology,
                    producer_idx=producer_idx,
                    num_exchange=num_exchange,
                    exchange_method=meta.exchange_method,
                )
                # Degradation events land in THIS pipeline's registry
                # (factories stay picklable, so it is injected here).
                if hasattr(self.shuffler, "metrics"):
                    self.shuffler.metrics = self.metrics
                if rejoin_ring is not None and not (
                    getattr(self.shuffler, "supports_elastic_replay", False)
                    and callable(getattr(self.shuffler, "rejoin", None))
                ):
                    # Rejoining a live exchange needs a fabric that retains
                    # consumed boxes and a rejoin(round) re-entry; anything
                    # else would strand the replayed take until timeout.
                    raise DoesNotMatchError(
                        type(self.shuffler).__name__,
                        "elastic respawn with global shuffle needs a "
                        "replay-capable shuffler (consumed-box retention + "
                        "a rejoin(round) re-entry method); this one does "
                        "not advertise supports_elastic_replay / rejoin",
                    )
                span = getattr(self.shuffler, "span", None)
                if topology.mode is RunMode.MULTIHOST and span in (
                        "thread", "process"):
                    raise DoesNotMatchError(
                        span,
                        "host-side global shuffle cannot span hosts "
                        "(exchange partners are other instances' producer "
                        "processes)",
                    )
                if connection.cross_process and span == "thread":
                    raise DoesNotMatchError(
                        span,
                        "an in-process Rendezvous cannot reach producers "
                        "in other processes (each process waits on its "
                        "own private board until timeout); pass "
                        "ThreadExchangeShuffler.factory(rendezvous="
                        "ShmRendezvous(session)) with a shared session "
                        "string",
                    )
                self.callbacks.append(self.shuffler)

        # Write-once producers fill ring slots directly unless a shuffler
        # needs my_ary to persist across refills (the exchange mutates it
        # between fills) or DDL_TORCH_INPLACE=0 opts out.
        self.inplace_fill = forced_inplace or (
            bool(getattr(fn, "supports_inplace_fill", False))
            and self.shuffler is None
            and inplace_enabled()
        )
        self._fill_slot: Optional[int] = None
        if not self.inplace_fill:
            # Private window the user fills; commits copy it into ring slots.
            self.my_ary = np.zeros(self.shape, dtype=self.dtype)

        # Integrity slots are one trailer larger than the payload.
        slot_bytes = self.window_nbytes + (
            integrity.HEADER_BYTES if self._integrity else 0
        )
        if rejoin_ring is not None:
            self.ring = connection.attach_ring(rejoin_ring)
            if self._integrity and self.ring.slot_bytes < slot_bytes:
                # The predecessor made the ring without trailer room: the
                # incarnations disagree on DDL_TORCH_INTEGRITY.
                raise DoesNotMatchError(
                    self.ring.slot_bytes,
                    "surviving ring has no integrity-header headroom; "
                    "respawned producer must run with the same "
                    "DDL_TORCH_INTEGRITY setting as its predecessor",
                )
            if self.shuffler is not None and self.ring.nslots < 2:
                # Checked on the attached ring's real geometry: with one
                # slot the last committed window shares the slot the
                # predecessor was filling when it died.
                raise DoesNotMatchError(
                    self.ring.nslots,
                    "elastic respawn with global shuffle needs nslots >= "
                    "2: with one slot the last committed window shares "
                    "the slot the predecessor was filling when it died, "
                    "so the state restore could read a torn fill",
                )
        else:
            self.ring = connection.create_ring(nslots, slot_bytes)
        if self.inplace_fill:
            # Zero-copy fill: the user writes straight into ring slots.
            self._fill_slot = self.ring.acquire_fill()
            self.my_ary = self._slot_array(self._fill_slot)
        connection.send_metadata(
            MetaData_Producer_To_Consumer(
                producer_idx=producer_idx,
                n_data=init_ret.nData,
                n_values=init_ret.nValues,
                shape=self.shape,
                splits=self.splits,
                batches_per_window=self.batches_per_window,
                dtype=self.dtype.name,
                integrity=self._integrity,
            )
        )
        execute_callbacks(self.callbacks, "post_init", my_ary=self.my_ary)
        if rejoin_ring is not None:
            self._rejoin()

    def _rejoin(self) -> None:
        """Replay to the predecessor's data position.  The ring's
        committed count is the number of windows published; with
        trailers, the last committed slot's seq is the exact logical
        position (after a quarantine replay the committed count includes
        the discarded re-commits)."""
        committed = int(self.ring.stats()["committed"])
        done = committed
        last = (committed - 1) % self.ring.nslots
        if self._integrity and committed:
            hdr = integrity.read_header(self.ring.slot_view(last),
                                        self.window_nbytes)
            if hdr.valid_magic:
                done = hdr.seq + 1
        if done:
            execute_callbacks(self.callbacks, "fast_forward", n=done,
                              my_ary=self.my_ary)
            if self.shuffler is not None:
                # Lanes exchanged in by peers are not locally
                # regenerable; the last committed slot holds the
                # predecessor's exact my_ary (copy fill: a shuffle forbids
                # in-place fill, and only this producer writes its slots).
                np.copyto(self.my_ary, self._slot_array(last))
        if self.shuffler is not None:
            self.shuffler.rejoin(done)
        self._iteration = done
        logger.info("producer %d: rejoined ring at window %d",
                    self.producer_idx, done)

    # -- hot loop ----------------------------------------------------------

    def _slot_array(self, slot: int) -> np.ndarray:
        return (
            self.ring.slot_view(slot)[: self.window_nbytes]
            .view(self.dtype)
            .reshape(self.shape)
        )

    def _stamp_and_commit(self, slot: int) -> None:
        """Stamp the integrity trailer (crc + seq + producer) and publish."""
        view = self.ring.slot_view(slot)
        if self._integrity:
            integrity.write_header(
                view,
                self.window_nbytes,
                seq=self._iteration,
                producer_idx=self.producer_idx,
                crc=integrity.window_crc(view[: self.window_nbytes]),
            )
        self.ring.commit(slot, self.window_nbytes)

    def _commit_window(self) -> None:
        """Publish the filled window and stage the next fill target."""
        if self.inplace_fill:
            # my_ary IS the slot: publish it, then point my_ary at the
            # next free slot for the coming refill.
            self._stamp_and_commit(self._fill_slot)
        else:
            slot = self.ring.acquire_fill()  # raises ShutdownRequested on stop
            np.copyto(self._slot_array(slot), self.my_ary)
            self._stamp_and_commit(slot)
        self.metrics.incr("producer.windows")
        self.metrics.incr("producer.bytes", self.window_nbytes)
        if self.inplace_fill:
            self._fill_slot = self.ring.acquire_fill()
            self.my_ary = self._slot_array(self._fill_slot)

    def _poll_control(self) -> None:
        """Drain pending control messages (non-blocking, once per window).

        Commands arrive in :class:`ControlEnvelope` s: each is unwrapped
        through the dedup and fencing receiver and ALWAYS acked, then a
        :class:`ReplayRequest` rewinds the stream.  The consumer's ABORT
        broadcast ends the loop like the ring flag."""
        from ddl_tpu_torch.env import ABORT

        while True:
            msg = self.connection.channel.try_recv()
            if msg is NOTHING:
                return
            if isinstance(msg, ControlEnvelope):
                payload, ack = self._envelope_rx.accept(msg)
                if ack.dup:
                    self.metrics.incr("producer.ctrl_dup_dropped")
                if ack.fence_rejected:
                    self.metrics.incr("producer.ctrl_fence_dropped")
                try:
                    self.connection.channel.send(ack)
                except (OSError, ValueError):
                    pass  # the consumer is gone mid-teardown
                if payload is None:
                    continue
                msg = payload
            if isinstance(msg, ReplayRequest):
                self._handle_replay(msg.seq)
            elif isinstance(msg, str) and msg == ABORT:
                raise ShutdownRequested("consumer abort broadcast")
            else:
                logger.warning(
                    "producer %d: ignoring unexpected control message %r",
                    self.producer_idx, type(msg).__name__,
                )

    def _handle_replay(self, seq: int) -> None:
        """Rewind the producer function to logical window ``seq`` and
        commit from there (the corrupt-slot re-request): ``on_init`` →
        ``post_init`` → ``fast_forward(seq)``, the respawn's recipe.  The
        consumer discards what was committed past ``seq`` before the
        request arrived."""
        if self.shuffler is not None:
            # Peer-exchanged lanes are not locally regenerable; the
            # consumer never asks in this configuration.
            logger.error(
                "producer %d: ignoring replay request at %d (cross-instance "
                "exchange active; stream is not locally replayable)",
                self.producer_idx, seq,
            )
            return
        seq = max(0, int(seq))
        logger.warning(
            "producer %d: replaying window stream from %d (corrupt-slot "
            "re-request; was at %d)", self.producer_idx, seq, self._iteration,
        )
        self.metrics.incr("producer.replays")
        execute_callbacks(
            self.callbacks, "on_init",
            producer_idx=self.producer_idx,
            n_producers=self.topology.n_producers,
            instance_idx=self.topology.instance_idx,
            n_instances=self.topology.n_instances,
            batch_size=self.batch_size,
        )
        execute_callbacks(self.callbacks, "post_init", my_ary=self.my_ary)
        if seq:
            execute_callbacks(self.callbacks, "fast_forward", n=seq,
                              my_ary=self.my_ary)
        self._iteration = seq

    def push_data(self) -> None:
        execute_callbacks(self.callbacks, "on_push_begin")
        clean = False
        try:
            while True:
                self._poll_control()
                if self.ring.is_shutdown():
                    raise ShutdownRequested()
                # Exchange across instances, then the user's refill.  The
                # exchange wait observes shutdown: a partner tearing down
                # may never post its half.
                execute_callbacks(
                    self.callbacks,
                    "global_shuffle",
                    my_ary=self.my_ary,
                    iteration=self._iteration,
                    should_abort=self.ring.is_shutdown,
                )
                execute_callbacks(
                    self.callbacks,
                    "execute_function",
                    my_ary=self.my_ary,
                    iteration=self._iteration,
                )
                self._commit_window()
                execute_callbacks(
                    self.callbacks, "on_shuffle_end", iteration=self._iteration
                )
                self._iteration += 1
        except ShutdownRequested:
            clean = True
            logger.debug(
                "producer %d: shutdown after %d windows",
                self.producer_idx, self._iteration,
            )
        finally:
            execute_callbacks(self.callbacks, "on_push_end")
            # A crashed producer leaves its ring's name linked, for a
            # respawned replacement to attach; the consumer's finalize
            # unlinks it if none comes.
            self.connection.finalize(unlink=clean)
