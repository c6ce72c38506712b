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
the stream to a quarantined window.  A
:class:`~ddl_tpu_torch.types.ShardAdoption` (a cluster view change,
:mod:`ddl_tpu_torch.cluster`) hands the producer function its host's new
shard ranges through its ``adopt_shards`` callback and suspends or
resumes the shuffler's exchange; adoptions at or below the last applied
view epoch are dropped.

Wire format (:mod:`ddl_tpu_torch.wire`): a reader whose ``wire_dtype``
(or ``DDL_TORCH_WIRE_DTYPE``) is ``bf16`` or ``int8`` commits the encoded
payload, with int8 scales in the trailer extension and the CRC over the
encoded bytes; the consumer decodes at its edge.  The handshake refuses
a lossy wire without integrity, on a non-float window, with a forced
``inplace_fill``, or on a geometry whose encoding does not fit the slot.

Fault sites (:mod:`ddl_tpu_torch.faults`): ``producer.fill`` at the top
of each refill, ``producer.commit`` after a raw trailer stamp,
``wire.encode`` after an encoded one, ``pusher.inplace_fill`` with a
write-once slot filled but not stamped.

Observability (:mod:`ddl_tpu_torch.obs`): a ``producer.fill`` span
(exchange and refill) and a ``producer.commit`` span (the free-slot wait,
copy and stamp) per window, keyed on the trailer's ``(producer_idx,
seq)``.  The commit span is recorded BEFORE the slot is published, so a
served window's commit span is always in the log.  A PROCESS producer
ships an :class:`~ddl_tpu_torch.types.ObsReport` every
``DDL_TORCH_OBS_SHIP_EVERY`` windows and once more at shutdown.
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional

import numpy as np

from ddl_tpu_torch import envspec, integrity, wire
from ddl_tpu_torch.datasetwrapper import DataProducerOnInitReturn
from ddl_tpu_torch.exceptions import DoesNotMatchError, ShutdownRequested
from ddl_tpu_torch.faults import armed_plan, fault_point
from ddl_tpu_torch.obs import aggregate as obs_aggregate
from ddl_tpu_torch.obs import spans as obs_spans
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
from ddl_tpu_torch.transport.connection import NOTHING, ProducerConnection
from ddl_tpu_torch.transport.envelope import EnvelopeReceiver
from ddl_tpu_torch.types import (
    ControlEnvelope,
    MetaData_Consumer_To_Producer,
    MetaData_Producer_To_Consumer,
    ReplayRequest,
    RunMode,
    ShardAdoption,
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
        # Last applied cluster view epoch (the ShardAdoption fence).
        self._view_epoch = -1
        self._integrity = integrity.integrity_enabled()
        # Acked control envelopes: dedup, fencing, and an ack per
        # envelope so the consumer's retries end.
        self._envelope_rx = EnvelopeReceiver(producer_idx=producer_idx)
        # Cross-process observability: a PROCESS producer's registry is
        # its own, so it ships reports; a THREAD producer's is the
        # consumer's.
        self._obs_ship_every = (
            obs_aggregate.ship_every() if connection.cross_process else 0)
        self._obs_report_idx = 0
        # Start of the current window's commit span (obs_spans.t0()).
        self._commit_t0 = 0.0

        meta: MetaData_Consumer_To_Producer = connection.recv_metadata_as_producer()
        self.batch_size = meta.batch_size
        # The user's producer function is callbacks[0].
        self.callbacks: List[Any] = [meta.data_producer_function]
        # The job's integrity namespace (serve/jobs.py): trailer seqs are
        # stamped at seq_base + iteration.  The base rides the producer
        # function, so it crosses a spawn with it and the consumer reads
        # the same attribute.  A Python int: bases reach 2^64 - 2^32.
        self.seq_base = int(
            getattr(meta.data_producer_function, "seq_base", 0) or 0)
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
        # The wire the slot commits carry: the reader's capability, or
        # the env override.  A lossy wire needs the trailer (its scales
        # travel there) and a float window; both are refused here, at the
        # handshake, never mid-run.
        self.wire_dtype = wire.resolve_wire_dtype(
            getattr(fn, "wire_dtype", "raw"))
        if self.wire_dtype != "raw":
            if not self._integrity:
                raise DoesNotMatchError(
                    self.wire_dtype,
                    "lossy wire_dtype needs DDL_TORCH_INTEGRITY on (the "
                    "quantization scales travel in the slot trailer "
                    "extension next to the CRC)",
                )
            if not wire.lossy_supported(self.dtype):
                raise DoesNotMatchError(
                    self.dtype.name,
                    f"lossy wire_dtype {self.wire_dtype!r} needs a float "
                    "window dtype (use the lossless codec tier for "
                    "token/image shards)",
                )
            if forced_inplace:
                # The encode reads the raw window: it cannot be the slot
                # it writes.
                raise DoesNotMatchError(
                    type(fn).__name__,
                    "inplace_fill producers cannot use a lossy wire_dtype "
                    "(the encode needs the raw window as its source; use "
                    "the default copy fill or wire_dtype='raw')",
                )
        self._enc_nbytes = wire.encoded_nbytes(
            self.shape, self.dtype, self.wire_dtype)
        self._scale_nbytes = wire.scale_bytes_for(self.shape, self.wire_dtype)

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
                        "(exchange partners are other instances' "
                        "producer processes); use the trainer-side "
                        "device exchange (ddl_tpu_torch.parallel."
                        "DeviceGlobalShuffler over the instance mesh "
                        "axis) for MULTIHOST runs — the producer-side "
                        "DeviceExchangeShuffler resolves its device "
                        "tier off outside THREAD topologies",
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
        # between fills), a lossy wire needs the raw window as the
        # encode's source, or DDL_TORCH_INPLACE=0 opts out.
        self.inplace_fill = forced_inplace or (
            bool(getattr(fn, "supports_inplace_fill", False))
            and self.shuffler is None
            and self.wire_dtype == "raw"
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
        if self.wire_dtype != "raw" and (
            self._enc_nbytes + integrity.HEADER_BYTES + self._scale_nbytes
            > slot_bytes
        ):
            # int8 on a window with few values per row pays 4 scale bytes
            # per block: the encoding can outgrow the raw slot.
            raise DoesNotMatchError(
                self.shape,
                f"wire_dtype {self.wire_dtype!r} does not shrink this "
                f"window geometry (encoded {self._enc_nbytes} + trailer "
                f"{integrity.HEADER_BYTES + self._scale_nbytes} exceeds "
                f"the {slot_bytes}-byte slot); use wire_dtype='raw' for "
                "windows this narrow",
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
                wire_dtype=self.wire_dtype,
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
            # An encoded slot's trailer sits past the encoded payload.
            hdr = integrity.read_header(self.ring.slot_view(last),
                                        self._enc_nbytes)
            if hdr.valid_magic:
                done = hdr.seq - self.seq_base + 1
        if done:
            execute_callbacks(self.callbacks, "fast_forward", n=done,
                              my_ary=self.my_ary)
            if self.shuffler is not None:
                # Lanes exchanged in by peers are not locally
                # regenerable; the last committed slot holds the
                # predecessor's exact my_ary (copy fill: a shuffle forbids
                # in-place fill, and only this producer writes its slots).
                if self.wire_dtype != "raw":
                    # A lossy slot holds the decoded window, the values
                    # the consumer served: restore those.
                    view = self.ring.slot_view(last)
                    hdr = integrity.read_header(view, self._enc_nbytes)
                    wire.decode_window(
                        view[: self._enc_nbytes],
                        integrity.read_scales(view, self._enc_nbytes,
                                              hdr.scale_bytes)
                        if hdr.scale_bytes else None,
                        self.shape, self.dtype, self.wire_dtype,
                        out=self.my_ary,
                    )
                else:
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
        """Stamp the integrity trailer (crc + seq + producer) and publish.
        The ``producer.commit`` site runs after the stamp, so flipped
        bytes fail the consumer's CRC check as real corruption would."""
        view = self.ring.slot_view(slot)
        if self._integrity:
            integrity.write_header(
                view,
                self.window_nbytes,
                seq=self.seq_base + self._iteration,
                producer_idx=self.producer_idx,
                crc=integrity.window_crc(view[: self.window_nbytes]),
            )
        fault_point("producer.commit", producer_idx=self.producer_idx,
                    view=view[: self.window_nbytes])
        self._publish(slot, self.window_nbytes)

    def _encode_and_commit(self, slot: int) -> None:
        """The encoded commit: the slot carries the bf16/int8 payload, the
        scales travel in the trailer extension, and the CRC covers both —
        so wire corruption quarantines and replays as raw corruption
        does.  The ``wire.encode`` site runs after the stamp.  The byte
        counters land at the consumer's decode (the one registry every
        mode shares)."""
        view = self.ring.slot_view(slot)
        payload, scales = wire.encode_window(self.my_ary, self.wire_dtype)
        enc = self._enc_nbytes
        view[:enc] = payload
        if scales is not None:
            integrity.write_scales(view, enc, scales)
        integrity.write_header(
            view, enc,
            seq=self.seq_base + self._iteration,
            producer_idx=self.producer_idx,
            crc=integrity.wire_crc(view, enc, self._scale_nbytes),
            wire_code=wire.WIRE_CODES[self.wire_dtype],
            scale_bytes=self._scale_nbytes,
        )
        fault_point("wire.encode", producer_idx=self.producer_idx,
                    view=view[:enc])
        self._publish(slot, enc)

    def _publish(self, slot: int, nbytes: int) -> None:
        """Record the window's ``producer.commit`` span, then commit the
        slot.  The span lands first: once committed, the window can be
        served (and a trace closed) before this thread runs again."""
        obs_spans.record("producer.commit", self.producer_idx,
                         self._iteration, self._commit_t0)
        self.ring.commit(slot, nbytes)

    def _commit_window(self) -> None:
        """Publish the filled window and stage the next fill target."""
        if self.inplace_fill:
            # my_ary IS the slot: publish it, then point my_ary at the
            # next free slot for the coming refill.
            self._stamp_and_commit(self._fill_slot)
        elif self.wire_dtype != "raw":
            slot = self.ring.acquire_fill()  # raises ShutdownRequested on stop
            self._encode_and_commit(slot)
        else:
            slot = self.ring.acquire_fill()  # raises ShutdownRequested on stop
            np.copyto(self._slot_array(slot), self.my_ary)
            self._stamp_and_commit(slot)
        self.metrics.incr("producer.windows")
        self.metrics.incr("producer.bytes", self.window_nbytes)
        if self.inplace_fill:
            self._fill_slot = self.ring.acquire_fill()
            self.my_ary = self._slot_array(self._fill_slot)

    def _should_abort(self) -> bool:
        """What abort-observing waits poll: the ring's shutdown, or this
        incarnation's retirement (a hung THREAD producer being
        replaced)."""
        return self.ring.is_shutdown() or self.connection.retired.is_set()

    def _poll_control(self) -> None:
        """Drain pending control messages (non-blocking, once per window).

        Commands arrive in :class:`ControlEnvelope` s: each is unwrapped
        through the dedup and fencing receiver and ALWAYS acked, then a
        :class:`ReplayRequest` rewinds the stream and a
        :class:`ShardAdoption` re-partitions it.  The consumer's ABORT
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
            elif isinstance(msg, ShardAdoption):
                self._handle_adoption(msg)
            elif isinstance(msg, str) and msg == ABORT:
                raise ShutdownRequested("consumer abort broadcast")
            else:
                logger.warning(
                    "producer %d: ignoring unexpected control message %r",
                    self.producer_idx, type(msg).__name__,
                )

    def _handle_adoption(self, msg: ShardAdoption) -> None:
        """Apply a cluster view change: adopt the re-partitioned shard
        ranges and suspend or resume the exchange.  Epoch-fenced: a
        message at or below the last applied view epoch is dropped, so a
        slow or duplicated view-N message never undoes view N+1."""
        if msg.view_epoch <= self._view_epoch:
            logger.debug("producer %d: dropping stale adoption (epoch %d "
                         "<= %d)", self.producer_idx, msg.view_epoch,
                         self._view_epoch)
            return
        self._view_epoch = msg.view_epoch
        logger.warning(
            "producer %d: adopting shard ranges %s at view epoch %d (peer "
            "%d/%d)", self.producer_idx, msg.ranges, msg.view_epoch,
            msg.peer_idx, msg.n_peers,
        )
        self.metrics.incr("producer.shard_adoptions")
        if msg.suspend_exchange is not None and self.shuffler is not None:
            # Node-local while the exchange schedule still names a dead
            # host; resumed at the rejoin fence.
            toggle = getattr(self.shuffler, "suspend_exchange"
                             if msg.suspend_exchange else "resume_exchange",
                             None)
            if callable(toggle):
                toggle()
        execute_callbacks(
            self.callbacks, "adopt_shards",
            ranges=msg.ranges, view_epoch=msg.view_epoch,
            peer_idx=msg.peer_idx, n_peers=msg.n_peers, my_ary=self.my_ary,
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
        # The request names the namespaced seq (the consumer speaks
        # trailer seqs); the producer function's position is the rest.
        seq = max(0, int(seq) - self.seq_base)
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
                if self._should_abort():
                    raise ShutdownRequested()
                fault_point("producer.fill", producer_idx=self.producer_idx,
                            should_abort=self._should_abort)
                # Exchange across instances, then the user's refill.  The
                # exchange wait observes shutdown: a partner tearing down
                # may never post its half.
                span_t0 = obs_spans.t0()
                execute_callbacks(
                    self.callbacks,
                    "global_shuffle",
                    my_ary=self.my_ary,
                    iteration=self._iteration,
                    should_abort=self._should_abort,
                )
                execute_callbacks(
                    self.callbacks,
                    "execute_function",
                    my_ary=self.my_ary,
                    iteration=self._iteration,
                )
                obs_spans.record("producer.fill", self.producer_idx,
                                 self._iteration, span_t0)
                if self.inplace_fill and armed_plan() is not None:
                    # The write-once slot is filled but not stamped: a
                    # crash here leaves a torn slot that is never
                    # committed.  The byte view is built only while a
                    # plan is armed.
                    fault_point(
                        "pusher.inplace_fill",
                        producer_idx=self.producer_idx,
                        view=self.ring.slot_view(self._fill_slot)[
                            : self.window_nbytes],
                        should_abort=self._should_abort,
                    )
                # The commit span covers the free-slot wait too: producer
                # backpressure is what a trace of a slow consumer shows.
                self._commit_t0 = obs_spans.t0()
                self._commit_window()
                execute_callbacks(
                    self.callbacks, "on_shuffle_end", iteration=self._iteration
                )
                self._iteration += 1
                self._maybe_ship_obs()
        except ShutdownRequested:
            # A retired incarnation's ring belongs to its replacement.
            clean = not self.connection.retired.is_set()
            logger.debug(
                "producer %d: shutdown after %d windows",
                self.producer_idx, self._iteration,
            )
        finally:
            execute_callbacks(self.callbacks, "on_push_end")
            # The final report goes before the channel closes, so short
            # runs still aggregate.
            self._maybe_ship_obs(final=True)
            # A crashed producer leaves its ring's name linked, for a
            # respawned replacement to attach; the consumer's finalize
            # unlinks it if none comes.
            self.connection.finalize(unlink=clean)

    def _maybe_ship_obs(self, final: bool = False) -> None:
        """Ship one :class:`~ddl_tpu_torch.types.ObsReport` when due:
        every ``_obs_ship_every`` windows, and a ``final`` one at
        shutdown.  PROCESS producers only.  A broken channel (the
        consumer gone first) drops the report: observability never turns
        a clean shutdown into a failure."""
        every = self._obs_ship_every
        if every <= 0 or (not final and self._iteration % every):
            return
        self._obs_report_idx += 1
        report = obs_aggregate.build_report(
            self.producer_idx - 1,  # the consumer's 0-based ring index
            self._obs_report_idx, self.metrics,
            view_epoch=self._view_epoch)
        try:
            self.connection.channel.send(report)
        except (OSError, ValueError) as e:
            logger.debug("producer %d: obs report dropped (%s)",
                         self.producer_idx, e)
