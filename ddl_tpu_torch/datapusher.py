"""Producer runtime: the worker-side window-fill loop (port of
``ddl_tpu/datapusher.py``: handshake, first fill, then fill → stamp →
commit until shutdown).

The window the user fills (``my_ary``) is either a private array whose
committed copy lands in the next free ring slot, or — for producers that
set ``inplace_fill`` or advertise ``supports_inplace_fill`` — a view of
the next free slot itself (write-once fill: acquire before fill, trailer
stamped strictly after it).

With a ``shuffler_factory`` and several instances, each refill first runs
the cross-instance exchange (``global_shuffle``) on the private array,
then the user's ``execute_function``.  Wire encoding, quarantine replay,
elastic rejoin and cross-process observability are later slices.
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
from ddl_tpu_torch.types import (
    MetaData_Consumer_To_Producer,
    MetaData_Producer_To_Consumer,
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
    ):
        self.connection = connection
        self.topology = topology
        self.producer_idx = producer_idx
        self.nslots = nslots
        self.metrics = metrics or default_metrics()
        self._iteration = 0
        self._integrity = integrity.integrity_enabled()

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
        """Drain pending control messages (non-blocking, once per window):
        the consumer's ABORT broadcast ends the loop like the ring flag."""
        from ddl_tpu_torch.env import ABORT

        while True:
            msg = self.connection.channel.try_recv()
            if msg is NOTHING:
                return
            if isinstance(msg, str) and msg == ABORT:
                raise ShutdownRequested("consumer abort broadcast")
            logger.warning(
                "producer %d: ignoring unexpected control message %r",
                self.producer_idx, type(msg).__name__,
            )

    def push_data(self) -> None:
        execute_callbacks(self.callbacks, "on_push_begin")
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
            logger.debug(
                "producer %d: shutdown after %d windows",
                self.producer_idx, self._iteration,
            )
        finally:
            execute_callbacks(self.callbacks, "on_push_end")
