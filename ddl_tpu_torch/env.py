"""Topology construction and the role-bifurcating decorator (port of
``ddl_tpu/env.py`` in THREAD mode).

The decorated main runs in the trainer process and the decorator starts
the producer workers beside it as daemon threads.  PROCESS and MULTIHOST
modes (spawned producers over a shared-memory ring) are later slices:
asking for them raises.
"""

from __future__ import annotations

import functools
import logging
import threading
from typing import Any, Callable, List, Optional

from ddl_tpu_torch import envspec
from ddl_tpu_torch.exceptions import ShutdownRequested, TransportError
from ddl_tpu_torch.transport.connection import (
    ConsumerConnection,
    ProducerConnection,
    ThreadChannel,
)
from ddl_tpu_torch.types import DDL_Env, RunMode, Topology

logger = logging.getLogger("ddl_tpu_torch")

#: Sentinel broadcast to producers when the consumer ends before or
#: during the handshake.
ABORT = "__ddl_tpu_torch_abort__"


def detect_topology(
    n_producers: Optional[int] = None,
    mode: Optional[RunMode | str] = None,
) -> Topology:
    """Build the topology from args + ``DDL_TORCH_*`` environment."""
    if mode is None:
        mode = envspec.get("DDL_TORCH_MODE")
    mode = RunMode(mode) if not isinstance(mode, RunMode) else mode
    if mode is not RunMode.THREAD:
        raise NotImplementedError(
            f"ddl_tpu_torch runs THREAD mode only so far, got {mode.value!r}"
        )
    if n_producers is None:
        n_producers = envspec.get("DDL_TORCH_N_PRODUCERS")
    return Topology(n_producers=n_producers, mode=mode)


def _producer_main(
    conn: ProducerConnection, topology: Topology, producer_idx: int,
    nslots: int, shuffler_factory: Any = None,
) -> None:
    """Body of one producer worker thread."""
    from ddl_tpu_torch.datapusher import DataPusher

    try:
        pusher = DataPusher(conn, topology, producer_idx, nslots=nslots,
                            shuffler_factory=shuffler_factory)
    except (TransportError, ShutdownRequested) as e:
        # Consumer aborted before/during the handshake (ABORT arrives as
        # non-metadata) or the run is tearing down: a clean exit.
        logger.debug("producer %d: handshake ended: %s", producer_idx, e)
        return
    except Exception as e:
        # Handshake-time user error (bad on_init, bad geometry): ship it
        # to the consumer so it fails fast instead of timing out.
        conn.channel.send(e)
        logger.exception("producer %d failed during handshake", producer_idx)
        return
    try:
        pusher.push_data()
    except Exception:
        # A crash in the user's refill loop: log it; the consumer's ring
        # wait then times out on the dead producer.
        logger.exception("producer %d crashed in the push loop", producer_idx)


class WorkerSet:
    """The producer worker threads + the consumer-side connection."""

    def __init__(self, topology: Topology, nslots: int,
                 pin_memory: bool = False, shuffler_factory: Any = None):
        self.topology = topology
        self.nslots = nslots
        self.threads: List[threading.Thread] = []
        channels = []
        for idx in range(topology.n_producers):
            consumer_end, producer_end = ThreadChannel.pair()
            conn = ProducerConnection(
                producer_end, idx + 1, pin_memory=pin_memory
            )
            t = threading.Thread(
                target=_producer_main,
                args=(conn, topology, idx + 1, nslots, shuffler_factory),
                name=f"ddl-torch-producer-{idx + 1}",
                daemon=True,
            )
            t.start()
            channels.append(consumer_end)
            self.threads.append(t)
        self.connection = ConsumerConnection(channels)

    def abort(self) -> None:
        """Wake producers wherever they block: the ABORT sentinel reaches
        one still in its handshake, the ring flag one in a ring wait."""
        for i in range(self.connection.n_producers):
            self.connection.send_control(i, ABORT)
        self.connection.shutdown_operation()

    def join(self, timeout_s: float = 30.0) -> None:
        for t in self.threads:
            t.join(timeout_s)


def distributed_dataloader(
    func: Optional[Callable[..., Any]] = None,
    *,
    n_producers: Optional[int] = None,
    mode: Optional[RunMode | str] = None,
    nslots: Optional[int] = None,
    pin_memory: Optional[bool] = None,
    shuffler_factory: Any = None,
) -> Callable[..., Any]:
    """Decorator running ``func`` as the consumer with producer threads
    alongside; ``func`` receives a :class:`DDL_Env` as its last argument
    and its return value is returned after all producers have exited.

    Explicit arguments win over the ``DDL_TORCH_*`` environment.
    ``pin_memory`` page-locks the ring slots so window copies to a CUDA
    card run asynchronously (default: whenever CUDA is available).
    ``shuffler_factory`` reaches every producer's ``DataPusher`` (the
    global-shuffle hook, e.g. ``ThreadExchangeShuffler.factory(...)``).
    """

    def deco(f: Callable[..., Any]) -> Callable[..., Any]:
        @functools.wraps(f)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            topology = detect_topology(n_producers, mode)
            depth = nslots or envspec.get("DDL_TORCH_NSLOTS")
            pin = pin_memory
            if pin is None:
                import torch

                pin = torch.cuda.is_available()
            workers = WorkerSet(topology, depth, pin_memory=pin,
                                shuffler_factory=shuffler_factory)
            env = DDL_Env(
                topology=topology, connection=workers.connection,
                workers=workers,
            )
            logger.info(
                "ddl_tpu_torch: %s mode, %d producer(s), %d slot(s)",
                topology.mode.value, topology.n_producers, depth,
            )
            try:
                return f(*args, env, **kwargs)
            finally:
                workers.abort()
                workers.join(timeout_s=30.0)

        return wrapper

    if func is not None:
        return deco(func)
    return deco
