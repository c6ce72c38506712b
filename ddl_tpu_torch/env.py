"""Topology construction and the role-bifurcating decorator (port of
``ddl_tpu/env.py``).

The decorated main runs in the trainer process and the decorator starts
the producer workers beside it:

- THREAD mode: producers are daemon threads of the trainer process, over
  in-process rings (page-locked where the consumer feeds a card).
- PROCESS mode: producers are spawned processes (``multiprocessing``'s
  ``spawn`` context), each over a shared-memory ring it creates; the
  consumer opens the ring by name and, feeding a card, page-locks it.
  Call the decorated main under ``if __name__ == "__main__":``, as spawn
  re-imports the main module.

MULTIHOST mode, respawn and elastic rejoin are later slices.  Every
``DDL_TORCH_*`` knob a spawned producer reads (ring, integrity, in-place
fill) reaches it through the environment it inherits, and no
``LoaderConfig`` field is read in a producer, so nothing needs exporting
before the spawn.
"""

from __future__ import annotations

import functools
import logging
import pickle
import threading
from typing import Any, Callable, List, Optional

from ddl_tpu_torch import envspec
from ddl_tpu_torch.exceptions import ShutdownRequested, TransportError
from ddl_tpu_torch.transport.connection import (
    ConsumerConnection,
    PipeChannel,
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
    if mode is RunMode.MULTIHOST:
        raise NotImplementedError(
            "ddl_tpu_torch runs THREAD and PROCESS modes so far, got "
            f"{mode.value!r}"
        )
    if n_producers is None:
        n_producers = envspec.get("DDL_TORCH_N_PRODUCERS")
    return Topology(n_producers=n_producers, mode=mode)


def _producer_main(
    conn: ProducerConnection, topology: Topology, producer_idx: int,
    nslots: int, shuffler_factory: Any = None,
) -> None:
    """Body of one producer worker (thread or process)."""
    from ddl_tpu_torch.datapusher import DataPusher

    try:
        pusher = DataPusher(conn, topology, producer_idx, nslots=nslots,
                            shuffler_factory=shuffler_factory)
    except (TransportError, ShutdownRequested) as e:
        # Consumer aborted before/during the handshake (ABORT arrives as
        # non-metadata) or the run is tearing down: a clean exit.
        logger.debug("producer %d: handshake ended: %s", producer_idx, e)
        conn.channel.close()
        return
    except Exception as e:
        # Handshake-time user error (bad on_init, bad geometry): ship it
        # to the consumer so it fails fast instead of timing out.
        try:
            conn.channel.send(e)
        except (pickle.PicklingError, TypeError, AttributeError):
            # Not picklable (open handles, locks): ship a surrogate that
            # carries the traceback text.
            import traceback

            conn.channel.send(TransportError(
                f"producer {producer_idx} handshake failure (original "
                f"unpicklable):\n{traceback.format_exc()}"))
        logger.exception("producer %d failed during handshake", producer_idx)
        return
    try:
        pusher.push_data()
    except Exception:
        # A crash in the user's refill loop: log it; the consumer's ring
        # wait then times out on the dead producer.  A process reports it
        # in its exit code.
        logger.exception("producer %d crashed in the push loop", producer_idx)
        if conn.cross_process:
            raise SystemExit(1)


def _process_entry(pipe_end: Any, topology: Topology, producer_idx: int,
                   nslots: int) -> None:
    """Top-level spawn target (importable, so it pickles by name)."""
    conn = ProducerConnection(PipeChannel(pipe_end), producer_idx,
                              cross_process=True)
    _producer_main(conn, topology, producer_idx, nslots)


class WorkerSet:
    """The producer workers (threads or spawned processes) + the
    consumer-side connection."""

    def __init__(self, topology: Topology, nslots: int,
                 pin_memory: bool = False, shuffler_factory: Any = None):
        self.topology = topology
        self.nslots = nslots
        self.threads: List[threading.Thread] = []
        self.processes: List[Any] = []
        #: Each spawned process's exit code, filled in by :meth:`join`.
        self.exitcodes: List[Optional[int]] = []
        channels = []
        if topology.mode is RunMode.PROCESS:
            if shuffler_factory is not None:
                raise NotImplementedError(
                    "global shuffle across producer processes needs a "
                    "shared-memory rendezvous, a later slice; use THREAD "
                    "mode"
                )
            for idx in range(topology.n_producers):
                ch, p = self._spawn_process(idx + 1)
                channels.append(ch)
                self.processes.append(p)
        else:
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

    def _spawn_process(self, producer_idx: int):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        parent_end, child_end = ctx.Pipe(duplex=True)
        p = ctx.Process(
            target=_process_entry,
            args=(child_end, self.topology, producer_idx, self.nslots),
            name=f"ddl-torch-producer-{producer_idx}",
            daemon=True,
        )
        p.start()
        # Close the parent's copy of the child end, so a dead producer
        # surfaces as EOF on the channel, not a timeout.
        child_end.close()
        return PipeChannel(parent_end), p

    def abort(self) -> None:
        """Wake producers wherever they block: the ABORT sentinel reaches
        one still in its handshake, the ring flag one in a ring wait."""
        for ch in self.connection.channels:
            try:
                ch.send(ABORT)
            except (OSError, ValueError):
                # A closed or dead producer's pipe: the case abort exists
                # for.
                pass
        self.connection.shutdown_operation()

    def join(self, timeout_s: float = 30.0) -> None:
        for t in self.threads:
            t.join(timeout_s)
        for p in self.processes:
            p.join(timeout_s)
            if p.is_alive():  # last resort
                logger.warning("producer process %s did not exit; "
                               "terminating it", p.name)
                p.terminate()
                p.join(timeout_s)
        self.exitcodes = [p.exitcode for p in self.processes]


def distributed_dataloader(
    func: Optional[Callable[..., Any]] = None,
    *,
    n_producers: Optional[int] = None,
    mode: Optional[RunMode | str] = None,
    nslots: Optional[int] = None,
    pin_memory: Optional[bool] = None,
    shuffler_factory: Any = None,
) -> Callable[..., Any]:
    """Decorator running ``func`` as the consumer with producers alongside;
    ``func`` receives a :class:`DDL_Env` as its last argument and its
    return value is returned after all producers have exited.

    Explicit arguments win over the ``DDL_TORCH_*`` environment.
    ``pin_memory`` page-locks THREAD
    rings' slots so window copies to a CUDA card run asynchronously
    (default: whenever CUDA is available); in PROCESS mode the consumer
    page-locks each shared-memory ring it attaches instead.
    ``shuffler_factory`` reaches every producer's ``DataPusher`` (the
    global-shuffle hook, e.g. ``ThreadExchangeShuffler.factory(...)``;
    THREAD mode only).  PROCESS mode spawns: call the decorated main under
    ``if __name__ == "__main__":``.
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
