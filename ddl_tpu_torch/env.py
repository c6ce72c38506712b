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

A dead or hung producer is replaced in place by :meth:`WorkerSet.respawn`
(the watchdog calls it): the replacement attaches the surviving ring and
rejoins at its predecessor's position.  A ``shuffler_factory`` crosses
the spawn boundary by pickle, with the producer function.

- MULTIHOST mode: each consumer process of a ``torch.distributed`` group
  (gloo, initialised by the user's main) runs PROCESS producers of its
  own; ``n_instances`` / ``instance_idx`` are the group's world size and
  rank (the JAX package reads ``jax.process_count``/``process_index``
  after ``jax.distributed.initialize``).  Producers never join the group.
  Without an initialised group a MULTIHOST run is one instance, as
  ``jax.process_count()`` is 1 without ``jax.distributed``.  Host
  identity (several consumer processes may share a host) comes from
  :func:`detect_host_identity`.

Every ``DDL_TORCH_*`` knob a spawned producer reads (ring, integrity,
in-place fill, the wire, the shard cache, the fault plan in
``DDL_TORCH_FAULT_PLAN``, host identity, the device shuffle) reaches it
through the environment it inherits.  The ``LoaderConfig`` fields a
producer needs are exported there before the spawn
(:func:`export_wire_knobs`, :func:`export_cache_knobs`,
:func:`export_cluster_knobs`, :func:`export_shuffle_knobs`,
:func:`export_tune_knobs`).
"""

from __future__ import annotations

import functools
import logging
import os
import pickle
import threading
from typing import Any, Callable, List, Optional, Tuple

from ddl_tpu_torch import envspec
from ddl_tpu_torch.exceptions import ShutdownRequested, TransportError
from ddl_tpu_torch.faults import fault_point
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


#: Wire env vars THIS process exported from a config (never user-set ones).
_exported_wire_vars: set = set()


def export_wire_knobs(config: Any) -> None:
    """Mirror a ``LoaderConfig``'s ``wire_dtype`` / ``wire_codec`` into
    ``DDL_TORCH_WIRE_DTYPE`` / ``DDL_TORCH_WIRE_CODEC`` before producers
    start: a spawned producer resolves its wire from the environment it
    inherits, and producer and consumer must agree on the slot layout.
    An empty field states no opinion: it leaves a user's environment
    alone and clears only this process's earlier export."""
    for var, value in (("DDL_TORCH_WIRE_DTYPE", config.wire_dtype),
                       ("DDL_TORCH_WIRE_CODEC", config.wire_codec)):
        if value:
            os.environ[var] = str(value)
            _exported_wire_vars.add(var)
        elif var in _exported_wire_vars:
            os.environ.pop(var, None)
            _exported_wire_vars.discard(var)


def export_cache_knobs(config: Any) -> None:
    """Mirror a ``LoaderConfig``'s shard-cache fields into the
    ``DDL_TORCH_CACHE*`` environment before producers start: the store is
    per process, and a spawned producer builds its own from the
    environment it inherits.

    The config wins over the environment both ways: ``cache=False``
    exports the gate off (where the environment set it), and a cache-on
    config with no spill dir (or no codec) clears a stale one.
    ``config=None`` states no opinion and leaves the environment alone.
    """
    if config is None:
        return
    if not config.cache:
        if "DDL_TORCH_CACHE" in os.environ:
            os.environ["DDL_TORCH_CACHE"] = "0"
        return
    os.environ["DDL_TORCH_CACHE"] = "1"
    os.environ["DDL_TORCH_CACHE_RAM_MB"] = str(config.cache_ram_mb)
    os.environ["DDL_TORCH_CACHE_SPILL_MB"] = str(config.cache_spill_mb)
    os.environ["DDL_TORCH_CACHE_WARM"] = "1" if config.cache_warm else "0"
    if config.cache_spill_dir:
        os.environ["DDL_TORCH_CACHE_SPILL_DIR"] = config.cache_spill_dir
    else:
        os.environ.pop("DDL_TORCH_CACHE_SPILL_DIR", None)
    if config.cache_codec:
        os.environ["DDL_TORCH_CACHE_CODEC"] = config.cache_codec
    else:
        os.environ.pop("DDL_TORCH_CACHE_CODEC", None)


#: Host-identity env vars THIS process exported from a config.
_exported_cluster_vars: set = set()


def export_cluster_knobs(config: Any) -> None:
    """Mirror a ``LoaderConfig``'s ``host_id`` / ``n_hosts`` /
    ``procs_per_host`` into ``DDL_TORCH_HOST_ID`` / ``_N_HOSTS`` /
    ``_PROCS_PER_HOST`` before producers spawn: spawned workers re-derive
    host identity from the environment they inherit.  Sentinel values
    (-1/0 = auto) leave a user's environment alone and clear only this
    process's earlier export."""
    if config is None:
        return
    for var, value, has_opinion in (
        ("DDL_TORCH_HOST_ID", config.host_id, config.host_id >= 0),
        ("DDL_TORCH_N_HOSTS", config.n_hosts, config.n_hosts > 0),
        ("DDL_TORCH_PROCS_PER_HOST", config.procs_per_host,
         config.procs_per_host > 0),
    ):
        if has_opinion:
            os.environ[var] = str(value)
            _exported_cluster_vars.add(var)
        elif var in _exported_cluster_vars:
            os.environ.pop(var, None)
            _exported_cluster_vars.discard(var)


#: Device-shuffle env vars THIS process exported from a config.
_exported_shuffle_vars: set = set()


def export_shuffle_knobs(config: Any) -> None:
    """Mirror a ``LoaderConfig``'s ``device_shuffle`` / ``shuffle_impl``
    into ``DDL_TORCH_DEVICE_SHUFFLE`` / ``DDL_TORCH_SHUFFLE_IMPL`` before
    producers start (the fabric reads the route from there).  Default
    values ("auto"/"ring") clear only this process's earlier export."""
    if config is None:
        return
    for var, value, default in (
        ("DDL_TORCH_DEVICE_SHUFFLE", config.device_shuffle, "auto"),
        ("DDL_TORCH_SHUFFLE_IMPL", config.shuffle_impl, "ring"),
    ):
        if value and str(value) != default:
            os.environ[var] = str(value)
            _exported_shuffle_vars.add(var)
        elif var in _exported_shuffle_vars:
            os.environ.pop(var, None)
            _exported_shuffle_vars.discard(var)


#: Tuning env vars THIS process exported from a config.
_exported_tune_vars: set = set()


def export_tune_knobs(config: Any) -> None:
    """Mirror a ``LoaderConfig``'s ``prefetch_depth`` into
    ``DDL_TORCH_PREFETCH_DEPTH`` (the seam every tuned call site reads),
    so a :class:`~ddl_tpu_torch.tune.TunedConfig` overlay applied before
    the loader is built reaches PROCESS workers too.  The default (2)
    clears only this process's earlier export."""
    if config is None:
        return
    for var, value, default in (
        ("DDL_TORCH_PREFETCH_DEPTH", getattr(config, "prefetch_depth", 2), 2),
    ):
        if value is not None and int(value) != default:
            os.environ[var] = str(value)
            _exported_tune_vars.add(var)
        elif var in _exported_tune_vars:
            os.environ.pop(var, None)
            _exported_tune_vars.discard(var)


def detect_host_identity(
    n_instances: int = 1,
    instance_idx: int = 0,
    host_id: Optional[int] = None,
    n_hosts: Optional[int] = None,
) -> Tuple[int, int]:
    """``(host_id, n_hosts)`` for this consumer process — the JAX
    package's resolution order, later layers only filling gaps:

    1. explicit arguments (``LoaderConfig.host_id`` / ``n_hosts``),
    2. ``DDL_TORCH_HOST_ID`` / ``DDL_TORCH_N_HOSTS``,
    3. SLURM node identity (``SLURM_NODEID`` / ``SLURM_NNODES``: per
       node, so co-located tasks agree),
    4. processes-per-host arithmetic over the process grid
       (``DDL_TORCH_PROCS_PER_HOST``, else ``SLURM_NTASKS_PER_NODE``,
       else 1: host == instance).

    An id at or past the resolved count widens the count to cover it.
    """
    def _env_int(name: str) -> Optional[int]:
        value = (envspec.raw(name) if name.startswith("DDL_TORCH_")
                 else os.environ.get(name))
        return int(value) if value not in (None, "") else None

    if host_id is None:
        host_id = _env_int("DDL_TORCH_HOST_ID")
    if n_hosts is None:
        n_hosts = _env_int("DDL_TORCH_N_HOSTS")
    if host_id is None and n_hosts is None:
        slurm_node = _env_int("SLURM_NODEID")
        slurm_nodes = _env_int("SLURM_NNODES")
        if slurm_node is not None and slurm_nodes is not None:
            host_id, n_hosts = slurm_node, slurm_nodes
    if host_id is None or n_hosts is None:
        pph = (_env_int("DDL_TORCH_PROCS_PER_HOST")
               or _env_int("SLURM_NTASKS_PER_NODE") or 1)
        pph = max(1, pph)
        if n_hosts is None:
            n_hosts = max(1, (n_instances + pph - 1) // pph)
        if host_id is None:
            host_id = min(instance_idx // pph, n_hosts - 1)
    if host_id >= n_hosts:
        n_hosts = host_id + 1
    return int(host_id), int(n_hosts)


def detect_topology(
    n_producers: Optional[int] = None,
    mode: Optional[RunMode | str] = None,
    host_id: Optional[int] = None,
    n_hosts: Optional[int] = None,
) -> Topology:
    """Build the topology from args + ``DDL_TORCH_*`` environment.
    MULTIHOST takes ``n_instances`` / ``instance_idx`` from the
    initialised ``torch.distributed`` group (1 / 0 without one); the
    single-host modes are one instance.  Host identity comes from
    :func:`detect_host_identity`."""
    if mode is None:
        mode = envspec.get("DDL_TORCH_MODE")
    mode = RunMode(mode) if not isinstance(mode, RunMode) else mode
    if n_producers is None:
        n_producers = envspec.get("DDL_TORCH_N_PRODUCERS")
    if mode is RunMode.MULTIHOST:
        from ddl_tpu_torch.parallel.mesh import process_count, process_rank

        n_instances, instance_idx = process_count(), process_rank()
    else:
        n_instances, instance_idx = 1, 0
    host_id, n_hosts = detect_host_identity(
        n_instances, instance_idx, host_id=host_id, n_hosts=n_hosts)
    return Topology(n_instances=n_instances, instance_idx=instance_idx,
                    n_producers=n_producers, mode=mode, host_id=host_id,
                    n_hosts=n_hosts)


def _producer_main(
    conn: ProducerConnection, topology: Topology, producer_idx: int,
    nslots: int, shuffler_factory: Any = None, rejoin_ring: Any = None,
) -> None:
    """Body of one producer worker (thread or process)."""
    from ddl_tpu_torch.datapusher import DataPusher

    try:
        # Fault site: a crash here ships to the consumer, which fails
        # fast with a typed error instead of waiting out its timeout.
        fault_point("producer.handshake", producer_idx=producer_idx)
        pusher = DataPusher(conn, topology, producer_idx, nslots=nslots,
                            shuffler_factory=shuffler_factory,
                            rejoin_ring=rejoin_ring)
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
        # A crash in the user's refill loop: log it and leave it to the
        # watchdog — a dead thread, or a process's nonzero exit code.
        logger.exception("producer %d crashed in the push loop", producer_idx)
        if conn.cross_process:
            raise SystemExit(1)


def _process_entry(pipe_end: Any, topology: Topology, producer_idx: int,
                   nslots: int, shuffler_factory: Any = None,
                   rejoin_ring: Any = None) -> None:
    """Top-level spawn target (importable, so it pickles by name)."""
    conn = ProducerConnection(PipeChannel(pipe_end), producer_idx,
                              cross_process=True)
    _producer_main(conn, topology, producer_idx, nslots, shuffler_factory,
                   rejoin_ring)


class WorkerSet:
    """The producer workers (threads or spawned processes) + the
    consumer-side connection."""

    def __init__(self, topology: Topology, nslots: int,
                 pin_memory: bool = False, shuffler_factory: Any = None):
        self.topology = topology
        self.nslots = nslots
        self.pin_memory = pin_memory
        self.shuffler_factory = shuffler_factory
        self.threads: List[threading.Thread] = []
        # Each thread producer's connection, whose ``retired`` flag ends
        # a hung producer's abort-observing wait.
        self._thread_conns: dict = {}
        self.processes: List[Any] = []
        #: Each spawned process's exit code, filled in by :meth:`join`.
        self.exitcodes: List[Optional[int]] = []
        channels = []
        for idx in range(topology.n_producers):
            if topology.mode is not RunMode.THREAD:
                ch, p = self._spawn_process(idx + 1)
                self.processes.append(p)
            else:
                ch, t = self._spawn_thread(idx + 1)
                self.threads.append(t)
            channels.append(ch)
        self.connection = ConsumerConnection(channels)

    # The one worker recipe, shared by __init__ and respawn, so the rarely
    # run recovery path cannot drift from the normal start.

    def _spawn_thread(self, producer_idx: int, rejoin_ring: Any = None):
        consumer_end, producer_end = ThreadChannel.pair()
        conn = ProducerConnection(producer_end, producer_idx,
                                  pin_memory=self.pin_memory)
        self._thread_conns[producer_idx] = conn
        t = threading.Thread(
            target=_producer_main,
            args=(conn, self.topology, producer_idx, self.nslots,
                  self.shuffler_factory, rejoin_ring),
            name=f"ddl-torch-producer-{producer_idx}"
            + ("-respawn" if rejoin_ring is not None else ""),
            daemon=True,
        )
        t.start()
        return consumer_end, t

    def _spawn_process(self, producer_idx: int, rejoin_ring: Any = None):
        import multiprocessing as mp

        # spawn, never fork: the consumer may have CUDA initialised.  The
        # shuffler factory crosses by pickle, like the producer function.
        ctx = mp.get_context("spawn")
        parent_end, child_end = ctx.Pipe(duplex=True)
        p = ctx.Process(
            target=_process_entry,
            args=(child_end, self.topology, producer_idx, self.nslots,
                  self.shuffler_factory, rejoin_ring),
            name=f"ddl-torch-producer-{producer_idx}"
            + ("-respawn" if rejoin_ring is not None else ""),
            daemon=True,
        )
        p.start()
        # Close the parent's copy of the child end, so a dead producer
        # surfaces as EOF on the channel, not a timeout.
        child_end.close()
        return PipeChannel(parent_end), p

    def respawn(self, producer_idx: int) -> None:
        """Replace a dead or hung producer with a fresh worker that
        rejoins the surviving ring: it re-handshakes over a new channel,
        attaches its predecessor's ring and fast-forwards to the position
        the ring records.  The consumer's drain sees only the stall.  A
        hung process is terminated, then killed.  A live thread is retired
        (its connection's ``retired`` flag ends a wait that observes an
        abort, such as an injected hang) and joined; one that does not
        exit cannot be replaced (a second producer on one SPSC ring would
        corrupt it).  The JAX package refuses every live thread; retiring
        one is what lets a THREAD run recover from a hang."""
        i = producer_idx - 1
        if not 0 <= i < self.topology.n_producers:
            raise ValueError(f"no producer {producer_idx}")
        replies = self.connection.replies
        ring_ref = replies[i].ring_ref if i < len(replies) else None
        if ring_ref is None:
            raise TransportError(
                f"producer {producer_idx} never completed its first "
                "handshake; nothing to rejoin")
        if self.topology.mode is not RunMode.THREAD:
            old = self.processes[i]
            if old.is_alive():  # hung rather than dead: replace it
                old.terminate()
                old.join(10)
                if old.is_alive():
                    old.kill()
                    old.join(10)
                if old.is_alive():
                    raise TransportError(
                        f"producer process {producer_idx} survived SIGKILL; "
                        "cannot safely attach a replacement")
            new_ch, p = self._spawn_process(producer_idx, rejoin_ring=ring_ref)
            self.processes[i] = p
        else:
            old = self.threads[i]
            if old.is_alive():
                self._thread_conns[producer_idx].retired.set()
                old.join(10)
            if old.is_alive():
                raise TransportError(
                    f"producer thread {producer_idx} is still alive; only "
                    "dead or retirable thread producers can be respawned")
            new_ch, t = self._spawn_thread(producer_idx, rejoin_ring=ring_ref)
            self.threads[i] = t
        self.connection.rejoin_producer(producer_idx, new_ch)
        logger.info("respawned producer %d", producer_idx)

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
    config: Any = None,
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
    global-shuffle hook, e.g. ``ThreadExchangeShuffler.factory(...)``); in
    PROCESS mode it is pickled to each child, so its rendezvous must be a
    ``ShmRendezvous``.  PROCESS mode spawns: call the decorated main under
    ``if __name__ == "__main__":``.

    ``config`` (a :class:`~ddl_tpu_torch.config.LoaderConfig`) supplies
    the topology's defaults (explicit arguments win) and has its wire and
    shard-cache fields exported to the environment before the producers
    start (:func:`export_wire_knobs`, :func:`export_cache_knobs`).
    """
    host_id = n_hosts = None
    if config is not None:
        config.check_ported()
        n_producers = config.n_producers if n_producers is None else n_producers
        mode = config.mode if mode is None else mode
        nslots = config.nslots if nslots is None else nslots
        # Sentinels (-1/0) mean auto-detect; explicit values win.
        host_id = config.host_id if config.host_id >= 0 else None
        n_hosts = config.n_hosts if config.n_hosts > 0 else None

    def deco(f: Callable[..., Any]) -> Callable[..., Any]:
        @functools.wraps(f)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            export_cluster_knobs(config)
            topology = detect_topology(n_producers, mode, host_id, n_hosts)
            depth = nslots or envspec.get("DDL_TORCH_NSLOTS")
            if config is not None:
                export_cache_knobs(config)
                export_wire_knobs(config)
                export_shuffle_knobs(config)
                export_tune_knobs(config)
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
                "ddl_tpu_torch: %s mode, %d producer(s), instance %d/%d, "
                "%d slot(s)", topology.mode.value, topology.n_producers,
                topology.instance_idx, topology.n_instances, depth,
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
