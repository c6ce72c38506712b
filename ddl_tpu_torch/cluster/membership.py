"""Membership control plane: host leases, epoch-fenced view changes
(port of ``ddl_tpu/cluster/membership.py``).

The watchdog (:mod:`ddl_tpu_torch.watchdog`) detects a dead *worker*;
this module is the host-level half.  Every physical host of the run is a
:class:`HostInfo` row in a :class:`ClusterView`, its liveness a lease in
a :class:`LeaseTable` refreshed by heartbeats over whatever liveness
signal exists (worker liveness locally, an external beat feed across
hosts), and a :class:`ClusterSupervisor` sweep turns lease expiry into a
**deterministic, epoch-fenced view change**:

- *Deterministic*: the successor view is a pure function of (previous
  view, dead-host set) — :func:`view_change` — so every surviving
  consumer that observes the same failure computes the same new shard
  assignment with no coordination round.
- *Epoch-fenced*: every view carries a monotonically increasing
  ``epoch``; downstream appliers (loader pool updates, producer shard
  adoptions) ignore anything stamped with a stale epoch, so a slow
  message from view N can never undo view N+1.

A host leaves the view only when its lease expires (no beat for
``lease_s``), when a ``HOST_LOSS`` fault fires at the
``cluster.heartbeat`` site, or when :meth:`ClusterSupervisor.
declare_host_loss` is called.  A dropped beat (``HEARTBEAT_DROP``) only
ages the lease: transient heartbeat loss under the lease budget causes
no membership churn.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import (
    Any,
    Callable,
    Dict,
    FrozenSet,
    Iterable,
    List,
    Optional,
    Tuple,
)

from ddl_tpu_torch.concurrency import named_lock, named_rlock
from ddl_tpu_torch.exceptions import (
    DDLError,
    HeartbeatDropped,
    HostLostError,
    ShutdownRequested,
)
from ddl_tpu_torch.faults import fault_point
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
from ddl_tpu_torch.cluster.pool import LoaderPool

logger = logging.getLogger("ddl_tpu_torch")

#: Shard-range type: half-open ``(start, stop)`` shard-index pairs.
Ranges = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class HostInfo:
    """One physical host in the cluster view.

    ``loader_ranks`` are 1-based producer indices (the repo-wide rank
    convention: ring ``i`` belongs to producer ``i + 1``) registered as
    the LOADER pool contribution of this host; ``trainer_ranks`` are
    the consumer process indices it hosts.  The two sets are disjoint
    roles by design (MPMD-style decoupling, arXiv:2412.14374): a host
    may carry loader ranks, trainer ranks, or both, and the loader pool
    resizes without touching the trainer set.  ``cache_spill_dir`` is
    the host's shard-cache disk tier — on host loss the survivors adopt
    it for a warm start when the path is reachable (a shared
    filesystem; a host-local path simply fails adoption).
    """

    host_id: int
    loader_ranks: Tuple[int, ...] = ()
    trainer_ranks: Tuple[int, ...] = ()
    cache_spill_dir: Optional[str] = None


def partition_shards(n_shards: int, host_ids: List[int]) -> Dict[int, Ranges]:
    """Deterministic contiguous partition of ``range(n_shards)`` over
    ``host_ids`` (sorted): host k of H gets the k-th of H near-equal
    contiguous ranges.  The base assignment every view derives from —
    identical on every process by construction."""
    ids = sorted(set(host_ids))
    if not ids:
        raise DDLError("cannot partition shards over zero hosts")
    out: Dict[int, Ranges] = {}
    n = len(ids)
    base, extra = divmod(n_shards, n)
    start = 0
    for k, hid in enumerate(ids):
        size = base + (1 if k < extra else 0)
        out[hid] = ((start, start + size),) if size else ()
        start += size
    return out


@dataclasses.dataclass(frozen=True)
class ClusterView:
    """An epoch-stamped membership snapshot.

    ``hosts`` is sorted by ``host_id``; ``shard_ranges`` maps host_id →
    its range list (tuple-of-pairs, hashable).  Views are immutable —
    change happens only through :func:`view_change` / :func:`view_rejoin`
    which return a successor with ``epoch + 1``.
    """

    epoch: int
    hosts: Tuple[HostInfo, ...]
    shard_ranges: Tuple[Tuple[int, Ranges], ...]
    n_shards: int = 0

    @staticmethod
    def bootstrap(
        hosts: List[HostInfo], n_shards: int = 0, epoch: int = 0
    ) -> "ClusterView":
        """The initial view: hosts sorted, shards partitioned by the
        deterministic base assignment."""
        hosts = tuple(sorted(hosts, key=lambda h: h.host_id))
        if len({h.host_id for h in hosts}) != len(hosts):
            raise DDLError("duplicate host_id in cluster bootstrap")
        ranges = partition_shards(n_shards, [h.host_id for h in hosts])
        return ClusterView(
            epoch=epoch,
            hosts=hosts,
            shard_ranges=tuple(sorted(ranges.items())),
            n_shards=n_shards,
        )

    def host(self, host_id: int) -> Optional[HostInfo]:
        for h in self.hosts:
            if h.host_id == host_id:
                return h
        return None

    def ranges_of(self, host_id: int) -> Ranges:
        for hid, r in self.shard_ranges:
            if hid == host_id:
                return r
        return ()

    def host_of_rank(self, rank: int) -> Optional[HostInfo]:
        """The host carrying loader rank ``rank`` (1-based)."""
        for h in self.hosts:
            if rank in h.loader_ranks:
                return h
        return None

    def loader_pool(self) -> LoaderPool:
        """The loader pool this view publishes: every member host's
        loader ranks as 0-based ring targets, generation = epoch (the
        fence downstream appliers compare against)."""
        members = sorted(
            r - 1 for h in self.hosts for r in h.loader_ranks
        )
        return LoaderPool(members=tuple(members), generation=self.epoch)

    @property
    def loader_ranks(self) -> Tuple[int, ...]:
        return tuple(sorted(r for h in self.hosts for r in h.loader_ranks))

    @property
    def trainer_ranks(self) -> Tuple[int, ...]:
        return tuple(sorted(r for h in self.hosts for r in h.trainer_ranks))


def view_change(view: ClusterView, dead: FrozenSet[int]) -> ClusterView:
    """The successor view after ``dead`` hosts leave — a PURE function.

    Survivors keep their existing ranges (minimal data movement: only
    orphaned shards move); the dead hosts' range lists are dealt
    round-robin, in sorted order, onto survivors sorted by host_id.
    Every consumer computing this from the same (view, dead) pair gets
    the identical successor — the no-coordination agreement property
    the chaos tests assert.
    """
    dead = frozenset(dead)
    survivors = tuple(h for h in view.hosts if h.host_id not in dead)
    if not survivors:
        raise HostLostError(
            f"view change at epoch {view.epoch}: no surviving hosts "
            f"(dead={sorted(dead)})"
        )
    if not dead & {h.host_id for h in view.hosts}:
        return view  # nothing to do; the epoch fence must not advance
    ranges = {hid: list(r) for hid, r in view.shard_ranges if hid not in dead}
    orphaned: List[Tuple[int, int]] = []
    for hid, r in sorted(view.shard_ranges):
        if hid in dead:
            orphaned.extend(r)
    ids = sorted(h.host_id for h in survivors)
    for k, rng in enumerate(sorted(orphaned)):
        ranges.setdefault(ids[k % len(ids)], []).append(rng)
    return ClusterView(
        epoch=view.epoch + 1,
        hosts=survivors,
        shard_ranges=tuple(
            sorted((hid, tuple(sorted(r))) for hid, r in ranges.items())
        ),
        n_shards=view.n_shards,
    )


def view_rejoin(view: ClusterView, host: HostInfo) -> ClusterView:
    """The successor view after ``host`` (re)joins.

    Unlike :func:`view_change` — which moves only orphans — a rejoin
    re-partitions ALL shards from the deterministic base assignment:
    the epoch fence makes the wholesale move safe (every consumer and
    producer switches at the same fence), and it restores the balanced
    layout instead of accreting skew across loss/rejoin cycles.
    """
    if view.host(host.host_id) is not None:
        raise DDLError(f"host {host.host_id} is already in the view")
    hosts = tuple(
        sorted(view.hosts + (host,), key=lambda h: h.host_id)
    )
    ranges = partition_shards(view.n_shards, [h.host_id for h in hosts])
    return ClusterView(
        epoch=view.epoch + 1,
        hosts=hosts,
        shard_ranges=tuple(sorted(ranges.items())),
        n_shards=view.n_shards,
    )


class LeaseTable:
    """Host-id → lease-deadline map.  Thread-safe, clock-injectable.

    ``beat`` refreshes a lease; :meth:`expired` returns hosts whose
    lease lapsed.  Pure mechanism — the HEARTBEAT fault points and the
    view-change policy live in :class:`ClusterSupervisor`.
    """

    def __init__(self, lease_s: float = 5.0, clock: Callable[[], float] = time.monotonic):
        self.lease_s = float(lease_s)
        self._clock = clock
        self._lock = named_lock("cluster.membership")
        # host_id -> lease deadline; bounded by the registered host set
        # (register/release are the only growth/shrink sites).
        self._deadline: Dict[int, float] = {}

    def register(self, host_id: int, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        with self._lock:
            self._deadline[host_id] = now + self.lease_s

    def release(self, host_id: int) -> None:
        with self._lock:
            self._deadline.pop(host_id, None)

    def beat(self, host_id: int, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        with self._lock:
            if host_id in self._deadline:
                self._deadline[host_id] = now + self.lease_s

    def remaining(self, host_id: int, now: Optional[float] = None) -> float:
        now = self._clock() if now is None else now
        with self._lock:
            dl = self._deadline.get(host_id)
        return float("inf") if dl is None else dl - now

    def expired(self, now: Optional[float] = None) -> List[int]:
        now = self._clock() if now is None else now
        with self._lock:
            return sorted(
                hid for hid, dl in self._deadline.items() if now > dl
            )

    def registered(self) -> List[int]:
        with self._lock:
            return sorted(self._deadline)


class ClusterSupervisor:
    """Owns the current view + leases; sweeps liveness into view changes.

    Heartbeat *sources* are pluggable per host: any zero-arg callable
    returning truthy-while-alive (worker/process liveness via
    :func:`ddl_tpu_torch.cluster.elastic.worker_alive_source`, transport
    channels via ``ControlChannel.alive``, a shared-filesystem beat
    file, ...).  A host WITHOUT a source is beaten externally through
    :meth:`beat` (e.g. a remote host's beat arriving over DCN).

    A source returning False does NOT declare the host dead — it merely
    stops refreshing the lease, and only lease EXPIRY (or an explicit
    :meth:`declare_host_loss`, or the ``HOST_LOSS`` fault) changes the
    view.  That gap is the recovery ladder's rung separation: a crashed
    producer whose watchdog respawn lands within ``lease_s`` revives
    the source before the lease lapses, so rung 1 (respawn) never
    escalates to rung 2 (host loss) by accident.  Size ``lease_s``
    above the watchdog's respawn latency.
    """

    def __init__(
        self,
        view: ClusterView,
        lease_s: float = 5.0,
        poll_interval_s: float = 0.5,
        metrics: Optional[Metrics] = None,
        clock: Callable[[], float] = time.monotonic,
        local_host_ids: Optional[Iterable[int]] = None,
    ):
        """``local_host_ids`` names the hosts whose loader ranks are
        THIS process's ring indices (rank numbering is per process:
        every host's workers are locally ranks 1..n, so without the
        locality set a remote host's ranks would alias local ones —
        ``lost_ranks`` would then mute the watchdog for live LOCAL
        producers after a REMOTE loss).  ``None`` (default) means every
        view host is local — the single-process mock-host topologies.
        ``ElasticCluster(local_host_id=...)`` is the usual setter."""
        self.view = view
        self.local_host_ids: Optional[set] = (
            set(local_host_ids) if local_host_ids is not None else None
        )
        self.poll_interval_s = poll_interval_s
        self.metrics = metrics or default_metrics()
        self.leases = LeaseTable(lease_s, clock)
        self._clock = clock
        for h in view.hosts:
            self.leases.register(h.host_id)
        # host_id -> liveness callable: bounded by the view's host set
        # (attach_source is only ever called per member host).
        self._sources: Dict[int, Callable[[], bool]] = {}
        self._listeners: List[
            Callable[[ClusterView, ClusterView, FrozenSet[int]], None]
        ] = []
        self._rank_listeners: List[Callable[[int], None]] = []
        self._departed_hosts: List[HostInfo] = []
        self._no_survivor_logged = False
        self._lock = named_rlock("cluster.supervisor")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.metrics.set_gauge("cluster.epoch", view.epoch)
        self.metrics.set_gauge("cluster.hosts", len(view.hosts))

    # -- wiring ------------------------------------------------------------

    def attach_source(self, host_id: int, alive: Callable[[], bool]) -> None:
        self._sources[host_id] = alive

    def add_listener(
        self,
        fn: Callable[[ClusterView, ClusterView, FrozenSet[int]], None],
    ) -> None:
        """``fn(old_view, new_view, dead_ids)`` after every view change
        (``dead_ids`` empty on rejoin).  Called on the sweeping thread —
        listeners must be quick and must not block on the consumer."""
        self._listeners.append(fn)

    def add_rank_listener(self, fn: Callable[[int], None]) -> None:
        """``fn(rank)`` after a loader rank is respawned (the watchdog's
        rung-1 recovery).  The elastic ladder uses it to re-ship the
        CURRENT view's shard adoption to the fresh incarnation — an
        adoption sent while the predecessor's channel was mid-swap is
        lost, and a survivor serving stale ranges would drop shards."""
        self._rank_listeners.append(fn)

    def rank_respawned(self, rank: int) -> None:
        """Report a respawned loader rank (called by the watchdog)."""
        for fn in self._rank_listeners:
            try:
                fn(rank)
            except (ShutdownRequested, KeyboardInterrupt):
                raise
            except Exception:
                logger.exception("cluster: rank-respawn listener raised")

    def is_local(self, host_id: int) -> bool:
        return self.local_host_ids is None or host_id in self.local_host_ids

    def lost_ranks(self) -> FrozenSet[int]:
        """LOCAL loader ranks (1-based ring indices of this process) of
        hosts that have LEFT the view — the watchdog consults this so a
        departed host's dead workers are the cluster ladder's to
        handle, not respawn fodder.  Remote hosts' ranks are excluded:
        rank numbering is per process, and a remote loss must never
        mute monitoring of the identically-numbered LOCAL workers."""
        with self._lock:
            return frozenset(
                r
                for h in self._departed_hosts
                if self.is_local(h.host_id)
                for r in h.loader_ranks
            )

    # -- the sweep ---------------------------------------------------------

    def beat(self, host_id: int, now: Optional[float] = None) -> None:
        """External heartbeat feed (cross-host: the remote host's beat
        arriving over whatever control plane exists there)."""
        self.leases.beat(host_id, now)
        self.metrics.incr("cluster.heartbeats")

    def sweep(self, now: Optional[float] = None) -> Optional[ClusterView]:
        """One liveness pass: refresh leases from attached sources, then
        turn expired leases into a view change.  Returns the new view
        when membership changed, else None.  Drives from the watchdog's
        monitor thread (``Watchdog(cluster=...)``) or :meth:`start`'s
        own loop."""
        now = self._clock() if now is None else now
        dead: set = set()
        for h in self.view.hosts:
            try:
                # Chaos site (producer_idx carries the HOST id):
                # HEARTBEAT_DROP loses this beat, HOST_LOSS declares the
                # host dead immediately.
                fault_point("cluster.heartbeat", producer_idx=h.host_id)
            except HeartbeatDropped:
                self.metrics.incr("cluster.heartbeats_dropped")
                continue  # the lease ages; only expiry changes the view
            except HostLostError:
                dead.add(h.host_id)
                continue
            src = self._sources.get(h.host_id)
            if src is None:
                continue  # externally beaten (see beat())
            if src():
                self.leases.beat(h.host_id, now)
                self.metrics.incr("cluster.heartbeats")
        live_ids = {h.host_id for h in self.view.hosts}
        dead |= set(self.leases.expired(now)) & live_ids
        if not dead:
            return None
        if dead >= live_ids:
            # A sweep must never empty the view: with zero survivors
            # there is no one to re-partition onto, and a crash-looping
            # monitor would bury the real failure.  Keep the view (the
            # data plane will surface its own error) and log ONCE.
            if not self._no_survivor_logged:
                self._no_survivor_logged = True
                logger.error(
                    "cluster: every host's lease lapsed (%s) — refusing "
                    "to empty the view; the data plane owns this failure",
                    sorted(dead),
                )
            self.metrics.incr("cluster.no_survivor_sweeps")
            return None
        return self._change_view(frozenset(dead))

    def declare_host_loss(
        self, host_id: int, graceful: bool = False
    ) -> ClusterView:
        """Operator/ladder declaration: the host is gone NOW (no lease
        wait) — e.g. the scheduler reported the node preempted.
        ``graceful`` marks a planned departure (the autoscaler's
        drain-then-release): the identical epoch-fenced view change
        runs, but it counts as ``cluster.host_drains`` — not
        ``cluster.host_losses``, the failure counter alerting keys on —
        and logs at WARNING, not ERROR."""
        return self._change_view(frozenset({host_id}), graceful=graceful)

    def _change_view(
        self, dead: FrozenSet[int], graceful: bool = False
    ) -> ClusterView:
        with self._lock:
            old = self.view
            # Chaos site: a crash here exercises the supervisor's
            # sweep-crash discrimination (the view must either change
            # completely or not at all — new is computed before any
            # state mutates).
            # The chaos site must sit INSIDE the critical section — it
            # exists to crash/delay mid-view-change and prove the sweep
            # sees all-or-nothing state.  fault_point is a disarmed
            # no-op outside chaos tests, and an armed delay is bounded
            # by the plan.
            fault_point("cluster.view_change")
            new = view_change(old, dead)
            if new is old:
                return old
            self._departed_hosts.extend(
                h for h in old.hosts if h.host_id in dead
            )
            self.view = new
            for hid in dead:
                self.leases.release(hid)
        self.metrics.incr("cluster.view_changes")
        self.metrics.incr(
            "cluster.host_drains" if graceful else "cluster.host_losses",
            len(dead),
        )
        self.metrics.set_gauge("cluster.epoch", new.epoch)
        self.metrics.set_gauge("cluster.hosts", len(new.hosts))
        logger.log(
            logging.WARNING if graceful else logging.ERROR,
            "cluster: host(s) %s %s — view epoch %d -> %d, shard "
            "ranges re-partitioned over %d survivor(s)",
            sorted(dead), "drained" if graceful else "lost",
            old.epoch, new.epoch, len(new.hosts),
        )
        self._notify(old, new, dead)
        return new

    def rejoin(self, host: HostInfo) -> ClusterView:
        """Re-admit ``host`` at a fresh epoch fence (full deterministic
        re-partition — :func:`view_rejoin`); its lease starts fresh."""
        with self._lock:
            old = self.view
            new = view_rejoin(old, host)
            self.view = new
            self.leases.register(host.host_id)
            self._departed_hosts = [
                h for h in self._departed_hosts if h.host_id != host.host_id
            ]
        self.metrics.incr("cluster.view_changes")
        self.metrics.incr("cluster.rejoins")
        self.metrics.set_gauge("cluster.epoch", new.epoch)
        self.metrics.set_gauge("cluster.hosts", len(new.hosts))
        logger.warning(
            "cluster: host %d rejoined — view epoch %d -> %d",
            host.host_id, old.epoch, new.epoch,
        )
        self._notify(old, new, frozenset())
        return new

    def restore_epoch(self, epoch: int) -> None:
        """Checkpoint resume: fast-forward the epoch fence so views
        minted after restore can never be mistaken for pre-checkpoint
        ones (``LoaderCheckpoint.cluster_epoch``)."""
        with self._lock:
            if epoch > self.view.epoch:
                self.view = dataclasses.replace(self.view, epoch=epoch)
                self.metrics.set_gauge("cluster.epoch", epoch)

    def _notify(
        self, old: ClusterView, new: ClusterView, dead: FrozenSet[int]
    ) -> None:
        for fn in self._listeners:
            try:
                fn(old, new, dead)
            except (ShutdownRequested, KeyboardInterrupt):
                raise
            except Exception:
                # One listener's crash must not silence the others (or
                # kill the monitor thread) — the ladder keeps climbing.
                logger.exception("cluster: view-change listener raised")

    # -- optional background loop (the watchdog drives sweeps when one
    # is attached; standalone deployments use this) ------------------------

    def start(self) -> "ClusterSupervisor":
        self._thread = threading.Thread(
            target=self._run, name="ddl-cluster", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.poll_interval_s * 2 + 1)

    def __enter__(self) -> "ClusterSupervisor":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    def _run(self) -> None:
        # Bounded by the stop event's timed wait; every sweep consults
        # lease expiry — never a free spin.
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.sweep()
            except (ShutdownRequested, KeyboardInterrupt):
                return  # teardown reached the monitor: stop cleanly
            except Exception:
                # A crashing sweep must never silently disable host-loss
                # detection (the watchdog.sweep contract, host-level).
                logger.exception("cluster: sweep raised; continuing")
                continue

    def wait_for_epoch(self, epoch: int, timeout_s: float = 30.0) -> bool:
        """Block until the view reaches ``epoch`` (tests/bootstrap
        barriers), up to ``timeout_s``."""
        deadline = self._clock() + timeout_s
        while self.view.epoch < epoch:
            if self._clock() >= deadline:
                return False
            time.sleep(0.01)
        return True
