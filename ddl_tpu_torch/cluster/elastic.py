"""Cross-host elastic recovery: the ladder above the watchdog (port of
``ddl_tpu/cluster/elastic.py``).

The watchdog's ladder ends at "respawn the dead producer".  This module
adds the host-level rungs:

1. **producer death, host alive** — the watchdog's rung, unchanged:
   respawn and deterministic replay.  The lease budget is sized so a
   respawn lands before the host's lease lapses (membership.py).
2. **whole-host death** — lease expiry, ``HOST_LOSS`` or a declaration
   → the supervisor's epoch-fenced view change, which this module turns
   into pipeline actions:

   - the loader is handed the shrunken
     :class:`~ddl_tpu_torch.cluster.pool.LoaderPool` the new view
     publishes (rotation drops the dead rings at the next window
     boundary; a consumer blocked on a dead ring is unblocked by target
     revocation);
   - each surviving LOCAL producer receives a
     :class:`~ddl_tpu_torch.types.ShardAdoption` in an acked control
     envelope: its host's post-change shard ranges, the view epoch as
     the fence, and ``suspend_exchange=True`` so the cross-instance
     shuffle degrades to node-local until rejoin (exchanging with a
     permutation that still names the dead host would stall every
     round);
   - the dead host's shard-cache disk tier is adopted for a warm start
     when its spill dir is reachable (``cache.adopt_manifest``).

3. **rejoin** — a recovered host re-enters at a fresh epoch fence:
   full deterministic re-partition, pool re-grown, exchange resumed.
"""

from __future__ import annotations

import logging
from typing import Any, FrozenSet, Iterable, Optional

from ddl_tpu_torch.cluster.membership import ClusterSupervisor, ClusterView, HostInfo
from ddl_tpu_torch.exceptions import DDLError, ShutdownRequested
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
from ddl_tpu_torch.types import ShardAdoption

logger = logging.getLogger("ddl_tpu_torch")


def worker_alive_source(workers: Any, ranks: Iterable[int]):
    """A heartbeat source over a host's LOCAL workers: alive while ANY
    of its loader ranks still runs (``any``, not ``all`` — a single
    producer crash is the watchdog's rung 1, and its respawn revives
    the beat before the lease lapses; only a fully dead host stops
    beating).  Rank indices are 1-based, matching the repo convention.
    """
    idxs = sorted(int(r) - 1 for r in ranks)

    def alive() -> bool:
        for i in idxs:
            if workers.threads:
                if i < len(workers.threads) and workers.threads[i].is_alive():
                    return True
            elif workers.processes:
                p = workers.processes[i] if i < len(workers.processes) else None
                if p is not None and p.exitcode is None:
                    return True
        return False

    return alive


class ElasticCluster:
    """Binds a :class:`ClusterSupervisor` to live pipeline components.

    One instance per consumer process: it subscribes to view changes and
    translates them into the rung-2 actions above.  Components attach as
    they exist — a caller that only wants membership metrics attaches
    nothing; the full pipeline attaches workers (adoption channel
    access and liveness sources) and the loader (pool application).
    """

    def __init__(
        self,
        supervisor: ClusterSupervisor,
        workers: Any = None,
        loader: Any = None,
        metrics: Optional[Metrics] = None,
        adopt_cache: bool = True,
        local_host_id: "int | Iterable[int] | None" = None,
    ):
        """``local_host_id`` (int or iterable) names THIS process's
        host(s) in the view — required in real multi-host deployments
        where every host numbers its workers locally as ranks 1..n, so
        rank values alias across hosts.  ``None`` keeps the default
        everything-is-local reading (single-process mock-host
        topologies, where the view really does describe this process's
        rings)."""
        self.supervisor = supervisor
        self.workers = workers
        self.loader = None
        self.metrics = metrics or default_metrics()
        self.adopt_cache = adopt_cache
        if local_host_id is not None:
            ids = (
                {local_host_id}
                if isinstance(local_host_id, int)
                else set(local_host_id)
            )
            supervisor.local_host_ids = ids
        supervisor.add_listener(self._on_view_change)
        supervisor.add_rank_listener(self._on_rank_respawned)
        if workers is not None:
            self._attach_worker_sources()
        if loader is not None:
            self.attach_loader(loader)

    # -- wiring ------------------------------------------------------------

    def _local_hosts(self, view: ClusterView):
        return [
            h for h in view.hosts if self.supervisor.is_local(h.host_id)
        ]

    def _local_pool(self, view: ClusterView):
        """The pool slice THIS process consumes: local hosts' ranks
        only (remote ranks are other processes' ring indices)."""
        from ddl_tpu_torch.cluster.pool import LoaderPool

        members = sorted(
            r - 1
            for h in self._local_hosts(view)
            for r in h.loader_ranks
        )
        return LoaderPool(members=tuple(members), generation=view.epoch)

    def _attach_worker_sources(self) -> None:
        """One liveness source per LOCAL host in the view (hosts whose
        loader ranks exist in this process's worker set)."""
        n_local = self.workers.connection.n_producers
        for h in self._local_hosts(self.supervisor.view):
            local = [r for r in h.loader_ranks if 1 <= r <= n_local]
            if local:
                self.supervisor.attach_source(
                    h.host_id, worker_alive_source(self.workers, local)
                )

    def attach_loader(self, loader: Any) -> None:
        """Register the consumer: it immediately adopts the CURRENT
        view's LOCAL pool slice (a loader attached after a loss must
        not rotate onto dead rings) and follows every later view
        change."""
        self.loader = loader
        loader.apply_pool(self._local_pool(self.supervisor.view))

    def rebind_supervisor(self, supervisor: ClusterSupervisor) -> None:
        """Re-point the ladder at a freshly promoted supervisor
        (:meth:`~ddl_tpu_torch.cluster.supervision.SupervisorHA.promote`):
        the new leader gets this ladder's listeners and liveness sources,
        and the consumer immediately adopts the replayed view's pool
        slice (a view change the dead leader half-delivered is re-applied
        here — epoch fences make the re-application idempotent)."""
        supervisor.local_host_ids = self.supervisor.local_host_ids
        self.supervisor = supervisor
        supervisor.add_listener(self._on_view_change)
        supervisor.add_rank_listener(self._on_rank_respawned)
        if self.workers is not None:
            self._attach_worker_sources()
        if self.loader is not None:
            self.loader.apply_pool(self._local_pool(supervisor.view))
        self.metrics.incr("cluster.supervisor_rebinds")

    # -- the rung-2 ladder -------------------------------------------------

    def _on_view_change(
        self, old: ClusterView, new: ClusterView, dead: FrozenSet[int]
    ) -> None:
        if self.loader is not None:
            self.loader.apply_pool(self._local_pool(new))
        if dead and self.adopt_cache:
            self._adopt_dead_caches(old, dead)
        # Loss degrades the exchange until rejoin; a rejoin (empty dead
        # set) is the resume edge.  The flag rides the SAME epoch-fenced
        # message as the ranges so suspend/resume can never reorder
        # against the shard assignment they protect.
        self._send_adoptions(new, suspend_exchange=bool(dead))

    def _adopt_dead_caches(
        self, old: ClusterView, dead: FrozenSet[int]
    ) -> None:
        """Warm-start adoption of each dead host's shard-cache disk tier
        (shared-filesystem spill dirs only; unreachable paths fail the
        adoption quietly — resuming cold was always legal)."""
        from ddl_tpu_torch import cache as cache_mod

        for h in old.hosts:
            if h.host_id not in dead or not h.cache_spill_dir:
                continue
            try:
                adopted = cache_mod.adopt_manifest(
                    h.cache_spill_dir, cache_mod.KEY_SCHEMA_VERSION
                )
            except (ShutdownRequested, KeyboardInterrupt):
                raise
            except Exception:
                logger.exception(
                    "cluster: cache adoption from host %d failed", h.host_id
                )
                continue
            if adopted:
                self.metrics.incr("cluster.cache_adoptions")
                logger.warning(
                    "cluster: adopted host %d's cache tier (%s) for "
                    "warm-start recovery", h.host_id, h.cache_spill_dir,
                )

    def _send_adoptions(
        self, view: ClusterView, suspend_exchange: Optional[bool]
    ) -> None:
        """Ship each surviving LOCAL producer its host's post-change
        shard ranges (epoch-fenced; producers ignore stale epochs)."""
        if self.workers is None:
            return
        conn = self.workers.connection
        sent = 0
        for h in self._local_hosts(view):
            local = sorted(
                r for r in h.loader_ranks if 1 <= r <= conn.n_producers
            )
            for peer_idx, rank in enumerate(local):
                msg = ShardAdoption(
                    ranges=view.ranges_of(h.host_id),
                    view_epoch=view.epoch,
                    peer_idx=peer_idx,
                    n_peers=len(local),
                    suspend_exchange=suspend_exchange,
                )
                try:
                    # Rides the acked envelope seam (under the
                    # connection's rejoin lock): a dropped or duplicated
                    # wire attempt becomes a dedup'd backoff retry
                    # instead of a silently stranded adoption, and the
                    # supervisor's fencing term rides the envelope so a
                    # zombie ex-leader's late adoption dies at the
                    # producer.
                    conn.send_control_acked(rank - 1, msg)
                    sent += 1
                except (OSError, ValueError):
                    # A dying channel mid-change: the watchdog/next view
                    # change owns that producer; adoption is re-sent on
                    # the NEXT view change or the post-respawn re-send
                    # (epoch fence makes both safe).
                    logger.warning(
                        "cluster: adoption send to producer %d failed",
                        rank,
                    )
        if sent:
            self.metrics.incr("cluster.shard_adoptions", sent)

    def _on_rank_respawned(self, rank: int) -> None:
        """Re-ship the CURRENT view's adoption to a respawned producer.

        A view change that raced the respawn's channel swap lost its
        adoption send (the old channel was closing), and the fresh
        incarnation starts from its on_init base assignment — without
        this it would serve pre-change ranges and silently drop the
        shards the view moved onto its host.  Epoch-fenced like every
        adoption: an incarnation that already applied this epoch drops
        the duplicate."""
        if self.workers is None:
            return
        view = self.supervisor.view
        host = next(
            (
                h
                for h in self._local_hosts(view)
                if rank in h.loader_ranks
            ),
            None,
        )
        if host is None:
            return  # a departed (or remote) host's rank: nothing to ship
        conn = self.workers.connection
        local = sorted(
            r for r in host.loader_ranks if 1 <= r <= conn.n_producers
        )
        if rank not in local:
            return
        msg = ShardAdoption(
            ranges=view.ranges_of(host.host_id),
            view_epoch=view.epoch,
            peer_idx=local.index(rank),
            n_peers=len(local),
            suspend_exchange=None,
        )
        try:
            # The acked seam, like every adoption send: the respawn race
            # this re-send papers over is exactly a lost delivery, so it
            # gets the same dedup'd-retry contract instead of a second
            # fire-and-forget hope.
            conn.send_control_acked(rank - 1, msg)
            self.metrics.incr("cluster.shard_adoptions")
        except (OSError, ValueError):
            logger.warning(
                "cluster: post-respawn adoption send to producer %d "
                "failed", rank,
            )

    # -- chaos / operator hammers -----------------------------------------

    def kill_host(self, host_id: int) -> ClusterView:
        """Hard-kill every LOCAL worker of ``host_id`` and declare the
        loss (the mock-host chaos hammer the cross-host tests swing; an
        operator draining a node uses the same path).  Declaration runs
        FIRST so the pool shrinks before the dead rings' shutdown flags
        can be mistaken for run teardown."""
        host = self.supervisor.view.host(host_id)
        if host is None:
            raise KeyError(f"host {host_id} is not in the view")
        new = self.supervisor.declare_host_loss(host_id)
        if self.workers is not None:
            n_local = self.workers.connection.n_producers
            for r in host.loader_ranks:
                i = r - 1
                if not (0 <= i < n_local):
                    continue
                if self.workers.processes:
                    p = self.workers.processes[i]
                    if p.exitcode is None:
                        p.terminate()
                        p.join(10)
                # THREAD mode cannot kill a thread: flag its ring's
                # shutdown so the producer exits its next wait.  The
                # consumer never observes it — the pool already dropped
                # this ring, and a revoked in-flight acquire is handled
                # by the loader's pool seam.
                try:
                    self.workers.connection.rings[i].shutdown()
                except (IndexError, OSError):
                    pass
        return new

    def drain_host(self, host_id: int) -> HostInfo:
        """Graceful scale-down (an autoscaler's release half, or a
        preemption guard's drain rung).  Unlike :meth:`kill_host`, the
        host's workers are PARKED, not killed: the epoch-fenced view change
        drops its rings from every consumer pool (in-flight acquires
        revoked at the fence) and re-partitions its shard ranges onto
        survivors, while its producers simply idle against their full
        rings — warm standby, so a later :meth:`rejoin_host` serves
        their already-committed windows immediately.  A park outlasting
        the transport stall budget ends with the producer exiting on
        its fill timeout; the view has already left it to the cluster
        ladder (the watchdog skips lost ranks), and a rejoin then rides
        the normal respawn path.  Returns the departed
        :class:`HostInfo` — the autoscaler's standby-reserve entry.
        Refuses to drain the last loader host (the never-empty floor).
        """
        view = self.supervisor.view
        host = view.host(host_id)
        if host is None:
            raise KeyError(f"host {host_id} is not in the view")
        survivors = [
            h for h in view.hosts
            if h.loader_ranks and h.host_id != host_id
        ]
        if not survivors:
            raise DDLError(
                f"refusing to drain host {host_id}: it carries the last "
                "loader ranks in the view (never-empty floor)"
            )
        # graceful=True: the identical epoch-fenced change, counted as
        # cluster.host_drains (not host_losses — the failure counter
        # alerting keys on) and logged WARNING.  The exchange still
        # suspends until rejoin: the drained host's producers are
        # PARKED, so an exchange schedule naming them would stall every
        # round exactly as a dead host's would.
        self.supervisor.declare_host_loss(host_id, graceful=True)
        return host

    def rejoin_host(self, host: HostInfo) -> ClusterView:
        """Re-admit a recovered host (the ladder's exit).  The listener
        ships the re-partitioned ranges with ``suspend_exchange=False``
        — shuffle degradation lasts exactly until this fence."""
        new = self.supervisor.rejoin(host)
        if self.workers is not None:
            self._attach_worker_sources()
        return new
