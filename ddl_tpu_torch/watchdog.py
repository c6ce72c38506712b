"""Failure detection and recovery: producer liveness and pipeline
progress (port of ``ddl_tpu/watchdog.py``).

Three mechanisms guard a run: every transport wait is bounded
(``StallTimeoutError``), a control pipe reports a dead peer as EOF, and
this watchdog — a consumer-side thread that checks, every
``poll_interval_s``, that each producer worker lives and that each ring
moves.  A dead worker (or a ring that made no progress for the stall
budget) is respawned in place with ``respawn=True``, up to
``max_respawns`` times, then handed to ``on_failure`` (default: log and
abort the workers).

With ``cluster=`` (a :class:`~ddl_tpu_torch.cluster.ClusterSupervisor`)
the ladder extends across hosts: every poll also drives one membership
sweep, workers whose HOST has left the view are the cluster ladder's
(neither respawned nor escalated), and a respawned rank is reported back
(``rank_respawned``) so the fresh incarnation hears the current view's
shard adoption.

Counters: ``watchdog.respawns`` and ``watchdog.failures``; timer
``watchdog.respawn`` (terminate, spawn and rejoin handshake of each
replacement).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ddl_tpu_torch.exceptions import ShutdownRequested, TransportError
from ddl_tpu_torch.faults import fault_point
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics

logger = logging.getLogger("ddl_tpu_torch")


class Watchdog:
    """Monitors a :class:`~ddl_tpu_torch.env.WorkerSet` and its rings
    from the consumer side."""

    def __init__(
        self,
        workers: Any,
        poll_interval_s: float = 2.0,
        stall_budget_s: float = 120.0,
        on_failure: Optional[Callable[[str], None]] = None,
        respawn: bool = False,
        max_respawns: int = 3,
        replay_budget_per_window_s: float = 1.0,
        metrics: Optional[Metrics] = None,
        cluster: Any = None,
    ):
        """``respawn=True`` turns detection into recovery: a dead
        producer worker is replaced (``WorkerSet.respawn``: rejoin the
        surviving ring at the recorded position) up to ``max_respawns``
        times before ``on_failure``.  While a replacement fast-forwards
        (commits nothing) its stall budget widens to ten times
        ``stall_budget_s`` plus ``replay_budget_per_window_s`` per window
        it replays.

        ``cluster`` (a ClusterSupervisor) makes each poll sweep the
        membership too; a rank of a host that left the view is the
        cluster ladder's: the view change IS its handling."""
        self.workers = workers
        self.cluster = cluster
        self.poll_interval_s = poll_interval_s
        self.stall_budget_s = stall_budget_s
        self.on_failure = on_failure or self._default_on_failure
        self.respawn = respawn
        self.max_respawns = max_respawns
        self.replay_budget_per_window_s = replay_budget_per_window_s
        self.metrics = metrics or default_metrics()
        self.respawns: List[int] = []  # producer_idx per respawn
        self.failures: List[str] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Keyed by ring index: bounded by n_producers.
        self._last_progress: Dict[int, tuple] = {}
        self._last_change: Dict[int, float] = {}
        self._dead_idx: Optional[int] = None  # set by check_once
        # ring index -> committed count at respawn.  While present the
        # replacement is replaying, and its budget is widened; the entry
        # clears once the committed count moves past it.
        self._replaying: Dict[int, float] = {}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Watchdog":
        self._thread = threading.Thread(
            target=self._run, name="ddl-torch-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.poll_interval_s * 2 + 1)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- checks ------------------------------------------------------------

    def _default_on_failure(self, reason: str) -> None:
        logger.error("watchdog: %s — initiating shutdown", reason)
        try:
            self.workers.abort()
        except (TransportError, OSError, ValueError):
            pass  # best effort: the run is failing anyway

    def check_once(self) -> Optional[str]:
        """One sweep; returns a failure description or None.  The
        ``watchdog.sweep`` fault site runs first: a spurious shutdown or
        a crash there exercises the monitor loop's own handling."""
        fault_point("watchdog.sweep")
        rings = self.workers.connection.rings
        # The loader flags rings one by one at shutdown, so a sweep in the
        # middle of teardown may see workers exiting: any shut-down ring
        # means teardown, not a failure.
        if rings and any(r.is_shutdown() for r in rings):
            return None
        self._dead_idx = None
        # Workers of hosts that LEFT the cluster view are dead by design:
        # the view change declared them, the loader pool dropped their
        # rings and the survivors adopted their shards.
        lost = (self.cluster.lost_ranks() if self.cluster is not None
                else frozenset())
        for i, t in enumerate(self.workers.threads):
            if i + 1 not in lost and not t.is_alive():
                self._dead_idx = i + 1
                return f"producer thread {i + 1} died"
        for i, p in enumerate(self.workers.processes):
            if (i + 1 not in lost and p.exitcode is not None
                    and p.exitcode != 0):
                self._dead_idx = i + 1
                return f"producer process {i + 1} exited with {p.exitcode}"
        now = time.monotonic()
        for i, ring in enumerate(rings):
            if i + 1 in lost:
                continue  # no progress expected from a departed host
            st = ring.stats()
            progress = (st["committed"], st["released"])
            if i in self._replaying and st["committed"] > self._replaying[i]:
                del self._replaying[i]  # the first new commit ends it
            if self._last_progress.get(i) != progress:
                self._last_progress[i] = progress
                self._last_change[i] = now
            # A replacement replays its predecessor's windows before it
            # commits anything, one execute_function each by default:
            # the grace grows with the windows to replay.
            budget = self.stall_budget_s
            if i in self._replaying:
                budget = self.stall_budget_s * 10.0 + (
                    max(0.0, self._replaying[i])
                    * self.replay_budget_per_window_s
                )
            if (
                self._last_progress.get(i) == progress
                and st["committed"] == st["released"]  # producer owes one
                and now - self._last_change.get(i, now) > budget
            ):
                # A hung PROCESS worker is replaceable (respawn terminates
                # it); a live thread is not, and falls through to
                # on_failure.
                self._dead_idx = i + 1
                return (f"ring {i} made no progress for {budget}s "
                        f"(committed={st['committed']:.0f})")
        return None

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            if self.cluster is not None:
                # The host-level ladder: one membership sweep a poll, with
                # check_once's crash discipline.
                try:
                    self.cluster.sweep()
                except (ShutdownRequested, KeyboardInterrupt):
                    return
                except Exception:
                    logger.exception("watchdog: cluster sweep raised; "
                                     "continuing")
            try:
                reason = self.check_once()
            except (ShutdownRequested, KeyboardInterrupt):
                return
            except Exception:
                # A crashing sweep must never disable failure detection.
                logger.exception("watchdog: check_once raised; continuing")
                continue
            if reason is None:
                continue
            idx = self._dead_idx
            if (self.cluster is not None and idx is not None
                    and idx in self.cluster.lost_ranks()):
                continue  # declared at host level since check_once

            if (self.respawn and idx is not None
                    and len(self.respawns) < self.max_respawns):
                logger.warning(
                    "watchdog: %s — respawning producer %d (%d/%d respawns "
                    "used)", reason, idx, len(self.respawns) + 1,
                    self.max_respawns,
                )
                try:
                    with self.metrics.timed("watchdog.respawn"):
                        self.workers.respawn(idx)
                except (ShutdownRequested, KeyboardInterrupt):
                    return  # teardown mid-respawn
                except Exception:
                    logger.exception("watchdog: respawn of producer %d "
                                     "failed", idx)
                else:
                    self.respawns.append(idx)
                    self.metrics.incr("watchdog.respawns")
                    if self.cluster is not None:
                        # The fresh incarnation must hear the current
                        # view's shard adoption.
                        self.cluster.rank_respawned(idx)
                    # The stall clock restarts; the widened budget holds
                    # until the committed count moves past this value.
                    self._last_change[idx - 1] = time.monotonic()
                    try:
                        committed = self.workers.connection.rings[
                            idx - 1].stats()["committed"]
                    except (TransportError, OSError, KeyError, IndexError):
                        committed = float("-inf")
                    self._replaying[idx - 1] = committed
                    continue
            # Counted once: the monitor stops at its first failure.
            self.failures.append(reason)
            self.metrics.incr("watchdog.failures")
            # The failure is terminal for the pipeline: dump the flight
            # ring before on_failure escalates (a no-op disarmed).  Only a
            # death or a replaceable stall names a producer.
            from ddl_tpu_torch.obs.recorder import flight_dump

            flight_dump("watchdog.failure", producer_idx=self._dead_idx,
                        metrics=self.metrics, extra={"reason": reason})
            self.on_failure(reason)
            return
