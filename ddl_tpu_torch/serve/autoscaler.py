"""Demand-driven autoscaling of the loader tier (port of
``ddl_tpu/serve/autoscaler.py``).

The cluster control plane has the mechanism of an elastically sized
loader pool (``ElasticCluster.rejoin_host``, the epoch-fenced shrink on
host loss); this module drives it: a deadline loop that reads the demand
signals ``north_star_report`` surfaces — the consumer stall fraction and
the staging queue depth — and turns *sustained* demand into
``rejoin_host`` of standby loader hosts, and *sustained* idleness into a
drain, then release, of surplus ones.

- **Hysteresis band.**  Scale up above ``up_stall_fraction``, down below
  ``down_stall_fraction``; the gap between them stops flapping.  A
  signal must hold beyond its threshold for ``sustain_s`` before any
  action.
- **Cooldown.**  After an action, none for ``cooldown_s``: a fresh host
  needs time to show in the signal.
- **Never-empty floor.**  The pool never shrinks below ``min_hosts``
  loader hosts, and a host carrying trainer ranks is never drained.
- **Placement follows the pool.**  Every resize re-runs
  :func:`~ddl_tpu_torch.cluster.placement.plan_placement` over the new
  view when link costs are known.

Metrics: ``serve.scale_ups`` / ``serve.scale_downs``, the
``serve.scale_up_reaction`` timer (sustained signal to rejoin complete),
``serve.pool_hosts`` / ``serve.standby_hosts``, ``serve.replans``.

Chaos: the ``serve.scale`` site fires at the top of every
:meth:`Autoscaler.step`; ``SCALE_DECISION_DELAY`` sleeps there (a slow
control plane delays a decision, never corrupts it).
"""


from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Iterable, List, Optional

from ddl_tpu_torch.cluster.membership import HostInfo
from ddl_tpu_torch.cluster.placement import Placement, plan_placement
from ddl_tpu_torch.exceptions import DDLError, ShutdownRequested
from ddl_tpu_torch.faults import fault_point
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics

logger = logging.getLogger("ddl_tpu_torch")


@dataclasses.dataclass(frozen=True)
class AutoscalerPolicy:
    """Hysteresis + pacing knobs for the policy loop."""

    #: Scale up when the windowed stall fraction holds above this.
    up_stall_fraction: float = 0.25
    #: Scale down when it holds below this (the hysteresis floor).
    down_stall_fraction: float = 0.05
    #: Optional second up-signal: staged-ingest queue depth at/above
    #: this also counts as demand (0 disables the queue signal).
    up_queue_depth: float = 0.0
    #: How long a signal must hold beyond its threshold before acting.
    sustain_s: float = 1.0
    #: Minimum spacing between consecutive scale actions.
    cooldown_s: float = 5.0
    #: The never-empty floor: loader hosts the pool may not drop below.
    min_hosts: int = 1
    #: Ceiling on loader hosts (0 = bounded only by standby supply).
    max_hosts: int = 0

    def __post_init__(self) -> None:
        if not (0.0 <= self.down_stall_fraction < self.up_stall_fraction):
            raise DDLError(
                "hysteresis band requires 0 <= down_stall_fraction < "
                f"up_stall_fraction, got [{self.down_stall_fraction}, "
                f"{self.up_stall_fraction}]"
            )
        if self.min_hosts < 1:
            raise DDLError("min_hosts must be >= 1 (never-empty floor)")
        if self.sustain_s < 0 or self.cooldown_s < 0:
            raise DDLError("sustain_s/cooldown_s must be >= 0")


class Autoscaler:
    """The policy loop binding demand signals to pool resizes.

    ``cluster`` is an :class:`~ddl_tpu_torch.cluster.elastic.ElasticCluster`
    (or anything exposing ``supervisor.view``, ``rejoin_host(HostInfo)``
    and ``drain_host(host_id)``).  ``standby`` seeds the idle-host reserve scale-up
    draws from; drained hosts return to it.

    ``signal`` overrides the demand reading — a zero-arg callable
    returning ``{"stall_fraction": float, "queue_depth": float}``.  The
    default reads the shared metrics registry and computes a WINDOWED
    stall fraction (deltas of the ``consumer.wait`` timer over deltas of
    wall clock, normalised by ``n_consumers``) — the cumulative
    ``Metrics.stall_fraction`` would dilute a fresh burst under a long
    quiet history and never cross the band.
    """

    def __init__(
        self,
        cluster,
        standby: Iterable[HostInfo] = (),
        policy: AutoscalerPolicy = AutoscalerPolicy(),
        metrics: Optional[Metrics] = None,
        clock: Callable[[], float] = time.monotonic,
        signal: Optional[Callable[[], dict]] = None,
        link_costs=None,
        n_consumers: int = 1,
        poll_interval_s: float = 0.25,
    ):
        self.cluster = cluster
        self.policy = policy
        self.metrics = metrics or default_metrics()
        self.link_costs = link_costs
        self.n_consumers = max(1, int(n_consumers))
        self.poll_interval_s = poll_interval_s
        self._clock = clock
        self._signal = signal or self._windowed_signal
        self._standby: List[HostInfo] = list(standby)
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._last_action_t = -float("inf")
        self._last_wait_s = (
            self.metrics.timer("consumer.wait").total_s
            - self.metrics.timer("serve.admission_wait").total_s
        )
        self._last_wall = self._clock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_placement: Optional[Placement] = None
        self._set_gauges()

    # -- signals -----------------------------------------------------------

    def _windowed_signal(self) -> dict:
        """Stall fraction over the span since the previous reading.

        Admission-gate waits are SUBTRACTED: a tenant parked by its own
        byte budget is throttled, not starved — scaling the pool up
        cannot help it, and counting that wait as demand would let one
        over-budget tenant inflate the fleet for everyone."""
        now = self._clock()
        wait = (
            self.metrics.timer("consumer.wait").total_s
            - self.metrics.timer("serve.admission_wait").total_s
        )
        dt = max(now - self._last_wall, 1e-9)
        stall = (wait - self._last_wait_s) / dt / self.n_consumers
        self._last_wait_s, self._last_wall = wait, now
        return {
            "stall_fraction": max(0.0, stall),
            "queue_depth": self.metrics.gauge("staging.queue_depth"),
        }

    def _loader_hosts(self) -> List[HostInfo]:
        return [
            h for h in self.cluster.supervisor.view.hosts if h.loader_ranks
        ]

    def _set_gauges(self) -> None:
        self.metrics.set_gauge("serve.pool_hosts", len(self._loader_hosts()))
        self.metrics.set_gauge("serve.standby_hosts", len(self._standby))

    # -- one policy evaluation ---------------------------------------------

    def step(self, now: Optional[float] = None) -> Optional[str]:
        """Evaluate the policy once; returns ``"up"`` / ``"down"`` /
        ``None``.  Driven by :meth:`start`'s loop or called directly
        (tests, an external scheduler tick)."""
        # Chaos site: SCALE_DECISION_DELAY sleeps here — a slow control
        # plane delays the decision, never corrupts it.
        fault_point("serve.scale")
        now = self._clock() if now is None else now
        sig = self._signal()
        stall = float(sig.get("stall_fraction", 0.0))
        queue = float(sig.get("queue_depth", 0.0))
        pol = self.policy
        demand = stall >= pol.up_stall_fraction or (
            pol.up_queue_depth > 0 and queue >= pol.up_queue_depth
        )
        idle = stall <= pol.down_stall_fraction and not demand
        if demand:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
        elif idle:
            self._above_since = None
            if self._below_since is None:
                self._below_since = now
        else:  # inside the hysteresis dead band: hold state, no timers
            self._above_since = None
            self._below_since = None
        if now - self._last_action_t < pol.cooldown_s:
            return None
        if (
            self._above_since is not None
            and now - self._above_since >= pol.sustain_s
        ):
            return self._scale_up(now)
        if (
            self._below_since is not None
            and now - self._below_since >= pol.sustain_s
        ):
            return self._scale_down(now)
        return None

    def _scale_up(self, now: float) -> Optional[str]:
        pol = self.policy
        if not self._standby:
            return None  # demand without supply: nothing to admit
        if pol.max_hosts and len(self._loader_hosts()) >= pol.max_hosts:
            return None
        host = self._standby.pop(0)
        reaction0 = self._above_since if self._above_since is not None else now
        try:
            view = self.cluster.rejoin_host(host)
        except (ShutdownRequested, KeyboardInterrupt):
            self._standby.insert(0, host)
            raise
        except Exception:
            # A failed rejoin (host never came back, channel dead) must
            # not lose the reserve entry OR kill the policy loop.
            self._standby.insert(0, host)
            logger.exception("serve: scale-up rejoin of host %d failed",
                             host.host_id)
            return None
        self._last_action_t = now
        self._above_since = None
        self.metrics.incr("serve.scale_ups")
        self.metrics.add_time(
            "serve.scale_up_reaction", max(0.0, self._clock() - reaction0)
        )
        self._replan(view)
        self._set_gauges()
        logger.warning(
            "serve: scaled UP — host %d joined the loader pool (%d hosts)",
            host.host_id, len(self._loader_hosts()),
        )
        return "up"

    def _scale_down(self, now: float) -> Optional[str]:
        pol = self.policy
        loaders = self._loader_hosts()
        if len(loaders) <= pol.min_hosts:
            return None  # the never-empty floor
        # Drain the newest (highest-id) loader-only host: trainer-role
        # hosts are never drained, and low ids are the stable base set.
        candidates = [h for h in loaders if not h.trainer_ranks]
        if not candidates:
            return None
        host = max(candidates, key=lambda h: h.host_id)
        try:
            drained = self.cluster.drain_host(host.host_id)
        except (ShutdownRequested, KeyboardInterrupt):
            raise
        except Exception:
            logger.exception("serve: scale-down drain of host %d failed",
                             host.host_id)
            return None
        self._last_action_t = now
        self._below_since = None
        self._standby.append(drained)
        self.metrics.incr("serve.scale_downs")
        self._replan(self.cluster.supervisor.view)
        self._set_gauges()
        logger.warning(
            "serve: scaled DOWN — host %d drained to standby (%d hosts)",
            host.host_id, len(self._loader_hosts()),
        )
        return "down"

    def retune(self, policy: AutoscalerPolicy) -> None:
        """Swap the hysteresis policy live (the ddl_tpu_torch.tune seam).

        Sustain timers reset: a threshold that just moved must be held
        beyond for a FULL sustain span before acting — carrying a timer
        accumulated against the old band would let the first post-retune
        tick fire on stale evidence.  The cooldown clock is kept: a
        retune is not an action and must not unlock one early.
        """
        self.policy = policy
        self._above_since = None
        self._below_since = None

    def _replan(self, view) -> None:
        """Placement follows the pool: re-run the Cloud-Collectives
        reorder over the resized view whenever link costs are known."""
        if self.link_costs is None:
            return
        try:
            self.last_placement = plan_placement(view, self.link_costs)
        except DDLError:
            # A view with no loader ranks mid-transition: placement is
            # meaningless until the next resize lands.
            self.last_placement = None
            return
        self.metrics.incr("serve.replans")
        self.metrics.set_gauge(
            "serve.placement_reordered",
            1.0 if self.last_placement.reordered else 0.0,
        )

    # -- the background loop (a timed stop-event wait) ---------------------

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(
            target=self._run, name="ddl-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.poll_interval_s * 2 + 1)

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        # Bounded by the stop event's timed wait; step()
        # itself does bounded per-tenant work (snapshot reads, one
        # resize at most) — never a per-tenant blocking fan-out.
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.step()
            except (ShutdownRequested, KeyboardInterrupt):
                return  # teardown reached the policy loop: stop cleanly
            except Exception:
                # A crashing step must never silently disable
                # autoscaling (the watchdog.sweep contract).
                logger.exception("serve: autoscaler step raised; continuing")
                continue

    @property
    def standby(self) -> List[HostInfo]:
        return list(self._standby)
