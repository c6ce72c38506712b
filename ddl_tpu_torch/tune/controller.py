"""Steady-state knob control: hysteresis, never-worse, full audit (port
of ``ddl_tpu/tune/controller.py``).

The :class:`KnobController` is the Autoscaler's policy discipline pointed
at the data plane's own knobs: a deadline loop on a stop event's timed
wait; a signal must hold beyond its band for ``sustain_s`` before any
action; a dead band between the thresholds; a ``cooldown_s`` between
actions.  It retunes the knobs bound through :mod:`ddl_tpu_torch.tune.
knobs`: prefetch depth and staging capacity on sustained stall, the
exchange wire on parity-headroom shrink, the placement plan on measured
link-cost drift.

- **Never-worse.**  Every knob change opens an observation window (one
  cooldown long).  If the window's throughput (the windowed
  ``consumer.samples`` rate by default) falls more than ``revert_tol``
  below the window before the change, the change is REVERTED,
  ``tune.reverts`` increments, and the revert is flight-recorded.
- **Safety outranks pacing.**  The lossy-wire parity guard (flip to raw
  when measured drift eats into the ``loss_parity`` tolerance) ignores
  the cooldown and is one-way.

Every decision lands in the flight-recorder ring (``("tune", <knob>,
<new value>)``) and in ``tune.decisions`` / ``tune.cost_source.*``.
"""


from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ddl_tpu_torch import envspec
from ddl_tpu_torch.cluster.placement import Placement, replan_on_drift
from ddl_tpu_torch.exceptions import DDLError, ShutdownRequested
from ddl_tpu_torch.faults import fault_point
from ddl_tpu_torch.obs.recorder import flight_note
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
from ddl_tpu_torch.tune.calibrate import COST_MEASURED, Decision, _numeric
from ddl_tpu_torch.tune.knobs import TunableKnob

logger = logging.getLogger("ddl_tpu_torch")


@dataclasses.dataclass(frozen=True)
class ControllerPolicy:
    """Hysteresis + pacing + guard knobs for the tuning loop."""

    #: Grow pipeline depth when the windowed stall fraction holds above.
    up_stall_fraction: float = 0.25
    #: Shrink back toward baseline when it holds below (hysteresis
    #: floor; the gap to ``up_stall_fraction`` is the dead band).
    down_stall_fraction: float = 0.05
    #: Optional second up-signal: window-latency p99 (seconds) at/above
    #: this also counts as demand (0 disables it).
    up_latency_p99_s: float = 0.0
    #: How long a signal must hold beyond its band before acting.
    sustain_s: float = 2.0
    #: Minimum spacing between knob changes — ALSO the never-worse
    #: observation window a change is judged over.
    cooldown_s: float = 5.0
    #: Revert a change whose post-window throughput drops more than
    #: this fraction below the pre-window.
    revert_tol: float = 0.05
    #: Flip lossy wire to raw when measured drift exceeds this fraction
    #: of the parity tolerance.
    parity_headroom: float = 0.5
    #: Replan placement when any link's measured cost drifts beyond
    #: this relative tolerance.
    drift_rel_tol: float = 0.25

    def __post_init__(self) -> None:
        if not (0.0 <= self.down_stall_fraction < self.up_stall_fraction):
            raise DDLError(
                "hysteresis band requires 0 <= down_stall_fraction < "
                f"up_stall_fraction, got [{self.down_stall_fraction}, "
                f"{self.up_stall_fraction}]"
            )
        if self.sustain_s < 0 or self.cooldown_s < 0:
            raise DDLError("sustain_s/cooldown_s must be >= 0")
        if not (0.0 <= self.revert_tol < 1.0):
            raise DDLError("revert_tol must be in [0, 1)")
        if not (0.0 < self.parity_headroom <= 1.0):
            raise DDLError("parity_headroom must be in (0, 1]")

    @classmethod
    def from_env(cls) -> "ControllerPolicy":
        """Policy from the ``DDL_TORCH_TUNE_*`` registry knobs."""
        return cls(
            sustain_s=envspec.get("DDL_TORCH_TUNE_SUSTAIN_S"),
            cooldown_s=envspec.get("DDL_TORCH_TUNE_COOLDOWN_S"),
            revert_tol=envspec.get("DDL_TORCH_TUNE_REVERT_TOL"),
            parity_headroom=envspec.get("DDL_TORCH_TUNE_PARITY_HEADROOM"),
        )


@dataclasses.dataclass
class _PendingChange:
    """One knob change under never-worse observation."""

    knob: TunableKnob
    old: Any
    new: Any
    opened_t: float
    work0: float
    pre_rate: float


class KnobController:
    """The closed loop binding the loader's telemetry to live knob writes.

    ``knobs`` are the :class:`~ddl_tpu_torch.tune.knobs.TunableKnob` bindings
    this controller may touch, in DEMAND PRIORITY order: on sustained
    stall the first growable depth knob grows (doubling, bounded);
    on sustained idleness the LAST grown knob shrinks back one step.
    Only ``live`` knobs are ever written.

    ``signal`` overrides the telemetry read — a zero-arg callable
    returning ``{"stall_fraction", "window_latency_p99"}``.  The
    default computes the WINDOWED stall fraction exactly as the
    Autoscaler does (deltas of ``consumer.wait`` minus admission waits
    over wall clock, per consumer) plus the shared histograms' p99.
    ``work`` overrides the never-worse guard's progress counter — a
    zero-arg callable returning cumulative work (default: the
    ``consumer.samples`` counter); throughput is its windowed rate.

    ``parity`` (optional) returns the current lossy-wire
    ``max_rel_drift`` (e.g. from a held-out
    :func:`~ddl_tpu_torch.parallel.optimizer.loss_parity` probe) or None;
    ``wire_knob`` is the binding the parity guard flips.  ``view`` +
    ``costs_probe`` (zero-arg → ``LinkCosts``) arm the placement-drift
    leg against ``base_costs``.
    """

    def __init__(
        self,
        knobs: List[TunableKnob],
        policy: Optional[ControllerPolicy] = None,
        metrics: Optional[Metrics] = None,
        clock: Callable[[], float] = time.monotonic,
        signal: Optional[Callable[[], Dict[str, float]]] = None,
        work: Optional[Callable[[], float]] = None,
        parity: Optional[Callable[[], Optional[float]]] = None,
        parity_tol: Optional[float] = None,
        wire_knob: Optional[TunableKnob] = None,
        view: Any = None,
        costs_probe: Optional[Callable[[], Any]] = None,
        base_costs: Any = None,
        n_consumers: int = 1,
        poll_interval_s: Optional[float] = None,
    ):
        self.knobs = [k for k in knobs if k.live]
        self.policy = policy or ControllerPolicy.from_env()
        self.metrics = metrics or default_metrics()
        self._clock = clock
        self._signal = signal or self._windowed_signal
        self._work = work or (
            lambda: float(self.metrics.counter("consumer.samples"))
        )
        self._parity = parity
        if parity_tol is None:
            from ddl_tpu_torch.parallel.optimizer import PARITY_REL_TOL

            parity_tol = PARITY_REL_TOL
        self.parity_tol = float(parity_tol)
        self.wire_knob = wire_knob
        self.view = view
        self._costs_probe = costs_probe
        self._costs = base_costs
        self.last_placement: Optional[Placement] = None
        self.n_consumers = max(1, int(n_consumers))
        self.poll_interval_s = (
            envspec.get("DDL_TORCH_TUNE_INTERVAL_S")
            if poll_interval_s is None
            else poll_interval_s
        )
        #: Audit trail (Decision records, calibration's shape).
        self.decisions: List[Decision] = []
        #: Baseline values knobs shrink back toward.
        self._baseline = {k.name: k.read() for k in self.knobs}
        #: Knobs grown above baseline, newest last (shrink order).
        self._grown: List[TunableKnob] = []
        self._pending: Optional[_PendingChange] = None
        self._wire_flipped = False
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._last_action_t = -float("inf")
        self._last_wait_s = (
            self.metrics.timer("consumer.wait").total_s
            - self.metrics.timer("serve.admission_wait").total_s
        )
        self._last_wall = self._clock()
        self._last_work = self._work()
        self._rate_wall = self._last_wall
        self._last_rate = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- signals -----------------------------------------------------------

    def _windowed_signal(self) -> Dict[str, float]:
        """Stall fraction over the span since the previous reading
        (the Autoscaler's windowed read: a cumulative fraction would
        dilute a fresh stall under a long quiet history), plus the
        shared window-latency p99."""
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
            "window_latency_p99": self.metrics.quantile(
                "consumer.window_latency", 0.99
            ),
        }

    def _rate(self, now: float) -> float:
        """Windowed throughput (work units/s) since the last reading."""
        work = self._work()
        dt = max(now - self._rate_wall, 1e-9)
        rate = (work - self._last_work) / dt
        self._last_work = work
        self._rate_wall = now
        return max(0.0, rate)

    # -- decision plumbing -------------------------------------------------

    def _record(
        self,
        knob: str,
        old: Any,
        new: Any,
        reason: str,
        signals: Dict[str, float],
        revert: bool = False,
    ) -> None:
        d = Decision(
            knob=knob, old=old, new=new, cost_source=COST_MEASURED,
            reason=reason, signals=dict(signals),
        )
        self.decisions.append(d)
        self.metrics.incr("tune.decisions")
        self.metrics.incr(f"tune.cost_source.{COST_MEASURED}")
        if revert:
            self.metrics.incr("tune.reverts")
        flight_note(
            "tune", f"{'revert' if revert else 'retune'}.{knob}",
            _numeric(new),
        )
        logger.warning(
            "tune: %s %s %r -> %r (%s)",
            "REVERT" if revert else "retune", knob, old, new, reason,
        )

    # -- one policy evaluation ---------------------------------------------

    def step(self, now: Optional[float] = None) -> Optional[str]:
        """Evaluate the loop once; returns the action taken
        (``"grow"`` / ``"shrink"`` / ``"revert"`` / ``"wire_raw"`` /
        ``"replan"`` / ``None``).  Driven by :meth:`start`'s loop or
        called directly (tests, a window hook, a fake clock)."""
        fault_point("tune.step")
        now = self._clock() if now is None else now
        sig = self._signal()
        rate = self._rate(now)

        # 1. Safety first: the parity guard ignores pacing entirely.
        acted = self._parity_guard(sig)
        if acted:
            self._last_rate = rate
            return acted

        # 2. Judge the open never-worse window before anything else —
        # a pending change must be accepted or reverted before the
        # controller may act again (the cooldown enforces the order).
        if self._pending is not None:
            acted = self._judge_pending(now, sig)
            if acted:
                self._last_rate = rate
                return acted

        # 3. Placement drift (no knob write; pacing still applies so a
        # noisy probe cannot replan every tick).
        if now - self._last_action_t >= self.policy.cooldown_s:
            acted = self._drift_replan(now, sig)
            if acted:
                self._last_rate = rate
                return acted

        # 4. Hysteresis over the stall band (the Autoscaler mechanics).
        action = self._hysteresis(now, sig, rate)
        self._last_rate = rate
        return action

    def _parity_guard(self, sig: Dict[str, float]) -> Optional[str]:
        if (
            self._parity is None
            or self.wire_knob is None
            or self._wire_flipped
        ):
            return None
        drift = self._parity()
        if drift is None:
            return None
        current = self.wire_knob.read()
        if current == "raw":
            return None
        budget = self.parity_headroom_budget()
        if drift <= budget:
            return None
        self.wire_knob.write("raw")
        self._wire_flipped = True
        self._record(
            self.wire_knob.name, current, "raw",
            f"parity headroom shrank: drift {drift:.3e} > "
            f"{self.policy.parity_headroom:.2f} x tol {self.parity_tol:.3e}",
            {**sig, "max_rel_drift": drift},
        )
        return "wire_raw"

    def parity_headroom_budget(self) -> float:
        """The drift level at which the lossy wire is no longer safe."""
        return self.policy.parity_headroom * self.parity_tol

    def _judge_pending(
        self, now: float, sig: Dict[str, float]
    ) -> Optional[str]:
        p = self._pending
        assert p is not None
        if now - p.opened_t < self.policy.cooldown_s:
            return None  # the observation window is still open
        dt = max(now - p.opened_t, 1e-9)
        post_rate = max(0.0, (self._work() - p.work0) / dt)
        floor = p.pre_rate * (1.0 - self.policy.revert_tol)
        self._pending = None
        if p.pre_rate > 0 and post_rate < floor:
            p.knob.write(p.old)
            if self._grown and self._grown[-1] is p.knob:
                self._grown.pop()
            self._record(
                p.knob.name, p.new, p.old,
                f"never-worse: post-change {post_rate:.1f}/s < "
                f"{floor:.1f}/s ({(1 - self.policy.revert_tol):.2f} x "
                f"pre-change {p.pre_rate:.1f}/s)",
                {**sig, "post_rate": post_rate, "pre_rate": p.pre_rate},
                revert=True,
            )
            # A reverted knob starts a fresh cooldown: the system needs
            # a clean window before the next experiment.
            self._last_action_t = now
            return "revert"
        return None  # accepted: the change stands

    def _drift_replan(
        self, now: float, sig: Dict[str, float]
    ) -> Optional[str]:
        if (
            self._costs_probe is None
            or self.view is None
            or self._costs is None
        ):
            return None
        try:
            fresh = self._costs_probe()
        except (ShutdownRequested, KeyboardInterrupt):
            raise
        except Exception:  # noqa: BLE001 - a dead probe never kills the loop
            logger.exception("tune: cost probe raised; continuing")
            return None
        plan = replan_on_drift(
            self.view, self._costs, fresh, self.policy.drift_rel_tol
        )
        if plan is None:
            return None
        self.last_placement = plan
        self._costs = fresh
        self._last_action_t = now
        self.metrics.incr("tune.replans")
        self._record(
            "placement", None, list(plan.assignment),
            f"measured link costs drifted beyond "
            f"{self.policy.drift_rel_tol:.2f}",
            sig,
        )
        return "replan"

    def _hysteresis(
        self, now: float, sig: Dict[str, float], rate: float
    ) -> Optional[str]:
        pol = self.policy
        stall = float(sig.get("stall_fraction", 0.0))
        p99 = float(sig.get("window_latency_p99", 0.0) or 0.0)
        demand = stall >= pol.up_stall_fraction or (
            pol.up_latency_p99_s > 0 and p99 >= pol.up_latency_p99_s
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
        else:  # the dead band: hold state, run no timers (no flapping)
            self._above_since = None
            self._below_since = None
        if now - self._last_action_t < pol.cooldown_s:
            return None
        if (
            self._above_since is not None
            and now - self._above_since >= pol.sustain_s
        ):
            return self._grow(now, sig, rate)
        if (
            self._below_since is not None
            and now - self._below_since >= pol.sustain_s
        ):
            return self._shrink(now, sig, rate)
        return None

    def _open_pending(
        self, knob: TunableKnob, old: Any, new: Any, now: float,
        rate: float,
    ) -> None:
        self._pending = _PendingChange(
            knob=knob, old=old, new=new, opened_t=now,
            work0=self._work(), pre_rate=rate or self._last_rate,
        )
        self._last_action_t = now
        self._above_since = None
        self._below_since = None

    def _grow(
        self, now: float, sig: Dict[str, float], rate: float
    ) -> Optional[str]:
        """Double the first depth knob with headroom (priority order)."""
        for knob in self.knobs:
            old = knob.read()
            if not isinstance(old, (int, float)) or isinstance(old, bool):
                continue
            new = knob.clamp(type(old)(old * 2))
            if new == old:
                continue  # at its ceiling; try the next knob
            knob.write(new)
            if knob not in self._grown:
                self._grown.append(knob)
            self._open_pending(knob, old, new, now, rate)
            self._record(
                knob.name, old, new,
                f"sustained stall {sig.get('stall_fraction', 0.0):.3f} "
                f">= {self.policy.up_stall_fraction:.3f} for "
                f"{self.policy.sustain_s:.1f}s",
                sig,
            )
            return "grow"
        return None  # every knob at its ceiling: demand without supply

    def _shrink(
        self, now: float, sig: Dict[str, float], rate: float
    ) -> Optional[str]:
        """Step the most recently grown knob back toward baseline."""
        while self._grown:
            knob = self._grown[-1]
            old = knob.read()
            base = self._baseline.get(knob.name, old)
            if not isinstance(old, (int, float)) or old <= base:
                self._grown.pop()
                continue
            halved = old // 2 if isinstance(old, int) else old / 2
            new = knob.clamp(type(old)(max(base, halved)))
            if new == old:
                self._grown.pop()
                continue
            knob.write(new)
            if new <= base:
                self._grown.pop()
            self._open_pending(knob, old, new, now, rate)
            self._record(
                knob.name, old, new,
                f"sustained idle {sig.get('stall_fraction', 0.0):.3f} "
                f"<= {self.policy.down_stall_fraction:.3f} for "
                f"{self.policy.sustain_s:.1f}s: reclaiming headroom",
                sig,
            )
            return "shrink"
        return None  # nothing above baseline: idleness costs nothing

    def retune(self, policy: ControllerPolicy) -> None:
        """Swap the policy live (the Autoscaler.retune contract: sustain
        timers reset, the cooldown clock is kept)."""
        self.policy = policy
        self._above_since = None
        self._below_since = None

    def report(self) -> dict:
        """The report block body (calibration's shape)."""
        return {
            "decisions": [d.as_dict() for d in self.decisions],
            "reverts": int(self.metrics.counter("tune.reverts")),
            "replans": int(self.metrics.counter("tune.replans")),
            "wire_flipped": self._wire_flipped,
        }

    # -- the background loop (a timed stop-event wait) ---------------------

    def start(self) -> "KnobController":
        self._thread = threading.Thread(
            target=self._run, name="ddl-tune", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.poll_interval_s * 2 + 1)

    def __enter__(self) -> "KnobController":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    def _run(self) -> None:
        # Bounded by the stop event's timed wait; step()
        # does bounded work (one signal read, at most one knob write).
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.step()
            except (ShutdownRequested, KeyboardInterrupt):
                return  # teardown reached the policy loop: stop cleanly
            except Exception:
                # A crashing step must never silently disable tuning
                # (the Autoscaler._run contract).
                logger.exception("tune: controller step raised; continuing")
                continue
