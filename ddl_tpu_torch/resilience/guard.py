"""Preemption notice → deadline-bounded graceful drain (port of
``ddl_tpu/resilience/guard.py``).

A spot or preemptible machine gets a SIGTERM (or an agent sets an env
knob) and a fixed grace budget before the hard kill.
:class:`PreemptionGuard` turns that notice into an ordered drain the
trainer runs at its next window boundary:

1. **Forced final checkpoint** (the trainer's thunk): train state and the
   fenced loader cursor, durably written — the restarted job loses no
   step.  Always attempted first, even at a blown deadline.
2. **In-flight window revocation** — ``admission.revoke_inflight(slo)``
   when an ``admission`` controller is given (duck-typed; the serving
   layer is a later slice).
3. **Graceful host drain** — ``cluster.drain_host(host_id)`` when a
   ``cluster`` and ``host_id`` are given (duck-typed likewise).
4. **Clean producer shutdown** — the loader's shutdown, so the watchdog
   records no failure.

Each rung after the checkpoint runs only while grace budget remains; a
rung whose turn comes after the deadline is skipped, counted
``resilience.drain_rungs_skipped``.

Notice sources: a SIGTERM handler (:meth:`install`), the
``DDL_TORCH_PREEMPT_NOTICE`` knob (optionally carrying the grace seconds
as its value), a programmatic :meth:`notify`, or the
``resilience.notice`` fault site (:mod:`ddl_tpu_torch.faults`), whose
``PREEMPT_NOTICE`` :meth:`poll` absorbs as a notice carrying the spec's
grace seconds.  An armed flight recorder (:mod:`ddl_tpu_torch.obs.
recorder`) dumps once per notice, at the first :meth:`poll` or
:meth:`drain` after it — never inside :meth:`notify`, which may run in
the SIGTERM handler.
"""

from __future__ import annotations

import logging
import signal
import time
from typing import Any, Callable, Optional

from ddl_tpu_torch import envspec
from ddl_tpu_torch.concurrency import named_rlock
from ddl_tpu_torch.exceptions import (
    CheckpointError,
    DDLError,
    PreemptionNotice,
    ShutdownRequested,
)
from ddl_tpu_torch.faults import fault_point
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics

logger = logging.getLogger("ddl_tpu_torch")

#: Env knob: any value but 0/off/false is a standing preemption notice;
#: a float value overrides the grace budget (seconds).
NOTICE_ENV = "DDL_TORCH_PREEMPT_NOTICE"
#: Env knob: default grace budget when the notice carries none.
DEADLINE_ENV = "DDL_TORCH_PREEMPT_DEADLINE_S"
#: Fallback grace budget (a common spot notice is 30 s).
DEFAULT_DEADLINE_S = 30.0


class PreemptionGuard:
    """One training run's preemption handler::

        guard = PreemptionGuard()
        trainer = Trainer(..., checkpoint_dir=d, preemption_guard=guard)
        with guard:                       # installs the SIGTERM handler
            res = trainer.fit(...)
        if res.preempted:
            ...                           # exit; a restart resumes

    Thread-safe: a signal handler or a watcher thread may :meth:`notify`
    while the trainer polls at window boundaries.
    """

    def __init__(
        self,
        deadline_s: Optional[float] = None,
        cluster: Any = None,
        host_id: Optional[int] = None,
        admission: Any = None,
        revoke_slo_s: float = 1.0,
        metrics: Optional[Metrics] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if deadline_s is None:
            deadline_s = envspec.get(DEADLINE_ENV)
        if deadline_s <= 0:
            raise DDLError(f"preemption deadline must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.cluster = cluster
        self.host_id = host_id
        self.admission = admission
        self.revoke_slo_s = float(revoke_slo_s)
        self.metrics = metrics or default_metrics()
        self._clock = clock
        # Re-entrant: the SIGTERM handler runs on the main thread between
        # bytecodes, possibly while that thread holds this lock (every
        # drain rung calls remaining()).
        self._lock = named_rlock("resilience.guard")
        self._notice_t: Optional[float] = None
        self._reason = ""
        self._drained = False
        # The flight dump of a notice is deferred to poll()/drain() on
        # the main thread (_flight_dump_once).
        self._flight_dumped = False
        self._prev_handler: Any = None
        self._installed = False

    # -- notice sources ----------------------------------------------------

    def install(self) -> "PreemptionGuard":
        """Install the SIGTERM handler (main thread only; elsewhere the
        env and programmatic sources still work, logged)."""
        try:
            self._prev_handler = signal.signal(signal.SIGTERM, self._on_sigterm)
            self._installed = True
        except ValueError:
            logger.warning(
                "resilience: SIGTERM handler not installed (not the main "
                "thread) — env/programmatic notice still observed"
            )
        return self

    def uninstall(self) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev_handler)
            self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc: Any) -> None:
        self.uninstall()

    def _on_sigterm(self, signum: int, frame: Any) -> None:
        # Set the flag; the trainer drains at its next window boundary.
        self.notify("SIGTERM")

    def notify(self, reason: str = "", deadline_s: Optional[float] = None) -> None:
        """Record a preemption notice (the first one wins).  ``deadline_s``
        overrides the grace budget when the notice carries its own."""
        with self._lock:
            if self._notice_t is not None:
                return
            self._notice_t = self._clock()
            self._reason = reason or "notice"
            if deadline_s is not None and deadline_s > 0:
                self.deadline_s = float(deadline_s)
        self.metrics.incr("resilience.notices")
        logger.warning(
            "resilience: preemption notice (%s) — graceful drain within "
            "%.1fs at the next window boundary", self._reason, self.deadline_s,
        )

    def _flight_dump_once(self) -> None:
        """Dump the armed flight recorder once per notice: the pipeline's
        state at the notice, the picture a drain that overruns its budget
        needs.  Called on the main thread only (poll, drain): inside the
        SIGTERM handler a dump (registry lock, recorder lock, file IO)
        could need a lock the interrupted frame holds."""
        if self._flight_dumped or self._notice_t is None:
            return
        self._flight_dumped = True
        from ddl_tpu_torch.obs.recorder import flight_dump

        flight_dump("resilience.preemption_notice", metrics=self.metrics,
                    extra={"reason": self._reason,
                           "grace_s": self.deadline_s})

    def poll(self) -> bool:
        """The trainer's once-per-window-boundary check: True once a
        notice is pending (signal, env knob, or a prior :meth:`notify`)."""
        if self._notice_t is not None:
            self._flight_dump_once()
            return True
        try:
            fault_point("resilience.notice")
        except PreemptionNotice as n:
            self.notify("injected", deadline_s=n.deadline_s or None)
            self._flight_dump_once()
            return True
        env = envspec.raw(NOTICE_ENV) or ""
        if env and env.lower() not in envspec.FALSY:
            try:
                deadline: Optional[float] = float(env)
            except ValueError:
                deadline = None
            self.notify(f"{NOTICE_ENV}={env}", deadline_s=deadline)
            self._flight_dump_once()
            return True
        return False

    @property
    def pending(self) -> bool:
        return self._notice_t is not None

    @property
    def drained(self) -> bool:
        return self._drained

    def remaining(self) -> float:
        """Grace budget left (seconds); the full budget before a notice."""
        with self._lock:
            if self._notice_t is None:
                return self.deadline_s
            return max(0.0, self.deadline_s - (self._clock() - self._notice_t))

    # -- the drain ladder --------------------------------------------------

    def drain(self, final_checkpoint: Optional[Callable[[], None]] = None,
              shutdown: Optional[Callable[[], None]] = None) -> bool:
        """Run the drain ladder under the remaining grace budget.  The
        checkpoint thunk runs first and always; the rungs after it only
        while budget remains.  Returns True when every applicable rung
        completed inside the budget."""
        t0 = self._clock()
        # A notify followed by a drain with no poll between still dumps;
        # drain runs on the main thread.
        self._flight_dump_once()
        self.metrics.incr("resilience.drains")
        within = True
        if final_checkpoint is not None:
            try:
                final_checkpoint()
            except CheckpointError:
                logger.exception(
                    "resilience: forced final checkpoint FAILED — the "
                    "restart resumes from the previous generation"
                )
                self.metrics.incr("resilience.final_ckpt_failures")
        within &= self._rung(
            "revoke_inflight",
            self._revoke_rung if self.admission is not None else None,
        )
        within &= self._rung(
            "drain_host",
            self._drain_host_rung
            if self.cluster is not None and self.host_id is not None
            else None,
        )
        within &= self._rung("shutdown", shutdown)
        dt = self._clock() - t0
        self.metrics.add_time("resilience.drain", dt)
        within = within and self.remaining() > 0
        self.metrics.set_gauge("resilience.drain_within_deadline",
                               1.0 if within else 0.0)
        self._drained = True
        logger.warning(
            "resilience: drain complete in %.2fs (%s the %.1fs budget)",
            dt, "within" if within else "OVER", self.deadline_s,
        )
        return within

    def _rung(self, name: str, action: Optional[Callable[[], None]]) -> bool:
        if action is None:
            return True
        if self.remaining() <= 0:
            self.metrics.incr("resilience.drain_rungs_skipped")
            logger.error(
                "resilience: drain rung %r SKIPPED — grace budget exhausted",
                name,
            )
            return False
        try:
            action()
        except (ShutdownRequested, KeyboardInterrupt):
            raise
        except Exception:
            # A failed hygiene rung never aborts the drain: the checkpoint
            # already landed and a restart recovers.
            logger.exception("resilience: drain rung %r failed", name)
            self.metrics.incr("resilience.drain_rung_failures")
        return True

    def _revoke_rung(self) -> None:
        slo = min(self.revoke_slo_s, max(0.0, self.remaining()))
        self.admission.revoke_inflight(slo)
        self.metrics.incr("resilience.revocations")

    def _drain_host_rung(self) -> None:
        self.cluster.drain_host(self.host_id)
