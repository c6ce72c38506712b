"""Multi-tenant admission: fair-share scheduling at the ring-acquire seam
(port of ``ddl_tpu/serve/tenancy.py``).

Independent :class:`~ddl_tpu_torch.dataloader.DistributedDataLoader` jobs
register as **tenants** against one producer pool and one shard-cache
tier, and a deficit-round-robin (DRR) fair-share scheduler arbitrates
every window acquisition at the loader's acquire seam
(``DistributedDataLoader._acquire_verified``, where a bound admission
gate runs before any ring wait).

- **Charge-after DRR.**  ``admit()`` blocks until the tenant is
  *grantable*; the byte charge lands at ``note_served(nbytes)`` (a
  window's size is known only after the acquire).  A tenant may overshoot
  its fair share by at most ONE window (the DRR burst bound) and is then
  held until a replenish round restores its deficit.  Rounds advance only
  when no waiting tenant is grantable, so a backlogged tenant is never
  starved: per round every tenant earns ``quantum_bytes * weight`` of
  credit, capped at one round's worth.
- **Byte budget.**  ``byte_budget_per_s`` is a token bucket (charged at
  ``note_served``, refilled by the clock): a tenant over its rate waits
  for the refill even when the DRR would grant it.
- **Slot budget.**  ``slot_budget`` caps the windows a tenant is granted
  per DRR round.
- **Bounded waits.**  ``admit`` is deadline-bounded and wakes on a timed
  condition wait: a wedged peer ages a tenant's wait into
  :class:`~ddl_tpu_torch.exceptions.StallTimeoutError`, never a spin.

Per-tenant metrics use the ``ingest.<tenant>.*`` family (``bytes`` /
``windows`` / ``bursts`` counters, the ``admission_wait`` timer and
histogram), read back with :meth:`Metrics.prefixed` in
:meth:`AdmissionController.report`; aggregates live under ``serve.*``
(``serve.admissions``, ``serve.tenant_bursts``, ``serve.rounds``,
``serve.revocations``, the ``serve.admission_wait`` timer, the
``serve.tenants`` gauge).

Chaos: the ``serve.admit`` site fires once per admission attempt
(``producer_idx`` is the tenant's registration index); ``TENANT_BURST``
raises :class:`~ddl_tpu_torch.exceptions.TenantBurst`, which the
scheduler absorbs as phantom demand charged to the burster's own share.
"""


from __future__ import annotations

import dataclasses
import logging
import threading

from ddl_tpu_torch.concurrency import named_condition
import time
from typing import Callable, Dict, Optional

from ddl_tpu_torch.exceptions import (
    DDLError,
    StallTimeoutError,
    TenantBurst,
    WindowsRevoked,
)
from ddl_tpu_torch.faults import fault_point
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics

logger = logging.getLogger("ddl_tpu_torch")

#: Default DRR quantum: credit earned per tenant per replenish round,
#: scaled by the tenant's weight: one round buys one 4 MiB window for a
#: weight-1.0 tenant.
DEFAULT_QUANTUM_BYTES = 4 << 20


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's admission contract.

    ``weight`` scales the DRR quantum (2.0 = twice the fair share);
    ``byte_budget_per_s`` caps sustained throughput (0 = uncapped);
    ``slot_budget`` caps windows granted per DRR round (0 = uncapped).
    """

    name: str
    weight: float = 1.0
    byte_budget_per_s: float = 0.0
    slot_budget: int = 0

    def __post_init__(self) -> None:
        if not self.name or "." in self.name:
            # The name becomes a metrics key segment (ingest.<name>.*):
            # a dot would alias into another family's namespace.
            raise DDLError(f"invalid tenant name {self.name!r}")
        if self.weight <= 0:
            raise DDLError(f"tenant weight must be > 0, got {self.weight}")
        if self.byte_budget_per_s < 0 or self.slot_budget < 0:
            raise DDLError("tenant budgets must be >= 0")


class _TenantState:
    """Scheduler-internal per-tenant accounting (guarded by the
    scheduler's condition lock)."""

    def __init__(self, spec: TenantSpec, index: int, now: float):
        self.spec = spec
        self.index = index
        self.deficit = 0.0
        # Token bucket: starts one second full so a fresh tenant's first
        # window is never budget-blocked; refilled lazily from `stamp`.
        self.tokens = float(spec.byte_budget_per_s)
        self.stamp = now
        self.served_in_round = 0
        self.waiting = 0
        # The preemption and scale-down seam: windows granted by
        # admit() but not yet charged at note_served() — the in-flight
        # set revoke_inflight waits out under its SLO.
        self.inflight = 0
        self.revoked = False

    def refill(self, now: float) -> None:
        rate = self.spec.byte_budget_per_s
        if rate <= 0:
            return
        self.tokens = min(
            rate, self.tokens + rate * max(0.0, now - self.stamp)
        )
        self.stamp = now


class FairShareScheduler:
    """Deficit-round-robin arbiter over registered tenants.

    Thread-safe: every tenant's consumer thread calls :meth:`admit` /
    :meth:`note_served` concurrently; all state lives under one
    condition lock.  The scheduler never touches rings — it only decides
    *when* a tenant's next ring acquire may proceed.
    """

    def __init__(
        self,
        quantum_bytes: int = DEFAULT_QUANTUM_BYTES,
        metrics: Optional[Metrics] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if quantum_bytes <= 0:
            raise DDLError(f"quantum_bytes must be > 0, got {quantum_bytes}")
        self.quantum_bytes = float(quantum_bytes)
        self.metrics = metrics or default_metrics()
        self._clock = clock
        self._cond = named_condition("serve.tenancy.cond")
        # name -> state: bounded by the registered tenant set
        # (register/unregister are the only growth/shrink sites).
        self._tenants: Dict[str, _TenantState] = {}  # ddl-lint: disable=DDL013
        self._next_index = 0
        self._round = 0

    # -- registration ------------------------------------------------------

    def register(self, spec: TenantSpec) -> None:
        with self._cond:
            if spec.name in self._tenants:
                raise DDLError(f"tenant {spec.name!r} is already registered")
            self._tenants[spec.name] = _TenantState(
                spec, self._next_index, self._clock()
            )
            self._next_index += 1
            self.metrics.set_gauge("serve.tenants", len(self._tenants))
            self._cond.notify_all()

    def unregister(self, name: str) -> None:
        with self._cond:
            if self._tenants.pop(name, None) is not None:
                self.metrics.set_gauge("serve.tenants", len(self._tenants))
                # A departing tenant may have been the only non-grantable
                # waiter blocking a round advance — wake the others.
                self._cond.notify_all()
        # Retire the departed tenant's stall gauge WITH its ``.max``
        # high-water companion: a stale ``serve.stall.<name>.max``
        # would keep north_star_report's per-tenant dict reporting a
        # tenant that no longer exists.
        self.metrics.clear_gauge(f"serve.stall.{name}")

    def tenants(self) -> "list[str]":
        with self._cond:
            return sorted(self._tenants)

    # -- the admission gate ------------------------------------------------

    def admit(self, name: str, timeout_s: float) -> None:
        """Block until ``name`` is grantable (deadline-bounded).

        ``timeout_s <= 0`` is the NON-BLOCKING probe the loader's
        lookahead deepening uses: not-grantable raises
        :class:`StallTimeoutError` immediately (the deepening loop
        treats it exactly like a not-yet-committed window).
        """
        st = self._state(name)
        try:
            # Chaos site (producer_idx = tenant registration index).
            fault_point("serve.admit", producer_idx=st.index)
        except TenantBurst as burst:
            self._charge_burst(name, st, burst.burst_bytes)
        t0 = time.perf_counter()
        deadline = self._clock() + max(0.0, timeout_s)
        with self._cond:
            st.waiting += 1
            try:
                while True:
                    if st.revoked:
                        # Preemption or scale-down revocation:
                        # the typed wake-up — never a silent timeout.
                        self.metrics.incr("serve.revoked_waiters")
                        self.metrics.incr(f"ingest.{name}.revocations")
                        raise WindowsRevoked(
                            f"tenant {name!r} admission revoked "
                            "(preemption/scale-down drain in progress)"
                        )
                    st.refill(self._clock())
                    if self._grantable(st):
                        st.inflight += 1
                        break
                    if self._advance_round_if_stuck():
                        # Rounds replenish instantly (they are logical,
                        # not wall-clock): re-check without sleeping —
                        # a multi-quantum window costs loop passes, not
                        # 50 ms apiece.  Terminates because each round
                        # adds >= quantum * weight credit and rounds
                        # only advance while NO waiter is grantable.
                        continue
                    now = self._clock()
                    if now >= deadline:
                        raise StallTimeoutError(
                            f"tenant {name!r} admission not granted "
                            f"within {timeout_s}s (deficit "
                            f"{st.deficit:.0f}, tokens {st.tokens:.0f}, "
                            f"round slots {st.served_in_round})"
                        )
                    self._cond.wait(min(0.05, deadline - now))
            finally:
                st.waiting -= 1
        wait = time.perf_counter() - t0
        self.metrics.incr("serve.admissions")
        self.metrics.add_time("serve.admission_wait", wait)
        self.metrics.add_time(f"ingest.{name}.admission_wait", wait)
        # The global and per-tenant admission-wait distributions land in
        # bounded log-spaced histograms: north_star_report's
        # admission_wait_p99 and the per-tenant p99s read them back.
        self.metrics.observe("serve.admission_wait", wait)
        self.metrics.observe(f"ingest.{name}.admission_wait", wait)

    def note_aborted(self, name: str) -> None:
        """Release a grant whose ring acquire FAILED (stall timeout,
        revoked target, shutdown): the window was never served, so
        nothing is charged — but the in-flight count must come back
        down, or every later :meth:`revoke_inflight` would burn its
        full SLO waiting on a phantom grant."""
        with self._cond:
            st = self._tenants.get(name)
            if st is not None:
                st.inflight = max(0, st.inflight - 1)
                self._cond.notify_all()

    def note_served(self, name: str, nbytes: int) -> None:
        """Charge one served window against ``name``'s share + budgets
        (the charge-after half of :meth:`admit`)."""
        nbytes = int(nbytes)
        with self._cond:
            st = self._tenants.get(name)
            if st is None:
                return  # unregistered mid-flight: nothing left to charge
            st.refill(self._clock())
            st.deficit -= nbytes
            if st.spec.byte_budget_per_s > 0:
                st.tokens -= nbytes
            st.served_in_round += 1
            st.inflight = max(0, st.inflight - 1)
            self._cond.notify_all()
        self.metrics.incr(f"ingest.{name}.bytes", float(nbytes))
        self.metrics.incr(f"ingest.{name}.windows")

    # -- preemption / scale-down revocation --------------------------------

    def revoke_inflight(
        self, slo_s: float, names: "Optional[list] | None" = None
    ) -> bool:
        """Revoke active tenants' in-flight windows under an SLO —
        the scale-down/preemption rung: instead of
        waiting for tenant idleness, every waiting ``admit`` wakes with
        the typed :class:`WindowsRevoked` and the already-GRANTED
        windows (admit returned, ``note_served`` pending — at most one
        per consumer thread, the DRR burst bound) are waited out for at
        most ``slo_s`` seconds.  Size the SLO from the per-tenant p99
        window latency: one p99 is the time a granted window
        legitimately needs to finish its ring acquire.

        ``names=None`` revokes every registered tenant (a whole-host
        drain); a list narrows it.  Returns True when all revoked
        in-flight windows completed inside the SLO.  Revoked tenants
        stay refused until :meth:`clear_revocations` (rejoin).
        """
        deadline = self._clock() + max(0.0, slo_s)
        with self._cond:
            targets = [
                st
                for n, st in self._tenants.items()
                if names is None or n in names
            ]
            for st in targets:
                st.revoked = True
            self._cond.notify_all()
            # ONE bounded wait per pass: the fan-out
            # above only flips flags; the SLO wait lives outside it.
            while any(st.inflight > 0 for st in targets):
                rem = deadline - self._clock()
                if rem <= 0:
                    break
                self._cond.wait(min(0.05, rem))
            leftover = sum(st.inflight for st in targets)
        self.metrics.incr("serve.revocations")
        if leftover:
            self.metrics.incr("serve.revoked_inflight", float(leftover))
            logger.warning(
                "serve: %d in-flight window(s) still unfinished at the "
                "%.2fs revocation SLO — proceeding with the drain",
                leftover, slo_s,
            )
        return leftover == 0

    def clear_revocations(
        self, names: "Optional[list] | None" = None
    ) -> None:
        """Re-admit previously revoked tenants (the rejoin edge)."""
        with self._cond:
            for n, st in self._tenants.items():
                if names is None or n in names:
                    st.revoked = False
            self._cond.notify_all()

    # -- failover state transfer (ddl_tpu_torch.cluster.supervision) -------------

    def export_state(self, now: Optional[float] = None) -> dict:
        """Snapshot the full DRR ledger as a JSON-serializable dict —
        the supervisor journal's scheduler record.

        Clock handling: absolute token-bucket stamps are exported
        together with the export-time ``now``; :meth:`adopt_state`
        shifts them by its own clock delta, so a snapshot adopted with
        the same ``now`` roundtrips BIT-EXACT (the property the
        failover suite pins) and one adopted later ages the buckets by
        exactly the elapsed gap.  Live thread state (``waiting`` — the
        blocked callers themselves) is deliberately NOT exported: a
        promoted standby has its own callers; the ledger (deficits,
        buckets, round/slot counters, in-flight grants, revocation
        flags) is what fairness continuity needs.
        """
        with self._cond:
            if now is None:
                now = self._clock()
            return {
                "version": 1,
                "now": float(now),
                "quantum_bytes": self.quantum_bytes,
                "round": self._round,
                "next_index": self._next_index,
                "tenants": {
                    name: {
                        "spec": {
                            "name": st.spec.name,
                            "weight": st.spec.weight,
                            "byte_budget_per_s": st.spec.byte_budget_per_s,
                            "slot_budget": st.spec.slot_budget,
                        },
                        "index": st.index,
                        "deficit": st.deficit,
                        "tokens": st.tokens,
                        "stamp": st.stamp,
                        "served_in_round": st.served_in_round,
                        "inflight": st.inflight,
                        "revoked": st.revoked,
                    }
                    for name, st in self._tenants.items()
                },
            }

    def adopt_state(self, state: dict, now: Optional[float] = None) -> None:
        """Replace this scheduler's ledger with an exported snapshot
        (the promoted standby's half of :meth:`export_state`).

        The adopted scheduler grants the same next-admission order the
        snapshot's owner would have: deficits, buckets (aged by the
        export→adopt clock gap), per-round slot counters, and the DRR
        round/registration cursors all carry over.
        """
        if state.get("version") != 1:
            raise DDLError(
                f"unknown scheduler snapshot version {state.get('version')!r}"
            )
        with self._cond:
            if now is None:
                now = self._clock()
            shift = float(now) - float(state["now"])
            self.quantum_bytes = float(state["quantum_bytes"])
            self._round = int(state["round"])
            self._next_index = int(state["next_index"])
            adopted: Dict[str, _TenantState] = {}
            for name, t in state["tenants"].items():
                spec = TenantSpec(**t["spec"])
                st = _TenantState(spec, int(t["index"]), float(now))
                st.deficit = float(t["deficit"])
                st.tokens = float(t["tokens"])
                st.stamp = float(t["stamp"]) + shift
                st.served_in_round = int(t["served_in_round"])
                st.inflight = int(t["inflight"])
                st.revoked = bool(t["revoked"])
                adopted[name] = st
            self._tenants = adopted
            self.metrics.set_gauge("serve.tenants", len(self._tenants))
            self._cond.notify_all()

    # -- internals (condition lock held) -----------------------------------

    def _state(self, name: str) -> _TenantState:
        with self._cond:
            st = self._tenants.get(name)
            if st is None:
                raise DDLError(f"tenant {name!r} is not registered")
            return st

    def _grantable(self, st: _TenantState) -> bool:
        if st.spec.byte_budget_per_s > 0 and st.tokens < 0:
            return False
        if st.spec.slot_budget > 0 and (
            st.served_in_round >= st.spec.slot_budget
        ):
            return False
        return st.deficit >= 0

    def _budget_blocked(self, st: _TenantState) -> bool:
        """Blocked by the WALL-CLOCK token bucket (only time heals it —
        a replenish round must not bypass the rate budget)."""
        return st.spec.byte_budget_per_s > 0 and st.tokens < 0

    def _advance_round_if_stuck(self) -> bool:
        """One DRR replenish round, taken only when every waiting tenant
        is blocked by deficit/slots (not by its wall-clock byte budget):
        everyone earns ``quantum * weight`` credit — capped at one
        round's worth — and the per-round slot counters reset.  Returns
        True when a round advanced (the caller re-checks immediately)."""
        waiters = [t for t in self._tenants.values() if t.waiting]
        if not waiters:
            return False
        if any(self._grantable(t) for t in waiters):
            return False  # someone can proceed; fairness says wait for them
        if all(self._budget_blocked(t) for t in waiters):
            return False  # only the clock may refill a rate budget
        self._round += 1
        for t in self._tenants.values():
            credit = self.quantum_bytes * t.spec.weight
            t.deficit = min(t.deficit + credit, credit)
            t.served_in_round = 0
        self.metrics.incr("serve.rounds")
        self._cond.notify_all()
        return True

    def _charge_burst(
        self, name: str, st: _TenantState, nbytes: float
    ) -> None:
        """Absorb an injected :class:`TenantBurst` as phantom demand:
        the burst bytes are charged to the BURSTING tenant's deficit and
        bucket, so its neighbours' shares are untouched and the burster
        simply waits out its own spike."""
        with self._cond:
            st.refill(self._clock())
            st.deficit -= nbytes
            if st.spec.byte_budget_per_s > 0:
                st.tokens -= nbytes
        self.metrics.incr("serve.tenant_bursts")
        self.metrics.incr(f"ingest.{name}.bursts")
        logger.warning(
            "serve: tenant %r absorbed an injected burst of %.0f bytes",
            name, nbytes,
        )


class Tenant:
    """One registered tenant's handle: the admission object a loader
    binds (``loader.bind_admission(tenant)`` — or ``tenant.bind(loader)``)
    so every ring acquire passes through the fair-share gate."""

    def __init__(self, controller: "AdmissionController", spec: TenantSpec):
        self.controller = controller
        self.spec = spec
        self.name = spec.name
        self._closed = False

    # The two-method admission protocol DistributedDataLoader speaks.

    def admit(self, timeout_s: float) -> None:
        self.controller.scheduler.admit(self.name, timeout_s)

    def note_served(self, nbytes: int) -> None:
        self.controller.scheduler.note_served(self.name, nbytes)

    def note_aborted(self) -> None:
        self.controller.scheduler.note_aborted(self.name)

    def revoke_inflight(self, slo_s: float) -> bool:
        """Revoke THIS tenant's in-flight windows under ``slo_s``."""
        return self.controller.scheduler.revoke_inflight(
            slo_s, names=[self.name]
        )

    def clear_revocations(self) -> None:
        self.controller.scheduler.clear_revocations(names=[self.name])

    def bind(self, loader) -> "Tenant":
        """Attach this tenant's admission gate to a loader (and hand it
        the shared shard-cache tier's store for its producers via
        ``controller.cache`` if the caller wires that themselves)."""
        loader.bind_admission(self)
        return self

    def metrics(self) -> Dict[str, float]:
        """This tenant's ``ingest.<name>.*`` family, prefix-stripped."""
        return self.controller.metrics.prefixed(f"ingest.{self.name}.")

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.controller._release(self.name)


class AdmissionController:
    """The tenancy facade: one shared scheduler + one shared shard-cache
    tier, fronted by :class:`Tenant` handles.

    ``cache`` is the shared :class:`~ddl_tpu_torch.cache.CacheStore` every
    tenant's producers should be constructed over (``cache=`` kwarg on
    the shard readers) — the controller does not inject it into
    producers itself (producer functions cross spawn boundaries), it
    just owns the single instance so N tenants share one warm tier.
    """

    def __init__(
        self,
        scheduler: Optional[FairShareScheduler] = None,
        cache=None,
        metrics: Optional[Metrics] = None,
    ):
        self.metrics = metrics or default_metrics()
        self.scheduler = scheduler or FairShareScheduler(
            metrics=self.metrics
        )
        self.cache = cache
        # name -> Tenant handle; bounded by the registered tenant set.
        self._handles: Dict[str, Tenant] = {}  # ddl-lint: disable=DDL013

    def register(self, spec: TenantSpec) -> Tenant:
        self.scheduler.register(spec)
        handle = Tenant(self, spec)
        self._handles[spec.name] = handle
        return handle

    def tenant(self, name: str) -> Tenant:
        return self._handles[name]

    def _release(self, name: str) -> None:
        self.scheduler.unregister(name)
        self._handles.pop(name, None)

    def revoke_inflight(self, slo_s: float) -> bool:
        """Revoke EVERY tenant's in-flight windows under ``slo_s`` —
        the whole-host drain the :class:`~ddl_tpu_torch.resilience.
        PreemptionGuard` runs; see
        :meth:`FairShareScheduler.revoke_inflight`."""
        return self.scheduler.revoke_inflight(slo_s)

    def clear_revocations(self) -> None:
        self.scheduler.clear_revocations()

    def report(self) -> dict:
        """Per-tenant ``ingest.<t>.*`` blocks plus the ``serve.*``
        aggregates.  Also
        refreshes the per-tenant ``serve.stall.<t>`` gauges (admission
        wait over scheduler wall time) that ``north_star_report``
        surfaces."""
        m = self.metrics
        elapsed = max(m.elapsed_s(), 1e-9)
        per_tenant = {}
        for name in self.scheduler.tenants():
            block = m.prefixed(f"ingest.{name}.")
            wait = m.timer(f"ingest.{name}.admission_wait")
            block["admission_wait_s"] = wait.total_s
            # First-class percentiles off the bounded histogram the
            # admit path observes into (ddl_tpu_torch.obs) — the same values
            # north_star_report's per-tenant dict surfaces.
            block["admission_wait_p50_s"] = m.quantile(
                f"ingest.{name}.admission_wait", 0.5
            )
            block["admission_wait_p99_s"] = m.quantile(
                f"ingest.{name}.admission_wait", 0.99
            )
            stall = wait.total_s / elapsed
            m.set_gauge(f"serve.stall.{name}", stall)
            block["stall_fraction"] = stall
            per_tenant[name] = block
        return {
            "tenants": per_tenant,
            "admissions": m.counter("serve.admissions"),
            "rounds": m.counter("serve.rounds"),
            "tenant_bursts": m.counter("serve.tenant_bursts"),
            "admission_wait_s": m.timer("serve.admission_wait").total_s,
        }

    def close(self) -> None:
        for name in list(self._handles):
            self._handles[name].close()
