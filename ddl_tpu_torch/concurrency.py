"""Named locks and the runtime lock-order sanitizer (port of
``ddl_tpu/concurrency.py``).

Every lock in the port is built through these factories, so a lock has
a name, and :data:`LOCK_ORDER` documents the hierarchy: a thread holding
a lock only takes locks that come later in it.

- **Disarmed** (the default) the factories return the raw ``threading``
  primitives: no wrapper, no cost per acquire.
- **Armed** (:func:`arm_sanitizer`, :class:`sanitized`) they return thin
  proxies that record each thread's held stack and flag an acquisition
  that inverts the order: ``violations`` holds ``(acquiring, holding,
  thread name, held stack)``, and an armed flight recorder
  (:mod:`ddl_tpu_torch.obs.recorder`) dumps a witness.  Only locks built
  while armed are watched, so arm before building the pipeline.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

#: The port's lock hierarchy, outermost first.
LOCK_ORDER: Tuple[str, ...] = (
    # The cluster control plane: the supervisor (and its HA tier) fans
    # out into everything below; the lease table is taken under it.
    "cluster.supervisor",
    "cluster.membership",
    # The fabric's admission authority: its apply path holds the fabric
    # lock while consulting the job registry and driving the scheduler,
    # never the reverse.
    "serve.fabric",
    "serve.fabric.jobs",
    "serve.tenancy.cond",
    # The preemption guard's lock: its drain ladder runs the checkpoint
    # flush and the loader's shutdown under nothing, but a notice may
    # arrive while any lock below is held.
    "resilience.guard",
    "transport.connection",
    # The async checkpoint writer's queue: the step loop submits to it
    # from the consumer side, above the data plane.
    "resilience.ckpt.cv",
    "transport.ring.cond",
    # The staging engine's queue, then its buffer pool; the ingestor's
    # transfer lock is taken by either thread that runs a staged job.
    "staging.executor.cv",
    "staging.pool",
    "ingest.transfer",
    # The device-tier exchange board ranks above the host board: the
    # device tier latches to the host exchange, never the reverse.
    "shuffle.device.cond",
    "shuffle.device.landing",
    "shuffle.exchange.cond",
    # Taken alone, around the once-per-root sweep of stale rendezvous
    # sessions.
    "shuffle.sweep",
    # The shard cache: the process-default store's registry, a store's
    # LRU, its disk tier (taken under the LRU lock by an eviction's spill
    # backstop, never the reverse), a throttled backend's open counter.
    "cache.registry",
    "cache.store",
    "cache.store.spill",
    "cache.backend",
    # The fault plan's hit counter: taken by injection sites under any
    # lock above while a plan is armed.
    "faults.plan",
    # The observability leaves: a registry, the span log's drain, the
    # flight recorder's dump counter.
    "obs.metrics",
    "obs.spans",
    "obs.recorder.dump",
    # The kernels' build-and-load lock: a kernel wrapper's first call
    # may take it under any lock above, and it holds no other.
    "ops.build",
)

_RANK: Dict[str, int] = {name: i for i, name in enumerate(LOCK_ORDER)}


class LockOrderViolation(RuntimeError):
    """An armed sanitizer observed an acquisition inverting the order."""


class LockOrderSanitizer:
    """Records per-thread lock-acquisition stacks and flags inversions.

    ``violations``: one ``(acquiring, holding, thread_name, held_stack)``
    tuple per observed inversion.  ``edges``: every distinct
    ``(holding_top, acquiring)`` pair seen.  ``strict=True`` raises
    :class:`LockOrderViolation` at the inversion site; the default
    records and lets the run proceed.
    """

    def __init__(self, order: Optional[Tuple[str, ...]] = None,
                 strict: bool = False):
        ranks = order if order is not None else LOCK_ORDER
        self.rank: Dict[str, int] = {n: i for i, n in enumerate(ranks)}
        self.strict = strict
        self.violations: List[Tuple[str, str, str, Tuple[str, ...]]] = []
        self.edges: set = set()
        #: Approximate acquisition count (a racy increment: it shows an
        #: armed run was not vacuous, it is no metric).
        self.n_acquisitions = 0
        self._tls = threading.local()
        # A bare lock on purpose (this module is the factory): guards the
        # shared records, never held across user code.
        self._lock = threading.Lock()

    def _stack(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def check(self, name: str) -> None:
        """The order check before the underlying acquire (never blocks)."""
        self.n_acquisitions += 1
        stack = self._stack()
        if not stack:
            return
        rank = self.rank.get(name)
        top = stack[-1]
        if top != name:
            with self._lock:
                self.edges.add((top, name))
        if rank is None:
            return
        for held in stack:
            held_rank = self.rank.get(held)
            if held == name or held_rank is None:
                continue  # reentrancy / unranked: no order claim
            if held_rank > rank:
                witness = (name, held, threading.current_thread().name,
                           tuple(stack))
                with self._lock:
                    self.violations.append(witness)
                self._flight_dump(name, held)
                if self.strict:
                    raise LockOrderViolation(
                        f"acquiring {name!r} while holding {held!r} "
                        f"inverts LOCK_ORDER (held stack: {stack})"
                    )

    def push(self, name: str) -> None:
        self._stack().append(name)

    @staticmethod
    def _flight_dump(acquiring: str, holding: str) -> None:
        """An armed flight recorder dumps the inversion's witness (the
        import is lazy: a process that never arms one never loads the
        obs layer)."""
        from ddl_tpu_torch.obs import recorder as flight

        if flight.armed_recorder() is not None:
            flight.flight_dump(f"lockorder.inversion.{holding}->{acquiring}")

    def pop(self, name: str) -> None:
        stack = self._stack()
        # Release order may differ from acquire order (a condition's wait
        # drops its own lock mid-stack): remove the newest match.
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return


class _SanitizedLock:
    """Proxy over a ``threading.Lock``/``RLock`` reporting to a sanitizer."""

    __slots__ = ("name", "_inner", "_san")

    def __init__(self, name: str, inner: Any, san: LockOrderSanitizer):
        self.name = name
        self._inner = inner
        self._san = san

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._san.check(self.name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._san.push(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        self._san.pop(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "_SanitizedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


class _SanitizedCondition:
    """Proxy over ``threading.Condition`` reporting to a sanitizer.  A
    wait pops the held-stack entry for its duration and pushes it back
    when it returns (the thread still owns its place in the order)."""

    __slots__ = ("name", "_inner", "_san")

    def __init__(self, name: str, inner: Any, san: LockOrderSanitizer):
        self.name = name
        self._inner = inner
        self._san = san

    def acquire(self, *args: Any, **kw: Any) -> bool:
        self._san.check(self.name)
        got = self._inner.acquire(*args, **kw)
        if got:
            self._san.push(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        self._san.pop(self.name)

    def wait(self, timeout: Optional[float] = None) -> bool:
        self._san.pop(self.name)
        try:
            return self._inner.wait(timeout)
        finally:
            self._san.push(self.name)

    def wait_for(self, predicate: Any, timeout: Optional[float] = None) -> Any:
        self._san.pop(self.name)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self._san.push(self.name)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()

    def __enter__(self) -> "_SanitizedCondition":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


#: The armed sanitizer, or None; read once at lock construction.
_ARMED: Optional[LockOrderSanitizer] = None


def _check(name: str) -> Optional[LockOrderSanitizer]:
    """The armed sanitizer (or None) after checking that ``name`` is
    ranked: in :data:`LOCK_ORDER`, or in the armed sanitizer's order."""
    san = _ARMED
    if name not in _RANK and (san is None or name not in san.rank):
        raise ValueError(f"lock {name!r} is not in LOCK_ORDER")
    return san


def named_lock(name: str) -> Any:
    """A ``threading.Lock`` with a sanitizer identity."""
    san = _check(name)
    if san is None:
        return threading.Lock()
    return _SanitizedLock(name, threading.Lock(), san)


def named_rlock(name: str) -> Any:
    """A ``threading.RLock`` with a sanitizer identity (re-entrant
    re-acquisition of the same name is never an inversion)."""
    san = _check(name)
    if san is None:
        return threading.RLock()
    return _SanitizedLock(name, threading.RLock(), san)


def named_condition(name: str) -> Any:
    """A ``threading.Condition`` over its own lock, with a sanitizer
    identity."""
    san = _check(name)
    if san is None:
        return threading.Condition(threading.Lock())
    return _SanitizedCondition(name, threading.Condition(threading.Lock()), san)


def arm_sanitizer(
    san: Optional[LockOrderSanitizer],
) -> Optional[LockOrderSanitizer]:
    """Arm ``san`` process-wide (``None`` disarms); returns the previous
    one.  Only locks constructed while armed are sanitized."""
    global _ARMED
    prev = _ARMED
    _ARMED = san
    return prev


def armed_sanitizer() -> Optional[LockOrderSanitizer]:
    return _ARMED


class sanitized:
    """Context manager: arm a fresh sanitizer for a scoped run, and
    restore the previously armed one on exit, even when the run raises::

        with concurrency.sanitized() as san:
            run_pipeline()          # locks built inside are watched
        assert not san.violations
    """

    def __init__(self, order: Optional[Tuple[str, ...]] = None,
                 strict: bool = False):
        self.sanitizer = LockOrderSanitizer(order=order, strict=strict)
        self._prev: Optional[LockOrderSanitizer] = None

    def __enter__(self) -> LockOrderSanitizer:
        self._prev = arm_sanitizer(self.sanitizer)
        return self.sanitizer

    def __exit__(self, *exc: Any) -> None:
        arm_sanitizer(self._prev)
