"""Deterministic fault injection: seeded chaos for the pipeline (port of
``ddl_tpu/faults.py``).

Named injection points are threaded through the rings, the pusher, the
staging engine, the shuffle exchange, the ICI tier, the wire, the
watchdog and the resilience layer.  A test arms a :class:`FaultPlan`
and holds the served stream to an undisturbed run's, byte for byte.

- **Zero cost disarmed.**  ``fault_point("site", ...)`` is one module
  attribute read and a ``return`` while no plan is armed.
- **Deterministic.**  A spec fires on the ``at``-th matching hit of its
  site, for ``count`` consecutive hits, optionally for one producer;
  corrupted byte offsets come from the plan's seeded RNG.
- **Cross-process.**  ``DDL_TORCH_FAULT_PLAN`` carries the JSON plan
  across the spawn boundary: a spawned producer arms itself when it
  imports this module (with a fresh hit counter per incarnation).

Sites in the port (site — the kinds that act there):

==========================  ==============================================
``producer.fill``           crash / hang / slowdown / spurious shutdown, at
                            the top of ``DataPusher.push_data``'s loop
``producer.commit``         ring corruption, after the trailer stamp
``pusher.inplace_fill``     crash with a write-once slot filled but not
                            stamped
``producer.handshake``      crash while a producer is constructed
``ring.fill``/``ring.drain``  spurious shutdown / slowdown in the ring
                            waits (all three ring classes)
``staging.copy``            staging-copy failure / source corruption
``staging.transfer``        staged-transfer failure / delay
``shuffle.exchange``        peer loss before a lane take
``shuffle.device_exchange`` ``ICI_DMA_FAIL`` poisons the device round:
                            every participant sees the failure together
``watchdog.sweep``          spurious shutdown / crash in ``check_once``
``ici.fanout``              a failed fan-out leg in ``IciDistributor``
``wire.encode``             ``WIRE_CORRUPTION`` of an encoded payload,
                            after its CRC stamp (slot) or its envelope
                            header (exchange)
``wire.decode``             ``DECODE_FAIL`` at a decode site (the slot
                            and exchange decoders, ``CodecBackend.open``)
``cache.disk_read``         ``CACHE_CORRUPTION`` of a disk-tier entry just
                            read: quarantine and refetch
``backend.fetch``           ``BACKEND_FETCH_FAIL`` before a shard fetch
                            attempt in ``open_with_retry``
``resilience.notice``       ``PREEMPT_NOTICE`` at ``PreemptionGuard.poll``
``resilience.ckpt_write``   ``CKPT_CORRUPTION`` of a stamped generation
``transport.control_send``  ``CONTROL_MSG_DROP`` / ``NETWORK_PARTITION``
                            lose an envelope send, ``CONTROL_MSG_DUP``
                            sends it twice
``cluster.heartbeat``       once per host per supervisor sweep
                            (``producer_idx`` is the HOST id):
                            ``HEARTBEAT_DROP`` loses the beat (the lease
                            ages), ``HOST_LOSS`` declares the host dead
``cluster.view_change``     inside the supervisor's critical section,
                            before the successor view is computed
``cluster.supervise``       top of every ``SupervisorHA.step``
                            (``producer_idx`` is the stepping node):
                            ``SUPERVISOR_CRASH`` kills the leader,
                            ``NETWORK_PARTITION`` skips its lease renewal
``serve.admit``             once per tenant admission attempt
                            (``producer_idx`` is the tenant's index):
                            ``TENANT_BURST`` charges phantom bytes
``serve.scale``             top of every ``Autoscaler.step``:
                            ``SCALE_DECISION_DELAY`` sleeps
``serve.fabric.admit``      once per fabric admission wire attempt:
                            ``JOB_ADMISSION_DROP`` loses it,
                            ``CONTROL_MSG_DUP`` delivers it twice
``serve.fabric.grant``      between a granted admit and its
                            ``note_served``: ``JOB_CRASH``
``tune.step``               top of every ``KnobController.step``
==========================  ==============================================

Every kind raises the type the JAX package raises for it.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ddl_tpu_torch import envspec
from ddl_tpu_torch.concurrency import named_lock
from ddl_tpu_torch.exceptions import (
    AdmissionDropped,
    BackendFetchError,
    ControlSendDropped,
    DDLError,
    DecodeError,
    HeartbeatDropped,
    HostLostError,
    InjectedFault,
    JobCrashed,
    NetworkPartitioned,
    PreemptionNotice,
    ShutdownRequested,
    SupervisorCrashed,
    TenantBurst,
)


class FaultKind(enum.Enum):
    """What happens when a spec fires (the JAX package's values)."""

    PRODUCER_CRASH = "producer_crash"
    PRODUCER_HANG = "producer_hang"
    PRODUCER_SLOWDOWN = "producer_slowdown"
    RING_CORRUPTION = "ring_corruption"
    STAGING_COPY_FAIL = "staging_copy_fail"
    STAGED_TRANSFER_FAIL = "staged_transfer_fail"
    STAGED_TRANSFER_TIMEOUT = "staged_transfer_timeout"
    SHUFFLE_PEER_LOSS = "shuffle_peer_loss"
    SPURIOUS_SHUTDOWN = "spurious_shutdown"
    CACHE_CORRUPTION = "cache_corruption"
    BACKEND_FETCH_FAIL = "backend_fetch_fail"
    ICI_DMA_FAIL = "ici_dma_fail"
    HOST_LOSS = "host_loss"
    HEARTBEAT_DROP = "heartbeat_drop"
    TENANT_BURST = "tenant_burst"
    SCALE_DECISION_DELAY = "scale_decision_delay"
    WIRE_CORRUPTION = "wire_corruption"
    DECODE_FAIL = "decode_fail"
    PREEMPT_NOTICE = "preempt_notice"
    CKPT_CORRUPTION = "ckpt_corruption"
    SUPERVISOR_CRASH = "supervisor_crash"
    CONTROL_MSG_DROP = "control_msg_drop"
    CONTROL_MSG_DUP = "control_msg_dup"
    NETWORK_PARTITION = "network_partition"
    JOB_ADMISSION_DROP = "job_admission_drop"
    JOB_CRASH = "job_crash"


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault: fires on the ``at``-th (1-based) matching hit
    of ``site`` and the ``count - 1`` hits after it.  ``producer_idx``
    narrows matching to one producer's hits (``None`` matches any).
    ``param``: seconds for a hang, slowdown or delay, flipped bytes for a
    corruption, grace seconds for a notice."""

    site: str
    kind: FaultKind
    at: int = 1
    count: int = 1
    producer_idx: Optional[int] = None
    param: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "site": self.site,
            "kind": self.kind.value,
            "at": self.at,
            "count": self.count,
            "producer_idx": self.producer_idx,
            "param": self.param,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultSpec":
        return cls(
            site=d["site"],
            kind=FaultKind(d["kind"]),
            at=int(d.get("at", 1)),
            count=int(d.get("count", 1)),
            producer_idx=d.get("producer_idx"),
            param=float(d.get("param", 0.0)),
        )


#: Kinds that flip ``param`` bytes of the site's view.
_CORRUPTIONS = (
    FaultKind.RING_CORRUPTION,
    FaultKind.CACHE_CORRUPTION,
    FaultKind.WIRE_CORRUPTION,
    FaultKind.CKPT_CORRUPTION,
)
#: Kinds that sleep ``param`` seconds (0.2 s unset).
_DELAYS = (
    FaultKind.PRODUCER_SLOWDOWN,
    FaultKind.STAGED_TRANSFER_TIMEOUT,
    FaultKind.SCALE_DECISION_DELAY,
)


class FaultPlan:
    """A seed plus a schedule of :class:`FaultSpec` s.

    Thread-safe: sites are hit from producers, the staging worker and the
    consumer at once; hit counting runs under one lock, only while armed.
    ``fired`` records ``(site, kind, producer_idx, hit_number)`` per
    firing."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        import numpy as np

        self.specs = list(specs)
        self.seed = int(seed)
        self.fired: List[Tuple[str, str, Optional[int], int]] = []
        self._lock = named_lock("faults.plan")
        # Spec index -> matching hits.
        self._hits: Dict[int, int] = {}  # ddl-lint: disable=DDL013 - bounded by len(specs)
        self._rng = np.random.default_rng(self.seed)

    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed, "specs": [s.to_dict() for s in self.specs]}
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        return cls(
            [FaultSpec.from_dict(s) for s in d.get("specs", [])],
            seed=int(d.get("seed", 0)),
        )

    def fire(
        self,
        site: str,
        producer_idx: Optional[int],
        view: Any,
        should_abort: Optional[Callable[[], bool]],
    ) -> List[str]:
        due: List[FaultSpec] = []
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                if (spec.producer_idx is not None
                        and spec.producer_idx != producer_idx):
                    continue
                n = self._hits.get(i, 0) + 1
                self._hits[i] = n
                if spec.at <= n < spec.at + spec.count:
                    self.fired.append((site, spec.kind.value, producer_idx, n))
                    due.append(spec)
        if due:
            # A fired site dumps the flight ring when a recorder is armed
            # (the import is lazy: a process that never arms it never
            # loads the obs layer).
            from ddl_tpu_torch.obs import recorder as flight

            if flight.armed_recorder() is not None:
                for spec in due:
                    flight.flight_dump(f"fault.{site}.{spec.kind.value}",
                                       producer_idx=producer_idx)
        for spec in due:
            self._act(spec, view=view, should_abort=should_abort)
        # Kinds that do not raise (CONTROL_MSG_DUP) reach here: the site
        # learns what fired and acts itself.
        return [spec.kind.value for spec in due]

    def _act(self, spec: FaultSpec, view: Any,
             should_abort: Optional[Callable[[], bool]]) -> None:
        kind = spec.kind
        where = f"injected at {spec.site!r}"
        if kind is FaultKind.PRODUCER_CRASH:
            raise InjectedFault(f"producer crash {where}")
        elif kind is FaultKind.SPURIOUS_SHUTDOWN:
            raise ShutdownRequested(f"spurious shutdown {where}")
        elif kind is FaultKind.PRODUCER_HANG:
            # A wedge, not a sleep: held until the stall budget or a
            # shutdown reacts, so teardown never strands the thread.
            deadline = time.monotonic() + (spec.param or 3600.0)
            while time.monotonic() < deadline:
                if should_abort is not None and should_abort():
                    raise ShutdownRequested(f"hang aborted {where}")
                time.sleep(0.05)
        elif kind in _DELAYS:
            time.sleep(spec.param or 0.2)
        elif kind in _CORRUPTIONS:
            if view is None or len(view) == 0:
                return  # the site carries no payload to flip
            nbytes = max(1, int(spec.param))
            with self._lock:
                offs = self._rng.integers(0, len(view), size=nbytes)
            for off in offs:
                view[int(off)] ^= 0xFF
        elif kind in (FaultKind.STAGING_COPY_FAIL,
                      FaultKind.STAGED_TRANSFER_FAIL,
                      FaultKind.ICI_DMA_FAIL):
            raise InjectedFault(f"{kind.value} {where}")
        elif kind is FaultKind.BACKEND_FETCH_FAIL:
            # The real type, so open_with_retry's ladder takes it.
            raise BackendFetchError(f"backend fetch failure {where}")
        elif kind is FaultKind.DECODE_FAIL:
            raise DecodeError(f"decode failure {where}")
        elif kind is FaultKind.PREEMPT_NOTICE:
            raise PreemptionNotice(f"preemption notice {where}",
                                   deadline_s=spec.param)
        elif kind is FaultKind.CONTROL_MSG_DROP:
            raise ControlSendDropped(f"control send dropped {where}")
        elif kind is FaultKind.NETWORK_PARTITION:
            raise NetworkPartitioned(f"network partitioned {where}")
        elif kind is FaultKind.CONTROL_MSG_DUP:
            pass  # the sender sends the same envelope twice
        elif kind is FaultKind.SHUFFLE_PEER_LOSS:
            raise DDLError(f"shuffle peer loss {where}")
        # The cluster kinds raise the real types: the supervisor's sweep
        # and the HA step handle them as they would the real events.
        elif kind is FaultKind.HOST_LOSS:
            raise HostLostError(f"host loss {where}")
        elif kind is FaultKind.HEARTBEAT_DROP:
            raise HeartbeatDropped(f"heartbeat dropped {where}")
        elif kind is FaultKind.SUPERVISOR_CRASH:
            raise SupervisorCrashed(f"supervisor crash {where}")
        # The serve kinds raise the real types: the scheduler charges a
        # burst to the burster, the fabric client retries a lost
        # admission, the fabric revokes a crashed job's grants.
        elif kind is FaultKind.TENANT_BURST:
            raise TenantBurst(f"tenant burst {where}",
                              burst_bytes=spec.param or (64 << 20))
        elif kind is FaultKind.JOB_ADMISSION_DROP:
            raise AdmissionDropped(f"job admission dropped {where}")
        elif kind is FaultKind.JOB_CRASH:
            raise JobCrashed(f"job crashed mid-grant {where}")
        else:  # FaultKind is closed above
            raise ValueError(f"unhandled fault kind {kind!r}")


#: The armed plan, or None: read unlocked at every injection point.
_ARMED: Optional[FaultPlan] = None

#: Env var carrying a JSON plan across process-spawn boundaries.
PLAN_ENV = "DDL_TORCH_FAULT_PLAN"


def fault_point(
    site: str,
    producer_idx: Optional[int] = None,
    view: Any = None,
    should_abort: Optional[Callable[[], bool]] = None,
) -> Optional[List[str]]:
    """One named injection point: nothing (one attribute read) unless a
    plan is armed; else the matching specs act — raise, sleep, or corrupt
    ``view`` in place.  Returns the fired kind values (possibly empty),
    ``None`` when disarmed."""
    plan = _ARMED
    if plan is None:
        return None
    return plan.fire(site, producer_idx, view, should_abort)


def arm(plan: Optional[FaultPlan], export: bool = False) -> Optional[FaultPlan]:
    """Arm ``plan`` process-wide (``None`` disarms).  ``export=True`` also
    publishes it in :data:`PLAN_ENV`, so producers spawned afterwards arm
    themselves at import.  Returns the previously armed plan."""
    global _ARMED
    prev = _ARMED
    _ARMED = plan
    if export:
        if plan is None:
            os.environ.pop(PLAN_ENV, None)
        else:
            os.environ[PLAN_ENV] = plan.to_json()
    return prev


def armed_plan() -> Optional[FaultPlan]:
    return _ARMED


class armed:
    """Context manager: arm a plan for a scoped chaos run, restoring the
    previous plan (and the env var) on exit, also when the run raises::

        plan = FaultPlan([FaultSpec("producer.fill",
                                    FaultKind.PRODUCER_CRASH, at=3)])
        with faults.armed(plan, export=True):
            run_pipeline()
        assert plan.fired
    """

    def __init__(self, plan: FaultPlan, export: bool = False):
        self.plan = plan
        self.export = export
        self._prev: Optional[FaultPlan] = None
        self._prev_env: Optional[str] = None

    def __enter__(self) -> FaultPlan:
        self._prev_env = envspec.raw(PLAN_ENV)
        self._prev = arm(self.plan, export=self.export)
        return self.plan

    def __exit__(self, *exc: Any) -> None:
        arm(self._prev)
        if self.export:
            if self._prev_env is None:
                os.environ.pop(PLAN_ENV, None)
            else:
                os.environ[PLAN_ENV] = self._prev_env


# A process launched with the env set (a spawned producer imports this
# module through the pusher) arms itself here.
_env_plan = envspec.raw(PLAN_ENV)
if _env_plan:
    try:
        _ARMED = FaultPlan.from_json(_env_plan)
    except (ValueError, KeyError):
        logging.getLogger("ddl_tpu_torch").warning(
            "ignoring malformed %s (%d chars)", PLAN_ENV, len(_env_plan)
        )
del _env_plan
