"""The cross-host multi-job ingest fabric: admission as a supervisor
service (port of ``ddl_tpu/serve/fabric.py``).

Independent training jobs draw from one shared, elastically scaled loader
fleet; this module puts the admission authority in the supervisor tier:

- **One authoritative scheduler.**  :class:`IngestFabric` owns THE
  :class:`~ddl_tpu_torch.serve.tenancy.FairShareScheduler` and the
  :class:`~ddl_tpu_torch.serve.jobs.JobRegistry`, resident beside the
  :class:`~ddl_tpu_torch.cluster.supervision.JournaledSupervisor` (they
  share a journal).  Jobs never touch the scheduler: they speak the
  admission protocol over the control plane.
- **Admission over acked envelopes.**  Every command (``admit`` /
  ``note_served`` / ``note_aborted`` / register / revoke / crash) rides
  the acked control seam: the client's :class:`~ddl_tpu_torch.transport.
  envelope.ControlSender` wraps it in a fenced ``(incarnation, seq)``
  envelope and retries drops under backoff, and the fabric's per-client
  :class:`~ddl_tpu_torch.transport.envelope.EnvelopeReceiver` dedups
  re-deliveries — with the applied set **journal-seeded**, so a duplicate
  arriving after a failover is answered from the journaled reply instead
  of charging the ledger again.
- **Journaled decisions.**  Every applied decision appends a
  ``job_admission`` record (client, incarnation, seq, op, reply) and, on
  the ``DDL_TORCH_FABRIC_SNAPSHOT_EVERY`` cadence, a full scheduler
  snapshot; registry mutations snapshot the registry.  A promoted
  standby rebuilds with :meth:`IngestFabric.from_journal` and grants in
  the order the dead leader would have.  The journal is the supervisor's
  file format, so either package replays the other's.

Transport: the **loopback** channel — clients call the fabric in-process
— with the whole envelope discipline (drops, duplicates, fencing, retry
exhaustion) live on the path.  A socket adapter would change nothing
above ``raw_send``.

Chaos: ``serve.fabric.admit`` fires once per admission WIRE attempt
(``JOB_ADMISSION_DROP`` loses it; retry and the journal-seeded dedup keep
the ledger exactly-once) and ``serve.fabric.grant`` between a granted
admit and its ``note_served`` (``JOB_CRASH`` kills the job mid-grant; the
fabric revokes its in-flight windows and releases its budget).
"""


from __future__ import annotations

import dataclasses
import logging

from ddl_tpu_torch.concurrency import named_lock
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ddl_tpu_torch import envspec
from ddl_tpu_torch.exceptions import (
    AdmissionDropped,
    DDLError,
    JobCrashed,
    StallTimeoutError,
    WindowsRevoked,
)
from ddl_tpu_torch.faults import fault_point, FaultKind
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
from ddl_tpu_torch.serve.jobs import JobRegistry, JobSpec
from ddl_tpu_torch.serve.tenancy import FairShareScheduler
from ddl_tpu_torch.transport.envelope import ControlSender, EnvelopeReceiver
from ddl_tpu_torch.types import ControlAck, ControlEnvelope

logger = logging.getLogger("ddl_tpu_torch")

#: Journal record kinds (ddl_tpu_torch.cluster.supervision replays both).
KIND_ADMISSION = "job_admission"
KIND_JOBS = "job_registry"

#: Reply cache bound: newest entries win (a client retry storm never
#: spans thousands of outstanding commands — the envelope WINDOW bound).
REPLY_WINDOW = 8192


# -- the admission protocol (ControlEnvelope payloads) ----------------------


@dataclasses.dataclass(frozen=True)
class RegisterJob:
    spec: dict


@dataclasses.dataclass(frozen=True)
class UnregisterJob:
    job_id: str


@dataclasses.dataclass(frozen=True)
class AdmitRequest:
    job_id: str
    timeout_s: float
    #: Registration index, for fault-site selection on the wire.
    index: int = 0


@dataclasses.dataclass(frozen=True)
class ServedNote:
    job_id: str
    nbytes: int


@dataclasses.dataclass(frozen=True)
class AbortNote:
    job_id: str


@dataclasses.dataclass(frozen=True)
class RevokeJobs:
    slo_s: float
    job_ids: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class ClearRevocations:
    job_ids: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class CrashNote:
    job_id: str


@dataclasses.dataclass
class FabricReply:
    """One command's outcome, JSON-round-trippable (it is journaled
    with the decision and re-served to post-failover duplicates)."""

    ok: bool
    error: Optional[str] = None
    #: Typed-error discriminator the client re-raises from:
    #: stall_timeout | revoked | fenced | error.
    error_type: Optional[str] = None
    value: Any = None

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "error": self.error,
            "error_type": self.error_type,
            "value": self.value,
        }


_OPS = {
    RegisterJob: "register",
    UnregisterJob: "unregister",
    AdmitRequest: "admit",
    ServedNote: "served",
    AbortNote: "aborted",
    RevokeJobs: "revoke",
    ClearRevocations: "clear_revocations",
    CrashNote: "crash",
}


# -- the supervisor-resident authority --------------------------------------


class IngestFabric:
    """THE admission authority: one scheduler + one job registry,
    resident in the supervisor tier, driven exclusively through applied
    control commands.

    ``journal`` is a :class:`~ddl_tpu_torch.cluster.supervision.
    SupervisorJournal` (or its path) — pass the JournaledSupervisor's
    own journal so admission records interleave with view changes in
    ONE durable history.  ``None`` runs unjournaled (unit tests).
    """

    def __init__(
        self,
        journal: Any = None,
        scheduler: Optional[FairShareScheduler] = None,
        registry: Optional[JobRegistry] = None,
        metrics: Optional[Metrics] = None,
        clock: Callable[[], float] = time.monotonic,
        term: int = 0,
        snapshot_every: Optional[int] = None,
    ):
        self.metrics = metrics or default_metrics()
        self._clock = clock
        self.scheduler = scheduler or FairShareScheduler(
            quantum_bytes=int(envspec.get("DDL_TORCH_FABRIC_QUANTUM_BYTES")),
            metrics=self.metrics,
            clock=clock,
        )
        self.registry = registry or JobRegistry(metrics=self.metrics)
        if isinstance(journal, str):
            from ddl_tpu_torch.cluster.supervision import SupervisorJournal

            journal = SupervisorJournal(journal)
        self.journal = journal
        #: Fencing term this authority answers under (the promoted
        #: standby's term; envelopes below it are zombie commands).
        self.term = int(term)
        self.snapshot_every = (
            int(envspec.get("DDL_TORCH_FABRIC_SNAPSHOT_EVERY"))
            if snapshot_every is None else int(snapshot_every)
        )
        self._lock = named_lock("serve.fabric")
        # client_id -> receiver; bounded by the connected client set.
        self._receivers: Dict[str, EnvelopeReceiver] = {}  # ddl-lint: disable=DDL013
        # (client, incarnation, seq) -> reply; trimmed to REPLY_WINDOW.
        self._replies: Dict[tuple, FabricReply] = {}  # ddl-lint: disable=DDL013
        self._decisions = 0
        #: Successful grants in decision order — the admission-order
        #: audit the failover property compares bit-exact.
        self.admission_log: List[str] = []

    # -- rebuild after failover (the promoted standby's half) --------------

    @classmethod
    def from_journal(
        cls,
        journal: Any,
        term: Optional[int] = None,
        metrics: Optional[Metrics] = None,
        clock: Callable[[], float] = time.monotonic,
        snapshot_every: Optional[int] = None,
    ) -> "IngestFabric":
        """Replay the journal and stand up the successor authority:
        registry + scheduler ledgers adopted from the newest snapshots,
        dedup seams and reply cache seeded from the decision records
        (exactly-once across the failover boundary), fencing term
        bumped past every journaled promotion."""
        from ddl_tpu_torch.cluster.supervision import replay_journal

        replayed = replay_journal(journal)
        fab = cls(
            journal=journal,
            metrics=metrics,
            clock=clock,
            term=(replayed.term + 1) if term is None else int(term),
            snapshot_every=snapshot_every,
        )
        if replayed.job_registry is not None:
            fab.registry.adopt_state(replayed.job_registry)
        if replayed.scheduler_state is not None:
            fab.scheduler.adopt_state(
                replayed.scheduler_state, now=clock()
            )
        for rec in replayed.admissions:
            client = rec["client"]
            rx = fab._receivers.get(client)
            if rx is None:
                rx = fab._receivers[client] = EnvelopeReceiver()
                rx.fence = fab.term
            if client != LOCAL_CLIENT:
                rx.seed(int(rec["incarnation"]), int(rec["seq"]))
                fab._replies[
                    (client, int(rec["incarnation"]), int(rec["seq"]))
                ] = FabricReply(**rec["reply"])
            fab._decisions = max(fab._decisions, int(rec["n"]) + 1)
            if rec["op"] == "admit" and rec["reply"].get("ok"):
                fab.admission_log.append(rec["job"])
        fab.metrics.incr("fabric.rebuilds")
        return fab

    # -- the envelope seam --------------------------------------------------

    def handle(
        self, client_id: str, env: ControlEnvelope
    ) -> Tuple[FabricReply, ControlAck]:
        """Apply one client envelope exactly once.

        Dedup/fencing run under the fabric lock; the apply itself runs
        OUTSIDE it (a blocking ``admit`` must not stall other clients'
        ``note_served`` — the DRR needs concurrent waiters to be fair).
        Per client, commands are serial (one outstanding RPC per
        consumer thread — the loader's admission protocol), so a
        retry never races its own first delivery.
        """
        with self._lock:
            rx = self._receivers.get(client_id)
            if rx is None:
                rx = self._receivers[client_id] = EnvelopeReceiver()
                rx.fence = self.term
            payload, ack = rx.accept(env)
            if payload is None:
                if ack.fence_rejected:
                    self.metrics.incr("fabric.fence_drops")
                    return FabricReply(
                        ok=False,
                        error=f"fenced off (authority term {self.term})",
                        error_type="fenced",
                    ), ack
                self.metrics.incr("fabric.dup_replies")
                reply = self._replies.get(
                    (client_id, env.incarnation, env.seq)
                )
                if reply is None:
                    reply = FabricReply(
                        ok=False,
                        error="duplicate past the reply window",
                        error_type="error",
                    )
                return reply, ack
        reply = self._apply(payload)
        self._record(client_id, env.incarnation, env.seq, payload, reply)
        return reply, ack

    def apply_local(self, payload: Any) -> FabricReply:
        """Apply a supervisor-local command through the same journaled
        decision path remote envelopes take — no envelope, no dedup
        (the caller IS the authority)."""
        reply = self._apply(payload)
        self._record(LOCAL_CLIENT, 0, -1, payload, reply)
        return reply

    # -- supervisor-side conveniences ---------------------------------------

    def register_job(self, spec: JobSpec) -> FabricReply:
        return self.apply_local(RegisterJob(spec.to_dict()))

    def job_crashed(self, job_id: str) -> FabricReply:
        """Absorb a job crash detected supervisor-side (lease expiry,
        operator report): revoke its in-flight grants, release its
        budget, unregister — neighbours untouched."""
        return self.apply_local(CrashNote(job_id))

    def revoke_jobs(
        self, slo_s: Optional[float] = None, job_ids: Optional[list] = None
    ) -> FabricReply:
        """Preemption/scale-down drain over the control plane; the SLO
        defaults to ``DDL_TORCH_FABRIC_DRAIN_SLO_S``."""
        if slo_s is None:
            slo_s = float(envspec.get("DDL_TORCH_FABRIC_DRAIN_SLO_S"))
        return self.apply_local(
            RevokeJobs(float(slo_s), tuple(job_ids) if job_ids else None)
        )

    def clear_job_revocations(
        self, job_ids: Optional[list] = None
    ) -> FabricReply:
        return self.apply_local(
            ClearRevocations(tuple(job_ids) if job_ids else None)
        )

    # -- decision application ----------------------------------------------

    def _apply(self, payload: Any) -> FabricReply:
        """Translate one command into scheduler/registry mutations.

        The ONLY function that drives the resident scheduler: every
        mutation pairs with a journaled
        decision in :meth:`_record`, so replay sees what happened here.
        """
        try:
            if isinstance(payload, RegisterJob):
                spec = JobSpec(**payload.spec)
                rec = self.registry.register(spec)
                self.scheduler.register(spec.tenant_spec())
                return FabricReply(
                    ok=True,
                    value={"index": rec.index, "seq_base": rec.seq_base},
                )
            if isinstance(payload, UnregisterJob):
                self.registry.unregister(payload.job_id)
                self.scheduler.unregister(payload.job_id)
                return FabricReply(ok=True)
            if isinstance(payload, AdmitRequest):
                self.scheduler.admit(payload.job_id, payload.timeout_s)
                self.metrics.incr("fabric.admissions")
                return FabricReply(ok=True)
            if isinstance(payload, ServedNote):
                self.scheduler.note_served(payload.job_id, payload.nbytes)
                return FabricReply(
                    ok=True, value={"charged": int(payload.nbytes)}
                )
            if isinstance(payload, AbortNote):
                self.scheduler.note_aborted(payload.job_id)
                return FabricReply(ok=True)
            if isinstance(payload, RevokeJobs):
                drained = self.scheduler.revoke_inflight(
                    payload.slo_s,
                    names=(
                        list(payload.job_ids)
                        if payload.job_ids is not None else None
                    ),
                )
                return FabricReply(ok=True, value={"drained": drained})
            if isinstance(payload, ClearRevocations):
                self.scheduler.clear_revocations(
                    names=(
                        list(payload.job_ids)
                        if payload.job_ids is not None else None
                    )
                )
                return FabricReply(ok=True)
            if isinstance(payload, CrashNote):
                return self._crash(payload.job_id)
            return FabricReply(
                ok=False,
                error=f"unknown fabric command {type(payload).__name__}",
                error_type="error",
            )
        except WindowsRevoked as e:
            return FabricReply(
                ok=False, error=str(e), error_type="revoked"
            )
        except StallTimeoutError as e:
            return FabricReply(
                ok=False, error=str(e), error_type="stall_timeout"
            )
        except DDLError as e:
            return FabricReply(ok=False, error=str(e), error_type="error")

    def _crash(self, job_id: str) -> FabricReply:
        """The JOB_CRASH ladder: release the dead job's in-flight
        grants (its ``note_served`` will never arrive — a leaked grant
        would make every later drain burn its full SLO), then drop its
        registration so its byte budget and DRR share vanish.  The
        neighbours' ledgers are untouched."""
        if job_id not in self.registry:
            return FabricReply(
                ok=False,
                error=f"job {job_id!r} is not registered",
                error_type="error",
            )
        state = self.scheduler.export_state()
        inflight = int(
            state["tenants"].get(job_id, {}).get("inflight", 0)
        )
        for _ in range(inflight):
            self.scheduler.note_aborted(job_id)
        self.scheduler.unregister(job_id)
        self.registry.unregister(job_id)
        self.metrics.incr("fabric.job_crashes")
        logger.warning(
            "fabric: job %r crashed mid-grant — released %d in-flight "
            "window(s), budget freed, registration dropped",
            job_id, inflight,
        )
        return FabricReply(ok=True, value={"revoked_inflight": inflight})

    # -- the decision journal ----------------------------------------------

    def _record(
        self,
        client_id: str,
        incarnation: int,
        seq: int,
        payload: Any,
        reply: FabricReply,
    ) -> None:
        op = _OPS.get(type(payload), "unknown")
        job_id = getattr(payload, "job_id", None)
        if isinstance(payload, RegisterJob):
            job_id = payload.spec.get("job_id")
        with self._lock:
            n = self._decisions
            self._decisions += 1
            if op == "admit" and reply.ok:
                self.admission_log.append(job_id)
            if client_id != LOCAL_CLIENT:
                self._replies[(client_id, incarnation, seq)] = reply
                while len(self._replies) > REPLY_WINDOW:
                    self._replies.pop(next(iter(self._replies)))
            if self.journal is None:
                return
            self.journal.append(
                KIND_ADMISSION,
                {
                    "n": n,
                    "client": client_id,
                    "incarnation": int(incarnation),
                    "seq": int(seq),
                    "op": op,
                    "job": job_id,
                    "reply": reply.to_dict(),
                },
            )
            if op in ("register", "unregister", "crash"):
                self.journal.append(
                    KIND_JOBS, {"state": self.registry.export_state()}
                )
            if self.snapshot_every > 0 and (n + 1) % self.snapshot_every == 0:
                from ddl_tpu_torch.cluster.supervision import KIND_SCHEDULER

                self.journal.append(
                    KIND_SCHEDULER,
                    {"state": self.scheduler.export_state()},
                )
                self.metrics.incr("fabric.scheduler_snapshots")

    # -- reporting ----------------------------------------------------------

    def report(self) -> dict:
        """Per-job admission and cache blocks (the :meth:`AdmissionController.report` shape, keyed by
        job)."""
        m = self.metrics
        per_job = {}
        for job_id in self.registry.jobs():
            block = m.prefixed(f"ingest.{job_id}.")
            block["admission_wait_p50_s"] = m.quantile(
                f"ingest.{job_id}.admission_wait", 0.5
            )
            block["admission_wait_p99_s"] = m.quantile(
                f"ingest.{job_id}.admission_wait", 0.99
            )
            block["cache_hits"] = m.counter(f"job.{job_id}.cache.hits")
            block["cache_misses"] = m.counter(f"job.{job_id}.cache.misses")
            per_job[job_id] = block
        return {
            "jobs": per_job,
            "admissions": m.counter("fabric.admissions"),
            "job_crashes": m.counter("fabric.job_crashes"),
            "dup_replies": m.counter("fabric.dup_replies"),
            "fence_drops": m.counter("fabric.fence_drops"),
            "decisions": self._decisions,
        }


#: Client id the authority's own apply_local decisions journal under.
LOCAL_CLIENT = "_local"


# -- the client side --------------------------------------------------------


class FabricClient:
    """One training-job host's connection to the fabric authority.

    ``channel`` is the wire: ``(client_id, envelope) -> (reply, ack)``.
    The loopback default calls an in-process :class:`IngestFabric`
    directly — synchronous delivery, with drops/dups/fencing injected
    on the attempt itself, so the acked-envelope discipline is live on
    exactly the path a socket adapter would run.
    """

    def __init__(
        self,
        fabric: Any,
        client_id: str,
        incarnation: int = 0,
        metrics: Optional[Metrics] = None,
        clock: Callable[[], float] = time.monotonic,
        retries: Optional[int] = None,
        backoff_s: Optional[float] = None,
    ):
        self.client_id = client_id
        self.metrics = metrics or default_metrics()
        self._clock = clock
        if isinstance(fabric, IngestFabric):
            self._channel = fabric.handle
            self.set_fence(fabric.term)
        else:
            self._channel = fabric
        self._sender = ControlSender(
            raw_send=self._raw_send,
            target=0,
            incarnation=incarnation,
            metrics=self.metrics,
            retries=retries,
            backoff_s=backoff_s,
            clock=clock,
        )
        # seq -> reply for in-flight RPCs (serial per consumer thread;
        # bounded by the outstanding command count).
        self._replies: Dict[int, FabricReply] = {}  # ddl-lint: disable=DDL013
        self._fault_index = 0

    def set_fence(self, term: int) -> None:
        """Adopt a (new) authority term — the re-fence after failover.
        Called automatically when constructed over a live fabric."""
        self._pending_fence = int(term)

    def rebind(self, fabric: "IngestFabric") -> None:
        """Point this client at a successor authority (failover): swap
        the channel and adopt its fencing term.  Pending envelopes on
        the old term would be fenced off — the protocol is serial per
        client, so there are none by construction when this is called
        between RPCs."""
        self._channel = fabric.handle
        self.set_fence(fabric.term)

    def _raw_send(self, env: ControlEnvelope) -> None:
        """One wire attempt.  ``serve.fabric.admit`` fires here, per
        attempt, for admission commands — a ``JOB_ADMISSION_DROP``
        raises the real :class:`AdmissionDropped` (a
        ``TransportError``), which :class:`ControlSender` absorbs into
        its pending set for backoff retry; ``CONTROL_MSG_DUP`` delivers
        the SAME envelope twice (the fabric's dedup answers the second
        from its reply cache)."""
        fired: list = []
        if isinstance(env.payload, AdmitRequest):
            fired = fault_point(
                "serve.fabric.admit", producer_idx=env.payload.index
            )
        reply, ack = self._channel(self.client_id, env)
        self._replies[env.seq] = reply
        self._sender.ack(ack)
        if fired and FaultKind.CONTROL_MSG_DUP.value in fired:
            dup_reply, dup_ack = self._channel(self.client_id, env)
            self._replies[env.seq] = dup_reply
            self._sender.ack(dup_ack)

    def _rpc(self, payload: Any) -> FabricReply:
        """Send one command and drive retries until its reply lands.

        Loopback delivery is synchronous, so a missing reply after an
        attempt means the attempt was LOST — pump immediately with the
        backoff horizon forced due (waiting wall-clock buys nothing on
        an in-process wire; an async adapter would sleep here
        instead).  Retry exhaustion surfaces as the real
        :class:`AdmissionDropped`."""
        fence = getattr(self, "_pending_fence", None)
        if fence is not None:
            self._sender.fence = max(self._sender.fence, fence)
        seq = self._sender.send(payload)
        while seq not in self._replies:
            if any(e.seq == seq for e in self._sender.exhausted):
                self.metrics.incr("fabric.client_exhausted")
                raise AdmissionDropped(
                    f"fabric command {type(payload).__name__} for "
                    f"{self.client_id!r} exhausted its retry cap"
                )
            self._sender.pump(now=self._clock() + 1e9)
        return self._replies.pop(seq)

    def _raise_typed(self, reply: FabricReply) -> None:
        if reply.error_type == "stall_timeout":
            raise StallTimeoutError(reply.error)
        if reply.error_type == "revoked":
            raise WindowsRevoked(reply.error)
        raise DDLError(reply.error or "fabric command failed")

    # -- the job-facing API --------------------------------------------------

    def register_job(self, spec: JobSpec) -> "FabricJob":
        reply = self._rpc(RegisterJob(spec.to_dict()))
        if not reply.ok:
            self._raise_typed(reply)
        return FabricJob(
            self,
            spec.job_id,
            index=int(reply.value["index"]),
            seq_base=int(reply.value["seq_base"]),
        )

    def unregister_job(self, job_id: str) -> None:
        reply = self._rpc(UnregisterJob(job_id))
        if not reply.ok:
            self._raise_typed(reply)

    def report_crash(self, job_id: str) -> None:
        """Report a job death to the authority (the client-side half of
        the JOB_CRASH ladder — a harness that catches
        :class:`JobCrashed` forwards it here)."""
        self._rpc(CrashNote(job_id))


class FabricJob:
    """One registered job's admission handle — the
    :class:`~ddl_tpu_torch.serve.tenancy.Tenant` protocol
    (``admit``/``note_served``/``note_aborted``), every call riding the
    acked control plane, so ``loader.bind_admission(job)`` works
    unchanged against a remote authority.

    ``seq_base`` is the job's integrity namespace: set it as the
    ``seq_base`` attribute on the job's producer function and its
    loaders verify trailer seqs in the job's own slice of the u64
    space (:mod:`ddl_tpu_torch.serve.jobs`).
    """

    def __init__(
        self, client: FabricClient, job_id: str, index: int, seq_base: int
    ):
        self.client = client
        self.job_id = job_id
        self.name = job_id
        self.index = index
        self.seq_base = seq_base

    def admit(self, timeout_s: Optional[float] = None) -> None:
        if timeout_s is None:
            timeout_s = float(envspec.get("DDL_TORCH_FABRIC_ADMIT_TIMEOUT_S"))
        reply = self.client._rpc(
            AdmitRequest(self.job_id, float(timeout_s), index=self.index)
        )
        if not reply.ok:
            self.client._raise_typed(reply)

    def note_served(self, nbytes: int) -> None:
        try:
            # Mid-grant chaos: admit returned, the window is in flight,
            # the charge has not landed — exactly where a trainer dies.
            fault_point("serve.fabric.grant", producer_idx=self.index)
        except JobCrashed:
            self.client.report_crash(self.job_id)
            raise
        reply = self.client._rpc(ServedNote(self.job_id, int(nbytes)))
        if not reply.ok:
            self.client._raise_typed(reply)

    def note_aborted(self) -> None:
        self.client._rpc(AbortNote(self.job_id))

    def bind(self, loader: Any) -> "FabricJob":
        loader.bind_admission(self)
        return self
