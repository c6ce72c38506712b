"""Exceptions for ddl_tpu_torch (the slice's subset of
``ddl_tpu/exceptions.py``, same names and hierarchy)."""

from __future__ import annotations


class DDLError(Exception):
    """Base class for all ddl_tpu_torch errors."""


class DoesNotMatchError(DDLError):
    """Topology or shape mismatch."""

    def __init__(self, value: object = None, message: str = ""):
        self.value = value
        self.message = message
        super().__init__(value, message)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        if self.message:
            return f"{self.value!r}: {self.message}"
        return repr(self.value)


class TransportError(DDLError):
    """A transport-level failure (ring corrupt, peer vanished, bad slot)."""


class ShutdownRequested(DDLError):
    """Internal control-flow signal: the pipeline is shutting down.
    Waits that observe a ring's shutdown flag raise this."""


class StallTimeoutError(TransportError, TimeoutError):
    """A blocking wait on the ring or a control channel exceeded its
    deadline (also a builtin ``TimeoutError``)."""


class IntegrityError(DDLError):
    """A window failed its drain-time integrity check (bad trailer
    magic, wrong producer or sequence number, or a CRC mismatch)."""


class WindowsRevoked(StallTimeoutError):
    """A tenant's in-flight window grants were revoked under a drain SLO
    (:meth:`~ddl_tpu_torch.serve.tenancy.FairShareScheduler.
    revoke_inflight`, the scale-down and preemption rung).  A
    :class:`StallTimeoutError`, so a revoked admission wait surfaces
    through the loader's acquire as a stall deadline would, while a
    tenant can still tell "you were preempted" from "the ring wedged"."""


class LoaderStateError(DDLError, RuntimeError):
    """The loader was driven from an invalid state (finalized loader,
    superseded ``windows()`` stream)."""


class PreemptionNotice(DDLError):
    """The platform announced this host's imminent preemption (a SIGTERM
    delivered to the trainer, or the ``DDL_TORCH_PREEMPT_NOTICE`` knob).
    Carries ``deadline_s``, the grace budget the notice grants, when the
    raiser knows it; :class:`~ddl_tpu_torch.resilience.PreemptionGuard`
    absorbs it at window boundaries."""

    def __init__(self, message: str = "", deadline_s: float = 0.0):
        self.deadline_s = float(deadline_s)
        super().__init__(message)


class CheckpointError(DDLError):
    """A checkpoint could not be durably written or flushed
    (:mod:`ddl_tpu_torch.resilience`), or a generation does not fit the
    current model.  Restore-side corruption is not this error:
    unverifiable generations are quarantined and skipped."""


class BackendFetchError(TransportError):
    """A storage-backend shard fetch failed, in a way a retry might heal
    (:mod:`ddl_tpu_torch.cache.backends`, and the ``backend.fetch`` fault
    site).  :func:`~ddl_tpu_torch.cache.open_with_retry` retries it with
    bounded backoff; exhaustion escalates to :class:`IntegrityError`."""


class DecodeError(DDLError):
    """A wire payload failed to decode (:mod:`ddl_tpu_torch.wire`): a
    codec raised, an envelope field was malformed, or the declared output
    bound was exceeded.  Also the type the ``DECODE_FAIL`` fault kind
    raises at the ``wire.decode`` site, so chaos runs the production
    ladder: a bounded retry, then the path's own fallback."""


class InjectedFault(DDLError):
    """A deliberate failure raised by the fault-injection engine
    (:mod:`ddl_tpu_torch.faults`), only while a plan is armed: distinct
    from the real error types, so a test can tell an injected crash from
    a genuine one."""


class ControlSendDropped(TransportError):
    """One control-channel send was lost on the wire (the
    ``CONTROL_MSG_DROP`` fault kind at ``transport.control_send``).  The
    acked envelope seam keeps the envelope pending and retries it with
    backoff until acked or the retry cap trips."""


class NetworkPartitioned(TransportError):
    """The control network partitioned: this side can neither deliver
    nor receive control traffic for the duration (the
    ``NETWORK_PARTITION`` fault kind at ``transport.control_send``).  The
    envelope seam keeps retrying under its cap."""


class HostLostError(DDLError):
    """A whole host left the cluster view (lease expiry, a declared loss,
    or the ``HOST_LOSS`` fault kind at ``cluster.heartbeat``).  The
    membership control plane (:mod:`ddl_tpu_torch.cluster`) catches it
    during a sweep and runs the epoch-fenced view change; it never
    escapes a healthy supervisor loop."""


class HeartbeatDropped(DDLError):
    """One heartbeat was lost in flight (the ``HEARTBEAT_DROP`` fault kind
    at ``cluster.heartbeat``).  The lease table treats a dropped beat as
    silence: the lease keeps aging and only its expiry changes the
    view."""


class SupervisorCrashed(DDLError):
    """The control-plane supervisor died mid-lease (the
    ``SUPERVISOR_CRASH`` fault kind at ``cluster.supervise``).  The HA
    tier (:class:`~ddl_tpu_torch.cluster.supervision.SupervisorHA`)
    absorbs it: the leader's lease stops renewing, a standby observes the
    expiry, replays the journal and promotes itself under the next
    fencing term."""


class TenantBurst(DDLError):
    """A tenant's demand spiked (the ``TENANT_BURST`` fault kind at
    ``serve.admit``).  Carries ``burst_bytes``, the phantom demand the
    fair-share scheduler charges to the bursting tenant's own deficit
    and byte bucket, so its neighbours' shares are untouched."""

    def __init__(self, message: str = "", burst_bytes: float = 0.0):
        self.burst_bytes = float(burst_bytes)
        super().__init__(message)


class AdmissionDropped(TransportError):
    """One fabric admission command was lost on the wire (the
    ``JOB_ADMISSION_DROP`` fault kind at ``serve.fabric.admit``).  The
    fabric client's acked envelope seam retries it, and the fabric's
    journal-seeded dedup applies it exactly once."""


class JobCrashed(DDLError):
    """A training job died mid-grant: ``admit`` returned, the window is in
    flight, and ``note_served`` will never arrive (the ``JOB_CRASH``
    fault kind at ``serve.fabric.grant``).  The fabric revokes the job's
    in-flight grants, drops its registration and budget, and leaves its
    neighbours' ledgers untouched."""
