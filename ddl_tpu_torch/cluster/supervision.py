"""Survivable control plane: supervisor journaling and lease-based
failover (port of ``ddl_tpu/cluster/supervision.py``).

A dead :class:`~ddl_tpu_torch.cluster.membership.ClusterSupervisor`
freezes membership (no sweeps, no adoptions) while the pipeline keeps
serving a stale view.  This module makes the supervisor survivable, in
three layers:

- **Journal** (:class:`SupervisorJournal`).  Every control-plane
  decision — bootstrap view, view changes, rejoins, epoch restores,
  scheduler snapshots, promotions — is appended as a self-delimiting
  record in the checkpoint blob framing: ``magic | u32 header-len |
  JSON header | 32-byte integrity trailer``, CRC'd and seq-stamped.  The
  bytes are the JAX package's, so either package replays the other's
  journal.  Replay is torn-tail-tolerant: a record whose trailer fails
  verification (a crash mid-append) ends the replay there — every
  preceding record is intact by construction.

- **Deterministic replay** (:func:`replay_journal`).  The supervisor is
  a state machine over the journal: views evolve only through the pure
  :func:`~ddl_tpu_torch.cluster.membership.view_change` /
  :func:`~ddl_tpu_torch.cluster.membership.view_rejoin`, so replaying
  the records reconstructs the leader's view, epoch fence, departed
  hosts, fencing term and latest scheduler snapshot.

- **Lease and fencing** (:class:`SupervisorHA`).  The leader renews a
  leadership lease every :meth:`SupervisorHA.step`; a standby promotes
  when the lease lapses (``DDL_TORCH_SUPERVISOR_LEASE_S``).  Promotion
  replays the journal, rebuilds a fresh :class:`JournaledSupervisor`,
  adopts the scheduler snapshot, bumps the **fencing term** and stamps
  it onto every control sender
  (:meth:`~ddl_tpu_torch.transport.connection.ConsumerConnection.set_control_fence`),
  so each post-promotion command carries the new term.  A zombie
  ex-leader keeps sending with the old term; every
  :class:`~ddl_tpu_torch.transport.envelope.EnvelopeReceiver` drops
  those unapplied (but acks them, so the zombie's retries drain).

Records append from the supervisor's change notification, after state
mutates: a crash in the gap loses exactly that record.  The successor
then replays to one view earlier, and its own first sweep re-detects the
dead host through the same lease table, converging on the same view
(:func:`view_change` is pure).  The journal is a replay log, not a
write-ahead log.

Chaos rides the ``cluster.supervise`` site inside
:meth:`SupervisorHA.step`: ``SUPERVISOR_CRASH`` kills the leader
mid-stream (the lease lapses, a standby promotes), ``NETWORK_PARTITION``
suppresses lease renewal without killing the leader — the split-brain
setup.  Promotions and crashes are flight-recorded.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from ddl_tpu_torch import envspec, integrity
from ddl_tpu_torch.cluster.membership import (
    ClusterSupervisor,
    ClusterView,
    HostInfo,
    view_change,
    view_rejoin,
)
from ddl_tpu_torch.concurrency import named_rlock
from ddl_tpu_torch.exceptions import (
    DDLError,
    NetworkPartitioned,
    ShutdownRequested,
    SupervisorCrashed,
)
from ddl_tpu_torch.faults import fault_point
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics

logger = logging.getLogger("ddl_tpu_torch")

#: Journal-record magic (8 bytes), ahead of the u32 header length —
#: same framing as the checkpoint generation blobs (``DDLRES1\0``),
#: distinct magic so a journal can never be mistaken for a checkpoint.
_MAGIC = b"DDLJRN1\0"

#: Trailer identity for journal records (the ring headers carry the
#: 1-based producer index there; 0 is unused by any producer).
_JOURNAL_PRODUCER = 0

# Record kinds (the header's "kind" field).
KIND_BOOTSTRAP = "bootstrap"
KIND_VIEW_CHANGE = "view_change"
KIND_REJOIN = "rejoin"
KIND_EPOCH_RESTORE = "epoch_restore"
KIND_SCHEDULER = "scheduler"
KIND_PROMOTION = "promotion"
# Ingest-fabric records (the serve layer's fabric appends them; string
# literals here, not imports — the serve layer depends on cluster, and
# replay only collects, never interprets, the fabric's payloads).
KIND_JOB_ADMISSION = "job_admission"
KIND_JOB_REGISTRY = "job_registry"


# -- view (de)serialization ------------------------------------------------


def host_to_dict(h: HostInfo) -> dict:
    return {
        "host_id": h.host_id,
        "loader_ranks": list(h.loader_ranks),
        "trainer_ranks": list(h.trainer_ranks),
        "cache_spill_dir": h.cache_spill_dir,
    }


def host_from_dict(d: dict) -> HostInfo:
    return HostInfo(
        host_id=int(d["host_id"]),
        loader_ranks=tuple(int(r) for r in d["loader_ranks"]),
        trainer_ranks=tuple(int(r) for r in d["trainer_ranks"]),
        cache_spill_dir=d.get("cache_spill_dir"),
    )


def view_to_dict(v: ClusterView) -> dict:
    return {
        "epoch": v.epoch,
        "n_shards": v.n_shards,
        "hosts": [host_to_dict(h) for h in v.hosts],
        "shard_ranges": [
            [hid, [list(pair) for pair in ranges]]
            for hid, ranges in v.shard_ranges
        ],
    }


def view_from_dict(d: dict) -> ClusterView:
    return ClusterView(
        epoch=int(d["epoch"]),
        hosts=tuple(host_from_dict(h) for h in d["hosts"]),
        shard_ranges=tuple(
            (int(hid), tuple(tuple(int(x) for x in pair) for pair in ranges))
            for hid, ranges in d["shard_ranges"]
        ),
        n_shards=int(d["n_shards"]),
    )


# -- record framing --------------------------------------------------------


def _encode_record(seq: int, kind: str, data: dict) -> bytes:
    """One journal record: magic | u32 header-len | JSON header |
    32-byte integrity trailer (crc over everything before it, trailer
    seq = record index — a spliced/reordered journal fails replay)."""
    header = json.dumps(
        {"seq": int(seq), "kind": kind, "data": data}, sort_keys=True
    ).encode()
    payload_bytes = len(_MAGIC) + 4 + len(header)
    blob = np.empty(payload_bytes + integrity.HEADER_BYTES, dtype=np.uint8)
    off = len(_MAGIC)
    blob[:off] = np.frombuffer(_MAGIC, dtype=np.uint8)
    blob[off : off + 4] = np.frombuffer(
        np.uint32(len(header)).tobytes(), dtype=np.uint8
    )
    off += 4
    blob[off : off + len(header)] = np.frombuffer(header, dtype=np.uint8)
    crc = integrity.window_crc(blob[:payload_bytes])
    integrity.write_header(
        blob, payload_bytes, seq=int(seq),
        producer_idx=_JOURNAL_PRODUCER, crc=crc,
    )
    return blob.tobytes()


def _decode_records(raw: bytes) -> Tuple[List[dict], Optional[str]]:
    """Parse records until the torn tail.  Returns ``(records, tail)``
    where ``tail`` describes why parsing stopped early (None on a clean
    end-of-file).  Every returned record verified its trailer."""
    records: List[dict] = []
    off = 0
    n = len(raw)
    idx = 0
    while off < n:
        head_end = off + len(_MAGIC) + 4
        if head_end > n:
            return records, f"torn tail at byte {off}: truncated frame"
        if raw[off : off + len(_MAGIC)] != _MAGIC:
            return records, f"bad record magic at byte {off}"
        hlen = int(
            np.frombuffer(raw[off + len(_MAGIC) : head_end], np.uint32)[0]
        )
        payload_bytes = len(_MAGIC) + 4 + hlen
        total = payload_bytes + integrity.HEADER_BYTES
        if off + total > n:
            return records, f"torn tail at byte {off}: truncated record"
        view = np.frombuffer(raw[off : off + total], dtype=np.uint8)
        err = integrity.verify_window(
            view, payload_bytes,
            expect_seq=idx, expect_producer=_JOURNAL_PRODUCER,
        )
        if err is not None:
            return records, f"record {idx} at byte {off}: {err}"
        try:
            header = json.loads(
                raw[off + len(_MAGIC) + 4 : off + payload_bytes].decode()
            )
        except (ValueError, UnicodeDecodeError) as e:
            return records, f"record {idx}: undecodable header ({e})"
        records.append(header)
        off += total
        idx += 1
    return records, None


class SupervisorJournal:
    """Append-only, CRC-trailered control-plane journal on disk.

    Thread-safety: appends happen on the supervisor's sweep thread and
    (promotion records) the HA stepper — serialized by the caller's
    ``cluster.supervisor`` lock, so the journal itself carries no lock.
    Each append is flushed + fsynced: a record is either fully durable
    or detectably torn, never silently half-applied at replay.
    """

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self.next_seq = 0
        if os.path.exists(self.path):
            with open(self.path, "rb") as f:
                records, tail = _decode_records(f.read())
            self.next_seq = len(records)
            if tail is not None:
                # Truncate the torn tail so appends resume at a clean
                # frame boundary (the crashed leader's half-record).
                logger.warning("supervision: journal %s: %s — truncating",
                               self.path, tail)
                self._truncate_to(records)

    def _truncate_to(self, records: List[dict]) -> None:
        clean = b"".join(
            _encode_record(r["seq"], r["kind"], r["data"]) for r in records
        )
        with open(self.path, "wb") as f:
            f.write(clean)
            f.flush()
            os.fsync(f.fileno())

    def append(self, kind: str, data: dict) -> int:
        """Durably append one record; returns its seq (= record index)."""
        seq = self.next_seq
        blob = _encode_record(seq, kind, data)
        with open(self.path, "ab") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        self.next_seq = seq + 1
        return seq

    def records(self) -> List[dict]:
        """Every intact record, in order (torn tail dropped)."""
        if not os.path.exists(self.path):
            return []
        with open(self.path, "rb") as f:
            records, _ = _decode_records(f.read())
        return records


# -- replay ----------------------------------------------------------------


@dataclasses.dataclass
class ReplayedState:
    """What a standby reconstructs from the journal at promotion."""

    view: Optional[ClusterView]
    term: int
    departed: List[HostInfo]
    scheduler_state: Optional[dict]
    records: int
    epoch_restores: int
    #: Ingest-fabric state (the serve layer's fabric): the newest job-
    #: registry snapshot and every applied admission decision, in
    #: journal order — the successor authority's exactly-once seed.
    job_registry: Optional[dict] = None
    admissions: List[dict] = dataclasses.field(default_factory=list)


def replay_journal(journal: "SupervisorJournal | str") -> ReplayedState:
    """Deterministically re-run the journal's state machine.

    Views evolve ONLY through the pure :func:`view_change` /
    :func:`view_rejoin` — the same functions the leader ran — so the
    replayed view is byte-identical to the leader's last journaled
    view.  The newest scheduler snapshot wins (each snapshot is a full
    export, not a delta).
    """
    if isinstance(journal, str):
        journal = SupervisorJournal(journal)
    view: Optional[ClusterView] = None
    term = 0
    departed: Dict[int, HostInfo] = {}
    scheduler_state: Optional[dict] = None
    job_registry: Optional[dict] = None
    admissions: List[dict] = []
    epoch_restores = 0
    records = journal.records()
    for rec in records:
        kind, data = rec["kind"], rec["data"]
        if kind == KIND_BOOTSTRAP:
            view = view_from_dict(data["view"])
        elif kind == KIND_VIEW_CHANGE:
            if view is None:
                raise DDLError("journal: view_change before bootstrap")
            dead = frozenset(int(h) for h in data["dead"])
            for h in view.hosts:
                if h.host_id in dead:
                    departed[h.host_id] = h
            view = view_change(view, dead)
            if view.epoch != int(data["epoch"]):
                # Concurrent leader changes raced notification order;
                # the recorded epoch is authoritative for the fence.
                logger.warning(
                    "supervision: replay epoch drift (%d != journaled %d)",
                    view.epoch, int(data["epoch"]),
                )
                view = dataclasses.replace(view, epoch=int(data["epoch"]))
        elif kind == KIND_REJOIN:
            if view is None:
                raise DDLError("journal: rejoin before bootstrap")
            host = host_from_dict(data["host"])
            departed.pop(host.host_id, None)
            view = view_rejoin(view, host)
        elif kind == KIND_EPOCH_RESTORE:
            if view is not None and int(data["epoch"]) > view.epoch:
                view = dataclasses.replace(view, epoch=int(data["epoch"]))
            epoch_restores += 1
        elif kind == KIND_SCHEDULER:
            scheduler_state = data["state"]
        elif kind == KIND_JOB_REGISTRY:
            job_registry = data["state"]
        elif kind == KIND_JOB_ADMISSION:
            admissions.append(data)
        elif kind == KIND_PROMOTION:
            term = max(term, int(data["term"]))
        # Unknown kinds are skipped, not fatal: an older standby must
        # still replay a newer leader's journal (forward compatibility).
    return ReplayedState(
        view=view,
        term=term,
        departed=list(departed.values()),
        scheduler_state=scheduler_state,
        records=len(records),
        epoch_restores=epoch_restores,
        job_registry=job_registry,
        admissions=admissions,
    )


# -- the journaled supervisor ----------------------------------------------


class JournaledSupervisor(ClusterSupervisor):
    """A :class:`ClusterSupervisor` whose every decision is journaled.

    Drop-in: identical sweep/lease/view-change behaviour, plus a
    journal listener registered FIRST (before any elastic ladder
    listener) so the record lands before downstream actions fire.
    ``bootstrap=False`` skips the bootstrap record — promotion uses it
    when rebuilding from a replay (the journal already holds history).
    """

    def __init__(
        self,
        view: ClusterView,
        journal: "SupervisorJournal | str",
        bootstrap: bool = True,
        **kwargs: Any,
    ):
        super().__init__(view, **kwargs)
        self.journal = (
            SupervisorJournal(journal) if isinstance(journal, str)
            else journal
        )
        if bootstrap:
            self.journal.append(
                KIND_BOOTSTRAP, {"view": view_to_dict(view)}
            )
        # Registered before any external listener: ElasticCluster binds
        # its ladder listeners at construction, after this line runs.
        self.add_listener(self._journal_change)

    def _journal_change(
        self, old: ClusterView, new: ClusterView, dead: FrozenSet[int]
    ) -> None:
        if dead:
            self.journal.append(
                KIND_VIEW_CHANGE,
                {"dead": sorted(dead), "epoch": new.epoch},
            )
            return
        # A rejoin notification: the (single) host in new but not old.
        old_ids = {h.host_id for h in old.hosts}
        for h in new.hosts:
            if h.host_id not in old_ids:
                self.journal.append(KIND_REJOIN, {"host": host_to_dict(h)})
                return

    def restore_epoch(self, epoch: int) -> None:
        before = self.view.epoch
        super().restore_epoch(epoch)
        if self.view.epoch > before:
            self.journal.append(KIND_EPOCH_RESTORE, {"epoch": epoch})

    def journal_scheduler_state(self, scheduler: Any) -> int:
        """Snapshot a fair-share scheduler (any object with
        ``export_state()``: the serve layer's ``FairShareScheduler``)
        into the journal (full export, newest-wins at replay) so a
        promoted standby preserves per-tenant deficits and admission
        order — the fairness half of the failover contract."""
        state = scheduler.export_state()
        seq = self.journal.append(KIND_SCHEDULER, {"state": state})
        self.metrics.incr("cluster.scheduler_snapshots")
        return seq

    def journal_job_registry(self, registry: Any) -> int:
        """Snapshot a job registry (any object with ``export_state()``:
        the serve layer's ``JobRegistry``) into the journal (the
        scheduler-snapshot pattern) so a promoted standby reconstructs
        the fabric's job table beside its ledger."""
        state = registry.export_state()
        seq = self.journal.append(KIND_JOB_REGISTRY, {"state": state})
        self.metrics.incr("cluster.job_registry_snapshots")
        return seq


# -- lease-based failover --------------------------------------------------


class SupervisorHA:
    """Leader + standby tier over one shared journal.

    The deployment model: the leader and every standby see the same
    journal (shared filesystem — the same substrate the checkpoint
    generations already require) and the stepper drives
    :meth:`step` periodically.  In-process (tests, the chip smoke)
    one ``SupervisorHA`` plays the whole tier: it renews the leader's
    lease each step, detects expiry, and promotes by journal replay.

    Fencing: the tier's ``term`` starts at 1 and bumps on every
    promotion.  :meth:`promote` stamps the new term onto the consumer
    connection's control senders, so every post-promotion command
    out-fences anything a zombie ex-leader still emits (the zombie's
    envelopes carry the old term and die, acked-but-unapplied, at each
    :class:`~ddl_tpu_torch.transport.envelope.EnvelopeReceiver`).
    """

    def __init__(
        self,
        leader: JournaledSupervisor,
        elastic: Any = None,
        scheduler: Any = None,
        lease_s: Optional[float] = None,
        standbys: Optional[int] = None,
        node_id: int = 0,
        metrics: Optional[Metrics] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        """``elastic`` (an :class:`~ddl_tpu_torch.cluster.elastic.ElasticCluster`)
        and ``scheduler`` (anything with ``adopt_state``: the serve
        layer's fair-share scheduler) are the rebind targets at
        promotion; either may be None.  ``node_id``
        identifies the stepping node at the ``cluster.supervise`` fault
        site (``producer_idx`` selector)."""
        self.leader: Optional[JournaledSupervisor] = leader
        self.journal = leader.journal
        self.elastic = elastic
        self.scheduler = scheduler
        self.lease_s = (
            float(envspec.get("DDL_TORCH_SUPERVISOR_LEASE_S"))
            if lease_s is None else float(lease_s)
        )
        self.standbys = (
            int(envspec.get("DDL_TORCH_SUPERVISOR_STANDBYS"))
            if standbys is None else int(standbys)
        )
        self.node_id = int(node_id)
        self.metrics = metrics or default_metrics()
        self._clock = clock
        self.term = 1
        self.promotions = 0
        self.last_takeover_s: Optional[float] = None
        #: The ex-leader after a promotion — split-brain tests drive its
        #: stale-term sends; production drops the reference eventually.
        self.deposed: Optional[JournaledSupervisor] = None
        self._lease_deadline = clock() + self.lease_s
        self._lease_lapsed_at: Optional[float] = None
        self._lock = named_rlock("cluster.supervisor")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.poll_interval_s = leader.poll_interval_s
        self.metrics.set_gauge("cluster.term", self.term)

    # -- the HA pass -------------------------------------------------------

    def step(self, now: Optional[float] = None) -> Optional[ClusterView]:
        """One HA pass: sweep membership through the live leader and
        renew its lease; on lease expiry (the leader crashed, or a
        partition ate its renewals past the budget), promote a standby.
        Returns the view when a promotion produced one, else None."""
        now = self._clock() if now is None else now
        with self._lock:
            partitioned = False
            try:
                # Chaos site (producer_idx = the stepping node's id):
                # SUPERVISOR_CRASH kills the leader outright;
                # NETWORK_PARTITION suppresses this step's lease renewal
                # without killing it — the split-brain producer.
                # Must sit inside the critical section: it exists to
                # crash/delay mid-pass; disarmed it is one attr read.
                fault_point(
                    "cluster.supervise", producer_idx=self.node_id
                )
            except SupervisorCrashed:
                if self.leader is not None:
                    self._leader_died("fault:SUPERVISOR_CRASH")
            except NetworkPartitioned:
                partitioned = True
                self.metrics.incr("cluster.partition_steps")
            if self.leader is not None and not partitioned:
                try:
                    self.leader.sweep(now)
                except (ShutdownRequested, KeyboardInterrupt):
                    raise
                except Exception:
                    # A sweep crash is a leader failure, not a monitor
                    # wedge: stop renewing and let the lease decide.
                    logger.exception("supervision: leader sweep raised")
                    self._leader_died("sweep-exception")
                else:
                    self._lease_deadline = now + self.lease_s
                    self.metrics.incr("cluster.lease_renewals")
                    return None
            if now < self._lease_deadline:
                return None  # within the lease budget: no churn yet
            if self._lease_lapsed_at is None:
                self._lease_lapsed_at = now
            return self.promote(now)

    def kill_leader(self) -> None:
        """Operator/chaos hammer: the leader is gone NOW (its lease
        still runs out the budget before a standby takes over)."""
        with self._lock:
            if self.leader is not None:
                self._leader_died("killed")

    def _leader_died(self, reason: str) -> None:
        self.deposed = self.leader
        self.leader = None
        self.metrics.incr("cluster.supervisor_crashes")
        logger.error("supervision: leader lost (%s) — lease expires in "
                     "%.3fs", reason, self._lease_deadline - self._clock())
        self._flight("supervisor.crashed", {"reason": reason})

    # -- promotion ---------------------------------------------------------

    def promote(self, now: Optional[float] = None) -> Optional[ClusterView]:
        """Promote a standby: replay the journal, rebuild the
        supervisor, adopt the scheduler snapshot, bump the fencing
        term, re-fence the control plane, and re-send the current
        view's adoptions through the acked envelope seam."""
        now = self._clock() if now is None else now
        with self._lock:
            if self.standbys < 1:
                # No standby provisioned: a fatal gap, surfaced loudly
                # once (the data plane owns the ensuing failure).
                self.metrics.incr("cluster.promotions_refused")
                logger.error(
                    "supervision: lease lapsed with zero standbys "
                    "(DDL_TORCH_SUPERVISOR_STANDBYS=0) — cannot promote"
                )
                self._lease_deadline = now + self.lease_s
                return None
            t0 = self._clock()
            state = replay_journal(self.journal)
            if state.view is None:
                raise DDLError(
                    "supervision: journal holds no bootstrap view — "
                    "nothing to promote from"
                )
            if self.leader is not None:
                self.deposed = self.leader
            old_term = self.term
            self.term = max(self.term, state.term) + 1
            sup = JournaledSupervisor(
                state.view,
                journal=self.journal,
                bootstrap=False,  # history already journaled
                lease_s=self.lease_s,
                poll_interval_s=self.poll_interval_s,
                metrics=self.metrics,
                clock=self._clock,
                local_host_ids=(
                    set(self.deposed.local_host_ids)
                    if self.deposed is not None
                    and self.deposed.local_host_ids is not None
                    else None
                ),
            )
            sup._departed_hosts = list(state.departed)
            self.journal.append(
                KIND_PROMOTION,
                {"term": self.term, "epoch": state.view.epoch,
                 "node": self.node_id},
            )
            self.leader = sup
            self._lease_deadline = now + self.lease_s
            if self.scheduler is not None and state.scheduler_state:
                self.scheduler.adopt_state(state.scheduler_state)
                self.metrics.incr("cluster.scheduler_adoptions")
            if self.elastic is not None:
                self.elastic.rebind_supervisor(sup)
                conn = getattr(
                    getattr(self.elastic, "workers", None), "connection", None
                )
                if conn is not None:
                    # Every post-promotion command now out-fences the
                    # zombie; then re-ship the replayed view's adoptions
                    # (dedup'd at the producer if the old leader's last
                    # sends did land).
                    conn.set_control_fence(self.term)
                self.elastic._send_adoptions(state.view, None)
            self.promotions += 1
            lapsed = self._lease_lapsed_at
            self._lease_lapsed_at = None
            takeover = (self._clock() - t0) + (
                max(0.0, now - lapsed) if lapsed is not None else 0.0
            )
            self.last_takeover_s = takeover
            self.metrics.incr("cluster.promotions")
            self.metrics.set_gauge("cluster.term", self.term)
            self.metrics.set_gauge("cluster.takeover_s", takeover)
            logger.warning(
                "supervision: standby promoted — term %d -> %d, epoch %d, "
                "%d journal record(s) replayed, takeover %.3fs",
                old_term, self.term, state.view.epoch, state.records,
                takeover,
            )
            self._flight(
                "supervisor.promoted",
                {"term": self.term, "epoch": state.view.epoch,
                 "records": state.records, "takeover_s": round(takeover, 6)},
            )
            return state.view

    def _flight(self, reason: str, extra: dict) -> None:
        from ddl_tpu_torch.obs import recorder as _flight

        if _flight.armed_recorder() is not None:
            _flight.flight_dump(reason, metrics=self.metrics, extra=extra)

    # -- optional background loop ------------------------------------------

    def start(self) -> "SupervisorHA":
        self._thread = threading.Thread(
            target=self._run, name="ddl-supervisor-ha", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.poll_interval_s * 2 + 1)

    def __enter__(self) -> "SupervisorHA":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    def _run(self) -> None:
        # Bounded by the stop event's timed wait; every step
        # consults the leadership lease — never a free spin.
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.step()
            except (ShutdownRequested, KeyboardInterrupt):
                return
            except Exception:
                # A crashing step must never disable failover itself.
                logger.exception("supervision: HA step raised; continuing")
                continue
