"""The port's survivable control plane (``ddl_tpu_torch.cluster.
supervision``) against the JAX package's, the twins of
``tests/test_supervision.py``.

- **journal** — the same record sequence writes byte-equal journals in
  both packages, and each package's ``replay_journal`` reads the other's
  file; torn-tail truncation and mid-file tamper detection.
- **replay** — the replayed view, epoch fence and departed hosts equal
  the leader's, and the JAX package's replay of the same journal.
- **envelope seam** — ``CONTROL_MSG_DROP`` / ``NETWORK_PARTITION``
  absorbed by the backoff retry, ``CONTROL_MSG_DUP`` by the
  ``(incarnation, seq)`` dedup, a zombie ex-leader's stale term dropped
  but acked — in both packages, with equal observables.
- **HA failover** under a fake clock: ``SUPERVISOR_CRASH`` at
  ``cluster.supervise``, a persistent ``NETWORK_PARTITION`` (split
  brain), zero-standby refusal, the promoted leader sweeping on — with
  the JAX package's counters, terms and views.
- **e2e** — a live THREAD pipeline whose supervisor is killed mid-stream
  (the promoted standby replays the journal, the stream completes
  byte-identical with no watchdog failure), and the host-loss ladder
  under envelope drop and duplication.

- **scheduler failover** — the reference's ``TestSchedulerFailover``
  over each package's real ``FairShareScheduler``: export/adopt
  round-trips bit for bit, a scheduler adopted mid-script grants what
  the uninterrupted one grants, an unknown snapshot version is refused;
  and a promoted leader adopts the journaled scheduler while the fabric
  rebuilt from the same journal adopts the job registry.

The journal hook is also held with a duck-typed scheduler.
"""

import pathlib
import time

import numpy as np
import pytest

from test_torch_cluster import (
    PKG,
    _canon,
    _view,
    assert_full_coverage_byte_identical,
    drain_cluster,
)
from torch_cluster_producers import ROWS, ShardRangeProducer


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def small_view(cl, n_hosts=2, n_shards=4):
    return cl.ClusterView.bootstrap(
        [cl.HostInfo(i, loader_ranks=(i + 1,)) for i in range(n_hosts)],
        n_shards=n_shards)


def _sv(pkg):
    return PKG[pkg].cl.supervision


class Scheduler:
    """A duck-typed fair-share scheduler: the journal hook needs only
    ``export_state``."""

    def __init__(self, tenants):
        self.tenants = dict(tenants)

    def export_state(self):
        return {"version": 1, "tenants": dict(self.tenants)}


def _history(pkg, path):
    """One scripted reign: bootstrap, a loss, an epoch restore, a
    scheduler snapshot, a rejoin, a future record kind."""
    cl = PKG[pkg].cl
    sup = cl.JournaledSupervisor(small_view(cl, 3, 6), journal=str(path),
                                 metrics=PKG[pkg].Metrics())
    sup.declare_host_loss(1)
    sup.restore_epoch(7)
    sup.journal_scheduler_state(Scheduler({"a": 2.0}))
    sup.rejoin(cl.HostInfo(1, loader_ranks=(2,)))
    sup.declare_host_loss(2)
    sup.journal.append("future_extension", {"anything": True})
    return sup


# ---------------------------------------------------------------------------
# Journal
# ---------------------------------------------------------------------------


class TestJournal:
    def test_same_records_write_byte_equal_journals(self, tmp_path):
        sups = {pkg: _history(pkg, tmp_path / f"{pkg}.bin")
                for pkg in ("jax", "torch")}
        raw = {pkg: (tmp_path / f"{pkg}.bin").read_bytes() for pkg in sups}
        assert raw["torch"] == raw["jax"]
        assert len(raw["torch"]) > 0
        assert _canon(sups["torch"].view) == _canon(sups["jax"].view)

    @pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                               ("jax", "torch")])
    def test_each_replays_the_others_journal(self, tmp_path, writer, reader):
        path = tmp_path / "journal.bin"
        sup = _history(writer, path)
        state = _sv(reader).replay_journal(str(path))
        assert _canon(state.view) == _canon(sup.view)
        assert [h.host_id for h in state.departed] == [2]
        assert state.epoch_restores == 1 and state.records == 7
        assert state.scheduler_state == {"version": 1, "tenants": {"a": 2.0}}
        own = _sv(writer).replay_journal(str(path))
        assert (state.term, state.records) == (own.term, own.records)

    def test_append_replay_roundtrip(self, tmp_path):
        j = _sv("torch").SupervisorJournal(str(tmp_path / "journal.bin"))
        j.append("bootstrap", {"view": {"x": 1}})
        j.append("view_change", {"dead": [2], "epoch": 1})
        recs = _sv("torch").SupervisorJournal(j.path).records()
        assert [r["kind"] for r in recs] == ["bootstrap", "view_change"]
        assert [r["seq"] for r in recs] == [0, 1]
        assert recs[1]["data"] == {"dead": [2], "epoch": 1}

    @pytest.mark.parametrize("pkg", ["jax", "torch"])
    def test_torn_tail_truncated_and_appends_resume(self, tmp_path, pkg):
        sv = _sv(pkg)
        j = sv.SupervisorJournal(str(tmp_path / "journal.bin"))
        for i in range(3):
            j.append("view_change", {"dead": [i], "epoch": i + 1})
        with open(j.path, "ab") as f:
            f.write(b"DDLJRN1\0\xff\xff")
        j2 = sv.SupervisorJournal(j.path)
        assert j2.next_seq == 3
        j2.append("rejoin", {"host": {}})
        recs = j2.records()
        assert len(recs) == 4 and recs[-1]["kind"] == "rejoin"

    def test_torn_tails_truncate_to_equal_bytes(self, tmp_path):
        """Both packages truncate the same torn file to the same bytes."""
        out = {}
        for pkg in ("jax", "torch"):
            j = _sv(pkg).SupervisorJournal(str(tmp_path / f"{pkg}.bin"))
            for i in range(3):
                j.append("view_change", {"dead": [i], "epoch": i + 1})
            with open(j.path, "ab") as f:
                f.write(b"DDLJRN1\0\xff\xff")
            _sv(pkg).SupervisorJournal(j.path)
            out[pkg] = pathlib.Path(j.path).read_bytes()
        assert out["torch"] == out["jax"]

    @pytest.mark.parametrize("pkg", ["jax", "torch"])
    def test_mid_file_tamper_stops_replay_there(self, tmp_path, pkg):
        sv = _sv(pkg)
        j = sv.SupervisorJournal(str(tmp_path / "journal.bin"))
        assert j.append("bootstrap", {"view": {}}) == 0
        j.append("view_change", {"dead": [1], "epoch": 1})
        raw = bytearray(open(j.path, "rb").read())
        raw[len(b"DDLJRN1\0") + 6] ^= 0xFF
        with open(j.path, "wb") as f:
            f.write(bytes(raw))
        assert sv.SupervisorJournal(j.path).records() == []
        other = _sv("jax" if pkg == "torch" else "torch")
        assert other.SupervisorJournal(j.path).records() == []


# ---------------------------------------------------------------------------
# Deterministic replay
# ---------------------------------------------------------------------------


class TestReplay:
    def test_replay_reconstructs_view_epoch_and_departed(self, tmp_path):
        path = str(tmp_path / "journal.bin")
        cl = PKG["torch"].cl
        sup = cl.JournaledSupervisor(small_view(cl, 3, 6), journal=path)
        sup.declare_host_loss(1)
        sup.restore_epoch(7)
        sup.rejoin(cl.HostInfo(1, loader_ranks=(2,)))
        state = cl.replay_journal(path)
        assert state.view == sup.view
        assert state.departed == []
        assert state.epoch_restores == 1
        assert _canon(_sv("jax").replay_journal(path).view) == _canon(sup.view)

    def test_departed_hosts_survive_replay(self, tmp_path):
        path = str(tmp_path / "journal.bin")
        cl = PKG["torch"].cl
        sup = cl.JournaledSupervisor(small_view(cl, 3, 6), journal=path)
        sup.declare_host_loss(2)
        state = cl.replay_journal(path)
        assert [h.host_id for h in state.departed] == [2]
        assert state.view == sup.view

    def test_newest_scheduler_snapshot_wins(self, tmp_path):
        path = str(tmp_path / "journal.bin")
        cl = PKG["torch"].cl
        m = PKG["torch"].Metrics()
        sup = cl.JournaledSupervisor(small_view(cl), journal=path, metrics=m)
        sched = Scheduler({"a": 2.0})
        sup.journal_scheduler_state(sched)
        sched.tenants["b"] = 1.0
        sup.journal_scheduler_state(sched)
        state = cl.replay_journal(path)
        assert sorted(state.scheduler_state["tenants"]) == ["a", "b"]
        assert m.counter("cluster.scheduler_snapshots") == 2.0

    def test_unknown_record_kinds_are_skipped(self, tmp_path):
        cl = PKG["torch"].cl
        j = cl.SupervisorJournal(str(tmp_path / "journal.bin"))
        sup = cl.JournaledSupervisor(small_view(cl), journal=j)
        j.append("future_extension", {"anything": True})
        sup.declare_host_loss(1)
        assert cl.replay_journal(j).view == sup.view


# ---------------------------------------------------------------------------
# Envelope seam: at-least-once, dedup and fencing
# ---------------------------------------------------------------------------


class WireHarness:
    """A ControlSender wired straight into an EnvelopeReceiver through a
    visible wire list, acks routed back."""

    def __init__(self, pkg, **sender_kw):
        from importlib import import_module

        env = import_module(f"{PKG[pkg].root}.transport.envelope")
        self.delivered = []
        self.rx = env.EnvelopeReceiver(producer_idx=1)
        self.metrics = PKG[pkg].Metrics()
        self.clock = FakeClock()
        self.tx = env.ControlSender(self.delivered.append, target=1,
                                    metrics=self.metrics, clock=self.clock,
                                    **sender_kw)

    def apply_all(self):
        applied = []
        while self.delivered:
            env = self.delivered.pop(0)
            payload, ack = self.rx.accept(env)
            self.tx.ack(ack)
            if payload is not None:
                applied.append(payload)
        return applied


CTRL = ("ctrl.wire_drops", "ctrl.wire_dups", "ctrl.acked", "ctrl.retries",
        "ctrl.stale_acks", "ctrl.send_exhausted")


def _both(body):
    """Run ``body(pkg)`` in both packages; their traces must be equal."""
    out = {pkg: body(pkg) for pkg in ("jax", "torch")}
    assert out["torch"] == out["jax"]
    return out["torch"]


class TestEnvelopeSeam:
    def test_drop_is_absorbed_by_backoff_retry(self):
        def body(pkg):
            f = PKG[pkg].faults
            h = WireHarness(pkg, retries=5, backoff_s=0.1)
            plan = f.FaultPlan([f.FaultSpec("transport.control_send",
                                            f.FaultKind.CONTROL_MSG_DROP)])
            with f.armed(plan):
                h.tx.send({"cmd": "adopt"})
            trace = [len(h.delivered), h.tx.pending_count()]
            h.clock.advance(0.2)
            trace += [h.tx.pump(), h.apply_all(), h.tx.pending_count()]
            return trace + [h.metrics.counter(c) for c in CTRL]

        trace = _both(body)
        assert trace[:5] == [0, 1, 1, [{"cmd": "adopt"}], 0]

    def test_partition_drops_every_attempt_until_heal(self):
        def body(pkg):
            f = PKG[pkg].faults
            h = WireHarness(pkg, retries=8, backoff_s=0.1)
            plan = f.FaultPlan([f.FaultSpec(
                "transport.control_send", f.FaultKind.NETWORK_PARTITION,
                count=2)])
            with f.armed(plan):
                h.tx.send({"cmd": "adopt"})
                h.clock.advance(0.3)
                h.tx.pump()
                lost = len(h.delivered)
                h.clock.advance(0.5)
                h.tx.pump()
            return [lost, h.apply_all()] + [h.metrics.counter(c) for c in CTRL]

        trace = _both(body)
        assert trace[:3] == [0, [{"cmd": "adopt"}], 2.0]

    def test_dup_is_deduped_and_reacked(self):
        def body(pkg):
            f = PKG[pkg].faults
            h = WireHarness(pkg)
            plan = f.FaultPlan([f.FaultSpec("transport.control_send",
                                            f.FaultKind.CONTROL_MSG_DUP)])
            with f.armed(plan):
                h.tx.send({"cmd": "replay"})
            same = h.delivered[0] is h.delivered[1]
            return [len(h.delivered), same, h.apply_all(), h.rx.dups] + [
                h.metrics.counter(c) for c in CTRL]

        trace = _both(body)
        assert trace[:4] == [2, True, [{"cmd": "replay"}], 1]

    def test_retry_cap_moves_to_exhausted_never_silent(self):
        def body(pkg):
            f = PKG[pkg].faults
            h = WireHarness(pkg, retries=2, backoff_s=0.01)
            plan = f.FaultPlan([f.FaultSpec(
                "transport.control_send", f.FaultKind.CONTROL_MSG_DROP,
                count=99)])
            with f.armed(plan):
                h.tx.send({"cmd": "adopt"})
                for _ in range(6):
                    h.clock.advance(1.0)
                    h.tx.pump()
            return [h.tx.pending_count(), len(h.tx.exhausted)] + [
                h.metrics.counter(c) for c in CTRL]

        assert _both(body)[:2] == [0, 1]

    def test_zombie_fence_dropped_but_acked(self):
        def body(pkg):
            from importlib import import_module

            root = PKG[pkg].root
            env = import_module(f"{root}.transport.envelope")
            Env = import_module(f"{root}.types").ControlEnvelope
            rx = env.EnvelopeReceiver(producer_idx=1)
            fresh = rx.accept(Env(seq=0, incarnation=1, fence=2,
                                  payload={"cmd": "adopt", "term": 2}))
            zombie = rx.accept(Env(seq=5, incarnation=0, fence=1,
                                   payload={"cmd": "adopt", "term": 1}))
            return [fresh[0], rx.fence, zombie[0], zombie[1].fence_rejected,
                    rx.fence_drops, rx.accepted]

        assert _both(body) == [{"cmd": "adopt", "term": 2}, 2, None, True, 1, 1]

    def test_adoption_rides_the_connection_fence(self):
        """``set_control_fence`` stamps the promoted term on the senders
        built before and after it, as the JAX package's connection does."""
        def body(pkg):
            from importlib import import_module

            conn_mod = import_module(f"{PKG[pkg].root}.transport.connection")
            types_mod = PKG[pkg].types
            a, _b = conn_mod.ThreadChannel.pair()
            c, _d = conn_mod.ThreadChannel.pair()
            conn = conn_mod.ConsumerConnection([a, c])
            conn.send_control_acked(0, types_mod.ShardAdoption(
                ranges=((0, 2),), view_epoch=1))
            conn.set_control_fence(3)
            conn.send_control_acked(1, types_mod.ShardAdoption(
                ranges=((2, 4),), view_epoch=1))
            sent = [_b.recv(1.0), _d.recv(1.0)]
            return [(e.fence, e.payload.ranges) for e in sent] + [
                conn.control_sender(0).fence]

        assert _both(body) == [(0, ((0, 2),)), (3, ((2, 4),)), 3]


# ---------------------------------------------------------------------------
# HA failover (fake clock)
# ---------------------------------------------------------------------------


def make_ha(pkg, tmp_path, lease_s=1.0, standbys=1, **kw):
    cl = PKG[pkg].cl
    clock = FakeClock()
    m = PKG[pkg].Metrics()
    sup = cl.JournaledSupervisor(
        small_view(cl), journal=str(tmp_path / f"{pkg}-journal.bin"),
        lease_s=50.0, metrics=m, clock=clock)
    ha = cl.SupervisorHA(sup, lease_s=lease_s, standbys=standbys, metrics=m,
                         clock=clock, **kw)
    return ha, sup, clock, m


HA_COUNTERS = ("cluster.promotions", "cluster.supervisor_crashes",
               "cluster.partition_steps", "cluster.promotions_refused",
               "cluster.lease_renewals")


class TestHAFailover:
    def test_lease_expiry_promotes_standby(self, tmp_path):
        def body(pkg):
            ha, sup, clock, m = make_ha(pkg, tmp_path)
            sup.declare_host_loss(1)
            ha.kill_leader()
            early = ha.step(now=clock.advance(0.5))
            view = ha.step(now=clock.advance(0.7))
            assert view == sup.view and ha.leader.view == sup.view
            assert ha.leader is not sup and ha.deposed is sup
            assert ha.last_takeover_s is not None
            replayed = PKG[pkg].cl.replay_journal(ha.journal)
            return [early, _canon(view), ha.term, replayed.term] + [
                m.counter(c) for c in HA_COUNTERS]

        trace = _both(body)
        assert trace[0] is None and trace[2:4] == [2, 2]

    def test_supervisor_crash_fault_drives_failover(self, tmp_path):
        def body(pkg):
            f = PKG[pkg].faults
            ha, sup, clock, m = make_ha(pkg, tmp_path)
            plan = f.FaultPlan([f.FaultSpec(
                "cluster.supervise", f.FaultKind.SUPERVISOR_CRASH, at=2)])
            with f.armed(plan):
                steps = [ha.step(now=clock.advance(0.1)),
                         ha.step(now=clock.advance(0.1))]
                dead = ha.leader is None
                view = ha.step(now=clock.advance(1.5))
            assert plan.fired
            return steps + [dead, _canon(view), ha.term] + [
                m.counter(c) for c in HA_COUNTERS]

        trace = _both(body)
        assert trace[:3] == [None, None, True] and trace[4] == 2

    def test_partition_suppresses_renewal_into_split_brain(self, tmp_path):
        def body(pkg):
            f = PKG[pkg].faults
            ha, sup, clock, m = make_ha(pkg, tmp_path)
            plan = f.FaultPlan([f.FaultSpec(
                "cluster.supervise", f.FaultKind.NETWORK_PARTITION,
                count=99)])
            with f.armed(plan):
                first = ha.step(now=clock.advance(0.5))
                view = ha.step(now=clock.advance(0.7))
            assert ha.deposed is sup
            return [first, _canon(view), ha.term] + [
                m.counter(c) for c in HA_COUNTERS]

        trace = _both(body)
        assert trace[0] is None and trace[2] == 2 and trace[5] == 2.0

    def test_zero_standbys_refuses_promotion_loudly(self, tmp_path):
        def body(pkg):
            ha, sup, clock, m = make_ha(pkg, tmp_path, standbys=0)
            ha.kill_leader()
            got = ha.step(now=clock.advance(2.0))
            return [got, ha.leader] + [m.counter(c) for c in HA_COUNTERS]

        trace = _both(body)
        assert trace[:2] == [None, None] and trace[2 + 3] == 1.0

    def test_promoted_leader_keeps_sweeping(self, tmp_path):
        def body(pkg):
            ha, sup, clock, m = make_ha(pkg, tmp_path)
            ha.kill_leader()
            ha.step(now=clock.advance(1.5))
            new = ha.leader.declare_host_loss(1)
            state = PKG[pkg].cl.replay_journal(ha.journal)
            assert state.view == new
            return [_canon(new), state.term, state.records]

        trace = _both(body)
        assert trace[0][0] == 1 and [h[0] for h in trace[0][2]] == [0]

    def test_supervisor_knobs_come_from_envspec(self, monkeypatch, tmp_path):
        monkeypatch.setenv("DDL_TORCH_SUPERVISOR_LEASE_S", "0.75")
        monkeypatch.setenv("DDL_TORCH_SUPERVISOR_STANDBYS", "0")
        cl = PKG["torch"].cl
        sup = cl.JournaledSupervisor(small_view(cl),
                                     journal=str(tmp_path / "j.bin"))
        ha = cl.SupervisorHA(sup)
        assert (ha.lease_s, ha.standbys) == (0.75, 0)
        monkeypatch.delenv("DDL_TORCH_SUPERVISOR_LEASE_S")
        monkeypatch.delenv("DDL_TORCH_SUPERVISOR_STANDBYS")
        ha = cl.SupervisorHA(sup)
        assert (ha.lease_s, ha.standbys) == (2.0, 1)


# ---------------------------------------------------------------------------
# Scheduler fairness across failover
# ---------------------------------------------------------------------------


def scripted_scheduler(pkg, clock):
    serve = _serve(pkg)
    s = serve.FairShareScheduler(quantum_bytes=1 << 20,
                                 metrics=PKG[pkg].Metrics(), clock=clock)
    s.register(serve.TenantSpec("heavy", weight=2.0,
                                byte_budget_per_s=float(4 << 20)))
    s.register(serve.TenantSpec("light", weight=1.0,
                                byte_budget_per_s=float(1 << 20)))
    return s


def _serve(pkg):
    import importlib

    return importlib.import_module(f"{PKG[pkg].root}.serve")


def run_script(pkg, sched, clock, steps):
    """The reference's admission script: each step advances the fake
    clock, probes both tenants non-blocking, and serves a window for
    every grant.  Returns the grant/throttle trace."""
    trace = []
    for _ in range(steps):
        clock.advance(0.25)
        for name in ("heavy", "light"):
            try:
                sched.admit(name, timeout_s=0.0)
            except PKG[pkg].exc.StallTimeoutError:
                trace.append((name, "throttled"))
                continue
            sched.note_served(name, 1 << 20)
            trace.append((name, "granted"))
    return trace


class TestSchedulerFailover:
    def test_export_adopt_roundtrips_bit_exact(self):
        def body(pkg):
            clock = FakeClock(100.0)
            donor = scripted_scheduler(pkg, clock)
            run_script(pkg, donor, clock, steps=3)
            snap = donor.export_state(now=clock())
            heir = _serve(pkg).FairShareScheduler(
                metrics=PKG[pkg].Metrics(), clock=clock)
            heir.adopt_state(snap, now=clock())
            assert heir.export_state(now=clock()) == snap
            return snap

        _both(body)

    def test_post_failover_admission_order_matches_uninterrupted(self):
        def body(pkg):
            c1, c2 = FakeClock(100.0), FakeClock(100.0)
            uninterrupted = scripted_scheduler(pkg, c1)
            interrupted = scripted_scheduler(pkg, c2)
            head1 = run_script(pkg, uninterrupted, c1, steps=4)
            head2 = run_script(pkg, interrupted, c2, steps=4)
            assert head1 == head2
            snap = interrupted.export_state(now=c2())
            standby = _serve(pkg).FairShareScheduler(
                metrics=PKG[pkg].Metrics(), clock=c2)
            standby.adopt_state(snap, now=c2())
            tail_uninterrupted = run_script(pkg, uninterrupted, c1, steps=6)
            tail_failover = run_script(pkg, standby, c2, steps=6)
            assert tail_failover == tail_uninterrupted
            assert any(t == ("light", "throttled") for t in tail_failover)
            return head1 + tail_failover

        _both(body)

    def test_adopt_rejects_unknown_version(self):
        def body(pkg):
            s = _serve(pkg).FairShareScheduler(metrics=PKG[pkg].Metrics())
            with pytest.raises(PKG[pkg].exc.DDLError):
                s.adopt_state({"version": 99})
            return True

        _both(body)

    def test_promoted_leader_adopts_journaled_scheduler_and_registry(
            self, tmp_path):
        """The journal hooks take the real scheduler and job registry; the
        HA tier's promotion adopts the newest scheduler snapshot into its
        ``scheduler=``, and a fabric rebuilt from the same journal adopts
        the registry."""
        def body(pkg):
            import importlib

            serve = _serve(pkg)
            fabric = importlib.import_module(f"{PKG[pkg].root}.serve.fabric")
            clock = FakeClock(100.0)
            ha, sup, _, m = make_ha(pkg, tmp_path)
            live = scripted_scheduler(pkg, clock)
            run_script(pkg, live, clock, steps=5)
            registry = serve.JobRegistry(metrics=m)
            for spec in (serve.JobSpec("heavy", weight=2.0),
                         serve.JobSpec("light")):
                registry.register(spec)
            sup.journal_scheduler_state(live)
            sup.journal_job_registry(registry)
            heir = serve.FairShareScheduler(metrics=m, clock=clock)
            ha.scheduler = heir
            ha.kill_leader()
            ha.step(now=2.0)
            assert ha.leader is not None and ha.term == 2
            rebuilt = fabric.IngestFabric.from_journal(
                str(tmp_path / f"{pkg}-journal.bin"), metrics=m, clock=clock)
            assert rebuilt.registry.export_state() == registry.export_state()
            # adopt_state ages the buckets by the adopter's clock, which
            # is the same fake clock: the ledger comes over bit for bit.
            assert (heir.export_state(now=clock())
                    == live.export_state(now=clock()))
            return (heir.export_state(now=clock()),
                    rebuilt.registry.export_state(),
                    m.counter("cluster.scheduler_adoptions"))

        _both(body)


# ---------------------------------------------------------------------------
# Fault-matrix reflection
# ---------------------------------------------------------------------------


#: Kinds whose sites the port does not have: none since the serve and
#: tune layers were ported.
UNPORTED_KINDS = set()


def test_every_ported_fault_kind_has_a_chaos_row():
    """Every ``FaultKind`` is used by some test of the port (a
    ``test_torch_*`` file or a case module both packages run)."""
    tests_dir = pathlib.Path(__file__).parent
    corpus = "".join(p.read_text(encoding="utf-8")
                     for p in sorted(tests_dir.glob("test_torch_*.py"))
                     + sorted(tests_dir.glob("torch_*_cases.py")))
    missing = {k.name for k in PKG["torch"].faults.FaultKind
               if f"FaultKind.{k.name}" not in corpus}
    assert missing <= UNPORTED_KINDS, missing - UNPORTED_KINDS


# ---------------------------------------------------------------------------
# e2e: a mid-stream supervisor kill on a live pipeline
# ---------------------------------------------------------------------------


def drain_with_failover(pkg, kill_after_epoch, journal_path, n_epochs=12):
    """The 2-mock-host THREAD pipeline with a journaled supervisor under a
    fast HA stepper; the leader is killed at ``kill_after_epoch`` and the
    standby must take over mid-stream."""
    p = PKG[pkg]
    m = p.Metrics()
    producer = ShardRangeProducer({1: ((0, 2),), 2: ((2, 4),)}, pkg=p.root)
    kw = {"pin_memory": False} if pkg == "torch" else {}

    @p.mod.distributed_dataloader(n_producers=2, mode="thread", **kw)
    def main(env):
        sup = p.cl.JournaledSupervisor(_view(p.cl), journal=journal_path,
                                       lease_s=30.0, poll_interval_s=0.05,
                                       metrics=m)
        elastic = p.cl.ElasticCluster(sup, workers=env.workers, metrics=m)
        ha = p.cl.SupervisorHA(sup, elastic=elastic, lease_s=0.3,
                               standbys=1, metrics=m).start()
        loader = p.mod.DistributedDataLoader(
            producer, batch_size=ROWS, connection=env.connection,
            n_epochs=n_epochs, output="numpy", timeout_s=60.0, metrics=m,
            cluster=elastic)
        wd = p.Watchdog(env.workers, poll_interval_s=0.05,
                        stall_budget_s=60.0, respawn=True, metrics=m).start()
        seen = {}
        try:
            for ep in range(n_epochs):
                for (win,) in loader:
                    seen.setdefault(int(win[0, 0] // 1000), []).append(
                        np.array(win, copy=True))
                    loader.mark(p.types.Marker.END_OF_BATCH)
                loader.mark(p.types.Marker.END_OF_EPOCH)
                if ep == kill_after_epoch:
                    ha.kill_leader()
                if ep == kill_after_epoch + 1:
                    deadline = time.monotonic() + 10.0
                    while ha.leader is None:
                        assert time.monotonic() < deadline, "no promotion"
                        time.sleep(0.02)
        finally:
            wd.stop()
            ha.stop()
        return seen, ha

    seen, ha = main()
    return seen, ha, m


class TestFailoverE2E:
    def test_mid_stream_supervisor_kill_byte_identical(self, tmp_path):
        out = {}
        for pkg in ("torch", "jax"):
            seen, ha, m = drain_with_failover(
                pkg, kill_after_epoch=2,
                journal_path=str(tmp_path / f"{pkg}.bin"))
            assert_full_coverage_byte_identical(seen)
            out[pkg] = [ha.term] + [m.counter(c) for c in (
                "cluster.promotions", "cluster.supervisor_crashes",
                "cluster.supervisor_rebinds", "watchdog.failures")]
        assert out["torch"] == out["jax"] == [2, 1.0, 1.0, 1.0, 0.0]
        # The journals the two reigns wrote are byte-equal.
        assert ((tmp_path / "torch.bin").read_bytes()
                == (tmp_path / "jax.bin").read_bytes())


class TestEnvelopeChaosE2E:
    @pytest.mark.parametrize("kind", ["CONTROL_MSG_DROP", "CONTROL_MSG_DUP"])
    def test_adoption_send_chaos_is_absorbed(self, kind):
        """The host-loss adoption's first wire attempt is lost (retried)
        or duplicated (deduped at the producer): the stream recovers full
        byte-identical coverage in both packages."""
        for pkg in ("torch", "jax"):
            f = PKG[pkg].faults
            plan = f.FaultPlan([f.FaultSpec(
                "transport.control_send", getattr(f.FaultKind, kind))])
            seen, m, _sup = drain_cluster(pkg, plan=plan, n_epochs=20,
                                          kill_host_after_epoch=1,
                                          pace_s=0.02)
            assert plan.fired, f"{kind} never fired"
            assert m.counter("watchdog.failures") == 0.0
            assert_full_coverage_byte_identical(seen)
            if kind == "CONTROL_MSG_DROP":
                assert m.counter("ctrl.wire_drops") >= 1.0
                assert m.counter("ctrl.retries") >= 1.0
                assert m.counter("ctrl.acked") >= 1.0
            else:
                assert m.counter("ctrl.wire_dups") == 1.0
                assert (m.counter("ctrl.acked_dup")
                        + m.counter("ctrl.stale_acks")) >= 1.0
