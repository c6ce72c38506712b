"""The cases of ``tests/test_fabric.py`` written against a package root
(``ROOT``, set by ``tests/torch_twins.load``): ``tests/test_torch_fabric.py``
runs each against the JAX package and the port and holds what they saw
equal.  Cases return their observables (grant orders, exported ledgers
and registries, fired faults), and two cases of the port's own: each
package's fabric journal rebuilt by the other's ``from_journal``, and
``JobCacheView``'s accounting of every access its store saw."""

import importlib
import os

import numpy as np
import pytest

ROOT = globals().get("ROOT", "ddl_tpu_torch")
#: The other package: the cross-package journal case reads with it.
OTHER = "ddl_tpu" if ROOT == "ddl_tpu_torch" else "ddl_tpu_torch"


def _imp(module, *names, root=None):
    mod = importlib.import_module(f"{root or ROOT}.{module}")
    vals = tuple(getattr(mod, n) for n in names)
    return vals[0] if len(vals) == 1 else vals


faults = importlib.import_module(f"{ROOT}.faults")
integrity = importlib.import_module(f"{ROOT}.integrity")
(AdmissionDropped, DDLError, JobCrashed, StallTimeoutError,
 WindowsRevoked) = _imp("exceptions", "AdmissionDropped", "DDLError",
                        "JobCrashed", "StallTimeoutError", "WindowsRevoked")
FaultKind, FaultPlan, FaultSpec = faults.FaultKind, faults.FaultPlan, \
    faults.FaultSpec
Metrics = _imp("observability", "Metrics")
AdmitRequest, FabricClient, IngestFabric = _imp(
    "serve.fabric", "AdmitRequest", "FabricClient", "IngestFabric")
(NAMESPACE_SPAN, JobCacheView, JobRegistry, JobSpec,
 integrity_namespace) = _imp("serve.jobs", "NAMESPACE_SPAN", "JobCacheView",
                             "JobRegistry", "JobSpec", "integrity_namespace")
ControlEnvelope = _imp("types", "ControlEnvelope")

WINDOW = 16 << 10


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def make_fabric(journal=None, clock=None, jobs=(), quantum=1 << 20):
    """A fabric + one loopback client + registered FabricJob handles."""
    FairShareScheduler = _imp("serve.tenancy", "FairShareScheduler")

    clock = clock or FakeClock()
    m = Metrics()
    fab = IngestFabric(
        journal=journal,
        scheduler=FairShareScheduler(
            quantum_bytes=quantum, metrics=m, clock=clock
        ),
        metrics=m,
        clock=clock,
        snapshot_every=1,
    )
    client = FabricClient(fab, "host00", metrics=m, clock=clock)
    handles = [client.register_job(spec) for spec in jobs]
    return fab, client, handles, clock


# ---------------------------------------------------------------------------
# The chaos-matrix rows for the fabric fault kinds
# ---------------------------------------------------------------------------


class TestFabricChaosMatrix:
    def test_admission_drop_absorbed_by_retry_ledger_exactly_once(self):
        """FaultKind.JOB_ADMISSION_DROP at serve.fabric.admit: the wire
        attempt is lost, the acked-envelope seam retries it, and the
        scheduler ledger charges the admission exactly once."""
        fab, client, (job,), _ = make_fabric(
            jobs=[JobSpec("alpha", byte_budget_per_s=float(1 << 20))]
        )
        plan = FaultPlan([
            FaultSpec("serve.fabric.admit", FaultKind.JOB_ADMISSION_DROP,
                      at=1, producer_idx=job.index),
        ])
        with faults.armed(plan):
            job.admit(5.0)
        assert ("serve.fabric.admit", "job_admission_drop",
                job.index, 1) in plan.fired
        # Exactly-once despite the retry: ONE admission, ONE inflight.
        assert fab.metrics.counter("fabric.admissions") == 1
        state = fab.scheduler.export_state()
        assert state["tenants"]["alpha"]["inflight"] == 1
        assert fab.admission_log == ["alpha"]
        # And the retried wire attempt is visible on the sender seam.
        assert fab.metrics.counter("ctrl.wire_drops") == 1
        assert fab.metrics.counter("ctrl.retries") >= 1
        job.note_served(WINDOW)
        assert fab.scheduler.export_state()["tenants"]["alpha"][
            "inflight"] == 0
        return plan.fired, fab.scheduler.export_state(), fab.admission_log

    def test_admission_drop_exhaustion_raises_typed_and_mutates_nothing(self):
        """A persistent drop past the retry cap surfaces as the real
        AdmissionDropped with the scheduler ledger untouched."""
        clock = FakeClock()
        m = Metrics()
        fab = IngestFabric(metrics=m, clock=clock)
        client = FabricClient(
            fab, "host00", metrics=m, clock=clock, retries=2, backoff_s=0.0
        )
        job = client.register_job(JobSpec("alpha"))
        plan = FaultPlan([
            FaultSpec("serve.fabric.admit", FaultKind.JOB_ADMISSION_DROP,
                      at=1, count=50, producer_idx=job.index),
        ])
        with faults.armed(plan):
            with pytest.raises(AdmissionDropped):
                job.admit(5.0)
        assert fab.metrics.counter("fabric.admissions") == 0
        assert fab.admission_log == []
        assert m.counter("fabric.client_exhausted") == 1
        return plan.fired, fab.scheduler.export_state()

    def test_job_crash_mid_grant_revokes_inflight_releases_budget(self):
        """FaultKind.JOB_CRASH between admit and note_served: the crash
        ladder revokes the dead job's in-flight grant, drops its
        registration (budget + DRR share released), and the neighbour
        stays byte-correct."""
        fab, client, (crasher, neighbour), _ = make_fabric(jobs=[
            JobSpec("crasher", weight=2.0,
                    byte_budget_per_s=float(1 << 20)),
            JobSpec("neighbour", byte_budget_per_s=float(1 << 20)),
        ])
        crasher.admit(5.0)
        neighbour.admit(5.0)
        plan = FaultPlan([
            FaultSpec("serve.fabric.grant", FaultKind.JOB_CRASH,
                      at=1, producer_idx=crasher.index),
        ])
        with faults.armed(plan):
            with pytest.raises(JobCrashed):
                crasher.note_served(WINDOW)
            # The neighbour's charge rides the SAME armed plan: the
            # producer_idx selection must not splash onto it.
            neighbour.note_served(WINDOW)
        assert plan.fired == [
            ("serve.fabric.grant", "job_crash", crasher.index, 1)
        ]
        # The ladder ran: inflight released, registration dropped.
        assert fab.metrics.counter("fabric.job_crashes") == 1
        assert "crasher" not in fab.registry
        state = fab.scheduler.export_state()
        assert "crasher" not in state["tenants"]
        # Neighbour byte-correct: its ledger shows exactly its own
        # window served and nothing leaked from the crash.
        nb = state["tenants"]["neighbour"]
        assert nb["inflight"] == 0
        assert fab.admission_log == ["crasher", "neighbour"]
        # No leaked grant: a full-fleet drain completes immediately
        # instead of burning the SLO on the dead job's window.
        reply = fab.revoke_jobs(slo_s=0.2)
        assert reply.ok and reply.value["drained"] is True
        return state, fab.registry.export_state(), fab.report()["decisions"]

    def test_supervisor_side_crash_note_reports_revoked_count(self):
        fab, client, (job,), _ = make_fabric(jobs=[JobSpec("alpha")])
        job.admit(5.0)
        job.admit(5.0)
        reply = fab.job_crashed("alpha")
        assert reply.ok and reply.value["revoked_inflight"] == 2
        assert fab.job_crashed("alpha").ok is False  # already gone
        return reply.to_dict()


# ---------------------------------------------------------------------------
# The envelope seam: dedup + fencing at the authority
# ---------------------------------------------------------------------------


class TestFabricSeam:
    def test_duplicate_envelope_served_from_reply_cache(self):
        fab, client, (job,), _ = make_fabric(jobs=[JobSpec("alpha")])
        env = ControlEnvelope(
            seq=0, incarnation=7, fence=fab.term,
            payload=AdmitRequest("alpha", 5.0),
        )
        first, ack1 = fab.handle("hostX", env)
        again, ack2 = fab.handle("hostX", env)
        assert first.ok and not ack1.dup
        assert ack2.dup and again.ok
        assert fab.metrics.counter("fabric.dup_replies") == 1
        # Re-served, not re-applied: still ONE inflight window.
        assert fab.scheduler.export_state()["tenants"]["alpha"][
            "inflight"] == 1
        return first.to_dict(), again.to_dict(), ack2.dup

    def test_zombie_term_command_fenced_off_but_acked(self):
        clock = FakeClock()
        fab = IngestFabric(metrics=Metrics(), clock=clock, term=3)
        fab.register_job(JobSpec("alpha"))
        env = ControlEnvelope(
            seq=0, incarnation=0, fence=2,
            payload=AdmitRequest("alpha", 5.0),
        )
        reply, ack = fab.handle("zombie", env)
        assert ack.fence_rejected and reply.ok is False
        assert reply.error_type == "fenced"
        assert fab.metrics.counter("fabric.fence_drops") == 1
        assert fab.scheduler.export_state()["tenants"]["alpha"][
            "inflight"] == 0
        return reply.to_dict()

    def test_typed_errors_cross_the_seam(self):
        """StallTimeoutError / WindowsRevoked re-raise as themselves on
        the client side — the Tenant protocol's contract."""
        fab, client, (job,), _ = make_fabric(
            jobs=[JobSpec("alpha", byte_budget_per_s=1.0)]
        )
        job.admit(5.0)
        job.note_served(WINDOW)  # budget 1 B/s: deeply over budget now
        with pytest.raises(StallTimeoutError):
            job.admit(0.0)
        fab.revoke_jobs(slo_s=0.1)
        with pytest.raises(WindowsRevoked):
            job.admit(0.0)
        fab.clear_job_revocations()
        with pytest.raises(DDLError):
            client.register_job(JobSpec("alpha"))  # duplicate id


# ---------------------------------------------------------------------------
# Admission order == the in-process DRR, incl. across failover
# ---------------------------------------------------------------------------


def drive_trace(admitters, clock, steps, seed, start=0):
    """One deterministic demand trace: each step advances the shared
    fake clock then walks a seed-shuffled probe order over the jobs;
    every job probes non-blocking and charges a window when granted.
    ``admitters`` maps name -> object with admit/note_served (a
    FabricJob or an in-process scheduler shim).  Returns the grant
    order the trace produced."""
    import random

    names = sorted(admitters)
    grants = []
    for step in range(start, steps):
        clock.t += 0.25
        order = list(names)
        random.Random((seed << 20) | step).shuffle(order)
        for name in order:
            try:
                admitters[name].admit(0.0)
            except (StallTimeoutError, WindowsRevoked):
                continue
            admitters[name].note_served(WINDOW)
            grants.append(name)
    return grants


class SchedShim:
    """The in-process reference: same Tenant verbs, straight onto a
    local FairShareScheduler (the pre-fabric shape)."""

    def __init__(self, sched, name):
        self.sched, self.name = sched, name

    def admit(self, timeout_s):
        self.sched.admit(self.name, timeout_s)

    def note_served(self, nbytes):
        self.sched.note_served(self.name, nbytes)


def make_reference(specs, clock, quantum=1 << 20):
    FairShareScheduler = _imp("serve.tenancy", "FairShareScheduler")

    sched = FairShareScheduler(
        quantum_bytes=quantum, metrics=Metrics(), clock=clock
    )
    for spec in specs:
        sched.register(spec.tenant_spec())
    return sched, {
        spec.job_id: SchedShim(sched, spec.job_id) for spec in specs
    }


def trace_specs(n_jobs=4):
    # Budget-bound on purpose: demand (one window per 0.25 s step) far
    # exceeds every byte budget, so the DRR + token buckets are doing
    # real work and the grant order is a meaningful fingerprint.
    return [
        JobSpec(
            f"job{k}", weight=float(k + 1),
            byte_budget_per_s=float(k + 1) * 2 * WINDOW,
        )
        for k in range(n_jobs)
    ]


class TestAdmissionOrderProperty:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_fabric_grant_order_matches_in_process_drr(self, seed):
        specs = trace_specs()
        ref_clock, fab_clock = FakeClock(), FakeClock()
        ref_sched, ref_admitters = make_reference(specs, ref_clock)
        fab, client, handles, _ = make_fabric(clock=fab_clock, jobs=specs)
        ref_grants = drive_trace(ref_admitters, ref_clock, 24, seed)
        fab_grants = drive_trace(
            {h.job_id: h for h in handles}, fab_clock, 24, seed
        )
        assert fab_grants == ref_grants
        assert fab.admission_log == ref_grants
        assert len(ref_grants) > 0
        # Not just the order — the full ledgers agree bit-exact.
        assert (
            fab.scheduler.export_state(now=fab_clock())
            == ref_sched.export_state(now=ref_clock())
        )
        # The trace exercised real contention, not a vacuous all-grant.
        assert len(ref_grants) < 24 * len(specs)
        return fab_grants, fab.scheduler.export_state(now=fab_clock())

    @pytest.mark.parametrize("seed", [0, 1])
    def test_grant_order_bit_identical_across_journal_failover(
        self, seed, tmp_path
    ):
        """Kill the authority mid-trace, rebuild from the journal, and
        the completed trace's grant order is IDENTICAL to the
        uninterrupted in-process reference — admission continuity is a
        durability property, not a best-effort one."""
        specs = trace_specs()
        steps, kill_at = 24, 11
        ref_clock = FakeClock()
        ref_sched, ref_admitters = make_reference(specs, ref_clock)
        ref_grants = drive_trace(ref_admitters, ref_clock, steps, seed)

        clock = FakeClock()
        journal = str(tmp_path / "fabric.journal")
        fab1, client, handles, _ = make_fabric(
            journal=journal, clock=clock, jobs=specs
        )
        grants = drive_trace(
            {h.job_id: h for h in handles}, clock, kill_at, seed
        )
        del fab1  # the kill: only the journal survives
        fab2 = IngestFabric.from_journal(
            journal, metrics=Metrics(), clock=clock, snapshot_every=1
        )
        assert fab2.term == 1
        client.rebind(fab2)
        grants += drive_trace(
            {h.job_id: h for h in handles}, clock, steps, seed,
            start=kill_at,
        )
        assert grants == ref_grants
        assert fab2.admission_log == ref_grants
        assert (
            fab2.scheduler.export_state(now=clock())
            == ref_sched.export_state(now=ref_clock())
        )
        return grants, fab2.registry.export_state()


# ---------------------------------------------------------------------------
# Per-job isolation seams
# ---------------------------------------------------------------------------


class TestPerJobIsolation:
    def test_integrity_namespaces_are_disjoint_and_verified(self):
        reg = JobRegistry(metrics=Metrics())
        rec_a = reg.register(JobSpec("alpha"))
        rec_b = reg.register(JobSpec("beta"))
        assert rec_a.seq_base == integrity_namespace("alpha")
        assert rec_b.seq_base == integrity_namespace("beta")
        assert rec_a.seq_base != rec_b.seq_base
        assert rec_a.seq_base % NAMESPACE_SPAN == 0
        # A window stamped in alpha's namespace verifies there and
        # NOWHERE else — cross-job replay of a stale window is loud.
        payload = 256
        blob = np.zeros(payload + integrity.HEADER_BYTES, dtype=np.uint8)
        blob[:payload] = np.arange(payload, dtype=np.uint8)
        crc = integrity.window_crc(blob[:payload])
        integrity.write_header(
            blob, payload, seq=rec_a.seq_base + 5, producer_idx=0, crc=crc
        )
        assert integrity.verify_window(
            blob, payload,
            expect_seq=rec_a.seq_base + 5, expect_producer=0,
        ) is None
        assert integrity.verify_window(
            blob, payload,
            expect_seq=rec_b.seq_base + 5, expect_producer=0,
        ) is not None
        return blob, rec_a.seq_base, rec_b.seq_base

    def test_fabric_job_carries_its_namespace(self):
        _, _, (job,), _ = make_fabric(jobs=[JobSpec("alpha")])
        assert job.seq_base == integrity_namespace("alpha")

        def producer(i):  # the wire_dtype-handshake pattern
            return np.zeros(4)

        producer.seq_base = job.seq_base
        assert getattr(producer, "seq_base") == integrity_namespace("alpha")

    def test_per_job_checkpoint_cursors_are_fenced_apart(self, tmp_path):
        """Each job checkpoints into its own generation directory; the
        verified-restore walk per job sees only its own steps."""
        atomic_file_write = _imp("checkpoint", "atomic_file_write")
        ckpt = importlib.import_module(f"{ROOT}.resilience.ckpt")

        reg = JobRegistry(metrics=Metrics())
        rec_a = reg.register(JobSpec("alpha"))
        rec_b = reg.register(JobSpec("beta"))
        dir_a = rec_a.checkpoint_dir(str(tmp_path))
        dir_b = rec_b.checkpoint_dir(str(tmp_path))
        assert dir_a != dir_b and os.path.isdir(dir_a)
        leaves = [np.arange(8, dtype=np.float32)]
        for d, step in ((dir_a, 3), (dir_b, 7)):
            blob = ckpt.serialize_generation(step, leaves, None)
            atomic_file_write(
                os.path.join(d, ckpt._gen_name(step)), blob.tobytes()
            )
        assert ckpt.latest_verified_generation(dir_a)[0] == 3
        assert ckpt.latest_verified_generation(dir_b)[0] == 7
        # Step fencing holds inside a job's own dir: beta's generation
        # renamed into alpha's cursor is rejected, not restored.
        rogue = os.path.join(dir_a, ckpt._gen_name(9))
        blob_b = ckpt.serialize_generation(7, leaves, None)
        atomic_file_write(rogue, blob_b.tobytes())
        assert ckpt.verify_generation(rogue, 9) is not None
        return sorted(os.listdir(dir_a)), sorted(os.listdir(dir_b))

    def test_obs_namespaces_merge_without_collision(self):
        adopt_job = _imp("obs.aggregate", "adopt_job")

        fleet = Metrics()
        adopt_job(fleet, "alpha", {"ingest.samples": 100.0})
        adopt_job(fleet, "beta", {"ingest.samples": 7.0})
        assert fleet.counter("job.alpha.ingest.samples") == 100.0
        assert fleet.counter("job.beta.ingest.samples") == 7.0
        # REPLACE-based adoption: re-merging a cumulative snapshot is
        # idempotent, never double-counts.
        adopt_job(fleet, "alpha", {"ingest.samples": 100.0})
        assert fleet.counter("job.alpha.ingest.samples") == 100.0

    def test_shared_cache_per_job_accounting_tiles_the_store(self):
        CacheKey, CacheStore = _imp("cache", "CacheKey", "CacheStore")

        store = CacheStore(ram_budget_bytes=8 << 20, metrics=Metrics())
        m = Metrics()
        views = {
            j: JobCacheView(store, j, metrics=m) for j in ("alpha", "beta")
        }
        key = CacheKey(source="s", shard="shard-0", reader="test")
        assert views["alpha"].get(key) is None           # miss
        views["alpha"].put(key, np.zeros(16, np.uint8))
        assert views["beta"].get(key) is not None        # hit, beta's
        assert views["alpha"].counts() == {"hits": 0.0, "misses": 1.0}
        assert views["beta"].counts() == {"hits": 1.0, "misses": 0.0}
        # The per-job pairs tile the store's fleet-global counters.
        total_hits = sum(v.counts()["hits"] for v in views.values())
        total_misses = sum(v.counts()["misses"] for v in views.values())
        assert total_hits == store.metrics.counter("cache.hits")
        assert total_misses == store.metrics.counter("cache.misses")
        return {j: v.counts() for j, v in views.items()}

    def test_registry_state_roundtrip_and_spec_validation(self):
        reg = JobRegistry(metrics=Metrics())
        reg.register(JobSpec("alpha", weight=2.0,
                             byte_budget_per_s=1024.0))
        reg.register(JobSpec("beta"))
        other = JobRegistry(metrics=Metrics())
        other.adopt_state(reg.export_state())
        assert other.jobs() == ["alpha", "beta"]
        assert other.get("alpha").seq_base == integrity_namespace("alpha")
        assert other.get("alpha").spec.weight == 2.0
        with pytest.raises(DDLError):
            reg.register(JobSpec("alpha"))  # duplicate id
        with pytest.raises(DDLError):
            JobSpec("bad/job")
        with pytest.raises(DDLError):
            JobSpec("bad.job")
        return other.export_state()


# ---------------------------------------------------------------------------
# Across the packages: one journal format, one accounting
# ---------------------------------------------------------------------------


class TestCrossPackage:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_journal_rebuilt_by_the_other_package(self, seed, tmp_path):
        """A fabric journal this package writes (registrations, a seeded
        trace of admissions and charges, a crash) is rebuilt by the OTHER
        package's ``IngestFabric.from_journal`` into the same scheduler
        ledger, job registry, admission log and term — and its
        journal-seeded receivers answer a re-sent envelope from the
        journaled reply without charging again."""
        specs = trace_specs()
        clock = FakeClock()
        journal = str(tmp_path / "fabric.journal")
        fab, client, handles, _ = make_fabric(journal=journal, clock=clock,
                                              jobs=specs)
        drive_trace({h.job_id: h for h in handles}, clock, 10, seed)
        clock.t += 10.0  # the buckets refill
        handles[0].admit(0.0)  # a grant left in flight
        fab.job_crashed(specs[-1].job_id)
        state = fab.scheduler.export_state(now=clock())
        registry = fab.registry.export_state()
        other_fab = _imp("serve.fabric", "IngestFabric", root=OTHER)
        other_metrics = _imp("observability", "Metrics", root=OTHER)
        env_cls = _imp("types", "ControlEnvelope", root=OTHER)
        admit_cls = _imp("serve.fabric", "AdmitRequest", root=OTHER)
        rebuilt = other_fab.from_journal(journal, metrics=other_metrics(),
                                         clock=clock, snapshot_every=1)
        assert rebuilt.scheduler.export_state(now=clock()) == state
        assert rebuilt.registry.export_state() == registry
        assert rebuilt.admission_log == fab.admission_log
        assert rebuilt.term == 1
        # The client's first envelope after its registrations (the
        # trace's first admission, granted), re-sent after the rebuild.
        env = env_cls(seq=len(specs), incarnation=0, fence=rebuilt.term,
                      payload=admit_cls(specs[0].job_id, 0.0))
        before = rebuilt.scheduler.export_state(now=clock())
        reply, ack = rebuilt.handle("host00", env)
        assert ack.dup and reply.ok
        assert rebuilt.scheduler.export_state(now=clock()) == before
        return state, registry, fab.admission_log

    def test_cache_view_accounts_for_every_access_its_store_saw(self):
        """Seeded gets and loads through two jobs' views of ONE shared
        store: the views' hit and miss counts add up to the store's own,
        per key as the store saw them (a miss, then hits)."""
        CacheKey, CacheStore = _imp("cache", "CacheKey", "CacheStore")
        rng = np.random.default_rng(7)
        store = CacheStore(ram_budget_bytes=8 << 20, metrics=Metrics())
        m = Metrics()
        views = {j: JobCacheView(store, j, metrics=m)
                 for j in ("alpha", "beta")}
        keys = [CacheKey(source="s", shard=f"shard-{k}", reader="test")
                for k in range(6)]
        loads, trace = [], []
        for _ in range(60):
            job = ("alpha", "beta")[int(rng.integers(0, 2))]
            key = keys[int(rng.integers(0, len(keys)))]
            if rng.random() < 0.5:
                got = views[job].get(key)
                trace.append((job, key.shard, got is not None))
            else:
                arr = views[job].get_or_load(
                    key, lambda: (loads.append(key.shard),
                                  np.full(32, len(loads), np.uint8))[1])
                trace.append((job, key.shard, int(arr[0])))
            assert views[job].contains(key) == store.contains(key)
        hits = sum(v.counts()["hits"] for v in views.values())
        misses = sum(v.counts()["misses"] for v in views.values())
        assert hits == store.metrics.counter("cache.hits")
        assert misses == store.metrics.counter("cache.misses")
        assert hits + misses == len(trace)
        # Each key loads once: the first get_or_load that missed it.
        assert len(loads) == len(set(loads))
        return trace, {j: v.counts() for j, v in views.items()}
