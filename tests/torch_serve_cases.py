"""The cases of ``tests/test_serve.py`` written against a package root
(``ROOT``, set by ``tests/torch_twins.load``): ``tests/test_torch_serve.py``
runs each against the JAX package and the port and holds what they saw
equal.  Cases return their observables (grant orders, exported ledgers,
autoscaler decisions, served windows)."""

import importlib
import threading
import time

import numpy as np
import pytest

ROOT = globals().get("ROOT", "ddl_tpu_torch")
_pkg = importlib.import_module(ROOT)
DataProducerOnInitReturn = _pkg.DataProducerOnInitReturn
DistributedDataLoader = _pkg.DistributedDataLoader
Marker = _pkg.Marker
ProducerFunctionSkeleton = _pkg.ProducerFunctionSkeleton
distributed_dataloader = _pkg.distributed_dataloader
faults = importlib.import_module(f"{ROOT}.faults")
_cl = importlib.import_module(f"{ROOT}.cluster")
ClusterSupervisor = _cl.ClusterSupervisor
ClusterView = _cl.ClusterView
ElasticCluster = _cl.ElasticCluster
HostInfo = _cl.HostInfo
LinkCosts = _cl.LinkCosts
_exc = importlib.import_module(f"{ROOT}.exceptions")
DDLError = _exc.DDLError
ShutdownRequested = _exc.ShutdownRequested
StallTimeoutError = _exc.StallTimeoutError
TenantBurst = _exc.TenantBurst
FaultKind, FaultPlan, FaultSpec = faults.FaultKind, faults.FaultPlan, \
    faults.FaultSpec
Metrics = importlib.import_module(f"{ROOT}.observability").Metrics
_serve = importlib.import_module(f"{ROOT}.serve")
AdmissionController = _serve.AdmissionController
Autoscaler = _serve.Autoscaler
AutoscalerPolicy = _serve.AutoscalerPolicy
FairShareScheduler = _serve.FairShareScheduler
TenantSpec = _serve.TenantSpec

ROWS, VALS = 8, 4


def _ledger(sched):
    """A scheduler's exported tenants without the wall-clock stamps (for
    cases that run on the real clock)."""
    return {name: {k: v for k, v in t.items() if k != "stamp"}
            for name, t in sched.export_state()["tenants"].items()}


class PatternProducer(ProducerFunctionSkeleton):
    """Deterministic per-producer window content: window k from producer
    p is ``p * 1000 + k`` everywhere — byte-correctness is checkable on
    any served subsequence regardless of pool churn."""

    inplace_fill = True

    def __init__(self, fill_latency_s: float = 0.0):
        self.fill_latency_s = fill_latency_s

    def on_init(self, producer_idx=1, **kw):
        self.idx = producer_idx
        self.k = 0
        return DataProducerOnInitReturn(
            nData=ROWS, nValues=VALS, shape=(ROWS, VALS), splits=(VALS,)
        )

    def post_init(self, my_ary, **kw):
        my_ary[:] = 0.0

    def execute_function(self, my_ary, **kw):
        if self.fill_latency_s:
            time.sleep(self.fill_latency_s)
        my_ary[:] = float(self.idx * 1000 + self.k)
        self.k += 1


def assert_pattern_windows(wins):
    """Every served window is a constant plane p*1000+k — intact bytes."""
    for w in wins:
        v = w.ravel()[0]
        np.testing.assert_array_equal(w, np.full_like(w, v))
        assert v >= 1000.0  # producer_idx >= 1


# ---------------------------------------------------------------------------
# Units: specs + scheduler
# ---------------------------------------------------------------------------


class TestTenantSpec:
    def test_validation(self):
        with pytest.raises(DDLError):
            TenantSpec("")
        with pytest.raises(DDLError):
            TenantSpec("a.b")  # dots alias the metrics namespace
        with pytest.raises(DDLError):
            TenantSpec("a", weight=0.0)
        with pytest.raises(DDLError):
            TenantSpec("a", byte_budget_per_s=-1)
        with pytest.raises(DDLError):
            TenantSpec("a", slot_budget=-1)
        TenantSpec("ok", weight=2.5, byte_budget_per_s=1e6, slot_budget=3)


class TestScheduler:
    def test_register_unregister_and_gauge(self):
        m = Metrics()
        s = FairShareScheduler(metrics=m)
        s.register(TenantSpec("a"))
        s.register(TenantSpec("b"))
        assert m.gauge("serve.tenants") == 2
        with pytest.raises(DDLError):
            s.register(TenantSpec("a"))
        s.unregister("a")
        assert m.gauge("serve.tenants") == 1
        assert s.tenants() == ["b"]

    def test_unknown_tenant_admit_raises(self):
        s = FairShareScheduler()
        with pytest.raises(DDLError):
            s.admit("ghost", 1.0)

    def test_single_tenant_never_waits_long(self):
        """A sole tenant's multi-quantum windows replenish through
        instant logical rounds, not 50 ms-per-quantum sleeps."""
        m = Metrics()
        s = FairShareScheduler(quantum_bytes=1 << 20, metrics=m)
        s.register(TenantSpec("solo"))
        t0 = time.perf_counter()
        for _ in range(5):
            s.admit("solo", 5.0)
            s.note_served("solo", 8 << 20)  # 8 quanta per window
        assert time.perf_counter() - t0 < 1.0
        assert m.counter("serve.rounds") >= 5
        assert m.counter("ingest.solo.windows") == 5
        assert m.counter("ingest.solo.bytes") == 5 * (8 << 20)
        return _ledger(s), m.counter("serve.rounds")

    def test_nonblocking_probe_raises_when_throttled(self):
        """timeout_s <= 0 is the lookahead-deepening probe: a budget-
        blocked tenant gets an immediate StallTimeoutError, never a
        wait (the deepening loop treats it as not-committed-yet)."""
        clock = [0.0]
        s = FairShareScheduler(clock=lambda: clock[0])
        s.register(TenantSpec("t", byte_budget_per_s=1000.0))
        s.admit("t", 0.0)  # fresh bucket: grantable
        s.note_served("t", 5000)  # 5 seconds of budget consumed
        with pytest.raises(StallTimeoutError):
            s.admit("t", 0.0)
        clock[0] += 10.0  # bucket refills with the (injected) clock
        s.admit("t", 0.0)
        return s.export_state()

    def test_byte_budget_is_wall_clock_not_rounds(self):
        """Replenish rounds must never bypass the rate budget: a
        budget-blocked sole waiter times out instead of round-spinning
        itself grantable."""
        clock = [0.0]
        s = FairShareScheduler(clock=lambda: clock[0])
        s.register(TenantSpec("t", byte_budget_per_s=100.0))
        s.admit("t", 0.0)
        s.note_served("t", 1000)  # 10 s of budget in one window

        waited = {}

        def try_admit():
            try:
                s.admit("t", 0.2)
                waited["granted"] = True
            except StallTimeoutError:
                waited["granted"] = False

        th = threading.Thread(target=try_admit)
        th.start()
        # Let the waiter park, then advance the injected clock past its
        # deadline WITHOUT refilling enough budget (0.2 s * 100 B/s).
        time.sleep(0.1)
        clock[0] += 0.3
        th.join(5.0)
        assert waited == {"granted": False}

    def test_slot_budget_caps_grants_per_round(self):
        """slot_budget=1 holds a tenant to one window per round while a
        competitor is PARKED in admit — the concurrency brake on top of
        the byte share.  Deterministic: the competitor's waiting state
        is pinned directly (a thread-timing version of this test is
        exactly the race the pin removes), and released to prove the
        cap is per-round, not permanent."""
        s = FairShareScheduler(quantum_bytes=1 << 30)  # bytes never bind
        s.register(TenantSpec("capped", slot_budget=1))
        s.register(TenantSpec("free"))
        s.admit("capped", 0.0)
        s.note_served("capped", 100)  # the round's one slot is spent
        st_free = s._state("free")
        st_free.waiting = 1  # a backlogged, grantable competitor
        with pytest.raises(StallTimeoutError):
            # The cap holds: a round may not advance past a grantable
            # waiter, and without a round the slot counter never resets.
            s.admit("capped", 0.0)
        st_free.waiting = 0
        # Competitor gone: the round advances and the cap resets.
        s.admit("capped", 0.0)
        s.note_served("capped", 100)
        return _ledger(s)

    def test_weight_proportional_service(self):
        """Two backlogged tenants with 2:1 weights settle at ~2:1 served
        bytes — the DRR quantum scaling."""
        s = FairShareScheduler(quantum_bytes=1 << 16)
        s.register(TenantSpec("heavy", weight=2.0))
        s.register(TenantSpec("light", weight=1.0))
        served = {"heavy": 0, "light": 0}
        window = 1 << 16  # one quantum per window

        def run(name, n):
            for _ in range(n):
                s.admit(name, 10.0)
                served[name] += window
                s.note_served(name, window)

        th = threading.Thread(target=run, args=("heavy", 40))
        tl = threading.Thread(target=run, args=("light", 40))
        th.start(), tl.start()
        th.join(30.0), tl.join(30.0)
        assert served == {"heavy": 40 * window, "light": 40 * window}
        return served

    def test_admission_wait_metrics_accumulate(self):
        m = Metrics()
        s = FairShareScheduler(metrics=m)
        s.register(TenantSpec("t"))
        s.admit("t", 1.0)
        s.note_served("t", 10)
        assert m.counter("serve.admissions") == 1
        assert m.timer("serve.admission_wait").count == 1
        assert m.timer("ingest.t.admission_wait").count == 1

    def test_note_served_after_unregister_is_harmless(self):
        s = FairShareScheduler()
        s.register(TenantSpec("t"))
        s.admit("t", 1.0)
        s.unregister("t")
        s.note_served("t", 100)  # mid-flight teardown: no raise


class TestAdmissionController:
    def test_register_report_close(self):
        m = Metrics()
        ctl = AdmissionController(metrics=m)
        a = ctl.register(TenantSpec("a"))
        b = ctl.register(TenantSpec("b", weight=2.0))
        a.admit(1.0), a.note_served(1 << 20)
        b.admit(1.0), b.note_served(2 << 20)
        rep = ctl.report()
        assert set(rep["tenants"]) == {"a", "b"}
        assert rep["tenants"]["a"]["bytes"] == float(1 << 20)
        assert rep["tenants"]["b"]["windows"] == 1.0
        assert rep["admissions"] == 2.0
        # report() refreshed the per-tenant stall gauges north_star reads
        assert m.gauge("serve.stall.a") >= 0.0
        assert a.metrics()["bytes"] == float(1 << 20)
        ctl.close()
        assert ctl.scheduler.tenants() == []
        return {k: v for k, v in rep.items() if k != "admission_wait_s"
                and k != "tenants"}

    def test_shared_cache_handle(self):
        store = object()
        ctl = AdmissionController(cache=store)
        assert ctl.cache is store


# ---------------------------------------------------------------------------
# Units: autoscaler policy machine
# ---------------------------------------------------------------------------


def loader_view(host_ids, n_shards=8):
    return ClusterView.bootstrap(
        [HostInfo(h, loader_ranks=(h + 1,)) for h in host_ids],
        n_shards=n_shards,
    )


class FakeCluster:
    """Duck-typed resize target: supervisor.view + rejoin/drain, no
    rings — the policy machine under test, not the ladder."""

    def __init__(self, host_ids):
        self.supervisor = ClusterSupervisor(loader_view(host_ids),
                                            metrics=Metrics())
        self.rejoins = []
        self.drains = []

    def rejoin_host(self, host):
        self.rejoins.append(host.host_id)
        return self.supervisor.rejoin(host)

    def drain_host(self, host_id):
        self.drains.append(host_id)
        host = self.supervisor.view.host(host_id)
        self.supervisor.declare_host_loss(host_id)
        return host


def make_scaler(cluster, sig, clock, m=None, standby=(), **pol):
    policy = AutoscalerPolicy(**{
        "up_stall_fraction": 0.3, "down_stall_fraction": 0.1,
        "sustain_s": 1.0, "cooldown_s": 2.0, "min_hosts": 1, **pol,
    })
    return Autoscaler(
        cluster, standby=standby, policy=policy, metrics=m or Metrics(),
        clock=lambda: clock[0], signal=lambda: dict(sig),
    )


class TestAutoscalerPolicy:
    def test_policy_validation(self):
        with pytest.raises(DDLError):
            AutoscalerPolicy(up_stall_fraction=0.1, down_stall_fraction=0.2)
        with pytest.raises(DDLError):
            AutoscalerPolicy(min_hosts=0)
        with pytest.raises(DDLError):
            AutoscalerPolicy(sustain_s=-1)

    def test_sustained_demand_scales_up_and_records_reaction(self):
        clock = [0.0]
        sig = {"stall_fraction": 0.9, "queue_depth": 0.0}
        m = Metrics()
        fc = FakeCluster([0])
        sc = make_scaler(fc, sig, clock, m,
                         standby=[HostInfo(1, loader_ranks=(2,))])
        assert sc.step() is None  # first sighting only starts the timer
        clock[0] = 0.5
        assert sc.step() is None  # not sustained yet
        clock[0] = 1.1
        assert sc.step() == "up"
        assert fc.rejoins == [1]
        assert m.counter("serve.scale_ups") == 1
        assert m.timer("serve.scale_up_reaction").count == 1
        assert m.gauge("serve.pool_hosts") == 2
        assert sc.standby == []
        return fc.rejoins, fc.drains

    def test_one_noisy_sample_never_scales(self):
        clock = [0.0]
        sig = {"stall_fraction": 0.9}
        fc = FakeCluster([0])
        sc = make_scaler(fc, sig, clock,
                         standby=[HostInfo(1, loader_ranks=(2,))])
        sc.step()
        sig["stall_fraction"] = 0.0  # noise gone before sustain_s
        clock[0] = 0.5
        sc.step()
        sig["stall_fraction"] = 0.9  # the sustain timer must restart
        clock[0] = 1.2
        assert sc.step() is None
        assert fc.rejoins == []
        return fc.rejoins, fc.drains

    def test_dead_band_holds_state(self):
        clock = [0.0]
        sig = {"stall_fraction": 0.2}  # between 0.1 and 0.3
        fc = FakeCluster([0, 1])
        sc = make_scaler(fc, sig, clock,
                         standby=[HostInfo(2, loader_ranks=(3,))])
        for t in (0.0, 1.0, 2.0, 5.0):
            clock[0] = t
            assert sc.step() is None
        assert fc.rejoins == [] and fc.drains == []
        return fc.rejoins, fc.drains

    def test_cooldown_spaces_actions(self):
        clock = [0.0]
        sig = {"stall_fraction": 0.9}
        fc = FakeCluster([0])
        sc = make_scaler(
            fc, sig, clock,
            standby=[HostInfo(1, loader_ranks=(2,)),
                     HostInfo(2, loader_ranks=(3,))],
        )
        sc.step()
        clock[0] = 1.1
        assert sc.step() == "up"
        clock[0] = 2.5  # sustained again, but inside cooldown (2.0 after t=1.1)
        sc.step()
        clock[0] = 3.0
        assert sc.step() is None
        clock[0] = 4.5  # cooldown passed AND demand sustained since 2.5
        assert sc.step() == "up"
        assert fc.rejoins == [1, 2]
        return fc.rejoins, fc.drains

    def test_sustained_idle_drains_newest_loader_host(self):
        clock = [0.0]
        sig = {"stall_fraction": 0.0}
        m = Metrics()
        fc = FakeCluster([0, 1, 2])
        sc = make_scaler(fc, sig, clock, m, cooldown_s=0.0)
        sc.step()
        clock[0] = 1.1
        assert sc.step() == "down"
        assert fc.drains == [2]
        assert m.counter("serve.scale_downs") == 1
        assert [h.host_id for h in sc.standby] == [2]
        return fc.rejoins, fc.drains

    def test_never_empty_floor(self):
        clock = [0.0]
        sig = {"stall_fraction": 0.0}
        fc = FakeCluster([0, 1])
        sc = make_scaler(fc, sig, clock, cooldown_s=0.0, min_hosts=2)
        sc.step()
        clock[0] = 1.5
        assert sc.step() is None
        assert fc.drains == []

    def test_trainer_hosts_are_never_drained(self):
        clock = [0.0]
        sig = {"stall_fraction": 0.0}
        fc = FakeCluster([0])
        # Host 5 both loads and trains; host 0 is the loader-only one
        # left after it — but draining 5 would take trainers down.
        fc.supervisor.rejoin(
            HostInfo(5, loader_ranks=(6,), trainer_ranks=(0,))
        )
        sc = make_scaler(fc, sig, clock, cooldown_s=0.0)
        sc.step()
        clock[0] = 1.5
        assert sc.step() == "down"
        assert fc.drains == [0]
        return fc.rejoins, fc.drains

    def test_demand_without_standby_is_a_noop(self):
        clock = [0.0]
        sig = {"stall_fraction": 0.9}
        fc = FakeCluster([0])
        sc = make_scaler(fc, sig, clock, standby=[])
        sc.step()
        clock[0] = 1.5
        assert sc.step() is None

    def test_max_hosts_ceiling(self):
        clock = [0.0]
        sig = {"stall_fraction": 0.9}
        fc = FakeCluster([0, 1])
        sc = make_scaler(fc, sig, clock, max_hosts=2,
                         standby=[HostInfo(2, loader_ranks=(3,))])
        sc.step()
        clock[0] = 1.5
        assert sc.step() is None
        assert fc.rejoins == []

    def test_queue_depth_is_a_second_up_signal(self):
        clock = [0.0]
        sig = {"stall_fraction": 0.0, "queue_depth": 7.0}
        fc = FakeCluster([0])
        sc = make_scaler(fc, sig, clock, up_queue_depth=4.0,
                         standby=[HostInfo(1, loader_ranks=(2,))])
        sc.step()
        clock[0] = 1.1
        assert sc.step() == "up"

    def test_resize_reruns_placement(self):
        clock = [0.0]
        sig = {"stall_fraction": 0.9}
        fc = FakeCluster([0])
        costs = LinkCosts.islands([[0, 1]], 8e9, 1e9)
        sc = Autoscaler(
            fc, standby=[HostInfo(1, loader_ranks=(2,))],
            policy=AutoscalerPolicy(sustain_s=0.0, cooldown_s=0.0),
            metrics=Metrics(), clock=lambda: clock[0],
            signal=lambda: dict(sig), link_costs=costs,
        )
        assert sc.last_placement is None
        clock[0] = 0.1
        assert sc.step() == "up"
        assert sc.last_placement is not None
        return list(sc.last_placement.assignment)

    def test_failed_rejoin_keeps_the_reserve_entry(self):
        clock = [0.0]
        sig = {"stall_fraction": 0.9}

        class ExplodingCluster(FakeCluster):
            def rejoin_host(self, host):
                raise RuntimeError("channel died mid-rejoin")

        fc = ExplodingCluster([0])
        sc = make_scaler(fc, sig, clock, sustain_s=0.0, cooldown_s=0.0)
        sc._standby = [HostInfo(1, loader_ranks=(2,))]
        assert sc.step() is None
        assert [h.host_id for h in sc.standby] == [1]

    def test_windowed_signal_sees_a_fresh_burst(self):
        """The default signal is windowed: a long quiet history must not
        dilute a new burst below the band (the cumulative stall_fraction
        would)."""
        m = Metrics()
        fc = FakeCluster([0])
        clock = [1000.0]  # long elapsed history on the registry
        sc = Autoscaler(fc, metrics=m, clock=lambda: clock[0])
        clock[0] = 1001.0
        m.add_time("consumer.wait", 0.9)  # 0.9 s of stall in a 1 s window
        sig = sc._windowed_signal()
        assert sig["stall_fraction"] > 0.8
        return sig

    def test_windowed_signal_excludes_admission_waits(self):
        """A tenant parked by its own byte budget is throttled, not
        starved: its admission wait must not read as ingest demand
        (one over-budget tenant could otherwise inflate the fleet)."""
        m = Metrics()
        fc = FakeCluster([0])
        clock = [0.0]
        sc = Autoscaler(fc, metrics=m, clock=lambda: clock[0])
        clock[0] = 1.0
        # The whole window's "stall" was spent at the admission gate
        # (the gate's wait is timed into consumer.wait by the loader).
        m.add_time("consumer.wait", 0.9)
        m.add_time("serve.admission_wait", 0.9)
        sig = sc._windowed_signal()
        assert sig["stall_fraction"] < 0.05
        return sig


class TestDrainHost:
    def test_drain_floor_refuses_last_loader_host(self):
        m = Metrics()
        sup = ClusterSupervisor(loader_view([0]), metrics=m)
        ec = ElasticCluster(sup, metrics=m)
        with pytest.raises(DDLError):
            ec.drain_host(0)

    def test_drain_unknown_host_raises(self):
        sup = ClusterSupervisor(loader_view([0, 1]), metrics=Metrics())
        ec = ElasticCluster(sup, metrics=Metrics())
        with pytest.raises(KeyError):
            ec.drain_host(7)

    def test_drain_shrinks_view_and_returns_standby_info(self):
        m = Metrics()
        sup = ClusterSupervisor(loader_view([0, 1]), metrics=m)
        ec = ElasticCluster(sup, metrics=m)
        info = ec.drain_host(1)
        assert info.host_id == 1 and info.loader_ranks == (2,)
        assert [h.host_id for h in sup.view.hosts] == [0]
        assert m.counter("cluster.host_drains") == 1
        # A PLANNED departure must never inflate the failure counter
        # alerting keys on.
        assert m.counter("cluster.host_losses") == 0
        # The drained host's shards moved to the survivor.
        assert sup.view.ranges_of(0) and not sup.view.ranges_of(1)
        # And the round trip: rejoin re-admits it at a fresh fence.
        epoch = sup.view.epoch
        ec.rejoin_host(info)
        assert sup.view.epoch == epoch + 1
        assert [h.host_id for h in sup.view.hosts] == [0, 1]
        return sup.view.epoch, sup.view.shard_ranges


# ---------------------------------------------------------------------------
# Chaos: the two new fault kinds (tier-1 matrix rows)
# ---------------------------------------------------------------------------


class TestServeFaults:
    def test_tenant_burst_charges_the_burster_not_the_neighbour(self):
        """TENANT_BURST at serve.admit: the bursting tenant absorbs its
        own phantom bytes (waits out replenish rounds) while the
        neighbour's admissions proceed untouched — the isolation
        property the tenancy chaos leg rides."""
        m = Metrics()
        s = FairShareScheduler(quantum_bytes=1 << 20, metrics=m)
        s.register(TenantSpec("burster"))     # index 0
        s.register(TenantSpec("neighbour"))   # index 1
        plan = FaultPlan([
            FaultSpec("serve.admit", FaultKind.TENANT_BURST,
                      at=1, producer_idx=0, param=float(4 << 20)),
        ])
        with faults.armed(plan):
            s.admit("burster", 5.0)   # absorbs the 4 MiB phantom spike
            s.admit("neighbour", 1.0)
        assert plan.fired and plan.fired[0][1] == "tenant_burst"
        assert m.counter("serve.tenant_bursts") == 1
        assert m.counter("ingest.burster.bursts") == 1
        assert m.counter("ingest.neighbour.bursts") == 0
        # The burster recovered via replenish rounds, not a timeout.
        assert m.counter("serve.rounds") >= 1
        return plan.fired, _ledger(s)

    def test_tenant_burst_respects_producer_idx_selection(self):
        s = FairShareScheduler(metrics=Metrics())
        s.register(TenantSpec("a"))  # index 0
        s.register(TenantSpec("b"))  # index 1
        plan = FaultPlan([
            FaultSpec("serve.admit", FaultKind.TENANT_BURST,
                      producer_idx=1, param=1024.0),
        ])
        with faults.armed(plan):
            s.admit("a", 1.0)
        assert plan.fired == []  # tenant 0's admit never matches idx 1

    def test_scale_decision_delay_slows_but_never_corrupts(self):
        """SCALE_DECISION_DELAY at serve.scale: the decision lands late
        (param seconds) but is the SAME decision."""
        clock = [0.0]
        sig = {"stall_fraction": 0.9}
        fc = FakeCluster([0])
        sc = make_scaler(fc, sig, clock, sustain_s=0.0, cooldown_s=0.0,
                         standby=[HostInfo(1, loader_ranks=(2,))])
        plan = FaultPlan([
            FaultSpec("serve.scale", FaultKind.SCALE_DECISION_DELAY,
                      at=1, param=0.15),
        ])
        clock[0] = 0.1
        t0 = time.perf_counter()
        with faults.armed(plan):
            out = sc.step()
        assert time.perf_counter() - t0 >= 0.15
        assert out == "up" and fc.rejoins == [1]
        assert plan.fired[0][1] == "scale_decision_delay"
        return plan.fired, fc.rejoins

    def test_burst_exception_carries_bytes(self):
        e = TenantBurst("boom", burst_bytes=123.0)
        assert e.burst_bytes == 123.0


# ---------------------------------------------------------------------------
# Fairness: concurrent consumers over the shared scheduler (rotation
# fairness with MORE than one consumer).
# ---------------------------------------------------------------------------


class TestConcurrentConsumerFairness:
    def test_two_tenants_skewed_demand_neither_starves(self):
        """Two REAL loaders — separate envs, one shared FairShareScheduler
        — with heavily skewed demand: the hog wants 4x the windows and
        polls as fast as it can, under a byte budget; the meek tenant is
        unbudgeted.  Neither starves past its budget: the meek stream
        completes promptly (well before the throttled hog, with zero
        admission timeouts) and the hog's end-to-end rate provably
        respects its byte budget THROUGH the loader binding — the
        enforcement is at the ring-acquire seam, not advisory.  (The
        strict per-round interleave bound is the deterministic
        slot-budget unit above; wall-clock thread timing can't pin it.)
        """
        m = Metrics()
        ctl = AdmissionController(
            scheduler=FairShareScheduler(
                quantum_bytes=ROWS * VALS * 4, metrics=m
            ),
            metrics=m,
        )
        window_bytes = ROWS * VALS * 4  # float32 windows: 128 B
        budget = 8.0 * window_bytes  # hog capped at ~8 windows/s
        hog = ctl.register(TenantSpec("hog", byte_budget_per_s=budget))
        meek = ctl.register(TenantSpec("meek"))
        n_meek = 6
        n_hog = 4 * n_meek
        done_t = {}
        errors = []

        def run_tenant(tenant, n_epochs):
            @distributed_dataloader(n_producers=2, mode="thread")
            def main(env):
                loader = DistributedDataLoader(
                    PatternProducer(), batch_size=ROWS,
                    connection=env.connection, n_epochs=n_epochs,
                    output="numpy", timeout_s=30.0, metrics=m,
                )
                tenant.bind(loader)
                wins = []
                for _ in range(n_epochs):
                    for (win,) in loader:
                        wins.append(win.copy())
                        loader.mark(Marker.END_OF_BATCH)
                    loader.mark(Marker.END_OF_EPOCH)
                return wins

            try:
                t0 = time.monotonic()
                assert_pattern_windows(main())
                done_t[tenant.name] = time.monotonic() - t0
            except (ShutdownRequested, KeyboardInterrupt):
                raise
            except Exception as e:  # noqa: BLE001 - surfaced below
                errors.append((tenant.name, e))

        th = threading.Thread(target=run_tenant, args=(hog, n_hog))
        tm = threading.Thread(target=run_tenant, args=(meek, n_meek))
        th.start(), tm.start()
        tm.join(60.0), th.join(60.0)
        assert errors == [], errors
        assert m.counter("ingest.hog.windows") == n_hog
        assert m.counter("ingest.meek.windows") == n_meek
        assert m.counter("ingest.hog.bytes") == n_hog * window_bytes
        # The hog's byte budget bit: 24 windows at 8 windows/s of budget
        # (1 s of initial burst allowance) cannot finish in under ~2 s.
        floor_s = (n_hog * window_bytes - budget) / budget * 0.5
        assert done_t["hog"] >= floor_s, done_t
        # The meek tenant was never starved behind the hog's demand: it
        # finished long before the budget-throttled hog.
        assert done_t["meek"] < done_t["hog"], done_t
        # And its admission waits stayed trivial (no DRR round ever
        # parked it behind the hog's backlog for long).
        assert m.timer("ingest.meek.admission_wait").total_s < 1.0
        return {k: m.counter(k) for k in (
            "ingest.hog.windows", "ingest.meek.windows", "ingest.hog.bytes",
            "ingest.meek.bytes", "serve.admissions")}

    def test_fast_forward_is_not_admitted_or_charged(self):
        """Checkpoint-resume replay discards windows the tenant never
        receives: it must neither pass the admission gate nor charge
        the tenant's budget/counters — a byte-budgeted tenant would
        otherwise spend ~history/budget wall time replaying."""
        m = Metrics()
        ctl = AdmissionController(metrics=m)
        window_bytes = ROWS * VALS * 4
        # Budget = 1 window/s: charging 4 replayed windows would park
        # the first REAL admit for seconds; the run must stay instant.
        tenant = ctl.register(
            TenantSpec("resume", byte_budget_per_s=float(window_bytes))
        )

        @distributed_dataloader(n_producers=2, mode="thread")
        def main(env):
            loader = DistributedDataLoader(
                PatternProducer(), batch_size=ROWS,
                connection=env.connection, n_epochs=8,
                output="numpy", timeout_s=30.0, metrics=m,
            )
            tenant.bind(loader)
            t0 = time.monotonic()
            loader.fast_forward(4)
            (win,) = loader[0]  # the first SERVED window is admitted
            loader.mark(Marker.END_OF_BATCH)
            dt = time.monotonic() - t0
            loader.shutdown()
            return dt

        dt = main()
        assert dt < 2.0, f"resume replay was rate-limited ({dt:.2f}s)"
        assert m.counter("consumer.windows_skipped") == 4
        # Only the served window reached the tenant's ledger.
        assert m.counter("ingest.resume.windows") == 1
        assert m.counter("ingest.resume.bytes") == window_bytes
        return m.counter("consumer.windows_skipped")

    def test_admission_spends_from_the_acquire_timeout_budget(self):
        """One acquisition, ONE timeout_s: an admission wait consumes
        from the same budget the ring acquire gets, so a throttled
        tenant cannot silently double the documented stall ceiling."""
        m = Metrics()

        class SlowGate:
            def admit(self, timeout_s):
                time.sleep(0.4)  # eats most of the 0.6 s budget

            def note_served(self, nbytes):
                pass

        @distributed_dataloader(n_producers=1, mode="thread")
        def main(env):
            # fill_latency 2 s: the producer cannot commit within the
            # budget, so the acquire must exhaust the REMAINDER only.
            loader = DistributedDataLoader(
                PatternProducer(2.0), batch_size=ROWS,
                connection=env.connection, n_epochs=1,
                output="numpy", timeout_s=0.6, metrics=m,
            )
            loader.bind_admission(SlowGate())
            t0 = time.monotonic()
            with pytest.raises(StallTimeoutError):
                loader[0]
            dt = time.monotonic() - t0
            loader.shutdown()
            return dt

        dt = main()
        assert 0.4 <= dt < 1.1, (
            f"acquisition took {dt:.2f}s — the admission wait did not "
            "spend from the ring acquire's timeout budget"
        )

    def test_admission_preserves_byte_identity(self):
        """The gate schedules acquisitions; it must never change data —
        admission-on and admission-off streams are byte-identical."""

        def run(with_admission):
            m = Metrics()
            ctl = AdmissionController(metrics=m) if with_admission else None

            @distributed_dataloader(n_producers=2, mode="thread")
            def main(env):
                loader = DistributedDataLoader(
                    PatternProducer(), batch_size=ROWS,
                    connection=env.connection, n_epochs=6,
                    output="numpy", timeout_s=30.0, metrics=m,
                )
                if ctl is not None:
                    ctl.register(TenantSpec("only")).bind(loader)
                out = []
                for _ in range(6):
                    for (win,) in loader:
                        out.append(win.copy())
                        loader.mark(Marker.END_OF_BATCH)
                    loader.mark(Marker.END_OF_EPOCH)
                return out

            return main()

        gated, free = run(True), run(False)
        assert len(gated) == len(free)
        for a, b in zip(gated, free):
            np.testing.assert_array_equal(a, b)
        return gated


# ---------------------------------------------------------------------------
# E2E: autoscaler grows a live pipeline's pool mid-stream
# ---------------------------------------------------------------------------


class TestAutoscalerE2E:
    def test_scale_up_joins_standby_host_mid_stream_byte_identical(self):
        """4-producer THREAD env; view starts with hosts {0,1} and hosts
        {2,3} standing by (their producers run from t0, filling rings
        nobody drains).  A forced demand signal scales the pool up
        mid-stream; the loader rotates onto the new rings at the next
        boundary and every window — old pool or new — arrives intact."""
        m = Metrics()
        n_epochs = 12

        @distributed_dataloader(n_producers=4, mode="thread")
        def main(env):
            view = ClusterView.bootstrap(
                [HostInfo(0, loader_ranks=(1,)),
                 HostInfo(1, loader_ranks=(2,))],
                n_shards=8,
            )
            sup = ClusterSupervisor(view, lease_s=60.0, metrics=m)
            elastic = ElasticCluster(sup, metrics=m)
            loader = DistributedDataLoader(
                PatternProducer(), batch_size=ROWS,
                connection=env.connection, n_epochs=n_epochs,
                output="numpy", timeout_s=30.0, metrics=m,
                cluster=elastic,
            )
            sig = {"stall_fraction": 0.0}
            sc = Autoscaler(
                elastic,
                standby=[HostInfo(2, loader_ranks=(3,)),
                         HostInfo(3, loader_ranks=(4,))],
                policy=AutoscalerPolicy(sustain_s=0.0, cooldown_s=0.0),
                metrics=m, signal=lambda: dict(sig),
            )
            wins, targets = [], set()
            for ep in range(n_epochs):
                for (win,) in loader:
                    wins.append(win.copy())
                    targets.add(int(win.ravel()[0] // 1000))
                    loader.mark(Marker.END_OF_BATCH)
                loader.mark(Marker.END_OF_EPOCH)
                if ep == 3:
                    sig["stall_fraction"] = 0.9  # the burst arrives
                    assert sc.step() == "up"
                    sig["stall_fraction"] = 0.0
            return wins, targets

        wins, targets = main()
        assert len(wins) == n_epochs
        assert_pattern_windows(wins)
        # The standby host's ring really entered rotation mid-stream.
        assert 3 in targets, targets
        assert m.counter("serve.scale_ups") == 1
        assert m.counter("consumer.pool_updates") >= 2
        assert m.gauge("serve.pool_hosts") == 3
        return sorted(targets), m.counter("serve.scale_ups")


# ---------------------------------------------------------------------------
# Seeded traces: the same inputs through both packages
# ---------------------------------------------------------------------------


class TestSeededTraces:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_seeded_demand_trace_grant_order_and_ledger(self, seed):
        """A numpy-seeded demand trace over four tenants with weights,
        byte budgets, slot caps and one TENANT_BURST, probed
        non-blocking on a fake clock: the grant order and the exported
        ledger after every step are what the case returns."""
        rng = np.random.default_rng(seed)
        clock = [100.0]
        m = Metrics()
        s = FairShareScheduler(quantum_bytes=1 << 16, metrics=m,
                               clock=lambda: clock[0])
        names = ["t0", "t1", "t2", "t3"]
        for k, name in enumerate(names):
            s.register(TenantSpec(
                name, weight=float(k + 1),
                byte_budget_per_s=float((1 << 16) * (k + 1)) if k % 2 else 0.0,
                slot_budget=2 if k == 3 else 0))
        plan = FaultPlan([FaultSpec("serve.admit", FaultKind.TENANT_BURST,
                                    at=3, producer_idx=1,
                                    param=float(1 << 17))])
        grants, ledgers = [], []
        with faults.armed(plan):
            for step in range(30):
                clock[0] += float(rng.uniform(0.05, 0.5))
                for i in rng.permutation(len(names)):
                    name = names[int(i)]
                    try:
                        s.admit(name, 0.0)
                    except StallTimeoutError:
                        continue
                    s.note_served(name, int(rng.integers(1, 4)) << 15)
                    grants.append(name)
                ledgers.append(s.export_state())
        assert plan.fired and 0 < len(grants) < 30 * len(names)
        return grants, ledgers, m.counter("serve.rounds")

    @pytest.mark.parametrize("seed", [0, 1])
    def test_seeded_signal_trace_autoscaler_decisions(self, seed):
        """A numpy-seeded stall/queue trace through the policy machine
        over a fake cluster with two standby hosts: every step's
        decision, and the cluster's joins and drains."""
        rng = np.random.default_rng(seed)
        clock = [0.0]
        sig = {"stall_fraction": 0.0, "queue_depth": 0.0}
        fc = FakeCluster([0, 1])
        sc = make_scaler(fc, sig, clock, up_queue_depth=6.0,
                         sustain_s=0.5, cooldown_s=1.0, max_hosts=4,
                         standby=[HostInfo(2, loader_ranks=(3,)),
                                  HostInfo(3, loader_ranks=(4,))])
        decisions = []
        for step in range(80):
            clock[0] += 0.25
            phase = (step // 20) % 2
            sig["stall_fraction"] = float(
                rng.uniform(0.3, 1.0) if phase == 0 else rng.uniform(0, 0.12))
            sig["queue_depth"] = float(rng.integers(0, 10))
            decisions.append(sc.step())
        assert "up" in decisions and "down" in decisions
        return decisions, fc.rejoins, fc.drains, [
            h.host_id for h in sc.standby]
