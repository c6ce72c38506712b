"""The port's cluster control plane (``ddl_tpu_torch.cluster``) against
the JAX package's (``ddl_tpu.cluster``), the twins of
``tests/test_cluster.py``.

- **units** — shard partitioning, view changes and rejoins over seeded
  random views and dead sets (equal ranges, epochs, loader pools and
  trainer ranks in both packages), leases and the supervisor under a
  fake clock (the HOST_LOSS / HEARTBEAT_DROP fault semantics),
  placement (equal assignments, rates and reports on the same
  ``LinkCosts``), the loader pool, host identity.
- **seam** — ``DistributedDataLoader.apply_pool`` (applied at the window
  boundary, generation-fenced), and a consumer blocked on a dropped ring
  moving to a survivor at the view change, not at its ``timeout_s``.
- **e2e** — the ladder on a live pipeline of two mock hosts: a host kill
  in THREAD and PROCESS mode, its per-shard window streams byte-equal to
  the JAX package's under the same kill, with equal counters; the two
  rungs composing; the watchdog leaving lost ranks alone; the cache warm
  start; the ``windows()`` stream surviving a host kill; an adoption
  suspending and resuming a live ``ThreadExchangeShuffler``.

Every e2e case runs with the port's lock-order sanitizer armed and
asserts it saw no inversion.
"""

import os
import threading
import time
import types

import numpy as np
import pytest

import ddl_tpu_torch
from ddl_tpu import cluster as jcl
from ddl_tpu_torch import cluster as tcl
from ddl_tpu_torch import concurrency as tcon
from torch_cluster_producers import (
    N_SHARDS,
    ROWS,
    VALS,
    ShardRangeProducer,
    shard_pattern,
)


def _pkg(name):
    """The modules one package's body needs, by role."""
    import importlib

    root = "ddl_tpu" if name == "jax" else "ddl_tpu_torch"
    mod = importlib.import_module
    return types.SimpleNamespace(
        name=name, root=root, mod=mod(root), cl=mod(f"{root}.cluster"),
        faults=mod(f"{root}.faults"), exc=mod(f"{root}.exceptions"),
        Metrics=mod(f"{root}.observability").Metrics,
        Watchdog=mod(f"{root}.watchdog").Watchdog,
        checkpoint=mod(f"{root}.checkpoint"), cache=mod(f"{root}.cache"),
        env=mod(f"{root}.env"), types=mod(f"{root}.types"),
    )


PKG = {"jax": _pkg("jax"), "torch": _pkg("torch")}


def _view(cl, spill_dir=None):
    """The two mock hosts of the reference suite: host 0 carries loader
    rank 1 and the trainer, host 1 loader rank 2."""
    return cl.ClusterView.bootstrap(
        [cl.HostInfo(0, loader_ranks=(1,), trainer_ranks=(0,)),
         cl.HostInfo(1, loader_ranks=(2,), cache_spill_dir=spill_dir)],
        n_shards=N_SHARDS)


def _canon(view):
    """A package-neutral reading of a view."""
    return (view.epoch, view.n_shards,
            tuple((h.host_id, h.loader_ranks, h.trainer_ranks,
                   h.cache_spill_dir) for h in view.hosts),
            view.shard_ranges, view.loader_pool().members,
            view.loader_pool().generation, view.loader_ranks,
            view.trainer_ranks)


def _random_hosts(cl, rng):
    n = int(rng.integers(1, 7))
    ids = sorted(rng.choice(40, size=n, replace=False).tolist())
    hosts, rank = [], 1
    for hid in ids:
        k = int(rng.integers(0, 3))
        loaders = tuple(range(rank, rank + k))
        rank += k
        trainers = (hid,) if rng.random() < 0.5 else ()
        hosts.append(cl.HostInfo(hid, loader_ranks=loaders,
                                 trainer_ranks=trainers))
    return hosts


# ---------------------------------------------------------------------------
# Units: partitioning and view changes
# ---------------------------------------------------------------------------


class TestViewChange:
    @pytest.mark.parametrize("seed", range(6))
    def test_partition_covers_all_shards_deterministically(self, seed):
        rng = np.random.default_rng(seed)
        n_shards = int(rng.integers(0, 50))
        ids = rng.choice(100, size=int(rng.integers(1, 9)),
                         replace=False).tolist()
        a = tcl.partition_shards(n_shards, ids)
        assert a == tcl.partition_shards(n_shards, ids[::-1])
        assert a == jcl.partition_shards(n_shards, ids)
        covered = sorted(s for r in a.values() for lo, hi in r
                         for s in range(lo, hi))
        assert covered == list(range(n_shards))

    def test_partition_zero_hosts_raises(self):
        with pytest.raises(ddl_tpu_torch.exceptions.DDLError):
            tcl.partition_shards(4, [])

    @pytest.mark.parametrize("seed", range(8))
    def test_view_change_is_pure_and_deterministic(self, seed):
        """Seeded random views and dead sets: the successor views of both
        packages are equal, and survivors keep their ranges."""
        rng = np.random.default_rng(seed)
        n_shards = int(rng.integers(0, 30))
        state = rng.bit_generator.state
        views = {}
        for name, cl in (("jax", jcl), ("torch", tcl)):
            rng.bit_generator.state = state
            views[name] = cl.ClusterView.bootstrap(
                _random_hosts(cl, rng), n_shards=n_shards)
        assert _canon(views["jax"]) == _canon(views["torch"])
        v = views["torch"]
        ids = [h.host_id for h in v.hosts]
        dead = frozenset(rng.choice(ids, size=int(rng.integers(0, len(ids))),
                                    replace=False).tolist())
        if not dead:
            assert tcl.view_change(v, dead) is v
            return
        a = tcl.view_change(v, dead)
        assert a == tcl.view_change(v, dead)
        assert _canon(a) == _canon(jcl.view_change(views["jax"], dead))
        assert a.epoch == v.epoch + 1
        for hid in set(ids) - dead:
            assert set(v.ranges_of(hid)) <= set(a.ranges_of(hid))
        covered = sorted(s for _h, r in a.shard_ranges for lo, hi in r
                         for s in range(lo, hi))
        assert covered == list(range(n_shards))
        # Rejoin of the first dead host: the base partition at a new fence.
        back = {name: cl.view_rejoin(
            cl.view_change(views[name], dead), views[name].host(min(dead)))
            for name, cl in (("jax", jcl), ("torch", tcl))}
        assert _canon(back["jax"]) == _canon(back["torch"])

    def test_view_change_unknown_host_is_a_noop_without_epoch_bump(self):
        v = _view(tcl)
        assert tcl.view_change(v, frozenset({99})) is v

    def test_last_host_death_raises(self):
        v = tcl.ClusterView.bootstrap([tcl.HostInfo(0, loader_ranks=(1,))], 4)
        with pytest.raises(ddl_tpu_torch.exceptions.HostLostError):
            tcl.view_change(v, frozenset({0}))

    def test_rejoin_repartitions_at_a_new_fence(self):
        v = _view(tcl)
        lost = tcl.view_change(v, frozenset({1}))
        back = tcl.view_rejoin(lost, v.host(1))
        assert back.epoch == lost.epoch + 1
        assert back.shard_ranges == v.shard_ranges
        assert _canon(back) == _canon(jcl.view_rejoin(
            jcl.view_change(_view(jcl), frozenset({1})), _view(jcl).host(1)))
        with pytest.raises(ddl_tpu_torch.exceptions.DDLError):
            tcl.view_rejoin(back, v.host(1))

    def test_loader_pool_tracks_view(self):
        v = _view(tcl)
        assert v.loader_pool() == tcl.LoaderPool((0, 1), generation=0)
        lost = tcl.view_change(v, frozenset({1}))
        assert lost.loader_pool() == tcl.LoaderPool((0,), generation=1)


class TestLeases:
    def test_beat_refreshes_and_expiry_fires(self):
        trace = {}
        for name, cl in (("jax", jcl), ("torch", tcl)):
            now = [0.0]
            lt = cl.LeaseTable(lease_s=1.0, clock=lambda: now[0])
            lt.register(7)
            out = []
            for t, beat in ((0.9, True), (1.8, False), (2.0, False)):
                now[0] = t
                out.append(lt.expired())
                if beat:
                    lt.beat(7)
            lt.release(7)
            out += [lt.expired(), lt.remaining(7)]
            trace[name] = out
        assert trace["torch"] == trace["jax"] == [
            [], [], [7], [], float("inf")]

    def test_beat_on_unregistered_host_is_ignored(self):
        lt = tcl.LeaseTable(lease_s=1.0)
        lt.beat(3)
        assert lt.registered() == []


def _sup(p, lease_s=1.0, clock=None, metrics=None):
    return p.cl.ClusterSupervisor(
        _view(p.cl), lease_s=lease_s, metrics=metrics or p.Metrics(),
        **({"clock": clock} if clock else {}))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
class TestSupervisor:
    def test_dead_source_expires_lease_into_view_change(self, pkg):
        p = PKG[pkg]
        now = [0.0]
        m = p.Metrics()
        sup = _sup(p, clock=lambda: now[0], metrics=m)
        alive = {0: True, 1: True}
        sup.attach_source(0, lambda: alive[0])
        sup.attach_source(1, lambda: alive[1])
        events = []
        sup.add_listener(lambda o, n, d: events.append((n.epoch, set(d))))
        assert sup.sweep(now[0]) is None
        alive[1] = False
        now[0] = 0.9
        assert sup.sweep(now[0]) is None
        now[0] = 2.1
        new = sup.sweep(now[0])
        assert new is not None and new.epoch == 1
        assert events == [(1, {1})]
        assert sup.lost_ranks() == frozenset({2})
        assert m.counter("cluster.view_changes") == 1
        assert m.counter("cluster.host_losses") == 1

    def test_host_loss_fault_declares_immediately(self, pkg):
        p = PKG[pkg]
        sup = _sup(p, lease_s=100.0)
        plan = p.faults.FaultPlan([p.faults.FaultSpec(
            "cluster.heartbeat", p.faults.FaultKind.HOST_LOSS, producer_idx=1)])
        with p.faults.armed(plan):
            new = sup.sweep()
        assert new is not None and new.epoch == 1
        assert plan.fired == [("cluster.heartbeat", "host_loss", 1, 1)]
        assert {h.host_id for h in sup.view.hosts} == {0}

    def test_heartbeat_drop_only_ages_the_lease(self, pkg):
        p = PKG[pkg]
        now = [0.0]
        m = p.Metrics()
        sup = _sup(p, clock=lambda: now[0], metrics=m)
        sup.attach_source(0, lambda: True)
        sup.attach_source(1, lambda: True)
        plan = p.faults.FaultPlan([p.faults.FaultSpec(
            "cluster.heartbeat", p.faults.FaultKind.HEARTBEAT_DROP,
            producer_idx=1, count=10_000)])
        with p.faults.armed(plan):
            assert sup.sweep(0.5) is None
            assert m.counter("cluster.heartbeats_dropped") == 1
            now[0] = 2.0
            new = sup.sweep(now[0])
        assert new is not None
        assert {h.host_id for h in sup.view.hosts} == {0}
        assert m.counter("cluster.heartbeats_dropped") == 2

    def test_external_beat_keeps_sourceless_host_alive(self, pkg):
        p = PKG[pkg]
        now = [0.0]
        sup = _sup(p, clock=lambda: now[0])
        sup.attach_source(0, lambda: True)
        for t in (0.5, 1.0, 1.5):
            now[0] = t
            sup.beat(1, t)
            assert sup.sweep(t) is None

    def test_remote_loss_never_mutes_local_monitoring(self, pkg):
        cl = PKG[pkg].cl
        view = cl.ClusterView.bootstrap(
            [cl.HostInfo(0, loader_ranks=(1,), trainer_ranks=(0,)),
             cl.HostInfo(1, loader_ranks=(1,), trainer_ranks=(1,))],
            n_shards=4)
        sup = cl.ClusterSupervisor(view, lease_s=60.0,
                                   metrics=PKG[pkg].Metrics(),
                                   local_host_ids={0})
        sup.declare_host_loss(1)
        assert sup.lost_ranks() == frozenset()
        sup2 = cl.ClusterSupervisor(
            cl.ClusterView.bootstrap(
                [cl.HostInfo(0, loader_ranks=(1,)),
                 cl.HostInfo(1, loader_ranks=(2,))], n_shards=4),
            lease_s=60.0, metrics=PKG[pkg].Metrics(), local_host_ids={1})
        sup2.declare_host_loss(1)
        assert sup2.lost_ranks() == frozenset({2})

    def test_elastic_local_scope_pool_and_adoptions(self, pkg):
        cl = PKG[pkg].cl
        view = cl.ClusterView.bootstrap(
            [cl.HostInfo(0, loader_ranks=(1, 2), trainer_ranks=(0,)),
             cl.HostInfo(1, loader_ranks=(1, 2), trainer_ranks=(1,))],
            n_shards=4)
        sup = cl.ClusterSupervisor(view, lease_s=60.0,
                                   metrics=PKG[pkg].Metrics())
        elastic = cl.ElasticCluster(sup, metrics=PKG[pkg].Metrics(),
                                    local_host_id=0)
        pool = elastic._local_pool(sup.view)
        assert pool.members == (0, 1) and pool.generation == 0
        assert sup.local_host_ids == {0}

    def test_restore_epoch_fast_forwards_the_fence(self, pkg):
        sup = _sup(PKG[pkg])
        sup.restore_epoch(7)
        assert sup.view.epoch == 7
        sup.restore_epoch(3)
        assert sup.view.epoch == 7

    def test_crashing_listener_does_not_stop_the_ladder(self, pkg):
        sup = _sup(PKG[pkg])
        calls = []
        sup.add_listener(lambda o, n, d: 1 / 0)
        sup.add_listener(lambda o, n, d: calls.append(n.epoch))
        sup.declare_host_loss(1)
        assert calls == [1]

    def test_checkpoint_carries_the_cluster_epoch(self, pkg, tmp_path):
        """``LoaderCheckpoint.cluster_epoch`` round-trips through either
        package's file."""
        p = PKG[pkg]
        sup = _sup(p)
        sup.declare_host_loss(1)

        class FakeLoader:
            _epoch, _target, _batches_in_window = 3, 0, 0

        ck = p.checkpoint.LoaderCheckpoint.capture(FakeLoader(), cluster=sup)
        assert ck.cluster_epoch == 1
        path = str(tmp_path / "ck.json")
        ck.save(path)
        other = PKG["torch" if pkg == "jax" else "jax"]
        restored = other.checkpoint.LoaderCheckpoint.load(path)
        sup2 = _sup(other)
        restored.apply(FakeLoader(), cluster=sup2)
        assert sup2.view.epoch == 1


# ---------------------------------------------------------------------------
# Units: placement
# ---------------------------------------------------------------------------


def island_view(cl):
    hosts = [cl.HostInfo(h, loader_ranks=(h + 1,)) for h in (0, 1, 2, 3)] + [
        cl.HostInfo(h, trainer_ranks=(h - 4,)) for h in (4, 5, 6, 7)]
    return cl.ClusterView.bootstrap(hosts, n_shards=8)


def island_costs(cl, intra=8e9, cross=1e9):
    return cl.LinkCosts.islands([[0, 5], [1, 4], [2, 7], [3, 6]], intra, cross)


def _plan_tuple(plan):
    return (plan.assignment, plan.modeled_bytes_per_s,
            plan.naive_bytes_per_s, plan.reordered)


class TestPlacement:
    def test_reorder_rides_fast_links(self):
        plan = tcl.plan_placement(island_view(tcl), island_costs(tcl))
        assert plan.reordered
        assert plan.assignment == ((0, 5), (1, 4), (2, 7), (3, 6))
        assert plan.modeled_ratio == pytest.approx(8.0)
        assert _plan_tuple(plan) == _plan_tuple(
            jcl.plan_placement(island_view(jcl), island_costs(jcl)))

    @pytest.mark.parametrize("seed", range(6))
    def test_random_costs_plan_equal_to_reference(self, seed):
        """Seeded random fabrics and role splits: equal plans, naive
        assignments, drift readings and replans."""
        rng = np.random.default_rng(seed)
        n = int(rng.integers(2, 9))
        roles = rng.integers(0, 3, size=n)  # 0 loader, 1 trainer, 2 both
        if not (roles != 1).any():
            roles[0] = 0
        links = {(a, b): float(rng.uniform(1e8, 1e10))
                 for a in range(n) for b in range(a + 1, n)
                 if rng.random() < 0.7}
        drifted = {k: v * float(rng.uniform(0.5, 1.5))
                   for k, v in links.items()}
        out = {}
        for name, cl in (("jax", jcl), ("torch", tcl)):
            hosts = [cl.HostInfo(
                h, loader_ranks=(h + 1,) if roles[h] != 1 else (),
                trainer_ranks=(h,) if roles[h] != 0 else ()) for h in range(n)]
            view = cl.ClusterView.bootstrap(hosts, n_shards=n)
            costs = cl.LinkCosts(links, default_bytes_per_s=5e8)
            new = cl.LinkCosts(drifted, default_bytes_per_s=5e8)
            from importlib import import_module

            pl = import_module(f"{cl.__name__}.placement")
            replan = pl.replan_on_drift(view, costs, new, rel_tol=0.25)
            out[name] = (_plan_tuple(cl.plan_placement(view, costs)),
                         cl.naive_placement(view),
                         pl.costs_drift(costs, new),
                         None if replan is None else _plan_tuple(replan),
                         cl.modeled_bytes_per_s(cl.naive_placement(view),
                                                costs))
        assert out["torch"] == out["jax"]

    def test_never_slower_fallback_on_uniform_fabric(self):
        costs = tcl.LinkCosts({}, default_bytes_per_s=1e9)
        plan = tcl.plan_placement(island_view(tcl), costs)
        assert not plan.reordered
        assert plan.assignment == tcl.naive_placement(island_view(tcl))
        assert plan.modeled_ratio == 1.0

    def test_assignment_is_balanced(self):
        for cl in (jcl, tcl):
            hosts = [cl.HostInfo(h, loader_ranks=(h + 1,)) for h in range(4)] + [
                cl.HostInfo(h, trainer_ranks=(h - 4,)) for h in (4, 5)]
            view = cl.ClusterView.bootstrap(hosts, n_shards=4)
            costs = cl.LinkCosts({(p, 4): 9e9 for p in range(4)},
                                 default_bytes_per_s=1e9)
            plan = cl.plan_placement(view, costs)
            fan = {}
            for _p, c in plan.assignment:
                fan[c] = fan.get(c, 0) + 1
            assert max(fan.values()) <= 2
        assert _plan_tuple(plan) == _plan_tuple(tcl.plan_placement(
            tcl.ClusterView.bootstrap(
                [tcl.HostInfo(h, loader_ranks=(h + 1,)) for h in range(4)]
                + [tcl.HostInfo(h, trainer_ranks=(h - 4,)) for h in (4, 5)],
                n_shards=4),
            tcl.LinkCosts({(p, 4): 9e9 for p in range(4)},
                          default_bytes_per_s=1e9)))

    def test_colocated_roles_fall_back_to_all_hosts_as_consumers(self):
        plan = tcl.plan_placement(_view(tcl), tcl.LinkCosts({}))
        assert {p for p, _c in plan.assignment} == {0, 1}
        assert _plan_tuple(plan) == _plan_tuple(
            jcl.plan_placement(_view(jcl), jcl.LinkCosts({})))

    def test_probe_is_positive_and_deadline_bounded(self):
        costs = tcl.probe_link_costs([0, 1, 2], payload_bytes=1 << 14, reps=1)
        assert costs.source == "probed"
        assert costs.bytes_per_s(0, 1) > 0
        assert costs.bytes_per_s(0, 1) == costs.bytes_per_s(1, 0)
        slow = tcl.probe_link_costs(
            [0, 1], transfer=lambda a, b, p: time.sleep(0.2),
            payload_bytes=1 << 10, reps=1, timeout_s=0.0)
        assert slow.source == "probed-partial"

    def test_measured_ratio_wins_on_the_simulated_fabric(self):
        costs = island_costs(tcl, intra=8e9, cross=1e9)
        fabric = tcl.SimulatedFabric(costs)
        view = island_view(tcl)
        plan = tcl.plan_placement(view, costs)
        naive_rate = tcl.measure_assignment(
            tcl.naive_placement(view), fabric, payload_bytes=1 << 22, reps=2)
        plan_rate = tcl.measure_assignment(
            plan.assignment, fabric, payload_bytes=1 << 22, reps=2)
        assert plan_rate > naive_rate * 1.5

    def test_placement_report_contract(self):
        block = tcl.placement_report(island_view(tcl), island_costs(tcl),
                                     payload_bytes=1 << 20, reps=1)
        ref = jcl.placement_report(island_view(jcl), island_costs(jcl),
                                   payload_bytes=1 << 20, reps=1)
        assert set(block) == set(ref)
        for key in ("n_hosts", "n_links", "cost_source", "payload_bytes",
                    "assignment", "naive_assignment", "reordered",
                    "modeled_ratio"):
            assert block[key] == ref[key], key
        assert block["bytes_per_s"] == max(block["naive_bytes_per_s"],
                                           block["topo_bytes_per_s"])


class TestLoaderPoolUnit:
    def test_members_deduped_and_sorted(self):
        p = tcl.LoaderPool((3, 1, 1, 0))
        assert p.members == (0, 1, 3) == jcl.LoaderPool((3, 1, 1, 0)).members
        assert 3 in p and 2 not in p

    def test_without_and_union_bump_generation(self):
        p = tcl.LoaderPool((0, 1, 2), generation=4)
        q = p.without([1])
        assert q.members == (0, 2) and q.generation == 5
        r = q.union([1])
        assert r.members == (0, 1, 2) and r.generation == 6

    def test_next_member_wraps_and_honours_include(self):
        for cl in (jcl, tcl):
            p = cl.LoaderPool((0, 2, 3))
            assert [p.next_member(t) for t in range(5)] == [2, 2, 3, 0, 0]
            assert p.next_member(2, include=True) == 2
            assert p.next_member(1, include=True) == 2
        with pytest.raises(ddl_tpu_torch.exceptions.DDLError):
            tcl.LoaderPool(()).next_member(0)


# ---------------------------------------------------------------------------
# Units: host identity
# ---------------------------------------------------------------------------


_ID_VARS = ("HOST_ID", "N_HOSTS", "PROCS_PER_HOST")


def _clear_identity(monkeypatch, *extra):
    for name in _ID_VARS:
        for prefix in ("DDL_TPU_", "DDL_TORCH_"):
            monkeypatch.delenv(prefix + name, raising=False)
    for name in ("SLURM_NODEID", "SLURM_NNODES", "SLURM_NTASKS_PER_NODE") + extra:
        monkeypatch.delenv(name, raising=False)


def _set_identity(monkeypatch, name, value):
    monkeypatch.setenv("DDL_TPU_" + name, value)
    monkeypatch.setenv("DDL_TORCH_" + name, value)


def _both_identities(*args):
    got = PKG["torch"].env.detect_host_identity(*args)
    assert got == PKG["jax"].env.detect_host_identity(*args)
    return got


class TestHostIdentity:
    def test_env_wins(self, monkeypatch):
        _clear_identity(monkeypatch)
        _set_identity(monkeypatch, "HOST_ID", "3")
        _set_identity(monkeypatch, "N_HOSTS", "8")
        assert _both_identities(32, 17) == (3, 8)

    def test_slurm_node_identity(self, monkeypatch):
        _clear_identity(monkeypatch)
        monkeypatch.setenv("SLURM_NODEID", "2")
        monkeypatch.setenv("SLURM_NNODES", "4")
        assert _both_identities(16, 11) == (2, 4)

    def test_procs_per_host_arithmetic(self, monkeypatch):
        _clear_identity(monkeypatch)
        _set_identity(monkeypatch, "PROCS_PER_HOST", "4")
        assert _both_identities(8, 5) == (1, 2)
        _clear_identity(monkeypatch)
        assert _both_identities(8, 5) == (5, 8)

    def test_topology_carries_and_validates_host_fields(self):
        Topology = PKG["torch"].types.Topology
        t = Topology(n_instances=4, instance_idx=3, n_producers=1,
                     host_id=1, n_hosts=2)
        assert (t.host_id, t.n_hosts) == (1, 2)
        with pytest.raises(ValueError):
            Topology(n_instances=4, instance_idx=0, host_id=2, n_hosts=2)
        t = Topology(n_instances=1, instance_idx=0, host_id=2, n_hosts=4)
        assert (t.host_id, t.n_hosts) == (2, 4)

    def test_single_host_run_inside_slurm_allocation(self, monkeypatch):
        _clear_identity(monkeypatch)
        monkeypatch.setenv("SLURM_NODEID", "2")
        monkeypatch.setenv("SLURM_NNODES", "4")
        t = PKG["torch"].env.detect_topology(1, "thread")
        j = PKG["jax"].env.detect_topology(1, "thread")
        assert (t.n_instances, t.host_id, t.n_hosts) == (
            j.n_instances, j.host_id, j.n_hosts) == (1, 2, 4)

    def test_partial_env_widens_instead_of_crashing(self, monkeypatch):
        _clear_identity(monkeypatch)
        _set_identity(monkeypatch, "HOST_ID", "5")
        assert _both_identities(1, 0) == (5, 6)

    def test_export_clears_only_own_stale_exports(self, monkeypatch):
        from ddl_tpu_torch.config import LoaderConfig
        from ddl_tpu_torch.env import export_cluster_knobs

        _clear_identity(monkeypatch)
        export_cluster_knobs(LoaderConfig(host_id=2, n_hosts=4))
        assert os.environ["DDL_TORCH_HOST_ID"] == "2"
        assert os.environ["DDL_TORCH_N_HOSTS"] == "4"
        export_cluster_knobs(LoaderConfig())
        assert "DDL_TORCH_HOST_ID" not in os.environ
        assert "DDL_TORCH_N_HOSTS" not in os.environ
        monkeypatch.setenv("DDL_TORCH_HOST_ID", "7")
        export_cluster_knobs(LoaderConfig())
        assert os.environ["DDL_TORCH_HOST_ID"] == "7"

    def test_detect_topology_threads_explicit_identity(self, monkeypatch):
        _clear_identity(monkeypatch)
        t = PKG["torch"].env.detect_topology(1, "thread", host_id=0, n_hosts=1)
        assert (t.host_id, t.n_hosts) == (0, 1)


# ---------------------------------------------------------------------------
# The loader-pool seam
# ---------------------------------------------------------------------------


def _dl_kw(pkg):
    return {"pin_memory": False} if pkg == "torch" else {}


def _loader(p, producer, env, n_epochs, m, **kw):
    return p.mod.DistributedDataLoader(
        producer, batch_size=ROWS, connection=env.connection,
        n_epochs=n_epochs, output=kw.pop("output", "numpy"),
        metrics=m, **kw)


class TestLoaderPoolSeam:
    @pytest.mark.parametrize("pkg", ["jax", "torch"])
    def test_pool_applies_at_boundary_and_fences_generations(self, pkg):
        p = PKG[pkg]
        m = p.Metrics()
        producer = ShardRangeProducer({1: ((0, 2),), 2: ((2, 4),)},
                                      pkg=p.root)

        @p.mod.distributed_dataloader(n_producers=2, mode="thread",
                                      **_dl_kw(pkg))
        def main(env):
            loader = _loader(p, producer, env, 6, m, timeout_s=30.0)
            seen = []
            for ep in range(6):
                for (win,) in loader:
                    seen.append(int(win[0, 0] // 1000))
                    loader.mark(p.types.Marker.END_OF_BATCH)
                loader.mark(p.types.Marker.END_OF_EPOCH)
                if ep == 1:
                    loader.apply_pool(p.cl.LoaderPool((0,), generation=1))
                    loader.apply_pool(p.cl.LoaderPool((0, 1), generation=0))
            return seen

        seen = main()
        assert seen == [0, 2, 1, 0, 1, 0]
        assert m.counter("consumer.pool_updates") == 1.0

    def test_empty_local_pool_raises(self):
        p = PKG["torch"]
        producer = ShardRangeProducer({1: ((0, 2),), 2: ((2, 4),)})

        @p.mod.distributed_dataloader(n_producers=2, mode="thread",
                                      pin_memory=False)
        def main(env):
            loader = _loader(p, producer, env, 2, p.Metrics(), timeout_s=30.0)
            loader.apply_pool(p.cl.LoaderPool((7,), generation=1))
            with pytest.raises(p.exc.LoaderStateError):
                loader[0]
            loader.shutdown()

        main()

    def test_rotation_goes_only_through_next_target(self):
        """The pool seam cannot be bypassed: no modular rotation is left
        outside ``_next_target``."""
        import inspect

        from ddl_tpu_torch import dataloader

        src = inspect.getsource(dataloader)
        rule = inspect.getsource(dataloader.DistributedDataLoader._next_target)
        assert src.replace(rule, "").count("% self.n_producers") == 0
        assert rule.count("% self.n_producers") == 2

    @pytest.mark.parametrize("pkg", ["jax", "torch"])
    def test_blocked_acquire_moves_at_the_view_change(self, pkg):
        """Host 1's producer wedges before its 3rd window; the consumer
        blocks on ring 1 with a 60 s timeout.  A host-loss declaration
        0.5 s later moves it to the survivor at once (the sliced acquire
        sees the revoked target), and the stream goes on from host 0."""
        p = PKG[pkg]
        m = p.Metrics()
        producer = ShardRangeProducer({1: ((0, 2),), 2: ((2, 4),)},
                                      pkg=p.root)
        plan = p.faults.FaultPlan([p.faults.FaultSpec(
            "producer.fill", p.faults.FaultKind.PRODUCER_HANG, at=3,
            producer_idx=2)])

        @p.mod.distributed_dataloader(n_producers=2, mode="thread",
                                      **_dl_kw(pkg))
        def main(env):
            sup = p.cl.ClusterSupervisor(_view(p.cl), lease_s=60.0, metrics=m)
            elastic = p.cl.ElasticCluster(sup, workers=env.workers, metrics=m)
            loader = _loader(p, producer, env, 8, m, timeout_s=60.0,
                             cluster=elastic)
            seen, waits = [], []
            for ep in range(8):
                t0 = time.monotonic()
                if ep == 5:
                    # Ring 1's next window never comes: the declaration
                    # arrives while the consumer waits for it.
                    threading.Timer(0.5, elastic.kill_host, (1,)).start()
                for (win,) in loader:
                    waits.append(time.monotonic() - t0)
                    seen.append(int(win[0, 0] // 1000))
                    loader.mark(p.types.Marker.END_OF_BATCH)
                loader.mark(p.types.Marker.END_OF_EPOCH)
            return seen, waits

        with p.faults.armed(plan):
            seen, waits = main()
        assert plan.fired
        assert seen[:5] == [0, 2, 1, 3, 0]
        assert 0.4 < waits[5] < 10.0, waits
        assert m.counter("cluster.host_losses") == 1.0
        assert m.counter("consumer.pool_updates") >= 1.0


# ---------------------------------------------------------------------------
# E2E: the cross-host recovery ladder on two mock hosts
# ---------------------------------------------------------------------------


def drain_cluster(pkg, mode="thread", plan=None, n_epochs=14, lease_s=1.5,
                  kill_host_after_epoch=None, spill_dir=None, pace_s=0.0):
    """The 2-mock-host pipeline of ``tests/test_cluster.py`` in one
    package: returns (windows by shard, metrics, supervisor).  A small
    matrix product runs after every window: the step goes on through
    recovery."""
    import torch

    p = PKG[pkg]
    m = p.Metrics()
    producer = ShardRangeProducer({1: ((0, 2),), 2: ((2, 4),)}, pkg=p.root)

    @p.mod.distributed_dataloader(n_producers=2, mode=mode, **_dl_kw(pkg))
    def main(env):
        sup = p.cl.ClusterSupervisor(_view(p.cl, spill_dir), lease_s=lease_s,
                                     metrics=m)
        elastic = p.cl.ElasticCluster(sup, workers=env.workers, metrics=m)
        loader = _loader(p, producer, env, n_epochs, m, timeout_s=60.0,
                         cluster=elastic)
        wd = p.Watchdog(env.workers, poll_interval_s=0.05,
                        stall_budget_s=60.0, respawn=True, metrics=m,
                        cluster=sup).start()
        w = torch.ones(VALS, VALS)
        seen, steps = {}, []
        try:
            for ep in range(n_epochs):
                for (win,) in loader:
                    shard = int(win[0, 0] // 1000)
                    seen.setdefault(shard, []).append(np.array(win, copy=True))
                    steps.append(float((torch.as_tensor(np.asarray(win))
                                        @ w).sum()))
                    loader.mark(p.types.Marker.END_OF_BATCH)
                loader.mark(p.types.Marker.END_OF_EPOCH)
                if pace_s:
                    time.sleep(pace_s)
                if ep == kill_host_after_epoch:
                    elastic.kill_host(1)
        finally:
            wd.stop()
        assert len(steps) == n_epochs and np.isfinite(steps).all()
        return seen, sup

    if plan is not None:
        with p.faults.armed(plan):
            seen, sup = main()
    else:
        seen, sup = main()
    return seen, m, sup


def assert_full_coverage_byte_identical(seen):
    assert sorted(seen) == list(range(N_SHARDS)), sorted(seen)
    for shard, wins in seen.items():
        for w in wins:
            np.testing.assert_array_equal(w, shard_pattern(shard),
                                          err_msg=f"shard {shard}")


COUNTERS = ("cluster.view_changes", "cluster.host_losses",
            "cluster.host_drains", "watchdog.failures", "watchdog.respawns")


@pytest.fixture
def armed_sanitizer():
    with tcon.sanitized() as san:
        yield san
    assert san.n_acquisitions > 0, "armed run watched no locks"
    assert san.violations == [], san.violations


class TestElasticLadder:
    @pytest.mark.parametrize("mode", ["thread", "process"])
    def test_host_kill_repartitions_byte_identical(self, mode,
                                                   armed_sanitizer):
        """Per-shard streams byte-equal to the JAX package's under the same
        kill, with the same counters, view and lost ranks."""
        got, m, sup = drain_cluster("torch", mode, kill_host_after_epoch=3)
        ref, jm, jsup = drain_cluster("jax", mode, kill_host_after_epoch=3)
        assert_full_coverage_byte_identical(got)
        assert sorted(got) == sorted(ref)
        for shard in got:
            np.testing.assert_array_equal(got[shard][0], ref[shard][0])
        assert {c: m.counter(c) for c in COUNTERS} == {
            c: jm.counter(c) for c in COUNTERS}
        assert m.counter("cluster.view_changes") == 1.0
        assert m.counter("cluster.host_losses") == 1.0
        assert m.counter("consumer.pool_updates") >= 1.0
        assert m.counter("cluster.shard_adoptions") == jm.counter(
            "cluster.shard_adoptions") == 1.0
        assert _canon(sup.view) == _canon(jsup.view)
        assert sup.lost_ranks() == jsup.lost_ranks() == frozenset({2})
        # After the change the survivor also serves the adopted shards.
        post = [s for s, wins in got.items() if len(wins) > 2]
        assert set(post) & {2, 3}, {s: len(w) for s, w in got.items()}

    def test_producer_crash_then_host_kill_rungs_compose(self,
                                                         armed_sanitizer):
        counts = {}
        for pkg in ("torch", "jax"):
            p = PKG[pkg]
            plan = p.faults.FaultPlan([p.faults.FaultSpec(
                "producer.fill", p.faults.FaultKind.PRODUCER_CRASH, at=2,
                producer_idx=1)])
            seen, m, sup = drain_cluster(pkg, plan=plan,
                                         kill_host_after_epoch=5)
            assert plan.fired, "crash spec never fired"
            assert_full_coverage_byte_identical(seen)
            counts[pkg] = {c: m.counter(c) for c in COUNTERS}
        assert counts["torch"] == counts["jax"]
        assert counts["torch"]["watchdog.respawns"] == 1.0
        assert counts["torch"]["cluster.host_losses"] == 1.0
        assert counts["torch"]["watchdog.failures"] == 0.0

    def test_watchdog_leaves_lost_ranks_to_the_cluster(self,
                                                       armed_sanitizer):
        seen, m, sup = drain_cluster("torch", kill_host_after_epoch=2,
                                     n_epochs=10, pace_s=0.06)
        assert m.counter("watchdog.failures") == 0.0
        assert m.counter("watchdog.respawns") == 0.0
        assert_full_coverage_byte_identical(seen)

    def test_cache_warm_start_adoption_on_host_loss(self, tmp_path,
                                                    monkeypatch):
        p = PKG["torch"]
        spill = str(tmp_path / "host1-spill")
        seeder = p.cache.CacheStore(ram_budget_bytes=1 << 20, spill_dir=spill,
                                    spill_budget_bytes=1 << 20,
                                    metrics=p.Metrics())
        key = p.cache.CacheKey(source="src-1", shard="shard-0", reader="seed")
        seeder.put(key, np.arange(8, dtype=np.float32))
        monkeypatch.delenv("DDL_TORCH_CACHE_SPILL_DIR", raising=False)
        p.cache.reset_default_store()
        try:
            store = p.cache.default_store()
            assert store.spill_dir is None
            seen, m, sup = drain_cluster("torch", kill_host_after_epoch=3,
                                         spill_dir=spill)
            assert m.counter("cluster.cache_adoptions") == 1.0
            assert store.spill_dir == os.path.abspath(spill)
            np.testing.assert_array_equal(store.get(key),
                                          np.arange(8, dtype=np.float32))
            assert_full_coverage_byte_identical(seen)
        finally:
            p.cache.reset_default_store()
            # The adoption exported the spill dir: drop it outright (a
            # monkeypatch.delenv here would record it and restore it at
            # teardown, for the next test in this process to inherit).
            os.environ.pop("DDL_TORCH_CACHE_SPILL_DIR", None)

    def test_windows_stream_survives_host_kill(self, armed_sanitizer):
        """The ``windows()`` stream rides the same pool seam: a mid-stream
        host kill rotates it onto the survivor, as in the JAX package."""
        def run(pkg):
            p = PKG[pkg]
            m = p.Metrics()
            producer = ShardRangeProducer({1: ((0, 2),), 2: ((2, 4),)},
                                          pkg=p.root)
            out = {"output": "jax"} if pkg == "jax" else {
                "output": "device", "device": "cpu"}

            @p.mod.distributed_dataloader(n_producers=2, mode="thread",
                                          **_dl_kw(pkg))
            def main(env):
                sup = p.cl.ClusterSupervisor(_view(p.cl), lease_s=2.0,
                                             metrics=m)
                elastic = p.cl.ElasticCluster(sup, workers=env.workers,
                                              metrics=m)
                loader = _loader(p, producer, env, 12, m, timeout_s=60.0,
                                 cluster=elastic, **out)
                seen, served = {}, 0
                for win in loader.windows():
                    arr = np.asarray(win).reshape(ROWS, VALS)
                    seen.setdefault(int(arr[0, 0] // 1000), []).append(
                        arr.copy())
                    served += 1
                    loader.mark(p.types.Marker.END_OF_EPOCH)
                    if served == 4:
                        elastic.kill_host(1)
                assert served == 12
                return seen

            return main(), m

        seen, m = run("torch")
        ref, jm = run("jax")
        assert_full_coverage_byte_identical(seen)
        assert sorted(seen) == sorted(ref)
        assert m.counter("cluster.host_losses") == jm.counter(
            "cluster.host_losses") == 1.0

    def test_drain_then_rejoin_serves_the_parked_host(self, armed_sanitizer):
        """``drain_host`` parks host 1 (a drain, not a loss) and
        ``rejoin_host`` brings its ring back at a fresh fence, in both
        packages."""
        def run(pkg):
            p = PKG[pkg]
            m = p.Metrics()
            producer = ShardRangeProducer({1: ((0, 2),), 2: ((2, 4),)},
                                          pkg=p.root)

            @p.mod.distributed_dataloader(n_producers=2, mode="thread",
                                          **_dl_kw(pkg))
            def main(env):
                sup = p.cl.ClusterSupervisor(_view(p.cl), lease_s=60.0,
                                             metrics=m)
                elastic = p.cl.ElasticCluster(sup, workers=env.workers,
                                              metrics=m)
                loader = _loader(p, producer, env, 12, m, timeout_s=60.0,
                                 cluster=elastic)
                seen, parked = [], None
                for ep in range(12):
                    for (win,) in loader:
                        seen.append(np.array(win, copy=True))
                        loader.mark(p.types.Marker.END_OF_BATCH)
                    loader.mark(p.types.Marker.END_OF_EPOCH)
                    if ep == 3:
                        parked = elastic.drain_host(1)
                    if ep == 6:
                        elastic.rejoin_host(parked)
                return seen, sup

            seen, sup = main()
            return seen, m, sup

        counts = {}
        for pkg in ("torch", "jax"):
            seen, m, sup = run(pkg)
            by_shard = {}
            for w in seen:
                by_shard.setdefault(int(w[0, 0] // 1000), []).append(w)
            assert_full_coverage_byte_identical(by_shard)
            counts[pkg] = [m.counter(c) for c in (
                "cluster.host_drains", "cluster.rejoins",
                "cluster.host_losses", "consumer.pool_updates")]
            assert sup.view.epoch == 2
            assert [h.host_id for h in sup.view.hosts] == [0, 1]
        assert counts["torch"] == counts["jax"]
        assert counts["torch"][:3] == [1.0, 1.0, 0.0]


class TestAdoptionSuspendsExchange:
    def test_adoption_suspends_then_resumes_a_live_exchange(self):
        """Two THREAD instances exchanging through a
        ``ThreadExchangeShuffler``: a ``ShardAdoption`` with
        ``suspend_exchange=True`` at view epoch 1 turns the live
        shuffler's rounds node-local, one with ``False`` at epoch 2
        resumes it, and a stale epoch-1 copy sent after it is dropped.
        Each consumer sends while its producer is parked on a full ring,
        so both instances switch at the same round."""
        from ddl_tpu_torch import datapusher, dataloader, types
        from ddl_tpu_torch.observability import Metrics
        from ddl_tpu_torch.shuffle import Rendezvous, ThreadExchangeShuffler
        from ddl_tpu_torch.transport import connection as conn

        n_data, epochs = 16, 10
        rdv = Rendezvous()
        barrier = threading.Barrier(2, timeout=30)
        out, errors, pushers = {}, [], {}

        class Tagged:
            def __init__(self, i):
                self.i = i

            def on_init(self, **kw):
                return ddl_tpu_torch.DataProducerOnInitReturn(
                    nData=n_data, nValues=2, shape=(n_data, 2), splits=(2,))

            def post_init(self, my_ary, **kw):
                my_ary[:, 0] = 100 * self.i + np.arange(n_data)
                my_ary[:, 1] = self.i

        def parked(i, ring):
            """Wait until instance i's producer sits on a full ring with
            its next round done (its round count stops moving)."""
            deadline = time.monotonic() + 30
            last = None
            while time.monotonic() < deadline:
                st = ring.stats()
                rnd = pushers[i].shuffler.exchange_round
                if st["committed"] - st["released"] == ring.nslots and (
                        rnd == last):
                    return
                last = rnd
                time.sleep(0.1)
            raise AssertionError("producer never parked")

        def run(i):
            try:
                topo = types.Topology(n_instances=2, instance_idx=i,
                                      n_producers=1)
                cons_end, prod_end = conn.ThreadChannel.pair()
                pconn = conn.ProducerConnection(prod_end, 1)

                def produce():
                    pushers[i] = datapusher.DataPusher(
                        pconn, topo, 1, metrics=Metrics(),
                        shuffler_factory=ThreadExchangeShuffler.factory(rdv))
                    pushers[i].push_data()

                pt = threading.Thread(target=produce, daemon=True)
                pt.start()
                loader = dataloader.DistributedDataLoader(
                    Tagged(i), batch_size=n_data,
                    connection=conn.ConsumerConnection([cons_end]),
                    n_epochs=epochs, output="numpy", device="cpu",
                    global_shuffle_fraction_exchange=0.5, metrics=Metrics())
                sends = {2: (1, True), 5: (2, False), 7: (1, True)}
                wins = []
                for ep in range(epochs):
                    for (a,) in loader:
                        wins.append(np.array(a, copy=True))
                        if ep in sends:
                            parked(i, loader.connection.rings[0])
                            epoch, suspend = sends[ep]
                            loader.connection.send_control_acked(
                                0, types.ShardAdoption(
                                    ranges=((i, i + 1),), view_epoch=epoch,
                                    suspend_exchange=suspend))
                            barrier.wait(timeout=30)
                        loader.mark(types.Marker.END_OF_BATCH)
                    loader.mark(types.Marker.END_OF_EPOCH)
                out[i] = wins
                pt.join(30)
            except Exception as e:  # ddl-lint: disable=DDL007 - a worker thread: asserted in the main thread
                errors.append((i, e))
                barrier.abort()

        ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        assert not errors, errors
        for i in range(2):
            m = pushers[i].metrics
            assert m.counter("producer.shard_adoptions") == 2.0
            assert m.counter("shuffle.suspensions") == 1.0
            assert m.counter("shuffle.resumes") == 1.0
            assert not pushers[i].shuffler.exchange_suspended
            assert pushers[i]._view_epoch == 2
            rows = [sorted(w[:, 0].tolist()) for w in out[i]]

            def local(k):
                """Window k+1 holds window k's rows: a node-local round."""
                return rows[k] == rows[k + 1]

            # Exchanged rounds before the suspension and after the resume,
            # node-local ones in between.
            assert not local(0) and not local(8), rows
            assert any(local(k) for k in range(2, 8)), rows
