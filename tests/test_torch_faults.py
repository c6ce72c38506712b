"""The port's fault engine (``ddl_tpu_torch/faults.py``) and its sites,
against the JAX package's chaos suite (``tests/test_faults.py``), on the
CPU.

- The engine: every kind of the reference, plans whose JSON is
  byte-identical to the reference's ``FaultPlan.to_json``, hit windows,
  producer narrowing, arming (scoped, exported, from the env at import),
  seeded corruption that flips the reference's offsets, a hang that
  observes its abort, and the disarmed cost: one attribute read.
- The single-fault matrix through THREAD loaders: every stream byte for
  byte the undisturbed stream (the chaos pattern of the reference), or
  the documented terminal rung.  Sites: ``producer.fill`` (crash, hang,
  slowdown, spurious shutdown), ``producer.commit``, ``pusher.inplace_fill``,
  ``producer.handshake``, ``ring.fill``, ``staging.copy``,
  ``staging.transfer``, ``shuffle.exchange``, ``shuffle.device_exchange``,
  ``ici.fanout``, ``watchdog.sweep``, ``transport.control_send``.
- The resilience sites: ``resilience.ckpt_write`` (a torn generation
  quarantined, the previous one restored) and ``resilience.notice`` (a
  fit drained and resumed byte-identically).
- The soak: seeded two-fault plans in THREAD mode, and the exported plan
  across the spawn boundary in PROCESS mode.
- The shard cache's sites, ``cache.disk_read`` and ``backend.fetch``
  (hits, counters and streams equal to the reference's, and a spawned
  producer's quarantine), and the reference's ``TestTFRecordCRC``.
"""

import ast
import contextlib
import dataclasses
import inspect
import os
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from ddl_tpu import faults as jfaults
from ddl_tpu_torch import (
    DistributedDataLoader,
    Marker,
    distributed_dataloader,
)
from ddl_tpu_torch import faults
from ddl_tpu_torch.exceptions import (
    AdmissionDropped,
    DDLError,
    DecodeError,
    HeartbeatDropped,
    HostLostError,
    InjectedFault,
    IntegrityError,
    JobCrashed,
    PreemptionNotice,
    ShutdownRequested,
    SupervisorCrashed,
    TenantBurst,
    TransportError,
)
from ddl_tpu_torch.faults import FaultKind, FaultPlan, FaultSpec, fault_point
from ddl_tpu_torch.observability import Metrics
from ddl_tpu_torch.watchdog import Watchdog

sys.path.insert(0, os.path.dirname(__file__))
from torch_recovery_producers import (  # noqa: E402
    PATTERN_SHAPE,
    InplacePatternProducer,
    PatternProducer,
    pattern,
)

N_DATA = PATTERN_SHAPE[0]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def drain(plan, n_epochs=6, metrics=None, stall_budget_s=60.0,
          producer=None, mode="thread", export=False, poll_s=0.1):
    """A one-producer loader drained under ``plan`` with a respawning
    watchdog: the served windows, the watchdog and the metrics."""
    m = metrics or Metrics()
    producer = producer or PatternProducer()

    @distributed_dataloader(n_producers=1, mode=mode, pin_memory=False)
    def main(env):
        wd = Watchdog(env.workers, poll_interval_s=poll_s,
                      stall_budget_s=stall_budget_s, respawn=True,
                      metrics=m).start()
        try:
            loader = DistributedDataLoader(
                producer, batch_size=N_DATA, connection=env.connection,
                n_epochs=n_epochs, output="numpy", timeout_s=60.0,
                metrics=m, device="cpu")
            windows = []
            for _ in range(n_epochs):
                for cols in loader:
                    windows.append(np.hstack([np.asarray(c) for c in cols]))
                    loader.mark(Marker.END_OF_BATCH)
                loader.mark(Marker.END_OF_EPOCH)
        finally:
            wd.stop()
        return windows, wd

    ctx = faults.armed(plan, export=export) if plan else contextlib.nullcontext()
    with ctx:
        windows, wd = main()
    return windows, wd, m


def drain_staged(plan, n_epochs=5, sharding=None, distribute="auto"):
    """The staged ``windows()`` stream onto the CPU under ``plan``: the
    windows, the metrics and the loader."""
    m = Metrics()

    @distributed_dataloader(n_producers=1, mode="thread", pin_memory=False)
    def main(env):
        loader = DistributedDataLoader(
            PatternProducer(), batch_size=N_DATA, connection=env.connection,
            n_epochs=n_epochs, output="device", device="cpu", timeout_s=60.0,
            metrics=m, staged=True, sharding=sharding, distribute=distribute)
        windows = []
        for win in loader.windows():
            host = win.numpy() if hasattr(win, "numpy") else np.asarray(win)
            windows.append(np.array(host).reshape(PATTERN_SHAPE))
            loader.mark(Marker.END_OF_EPOCH)
        return windows, loader

    with faults.armed(plan):
        windows, loader = main()
    return windows, m, loader


def assert_byte_identical(got, n_epochs):
    want = [pattern(it) for it in range(1, n_epochs + 1)]
    assert len(got) == len(want), (len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.tobytes() == w.tobytes(), f"window {i + 1}"


# -- the engine ----------------------------------------------------------------


class TestFaultEngine:
    def test_kinds_equal_the_reference(self):
        assert [k.value for k in FaultKind] == [k.value for k in jfaults.FaultKind]
        assert faults.PLAN_ENV == "DDL_TORCH_FAULT_PLAN"

    @pytest.mark.parametrize("seed", [0, 7, 123])
    def test_plan_json_byte_identical_to_reference(self, seed):
        specs = [("producer.fill", "producer_crash", 3, 2, 1, 0.5),
                 ("wire.encode", "wire_corruption", 1, 1, None, 8.0),
                 ("resilience.notice", "preempt_notice", 4, 1, None, 7.0),
                 ("transport.control_send", "control_msg_dup", 2, 3, 2, 0.0)]
        port = FaultPlan([FaultSpec(s, FaultKind(k), at=a, count=c,
                                    producer_idx=p, param=x)
                          for s, k, a, c, p, x in specs], seed=seed)
        ref = jfaults.FaultPlan([jfaults.FaultSpec(s, jfaults.FaultKind(k),
                                                   at=a, count=c,
                                                   producer_idx=p, param=x)
                                 for s, k, a, c, p, x in specs], seed=seed)
        assert port.to_json() == ref.to_json()
        back = FaultPlan.from_json(ref.to_json())
        assert back.seed == seed and back.specs == port.specs
        assert jfaults.FaultPlan.from_json(port.to_json()).specs == ref.specs

    def test_disarmed_fault_point_is_a_noop(self, monkeypatch):
        assert faults.armed_plan() is None

        def never(*a, **k):
            raise AssertionError("a disarmed site reached the plan")

        monkeypatch.setattr(FaultPlan, "fire", never)
        assert fault_point("producer.fill", producer_idx=1) is None
        assert fault_point("nonexistent.site", view=np.zeros(4, np.uint8)) is None

    def test_disarmed_path_is_one_attribute_read(self):
        """The body: ``plan = _ARMED``, then ``return None`` while it is
        None — no dict, no lock, no logging before the test."""
        fn = ast.parse(inspect.getsource(faults.fault_point)).body[0]
        body = [n for n in fn.body if not (isinstance(n, ast.Expr)
                                           and isinstance(n.value, ast.Constant))]
        assign, test = body[0], body[1]
        assert isinstance(assign, ast.Assign)
        assert isinstance(assign.value, ast.Name) and assign.value.id == "_ARMED"
        assert isinstance(test, ast.If)
        assert isinstance(test.body[0], ast.Return)

    def test_at_and_count_hit_windows(self):
        plan = FaultPlan([FaultSpec("s", FaultKind.PRODUCER_CRASH, at=2,
                                    count=2)])
        with faults.armed(plan):
            assert fault_point("s") == []  # hit 1: below `at`
            with pytest.raises(InjectedFault):
                fault_point("s")  # hit 2
            with pytest.raises(InjectedFault):
                fault_point("s")  # hit 3
            assert fault_point("s") == []  # hit 4: past the window
        assert [f[3] for f in plan.fired] == [2, 3]

    def test_producer_idx_narrowing(self):
        plan = FaultPlan([FaultSpec("s", FaultKind.PRODUCER_CRASH,
                                    producer_idx=2)])
        with faults.armed(plan):
            fault_point("s", producer_idx=1)
            fault_point("s")
            with pytest.raises(InjectedFault):
                fault_point("s", producer_idx=2)

    def test_armed_context_restores_previous_plan_and_env(self, monkeypatch):
        monkeypatch.delenv(faults.PLAN_ENV, raising=False)
        outer = FaultPlan([FaultSpec("a", FaultKind.PRODUCER_CRASH)])
        inner = FaultPlan([FaultSpec("b", FaultKind.PRODUCER_CRASH)])
        with faults.armed(outer):
            with faults.armed(inner, export=True):
                assert faults.armed_plan() is inner
                assert os.environ[faults.PLAN_ENV] == inner.to_json()
            assert faults.armed_plan() is outer
            assert faults.PLAN_ENV not in os.environ
        assert faults.armed_plan() is None

    def test_corruption_flips_the_reference_offsets(self):
        def corrupted(mod, seed):
            buf = np.zeros(64, np.uint8)
            plan = mod.FaultPlan([mod.FaultSpec(
                "s", mod.FaultKind.RING_CORRUPTION, param=4)], seed=seed)
            with mod.armed(plan):
                mod.fault_point("s", view=buf)
            return buf

        for seed in (3, 4):
            assert corrupted(faults, seed).tobytes() == \
                corrupted(jfaults, seed).tobytes()
        assert not np.array_equal(corrupted(faults, 3), corrupted(faults, 4))

    def test_hang_observes_abort(self):
        plan = FaultPlan([FaultSpec("s", FaultKind.PRODUCER_HANG, param=30.0)])
        flag = {"down": False}

        def aborter():
            time.sleep(0.2)
            flag["down"] = True

        t0 = time.monotonic()
        threading.Thread(target=aborter, daemon=True).start()
        with faults.armed(plan):
            with pytest.raises(ShutdownRequested):
                fault_point("s", should_abort=lambda: flag["down"])
        assert time.monotonic() - t0 < 5.0

    @pytest.mark.parametrize("kind,exc", [
        (FaultKind.PRODUCER_CRASH, InjectedFault),
        (FaultKind.SPURIOUS_SHUTDOWN, ShutdownRequested),
        (FaultKind.STAGING_COPY_FAIL, InjectedFault),
        (FaultKind.STAGED_TRANSFER_FAIL, InjectedFault),
        (FaultKind.ICI_DMA_FAIL, InjectedFault),
        (FaultKind.DECODE_FAIL, DecodeError),
        (FaultKind.PREEMPT_NOTICE, PreemptionNotice),
        (FaultKind.CONTROL_MSG_DROP, TransportError),
        (FaultKind.NETWORK_PARTITION, TransportError),
        (FaultKind.SHUFFLE_PEER_LOSS, DDLError),
        (FaultKind.BACKEND_FETCH_FAIL, TransportError),
        (FaultKind.HOST_LOSS, HostLostError),
        (FaultKind.HEARTBEAT_DROP, HeartbeatDropped),
        (FaultKind.SUPERVISOR_CRASH, SupervisorCrashed),
        (FaultKind.TENANT_BURST, TenantBurst),
        (FaultKind.JOB_ADMISSION_DROP, AdmissionDropped),
        (FaultKind.JOB_CRASH, JobCrashed),
    ])
    def test_each_kind_raises_the_reference_type(self, kind, exc):
        plan = FaultPlan([FaultSpec("s", kind)])
        jplan = jfaults.FaultPlan([jfaults.FaultSpec(
            "s", jfaults.FaultKind(kind.value))])
        with faults.armed(plan), pytest.raises(exc) as got:
            fault_point("s")
        with jfaults.armed(jplan), pytest.raises(Exception) as want:
            jfaults.fault_point("s")
        assert type(got.value).__name__ == type(want.value).__name__

    @pytest.mark.parametrize("kind", list(FaultKind), ids=lambda k: k.name)
    def test_every_kind_raises_what_the_reference_raises(self, kind):
        """Every kind, fired at a bare site with a short ``param``: the
        port raises the type the JAX package raises — by name and by the
        names of its base classes — or, like it, raises nothing."""

        def fire(mod):
            plan = mod.FaultPlan([mod.FaultSpec("s", mod.FaultKind(kind.value),
                                                param=0.01)])
            with mod.armed(plan):
                try:
                    mod.fault_point("s", view=bytearray(8),
                                    should_abort=lambda: False)
                except Exception as e:  # ddl-lint: disable=DDL007 - the raised type (ShutdownRequested included) is what is compared
                    return [c.__name__ for c in type(e).__mro__]
            return None

        assert fire(faults) == fire(jfaults)

    def test_tenant_burst_carries_its_bytes(self):
        plan = FaultPlan([FaultSpec("s", FaultKind.TENANT_BURST,
                                    param=4096.0)])
        with faults.armed(plan), pytest.raises(TenantBurst) as got:
            fault_point("s")
        assert got.value.burst_bytes == 4096.0

    def test_dup_returns_its_kind_without_raising(self):
        plan = FaultPlan([FaultSpec("s", FaultKind.CONTROL_MSG_DUP)])
        with faults.armed(plan):
            assert fault_point("s") == ["control_msg_dup"]

    @pytest.mark.parametrize("text,armed", [
        (FaultPlan([FaultSpec("producer.fill", FaultKind.PRODUCER_CRASH,
                              at=3)], seed=5).to_json(), True),
        ("{not json", False),
    ], ids=["plan", "malformed"])
    def test_a_process_arms_itself_from_the_env(self, text, armed):
        probe = ("import sys; sys.path.insert(0, sys.argv[1]); "
                 "from ddl_tpu_torch import faults; p = faults.armed_plan(); "
                 "print(p.to_json() if p else 'none')")
        env = dict(os.environ, DDL_TORCH_FAULT_PLAN=text)
        env.pop("PYTHONPATH", None)
        out = subprocess.run([sys.executable, "-c", probe, REPO], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == (text if armed else "none")


# -- the single-fault matrix --------------------------------------------------


class TestFaultMatrix:
    def test_producer_crash_respawned_byte_identical(self):
        plan = FaultPlan([FaultSpec("producer.fill", FaultKind.PRODUCER_CRASH,
                                    at=3)])
        windows, wd, m = drain(plan)
        assert_byte_identical(windows, 6)
        assert list(wd.respawns) == [1] and list(wd.failures) == []
        assert m.counter("watchdog.respawns") == 1
        assert plan.fired and plan.fired[0][1] == "producer_crash"

    def test_producer_hang_retired_and_respawned_byte_identical(self):
        """A wedged THREAD producer: the watchdog sees no progress past
        its budget, retires the hung thread (the hang observes it) and
        its replacement serves the exact stream."""
        plan = FaultPlan([FaultSpec("producer.fill", FaultKind.PRODUCER_HANG,
                                    at=3, producer_idx=1)])
        windows, wd, m = drain(plan, stall_budget_s=2.0)
        assert_byte_identical(windows, 6)
        assert list(wd.respawns) == [1] and list(wd.failures) == []
        assert len(plan.fired) == 1

    def test_producer_slowdown_recovers_unassisted(self):
        plan = FaultPlan([FaultSpec("producer.fill",
                                    FaultKind.PRODUCER_SLOWDOWN, at=2,
                                    count=2, param=0.3)])
        windows, wd, m = drain(plan)
        assert_byte_identical(windows, 6)
        assert list(wd.respawns) == [] and list(wd.failures) == []
        assert len(plan.fired) == 2

    @pytest.mark.parametrize("site", ["producer.fill", "ring.fill"])
    def test_spurious_shutdown_respawned_byte_identical(self, site):
        plan = FaultPlan([FaultSpec(site, FaultKind.SPURIOUS_SHUTDOWN, at=2)])
        windows, wd, m = drain(plan)
        assert_byte_identical(windows, 6)
        assert list(wd.respawns) == [1] and list(wd.failures) == []

    @pytest.mark.parametrize("producer_cls", [PatternProducer,
                                              InplacePatternProducer])
    def test_ring_corruption_quarantined_and_replayed(self, producer_cls):
        plan = FaultPlan([FaultSpec("producer.commit",
                                    FaultKind.RING_CORRUPTION, at=2, param=4)])
        windows, wd, m = drain(plan, producer=producer_cls())
        assert_byte_identical(windows, 6)
        assert m.counter("integrity.corrupt_windows") == 1
        assert m.counter("integrity.replays") == 1
        assert list(wd.failures) == []

    def test_persistent_corruption_escalates_to_integrity_error(self):
        plan = FaultPlan([FaultSpec("producer.commit",
                                    FaultKind.RING_CORRUPTION, at=2,
                                    count=50, param=4)])
        m = Metrics()

        @distributed_dataloader(n_producers=1, mode="thread", pin_memory=False)
        def main(env):
            loader = DistributedDataLoader(
                PatternProducer(), batch_size=N_DATA,
                connection=env.connection, n_epochs=6, output="numpy",
                timeout_s=15.0, metrics=m, device="cpu")
            with pytest.raises(IntegrityError, match="still corrupt"):
                for _ in range(6):
                    for cols in loader:
                        loader.mark(Marker.END_OF_BATCH)
                    loader.mark(Marker.END_OF_EPOCH)
            loader.shutdown()

        with faults.armed(plan):
            main()
        assert m.counter("integrity.replays") == 2  # DDL_TORCH_MAX_REPLAYS
        assert m.counter("integrity.corrupt_windows") >= 3
        assert m.counter("integrity.replay_exhausted") == 1

    def test_inplace_crash_mid_fill_respawned_byte_identical(self):
        plan = FaultPlan([FaultSpec("pusher.inplace_fill",
                                    FaultKind.PRODUCER_CRASH, at=3)])
        windows, wd, m = drain(plan, producer=InplacePatternProducer())
        assert_byte_identical(windows, 6)
        assert list(wd.respawns) == [1] and list(wd.failures) == []
        assert m.counter("integrity.corrupt_windows") == 0
        assert plan.fired and plan.fired[0][0] == "pusher.inplace_fill"

    def test_staging_copy_fault_retried(self):
        plan = FaultPlan([FaultSpec("staging.copy",
                                    FaultKind.STAGING_COPY_FAIL, at=2)])
        windows, m, loader = drain_staged(plan)
        assert_byte_identical(windows, 5)
        assert m.counter("staging.retries") >= 1
        assert not loader._ingestor._engine.faulted

    def test_staged_transfer_fault_falls_back_inline(self):
        plan = FaultPlan([FaultSpec("staging.transfer",
                                    FaultKind.STAGED_TRANSFER_FAIL, at=1,
                                    count=999)])
        windows, m, loader = drain_staged(plan)
        assert_byte_identical(windows, 5)
        assert m.counter("staging.retries") >= 1
        assert m.counter("staging.inline_fallbacks") >= 1
        assert loader._ingestor._engine.faulted

    def test_staged_transfer_timeout_recovers(self):
        plan = FaultPlan([FaultSpec("staging.transfer",
                                    FaultKind.STAGED_TRANSFER_TIMEOUT, at=2,
                                    param=0.4)])
        windows, m, loader = drain_staged(plan)
        assert_byte_identical(windows, 5)
        assert m.counter("integrity.corrupt_windows") == 0
        assert not loader._ingestor._engine.faulted

    def test_ici_dma_fail_latches_the_plain_route(self):
        """``ici.fanout``'s injected leg failure mid-stream latches the
        plain route for the rest of the run (``ici.fallbacks`` once) and
        the stream stays byte-identical."""
        from ddl_tpu_torch.parallel import mesh as tmesh

        sh = tmesh.NamedSharding(tmesh.make_mesh({"dp": 8}, ["cpu"] * 8),
                                 tmesh.P(None, "dp"))
        plan = FaultPlan([FaultSpec("ici.fanout", FaultKind.ICI_DMA_FAIL,
                                    at=3)])
        windows, m, loader = drain_staged(plan, n_epochs=6, sharding=sh,
                                          distribute="ici")
        assert_byte_identical(windows, 6)
        assert plan.fired and plan.fired[0][1] == "ici_dma_fail"
        assert loader._ingestor._ici.faulted
        assert m.counter("ici.fallbacks") == 1
        assert m.counter("ici.windows") == 2

    def test_ici_fallbacks_never_fire_undisturbed(self):
        from ddl_tpu_torch.parallel import mesh as tmesh

        sh = tmesh.NamedSharding(tmesh.make_mesh({"dp": 8}, ["cpu"] * 8),
                                 tmesh.P(None, "dp"))
        windows, m, loader = drain_staged(None, n_epochs=4, sharding=sh,
                                          distribute="ici")
        assert_byte_identical(windows, 4)
        assert m.counter("ici.fallbacks") == 0 and m.counter("ici.windows") == 4

    def test_shuffle_peer_loss_degrades_to_local(self):
        """A lost exchange partner: rounds degrade node-locally, the
        exchange is disabled after ``max_peer_losses``, and every served
        window keeps its row multiset."""
        from ddl_tpu_torch.env import WorkerSet
        from ddl_tpu_torch.shuffle import Rendezvous, ThreadExchangeShuffler
        from ddl_tpu_torch.types import RunMode, Topology

        from torch_recovery_producers import ExchangeProducer

        plan = FaultPlan([FaultSpec("shuffle.exchange",
                                    FaultKind.SHUFFLE_PEER_LOSS, at=1,
                                    count=999)])
        n_epochs = 5
        topo = Topology(n_instances=2, instance_idx=0, n_producers=1,
                        mode=RunMode.THREAD)
        ws = WorkerSet(topo, nslots=2, shuffler_factory=(
            ThreadExchangeShuffler.factory(rendezvous=Rendezvous(),
                                           exchange_timeout_s=5.0,
                                           max_peer_losses=2)))
        t0 = time.monotonic()
        m = Metrics()
        with faults.armed(plan):
            loader = DistributedDataLoader(
                ExchangeProducer(0), batch_size=16,
                connection=ws.connection, n_epochs=n_epochs, output="numpy",
                global_shuffle_fraction_exchange=0.5, timeout_s=60.0,
                metrics=m, device="cpu")
            windows = []
            try:
                for _ in range(n_epochs):
                    for cols in loader:
                        windows.append(np.hstack([np.asarray(c) for c in cols]))
                        loader.mark(Marker.END_OF_BATCH)
                    loader.mark(Marker.END_OF_EPOCH)
            finally:
                loader.shutdown()
                ws.abort()
                ws.join(30.0)
        assert len(windows) == n_epochs
        tags = np.arange(16, dtype=np.float32)
        for i, win in enumerate(windows):
            np.testing.assert_array_equal(np.sort(win[:, 0]), tags,
                                          err_msg=f"window {i + 1}")
        assert len(plan.fired) >= 2
        assert time.monotonic() - t0 < 30.0

    def test_handshake_crash_fails_fast_with_typed_error(self):
        plan = FaultPlan([FaultSpec("producer.handshake",
                                    FaultKind.PRODUCER_CRASH)])

        @distributed_dataloader(n_producers=1, mode="thread", pin_memory=False)
        def main(env):
            with pytest.raises(TransportError, match="handshake"):
                DistributedDataLoader(
                    PatternProducer(), batch_size=N_DATA,
                    connection=env.connection, n_epochs=1, output="numpy",
                    device="cpu")

        t0 = time.monotonic()
        with faults.armed(plan):
            main()
        assert time.monotonic() - t0 < 30.0

    def test_watchdog_sweep_crash_never_disables_detection(self):
        plan = FaultPlan([
            FaultSpec("watchdog.sweep", FaultKind.PRODUCER_CRASH, at=1),
            FaultSpec("producer.fill", FaultKind.PRODUCER_CRASH, at=3),
        ])
        windows, wd, m = drain(plan)
        assert_byte_identical(windows, 6)
        assert list(wd.respawns) == [1] and list(wd.failures) == []
        assert [f[0] for f in plan.fired].count("watchdog.sweep") == 1

    @pytest.mark.parametrize("kind,counter", [
        (FaultKind.CONTROL_MSG_DROP, "ctrl.wire_drops"),
        (FaultKind.NETWORK_PARTITION, "ctrl.wire_drops"),
        (FaultKind.CONTROL_MSG_DUP, "ctrl.wire_dups"),
    ])
    def test_control_send_faults_absorbed_by_the_envelope(self, kind,
                                                          counter):
        """The replay request of a corrupt window rides the acked
        envelope: a dropped or partitioned send is retried, a duplicate
        is deduplicated; the stream is byte-identical."""
        plan = FaultPlan([
            FaultSpec("producer.commit", FaultKind.RING_CORRUPTION, at=2,
                      param=4),
            FaultSpec("transport.control_send", kind, at=1),
        ])
        windows, wd, m = drain(plan)
        assert_byte_identical(windows, 6)
        assert m.counter("integrity.replays") == 1
        assert m.counter(counter) == 1
        if kind is FaultKind.CONTROL_MSG_DUP:
            assert m.counter("ctrl.acked") >= 1
        else:
            assert m.counter("ctrl.retries") >= 1

    def test_device_exchange_fault_latches_every_participant(self):
        """``shuffle.device_exchange``'s ICI_DMA_FAIL poisons the round:
        both participants latch the host exchange together
        (``shuffle.device_fallbacks`` once each) and the served streams
        equal the host tier's byte for byte."""
        import test_torch_shuffle as ts

        from ddl_tpu_torch import shuffle as tsh

        rdv, rdv2 = tsh.Rendezvous(), tsh.Rendezvous()
        host = ts.drain("torch", lambda: tsh.ThreadExchangeShuffler.factory(
            rendezvous=rdv, seed=3), epochs=4)
        fabric = tsh.DeviceExchangeFabric(devices=["cpu"] * 2)
        plan = FaultPlan([FaultSpec("shuffle.device_exchange",
                                    FaultKind.ICI_DMA_FAIL, at=3)])
        with faults.armed(plan):
            dev = ts.drain("torch", lambda: tsh.DeviceExchangeShuffler.factory(
                rendezvous=rdv2, fabric=fabric, seed=3), epochs=4)
        for i in range(2):
            assert dev[i][0].tobytes() == host[i][0].tobytes()
        pushers = [dev[i][1] for i in range(2)]
        assert [p.metrics.counter("shuffle.device_fallbacks")
                for p in pushers] == [1, 1]
        assert all(p.metrics.counter("shuffle.device_rounds") >= 1
                   for p in pushers)

    def test_device_fallbacks_never_fire_undisturbed(self):
        import test_torch_shuffle as ts

        from ddl_tpu_torch import shuffle as tsh

        fabric = tsh.DeviceExchangeFabric(devices=["cpu"] * 2)
        rdv = tsh.Rendezvous()
        dev = ts.drain("torch", lambda: tsh.DeviceExchangeShuffler.factory(
            rendezvous=rdv, fabric=fabric, seed=3), epochs=3)
        for i in range(2):
            assert dev[i][1].metrics.counter("shuffle.device_fallbacks") == 0


# -- the resilience sites -------------------------------------------------------


def _tiny():
    from ddl_tpu_torch.models import llama as tllama

    return tllama.LlamaConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                              n_kv_heads=2, d_ff=64, max_seq=16,
                              dtype=torch.float32)


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tok") / "tokens.bin")
    np.random.default_rng(8).integers(0, 64, 20_000,
                                      dtype=np.int32).tofile(path)
    return path


def _fit(token_file, ckpt_dir=None, guard=None, metrics=None, n_epochs=6,
         mode="thread", **kw):
    """A window-streamed CPU fit of a tiny Llama: the result and each
    served window's CRC."""
    from ddl_tpu_torch.models import llama as tllama
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.readers import TokenStreamProducer
    from ddl_tpu_torch.trainer import Trainer

    cfg = _tiny()
    crcs = []

    def hook(win):
        crcs.append(zlib.crc32(win.numpy().tobytes()))
        return win

    trainer = Trainer(
        loss_fn=lambda p, b: tllama.next_token_loss(p, b[0], cfg),
        optimizer=adamw(3e-3),
        init_params=tllama.init_params(cfg, seed=1, device="cpu"),
        device="cpu", metrics=metrics or Metrics(), checkpoint_dir=ckpt_dir,
        preemption_guard=guard, **kw)
    res = trainer.fit(TokenStreamProducer(token_file, 16, 8, seed=2),
                      batch_size=4, n_epochs=n_epochs, n_producers=2,
                      mode=mode, window_stream=True, window_hook=hook)
    return res, crcs


class TestResilienceSites:
    def test_ckpt_corruption_chaos_site(self, tmp_path):
        """CKPT_CORRUPTION at resilience.ckpt_write flips bytes after the
        CRC stamp: the generation fails verification, is quarantined, and
        the previous verified generation restores."""
        from ddl_tpu_torch.models import llama as tllama
        from ddl_tpu_torch.parallel.train import adamw, make_train_step
        from ddl_tpu_torch.resilience import AsyncCheckpointer, restore_latest

        cfg = _tiny()
        init, _ = make_train_step(
            lambda p, b: tllama.next_token_loss(p, b[0], cfg), adamw(1e-3),
            "cpu")
        st = init(tllama.init_params(cfg, seed=1, device="cpu"))
        plan = FaultPlan([FaultSpec("resilience.ckpt_write",
                                    FaultKind.CKPT_CORRUPTION, at=2,
                                    param=16)])
        m = Metrics()
        cp = AsyncCheckpointer(str(tmp_path), metrics=m)
        with faults.armed(plan):
            cp.submit(dataclasses.replace(st, step=1))
            cp.flush()
            cp.submit(dataclasses.replace(st, step=2))
            cp.flush()
        cp.close()
        assert plan.fired
        like = init(tllama.init_params(cfg, seed=9, device="cpu"))
        restored = restore_latest(str(tmp_path), like=like, metrics=m)
        assert restored is not None and restored.step == 1
        assert m.counter("resilience.ckpt_quarantined") == 1

    def test_ckpt_write_streams_under_a_plan_for_another_site(
            self, tmp_path, monkeypatch):
        """A plan that names no ``resilience.ckpt_write`` spec (the notice
        plan a preemption drain runs under) leaves the write on its
        streaming path: the parts reach the file as they are, never joined
        into one copy, and the generation restores."""
        from ddl_tpu_torch.models import llama as tllama
        from ddl_tpu_torch.parallel.train import adamw, make_train_step
        from ddl_tpu_torch.resilience import AsyncCheckpointer, restore_latest
        from ddl_tpu_torch.resilience import ckpt as tckpt

        cfg = _tiny()
        init, _ = make_train_step(
            lambda p, b: tllama.next_token_loss(p, b[0], cfg), adamw(1e-3),
            "cpu")
        st = init(tllama.init_params(cfg, seed=1, device="cpu"))
        writes = []
        real = tckpt.atomic_file_write

        def spy(path, parts):
            if not isinstance(parts, bytes):
                writes.append(len(parts))
            return real(path, parts)

        monkeypatch.setattr(tckpt, "atomic_file_write", spy)
        plan = FaultPlan([FaultSpec("resilience.notice",
                                    FaultKind.PREEMPT_NOTICE, at=99)])
        m = Metrics()
        cp = AsyncCheckpointer(str(tmp_path), metrics=m)
        with faults.armed(plan):
            cp.submit(dataclasses.replace(st, step=1))
            cp.flush()
        cp.close()
        assert not plan.fired
        assert len(writes) == 1 and writes[0] > 1
        like = init(tllama.init_params(cfg, seed=9, device="cpu"))
        restored = restore_latest(str(tmp_path), like=like, metrics=m)
        assert restored is not None and restored.step == 1

    def test_fault_site_notice(self):
        from ddl_tpu_torch.resilience import PreemptionGuard

        plan = FaultPlan([FaultSpec("resilience.notice",
                                    FaultKind.PREEMPT_NOTICE, at=3,
                                    param=7.0)])
        g = PreemptionGuard(deadline_s=30.0, metrics=Metrics())
        with faults.armed(plan):
            assert g.poll() is False
            assert g.poll() is False
            assert g.poll() is True  # the 3rd boundary
        assert g.deadline_s == 7.0 and g.pending

    @pytest.mark.parametrize("mode,drained_at", [("thread", 4),
                                                 ("process", 2)])
    def test_preempt_notice_drains_and_resumes_byte_identical(
            self, tmp_path, token_file, mode, drained_at):
        from ddl_tpu_torch.resilience import PreemptionGuard, list_generations

        ref, ref_crcs = _fit(token_file, mode=mode)
        plan = FaultPlan([FaultSpec("resilience.notice",
                                    FaultKind.PREEMPT_NOTICE, at=drained_at)])
        m_b = Metrics()
        g = PreemptionGuard(deadline_s=60.0, metrics=m_b)
        ckpt = str(tmp_path / "ckpt")
        with faults.armed(plan):
            res_b, crcs_b = _fit(token_file, ckpt, guard=g, metrics=m_b,
                                 mode=mode, checkpoint_every_epochs=100)
        assert plan.fired and g.drained and res_b.preempted
        assert m_b.counter("watchdog.failures") == 0
        assert m_b.counter("resilience.final_ckpts") == 1
        assert m_b.gauge("resilience.drain_within_deadline") == 1.0
        assert [s for s, _ in list_generations(ckpt)] == [drained_at * 2]
        res_c, crcs_c = _fit(token_file, ckpt, mode=mode)
        assert res_c.resumed_from_epoch == drained_at
        assert crcs_b + crcs_c == ref_crcs
        assert res_b.losses + res_c.losses == ref.losses
        assert res_c.state.step == ref.state.step


# -- disarmed: zero cost -------------------------------------------------------


def test_disarmed_sites_leave_a_fit_unchanged(token_file):
    """The threaded sites change nothing while disarmed: a fit's losses,
    window CRCs and counters equal those of the same fit under an armed
    plan whose only spec names no site (every site then walks the plan
    and fires nothing)."""
    m_a, m_b = Metrics(), Metrics()
    res_a, crcs_a = _fit(token_file, metrics=m_a, n_epochs=3)
    plan = FaultPlan([FaultSpec("no.such.site", FaultKind.PRODUCER_CRASH)])
    with faults.armed(plan):
        res_b, crcs_b = _fit(token_file, metrics=m_b, n_epochs=3)
    assert res_a.losses == res_b.losses and crcs_a == crcs_b
    assert plan.fired == []
    assert m_a._counters == m_b._counters


# -- the soak -----------------------------------------------------------------


def _random_plan(seed):
    """Two seeded faults drawn from the locally replayable matrix
    (tests/test_faults.py:816-831)."""
    rng = np.random.default_rng(seed)
    kinds = [
        (FaultKind.PRODUCER_CRASH, "producer.fill", 0.0),
        (FaultKind.PRODUCER_SLOWDOWN, "producer.fill", 0.3),
        (FaultKind.SPURIOUS_SHUTDOWN, "producer.fill", 0.0),
        (FaultKind.RING_CORRUPTION, "producer.commit", 3.0),
    ]
    specs = []
    for pick in rng.choice(len(kinds), size=2, replace=False):
        kind, site, param = kinds[int(pick)]
        specs.append(FaultSpec(site, kind, at=int(rng.integers(2, 6)),
                               param=param))
    return FaultPlan(specs, seed=seed)


class TestChaosSoak:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_multi_fault_byte_identical(self, seed):
        plan = _random_plan(seed)
        assert plan.to_json() == jfaults.FaultPlan.from_json(
            plan.to_json()).to_json()
        windows, wd, m = drain(plan, n_epochs=8)
        assert_byte_identical(windows, 8)
        assert list(wd.failures) == []
        assert plan.fired, "no scheduled fault ever fired"

    @pytest.mark.parametrize("producer_cls,site", [
        (PatternProducer, "producer.fill"),
        (InplacePatternProducer, "pusher.inplace_fill"),
    ])
    def test_process_mode_crash_respawn_with_exported_plan(
            self, producer_cls, site):
        """The plan crosses the spawn boundary in DDL_TORCH_FAULT_PLAN; each
        spawned incarnation arms it with a fresh hit counter, so late
        incarnations may crash again — the count of respawns depends on
        timing, the data never does."""
        plan = FaultPlan([FaultSpec(site, FaultKind.PRODUCER_CRASH, at=3)])
        windows, wd, m = drain(plan, producer=producer_cls(), mode="process",
                               export=True, poll_s=0.2)
        assert_byte_identical(windows, 6)
        assert len(wd.respawns) >= 1 and set(wd.respawns) == {1}
        assert list(wd.failures) == []

    def test_process_mode_wire_corruption_replayed(self):
        """A spawned producer corrupts its encoded slot after the stamp
        (``wire.encode``); the consumer replays it across the pipe, and
        the stream equals the undisturbed encoded stream."""
        clean, _, _ = drain(None, producer=PatternProducer(wire_dtype="int8"),
                            mode="process")
        plan = FaultPlan([FaultSpec("wire.encode", FaultKind.WIRE_CORRUPTION,
                                    at=2, param=6)])
        got, wd, m = drain(plan, producer=PatternProducer(wire_dtype="int8"),
                           mode="process", export=True)
        assert [g.tobytes() for g in got] == [c.tobytes() for c in clean]
        assert m.counter("integrity.replays") == 1
        assert m.counter("wire.decoded_windows") >= 6


# -- the shard cache's sites and the TFRecord CRC -----------------------------


def _npy_shard_glob(tmp_path, n=3):
    rng = np.random.default_rng(0)
    for i in range(n):
        np.save(tmp_path / f"s{i}.npy",
                rng.standard_normal((8, 4)).astype(np.float32))
    return str(tmp_path / "s*.npy")


def _fills(producer, n):
    ret = producer.on_init(producer_idx=1)
    ary = np.zeros(ret.shape, ret.dtype)
    producer.post_init(my_ary=ary)
    out = [ary.copy()]
    for _ in range(n - 1):
        producer.execute_function(my_ary=ary)
        out.append(ary.copy())
    return np.stack(out)


class TestCacheSites:
    """``cache.disk_read`` and ``backend.fetch`` act as in the reference:
    the same plan fires the same hits and leaves the same counters."""

    @pytest.mark.parametrize("site,kind,at,count,param", [
        ("cache.disk_read", "cache_corruption", 1, 1, 16),
        ("cache.disk_read", "cache_corruption", 2, 2, 4),
        ("backend.fetch", "backend_fetch_fail", 2, 2, 0),
        ("backend.fetch", "backend_fetch_fail", 1, 3, 0),
    ])
    def test_plan_fires_and_counts_as_the_reference(
            self, tmp_path, monkeypatch, site, kind, at, count, param):
        from ddl_tpu import cache as jcache
        from ddl_tpu import readers as jreaders
        from ddl_tpu.observability import Metrics as JMetrics
        from ddl_tpu_torch import cache as tcache
        from ddl_tpu_torch import readers as treaders

        pattern = _npy_shard_glob(tmp_path)
        monkeypatch.setenv("DDL_TPU_CACHE_BACKOFF_S", "0.001")
        monkeypatch.setenv("DDL_TORCH_CACHE_BACKOFF_S", "0.001")
        got = {}
        for name, cache, readers, fmod, M in (
                ("jax", jcache, jreaders, jfaults, JMetrics),
                ("torch", tcache, treaders, faults, Metrics)):
            m = M()
            store = cache.CacheStore(spill_dir=str(tmp_path / name),
                                     metrics=m)
            clean = _fills(readers.FileShardProducer(
                pattern, seed=2, cache=store, warm=False), 4)
            if site == "cache.disk_read":
                store.clear()  # the next reads go through the disk tier
            else:  # a cold store: every shard is fetched
                store = cache.CacheStore(
                    spill_dir=str(tmp_path / f"{name}-cold"), metrics=m)
            plan = fmod.FaultPlan([fmod.FaultSpec(
                site, fmod.FaultKind(kind), at=at, count=count,
                param=param)], seed=3)
            with fmod.armed(plan):
                out = _fills(readers.FileShardProducer(
                    pattern, seed=2, cache=store, warm=False), 4)
            assert out.tobytes() == clean.tobytes()
            got[name] = (out.tobytes(), [f[1] for f in plan.fired],
                         {k: m.counter(k) for k in (
                             "cache.quarantined", "cache.backend_retries",
                             "cache.spill_hits", "cache.misses")})
        assert got["torch"] == got["jax"]
        assert got["torch"][1] == [kind] * count

    def test_decode_fail_at_the_codec_backend_retries(self, tmp_path):
        from ddl_tpu_torch import cache as tcache

        src = tmp_path / "x.npy"
        np.save(src, np.arange(8, dtype=np.float32))
        (tmp_path / "x.npy.zz").write_bytes(zlib.compress(src.read_bytes()))
        plan = FaultPlan([FaultSpec("wire.decode", FaultKind.DECODE_FAIL,
                                    at=1)])
        m = Metrics()
        with faults.armed(plan):
            f = tcache.open_with_retry(tcache.CodecBackend(),
                                       str(tmp_path / "x.npy.zz"),
                                       retries=2, backoff_s=0.001, metrics=m)
        assert np.array_equal(np.load(f), np.arange(8, dtype=np.float32))
        assert plan.fired and m.counter("cache.backend_retries") == 1

    def test_exported_corruption_plan_reaches_process_producers(
            self, tmp_path):
        """PROCESS producers arm an exported plan and build their stores
        from the exported cache knobs: a corrupted disk entry in a spawned
        producer is quarantined and refetched, the stream unchanged."""
        from ddl_tpu_torch.config import LoaderConfig
        from ddl_tpu_torch import cache as tcache
        from ddl_tpu_torch.readers import FileShardProducer

        pattern = _npy_shard_glob(tmp_path, n=2)
        spill = str(tmp_path / "spill")
        cfg = LoaderConfig(mode="process", n_producers=1, cache=True,
                           cache_spill_dir=spill, cache_warm=False)
        prev = {k: os.environ.get(k) for k in (
            "DDL_TORCH_CACHE", "DDL_TORCH_CACHE_SPILL_DIR",
            "DDL_TORCH_CACHE_WARM", "DDL_TORCH_CACHE_RAM_MB",
            "DDL_TORCH_CACHE_SPILL_MB")}

        def run(plan=None):
            @distributed_dataloader(config=cfg, pin_memory=False)
            def main(env):
                loader = DistributedDataLoader(
                    FileShardProducer(pattern, seed=9), batch_size=8,
                    connection=env.connection, n_epochs=4, output="numpy",
                    device="cpu", metrics=Metrics(), timeout_s=60.0)
                out = []
                for _ in range(4):
                    for cols in loader:
                        out.append(np.hstack([np.asarray(c) for c in cols]))
                        loader.mark(Marker.END_OF_BATCH)
                    loader.mark(Marker.END_OF_EPOCH)
                return np.stack(out), env

            ctx = (faults.armed(plan, export=True) if plan
                   else contextlib.nullcontext())
            with ctx:
                return main()

        try:
            clean, env = run()
            assert env.workers.exitcodes == [0]
            assert len(os.listdir(spill)) == 2
            plan = FaultPlan([FaultSpec("cache.disk_read",
                                        FaultKind.CACHE_CORRUPTION, at=1,
                                        param=8)])
            got, env = run(plan)
            assert env.workers.exitcodes == [0]
            assert got.tobytes() == clean.tobytes()
            names = os.listdir(spill)
            assert sum(n.endswith(".quarantined") for n in names) == 1
            assert sum(n.endswith(".ddlc") for n in names) == 2
        finally:
            for k, v in prev.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            tcache.reset_default_store()


class TestTFRecordCRC:
    """The reference's ``TestTFRecordCRC`` against the port's parsers."""

    def _write(self, tmp_path, valid=True):
        from datagen import encode_example_int64, write_tfrecord

        payloads = [
            encode_example_int64("input_ids", list(range(10 * i, 10 * i + 8)))
            for i in range(4)
        ]
        path = str(tmp_path / "rec.tfrecord")
        write_tfrecord(path, payloads, valid_crc=valid)
        return path, payloads

    def test_crc32c_check_vector(self):
        from ddl_tpu_torch.readers import _make_crc32c_tables, crc32c

        assert crc32c(b"123456789") == 0xE3069283
        assert crc32c(b"") == 0
        data = bytes(range(256)) * 3 + b"tail"
        ref = 0xFFFFFFFF
        t0 = _make_crc32c_tables()[0]
        for b in data:
            ref = int(t0[(ref ^ b) & 0xFF]) ^ (ref >> 8)
        assert crc32c(data) == ref ^ 0xFFFFFFFF
        assert crc32c(data) != (zlib.crc32(data) & 0xFFFFFFFF)

    @pytest.mark.parametrize("n", [1, 3, 4, 5, 2047, 2048, 2049, 4096,
                                   6000, 10_000])
    def test_crc32c_equals_the_reference(self, n):
        from ddl_tpu import readers as jreaders
        from ddl_tpu_torch import readers as treaders

        data = np.random.default_rng(n).integers(0, 256, n,
                                                 dtype=np.uint8).tobytes()
        assert treaders.crc32c(data) == jreaders.crc32c(data)
        assert treaders.masked_crc32c(data) == jreaders.masked_crc32c(data)

    def test_valid_file_reads_with_verification(self, tmp_path):
        from ddl_tpu_torch.readers import iter_tfrecords

        path, payloads = self._write(tmp_path)
        assert list(iter_tfrecords(path, verify_crc=True)) == payloads

    def test_corrupt_payload_raises_with_context(self, tmp_path):
        from ddl_tpu_torch.readers import iter_tfrecords

        path, _ = self._write(tmp_path)
        data = bytearray(open(path, "rb").read())
        data[20] ^= 0xFF  # inside record 0's payload
        open(path, "wb").write(bytes(data))
        with pytest.raises(IntegrityError, match="offset 0"):
            list(iter_tfrecords(path, verify_crc=True))

    def test_corrupt_length_crc_raises(self, tmp_path):
        from ddl_tpu_torch.readers import iter_tfrecords

        path, _ = self._write(tmp_path, valid=False)
        with pytest.raises(IntegrityError, match="length-crc"):
            list(iter_tfrecords(path, verify_crc=True))

    def test_opt_out_knob_skips_validation(self, tmp_path, monkeypatch):
        from ddl_tpu_torch.readers import iter_tfrecords

        path, payloads = self._write(tmp_path, valid=False)
        assert list(iter_tfrecords(path, verify_crc=False)) == payloads
        monkeypatch.setenv("DDL_TORCH_TFRECORD_CRC", "0")
        assert list(iter_tfrecords(path)) == payloads
        monkeypatch.setenv("DDL_TORCH_TFRECORD_CRC", "1")
        with pytest.raises(IntegrityError):
            list(iter_tfrecords(path))

    @pytest.mark.parametrize("cut", [1, 4, 11, 12, 20, 30])
    @pytest.mark.parametrize("verify", [True, False])
    def test_truncated_tail_ends_the_stream_in_both_modes(
            self, tmp_path, cut, verify):
        from ddl_tpu import readers as jreaders
        from ddl_tpu_torch.readers import iter_tfrecords

        path, payloads = self._write(tmp_path)
        data = open(path, "rb").read()
        open(path, "wb").write(data[:-cut])
        got = list(iter_tfrecords(path, verify_crc=verify))
        assert got == payloads[:-1]
        assert got == list(jreaders.iter_tfrecords(path, verify_crc=verify))
