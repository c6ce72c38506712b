"""Preemption-tolerant training in the port, held to the JAX package's
behaviour (``tests/test_resilience.py``).

- ``PreemptionGuard`` units, each run through both packages: the drain
  ladder's order and metrics, the drain rung through a real
  ``ElasticCluster`` over two mock hosts (a graceful view change that
  drops the drained host), the revoke rung through a real
  ``AdmissionController`` (a tenant parked in ``admit`` wakes with
  ``WindowsRevoked`` inside the rung's SLO), a blown deadline (the checkpoint still
  runs, the hygiene rungs are skipped), the env notice carrying its
  deadline, and the SIGTERM handler's install/uninstall.
- Drain on notice, end to end on the CPU: a notice mid-``fit`` drains at
  the window boundary (forced final generation, clean producer
  shutdown), and a fresh ``Trainer`` on the same directory resumes — the
  served window stream and the loss curve of the two runs together equal
  an undisturbed fit's byte for byte, in THREAD and PROCESS mode; the
  synchronous checkpoint path drains and resumes too.
- Async and sync checkpoints of the same fit restore to identical state.
"""

import os
import signal
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from ddl_tpu.observability import Metrics as JaxMetrics
from ddl_tpu.resilience import PreemptionGuard as JaxGuard
from ddl_tpu_torch import checkpoint as tckpt
from ddl_tpu_torch.models import llama as tllama
from ddl_tpu_torch.observability import Metrics
from ddl_tpu_torch.parallel.train import adamw, tree_leaves
from ddl_tpu_torch.readers import TokenStreamProducer
from ddl_tpu_torch.resilience import (
    PreemptionGuard,
    latest_verified_generation,
    list_generations,
    restore_latest,
)
from ddl_tpu_torch.trainer import Trainer

GUARDS = {"jax": (JaxGuard, JaxMetrics, "DDL_TPU_PREEMPT_NOTICE"),
          "torch": (PreemptionGuard, Metrics, "DDL_TORCH_PREEMPT_NOTICE")}


# -- guard units ---------------------------------------------------------------


def _ladder(pkg):
    guard_cls, metrics_cls, _ = GUARDS[pkg]
    calls = []

    class FakeAdmission:
        def revoke_inflight(self, slo_s):
            calls.append(("revoke", slo_s <= 0.5))

    class FakeCluster:
        def drain_host(self, host_id):
            calls.append(("drain_host", host_id))

    m = metrics_cls()
    g = guard_cls(deadline_s=30.0, cluster=FakeCluster(), host_id=2,
                  admission=FakeAdmission(), revoke_slo_s=0.5, metrics=m)
    g.notify("test")
    ok = g.drain(final_checkpoint=lambda: calls.append(("ckpt",)),
                 shutdown=lambda: calls.append(("shutdown",)))
    return (ok, g.drained, calls, m.counter("resilience.drains"),
            m.counter("resilience.notices"),
            m.gauge("resilience.drain_within_deadline"),
            m.timer("resilience.drain").count)


def test_drain_ladder_order_and_metrics():
    got = _ladder("torch")
    assert got == _ladder("jax")
    assert got[2] == [("ckpt",), ("revoke", True), ("drain_host", 2),
                      ("shutdown",)]


def _elastic_ladder(pkg):
    """The guard's drain rung through a real ``ElasticCluster`` over two
    mock hosts: the rung is a graceful, epoch-fenced view change."""
    import importlib

    guard_cls, metrics_cls, _ = GUARDS[pkg]
    cl = importlib.import_module(
        ("ddl_tpu" if pkg == "jax" else "ddl_tpu_torch") + ".cluster")
    m = metrics_cls()
    sup = cl.ClusterSupervisor(cl.ClusterView.bootstrap(
        [cl.HostInfo(0, loader_ranks=(1,), trainer_ranks=(0,)),
         cl.HostInfo(1, loader_ranks=(2,))], n_shards=4), lease_s=60.0,
        metrics=m)
    calls = []
    sup.add_listener(lambda old, new, dead: calls.append(
        ("view_change", old.epoch, new.epoch, sorted(dead))))
    elastic = cl.ElasticCluster(sup, metrics=m)
    g = guard_cls(deadline_s=30.0, cluster=elastic, host_id=1, metrics=m)
    g.notify("test")
    ok = g.drain(final_checkpoint=lambda: calls.append(("ckpt",)),
                 shutdown=lambda: calls.append(("shutdown",)))
    view = sup.view
    return (ok, calls, [h.host_id for h in view.hosts], view.shard_ranges,
            view.loader_pool().members, sorted(sup.lost_ranks()),
            m.counter("cluster.host_drains"), m.counter("cluster.host_losses"),
            m.counter("resilience.drain_rung_failures"))


def test_drain_rung_through_a_real_elastic_cluster():
    got = _elastic_ladder("torch")
    assert got == _elastic_ladder("jax")
    assert got[:2] == (True, [("ckpt",), ("view_change", 0, 1, [1]),
                              ("shutdown",)])
    assert got[2:] == ([0], ((0, ((0, 2), (2, 4))),), (0,), [2], 1.0, 0.0,
                       0.0)


def _revoke_ladder(pkg):
    """The guard's revoke rung over a REAL admission controller: a tenant
    whose byte bucket is underwater is parked in ``admit`` when the notice
    drains; the rung must wake it with the typed ``WindowsRevoked``
    within the rung's SLO, between the checkpoint and the host drain."""
    import importlib

    root = "ddl_tpu" if pkg == "jax" else "ddl_tpu_torch"
    serve = importlib.import_module(f"{root}.serve")
    exc = importlib.import_module(f"{root}.exceptions")
    guard_cls, metrics_cls, _ = GUARDS[pkg]
    m = metrics_cls()
    ctl = serve.AdmissionController(metrics=m)
    tenant = ctl.register(serve.TenantSpec("t", byte_budget_per_s=1000.0))
    tenant.admit(1.0)
    tenant.note_served(1 << 20)  # the bucket ~17 minutes underwater
    calls, woke = [], []
    revoke = ctl.revoke_inflight

    def logged_revoke(slo_s):
        calls.append(("revoke", time.monotonic()))
        return revoke(slo_s)

    ctl.revoke_inflight = logged_revoke

    def parked():
        try:
            tenant.admit(30.0)
        except exc.WindowsRevoked:
            woke.append(("revoked", time.monotonic()))

    th = threading.Thread(target=parked, daemon=True)
    th.start()
    deadline = time.monotonic() + 5.0
    while not ctl.scheduler._state("t").waiting:
        assert time.monotonic() < deadline, "the tenant never parked"
        time.sleep(0.01)

    class Cluster:
        def drain_host(self, host_id):
            calls.append(("drain_host", time.monotonic()))

    slo = 0.5
    g = guard_cls(deadline_s=30.0, cluster=Cluster(), host_id=1,
                  admission=ctl, revoke_slo_s=slo, metrics=m)
    g.notify("test")
    ok = g.drain(
        final_checkpoint=lambda: calls.append(("ckpt", time.monotonic())),
        shutdown=lambda: calls.append(("shutdown", time.monotonic())))
    th.join(5.0)
    assert not th.is_alive() and len(woke) == 1
    t_revoke = dict(calls)["revoke"]
    assert woke[0][1] - t_revoke <= slo, woke[0][1] - t_revoke
    return (ok, [c[0] for c in calls], m.counter("serve.revocations"),
            m.counter("serve.revoked_waiters"),
            m.counter("ingest.t.revocations"))


def test_revoke_rung_wakes_a_parked_tenant_within_its_slo():
    got = _revoke_ladder("torch")
    assert got == _revoke_ladder("jax")
    assert got == (True, ["ckpt", "revoke", "drain_host", "shutdown"],
                   1.0, 1.0, 1.0)


def _blown(pkg):
    guard_cls, metrics_cls, _ = GUARDS[pkg]
    now = [0.0]
    calls = []

    def slow_ckpt():
        calls.append("ckpt")
        now[0] += 100.0  # the checkpoint ate the whole budget

    class FakeAdmission:
        def revoke_inflight(self, slo_s):
            calls.append("revoke")

    m = metrics_cls()
    g = guard_cls(deadline_s=30.0, admission=FakeAdmission(), metrics=m,
                  clock=lambda: now[0])
    g.notify("test")
    ok = g.drain(final_checkpoint=slow_ckpt,
                 shutdown=lambda: calls.append("shutdown"))
    return (ok, calls, m.counter("resilience.drain_rungs_skipped"),
            m.gauge("resilience.drain_within_deadline"))


def test_blown_deadline_skips_hygiene_keeps_checkpoint():
    got = _blown("torch")
    assert got == _blown("jax")
    assert got[:2] == (False, ["ckpt"]) and got[2] >= 1


@pytest.mark.parametrize("value", ["12.5", "1", "no", "yes", "0", "off", ""])
def test_env_notice_carries_deadline(monkeypatch, value):
    out = {}
    for pkg, (guard_cls, metrics_cls, env) in GUARDS.items():
        g = guard_cls(deadline_s=30.0, metrics=metrics_cls())
        monkeypatch.setenv(env, value)
        out[pkg] = (g.poll(), g.pending, g.deadline_s)
    assert out["torch"] == out["jax"]
    if value == "12.5":
        assert out["torch"] == (True, True, 12.5)


def test_deadline_knob_and_bad_deadline(monkeypatch):
    monkeypatch.setenv("DDL_TORCH_PREEMPT_DEADLINE_S", "7.5")
    assert PreemptionGuard(metrics=Metrics()).deadline_s == 7.5
    from ddl_tpu_torch.exceptions import DDLError

    with pytest.raises(DDLError, match="> 0"):
        PreemptionGuard(deadline_s=0.0)


def test_signal_install_uninstall_restores_handler():
    prev = signal.getsignal(signal.SIGTERM)
    g = PreemptionGuard(deadline_s=5.0, metrics=Metrics())
    with g:
        assert signal.getsignal(signal.SIGTERM) == g._on_sigterm
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while not g.pending and time.monotonic() < deadline:
            time.sleep(0.01)
        assert g.pending
    assert signal.getsignal(signal.SIGTERM) == prev


# -- drain on notice, end to end --------------------------------------------------

CFG = tllama.LlamaConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=64, max_seq=16,
                         dtype=torch.float32)
N = 6  # windows (== epochs) of the undisturbed run


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tok") / "tokens.bin")
    np.random.default_rng(8).integers(0, 64, 20_000,
                                      dtype=np.int32).tofile(path)
    return path


def _trainer(ckpt_dir, guard=None, metrics=None, **kw):
    return Trainer(
        loss_fn=lambda p, b: tllama.next_token_loss(p, b[0], CFG),
        optimizer=adamw(3e-3),
        init_params=tllama.init_params(CFG, seed=1, device="cpu"),
        device="cpu", metrics=metrics or Metrics(),
        checkpoint_dir=ckpt_dir, preemption_guard=guard, **kw,
    )


def _run_fit(token_file, ckpt_dir, mode="thread", guard=None, notify_at=None,
             metrics=None, **kw):
    """One window-streamed fit recording each served window's CRC; the
    hook raises the notice while window ``notify_at`` is in hand, so the
    drain follows that window's steps."""
    crcs = []

    def hook(win):
        crcs.append(zlib.crc32(win.numpy().tobytes()))
        if notify_at is not None and len(crcs) == notify_at:
            guard.notify("test")
        return win

    trainer = _trainer(ckpt_dir, guard=guard, metrics=metrics, **kw)
    res = trainer.fit(TokenStreamProducer(token_file, 16, 8, seed=2),
                      batch_size=4, n_epochs=N, n_producers=2, mode=mode,
                      window_stream=True, window_hook=hook)
    return res, crcs


def _params(state):
    return [p.detach().numpy().copy() for p in tree_leaves(state.params)]


@pytest.mark.parametrize("mode,drained_at", [("thread", 4), ("process", 2)])
def test_notice_drains_and_resumes_byte_identical(tmp_path, token_file, mode,
                                                  drained_at):
    ref, ref_crcs = _run_fit(token_file, None, mode=mode)
    m_b = Metrics()
    guard = PreemptionGuard(deadline_s=60.0, metrics=m_b)
    ckpt = str(tmp_path / "ckpt")
    res_b, crcs_b = _run_fit(token_file, ckpt, mode=mode, guard=guard,
                             notify_at=drained_at, metrics=m_b,
                             checkpoint_every_epochs=100)
    assert res_b.preempted and guard.drained
    assert len(crcs_b) == drained_at and res_b.epochs_run == drained_at
    assert res_b.losses == ref.losses[:drained_at]
    assert m_b.counter("resilience.final_ckpts") == 1
    assert m_b.counter("watchdog.failures") == 0
    assert m_b.gauge("resilience.drain_within_deadline") == 1.0
    assert [s for s, _ in list_generations(ckpt)] == [drained_at * 2]

    m_c = Metrics()
    res_c, crcs_c = _run_fit(token_file, ckpt, mode=mode, metrics=m_c)
    assert res_c.resumed_from_epoch == drained_at and not res_c.preempted
    assert m_c.counter("resilience.ckpt_restores") == 1
    assert crcs_b + crcs_c == ref_crcs
    assert res_b.losses + res_c.losses == ref.losses
    assert res_c.state.step == ref.state.step
    assert all(np.array_equal(a, b)
               for a, b in zip(_params(res_c.state), _params(ref.state)))


def test_sigterm_mid_fit_thread_mode(tmp_path, token_file):
    guard = PreemptionGuard(deadline_s=60.0, metrics=Metrics())
    crcs = []

    def hook(win):
        crcs.append(win)
        if len(crcs) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return win

    with guard:
        res = _trainer(str(tmp_path / "ckpt"), guard=guard).fit(
            TokenStreamProducer(token_file, 16, 8, seed=2), batch_size=4,
            n_epochs=N, n_producers=2, window_stream=True, window_hook=hook)
    assert res.preempted and len(res.losses) == 3
    res_c = _trainer(str(tmp_path / "ckpt")).fit(
        TokenStreamProducer(token_file, 16, 8, seed=2), batch_size=4,
        n_epochs=N, n_producers=2, window_stream=True)
    assert res_c.resumed_from_epoch == 3 and len(res_c.losses) == N - 3


def test_env_notice_drains_first_boundary(tmp_path, token_file, monkeypatch):
    m = Metrics()
    guard = PreemptionGuard(deadline_s=60.0, metrics=m)
    monkeypatch.setenv("DDL_TORCH_PREEMPT_NOTICE", "1")
    res, crcs = _run_fit(token_file, str(tmp_path / "ckpt"), guard=guard,
                         metrics=m)
    assert res.preempted and len(crcs) == 1
    assert m.counter("resilience.notices") == 1


@pytest.mark.parametrize("window_stream", [True, False])
def test_sync_checkpoint_trainer_drains_too(tmp_path, token_file,
                                            window_stream):
    """The synchronous checkpoint path honours the guard (window stream
    and the batch path's epoch boundary), and the resumed run ends where
    an undisturbed one does."""
    def fit(guard=None, hook=None):
        kw = dict(window_hook=hook) if window_stream else {}
        return _trainer(str(tmp_path / "ckpt"), guard=guard,
                        checkpoint_async=False).fit(
            TokenStreamProducer(token_file, 16, 8, seed=2), batch_size=4,
            n_epochs=N, n_producers=2, window_stream=window_stream, **kw)

    ref = _trainer(None).fit(
        TokenStreamProducer(token_file, 16, 8, seed=2), batch_size=4,
        n_epochs=N, n_producers=2, window_stream=window_stream)
    guard = PreemptionGuard(deadline_s=60.0, metrics=Metrics())
    if not window_stream:
        guard.notify("test")  # drained at the first epoch boundary
    seen = []

    def hook(win):
        seen.append(1)
        if len(seen) == 3:
            guard.notify("test")
        return win

    res_b = fit(guard, hook)
    drained_at = len(res_b.losses)
    assert res_b.preempted and drained_at == (3 if window_stream else 1)
    assert tckpt.latest_verified_step(str(tmp_path / "ckpt")) == drained_at * 2
    res_c = fit()
    assert res_c.resumed_from_epoch == drained_at
    np.testing.assert_array_equal(res_b.losses + res_c.losses, ref.losses)


def test_async_and_sync_checkpoints_restore_identically(tmp_path, token_file):
    _run_fit(token_file, str(tmp_path / "a"), checkpoint_every_epochs=3)
    _run_fit(token_file, str(tmp_path / "s"), checkpoint_every_epochs=3,
             checkpoint_async=False)
    gen = latest_verified_generation(str(tmp_path / "a"))
    assert gen is not None and gen[0] == N * 2
    like_a = _trainer(None)._init_fn(tllama.init_params(CFG, 5, device="cpu"))
    like_s = _trainer(None)._init_fn(tllama.init_params(CFG, 5, device="cpu"))
    a = restore_latest(str(tmp_path / "a"), like=like_a).state
    s = tckpt.restore_train_state(str(tmp_path / "s"), like=like_s)
    assert a.step == s.step == N * 2
    assert all(np.array_equal(x, y) for x, y in zip(_params(a), _params(s)))
    for pa, ps in zip(tree_leaves(a.params), tree_leaves(s.params)):
        sa, ss = a.optimizer.state[pa], s.optimizer.state[ps]
        assert float(sa["step"]) == float(ss["step"])
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[key], ss[key])
