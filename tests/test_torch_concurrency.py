"""The port's lock-order sanitizer against the JAX package's.

- The reference's sanitizer scenarios (``tests/test_verify.py``
  ``TestSanitizer``) run through both packages and give the same
  violations, held stacks and edges: a two-thread inversion, strict
  mode, re-entrancy and condition waits, the disarmed raw primitives.
- One armed run drives the port's threads end to end — a THREAD fit with
  async checkpoints (their writer flushed), a PROCESS fit, and a THREAD
  stream whose corrupt window is quarantined and replayed — with no
  violation, and every observed edge in ``LOCK_ORDER``'s direction; a
  deliberate inversion of two real names under the same sanitizer is
  caught.
"""

import threading

import numpy as np
import pytest
import torch

from ddl_tpu import concurrency as jcon
from ddl_tpu_torch import concurrency as tcon
from ddl_tpu_torch.models import llama as tllama
from ddl_tpu_torch.observability import Metrics
from ddl_tpu_torch.parallel.train import adamw
from ddl_tpu_torch.readers import TokenStreamProducer
from ddl_tpu_torch.trainer import Trainer


def _inversion(con):
    with con.sanitized(order=("outer", "inner")) as san:
        lo, li = con.named_lock("outer"), con.named_lock("inner")
        a_done = threading.Event()

        def compliant():
            with lo:
                with li:
                    pass
            a_done.set()

        def inverted():
            a_done.wait(5.0)
            with li:
                with lo:
                    pass

        ta = threading.Thread(target=compliant, name="compliant")
        tb = threading.Thread(target=inverted, name="inverted")
        ta.start(), tb.start()
        ta.join(5.0), tb.join(5.0)
    return san.violations, sorted(san.edges)


def _strict(con):
    with con.sanitized(order=("outer", "inner"), strict=True) as san:
        lo, li = con.named_lock("outer"), con.named_lock("inner")
        with li:
            with pytest.raises(con.LockOrderViolation):
                lo.acquire()
    return san.violations, sorted(san.edges)


def _reentrant(con):
    with con.sanitized(order=("outer", "inner")) as san:
        rl = con.named_rlock("outer")
        cv = con.named_condition("inner")
        with rl:
            with rl:
                with cv:
                    cv.wait(0.01)
                    stack = tuple(san._stack())
        return san.violations, sorted(san.edges), stack


@pytest.mark.parametrize("scenario", [_inversion, _strict, _reentrant])
def test_scenarios_match_the_reference(scenario):
    want = scenario(jcon)
    got = scenario(tcon)
    assert got == want
    assert tcon.armed_sanitizer() is None


def test_inversion_names_pair_thread_and_stack():
    violations, edges = _inversion(tcon)
    assert violations == [("outer", "inner", "inverted", ("inner",))]
    assert ("outer", "inner") in edges


def test_disarmed_factories_return_raw_primitives():
    assert tcon.armed_sanitizer() is None
    assert type(tcon.named_lock("staging.pool")) is type(threading.Lock())
    assert type(tcon.named_rlock("resilience.guard")) is type(threading.RLock())
    assert type(tcon.named_condition("resilience.ckpt.cv")) is threading.Condition
    with pytest.raises(ValueError, match="LOCK_ORDER"):
        tcon.named_lock("not.a.lock")


def test_slice_locks_rank_as_in_the_reference():
    """The cluster control plane's locks come first, the guard ranks
    above the connection, the checkpoint writer's condition between the
    connection and the staging queue."""
    for con in (jcon, tcon):
        r = {n: i for i, n in enumerate(con.LOCK_ORDER)}
        assert (r["cluster.supervisor"] == 0 and r["cluster.membership"] == 1)
        assert (r["cluster.membership"] < r["resilience.guard"]
                < r["transport.connection"] < r["resilience.ckpt.cv"]
                < r["staging.executor.cv"])


CFG = tllama.LlamaConfig(vocab=64, d_model=32, n_layers=1, n_heads=4,
                         n_kv_heads=2, d_ff=64, max_seq=16,
                         dtype=torch.float32)


def _fit(path, mode, ckpt_dir=None):
    trainer = Trainer(
        loss_fn=lambda p, b: tllama.next_token_loss(p, b[0], CFG),
        optimizer=adamw(1e-3),
        init_params=tllama.init_params(CFG, seed=0, device="cpu"),
        device="cpu", metrics=Metrics(), checkpoint_dir=ckpt_dir,
        checkpoint_async=True,
    )
    built = []
    build = trainer._checkpointer

    def checkpointer():
        built.append(build())
        return built[-1]

    trainer._checkpointer = checkpointer
    res = trainer.fit(TokenStreamProducer(path, 16, 8), batch_size=4,
                      n_epochs=3, n_producers=2, mode=mode,
                      window_stream=True)
    return res, trainer, built


def test_armed_run_of_the_slice_threads_is_inversion_free(tmp_path):
    from test_torch_replay import TorchTokens, _stream, corrupt_commits

    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(3).integers(0, 64, 5_000,
                                      dtype=np.int32).tofile(path)
    with tcon.sanitized() as san:
        res, trainer, built = _fit(path, "thread", str(tmp_path / "ckpt"))
        assert res.metrics.counter("resilience.ckpts") == 3
        assert np.isfinite(res.losses).all()
        # The writer's condition was built armed: its waits were watched.
        # The fit closed the writer at its end, releasing its staging.
        assert built and all(isinstance(cp._cond, tcon._SanitizedCondition)
                             for cp in built)
        assert trainer._ckptr is None and built[0]._closed
        res, _, _ = _fit(path, "process")
        assert len(res.losses) == 3
        with corrupt_commits("torch", producer=2, seq=1) as fired:
            _, m = _stream("torch", TorchTokens(path, 16, 8, seed=3))
        assert fired == [1] and m.counter("integrity.replays") == 1
        assert san.n_acquisitions > 0, "armed run watched no locks"
        assert san.violations == [], san.violations
        for top, name in san.edges:
            assert tcon._RANK[top] <= tcon._RANK[name], (top, name)
        conn = tcon.named_lock("transport.connection")
        ring = tcon.named_condition("transport.ring.cond")
        with ring:
            with conn:
                pass
        assert any(v[:2] == ("transport.connection", "transport.ring.cond")
                   for v in san.violations)
