"""The slice end to end: the port's ``Trainer.fit`` against the JAX
package's, from the same params, data and hyper-parameters.

A 2-layer fp32 Llama trained over a THREAD-mode ``TokenStreamProducer``
window stream (2 producers, 2 optimizer steps per window) with AdamW at
optax's hyper-parameters.  Per-window losses agree within ``rtol 1e-4``
(same data — the streams are byte-identical — and the same math; matmul
summation order differs).  The port's fused and synchronous loops give
bit-equal losses, as the JAX package's do.  The packed-document fit —
``PackedTokenProducer`` feeding ``next_token_loss(..., segment_ids=b[1])``
over the same window stream — is held to the JAX trainer the same way,
and so is ``Trainer.evaluate`` on both of its routes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ddl_tpu.config import LoaderConfig as JaxLoaderConfig
from ddl_tpu.models import llama as jllama
from ddl_tpu.parallel.mesh import make_mesh
from ddl_tpu.readers import PackedTokenProducer as JaxPacked
from ddl_tpu.readers import TokenStreamProducer as JaxTokens
from ddl_tpu.trainer import Trainer as JaxTrainer
from ddl_tpu_torch import trainer as trainer_mod
from ddl_tpu_torch.config import LoaderConfig, TrainConfig
from ddl_tpu_torch.models import llama as tllama
from ddl_tpu_torch.observability import Metrics
from ddl_tpu_torch.parallel.train import adamw
from ddl_tpu_torch.readers import PackedTokenProducer as TorchPacked
from ddl_tpu_torch.readers import TokenStreamProducer as TorchTokens
from ddl_tpu_torch.trainer import Trainer

SEQ, ROWS, BATCH, EPOCHS, LR = 32, 8, 4, 3, 3e-3
JCFG = jllama.LlamaConfig(vocab=96, d_model=32, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=64, max_seq=SEQ,
                          dtype=jnp.float32)
TCFG = tllama.LlamaConfig(vocab=96, d_model=32, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=64, max_seq=SEQ,
                          dtype=torch.float32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = os.path.join(tmp_path_factory.mktemp("tok"), "tokens.bin")
    np.random.default_rng(2).integers(0, JCFG.vocab, 20_000,
                                      dtype=np.int32).tofile(path)
    params = jax.tree.map(np.asarray, jllama.init_params(JCFG, jax.random.key(1)))
    return path, params


def _torch_fit(path, params, metrics=None, **fit_kw):
    trainer = Trainer(
        loss_fn=lambda p, b: tllama.next_token_loss(p, b[0], TCFG),
        optimizer=adamw(LR),
        init_params=tllama.params_from_numpy(params, device="cpu"),
        device="cpu",
        metrics=metrics,
    )
    cfg = LoaderConfig(batch_size=BATCH, n_epochs=EPOCHS, n_producers=2,
                       window_stream=fit_kw.pop("window_stream", True))
    return trainer.fit(TorchTokens(path, SEQ, ROWS), config=cfg, **fit_kw)


def test_window_stream_losses_track_jax_trainer(setup):
    path, params = setup
    jtrainer = JaxTrainer(
        loss_fn=lambda p, b: jllama.next_token_loss(p, b[0], JCFG),
        optimizer=optax.adamw(LR),
        mesh=make_mesh({"dp": 1}, devices=jax.local_devices()[:1]),
        param_specs=jllama.param_specs(JCFG),
        init_params=jax.tree.map(jnp.asarray, params),
        batch_spec=P(("dp",)),
    )
    want = jtrainer.fit(
        JaxTokens(path, SEQ, ROWS),
        config=JaxLoaderConfig(batch_size=BATCH, n_epochs=EPOCHS,
                               n_producers=2, window_stream=True),
    ).losses
    res = _torch_fit(path, params, stream_lookahead=2)
    assert len(res.losses) == len(want) == EPOCHS
    np.testing.assert_allclose(res.losses, want, rtol=1e-4)
    assert res.state.step == EPOCHS * ROWS // BATCH
    assert res.metrics.counter("trainer.fused_windows") == EPOCHS


def test_fused_and_sync_loops_give_equal_losses(setup):
    path, params = setup
    fused = _torch_fit(path, params, fused=True).losses
    sync = _torch_fit(path, params, fused=False).losses
    assert fused == sync
    assert all(np.isfinite(fused))


class _FakeEvents:
    """Stands in for the trainer's ``done_event``: one fake event a
    window, numbered from 0, each logging ``(call, window, events made
    so far)`` for every ``query()`` and ``synchronize()``.  ``query()``
    reads not ready for the windows in ``busy`` (steps still on the
    card)."""

    def __init__(self, busy=()):
        self.busy, self.log, self.made = set(busy), [], 0

    def __call__(self, device):
        k, self.made = self.made, self.made + 1
        events = self

        class Event:
            def query(self):
                events.log.append(("query", k, events.made))
                return k not in events.busy

            def synchronize(self):
                events.log.append(("synchronize", k, events.made))

        return Event()

    def calls(self, name):
        return [(k, made) for call, k, made in self.log if call == name]


def test_fused_read_waits_on_the_previous_window_event(setup, monkeypatch):
    """Each window's read waits on its own event once, after the next
    window's steps were dispatched (its event made), and never on the
    event of the window just dispatched; the losses are the synchronous
    loop's."""
    path, params = setup
    sync = _torch_fit(path, params, fused=False).losses
    events = _FakeEvents()
    monkeypatch.setattr(trainer_mod, "done_event", events)
    assert _torch_fit(path, params, fused=True).losses == sync
    assert events.made == EPOCHS
    waits = events.calls("synchronize")
    assert [k for k, _ in waits] == list(range(EPOCHS))
    # Window k's read comes after window k+1's dispatch; the last read
    # follows the loop.
    assert [made for _, made in waits] == (
        [k + 2 for k in range(EPOCHS - 1)] + [EPOCHS])
    # The overlap probe asks about the previous window only.
    assert all(k == made - 1 for k, made in events.calls("query"))


@pytest.mark.parametrize("busy,overlapped", [
    ((), 0), ((1,), 1), (tuple(range(EPOCHS)), EPOCHS - 1)])
def test_overlapped_windows_counts_acquires_under_running_steps(
        setup, monkeypatch, busy, overlapped):
    """``trainer.overlapped_windows`` counts the windows whose acquire
    found the previous window's event not ready (the stream's end is no
    window), beside the ``trainer.ingest_overlap`` time."""
    path, params = setup
    monkeypatch.setattr(trainer_mod, "done_event", _FakeEvents(busy))
    m = Metrics()
    res = _torch_fit(path, params, metrics=m, fused=True)
    assert len(res.losses) == EPOCHS
    assert m.counter("trainer.overlapped_windows") == overlapped
    assert m.counter("trainer.fused_windows") == EPOCHS
    assert (m.timer("trainer.ingest_overlap").count > 0) == bool(busy)


def test_batch_fit_matches_window_stream(setup):
    """Per-batch fit (the prefetcher path) runs the same optimizer-step
    sequence as the window stream."""
    path, params = setup
    stream = _torch_fit(path, params).losses
    batch = _torch_fit(path, params, window_stream=False, prefetch_depth=2).losses
    np.testing.assert_allclose(batch, stream, rtol=1e-6)


def test_accum_steps_average_microbatch_grads(setup):
    """accum_steps=2 from TrainConfig: the same loss sequence within fp32
    rounding (the mean loss's gradient is the mean of the halves')."""
    path, params = setup
    plain = _torch_fit(path, params).losses
    trainer = Trainer(
        loss_fn=lambda p, b: tllama.next_token_loss(p, b[0], TCFG),
        optimizer=adamw(LR),
        init_params=tllama.params_from_numpy(params, device="cpu"),
        device="cpu",
        train_config=TrainConfig(accum_steps=2),
    )
    res = trainer.fit(TorchTokens(path, SEQ, ROWS), config=LoaderConfig(
        batch_size=BATCH, n_epochs=EPOCHS, n_producers=2, window_stream=True))
    np.testing.assert_allclose(res.losses, plain, rtol=1e-4)


PACKED = jllama.LlamaConfig(vocab=64, d_model=64, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=128, max_seq=SEQ,
                            dtype=jnp.float32)
TPACKED = tllama.LlamaConfig(vocab=64, d_model=64, n_layers=2, n_heads=4,
                             n_kv_heads=2, d_ff=128, max_seq=SEQ,
                             dtype=torch.float32)


@pytest.fixture(scope="module")
def packed_setup(tmp_path_factory):
    """Documents of 4-29 tokens, each closed by the delimiter 0."""
    rng = np.random.default_rng(4)
    docs = [rng.integers(1, 60, size=int(n)).tolist() + [0]
            for n in rng.integers(4, 30, size=400)]
    path = os.path.join(tmp_path_factory.mktemp("pack"), "pack.bin")
    np.asarray([t for d in docs for t in d], np.int32).tofile(path)
    params = jax.tree.map(np.asarray, jllama.init_params(PACKED, jax.random.key(0)))
    return path, params


def _torch_packed_fit(path, params, **fit_kw):
    trainer = Trainer(
        loss_fn=lambda p, b: tllama.next_token_loss(p, b[0], TPACKED,
                                                    segment_ids=b[1]),
        optimizer=adamw(LR),
        init_params=tllama.params_from_numpy(params, device="cpu"),
        device="cpu",
    )
    return trainer.fit(
        TorchPacked(path, SEQ, ROWS, delimiter=0),
        config=LoaderConfig(batch_size=BATCH, n_epochs=EPOCHS, n_producers=2,
                            window_stream=True),
        **fit_kw)


def test_packed_window_stream_losses_track_jax_trainer(packed_setup):
    path, params = packed_setup
    jtrainer = JaxTrainer(
        loss_fn=lambda p, b: jllama.next_token_loss(p, b[0], PACKED,
                                                    segment_ids=b[1]),
        optimizer=optax.adamw(LR),
        mesh=make_mesh({"dp": 1}, devices=jax.local_devices()[:1]),
        param_specs=jllama.param_specs(PACKED),
        init_params=jax.tree.map(jnp.asarray, params),
        batch_spec=P(("dp",)),
    )
    want = jtrainer.fit(
        JaxPacked(path, SEQ, ROWS, delimiter=0),
        config=JaxLoaderConfig(batch_size=BATCH, n_epochs=EPOCHS,
                               n_producers=2, window_stream=True),
    ).losses
    res = _torch_packed_fit(path, params)
    assert len(res.losses) == len(want) == EPOCHS
    np.testing.assert_allclose(res.losses, want, rtol=1e-4)
    assert res.state.step == EPOCHS * ROWS // BATCH


def test_packed_fused_and_sync_loops_give_equal_losses(packed_setup):
    path, params = packed_setup
    fused = _torch_packed_fit(path, params, fused=True).losses
    sync = _torch_packed_fit(path, params, fused=False).losses
    assert fused == sync
    assert all(np.isfinite(fused))


# -- Trainer.evaluate ---------------------------------------------------------


@pytest.mark.parametrize("window_stream", [True, False])
def test_evaluate_matches_jax_trainer(setup, window_stream):
    """Both routes — each window's batches in one pass (weighted by batch
    count), and per batch through the prefetcher — on a held-out stream
    (another seed), from the same params: rtol 1e-4 against the JAX
    package's ``evaluate``; under ``no_grad`` no autograd graph is kept."""
    path, params = setup
    jtrainer = JaxTrainer(
        loss_fn=lambda p, b: jllama.next_token_loss(p, b[0], JCFG),
        optimizer=optax.adamw(LR),
        mesh=make_mesh({"dp": 1}, devices=jax.local_devices()[:1]),
        param_specs=jllama.param_specs(JCFG),
        init_params=jax.tree.map(jnp.asarray, params),
        batch_spec=P(("dp",)),
    )
    want = jtrainer.evaluate(
        JaxTokens(path, SEQ, ROWS, seed=9), jtrainer._init_fn(
            jtrainer._init_params),
        lambda p, b: jllama.next_token_loss(p, b[0], JCFG),
        batch_size=BATCH, n_producers=2, n_epochs=4,
        output="jax" if window_stream else "numpy",
        window_stream=window_stream,
    )
    trainer = Trainer(
        loss_fn=lambda p, b: tllama.next_token_loss(p, b[0], TCFG),
        optimizer=adamw(LR),
        init_params=tllama.params_from_numpy(params, device="cpu"),
        device="cpu",
    )
    grads = []

    def metric(p, b):
        loss = tllama.next_token_loss(p, b[0], TCFG)
        grads.append(loss.requires_grad)
        return loss

    got = trainer.evaluate(
        TorchTokens(path, SEQ, ROWS, seed=9), trainer._init_fn(
            trainer._init_params), metric,
        batch_size=BATCH, n_producers=2, n_epochs=4,
        window_stream=window_stream,
    )
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert len(grads) == 4 * ROWS // BATCH and not any(grads)


# -- the mesh path --------------------------------------------------------------


def _mesh_fit(path, params, mesh, n_epochs=EPOCHS, train_config=None,
              checkpoint_dir=None, **fit_kw):
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.parallel.mesh import P as TP

    trainer = Trainer(
        lambda p, b: tllama.next_token_loss(p, b[0], TCFG, mesh=mesh),
        adamw(LR), tllama.params_from_numpy(params, device="cpu"),
        device="cpu", metrics=Metrics(), train_config=train_config,
        checkpoint_dir=checkpoint_dir, mesh=mesh,
        param_specs=tllama.param_specs(TCFG), batch_spec=TP("dp", "sp"),
    )
    return trainer.fit(TorchTokens(path, SEQ, ROWS), config=LoaderConfig(
        batch_size=BATCH, n_epochs=n_epochs, n_producers=2,
        window_stream=True), **fit_kw)


def test_mesh_fit_tracks_jax_trainer(setup):
    """``Trainer(..., mesh=, param_specs=, batch_spec=)`` over dp=2 x sp=2
    positions of the CPU — windows landed sharded over ``P(None, "dp",
    "sp")``, ring attention over sp — against the JAX package's Trainer
    over the same mesh of virtual devices: per-window losses at rtol
    1e-4, and equal to the port's own one-device fit."""
    from ddl_tpu_torch.parallel.mesh import make_mesh as torch_mesh

    path, params = setup
    jmesh = make_mesh({"dp": 2, "sp": 2}, devices=jax.devices()[:4])
    jtrainer = JaxTrainer(
        loss_fn=lambda p, b: jllama.next_token_loss(p, b[0], JCFG, mesh=jmesh),
        optimizer=optax.adamw(LR), mesh=jmesh,
        param_specs=jllama.param_specs(JCFG),
        init_params=jax.tree.map(jnp.asarray, params),
        batch_spec=P("dp", "sp"),
    )
    want = jtrainer.fit(
        JaxTokens(path, SEQ, ROWS),
        config=JaxLoaderConfig(batch_size=BATCH, n_epochs=EPOCHS,
                               n_producers=2, window_stream=True),
    ).losses
    res = _mesh_fit(path, params, torch_mesh({"dp": 2, "sp": 2}, ["cpu"] * 4))
    assert len(res.losses) == len(want) == EPOCHS
    np.testing.assert_allclose(res.losses, want, rtol=1e-4)
    assert res.state.step == EPOCHS * ROWS // BATCH
    assert res.metrics.counter("consumer.windows") == EPOCHS
    plain = _torch_fit(path, params).losses
    np.testing.assert_allclose(res.losses, plain, rtol=1e-5)


def test_zero1_checkpoint_resumes_bit_equal(setup, tmp_path):
    """A ZeRO-1 fit over dp=2 x sp=2 stopped after 2 windows (async
    generations carry the sharded state's whole moments) and resumed by a
    fresh Trainer: the two runs' losses concatenate to an undisturbed
    run's bit for bit."""
    from ddl_tpu_torch.parallel.mesh import make_mesh as torch_mesh
    from ddl_tpu_torch.parallel.optimizer import Zero1Optimizer

    path, params = setup
    mesh = torch_mesh({"dp": 2, "sp": 2}, ["cpu"] * 4)
    z1 = TrainConfig(optimizer_sharding="zero1")
    full = _mesh_fit(path, params, mesh, train_config=z1)
    assert isinstance(full.state.optimizer, Zero1Optimizer)
    ckpt = str(tmp_path / "ckpt")
    first = _mesh_fit(path, params, mesh, n_epochs=2, train_config=z1,
                      checkpoint_dir=ckpt)
    second = _mesh_fit(path, params, mesh, train_config=z1,
                       checkpoint_dir=ckpt)
    assert second.resumed_from_epoch == 2
    assert first.losses + second.losses == full.losses
