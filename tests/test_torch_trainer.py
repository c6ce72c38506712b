"""The slice end to end: the port's ``Trainer.fit`` against the JAX
package's, from the same params, data and hyper-parameters.

A 2-layer fp32 Llama trained over a THREAD-mode ``TokenStreamProducer``
window stream (2 producers, 2 optimizer steps per window) with AdamW at
optax's hyper-parameters.  Per-window losses agree within ``rtol 1e-4``
(same data — the streams are byte-identical — and the same math; matmul
summation order differs).  The port's fused and synchronous loops give
bit-equal losses, as the JAX package's do.  The packed-document fit —
``PackedTokenProducer`` feeding ``next_token_loss(..., segment_ids=b[1])``
over the same window stream — is held to the JAX trainer the same way.
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
from ddl_tpu_torch.config import LoaderConfig, TrainConfig
from ddl_tpu_torch.models import llama as tllama
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


def _torch_fit(path, params, **fit_kw):
    trainer = Trainer(
        loss_fn=lambda p, b: tllama.next_token_loss(p, b[0], TCFG),
        optimizer=adamw(LR),
        init_params=tllama.params_from_numpy(params, device="cpu"),
        device="cpu",
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
