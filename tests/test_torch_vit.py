"""The port's Vision Transformer (``ddl_tpu_torch/models/vit.py``) against
the JAX package's ``ddl_tpu/models/vit.py``, from the same numpy weights
and pixels.

Twins ``tests/test_models_train.py``'s ViT class (forward, flash against
dense, a mesh fit, the WebDataset fit), ``tests/test_pipeline.py``'s ViT
class and ``tests/test_trainer.py``'s ``evaluate`` pass.  Tolerances in
fp32: logits 2e-5 (the flash path's plain version 2e-4, as the JAX
package holds its flash kernel), gradients 1e-4 relative, train-step
losses rtol 1e-4, accuracy exactly.  Non-causal attention at ViT-B/16's
sequence length (T = 196, H = Hkv, D = 64) goes through the port's flash
path (its plain version on the CPU) against the JAX package's dense
attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from ddl_tpu.models import vit as jv
from ddl_tpu.parallel.mesh import make_mesh as jmesh
from ddl_tpu.parallel.train import make_train_step as jstep
from ddl_tpu_torch.models import vit as tv
from ddl_tpu_torch.parallel.mesh import P, make_mesh
from ddl_tpu_torch.parallel.train import adamw, make_train_step

ATOL = 2e-5


def tmesh(axes):
    return make_mesh(axes, ["cpu"] * int(np.prod(list(axes.values()))))


def _cfgs(**kw):
    base = dict(image_size=16, patch_size=4, d_model=32, n_layers=2, n_heads=2,
                d_ff=64, n_classes=5)
    base.update(kw)
    return (jv.ViTConfig(**base, dtype=jnp.float32),
            tv.ViTConfig(**base, dtype=torch.float32))


def _params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jax.jit(jv.init_params, static_argnums=0)(
        jcfg, jax.random.key(seed)))


def _tp(np_params, grad=False):
    p = tv.params_from_numpy(np_params, device="cpu")
    return jax.tree.map(lambda t: t.requires_grad_(True), p) if grad else p


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _adam(lr):
    """``optax.adam`` as the port's factory (AdamW without decay)."""
    return adamw(lr, weight_decay=0.0)


def test_forward_shapes_and_finite():
    """Image and flat-row inputs give the same logits, the JAX package's."""
    jcfg, tcfg = _cfgs()
    params = _params(jcfg)
    imgs = np.random.default_rng(1).random((3, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        logits = tv.forward(_tp(params), torch.tensor(imgs), tcfg)
        flat = tv.forward(_tp(params), torch.tensor(imgs.reshape(3, -1)), tcfg)
    assert tuple(logits.shape) == (3, 5) and torch.isfinite(logits).all()
    assert torch.equal(flat, logits)
    want = jax.jit(lambda p, x: jv.forward(p, x, jcfg))(params, imgs)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=ATOL)


def test_flash_matches_dense():
    """The flash path (its plain version on the CPU) against the dense
    path, and both against the JAX package's dense forward."""
    jcfg, tcfg = _cfgs(attn_impl="dense")
    params = _params(jcfg)
    imgs = np.random.default_rng(2).random((2, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        dense = tv.forward(_tp(params), torch.tensor(imgs), tcfg)
        flash = tv.forward(_tp(params), torch.tensor(imgs),
                           tv.ViTConfig(**{**tcfg.__dict__, "attn_impl": "flash"}))
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), atol=2e-4, rtol=2e-4)
    want = jax.jit(lambda p, x: jv.forward(p, x, jcfg))(params, imgs)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("B,T,H,D", [(2, 196, 12, 64), (1, 196, 4, 128),
                                     (2, 60, 3, 64)])
def test_noncausal_flash_path_matches_jax_dense(B, T, H, D):
    """Non-causal attention at ViT-B/16's sequence length (T = 196 patches,
    H = Hkv): the port's flash wrapper (the plain version for CPU tensors,
    the kernels K1-K3 on the card) against the JAX package's dense
    attention — outputs at 2e-5, the gradients of a weighted sum at 1e-4
    relative."""
    from ddl_tpu.parallel.ring_attention import attention as jattn
    from ddl_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(B * T + H)
    q, k, v, w = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                  for _ in range(4))

    def jloss(q, k, v):
        out = jattn(q, k, v, impl="dense", causal=False)
        return (out * w).sum(), out

    (_, want), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                               has_aux=True))(q, k, v)
    tq, tk, tvv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_attention(tq, tk, tvv, causal=False)
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=ATOL)
    for t, g in zip((tq, tk, tvv), jg):
        assert _rel(t.grad.numpy(), g) < 1e-4


def test_vit_b16_sequence_through_the_flash_path():
    """A ViT on 224x224 images in 16x16 patches (196 tokens, head_dim 64,
    narrow and one layer) through the port's flash path against the JAX
    package's dense forward, and its gradients."""
    jcfg, tcfg = _cfgs(image_size=224, patch_size=16, d_model=128, n_layers=1,
                       n_heads=2, d_ff=128, n_classes=10)
    params = _params(jcfg)
    imgs = np.random.default_rng(3).random((2, 224 * 224 * 3)).astype(np.float32)
    labels = np.array([[3.0], [7.0]], np.float32)
    tflash = tv.ViTConfig(**{**tcfg.__dict__, "attn_impl": "flash"})
    tp = _tp(params, grad=True)
    loss = tv.classification_loss(tp, (torch.tensor(imgs), torch.tensor(labels)),
                                  tflash)
    loss.backward()
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jv.classification_loss(
        p, (imgs, labels), jcfg)))(params)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    jax.tree.map(lambda t, g: np.testing.assert_array_less(
        _rel(t.grad.numpy(), g), 1e-4), tp, jg)


def test_param_specs_and_stage_layout_mirror_jax():
    jcfg, tcfg = _cfgs(n_layers=4)
    is_p = lambda x: isinstance(x, (P, JP))  # noqa: E731
    assert (jax.tree.map(tuple, tv.param_specs(tcfg), is_leaf=is_p)
            == jax.tree.map(tuple, jv.param_specs(jcfg), is_leaf=is_p))
    assert ({k: tuple(v) for k, v in tv.pp_param_specs(tcfg)["stages"].items()}
            == {k: tuple(v) for k, v in jv.pp_param_specs(jcfg)["stages"].items()})
    params = _params(jcfg)
    shapes = jax.tree.map(lambda t: tuple(t.shape), tv.param_shapes(tcfg))
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), params)
    staged = tv.stage_params(_tp(params), 2)
    want = jv.stage_params(jax.tree.map(jnp.asarray, params), 2)
    for k, v in staged["stages"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want["stages"][k]))


def test_learns_on_mesh():
    """dp=4 x tp=2, 25 Adam steps on label-banded pixels: the port's
    losses track the JAX package's and halve."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 5, (8, 1)).astype(np.float32)
    pixels = (labels[:, :, None] / 5.0 + 0.05 * rng.standard_normal(
        (8, 1, 16 * 16 * 3))).reshape(8, -1).astype(np.float32)
    params = _params(jcfg)
    jm_ = jmesh({"dp": 4, "tp": 2})
    jinit, jfn = jstep(lambda p, b: jv.classification_loss(p, b, jcfg),
                       optax.adam(3e-3), jm_, jv.param_specs(jcfg),
                       batch_spec=JP(("dp",)))
    tm_ = tmesh({"dp": 4, "tp": 2})
    tinit, tfn = make_train_step(
        lambda p, b: tv.classification_loss(p, b, tcfg, mesh=tm_), _adam(3e-3),
        mesh=tm_, param_specs=tv.param_specs(tcfg), batch_spec=P(("dp",)))
    js, ts = jinit(jax.tree.map(jnp.asarray, params)), tinit(_tp(params))
    jl, tl = [], []
    for _ in range(25):
        js, loss = jfn(js, (pixels, labels))
        jl.append(float(loss))
        ts, loss = tfn(ts, (torch.tensor(pixels), torch.tensor(labels)))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0] * 0.5, tl


def test_trains_from_webdataset_loader(tmp_path):
    """Tar image shards → the port's WebDatasetProducer → THREAD loader →
    a dp=8 ViT step: finite losses, equal to the JAX package's step on the
    same batches."""
    from datagen import write_image_shard

    from ddl_tpu_torch import DistributedDataLoader, Marker, distributed_dataloader
    from ddl_tpu_torch.readers import WebDatasetProducer

    for s in range(2):
        write_image_shard(str(tmp_path / f"train-{s}.tar"),
                          [(f"s{s}k{i}", i % 3) for i in range(8)], size=16)
    jcfg, tcfg = _cfgs(n_classes=3)
    params = _params(jcfg)
    mesh = tmesh({"dp": 8})
    init_fn, step_fn = make_train_step(
        lambda p, b: tv.classification_loss(p, b, tcfg, mesh=mesh), _adam(1e-3),
        mesh=mesh, param_specs=tv.param_specs(tcfg), batch_spec=P(("dp",)))

    @distributed_dataloader(n_producers=2, mode="thread", pin_memory=False)
    def main(env):
        loader = DistributedDataLoader(
            WebDatasetProducer(str(tmp_path / "train-*.tar"), image_size=16,
                               window_rows=8),
            batch_size=8, connection=env.connection, n_epochs=2,
            output="numpy", device="cpu")
        state = init_fn(_tp(params))
        losses, batches = [], []
        for _ in range(2):
            for batch in loader:
                batches.append(tuple(np.array(c, copy=True) for c in batch))
                state, loss = step_fn(state, tuple(torch.tensor(c)
                                                   for c in batches[-1]))
                losses.append(float(loss))
                loader.mark(Marker.END_OF_BATCH)
            loader.mark(Marker.END_OF_EPOCH)
        return losses, batches

    losses, batches = main()
    assert losses and all(np.isfinite(v) for v in losses)
    jinit, jfn = jstep(lambda p, b: jv.classification_loss(p, b, jcfg),
                       optax.adam(1e-3), jmesh({"dp": 8}), jv.param_specs(jcfg),
                       batch_spec=JP(("dp",)))
    js = jinit(jax.tree.map(jnp.asarray, params))
    want = []
    for b in batches:
        js, loss = jfn(js, b)
        want.append(float(loss))
    np.testing.assert_allclose(losses, want, rtol=1e-4)


def test_evaluate_metric_pass(tmp_path):
    """``Trainer.fit`` on brightness-banded image shards, then
    ``Trainer.evaluate`` of ``accuracy``: decisively above the 2-class
    chance level, the same on the window-stream route, and equal to the
    JAX package's ``accuracy`` of the trained weights on the same
    batches."""
    from test_trainer import _write_banded_shard

    from ddl_tpu_torch.readers import WebDatasetProducer
    from ddl_tpu_torch.trainer import Trainer

    for s in range(2):
        _write_banded_shard(str(tmp_path / f"t-{s}.tar"),
                            [(f"s{s}k{i}", i % 2) for i in range(8)], size=16)
    jcfg, tcfg = _cfgs(n_layers=1, n_classes=2)
    mesh = tmesh({"dp": 8})
    trainer = Trainer(
        loss_fn=lambda p, b: tv.classification_loss(p, b, tcfg, mesh=mesh),
        optimizer=_adam(3e-3), init_params=_tp(_params(jcfg)), device="cpu",
        mesh=mesh, param_specs=tv.param_specs(tcfg), batch_spec=P(("dp",)),
        watchdog=False)
    producer = WebDatasetProducer(str(tmp_path / "t-*.tar"), image_size=16,
                                  window_rows=8)
    res = trainer.fit(producer, batch_size=8, n_epochs=6, n_producers=2,
                      mode="thread")
    seen = []

    def metric(p, b):
        seen.append(tuple(np.array(c, copy=True) for c in b))
        return tv.accuracy(p, b, tcfg)

    acc = trainer.evaluate(producer, res.state, metric, batch_size=8,
                           n_producers=2, mode="thread")
    assert 0.8 < acc <= 1.0, acc
    acc_win = trainer.evaluate(producer, res.state,
                               lambda p, b: tv.accuracy(p, b, tcfg),
                               batch_size=8, n_producers=2, mode="thread",
                               window_stream=True)
    assert abs(acc_win - acc) < 1e-6, (acc_win, acc)
    trained = jax.tree.map(lambda t: t.detach().numpy(), res.state.params)
    want = np.mean([float(jv.accuracy(trained, b, jcfg)) for b in seen])
    assert abs(want - acc) < 1e-6, (want, acc)


class TestViTPipeline:
    """Twins of ``tests/test_pipeline.py``'s ViT class: the image family
    through the pipe, non-causal attention inside the stages."""

    def _cfgs(self):
        return _cfgs(image_size=16, patch_size=4, d_model=32, n_layers=4,
                     n_heads=4, d_ff=64, n_classes=8, attn_impl="dense")

    def test_forward_pp_matches_forward(self):
        jcfg, tcfg = self._cfgs()
        params = _params(jcfg)
        images = np.random.default_rng(0).random((8, 16 * 16 * 3)).astype(np.float32)
        with torch.no_grad():
            ref = tv.forward(_tp(params), torch.tensor(images), tcfg)
            got = tv.forward_pp(tv.stage_params(_tp(params), 4),
                                torch.tensor(images), tcfg,
                                tmesh({"pp": 4, "dp": 2}), n_microbatches=4)
        want = jax.jit(lambda p, x: jv.forward_pp(
            jv.stage_params(p, 4), x, jcfg, jmesh({"pp": 4, "dp": 2}),
            n_microbatches=4))(params, images)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=ATOL)

    def test_train_step_pp_vit(self):
        """pp=4 x dp=2, 8 Adam steps: the first loss is the unpipelined
        loss of the same weights, the JAX package's, and the losses fall."""
        jcfg, tcfg = self._cfgs()
        mesh = tmesh({"pp": 4, "dp": 2})
        init_fn, step_fn = make_train_step(
            lambda p, b: tv.classification_loss_pp(p, b, tcfg, mesh,
                                                   n_microbatches=4),
            _adam(1e-2), mesh=mesh, param_specs=tv.pp_param_specs(tcfg),
            batch_spec=P(("dp",)))
        params = _params(jcfg)
        state = init_fn(tv.stage_params(_tp(params), 4))
        g = np.random.default_rng(0)
        pixels = g.random((8, 16 * 16 * 3)).astype(np.float32)
        labels = g.integers(0, 8, (8, 1)).astype(np.float32)
        losses = []
        for _ in range(8):
            state, loss = step_fn(state, (torch.tensor(pixels),
                                          torch.tensor(labels)))
            losses.append(float(loss))
        ref = float(jax.jit(lambda p: jv.classification_loss(
            p, (pixels, labels), jcfg))(params))
        np.testing.assert_allclose(losses[0], ref, rtol=1e-5)
        assert losses[-1] < losses[0] - 0.3, losses
