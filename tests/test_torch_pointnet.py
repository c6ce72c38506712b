"""The port's pointwise regressor (``ddl_tpu_torch/models/pointnet.py``)
against the JAX package's ``ddl_tpu/models/pointnet.py``, from the same
numpy weights and points: ``forward`` and the weighted MSE at 1e-6, their
gradients at 1e-5 relative, and the twin of ``tests/test_models_train.py``'s
PointNet class (a model trained from the loader's ``(pos, target,
weight)`` batches, its losses the JAX package's step's on the same
batches, rtol 1e-4, as the other train-step twins).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from ddl_tpu.models import pointnet as jpn
from ddl_tpu_torch.models import pointnet as tpn
from ddl_tpu_torch.parallel.mesh import P, make_mesh
from ddl_tpu_torch.parallel.train import adamw, make_train_step


def _params(jcfg):
    return jax.tree.map(np.asarray, jax.jit(jpn.init_params, static_argnums=0)(
        jcfg, jax.random.key(0)))


def _batch(n, seed=0, n_out=6):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3)).astype(np.float32),
            rng.random((n, n_out)).astype(np.float32),
            rng.random((n, 1)).astype(np.float32))


@pytest.mark.parametrize("hidden,n_out", [((64, 64), 6), ((32,), 2),
                                          ((16, 48, 16), 6)])
def test_forward_and_loss_match_jax(hidden, n_out):
    jcfg = jpn.PointNetConfig(n_outputs=n_out, hidden=hidden)
    tcfg = tpn.PointNetConfig(n_outputs=n_out, hidden=hidden)
    params = _params(jcfg)
    batch = _batch(128, n_out=n_out)
    tp = jax.tree.map(lambda t: t.requires_grad_(True),
                      tpn.params_from_numpy(params, device="cpu"))
    out = tpn.forward(tp, torch.tensor(batch[0]), tcfg)
    want = jax.jit(lambda p, x: jpn.forward(p, x, jcfg))(params, batch[0])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-6)
    loss = tpn.weighted_mse_loss(tp, tuple(map(torch.tensor, batch)), tcfg)
    loss.backward()
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jpn.weighted_mse_loss(p, b, jcfg)))(params, batch)
    np.testing.assert_allclose(float(loss), float(jl), atol=1e-6)
    jax.tree.map(lambda t, g: np.testing.assert_allclose(
        t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-7), tp, jg)
    specs = jax.tree.map(tuple, tpn.param_specs(tcfg),
                         is_leaf=lambda x: isinstance(x, P))
    assert specs == jax.tree.map(tuple, jpn.param_specs(jcfg),
                                 is_leaf=lambda x: isinstance(x, JP))


def test_train_on_loader_batches():
    """The reference harness's loop closed in the port: the example
    producer's columns through a THREAD loader into a dp=8 step; the
    losses fall and equal the JAX package's step on the same batches."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    from run_ddl import make_pointwise_data

    from ddl_tpu_torch import (
        DataProducerOnInitReturn,
        DistributedDataLoader,
        Marker,
        ProducerFunctionSkeleton,
        distributed_dataloader,
    )

    class DataProducer(ProducerFunctionSkeleton):
        """``examples/run_ddl.py``'s producer for the port: a seeded
        normalised pointwise shard, reshuffled in place each window."""

        def on_init(self, producer_idx=0, instance_idx=0, **kw):
            seed = instance_idx * 1000 + producer_idx
            self._data = make_pointwise_data(256, 10, seed)
            self._rng = np.random.default_rng(seed + 1)
            return DataProducerOnInitReturn(nData=256, nValues=10,
                                            shape=(256, 10), splits=(3, 6, 1),
                                            dtype=np.float32)

        def post_init(self, my_ary, **kw):
            np.copyto(my_ary, self._data)

        def execute_function(self, my_ary, **kw):
            self._rng.shuffle(my_ary)

    jcfg, tcfg = jpn.PointNetConfig(), tpn.PointNetConfig()
    params = _params(jcfg)
    mesh = make_mesh({"dp": 8}, ["cpu"] * 8)
    init_fn, step_fn = make_train_step(
        lambda p, b: tpn.weighted_mse_loss(p, b, tcfg),
        adamw(1e-2, weight_decay=0.0), mesh=mesh,
        param_specs=tpn.param_specs(tcfg))

    @distributed_dataloader(n_producers=2, mode="thread", pin_memory=False)
    def main(env):
        loader = DistributedDataLoader(DataProducer(), batch_size=64,
                                       connection=env.connection, n_epochs=2,
                                       output="numpy", device="cpu")
        state = init_fn(tpn.params_from_numpy(params, device="cpu"))
        losses, batches = [], []
        for _ in range(2):
            for batch in loader:
                batches.append(tuple(np.array(c, copy=True) for c in batch))
                state, loss = step_fn(state, tuple(map(torch.tensor,
                                                       batches[-1])))
                losses.append(float(loss))
                loader.mark(Marker.END_OF_BATCH)
            loader.mark(Marker.END_OF_EPOCH)
        return losses, batches

    losses, batches = main()
    assert len(losses) == 2 * (256 // 64)
    assert losses[-1] < losses[0]
    opt = optax.adam(1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)

    @jax.jit
    def jstep(p, s, b):
        loss, g = jax.value_and_grad(lambda q: jpn.weighted_mse_loss(q, b, jcfg))(p)
        upd, s = opt.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss

    want = []
    for b in batches:
        jp, state, loss = jstep(jp, state, b)
        want.append(float(loss))
    np.testing.assert_allclose(losses, want, rtol=1e-4)
