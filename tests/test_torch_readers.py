"""The port's ``ArrayProducer`` against the JAX package's: the same data
and seed give the same draws and bytes, worker by worker, and the same
window stream through both loaders."""

import numpy as np
import pytest

import ddl_tpu
import ddl_tpu_torch
from ddl_tpu.readers import ArrayProducer as JaxArray
from ddl_tpu_torch.readers import ArrayProducer as TorchArray


def _data(n, f, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal((n, f)).astype(dtype)
    return rng.integers(0, 1000, (n, f)).astype(dtype)


@pytest.mark.parametrize("n,window,producer,n_producers,instance,n_instances,dtype", [
    (64, 16, 1, 2, 0, 1, "float32"),
    (64, 16, 2, 2, 0, 1, "int32"),
    (40, 32, 1, 3, 1, 2, "float32"),  # the shard is tiled up to the window
    (100, 8, 3, 4, 0, 1, "uint8"),
])
def test_array_producer_fills_equal_reference(n, window, producer, n_producers,
                                              instance, n_instances, dtype):
    data = _data(n, 5, dtype, seed=n)
    kw = dict(producer_idx=producer, n_producers=n_producers,
              instance_idx=instance, n_instances=n_instances)
    ref, port = JaxArray(data, window, seed=7), TorchArray(data, window, seed=7)
    rinit, pinit = ref.on_init(**kw), port.on_init(**kw)
    for field in ("nData", "nValues", "shape", "splits"):
        assert getattr(pinit, field) == getattr(rinit, field)
    assert np.dtype(pinit.dtype) == np.dtype(rinit.dtype)
    want = np.zeros(rinit.shape, dtype)
    got = np.zeros(pinit.shape, dtype)
    ref.post_init(want)
    port.post_init(got)
    assert got.tobytes() == want.tobytes()
    for _ in range(3):
        ref.execute_function(want)
        port.execute_function(got)
        assert got.tobytes() == want.tobytes()


def test_array_producer_splits_and_capability():
    data = _data(32, 6, "float32")
    p = TorchArray(data, 8, splits=(4, 2))
    assert p.on_init().splits == (4, 2) == JaxArray(data, 8, (4, 2)).on_init().splits
    assert TorchArray.supports_inplace_fill and JaxArray.supports_inplace_fill


def _stream(pkg, cls, data, **kw):
    @pkg.distributed_dataloader(n_producers=2, mode="thread", nslots=2, **kw)
    def run(env):
        output = "jax" if pkg is ddl_tpu else "device"
        extra = {} if pkg is ddl_tpu else {"device": "cpu"}
        loader = pkg.DistributedDataLoader(
            cls(data, window_size=24, seed=5), batch_size=6,
            connection=env.connection, n_epochs=4, output=output, **extra,
        )
        out = []
        for win in loader.windows(lookahead=2):
            out.append(np.asarray(win).copy() if pkg is ddl_tpu
                       else win.numpy().copy())
            loader.mark(pkg.Marker.END_OF_EPOCH)
        return out

    return run()


def test_array_producer_stream_byte_identical():
    data = _data(96, 7, "float32", seed=3)
    want = _stream(ddl_tpu, JaxArray, data)
    got = _stream(ddl_tpu_torch, TorchArray, data, pin_memory=False)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape == (4, 6, 7)
        assert g.tobytes() == w.tobytes()
