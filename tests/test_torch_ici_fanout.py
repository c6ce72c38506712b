"""The port's fan-out kernels K7/K8 (their plain versions, on the CPU)
against the JAX package's Pallas rings in interpret mode.

Both take the same numpy-seeded ``(rows, cols)`` block on ring position
``src`` and must land byte-identical blocks on every ring position:
n = 2, 4, 8; the reference's ``n_chunks`` 1, 3 and 4 over rows that
leave a chunk tail (the port's one launch has no chunk pipeline, so it
takes none); ``src`` != 0; fp32, int32 and bf16 (compared as 16-bit patterns: numpy
has no bf16).  The reference's kernels name ``pltpu.TPUCompilerParams``,
which this JAX spells ``pltpu.CompilerParams``; the fixture below lends
the old name for the test only.  The CUDA kernels themselves run on the
card (``tests/test_torch_cuda.py``).
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ddl_tpu.ops import ici_fanout as jfan
from ddl_tpu_torch.ops import ici_fanout as tfan


@pytest.fixture(autouse=True)
def _reference_compiler_params(monkeypatch):
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


def _block(rows, cols, dtype, seed):
    """The same block for both packages: (numpy for JAX, torch)."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        x = rng.integers(-2**31, 2**31 - 1, (rows, cols), dtype=np.int32)
        return x, torch.from_numpy(x.copy())
    x = rng.standard_normal((rows, cols)).astype(np.float32)
    if dtype == "float32":
        return x, torch.from_numpy(x.copy())
    jx = x.astype(ml_dtypes.bfloat16)
    return jx, torch.from_numpy(jx.view(np.int16).copy()).view(torch.bfloat16)


def _bits(a):
    """Raw bit patterns of a numpy array or a CPU tensor (bf16 as int16)."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    elif a.dtype == ml_dtypes.bfloat16:
        a = a.view(np.int16)
    return a


def _ring(n):
    return tuple(jax.devices()[:n]), ["cpu"] * n


@pytest.mark.parametrize("n,n_chunks,src,dtype", [
    (2, 1, 1, "float32"), (4, 3, 2, "int32"), (8, 4, 5, "bfloat16"),
    (4, 4, 0, "float32"), (8, 1, 0, "int32"), (2, 3, 0, "bfloat16"),
    (4, 1, 3, "bfloat16"), (8, 3, 7, "float32"),
])
def test_replicate_equals_reference(n, n_chunks, src, dtype):
    """10 rows: 3 and 4 chunks leave a tail the reference pads and
    strips.  Every ring position holds the block, position by position."""
    jdevs, tdevs = _ring(n)
    x, t = _block(10, 6, dtype, n * 10 + src)
    want = jfan.fanout_replicate(jax.device_put(x, jdevs[src]), jdevs,
                                 src=src, n_chunks=n_chunks)
    before = tfan.fanout_replicate.launches
    got = tfan.fanout_replicate(t, tdevs, src=src)
    assert tfan.fanout_replicate.launches == before  # the CPU takes no kernel
    assert got.shape == tuple(want.shape) == (n * 10, 6)
    np.testing.assert_array_equal(_bits(got.tensor()), _bits(np.asarray(want)))
    by_device = {s.device: s for s in want.addressable_shards}
    for s in got.shards:
        ref = by_device[jdevs[s.position]]
        assert s.index == ref.index
        np.testing.assert_array_equal(_bits(s.data), _bits(np.asarray(ref.data)))
    assert got.shards[src].data is t  # the source keeps the anchor, zero copy
    assert all(s.data.data_ptr() != t.data_ptr()
               for s in got.shards if s.position != src)


@pytest.mark.parametrize("n,src,dtype", [
    (2, 1, "float32"), (4, 3, "int32"), (8, 5, "bfloat16"), (4, 0, "float32"),
    (8, 0, "int32"),
])
def test_shard_equals_reference(n, src, dtype):
    """Row-block i lands on ring position i whatever ``src`` holds the
    block; each position's block is its own contiguous tensor."""
    jdevs, tdevs = _ring(n)
    x, t = _block(2 * n, 5, dtype, 100 + n + src)
    want = jfan.fanout_shard(jax.device_put(x, jdevs[src]), jdevs, src=src)
    got = tfan.fanout_shard(t, tdevs, src=src)
    assert got.shape == tuple(want.shape)
    by_device = {s.device: s for s in want.addressable_shards}
    for s in got.shards:
        ref = by_device[jdevs[s.position]]
        assert s.index == ref.index
        assert s.data.is_contiguous() and s.data.data_ptr() != t.data_ptr()
        np.testing.assert_array_equal(_bits(s.data), _bits(np.asarray(ref.data)))
    np.testing.assert_array_equal(_bits(got.tensor()), _bits(x))


def test_plain_versions_are_what_the_kernels_compute():
    t = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    rep = tfan.replicate_plain(t, 3, src=1)
    assert rep[1] is t and all(torch.equal(r, t) for r in rep)
    shards = tfan.shard_plain(t, 4)
    assert [tuple(s.shape) for s in shards] == [(2, 3)] * 4
    assert torch.equal(torch.cat(shards), t)


@pytest.mark.parametrize("mode,nbytes,n_dev,n_chunks,rows", [
    ("replicate", 4096, 4, 4, None), ("replicate", 5 * 1024, 4, 4, 5),
    ("replicate", 10 * 24, 8, 3, 10), ("replicate", 1 << 26, 4, 4, 32),
    ("replicate", 1024, 1, 4, None), ("shard", 8192, 8, 4, None),
    ("shard", 1 << 26, 4, 4, 32), ("shard", 1024, 1, 4, None),
])
def test_pricing_equals_reference(mode, nbytes, n_dev, n_chunks, rows):
    assert tfan.wire_bytes(mode, nbytes, n_dev, n_chunks, rows=rows) == (
        jfan.wire_bytes(mode, nbytes, n_dev, n_chunks, rows=rows))
    assert tfan.payload_bytes(mode, nbytes, n_dev) == (
        jfan.payload_bytes(mode, nbytes, n_dev))
    assert tfan.bcast_grid(n_dev, n_chunks) == jfan.bcast_grid(n_dev, n_chunks)


def test_pricing_refuses_an_unknown_mode():
    for fn in (tfan.wire_bytes, tfan.payload_bytes):
        with pytest.raises(ValueError, match="replicate|shard"):
            fn("gather", 1024, 4)


def test_single_position_passthrough():
    t = torch.ones(4, 4)
    for fn in (tfan.fanout_replicate, tfan.fanout_shard):
        out = fn(t, ["cpu"])
        assert len(out.shards) == 1 and out.shards[0].data is t
    assert tfan.replicated_view(tfan.fanout_replicate(t, ["cpu"]),
                                ["cpu"]).shards[0].data is t


def test_indivisible_rows_rejected():
    jdevs, tdevs = _ring(4)
    with pytest.raises(ValueError, match="divisible"):
        jfan.fanout_shard(jax.device_put(np.ones((10, 4), np.float32),
                                         jdevs[0]), jdevs)
    with pytest.raises(ValueError, match="divisible"):
        tfan.fanout_shard(torch.ones(10, 4), tdevs)


def test_blocks_must_be_2d_on_the_ring_device():
    with pytest.raises(ValueError, match="2-D"):
        tfan.fanout_shard(torch.ones(4, 4, 2), ["cpu"] * 2)
    with pytest.raises(ValueError, match="do not hold"):
        tfan.fanout_replicate(torch.ones(4, 4), ["cuda:0"] * 2)
    with pytest.raises(ValueError, match="src"):
        tfan.fanout_replicate(torch.ones(4, 4), ["cpu"] * 2, src=2)
    with pytest.raises(NotImplementedError, match="multi-card"):
        tfan.fanout_shard(torch.ones(4, 4), ["cuda:0", "cuda:1"])


def test_replicated_view_is_zero_copy():
    jdevs, tdevs = _ring(4)
    x, t = _block(8, 4, "float32", 0)
    out = tfan.fanout_replicate(t, tdevs)
    rep = tfan.replicated_view(out, tdevs)
    want = jfan.replicated_view(
        jfan.fanout_replicate(jax.device_put(x, jdevs[0]), jdevs), jdevs)
    assert rep.shape == tuple(want.shape) == (8, 4)
    assert all(a.data is b.data for a, b in zip(rep.shards, out.shards))
    assert all(s.index == (slice(None), slice(None)) for s in rep.shards)
    np.testing.assert_array_equal(rep.numpy(), np.asarray(want))
