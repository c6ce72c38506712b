"""The port's device collectives against the JAX package's, on the same
numpy-seeded inputs.

- The int8 wire format: ``quantize_blockwise``'s payload and scales byte
  for byte (deterministic rounding), the round trip's error bound,
  ``quantized_bytes``; stochastic rounding unbiased (the averaged error
  collapses against the deterministic one, the JAX package's own bound)
  and the same bytes for the same key (not JAX's random numbers).
- ``quantized_all_reduce`` over positions against the JAX package's
  ``shard_map`` version on the 8-device CPU mesh: every position holds
  the same vector, within the reference's bound of the exact mean, 99 %
  of its values within 1e-6 (relative to the peak) of the reference's
  and none more than one output quantization step away (fp32 sums in
  another order move a scale's last bit or a value on a rounding edge).
- ``DeviceGlobalShuffler``: pools byte for byte the JAX package's over
  several rounds, both strategies, a ``rejoin``; ``ppermute``'s moves and
  its refusal of distinct cards; the window hook.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JaxSharding, PartitionSpec as JP

from ddl_tpu._compat import shard_map
from ddl_tpu.parallel import collectives as jcol
from ddl_tpu.parallel.mesh import make_mesh as jax_mesh
from ddl_tpu_torch.parallel import collectives as tcol
from ddl_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    P,
    ShardedArray,
    make_mesh,
    shard,
)


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.mark.parametrize("shape,block", [
    ((7, 500), 256), ((4, 2 * 256 + 3), 256), ((1000,), 256),
    ((3, 5, 130), 64), ((2, 64), 64), ((17,), 256),
])
def test_deterministic_payload_and_scales_are_the_references(shape, block):
    x = _normal(sum(shape), shape, 3.0)
    x.reshape(-1)[: min(x.size, block)] = 0.0  # a zero block: scale 1
    jq, js = jcol.quantize_blockwise(jnp.asarray(x), block)
    tq, ts = tcol.quantize_blockwise(torch.from_numpy(x), block)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    jout = jcol.dequantize_blockwise(jq, js, jnp.float32, block)
    tout = tcol.dequantize_blockwise(tq, ts, torch.float32, block)
    assert tout.numpy().tobytes() == np.asarray(jout).tobytes()
    # Per-block max-abs scaling: error <= scale/2 = max|block|/254.
    err = np.abs(tout.numpy() - x)
    assert err.max() <= np.abs(x).max() / 254 + 1e-7


def test_block_scales_and_zero_blocks_match():
    x = np.zeros((4, 2 * 256 + 3), np.float32)
    x[1, 300] = -5.0
    jsc = np.asarray(jcol.block_scales(jnp.asarray(x)))
    tsc = tcol.block_scales(torch.from_numpy(x)).numpy()
    assert tsc.shape == (4, 3) and tsc.tobytes() == jsc.tobytes()
    q, s = tcol.quantize_blockwise(torch.from_numpy(x))
    out = tcol.dequantize_blockwise(q, s, torch.float32)
    assert torch.equal(out, torch.from_numpy(x))  # zeros and one peak exact


def test_quantize_dequantize_keeps_the_dtype():
    x = torch.from_numpy(_normal(1, (32,))).bfloat16()
    out = tcol.quantize_dequantize(x)
    assert out.dtype == torch.bfloat16
    want = jcol.quantize_dequantize(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    assert np.array_equal(out.float().numpy(), np.asarray(want, np.float32))


def test_stochastic_rounding_requires_a_key_and_is_deterministic_per_key():
    x = torch.from_numpy(_normal(2, (256,)))
    with pytest.raises(ValueError, match="key"):
        tcol.quantize_blockwise(x, stochastic=True)
    a = tcol.quantize_dequantize(x, stochastic=True, key=7)
    b = tcol.quantize_dequantize(x, stochastic=True, key=7)
    c = tcol.quantize_dequantize(x, stochastic=True, key=(7, 1))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    # Every value rounds to one of its two neighbours on the int8 grid.
    q, s = tcol.quantize_blockwise(x, stochastic=True, key=3)
    v = x / s.repeat_interleave(256)[:256]
    assert bool(((q.float() == torch.floor(v)) | (q.float() == torch.ceil(v))).all())


def test_stochastic_rounding_is_unbiased():
    """E over keys approaches x much closer than any single rounded
    draw: the averaged error collapses against the deterministic one (the
    JAX package's bound, 1/3)."""
    x = torch.from_numpy(_normal(3, (2048,), 0.01))
    det_err = (tcol.quantize_dequantize(x) - x).abs().mean()
    draws = torch.stack([tcol.quantize_dequantize(x, stochastic=True, key=i)
                         for i in range(64)]).mean(0)
    sto_err = (draws - x).abs().mean()
    assert sto_err < det_err / 3


@pytest.mark.parametrize("shape,block", [
    ((4, 2 * 256 + 1), 256), ((), 256), ((1000,), 256), ((3, 7, 130), 64),
])
def test_quantized_bytes_equal_the_references(shape, block):
    assert tcol.quantized_bytes(shape, block) == jcol.quantized_bytes(shape, block)
    if shape == (4, 2 * 256 + 1):
        assert tcol.quantized_bytes(shape) == 4 * (2 * 256 + 1) + 4 * 4 * 3


def _jax_all_reduce(x, n, mean):
    mesh = jax_mesh({"dp": n}, jax.devices()[:n])

    def f(xl):
        return jcol.quantized_all_reduce(xl[0], "dp", n, mean=mean)[None]

    fn = shard_map(f, mesh=mesh, in_specs=JP("dp"), out_specs=JP("dp"),
                   check_vma=False)
    return np.asarray(jax.jit(fn)(x))


@pytest.mark.parametrize("n,size,mean", [
    (8, 1000, True), (8, 37, False), (4, 3000, True), (2, 513, True),
    (3, 777, False),
])
def test_quantized_all_reduce_matches_the_reference(n, size, mean):
    x = _normal(n + size, (n, size))
    want = _jax_all_reduce(x, n, mean)
    got = tcol.quantized_all_reduce([torch.from_numpy(r) for r in x],
                                    mean=mean)
    assert len(got) == n
    for g in got:  # the all-gather completed: every position agrees
        assert torch.equal(g, got[0])
    ref = x.mean(0) if mean else x.sum(0)
    out = got[0].numpy()
    # Within the two-phase quantization bound of the exact result ...
    assert np.abs(out - ref).max() <= 0.02 * np.abs(ref).max()
    # ... and of the reference's values: its fp32 sums run in another
    # order, so a block's scale may differ in its last bit (values one
    # ulp apart) and a value on a rounding edge one output step apart.
    step = np.abs(ref).max() / 127
    assert np.abs(out - want[0]).max() <= 1.01 * step
    near = np.abs(out - want[0]) <= 1e-6 * np.abs(want[0]).max()
    assert near.mean() > 0.99


def test_quantized_all_reduce_of_one_is_a_local_roundtrip():
    x = torch.from_numpy(_normal(4, (64,)))
    (out,) = tcol.quantized_all_reduce([x])
    assert (out - x).abs().max() <= x.abs().max() / 60
    assert torch.equal(out, tcol.quantize_dequantize(
        tcol.quantize_dequantize(x.reshape(1, -1))).reshape(-1))
    with pytest.raises(ValueError, match="axis_size"):
        tcol.quantized_all_reduce([])


def test_quantized_all_reduce_stochastic_is_deterministic_per_key():
    xs = [torch.from_numpy(_normal(i, (600,))) for i in range(4)]
    a = tcol.quantized_all_reduce(xs, stochastic=True, key=5)
    b = tcol.quantized_all_reduce(xs, stochastic=True, key=5)
    assert torch.equal(a[0], b[0])
    ref = torch.stack(xs).mean(0)
    assert (a[0] - ref).abs().max() <= 0.04 * ref.abs().max()


# -- ppermute and the global shuffle -----------------------------------------


def test_ppermute_moves_shards_along_one_axis():
    mesh = make_mesh({"dp": 2, "sp": 3}, ["cpu"] * 6)
    x = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 12)
    sh = NamedSharding(mesh, P("dp", "sp"))
    out = tcol.ppermute(shard(x, sh), [(0, 1), (1, 2)], "sp")
    # Index 2 sends nowhere; index 0 receives nothing (zeros).
    for p, (d, s) in enumerate(mesh.coords()):
        got = out.shards[p].data
        if s == 0:
            assert torch.equal(got, torch.zeros(1, 4))
        else:
            assert torch.equal(got, x[d:d + 1, (s - 1) * 4: s * 4])
    with pytest.raises(ValueError, match="receives twice"):
        tcol.ppermute(shard(x, sh), [(0, 1), (2, 1)], "sp")


def test_ppermute_is_differentiable():
    mesh = make_mesh({"sp": 4}, ["cpu"] * 4)
    x = torch.randn(8, 3, requires_grad=True)
    ring = [(j, (j + 1) % 4) for j in range(4)]
    out = tcol.ppermute(shard(x, NamedSharding(mesh, P("sp"))), ring).assemble()
    assert torch.equal(out, torch.roll(x, 2, dims=0).detach())
    (out * torch.arange(8.0)[:, None]).sum().backward()
    assert torch.equal(x.grad, torch.roll(torch.arange(8.0), -2)[:, None].expand(8, 3))


def test_positions_over_distinct_cards_raise():
    mesh = Mesh(["cuda:0", "cuda:1"], ("dp",))
    with pytest.raises(NotImplementedError, match="distinct cards"):
        tcol.DeviceGlobalShuffler(mesh, num_exchange=4)
    arr = ShardedArray((4, 2), NamedSharding(mesh, P("dp")),
                       [torch.zeros(2, 2), torch.zeros(2, 2)])
    with pytest.raises(NotImplementedError, match="distinct cards"):
        tcol.ppermute(arr, [(0, 1), (1, 0)])


@pytest.mark.parametrize("method", ["sendrecv_replace", "all_to_all"])
@pytest.mark.parametrize("n,rows,num_exchange", [(4, 8, 4), (8, 12, 9), (2, 16, 7)])
def test_shuffler_pools_equal_the_references(method, n, rows, num_exchange):
    """Several rounds, a rejoin into the middle of the schedule: every
    pool byte for byte the JAX package's."""
    x = np.arange(n * rows * 3, dtype=np.float32).reshape(n * rows, 3)
    jm = jax_mesh({"dp": n}, jax.devices()[:n])
    js = jcol.DeviceGlobalShuffler(jm, num_exchange=num_exchange,
                                   method=method, seed=11)
    tm = make_mesh({"dp": n}, ["cpu"] * n)
    ts = tcol.DeviceGlobalShuffler(tm, num_exchange=num_exchange,
                                   method=method, seed=11)
    jw = jax.device_put(jnp.asarray(x), JaxSharding(jm, JP("dp")))
    tw = shard(torch.from_numpy(x), NamedSharding(tm, P("dp")))
    moved = False
    for _ in range(4):
        jw, tw = js.shuffle(jw), ts.shuffle(tw)
        assert tw.numpy().tobytes() == np.asarray(jw).tobytes()
        moved |= not np.array_equal(tw.numpy(), x)
    assert ts.exchange_round == js.exchange_round == 4
    assert moved
    js.rejoin(9)
    ts.rejoin(9)
    assert ts.shuffle(tw).numpy().tobytes() == np.asarray(js.shuffle(jw)).tobytes()


def test_window_hook_equals_the_references():
    n, bpw, batch, feat = 4, 2, 8, 5
    win = np.arange(bpw * batch * feat, dtype=np.float32).reshape(bpw, batch, feat)
    jm = jax_mesh({"dp": n}, jax.devices()[:n])
    tm = make_mesh({"dp": n}, ["cpu"] * n)
    jhook = jcol.DeviceGlobalShuffler(jm, num_exchange=2, seed=3).window_hook()
    thook = tcol.DeviceGlobalShuffler(tm, num_exchange=2, seed=3).window_hook()
    jwin = jax.device_put(jnp.asarray(win), JaxSharding(jm, JP(None, "dp")))
    twin = torch.from_numpy(win)
    for _ in range(3):
        jwin, twin = jhook(jwin), thook(twin)
        assert twin.shape == (bpw, batch, feat)
        assert twin.numpy().tobytes() == np.asarray(jwin).tobytes()
    assert thook.owner.exchange_round == 3


def test_one_instance_or_no_exchange_is_identity():
    tm = make_mesh({"dp": 1}, ["cpu"])
    x = shard(torch.ones(4, 2), NamedSharding(tm, P("dp")))
    assert tcol.DeviceGlobalShuffler(tm, num_exchange=4).shuffle(x) is x
    tm = make_mesh({"dp": 2}, ["cpu"] * 2)
    x = shard(torch.ones(4, 2), NamedSharding(tm, P("dp")))
    assert tcol.DeviceGlobalShuffler(tm, num_exchange=1).shuffle(x) is x
    with pytest.raises(NotImplementedError, match="method"):
        tcol.DeviceGlobalShuffler(tm, method="ring")
