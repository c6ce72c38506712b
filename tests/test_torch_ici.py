"""The port's ICI ingest tier against the JAX package's, on the CPU.

- Plans: for every ``DRYRUN_MATRIX`` row at ``n_slots`` 1 and 2,
  ``plan_distribution`` equals the reference's field by field (the ring
  order compared as mesh positions), and the ``PlanError`` cases agree.
- Distribution: ``IciDistributor.put`` on an 8-position CPU mesh lands
  the shards of the reference's ``IciDistributor.put`` (its Pallas rings
  in interpret mode on the conftest's 8-device CPU mesh), shard by shard
  and index by index.
- The ladder (per-geometry plain route, the CPU latch, shutdowns), the
  slots and gauges, the ingest seam, and window streams through the
  loaders of both packages under ``distribute="ici"`` and ``"xla"``.

The reference's kernels name ``pltpu.TPUCompilerParams``, which this JAX
spells ``pltpu.CompilerParams``; the fixture below lends the old name
for the test only.
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding as JaxSharding
from jax.sharding import PartitionSpec as JaxP

import ddl_tpu
import ddl_tpu_torch
from ddl_tpu.observability import Metrics as JaxMetrics
from ddl_tpu.parallel import ici as jici
from ddl_tpu_torch.exceptions import ShutdownRequested
from ddl_tpu_torch.ingest import DeviceIngestor, device_put
from ddl_tpu_torch.observability import Metrics
from ddl_tpu_torch.ops import ici_fanout as tfan
from ddl_tpu_torch.parallel import ici as tici
from ddl_tpu_torch.parallel import mesh as tmesh

MATRIX_IDS = ["x".join(f"{a}{n}" for a, n in axes) + "-" + repr(spec)
              for axes, spec in tici.DRYRUN_MATRIX]


@pytest.fixture(autouse=True)
def _reference_compiler_params(monkeypatch):
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


def _jax_sharding(axes, spec):
    names = [a for a, _ in axes]
    shape = [n for _, n in axes]
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return JaxSharding(JaxMesh(devs, names), JaxP(*spec))


def _torch_sharding(axes, spec, device="cpu"):
    n = int(np.prod([s for _, s in axes]))
    return tmesh.NamedSharding(tmesh.make_mesh(dict(axes), [device] * n),
                               tmesh.P(*spec))


def test_matrix_is_the_reference_matrix():
    assert tici.DRYRUN_MATRIX == jici.DRYRUN_MATRIX


@pytest.mark.parametrize("n_slots", [1, 2])
@pytest.mark.parametrize("axes,spec", tici.DRYRUN_MATRIX, ids=MATRIX_IDS)
def test_plan_equals_reference(axes, spec, n_slots):
    shape = (16,) * len(spec)
    jsh = _jax_sharding(axes, spec)
    want = jici.plan_distribution(shape, np.float32, jsh, n_slots=n_slots)
    got = tici.plan_distribution(shape, np.float32, _torch_sharding(axes, spec),
                                 n_slots=n_slots)
    positions = {d: p for p, d in enumerate(jsh.mesh.devices.reshape(-1))}
    assert got.ring_positions == tuple(positions[d] for d in want.ring_devices)
    assert got.anchor == positions[want.anchor]
    for field in ("mode", "shape", "dtype", "split_dim", "split_axes",
                  "rest_axes", "wire_bytes", "payload_bytes", "peak_bytes",
                  "dst_shard_bytes", "peak_factor", "n_slots", "wire_dtype",
                  "encoded_bytes"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.legs == tuple(tici.RedistLeg(**vars(leg)) for leg in want.legs)


@pytest.mark.parametrize("axes,spec,shape,kw,match", [
    ((("dp", 4), ("tp", 2)), ("dp", "tp"), (16, 16), {}, "single split dim"),
    ((("dp", 8),), ("dp",), (12, 4), {}, "not divisible"),
    ((("dp", 8),), ("dp",), (16, 16), {"max_memory_factor": 1.0},
     "memory bound"),
    ((("dp", 2), ("fsdp", 4)), (None, None), (16, 16),
     {"max_memory_factor": 2.0}, "memory bound"),
])
def test_plan_errors_equal_reference(axes, spec, shape, kw, match):
    with pytest.raises(jici.PlanError, match=match):
        jici.plan_distribution(shape, np.float32, _jax_sharding(axes, spec), **kw)
    with pytest.raises(tici.PlanError, match=match):
        tici.plan_distribution(shape, np.float32, _torch_sharding(axes, spec),
                               **kw)


def test_encoded_wires_are_a_later_slice():
    sh = _torch_sharding((("dp", 8),), ("dp",))
    with pytest.raises(NotImplementedError, match="wire.py"):
        tici.plan_distribution((16, 4), np.float32, sh, wire_dtype="int8")
    with pytest.raises(NotImplementedError, match="wire.py"):
        tici.IciDistributor(sh, wire_dtype="bf16")
    with pytest.raises(ValueError, match="wire_dtype"):
        tici.plan_distribution((16, 4), np.float32, sh, wire_dtype="fp8")


def _shards_equal_reference(got, want, jmesh):
    """Shard by shard, by index: port position p against the reference's
    shard on the mesh's p-th device."""
    by_device = {s.device: s for s in want.addressable_shards}
    devices = jmesh.devices.reshape(-1)
    assert len(got.shards) == len(by_device)
    for s in got.shards:
        ref = by_device[devices[s.position]]
        assert s.index == ref.index
        assert s.data.is_contiguous()
        np.testing.assert_array_equal(s.data.numpy(), np.asarray(ref.data))


@pytest.mark.parametrize("axes,spec", tici.DRYRUN_MATRIX, ids=MATRIX_IDS)
def test_put_equals_reference(axes, spec):
    shape = (16,) * len(spec)
    x = np.random.default_rng(len(axes)).standard_normal(shape).astype(np.float32)
    jsh = _jax_sharding(axes, spec)
    jd = jici.IciDistributor(jsh, metrics=JaxMetrics())
    want = jd.put(x, jax.device_put)
    tsh = _torch_sharding(axes, spec)
    td = tici.IciDistributor(tsh, metrics=Metrics())
    got = td.put(x, device_put)
    assert not jd.faulted and not td.faulted
    assert td.metrics.counter("ici.windows") == 1
    assert td.metrics.counter("ici.fallbacks") == 0
    assert got.sharding is tsh and got.shape == shape
    _shards_equal_reference(got, want, jsh.mesh)
    np.testing.assert_array_equal(got.numpy(), x)


def test_plain_route_equals_reference_device_put():
    axes, spec = (("dp", 4), ("fsdp", 2)), (None, "dp")
    x = np.arange(16 * 8 * 3, dtype=np.int32).reshape(16, 8, 3)
    jsh = _jax_sharding(axes, spec)
    got = device_put(x, _torch_sharding(axes, spec))
    _shards_equal_reference(got, jax.device_put(x, jsh), jsh.mesh)
    assert all(s.data.data_ptr() != got.shards[0].data.data_ptr()
               for s in got.shards[1:])  # every position its own copy
    with pytest.raises(ValueError, match="divisible"):
        device_put(np.ones((10, 4), np.float32),
                   _torch_sharding((("dp", 8),), ("dp",)))


# -- the distributor's ladder ---------------------------------------------


def _dp8():
    return _torch_sharding((("dp", 8),), ("dp",))


def test_unplannable_geometry_takes_the_plain_route_once():
    m = Metrics()
    sh = _torch_sharding((("dp", 4), ("fsdp", 2)), ("dp", "fsdp"))
    dist = tici.IciDistributor(sh, metrics=m)
    x = np.arange(8 * 8, dtype=np.float32).reshape(8, 8)
    out = dist.put(x, device_put)
    assert not dist.faulted and m.counter("ici.fallbacks") == 1
    np.testing.assert_array_equal(out.numpy(), x)
    dist.put(x + 1.0, device_put)
    assert m.counter("ici.fallbacks") == 1  # counted once per geometry
    assert m.counter("ici.windows") == 0


def test_ragged_geometry_does_not_poison_the_tier():
    m = Metrics()
    dist = tici.IciDistributor(_dp8(), metrics=m)
    with pytest.raises(ValueError, match="divisible"):
        dist.put(np.ones((10, 4), np.float32), device_put)
    assert not dist.faulted and m.counter("ici.fallbacks") == 1
    window = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    np.testing.assert_array_equal(dist.put(window, device_put).numpy(), window)
    assert m.counter("ici.windows") == 1 and m.counter("ici.fallbacks") == 1


def test_plan_cache_serves_and_bounds():
    dist = tici.IciDistributor(_dp8())
    p1 = dist.plan((16, 4), np.float32)
    assert dist.plan((16, 4), np.float32) is p1
    for r in range(8, 80, 8):
        dist.plan((r, 2), np.float32)
    assert len(dist._plans) <= 8
    assert dist.plan((16, 4), torch.float32).shape == (16, 4)
    assert dist.anchor((16, 4), np.float32) == torch.device("cpu")


def test_failing_plain_kernel_latches_the_plain_route_on_the_cpu(monkeypatch):
    """The CPU's plain kernels keep the reference's tier-wide latch: the
    window still lands right, ``ici.fallbacks`` counts once, and later
    windows skip the tier."""
    m = Metrics()
    dist = tici.IciDistributor(_dp8(), metrics=m)
    calls = []

    def broken(block, n):
        calls.append(n)
        raise RuntimeError("injected leg failure")

    monkeypatch.setattr(tfan, "shard_plain", broken)
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    out = dist.put(x, device_put)
    assert dist.faulted and calls == [8]
    assert m.counter("ici.fallbacks") == 1 and m.counter("ici.windows") == 0
    np.testing.assert_array_equal(out.numpy(), x)
    np.testing.assert_array_equal(dist.put(x + 1, device_put).numpy(), x + 1)
    assert calls == [8] and m.counter("ici.fallbacks") == 1
    assert m.gauge("ici.slots_in_flight") == 0.0


def test_shutdown_propagates_without_latching(monkeypatch):
    m = Metrics()
    dist = tici.IciDistributor(_dp8(), metrics=m)

    def shutdown(block, n):
        raise ShutdownRequested("loader closing")

    monkeypatch.setattr(tfan, "shard_plain", shutdown)
    with pytest.raises(ShutdownRequested):
        dist.put(np.ones((16, 4), np.float32), device_put)
    assert not dist.faulted and m.counter("ici.fallbacks") == 0


def test_healthy_windows_count_bytes_slots_and_gauges():
    m = Metrics()
    dist = tici.IciDistributor(_dp8(), metrics=m, n_slots=2)
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    plan = dist.plan(x.shape, x.dtype)
    assert plan.n_slots == 2
    for _ in range(3):
        dist.put(x, device_put)
    assert m.counter("ici.windows") == 3
    assert m.counter("ici.bytes") == 3 * plan.wire_bytes
    assert m.gauge("ici.peak_bytes") == plan.peak_bytes
    assert m.gauge("ici.slots_in_flight.max") == 0.0  # CPU windows land at once
    assert m.timer("ici.fanout").count == 3
    assert m.timer("ici.redistribute").count == 3


def test_fused_gate_sets_the_slot_count(monkeypatch):
    monkeypatch.setenv("DDL_TORCH_FUSED", "0")
    assert not tici.fused_enabled()
    dist = tici.IciDistributor(_dp8(), metrics=Metrics())
    assert dist.n_slots == 1
    x = np.ones((16, 4), np.float32)
    assert dist.plan(x.shape, x.dtype).n_slots == 1
    np.testing.assert_array_equal(dist.put(x, device_put).numpy(), x)
    monkeypatch.delenv("DDL_TORCH_FUSED")
    assert tici.IciDistributor(_dp8()).n_slots == 2
    assert tici.IciDistributor(_dp8()).max_memory_factor == 6.0


# -- the ingest seam ------------------------------------------------------


def test_auto_takes_the_plain_route_on_the_cpu():
    ing = DeviceIngestor(sharding=_dp8())
    assert ing.distribute == "auto" and not ing.ici_active
    assert ing.device == torch.device("cpu")


def test_forced_ici_engages_and_xla_never_does():
    assert DeviceIngestor(sharding=_dp8(), distribute="ici").ici_active
    assert not DeviceIngestor(sharding=_dp8(), distribute="xla").ici_active


def test_invalid_mode_rejected():
    with pytest.raises(ValueError, match="ici|xla|auto"):
        DeviceIngestor(sharding=_dp8(), distribute="magic")


def test_single_position_never_engages():
    one = tmesh.NamedSharding(tmesh.make_mesh({"dp": 1}, ["cpu"]), tmesh.P("dp"))
    assert not DeviceIngestor(sharding=one, distribute="ici").ici_active
    assert not DeviceIngestor(device="cpu", distribute="ici").ici_active


def test_distinct_cards_are_the_multi_card_slice():
    sh = tmesh.NamedSharding(tmesh.make_mesh({"dp": 2}, ["cuda:0", "cuda:1"]),
                             tmesh.P("dp"))
    with pytest.raises(NotImplementedError, match="multi-card"):
        DeviceIngestor(sharding=sh, distribute="ici")


def test_put_batch_ici_equals_xla():
    batch = np.random.default_rng(0).random((32, 8)).astype(np.float32)
    ici = DeviceIngestor(sharding=_dp8(), distribute="ici", metrics=Metrics())
    xla = DeviceIngestor(sharding=_dp8(), distribute="xla", metrics=Metrics())
    a = ici.put_batch(batch, splits=(7, 1))
    b = xla.put_batch(batch, splits=(7, 1))
    for ca, cb, lo, hi in zip(a, b, (0, 7), (7, 8)):
        assert ca.shape == cb.shape == (32, hi - lo)
        assert [s.index for s in ca.shards] == [s.index for s in cb.shards]
        np.testing.assert_array_equal(ca.numpy(), cb.numpy())
        np.testing.assert_array_equal(ca.numpy(), batch[:, lo:hi])
    assert ici.ici().metrics.counter("ici.windows") == 1 and not ici.ici().faulted
    whole = ici.put_batch(batch, splits=(8,))
    np.testing.assert_array_equal(whole[0].numpy(), batch)


def test_column_split_across_positions_is_refused():
    sh = _torch_sharding((("dp", 2),), (None, "dp"))
    ing = DeviceIngestor(sharding=sh, distribute="xla")
    with pytest.raises(NotImplementedError, match="batch dim"):
        ing.put_batch(np.ones((4, 8), np.float32), splits=(6, 2))


# -- window streams through both loaders -----------------------------------

# (producer, mesh axes, window spec): dp=4 x fsdp=2 with the batch dim
# split (the ring gathers over fsdp, the finish moves the axis back),
# dp=8 over the leading dim, and a replicated window (K7's path).
STREAMS = [
    ("array", (("dp", 4), ("fsdp", 2)), (None, "dp")),
    ("tokens", (("dp", 8),), ("dp",)),
    ("tokens", (("dp", 2), ("fsdp", 4)), (None, None, None)),
]


@pytest.fixture(scope="module")
def stream_data(tmp_path_factory):
    path = os.path.join(tmp_path_factory.mktemp("ici"), "tokens.bin")
    np.random.default_rng(11).integers(0, 30_000, 20_000,
                                       dtype=np.int32).tofile(path)
    array = np.random.default_rng(12).standard_normal((96, 6)).astype(np.float32)
    return path, array


def _producer(pkg, kind, data):
    path, array = data
    if kind == "array":
        return pkg.readers.ArrayProducer(array, window_size=32, seed=3)
    return pkg.readers.TokenStreamProducer(path, 16, 64, seed=3)


def _jax_stream(kind, axes, spec, data):
    import ddl_tpu.readers  # noqa: F401 - pkg.readers below

    @ddl_tpu.distributed_dataloader(n_producers=2, mode="thread", nslots=2)
    def run(env):
        loader = ddl_tpu.DistributedDataLoader(
            _producer(ddl_tpu, kind, data), batch_size=8,
            connection=env.connection, n_epochs=2, output="jax",
            sharding=_jax_sharding(axes, spec), distribute="ici",
            metrics=JaxMetrics(),
        )
        out = [np.asarray(w).copy() for w in _drain(loader, ddl_tpu)]
        assert not loader._ingestor.ici().faulted
        return out

    return run()


def _torch_stream(kind, axes, spec, data, distribute):
    import ddl_tpu_torch.readers  # noqa: F401 - pkg.readers below

    @ddl_tpu_torch.distributed_dataloader(n_producers=2, mode="thread",
                                          nslots=2, pin_memory=False)
    def run(env):
        sh = _torch_sharding(axes, spec)
        loader = ddl_tpu_torch.DistributedDataLoader(
            _producer(ddl_tpu_torch, kind, data), batch_size=8,
            connection=env.connection, n_epochs=2, output="device",
            device="cpu", sharding=sh, distribute=distribute,
            metrics=Metrics(),
        )
        wins = list(_drain(loader, ddl_tpu_torch))
        for w in wins:
            assert w.sharding is sh
            assert all(s.data.is_contiguous() for s in w.shards)
        m = loader.metrics
        return [w.numpy() for w in wins], (m.counter("ici.windows"),
                                           m.counter("ici.fallbacks"))

    return run()


def _drain(loader, pkg):
    for win in loader.windows(lookahead=1):
        yield win
        loader.mark(pkg.Marker.END_OF_EPOCH)


@pytest.mark.parametrize("kind,axes,spec", STREAMS,
                         ids=[f"{k}-{s}" for k, _, s in STREAMS])
def test_window_streams_equal_xla_and_the_reference(kind, axes, spec,
                                                    stream_data):
    ici, (windows, fallbacks) = _torch_stream(kind, axes, spec, stream_data,
                                              "ici")
    xla, (xla_windows, _) = _torch_stream(kind, axes, spec, stream_data, "xla")
    want = _jax_stream(kind, axes, spec, stream_data)
    assert windows == 2 and fallbacks == 0 and xla_windows == 0
    assert len(ici) == len(xla) == len(want) == 2
    for a, b, w in zip(ici, xla, want):
        assert a.shape == w.shape and a.dtype == w.dtype
        assert a.tobytes() == b.tobytes() == w.tobytes()
