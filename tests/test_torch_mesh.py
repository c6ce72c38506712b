"""The port's mesh, sharding and sharded-array types against
``ddl_tpu.parallel.mesh`` and ``jax.sharding`` on the conftest's
8-device CPU mesh: the same axes give the same layout, and a spec gives
every position the index JAX gives the device at that position."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JaxSharding
from jax.sharding import PartitionSpec as JaxP

from ddl_tpu.parallel import mesh as jmesh
from ddl_tpu_torch.parallel import mesh as tmesh


@pytest.mark.parametrize("axes", [
    None, {"dp": 8}, {"dp": -1, "tp": 2}, {"dp": 2, "fsdp": 2, "tp": 2},
    {"dp": 4, "fsdp": -1},
])
def test_make_mesh_equals_reference(axes):
    want = jmesh.make_mesh(axes)
    got = tmesh.make_mesh(axes, ["cpu"] * 8)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert got.size == want.size == 8
    assert got.positions().shape == want.devices.shape
    assert got.device_list == [torch.device("cpu")] * 8


@pytest.mark.parametrize("axes,match", [
    ({"dp": 3}, "need 3"), ({"dp": -1, "tp": -1}, "at most one"),
    ({"dp": -1, "tp": 3}, "not divisible"),
])
def test_make_mesh_refusals_equal_reference(axes, match):
    with pytest.raises(ValueError, match=match):
        jmesh.make_mesh(axes)
    with pytest.raises(ValueError, match=match):
        tmesh.make_mesh(axes, ["cpu"] * 8)


def test_data_parallel_mesh():
    m = tmesh.data_parallel_mesh(4, ["cuda:0"] * 8)
    assert m.shape == {"dp": 4} and m.device_list == [torch.device("cuda", 0)] * 4


@pytest.mark.parametrize("axes,spec,shape", [
    ({"dp": 8}, ("dp",), (16, 3)),
    ({"dp": 4, "fsdp": 2}, (None, "dp"), (2, 8, 5)),
    ({"dp": 4, "fsdp": 2}, (("dp", "fsdp"), None), (16, 4)),
    ({"dp": 2, "fsdp": 2, "tp": 2}, ("tp", ("fsdp", "dp")), (4, 8)),
    ({"dp": 2, "fsdp": 4}, (None, None), (3, 5)),
    ({"dp": 8}, (), (8, 2)),
])
def test_shard_indices_equal_jax(axes, spec, shape):
    jm = jmesh.make_mesh(axes)
    want = JaxSharding(jm, JaxP(*spec)).devices_indices_map(shape)
    got = tmesh.NamedSharding(tmesh.make_mesh(axes, ["cpu"] * 8),
                              tmesh.P(*spec))
    devices = jm.devices.reshape(-1)
    assert got.shard_indices(shape) == [want[d] for d in devices]
    assert got.shard_shape(shape) == JaxSharding(
        jm, JaxP(*spec)).shard_shape(shape)


def test_sharding_refusals():
    m = tmesh.make_mesh({"dp": 4}, ["cpu"] * 4)
    with pytest.raises(ValueError, match="not in"):
        tmesh.NamedSharding(m, tmesh.P("tp"))
    with pytest.raises(ValueError, match="twice"):
        tmesh.NamedSharding(m, tmesh.P("dp", "dp"))
    with pytest.raises(ValueError, match="divisible"):
        tmesh.NamedSharding(m, tmesh.P("dp")).shard_indices((6, 2))
    with pytest.raises(ValueError, match="more entries"):
        tmesh.NamedSharding(m, tmesh.P(None, None, "dp")).shard_indices((4, 4))


def test_sharded_array_assembles_like_jax():
    axes, spec, shape = {"dp": 4, "fsdp": 2}, (None, "dp"), (3, 8, 2)
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    jm = jmesh.make_mesh(axes)
    want = jax.device_put(x, JaxSharding(jm, JaxP(*spec)))
    sh = tmesh.NamedSharding(tmesh.make_mesh(axes, ["cpu"] * 8), tmesh.P(*spec))
    t = torch.from_numpy(x)
    arr = tmesh.ShardedArray(shape, sh, [t[i].clone()
                                         for i in sh.shard_indices(shape)])
    assert arr.nbytes == want.nbytes
    assert [s.position for s in arr.shards] == list(range(8))
    np.testing.assert_array_equal(arr.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="shard"):
        tmesh.ShardedArray(shape, sh, [t] * 8)


def test_one_card_counts_cards_not_positions():
    assert tmesh.one_card(["cuda:0"] * 4) == torch.device("cuda", 0)
    assert tmesh.one_card(["cpu"] * 3) == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="multi-card"):
        tmesh.one_card(["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="mix"):
        tmesh.one_card(["cpu", "cuda:0"])
