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


# -- spec trees, the shard_map boundary, the axes this slice takes -------------


def _tuple_axes(spec):
    return tuple(() if e is None else (e,) if isinstance(e, str) else tuple(e)
                 for e in tuple(spec))


@pytest.mark.parametrize("axes", [{"dp": 8}, {"dp": 2, "fsdp": 2, "tp": 2},
                                  {"dp": 2, "sp": 4}])
def test_named_and_prune_equal_the_references(axes):
    """``named`` drops axes the mesh lacks, ``prune_indivisible`` those
    that do not divide their dimension: each leaf's spec equals the JAX
    package's ``_named`` / ``_prune_indivisible`` (axes as tuples)."""
    from ddl_tpu.parallel import train as jtrain

    specs = {"a": JaxP("fsdp", "tp"), "b": [JaxP(None, ("dp", "tp")),
                                            JaxP(("fsdp", "sp"))],
             "c": JaxP(None)}
    tspecs = {"a": tmesh.P("fsdp", "tp"), "b": [tmesh.P(None, ("dp", "tp")),
                                                tmesh.P(("fsdp", "sp"))],
              "c": tmesh.P(None)}
    shapes = {"a": (12, 8), "b": [(6, 16), (8,)], "c": (5,)}
    jm = jmesh.make_mesh(axes)
    tm = tmesh.make_mesh(axes, ["cpu"] * 8)
    jn = jtrain._named(jm, specs)
    tn = tmesh.named(tm, tspecs)
    for path in (("a",), ("b", 0), ("b", 1), ("c",)):
        j, t, shape = jn, tn, shapes
        for k in path:
            j, t, shape = j[k], t[k], shape[k]
        assert _tuple_axes(t.spec) == _tuple_axes(j.spec)
        jp = jtrain._prune_indivisible(j, np.zeros(shape))
        tp = tmesh.prune_indivisible(t, torch.zeros(shape))
        assert _tuple_axes(tp.spec) == _tuple_axes(jp.spec)


def test_shard_and_assemble_round_trip_with_grads():
    mesh = tmesh.make_mesh({"dp": 2, "sp": 2, "tp": 2}, ["cpu"] * 8)
    x = torch.randn(4, 6, 3, requires_grad=True)
    sh = tmesh.NamedSharding(mesh, tmesh.P("dp", "sp"))
    arr = tmesh.shard(x, sh)
    assert [tuple(s.data.shape) for s in arr.shards] == [(2, 3, 3)] * 8
    out = arr.assemble()
    assert torch.equal(out, x.detach())
    (out * 2).sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 2.0))
    sub = mesh.sub_mesh(("dp", None, "sp"))
    assert sub.shape == {"dp": 2, "sp": 2}
    assert sub.device_list == [torch.device("cpu")] * 4


def test_pipeline_axis_waits_for_a5b():
    """The pipeline axis is ported: a ``pp`` mesh builds, one process's
    positions.  Positions of a ``pp`` (or any inner) axis that span
    processes raise, naming A5c; the outermost ``dp`` may span them."""
    mesh = tmesh.make_mesh({"dp": 2, "pp": 4}, ["cpu"] * 8)
    assert mesh.shape == {"dp": 2, "pp": 4} and not mesh.spans_processes
    tmesh.Mesh(np.array(["cpu"] * 2), ("pp",))
    grid = np.array(["cpu"] * 4).reshape(2, 2)
    procs = [[0, 0], [1, 1]]
    spanning = tmesh.Mesh(grid, ("dp", "pp"), processes=procs)
    assert spanning.spans_processes
    assert spanning.local_positions() == [0, 1]
    assert spanning.local().shape == {"dp": 1, "pp": 2}
    assert spanning.sub_mesh(("pp",)).shape == {"pp": 2}
    for names in (("pp", "dp"), ("sp", "dp"), ("tp", "pp")):
        with pytest.raises(NotImplementedError, match="A5c"):
            tmesh.Mesh(grid, names, processes=procs)
    with pytest.raises(NotImplementedError, match="A5c"):
        tmesh.Mesh(grid, ("dp", "pp"), processes=[[0, 1], [0, 1]])
    arr = tmesh.ShardedArray((4, 3), tmesh.NamedSharding(spanning, tmesh.P("dp")),
                             [torch.zeros(2, 3)] * 2)
    with pytest.raises(ValueError, match="process_allgather"):
        arr.assemble()
    assert arr.assemble_local().shape == (2, 3)


def test_shard_refuses_distinct_cards():
    mesh = tmesh.Mesh(["cuda:0", "cuda:1"], ("sp",))
    with pytest.raises(NotImplementedError, match="distinct cards"):
        tmesh.shard(torch.zeros(4), tmesh.NamedSharding(mesh, tmesh.P("sp")))
