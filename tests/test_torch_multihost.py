"""MULTIHOST in the port: host identity, a two-process gloo run on the
CPU, and the ``"xla"`` exchange route.

- ``detect_host_identity`` equals the JAX package's over a matrix of
  arguments and environments (``DDL_TORCH_*`` against ``DDL_TPU_*``, the
  SLURM variables shared).
- Two OS processes run ``tests/torch_multihost_prog.py`` (legs ``core``,
  ``stream``, ``ppdp``, ``dpep``, ``dpsp``, ``ckpt``, ``packed``,
  ``evaluate``) over
  a gloo group, each with its own
  PROCESS producers, as ``tests/test_multihost.py`` runs the JAX
  package's program.  Each process's batch and window streams equal the
  JAX package's for ``Topology(n_instances=2, instance_idx=i)`` byte for
  byte; the losses equal a one-process run of the port over the same
  global mesh and batches within ``rtol 1e-5`` (the gloo sum and the
  smaller microbatches change the order of the additions; the first
  readings were 8.8e-8 for ``core`` and 1.0e-7 for ``ppdp``); the cross-process shuffle keeps the multiset
  of rows, moves some, and equals the one-process shuffler's pool byte
  for byte; the checkpoint round trip (rank 0 writes, every rank
  restores and fast-forwards) passes inside the program.  The ``packed``
  leg's processes keep different token counts, and its losses still
  equal the one-process run (the step weights each process's loss and
  grads by its count); ``evaluate`` returns one value on every process,
  the one-process value over the global batches (rtol 1e-6), for a row
  metric and for a masked ``cross_entropy`` metric.  The ``chaos`` leg
  (the JAX package's cross-host elastic leg) loses a producer and then a
  whole mock host in process 1 under a gloo ``all_reduce`` a window:
  both processes serve every shard byte-correct, with the reference
  leg's counters (one respawn, one host loss, no watchdog failure).  The
  JAX package's leg runs beside it in the same fixture
  (``tests/torch_chaos_reference.py`` records what it served), and each
  process's served shard sequence, counters, view epoch and lost ranks
  are held to it.
- The ``"xla"`` exchange (two ``ppermute`` lane moves) equals the
  ``"ring"`` route and the lanes ``exchange_permutation`` gives, byte for
  byte.
"""

import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import torch_multihost_prog as prog
from ddl_tpu import env as jenv
from ddl_tpu_torch import env as tenv

_PROG = os.path.join(os.path.dirname(__file__), "torch_multihost_prog.py")
_REF_CHAOS = os.path.join(os.path.dirname(__file__), "torch_chaos_reference.py")
_TIMEOUT_S = 240
RTOL = 1e-5


# -- host identity ---------------------------------------------------------------


_ID_ENV = ("HOST_ID", "N_HOSTS", "PROCS_PER_HOST")
_SLURM = ("SLURM_NODEID", "SLURM_NNODES", "SLURM_NTASKS_PER_NODE")


@pytest.mark.parametrize("args,env", [
    ((1, 0, None, None), {}),
    ((4, 3, None, None), {}),
    ((4, 3, None, None), {"PROCS_PER_HOST": "2"}),
    ((8, 5, None, None), {"SLURM_NTASKS_PER_NODE": "4"}),
    ((8, 5, None, None), {"SLURM_NODEID": "3", "SLURM_NNODES": "4"}),
    ((8, 5, None, None), {"SLURM_NODEID": "3"}),
    ((2, 1, None, None), {"HOST_ID": "6", "N_HOSTS": "8"}),
    ((2, 1, None, None), {"HOST_ID": "6"}),
    ((2, 1, None, None), {"N_HOSTS": "3", "PROCS_PER_HOST": "1"}),
    ((2, 1, 5, None), {"N_HOSTS": "2"}),
    ((2, 1, 0, 1), {"HOST_ID": "4", "SLURM_NODEID": "2", "SLURM_NNODES": "3"}),
    ((4, 2, None, 2), {"SLURM_NTASKS_PER_NODE": "2"}),
    ((3, 2, None, None), {"PROCS_PER_HOST": "0"}),
])
def test_detect_host_identity_matches_reference(args, env, monkeypatch):
    for name in _ID_ENV:
        for prefix in ("DDL_TORCH_", "DDL_TPU_"):
            monkeypatch.delenv(prefix + name, raising=False)
    for name in _SLURM:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        if name in _ID_ENV:
            monkeypatch.setenv("DDL_TORCH_" + name, value)
            monkeypatch.setenv("DDL_TPU_" + name, value)
        else:
            monkeypatch.setenv(name, value)
    assert tenv.detect_host_identity(*args) == jenv.detect_host_identity(*args)


def test_topology_carries_host_identity(monkeypatch):
    """``LoaderConfig``'s identity reaches the topology, and a MULTIHOST
    run without an initialised group is one instance (no quiet
    reduction: the reference reads ``jax.process_count() == 1``)."""
    for name in _ID_ENV:
        monkeypatch.delenv("DDL_TORCH_" + name, raising=False)
    topo = tenv.detect_topology(2, "multihost", host_id=3, n_hosts=4)
    want = jenv.detect_topology(2, "multihost", host_id=3, n_hosts=4)
    assert (topo.n_instances, topo.instance_idx, topo.host_id, topo.n_hosts) == (
        want.n_instances, want.instance_idx, want.host_id, want.n_hosts)
    with pytest.raises(ValueError, match="out of range"):
        from ddl_tpu_torch.types import Topology

        Topology(host_id=2, n_hosts=2)


# -- the two-process gloo run ---------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """Run the two-process program once; its per-process records.  The
    JAX package's ``chaos`` leg runs at the same time in two processes of
    its own: its reports and exit codes are under ``("chaos_ref", i)``."""
    out = tmp_path_factory.mktemp("mh-out")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    ref_env = dict(env, DDL_MH_PROCS="2", DDL_MH_DEVS="2", DDL_MH_LEGS="chaos")
    coord = f"127.0.0.1:{_free_port()}"
    ref_procs = [subprocess.Popen(
        [sys.executable, _REF_CHAOS, str(i), coord, str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=ref_env) for i in range(2)]
    tokens = out / "tokens.bin"
    np.random.default_rng(5).integers(0, 64, 20_000, dtype=np.int32).tofile(tokens)
    env.update(DDL_TORCH_MH_PROCS="2", DDL_TORCH_MH_DEVS="2",
               DDL_TORCH_MH_LEGS=("core,stream,ppdp,dpep,dpsp,ckpt,packed,"
                                  "evaluate,chaos"),
               DDL_TORCH_MH_OUT=str(out), DDL_TORCH_MH_TOKENS=str(tokens),
               DDL_TORCH_MH_DIR=str(tmp_path_factory.mktemp("mh-ckpt")))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, _PROG, str(i), port],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for i in range(2)]
    outs = []
    try:
        for p in procs + ref_procs:
            text, _ = p.communicate(timeout=_TIMEOUT_S)
            outs.append(text)
    except subprocess.TimeoutExpired:
        for p in procs + ref_procs:
            p.kill()
        pytest.fail("multihost program timed out (deadlock?); partial "
                    "output:\n" + "\n---\n".join(outs))
    for i, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} rc={p.returncode}:\n{text}"
        assert f"MULTIHOST OK process={i}" in text, text
    records = {(leg, i): dict(np.load(out / f"{leg}_{i}.npz"))
               for leg in ("core", "stream", "ppdp", "dpep", "dpsp", "ckpt",
                           "packed", "evaluate", "chaos")
               for i in range(2)}
    for i, (p, text) in enumerate(zip(ref_procs, outs[2:])):
        path = out / f"chaos_ref_{i}.json"
        records[("chaos_ref", i)] = dict(
            rc=p.returncode, output=text,
            report=json.loads(path.read_text()) if path.exists() else None)
    return records


def _jax_batches(instance, producer_cls, epochs=2):
    """The JAX package's batch stream of one instance of a 2-instance
    topology: its two producers in threads, its loader drained."""
    from ddl_tpu import dataloader, datapusher, types
    from ddl_tpu.observability import Metrics
    from ddl_tpu.transport import connection as conn

    topo = types.Topology(n_instances=2, instance_idx=instance,
                          n_producers=prog.N_PRODUCERS)
    ends, threads = [], []
    for idx in range(1, prog.N_PRODUCERS + 1):
        cons_end, prod_end = conn.ThreadChannel.pair()
        ends.append(cons_end)
        pconn = conn.ProducerConnection(prod_end, idx, cross_process=False)

        def push(pconn=pconn, idx=idx):
            datapusher.DataPusher(pconn, topo, idx, metrics=Metrics()).push_data()

        t = threading.Thread(target=push, daemon=True)
        t.start()
        threads.append(t)
    loader = dataloader.DistributedDataLoader(
        producer_cls(instance, pkg="jax"), batch_size=prog.BATCH,
        connection=conn.ConsumerConnection(ends), n_epochs=epochs,
        output="numpy", metrics=Metrics())
    batches = []
    for _ in range(epochs):
        for cols in loader:
            batches.append(tuple(np.array(c, copy=True) for c in cols))
            loader.mark(types.Marker.END_OF_BATCH)
        loader.mark(types.Marker.END_OF_EPOCH)
    loader.shutdown()
    for t in threads:
        t.join(30)
    return batches


def test_processes_own_distinct_shared_memory_rings(cluster):
    """Two consumers on one machine share ``/dev/shm``: each process's
    PROCESS producers made rings of their own (names carry the pid and a
    uuid), none shared with the other process."""
    a = set(cluster[("core", 0)]["rings"].tolist())
    b = set(cluster[("core", 1)]["rings"].tolist())
    assert len(a) == len(b) == prog.N_PRODUCERS
    assert not a & b


@pytest.mark.parametrize("instance", [0, 1])
def test_batch_streams_equal_jax(cluster, instance):
    want = _jax_batches(instance, prog.TaggedProducer)
    rec = cluster[("core", instance)]
    np.testing.assert_array_equal(rec["x"], np.stack([b[0] for b in want]))
    np.testing.assert_array_equal(rec["y"], np.stack([b[1] for b in want]))


@pytest.mark.parametrize("instance", [0, 1])
def test_window_streams_equal_jax(cluster, instance):
    """The ``stream`` leg's local blocks (each window's rows of this
    process) are the JAX package's batches of that window, in order."""
    want = _jax_batches(instance, prog.TaggedProducer)
    bpw = prog.N_DATA // prog.BATCH
    wins = cluster[("stream", instance)]["windows"]
    for e, win in enumerate(wins):
        batches = want[e * bpw:(e + 1) * bpw]
        expect = np.stack([np.concatenate(b, axis=1) for b in batches])
        np.testing.assert_array_equal(win, expect)


@pytest.mark.parametrize("instance", [0, 1])
def test_token_streams_equal_jax(cluster, instance):
    want = _jax_batches(instance, prog.TokenProducer)
    np.testing.assert_array_equal(cluster[("ppdp", instance)]["tokens"],
                                  np.stack([b[0] for b in want]))


def test_core_losses_equal_one_process_run(cluster):
    """The dp step over both processes (grads and loss averaged in one
    gloo bucket) against the port's one-process step over the same global
    mesh and the concatenated batches."""
    from ddl_tpu_torch.parallel.mesh import NamedSharding, P, make_mesh
    from ddl_tpu_torch.parallel.train import make_train_step

    c0, c1 = cluster[("core", 0)], cluster[("core", 1)]
    np.testing.assert_array_equal(c0["losses"], c1["losses"])
    np.testing.assert_array_equal(c0["w"], c1["w"])
    mesh = make_mesh({"dp": 4}, ["cpu"] * 4)
    init_fn, step_fn = make_train_step(
        prog.linear_loss, lambda ps: torch.optim.SGD(ps, lr=prog.LR),
        mesh=mesh, param_specs={"w": P(None)}, batch_spec=P(("dp",)))
    state = init_fn({"w": np.zeros((prog.N_VALUES - 1,), np.float32)})
    sh = NamedSharding(mesh, P("dp"))
    from ddl_tpu_torch.ingest import make_global_array

    losses = []
    for k in range(len(c0["losses"])):
        gx = make_global_array(np.concatenate([c0["x"][k], c1["x"][k]]), sh)
        gy = make_global_array(np.concatenate([c0["y"][k], c1["y"][k]]), sh)
        state, loss = step_fn(state, (gx, gy))
        losses.append(float(loss))
    np.testing.assert_allclose(c0["losses"], losses, rtol=RTOL)
    np.testing.assert_allclose(c0["w"], state.params["w"].detach().numpy(),
                               rtol=RTOL, atol=1e-9)


def test_ppdp_losses_equal_one_process_run(cluster):
    """The pipelined loss over each process's pp pair, dp across the
    processes, against the port's one-process run over the same global
    ``{"dp": 2, "pp": 2}`` mesh and the concatenated token batches."""
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.ingest import make_global_array
    from ddl_tpu_torch.parallel.mesh import NamedSharding, P, make_mesh
    from ddl_tpu_torch.parallel.train import make_train_step

    r0, r1 = cluster[("ppdp", 0)], cluster[("ppdp", 1)]
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    mesh = make_mesh({"dp": 2, "pp": 2}, ["cpu"] * 4)
    init_fn, step_fn = make_train_step(
        prog.pp_loss(mesh), lambda ps: torch.optim.SGD(ps, lr=1e-2),
        mesh=mesh, param_specs=llama.pp_param_specs(prog.pp_cfg()),
        batch_spec=P(("dp",)))
    state = init_fn(prog.pp_params())
    sh = NamedSharding(mesh, P(("dp",)))
    losses = []
    for k in range(len(r0["losses"])):
        tok = make_global_array(np.concatenate([r0["tokens"][k], r1["tokens"][k]]), sh)
        state, loss = step_fn(state, (tok,))
        losses.append(float(loss))
    np.testing.assert_allclose(r0["losses"], losses, rtol=RTOL)
    assert all(np.isfinite(losses))


def test_dpep_moe_routes_the_global_batch(cluster):
    """The einsum MoE at a binding capacity over ``{"dp": 2, "ep": 2}``,
    dp across the processes: routed as the global batch (capacity from
    the global token count, arrival slots offset by the other process's
    picks, the aux each process's additive share), the losses equal the
    port's one-process run over the same global mesh and the
    concatenated batches within ``RTOL``.  The control, each process
    routing its own rows, misses that tolerance."""
    from ddl_tpu_torch.ingest import make_global_array
    from ddl_tpu_torch.models import moe
    from ddl_tpu_torch.parallel.mesh import NamedSharding, P, make_mesh
    from ddl_tpu_torch.parallel.train import make_train_step

    r0, r1 = cluster[("dpep", 0)], cluster[("dpep", 1)]
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    np.testing.assert_array_equal(r0["control"], r1["control"])
    mesh = make_mesh({"dp": 2, "ep": 2}, ["cpu"] * 4)
    init_fn, step_fn = make_train_step(
        prog.moe_loss(mesh), lambda ps: torch.optim.SGD(ps, lr=1e-2),
        mesh=mesh, param_specs=moe.param_specs(prog.moe_cfg()),
        batch_spec=P(("dp",)))
    state = init_fn(moe.init_params(prog.moe_cfg(), seed=0, device="cpu"))
    sh = NamedSharding(mesh, P(("dp",)))
    losses = []
    for k in range(len(r0["losses"])):
        tok = make_global_array(np.concatenate([r0["tokens"][k], r1["tokens"][k]]), sh)
        state, loss = step_fn(state, (tok,))
        losses.append(float(loss))
    np.testing.assert_allclose(r0["losses"], losses, rtol=RTOL)
    gap = np.abs(r0["control"] - losses) / np.abs(losses)
    assert gap.max() > RTOL, gap


def test_trainer_fit_in_multihost_mode_equals_one_process_run(cluster):
    """``Trainer.fit(config=LoaderConfig(mode="multihost"))`` over
    ``{"dp": 2, "sp": 2}``: each process's windows are its own
    instance's (the two differ), the processes report the same global
    losses, and those equal a one-process multistep over the same global
    mesh and the joined windows within ``RTOL``."""
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.parallel.mesh import P, make_mesh
    from ddl_tpu_torch.parallel.train import adamw, make_multistep

    r0, r1 = cluster[("dpsp", 0)], cluster[("dpsp", 1)]
    assert not np.array_equal(r0["windows"], r1["windows"])
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    mesh = make_mesh({"dp": 2, "sp": 2}, ["cpu"] * 4)
    cfg = prog.pp_cfg()
    wins = np.concatenate([r0["windows"], r1["windows"]], axis=2)
    init_fn, multi = make_multistep(
        lambda p, b: llama.next_token_loss(p, b[0], cfg, mesh=mesh),
        adamw(1e-3), mesh=mesh, param_specs=llama.param_specs(cfg),
        batch_spec=P(("dp",), "sp"), n_steps=wins.shape[1])
    state = init_fn(llama.init_params(cfg, seed=0, device="cpu"))
    losses = []
    for w in wins:
        state, ls = multi(state, (torch.from_numpy(w),), per_step=True)
        losses.append(float(ls.mean()))
    np.testing.assert_allclose(r0["losses"], losses, rtol=RTOL)


def test_packed_losses_equal_one_process_run(cluster):
    """The twin of the JAX package's packed leg: each process streams its
    own packed documents into a global window and takes one
    segment-masked step a window.  The processes keep different token
    counts in some step, and the losses (and so the updates) still equal
    a one-process run over the joined windows within ``RTOL``."""
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.parallel.mesh import P, make_mesh
    from ddl_tpu_torch.parallel.train import make_train_step

    r0, r1 = cluster[("packed", 0)], cluster[("packed", 1)]
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    assert (r0["counts"] != r1["counts"]).any(), (r0["counts"], r1["counts"])
    for r in (r0, r1):
        assert list(r["counts"]) == [prog.packed_count(w) for w in r["windows"]]
    mesh = make_mesh({"dp": 4}, ["cpu"] * 4)
    init_fn, step_fn = make_train_step(
        prog.packed_loss, lambda ps: torch.optim.SGD(ps, lr=1e-2), mesh=mesh,
        param_specs=llama.param_specs(prog.pp_cfg()), batch_spec=P(None, ("dp",)))
    state = init_fn(llama.init_params(prog.pp_cfg(), seed=0, device="cpu"))
    losses = []
    for w0, w1 in zip(r0["windows"], r1["windows"]):
        state, loss = step_fn(state, torch.from_numpy(np.concatenate([w0, w1], 1)))
        losses.append(float(loss))
    np.testing.assert_allclose(r0["losses"], losses, rtol=RTOL)


@pytest.mark.parametrize("metric", ["tag", "masked"])
def test_evaluate_returns_the_global_value(cluster, metric):
    """``Trainer.evaluate`` over ``{"dp": 4}`` spanning both processes:
    one value on every process, equal to the mean over the global batches
    of the metric on the joined rows (rtol 1e-6) — for the masked metric
    the processes' counts differ, so a mean of their means would miss."""
    fn = {"tag": prog.tag_metric, "masked": prog.masked_metric}[metric]
    e0, e1 = cluster[("evaluate", 0)], cluster[("evaluate", 1)]
    assert float(e0[metric]) == float(e1[metric])
    b0, b1 = e0[f"{metric}_batches"], e1[f"{metric}_batches"]
    assert len(b0) == len(b1) > 0

    def split(rows):
        t = torch.from_numpy(rows)
        return t[:, :prog.N_VALUES - 1], t[:, prog.N_VALUES - 1:]

    joined = [float(fn(None, split(np.concatenate([x, y]))))
              for x, y in zip(b0, b1)]
    np.testing.assert_allclose(float(e0[metric]), np.mean(joined), rtol=1e-6)
    if metric == "masked":
        means = [(float(fn(None, split(x))) + float(fn(None, split(y)))) / 2
                 for x, y in zip(b0, b1)]
        assert abs(np.mean(means) - np.mean(joined)) > 1e-4 * abs(np.mean(joined))


def test_cross_process_shuffle_keeps_rows_and_equals_one_process(cluster):
    """``DeviceGlobalShuffler`` lanes crossed processes over gloo: the
    multiset of rows is kept, rows moved, and the pool equals the
    one-process shuffler's over the same global window byte for byte."""
    from ddl_tpu_torch.parallel.collectives import DeviceGlobalShuffler
    from ddl_tpu_torch.parallel.mesh import NamedSharding, P, make_mesh, shard

    before, after = cluster[("core", 0)]["before"], cluster[("core", 0)]["after"]
    np.testing.assert_array_equal(before, cluster[("core", 1)]["before"])
    np.testing.assert_array_equal(after, cluster[("core", 1)]["after"])
    assert sorted(before[:, 0].tolist()) == sorted(after[:, 0].tolist())
    assert not np.array_equal(before, after)
    mesh = make_mesh({"dp": 4}, ["cpu"] * 4)
    one = DeviceGlobalShuffler(mesh, num_exchange=2, seed=3).shuffle(
        shard(torch.from_numpy(before), NamedSharding(mesh, P("dp"))))
    np.testing.assert_array_equal(one.numpy(), after)


def test_checkpoint_round_trip(cluster):
    """Every rank restored rank 0's generation (sync and async), fast-
    forwarded its loader and trained on: the resumed losses agree."""
    a, b = cluster[("ckpt", 0)]["losses"], cluster[("ckpt", 1)]["losses"]
    assert len(a) > 0
    np.testing.assert_array_equal(a, b)


# -- the "xla" exchange route ------------------------------------------------------------


@pytest.mark.parametrize("n,half,cols,seed,round_", [
    (2, 3, 4, 7, 0), (3, 2, 5, 1, 4), (4, 4, 3, 7, 2), (8, 1, 6, 11, 9),
])
def test_xla_exchange_equals_ring_and_permutation(n, half, cols, seed, round_):
    from ddl_tpu_torch.ops import device_shuffle as dsh
    from ddl_tpu_torch.shuffle import exchange_permutation, inverse_permutation

    gin = torch.arange(n * 2 * half * cols, dtype=torch.float32).reshape(
        n * 2 * half, cols)
    p = exchange_permutation(n, seed, round_)
    xla = dsh.exchange_start("xla", gin, ["cpu"] * n, p)
    ring = dsh.exchange_start("ring", gin, ["cpu"] * n, p)
    assert torch.equal(xla, ring)
    blocks = gin.reshape(n, 2 * half, cols)
    out = xla.reshape(n, 2 * half, cols)
    pinv = inverse_permutation(p)
    for i in range(n):
        assert torch.equal(out[p[i], :half], blocks[i, :half])
        assert torch.equal(out[pinv[i], half:], blocks[i, half:])
    with pytest.raises(ValueError, match="ring|xla"):
        dsh.exchange_start("pallas", gin, ["cpu"] * n, p)


def test_xla_fabric_streams_equal_ring_fabric():
    """A two-instance drain through a ``DeviceExchangeFabric(impl="xla")``
    serves the same bytes as one through the ring fabric."""
    from test_torch_shuffle import drain

    from ddl_tpu_torch.shuffle import DeviceExchangeFabric, DeviceExchangeShuffler

    streams = {}
    for impl in ("ring", "xla"):
        fabric = DeviceExchangeFabric(devices=["cpu"] * 2, impl=impl)
        out = drain("torch", lambda: DeviceExchangeShuffler.factory(fabric=fabric))
        streams[impl] = out
        assert fabric.legs >= 1
    for i in (0, 1):
        np.testing.assert_array_equal(streams["ring"][i][0], streams["xla"][i][0])


@pytest.mark.parametrize("rank", [0, 1])
def test_chaos_leg_recovers_both_rungs(cluster, rank):
    """The reference chaos leg's gates (``tests/multihost_prog.py``):
    every shard served byte-correct in both processes (the program checks
    each window against its shard's pattern); in process 1 the producer
    crash was respawned and the whole mock host declared lost, with no
    watchdog failure; process 0 never changed its view."""
    rec = cluster[("chaos", rank)]
    assert rec["shards"].tolist() == list(range(prog.CH_SHARDS))
    assert int(rec["counts"].sum()) == prog.CH_EPOCHS
    assert float(rec["watchdog.failures"]) == 0.0
    if rank == 1:
        assert float(rec["watchdog.respawns"]) == 1.0
        assert float(rec["cluster.host_losses"]) == 1.0
        assert float(rec["cluster.view_changes"]) == 1.0
        assert int(rec["epoch"]) == 1 and rec["lost"].tolist() == [2]
        assert float(rec["cluster.shard_adoptions"]) >= 1.0
        assert float(rec["consumer.pool_updates"]) >= 2.0
    else:
        assert float(rec["watchdog.respawns"]) == 0.0
        assert float(rec["cluster.host_losses"]) == 0.0
        assert int(rec["epoch"]) == 0 and rec["lost"].tolist() == []


def _survivor_switch(suffix, first_it):
    """The fill at which process 1's surviving producer took up the
    adopted ranges, or None when ``suffix`` (the shards served after the
    host kill) is no such stream.  The survivor serves its fills
    ``first_it, first_it + 1, ...`` in order; a fill ``it`` before the
    adoption reached it walks its own shards (0, 1), after it all four.
    Where it took them up depends on how far the producer had filled
    ahead of the consumer when the adoption arrived: at most a ring's
    depth."""
    for k in range(first_it, first_it + len(suffix) + 1):
        if suffix == [it % 2 if it < k else it % prog.CH_SHARDS
                      for it in range(first_it, first_it + len(suffix))]:
            return k
    return None


@pytest.mark.parametrize("rank", [0, 1])
def test_chaos_leg_equals_jax_leg(cluster, rank):
    """The port's chaos leg against the JAX package's, run at the same
    time on the same geometry: equal counters, view epoch and lost ranks,
    and the same shard sequence where it is fixed.  Process 0 loses
    nothing, so its whole sequence is.  Process 1's is up to the host
    kill (6 windows: each producer's walk, the respawned one replaying to
    its predecessor's position); after it the survivor serves its fills
    from the 4th on, taking up the adopted ranges at a fill that depends
    on how far it had filled ahead: each package's stream must be that
    walk, and the per-shard counts follow from where it switched (the
    7th fill in both packages in every run seen so far, which gives
    equal sequences)."""
    ref = cluster[("chaos_ref", rank)]
    assert ref["rc"] == 0 and ref["report"] is not None, ref["output"][-4000:]
    want, rec = ref["report"], cluster[("chaos", rank)]
    got = rec["sequence"].tolist()
    assert rec["shards"].tolist() == want["shards"]
    assert int(rec["epoch"]) == want["epoch"]
    assert rec["lost"].tolist() == want["lost"]
    for c in prog.CHAOS_COUNTERS:
        assert float(rec[c]) == want[c], c
    assert len(got) == len(want["sequence"]) == prog.CH_EPOCHS
    if rank == 0:
        assert got == want["sequence"]
        assert rec["counts"].tolist() == want["counts"]
        return
    assert got[:6] == want["sequence"][:6] == [0, 2, 1, 3, 0, 2]
    for seq in (got, want["sequence"]):
        # The adoption lands within the survivor's ring (2 slots) and the
        # window in its hand, and it serves the departed host's shards.
        assert _survivor_switch(seq[6:], 3) in range(3, 7), seq
        assert {2, 3} <= set(seq[6:]), seq
