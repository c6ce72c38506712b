"""MULTIHOST in the port over four gloo processes on the CPU: the JAX
package's two four-process shapes (``tests/test_multihost.py``).

- 4 x 1: four processes with one mesh position each, legs ``core`` and
  ``ckpt`` of ``tests/torch_multihost_prog.py``.
- 4 x 2: four processes with two positions each, legs ``core`` and
  ``dpsp`` (``Trainer.fit`` in MULTIHOST mode over ``{"dp": 4, "sp":
  2}``: the ring over each process's sp pair).

Each process's batch stream (``core``) and token windows (``dpsp``)
equal the JAX package's for ``Topology(n_instances=4, instance_idx=i)``
byte for byte, its loader built in-process; every process's producers
reach it and no ring is shared; the losses equal the port's one-process
run over the same global mesh and batches within ``RTOL``; the
cross-process shuffle keeps every row and equals the one-process
shuffler's pool; the checkpoint round trip (rank 0 writes, all four
restore and fast-forward) passes in the program, and the four resumed
runs agree.  Each cluster's children are killed past ``_TIMEOUT_S``.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_multihost_prog as prog
from test_torch_multihost import _jax_batches

_PROG = os.path.join(os.path.dirname(__file__), "torch_multihost_prog.py")
_TIMEOUT_S = 240
N = 4
RTOL = 1e-5
#: Each shape's devices a process and legs (the JAX package's).
SHAPES = {1: ("core", "ckpt"), 2: ("core", "dpsp")}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(devs, tmp_path_factory):
    """Run the four processes at ``devs`` positions each; their records
    by ``(leg, rank)``."""
    legs = SHAPES[devs]
    out = tmp_path_factory.mktemp(f"mh4x{devs}")
    tokens = out / "tokens.bin"
    np.random.default_rng(5).integers(0, 64, 20_000, dtype=np.int32).tofile(tokens)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    # Four children (each with its producers) on the host's cores: their
    # intra-op pools at the default would oversubscribe it.
    env.update(DDL_TORCH_MH_PROCS=str(N), DDL_TORCH_MH_DEVS=str(devs),
               DDL_TORCH_MH_LEGS=",".join(legs), DDL_TORCH_MH_OUT=str(out),
               DDL_TORCH_MH_TOKENS=str(tokens), OMP_NUM_THREADS="2",
               DDL_TORCH_MH_DIR=str(tmp_path_factory.mktemp(f"mh4x{devs}-ck")))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, _PROG, str(i), port],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for i in range(N)]
    outs = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=_TIMEOUT_S)
            outs.append(text)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait(timeout=60)
        pytest.fail("multihost program timed out (deadlock?); partial "
                    "output:\n" + "\n---\n".join(outs))
    for i, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} rc={p.returncode}:\n{text}"
        assert f"MULTIHOST OK process={i}" in text, text
    rec = {(leg, i): dict(np.load(out / f"{leg}_{i}.npz"))
           for leg in legs for i in range(N)}
    rec["tokens"] = str(tokens)
    return rec


@pytest.fixture(scope="module")
def cluster41(tmp_path_factory):
    return _run(1, tmp_path_factory)


@pytest.fixture(scope="module")
def cluster42(tmp_path_factory):
    return _run(2, tmp_path_factory)


@pytest.fixture(params=sorted(SHAPES), ids=lambda d: f"4x{d}")
def shape(request):
    """``(devices a process, that shape's records)``."""
    return request.param, request.getfixturevalue(f"cluster4{request.param}")


def test_processes_own_distinct_shared_memory_rings(shape):
    _, rec = shape
    rings = [set(rec[("core", i)]["rings"].tolist()) for i in range(N)]
    assert all(len(r) == prog.N_PRODUCERS for r in rings)
    assert len(set().union(*rings)) == N * prog.N_PRODUCERS


@pytest.mark.parametrize("instance", range(N))
def test_batch_streams_equal_jax(shape, instance):
    _, rec = shape
    want = _jax_batches(instance, prog.TaggedProducer, n_instances=N)
    got = rec[("core", instance)]
    np.testing.assert_array_equal(got["x"], np.stack([b[0] for b in want]))
    np.testing.assert_array_equal(got["y"], np.stack([b[1] for b in want]))


@pytest.mark.parametrize("instance", range(N))
def test_token_windows_equal_jax(cluster42, instance):
    """The ``dpsp`` fit's windows are the JAX package's
    ``TokenStreamProducer`` batches of the instance, two a window."""
    from ddl_tpu.readers import TokenStreamProducer

    want = _jax_batches(instance, None, n_instances=N, batch=4,
                        producer=TokenStreamProducer(cluster42["tokens"],
                                                     prog.SP_SEQ, 8))
    wins = cluster42[("dpsp", instance)]["windows"]
    assert len(want) == 2 * len(wins) > 0
    for k, win in enumerate(wins):
        np.testing.assert_array_equal(
            win, np.stack([want[2 * k][0], want[2 * k + 1][0]]))


def test_core_covers_every_host_and_equals_one_process_run(shape):
    """The dp step over four processes against the port's one-process step
    over the same global mesh and the joined batches."""
    from ddl_tpu_torch.ingest import make_global_array
    from ddl_tpu_torch.parallel.mesh import NamedSharding, P, make_mesh
    from ddl_tpu_torch.parallel.train import make_train_step

    devs, rec = shape
    cores = [rec[("core", i)] for i in range(N)]
    for c in cores[1:]:
        np.testing.assert_array_equal(c["losses"], cores[0]["losses"])
        np.testing.assert_array_equal(c["w"], cores[0]["w"])
    tags = {int(t) for c in cores for t in c["y"].reshape(-1)}
    assert {t // 1000 for t in tags} == set(range(N))
    mesh = make_mesh({"dp": N * devs}, ["cpu"] * (N * devs))
    init_fn, step_fn = make_train_step(
        prog.linear_loss, lambda ps: torch.optim.SGD(ps, lr=prog.LR),
        mesh=mesh, param_specs={"w": P(None)}, batch_spec=P(("dp",)))
    state = init_fn({"w": np.zeros((prog.N_VALUES - 1,), np.float32)})
    sh = NamedSharding(mesh, P("dp"))
    losses = []
    for k in range(len(cores[0]["losses"])):
        gx = make_global_array(np.concatenate([c["x"][k] for c in cores]), sh)
        gy = make_global_array(np.concatenate([c["y"][k] for c in cores]), sh)
        state, loss = step_fn(state, (gx, gy))
        losses.append(float(loss))
    np.testing.assert_allclose(cores[0]["losses"], losses, rtol=RTOL)
    np.testing.assert_allclose(cores[0]["w"], state.params["w"].detach().numpy(),
                               rtol=RTOL, atol=1e-9)


def test_cross_process_shuffle_keeps_rows_and_equals_one_process(shape):
    from ddl_tpu_torch.parallel.collectives import DeviceGlobalShuffler
    from ddl_tpu_torch.parallel.mesh import NamedSharding, P, make_mesh, shard

    devs, rec = shape
    before, after = rec[("core", 0)]["before"], rec[("core", 0)]["after"]
    for i in range(1, N):
        np.testing.assert_array_equal(rec[("core", i)]["before"], before)
        np.testing.assert_array_equal(rec[("core", i)]["after"], after)
    assert sorted(before[:, 0].tolist()) == sorted(after[:, 0].tolist())
    assert not np.array_equal(before, after)
    # Rows crossed between processes, not only within one.
    rows = len(before) // N
    moved = [set(after[r * rows:(r + 1) * rows, 0] // 1000) for r in range(N)]
    assert any(m != {r} for r, m in enumerate(moved)), moved
    mesh = make_mesh({"dp": N * devs}, ["cpu"] * (N * devs))
    one = DeviceGlobalShuffler(mesh, num_exchange=2, seed=3).shuffle(
        shard(torch.from_numpy(before), NamedSharding(mesh, P("dp"))))
    np.testing.assert_array_equal(one.numpy(), after)


def test_dpsp_fit_equals_one_process_run(cluster42):
    """``Trainer.fit`` in MULTIHOST mode over ``{"dp": 4, "sp": 2}``: the
    four processes' windows differ and their losses agree, and equal a
    one-process multistep over the same global mesh and the joined
    windows within ``RTOL``."""
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.parallel.mesh import P, make_mesh
    from ddl_tpu_torch.parallel.train import adamw, make_multistep

    recs = [cluster42[("dpsp", i)] for i in range(N)]
    assert len({r["windows"].tobytes() for r in recs}) == N
    for r in recs[1:]:
        np.testing.assert_array_equal(r["losses"], recs[0]["losses"])
    mesh = make_mesh({"dp": N, "sp": 2}, ["cpu"] * (2 * N))
    cfg = prog.pp_cfg()
    wins = np.concatenate([r["windows"] for r in recs], axis=2)
    init_fn, multi = make_multistep(
        lambda p, b: llama.next_token_loss(p, b[0], cfg, mesh=mesh),
        adamw(1e-3), mesh=mesh, param_specs=llama.param_specs(cfg),
        batch_spec=P(("dp",), "sp"), n_steps=wins.shape[1])
    state = init_fn(llama.init_params(cfg, seed=0, device="cpu"))
    losses = []
    for w in wins:
        state, ls = multi(state, (torch.from_numpy(w),), per_step=True)
        losses.append(float(ls.mean()))
    np.testing.assert_allclose(recs[0]["losses"], losses, rtol=RTOL)


def test_checkpoint_round_trip(cluster41):
    """Every rank restored rank 0's generation (sync and async) bit-equal
    and fast-forwarded its loader in the program; the four resumed runs
    agree."""
    first = cluster41[("ckpt", 0)]["losses"]
    assert len(first) > 0 and np.isfinite(first).all()
    for i in range(1, N):
        np.testing.assert_array_equal(cluster41[("ckpt", i)]["losses"], first)
