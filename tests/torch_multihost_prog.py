"""MULTIHOST program of the port: one "host" of a gloo cluster.

The twin of ``tests/multihost_prog.py`` for ``ddl_tpu_torch``: each OS
process initialises a ``torch.distributed`` gloo group, runs its own
PROCESS producers under ``distributed_dataloader(mode="multihost")``,
lands its local batches as its block of a global dp-sharded array
(``ingest.make_global_array``), trains over the global mesh (the grads
summed over the group in one bucket), exchanges window lanes across
processes (``DeviceGlobalShuffler``) and round-trips a checkpoint on a
shared directory.  It imports no JAX.  Driven by
``tests/test_torch_multihost.py``.

Parameterized by env (inherited by the spawned producers, so module
constants agree across the pickle boundary):

- ``DDL_TORCH_MH_PROCS`` (default 2): processes in the group
  (``tests/test_torch_multihost_four.py`` runs 4, the JAX package's
  four-process shapes: legs ``core,ckpt`` at one position a process and
  ``core,dpsp`` at two).
- ``DDL_TORCH_MH_DEVS`` (default 2): mesh positions a process.
- ``DDL_TORCH_MH_LEGS`` (default
  ``core,stream,ppdp,dpep,dpsp,ckpt,packed,evaluate``):
  ``core`` (coverage, the global train step, the cross-process shuffle),
  ``stream`` (``windows()`` with a process-spanning sharding), ``ppdp``
  (the pipelined Llama loss over each process's pp pair, dp across
  processes), ``dpep`` (a binding-capacity einsum MoE over
  ``{"dp": processes, "ep": 2}``: the routing of the global batch, and
  beside it the control that routes each process's rows alone),
  ``dpsp`` (``Trainer.fit`` in MULTIHOST mode over
  ``{"dp": processes * positions / 2, "sp": 2}``: the ring over each
  process's sp pair, on the
  int32 tokens of ``DDL_TORCH_MH_TOKENS``, else a seeded corpus it
  writes), ``ckpt`` (save, fresh restore,
  loader fast-forward on ``DDL_TORCH_MH_DIR``), ``packed`` (the twin of
  the JAX package's packed leg: per-process packed documents streamed
  into a global window, a segment-masked Llama step per window, the
  processes keeping different token counts), ``evaluate``
  (``Trainer.evaluate`` over a process-spanning mesh, a row metric
  through the prefetcher and a masked ``cross_entropy`` metric over
  streamed windows), ``chaos`` (the cross-host elastic leg of the JAX
  package's program: two mock hosts a process; process 1 loses producer 1
  at its 3rd fill — the watchdog respawns it — and then the whole mock
  host of producer 2, while both processes run one gloo ``all_reduce`` a
  window and serve every shard byte-correct).
- ``DDL_TORCH_MH_OUT``: directory of the per-process records
  (``<leg>_<rank>.npz``) the test holds to the JAX package's streams and
  to a one-process run.

Usage: python torch_multihost_prog.py <rank> <port>
"""

import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_PROCESSES = int(os.environ.get("DDL_TORCH_MH_PROCS", "2"))
DEVICES_PER_PROCESS = int(os.environ.get("DDL_TORCH_MH_DEVS", "2"))
LEGS = tuple(os.environ.get(
    "DDL_TORCH_MH_LEGS",
    "core,stream,ppdp,dpep,dpsp,ckpt,packed,evaluate").split(","))
N_PRODUCERS = 2
N_DATA, N_VALUES = 32, 8
BATCH = 8
SP_SEQ = 16
LR = 1e-3
#: The packed leg's geometry (the JAX package's packed leg).
PACK_SEQ, PACK_ROWS, PACK_BATCH = 16, 16, 4
#: The chaos leg's geometry (the JAX package's chaos leg).
CH_SHARDS, CH_ROWS, CH_VALS, CH_EPOCHS = 4, 8, 4, 12

import numpy as np  # noqa: E402
from torch_cluster_producers import ShardRangeProducer  # noqa: E402


def _init_return(pkg: str):
    import importlib

    name = "ddl_tpu" if pkg == "jax" else "ddl_tpu_torch"
    return importlib.import_module(f"{name}.datasetwrapper").DataProducerOnInitReturn


class TaggedProducer:
    """Rows tagged ``instance*1000 + producer*100 + row`` in every column,
    so a consumer can prove whose data landed where.  ``pkg`` picks which
    package's ``DataProducerOnInitReturn`` it returns (one class drives
    both packages)."""

    def __init__(self, instance_idx: int, pkg: str = "torch"):
        self.instance_idx = instance_idx
        self.pkg = pkg

    def on_init(self, producer_idx=0, **kw):
        self._idx = producer_idx
        return _init_return(self.pkg)(
            nData=N_DATA, nValues=N_VALUES, shape=(N_DATA, N_VALUES),
            splits=(N_VALUES - 1, 1),
        )

    def post_init(self, my_ary, **kw):
        tags = self.instance_idx * 1000 + self._idx * 100 + np.arange(N_DATA)
        my_ary[:] = tags[:, None].astype(np.float32)

    def execute_function(self, my_ary, **kw):
        pass  # deterministic windows (coverage is the assertion)


class TokenProducer:
    """int32 token rows for the ppdp leg, from a per-(instance, producer)
    seed."""

    def __init__(self, instance_idx: int, pkg: str = "torch"):
        self.instance_idx = instance_idx
        self.pkg = pkg

    def on_init(self, producer_idx=0, **kw):
        self._rng = np.random.default_rng(100 * self.instance_idx + producer_idx)
        return _init_return(self.pkg)(
            nData=N_DATA, nValues=SP_SEQ, shape=(N_DATA, SP_SEQ),
            splits=(SP_SEQ,), dtype=np.int32,
        )

    def post_init(self, my_ary, **kw):
        my_ary[:] = self._rng.integers(0, 64, my_ary.shape)

    def execute_function(self, my_ary, **kw):
        my_ary[:] = self._rng.integers(0, 64, my_ary.shape)


def chaos_pattern(instance_idx: int, shard: int) -> np.ndarray:
    """Byte-deterministic content of one (instance, shard) window."""
    return (instance_idx * 100_000.0 + shard * 1000.0
            + np.arange(CH_ROWS * CH_VALS, dtype=np.float32) % 97
            ).reshape(CH_ROWS, CH_VALS)


def run_chaos_leg(rank: int, n_processes: int, record, device="cpu"):
    """The cross-host elastic leg: two LOCAL mock hosts a process, one
    producer each, host ids globally distinct.  Process 1 arms (and
    exports to its producers) a crash of producer 1 at its 3rd fill — rung
    1, the watchdog's respawn — and kills its mock host B after epoch 5 —
    rung 2, the view change, the pool shrink and the shard adoption.
    Every window, both processes run one gloo ``all_reduce`` of a tensor on
    ``device`` (the collective goes on through both recoveries); beside a
    card the producers' rings are page-locked.  Returns this process's
    report."""
    import torch
    import torch.distributed as dist

    from ddl_tpu_torch import (
        DistributedDataLoader,
        Marker,
        distributed_dataloader,
    )
    from ddl_tpu_torch import faults
    from ddl_tpu_torch.cluster import (
        ClusterSupervisor,
        ClusterView,
        ElasticCluster,
        HostInfo,
    )
    from ddl_tpu_torch.faults import FaultKind, FaultPlan, FaultSpec
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.watchdog import Watchdog

    m = Metrics()
    if rank == 1:
        faults.arm(FaultPlan([FaultSpec("producer.fill",
                                        FaultKind.PRODUCER_CRASH, at=3,
                                        producer_idx=1)]), export=True)
    producer = ShardRangeProducer({1: ((0, 2),), 2: ((2, 4),)},
                                  pattern=functools.partial(chaos_pattern,
                                                            rank))
    report = {}

    @distributed_dataloader(n_producers=2, mode="multihost",
                            pin_memory=device != "cpu")
    def run(env):
        # The producers spawned at entry carry the exported plan; dropping
        # it now makes the crash fire in one incarnation only.
        os.environ.pop(faults.PLAN_ENV, None)
        host_a, host_b = 2 * rank, 2 * rank + 1
        view = ClusterView.bootstrap(
            [HostInfo(host_a, loader_ranks=(1,), trainer_ranks=(rank,)),
             HostInfo(host_b, loader_ranks=(2,))], n_shards=CH_SHARDS)
        # A long lease: this leg's host death is declared (kill_host); the
        # crash-respawn gap must never expire a lease.
        sup = ClusterSupervisor(view, lease_s=120.0, metrics=m)
        elastic = ElasticCluster(sup, workers=env.workers, metrics=m)
        loader = DistributedDataLoader(
            producer, batch_size=CH_ROWS, connection=env.connection,
            n_epochs=CH_EPOCHS, output="numpy", timeout_s=120.0,
            metrics=m, cluster=elastic)
        wd = Watchdog(env.workers, poll_interval_s=0.1, stall_budget_s=60.0,
                      respawn=True, metrics=m, cluster=sup).start()
        served, reduce_s = [], []
        try:
            for ep in range(CH_EPOCHS):
                for (win,) in loader:
                    tag = float(win[0, 0])
                    inst, shard = int(tag // 100_000), int(
                        (tag % 100_000) // 1000)
                    assert inst == rank, (inst, rank)
                    np.testing.assert_array_equal(
                        win, chaos_pattern(rank, shard),
                        err_msg=f"shard {shard} epoch {ep}")
                    served.append(shard)
                    t = torch.ones(2, device=device)
                    t0 = time.perf_counter()
                    dist.all_reduce(t)
                    total = float(t.sum())
                    reduce_s.append(time.perf_counter() - t0)
                    assert total == 2 * n_processes, total
                    loader.mark(Marker.END_OF_BATCH)
                loader.mark(Marker.END_OF_EPOCH)
                if rank == 1 and ep == 5:
                    elastic.kill_host(host_b)
        finally:
            wd.stop()
        shards = sorted(set(served))
        report.update(
            sequence=served, shards=shards,
            counts=[served.count(s) for s in shards],
            epoch=sup.view.epoch, lost=sorted(sup.lost_ranks()),
            reduce_ms=1e3 * float(np.mean(reduce_s)),
            **{c: m.counter(c) for c in CHAOS_COUNTERS})

    run()
    if rank == 1:
        faults.arm(None, export=True)
    record("chaos", **{k: np.asarray(v) for k, v in report.items()})
    return report


#: The chaos leg's counters, as the JAX package's leg reads them.
CHAOS_COUNTERS = ("watchdog.respawns", "watchdog.failures",
                  "cluster.host_losses", "cluster.view_changes",
                  "consumer.pool_updates", "cluster.shard_adoptions")


def linear_loss(p, b):
    """The core leg's model: ``w`` learns the (scaled) tag.  A mean over
    rows, so the mean of the processes' losses over their equal row
    blocks is the loss over the global batch (what a MULTIHOST step
    reports and differentiates)."""
    return ((((b[0] * 1e-3) @ p["w"]) - b[1][:, 0] * 1e-3) ** 2).mean()


def pp_cfg():
    import torch

    from ddl_tpu_torch.models import llama

    return llama.LlamaConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                             n_kv_heads=2, d_ff=64, max_seq=SP_SEQ,
                             dtype=torch.float32)


def pp_params():
    """The ppdp leg's weights in the stage layout, the same in every
    process (a seeded CPU generator)."""
    from ddl_tpu_torch.models import llama

    return llama.stage_params(llama.init_params(pp_cfg(), seed=0, device="cpu"), 2)


def pp_loss(mesh):
    from ddl_tpu_torch.models import llama

    cfg = pp_cfg()
    return lambda p, b: llama.next_token_loss_pp(p, b[0], cfg, mesh,
                                                 n_microbatches=2)


def moe_cfg():
    """The dpep leg's MoE at a binding capacity (half the picks drop), so
    a wrong routing group changes which tokens drop."""
    import torch

    from ddl_tpu_torch.models import moe

    return moe.MoeConfig(vocab=64, d_model=32, n_layers=1, n_heads=4,
                         n_kv_heads=2, d_ff=32, n_experts=4, topk=2,
                         capacity_factor=0.5, max_seq=SP_SEQ,
                         dtype=torch.float32)


def moe_loss(mesh):
    """The dpep leg's loss, routing over ``mesh``: the global mesh routes
    the global batch (the JAX package's GSPMD semantics); a process's
    ``mesh.local()`` routes its own rows only (the control)."""
    from ddl_tpu_torch.models import moe

    cfg = moe_cfg()
    return lambda p, b: moe.next_token_loss(p, b[0], cfg, mesh=mesh)


def packed_corpus(rank: int, path: str) -> str:
    """The packed leg's per-process documents (the JAX package's recipe):
    200 documents of 3-11 tokens, each ended by the delimiter 0."""
    rng = np.random.default_rng(100 + rank)
    docs = [rng.integers(1, 60, size=int(n)).tolist() + [0]
            for n in rng.integers(3, 12, size=200)]
    np.asarray([t for d in docs for t in d], np.int32).tofile(path)
    return path


def packed_loss(p, win):
    """The packed leg's loss over a whole window: tokens and segment ids
    of every row, one segment-masked next-token loss."""
    from ddl_tpu_torch.models import llama

    tok = win[..., :PACK_SEQ].reshape(-1, PACK_SEQ)
    seg = win[..., PACK_SEQ:].reshape(-1, PACK_SEQ)
    return llama.next_token_loss(p, tok, pp_cfg(), segment_ids=seg)


def packed_count(win: np.ndarray) -> int:
    """Positions the packed loss keeps in ``win``: every row's first
    T - 1 positions whose next token is in the same document."""
    seg = win[..., PACK_SEQ:].reshape(-1, PACK_SEQ)
    return int((seg[:, :-1] == seg[:, 1:]).sum())


def tag_metric(p, b):
    """The evaluate leg's row metric: the mean tag of the batch."""
    return b[1][:, 0].mean()


def masked_metric(p, b):
    """The evaluate leg's masked metric: a ``cross_entropy`` whose mask
    keeps the rows whose tag is not a multiple of 3, so the two
    processes (tags 0... and 1000...) keep different counts."""
    import torch

    from ddl_tpu_torch.models.losses import cross_entropy

    x, y = b[0], b[1]
    logits = (x[:, :, None] * 1e-3 * torch.arange(1, 8)).sum(1)
    tags = y[:, 0].long()
    return cross_entropy(logits, tags % 7, mask=(tags % 3) != 0)


def main(rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    from ddl_tpu_torch import DistributedDataLoader, Marker, distributed_dataloader
    from ddl_tpu_torch.ingest import make_global_array
    from ddl_tpu_torch.parallel.collectives import (
        DeviceGlobalShuffler,
        process_allgather,
    )
    from ddl_tpu_torch.parallel.mesh import NamedSharding, P, make_mesh
    from ddl_tpu_torch.parallel.train import make_train_step

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=N_PROCESSES, rank=rank)
    out_dir = os.environ.get("DDL_TORCH_MH_OUT")
    positions = ["cpu"] * DEVICES_PER_PROCESS
    total = N_PROCESSES * DEVICES_PER_PROCESS

    def record(name, **arrays):
        if out_dir:
            np.savez(os.path.join(out_dir, f"{name}_{rank}.npz"), **arrays)

    def sgd(lr):
        return lambda params: torch.optim.SGD(params, lr=lr)

    @distributed_dataloader(n_producers=N_PRODUCERS, mode="multihost",
                            pin_memory=False)
    def run_core(env):
        assert env.topology.n_instances == N_PROCESSES
        assert env.topology.instance_idx == rank
        mesh = make_mesh({"dp": total}, positions)
        assert mesh.spans_processes and mesh.size == total
        batch_sh = NamedSharding(mesh, P("dp"))
        loader = DistributedDataLoader(
            TaggedProducer(rank), batch_size=BATCH, connection=env.connection,
            n_epochs=2, output="numpy", device="cpu")
        init_fn, step_fn = make_train_step(
            linear_loss, sgd(LR), mesh=mesh, param_specs={"w": P(None)},
            batch_spec=P(("dp",)))
        state = init_fn({"w": np.zeros((N_VALUES - 1,), np.float32)})
        xs, ys, losses, seen = [], [], [], set()
        for _epoch in range(2):
            for x, y in loader:
                xs.append(np.array(x, copy=True))
                ys.append(np.array(y, copy=True))
                gx = make_global_array(x, batch_sh)
                gy = make_global_array(y, batch_sh)
                assert gx.shape == (N_PROCESSES * BATCH, N_VALUES - 1)
                state, loss = step_fn(state, (gx, gy))
                losses.append(float(loss))
                seen.update(int(t) for t in process_allgather(gy).reshape(-1))
                loader.mark(Marker.END_OF_BATCH)
            loader.mark(Marker.END_OF_EPOCH)
        assert {t // 1000 for t in seen} == set(range(N_PROCESSES)), seen
        assert len({(t // 1000, (t % 1000) // 100) for t in seen}) == (
            N_PROCESSES * N_PRODUCERS)
        # The cross-process shuffle: lanes move between instance shards,
        # the multiset of rows is kept.
        rows = 4 * total
        window = make_global_array(
            (1000.0 * rank + np.arange(rows // N_PROCESSES, dtype=np.float32)
             )[:, None] * np.ones((1, 4), np.float32),
            NamedSharding(mesh, P("dp")))
        shuffler = DeviceGlobalShuffler(mesh, num_exchange=2, seed=3)
        before = process_allgather(window).numpy()
        after = process_allgather(shuffler.shuffle(window)).numpy()
        assert sorted(before[:, 0].tolist()) == sorted(after[:, 0].tolist())
        assert not np.array_equal(before, after)
        rings = [str(r.ring_ref) for r in env.connection.replies]
        record("core", x=np.stack(xs), y=np.stack(ys), losses=np.array(losses),
               w=state.params["w"].detach().numpy(), before=before, after=after,
               rings=np.array(rings))

    if "core" in LEGS:
        run_core()

    @distributed_dataloader(n_producers=N_PRODUCERS, mode="multihost",
                            pin_memory=False)
    def run_stream(env):
        mesh = make_mesh({"dp": total}, positions)
        loader = DistributedDataLoader(
            TaggedProducer(rank), batch_size=BATCH, connection=env.connection,
            n_epochs=2, output="device", device="cpu",
            sharding=NamedSharding(mesh, P(None, "dp")))
        tags, local = set(), []
        for win in loader.windows():
            assert win.shape == (N_DATA // BATCH, N_PROCESSES * BATCH, N_VALUES)
            local.append(win.assemble_local().numpy().copy())
            tags.update(int(t) for t in process_allgather(win)[..., -1].reshape(-1))
            loader.mark(Marker.END_OF_EPOCH)
        assert {t // 1000 for t in tags} == set(range(N_PROCESSES)), tags
        record("stream", windows=np.stack(local))

    if "stream" in LEGS:
        run_stream()

    @distributed_dataloader(n_producers=N_PRODUCERS, mode="multihost",
                            pin_memory=False)
    def run_ppdp(env):
        # dp OUTER (spans processes), pp inner (each process's pair).
        mesh = make_mesh({"dp": total // 2, "pp": 2}, positions)
        from ddl_tpu_torch.models import llama

        init_fn, step_fn = make_train_step(
            pp_loss(mesh), sgd(1e-2), mesh=mesh,
            param_specs=llama.pp_param_specs(pp_cfg()), batch_spec=P(("dp",)))
        state = init_fn(pp_params())
        loader = DistributedDataLoader(
            TokenProducer(rank), batch_size=BATCH, connection=env.connection,
            n_epochs=2, output="numpy", device="cpu")
        toks, losses = [], []
        for _epoch in range(2):
            for (tok,) in loader:
                toks.append(np.array(tok, copy=True))
                gtok = make_global_array(tok, NamedSharding(mesh, P(("dp",))))
                assert gtok.shape == (N_PROCESSES * BATCH, SP_SEQ)
                state, loss = step_fn(state, (gtok,))
                losses.append(float(loss))
                loader.mark(Marker.END_OF_BATCH)
            loader.mark(Marker.END_OF_EPOCH)
        assert losses and all(np.isfinite(v) for v in losses)
        record("ppdp", tokens=np.stack(toks), losses=np.array(losses))

    if "ppdp" in LEGS:
        run_ppdp()

    @distributed_dataloader(n_producers=N_PRODUCERS, mode="multihost",
                            pin_memory=False)
    def run_dpep(env):
        # dp OUTER (spans processes), ep inner: the expert stacks' specs
        # carry ep; the einsum routing is the global batch's.
        from ddl_tpu_torch.models import moe
        from ddl_tpu_torch.parallel.mesh import named, prune_indivisible

        mesh = make_mesh({"dp": total // 2, "ep": 2}, positions)
        specs = moe.param_specs(moe_cfg())
        params = moe.init_params(moe_cfg(), seed=0, device="cpu")
        w_gate = prune_indivisible(named(mesh, specs["layers"][0]["w_gate"]),
                                   params["layers"][0]["w_gate"])
        assert tuple(w_gate.spec)[0] == "ep", w_gate.spec
        runs = {}
        for name, loss_mesh in (("global", mesh), ("per_process", mesh.local())):
            init_fn, step_fn = make_train_step(
                moe_loss(loss_mesh), sgd(1e-2), mesh=mesh, param_specs=specs,
                batch_spec=P(("dp",)))
            runs[name] = [init_fn(params), step_fn, []]
        loader = DistributedDataLoader(
            TokenProducer(rank), batch_size=BATCH, connection=env.connection,
            n_epochs=2, output="numpy", device="cpu")
        toks = []
        for _epoch in range(2):
            for (tok,) in loader:
                toks.append(np.array(tok, copy=True))
                gtok = make_global_array(tok, NamedSharding(mesh, P(("dp",))))
                for run in runs.values():
                    run[0], loss = run[1](run[0], (gtok,))
                    run[2].append(float(loss))
                loader.mark(Marker.END_OF_BATCH)
            loader.mark(Marker.END_OF_EPOCH)
        assert all(np.isfinite(v) for run in runs.values() for v in run[2])
        record("dpep", tokens=np.stack(toks),
               losses=np.array(runs["global"][2]),
               control=np.array(runs["per_process"][2]))

    if "dpep" in LEGS:
        run_dpep()

    if "dpsp" in LEGS:
        # Trainer.fit in MULTIHOST mode: the ring over each process's sp
        # pair, dp across the processes, each local window recorded.
        from ddl_tpu_torch.config import LoaderConfig
        from ddl_tpu_torch.models import llama
        from ddl_tpu_torch.observability import Metrics
        from ddl_tpu_torch.parallel.train import adamw
        from ddl_tpu_torch.readers import TokenStreamProducer
        from ddl_tpu_torch.trainer import Trainer

        mesh = make_mesh({"dp": total // 2, "sp": 2}, positions)
        cfg = pp_cfg()
        seen = []

        def hook(win):
            seen.append(win.numpy().copy())
            return win

        tokens = os.environ.get("DDL_TORCH_MH_TOKENS")
        if not tokens:  # the same seeded corpus in every process
            import tempfile

            tokens = os.path.join(tempfile.mkdtemp(), "tokens.bin")
            np.random.default_rng(5).integers(0, 64, 20_000,
                                              dtype=np.int32).tofile(tokens)
        trainer = Trainer(
            lambda p, b: llama.next_token_loss(p, b[0], cfg, mesh=mesh),
            adamw(1e-3), llama.init_params(cfg, seed=0, device="cpu"),
            device="cpu", metrics=Metrics(), mesh=mesh,
            param_specs=llama.param_specs(cfg), batch_spec=P(("dp",), "sp"))
        res = trainer.fit(
            TokenStreamProducer(tokens, SP_SEQ, 8),
            config=LoaderConfig(batch_size=4, n_epochs=2, n_producers=2,
                                mode="multihost", window_stream=True),
            window_hook=hook)
        assert all(np.isfinite(v) for v in res.losses)
        record("dpsp", windows=np.stack(seen), losses=np.array(res.losses))

    if "ckpt" in LEGS:
        ckpt_dir = os.environ["DDL_TORCH_MH_DIR"]
        from ddl_tpu_torch.checkpoint import (
            LoaderCheckpoint,
            restore_train_state,
            save_train_state,
        )
        from ddl_tpu_torch.resilience import AsyncCheckpointer, restore_latest

        from ddl_tpu_torch.parallel.train import adamw

        def step_factory(mesh):
            # AdamW: the async generations carry optax's Adam layout.
            return make_train_step(linear_loss, adamw(LR), mesh=mesh,
                                   param_specs={"w": P(None)},
                                   batch_spec=P(("dp",)))

        @distributed_dataloader(n_producers=N_PRODUCERS, mode="multihost",
                                pin_memory=False)
        def run_ckpt_first(env):
            mesh = make_mesh({"dp": total}, positions)
            init_fn, step_fn = step_factory(mesh)
            state = init_fn({"w": np.zeros((N_VALUES - 1,), np.float32)})
            loader = DistributedDataLoader(
                TaggedProducer(rank), batch_size=BATCH,
                connection=env.connection, n_epochs=4, output="numpy",
                device="cpu")
            batch_sh = NamedSharding(mesh, P("dp"))
            for _epoch in range(2):
                for x, y in loader:
                    state, _ = step_fn(state, (make_global_array(x, batch_sh),
                                               make_global_array(y, batch_sh)))
                    loader.mark(Marker.END_OF_BATCH)
                loader.mark(Marker.END_OF_EPOCH)
            # Rank 0 writes the replicated state, every rank waits; the
            # loader clock is per process.
            save_train_state(state, ckpt_dir)
            LoaderCheckpoint.capture(loader).save(
                os.path.join(ckpt_dir, f"loader_{rank}.json"))
            gens = AsyncCheckpointer(os.path.join(ckpt_dir, "gens"))
            gens.submit(state)
            gens.close()
            return state.step, loader._target, state.params["w"].detach().clone()

        step_before, target_before, w_before = run_ckpt_first()

        @distributed_dataloader(n_producers=N_PRODUCERS, mode="multihost",
                                pin_memory=False)
        def run_ckpt_resume(env):
            mesh = make_mesh({"dp": total}, positions)
            init_fn, step_fn = step_factory(mesh)
            fresh = init_fn({"w": np.zeros((N_VALUES - 1,), np.float32)})
            state = restore_train_state(ckpt_dir, fresh)
            assert state.step == step_before, (state.step, step_before)
            assert torch.equal(state.params["w"].detach(), w_before)
            gen = restore_latest(os.path.join(ckpt_dir, "gens"),
                                 init_fn({"w": np.zeros((N_VALUES - 1,),
                                                        np.float32)}))
            assert gen is not None and gen.state.step == step_before
            assert torch.equal(gen.state.params["w"].detach(), w_before)
            ck = LoaderCheckpoint.load(
                os.path.join(ckpt_dir, f"loader_{rank}.json"))
            loader = DistributedDataLoader(
                TaggedProducer(rank), batch_size=BATCH,
                connection=env.connection, n_epochs=4, output="numpy",
                device="cpu")
            loader.fast_forward(ck.epoch)
            ck.apply(loader)
            assert loader._target == target_before
            assert loader._epoch == 2
            batch_sh = NamedSharding(mesh, P("dp"))
            losses = []
            for _epoch in range(2):
                for x, y in loader:
                    state, loss = step_fn(state, (make_global_array(x, batch_sh),
                                                  make_global_array(y, batch_sh)))
                    losses.append(float(loss))
                    loader.mark(Marker.END_OF_BATCH)
                loader.mark(Marker.END_OF_EPOCH)
            assert losses and all(np.isfinite(v) for v in losses)
            assert state.step == step_before + len(losses)
            record("ckpt", losses=np.array(losses))

        run_ckpt_resume()

    if "packed" in LEGS:
        import tempfile

        from ddl_tpu_torch.models import llama
        from ddl_tpu_torch.readers import PackedTokenProducer

        token_file = packed_corpus(rank, os.path.join(
            tempfile.mkdtemp(prefix=f"ddl-torch-mh-{rank}-"), "pack.bin"))

        @distributed_dataloader(n_producers=N_PRODUCERS, mode="multihost",
                                pin_memory=False)
        def run_packed(env):
            mesh = make_mesh({"dp": total}, positions)
            loader = DistributedDataLoader(
                PackedTokenProducer(token_file, seq_len=PACK_SEQ,
                                    window_rows=PACK_ROWS, delimiter=0),
                batch_size=PACK_BATCH, connection=env.connection, n_epochs=2,
                output="device", device="cpu",
                sharding=NamedSharding(mesh, P(None, "dp")))
            init_fn, step_fn = make_train_step(
                packed_loss, sgd(1e-2), mesh=mesh,
                param_specs=llama.param_specs(pp_cfg()),
                batch_spec=P(None, ("dp",)))
            state = init_fn(llama.init_params(pp_cfg(), seed=0, device="cpu"))
            wins, counts, losses = [], [], []
            for win in loader.windows():
                assert win.shape == (PACK_ROWS // PACK_BATCH,
                                     N_PROCESSES * PACK_BATCH, 2 * PACK_SEQ)
                local = win.assemble_local().numpy().copy()
                wins.append(local)
                counts.append(packed_count(local))
                state, loss = step_fn(state, win)
                losses.append(float(loss))
                loader.mark(Marker.END_OF_EPOCH)
            assert len(losses) == 2 and all(np.isfinite(v) for v in losses)
            # The packing packed: some row spans several documents.
            assert any((w[..., PACK_SEQ:] > 0).any() for w in wins)
            record("packed", windows=np.stack(wins), counts=np.array(counts),
                   losses=np.array(losses))

        run_packed()

    if "evaluate" in LEGS:
        from ddl_tpu_torch.observability import Metrics
        from ddl_tpu_torch.trainer import Trainer

        mesh = make_mesh({"dp": total}, positions)
        trainer = Trainer(linear_loss, sgd(LR),
                          {"w": np.zeros((N_VALUES - 1,), np.float32)},
                          device="cpu", metrics=Metrics(), mesh=mesh,
                          param_specs={"w": P(None)}, batch_spec=P(("dp",)))
        state = trainer._init_fn(trainer._init_params)
        got, seen = {}, {"tag": [], "masked": []}
        for name, fn, stream in (("tag", tag_metric, False),
                                 ("masked", masked_metric, True)):
            def metric(p, b, fn=fn, name=name):
                seen[name].append(np.concatenate(
                    [np.asarray(c, dtype=np.float32) for c in b], axis=1))
                return fn(p, b)

            got[name] = trainer.evaluate(
                TaggedProducer(rank), state, metric, batch_size=BATCH,
                n_producers=N_PRODUCERS, mode="multihost",
                window_stream=stream, n_epochs=2)
        record("evaluate", tag=np.array(got["tag"]),
               masked=np.array(got["masked"]),
               tag_batches=np.stack(seen["tag"]),
               masked_batches=np.stack(seen["masked"]))

    if "chaos" in LEGS:
        run_chaos_leg(rank, N_PROCESSES, record)

    dist.destroy_process_group()
    print(f"MULTIHOST OK process={rank}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]))
