"""Program of ``tests/test_torch_zero1_multihost.py`` (two processes) and
``tests/test_torch_zero1_worlds.py`` (three and four): one process of a
gloo group on the CPU, training over a ``{"dp": N, "sp": 2}`` mesh whose
dp spans the ``N`` processes, with ZeRO-1 and int8 gradient communication
(``ddl_tpu_torch.parallel.optimizer``).  It imports no JAX.

``DDL_TORCH_Z1_PROCS`` (default 2) is ``N``.  The models' widths are
those of ``tests/test_torch_optimizer.py``'s TINY and
``torch_multihost_prog.pp_cfg`` where they divide by ``N`` (2 and 4), and
3/2 of them at 3 processes (:data:`SCALE`), so that ZeRO-1 shards every
leaf; the int8 blocks are the 1-D norms' slices (:data:`STEP_BLOCK`,
:data:`FIT_BLOCK`).

Legs (``DDL_TORCH_Z1_LEGS``, default ``step,fit,ckpt``):

- ``step``: the small Llama tree the test pickled (``params.pkl``), four
  ZeRO-1 updates from per-process gradient contributions
  (:func:`contribution`), in fp32, deterministic int8 and stochastic
  int8; every slice the optimizer quantized is recorded with its input.
- ``fit``: ``Trainer.fit`` in MULTIHOST mode on the token file
  ``tokens.bin``, replicated, ZeRO-1, ZeRO-1 int8 and int8 alone: losses,
  windows, final params, the ``mh.*`` counters and the moment bytes this
  process allocated.
- ``ckpt``: ZeRO-1 steps over :func:`ckpt_batches`, uninterrupted and
  interrupted at step 2 through the synchronous checkpoint and the
  async generations; and a restore of the one-process checkpoint the
  test wrote (``one/``, ``one_gens/``), continued; and ZeRO-1 against
  the replicated step with ``accum_steps=2``.

Records go to ``<out>/<leg>_<rank>.npz``.

Usage: python torch_zero1_prog.py <rank> <port> <out dir>
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

N_PROCESSES = int(os.environ.get("DDL_TORCH_Z1_PROCS", "2"))
LEGS = tuple(os.environ.get("DDL_TORCH_Z1_LEGS", "step,fit,ckpt").split(","))
#: Twice the widths' factor over the 2-process models: 2 where the world
#: divides them (2, 4), 3 at a world of 3.
SCALE = 3 if N_PROCESSES % 3 == 0 else 2
#: The step leg's modes, its block (the tree's 32 * SCALE-wide norms
#: split into N slices: a block of one slice keeps them whole blocks;
#: 32 at 2 processes) and its steps.
STEP_MODES = {
    "fp32": {},
    "int8": {"grad_comm": "int8"},
    "int8_sr": {"grad_comm": "int8", "stochastic_rounding": True},
}
STEP_BLOCK = 32 * SCALE // N_PROCESSES
N_STEPS = 4
STEP_LR = 1e-2
#: The fit and ckpt legs' model (``torch_multihost_prog.pp_cfg``'s at 2
#: and 4 processes): its 16 * SCALE-wide norms split into N slices, hence
#: the block (16 at 2 processes).
SEQ = 16
FIT_BLOCK = 16 * SCALE // N_PROCESSES
FIT_LEGS = {
    "rep": {},
    "z1": {"optimizer_sharding": "zero1"},
    "z1i8": {"optimizer_sharding": "zero1", "grad_comm": "int8",
             "grad_comm_block": FIT_BLOCK},
    "i8": {"grad_comm": "int8", "grad_comm_block": FIT_BLOCK},
}
CKPT_STEPS, CKPT_AT = 4, 2


def contribution(rank, step, shapes):
    """Process ``rank``'s gradient contribution at ``step``, one array a
    leaf: the step's global grad is the processes' mean."""
    rng = np.random.default_rng(1000 * step + rank)
    return [(0.1 * rng.standard_normal(s)).astype(np.float32) for s in shapes]


def small_cfg():
    import torch

    from ddl_tpu_torch.models import llama

    return llama.LlamaConfig(**small_widths(), dtype=torch.float32)


def small_widths():
    """The fit and ckpt legs' widths (``torch_multihost_prog.pp_cfg``'s
    times ``SCALE / 2``)."""
    return dict(vocab=32 * SCALE, d_model=16 * SCALE, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=32 * SCALE, max_seq=SEQ)


def tiny_widths():
    """The step leg's widths: ``tests/test_torch_optimizer.py``'s TINY
    times ``SCALE / 2``."""
    return dict(vocab=64 * SCALE, d_model=32 * SCALE, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=64 * SCALE, max_seq=64)


def tiny_cfg():
    """The step leg's tree."""
    import torch

    from ddl_tpu_torch.models import llama

    return llama.LlamaConfig(**tiny_widths(), dtype=torch.float32)


def ckpt_batches():
    """The ckpt leg's global batches: 4 rows each, rows ``2r, 2r + 1``
    process ``r``'s."""
    return np.random.default_rng(7).integers(
        0, 64, (CKPT_STEPS, 2 * N_PROCESSES, SEQ), dtype=np.int32)


def moment_bytes(opt):
    """The moment bytes this process's optimizer allocated (0-d entries,
    the per-tensor ``step``, left out)."""
    from ddl_tpu_torch.parallel.optimizer import _state_tensors

    return sum(t.numel() * t.element_size() for t in _state_tensors(opt)
               if t.dim() > 0)


def owned_moments(opt):
    """This process's moment slices, flattened in the bucket order."""
    import torch

    out = []
    for o, j in zip(opt.replicas, opt.owned):
        for lf in opt.leaves:
            for v in lf.views[j]:
                st = o.state[v]
                out += [st["exp_avg"].reshape(-1), st["exp_avg_sq"].reshape(-1)]
    return torch.cat(out).numpy().copy()


def main(rank, port, out):
    import torch
    import torch.distributed as dist

    from ddl_tpu_torch.parallel.mesh import P, make_mesh
    from ddl_tpu_torch.parallel.train import adamw, tree_leaves, tree_map

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=N_PROCESSES, rank=rank)
    mesh = make_mesh({"dp": N_PROCESSES, "sp": 2}, ["cpu"] * 2)
    assert mesh.spans_processes

    if "step" in LEGS:
        from ddl_tpu_torch.models import llama
        from ddl_tpu_torch.parallel.optimizer import ShardedOptimizer

        with open(os.path.join(out, "params.pkl"), "rb") as f:
            np_tree = pickle.load(f)
        rec = {}
        for mode, kw in STEP_MODES.items():
            params = tree_map(lambda x: torch.tensor(x, requires_grad=True),
                              np_tree)
            opt = ShardedOptimizer(adamw(STEP_LR), mesh,
                                   llama.param_specs(tiny_cfg()),
                                   block=STEP_BLOCK, **kw).init(params)
            assert opt.spans_processes and opt.owned == [rank]
            at = {"step": 0}
            quantize = opt.quantize_slices

            def recorded(lf, j, xs, bits, phase, quantize=quantize, mode=mode,
                         at=at, opt=opt):
                got = quantize(lf, j, xs, bits, phase)
                i = opt._index[id(lf.param)]
                for b, (x, (q, s)) in enumerate(zip(xs, got)):
                    tag = f"{mode}/{at['step']}/{phase}/{i}/{j}/{b}"
                    rec[tag + "/x"] = x.numpy().copy()
                    rec[tag + "/q"] = q.numpy().copy()
                    rec[tag + "/s"] = s.numpy().copy()
                return got

            opt.quantize_slices = recorded
            leaves = tree_leaves(params)
            for t in range(N_STEPS):
                at["step"] = t
                grads = contribution(rank, t, [tuple(p.shape) for p in leaves])
                for p, g in zip(leaves, grads):
                    p.grad = torch.from_numpy(g)
                opt.step()
            for i, p in enumerate(leaves):
                rec[f"{mode}/param/{i}"] = p.detach().numpy().copy()
        # The same contributions through gloo's all-reduce (the
        # replicated step's bucket), summed in whatever order gloo adds.
        from ddl_tpu_torch.parallel.collectives import process_mean

        shapes = [tuple(x.shape) for x in tree_leaves(np_tree)]
        for t in range(N_STEPS):
            grads = [torch.from_numpy(g) for g in contribution(rank, t, shapes)]
            process_mean(grads, grads)
            for i, g in enumerate(grads):
                rec[f"mean/{t}/{i}"] = g.numpy().copy()
        # The default block (256) against the norm slices.
        rec["cut_error"] = np.array("")
        try:
            ShardedOptimizer(adamw(STEP_LR), mesh, llama.param_specs(tiny_cfg()),
                             grad_comm="int8").init(
                tree_map(lambda x: torch.tensor(x, requires_grad=True), np_tree))
        except ValueError as e:
            rec["cut_error"] = np.array(str(e))
        np.savez(os.path.join(out, f"step_{rank}.npz"), **rec)

    if "fit" in LEGS:
        from ddl_tpu_torch.config import LoaderConfig, TrainConfig
        from ddl_tpu_torch.models import llama
        from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
        from ddl_tpu_torch.readers import TokenStreamProducer
        from ddl_tpu_torch.trainer import Trainer

        cfg = small_cfg()
        rec = {}
        dm = default_metrics()
        names = ("mh.scatter_bytes", "mh.gather_bytes", "mh.allreduce_bytes")
        for leg, kw in FIT_LEGS.items():
            seen = []

            def hook(win, seen=seen):
                seen.append(win.numpy().copy())
                return win

            before = {c: dm.counter(c) for c in names}
            counts = {c: dm.timer(c.replace("_bytes", "")).count for c in names}
            trainer = Trainer(
                lambda p, b: llama.next_token_loss(p, b[0], cfg, mesh=mesh),
                adamw(1e-3), llama.init_params(cfg, seed=0, device="cpu"),
                device="cpu", metrics=Metrics(), mesh=mesh,
                param_specs=llama.param_specs(cfg), batch_spec=P(("dp",), "sp"),
                train_config=TrainConfig(**kw) if kw else None)
            res = trainer.fit(
                TokenStreamProducer(os.path.join(out, "tokens.bin"), SEQ, 8),
                config=LoaderConfig(batch_size=4, n_epochs=2, n_producers=2,
                                    mode="multihost", window_stream=True),
                window_hook=hook)
            rec[f"{leg}/losses"] = np.array(res.losses)
            rec[f"{leg}/windows"] = np.stack(seen)
            for i, p in enumerate(tree_leaves(res.state.params)):
                rec[f"{leg}/param/{i}"] = p.detach().numpy().copy()
            for c in names:
                rec[f"{leg}/{c}"] = np.array(dm.counter(c) - before[c])
                rec[f"{leg}/{c}/calls"] = np.array(
                    dm.timer(c.replace("_bytes", "")).count - counts[c])
            rec[f"{leg}/moment_bytes"] = np.array(moment_bytes(res.state.optimizer))
            for g in ("opt.state_bytes_local", "opt.state_bytes_total"):
                rec[f"{leg}/{g}"] = np.array(dm.gauge(g))
            rec[f"{leg}/spans"] = np.array(
                getattr(res.state.optimizer, "spans_processes", False))
        np.savez(os.path.join(out, f"fit_{rank}.npz"), **rec)

    if "ckpt" in LEGS:
        from ddl_tpu_torch.checkpoint import restore_train_state, save_train_state
        from ddl_tpu_torch.models import llama
        from ddl_tpu_torch.parallel.train import make_train_step
        from ddl_tpu_torch.resilience import AsyncCheckpointer, restore_latest

        cfg = small_cfg()
        init_fn, step_fn = make_train_step(
            lambda p, b: llama.next_token_loss(p, b[0], cfg, mesh=mesh),
            adamw(1e-3), mesh=mesh, param_specs=llama.param_specs(cfg),
            batch_spec=P(("dp",), "sp"), optimizer_sharding="zero1")
        local = torch.from_numpy(ckpt_batches()[:, 2 * rank:2 * rank + 2])

        def fresh():
            return init_fn(llama.init_params(cfg, seed=0, device="cpu"))

        def run(state, steps):
            losses = []
            for t in steps:
                state, loss = step_fn(state, (local[t],))
                losses.append(float(loss))
            return state, losses

        rec = {}
        state, rec["full"] = run(fresh(), range(CKPT_STEPS))
        rec["full_params"] = np.concatenate(
            [p.detach().reshape(-1).numpy() for p in tree_leaves(state.params)])
        state, _ = run(fresh(), range(CKPT_AT))
        rec["moments_at"] = owned_moments(state.optimizer)
        save_train_state(state, os.path.join(out, "two"))
        gens = AsyncCheckpointer(os.path.join(out, "two_gens"))
        gens.submit(state)
        gens.close()
        for name, restore in (
                ("sync", lambda s: restore_train_state(os.path.join(out, "two"), s)),
                ("async", lambda s: restore_latest(os.path.join(out, "two_gens"),
                                                   s).state),
                ("one_sync", lambda s: restore_train_state(
                    os.path.join(out, "one"), s)),
                ("one_async", lambda s: restore_latest(
                    os.path.join(out, "one_gens"), s).state)):
            state = restore(fresh())
            assert state.step == CKPT_AT, (name, state.step)
            rec[f"{name}_moments"] = owned_moments(state.optimizer)
            state, rec[name] = run(state, range(CKPT_AT, CKPT_STEPS))
            rec[f"{name}_params"] = np.concatenate(
                [p.detach().reshape(-1).numpy() for p in tree_leaves(state.params)])
        # accum_steps > 1: the processes' means of microbatch means, as
        # the replicated step takes them.
        for name, kw in (("accum_rep", {}),
                         ("accum_z1", {"optimizer_sharding": "zero1"})):
            a_init, a_step = make_train_step(
                lambda p, b: llama.next_token_loss(p, b[0], cfg, mesh=mesh),
                adamw(1e-3), mesh=mesh, param_specs=llama.param_specs(cfg),
                batch_spec=P(("dp",), "sp"), accum_steps=2, **kw)
            state = a_init(llama.init_params(cfg, seed=0, device="cpu"))
            rec[name] = []
            for t in range(CKPT_STEPS):
                state, loss = a_step(state, (local[t],))
                rec[name].append(float(loss))
            rec[f"{name}_params"] = np.concatenate(
                [p.detach().reshape(-1).numpy() for p in tree_leaves(state.params)])
        np.savez(os.path.join(out, f"ckpt_{rank}.npz"),
                 **{k: np.asarray(v) for k, v in rec.items()})

    dist.destroy_process_group()
    print(f"ZERO1 OK process={rank}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
