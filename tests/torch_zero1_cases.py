"""The cases of ZeRO-1 over ``N`` gloo processes on the CPU
(``Zero1Optimizer.reduce_step`` past two processes), against the port's
one-process optimizer and the JAX package, collected by
``tests/test_torch_zero1_three.py`` (``N = 3``) and
``tests/test_torch_zero1_four.py`` (``N = 4``), each of which binds the
``cluster`` fixture to its world with :func:`cluster_fixture`.

``N`` OS processes run ``tests/torch_zero1_prog.py`` once (the test
module's fixture) over ``{"dp": N, "sp": 2}``, dp across the processes.
At 3 the models' widths are 3/2 of the two-process ones, so every leaf
divides (``torch_zero1_prog.SCALE``).

- The sum order.  The scatter leg sums the received chunks in rank
  order; the processes' step params equal the port's one-process ZeRO-1
  fed that rank-order mean, bit for bit, in fp32, deterministic int8 and
  stochastic int8.  gloo's all-reduce (``process_mean``, the replicated
  step's bucket) adds in another order past two processes: its sums are
  held to the rank-order sums within one rounding (``SUM_RTOL``), and
  the count of elements that differ is recorded, not assumed.
- The JAX package: fp32 and deterministic int8 params within 1e-6 of
  its ``ShardedOptimizer`` over ``dp = N``, except elements within
  ``TIE`` quanta of a rounding tie, which may differ by one quantum a
  step; the count of such elements is bounded, and the int8 payloads
  equal its ``quantize_blockwise`` of the whole leaf byte for byte.
- ``Trainer.fit`` in MULTIHOST mode: ZeRO-1 and the replicated fit
  against the port's one-process runs over the same global mesh and
  windows within ``RTOL``; ZeRO-1 against the replicated fit within
  ``FIT_RTOL`` (they sum in different orders); each process allocates
  1/N of the one-process moments, and ``opt.state_bytes_local`` is 1/N of
  ``opt.state_bytes_total``; the scatter and gather bytes follow the
  layout.
- Checkpoints: interrupted and resumed on every rank bit-equal; the
  N-process checkpoint restores into one process and the one-process
  checkpoint into N processes.
"""

import importlib.util
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddl_tpu.models import llama as jllama
from ddl_tpu.parallel import collectives as jcoll
from ddl_tpu.parallel import optimizer as jopt
from ddl_tpu.parallel.mesh import make_mesh as jax_mesh
from ddl_tpu_torch.models import llama as tllama
from ddl_tpu_torch.parallel import optimizer as topt
from ddl_tpu_torch.parallel.mesh import P, make_mesh
from ddl_tpu_torch.parallel.train import (
    adamw,
    make_multistep,
    make_train_step,
    tree_leaves,
    tree_map,
)

_PROG = os.path.join(os.path.dirname(__file__), "torch_zero1_prog.py")
_TIMEOUT_S = 300
RTOL = 1e-5
#: How far gloo's all-reduce may sit from the rank-order sum: one
#: rounding of each of the N - 1 additions, relative to the sum's scale.
SUM_RTOL = 1e-6
#: ZeRO-1 against the replicated fit over N processes: the same updates
#: from sums in different orders (the fits' losses, step by step).
FIT_RTOL = 1e-5
#: How near a rounding tie (in quanta) an update may lie for the two
#: AdamW implementations' last bits to round it to different sides.
TIE = 1e-3


def load_prog(n):
    """``torch_zero1_prog`` with ``DDL_TORCH_Z1_PROCS = n`` (its widths and
    blocks are read at import), under a module name of its own."""
    old = os.environ.get("DDL_TORCH_Z1_PROCS")
    os.environ["DDL_TORCH_Z1_PROCS"] = str(n)
    try:
        spec = importlib.util.spec_from_file_location(f"torch_zero1_prog_{n}",
                                                      _PROG)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if old is None:
            os.environ.pop("DDL_TORCH_Z1_PROCS", None)
        else:
            os.environ["DDL_TORCH_Z1_PROCS"] = old
    assert mod.N_PROCESSES == n
    return mod


def jcfg(prog):
    return jllama.LlamaConfig(**prog.tiny_widths(), dtype=jnp.float32)


def np_params(prog):
    return jax.tree.map(np.asarray,
                        jllama.init_params(jcfg(prog), jax.random.key(0)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def one_process_ckpt_steps(prog):
    """The ckpt leg's steps in one process over the same global mesh and
    the global batches."""
    n = prog.N_PROCESSES
    cfg = prog.small_cfg()
    mesh = make_mesh({"dp": n, "sp": 2}, ["cpu"] * (2 * n))
    init_fn, step_fn = make_train_step(
        lambda p, b: tllama.next_token_loss(p, b[0], cfg, mesh=mesh),
        adamw(1e-3), mesh=mesh, param_specs=tllama.param_specs(cfg),
        batch_spec=P(("dp",), "sp"), optimizer_sharding="zero1")
    batches = torch.from_numpy(prog.ckpt_batches())

    def run(state, steps):
        losses = []
        for t in steps:
            state, loss = step_fn(state, (batches[t],))
            losses.append(float(loss))
        return state, losses

    def fresh():
        return init_fn(tllama.init_params(cfg, seed=0, device="cpu"))

    return fresh, run


def cluster_fixture(n):
    """The module-scoped ``cluster`` fixture of a world of ``n``
    processes."""

    @pytest.fixture(scope="module", name="cluster")
    def cluster(tmp_path_factory):
        return run_cluster(n, tmp_path_factory)

    return cluster


def run_cluster(n, tmp_path_factory):
    """Write the inputs and the one-process checkpoint, run the ``n``
    processes once; their records and the one-process side's.  The
    children are killed if they outlive ``_TIMEOUT_S``."""
    from ddl_tpu_torch.checkpoint import save_train_state
    from ddl_tpu_torch.resilience import AsyncCheckpointer

    prog = load_prog(n)
    out = tmp_path_factory.mktemp(f"z1-world{n}")
    with open(out / "params.pkl", "wb") as f:
        pickle.dump(np_params(prog), f)
    np.random.default_rng(5).integers(0, 64, 20_000, dtype=np.int32).tofile(
        out / "tokens.bin")
    fresh, run = one_process_ckpt_steps(prog)
    state, _ = run(fresh(), range(prog.CKPT_AT))
    one_moments = {p: {k: v.clone() for k, v in st.items()}
                   for p, st in state.optimizer.state.items()}
    save_train_state(state, str(out / "one"))
    gens = AsyncCheckpointer(str(out / "one_gens"))
    gens.submit(state)
    gens.close()
    _, one_cont = run(state, range(prog.CKPT_AT, prog.CKPT_STEPS))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["DDL_TORCH_Z1_PROCS"] = str(n)
    # Each child's intra-op pool at its default (every core) oversubscribes
    # the host N times: 97 s against 39 s for the four-process module.
    env["OMP_NUM_THREADS"] = "2"
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, _PROG, str(i), port, str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for i in range(n)]
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
        pytest.fail("zero1 program timed out (deadlock?); partial output:\n"
                    + "\n---\n".join(outs))
    for i, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} rc={p.returncode}:\n{text}"
        assert f"ZERO1 OK process={i}" in text, text
    rec = {(leg, i): dict(np.load(out / f"{leg}_{i}.npz"))
           for leg in ("step", "fit", "ckpt") for i in range(n)}
    rec.update(prog=prog, n=n, out=out, one_moments=one_moments,
               one_cont=one_cont)
    return rec


# -- the step and the sum order ----------------------------------------------------


def contributions(prog, leaves, t):
    shapes = [tuple(x.shape) for x in leaves]
    return [prog.contribution(r, t, shapes) for r in range(prog.N_PROCESSES)]


def rank_order_mean(prog, leaves, t):
    """The scatter leg's reduced grads: the processes' contributions added
    in rank order in fp32, then divided by N."""
    parts = contributions(prog, leaves, t)
    out = []
    for i in range(len(leaves)):
        acc = parts[0][i].copy()
        for r in range(1, prog.N_PROCESSES):
            acc += parts[r][i]
        out.append(acc / np.float32(prog.N_PROCESSES))
    return out


def one_process_optimizer(prog, mode, mesh=None):
    """The port's one-process ZeRO-1 over the same global mesh (or
    ``mesh``), on the pickled tree."""
    n = prog.N_PROCESSES
    mesh = mesh or make_mesh({"dp": n, "sp": 2}, ["cpu"] * (2 * n))
    params = tree_map(lambda x: torch.tensor(x, requires_grad=True),
                      np_params(prog))
    opt = topt.ShardedOptimizer(adamw(prog.STEP_LR), mesh,
                                tllama.param_specs(prog.tiny_cfg()),
                                block=prog.STEP_BLOCK,
                                **prog.STEP_MODES[mode]).init(params)
    return params, opt


@pytest.mark.parametrize("mode", ["fp32", "int8", "int8_sr"])
def test_step_equals_the_one_process_port_fed_the_rank_order_sum(cluster, mode):
    """Every process ends with the params of the port's one-process
    ZeRO-1 fed the rank-order mean of the contributions, bit for bit:
    the scatter leg adds the received chunks in rank order, as the fp32
    sum here does.  Every leaf is sharded (the widths divide by N)."""
    prog = cluster["prog"]
    params, opt = one_process_optimizer(prog, mode)
    assert len(opt.leaves) == len(opt.params) and not opt.replicated
    leaves = tree_leaves(params)
    for t in range(prog.N_STEPS):
        for p, g in zip(leaves, rank_order_mean(prog, leaves, t)):
            p.grad = torch.from_numpy(g)
        opt.step()
    for r in range(cluster["n"]):
        for i, p in enumerate(leaves):
            np.testing.assert_array_equal(
                cluster[("step", r)][f"{mode}/param/{i}"], p.detach().numpy(),
                err_msg=f"rank {r} leaf {i}")


def test_gloo_all_reduce_against_the_rank_order_sum(cluster):
    """``process_mean`` (gloo's all-reduce, the replicated step's bucket)
    over the same contributions: every process gets the same bytes, within
    ``SUM_RTOL`` of the rank-order mean relative to the largest
    contribution; how many elements differ is recorded in the test's
    output (ROADMAP.md: at 3 and 4 processes gloo adds in another
    order)."""
    prog, n = cluster["prog"], cluster["n"]
    leaves = jax.tree.leaves(np_params(prog))
    differ = total = 0
    for t in range(prog.N_STEPS):
        want = rank_order_mean(prog, leaves, t)
        scale = [max(np.abs(c[i]).max() for c in contributions(prog, leaves, t))
                 for i in range(len(leaves))]
        for i, w in enumerate(want):
            got = cluster[("step", 0)][f"mean/{t}/{i}"]
            for r in range(1, n):
                np.testing.assert_array_equal(cluster[("step", r)][f"mean/{t}/{i}"],
                                              got)
            assert (np.abs(got - w) <= SUM_RTOL * scale[i]).all(), (t, i)
            differ += int((got != w).sum())
            total += w.size
    print(f"world {n}: gloo's all-reduce differs from the rank-order sum in "
          f"{differ} of {total} elements")
    assert total > 0


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_step_tracks_the_jax_sharded_optimizer(cluster, mode):
    """fp32: every param within 1e-6 (absolute and relative) of the JAX
    package's ``ShardedOptimizer`` over ``dp = N`` fed the same mean.
    int8 likewise, except elements whose update lies within ``TIE``
    quanta of a rounding tie, which may differ by one quantum a step;
    those elements are counted, and they are few."""
    prog, n = cluster["prog"], cluster["n"]
    tree = np_params(prog)
    cfg = jcfg(prog)
    jm = jax_mesh({"dp": n, "sp": 2}, jax.devices()[:2 * n])
    jo = jopt.ShardedOptimizer(optax.adamw(prog.STEP_LR), jm,
                               jllama.param_specs(cfg), block=prog.STEP_BLOCK,
                               **prog.STEP_MODES[mode])
    jp = jax.tree.map(jnp.asarray, tree)
    js = jo.init(jp)
    update = jax.jit(lambda g, s, p: jo.update(g, s, p))
    raw = jax.jit(lambda g, s, p: jo._inner.update(
        jo._quantize_tree(g, phase=0), s, p)[0])
    _, treedef = jax.tree.flatten(tree)
    leaves = jax.tree.leaves(tree)
    slack = [np.zeros(x.shape, np.float64) for x in leaves]
    for t in range(prog.N_STEPS):
        grads = jax.tree.map(jnp.asarray, jax.tree.unflatten(
            treedef, rank_order_mean(prog, leaves, t)))
        if mode == "int8":
            for i, u in enumerate(jax.tree.leaves(raw(grads, js, jp))):
                q, sc = jcoll.quantize_blockwise(u, prog.STEP_BLOCK)
                scale = np.repeat(np.asarray(sc), prog.STEP_BLOCK, -1)[
                    ..., :u.shape[-1]]
                v = np.abs(np.asarray(u) / scale)
                slack[i] += np.where(np.abs(v % 1.0 - 0.5) <= TIE, scale, 0.0)
        u, js = update(grads, js, jp)
        jp = optax.apply_updates(jp, u)
    n_elems = sum(x.size for x in leaves)
    for r in range(n):
        step = cluster[("step", r)]
        off_ties = 0
        for i, want in enumerate(jax.tree.leaves(jp)):
            got, want = step[f"{mode}/param/{i}"], np.asarray(want)
            gap = np.abs(got - want)
            near = 1e-6 + 1e-6 * np.abs(want)
            assert (gap <= near + slack[i] * (1 + 1e-6)).all(), (i, gap.max())
            off_ties += int((gap > near).sum())
        print(f"world {n} rank {r} {mode}: {off_ties} of {n_elems} elements "
              f"differ by a tie's quantum")
        # The ties are rare: a few per thousand of the elements at most.
        assert off_ties <= n_elems // 1000, off_ties
        if mode == "fp32":
            assert off_ties == 0


def whole_leaf(step, prog, t, phase, i, lf, what):
    """Leaf ``i``'s whole array of a recorded ``what`` (``x`` inputs, ``q``
    payloads, ``s`` scales) at step ``t`` and ``phase``, joined from every
    process's slices."""
    n = prog.N_PROCESSES
    parts = {}
    for r in range(n):
        for j in range(n):
            for b in range(len(lf.index[j])):
                key = f"int8/{t}/{phase}/{i}/{j}/{b}/{what}"
                if key in step[r]:
                    parts[(j, b)] = step[r][key]
    if not parts:
        return None
    shape = list(lf.param.shape)
    if what == "s":
        shape[-1] = -(-shape[-1] // prog.STEP_BLOCK)
    dt = next(iter(parts.values())).dtype
    out = np.zeros(shape, dt)
    for (j, b), a in parts.items():
        s, m = lf.index[j][b]
        if what == "s" and lf.dim == lf.param.dim() - 1:
            s, m = s // prog.STEP_BLOCK, a.shape[-1]
        idx = [slice(None)] * len(shape)
        idx[lf.dim] = slice(s, s + m)
        out[tuple(idx)] = a
    return out


def test_int8_payloads_equal_the_reference_bytes(cluster):
    """Deterministic int8: phase 0's inputs are the rank-order mean
    exactly, and both phases' payloads and scales equal the JAX package's
    ``quantize_blockwise`` of the whole leaf byte for byte."""
    prog, n = cluster["prog"], cluster["n"]
    step = [cluster[("step", r)] for r in range(n)]
    _, opt = one_process_optimizer(prog, "int8")
    leaves = jax.tree.leaves(np_params(prog))
    checked = 0
    for t in range(prog.N_STEPS):
        grads = rank_order_mean(prog, leaves, t)
        for phase in (0, 1):
            for lf in opt.leaves:
                i = opt._index[id(lf.param)]
                x = whole_leaf(step, prog, t, phase, i, lf, "x")
                if phase == 0:
                    np.testing.assert_array_equal(x, grads[i])
                q, s = jcoll.quantize_blockwise(jnp.asarray(x), prog.STEP_BLOCK)
                np.testing.assert_array_equal(
                    whole_leaf(step, prog, t, phase, i, lf, "q"), np.asarray(q))
                np.testing.assert_array_equal(
                    whole_leaf(step, prog, t, phase, i, lf, "s"), np.asarray(s))
                checked += 1
    assert checked == prog.N_STEPS * 2 * len(opt.leaves) and checked > 0


def test_a_slice_that_cuts_a_block_raises(cluster):
    msg = str(cluster[("step", 0)]["cut_error"])
    assert "quantization blocks of 256" in msg and "norm" in msg, msg


# -- Trainer.fit ------------------------------------------------------------------------


def _one_process_fit(cluster, leg):
    """The port's one-process multistep over the same global mesh and
    the processes' windows joined (rank 0's rows first)."""
    prog, n = cluster["prog"], cluster["n"]
    cfg = prog.small_cfg()
    mesh = make_mesh({"dp": n, "sp": 2}, ["cpu"] * (2 * n))
    wins = np.concatenate([cluster[("fit", r)][f"{leg}/windows"]
                           for r in range(n)], axis=2)
    init_fn, multi = make_multistep(
        lambda p, b: tllama.next_token_loss(p, b[0], cfg, mesh=mesh),
        adamw(1e-3), mesh=mesh, param_specs=tllama.param_specs(cfg),
        batch_spec=P(("dp",), "sp"), n_steps=wins.shape[1],
        **prog.FIT_LEGS[leg])
    state = init_fn(tllama.init_params(cfg, seed=0, device="cpu"))
    losses = []
    for w in wins:
        state, ls = multi(state, (torch.from_numpy(w),), per_step=True)
        losses.append(float(ls.mean()))
    return losses


@pytest.mark.parametrize("leg", ["rep", "z1", "z1i8", "i8"])
def test_fit_equals_the_one_process_run(cluster, leg):
    """Each fit over N processes: every process reports the same losses,
    its windows are its own instance's, and the losses equal the port's
    one-process run over the same global mesh and windows within
    ``RTOL``; the int8 legs stay inside ``loss_parity`` of the fp32
    curve, with nonzero drift."""
    n = cluster["n"]
    fits = [cluster[("fit", r)] for r in range(n)]
    for f in fits[1:]:
        np.testing.assert_array_equal(f[f"{leg}/losses"], fits[0][f"{leg}/losses"])
    assert len({f[f"{leg}/windows"].tobytes() for f in fits}) == n
    np.testing.assert_allclose(fits[0][f"{leg}/losses"],
                               _one_process_fit(cluster, leg), rtol=RTOL)
    if leg in ("z1i8", "i8"):
        gate = topt.loss_parity(fits[0]["rep/losses"], fits[0][f"{leg}/losses"])
        assert gate["parity"] and gate["max_rel_drift"] > 0.0, gate


def test_fit_zero1_against_the_replicated_fit(cluster):
    """Past two processes the two fits reduce in different orders (the
    scatter leg's rank order, gloo's own in the all-reduce): their losses
    and params agree within ``FIT_RTOL``.  Whether they are bit-equal is
    printed (ROADMAP.md records it)."""
    n = cluster["n"]
    for r in range(n):
        fit = cluster[("fit", r)]
        assert bool(fit["z1/spans"]) and not bool(fit["rep/spans"])
        np.testing.assert_allclose(fit["z1/losses"], fit["rep/losses"],
                                   rtol=FIT_RTOL)
        i = differ = 0
        while f"rep/param/{i}" in fit:
            a, b = fit[f"z1/param/{i}"], fit[f"rep/param/{i}"]
            np.testing.assert_allclose(a, b, rtol=FIT_RTOL, atol=1e-7)
            differ += int((a != b).sum())
            i += 1
        assert i > 0
        if r == 0:
            same = np.array_equal(fit["z1/losses"], fit["rep/losses"])
            print(f"world {n}: z1 losses bit-equal to rep {same}; "
                  f"{differ} param elements differ; z1 {fit['z1/losses']}, "
                  f"rep {fit['rep/losses']}")


def predicted_bytes(prog, block=None):
    """(reduce-scatter input, this process's all-gather part) bytes a step
    of the fit's ZeRO-1: every leaf of the small model splits its dim 0
    over dp = N (fp32 values; int8 payloads plus fp32 scales a block)."""
    n = prog.N_PROCESSES
    shapes = [tuple(p.shape) for p in tree_leaves(
        tllama.init_params(prog.small_cfg(), seed=0, device="cpu"))]
    total = sum(int(np.prod(s)) for s in shapes)
    if block is None:
        return 4 * total, 4 * total // n
    scales = 0
    for s in shapes:
        part = (s[0] // n,) + s[1:]
        scales += int(np.prod(part[:-1])) * -(-part[-1] // block)
    payload = total // n
    return 4 * total, 4 * scales + payload + (-payload) % 4


@pytest.mark.parametrize("leg", ["z1", "z1i8"])
def test_fit_byte_counters_equal_the_layout(cluster, leg):
    prog, n = cluster["prog"], cluster["n"]
    steps = len(cluster[("fit", 0)][f"{leg}/losses"]) * 2  # 2 steps a window
    scatter, gather = predicted_bytes(
        prog, prog.FIT_BLOCK if leg == "z1i8" else None)
    for r in range(n):
        fit = cluster[("fit", r)]
        assert float(fit[f"{leg}/mh.scatter_bytes"]) == steps * scatter
        assert float(fit[f"{leg}/mh.gather_bytes"]) == steps * gather
        assert int(fit[f"{leg}/mh.scatter_bytes/calls"]) == steps
        assert int(fit[f"{leg}/mh.gather_bytes/calls"]) == steps
        assert float(fit[f"{leg}/mh.allreduce_bytes"]) == steps * 8


def test_fit_moments_are_one_nth_of_the_whole(cluster):
    """Each process allocates 1/N of the one-process ZeRO-1 moments, the
    JAX package's ``state_bytes_per_replica`` over ``dp = N`` (less
    optax's int32 count); its gauge ``opt.state_bytes_local`` is 1/N of
    ``opt.state_bytes_total``."""
    prog, n = cluster["prog"], cluster["n"]
    cfg = prog.small_cfg()
    one = make_train_step(lambda p, b: 0, adamw(1e-3),
                          mesh=make_mesh({"dp": n, "sp": 2}, ["cpu"] * (2 * n)),
                          param_specs=tllama.param_specs(cfg),
                          optimizer_sharding="zero1")[0](
        tllama.init_params(cfg, seed=0, device="cpu")).optimizer
    total = prog.moment_bytes(one)
    jsmall = jllama.LlamaConfig(**prog.small_widths(), dtype=jnp.float32)
    jm = jax_mesh({"dp": n, "sp": 2}, jax.devices()[:2 * n])
    jo = jopt.ShardedOptimizer(optax.adamw(1e-3), jm, jllama.param_specs(jsmall))
    ref = jopt.state_bytes_per_replica(
        jo.init(jllama.init_params(jsmall, jax.random.key(0))))
    for r in range(n):
        fit = cluster[("fit", r)]
        for leg in ("z1", "z1i8"):
            assert n * int(fit[f"{leg}/moment_bytes"]) == total
            assert int(fit[f"{leg}/moment_bytes"]) == ref - 4
            local = float(fit[f"{leg}/opt.state_bytes_local"])
            assert local > 0 and n * local == float(
                fit[f"{leg}/opt.state_bytes_total"])
        assert int(fit["rep/moment_bytes"]) == total


# -- checkpoints ------------------------------------------------------------------


@pytest.mark.parametrize("path", ["sync", "async"])
def test_checkpoint_resumes_bit_equal(cluster, path):
    prog, n = cluster["prog"], cluster["n"]
    for r in range(n):
        ck = cluster[("ckpt", r)]
        np.testing.assert_array_equal(ck[path], ck["full"][prog.CKPT_AT:])
        np.testing.assert_array_equal(ck[f"{path}_params"], ck["full_params"])
        np.testing.assert_array_equal(ck[f"{path}_moments"], ck["moments_at"])
        np.testing.assert_array_equal(ck["full"], cluster[("ckpt", 0)]["full"])


def by_rank(opt_like, moments, n):
    """Every rank's owned moment slices of whole moments, flattened in its
    bucket order (``torch_zero1_prog.owned_moments``)."""
    out = []
    for r in range(n):
        parts = []
        for lf in opt_like.leaves:
            for s, m in lf.index[r]:
                st = moments[lf.param]
                parts += [st["exp_avg"].narrow(lf.dim, s, m).reshape(-1),
                          st["exp_avg_sq"].narrow(lf.dim, s, m).reshape(-1)]
        out.append(torch.cat(parts).numpy())
    return out


@pytest.mark.parametrize("path", ["sync", "async"])
def test_n_process_checkpoint_restores_into_one_process(cluster, path):
    from ddl_tpu_torch.checkpoint import restore_train_state
    from ddl_tpu_torch.resilience import restore_latest

    prog, n, out = cluster["prog"], cluster["n"], cluster["out"]
    fresh, run = one_process_ckpt_steps(prog)
    state = (restore_train_state(str(out / "two"), fresh()) if path == "sync"
             else restore_latest(str(out / "two_gens"), fresh()).state)
    assert state.step == prog.CKPT_AT
    got = by_rank(state.optimizer, state.optimizer.state, n)
    for r in range(n):
        np.testing.assert_array_equal(got[r], cluster[("ckpt", r)]["moments_at"])
    _, losses = run(state, range(prog.CKPT_AT, prog.CKPT_STEPS))
    np.testing.assert_allclose(cluster[("ckpt", 0)]["full"][prog.CKPT_AT:],
                               losses, rtol=RTOL)


@pytest.mark.parametrize("path", ["one_sync", "one_async"])
def test_one_process_checkpoint_restores_into_n_processes(cluster, path):
    prog, n = cluster["prog"], cluster["n"]
    fresh, _ = one_process_ckpt_steps(prog)
    like = fresh().optimizer
    moments = {lf.param: cluster["one_moments"][p]
               for lf, p in zip(like.leaves, cluster["one_moments"])}
    want = by_rank(like, moments, n)
    for r in range(n):
        ck = cluster[("ckpt", r)]
        np.testing.assert_array_equal(ck[f"{path}_moments"], want[r])
        np.testing.assert_allclose(ck[path], cluster["one_cont"], rtol=RTOL)


def test_accumulated_zero1_steps_against_the_replicated(cluster):
    """``accum_steps=2``: ZeRO-1 over N processes against the replicated
    step's bucket, within ``FIT_RTOL`` (bit-equal at two processes,
    ``test_torch_zero1_multihost.py``)."""
    prog, n = cluster["prog"], cluster["n"]
    for r in range(n):
        ck = cluster[("ckpt", r)]
        assert len(ck["accum_z1"]) == prog.CKPT_STEPS
        np.testing.assert_allclose(ck["accum_z1"], ck["accum_rep"], rtol=FIT_RTOL)
        np.testing.assert_allclose(ck["accum_z1_params"], ck["accum_rep_params"],
                                   rtol=FIT_RTOL, atol=1e-7)
