"""ZeRO-1 and int8 gradient communication over a dp that spans two gloo
processes on the CPU (``ddl_tpu_torch.parallel.optimizer``,
``Zero1Optimizer.reduce_step``), against the JAX package and the port's
one-process optimizer.

Two OS processes run ``tests/torch_zero1_prog.py`` once (the module's
fixture) over ``{"dp": 2, "sp": 2}``, dp across the processes:

- (a) the step: four ZeRO-1 updates of the small Llama tree of
  ``tests/test_torch_optimizer.py`` from per-process grads whose mean is
  ``G``; fp32 and deterministic int8 land within 1e-6 (absolute and
  relative) of the JAX package's ``ShardedOptimizer.update`` with ``G`` on
  a one-process mesh of the same shape, and every int8 payload (phase 0
  on the reduced grad, phase 1 on the update) equals the JAX package's
  ``quantize_blockwise`` of the whole leaf byte for byte.  All three
  modes, stochastic int8 included, equal the port's one-process ZeRO-1
  bit for bit (the stochastic draws are torch's, not JAX's random
  numbers, so that leg is held to the port's whole-leaf rule); a block
  that the slices cut raises.
- (b) in one process: the replica-major layout, the slice quantization
  (block edges, stochastic draws, keys) and the unpack equal the
  one-process optimizer's views and whole-leaf ``_qdq`` byte for byte,
  at dp 2 and 4.
- (c) ``Trainer.fit`` in MULTIHOST mode: ZeRO-1 fp32 bit-equal to the
  replicated fit; ZeRO-1 int8 and int8 alone within ``PARITY_REL_TOL`` of
  the fp32 curve and within rtol 1e-5 of the port's one-process run over
  the same global mesh and windows; the ``mh.scatter`` / ``mh.gather``
  bytes equal what the layout predicts; each process allocates half the
  one-process moments, the reference's ``state_bytes_per_replica``.
- (d) checkpoints: interrupted at step 2 (the synchronous path and the
  async generations) and resumed on both ranks, bit-equal to the
  uninterrupted run; the two-process checkpoint restores into a
  one-process fit over the same global mesh, and the reverse; ZeRO-1
  with ``accum_steps=2`` bit-equal to the replicated step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_zero1_cases as cases
import torch_zero1_prog as prog
from ddl_tpu.models import llama as jllama
from ddl_tpu.parallel import collectives as jcoll
from ddl_tpu.parallel import optimizer as jopt
from ddl_tpu.parallel.mesh import make_mesh as jax_mesh
from ddl_tpu_torch.models import llama as tllama
from ddl_tpu_torch.parallel import optimizer as topt
from ddl_tpu_torch.parallel.collectives import (
    dequantize_blockwise,
    quantize_blockwise,
)
from ddl_tpu_torch.parallel.mesh import P, make_mesh
from ddl_tpu_torch.parallel.train import (
    adamw,
    make_multistep,
    make_train_step,
    tree_leaves,
    tree_map,
)

RTOL = 1e-5
#: The tiny tree's config (``tests/test_torch_optimizer.py``'s TINY).
JCFG = cases.jcfg(prog)

#: Write the inputs and the one-process checkpoint, run the two
#: processes once (``torch_zero1_cases.run_cluster``).
cluster = cases.cluster_fixture(2)


# -- (a) the cross-process step -------------------------------------------------


#: How near a rounding tie (in quanta) an update may lie for the two
#: AdamW implementations' last bits to round it to different sides.
TIE = 1e-3


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_step_tracks_the_jax_sharded_optimizer(cluster, mode):
    """fp32: every param within 1e-6 (absolute and relative) of the JAX
    package's.  int8 likewise, except that an element whose update lies
    within ``TIE`` quanta of a rounding tie may round to the other side
    (torch's AdamW and optax's differ in their last bits, ~1e-5 quanta
    here): such an element may differ by one quantum for each such
    step, and no other element may differ."""
    np_params = cases.np_params(prog)
    jm = jax_mesh({"dp": 2, "sp": 2}, jax.devices()[:4])
    jo = jopt.ShardedOptimizer(optax.adamw(prog.STEP_LR), jm,
                               jllama.param_specs(JCFG), block=prog.STEP_BLOCK,
                               **prog.STEP_MODES[mode])
    jp = jax.tree.map(jnp.asarray, np_params)
    js = jo.init(jp)
    update = jax.jit(lambda g, s, p: jo.update(g, s, p))
    # The update before the gather's quantization (phase 1's input).
    raw = jax.jit(lambda g, s, p: jo._inner.update(
        jo._quantize_tree(g, phase=0), s, p)[0])
    _, treedef = jax.tree.flatten(np_params)
    leaves = jax.tree.leaves(np_params)
    slack = [np.zeros(x.shape, np.float64) for x in leaves]
    for t in range(prog.N_STEPS):
        grads = jax.tree.map(jnp.asarray,
                             jax.tree.unflatten(
                                 treedef, cases.rank_order_mean(prog, leaves, t)))
        if mode == "int8":
            for i, u in enumerate(jax.tree.leaves(raw(grads, js, jp))):
                q, sc = jcoll.quantize_blockwise(u, prog.STEP_BLOCK)
                scale = np.repeat(np.asarray(sc), prog.STEP_BLOCK, -1)[
                    ..., :u.shape[-1]]
                v = np.abs(np.asarray(u) / scale)
                slack[i] += np.where(np.abs(v % 1.0 - 0.5) <= TIE, scale, 0.0)
        u, js = update(grads, js, jp)
        jp = optax.apply_updates(jp, u)
    for r in range(2):
        step = cluster[("step", r)]
        for i, want in enumerate(jax.tree.leaves(jp)):
            got, want = step[f"{mode}/param/{i}"], np.asarray(want)
            assert (np.abs(got - want) <= 1e-6 + 1e-6 * np.abs(want)
                    + slack[i] * (1 + 1e-6)).all(), (i, np.abs(got - want).max())


def test_int8_payloads_equal_the_reference_bytes(cluster):
    """Deterministic int8: each slice the processes quantized is its part
    of the whole leaf — phase 0's inputs are the reduced grad ``G``
    exactly, and both phases' payloads and scales equal the JAX package's
    ``quantize_blockwise`` of the whole leaf byte for byte."""
    step = [cluster[("step", r)] for r in range(2)]
    _, opt = cases.one_process_optimizer(prog, "int8")
    leaves = jax.tree.leaves(cases.np_params(prog))
    checked = 0
    for t in range(prog.N_STEPS):
        grads = cases.rank_order_mean(prog, leaves, t)
        for phase in (0, 1):
            for lf in opt.leaves:
                i = opt._index[id(lf.param)]
                x = cases.whole_leaf(step, prog, t, phase, i, lf, "x")
                if phase == 0:
                    np.testing.assert_array_equal(x, grads[i])
                q, s = jcoll.quantize_blockwise(jnp.asarray(x), prog.STEP_BLOCK)
                np.testing.assert_array_equal(
                    cases.whole_leaf(step, prog, t, phase, i, lf, "q"),
                    np.asarray(q))
                np.testing.assert_array_equal(
                    cases.whole_leaf(step, prog, t, phase, i, lf, "s"),
                    np.asarray(s))
                checked += 1
    assert checked == prog.N_STEPS * 2 * len(opt.leaves) and checked > 0


@pytest.mark.parametrize("mode", list(prog.STEP_MODES))
def test_step_equals_the_one_process_port(cluster, mode):
    """Both processes end with the params of the port's one-process
    ZeRO-1 fed ``G``, bit for bit, in every mode (stochastic rounding
    draws the whole leaf's numbers under the whole leaf's key)."""
    params, opt = cases.one_process_optimizer(prog, mode)
    leaves = tree_leaves(params)
    for t in range(prog.N_STEPS):
        for p, g in zip(leaves, cases.rank_order_mean(prog, leaves, t)):
            p.grad = torch.from_numpy(g)
        opt.step()
    for r in range(2):
        for i, p in enumerate(leaves):
            np.testing.assert_array_equal(cluster[("step", r)][f"{mode}/param/{i}"],
                                          p.detach().numpy())
    if mode == "int8_sr":
        # The stochastic leg really rounded otherwise than the nearest.
        assert any(not np.array_equal(cluster[("step", 0)][f"int8/param/{i}"],
                                      cluster[("step", 0)][f"int8_sr/param/{i}"])
                   for i in range(len(leaves)))


def test_a_slice_that_cuts_a_block_raises(cluster):
    msg = str(cluster[("step", 0)]["cut_error"])
    assert "quantization blocks of 256" in msg and "norm" in msg, msg


# -- (b) slices equal the whole leaf, in one process ------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_layout_packs_and_unpacks_the_views(n):
    mesh = make_mesh({"dp": n}, ["cpu"] * n)
    params, opt = cases.one_process_optimizer(prog, "fp32", mesh)
    lay = topt.ReplicaLayout(opt.leaves)
    leaves = [lf.param.detach() for lf in opt.leaves]
    host = torch.empty(n * lay.size)
    for j, li, b, piece in lay.pieces(host, range(n)):
        s, m = opt.leaves[li].index[j][b]
        piece.copy_(leaves[li].narrow(opt.leaves[li].dim, s, m))
    for j in range(n):
        want = torch.cat([v.reshape(-1) for lf in opt.leaves for v in lf.views[j]])
        assert torch.equal(host[j * lay.size:(j + 1) * lay.size], want)
    back = [torch.zeros_like(x) for x in leaves]
    for j, li, b, piece in lay.pieces(host, range(n)):
        s, m = opt.leaves[li].index[j][b]
        back[li].narrow(opt.leaves[li].dim, s, m).copy_(piece)
    assert all(torch.equal(a, b) for a, b in zip(back, leaves))
    # A process's chunk (its last replica alone): that replica's region.
    chunk = torch.empty(lay.size)
    for j, li, b, piece in lay.pieces(chunk, [n - 1]):
        s, m = opt.leaves[li].index[j][b]
        piece.copy_(leaves[li].narrow(opt.leaves[li].dim, s, m))
    assert torch.equal(chunk, host[(n - 1) * lay.size:])


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_slice_quantization_equals_the_whole_leaf(n, stochastic):
    """Each replica's slices quantize to the slices of the whole leaf's
    payload and scales, and dequantize to the slices of the whole leaf's
    ``_qdq``, for both phases' keys."""
    block = 16
    mesh = make_mesh({"dp": n}, ["cpu"] * n)
    params = tree_map(lambda x: torch.tensor(x), cases.np_params(prog))
    opt = topt.ShardedOptimizer(adamw(1e-2), mesh,
                                tllama.param_specs(prog.tiny_cfg()),
                                grad_comm="int8", stochastic_rounding=stochastic,
                                block=block).init(params)
    rng = np.random.default_rng(11)
    last_dim = 0
    for phase in (0, 1):
        for lf in opt.leaves:
            i = opt._index[id(lf.param)]
            x = torch.from_numpy(rng.standard_normal(tuple(lf.param.shape))
                                 .astype(np.float32))
            last_dim += lf.dim == x.dim() - 1
            bits = topt._bits(x)
            key = opt._key(i, x, phase) if stochastic else None
            q, s = quantize_blockwise(x, block, stochastic=stochastic, key=key)
            whole = opt._qdq(x, i, phase)
            for j in range(n):
                xs = [x.narrow(lf.dim, a, m) for a, m in lf.index[j]]
                got = opt.quantize_slices(lf, j, xs, bits, phase)
                for (a, m), (qj, sj) in zip(lf.index[j], got):
                    assert torch.equal(qj, q.narrow(lf.dim, a, m))
                    if lf.dim == x.dim() - 1:
                        want_s = s.narrow(lf.dim, a // block, sj.shape[-1])
                    else:
                        want_s = s.narrow(lf.dim, a, m)
                    assert torch.equal(sj, want_s)
                    deq = dequantize_blockwise(qj, sj, x.dtype, block)
                    assert torch.equal(deq, whole.narrow(lf.dim, a, m))
    assert last_dim > 0  # the 1-D norms slice along their only (last) dim


def test_quantized_layout_round_trips():
    mesh = make_mesh({"dp": 4}, ["cpu"] * 4)
    _, opt = cases.one_process_optimizer(prog, "int8", mesh)
    lay = topt.ReplicaLayout(opt.leaves)
    region, rows = lay.quantized(prog.STEP_BLOCK)
    n_scales = sum(int(np.prod(sh)) for row in rows for _, sh, _ in row)
    assert region == 4 * n_scales + lay.size + (-lay.size) % 4
    host = torch.zeros(4 * region, dtype=torch.uint8)
    sent = {}
    g = torch.Generator().manual_seed(0)
    for j, li, b, scales, payload in lay.qpieces(host, prog.STEP_BLOCK, range(4)):
        sent[(j, li, b)] = (torch.rand(scales.shape, generator=g),
                            torch.randint(-127, 128, payload.shape, generator=g,
                                          dtype=torch.int8))
        scales.copy_(sent[(j, li, b)][0])
        payload.copy_(sent[(j, li, b)][1])
    for j, li, b, scales, payload in lay.qpieces(host, prog.STEP_BLOCK, range(4)):
        assert torch.equal(scales, sent[(j, li, b)][0])
        assert torch.equal(payload, sent[(j, li, b)][1])


# -- (c) Trainer.fit legs -----------------------------------------------------------


def test_fit_zero1_is_bit_equal_to_the_replicated_fit(cluster):
    for r in range(2):
        fit = cluster[("fit", r)]
        np.testing.assert_array_equal(fit["z1/losses"], fit["rep/losses"])
        i = 0
        while f"rep/param/{i}" in fit:
            np.testing.assert_array_equal(fit[f"z1/param/{i}"], fit[f"rep/param/{i}"])
            i += 1
        assert i > 0 and bool(fit["z1/spans"]) and not bool(fit["rep/spans"])
    np.testing.assert_array_equal(cluster[("fit", 0)]["z1/losses"],
                                  cluster[("fit", 1)]["z1/losses"])
    assert not np.array_equal(cluster[("fit", 0)]["z1/windows"],
                              cluster[("fit", 1)]["z1/windows"])


@pytest.mark.parametrize("leg", ["z1i8", "i8"])
def test_fit_int8_legs_keep_parity_and_equal_one_process(cluster, leg):
    f0, f1 = cluster[("fit", 0)], cluster[("fit", 1)]
    np.testing.assert_array_equal(f0[f"{leg}/losses"], f1[f"{leg}/losses"])
    gate = topt.loss_parity(f0["rep/losses"], f0[f"{leg}/losses"])
    assert gate["parity"] and gate["max_rel_drift"] > 0.0, gate
    cfg = prog.small_cfg()
    mesh = make_mesh({"dp": 2, "sp": 2}, ["cpu"] * 4)
    wins = np.concatenate([f0[f"{leg}/windows"], f1[f"{leg}/windows"]], axis=2)
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
    np.testing.assert_allclose(f0[f"{leg}/losses"], losses, rtol=RTOL)


@pytest.mark.parametrize("leg", ["z1", "z1i8", "rep"])
def test_fit_byte_counters_equal_the_layout(cluster, leg):
    steps = len(cluster[("fit", 0)][f"{leg}/losses"]) * 2  # 2 steps a window
    for r in range(2):
        fit = cluster[("fit", r)]
        if leg == "rep":
            assert float(fit["rep/mh.scatter_bytes"]) == 0.0
            assert float(fit["rep/mh.gather_bytes"]) == 0.0
            continue
        scatter, gather = cases.predicted_bytes(
            prog, prog.FIT_BLOCK if leg == "z1i8" else None)
        assert float(fit[f"{leg}/mh.scatter_bytes"]) == steps * scatter
        assert float(fit[f"{leg}/mh.gather_bytes"]) == steps * gather
        assert int(fit[f"{leg}/mh.scatter_bytes/calls"]) == steps
        assert int(fit[f"{leg}/mh.gather_bytes/calls"]) == steps
        # The small bucket: the loss and the count.
        assert float(fit[f"{leg}/mh.allreduce_bytes"]) == steps * 8
    if leg == "z1i8":
        ratio = (cases.predicted_bytes(prog)[1]
                 / cases.predicted_bytes(prog, prog.FIT_BLOCK)[1])
        assert 3.0 < ratio < 4.0, ratio


def test_fit_moments_halve_to_the_reference_count(cluster):
    cfg = prog.small_cfg()
    one = make_train_step(lambda p, b: 0, adamw(1e-3),
                          mesh=make_mesh({"dp": 2, "sp": 2}, ["cpu"] * 4),
                          param_specs=tllama.param_specs(cfg),
                          optimizer_sharding="zero1")[0](
        tllama.init_params(cfg, seed=0, device="cpu")).optimizer
    total = prog.moment_bytes(one)
    jcfg = jllama.LlamaConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                              n_kv_heads=2, d_ff=64, max_seq=prog.SEQ,
                              dtype=jnp.float32)
    jm = jax_mesh({"dp": 2, "sp": 2}, jax.devices()[:4])
    jo = jopt.ShardedOptimizer(optax.adamw(1e-3), jm, jllama.param_specs(jcfg))
    ref = jopt.state_bytes_per_replica(
        jo.init(jllama.init_params(jcfg, jax.random.key(0))))
    for r in range(2):
        fit = cluster[("fit", r)]
        for leg in ("z1", "z1i8"):
            assert 2 * int(fit[f"{leg}/moment_bytes"]) == total
            # optax's one int32 count beside the moments.
            assert int(fit[f"{leg}/moment_bytes"]) == ref - 4
        assert int(fit["rep/moment_bytes"]) == total


# -- (d) checkpoints ------------------------------------------------------------------


@pytest.mark.parametrize("path", ["sync", "async"])
def test_checkpoint_resumes_bit_equal(cluster, path):
    for r in range(2):
        ck = cluster[("ckpt", r)]
        np.testing.assert_array_equal(ck[path], ck["full"][prog.CKPT_AT:])
        np.testing.assert_array_equal(ck[f"{path}_params"], ck["full_params"])
        np.testing.assert_array_equal(ck[f"{path}_moments"], ck["moments_at"])
    np.testing.assert_array_equal(cluster[("ckpt", 0)]["full"],
                                  cluster[("ckpt", 1)]["full"])


def test_accumulated_zero1_steps_equal_the_replicated(cluster):
    """``accum_steps=2``: ZeRO-1 over the processes averages the
    processes' means of microbatch means, bit-equal to the replicated
    step's bucket."""
    for r in range(2):
        ck = cluster[("ckpt", r)]
        assert len(ck["accum_z1"]) == prog.CKPT_STEPS
        np.testing.assert_array_equal(ck["accum_z1"], ck["accum_rep"])
        np.testing.assert_array_equal(ck["accum_z1_params"], ck["accum_rep_params"])


@pytest.mark.parametrize("path", ["sync", "async"])
def test_two_process_checkpoint_restores_into_one_process(cluster, path):
    from ddl_tpu_torch.checkpoint import restore_train_state
    from ddl_tpu_torch.resilience import restore_latest

    fresh, run = cases.one_process_ckpt_steps(prog)
    out = cluster["out"]
    state = (restore_train_state(str(out / "two"), fresh()) if path == "sync"
             else restore_latest(str(out / "two_gens"), fresh()).state)
    assert state.step == prog.CKPT_AT
    got = cases.by_rank(state.optimizer, state.optimizer.state, 2)
    for r in range(2):
        np.testing.assert_array_equal(got[r], cluster[("ckpt", r)]["moments_at"])
    _, losses = run(state, range(prog.CKPT_AT, prog.CKPT_STEPS))
    np.testing.assert_allclose(cluster[("ckpt", 0)]["full"][prog.CKPT_AT:],
                               losses, rtol=RTOL)


@pytest.mark.parametrize("path", ["one_sync", "one_async"])
def test_one_process_checkpoint_restores_into_two_processes(cluster, path):
    fresh, _ = cases.one_process_ckpt_steps(prog)
    like = fresh().optimizer
    moments = {lf.param: cluster["one_moments"][p]
               for lf, p in zip(like.leaves, cluster["one_moments"])}
    # The fixture's moments are keyed by its own optimizer's leaves, in
    # the same order as any fresh optimizer's.
    want = cases.by_rank(like, moments, 2)
    for r in range(2):
        ck = cluster[("ckpt", r)]
        np.testing.assert_array_equal(ck[f"{path}_moments"], want[r])
        np.testing.assert_allclose(ck[path], cluster["one_cont"], rtol=RTOL)
