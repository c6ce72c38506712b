"""The port's distributed optimizer against the JAX package's, and fp32
ZeRO-1 against the port's own replicated optimizer.

- ``zero1_sharding`` on ``TestZero1Sharding``'s specs, compared as axis
  tuples (``_axes_of``: jax 0.9 prints ``P(None, ("dp",))`` as
  ``P(None, "dp")``, which is why the reference's own
  ``test_skips_nondividing_dims`` is red).
- fp32 ZeRO-1 over positions of the CPU is bit-equal to the replicated
  optimizer (losses and every param after 6 Llama steps, dp=4 x fsdp=2
  and dp=8), and, over four updates fed the same grads, within 1e-6 of
  the JAX package's ``ShardedOptimizer(optax.adamw)``.
- int8 gradient communication passes ``loss_parity`` with nonzero
  drift, with and without stochastic rounding.
- ``hbm_accounting`` and the moments of ``state_bytes_per_replica``:
  integers equal to the reference's (torch keeps one fp32 ``step`` a
  leaf where optax keeps one int32 count, so the scalars are compared
  apart).
- The config plumbing: ``TrainConfig.optimizer_kwargs``, its
  ``DDL_TORCH_TRAIN_*`` twins, a ``Trainer`` with ZeRO-1 bit-equal to
  the replicated one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding as JaxSharding, PartitionSpec as JP

from ddl_tpu.models import llama as jllama
from ddl_tpu.parallel import optimizer as jopt
from ddl_tpu.parallel.mesh import make_mesh as jax_mesh
from ddl_tpu.parallel.train import make_train_step as jax_train_step
from ddl_tpu_torch.config import LoaderConfig, TrainConfig
from ddl_tpu_torch.models import llama as tllama
from ddl_tpu_torch.observability import Metrics
from ddl_tpu_torch.parallel import optimizer as topt
from ddl_tpu_torch.parallel.mesh import NamedSharding, P, make_mesh
from ddl_tpu_torch.parallel.train import (
    adamw,
    make_multistep,
    make_train_step,
    tree_leaves,
)

TINY = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq=64)
TCFG = tllama.LlamaConfig(**TINY, dtype=torch.float32)
JCFG = jllama.LlamaConfig(**TINY, dtype=jnp.float32)


def _axes(spec):
    return tuple(topt._axes_of(e) for e in tuple(spec))


def _jaxes(spec):
    return tuple(jopt._axes_of(e) for e in tuple(spec))


@pytest.mark.parametrize("spec,shape", [
    (("fsdp", None), (64, 64)),      # adds dp to the first dividing dim
    ((), (6, 64)),                    # skips the non-dividing dim 0
    ((), (3, 5)),                     # nothing divides: replicated
    ((), ()),                         # a scalar
    (("dp", None), (64, 64)),         # already dp-sharded: passes through
    ((None, "fsdp"), (8, 12)),        # dim 0 takes dp on its own
])
def test_zero1_sharding_equals_the_references(spec, shape):
    jm = jax_mesh({"dp": 4, "fsdp": 2})
    tm = make_mesh({"dp": 4, "fsdp": 2}, ["cpu"] * 8)
    want = jopt.zero1_sharding(JaxSharding(jm, JP(*spec)), shape)
    got = topt.zero1_sharding(NamedSharding(tm, P(*spec)), shape)
    assert _axes(got.spec) == _jaxes(want.spec)
    if spec == ("dp", None):
        sh = NamedSharding(tm, P(*spec))
        assert topt.zero1_sharding(sh, shape) is sh
    if spec == () and shape == (6, 64):
        # The reference builds the tuple entry ("dp",) too.
        assert tuple(got.spec) == (None, ("dp",))


def test_no_dp_axis_is_identity():
    tm = make_mesh({"fsdp": 8}, ["cpu"] * 8)
    sh = NamedSharding(tm, P("fsdp"))
    assert topt.zero1_sharding(sh, (64,)) is sh


def _np_params():
    return jax.tree.map(np.asarray, jllama.init_params(JCFG, jax.random.key(0)))


def _tokens(seed=0, batch=8, seq=32):
    return np.random.default_rng(seed).integers(0, TCFG.vocab, (batch, seq),
                                                dtype=np.int32)


def _run(mesh, np_params, n=6, **kw):
    init, step = make_train_step(
        lambda p, b: tllama.next_token_loss(p, b[0], TCFG, mesh=mesh),
        adamw(1e-2), mesh=mesh, param_specs=tllama.param_specs(TCFG), **kw)
    state = init(tllama.params_from_numpy(np_params, device="cpu"))
    batch = (torch.from_numpy(_tokens()),)
    losses = []
    for _ in range(n):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return state, losses


@pytest.mark.parametrize("axes", [{"dp": 4, "fsdp": 2}, {"dp": 8}])
def test_fp32_zero1_is_bit_equal_to_the_replicated_optimizer(axes):
    mesh = make_mesh(axes, ["cpu"] * 8)
    np_params = _np_params()
    st_r, l_r = _run(mesh, np_params)
    st_z, l_z = _run(mesh, np_params, optimizer_sharding="zero1")
    assert l_r == l_z
    gate = topt.loss_parity(l_r, l_z)
    assert gate["parity"] and gate["max_rel_drift"] == 0.0
    for a, b in zip(tree_leaves(st_r.params), tree_leaves(st_z.params)):
        assert torch.equal(a, b)
    assert isinstance(st_z.optimizer, topt.Zero1Optimizer)
    assert l_z[-1] < l_z[0]


def test_fp32_zero1_update_tracks_the_jax_package():
    """Four updates from the same params and the same grads: the port's
    ZeRO-1 over AdamW and the JAX package's ShardedOptimizer over
    optax.adamw land within 1e-6 (absolute, and relative)."""
    np_params = _np_params()
    jm = jax_mesh({"dp": 4, "fsdp": 2})
    jo = jopt.ShardedOptimizer(optax.adamw(1e-2), jm, jllama.param_specs(JCFG))
    jp = jax.tree.map(jnp.asarray, np_params)
    js = jo.init(jp)
    update = jax.jit(lambda g, s, p: jo.update(g, s, p))
    tm = make_mesh({"dp": 4, "fsdp": 2}, ["cpu"] * 8)
    to = topt.ShardedOptimizer(adamw(1e-2), tm, tllama.param_specs(TCFG))
    tp = jax.tree.map(lambda x: torch.tensor(x, requires_grad=True), np_params)
    zo = to.init(tp)
    rng = np.random.default_rng(3)
    for _ in range(4):
        grads = jax.tree.map(
            lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32),
            np_params)
        u, js = update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, u)
        for p, g in zip(tree_leaves(tp), jax.tree.leaves(grads)):
            p.grad = torch.from_numpy(g)
        zo.step()
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(optimizer_sharding="zero1", grad_comm="int8"),
    dict(optimizer_sharding="zero1", grad_comm="int8", stochastic_rounding=True),
    dict(grad_comm="int8"),
    dict(optimizer_sharding="zero1", grad_comm="int8", grad_comm_block=64),
])
def test_int8_passes_loss_parity_with_nonzero_drift(kw):
    mesh = make_mesh({"dp": 4, "fsdp": 2}, ["cpu"] * 8)
    np_params = _np_params()
    _, l_r = _run(mesh, np_params)
    _, l_q = _run(mesh, np_params, **kw)
    gate = topt.loss_parity(l_r, l_q)
    assert gate["parity"], gate
    assert gate["rel_tol"] == topt.PARITY_REL_TOL == jopt.PARITY_REL_TOL
    assert gate["max_rel_drift"] > 0.0  # the path IS engaged
    assert l_q[-1] < l_q[0]


def test_stochastic_rounding_is_deterministic_per_step():
    mesh = make_mesh({"dp": 4}, ["cpu"] * 4)
    kw = dict(optimizer_sharding="zero1", grad_comm="int8",
              stochastic_rounding=True)
    _, a = _run(mesh, _np_params(), n=3, **kw)
    _, b = _run(mesh, _np_params(), n=3, **kw)
    assert a == b


def test_multistep_matches_single_step_zero1():
    mesh = make_mesh({"dp": 4, "fsdp": 2}, ["cpu"] * 8)
    np_params = _np_params()
    _, single = _run(mesh, np_params, n=4, optimizer_sharding="zero1")
    init, multi = make_multistep(
        lambda p, b: tllama.next_token_loss(p, b[0], TCFG, mesh=mesh),
        adamw(1e-2), mesh=mesh, param_specs=tllama.param_specs(TCFG),
        n_steps=4, optimizer_sharding="zero1")
    state, losses = multi(init(tllama.params_from_numpy(np_params, "cpu")),
                          (torch.from_numpy(_tokens()),))
    assert [float(x) for x in losses] == single


def _jax_states(axes):
    """The JAX package's placed optimizer states (replicated, zero1)."""
    jm = jax_mesh(axes)
    specs = jllama.param_specs(JCFG)
    params = jllama.init_params(JCFG, jax.random.key(0))
    loss = lambda p, b: jllama.next_token_loss(p, b[0], JCFG)  # noqa: E731
    out = []
    for opt in (optax.adamw(1e-2),
                jopt.ShardedOptimizer(optax.adamw(1e-2), jm, specs)):
        init, _ = jax_train_step(loss, opt, jm, specs, batch_spec=JP(("dp",)))
        out.append(init(params).opt_state)
    return out


@pytest.mark.parametrize("axes", [{"dp": 4, "fsdp": 2}, {"dp": 8}])
def test_state_bytes_per_replica_equal_the_references(axes):
    j_rep, j_z1 = _jax_states(axes)
    mesh = make_mesh(axes, ["cpu"] * 8)
    np_params = _np_params()
    st_r, _ = _run(mesh, np_params, n=1)
    st_z, _ = _run(mesh, np_params, n=1, optimizer_sharding="zero1")
    n_leaves = len(tree_leaves(st_r.params))
    for st, want in ((st_r, j_rep), (st_z, j_z1)):
        ref = jopt.state_bytes_per_replica(want)
        moments = topt.state_bytes_per_replica(st.optimizer, moments_only=True)
        # optax: one int32 count; torch: one fp32 step a tensor it steps
        # (a leaf, or each slice a replica owns).
        assert moments == ref - 4
        opt = st.optimizer
        n_steps = (len(opt.replicas[0].param_groups[0]["params"])
                   if isinstance(opt, topt.Zero1Optimizer) else n_leaves)
        assert topt.state_bytes_per_replica(opt) == moments + 4 * n_steps
    z = topt.state_bytes_per_replica(st_z.optimizer, moments_only=True)
    r = topt.state_bytes_per_replica(st_r.optimizer, moments_only=True)
    assert r == axes["dp"] * z
    from ddl_tpu_torch.observability import metrics as default_metrics

    init, _ = make_train_step(lambda p, b: 0, adamw(1e-2), mesh=mesh,
                              param_specs=tllama.param_specs(TCFG),
                              optimizer_sharding="zero1")
    opt = init(tllama.params_from_numpy(np_params, "cpu")).optimizer
    assert default_metrics().gauge("opt.state_bytes_per_replica") == float(
        topt.state_bytes_per_replica(opt))


def _meta(tree):
    return jax.tree.map(
        lambda s: torch.empty(s.shape, dtype=getattr(torch, str(s.dtype)),
                              device="meta"), tree)


@pytest.mark.parametrize("sharding", ["none", "zero1"])
@pytest.mark.parametrize("pod", [{"dp": 8, "fsdp": 4}, {"dp": 4, "tp": 2},
                                 {"dp": 3}])
def test_hbm_accounting_equals_the_references(sharding, pod):
    jcfg = jllama.LlamaConfig.llama_4b()
    tcfg = tllama.LlamaConfig(
        vocab=jcfg.vocab, d_model=jcfg.d_model, n_layers=jcfg.n_layers,
        n_heads=jcfg.n_heads, n_kv_heads=jcfg.n_kv_heads, d_ff=jcfg.d_ff,
        max_seq=jcfg.max_seq)
    want = jopt.hbm_accounting(jllama.param_shapes(jcfg),
                               jllama.param_specs(jcfg), pod, sharding)
    got = topt.hbm_accounting(tllama.param_shapes(tcfg),
                              tllama.param_specs(tcfg), pod, sharding)
    assert (got.param_bytes, got.grad_bytes, got.opt_state_bytes) == (
        want.param_bytes, want.grad_bytes, want.opt_state_bytes)
    assert got.total_bytes == want.total_bytes
    # The meta tree is init_params' layout.
    shapes = jax.tree.map(lambda s: tuple(s.shape), jllama.param_shapes(jcfg))
    assert sorted(tuple(t.shape) for t in tree_leaves(tllama.param_shapes(tcfg))) \
        == sorted(jax.tree.leaves(shapes, is_leaf=lambda x: isinstance(x, tuple)))


@pytest.mark.parametrize("shape,spec", [((64, 64), P("fsdp", None)),
                                        ((6, 5), P("fsdp", None))])
def test_hbm_accounting_known_cases(shape, spec):
    leaf = torch.empty(shape, device="meta")
    jleaf = jax.ShapeDtypeStruct(shape, jnp.float32)
    for mode in ("none", "zero1"):
        got = topt.hbm_accounting([leaf], [spec], {"dp": 4, "fsdp": 2}, mode)
        want = jopt.hbm_accounting([jleaf], [JP(*spec)], {"dp": 4, "fsdp": 2},
                                   mode)
        assert got == topt.HbmAccount(want.param_bytes, want.grad_bytes,
                                      want.opt_state_bytes)
    with pytest.raises(ValueError, match="optimizer_sharding"):
        topt.hbm_accounting([leaf], [spec], {"dp": 2}, "zero2")


def test_loss_parity_equals_the_references():
    for a, b, tol in (([1.0, 0.5], [1.0, 0.5], 2e-2),
                      ([1.0, 1.0], [1.0, 1.05], 2e-2),
                      ([2.0, 3.0], [2.01, 2.99], 1e-3)):
        assert topt.loss_parity(a, b, tol) == jopt.loss_parity(a, b, tol)
    with pytest.raises(ValueError, match="length"):
        topt.loss_parity([1.0], [1.0, 2.0])


def test_measure_legs_records_timers():
    mesh = make_mesh({"dp": 4, "fsdp": 2}, ["cpu"] * 8)
    opt = topt.ShardedOptimizer(adamw(1e-2), mesh, tllama.param_specs(TCFG))
    m = Metrics()
    legs = opt.measure_legs(tllama.params_from_numpy(_np_params(), "cpu"),
                            metrics=m)
    assert legs["gather_s"] > 0 and legs["scatter_s"] > 0
    assert m.timer("opt.gather").count == 1
    assert m.timer("opt.scatter").count == 1


def test_inactive_on_a_dp1_mesh_and_validation():
    mesh = make_mesh({"dp": 1}, ["cpu"])
    opt = topt.ShardedOptimizer(adamw(1e-2), mesh, tllama.param_specs(TCFG))
    assert not opt.active
    _, losses = _run(mesh, _np_params(), n=2, optimizer_sharding="zero1")
    assert np.isfinite(losses).all()
    with pytest.raises(ValueError, match="grad_comm"):
        topt.ShardedOptimizer(adamw(1e-2), mesh, {}, grad_comm="fp16")
    with pytest.raises(ValueError, match="optimizer_sharding"):
        make_train_step(lambda p, b: 0, adamw(1e-2), mesh=mesh,
                        optimizer_sharding="zero3")
    with pytest.raises(ValueError, match="needs a mesh"):
        make_train_step(lambda p, b: 0, adamw(1e-2), "cpu",
                        optimizer_sharding="zero1")


def test_sync_checkpoint_round_trips_zero1_state(tmp_path):
    from ddl_tpu_torch.checkpoint import restore_train_state, save_train_state

    mesh = make_mesh({"dp": 4}, ["cpu"] * 4)
    np_params = _np_params()
    st, _ = _run(mesh, np_params, n=2, optimizer_sharding="zero1")
    save_train_state(st, str(tmp_path))
    fresh, _ = _run(mesh, np_params, n=0, optimizer_sharding="zero1")
    back = restore_train_state(str(tmp_path), like=fresh)
    assert back.step == st.step
    a = st.optimizer.state
    b = back.optimizer.state
    for pa, pb in zip(tree_leaves(st.params), tree_leaves(back.params)):
        assert torch.equal(pa, pb)
        assert torch.equal(a[pa]["exp_avg"], b[pb]["exp_avg"])
        assert torch.equal(a[pa]["exp_avg_sq"], b[pb]["exp_avg_sq"])


# -- config plumbing ----------------------------------------------------------


def test_train_config_validates_and_splats():
    tc = TrainConfig.load(optimizer_sharding="zero1", grad_comm="int8")
    assert tc.optimizer_kwargs() == {
        "optimizer_sharding": "zero1", "grad_comm": "int8",
        "grad_comm_block": 0, "stochastic_rounding": False,
    }
    with pytest.raises(ValueError, match="optimizer_sharding"):
        TrainConfig.load(optimizer_sharding="zero3")
    with pytest.raises(ValueError, match="grad_comm"):
        TrainConfig.load(grad_comm="fp8")


def test_env_twins_reach_the_step_factories(monkeypatch):
    monkeypatch.setenv("DDL_TORCH_TRAIN_OPTIMIZER_SHARDING", "zero1")
    monkeypatch.setenv("DDL_TORCH_TRAIN_GRAD_COMM", "int8")
    monkeypatch.setenv("DDL_TORCH_TRAIN_GRAD_COMM_BLOCK", "64")
    monkeypatch.setenv("DDL_TORCH_TRAIN_STOCHASTIC_ROUNDING", "1")
    tc = TrainConfig.load()
    assert tc.optimizer_kwargs() == {
        "optimizer_sharding": "zero1", "grad_comm": "int8",
        "grad_comm_block": 64, "stochastic_rounding": True,
    }
    mesh = make_mesh({"dp": 2}, ["cpu"] * 2)
    init, _ = make_train_step(lambda p, b: 0, adamw(1e-2), mesh=mesh,
                              param_specs=tllama.param_specs(TCFG),
                              **tc.optimizer_kwargs())
    opt = init(tllama.params_from_numpy(_np_params(), "cpu")).optimizer
    assert isinstance(opt, topt.Zero1Optimizer)
    assert (opt.cfg.active, opt.cfg.grad_comm, opt.cfg.block,
            opt.cfg.stochastic_rounding) == (True, "int8", 64, True)


def test_trainer_zero1_matches_replicated(tmp_path):
    """A Trainer built from ``TrainConfig(optimizer_sharding="zero1")``
    trains bit-identically to the replicated Trainer on the same stream,
    over a dp=2 mesh of CPU positions."""
    from ddl_tpu_torch.readers import TokenStreamProducer
    from ddl_tpu_torch.trainer import Trainer

    path = os.path.join(tmp_path, "tokens.bin")
    np.random.default_rng(2).integers(0, TCFG.vocab, 20_000,
                                      dtype=np.int32).tofile(path)
    mesh = make_mesh({"dp": 2}, ["cpu"] * 2)

    def fit(train_config):
        return Trainer(
            lambda p, b: tllama.next_token_loss(p, b[0], TCFG, mesh=mesh),
            adamw(3e-3), tllama.params_from_numpy(_np_params(), "cpu"),
            device="cpu", metrics=Metrics(), train_config=train_config,
            mesh=mesh, param_specs=tllama.param_specs(TCFG),
        ).fit(TokenStreamProducer(path, 32, 8), config=LoaderConfig(
            batch_size=4, n_epochs=3, n_producers=2, window_stream=True))

    rep = fit(None)
    z1 = fit(TrainConfig(optimizer_sharding="zero1"))
    assert z1.losses == rep.losses
    assert isinstance(z1.state.optimizer, topt.Zero1Optimizer)
