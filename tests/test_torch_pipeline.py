"""The port's pipeline schedule (``ddl_tpu_torch/parallel/pipeline.py``
and the ``*_pp`` path of ``models/llama.py``) against the JAX package's
``pipeline_apply`` / ``forward_pp`` on the conftest's 8 virtual CPU
devices, from the same numpy inputs.

Each test twins one of ``tests/test_pipeline.py`` (all but the MoE and
ViT classes, whose models are not ported yet): toy stages at
``atol 1e-5``, Llama logits at ``atol = rtol = 2e-5``, gradients at a
relative Frobenius error of 1e-4, train-step losses at ``rtol 1e-4``.
Within the port, gpipe, 1f1b and the sequential fallback apply the same
layer ops to the same microbatch shapes in the same order, so their
outputs and gradients are held bit for bit (``torch.equal``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from ddl_tpu.models import llama as jllama
from ddl_tpu.parallel import pipeline as jpipe
from ddl_tpu.parallel.mesh import make_mesh as jmesh
from ddl_tpu_torch.models import llama as tllama
from ddl_tpu_torch.observability import Metrics
from ddl_tpu_torch.parallel import pipeline as tpipe
from ddl_tpu_torch.parallel.mesh import P, make_mesh
from ddl_tpu_torch.parallel.train import adamw, make_train_step, tree_leaves

D = 16


def tmesh(axes):
    return make_mesh(axes, ["cpu"] * int(np.prod(list(axes.values()))))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# -- toy stages ------------------------------------------------------------------


def _stages_np(rng, n):
    return [{"w": (rng.standard_normal((D, D)) / 4).astype(np.float32),
             "b": (rng.standard_normal((D,)) / 4).astype(np.float32)}
            for _ in range(n)]


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree, grad=False):
    return jax.tree.map(
        lambda a: torch.tensor(np.asarray(a)).requires_grad_(grad), tree)


def _jstage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _tstage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _jlayers_stage(stage, x):
    out, _ = jax.lax.scan(lambda c, lyr: (_jstage(lyr, c), None), x, stage)
    return out


def _tlayers_stage(stage, x):
    for i in range(stage["w"].shape[0]):
        x = _tstage({"w": stage["w"][i], "b": stage["b"][i]}, x)
    return x


def _tseq(layers, x):
    for p in layers:
        x = _tstage(p, x)
    return x


def test_pipeline_matches_sequential(rng):
    stages = _stages_np(rng, 4)
    x = rng.standard_normal((8, D)).astype(np.float32)
    want = jpipe.pipeline_apply(jpipe.stack_stage_params(_j(stages)),
                                jnp.asarray(x), _jstage,
                                jmesh({"pp": 4, "dp": 2}), n_microbatches=4)
    got = tpipe.pipeline_apply(tpipe.stack_stage_params(_t(stages)),
                               torch.tensor(x), _tstage,
                               tmesh({"pp": 4, "dp": 2}), n_microbatches=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(),
                               _tseq(_t(stages), torch.tensor(x)).numpy(),
                               atol=1e-5)


def test_pipeline_fallback_no_pp_axis(rng):
    stages = _stages_np(rng, 3)
    x = rng.standard_normal((4, D)).astype(np.float32)
    want = jpipe.pipeline_apply(jpipe.stack_stage_params(_j(stages)),
                                jnp.asarray(x), _jstage, jmesh({"dp": 8}),
                                n_microbatches=2)
    got = tpipe.pipeline_apply(tpipe.stack_stage_params(_t(stages)),
                               torch.tensor(x), _tstage, tmesh({"dp": 8}),
                               n_microbatches=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_pipeline_spec_prepends_pp():
    spec = tpipe.pipeline_spec({"w": P("fsdp", "tp"), "b": P(None)})
    want = jpipe.pipeline_spec({"w": JP("fsdp", "tp"), "b": JP(None)})
    assert spec["w"] == P("pp", "fsdp", "tp")
    assert spec["b"] == P("pp", None)
    assert {k: tuple(v) for k, v in spec.items()} == {
        k: tuple(v) for k, v in want.items()}


def test_bubble_fraction():
    from ddl_tpu_torch.parallel import bubble_fraction

    cases = [((1, 4), {}), ((4, 4), {}), ((4, 28), {}),
             ((4, 4), {"schedule": "1f1b"}),
             ((4, 4), {"schedule": "1f1b", "n_chunks": 4}),
             ((2, 2), {"schedule": "gpipe"})]
    for args, kw in cases:
        assert bubble_fraction(*args, **kw) == jpipe.bubble_fraction(*args, **kw)
    assert bubble_fraction(4, 4, schedule="1f1b") == 3 / 11
    for args, kw in [((0, 4), {}), ((4, 4), {"schedule": "pipedream"}),
                     ((4, 4), {"schedule": "gpipe", "n_chunks": 2})]:
        with pytest.raises(ValueError):
            bubble_fraction(*args, **kw)
        with pytest.raises(ValueError):
            jpipe.bubble_fraction(*args, **kw)


class Test1F1BSchedule:
    """The interleaved schedule: chunk layout, forward and grads against
    the JAX package, bit-equality with gpipe in the port, the checks."""

    def test_chunk_layout(self, rng):
        layers = _stages_np(rng, 8)
        got = tpipe.stack_layer_stages(_t(layers), 4, n_chunks=2)
        want = jpipe.stack_layer_stages(_j(layers), 4, n_chunks=2)
        assert tuple(got["w"].shape) == (4, 2, 1, D, D)
        np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
        np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))
        with pytest.raises(ValueError):
            tpipe.stack_layer_stages(_t(layers), 4, n_chunks=3)

    def test_1f1b_matches_sequential_and_gpipe(self, rng):
        layers = _stages_np(rng, 8)
        x = rng.standard_normal((8, D)).astype(np.float32)
        jm, tm = jmesh({"pp": 4, "dp": 2}), tmesh({"pp": 4, "dp": 2})
        for M in (4, 8):
            want = jpipe.pipeline_apply(
                jpipe.stack_layer_stages(_j(layers), 4, n_chunks=2),
                jnp.asarray(x), _jlayers_stage, jm, M, schedule="1f1b",
                n_chunks=2)
            f1 = tpipe.pipeline_apply(
                tpipe.stack_layer_stages(_t(layers), 4, n_chunks=2),
                torch.tensor(x), _tlayers_stage, tm, M, schedule="1f1b",
                n_chunks=2)
            gp = tpipe.pipeline_apply(
                tpipe.stack_layer_stages(_t(layers), 4), torch.tensor(x),
                _tlayers_stage, tm, M)
            np.testing.assert_allclose(f1.numpy(), np.asarray(want), atol=1e-5)
            np.testing.assert_allclose(
                f1.numpy(), _tseq(_t(layers), torch.tensor(x)).numpy(),
                atol=1e-5)
            assert torch.equal(f1, gp), M

    def test_1f1b_fallback_no_pp_axis(self, rng):
        layers = _stages_np(rng, 8)
        x = rng.standard_normal((8, D)).astype(np.float32)
        stacked = tpipe.stack_layer_stages(_t(layers), 4, n_chunks=2)
        fb = tpipe.pipeline_apply(stacked, torch.tensor(x), _tlayers_stage,
                                  tmesh({"dp": 8}), 4, schedule="1f1b",
                                  n_chunks=2)
        want = jpipe.pipeline_apply(
            jpipe.stack_layer_stages(_j(layers), 4, n_chunks=2),
            jnp.asarray(x), _jlayers_stage, jmesh({"dp": 8}), 4,
            schedule="1f1b", n_chunks=2)
        np.testing.assert_allclose(fb.numpy(), np.asarray(want), atol=1e-5)
        piped = tpipe.pipeline_apply(stacked, torch.tensor(x), _tlayers_stage,
                                     tmesh({"pp": 4, "dp": 2}), 4,
                                     schedule="1f1b", n_chunks=2)
        assert torch.equal(fb, piped)

    def test_1f1b_grads_match_gpipe(self, rng):
        layers = _stages_np(rng, 8)
        x = rng.standard_normal((8, D)).astype(np.float32)
        jm, tm = jmesh({"pp": 4, "dp": 2}), tmesh({"pp": 4, "dp": 2})

        def jloss(stacked, schedule, n_chunks):
            out = jpipe.pipeline_apply(stacked, jnp.asarray(x),
                                       _jlayers_stage, jm, 4,
                                       schedule=schedule, n_chunks=n_chunks)
            return jnp.sum(out ** 2)

        jg = jax.jit(jax.grad(lambda p: jloss(p, "gpipe", None)))(
            jpipe.stack_layer_stages(_j(layers), 4))
        grads = {}
        for schedule, V in (("gpipe", None), ("1f1b", 2)):
            stacked = tpipe.stack_layer_stages(_t(layers), 4, n_chunks=V or 1)
            stacked = {k: v.detach().requires_grad_(True)
                       for k, v in stacked.items()}
            out = tpipe.pipeline_apply(stacked, torch.tensor(x),
                                       _tlayers_stage, tm, 4,
                                       schedule=schedule, n_chunks=V)
            (out ** 2).sum().backward()
            grads[schedule] = {k: v.grad for k, v in stacked.items()}
        gg, gf = grads["gpipe"], grads["1f1b"]
        for li in range(8):
            for k in ("w", "b"):
                assert torch.equal(gg[k][li // 2, li % 2],
                                   gf[k][li % 4, li // 4, 0]), (li, k)
        for k in ("w", "b"):
            assert _rel(gg[k].numpy(), jg[k]) < 1e-4, k

    def test_1f1b_requires_divisible_microbatches(self, rng):
        layers = _stages_np(rng, 8)
        tm = tmesh({"pp": 4, "dp": 2})
        st = tpipe.stack_layer_stages(_t(layers), 4, n_chunks=2)
        x6 = torch.tensor(rng.standard_normal((6, D)), dtype=torch.float32)
        with pytest.raises(ValueError, match="divisible by n_stages"):
            tpipe.pipeline_apply(st, x6, _tlayers_stage, tm, 6,
                                 schedule="1f1b", n_chunks=2)
        x8 = torch.tensor(rng.standard_normal((8, D)), dtype=torch.float32)
        with pytest.raises(ValueError, match="stack_layer_stages"):
            tpipe.pipeline_apply(tpipe.stack_layer_stages(_t(layers[:4]), 4),
                                 x8, _tlayers_stage, tm, 4,
                                 schedule="1f1b", n_chunks=2)


def test_pipeline_gauges_and_tick_counts(rng):
    """``pp.bubble`` / ``pp.chunks`` as the reference sets them; the live
    (tick, position) pairs leave exactly the analytic bubble idle."""
    layers = _stages_np(rng, 8)
    x = torch.tensor(rng.standard_normal((8, D)), dtype=torch.float32)
    for schedule, V, M in (("gpipe", None, 4), ("1f1b", 2, 4)):
        m = Metrics()
        tpipe.pipeline_apply(
            tpipe.stack_layer_stages(_t(layers), 4, n_chunks=V or 1), x,
            _tlayers_stage, tmesh({"pp": 4, "dp": 2}), M, schedule=schedule,
            n_chunks=V, metrics=m)
        bubble = tpipe.bubble_fraction(4, M, schedule, V)
        assert m.gauge("pp.bubble") == bubble
        assert m.gauge("pp.chunks") == float(V or 1)
        idle = 1 - m.counter("pp.live_ticks") / m.counter("pp.ticks")
        assert abs(idle - bubble) < 1e-12


def test_pipeline_tree_activations(rng):
    """An activation TREE hops as one: every leaf rides the ring."""
    stages = _stages_np(rng, 2)
    x = torch.tensor(rng.standard_normal((4, D)), dtype=torch.float32)
    aux = torch.zeros(4, 1)

    def stage(p, h):
        return {"x": _tstage(p, h["x"]), "aux": h["aux"] + h["x"].sum(-1, keepdim=True)}

    out = tpipe.pipeline_apply(tpipe.stack_stage_params(_t(stages)),
                               {"x": x, "aux": aux}, stage,
                               tmesh({"pp": 2}), 2)
    seq = {"x": x, "aux": aux}
    for p in _t(stages):
        seq = stage(p, seq)
    assert torch.equal(out["x"], seq["x"]) and torch.equal(out["aux"], seq["aux"])


# -- the Llama pipeline ------------------------------------------------------------


def _cfgs(n_layers=4, **kw):
    j = jllama.LlamaConfig(vocab=64, d_model=32, n_layers=n_layers, n_heads=4,
                           n_kv_heads=2, d_ff=64, dtype=jnp.float32,
                           attn_impl="dense", **kw)
    t = tllama.LlamaConfig(vocab=64, d_model=32, n_layers=n_layers, n_heads=4,
                           n_kv_heads=2, d_ff=64, dtype=torch.float32,
                           attn_impl="dense", **kw)
    return j, t


def _weights(n_layers, batch=8, seed=0):
    jcfg, _ = _cfgs(n_layers)
    params = jax.tree.map(np.asarray, jllama.init_params(jcfg, jax.random.key(0)))
    tokens = np.random.default_rng(seed).integers(0, 64, (batch, 16)).astype(np.int32)
    return params, tokens


def _jfwd(params, tokens, cfg, mesh, M, **kw):
    """The JAX package's ``forward_pp``, jitted (an eager ``shard_map``
    scan is several times slower)."""
    return jax.jit(lambda p, t: jllama.forward_pp(
        p, t, cfg, mesh, n_microbatches=M, **kw))(params, tokens)


def _tparams(np_params, grad=False):
    p = tllama.params_from_numpy(np_params, device="cpu")
    return jax.tree.map(lambda t: t.requires_grad_(grad), p) if grad else p


def _tstaged(np_params, S, V=1):
    st = tllama.stage_params(tllama.params_from_numpy(np_params, device="cpu"),
                             S, n_chunks=V)
    return jax.tree.map(lambda t: t.detach().requires_grad_(True), st)


class TestLlamaPipeline:

    def test_stage_params_layout(self):
        params, _ = _weights(4)
        pp = tllama.stage_params(tllama.params_from_numpy(params, device="cpu"), 2)
        assert tuple(pp["stages"]["wq"].shape) == (2, 2, 32, 32)
        np.testing.assert_array_equal(pp["stages"]["wq"][1, 0].numpy(),
                                      params["layers"][2]["wq"])
        jcfg, tcfg = _cfgs(4)
        want = jllama.stage_params(_j(params), 2, n_chunks=1)
        for k, v in pp["stages"].items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want["stages"][k]))
        specs = tllama.pp_param_specs(tcfg, n_chunks=2)
        jspecs = jllama.pp_param_specs(jcfg, n_chunks=2)
        assert {k: tuple(v) for k, v in specs["stages"].items()} == {
            k: tuple(v) for k, v in jspecs["stages"].items()}
        with pytest.raises(ValueError):
            tllama.stage_params(tllama.params_from_numpy(params, device="cpu"), 3)

    def test_forward_pp_matches_forward(self):
        params, tokens = _weights(4)
        jcfg, tcfg = _cfgs(4)
        ref = tllama.forward(_tparams(params), torch.tensor(tokens), tcfg)
        for S, dp, M in ((4, 2, 4), (2, 4, 2), (4, 2, 8)):
            want = _jfwd(jllama.stage_params(_j(params), S),
                         jnp.asarray(tokens), jcfg, jmesh({"pp": S, "dp": dp}), M)
            got = tllama.forward_pp(_tstaged(params, S), torch.tensor(tokens),
                                    tcfg, tmesh({"pp": S, "dp": dp}),
                                    n_microbatches=M).detach()
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=2e-5, rtol=2e-5,
                                       err_msg=f"pp={S} dp={dp} M={M}")
            np.testing.assert_allclose(got.numpy(), ref.detach().numpy(),
                                       atol=2e-5, rtol=2e-5)

    def _train(self, axes, S, steps=8):
        params, _ = _weights(4)
        jcfg, tcfg = _cfgs(4)
        tokens = np.random.default_rng(0).integers(0, 64, (8, 16)).astype(np.int32)
        jm = jmesh(axes)
        from ddl_tpu.parallel.train import make_train_step as jstep

        jinit, jfn = jstep(
            lambda p, b: jllama.next_token_loss_pp(p, b, jcfg, jm,
                                                   n_microbatches=4),
            optax.adamw(1e-2), jm, jllama.pp_param_specs(jcfg),
            batch_spec=JP(("dp",)))
        js = jinit(jllama.stage_params(_j(params), S))
        tm = tmesh(axes)
        tinit, tfn = make_train_step(
            lambda p, b: tllama.next_token_loss_pp(p, b[0], tcfg, tm,
                                                   n_microbatches=4),
            adamw(1e-2), mesh=tm, param_specs=tllama.pp_param_specs(tcfg),
            batch_spec=P(("dp",)))
        ts = tinit(tllama.stage_params(_tparams(params), S))
        jl, tl = [], []
        for _ in range(steps):
            js, loss = jfn(js, tokens)
            jl.append(float(loss))
            ts, loss = tfn(ts, (torch.tensor(tokens),))
            tl.append(float(loss))
        ref = float(tllama.next_token_loss(_tparams(params),
                                           torch.tensor(tokens), tcfg))
        return jl, tl, ref

    def test_train_step_pp_llama(self):
        jl, tl, ref = self._train({"pp": 4, "dp": 2}, 4)
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        assert abs(tl[0] - ref) < 0.05, (tl[0], ref)
        assert tl[-1] < tl[0] - 0.3, tl

    def test_forward_pp_tp_resident_matches(self):
        params, tokens = _weights(4)
        jcfg, tcfg = _cfgs(4)
        want = _jfwd(jllama.stage_params(_j(params), 2), jnp.asarray(tokens),
                     jcfg, jmesh({"pp": 2, "tp": 2, "dp": 2}), 4)
        mesh = tmesh({"pp": 2, "tp": 2, "dp": 2})
        assert tllama.tp_resident(tcfg, mesh) == 2
        got = tllama.forward_pp(_tstaged(params, 2), torch.tensor(tokens), tcfg,
                                mesh, n_microbatches=4).detach()
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)
        ref = tllama.forward(_tparams(params), torch.tensor(tokens), tcfg)
        np.testing.assert_allclose(got.numpy(), ref.detach().numpy(),
                                   atol=2e-5, rtol=2e-5)

    def test_forward_pp_degenerate_pp1_with_tp(self):
        params, tokens = _weights(4, batch=4)
        jcfg, tcfg = _cfgs(4)
        mesh = tmesh({"pp": 1, "tp": 2, "dp": 4})
        assert tllama.tp_resident(tcfg, mesh) == 1
        got = tllama.forward_pp(_tstaged(params, 1), torch.tensor(tokens), tcfg,
                                mesh, n_microbatches=2).detach()
        want = jllama.forward_pp(jllama.stage_params(_j(params), 1),
                                 jnp.asarray(tokens), jcfg,
                                 jmesh({"pp": 1, "tp": 2, "dp": 4}),
                                 n_microbatches=2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)

    def test_train_step_pp_tp_llama(self):
        jl, tl, ref = self._train({"pp": 2, "tp": 2, "dp": 2}, 2, steps=6)
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        assert abs(tl[0] - ref) < 0.05, (tl[0], ref)
        assert tl[-1] < tl[0] - 0.3, tl

    def test_tp_resident_grads_match_plain(self):
        """The sums over tp positions are differentiable: the tp-resident
        loss's grads equal the gpipe stages' (pp x dp) at 1e-4 relative,
        each tp position's column/row block getting its own share."""
        params, tokens = _weights(4)
        _, tcfg = _cfgs(4)
        grads = []
        for axes in ({"pp": 2, "tp": 2, "dp": 2}, {"pp": 2, "dp": 4}):
            st = _tstaged(params, 2)
            tllama.next_token_loss_pp(st, torch.tensor(tokens), tcfg,
                                      tmesh(axes), n_microbatches=4).backward()
            grads.append([p.grad.numpy() for p in tree_leaves(st)])
        for a, b in zip(*grads):
            assert _rel(a, b) < 1e-4

    def test_remat_pp_matches(self):
        params, tokens = _weights(4, batch=4)
        jcfg, tcfg = _cfgs(4)
        tm, jm = tmesh({"pp": 4, "dp": 2}), jmesh({"pp": 4, "dp": 2})
        a = tllama.forward_pp(_tstaged(params, 4), torch.tensor(tokens), tcfg,
                              tm, n_microbatches=4)
        for policy in (True, "full", "selective", "dots"):
            cfg_r = dataclasses.replace(tcfg, remat=policy)
            st = _tstaged(params, 4)
            b = tllama.forward_pp(st, torch.tensor(tokens), cfg_r, tm,
                                  n_microbatches=4)
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                       atol=1e-6, err_msg=f"remat={policy}")
            jb = _jfwd(jllama.stage_params(_j(params), 4), jnp.asarray(tokens),
                       dataclasses.replace(jcfg, remat=policy), jm, 4)
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(jb),
                                       atol=2e-5, rtol=2e-5)
            b.square().sum().backward()  # the recompute runs

    def test_forward_pp_1f1b_matches_forward(self):
        params, tokens = _weights(8)
        jcfg, tcfg = _cfgs(8)
        want = _jfwd(jllama.stage_params(_j(params), 4, n_chunks=2),
                     jnp.asarray(tokens), jcfg, jmesh({"pp": 4, "dp": 2}), 4,
                     schedule="1f1b", n_chunks=2)
        got = tllama.forward_pp(_tstaged(params, 4, 2), torch.tensor(tokens),
                                tcfg, tmesh({"pp": 4, "dp": 2}),
                                n_microbatches=4, schedule="1f1b",
                                n_chunks=2).detach()
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)

    def test_train_step_1f1b_matches_gpipe(self):
        """Grads of both schedules against the JAX package's at 1e-4
        relative, and against each other (and the fallback) bit for bit."""
        params, _ = _weights(8)
        jcfg, tcfg = _cfgs(8)
        tokens = np.random.default_rng(0).integers(0, 64, (8, 16)).astype(np.int32)
        jm = jmesh({"pp": 4, "dp": 2})
        jg = jax.jit(jax.grad(lambda p: jllama.next_token_loss_pp(
            p, jnp.asarray(tokens), jcfg, jm, n_microbatches=4)))(
            jllama.stage_params(_j(params), 4))
        runs = {}
        for name, axes, V in (("gpipe", {"pp": 4, "dp": 2}, None),
                              ("1f1b", {"pp": 4, "dp": 2}, 2),
                              ("fallback", {"dp": 8}, 2)):
            st = _tstaged(params, 4, V or 1)
            loss = tllama.next_token_loss_pp(
                st, torch.tensor(tokens), tcfg, tmesh(axes), n_microbatches=4,
                schedule="gpipe" if V is None else "1f1b", n_chunks=V)
            loss.backward()
            runs[name] = (loss.detach(), jax.tree.map(lambda t: t.grad, st))
        lg, gg = runs["gpipe"]
        for other in ("1f1b", "fallback"):
            lf, gf = runs[other]
            assert torch.equal(lg, lf), other
            for li in range(8):
                for k in gg["stages"]:
                    assert torch.equal(gg["stages"][k][li // 2, li % 2],
                                       gf["stages"][k][li % 4, li // 4, 0]), (
                        other, li, k)
            for leaf in ("embed", "lm_head", "final_norm"):
                assert torch.equal(gg[leaf], gf[leaf])
        for k, v in gg["stages"].items():
            assert _rel(v.numpy(), jg["stages"][k]) < 1e-4, k
        for leaf in ("embed", "lm_head", "final_norm"):
            assert _rel(gg[leaf].numpy(), jg[leaf]) < 1e-4, leaf


def test_schedules_bit_equal_on_four_layers():
    """gpipe over 2 stages of 2 layers, 1f1b over 2 stages x 2 chunks of 1
    layer, and the sequential fallback: bit-equal logits."""
    params, tokens = _weights(4)
    _, tcfg = _cfgs(4)
    outs = [
        tllama.forward_pp(_tstaged(params, 2), torch.tensor(tokens), tcfg,
                          tmesh({"pp": 2, "dp": 2}), 2),
        tllama.forward_pp(_tstaged(params, 2, 2), torch.tensor(tokens), tcfg,
                          tmesh({"pp": 2, "dp": 2}), 2, schedule="1f1b",
                          n_chunks=2),
        tllama.forward_pp(_tstaged(params, 2), torch.tensor(tokens), tcfg,
                          tmesh({"dp": 2}), 2),
    ]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_train_config_drives_the_pipeline(monkeypatch):
    """``TrainConfig``'s pipeline fields (and their ``DDL_TORCH_TRAIN_*``
    twins) reach ``next_token_loss_pp`` through ``pipeline_kwargs()``."""
    from ddl_tpu_torch.config import TrainConfig

    monkeypatch.setenv("DDL_TORCH_TRAIN_SCHEDULE", "1f1b")
    monkeypatch.setenv("DDL_TORCH_TRAIN_PP_CHUNKS", "2")
    monkeypatch.setenv("DDL_TORCH_TRAIN_N_MICROBATCHES", "4")
    tc = TrainConfig.load()
    assert (tc.schedule, tc.pp_chunks, tc.n_microbatches) == ("1f1b", 2, 4)
    assert tc.pipeline_kwargs() == {"schedule": "1f1b", "n_chunks": 2}
    with pytest.raises(ValueError, match="schedule"):
        TrainConfig.load(schedule="pipedream")
    params, tokens = _weights(8)
    _, tcfg = _cfgs(8)
    loss = tllama.next_token_loss_pp(
        _tstaged(params, 4, tc.pp_chunks), torch.tensor(tokens), tcfg,
        tmesh({"pp": 4, "dp": 2}), tc.n_microbatches, **tc.pipeline_kwargs())
    ref = tllama.next_token_loss(_tparams(params), torch.tensor(tokens), tcfg)
    np.testing.assert_allclose(float(loss.detach()), float(ref.detach()),
                               rtol=2e-5)


def test_psum_sums_positions_differentiably():
    from ddl_tpu_torch.parallel.collectives import psum

    mesh = tmesh({"pp": 2, "tp": 2})
    parts = [torch.randn(3, 4, requires_grad=True) for _ in range(2)]
    out = psum(parts, mesh, "tp")
    assert torch.equal(out, parts[0] + parts[1])
    (out * 3).sum().backward()
    assert all(torch.equal(p.grad, torch.full((3, 4), 3.0)) for p in parts)
    with pytest.raises(ValueError):
        psum(parts[:1], mesh, "tp")


# -- the Trainer over a pp mesh and the stage layout's checkpoints ----------------


SEQ, ROWS, BATCH, EPOCHS, LR = 16, 8, 4, 3, 3e-3


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    import os

    path = os.path.join(tmp_path_factory.mktemp("pp-tok"), "tokens.bin")
    np.random.default_rng(2).integers(0, 64, 20_000, dtype=np.int32).tofile(path)
    return path


def _pp_fit(path, params, mesh, loss, specs, batch_spec, n_epochs=EPOCHS,
            checkpoint_dir=None, distribute_metrics=None):
    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.readers import TokenStreamProducer
    from ddl_tpu_torch.trainer import Trainer

    trainer = Trainer(loss, adamw(LR), params, device="cpu",
                      metrics=distribute_metrics or Metrics(),
                      checkpoint_dir=checkpoint_dir, mesh=mesh,
                      param_specs=specs, batch_spec=batch_spec)
    return trainer.fit(TokenStreamProducer(path, SEQ, ROWS), config=LoaderConfig(
        batch_size=BATCH, n_epochs=n_epochs, n_producers=2, window_stream=True))


@pytest.mark.parametrize("axes", [{"pp": 2, "dp": 2}, {"pp": 2, "tp": 2, "dp": 2}])
def test_trainer_fits_a_pp_mesh(token_file, axes):
    """A Trainer over a pp x dp (and pp x tp x dp) mesh fits with
    ``stage_params`` weights and ``pp_param_specs``, windows landed over
    ``P(None, ("dp",))``: per-window losses equal a ``mesh=None`` plain
    fit from the same weights within 1e-5 relative."""
    params, _ = _weights(4)
    _, tcfg = _cfgs(4)
    mesh = tmesh(axes)
    res = _pp_fit(
        token_file, tllama.stage_params(_tparams(params), 2), mesh,
        lambda p, b: tllama.next_token_loss_pp(p, b[0], tcfg, mesh, 2),
        tllama.pp_param_specs(tcfg), P(("dp",)))
    plain = _pp_fit(token_file, _tparams(params), None,
                    lambda p, b: tllama.next_token_loss(p, b[0], tcfg),
                    None, None)
    assert len(res.losses) == EPOCHS
    np.testing.assert_allclose(res.losses, plain.losses, rtol=1e-5)
    assert res.state.step == EPOCHS * ROWS // BATCH
    assert tuple(res.state.params["stages"]["wq"].shape) == (2, 2, 32, 32)


def test_stage_layout_checkpoints_resume_bit_equal(token_file, tmp_path):
    """Checkpoints save and restore THIS layout: a pp fit stopped after
    2 windows (async generations) and resumed by a fresh Trainer
    concatenates to the undisturbed run's losses bit for bit; the sync
    ``save_train_state`` round-trips the stage tree too."""
    from ddl_tpu_torch.checkpoint import restore_train_state, save_train_state

    params, _ = _weights(4)
    _, tcfg = _cfgs(4)
    mesh = tmesh({"pp": 2, "dp": 2})

    def fit(**kw):
        return _pp_fit(
            token_file, tllama.stage_params(_tparams(params), 2), mesh,
            lambda p, b: tllama.next_token_loss_pp(p, b[0], tcfg, mesh, 2),
            tllama.pp_param_specs(tcfg), P(("dp",)), **kw)

    full = fit()
    ckpt = str(tmp_path / "ckpt")
    first = fit(n_epochs=2, checkpoint_dir=ckpt)
    second = fit(checkpoint_dir=ckpt)
    assert second.resumed_from_epoch == 2
    assert first.losses + second.losses == full.losses
    sync = str(tmp_path / "sync")
    save_train_state(full.state, sync)
    init, _ = make_train_step(lambda p, b: 0, adamw(LR), device="cpu")
    fresh = init(tllama.stage_params(_tparams(params), 2))
    back = restore_train_state(sync, fresh)
    assert back.step == full.state.step
    for a, b in zip(tree_leaves(back.params), tree_leaves(full.state.params)):
        assert torch.equal(a, b)
