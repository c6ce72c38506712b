"""The port's MoE family (``ddl_tpu_torch/models/moe.py``) against the JAX
package's ``ddl_tpu/models/moe.py`` on the conftest's 8 virtual CPU
devices, from the same numpy weights and tokens.

Twins ``tests/test_moe.py`` (routing, the ragged impl, the model, decode,
the mesh steps), the MoE cases of ``tests/test_pipeline.py`` and the
selective-remat case of ``tests/test_models_train.py``.  Tolerances in
fp32: logits, outputs and aux 2e-5; gradients 1e-4 relative (Frobenius);
train-step losses rtol 1e-4; routing decisions (expert picks, arrival
slots, kept picks) exactly.

Capacity makes the einsum impl couple the tokens routed together, so
each routing-group rule is also held at a binding capacity
(``capacity_factor=0.5``: half the picks drop), where routing a wrong
group changes which tokens drop: ``mesh=None``, a one-card ``dp x ep``
mesh (one group, the whole batch), the ragged impl over ``dp`` / ``sp``
/ ``dp x tp`` (one group a token shard: the aux is the shards' mean),
and ``forward_pp`` over ``pp x dp`` (one group a dp shard of a
microbatch).  Each such case has a control, the port run with the wrong
group, that must miss the tolerance; and each asserts that its router's
smallest top-k margin exceeds the fp32 difference between the two
routers, so a flipped pick is a fault and not noise.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from ddl_tpu.models import moe as jm
from ddl_tpu.parallel.mesh import make_mesh as jmesh
from ddl_tpu.parallel.train import make_train_step as jstep
from ddl_tpu_torch.models import moe as tm
from ddl_tpu_torch.parallel.mesh import P, make_mesh
from ddl_tpu_torch.parallel.train import adamw, make_train_step

ATOL = 2e-5
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-4
BINDING = 0.5


def tmesh(axes):
    return make_mesh(axes, ["cpu"] * int(np.prod(list(axes.values()))))


def _cfgs(**kw):
    base = dict(vocab=64, d_model=32, n_layers=1, n_heads=4, n_kv_heads=2,
                d_ff=64, n_experts=4)
    base.update(kw)
    j = jm.MoeConfig(**base, dtype=jnp.float32)
    t = tm.MoeConfig(**base, dtype=torch.float32)
    return j, t


#: The JAX package's functions under ``jit`` (op-by-op dispatch of the
#: same calls takes several times longer on the CPU).
_jinit = jax.jit(jm.init_params, static_argnums=0)
_jmlp = jax.jit(jm.moe_mlp, static_argnums=2)
_jmlp_ragged = jax.jit(jm.moe_mlp_ragged, static_argnums=2)
_jrouter = jax.jit(jm._router_topk, static_argnums=2)


@functools.lru_cache(maxsize=None)
def _init(shape_cfg, seed):
    return jax.tree.map(np.asarray, _jinit(shape_cfg, jax.random.key(seed)))


def _params(jcfg, seed=0):
    """The JAX package's init as numpy (sorted dict keys, as jax.tree
    orders them: the port's trees built from it share that order), one
    init a layout: the routing and remat fields do not change it."""
    shape_cfg = jm.MoeConfig(**{f: getattr(jcfg, f) for f in (
        "vocab", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff",
        "n_experts", "param_dtype")})
    return jax.tree.map(np.copy, _init(shape_cfg, seed))


def _tp(np_params, grad=False):
    p = tm.params_from_numpy(np_params, device="cpu")
    return jax.tree.map(lambda t: t.requires_grad_(True), p) if grad else p


def _tokens(shape, seed=0, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _jforward(params, tokens, cfg, mesh=None, segment_ids=None):
    return jax.jit(lambda p, t, s: jm.forward(p, t, cfg, mesh, segment_ids=s)
                   )(params, jnp.asarray(tokens), segment_ids)


def _tforward(params, tokens, cfg, mesh=None, segment_ids=None):
    with torch.no_grad():
        logits, aux = tm.forward(
            _tp(params), torch.tensor(tokens), cfg, mesh,
            segment_ids=None if segment_ids is None else torch.tensor(
                np.asarray(segment_ids)))
    return logits.numpy(), float(aux)


def _jgrad(params, tokens, cfg):
    return jax.jit(jax.value_and_grad(
        lambda p: jm.next_token_loss(p, jnp.asarray(tokens), cfg)))(params)


def _tgrad(params, tokens, cfg, mesh=None):
    tp = _tp(params, grad=True)
    loss = tm.next_token_loss(tp, torch.tensor(tokens), cfg, mesh)
    loss.backward()
    return float(loss), jax.tree.map(lambda t: t.grad.numpy(), tp)


def _assert_grads(got, want, rtol=GRAD_RTOL):
    jax.tree.map(lambda a, b: np.testing.assert_array_less(
        _rel(a, b), rtol), got, want)


@contextlib.contextmanager
def _routers():
    """Record every (router input, probabilities, top_e) the port routes."""
    seen = []
    orig = tm._router_topk

    def spy(x, layer, cfg):
        out = orig(x, layer, cfg)
        seen.append((x.detach().numpy().copy(), layer["w_router"].detach()
                     .numpy().copy(), out[0].detach().numpy(),
                     out[2].numpy()))
        return out

    tm._router_topk = spy
    try:
        yield seen
    finally:
        tm._router_topk = orig


def _assert_margins(seen, jcfg):
    """Every recorded routing: the JAX router on the same input picks the
    same experts, and the smallest top-k margin (k-th minus (k+1)-th
    probability) is wider than the largest fp32 difference between the
    two routers' probabilities, by 10x."""
    assert seen
    k = jcfg.topk
    for x, w, probs, top_e in seen:
        jp, _, je = _jrouter(jnp.asarray(x), {"w_router": jnp.asarray(w)}, jcfg)
        np.testing.assert_array_equal(top_e, np.asarray(je))
        srt = -np.sort(-probs, axis=-1)
        margin = (srt[:, k - 1] - srt[:, k]).min()
        diff = np.abs(probs - np.asarray(jp)).max()
        assert margin > 10 * diff, (margin, diff)


# -- routing ---------------------------------------------------------------------


class TestRouting:

    def test_combine_weights_sum_to_one_without_drops(self, rng):
        """With ample capacity every token's gates survive and sum to 1;
        the output equals the JAX package's."""
        jcfg, tcfg = _cfgs(capacity_factor=4.0)
        params = _params(jcfg)
        x = rng.standard_normal((64, 32)).astype(np.float32)
        layer = params["layers"][0]
        want, want_aux = _jmlp(jnp.asarray(x), layer, jcfg)
        with torch.no_grad():
            got, aux = tm.moe_mlp(torch.tensor(x), _tp(layer), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(float(aux), float(want_aux), atol=ATOL)
        _, top_p, _ = tm._router_topk(torch.tensor(x), _tp(layer), tcfg)
        np.testing.assert_allclose(float(top_p.sum()), x.shape[0], rtol=1e-5)

    def test_capacity_drops_overflow_tokens(self, rng):
        """Tiny capacity: dropped tokens add nothing (their rows are 0 in
        both packages, the same rows), outputs finite and equal."""
        jcfg, tcfg = _cfgs(capacity_factor=0.1)
        params = _params(jcfg)
        x = rng.standard_normal((64, 32)).astype(np.float32)
        want, _ = _jmlp(jnp.asarray(x), params["layers"][0], jcfg)
        with torch.no_grad():
            got, _ = tm.moe_mlp(torch.tensor(x), _tp(params["layers"][0]), tcfg)
        got = got.numpy()
        assert np.isfinite(got).all()
        live = np.abs(got).sum(-1) > 0
        np.testing.assert_array_equal(live, np.abs(np.asarray(want)).sum(-1) > 0)
        assert live.sum() <= tcfg.capacity(64) * tcfg.n_experts
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)

    def test_aux_loss_is_one_when_balanced(self):
        """Uniform router → Switch aux == 1 (its minimum), in both."""
        jcfg, tcfg = _cfgs()
        layer = dict(_params(jcfg)["layers"][0])
        layer["w_router"] = np.zeros_like(layer["w_router"])
        x = np.random.default_rng(0).standard_normal((256, 32)).astype(np.float32)
        _, want = _jmlp(jnp.asarray(x), layer, jcfg)
        with torch.no_grad():
            _, aux = tm.moe_mlp(torch.tensor(x), _tp(layer), tcfg)
        np.testing.assert_allclose(float(aux), 1.0, rtol=1e-5)
        np.testing.assert_allclose(float(aux), float(want), rtol=1e-6)

    def test_ties_go_to_the_lower_expert(self):
        """Equal probabilities: the port's top-k picks the lower expert ids
        first, as ``lax.top_k`` does."""
        jcfg, tcfg = _cfgs(topk=2)
        layer = dict(_params(jcfg)["layers"][0])
        layer["w_router"] = np.zeros_like(layer["w_router"])
        x = np.ones((8, 32), np.float32)
        _, _, want = _jrouter(jnp.asarray(x), layer, jcfg)
        _, _, got = tm._router_topk(torch.tensor(x), _tp(layer), tcfg)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy()[0], [0, 1])

    @pytest.mark.parametrize("topk,cf", [(2, BINDING), (1, BINDING), (2, 1.0)])
    def test_routing_decisions_exact(self, rng, topk, cf):
        """Expert picks, slot-major arrival indices and kept picks equal
        the JAX package's exactly (its own formula, ``moe.py:214-219``),
        on inputs whose top-k margin exceeds the routers' fp32
        difference; the outputs then agree at the binding capacity."""
        jcfg, tcfg = _cfgs(topk=topk, capacity_factor=cf)
        params = _params(jcfg)
        layer = params["layers"][0]
        x = rng.standard_normal((96, 32)).astype(np.float32)
        with _routers() as seen, torch.no_grad():
            got, aux = tm.moe_mlp(torch.tensor(x), _tp(layer), tcfg)
        _assert_margins(seen, jcfg)
        _, _, je = _jrouter(jnp.asarray(x), layer, jcfg)
        mask = jax.nn.one_hot(je, jcfg.n_experts, dtype=jnp.float32)
        N, E = x.shape[0], jcfg.n_experts
        mask_f = mask.transpose(1, 0, 2).reshape(topk * N, E)
        pos_f = jnp.cumsum(mask_f, axis=0) - mask_f
        jpos = (pos_f * mask_f).sum(-1).reshape(topk, N).T.astype(jnp.int32)
        C = jcfg.capacity(N)
        tmask = torch.nn.functional.one_hot(torch.tensor(seen[0][3]), E).float()
        tpos = tm._arrival(tmask).long().numpy()
        np.testing.assert_array_equal(tpos, np.asarray(jpos))
        keep = tpos < C
        np.testing.assert_array_equal(keep, np.asarray(jpos < C))
        if cf < 1:
            assert 0 < keep.sum() < keep.size  # the capacity binds
        want, want_aux = _jmlp(jnp.asarray(x), layer, jcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(float(aux), float(want_aux), atol=ATOL)


# -- the ragged impl ---------------------------------------------------------------


class TestRaggedImpl:

    def test_matches_einsum_when_capacity_unbound(self, rng):
        jcfg, tcfg = _cfgs(capacity_factor=8.0, topk=2)
        tcfg_r = dataclasses.replace(tcfg, moe_impl="ragged")
        params = _params(jcfg)
        x = torch.tensor(rng.standard_normal((96, 32)).astype(np.float32))
        layer = _tp(params["layers"][0])
        with torch.no_grad():
            out_e, aux_e = tm.moe_mlp(x, layer, tcfg)
            out_r, aux_r = tm.moe_mlp_ragged(x, layer, tcfg_r)
        np.testing.assert_allclose(out_e.numpy(), out_r.numpy(), atol=1e-5)
        np.testing.assert_allclose(float(aux_e), float(aux_r), rtol=1e-6)
        want, _ = _jmlp_ragged(jnp.asarray(x.numpy()), params["layers"][0],
                                    dataclasses.replace(jcfg, moe_impl="ragged"))
        np.testing.assert_allclose(out_r.numpy(), np.asarray(want), atol=ATOL)

    def test_loss_and_grads_match_einsum(self, rng):
        """Loss and every gradient agree across impls, and the ragged
        impl's agree with the JAX package's."""
        jcfg, tcfg = _cfgs(capacity_factor=8.0, topk=2)
        params = _params(jcfg)
        toks = _tokens((2, 16), 1)
        le, ge = _tgrad(params, toks, tcfg)
        lr, gr = _tgrad(params, toks, dataclasses.replace(tcfg, moe_impl="ragged"))
        np.testing.assert_allclose(le, lr, rtol=1e-6)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=2e-5),
                     ge, gr)
        jl, jg = _jgrad(params, toks, dataclasses.replace(jcfg, moe_impl="ragged"))
        np.testing.assert_allclose(lr, float(jl), rtol=1e-5)
        _assert_grads(gr, jax.tree.map(np.asarray, jg))

    def test_decode_path_uses_ragged(self, rng):
        """Greedy generation through the ragged impl continues as the
        ragged full forward's arg-max (teacher forcing)."""
        jcfg, tcfg = _cfgs(moe_impl="ragged", topk=2, max_seq=32)
        params = _params(jcfg)
        prompt = torch.tensor(_tokens((2, 6), 2))
        out = tm.generate(_tp(params), prompt, tcfg, max_new_tokens=5)
        logits, _ = _tforward(params, out.numpy(), tcfg)
        for t in range(6, 11):
            np.testing.assert_array_equal(logits[:, t - 1].argmax(-1),
                                          out[:, t].numpy())

    def test_rejected_on_ep_mesh(self):
        jcfg, tcfg = _cfgs(moe_impl="ragged")
        with pytest.raises(ValueError, match="ragged.*ep"):
            tm.forward(_tp(_params(jcfg)), torch.zeros(2, 8, dtype=torch.int32),
                       tcfg, mesh=tmesh({"dp": 2, "ep": 4}))

    def test_dp_mesh_trains(self, rng):
        """Per-shard routing over dp trains (the logits are held in
        ``TestRoutingGroups``)."""
        jcfg, tcfg = _cfgs(moe_impl="ragged", topk=2)
        mesh = tmesh({"dp": 8})
        init_fn, step_fn = make_train_step(
            lambda p, b: tm.next_token_loss(p, b[0], tcfg, mesh=mesh),
            adamw(1e-2), mesh=mesh, param_specs=tm.param_specs(tcfg),
            batch_spec=P(("dp",)))
        state = init_fn(_tp(_params(jcfg)))
        toks = torch.tensor(_tokens((8, 16)))
        state, l1 = step_fn(state, (toks,))
        state, l2 = step_fn(state, (toks,))
        assert float(l2) < float(l1)

    @pytest.mark.parametrize("remat", [True, "selective"])
    def test_ragged_composes_with_remat(self, rng, remat):
        jcfg, tcfg = _cfgs(moe_impl="ragged", topk=2)
        params = _params(jcfg)
        toks = _tokens((2, 16), 3)
        lr, gr = _tgrad(params, toks, dataclasses.replace(tcfg, remat=remat))
        ln, gn = _tgrad(params, toks, tcfg)
        np.testing.assert_allclose(lr, ln, rtol=1e-6)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=2e-5),
                     gr, gn)

    def test_ragged_rejects_nondividing_token_axis(self):
        jcfg, tcfg = _cfgs(moe_impl="ragged")
        with pytest.raises(ValueError, match="divide"):
            tm.forward(_tp(_params(jcfg)), torch.zeros(3, 8, dtype=torch.int32),
                       tcfg, mesh=tmesh({"dp": 8}))

    def test_unknown_impl_rejected(self):
        jcfg, tcfg = _cfgs(moe_impl="nope")
        with pytest.raises(ValueError, match="unknown moe_impl"):
            tm.forward(_tp(_params(jcfg)), torch.zeros(2, 8, dtype=torch.int32),
                       tcfg)


# -- routing groups at a binding capacity ------------------------------------------


class TestRoutingGroups:
    """One case per group rule, at ``capacity_factor=0.5``: logits and aux
    against the JAX package on the same mesh shape, and a control (the
    port with the wrong group) that must miss."""

    @pytest.mark.parametrize("impl,axes", [
        ("einsum", None),
        ("einsum", {"dp": 2, "ep": 4}),
        ("ragged", {"dp": 8}),
        ("ragged", {"sp": 8}),
        ("ragged", {"dp": 2, "tp": 4}),
    ])
    def test_forward_groups(self, impl, axes):
        jcfg, tcfg = _cfgs(n_layers=2, capacity_factor=BINDING, moe_impl=impl,
                           topk=2)
        params = _params(jcfg)
        toks = _tokens((8, 16), 4)
        jmsh = jmesh(axes) if axes else None
        want, want_aux = _jforward(params, toks, jcfg, jmsh)
        with _routers() as seen:
            got, aux = _tforward(params, toks, tcfg, tmesh(axes) if axes else None)
        _assert_margins(seen, jcfg)
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(aux, float(want_aux), atol=ATOL)
        # The control: another grouping of the same tokens.
        if impl == "einsum":
            # Per dp shard (half the batch each) instead of the whole batch.
            halves = [_tforward(params, t, tcfg) for t in (toks[:4], toks[4:])]
            wrong = np.concatenate([h[0] for h in halves])
            assert np.abs(wrong - np.asarray(want)).max() > 100 * ATOL
        else:
            # Dropless: the logits agree, the aux is the shards' mean.
            wrong_logits, wrong_aux = _tforward(params, toks, tcfg)
            np.testing.assert_allclose(wrong_logits, got, atol=ATOL)
            assert abs(wrong_aux - float(want_aux)) > 100 * ATOL

    def test_forward_pp_groups(self):
        """pp=4 x dp=2, M=2: each microbatch's 4 rows route as two dp
        groups of 2; the control routes whole microbatches (pp=4 alone)."""
        jcfg, tcfg = _cfgs(n_layers=4, capacity_factor=BINDING,
                           attn_impl="dense")
        params = _params(jcfg)
        toks = _tokens((8, 16), 5)
        want, want_aux = jax.jit(lambda p, t: jm.forward_pp(
            jm.stage_params(p, 4), t, jcfg, jmesh({"pp": 4, "dp": 2}),
            n_microbatches=2))(params, jnp.asarray(toks))
        staged = tm.stage_params(_tp(params), 4)
        with torch.no_grad(), _routers() as seen:
            got, aux = tm.forward_pp(staged, torch.tensor(toks), tcfg,
                                     tmesh({"pp": 4, "dp": 2}), n_microbatches=2)
            wrong, _ = tm.forward_pp(staged, torch.tensor(toks), tcfg,
                                     tmesh({"pp": 4}), n_microbatches=2)
        _assert_margins(seen, jcfg)
        assert all(s[0].shape[0] == 2 * 16 for s in seen[:4 * 2 * 2])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(float(aux), float(want_aux), atol=ATOL)
        assert np.abs(wrong.numpy() - np.asarray(want)).max() > 100 * ATOL


# -- the model -------------------------------------------------------------------


class TestMoeModel:

    def test_forward_finite_and_shapes(self, rng):
        jcfg, tcfg = _cfgs(n_layers=2)
        params = _params(jcfg)
        toks = _tokens((2, 16), 6)
        got, aux = _tforward(params, toks, tcfg)
        assert got.shape == (2, 16, 64) and np.isfinite(got).all() and aux > 0
        want, want_aux = _jforward(params, toks, jcfg)
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(aux, float(want_aux), atol=ATOL)

    def test_loss_and_grads_match_jax(self, rng):
        """The einsum model at a binding capacity: loss and every
        gradient against ``jax.value_and_grad``."""
        jcfg, tcfg = _cfgs(n_layers=2, capacity_factor=BINDING)
        params = _params(jcfg)
        toks = _tokens((2, 16), 7)
        jl, jg = _jgrad(params, toks, jcfg)
        tl, tg = _tgrad(params, toks, tcfg)
        np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
        _assert_grads(tg, jax.tree.map(np.asarray, jg))

    @pytest.mark.parametrize("remat", ["full", "selective", "dots"])
    def test_remat_matches_plain_forward_and_grad(self, rng, remat):
        """Each remat policy (the JAX package tests ``True`` and
        ``"selective"``): loss and grads equal the plain path's."""
        jcfg, tcfg = _cfgs(n_layers=2, attn_impl="dense", capacity_factor=8.0)
        params = _params(jcfg)
        toks = _tokens((2, 16), 0)
        l0, g0 = _tgrad(params, toks, tcfg)
        l1, g1 = _tgrad(params, toks, dataclasses.replace(tcfg, remat=remat))
        np.testing.assert_allclose(l1, l0, rtol=1e-6)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, b, rtol=1e-5, atol=1e-6), g1, g0)

    def test_param_dtype_bf16_storage(self, rng):
        kw = dict(vocab=64, d_model=32, n_layers=1, n_heads=4, n_kv_heads=2,
                  d_ff=64, n_experts=4)
        tcfg = tm.MoeConfig(**kw, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
        params = tm.init_params(tcfg, seed=0, device="cpu")
        assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(params))
        logits, aux = tm.forward(params, torch.tensor(_tokens((1, 8))), tcfg)
        assert logits.dtype == torch.float32
        assert torch.isfinite(logits).all() and torch.isfinite(aux)

    def test_packed_segments_isolation(self, rng):
        """Rewriting document 0 leaves document 1's logits as they were
        (ample capacity: with drops the documents compete for slots), and
        the packed logits equal the JAX package's."""
        jcfg, tcfg = _cfgs(n_layers=2, capacity_factor=8.0)
        params = _params(jcfg)
        t1 = _tokens((1, 16), 8)
        t1[t1 == 0] = 1
        t2 = t1.copy()
        t2[0, :8] = 0
        seg = np.concatenate([np.zeros(8, np.int32), np.ones(8, np.int32)])[None]
        l1, _ = _tforward(params, t1, tcfg, segment_ids=seg)
        l2, _ = _tforward(params, t2, tcfg, segment_ids=seg)
        np.testing.assert_allclose(l1[0, 8:], l2[0, 8:], rtol=1e-5, atol=1e-6)
        want, _ = _jforward(params, t1, jcfg, segment_ids=jnp.asarray(seg))
        np.testing.assert_allclose(l1, np.asarray(want), atol=ATOL)
        loss = tm.next_token_loss(_tp(params), torch.tensor(t1), tcfg,
                                  segment_ids=torch.tensor(seg))
        want_loss = jax.jit(lambda p, t, s: jm.next_token_loss(
            p, t, jcfg, segment_ids=s))(params, jnp.asarray(t1), jnp.asarray(seg))
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)

    def test_cached_prefill_matches_forward(self, rng):
        """Prefill routes the prompt as the training forward does: its
        logits equal the forward's, drops included (binding capacity)."""
        jcfg, tcfg = _cfgs(n_layers=2, capacity_factor=BINDING)
        params = _params(jcfg)
        toks = _tokens((2, 12), 9)
        full, _ = _tforward(params, toks, tcfg)
        cache = tm.init_cache(tcfg, 2, 12, device="cpu")
        with torch.no_grad():
            cached, _ = tm.forward_with_cache(_tp(params), torch.tensor(toks),
                                              tcfg, cache, 0)
        np.testing.assert_allclose(cached.numpy(), full, rtol=2e-5, atol=2e-5)

    def test_stepwise_decode_matches_teacher_forcing(self, rng):
        jcfg, tcfg = _cfgs(n_layers=2, capacity_factor=8.0)
        params = _params(jcfg)
        toks = _tokens((1, 10), 10)
        full, _ = _tforward(params, toks, tcfg)
        cache = tm.init_cache(tcfg, 1, 10, device="cpu")
        tp = _tp(params)
        with torch.no_grad():
            for t in range(10):
                lt, cache = tm.forward_with_cache(
                    tp, torch.tensor(toks[:, t:t + 1]), tcfg, cache, t)
                np.testing.assert_allclose(full[:, t], lt[:, 0].numpy(),
                                           rtol=2e-5, atol=2e-5,
                                           err_msg=f"position {t}")

    def test_greedy_generate(self, rng):
        """Deterministic, prompt-prefixed, and the first emitted token is
        the JAX package's forward's arg-max."""
        jcfg, tcfg = _cfgs(n_layers=2, capacity_factor=8.0)
        params = _params(jcfg)
        prompt = torch.tensor(_tokens((2, 5), 11))
        out = tm.generate(_tp(params), prompt, tcfg, max_new_tokens=4)
        assert tuple(out.shape) == (2, 9)
        assert torch.equal(out[:, :5], prompt)
        assert torch.equal(out, tm.generate(_tp(params), prompt, tcfg,
                                            max_new_tokens=4))
        full, _ = _jforward(params, prompt.numpy(), jcfg)
        np.testing.assert_array_equal(out[:, 5].numpy(),
                                      np.asarray(full[:, -1].argmax(-1)))

    def test_sampled_generate_requires_generator(self, rng):
        jcfg, tcfg = _cfgs()
        prompt = torch.tensor(_tokens((1, 4)))
        with pytest.raises(ValueError, match="explicit generator"):
            tm.generate(_tp(_params(jcfg)), prompt, tcfg, max_new_tokens=2,
                        temperature=0.7)


# -- mesh steps ------------------------------------------------------------------


def _both_steps(jcfg, tcfg, axes, spec, tokens, steps, lr):
    """Losses of ``steps`` AdamW steps, JAX (GSPMD over the virtual
    devices) then the port (positions of the CPU), same weights."""
    jm_ = jmesh(dict(axes))
    jinit, jfn = jstep(lambda p, b: jm.next_token_loss(p, b, jcfg, mesh=jm_),
                       optax.adamw(lr), jm_, jm.param_specs(jcfg),
                       batch_spec=JP(*spec))
    params = _params(jcfg)
    js = jinit(jax.tree.map(jnp.asarray, params))
    tmsh = tmesh(dict(axes))
    tinit, tfn = make_train_step(
        lambda p, b: tm.next_token_loss(p, b[0], tcfg, mesh=tmsh), adamw(lr),
        mesh=tmsh, param_specs=tm.param_specs(tcfg), batch_spec=P(*spec))
    ts = tinit(_tp(params))
    jl, tl = [], []
    for _ in range(steps):
        js, loss = jfn(js, tokens)
        jl.append(float(loss))
        ts, loss = tfn(ts, (torch.tensor(tokens),))
        tl.append(float(loss))
    return jl, tl, js


def test_loss_decreases_on_ep_mesh():
    """dp=2 x ep=4, 15 AdamW steps: the port's losses track the JAX
    package's and halve; the expert specs carry ``ep`` on both."""
    jcfg, tcfg = _cfgs()
    tokens = np.tile(np.arange(16, dtype=np.int32) % 7, (8, 1))
    jl, tl, js = _both_steps(jcfg, tcfg, {"dp": 2, "ep": 4}, (("dp",),),
                             tokens, 15, 1e-2)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0] * 0.5, tl
    assert "ep" in str(js.params["layers"][0]["w_gate"].sharding.spec)
    from ddl_tpu_torch.parallel.mesh import named, prune_indivisible

    spec = tm.param_specs(tcfg)["layers"][0]["w_gate"]
    kept = prune_indivisible(named(tmesh({"dp": 2, "ep": 4}), spec),
                             np.zeros((4, 32, 64)))
    assert tuple(kept.spec)[0] == "ep"


@pytest.mark.parametrize("axes,spec", [
    ({"ep": 8}, (None,)),
    ({"dp": 2, "ep": 2, "tp": 2}, (("dp",),)),
    ({"dp": 2, "sp": 2, "ep": 2}, ("dp", "sp")),
])
def test_step_on_mixed_meshes(axes, spec):
    """Two AdamW steps over each mesh: the einsum impl routes the whole
    batch on any one-process mesh, so the losses equal the ``mesh=None``
    steps' (rtol 1e-5; only the attention's split differs), and fall.
    (The JAX package's mesh step is held on dp x ep above.)"""
    jcfg, tcfg = _cfgs(n_experts=2)
    params = _params(jcfg)
    tokens = torch.tensor(_tokens((8, 16)))
    losses = {}
    for name, mesh in (("mesh", tmesh(axes)), ("none", None)):
        init_fn, step_fn = make_train_step(
            lambda p, b, mesh=mesh: tm.next_token_loss(p, b[0], tcfg, mesh=mesh),
            adamw(1e-3), mesh=mesh, device=None if mesh else "cpu",
            param_specs=tm.param_specs(tcfg) if mesh else None,
            batch_spec=P(*spec))
        state = init_fn(_tp(params))
        losses[name] = []
        for _ in range(2):
            state, loss = step_fn(state, (tokens,))
            losses[name].append(float(loss))
    np.testing.assert_allclose(losses["mesh"], losses["none"], rtol=1e-5)
    assert np.isfinite(losses["mesh"]).all()
    assert losses["mesh"][1] < losses["mesh"][0]


def test_param_specs_and_stage_layout_mirror_jax():
    jcfg, tcfg = _cfgs(n_layers=4)
    spec_t = jax.tree.map(tuple, tm.param_specs(tcfg),
                          is_leaf=lambda x: isinstance(x, P))
    spec_j = jax.tree.map(tuple, jm.param_specs(jcfg),
                          is_leaf=lambda x: isinstance(x, JP))
    assert spec_t == spec_j
    pp_t = tm.pp_param_specs(tcfg, n_chunks=2)["stages"]
    pp_j = jm.pp_param_specs(jcfg, n_chunks=2)["stages"]
    assert {k: tuple(v) for k, v in pp_t.items()} == {
        k: tuple(v) for k, v in pp_j.items()}
    params = _params(jcfg)
    staged = tm.stage_params(_tp(params), 2)
    want = jm.stage_params(jax.tree.map(jnp.asarray, params), 2)
    for k, v in staged["stages"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want["stages"][k]))


def test_mixtral_param_shapes_on_meta():
    """Mixtral-8x7B's layout on the ``meta`` device (nothing allocated):
    every leaf's shape equals ``jax.eval_shape`` of the JAX package's
    init, and the count is the published 46.7 B."""
    tcfg = tm.MoeConfig.mixtral_8x7b()
    got = tm.param_shapes(tcfg)
    want = jm.param_shapes(jm.MoeConfig.mixtral_8x7b())
    leaves, shapes = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(leaves) == len(shapes)
    assert all(t.device.type == "meta" for t in leaves)
    assert [tuple(t.shape) for t in leaves] == [tuple(s.shape) for s in shapes]
    total = sum(t.numel() for t in leaves)
    assert round(total / 1e9, 1) == 46.7


# -- the pipeline ----------------------------------------------------------------


class TestMoePipeline:
    """Twins of ``tests/test_pipeline.py``'s MoE class: the activation
    tree carries the aux accumulator beside the residual stream."""

    def test_forward_pp_matches_forward(self):
        """Unbound capacity: the pipelined logits equal the plain
        forward's; the aux is the JAX package's forward_pp's (the mean of
        the per-group aux) and of the plain aux's order."""
        jcfg, tcfg = _cfgs(n_layers=4, attn_impl="dense", capacity_factor=8.0)
        params = _params(jcfg)
        toks = _tokens((8, 16), 12)
        ref, ref_aux = _tforward(params, toks, tcfg)
        want, want_aux = jax.jit(lambda p, t: jm.forward_pp(
            jm.stage_params(p, 4), t, jcfg, jmesh({"pp": 4, "dp": 2}),
            n_microbatches=4))(params, jnp.asarray(toks))
        with torch.no_grad():
            got, aux = tm.forward_pp(tm.stage_params(_tp(params), 4),
                                     torch.tensor(toks), tcfg,
                                     tmesh({"pp": 4, "dp": 2}), n_microbatches=4)
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=ATOL)
        np.testing.assert_allclose(float(aux), float(want_aux), atol=ATOL)
        assert abs(float(aux) - ref_aux) < 0.5 * ref_aux

    def test_train_step_pp_moe(self):
        """pp=4 x dp=2, 8 AdamW steps at capacity_factor 2 through the
        routed experts, the aux accumulator and the schedule: the first
        loss is the unpipelined loss of the same weights (grouped as the
        pipe groups them) near log(vocab), and the losses fall."""
        jcfg, tcfg = _cfgs(n_layers=4, attn_impl="dense", capacity_factor=2.0)
        tmsh = tmesh({"pp": 4, "dp": 2})
        params = _params(jcfg)
        tinit, tfn = make_train_step(
            lambda p, b: tm.next_token_loss_pp(p, b[0], tcfg, tmsh,
                                               n_microbatches=4),
            adamw(1e-2), mesh=tmsh, param_specs=tm.pp_param_specs(tcfg),
            batch_spec=P(("dp",)))
        ts = tinit(tm.stage_params(_tp(params), 4))
        toks = _tokens((8, 16))
        want = jax.jit(lambda p, t: jm.next_token_loss_pp(
            jm.stage_params(p, 4), t, jcfg, jmesh({"pp": 4, "dp": 2}),
            n_microbatches=4))(params, jnp.asarray(toks))
        tl = []
        for _ in range(8):
            ts, loss = tfn(ts, (torch.tensor(toks),))
            tl.append(float(loss))
        np.testing.assert_allclose(tl[0], float(want), rtol=1e-5)
        assert abs(tl[0] - np.log(64)) < 1.0, tl[0]
        assert tl[-1] < tl[0] - 0.3, tl

    def test_ragged_without_pp_axis_rejects_token_shards(self):
        jcfg, tcfg = _cfgs(n_layers=4, moe_impl="ragged")
        with pytest.raises(ValueError, match="real pp>1"):
            tm.forward_pp(tm.stage_params(_tp(_params(jcfg)), 1),
                          torch.tensor(_tokens((8, 16))), tcfg,
                          tmesh({"dp": 8}), n_microbatches=2)
