"""The port's Llama against the JAX package's, from the same weights.

A 2-layer, d_model 64 model in fp32: the JAX ``init_params`` tree crosses
as numpy arrays through ``params_from_numpy``; logits, loss and every
parameter gradient must agree (``atol = rtol = 2e-5`` on logits and
loss, relative Frobenius error <= 1e-4 per gradient — same math, the
summation order of the matmuls differs).  One AdamW step of
``parallel.train.adamw`` is held against ``optax.adamw`` at ``rtol 1e-6``.
Packed-document batches (``segment_ids``) are held to the JAX package at
the same tolerances, and each remat policy to the port's "none" (loss and
gradients at ``rtol 1e-6``: the recompute repeats the same float ops) and
to the JAX package under the same policy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddl_tpu.models import llama as jllama
from ddl_tpu_torch.models import llama as tllama
from ddl_tpu_torch.models.losses import cross_entropy
from ddl_tpu_torch.parallel.train import adamw, tree_leaves, tree_map

JCFG = jllama.LlamaConfig(vocab=128, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq=64,
                          dtype=jnp.float32, attn_impl="dense")


def _tcfg(attn_impl="auto", remat=False):
    return tllama.LlamaConfig(vocab=128, d_model=64, n_layers=2, n_heads=4,
                              n_kv_heads=2, d_ff=128, max_seq=64,
                              dtype=torch.float32, attn_impl=attn_impl,
                              remat=remat)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(JCFG, jax.random.key(0))
    tokens = np.random.default_rng(7).integers(0, JCFG.vocab, (2, 48),
                                               dtype=np.int32)
    return _np_tree(params), tokens


def _torch_params(np_params):
    return tree_map(lambda t: t.requires_grad_(True),
                    tllama.params_from_numpy(np_params, device="cpu"))


def test_params_from_numpy_is_a_copy_of_the_layout(weights):
    np_params, _ = weights
    tp = tllama.params_from_numpy(np_params, device="cpu")
    assert len(tp["layers"]) == JCFG.n_layers
    assert tp["layers"][0]["wq"].shape == (64, 64)  # (in, out), no transpose
    assert tp["lm_head"].dtype == torch.float32
    np.testing.assert_array_equal(tp["embed"].numpy(), np_params["embed"])
    tp["embed"][0, 0] += 1.0  # a copy, not a view of the numpy tree
    assert tp["embed"][0, 0] != np_params["embed"][0, 0]


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_logits_loss_and_grads_match(weights, impl):
    np_params, tokens = weights
    jcfg = dataclasses.replace(JCFG, attn_impl="dense" if impl == "auto" else "flash")
    jlogits = np.asarray(jllama.forward(np_params, jnp.asarray(tokens), jcfg))
    jloss, jgrads = jax.value_and_grad(jllama.next_token_loss)(
        np_params, jnp.asarray(tokens), jcfg)

    cfg = _tcfg(impl)
    tp = _torch_params(np_params)
    logits = tllama.forward(tp, torch.tensor(tokens), cfg)
    np.testing.assert_allclose(logits.detach().numpy(), jlogits,
                               atol=2e-5, rtol=2e-5)
    loss = tllama.next_token_loss(tp, torch.tensor(tokens), cfg)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=2e-5, rtol=2e-5)
    loss.backward()
    got = [t.grad.numpy() for t in tree_leaves(tp)]
    # jax.tree.leaves sorts dict keys; tree_leaves keeps insertion order.
    want = tree_leaves(_np_tree(jgrads))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w) + 1e-12


def test_cross_entropy_mask_matches_jax():
    from ddl_tpu.models.losses import cross_entropy as jce

    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (3, 5))
    mask = rng.random((3, 5)) < 0.6
    want = jce(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask))
    got = cross_entropy(torch.tensor(logits), torch.tensor(targets),
                        torch.tensor(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_init_params_layout_and_scale():
    """The port's own init: the JAX layout, unit norms, 1/sqrt(fan_in)
    scaled normals, reproducible from the seed."""
    cfg = _tcfg()
    a = tllama.init_params(cfg, seed=3, device="cpu")
    b = tllama.init_params(cfg, seed=3, device="cpu")
    jparams = _np_tree(jllama.init_params(JCFG, jax.random.key(0)))

    def shapes(tree):  # nested shapes; dict equality ignores key order
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(a) == shapes(jparams)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert torch.all(a["layers"][0]["attn_norm"] == 1)
    w = a["layers"][0]["w_down"]
    assert abs(float(w.std()) * np.sqrt(cfg.d_ff) - 1.0) < 0.05
    assert sum(t.numel() for t in tree_leaves(a)) == tllama.param_count(cfg)


def test_adamw_step_matches_optax(weights):
    """Two AdamW steps on the same params and gradients: torch.optim.AdamW
    with optax.adamw's hyper-parameters lands on the same params."""
    np_params, _ = weights
    leaves = tree_leaves(np_params)
    rng = np.random.default_rng(11)
    grads = [[rng.standard_normal(x.shape).astype(np.float32) for x in leaves]
             for _ in range(2)]

    opt = optax.adamw(3e-3)
    jp = [jnp.asarray(x) for x in leaves]
    state = opt.init(jp)
    for g in grads:
        upd, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = [torch.tensor(x).requires_grad_(True) for x in leaves]
    topt = adamw(3e-3)(tp)
    for g in grads:
        for t, x in zip(tp, g):
            t.grad = torch.tensor(x)
        topt.step()
    for t, j in zip(tp, jp):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=1e-6, atol=1e-7)


def _doc_ids(seed, B, T, mean_len=10):
    """Row-local ids of packed documents with random lengths."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, T), np.int32)
    ids[:, 1:] = np.cumsum(rng.random((B, T - 1)) < 1.0 / mean_len, axis=1)
    return ids


def _jax_grads(np_params, tokens, jcfg, seg):
    kw = {} if seg is None else {"segment_ids": jnp.asarray(seg)}
    loss, grads = jax.value_and_grad(jllama.next_token_loss)(
        np_params, jnp.asarray(tokens), jcfg, **kw)
    return float(loss), tree_leaves(_np_tree(grads))


def _torch_grads(np_params, tokens, cfg, seg):
    tp = _torch_params(np_params)
    kw = {} if seg is None else {"segment_ids": torch.tensor(seg)}
    loss = tllama.next_token_loss(tp, torch.tensor(tokens), cfg, **kw)
    loss.backward()
    return float(loss.detach()), [t.grad.numpy() for t in tree_leaves(tp)]


def _assert_grads_close(got, want, rel):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.linalg.norm(g - w) <= rel * np.linalg.norm(w) + 1e-12


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_packed_logits_loss_and_grads_match(weights, impl):
    """forward and next_token_loss with segment_ids, dense ("auto" on the
    CPU) and flash, against the JAX package."""
    np_params, tokens = weights
    seg = _doc_ids(1, *tokens.shape)
    jcfg = dataclasses.replace(JCFG, attn_impl="dense" if impl == "auto" else "flash")
    jlogits = np.asarray(jllama.forward(np_params, jnp.asarray(tokens), jcfg,
                                        segment_ids=jnp.asarray(seg)))
    logits = tllama.forward(_torch_params(np_params), torch.tensor(tokens),
                            _tcfg(impl), segment_ids=torch.tensor(seg))
    np.testing.assert_allclose(logits.detach().numpy(), jlogits,
                               atol=2e-5, rtol=2e-5)
    jloss, jgrads = _jax_grads(np_params, tokens, jcfg, seg)
    loss, grads = _torch_grads(np_params, tokens, _tcfg(impl), seg)
    np.testing.assert_allclose(loss, jloss, atol=2e-5, rtol=2e-5)
    _assert_grads_close(grads, jgrads, 1e-4)


def test_packed_ids_may_be_a_strided_int_view(weights):
    """The trainer hands the ids as a strided view of the window (and the
    reader's dtype may be any int): the loss is that of contiguous int32
    ids."""
    np_params, tokens = weights
    seg = _doc_ids(2, *tokens.shape)
    window = np.concatenate([tokens, seg], axis=1).astype(np.int64)
    view = torch.tensor(window)[:, tokens.shape[1]:]
    assert not view.is_contiguous()
    cfg = _tcfg("flash")
    tp = tllama.params_from_numpy(np_params, device="cpu")
    got = tllama.next_token_loss(tp, torch.tensor(tokens), cfg, segment_ids=view)
    want = tllama.next_token_loss(tp, torch.tensor(tokens), cfg,
                                  segment_ids=torch.tensor(seg))
    assert float(got) == float(want)


def test_next_token_cross_entropy_segments_match_jax():
    from ddl_tpu.models.losses import next_token_cross_entropy as jnce
    from ddl_tpu_torch.models.losses import next_token_cross_entropy

    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 12, 17)).astype(np.float32)
    tokens = rng.integers(0, 17, (3, 12))
    seg = _doc_ids(5, 3, 12, mean_len=4)
    extra = rng.random((3, 12)) < 0.2
    want = jnce(jnp.asarray(logits), jnp.asarray(tokens),
                extra_mask=jnp.asarray(extra), segment_ids=jnp.asarray(seg))
    got = next_token_cross_entropy(torch.tensor(logits), torch.tensor(tokens),
                                   extra_mask=torch.tensor(extra),
                                   segment_ids=torch.tensor(seg))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("policy", ["full", "selective", "dots"])
def test_remat_policy_matches_none_and_jax(weights, policy):
    """Each policy gives the loss and gradients of "none" (packed batch,
    flash path), and of the JAX package under the same policy."""
    np_params, tokens = weights
    seg = _doc_ids(3, *tokens.shape)
    base_loss, base = _torch_grads(np_params, tokens, _tcfg("flash"), seg)
    loss, grads = _torch_grads(np_params, tokens, _tcfg("flash", policy), seg)
    np.testing.assert_allclose(loss, base_loss, rtol=1e-6)
    _assert_grads_close(grads, base, 1e-6)
    jcfg = dataclasses.replace(JCFG, attn_impl="flash", remat=policy)
    jloss, jgrads = _jax_grads(np_params, tokens, jcfg, seg)
    np.testing.assert_allclose(loss, jloss, atol=2e-5, rtol=2e-5)
    _assert_grads_close(grads, jgrads, 1e-4)


def test_remat_resolve_matches_jax():
    from ddl_tpu.models import remat as jremat
    from ddl_tpu_torch.models import remat as tremat

    assert tremat.POLICIES == jremat.POLICIES
    for value in (True, False, None, *tremat.POLICIES):
        assert tremat.resolve(value) == jremat.resolve(value)
    for junk in ("some", 1, "Full"):
        with pytest.raises(ValueError):
            tremat.resolve(junk)
        with pytest.raises(ValueError):
            tllama.LlamaConfig(remat=junk)
