"""The port's ring attention and sharded local attention against the JAX
package's, on the same numpy-seeded inputs.

The JAX side runs on the 8-device CPU mesh ``tests/conftest.py`` sets
up (its flash route through the Pallas kernels in interpret mode); the
port's on positions of ``"cpu"`` (its flash route through
``attention_plain``, the kernels' plain version).  Outputs and the
gradients of ``sum(out ** 2)`` agree within ``rtol = atol = 2e-5`` (the
reference's ring tolerance): sp in {2, 4, 8}, causal and not, both
routes, compact GQA, packed documents that straddle the shard cuts, a
dp x sp mesh, masked rows with strongly negative scores, and the
sharded local attention over dp/tp geometries (axes that do not divide
left unsharded, one warning per geometry).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.parallel import ring_attention as jra
from ddl_tpu.parallel.mesh import make_mesh as jax_mesh
from ddl_tpu_torch.parallel import ring_attention as tra
from ddl_tpu_torch.parallel.mesh import make_mesh

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, B=2, T=32, H=4, Hkv=None, D=16, scale=1.0):
    rng = np.random.default_rng(seed)
    Hkv = Hkv or H
    q = (scale * rng.standard_normal((B, T, H, D))).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    return q, k, v


def _doc_ids(seed, B, T, n_cuts=3):
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, T), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(1, T), n_cuts, replace=False))
        ids[b] = np.searchsorted(cuts, np.arange(T), side="right")
    return ids


def _jax(fn, q, k, v, **kw):
    """Output and grads of sum(out ** 2) through the JAX package (one
    jitted program)."""
    def loss(q, k, v):
        out = fn(q, k, v, **kw)
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch(fn, q, k, v, **kw):
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fn(*ts, **kw)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sp", [2, 4, 8])
def test_ring_matches_jax(sp, causal, use_flash):
    q, k, v = _qkv(sp)
    want = _jax(jra.ring_attention, q, k, v,
                mesh=jax_mesh({"sp": sp}, jax.devices()[:sp]), causal=causal,
                dp_axis=None, use_flash=use_flash)
    got = _torch(tra.ring_attention, q, k, v,
                 mesh=make_mesh({"sp": sp}, ["cpu"] * sp), causal=causal,
                 dp_axis=None, use_flash=use_flash)
    _close(got, want)


@pytest.mark.parametrize("use_flash", [False, True])
def test_compact_gqa_ring_matches_jax(use_flash):
    q, k, v = _qkv(5, H=8, Hkv=2)
    want = _jax(jra.ring_attention, q, k, v,
                mesh=jax_mesh({"sp": 4}, jax.devices()[:4]), dp_axis=None,
                kv_repeat=4, use_flash=use_flash)
    got = _torch(tra.ring_attention, q, k, v,
                 mesh=make_mesh({"sp": 4}, ["cpu"] * 4), dp_axis=None,
                 kv_repeat=4, use_flash=use_flash)
    _close(got, want)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("sp", [2, 4, 8])
def test_packed_documents_across_cuts_match_jax(sp, use_flash):
    """Key-side ids ride the ring with their K/V blocks; documents
    straddle the shard cuts."""
    q, k, v = _qkv(10 + sp, T=32)
    ids = _doc_ids(sp, 2, 32)
    want = _jax(jra.ring_attention, q, k, v,
                mesh=jax_mesh({"sp": sp}, jax.devices()[:sp]), dp_axis=None,
                use_flash=use_flash, segment_ids=jnp.asarray(ids))
    got = _torch(tra.ring_attention, q, k, v,
                 mesh=make_mesh({"sp": sp}, ["cpu"] * sp), dp_axis=None,
                 use_flash=use_flash, segment_ids=torch.from_numpy(ids))
    _close(got, want)
    # The documents do straddle a cut.
    blk = 32 // sp
    assert any(ids[b, c * blk - 1] == ids[b, c * blk]
               for b in range(2) for c in range(1, sp))


def test_dp_and_sp_mesh_matches_jax():
    q, k, v = _qkv(1, B=4, T=64)
    want = _jax(jra.ring_attention, q, k, v,
                mesh=jax_mesh({"dp": 2, "sp": 4}), causal=True)
    got = _torch(tra.ring_attention, q, k, v,
                 mesh=make_mesh({"dp": 2, "sp": 4}, ["cpu"] * 8), causal=True)
    _close(got, want)


def test_sp_absent_falls_back_dense():
    q, k, v = _qkv(2)
    out = tra.ring_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             make_mesh({"dp": 8}, ["cpu"] * 8))
    ref = tra.attention_reference(*(torch.from_numpy(x) for x in (q, k, v)))
    assert torch.equal(out, ref)


@pytest.mark.parametrize("use_flash", [False, True])
def test_masked_rows_with_strongly_negative_scores(use_flash):
    """Fully masked ring blocks must not clamp the running max to 0 (nor
    put weight on the -1e30 sentinel): true scores ~ -1000 survive, with
    finite gradients.  The output is held to the JAX package's ring on
    the same route and every result to its dense oracle
    (``attention_reference``) at 1e-4 — the oracle, not its flash ring,
    for the gradients: the Pallas kernels in interpret mode land 6.5e-3
    from the oracle's dq at these scores, the port's plain version 5e-5."""
    rng = np.random.default_rng(6)
    q = (-20.0 * np.abs(rng.standard_normal((1, 32, 2, 16)))).astype(np.float32)
    k = (20.0 * np.abs(rng.standard_normal((1, 32, 2, 16)))).astype(np.float32)
    v = rng.standard_normal((1, 32, 2, 16)).astype(np.float32)
    ring = _jax(jra.ring_attention, q, k, v,
                mesh=jax_mesh({"sp": 4}, jax.devices()[:4]), dp_axis=None,
                use_flash=use_flash)
    oracle = _jax(jra.attention_reference, q, k, v)
    got = _torch(tra.ring_attention, q, k, v,
                 mesh=make_mesh({"sp": 4}, ["cpu"] * 4), dp_axis=None,
                 use_flash=use_flash)
    assert np.isfinite(got[0]).all() and all(np.isfinite(g).all() for g in got[1])
    np.testing.assert_allclose(got[0], ring[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[0], oracle[0], rtol=1e-4, atol=1e-4)
    for g, w in zip(got[1], oracle[1]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def test_merge_of_empty_rows_gives_zero_weight_and_no_nan():
    """The flash route's merge at the -1e30 sentinel: a row empty in both
    partials stays zero with lse -1e30 and gets zero gradient (weights
    zeroed explicitly, not exp of sentinel differences); a row empty in
    the new block keeps its accumulator exactly and passes no gradient
    into the block's lse."""
    neg = tra._NEG_INF
    o_acc = torch.randn(1, 3, 1, 4)
    o_blk = torch.randn(1, 3, 1, 4)
    lse_acc = torch.tensor([[[neg, 0.5, neg]]])
    lse_blk = torch.tensor([[[neg, neg, 1.0]]], requires_grad=True)
    o, lse = tra._flash_merge(o_acc, lse_acc, o_blk, lse_blk)
    assert torch.equal(o[0, 0], torch.zeros(1, 4))
    assert float(lse[0, 0, 0]) <= neg / 2
    assert torch.equal(o[0, 1], o_acc[0, 1])
    torch.testing.assert_close(o[0, 2], o_blk[0, 2])
    (o.sum() + lse[lse > neg / 2].sum()).backward()
    g = lse_blk.grad[0, 0]
    assert torch.isfinite(lse_blk.grad).all()
    assert float(g[0]) == 0.0 and float(g[1]) == 0.0


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("axes,B,H,Hkv", [
    ({"dp": 8}, 8, 4, 2),                 # batch over dp
    ({"dp": 2, "fsdp": 2, "tp": 2}, 4, 4, 2),  # batch over dp, heads over tp
    ({"tp": 4}, 2, 8, 4),                 # heads over tp
    ({"dp": 4, "tp": 2}, 6, 4, 2),        # dp does not divide 6: heads only
    ({"dp": 2, "tp": 4}, 2, 4, 2),        # tp does not divide 2 kv heads
])
def test_sharded_local_attention_matches_jax(axes, B, H, Hkv, use_flash):
    q, k, v = _qkv(7, B=B, T=16, H=H, Hkv=Hkv)
    rep = H // Hkv
    n = int(np.prod(list(axes.values())))
    want = _jax(jra.sharded_local_attention, q, k, v,
                mesh=jax_mesh(axes, jax.devices()[:n]), kv_repeat=rep,
                use_flash=use_flash)
    got = _torch(tra.sharded_local_attention, q, k, v,
                 mesh=make_mesh(axes, ["cpu"] * n), kv_repeat=rep,
                 use_flash=use_flash)
    _close(got, want)


def test_sharded_local_packed_matches_jax():
    q, k, v = _qkv(8, B=4, T=32)
    ids = _doc_ids(4, 4, 32)
    want = _jax(jra.sharded_local_attention, q, k, v,
                mesh=jax_mesh({"dp": 4}, jax.devices()[:4]),
                segment_ids=jnp.asarray(ids))
    got = _torch(tra.sharded_local_attention, q, k, v,
                 mesh=make_mesh({"dp": 4}, ["cpu"] * 4),
                 segment_ids=torch.from_numpy(ids))
    _close(got, want)


def test_replicated_geometry_warns_once(caplog):
    q, k, v = (torch.from_numpy(x) for x in _qkv(9, B=3, T=8, H=3))
    mesh = make_mesh({"dp": 2, "tp": 2}, ["cpu"] * 4)
    tra._warned_replicated.clear()
    with caplog.at_level(logging.WARNING, logger=tra.logger.name):
        for _ in range(3):
            out = tra.sharded_local_attention(q, k, v, mesh)
    assert sum("fully replicated" in r.message for r in caplog.records) == 1
    assert torch.equal(out, tra.attention_reference(q, k, v))


@pytest.mark.parametrize("axes,expect", [
    ({"sp": 4}, "ring"), ({"dp": 2, "sp": 2}, "ring"), ({"dp": 4}, "local"),
    ({"sp": 1, "dp": 4}, "local"), (None, "plain"),
])
def test_dispatcher_routes_as_the_reference(axes, expect, monkeypatch):
    """``attention(..., mesh=)``: sp > 1 → ring, another mesh → sharded
    local, none → plain; the output equals the JAX dispatcher's."""
    q, k, v = _qkv(11, B=4, T=16)
    n = int(np.prod(list(axes.values()))) if axes else 0
    seen = []
    for name in ("ring_attention", "sharded_local_attention"):
        orig = getattr(tra, name)
        monkeypatch.setattr(tra, name, lambda *a, _o=orig, _n=name, **kw: (
            seen.append(_n), _o(*a, **kw))[1])
    mesh = make_mesh(axes, ["cpu"] * n) if axes else None
    got = tra.attention(*(torch.from_numpy(x) for x in (q, k, v)), mesh=mesh)
    jmesh = jax_mesh(axes, jax.devices()[:n]) if axes else None
    want = jra.attention(*(jnp.asarray(x) for x in (q, k, v)), mesh=jmesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert seen == {"ring": ["ring_attention"],
                    "local": ["sharded_local_attention"], "plain": []}[expect]
