"""The port's flash attention against the JAX package's.

The JAX side runs the Pallas kernels in interpret mode (as
tests/test_ops.py does on the CPU) and its dense ``attention_reference``;
the port side runs its plain PyTorch version, which is what a CPU tensor
reaches.  Inputs come from one numpy seed and cross as numpy arrays.
Tolerances: fp32 ``atol = rtol = 2e-5`` (same algorithm, summation order
differs); bf16 — the JAX kernel rounds ``p`` and ``ds`` to bf16 before its
products and its outputs to bf16, while the plain version keeps fp32 —
``out`` atol 2e-2 (bf16 spacing at |out| <= 2 is 1.6e-2), ``lse`` atol 1e-3,
gradients relative Frobenius error <= 2e-2.  The CUDA kernels themselves
run only on a card: tests/test_torch_cuda.py holds them against this plain
version there (and states where the kernels round differently from the
JAX package: K3's GQA group sum), and chip_smoke.py at the main path's
shapes.  The packed-segment cases (K4-K6's function) use the same
tolerances, with ids of random documents.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
    flash_attention_with_lse as jax_flash_lse,
)
from ddl_tpu.parallel.ring_attention import attention_reference as jax_dense
from ddl_tpu_torch.ops import flash_attention as tfa
from ddl_tpu_torch.parallel.ring_attention import attention, attention_reference

F32_TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, B, Tq, Tk, H, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, Hkv, D)).astype(np.float32)
    g_out = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    g_lse = rng.standard_normal((B, H, Tq)).astype(np.float32)
    return q, k, v, g_out, g_lse


def _jax_run(q, k, v, g_out, g_lse, q_off, k_off, causal, rep, dtype,
             seg=None):
    """JAX flash (interpret) out/lse and the grads of a loss weighing
    both outputs (a nonzero lse cotangent on live rows).  ``seg``: the
    (query, key) segment ids as numpy arrays."""
    ids = {} if seg is None else dict(
        segment_ids=jnp.asarray(seg[0]), kv_segment_ids=jnp.asarray(seg[1]))

    def loss(q, k, v):
        out, lse = jax_flash_lse(q, k, v, q_off, k_off, causal=causal,
                                 kv_repeat=rep, block_q=32, block_k=32, **ids)
        live = lse > -1e29
        return (out.astype(jnp.float32) * g_out).sum() + jnp.where(
            live, lse * g_lse, 0.0).sum(), (out, lse)

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    (_, (out, lse)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(*args)
    return [np.asarray(jnp.asarray(x, jnp.float32)) for x in (out, lse, *grads)]


def _torch_run(q, k, v, g_out, g_lse, q_off, k_off, causal, rep, dtype,
               seg=None):
    ts = [torch.tensor(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    ids = {} if seg is None else dict(
        segment_ids=torch.tensor(seg[0]), kv_segment_ids=torch.tensor(seg[1]))
    out, lse = tfa.flash_attention_with_lse(*ts, q_off, k_off, causal, rep,
                                            **ids)
    live = lse > -1e29
    loss = (out.float() * torch.tensor(g_out)).sum() + torch.where(
        live, lse * torch.tensor(g_lse), torch.zeros_like(lse)).sum()
    loss.backward()
    return [t.detach().float().numpy() for t in (out, lse, *(x.grad for x in ts))]


CASES = {
    # name: (B, Tq, Tk, H, Hkv, D, q_off, k_off, causal)
    "causal": (2, 64, 64, 4, 4, 32, 0, 0, True),
    "noncausal": (2, 64, 64, 4, 4, 32, 0, 0, False),
    "gqa2": (1, 64, 64, 4, 2, 32, 0, 0, True),
    "ragged": (1, 50, 50, 4, 2, 16, 0, 0, True),
    "empty_rows": (1, 64, 64, 2, 1, 16, 0, 24, True),
    "shifted": (1, 48, 64, 2, 2, 16, 40, 8, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fp32_matches_jax_flash(name):
    B, Tq, Tk, H, Hkv, D, q_off, k_off, causal = CASES[name]
    data = _inputs(1, B, Tq, Tk, H, Hkv, D)
    args = (q_off, k_off, causal, H // Hkv)
    want = _jax_run(*data, *args, jnp.float32)
    got = _torch_run(*data, *args, torch.float32)
    for label, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=label, **F32_TOL)
    if q_off < k_off and causal:
        n_empty = k_off - q_off
        assert (got[1][..., :n_empty] == -1e30).all()
        assert not got[0][:, :n_empty].any() and not got[2][:, :n_empty].any()


@pytest.mark.parametrize("name", ["causal", "gqa2", "empty_rows"])
def test_bf16_matches_jax_flash(name):
    B, Tq, Tk, H, Hkv, D, q_off, k_off, causal = CASES[name]
    data = _inputs(2, B, Tq, Tk, H, Hkv, D)
    args = (q_off, k_off, causal, H // Hkv)
    want = _jax_run(*data, *args, jnp.bfloat16)
    got = _torch_run(*data, *args, torch.bfloat16)
    np.testing.assert_allclose(got[0], want[0], atol=2e-2, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-3, rtol=0)
    for g, w in zip(got[2:], want[2:]):
        assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rep", [1, 2])
def test_flash_and_dense_match_jax_dense(causal, rep):
    """flash_attention (no lse) and the dense oracle against JAX's
    ``attention_reference``, fp32."""
    q, k, v, _, _ = _inputs(3, 2, 40, 40, 4, 4 // rep, 32)
    want = np.asarray(jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, kv_repeat=rep))
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    flash = tfa.flash_attention(tq, tk, tv, causal=causal, kv_repeat=rep)
    dense = attention_reference(tq, tk, tv, causal=causal, kv_repeat=rep)
    np.testing.assert_allclose(flash.numpy(), want, **F32_TOL)
    np.testing.assert_allclose(dense.numpy(), want, **F32_TOL)
    # The JAX flash kernel without lse, for the same inputs.
    jf = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, kv_repeat=rep, block_q=32,
                              block_k=32))
    np.testing.assert_allclose(flash.numpy(), jf, **F32_TOL)


def test_auto_dispatch_on_cpu_is_dense():
    """impl="auto" on CPU tensors takes the dense reference (the JAX
    package's "auto" off the TPU); "flash" takes the plain flash version;
    neither touches a kernel."""
    q, k, v, _, _ = _inputs(4, 1, 16, 16, 2, 1, 16)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    before = [fn.launches for fn in tfa.KERNELS]
    auto = attention(tq, tk, tv, impl="auto", kv_repeat=2)
    flash = attention(tq, tk, tv, impl="flash", kv_repeat=2)
    np.testing.assert_allclose(auto.numpy(), flash.numpy(), **F32_TOL)
    assert [fn.launches for fn in tfa.KERNELS] == before
    with pytest.raises(ValueError):
        attention(tq, tk, tv, impl="bogus")


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches on CUDA tensors or raises: it never falls
    back to the plain version."""
    q = torch.zeros(1, 8, 2, 64)
    k = torch.zeros(1, 8, 1, 64)
    rows = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dq(q, k, k, q, rows, rows, rows)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dq(q.bfloat16(), k.bfloat16(), k.bfloat16(),
                         q.bfloat16(), rows, rows, rows,
                         visited=torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dkv(q, k, k, q, rows, rows, rows)


def test_reset_launch_counts_zeroes_both_counters():
    """Every kernel wrapper, K1-K6, counts its launches and those its bf16
    wgmma kernel served; ``reset_launch_counts`` zeroes both."""
    assert len(tfa.KERNELS) == 6
    saved = [(fn.launches, fn.sm90_launches) for fn in tfa.KERNELS]
    try:
        for fn in tfa.KERNELS:
            fn.launches, fn.sm90_launches = 5, 3
        tfa.reset_launch_counts()
        assert [(fn.launches, fn.sm90_launches) for fn in tfa.KERNELS] == [
            (0, 0)] * 6
    finally:
        for fn, (n, m) in zip(tfa.KERNELS, saved):
            fn.launches, fn.sm90_launches = n, m


def _doc_ids(rng, B, T, mean_len):
    """Row-local segment ids of packed documents with random lengths
    (a document ends after each position with probability 1/mean_len)."""
    ids = np.zeros((B, T), np.int32)
    ends = rng.random((B, T)) < 1.0 / mean_len
    ids[:, 1:] = np.cumsum(ends[:, :-1], axis=1)
    return ids


PACKED_CASES = {
    # name: (B, Tq, Tk, H, Hkv, D, q_off, k_off, kv ids)
    "docs": (2, 64, 64, 4, 4, 32, 0, 0, "same"),
    "docs_gqa2": (1, 64, 64, 4, 2, 32, 0, 0, "same"),
    "docs_ragged": (1, 50, 50, 4, 2, 16, 0, 0, "same"),
    # Ids of global positions, each side cut at its own offset.
    "docs_offsets": (1, 48, 64, 2, 2, 16, 40, 8, "global"),
    # Key ids differ: the queries of segment 1 find no key (empty rows).
    "docs_empty_rows": (2, 64, 64, 2, 1, 16, 0, 0, "differ"),
}


def _packed_ids(seed, B, Tq, Tk, q_off, k_off, kind):
    rng = np.random.default_rng(seed)
    if kind == "global":
        ids = _doc_ids(rng, B, max(q_off + Tq, k_off + Tk), 12)
        return ids[:, q_off:q_off + Tq], ids[:, k_off:k_off + Tk]
    sq = _doc_ids(rng, B, Tq, 12)
    sk = np.where(sq == 1, 99, sq).astype(np.int32) if kind == "differ" else sq
    return sq, sk


@pytest.mark.parametrize("name", sorted(PACKED_CASES))
def test_packed_fp32_matches_jax_flash(name):
    B, Tq, Tk, H, Hkv, D, q_off, k_off, kind = PACKED_CASES[name]
    data = _inputs(5, B, Tq, Tk, H, Hkv, D)
    seg = _packed_ids(6, B, Tq, Tk, q_off, k_off, kind)
    args = (q_off, k_off, True, H // Hkv)
    want = _jax_run(*data, *args, jnp.float32, seg=seg)
    got = _torch_run(*data, *args, torch.float32, seg=seg)
    for label, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=label, **F32_TOL)
    if kind == "differ":
        empty = seg[0] == 1  # (B, Tq): rows with no key of their segment
        assert empty.any()
        assert (got[1].transpose(0, 2, 1)[empty] == -1e30).all()
        assert not got[0][empty].any() and not got[2][empty].any()


def test_packed_bf16_matches_jax_flash():
    B, Tq, Tk, H, Hkv, D, q_off, k_off, kind = PACKED_CASES["docs_gqa2"]
    data = _inputs(7, B, Tq, Tk, H, Hkv, D)
    seg = _packed_ids(8, B, Tq, Tk, q_off, k_off, kind)
    args = (q_off, k_off, True, H // Hkv)
    want = _jax_run(*data, *args, jnp.bfloat16, seg=seg)
    got = _torch_run(*data, *args, torch.bfloat16, seg=seg)
    np.testing.assert_allclose(got[0], want[0], atol=2e-2, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-3, rtol=0)
    for g, w in zip(got[2:], want[2:]):
        assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w)


@pytest.mark.parametrize("rep", [1, 2])
def test_packed_flash_and_dense_match_jax_dense(rep):
    """``attention_reference`` and ``flash_attention`` with
    ``segment_ids`` against JAX's dense reference and its flash kernel."""
    q, k, v, _, _ = _inputs(9, 2, 40, 40, 4, 4 // rep, 32)
    ids = _doc_ids(np.random.default_rng(10), 2, 40, 8)
    jq, jk, jv, jids = (jnp.asarray(x) for x in (q, k, v, ids))
    want = np.asarray(jax_dense(jq, jk, jv, causal=True, kv_repeat=rep,
                                segment_ids=jids))
    jf = np.asarray(jax_flash(jq, jk, jv, causal=True, kv_repeat=rep,
                              block_q=32, block_k=32, segment_ids=jids))
    tq, tk, tv, tids = (torch.tensor(x) for x in (q, k, v, ids))
    dense = attention_reference(tq, tk, tv, kv_repeat=rep, segment_ids=tids)
    flash = tfa.flash_attention(tq, tk, tv, kv_repeat=rep, segment_ids=tids)
    routed = attention(tq, tk, tv, impl="flash", kv_repeat=rep,
                       segment_ids=tids)
    np.testing.assert_allclose(dense.numpy(), want, **F32_TOL)
    np.testing.assert_allclose(flash.numpy(), jf, **F32_TOL)
    np.testing.assert_allclose(routed.numpy(), jf, **F32_TOL)


def test_kv_segment_ids_require_segment_ids():
    q, k, v, _, _ = _inputs(11, 1, 16, 16, 2, 2, 16)
    ids = np.zeros((1, 16), np.int32)
    with pytest.raises(ValueError, match="kv_segment_ids requires"):
        jax_flash_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      kv_segment_ids=jnp.asarray(ids))
    with pytest.raises(ValueError, match="kv_segment_ids requires"):
        tfa.flash_attention_with_lse(torch.tensor(q), torch.tensor(k),
                                     torch.tensor(v),
                                     kv_segment_ids=torch.tensor(ids))


def test_packed_kernel_wrappers_refuse_cpu_tensors():
    """K4-K6's wrappers launch on CUDA tensors or raise, like K1-K3's."""
    q = torch.zeros(1, 8, 2, 64)
    k = torch.zeros(1, 8, 1, 64)
    rows = torch.zeros(1, 2, 8)
    ids = torch.zeros(1, 8, dtype=torch.int32)
    before = [fn.launches for fn in tfa.KERNELS]
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd_seg(q, k, k, ids, ids)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dq_seg(q, k, k, q, rows, rows, rows, ids, ids)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dq_seg(q.bfloat16(), k.bfloat16(), k.bfloat16(),
                             q.bfloat16(), rows, rows, rows, ids, ids,
                             visited=torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dkv_seg(q, k, k, q, rows, rows, rows, ids, ids)
    assert [fn.launches for fn in tfa.KERNELS] == before
