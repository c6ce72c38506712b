"""ddl_tpu_torch on an NVIDIA card: the hand-written kernels against
their plain versions, the pinned-slot window stream, tiny fits (unpacked
and packed-document), the remat policies' launch counts, the
global-shuffle exchange kernel K9 (byte-exact against its plain version,
and the one-card fabric against the host exchange), and PROCESS mode
with staging: shared-memory rings page-locked with ``cudaHostRegister``,
alias- and pool-staged windows against the host's, and a PROCESS fit
against its THREAD twin (``-k "process or staging"``); recovery on the
card: a SIGKILLed PROCESS producer respawned under the alias route, a
replay while a window's copy is in flight, and the PROCESS shuffle over a
``ShmRendezvous`` landing on cuda:0 (``-k recovery``).

Every test here is marked ``cuda`` and skips where no card is present.
The file imports no JAX (the card's machine has none), so it runs there
without the repo's conftest::

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: fp32 — both sides take exact fp32 products, only the
summation order differs: 1e-4.  bf16 — the kernels round ``p`` and ``ds``
to bf16 before their products (as the TPU kernels do), the plain version
keeps fp32: ``out`` atol 2e-2, ``lse`` 1e-3, gradients relative Frobenius
error 2e-2.  The forward, the dQ and the dK/dV backward take their wgmma
kernels in bf16 and the FMA kernels in fp32; every head dim the kernels
take (16, 32, 64, 128) is checked.
The flash tests alone: ``python -m pytest tests/test_torch_cuda.py
--noconftest -q -k flash``.

Rounding that differs from the JAX package: K3 sums dK/dV over a KV
head's ``rep`` query heads in fp32 inside the kernel and rounds once,
where the JAX package rounds each head's dK/dV to bf16 and sums the group
afterwards (``ddl_tpu/ops/flash_attention.py:598-600``).  In bf16 that
is up to ``rep`` extra half-ulp roundings per element in the JAX package
— ``4 x 2^-9`` ~ 0.8% relative at the main path's rep = 4 — which the
kernel does not incur; in fp32 the two agree to summation order.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import ddl_tpu_torch
from ddl_tpu_torch import shuffle as tsh
from ddl_tpu_torch.ops import device_shuffle as tdsh
from ddl_tpu_torch.ops import flash_attention as tfa
from ddl_tpu_torch.readers import PackedTokenProducer, TokenStreamProducer

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(seed, B, Tq, Tk, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in (
        (B, Tq, H, D), (B, Tk, Hkv, D), (B, Tk, Hkv, D), (B, Tq, H, D),
        (B, H, Tq))]


@pytest.mark.flash
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_kernels_match_plain(dtype, D):
    """K1-K3 against the plain version: out, lse and the three gradients,
    with a nonzero lse cotangent and fully masked rows (k_off = 30)."""
    dt = getattr(torch, dtype)
    q, k, v, g_out, g_lse = _inputs(5, 2, 200, 200, 8, 2, D)

    def run(fn):
        ts = [torch.tensor(x, device="cuda").to(dt).requires_grad_(True)
              for x in (q, k, v)]
        out, lse = fn(*ts)
        live = lse > -1e29
        loss = (out.float() * torch.tensor(g_out, device="cuda")).sum() + (
            torch.where(live, lse * torch.tensor(g_lse, device="cuda"),
                        torch.zeros_like(lse)).sum())
        loss.backward()
        return [t.detach().float().cpu().numpy()
                for t in (out, lse, *(x.grad for x in ts))]

    before = [fn.launches for fn in tfa.KERNELS]
    got = run(lambda a, b, c: tfa.flash_attention_with_lse(a, b, c, 0, 30, True, 4))
    assert ([fn.launches - n for fn, n in zip(tfa.KERNELS, before)]
            == [1, 1, 1, 0, 0, 0])
    want = run(lambda a, b, c: tfa.attention_plain(a, b, c, 0, 30, True, 4))
    out_tol, grad_tol = (1e-4, 1e-4) if dtype == "float32" else (2e-2, 2e-2)
    np.testing.assert_allclose(got[0], want[0], atol=out_tol, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-3, rtol=0)
    for g, w in zip(got[2:], want[2:]):
        assert np.linalg.norm(g - w) <= grad_tol * np.linalg.norm(w)
    assert (got[1][..., :30] == -1e30).all() and not got[0][:, :30].any()


@pytest.mark.flash
def test_kernels_refuse_what_they_do_not_take():
    q = torch.zeros(1, 8, 2, 64, device="cuda")
    k = torch.zeros(1, 8, 1, 64, device="cuda")
    with pytest.raises(TypeError):
        tfa.flash_fwd(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_fwd(q[..., :48].contiguous(), k[..., :48].contiguous(),
                      k[..., :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_fwd(q.transpose(1, 2), k, k)


@pytest.mark.flash
@pytest.mark.parametrize("packed", [False, True])
def test_forward_route_follows_the_dtype(packed):
    """bf16 reaches the wgmma kernel (``sm90_launches``), fp32 the FMA
    kernel; both count as K1 (K4 packed)."""
    fwd = tfa.flash_fwd_seg if packed else tfa.flash_fwd
    q, k, v, _, _ = _inputs(8, 1, 130, 130, 4, 2, 64)
    ids = torch.tensor(_doc_ids(np.random.default_rng(8), 1, 130, 30),
                       device="cuda")
    seg = (ids, ids) if packed else ()
    tfa.reset_launch_counts()
    # Cumulative counts: the bf16 call moves both, the fp32 one .launches.
    for dt, counts in ((torch.bfloat16, (1, 1)), (torch.float32, (2, 1))):
        ts = [torch.tensor(x, device="cuda").to(dt) for x in (q, k, v)]
        fwd(*ts, *seg)
        torch.cuda.synchronize()
        assert (fwd.launches, fwd.sm90_launches) == counts
    other = tfa.flash_fwd if packed else tfa.flash_fwd_seg
    assert other.launches == other.sm90_launches == 0
    # The tile counter belongs to the wgmma kernel alone.
    with pytest.raises(ValueError, match="visited"):
        fwd(*ts, *seg, visited=torch.zeros(1, dtype=torch.int64,
                                           device="cuda"))


@pytest.mark.flash
def test_bf16_forward_refuses_misaligned_tensors():
    """The TMA copies need 16-byte aligned bases: a contiguous view 2 bytes
    into its storage raises, and launches nothing."""
    buf = torch.zeros(1 * 8 * 2 * 64 + 1, dtype=torch.bfloat16, device="cuda")
    q = buf[1:].view(1, 8, 2, 64)
    k = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16, device="cuda")
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    tfa.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_fwd(q, k, k)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_fwd(k.expand(1, 8, 2, 64).contiguous(), buf[1:513].view(
            1, 8, 1, 64), k)
    assert tfa.flash_fwd.launches == tfa.flash_fwd.sm90_launches == 0


@pytest.mark.flash
@pytest.mark.parametrize("packed", [False, True])
def test_example_llama_widths_run_through_the_kernels(packed):
    """The model of ``examples/train_llama.py`` (d_model
    128, 2 layers, 4 heads, 2 KV heads, d_ff 256, so head_dim 32) through
    the kernels against ``attn_impl="dense"``: loss and every gradient, in
    fp32 at the model check's tolerances (loss rel 1e-5, grads rel 1e-4);
    then the bf16 forward at those widths rides the wgmma kernel."""
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.parallel.train import tree_leaves, tree_map

    rng = np.random.default_rng(11)
    tokens = torch.tensor(rng.integers(0, 256, (2, 160)), device="cuda")
    seg = (torch.tensor(_doc_ids(rng, 2, 160, 30), device="cuda")
           if packed else None)
    cfg = llama.LlamaConfig(vocab=256, d_model=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=256, dtype=torch.float32)
    assert cfg.head_dim == 32

    def run(impl):
        c = dataclasses.replace(cfg, attn_impl=impl)
        params = tree_map(lambda t: t.requires_grad_(True),
                          llama.init_params(c, seed=3))
        loss = llama.next_token_loss(params, tokens, c, segment_ids=seg)
        loss.backward()
        return float(loss.detach()), [t.grad for t in tree_leaves(params)]

    tfa.reset_launch_counts()
    l_f, g_f = run("flash")
    ran = tfa.KERNELS[3:] if packed else tfa.KERNELS[:3]
    assert all(fn.launches == cfg.n_layers for fn in ran)
    l_d, g_d = run("dense")
    assert l_f == pytest.approx(l_d, rel=1e-5)
    for g, w in zip(g_f, g_d):
        assert float((g - w).norm()) <= 1e-4 * float(w.norm()) + 1e-12
    bf = dataclasses.replace(cfg, dtype=torch.bfloat16, attn_impl="flash")
    fwd = tfa.flash_fwd_seg if packed else tfa.flash_fwd
    tfa.reset_launch_counts()
    with torch.no_grad():
        logits = llama.forward(llama.init_params(bf, seed=3), tokens, bf,
                               segment_ids=seg)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits.float()).all())
    assert fwd.sm90_launches == fwd.launches == cfg.n_layers


def _stream(path, device, epochs):
    @ddl_tpu_torch.distributed_dataloader(
        n_producers=2, mode="thread", nslots=2,
        pin_memory=device == "cuda")
    def run(env):
        loader = ddl_tpu_torch.DistributedDataLoader(
            TokenStreamProducer(path, 256, 8, seed=4),
            batch_size=4, connection=env.connection, n_epochs=epochs,
            output="device", device=device,
        )
        out = []
        for win in loader.windows(lookahead=2):
            # A consumer on the compute stream, gated like the fused loop.
            out.append((win.long() * 3).sum(dim=-1).cpu().numpy())
            ev = torch.cuda.Event() if device == "cuda" else None
            if ev is not None:
                ev.record()
            loader.gate_release_on(ev)
            loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
        return out

    return run()


def test_pinned_window_stream_equals_cpu_stream(tmp_path):
    """Windows copied asynchronously out of page-locked slots, with the
    slot release gated on the copy (and step) events, land byte-for-byte
    like the CPU stream: a premature release would show torn windows."""
    path = os.path.join(tmp_path, "tokens.bin")
    np.random.default_rng(0).integers(0, 1 << 20, 200_000,
                                      dtype=np.int32).tofile(path)
    got = _stream(path, "cuda", 24)
    want = _stream(path, "cpu", 24)
    assert len(got) == len(want) == 24
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.flash
def test_tiny_fit_runs_through_the_kernels(tmp_path):
    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.trainer import Trainer

    path = os.path.join(tmp_path, "tokens.bin")
    np.random.default_rng(1).integers(0, 256, 50_000, dtype=np.int32).tofile(path)
    cfg = llama.LlamaConfig(vocab=256, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=512)
    trainer = Trainer(lambda p, b: llama.next_token_loss(p, b[0], cfg),
                      adamw(1e-3), llama.init_params(cfg, seed=0),
                      metrics=Metrics())
    tfa.reset_launch_counts()
    res = trainer.fit(TokenStreamProducer(path, 128, 8), config=LoaderConfig(
        batch_size=4, n_epochs=4, window_stream=True))
    assert len(res.losses) == 4 and all(np.isfinite(res.losses))
    steps = 4 * 2
    assert ([fn.launches for fn in tfa.KERNELS]
            == [cfg.n_layers * steps] * 3 + [0, 0, 0])
    # Staged by default on the card: each window's copy sources its
    # pinned slot and the slot returns before the step, so no release
    # waits on the step's event.
    assert res.metrics.counter("staging.alias_windows") == 4
    assert res.metrics.counter("ingest.fused_gated") == 0


def _doc_ids(rng, B, T, mean_len):
    """Row-local segment ids of packed documents with random lengths."""
    ids = np.zeros((B, T), np.int32)
    for b in range(B):
        ends = rng.random(T) < 1.0 / mean_len
        ids[b, 1:] = np.cumsum(ends[:-1])
    return ids


@pytest.mark.flash
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_packed_kernels_match_plain(dtype, D):
    """K4-K6 against the plain version on random documents, with key ids
    that differ from the query ids: the queries of segment 1 have no key,
    so their rows must give out = 0, lse = -1e30 and dq = 0."""
    dt = getattr(torch, dtype)
    q, k, v, g_out, g_lse = _inputs(6, 2, 200, 200, 8, 2, D)
    sq = _doc_ids(np.random.default_rng(7), 2, 200, 40)
    sk = np.where(sq == 1, 99, sq).astype(np.int32)
    seg_q, seg_k = (torch.tensor(x, device="cuda") for x in (sq, sk))

    def run(fn):
        ts = [torch.tensor(x, device="cuda").to(dt).requires_grad_(True)
              for x in (q, k, v)]
        out, lse = fn(*ts)
        live = lse > -1e29
        loss = (out.float() * torch.tensor(g_out, device="cuda")).sum() + (
            torch.where(live, lse * torch.tensor(g_lse, device="cuda"),
                        torch.zeros_like(lse)).sum())
        loss.backward()
        return [t.detach().float().cpu().numpy()
                for t in (out, lse, *(x.grad for x in ts))]

    before = [fn.launches for fn in tfa.KERNELS]
    got = run(lambda a, b, c: tfa.flash_attention_with_lse(
        a, b, c, 0, 0, True, 4, segment_ids=seg_q, kv_segment_ids=seg_k))
    assert ([fn.launches - n for fn, n in zip(tfa.KERNELS, before)]
            == [0, 0, 0, 1, 1, 1])
    want = run(lambda a, b, c: tfa.attention_plain(a, b, c, 0, 0, True, 4,
                                                   seg_q, seg_k))
    out_tol, grad_tol = (1e-4, 1e-4) if dtype == "float32" else (2e-2, 2e-2)
    np.testing.assert_allclose(got[0], want[0], atol=out_tol, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-3, rtol=0)
    for g, w in zip(got[2:], want[2:]):
        assert np.linalg.norm(g - w) <= grad_tol * np.linalg.norm(w)
    empty = sq == 1  # (B, T)
    assert empty.any()
    assert (got[1].transpose(0, 2, 1)[empty] == -1e30).all()
    assert not got[0][empty].any() and not got[2][empty].any()


@pytest.mark.flash
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("causal,Tq,Tk,H,Hkv,q_off,k_off", [
    (False, 200, 260, 4, 4, 0, 0),    # no causal loop bound, Tq != Tk
    (True, 48, 300, 4, 1, 240, 8),    # queries late in the keys
    (True, 130, 130, 2, 2, 0, 0),     # rep 1, a ragged second query tile
])
def test_bf16_forward_geometries(packed, causal, Tq, Tk, H, Hkv, q_off, k_off):
    """The wgmma forward (K1, K4 packed) against the plain version on the
    geometries the model path does not take: non-causal, q_off > k_off
    with Tq != Tk, one query head per KV head.  The key tiles the kernel
    loads (its ``visited`` counter) are those :func:`live_tiles` names,
    in every head: the rule and the kernel's tile sizes agree."""
    q, k, v, _, _ = _inputs(12, 2, Tq, Tk, H, Hkv, 64)
    ts = [torch.tensor(x, device="cuda").bfloat16() for x in (q, k, v)]
    seg = {}
    if packed:
        ids = _doc_ids(np.random.default_rng(12), 2, q_off + Tq + k_off + Tk,
                       25)
        seg = dict(segment_ids=torch.tensor(ids[:, q_off:q_off + Tq],
                                            device="cuda").contiguous(),
                   kv_segment_ids=torch.tensor(ids[:, k_off:k_off + Tk],
                                               device="cuda").contiguous())
    fwd = tfa.flash_fwd_seg if packed else tfa.flash_fwd
    tfa.reset_launch_counts()
    with torch.no_grad():
        out, lse = tfa.flash_attention_with_lse(*ts, q_off, k_off, causal,
                                                H // Hkv, **seg)
        want_out, want_lse = tfa.attention_plain(
            *ts, q_off, k_off, causal, H // Hkv, seg.get("segment_ids"),
            seg.get("kv_segment_ids"))
    torch.cuda.synchronize()
    assert fwd.sm90_launches == 1
    live = want_lse > -1e29
    assert float((out.float() - want_out.float()).abs().max()) <= 2e-2
    assert float((lse - want_lse)[live].abs().max()) <= 1e-3
    assert bool((lse[~live] == -1e30).all())
    assert not out.transpose(1, 2)[~live].any()
    ids = (seg["segment_ids"], seg["kv_segment_ids"]) if packed else (
        torch.zeros(2, Tq, dtype=torch.int32), torch.zeros(2, Tk,
                                                           dtype=torch.int32))
    visited = torch.zeros(1, dtype=torch.int64, device="cuda")
    fwd(*ts, *(ids if packed else ()), q_off, k_off, causal, visited=visited)
    rule = int(tfa.live_tiles(*ids, q_off, k_off, causal).sum())
    assert int(visited) == H * rule > 0


def _dkv_inputs(seed, B, Tq, Tk, H, Hkv, D, q_off, k_off, causal, seg=()):
    """bf16 q, k, v, dout on the card and the backward's row terms from the
    bf16 forward (a nonzero lse cotangent included)."""
    q, k, v, dout, g_lse = _inputs(seed, B, Tq, Tk, H, Hkv, D)
    q, k, v, dout = (torch.tensor(x, device="cuda").bfloat16()
                     for x in (q, k, v, dout))
    fwd = tfa.flash_fwd_seg if seg else tfa.flash_fwd
    out, lse = fwd(q, k, v, *seg, q_off, k_off, causal)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dlse = torch.tensor(0.1 * g_lse, device="cuda")
    return q, k, v, dout, lse, delta, dlse


@pytest.mark.flash
@pytest.mark.parametrize("packed", [False, True])
def test_dkv_route_follows_the_dtype(packed):
    """bf16 reaches the wgmma dK/dV kernel (``sm90_launches``), fp32 the
    FMA kernel; both count as K3 (K6 packed).  The tile counter belongs to
    the wgmma kernel alone."""
    dkv = tfa.flash_bwd_dkv_seg if packed else tfa.flash_bwd_dkv
    ids = torch.tensor(_doc_ids(np.random.default_rng(9), 1, 130, 30),
                       device="cuda")
    seg = (ids, ids) if packed else ()
    q, k, v, dout, lse, delta, dlse = _dkv_inputs(9, 1, 130, 130, 4, 2, 64,
                                                  0, 0, True, seg)
    tfa.reset_launch_counts()
    dkv(q, k, v, dout, lse, delta, dlse, *seg)
    torch.cuda.synchronize()
    assert (dkv.launches, dkv.sm90_launches) == (1, 1)
    f32 = [t.float() for t in (q, k, v, dout)]
    dkv(*f32, lse, delta, dlse, *seg)
    torch.cuda.synchronize()
    assert (dkv.launches, dkv.sm90_launches) == (2, 1)
    other = tfa.flash_bwd_dkv if packed else tfa.flash_bwd_dkv_seg
    assert other.launches == other.sm90_launches == 0
    with pytest.raises(ValueError, match="visited"):
        dkv(*f32, lse, delta, dlse, *seg,
            visited=torch.zeros(1, dtype=torch.int64, device="cuda"))


@pytest.mark.flash
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("causal,Tq,Tk,H,Hkv,q_off,k_off,mean_len", [
    (False, 200, 260, 4, 4, 0, 0, 25),   # no causal loop bound, Tq != Tk
    (True, 48, 300, 4, 1, 240, 8, 25),   # queries late in the keys
    (True, 130, 130, 2, 2, 0, 0, 25),    # rep 1, a ragged query tile
    (True, 100, 100, 8, 2, 0, 30, 25),   # T not a multiple of 64, rows with no key
    (True, 200, 200, 8, 2, 0, 0, 1),     # one-token documents (packed)
])
def test_bf16_dkv_geometries(packed, causal, Tq, Tk, H, Hkv, q_off, k_off,
                             mean_len):
    """The wgmma dK/dV kernel (K3, K6 packed) against the plain version
    through autograd on the geometries the model path does not take, at
    the bf16 tolerance (grads rel 2e-2).  The query tiles the kernel loads
    (its ``visited`` counter) are those :func:`live_tiles_dkv` names, in
    every query head; keys no query reaches give dk = dv = 0 exactly."""
    q, k, v, g_out, g_lse = _inputs(13, 2, Tq, Tk, H, Hkv, 64)
    seg = {}
    if packed:
        ids = _doc_ids(np.random.default_rng(13), 2, q_off + Tq + k_off + Tk,
                       mean_len)
        if mean_len == 1:
            ids = np.broadcast_to(np.arange(ids.shape[1], dtype=np.int32),
                                  ids.shape)
        seg = dict(segment_ids=torch.tensor(ids[:, q_off:q_off + Tq],
                                            device="cuda").contiguous(),
                   kv_segment_ids=torch.tensor(ids[:, k_off:k_off + Tk],
                                               device="cuda").contiguous())

    def run(fn):
        ts = [torch.tensor(x, device="cuda").bfloat16().requires_grad_(True)
              for x in (q, k, v)]
        out, lse = fn(*ts)
        live = lse > -1e29
        loss = (out.float() * torch.tensor(g_out, device="cuda")).sum() + (
            torch.where(live, lse * torch.tensor(g_lse, device="cuda"),
                        torch.zeros_like(lse)).sum())
        loss.backward()
        return ts[1].grad.float(), ts[2].grad.float()

    dkv = tfa.flash_bwd_dkv_seg if packed else tfa.flash_bwd_dkv
    tfa.reset_launch_counts()
    got = run(lambda a, b, c: tfa.flash_attention_with_lse(
        a, b, c, q_off, k_off, causal, H // Hkv, **seg))
    assert (dkv.launches, dkv.sm90_launches) == (1, 1)
    want = run(lambda a, b, c: tfa.attention_plain(
        a, b, c, q_off, k_off, causal, H // Hkv, seg.get("segment_ids"),
        seg.get("kv_segment_ids")))
    for g, w in zip(got, want):
        assert float((g - w).norm()) <= 2e-2 * float(w.norm())
        unreached = w.abs().amax(-1) == 0
        assert not g[unreached].any()
    ids = (seg["segment_ids"], seg["kv_segment_ids"]) if packed else ()
    inputs = _dkv_inputs(13, 2, Tq, Tk, H, Hkv, 64, q_off, k_off, causal, ids)
    visited = torch.zeros(1, dtype=torch.int64, device="cuda")
    dkv(*inputs, *ids, q_off, k_off, causal, visited=visited)
    rule_ids = ids or (torch.zeros(2, Tq, dtype=torch.int32),
                       torch.zeros(2, Tk, dtype=torch.int32))
    rule = int(tfa.live_tiles_dkv(*rule_ids, q_off, k_off, causal).sum())
    assert int(visited) == H * rule > 0


@pytest.mark.flash
@pytest.mark.parametrize("packed", [False, True])
def test_bf16_dkv_is_deterministic(packed):
    """No atomics: two calls on the same inputs give bit-identical dk, dv."""
    dkv = tfa.flash_bwd_dkv_seg if packed else tfa.flash_bwd_dkv
    ids = torch.tensor(_doc_ids(np.random.default_rng(14), 2, 300, 60),
                       device="cuda")
    seg = (ids, ids) if packed else ()
    inputs = _dkv_inputs(14, 2, 300, 300, 8, 2, 128, 0, 0, True, seg)
    first = dkv(*inputs, *seg)
    second = dkv(*inputs, *seg)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.flash
def test_bf16_dkv_refuses_misaligned_dout():
    """Called directly, the wgmma dK/dV kernel raises on a dout 2 bytes
    into its storage (its TMA needs 16-byte aligned bases) and launches
    nothing; the autograd path copies such a dout first."""
    q, k, v, dout, lse, delta, dlse = _dkv_inputs(15, 1, 64, 64, 2, 1, 64,
                                                  0, 0, True)
    buf = torch.zeros(dout.numel() + 1, dtype=torch.bfloat16, device="cuda")
    bad = buf[1:].view(dout.shape)
    bad.copy_(dout)
    assert bad.is_contiguous() and bad.data_ptr() % 16 == 2
    tfa.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_bwd_dkv(q, k, v, bad, lse, delta, dlse)
    assert tfa.flash_bwd_dkv.launches == tfa.flash_bwd_dkv.sm90_launches == 0
    out = torch.zeros_like(dout)
    aligned, _, _ = tfa._bwd_rows(bad, out, torch.zeros_like(lse))
    assert aligned.data_ptr() % 16 == 0 and torch.equal(aligned, dout)


@pytest.mark.flash
@pytest.mark.parametrize("packed", [False, True])
def test_dq_route_follows_the_dtype(packed):
    """bf16 reaches the wgmma dQ kernel (``sm90_launches``), fp32 the FMA
    kernel; both count as K2 (K5 packed).  The tile counter belongs to the
    wgmma kernel alone."""
    dq = tfa.flash_bwd_dq_seg if packed else tfa.flash_bwd_dq
    ids = torch.tensor(_doc_ids(np.random.default_rng(16), 1, 130, 30),
                       device="cuda")
    seg = (ids, ids) if packed else ()
    q, k, v, dout, lse, delta, dlse = _dkv_inputs(16, 1, 130, 130, 4, 2, 64,
                                                  0, 0, True, seg)
    tfa.reset_launch_counts()
    dq(q, k, v, dout, lse, delta, dlse, *seg)
    torch.cuda.synchronize()
    assert (dq.launches, dq.sm90_launches) == (1, 1)
    f32 = [t.float() for t in (q, k, v, dout)]
    dq(*f32, lse, delta, dlse, *seg)
    torch.cuda.synchronize()
    assert (dq.launches, dq.sm90_launches) == (2, 1)
    other = tfa.flash_bwd_dq if packed else tfa.flash_bwd_dq_seg
    assert other.launches == other.sm90_launches == 0
    with pytest.raises(ValueError, match="visited"):
        dq(*f32, lse, delta, dlse, *seg,
           visited=torch.zeros(1, dtype=torch.int64, device="cuda"))


@pytest.mark.flash
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("causal,Tq,Tk,H,Hkv,q_off,k_off,mean_len", [
    (False, 200, 260, 4, 4, 0, 0, 25),   # no causal loop bound, Tq != Tk
    (True, 48, 300, 4, 1, 240, 8, 25),   # queries late in the keys
    (True, 130, 130, 2, 2, 0, 0, 25),    # rep 1, a ragged query tile
    (True, 100, 100, 8, 2, 0, 30, 25),   # T not a multiple of 64, rows with no key
    (True, 200, 200, 8, 2, 0, 0, 1),     # one-token documents (packed)
])
def test_bf16_dq_geometries(packed, causal, Tq, Tk, H, Hkv, q_off, k_off,
                            mean_len):
    """The wgmma dQ kernel (K2, K5 packed) against the plain version
    through autograd on the geometries the model path does not take, at
    the bf16 tolerance (grads rel 2e-2).  Rows with no key give dq = 0
    exactly; the key tiles the kernel loads (its ``visited`` counter) are
    those :func:`live_tiles` names, in every query head."""
    q, k, v, g_out, g_lse = _inputs(17, 2, Tq, Tk, H, Hkv, 64)
    seg = {}
    if packed:
        ids = _doc_ids(np.random.default_rng(17), 2, q_off + Tq + k_off + Tk,
                       mean_len)
        if mean_len == 1:
            ids = np.broadcast_to(np.arange(ids.shape[1], dtype=np.int32),
                                  ids.shape)
        seg = dict(segment_ids=torch.tensor(ids[:, q_off:q_off + Tq],
                                            device="cuda").contiguous(),
                   kv_segment_ids=torch.tensor(ids[:, k_off:k_off + Tk],
                                               device="cuda").contiguous())

    def run(fn):
        ts = [torch.tensor(x, device="cuda").bfloat16().requires_grad_(True)
              for x in (q, k, v)]
        out, lse = fn(*ts)
        live = lse > -1e29
        loss = (out.float() * torch.tensor(g_out, device="cuda")).sum() + (
            torch.where(live, lse * torch.tensor(g_lse, device="cuda"),
                        torch.zeros_like(lse)).sum())
        loss.backward()
        return ts[0].grad.float(), lse.detach()

    dq = tfa.flash_bwd_dq_seg if packed else tfa.flash_bwd_dq
    tfa.reset_launch_counts()
    got, _ = run(lambda a, b, c: tfa.flash_attention_with_lse(
        a, b, c, q_off, k_off, causal, H // Hkv, **seg))
    assert (dq.launches, dq.sm90_launches) == (1, 1)
    want, want_lse = run(lambda a, b, c: tfa.attention_plain(
        a, b, c, q_off, k_off, causal, H // Hkv, seg.get("segment_ids"),
        seg.get("kv_segment_ids")))
    assert float((got - want).norm()) <= 2e-2 * float(want.norm())
    empty = (want_lse <= -1e29).transpose(1, 2)  # (B, Tq, H)
    assert bool(empty.any()) == (k_off > q_off and causal)
    assert not got[empty].any()
    ids = (seg["segment_ids"], seg["kv_segment_ids"]) if packed else ()
    inputs = _dkv_inputs(17, 2, Tq, Tk, H, Hkv, 64, q_off, k_off, causal, ids)
    visited = torch.zeros(1, dtype=torch.int64, device="cuda")
    dq(*inputs, *ids, q_off, k_off, causal, visited=visited)
    rule_ids = ids or (torch.zeros(2, Tq, dtype=torch.int32),
                       torch.zeros(2, Tk, dtype=torch.int32))
    rule = int(tfa.live_tiles(*rule_ids, q_off, k_off, causal).sum())
    assert int(visited) == H * rule > 0


@pytest.mark.flash
@pytest.mark.parametrize("packed", [False, True])
def test_bf16_dq_is_deterministic(packed):
    """No atomics: two calls on the same inputs give bit-identical dq."""
    dq = tfa.flash_bwd_dq_seg if packed else tfa.flash_bwd_dq
    ids = torch.tensor(_doc_ids(np.random.default_rng(18), 2, 300, 60),
                       device="cuda")
    seg = (ids, ids) if packed else ()
    inputs = _dkv_inputs(18, 2, 300, 300, 8, 2, 128, 0, 0, True, seg)
    first = dq(*inputs, *seg)
    second = dq(*inputs, *seg)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.flash
def test_bf16_dq_refuses_misaligned_dout():
    """Called directly, the wgmma dQ kernel raises on a dout 2 bytes into
    its storage (its TMA needs 16-byte aligned bases) and launches
    nothing; the autograd path copies such a dout first."""
    q, k, v, dout, lse, delta, dlse = _dkv_inputs(19, 1, 64, 64, 2, 1, 64,
                                                  0, 0, True)
    buf = torch.zeros(dout.numel() + 1, dtype=torch.bfloat16, device="cuda")
    bad = buf[1:].view(dout.shape)
    bad.copy_(dout)
    assert bad.is_contiguous() and bad.data_ptr() % 16 == 2
    tfa.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_bwd_dq(q, k, v, bad, lse, delta, dlse)
    assert tfa.flash_bwd_dq.launches == tfa.flash_bwd_dq.sm90_launches == 0
    tfa.flash_bwd_dq(q, k, v, bad.clone(), lse, delta, dlse)
    assert tfa.flash_bwd_dq.launches == tfa.flash_bwd_dq.sm90_launches == 1


@pytest.mark.flash
def test_packed_kernels_refuse_bad_ids():
    q = torch.zeros(1, 8, 2, 64, device="cuda")
    k = torch.zeros(1, 8, 1, 64, device="cuda")
    ids = torch.zeros(1, 8, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="int32"):
        tfa.flash_fwd_seg(q, k, k, ids.long(), ids)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_fwd_seg(q, k, k, ids, torch.zeros(
            1, 16, dtype=torch.int32, device="cuda")[:, ::2])
    with pytest.raises(ValueError):
        tfa.flash_fwd_seg(q, k, k, ids[:, :4].contiguous(), ids)
    with pytest.raises(ValueError, match="on cuda"):
        tfa.flash_fwd_seg(q, k, k, ids.cpu(), ids)


def _packed_file(path, vocab, n_tokens, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, n_tokens, dtype=np.int32)
    tokens[rng.random(n_tokens) < 1 / 30] = 0  # document ends
    tokens.tofile(path)


@pytest.mark.flash
def test_tiny_packed_fit_runs_through_packed_kernels(tmp_path):
    """The packed path end to end: PackedTokenProducer -> window stream ->
    segment-masked loss.  K4-K6 launch once per layer per step; K1-K3
    never."""
    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.trainer import Trainer

    path = os.path.join(tmp_path, "docs.bin")
    _packed_file(path, 256, 50_000, 2)
    cfg = llama.LlamaConfig(vocab=256, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=512)
    trainer = Trainer(
        lambda p, b: llama.next_token_loss(p, b[0], cfg, segment_ids=b[1]),
        adamw(1e-3), llama.init_params(cfg, seed=0), metrics=Metrics())
    tfa.reset_launch_counts()
    res = trainer.fit(PackedTokenProducer(path, 128, 8, delimiter=0),
                      config=LoaderConfig(batch_size=4, n_epochs=4,
                                          window_stream=True))
    assert len(res.losses) == 4 and all(np.isfinite(res.losses))
    steps = 4 * 2
    assert ([fn.launches for fn in tfa.KERNELS]
            == [0, 0, 0] + [cfg.n_layers * steps] * 3)


@pytest.mark.flash
@pytest.mark.parametrize("policy,fwd_per_layer",
                         [("none", 1), ("selective", 1), ("full", 2),
                          ("dots", 2)])
def test_remat_policy_launch_counts(policy, fwd_per_layer):
    """Per layer and step the forward kernel runs once under "none" and
    "selective" (the attention output is kept) and twice under "full" and
    "dots" (the backward recomputes attention); the backward kernels run
    once.  Every policy gives the loss and gradients of "none"."""
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.parallel.train import tree_leaves, tree_map

    rng = np.random.default_rng(3)
    tokens = torch.tensor(rng.integers(0, 128, (2, 96)), device="cuda")
    seg = torch.tensor(_doc_ids(rng, 2, 96, 20), device="cuda")

    def grads(remat):
        cfg = llama.LlamaConfig(vocab=128, d_model=128, n_layers=2,
                                n_heads=2, n_kv_heads=1, d_ff=256,
                                dtype=torch.float32, remat=remat)
        params = tree_map(lambda t: t.requires_grad_(True),
                          llama.init_params(cfg, seed=1))
        tfa.reset_launch_counts()
        loss = llama.next_token_loss(params, tokens, cfg, segment_ids=seg)
        loss.backward()
        torch.cuda.synchronize()
        counts = [fn.launches for fn in tfa.KERNELS]
        grads = [t.grad for t in tree_leaves(params)]
        return float(loss.detach()), grads, counts

    base_loss, base_grads, _ = grads("none")
    loss, got, counts = grads(policy)
    assert counts == [0, 0, 0, 2 * fwd_per_layer, 2, 2]
    assert loss == pytest.approx(base_loss, rel=1e-6)
    for g, w in zip(got, base_grads):
        assert float((g - w).norm()) <= 1e-6 * float(w.norm()) + 1e-12


# -- K9: the global-shuffle exchange kernel ----------------------------------


def _bytes(t):
    return t.contiguous().view(torch.uint8)


def _exchange_input(n, half, cols, dtype, seed):
    """(n * 2*half, cols) random bytes of ``dtype`` on the card."""
    isz = torch.empty(0, dtype=dtype).element_size()
    raw = np.random.default_rng(seed).integers(
        0, 256, (n * 2 * half, cols * isz), dtype=np.uint8)
    return torch.from_numpy(raw).cuda().view(dtype)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "int32", "uint8", "bfloat16"])
@pytest.mark.parametrize("cols", [256, 5])
def test_exchange_kernel_matches_plain(n, dtype, cols):
    """Byte-exact over dtypes, n and row sizes that are (cols 256) and
    are not (cols 5: 20, 5 or 10 bytes) a multiple of 16 bytes."""
    gin = _exchange_input(n, 3, cols, getattr(torch, dtype), n)
    before = _bytes(gin).clone()
    p = tsh.exchange_permutation(n, 7, 2)
    routes = np.stack([p, tsh.inverse_permutation(p)])
    got = tdsh.exchange_ring(gin, ["cuda:0"] * n, routes)
    want = tdsh.exchange_plain(gin, routes)
    torch.cuda.synchronize()
    assert got.data_ptr() != gin.data_ptr()
    assert torch.equal(_bytes(got), _bytes(want))
    assert torch.equal(_bytes(gin), before)  # the input is left as it was


def test_exchange_kernel_counts_its_launches():
    gin = _exchange_input(4, 8, 16, torch.float32, 0)
    routes = np.stack([np.array([1, 2, 3, 0]), np.array([3, 0, 1, 2])])
    tdsh.reset_launch_counts()
    for _ in range(3):
        tdsh.exchange_ring(gin, ["cuda:0"] * 4, routes)
    tdsh.exchange_plain(gin, routes)
    assert tdsh.exchange_ring.launches == 3


def test_exchange_kernel_refuses_what_it_does_not_take():
    """A CUDA tensor reaches the kernel or raises; it never takes the
    plain version."""
    gin = _exchange_input(2, 4, 8, torch.float32, 1)
    routes = [[1, 0], [1, 0]]
    tdsh.reset_launch_counts()
    with pytest.raises(ValueError, match="contiguous"):
        tdsh.exchange_ring(gin.t().contiguous().t(), ["cuda:0"] * 2, routes)
    with pytest.raises(ValueError, match="2\\*half"):
        tdsh.exchange_ring(gin[:6], ["cuda:0"] * 2, routes)
    with pytest.raises(ValueError, match="do not hold"):
        tdsh.exchange_ring(gin, ["cpu"] * 2, routes)
    with pytest.raises(ValueError, match="permutations"):
        tdsh.exchange_ring(gin, ["cuda:0"] * 2, [[0, 0], [1, 0]])
    big = _exchange_input(66, 1, 4, torch.float32, 2)
    ring = np.roll(np.arange(66), 1)
    with pytest.raises(ValueError, match="at most 64"):
        tdsh.exchange_ring(big, ["cuda:0"] * 66, [ring, np.argsort(ring)])
    assert tdsh.exchange_ring.launches == 0


@pytest.mark.parametrize("n,rows,num_exchange",
                         [(2, 16, 7), (3, 10, 10), (5, 9, 5), (8, 12, 6)])
def test_one_card_fabric_rounds_equal_the_host_exchange(n, rows, num_exchange):
    """``devices=[cuda:0] * n``: every round rides K9 (one launch per
    fabric leg) and the pools equal the host exchange's."""
    import threading

    from ddl_tpu_torch.observability import Metrics

    def run(make):
        arys = [np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
                + 10_000.0 * i for i in range(n)]
        shufs = [make(i) for i in range(n)]
        ts = [threading.Thread(target=lambda i=i: [
            shufs[i].global_shuffle(arys[i]) for _ in range(3)])
            for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
        return arys, shufs

    def topo(i):
        return ddl_tpu_torch.Topology(n_instances=n, instance_idx=i,
                                      n_producers=1)

    rdv = tsh.Rendezvous()
    host, _ = run(lambda i: tsh.ThreadExchangeShuffler(
        topo(i), 1, num_exchange, rendezvous=rdv, seed=7))
    fabric = tsh.DeviceExchangeFabric(devices=["cuda:0"] * n)

    def make(i):
        s = tsh.DeviceExchangeShuffler(topo(i), 1, num_exchange,
                                       rendezvous=tsh.Rendezvous(),
                                       fabric=fabric, seed=7)
        s.metrics = Metrics()
        return s

    tdsh.reset_launch_counts()
    dev, shufs = run(make)
    for a, b in zip(dev, host):
        assert a.tobytes() == b.tobytes()
    assert fabric.legs == 3 and tdsh.exchange_ring.launches == 3
    for s in shufs:
        assert s.metrics.counter("shuffle.device_fallbacks") == 0
        assert s.metrics.counter("shuffle.device_rounds") == 3


# -- K7/K8: the ICI tier's fan-out kernels ------------------------------------


def _fanout_block(rows, cols, dtype, seed, offset=0):
    """(rows, cols) random bytes of ``dtype`` on the card, ``offset`` bytes
    into its allocation."""
    isz = torch.empty(0, dtype=dtype).element_size()
    raw = np.random.default_rng(seed).integers(
        0, 256, rows * cols * isz + offset, dtype=np.uint8)
    return torch.from_numpy(raw).cuda()[offset:].view(dtype).view(rows, cols)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "int32", "uint8", "bfloat16"])
@pytest.mark.parametrize("cols", [256, 7])
def test_fanout_kernels_match_plain(n, dtype, cols):
    """K7 and K8 byte-exact against their plain versions, over dtypes, n
    and rows that are (256 columns) and are not (7) a multiple of 16
    bytes, from a source position other than 0."""
    from ddl_tpu_torch.ops import ici_fanout as fan

    block = _fanout_block(4 * n, cols, getattr(torch, dtype), n)
    before = _bytes(block).clone()
    devs = ["cuda:0"] * n
    fan.reset_launch_counts()
    rep = fan.fanout_replicate(block, devs, src=n - 1)
    shard = fan.fanout_shard(block, devs, src=1)
    torch.cuda.synchronize()
    assert [fn.launches for fn in fan.KERNELS] == [1, 1]
    assert rep.shards[n - 1].data is block
    for got, want in ((rep, fan.replicate_plain(block, n, n - 1)),
                      (shard, fan.shard_plain(block, n))):
        for s, w in zip(got.shards, want):
            assert s.data.is_contiguous()
            assert torch.equal(_bytes(s.data), _bytes(w))
    assert torch.equal(_bytes(block), before)


@pytest.mark.parametrize("offset,dtype", [(3, "uint8"), (4, "float32"),
                                          (8, "int32")])
def test_fanout_kernels_take_misaligned_sources(offset, dtype):
    """A source off 16-byte alignment takes the kernels' narrower paths
    (4-byte words, bytes) and their byte heads and tails."""
    from ddl_tpu_torch.ops import ici_fanout as fan

    block = _fanout_block(12, 37, getattr(torch, dtype), offset, offset)
    assert block.data_ptr() % 16 == offset
    devs = ["cuda:0"] * 4
    rep = fan.fanout_replicate(block, devs)
    shard = fan.fanout_shard(block, devs)
    torch.cuda.synchronize()
    for got, want in ((rep, fan.replicate_plain(block, 4)),
                      (shard, fan.shard_plain(block, 4))):
        assert all(torch.equal(_bytes(s.data), _bytes(w))
                   for s, w in zip(got.shards, want))


def test_fanout_kernels_refuse_what_they_do_not_take():
    """A CUDA tensor reaches the kernel or raises; it never takes the
    plain version."""
    from ddl_tpu_torch.ops import ici_fanout as fan

    block = _fanout_block(8, 16, torch.float32, 0)
    fan.reset_launch_counts()
    with pytest.raises(ValueError, match="contiguous"):
        fan.fanout_shard(block.t(), ["cuda:0"] * 2)
    with pytest.raises(ValueError, match="do not hold"):
        fan.fanout_replicate(block, ["cpu"] * 2)
    with pytest.raises(ValueError, match="divisible"):
        fan.fanout_shard(block, ["cuda:0"] * 3)
    with pytest.raises(ValueError, match="at most 64"):
        fan.fanout_replicate(block, ["cuda:0"] * 65)
    with pytest.raises(NotImplementedError, match="multi-card"):
        fan.fanout_shard(block, ["cuda:0", "cuda:1"])
    assert [fn.launches for fn in fan.KERNELS] == [0, 0]


def _mesh_sharding(axes, spec, devices=None):
    from ddl_tpu_torch.parallel.mesh import NamedSharding, P, make_mesh

    n = int(np.prod(list(axes.values())))
    return NamedSharding(make_mesh(axes, devices or ["cuda:0"] * n), P(*spec))


def test_ici_distinct_card_mesh_is_the_multi_card_slice():
    from ddl_tpu_torch.ingest import DeviceIngestor

    sh = _mesh_sharding({"dp": 2}, ("dp",), ["cuda:0", "cuda:1"])
    for distribute in ("ici", "xla", "auto"):
        with pytest.raises(NotImplementedError, match="multi-card"):
            DeviceIngestor(sharding=sh, distribute=distribute)


def test_ici_auto_engages_on_a_card_mesh():
    from ddl_tpu_torch.ingest import DeviceIngestor

    sh = _mesh_sharding({"dp": 4}, (None, "dp"))
    assert DeviceIngestor(sharding=sh).ici_active
    assert not DeviceIngestor(sharding=sh, distribute="xla").ici_active


def _sharded_stream(tmp_path, device, axes, spec, distribute):
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.readers import ArrayProducer

    data = np.random.default_rng(9).standard_normal((512, 24)).astype(np.float32)
    metrics = Metrics()

    @ddl_tpu_torch.distributed_dataloader(n_producers=2, mode="thread",
                                          nslots=2, pin_memory=device == "cuda")
    def run(env):
        loader = ddl_tpu_torch.DistributedDataLoader(
            ArrayProducer(data, window_size=128, seed=2), batch_size=16,
            connection=env.connection, n_epochs=6, output="device",
            device=device,
            sharding=_mesh_sharding(axes, spec) if device == "cuda" else None,
            distribute=distribute, metrics=metrics,
        )
        out = []
        for win in loader.windows(lookahead=2):
            if device == "cuda":
                assert all(s.data.is_contiguous() for s in win.shards)
                # A consumer on the compute stream reads every shard.
                out.append([s.data.sum().item() for s in win.shards] + [
                    win.numpy()])
            else:
                out.append(win.numpy().copy())
            loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
        return out

    return run(), metrics


@pytest.mark.parametrize("axes,spec,kernel", [
    ({"dp": 4}, (None, "dp"), "fanout_shard"),
    ({"dp": 2, "fsdp": 2}, (None, "dp"), "fanout_shard"),
    ({"dp": 4}, (None, None, None), "fanout_replicate"),
])
def test_ici_loader_windows_ride_the_fanout_kernels(tmp_path, axes, spec, kernel):
    """``DistributedDataLoader(..., sharding=, distribute="ici")`` on
    positions of cuda:0: one K7/K8 launch per window, no fallback, and
    windows byte-equal to the host stream."""
    from ddl_tpu_torch.ops import ici_fanout as fan

    want, _ = _sharded_stream(tmp_path, "cpu", axes, spec, "xla")
    fan.reset_launch_counts()
    got, m = _sharded_stream(tmp_path, "cuda", axes, spec, "ici")
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in fan.KERNELS}
    assert counts[kernel] == m.counter("ici.windows") == 6
    assert sum(counts.values()) == 6
    assert m.counter("ici.fallbacks") == 0
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g[-1].tobytes() == w.tobytes()


# -- PROCESS mode and staging -------------------------------------------------


def test_staging_registers_a_shm_ring_mapping():
    """``page_lock`` registers a native ring's whole mapping, which then
    reads back as page-locked host memory; ``page_unlock`` undoes it."""
    from ddl_tpu_torch.ops import host_register
    from ddl_tpu_torch.transport.shm_ring import NativeShmRing, make_ring_name

    ring = NativeShmRing.create(make_ring_name("ddl-torch-test"), 2, 1 << 17)
    try:
        base, nbytes = ring.mapping()
        assert base % 4096 == 0 and nbytes >= 2 * (1 << 17)
        assert not host_register.is_registered(ring.slot_base(1))
        host_register.page_lock(ring, "cuda")
        assert ring.page_locked
        assert host_register.is_registered(base)
        assert host_register.is_registered(ring.slot_base(1))
        # A non_blocking copy out of the registered slot lands the bytes.
        view = ring.slot_view(1)
        view[:] = np.arange(view.size, dtype=np.uint8)
        dev = torch.empty(view.size, dtype=torch.uint8, device="cuda")
        dev.copy_(torch.from_numpy(view), non_blocking=True)
        torch.cuda.synchronize()
        assert np.array_equal(dev.cpu().numpy(), view)
        host_register.page_unlock(ring)
        assert not ring.page_locked
        assert not host_register.is_registered(base)
    finally:
        ring.unlink()


def _process_stream(path, device, epochs, metrics):
    @ddl_tpu_torch.distributed_dataloader(n_producers=2, mode="process",
                                          nslots=2)
    def run(env):
        loader = ddl_tpu_torch.DistributedDataLoader(
            TokenStreamProducer(path, 256, 8, seed=4),
            batch_size=4, connection=env.connection, n_epochs=epochs,
            output="device", device=device, metrics=metrics,
        )
        out = []
        for win in loader.windows(lookahead=2):
            out.append(win.cpu().numpy().copy())
            loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
        return out, env

    out, env = run()
    return out, env.workers.exitcodes


@pytest.mark.parametrize("shm_staging", ["1", "0"])
def test_staging_process_windows_equal_the_host_windows(
        tmp_path, monkeypatch, shm_staging):
    """PROCESS producers over registered shm rings: alias-staged windows
    (the copy sources the slot) and copy-pool-staged ones
    (``DDL_TORCH_SHM_STAGING=0``) land byte-equal to the CPU stream, with
    the route in the counters and every mapping unregistered at
    shutdown."""
    from ddl_tpu_torch.observability import Metrics

    path = os.path.join(tmp_path, "tokens.bin")
    np.random.default_rng(0).integers(0, 1 << 20, 200_000,
                                      dtype=np.int32).tofile(path)
    monkeypatch.setenv("DDL_TORCH_SHM_STAGING", shm_staging)
    m = Metrics()
    got, codes = _process_stream(path, "cuda", 12, m)
    want, _ = _process_stream(path, "cpu", 12, Metrics())
    assert codes == [0, 0]
    assert len(got) == len(want) == 12
    assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))
    assert m.counter("transport.rings.NativeShmRing") == 2
    assert m.counter("ingest.registered_rings") == 2
    alias = 12 if shm_staging == "1" else 0
    assert m.counter("staging.alias_windows") == alias
    assert m.counter("staging.pool_misses") + m.counter(
        "staging.pool_hits") == 12 - alias
    assert m.counter("staging.alias_fallbacks") == 0
    assert m.counter("staging.pool_alias_drops") == 0
    assert m.counter("integrity.staging_verify_failures") == 0
    assert m.counter("staging.inline_fallbacks") == 0


@pytest.mark.flash
def test_process_fit_losses_equal_thread_fit(tmp_path):
    """A small model trained in PROCESS mode (spawned producers, alias
    staging over registered shm rings) gives its THREAD twin's losses bit
    for bit: the same windows, parameters and kernels."""
    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.trainer import Trainer

    path = os.path.join(tmp_path, "tokens.bin")
    np.random.default_rng(1).integers(0, 256, 50_000, dtype=np.int32).tofile(path)
    cfg = llama.LlamaConfig(vocab=256, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=512)

    def fit(mode):
        trainer = Trainer(lambda p, b: llama.next_token_loss(p, b[0], cfg),
                          adamw(1e-3), llama.init_params(cfg, seed=0),
                          metrics=Metrics())
        tfa.reset_launch_counts()
        res = trainer.fit(TokenStreamProducer(path, 128, 8),
                          config=LoaderConfig(batch_size=4, n_epochs=4,
                                              mode=mode, window_stream=True))
        return res, [fn.launches for fn in tfa.KERNELS]

    thread, thread_launches = fit("thread")
    proc, proc_launches = fit("process")
    assert proc.losses == thread.losses
    assert proc_launches == thread_launches == [2 * 8] * 3 + [0, 0, 0]
    m = proc.metrics
    assert m.counter("staging.alias_windows") == 4
    assert m.counter("ingest.registered_rings") == 2
    assert m.counter("producer.exits_clean") == 2
    assert m.counter("producer.exits_failed") == 0


@pytest.mark.parametrize("staged", [None, False])
def test_staging_prefetch_batches_equal_the_host_batches(tmp_path, staged):
    """The batch prefetcher on the card: staged by default (recycled
    page-locked buffers, transfers on the side stream through the
    background executor, handed off to the compute stream) or inline
    (``staged=False``), the batches land byte-equal to the CPU's."""
    from ddl_tpu_torch.observability import Metrics

    path = os.path.join(tmp_path, "tokens.bin")
    np.random.default_rng(3).integers(0, 1 << 20, 100_000,
                                      dtype=np.int32).tofile(path)

    def run(device, staged, metrics):
        @ddl_tpu_torch.distributed_dataloader(
            n_producers=2, mode="thread", nslots=2,
            pin_memory=device == "cuda")
        def main(env):
            loader = ddl_tpu_torch.DistributedDataLoader(
                TokenStreamProducer(path, 256, 16, seed=2), batch_size=4,
                connection=env.connection, n_epochs=6, output="device",
                device=device, metrics=metrics, staged=staged)
            out = []
            for _ in range(6):
                for (b,) in loader.prefetch(3):
                    out.append((b.long() * 3).cpu().numpy())
                    loader.mark(ddl_tpu_torch.Marker.END_OF_BATCH)
                loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
            return out

        return main()

    m = Metrics()
    got = run("cuda", staged, m)
    want = run("cpu", None, Metrics())
    assert len(got) == len(want) == 24
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    pooled = m.counter("staging.pool_hits") + m.counter("staging.pool_misses")
    assert pooled == (24 if staged is None else 0)


# -- recovery: respawn, replay and the PROCESS shuffle on the card -------------


def _recovery_windows(producer, mode, device, metrics, epochs, respawn=False,
                      lookahead=2, pin=True):
    """Drain ``producer``'s window stream onto ``device`` (2 producers),
    with a respawning watchdog when asked; returns the windows as bytes,
    the respawns and the producers' exit codes."""
    from ddl_tpu_torch.watchdog import Watchdog

    @ddl_tpu_torch.distributed_dataloader(n_producers=2, mode=mode, nslots=2,
                                          pin_memory=pin and device == "cuda")
    def run(env):
        wd = Watchdog(env.workers, poll_interval_s=0.2, stall_budget_s=60.0,
                      respawn=True, metrics=metrics).start() if respawn else None
        try:
            loader = ddl_tpu_torch.DistributedDataLoader(
                producer, batch_size=4, connection=env.connection,
                n_epochs=epochs, output="device", device=device,
                metrics=metrics, timeout_s=120.0)
            out = []
            for win in loader.windows(lookahead=lookahead):
                out.append(win.cpu().numpy().tobytes())
                loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
        finally:
            if wd is not None:
                wd.stop()
        return out, list(wd.respawns) if wd else [], env

    out, respawns, env = run()
    return out, respawns, env.workers.exitcodes


def test_recovery_sigkilled_producer_respawns_under_the_alias_route(tmp_path):
    """A PROCESS producer SIGKILLs itself mid-run: its ring stays linked
    and registered, the replacement attaches it (the consumer neither
    re-registers nor unregisters the mapping) and every window still
    takes the alias route, byte-equal to an undisturbed CPU drain."""
    from ddl_tpu_torch.observability import Metrics
    from torch_recovery_producers import CrashOnceWrapper

    path = os.path.join(tmp_path, "tokens.bin")
    np.random.default_rng(6).integers(0, 1 << 20, 400_000,
                                      dtype=np.int32).tofile(path)
    tokens = TokenStreamProducer(path, 1024, 16, seed=5)
    want, _, _ = _recovery_windows(tokens, "process", "cpu", Metrics(), 10)
    m = Metrics()
    sentinel = os.path.join(tmp_path, "killed")
    got, respawns, codes = _recovery_windows(
        CrashOnceWrapper(tokens, sentinel, fault_at=3, fault="sigkill"),
        "process", "cuda", m, 10, respawn=True)
    assert os.path.exists(sentinel)
    assert got == want
    assert len(respawns) == 1
    assert m.counter("watchdog.respawns") == 1
    assert codes == [0, 0]
    assert m.counter("ingest.registered_rings") == 2
    assert m.counter("staging.alias_windows") == 10
    assert m.counter("staging.alias_fallbacks") == 0
    assert m.counter("staging.inline_fallbacks") == 0


def test_recovery_replay_while_a_window_copy_is_in_flight(tmp_path):
    """THREAD producers over pinned slots, 4 MiB windows, lookahead 2: a
    window corrupted after its trailer was stamped is quarantined while
    the previous window's DMA out of its slot may still run; the replay
    hands slots back only after their copies complete, and the stream
    equals the undisturbed CPU stream."""
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.transport.ring import ThreadRing
    from ddl_tpu_torch import integrity

    path = os.path.join(tmp_path, "tokens.bin")
    np.random.default_rng(7).integers(0, 1 << 20, 2_000_000,
                                      dtype=np.int32).tofile(path)
    tokens = TokenStreamProducer(path, 4096, 256, seed=8)
    want, _, _ = _recovery_windows(tokens, "thread", "cpu", Metrics(), 8)
    original, fired = ThreadRing.commit, []

    def commit(self, slot, payload_bytes):
        hdr = integrity.read_header(self.slot_view(slot), payload_bytes)
        if hdr.producer_idx == 1 and hdr.seq == 2 and not fired:
            self.slot_view(slot)[payload_bytes // 2] ^= 0xFF
            fired.append(slot)
        return original(self, slot, payload_bytes)

    m = Metrics()
    ThreadRing.commit = commit
    try:
        got, _, _ = _recovery_windows(tokens, "thread", "cuda", m, 8)
    finally:
        ThreadRing.commit = original
    assert len(fired) == 1
    assert got == want
    assert m.counter("integrity.replays") == 1
    assert m.counter("integrity.corrupt_windows") == 1
    assert m.counter("integrity.replay_exhausted") == 0
    assert m.counter("staging.alias_windows") == 8


def test_recovery_process_shuffle_lands_on_the_card(tmp_path):
    """Two PROCESS instances exchanging over a ShmRendezvous session land
    their windows on cuda:0 through the staged engine, byte-equal to two
    THREAD instances over the in-process board; the session directory is
    gone after cleanup."""
    from ddl_tpu_torch.env import WorkerSet
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.types import RunMode, Topology
    from torch_recovery_producers import ExchangeProducer

    def drain(mode, device, factory, epochs=6):
        sets, loaders, out = [], [], [[], []]
        try:
            for i in range(2):
                ws = WorkerSet(Topology(n_instances=2, instance_idx=i,
                                        n_producers=1, mode=RunMode(mode)),
                               nslots=2, pin_memory=device == "cuda",
                               shuffler_factory=factory)
                sets.append(ws)
                loaders.append(ddl_tpu_torch.DistributedDataLoader(
                    ExchangeProducer(i, rows=2048, cols=64), batch_size=256,
                    connection=ws.connection, n_epochs=epochs,
                    output="device", device=device, metrics=Metrics(),
                    global_shuffle_fraction_exchange=0.5, timeout_s=120.0))
            streams = [loader.windows(lookahead=1) for loader in loaders]
            for _ in range(epochs):
                for i, (loader, s) in enumerate(zip(loaders, streams)):
                    out[i].append(next(s).cpu().numpy().tobytes())
                    loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
        finally:
            for loader in loaders:
                loader.shutdown()
            for ws in sets:
                ws.abort()
                ws.join(30.0)
        return out, [l.metrics for l in loaders]

    rdv = tsh.ShmRendezvous(tsh.make_session("t-card"), root=str(tmp_path))
    got, metrics = drain("process", "cuda",
                         tsh.ThreadExchangeShuffler.factory(rendezvous=rdv))
    want, _ = drain("thread", "cpu",
                    tsh.ThreadExchangeShuffler.factory(tsh.Rendezvous()))
    assert got == want
    assert all(m.counter("ingest.registered_rings") == 1 for m in metrics)
    assert all(m.counter("staging.alias_windows") == 6 for m in metrics)
    rdv.cleanup()
    assert not os.path.exists(rdv._dir)
