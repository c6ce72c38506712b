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
``ShmRendezvous`` landing on cuda:0 (``-k recovery``); a checkpoint
round trip of a card-resident state and KV-cache decode against the
no-cache forward (``-k "checkpoint or decode"``); the wire's card
encode and encoded legs (``-k wire``); file shards through the shard
cache onto the card — a TFRecord stream from a warm store (THREAD) and
from a spill dir (PROCESS) on the alias route, ``.npy`` shards onto a
mesh of positions through K8 (``-k cache``); the cluster ladder: a host
killed under ``windows()`` on the alias route, THREAD and PROCESS (``-k
host_kill``); the serve and tune seams: two loaders under one admission
controller with a byte budget on the alias route, ``set_depth`` on a live
card ``PrefetchIterator`` (``-k "admission or set_depth"``).

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
import math
import os
import time

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


def test_fused_fit_takes_the_next_window_under_the_running_steps(
        tmp_path, monkeypatch):
    """The fused loop's deferred read waits only for the previous
    window: with ~50 ms of card time a step (``torch.cuda._sleep`` in the
    loss) and little host work a window, window k+1's acquire begins
    while window k's steps still run — every window after the first
    counts in ``trainer.overlapped_windows`` but at most one — and the
    losses equal the synchronous loop's bit for bit."""
    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.trainer import Trainer

    path = os.path.join(tmp_path, "tokens.bin")
    np.random.default_rng(1).integers(0, 256, 50_000, dtype=np.int32).tofile(path)
    windows, seq = 6, 128
    # ~50 ms at the H100's 1.98 GHz boost clock.
    sleep_cycles = 100_000_000

    def loss_fn(p, b):
        torch.cuda._sleep(sleep_cycles)
        x = b[0].float() / 256.0
        return ((x @ p["w"]) ** 2).mean()

    def fit():
        g = torch.Generator().manual_seed(0)
        params = {"w": torch.randn(seq, 4, generator=g).cuda()}
        trainer = Trainer(loss_fn, adamw(1e-3), params, metrics=Metrics())
        return trainer.fit(TokenStreamProducer(path, seq, 8),
                           config=LoaderConfig(batch_size=4, n_epochs=windows,
                                               window_stream=True))

    fused = fit()
    monkeypatch.setenv("DDL_TORCH_FUSED", "0")
    sync = fit()
    m = fused.metrics
    assert m.counter("trainer.fused_windows") == windows
    assert m.counter("trainer.overlapped_windows") >= windows - 2
    assert sync.metrics.counter("trainer.fused_windows") == 0
    assert len(fused.losses) == windows and all(np.isfinite(fused.losses))
    assert fused.losses == sync.losses


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
    # Every window started in the next of the two landing slots.
    assert m.counter("ici.fused_windows") == 6
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g[-1].tobytes() == w.tobytes()


# -- the landing slots: fan-out and exchange tickets --------------------------


def _sleep_cycles(ms):
    """The ``torch.cuda._sleep`` argument that keeps the current stream
    busy for about ``ms`` milliseconds on this card."""
    probe = 10_000_000
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    end.synchronize()
    return int(probe * ms / start.elapsed_time(end))


def _plain(mode, block, n, src=0):
    from ddl_tpu_torch.ops import ici_fanout as fan

    return (fan.replicate_plain(block, n, src) if mode == "replicate"
            else fan.shard_plain(block, n))


@pytest.mark.parametrize("mode", ["replicate", "shard"])
def test_fanout_start_orders_after_the_anchor_and_never_waits(mode):
    """The anchor block is written by a kernel queued on the caller's
    stream behind a 200 ms sleep: ``fanout_start`` returns long before
    the sleep ends, its ticket is still in flight, and the landed blocks
    are the block's final value."""
    from ddl_tpu_torch.ops import ici_fanout as fan

    n, devs = 4, ["cuda:0"] * 4
    block = torch.zeros((1024, 256), device="cuda")
    final = _fanout_block(1024, 256, torch.float32, 5)
    fan.fanout_wait(fan.fanout_start(mode, block, devs, slot=1), sync=True)
    cycles = _sleep_cycles(200.0)
    fan.reset_launch_counts()
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    block.copy_(final)
    ticket = fan.fanout_start(mode, block, devs, slot=1)
    returned_s = time.perf_counter() - t0
    in_flight = not ticket.done.query()
    out = fan.fanout_wait(ticket)
    torch.cuda.synchronize()
    assert returned_s < 0.05 and in_flight
    assert (ticket.mode, ticket.slot) == (mode, 1)
    assert sum(fn.launches for fn in fan.KERNELS) == 1
    for s, w in zip(out.shards, _plain(mode, final, n)):
        assert torch.equal(_bytes(s.data), _bytes(w))


def test_fanout_start_keeps_a_dropped_block_until_the_slot_read_it():
    """``del`` the anchor block right after ``start``, then allocate and
    fill a same-size tensor on the caller's stream while the kernel is
    still queued: ``wait`` lands the original bytes (the allocator may
    hand the fill the block's memory only behind the kernel)."""
    from ddl_tpu_torch.ops import ici_fanout as fan

    n, devs = 4, ["cuda:0"] * 4
    block = _fanout_block(1024, 256, torch.float32, 6)
    want = [w.clone() for w in fan.shard_plain(block, n)]
    fan.fanout_wait(fan.fanout_start("shard", block, devs), sync=True)
    cycles = _sleep_cycles(100.0)
    torch.cuda.synchronize()
    torch.cuda._sleep(cycles)
    ticket = fan.fanout_start("shard", block, devs)
    del block
    other = torch.empty((1024, 256), device="cuda")
    other.fill_(-1.0)
    in_flight = not ticket.done.query()
    out = fan.fanout_wait(ticket)
    torch.cuda.synchronize()
    assert in_flight  # the kernel still read the block when it was dropped
    for s, w in zip(out.shards, want):
        assert torch.equal(_bytes(s.data), _bytes(w))


def test_two_tickets_in_flight_one_a_slot():
    """A fan-out ticket and an exchange ticket on each slot, all started
    behind a sleep: in flight together, each byte-equal to its plain
    version."""
    from ddl_tpu_torch.ops import ici_fanout as fan
    from ddl_tpu_torch.shuffle import exchange_permutation, inverse_permutation

    n, devs = 4, ["cuda:0"] * 4
    blocks = [_fanout_block(64, 256, torch.float32, 7 + s) for s in range(2)]
    gins = [_exchange_input(n, 16, 64, torch.float32, 9 + s)
            for s in range(2)]
    perm = exchange_permutation(n, 3, 0)
    routes = np.stack([perm, inverse_permutation(perm)])
    for s in range(2):  # first use of the libraries and of each slot
        fan.fanout_wait(fan.fanout_start("shard", blocks[s], devs, slot=s),
                        sync=True)
        tdsh.exchange_wait(tdsh.exchange_start("ring", gins[s], devs, perm,
                                               slot=s), sync=True)
    cycles = _sleep_cycles(100.0)
    fan.reset_launch_counts()
    tdsh.reset_launch_counts()
    torch.cuda._sleep(cycles)
    fts = [fan.fanout_start(m, blocks[s], devs, slot=s)
           for s, m in enumerate(("replicate", "shard"))]
    ets = [tdsh.exchange_start("ring", gins[s], devs, perm, slot=s)
           for s in range(2)]
    in_flight = [not t.done.query() for t in fts + ets]
    outs = [fan.fanout_wait(t) for t in fts]
    ex = [tdsh.exchange_wait(t) for t in ets]
    torch.cuda.synchronize()
    assert in_flight == [True] * 4
    assert [t.slot for t in fts + ets] == [0, 1, 0, 1]
    assert [fn.launches for fn in fan.KERNELS] == [1, 1]
    assert tdsh.exchange_ring.launches == 2
    for s, (m, out) in enumerate(zip(("replicate", "shard"), outs)):
        for got, w in zip(out.shards, _plain(m, blocks[s], n)):
            assert torch.equal(_bytes(got.data), _bytes(w))
    for s in range(2):
        assert torch.equal(_bytes(ex[s]),
                           _bytes(tdsh.exchange_plain(gins[s], routes)))


def test_a_failed_slot_launch_raises(monkeypatch):
    """No fallback on the ticket path: a launch that fails on the slot's
    stream raises out of ``start``, for K7, K8 and K9."""
    from ddl_tpu_torch.ops import ici_fanout as fan

    class Failing:
        def __getattr__(self, name):
            return lambda *a: 700  # cudaErrorIllegalAddress

    monkeypatch.setattr(fan, "_lib", Failing)
    monkeypatch.setattr(tdsh, "_lib", Failing)
    block = _fanout_block(64, 256, torch.float32, 8)
    for mode in ("replicate", "shard"):
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            fan.fanout_start(mode, block, ["cuda:0"] * 4, slot=1)
    gin = _exchange_input(4, 16, 64, torch.float32, 1)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tdsh.exchange_start("ring", gin, ["cuda:0"] * 4, [1, 2, 3, 0], slot=1)


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


def test_host_bucket_registers_exactly_its_bytes():
    """A gloo staging bucket (``collectives.host_bucket``) is page-locked
    by registering exactly its bytes, not through the caching host
    allocator (which would round 5.1 GB up to 8 GiB and keep it); a
    request of another size unregisters the old bucket, and
    ``release_host_buckets`` unregisters every bucket."""
    from ddl_tpu_torch.ops import host_register
    from ddl_tpu_torch.parallel import collectives as coll

    coll.release_host_buckets()
    a = coll.host_bucket("test.bucket", 3 * (1 << 20) + 5)
    assert host_register.is_registered(a.data_ptr())
    assert coll.host_bucket("test.bucket", 3 * (1 << 20) + 5) is a
    a.copy_(torch.arange(a.numel(), dtype=torch.float32))
    dev = a.to("cuda", non_blocking=True)
    torch.cuda.synchronize()
    assert torch.equal(dev.cpu(), a)
    old = a.data_ptr()
    b = coll.host_bucket("test.bucket", 1 << 20)
    assert host_register.is_registered(b.data_ptr())
    assert b.data_ptr() == old or not host_register.is_registered(old)
    ptr = b.data_ptr()
    coll.release_host_buckets()
    assert not host_register.is_registered(ptr)


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


# -- checkpoints and decode on the card (``-k "checkpoint or decode"``) ------


def _card_state(cfg, seed=0):
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.parallel.train import adamw, make_train_step

    init, step = make_train_step(
        lambda p, b: llama.next_token_loss(p, b[0], cfg), adamw(1e-3), "cuda")
    st = init(llama.init_params(cfg, seed=seed, device="cuda"))
    tokens = torch.randint(0, cfg.vocab, (2, 32), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(seed),
                           dtype=torch.int32)
    st, _ = step(st, (tokens,))
    return st, step, tokens


def _host_leaves(state):
    from ddl_tpu_torch.resilience.ckpt import train_state_leaves

    return [np.array(x.detach().cpu().numpy()) if isinstance(x, torch.Tensor)
            else np.array(x) for x in train_state_leaves(state)]


def test_checkpoint_round_trip_of_a_card_state_ignores_the_next_step(tmp_path):
    """A generation of a card-resident state equals the state at submit:
    steps launched right after submit (in-place AdamW updates on the same
    stream) do not reach it, and it restores onto the card exactly."""
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.resilience import AsyncCheckpointer, restore_latest

    cfg = llama.LlamaConfig(vocab=256, d_model=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=256, max_seq=64)
    st, step, tokens = _card_state(cfg)
    torch.cuda.synchronize()
    want = _host_leaves(st)
    cp = AsyncCheckpointer(str(tmp_path))
    assert cp.submit(st)
    for _ in range(3):
        st, _ = step(st, (tokens,))
    cp.flush()
    cp.close()
    after = _host_leaves(st)
    assert not all(np.array_equal(a, b) for a, b in zip(after[1:], want[1:]))
    like, _, _ = _card_state(cfg, seed=5)
    restored = restore_latest(str(tmp_path), like=like)
    assert restored is not None and restored.state.step == 1
    got = _host_leaves(restored.state)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    p0 = restored.state.params["embed"]
    assert p0.is_cuda and restored.state.optimizer.state[p0]["exp_avg"].is_cuda


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_the_no_cache_forward(dtype):
    """Cached prefill and each T = 1 step against the flash forward of the
    same prefix (fp32 1e-4; bf16 5e-2 on logits of O(1))."""
    from ddl_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab=512, d_model=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=256, max_seq=64,
                            dtype=getattr(torch, dtype))
    params = llama.init_params(cfg, seed=3, device="cuda")
    prompt = torch.randint(0, cfg.vocab, (2, 16), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(0),
                           dtype=torch.int32)
    tol = 1e-4 if dtype == "float32" else 5e-2
    with torch.no_grad():
        out = llama.generate(params, prompt, cfg, max_new_tokens=8)
        cache = llama.init_cache(cfg, 2, 24, device="cuda")
        logits, cache = llama.forward_with_cache(params, prompt, cfg, cache, 0)
        full = llama.forward(params, prompt, cfg)
        torch.testing.assert_close(logits, full, atol=tol, rtol=tol)
        for pos in range(16, 23):
            tok = out[:, pos:pos + 1]
            step, cache = llama.forward_with_cache(params, tok, cfg, cache, pos)
            full = llama.forward(params, out[:, :pos + 1], cfg)
            torch.testing.assert_close(step[:, 0], full[:, -1], atol=tol,
                                       rtol=tol)
    assert tuple(out.shape) == (2, 24) and int(out.max()) < cfg.vocab


# -- the wire on the card -------------------------------------------------------


def _host_wire_rows(x, wd):
    """The host ``encode_window`` of a 2-D float array laid out as the ICI
    wire's ``(rows, wire_cols)`` uint8 rows: payload, then int8 scales."""
    from ddl_tpu_torch import wire

    payload, scales = wire.encode_window(x, wd)
    rows = x.shape[0]
    if scales is None:
        return payload.reshape(rows, -1)
    return np.concatenate([payload.reshape(rows, -1),
                           scales.view(np.uint8).reshape(rows, -1)], axis=1)


@pytest.mark.parametrize("wd", ["bf16", "int8"])
@pytest.mark.parametrize("rows,cols", [(4096, 256), (64, 48), (8, 700),
                                       (3, 1)])
def test_wire_device_encode_equals_the_host_encode(wd, rows, cols):
    """The card's encode (``parallel.ici.encode2d``) byte for byte the host
    ``wire.encode_window``, payload and scales (zeros, a signed zero and a
    subnormal included); the card's decode bit for bit the host
    ``decode_window``."""
    from ddl_tpu_torch import wire
    from ddl_tpu_torch.parallel.ici import decode2d, encode2d

    x = (np.random.default_rng(rows + cols).standard_normal((rows, cols))
         * 10).astype(np.float32)
    x.reshape(-1)[:3] = [0.0, -0.0, 1e-40][: x.size]
    w = encode2d(torch.from_numpy(x).cuda(), wd)
    torch.cuda.synchronize()
    assert w.dtype == torch.uint8
    assert w.cpu().numpy().tobytes() == _host_wire_rows(x, wd).tobytes()
    payload, scales = wire.encode_window(x, wd)
    back = decode2d(w, cols, torch.float32, wd)
    assert back.cpu().numpy().tobytes() == wire.decode_window(
        payload, scales, x.shape, x.dtype, wd).tobytes()


@pytest.mark.parametrize("rows,wire_cols", [(64, 52), (128, 260), (12, 98)])
def test_wire_rows_off_16_bytes_ride_k7_and_k8(rows, wire_cols):
    """Encoded rows whose width is no multiple of 16 bytes (int8 at 48 and
    256 columns: 52 and 260 bytes; bf16 at 49: 98) through K8 and K7,
    byte-exact against the plain versions."""
    from ddl_tpu_torch.ops import ici_fanout as fan

    block = _fanout_block(rows, wire_cols, torch.uint8, rows)
    devs = ["cuda:0"] * 4
    fan.reset_launch_counts()
    shard = fan.fanout_shard(block, devs)
    rep = fan.fanout_replicate(block, devs)
    torch.cuda.synchronize()
    assert [fn.launches for fn in fan.KERNELS] == [1, 1]
    for got, want in ((shard, fan.shard_plain(block, 4)),
                      (rep, fan.replicate_plain(block, 4))):
        assert all(torch.equal(s.data, w) for s, w in zip(got.shards, want))


@pytest.mark.parametrize("wd", ["bf16", "int8"])
@pytest.mark.parametrize("axes,spec,kernel", [
    ({"dp": 4}, (None, "dp"), "fanout_shard"),
    ({"dp": 2, "fsdp": 2}, (None, "dp"), "fanout_shard"),
    ({"dp": 4}, (None, None, None), "fanout_replicate"),
])
def test_wire_ici_legs_land_the_host_decode_of_the_host_encode(wd, axes, spec,
                                                               kernel):
    """An encoded ICI leg on positions of cuda:0: one K7/K8 launch on
    uint8 rows, every position's values the host decode of the host
    encode of the window's 2-D view, the plan's wire bytes counted, no
    fallback."""
    from ddl_tpu_torch import wire
    from ddl_tpu_torch.ingest import device_put
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import ici_fanout as fan
    from ddl_tpu_torch.parallel.ici import IciDistributor

    win = np.random.default_rng(3).standard_normal((4, 64, 48)).astype(
        np.float32)
    sh = _mesh_sharding(axes, spec)
    m = Metrics()
    dist = IciDistributor(sh, metrics=m, wire_dtype=wd)
    fan.reset_launch_counts()
    out = dist.put(torch.from_numpy(win), device_put)
    torch.cuda.synchronize()
    plan = dist.plan(win.shape, win.dtype)
    split = plan.split_dim or 0
    view = np.moveaxis(win, split, 0).reshape(win.shape[split], -1)
    payload, scales = wire.encode_window(view, wd)
    dec = wire.decode_window(payload, scales, view.shape, view.dtype, wd)
    want = np.ascontiguousarray(np.moveaxis(
        dec.reshape((win.shape[split],) + tuple(np.delete(win.shape, split))),
        0, split))
    for s in out.shards:
        assert s.data.is_contiguous()
        assert s.data.cpu().numpy().tobytes() == np.ascontiguousarray(
            want[s.index]).tobytes()
    counts = {fn.__name__: fn.launches for fn in fan.KERNELS}
    assert counts[kernel] == 1 and sum(counts.values()) == 1
    assert m.counter("ici.fallbacks") == 0
    assert m.counter("ici.bytes") == plan.wire_bytes
    assert m.counter("wire.encoded_bytes") == plan.encoded_bytes


def test_wire_ici_faults_on_the_card_raise(monkeypatch):
    """On the card a failed encoded ICI leg raises and latches nothing,
    whether the ``ici.fanout`` site injected it or a launch failed: the
    card is never traded for the plain route."""
    from ddl_tpu_torch import faults
    from ddl_tpu_torch.exceptions import InjectedFault
    from ddl_tpu_torch.ingest import device_put
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import ici_fanout as fan
    from ddl_tpu_torch.parallel.ici import IciDistributor

    sh = _mesh_sharding({"dp": 4}, (None, "dp"))
    win = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 64, 48)).astype(np.float32))
    m = Metrics()
    dist = IciDistributor(sh, metrics=m, wire_dtype="int8")
    plan = faults.FaultPlan([faults.FaultSpec(
        "ici.fanout", faults.FaultKind.ICI_DMA_FAIL)])
    with faults.armed(plan):
        with pytest.raises(InjectedFault, match="ici_dma_fail"):
            dist.put(win, device_put)
    assert not dist.faulted and m.counter("ici.fallbacks") == 0
    broken = IciDistributor(sh, metrics=Metrics(), wire_dtype="int8")

    def fail(*a, **k):
        raise RuntimeError("a failed launch")

    monkeypatch.setattr(fan, "fanout_shard", fail)
    with pytest.raises(RuntimeError, match="failed launch"):
        broken.put(win, device_put)
    assert not broken.faulted


@pytest.mark.parametrize("mode", ["thread", "process"])
@pytest.mark.parametrize("wd", ["bf16", "int8"])
def test_wire_decoded_windows_take_the_copying_route(wd, mode):
    """Slot-wire windows onto cuda:0 through the staged engine: the stream
    is the host decode of the host encode of the raw stream, bit for bit;
    every window is decoded at the consumer edge and copied through the
    staging pool, never aliased (its bytes are not the slot's)."""
    from ddl_tpu_torch import wire
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.readers import ArrayProducer

    data = np.random.default_rng(9).standard_normal((512, 24)).astype(
        np.float32)
    epochs = 4

    def stream(device, wire_dtype, metrics):
        prod = ArrayProducer(data, window_size=128, seed=2)
        prod.wire_dtype = wire_dtype

        @ddl_tpu_torch.distributed_dataloader(
            n_producers=2, mode=mode if device == "cuda" else "thread",
            nslots=2, pin_memory=device == "cuda")
        def run(env):
            loader = ddl_tpu_torch.DistributedDataLoader(
                prod, batch_size=16, connection=env.connection,
                n_epochs=epochs, output="device", device=device,
                staged=True, metrics=metrics)
            out = []
            for win in loader.windows(lookahead=1):
                out.append(win.cpu().numpy().reshape(128, 24).copy())
                loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
            return out

        return run()

    raw = stream("cpu", "raw", Metrics())
    m = Metrics()
    got = stream("cuda", wd, m)
    assert len(got) == epochs
    for g, r in zip(got, raw):
        payload, scales = wire.encode_window(r, wd)
        want = wire.decode_window(payload, scales, r.shape, r.dtype, wd)
        assert g.tobytes() == want.tobytes()
    assert m.counter("wire.decoded_windows") == epochs
    assert m.counter("staging.alias_windows") == 0
    assert m.timer("ingest.stage_copy").count == epochs
    assert m.counter("integrity.corrupt_windows") == 0
    assert m.counter("integrity.staging_verify_failures") == 0


# -- file shards through the shard cache --------------------------------------


def _tfrecord_glob(tmp_path):
    import chip_smoke

    tokens = (np.random.default_rng(3).zipf(1.2, 60_000) - 1) % 1000
    lens = chip_smoke._doc_lengths(np.random.default_rng(3), 60_000)
    return chip_smoke.write_tfrecord_corpus(str(tmp_path), tokens, lens, 4)[0]


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_cache_tfrecord_windows_alias_from_the_cache(tmp_path, mode):
    """A TFRecord stream onto cuda:0 whose shards come from the cache
    (THREAD: a store warmed by an uncached pass's twin; PROCESS: each
    producer's store built from the exported spill dir) equals the
    uncached host stream byte for byte, every window on the alias route,
    and no shard is fetched from source."""
    import chip_smoke
    from ddl_tpu_torch.cache import CacheStore
    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.readers import TFRecordTokenProducer

    pattern = _tfrecord_glob(tmp_path)
    spill = str(tmp_path / "spill")
    store = CacheStore(spill_dir=spill, metrics=Metrics())
    for idx in (1, 2):  # every shard into the store
        p = TFRecordTokenProducer(pattern, 256, 8, cache=store, warm=False)
        chip_smoke._refills(p, 40, producer_idx=idx, n_producers=2)
    os.makedirs(tmp_path / "fetches")
    fetch = chip_smoke.FetchLog(str(tmp_path / "fetches"))

    def stream(device, producer, mode, config=None, metrics=None):
        @ddl_tpu_torch.distributed_dataloader(
            n_producers=2, mode=mode, nslots=2, config=config,
            pin_memory=device == "cuda")
        def run(env):
            loader = ddl_tpu_torch.DistributedDataLoader(
                producer, batch_size=4, connection=env.connection,
                n_epochs=6, output="device", device=device,
                metrics=metrics or Metrics())
            out = []
            for win in loader.windows(lookahead=1):
                out.append(win.cpu().numpy().copy())
                loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
            return out, env

        out, env = run()
        return out, env.workers.exitcodes  # filled in once they joined

    want, _ = stream("cpu", TFRecordTokenProducer(pattern, 256, 8,
                                                  cache=False), "thread")
    m = Metrics()
    if mode == "thread":
        got, codes = stream("cuda", TFRecordTokenProducer(
            pattern, 256, 8, cache=store, warm=False, backend=fetch),
            mode, metrics=m)
        assert store.metrics.counter("cache.hits") > 0
    else:
        cfg = LoaderConfig(cache=True, cache_spill_dir=spill,
                           cache_warm=False)
        try:
            got, codes = stream("cuda", TFRecordTokenProducer(
                pattern, 256, 8, backend=fetch), mode, config=cfg, metrics=m)
        finally:
            for var in [v for v in os.environ
                        if v.startswith("DDL_TORCH_CACHE")]:
                os.environ.pop(var)
        assert codes == [0, 0]
    assert fetch.fetches() == 0
    assert len(got) == len(want) == 6
    assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))
    assert m.counter("staging.alias_windows") == 6
    assert m.counter("staging.alias_fallbacks") == 0
    assert m.counter("integrity.corrupt_windows") == 0


def test_cache_npy_shards_ride_k8_onto_a_mesh(tmp_path):
    """``.npy`` shards through a RAM store over a throttled backend onto
    dp=4 positions of cuda:0: one K8 launch a window, no fallback, one
    miss a shard, and every position's shard byte-equal to its slice of
    the uncached host stream."""
    from ddl_tpu_torch.cache import CacheStore, ThrottledBackend
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import ici_fanout as fan
    from ddl_tpu_torch.parallel.mesh import NamedSharding, P, make_mesh
    from ddl_tpu_torch.readers import FileShardProducer

    rng = np.random.default_rng(5)
    for i in range(4):
        np.save(tmp_path / f"s{i}.npy",
                rng.standard_normal((1024, 64)).astype(np.float32))
    pattern = str(tmp_path / "s*.npy")
    sh = NamedSharding(make_mesh({"dp": 4}, ["cuda:0"] * 4), P(None, "dp"))

    def stream(producer, device, sharding=None, metrics=None):
        @ddl_tpu_torch.distributed_dataloader(n_producers=2, mode="thread",
                                              pin_memory=device == "cuda")
        def run(env):
            loader = ddl_tpu_torch.DistributedDataLoader(
                producer, batch_size=128, connection=env.connection,
                n_epochs=8, output="device", device=device,
                sharding=sharding, distribute="ici" if sharding else "auto",
                metrics=metrics or Metrics())
            out = []
            for win in loader.windows(lookahead=1):
                out.append(win.numpy().copy() if sharding is None
                           else [(s.index, s.data.cpu().numpy())
                                 for s in win.shards])
                loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
            return out

        return run()

    want = stream(FileShardProducer(pattern, seed=1, cache=False), "cpu")
    cm, lm = Metrics(), Metrics()
    store = CacheStore(ram_budget_bytes=64 << 20, metrics=cm)
    fan.reset_launch_counts()
    got = stream(FileShardProducer(
        pattern, seed=1, cache=store, warm=False,
        backend=ThrottledBackend(latency_s=0.02)), "cuda", sh, lm)
    torch.cuda.synchronize()
    assert fan.fanout_shard.launches == lm.counter("ici.windows") == 8
    assert fan.fanout_replicate.launches == 0
    assert lm.counter("ici.fallbacks") == 0
    assert cm.counter("cache.misses") == 4
    assert len(got) == len(want) == 8
    for shards, w in zip(got, want):
        for index, data in shards:
            assert data.tobytes() == np.ascontiguousarray(w[index]).tobytes()


# -- the mesh path: ring attention over positions of the card ----------------


def _rel_err(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


@pytest.fixture
def dlse_seen(monkeypatch):
    """Records ``max|dlse|`` of each backward call: the row terms
    (``_bwd_rows``) hand K2/K3 (K5/K6) the lse cotangent."""
    seen = []
    rows = tfa._bwd_rows

    def wrapped(dout, out, dlse):
        res = rows(dout, out, dlse)
        seen.append(float(res[2].abs().max()))
        return res

    monkeypatch.setattr(tfa, "_bwd_rows", wrapped)
    return seen


@pytest.mark.flash
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("packed", [False, True])
def test_ring_matches_plain_on_the_card(packed, dtype, dlse_seen):
    """The ring over sp = 4 positions of cuda:0 reaches K1-K3 (K4-K6
    packed, ids rotating with their blocks) at the blocks' global offsets,
    sp^2 launches each, the backward fed a nonzero lse cotangent; output
    and q/k/v grads against ``attention_plain`` over the whole T (2e-2
    relative in bf16, 1e-4 in fp32)."""
    from ddl_tpu_torch.parallel.mesh import make_mesh
    from ddl_tpu_torch.parallel.ring_attention import ring_attention

    sp, B, T, H, Hkv, D = 4, 2, 512, 4, 2, 64
    dt = getattr(torch, dtype)
    q, k, v, dout, _ = _inputs(21, B, T, T, H, Hkv, D)
    ts = [torch.tensor(x, device="cuda", dtype=dt, requires_grad=True)
          for x in (q, k, v)]
    ids = (torch.tensor(_doc_ids(np.random.default_rng(4), B, T, 90),
                        device="cuda") if packed else None)
    mesh = make_mesh({"sp": sp}, ["cuda:0"] * sp)
    tfa.reset_launch_counts()
    out = ring_attention(*ts, mesh, dp_axis=None, kv_repeat=H // Hkv,
                         use_flash=True, segment_ids=ids)
    g = torch.tensor(dout, device="cuda", dtype=dt)
    grads = torch.autograd.grad(out, ts, g)
    torch.cuda.synchronize()
    ref = [t.detach().float().requires_grad_(True) for t in ts]
    want, _ = tfa.attention_plain(*ref, kv_repeat=H // Hkv, seg_q=ids, seg_k=ids)
    wgrads = torch.autograd.grad(want, ref, g.float())
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    assert _rel_err(out, want) <= tol
    for a, b in zip(grads, wgrads):
        assert _rel_err(a, b) <= tol
    kernels = tfa.KERNELS[3:] if packed else tfa.KERNELS[:3]
    for fn in kernels:
        assert fn.launches == sp * sp, fn.__name__
        assert fn.sm90_launches == (sp * sp if dt == torch.bfloat16 else 0)
    for fn in (tfa.KERNELS[:3] if packed else tfa.KERNELS[3:]):
        assert fn.launches == 0
    assert len(dlse_seen) == sp * sp and max(dlse_seen) > 0


@pytest.mark.flash
def test_a_failing_kernel_in_the_ring_raises():
    """On CUDA tensors the ring reaches the kernels or raises — a head dim
    the kernels refuse is not traded for the plain route."""
    from ddl_tpu_torch.parallel.mesh import make_mesh
    from ddl_tpu_torch.parallel.ring_attention import ring_attention

    q = torch.randn(1, 64, 2, 48, device="cuda", dtype=torch.bfloat16)
    mesh = make_mesh({"sp": 2}, ["cuda:0"] * 2)
    tfa.reset_launch_counts()
    with pytest.raises(ValueError, match="head_dim 48"):
        ring_attention(q, q, q, mesh, dp_axis=None, use_flash=True)
    assert all(fn.launches == 0 for fn in tfa.KERNELS)


def test_a_mesh_over_distinct_cards_still_raises():
    from ddl_tpu_torch.parallel.mesh import Mesh
    from ddl_tpu_torch.parallel.ring_attention import ring_attention

    mesh = Mesh(["cuda:0", "cuda:1"], ("sp",))
    q = torch.randn(1, 64, 2, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="distinct cards"):
        ring_attention(q, q, q, mesh, dp_axis=None, use_flash=True)


@pytest.mark.flash
def test_sharded_local_attention_on_the_card():
    """dp = 2 x tp = 2 positions of cuda:0: one K1-K3 launch a position
    (batch and heads cut), against the one-call kernels bit for bit."""
    from ddl_tpu_torch.parallel.mesh import make_mesh
    from ddl_tpu_torch.parallel.ring_attention import attention

    q, k, v, _, _ = _inputs(5, 4, 256, 256, 8, 4, 64)
    ts = [torch.tensor(x, device="cuda").bfloat16() for x in (q, k, v)]
    mesh = make_mesh({"dp": 2, "tp": 2}, ["cuda:0"] * 4)
    tfa.reset_launch_counts()
    out = attention(*ts, kv_repeat=2, mesh=mesh)
    assert tfa.flash_fwd.sm90_launches == 4
    want = attention(*ts, kv_repeat=2)
    assert torch.equal(out, want)


def test_zero1_fit_on_the_card_is_bit_equal(tmp_path):
    """A tiny fit over dp = 2 positions of cuda:0: ZeRO-1 (fp32) gives the
    replicated optimizer's losses bit for bit; int8 passes the parity
    gate."""
    from ddl_tpu_torch.config import LoaderConfig, TrainConfig
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.parallel.mesh import make_mesh
    from ddl_tpu_torch.parallel.optimizer import loss_parity
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.trainer import Trainer

    path = str(tmp_path / "tok.bin")
    np.random.default_rng(0).integers(0, 256, 50_000, dtype=np.int32).tofile(path)
    cfg = llama.LlamaConfig(vocab=256, d_model=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=256, max_seq=128)
    mesh = make_mesh({"dp": 2}, ["cuda:0"] * 2)

    def fit(**tc):
        return Trainer(
            lambda p, b: llama.next_token_loss(p, b[0], cfg, mesh=mesh),
            adamw(1e-3), llama.init_params(cfg, seed=0), metrics=Metrics(),
            train_config=TrainConfig(**tc), mesh=mesh,
            param_specs=llama.param_specs(cfg),
        ).fit(TokenStreamProducer(path, 128, 8), config=LoaderConfig(
            batch_size=4, n_epochs=3, n_producers=2, window_stream=True)).losses

    rep = fit()
    assert fit(optimizer_sharding="zero1") == rep
    gate = loss_parity(rep, fit(optimizer_sharding="zero1", grad_comm="int8"))
    assert gate["parity"] and gate["max_rel_drift"] > 0


# -- the pipeline schedule ------------------------------------------------------------


def _pp_setup(dtype, n_layers=4):
    from ddl_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab=256, d_model=512, n_layers=n_layers,
                            n_heads=8, n_kv_heads=4, d_ff=1024, max_seq=256,
                            dtype=getattr(torch, dtype))
    params = llama.init_params(cfg, seed=3, device="cuda")
    tokens = torch.randint(0, 256, (4, 256), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(4))
    return cfg, params, tokens


@pytest.mark.flash
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tp_resident_pipelined_stages_match_plain_on_the_card(dtype):
    """Tensor-parallel-resident stages on pp = 2 x tp = 2 positions of
    cuda:0: every K1 call at the LOCAL head counts (4 query heads over 2
    KV heads a tp position), one a (tp position, live tick, layer); the
    logits and the stage grads against the plain version (dense
    attention, one device) at the file's tolerances."""
    import dataclasses as dc

    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.parallel.mesh import make_mesh
    from ddl_tpu_torch.parallel.train import tree_leaves

    cfg, params, tokens = _pp_setup(dtype)
    mesh = make_mesh({"pp": 2, "tp": 2}, ["cuda:0"] * 4)
    staged = llama.stage_params(params, 2)
    for leaf in tree_leaves(staged):
        leaf.requires_grad_(True)
    heads = []
    orig = tfa.flash_attention

    def counted(q, *a, **kw):
        heads.append((q.shape[2], a[0].shape[2]))
        return orig(q, *a, **kw)

    tfa.reset_launch_counts()
    tfa.flash_attention = counted
    try:
        out = llama.forward_pp(staged, tokens, cfg, mesh, n_microbatches=2)
    finally:
        tfa.flash_attention = orig
    assert set(heads) == {(4, 2)} and len(heads) == 2 * 4 * 2
    launches = tfa.flash_fwd.sm90_launches if dtype == "bfloat16" else \
        tfa.flash_fwd.launches
    assert launches == 2 * 4 * 2
    out.float().square().mean().backward()
    plain_cfg = dc.replace(cfg, attn_impl="dense")
    plain_params = llama.stage_params(
        {k: v for k, v in params.items()}, 2)
    for leaf in tree_leaves(plain_params):
        leaf.requires_grad_(True)
    ref = llama.forward_pp(plain_params, tokens, plain_cfg, None, 2)
    ref.float().square().mean().backward()
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    assert _rel_err(out.detach(), ref.detach()) < tol
    for a, b in zip(tree_leaves(staged["stages"]),
                    tree_leaves(plain_params["stages"])):
        assert _rel_err(a.grad, b.grad) < tol


@pytest.mark.flash
def test_pipeline_schedules_bit_equal_on_the_card():
    """gpipe (2 stages of 2 layers), 1f1b (2 stages x 2 chunks of 1
    layer) and the sequential fallback run the same kernels on the same
    microbatch shapes in the same order on the card: logits and stage
    grads bit for bit, K1 once a (microbatch, layer)."""
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.parallel.mesh import make_mesh
    from ddl_tpu_torch.parallel.train import tree_leaves

    cfg, params, tokens = _pp_setup("bfloat16")
    runs = []
    for axes, V in (({"pp": 2, "dp": 2}, 1), ({"pp": 2, "dp": 2}, 2),
                    ({"dp": 2}, 1)):
        staged = llama.stage_params(params, 2, n_chunks=V)
        for leaf in tree_leaves(staged):
            leaf.requires_grad_(True)
        tfa.reset_launch_counts()
        out = llama.forward_pp(
            staged, tokens, cfg, make_mesh(axes, ["cuda:0"] * 4 if "pp" in axes
                                           else ["cuda:0"] * 2), 2,
            schedule="gpipe" if V == 1 else "1f1b",
            n_chunks=None if V == 1 else V)
        assert tfa.flash_fwd.sm90_launches == 2 * 4
        out.float().square().mean().backward()
        grads = staged["stages"]["wq"].grad
        if V == 2:  # [d, c, 0] = layer c*2 + d -> gpipe's [s, i] = layer 2s+i
            grads = torch.stack([grads[li % 2, li // 2, 0] for li in range(4)]
                                ).reshape(2, 2, *grads.shape[3:])
        runs.append((out.detach(), grads))
    for out, grads in runs[1:]:
        assert torch.equal(out, runs[0][0])
        assert torch.equal(grads, runs[0][1])


# -- observability on the card ---------------------------------------------------


def _obs_tiny_fit(path, armed=None, mode="thread"):
    """A tiny token fit on the card, 3 windows of 2 steps, optionally
    inside ``armed`` (a context manager)."""
    import contextlib

    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.trainer import Trainer

    cfg = llama.LlamaConfig(vocab=256, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=512)
    trainer = Trainer(lambda p, b: llama.next_token_loss(p, b[0], cfg),
                      adamw(1e-3), llama.init_params(cfg, seed=0),
                      metrics=Metrics())
    tfa.reset_launch_counts()
    with armed if armed is not None else contextlib.nullcontext():
        res = trainer.fit(TokenStreamProducer(path, 128, 8), config=LoaderConfig(
            batch_size=4, n_epochs=3, mode=mode, window_stream=True))
        torch.cuda.synchronize()
    return res, [fn.launches for fn in tfa.KERNELS]


@pytest.mark.flash
@pytest.mark.parametrize("mode", ["thread", "process"])
def test_obs_armed_fit_is_bit_equal(tmp_path, mode):
    """Span tracing and the flight recorder armed (exported to PROCESS
    producers) change no loss and no launch; every served window has its
    stage events."""
    import contextlib

    from ddl_tpu_torch.obs import SpanLog, recorder, spans

    path = os.path.join(tmp_path, "tokens.bin")
    np.random.default_rng(1).integers(0, 256, 50_000, dtype=np.int32).tofile(path)
    plain, plain_launches = _obs_tiny_fit(path, mode=mode)
    slog = SpanLog()
    stack = contextlib.ExitStack()
    stack.enter_context(spans.tracing(slog, export=True))
    stack.enter_context(recorder.armed(directory=str(tmp_path / "flight"),
                                       export=True))
    armed, armed_launches = _obs_tiny_fit(path, stack, mode=mode)
    assert armed.losses == plain.losses
    assert armed_launches == plain_launches == [2 * 6] * 3 + [0, 0, 0]
    stages = {}
    for e in slog.events():
        stages.setdefault((e[3], e[4]), set()).add(e[2])
    served = {k: v for k, v in stages.items() if "consumer.yield" in v}
    assert len(served) == 3
    for v in served.values():
        assert {"producer.fill", "producer.commit", "consumer.acquire",
                "ingest.transfer", "trainer.consume", "consumer.release"} <= v
    if mode == "process":
        assert armed.metrics.adopted_prefixes() == ["producer.0.", "producer.1."]


@pytest.mark.flash
def test_obs_profiling_trace_names_k1(tmp_path):
    """``profiling.trace`` around a tiny fit: the Chrome trace holds the
    pipeline's host ranges and as many K1 kernel events as K1's counter."""
    import json

    from ddl_tpu_torch import profiling

    path = os.path.join(tmp_path, "tokens.bin")
    np.random.default_rng(1).integers(0, 256, 50_000, dtype=np.int32).tofile(path)
    _obs_tiny_fit(path)  # warm-up
    with profiling.trace(str(tmp_path / "prof")) as prof:
        _res, launches = _obs_tiny_fit(path)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    k1 = [n for e, n in zip(events, names)
          if e.get("cat") == "kernel" and "flash_fwd_sm90_kernel" in n]
    assert len(k1) == launches[0] == tfa.flash_fwd.sm90_launches > 0
    assert "ddl.window_wait" in names and "ddl.ingest_put_window" in names


def test_obs_corrupt_window_flight_dump(tmp_path):
    """A corrupt window on the card's staged stream under an armed
    recorder: one dump names the quarantined window, and the stream
    equals the undisturbed one."""
    import json

    from ddl_tpu_torch import DistributedDataLoader, Marker, distributed_dataloader
    from ddl_tpu_torch import faults as flt
    from ddl_tpu_torch.obs import recorder
    from ddl_tpu_torch.observability import Metrics

    path = os.path.join(tmp_path, "tokens.bin")
    np.random.default_rng(1).integers(0, 256, 50_000, dtype=np.int32).tofile(path)

    def drain(m):
        @distributed_dataloader(n_producers=2, mode="thread", nslots=2)
        def run(env):
            loader = DistributedDataLoader(
                TokenStreamProducer(path, 128, 8), batch_size=4,
                connection=env.connection, n_epochs=4, output="device",
                device="cuda", metrics=m)
            out = []
            for win in loader.windows():
                out.append(win.cpu())
                loader.mark(Marker.END_OF_EPOCH)
            return out

        return run()

    clean = drain(Metrics())
    plan = flt.FaultPlan([flt.FaultSpec(
        "producer.commit", flt.FaultKind.RING_CORRUPTION, at=2,
        producer_idx=1, param=8)], seed=0)
    m = Metrics()
    with recorder.armed(directory=str(tmp_path / "flight")) as rec, \
            flt.armed(plan):
        got = drain(m)
    assert plan.fired and m.counter("integrity.replays") == 1
    assert all(torch.equal(a, b) for a, b in zip(got, clean))
    named = []
    for p in rec.dumped_paths:
        with open(p) as f:
            d = json.load(f)
        if d["window"]["seq"] is not None:
            named.append(d)
    assert [(d["reason"], d["window"]) for d in named] == [
        ("integrity.corrupt_window", {"producer_idx": 1, "seq": 1})]


# -- the other model families (MoE, ViT) ---------------------------------------


@pytest.mark.flash
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T", [196, 1000])
def test_noncausal_kernels_match_plain(dtype, D, T):
    """K1-K3 with ``causal=False`` at ``H == Hkv`` (the ViT's attention:
    T = 196 is ViT-B/16's patch count, whose dK/dV query tiles end in a
    4-row tail) against the plain version through autograd; bf16 on the
    wgmma kernels, whose tile counters show every tile pair loaded (no
    causal skip)."""
    dt = getattr(torch, dtype)
    H = 4
    q, k, v, g_out, g_lse = _inputs(17, 2, T, T, H, H, D)

    def run(fn):
        ts = [torch.tensor(x, device="cuda").to(dt).requires_grad_(True)
              for x in (q, k, v)]
        out, lse = fn(*ts)
        loss = (out.float() * torch.tensor(g_out, device="cuda")).sum() + (
            lse * torch.tensor(g_lse, device="cuda")).sum()
        loss.backward()
        return [t.detach().float() for t in (out, lse, *(x.grad for x in ts))]

    tfa.reset_launch_counts()
    got = run(lambda a, b, c: tfa.flash_attention_with_lse(a, b, c, 0, 0, False, 1))
    wgmma = 1 if dtype == "bfloat16" else 0
    assert [(fn.launches, fn.sm90_launches) for fn in tfa.KERNELS[:3]] == [
        (1, wgmma)] * 3
    want = run(lambda a, b, c: tfa.attention_plain(a, b, c, 0, 0, False, 1))
    out_tol, grad_tol = (1e-4, 1e-4) if dtype == "float32" else (2e-2, 2e-2)
    assert float((got[0] - want[0]).abs().max()) <= out_tol
    assert float((got[1] - want[1]).abs().max()) <= 1e-3
    for g, w in zip(got[2:], want[2:]):
        assert float((g - w).norm()) <= grad_tol * float(w.norm())
    if dtype == "bfloat16":
        ts = [torch.tensor(x, device="cuda").bfloat16() for x in (q, k, v)]
        zeros = torch.zeros(2, T, dtype=torch.int32)
        visited = torch.zeros(1, dtype=torch.int64, device="cuda")
        tfa.flash_fwd(*ts, 0, 0, False, visited=visited)
        every = 2 * H * math.ceil(T / 128) ** 2
        assert int(visited) == H * int(tfa.live_tiles(
            zeros, zeros, causal=False).sum()) == every
        inputs = _dkv_inputs(17, 2, T, T, H, H, D, 0, 0, False)
        visited.zero_()
        tfa.flash_bwd_dkv(*inputs, 0, 0, False, visited=visited)
        assert int(visited) == H * int(tfa.live_tiles_dkv(
            zeros, zeros, causal=False).sum()) == (
                2 * H * math.ceil(T / 128) * math.ceil(T / 64))


def _loss_grads(loss_of, params):
    leaves = [t.detach().clone().requires_grad_(True)
              for t in _tree_leaves(params)]
    it = iter(leaves)
    tree = _tree_map(lambda _: next(it), params)
    loss = loss_of(tree)
    loss.backward()
    return float(loss.detach()), [t.grad for t in leaves]


def _tree_leaves(tree):
    from ddl_tpu_torch.parallel.train import tree_leaves

    return tree_leaves(tree)


def _tree_map(fn, tree):
    from ddl_tpu_torch.parallel.train import tree_map

    return tree_map(fn, tree)


@pytest.mark.flash
@pytest.mark.parametrize("impl", ["einsum", "ragged"])
def test_moe_layer_through_the_kernels(impl):
    """One fp32 MoE layer at a small width (binding capacity for the
    einsum impl) through K1-K3 against the dense path: loss within 1e-5
    relative, every gradient within 1e-4, one launch of each kernel."""
    from ddl_tpu_torch.models import moe

    cfg = moe.MoeConfig(vocab=512, d_model=256, n_layers=1, n_heads=4,
                        n_kv_heads=2, d_ff=512, n_experts=4,
                        capacity_factor=0.5, moe_impl=impl,
                        dtype=torch.float32, attn_impl="flash")
    params = moe.init_params(cfg, seed=0, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 200), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(3))
    tfa.reset_launch_counts()
    lf, gf = _loss_grads(lambda p: moe.next_token_loss(p, tokens, cfg), params)
    assert [fn.launches for fn in tfa.KERNELS] == [1, 1, 1, 0, 0, 0]
    ld, gd = _loss_grads(lambda p: moe.next_token_loss(
        p, tokens, dataclasses.replace(cfg, attn_impl="dense")), params)
    assert abs(lf - ld) <= 1e-5 * abs(ld)
    for a, b in zip(gf, gd):
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-12


@pytest.mark.flash
def test_vit_layer_through_noncausal_kernels():
    """A one-layer bf16 ViT on 224 x 224 images in 16 x 16 patches (T =
    196, head_dim 64) through the non-causal wgmma kernels: one launch of
    each of K1-K3 on the wgmma route, finite logits and gradients close
    to the dense path's."""
    from ddl_tpu_torch.models import vit

    cfg = vit.ViTConfig(image_size=224, patch_size=16, d_model=256,
                        n_layers=1, n_heads=4, d_ff=512, n_classes=10,
                        dtype=torch.bfloat16)
    params = vit.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    pixels = torch.rand((4, 224 * 224 * 3), device="cuda", generator=gen)
    labels = torch.randint(0, 10, (4, 1), device="cuda", generator=gen).float()
    tfa.reset_launch_counts()
    lf, gf = _loss_grads(lambda p: vit.classification_loss(
        p, (pixels, labels), cfg), params)
    assert [(fn.launches, fn.sm90_launches) for fn in tfa.KERNELS[:3]] == [
        (1, 1)] * 3
    ld, gd = _loss_grads(lambda p: vit.classification_loss(
        p, (pixels, labels), dataclasses.replace(cfg, attn_impl="dense")), params)
    assert np.isfinite(lf) and abs(lf - ld) <= 2e-2 * abs(ld)
    for a, b in zip(gf, gd):
        assert torch.isfinite(a).all()
        assert float((a - b).norm()) <= 5e-2 * float(b.norm()) + 1e-12


# -- the cluster ladder on the card -------------------------------------------


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_host_kill_under_windows_on_the_alias_route(mode):
    """Two mock hosts under ``windows(lookahead=2)`` onto cuda:0 on the
    staged alias route; host 1 is killed after the 4th window (its
    thread's ring shut, or its process terminated).  Every window is its
    shard's bytes, all four shards are served, every window took the
    alias route with no fallback, the watchdog neither failed nor
    respawned, and at teardown every page-locked ring was unlocked once
    (the terminated producer's included)."""
    from torch_cluster_producers import (
        N_SHARDS,
        ROWS,
        VALS,
        ShardRangeProducer,
        shard_pattern,
    )

    from ddl_tpu_torch import cluster as tcl
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import host_register
    from ddl_tpu_torch.watchdog import Watchdog

    m = Metrics()
    unlocked = []
    real_unlock = host_register.page_unlock

    def unlock(ring):
        unlocked.append(ring)
        real_unlock(ring)

    host_register.page_unlock = unlock

    @ddl_tpu_torch.distributed_dataloader(n_producers=2, mode=mode)
    def run(env):
        sup = tcl.ClusterSupervisor(tcl.ClusterView.bootstrap(
            [tcl.HostInfo(0, loader_ranks=(1,), trainer_ranks=(0,)),
             tcl.HostInfo(1, loader_ranks=(2,))], n_shards=N_SHARDS),
            lease_s=60.0, metrics=m)
        elastic = tcl.ElasticCluster(sup, workers=env.workers, metrics=m)
        loader = ddl_tpu_torch.DistributedDataLoader(
            ShardRangeProducer({1: ((0, 2),), 2: ((2, 4),)}),
            batch_size=ROWS, connection=env.connection, n_epochs=12,
            output="device", device="cuda", metrics=m, cluster=elastic)
        wd = Watchdog(env.workers, poll_interval_s=0.05, respawn=True,
                      metrics=m, cluster=sup).start()
        seen = {}
        try:
            for i, win in enumerate(loader.windows(lookahead=2)):
                assert win.device.type == "cuda"
                arr = win.cpu().numpy().reshape(ROWS, VALS)
                shard = int(arr[0, 0] // 1000)
                np.testing.assert_array_equal(arr, shard_pattern(shard))
                seen[shard] = seen.get(shard, 0) + 1
                loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
                if i == 3:
                    elastic.kill_host(1)
        finally:
            wd.stop()
        return seen, sup, list(env.connection.rings)

    try:
        seen, sup, rings = run()
    finally:
        host_register.page_unlock = real_unlock
    assert sorted(seen) == list(range(N_SHARDS)) and sum(seen.values()) == 12
    assert sup.lost_ranks() == frozenset({2}) and sup.view.epoch == 1
    assert m.counter("cluster.host_losses") == 1.0
    assert m.counter("consumer.pool_updates") >= 2.0
    assert m.counter("watchdog.failures") == 0.0
    assert m.counter("watchdog.respawns") == 0.0
    assert m.counter("consumer.windows") == 12
    assert m.counter("staging.alias_windows") == 12
    for c in ("staging.alias_fallbacks", "staging.inline_fallbacks",
              "staging.pool_alias_drops", "integrity.corrupt_windows"):
        assert m.counter(c) == 0, c
    if mode == "process":
        assert m.counter("ingest.registered_rings") == 2
        assert sorted(map(id, unlocked)) == sorted(map(id, rings))
        assert not any(r.page_locked for r in rings)


def test_two_loaders_under_one_admission_controller_on_the_alias_route():
    """Two THREAD loaders stream ``windows()`` onto cuda:0 at once through
    one ``AdmissionController``: a budgeted tenant (4 windows a second
    after its first full second) and an unbudgeted one.  Every window is
    its producer's bytes and takes the staged alias route; the budgeted
    tenant's charged bytes stay within its token bucket's bound
    (budget x (wall + 1 s) + one window), its wall at least the budget's
    floor, and the unbudgeted tenant finishes first."""
    import threading
    import time

    from torch_recovery_producers import TagProducer

    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.serve import AdmissionController, TenantSpec

    m = Metrics()
    ctl = AdmissionController(metrics=m)
    window = 16 * 4 * 4
    n = {"hog": 12, "meek": 6}
    budget = 4.0 * window
    tenants = {"hog": ctl.register(TenantSpec("hog",
                                              byte_budget_per_s=budget)),
               "meek": ctl.register(TenantSpec("meek"))}
    got, walls, errors = {}, {}, []

    def run(name):
        lm = Metrics()

        @ddl_tpu_torch.distributed_dataloader(n_producers=1, mode="thread")
        def main(env):
            loader = ddl_tpu_torch.DistributedDataLoader(
                TagProducer(fault_at=0), batch_size=16,
                connection=env.connection, n_epochs=n[name],
                output="device", device="cuda", metrics=lm)
            tenants[name].bind(loader)
            t0 = time.monotonic()
            out = []
            for win in loader.windows():
                out.append(win.cpu().numpy().copy())
                loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
            torch.cuda.synchronize()
            walls[name] = time.monotonic() - t0
            return out

        try:
            got[name] = main()
            got[name + ".alias"] = lm.counter("staging.alias_windows")
        except Exception as e:  # ddl-lint: disable=DDL007 - a worker thread: asserted in the main thread
            errors.append((name, repr(e)))

    threads = [threading.Thread(target=run, args=(k,)) for k in n]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert errors == []
    for name, count in n.items():
        tags = [float(w[0, 0, 0]) for w in got[name]]
        assert tags == [float(k) for k in range(1, count + 1)]
        assert all((w == w[0, 0, 0]).all() for w in got[name])
        assert got[name + ".alias"] == count
        assert m.counter(f"ingest.{name}.windows") == count
    charged = m.counter("ingest.hog.bytes")
    assert charged == n["hog"] * window
    assert charged <= budget * (walls["hog"] + 1.0) + window
    # The last grant waits for the bucket to refill what the first full
    # second and one overshooting window did not cover (10 % slack for
    # the clock reads around the stream).
    assert walls["hog"] >= 0.9 * (n["hog"] * window - budget - window) / budget
    assert walls["meek"] < walls["hog"]


def test_set_depth_on_a_live_card_prefetch_iterator():
    """A card ``PrefetchIterator`` retuned mid-stream through
    ``set_depth`` (and the tune seam's ``prefetch_knob``): the transfers
    in flight follow the new depth at the next fill, and the batches on
    cuda:0 equal the host batches in order."""
    from ddl_tpu_torch.ingest import DeviceIngestor, PrefetchIterator
    from ddl_tpu_torch.tune import prefetch_knob

    ing = DeviceIngestor(device="cuda")
    batches = [np.full((64, 32), i, np.float32) for i in range(24)]
    it = PrefetchIterator(iter(batches),
                          lambda b: ing.hand_off(ing.put_window(b)),
                          depth=1, ingestor=ing)
    knob = prefetch_knob(it)
    out, depths = [], []
    for i, dev in enumerate(it):
        assert dev.device.type == "cuda"
        out.append(dev.cpu().numpy())
        depths.append(len(it._queue))
        if i == 4:
            knob.write(6)
        if i == 14:
            it.set_depth(2)
    assert all(np.array_equal(a, b) for a, b in zip(out, batches))
    assert len(out) == len(batches)
    # Depth 1 keeps nothing queued past the head; depth 6 five; after
    # the shrink to 2 the queue drains (no transfer is cancelled) down to
    # one, then the tail of the stream empties it.
    assert depths == [0] * 5 + [5] * 10 + [4, 3, 2] + [1] * 5 + [0]
    assert it._depth == 2

