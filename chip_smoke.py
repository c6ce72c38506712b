#!/usr/bin/env python3
"""Drive the ddl_tpu_torch port on one NVIDIA card and check it.

    python3 chip_smoke.py            # the phases below
    python3 chip_smoke.py --profile  # + a torch.profiler breakdown of each fit,
                                     # of a device-fabric drain and of an ICI drain

Phase 1 builds the hand-written CUDA kernels from the sources in this
checkout (``ddl_tpu_torch/ops/csrc``, one ``nvcc`` per source, all
started together), the host-registration library beside them and the
native shared-memory ring (``g++``, ``transport/csrc/shm_ring.cpp``),
and identifies the card.
Phase 2 holds each kernel against its plain PyTorch version at the main
path's attention shapes (plus a ragged length, fp32, a call whose query
rows are all masked, and bf16 at head dims 16, 32 and 64), times kernel,
plain version and the PyTorch library call, and computes each kernel's
bound.  The packed-segment kernels K4-K6 get the same treatment on
packed-document ids, plus key ids that leave some queries without a key
and one-token segments.  Every case checks the routes of the forward, the
dQ and the dK/dV backward by their counters: bf16 on the wgmma kernels
(``flash_fwd_sm90.cu``, ``flash_bwd_sm90.cu``), fp32 on the FMA kernels;
that query rows with no key get dq = 0 and keys no query reaches dk = dv
= 0 exactly.  The timed K1/K4 and K2/K5 calls run with the kernel's own
count of the key tiles it loads, the timed K3/K6 calls with its count of
the query tiles it loads: K1's, K2's and K3's are the causal loop's, K4's,
K5's and K6's what their document skip leaves, and the packed rows give
the share; each must equal the count that ``live_tiles`` /
``live_tiles_dkv`` (the skips' rules in Python) give.  Phase 1 prints
the ptxas report of every instantiation and fails if the backward's
library spills or any wgmma kernel's products are serialized.
Phase 3 checks the model's loss and gradients through the kernels
against the dense path on a small input, unpacked and packed, at head_dim
64 and at the widths of examples/train_llama.py (head_dim 32), and the remat
policies against "none" (with their forward launch counts).
Phase 4 is the global shuffle: the exchange kernel K9 held byte for
byte against its plain version (n = 2, 3, 4, 8; fp32, int32, uint8, bf16;
rows that are not a multiple of 16 bytes; an odd exchange count; the
bench geometry), timed at the bench geometry (4 instances, pools of
8192 x 256 fp32, 4096 rows exchanged), with one fabric round's parts on
the host clock, then the path: four THREAD instances in this process,
each a ``DataPusher`` over a pool producer and a
``DistributedDataLoader``, drained in turn over the host exchange, the
one-card ``DeviceExchangeFabric`` twice, and the host exchange again —
the served streams must be byte-identical, mixed across instances, with
no device fallback and one K9 launch per fabric round.
Phase 5 is the ICI ingest tier: the fan-out kernels K7 (broadcast) and K8
(scatter) held byte for byte against their plain versions (n = 2, 3, 4,
8; fp32, int32, uint8, bf16; 7-byte rows; row counts that leave the
reference's chunk pipeline a tail or undercut its chunks; src != 0;
sources off 16-byte alignment; the 2-D views the path hands them; the
full-size (65536, 256) fp32 block), timed there with the ``copy_``
yardstick, then the path: 64 MiB ``ArrayProducer`` windows (32, 2048,
256) fp32 drained in THREAD mode through ``DistributedDataLoader(...,
sharding=..., distribute="ici")`` onto three meshes of positions of
cuda:0 (dp=4 split, dp=2 x fsdp=2 split, dp=4 replicated) and a token
stream at the Llama path's window, every position's shard byte-equal to
its slice of the host window, one K7/K8 launch per window and no
fallback; a ragged geometry through the plain route; and the A/B of the
tier against the plain per-position route.
Phase 6 runs the port's two training paths at Llama-3-8B's published
widths cut to 2 layers, with random weights from a seed: ``Trainer.fit``
over a ``TokenStreamProducer`` window stream (K1-K3), then over a
``PackedTokenProducer`` stream of documents (K4-K6), each twice from the
same parameters: with THREAD producers, then with spawned PROCESS
producers over native shared-memory rings that the loader page-locks
with ``cudaHostRegister``.  Every forward, dQ and dK/dV launch of every
fit must ride the wgmma kernels; every window must take the staged
engine's alias route (its copy to the card sourcing the page-locked
slot) with no fallback, drop, CRC failure or salvage; a PROCESS fit's
rings must be native and registered, its producers must exit 0, and
its losses must equal its THREAD twin's (relative 1e-5).  Each fit
prints its wall-time ms/step and, apart, its time to the first window
(spawn and handshake included), its steady state (every step, from the
first window to the end of the last steps, on the card's clock) and its
teardown.

Phase 7 is recovery in PROCESS mode, on the token cell of phase 6 over 6
windows: a PROCESS fit, then the same fit with one producer SIGKILLed at
its second refill under ``Trainer(watchdog_respawn=True)`` — losses bit-
equal, one respawn, no failure, the same kernel launches, every window
on the alias route — and a THREAD fit with one committed slot corrupted
after its trailer was stamped (a one-shot wrapper around the ring's
commit in this script) — one replay, losses bit-equal.  Then the global
shuffle of phase 4 with PROCESS producers: four instances over one
``ShmRendezvous`` session, windows onto cuda:0 through the staged engine,
byte-identical to the THREAD tier's drain, and again with instance 0's
producer SIGKILLed mid-exchange and respawned (every round's windows
partition the rows).  It prints the recovery time, the replay's cost and
the drains.

Output: progress lines, then one JSON line ``{"kernels": [...]}``, the
card's ``name, power.limit``, and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero
without that line.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM published peaks: dense bf16 tensor rate (the main path's
#: type) and HBM bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

SEED = 0
MAIN = dict(B=4, T=2048, H=32, Hkv=8, D=128)  # the slice's attention shape
TRAIN = dict(seq_len=2048, batch_size=4, window_rows=8, n_producers=2,
             n_epochs=3, n_layers=2, n_tokens=4_000_000)
#: The global-shuffle path's geometry (bench.py's _run_shuffle_ab): 4
#: instances, pools of 8192 rows x 256 fp32 values, half of each window
#: exchanged per refill.
SHUFFLE = dict(n=4, rows=8192, cols=256, fraction=0.5, batch_size=2048,
               n_epochs=8)
#: The ICI ingest path's geometry (bench.py's ICI A/B, :74-75): an
#: ArrayProducer over 131072 x 256 fp32 values, windows of 65536 rows in
#: batches of 2048, so (32, 2048, 256) fp32 = 64 MiB a window; 4 ring
#: positions; 6 windows per mesh.  The kernels' standalone block is the
#: window's 2-D view on dim 0, (65536, 256).
ICI = dict(n=4, n_rows=131072, rows=65536, cols=256, window=65536,
           batch_size=2048, n_epochs=6)
#: Llama-3's <|end_of_text|>: the document delimiter of the packed path.
EOT = 128001
VOCAB = 128256


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailed(Exception):
    pass


# ------------------------------------------------------------- phase 1 ---

#: The kernel sources, one library each.
SOURCES = ("flash_fwd_sm90", "flash_bwd_sm90", "flash_attention",
           "device_shuffle", "ici_fanout", "host_register")
#: The wgmma sources: their ptxas report must show no serialized wgmma
#: (C7512: too few registers; C7520: a wgmma in a divergent branch), and
#: the backward's (dK/dV and dQ) no spill.  The forward's K4 at head dim
#: 128 spills a few bytes at its 168-register cap: reported, not failed.
WGMMA_SOURCES = ("flash_fwd_sm90", "flash_bwd_sm90")
NO_SPILL_SOURCES = ("flash_bwd_sm90",)


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from ddl_tpu_torch.ops import _build
    from ddl_tpu_torch.transport import shm_ring

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        ring = pool.submit(shm_ring.build_native)
        libs = list(pool.map(_build.build, SOURCES))
        # A failed g++ build raises here: PROCESS mode must not fall back
        # to the Python ring in this run.
        log(f"[build] transport/csrc/shm_ring.cpp -> "
            f"{os.path.basename(ring.result())} (g++)")
    faults = []
    for name, lib in zip(SOURCES, libs):
        log(f"[build] {name}.cu -> {os.path.basename(lib)}")
        report = lib.parent / f"{lib.name}.log"
        if report.exists():
            for line in report.read_text().splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling entry" in line or "warning" in line):
                    log(f"[ptxas] {line.strip()}")
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", line)
                if ((name in NO_SPILL_SOURCES and spill
                     and spill.groups() != ("0", "0"))
                        or (name in WGMMA_SOURCES
                            and ("C7512" in line or "C7520" in line))):
                    faults.append(f"{name}: {line.strip()}")
    log(f"[build] {len(SOURCES) + 1} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    if faults:
        raise PhaseFailed("ptxas spills or serializes a wgmma kernel: "
                          + "; ".join(faults))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    if not card:
        raise PhaseFailed(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"[card] {card}")
    return card


# ------------------------------------------------------------- phase 2 ---

def _rand(shape, dtype, gen, device):
    import torch

    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).to(dtype)


def _time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed_tile_visits(fn, *args, rule: int):
    """``fn`` (a bf16 flash wrapper, K1-K6) timed by ``_time_ms`` with the
    kernel's tile counter on: (ms, tiles the kernel loaded per call — key
    tiles for the forward and dQ, query tiles for the dK/dV backward).
    Fails unless every call loaded ``rule`` tiles."""
    import torch

    visited = torch.zeros(1, dtype=torch.int64, device="cuda")
    reps, warmup = 10, 2
    ms = _time_ms(lambda: fn(*args, visited=visited), reps, warmup)
    total = int(visited)
    what, rule_fn = (("query tiles", "live_tiles_dkv") if "dkv" in fn.__name__
                     else ("key tiles", "live_tiles"))
    log(f"[time] {fn.__name__}: the kernel loaded {total} {what} in "
        f"{reps + warmup} calls; {rule_fn} (computed) gives {rule} a call")
    if total != (reps + warmup) * rule:
        raise PhaseFailed(f"{fn.__name__} loaded {total / (reps + warmup)} "
                          f"{what} a call, its rule says {rule}")
    return ms, total // (reps + warmup)


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def documents(n_tokens: int, seed: int = SEED):
    """A web-text-like stream of packed documents: lengths log-normal with
    median 300 tokens and sigma 1.0, clipped to [16, 8192]; bodies are
    Zipf(1.2) ranks mod the vocabulary (draws of the delimiter remapped);
    every document ends in ``EOT``.  int32, ``n_tokens`` long."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = np.zeros(0, np.int64)
    while lens.sum() < n_tokens:
        draw = rng.lognormal(np.log(300.0), 1.0, n_tokens // 300 + 16)
        lens = np.concatenate([lens, np.clip(np.rint(draw), 16, 8192)
                               .astype(np.int64)])
    ends = np.cumsum(lens) - 1
    tokens = (rng.zipf(1.2, n_tokens) - 1) % VOCAB
    tokens[tokens == EOT] = (EOT + 1) % VOCAB
    tokens[ends[ends < n_tokens]] = EOT
    return tokens.astype(np.int32)


def seg_ids(tokens):
    """Row-local segment ids of (rows, T) tokens, as PackedTokenProducer
    writes them: a new document starts after each ``EOT``."""
    import numpy as np

    seg = np.zeros_like(tokens)
    seg[:, 1:] = np.cumsum(tokens[:, :-1] == EOT, axis=1)
    return seg


def _in_segment_causal_pairs(ids) -> int:
    """(q, k) pairs with k <= q in the same segment, per head, over the
    rows of contiguous row-local ids."""
    import numpy as np

    total = 0
    for row in ids:
        _, n = np.unique(row, return_counts=True)
        total += int((n * (n + 1) // 2).sum())
    return total


def _case(name, B, Tq, Tk, H, Hkv, D, dtype, q_off, k_off, causal, tol, gen,
          seg=None):
    """One kernel-vs-plain comparison: forward out/lse, then dq/dk/dv of a
    loss that weighs both outputs (so the lse cotangent is nonzero).
    ``seg``: (query, key) segment ids, int32 on the card — the packed
    kernels K4-K6.  Rows whose every key is masked must give out = 0,
    lse = -1e30 and dq = 0; keys that no query reaches, dk = dv = 0
    exactly.  The forward, the dQ and the dK/dV backward must take their
    wgmma kernels in bf16 and the FMA kernels in fp32 (their
    ``sm90_launches`` counters).  Returns (ok, errors, kernel outputs, v)."""
    import torch

    from ddl_tpu_torch.ops import flash_attention as fa

    dev = "cuda"
    rep = H // Hkv
    q = _rand((B, Tq, H, D), dtype, gen, dev)
    k = _rand((B, Tk, Hkv, D), dtype, gen, dev)
    v = _rand((B, Tk, Hkv, D), dtype, gen, dev)
    g_out = _rand((B, Tq, H, D), torch.float32, gen, dev)
    g_lse = _rand((B, H, Tq), torch.float32, gen, dev)

    def run(f):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        out, lse = f(qq, kk, vv)
        live = lse > -1e29
        loss = (out.float() * g_out).sum() + torch.where(
            live, lse * g_lse, torch.zeros_like(lse)).sum()
        loss.backward()
        return out.detach(), lse.detach(), qq.grad, kk.grad, vv.grad

    sq, sk = seg if seg is not None else (None, None)
    routed = fa.KERNELS[:3] if seg is None else fa.KERNELS[3:]
    before = [(f.launches, f.sm90_launches) for f in routed]
    kern = run(lambda a, b, c: fa.flash_attention_with_lse(
        a, b, c, q_off, k_off, causal, rep, segment_ids=sq,
        kv_segment_ids=sk))
    route = [(f.launches - n, f.sm90_launches - m)
             for f, (n, m) in zip(routed, before)]
    want_route = [(1, 1 if dtype == torch.bfloat16 else 0)] * 3
    plain = run(lambda a, b, c: fa.attention_plain(
        a, b, c, q_off, k_off, causal, rep, sq, sk))
    torch.cuda.synchronize()
    errs = {
        "out_abs": float((kern[0].float() - plain[0].float()).abs().max()),
        "lse_abs": float((kern[1] - plain[1]).abs().max()),
    }
    for i, g in ((2, "dq"), (3, "dk"), (4, "dv")):
        errs[f"{g}_rel"] = _rel(kern[i], plain[i])
        errs[f"{g}_abs"] = float((kern[i].float() - plain[i].float()).abs().max())
    finite = all(bool(torch.isfinite(t).all()) for t in kern)
    ok = (
        finite
        and route == want_route
        and errs["out_abs"] <= tol["out"]
        and errs["lse_abs"] <= tol["lse"]
        and max(errs["dq_rel"], errs["dk_rel"], errs["dv_rel"]) <= tol["grad"]
    )
    log(f"[check] {name}: " + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
        + f" | tol out<={tol['out']} lse<={tol['lse']} grad_rel<={tol['grad']}"
        + f" finite={finite} route fwd/dq/dkv="
        + "/".join("sm90" if r[1] else "fma" for r in route)
        + f" -> {'ok' if ok else 'FAIL'}")
    # Rows with no key: the plain version's verdict, from the masks alone.
    empty = plain[1][:, 0] <= -1e29  # (B, Tq)
    if bool(empty.any()):
        lse_rows = kern[1].transpose(1, 2)[empty]
        held = (bool((lse_rows == -1e30).all())
                and float(kern[0][empty].abs().max()) == 0.0
                and float(kern[2][empty].abs().max()) == 0.0)
        log(f"[check] {name}: {int(empty.sum())} query rows with no key: "
            f"out = 0, lse = -1e30, dq = 0 -> {'ok' if held else 'FAIL'}")
        ok &= held
    # Keys that no query reaches, from the masks alone.
    allowed = torch.ones(B, Tq, Tk, dtype=torch.bool, device=dev)
    if causal:
        allowed &= ((k_off + torch.arange(Tk, device=dev))[None, :]
                    <= (q_off + torch.arange(Tq, device=dev))[:, None])
    if seg is not None:
        allowed &= sq.long()[:, :, None] == sk.long()[:, None, :]
    unreached = ~allowed.any(1)  # (B, Tk)
    del allowed
    if bool(unreached.any()):
        held = (float(kern[3][unreached].abs().max()) == 0.0
                and float(kern[4][unreached].abs().max()) == 0.0)
        log(f"[check] {name}: {int(unreached.sum())} keys no query reaches: "
            f"dk = dv = 0 exactly -> {'ok' if held else 'FAIL'}")
        ok &= held
    return ok, errs, kern, v


#: Tolerances and why.  bf16: the kernel rounds p (and ds) to bf16 before
#: its products, as the TPU kernel does, while the plain version stays in
#: fp32 — a relative error of ~2^-8 per term, so |out| <= ~3 carries ~1e-2
#: and the gradients' relative Frobenius error stays well under 2e-2; lse
#: is built from unrounded fp32 terms in both, only the summation order
#: differs.  fp32: both sides run exact fp32 products (no TF32), so only
#: the summation order differs.
TOL_BF16 = {"out": 2e-2, "lse": 1e-3, "grad": 2e-2}
TOL_F32 = {"out": 1e-4, "lse": 1e-4, "grad": 1e-4}


def phase_kernels():
    import torch

    from ddl_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    m = MAIN
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("main bf16 B=4 T=2048 H=32/8 D=128", m["B"], m["T"], m["T"], m["H"],
         m["Hkv"], m["D"], bf16, 0, 0, True, TOL_BF16),
        ("ragged bf16 T=1000", 1, 1000, 1000, m["H"], m["Hkv"], m["D"], bf16,
         0, 0, True, TOL_BF16),
        ("fp32 T=333 H=8/2 D=64", 2, 333, 333, 8, 2, 64, f32, 0, 0, True,
         TOL_F32),
        ("fp32 non-causal T=200 D=128", 1, 200, 260, 4, 4, 128, f32, 0, 0,
         False, TOL_F32),
        ("offsets q_off<k_off bf16 T=256", 1, 256, 256, m["H"], m["Hkv"],
         m["D"], bf16, 0, 100, True, TOL_BF16),
    ] + [
        # The head dims of the reference's smaller configs (16, 32) and 64.
        (f"bf16 D={d} T=300 H=8/2 q_off<k_off", 2, 300, 300, 8, 2, d, bf16,
         0, 20, True, TOL_BF16) for d in (16, 32, 64)
    ]
    ok = True
    errs_main = None
    for c in cases:
        c_ok, errs, _, _ = _case(*c, gen)
        ok &= c_ok
        if errs_main is None:
            errs_main = errs
    if not ok:
        raise PhaseFailed("a kernel disagrees with its plain version")
    rows = time_kernels(gen, errs_main)
    return rows + packed_kernels(gen, causal_tiles={
        row["name"]: row["tiles_visited"] for row in rows
        if "tiles_visited" in row})


def _ids(a):
    import torch

    return torch.tensor(a, dtype=torch.int32, device="cuda")


def packed_kernels(gen, causal_tiles):
    """K4-K6 against the plain version: (a) the main shape with ids from
    the document generator, (b) a ragged bf16 length, (c) fp32, (d) key ids
    that differ from the query ids so that some queries have no key,
    (e) every token its own segment, where out must equal the
    rep-expanded v.  Then their times at the main shape."""
    import numpy as np
    import torch

    m = MAIN
    bf16, f32 = torch.bfloat16, torch.float32
    docs = documents(m["B"] * m["T"] + 4096, seed=SEED + 1)
    main_ids = seg_ids(docs[: m["B"] * m["T"]].reshape(m["B"], m["T"]))

    def doc_ids(B, T, off):
        return seg_ids(docs[off: off + B * T].reshape(B, T))

    ids_d = doc_ids(2, 512, 100)
    keys_d = np.where(ids_d % 3 == 1, -7, ids_d)  # those documents lose their keys
    own = np.broadcast_to(np.arange(256, dtype=np.int32), (2, 256))
    cases = [
        ("(a) packed main bf16 B=4 T=2048 H=32/8 D=128", m["B"], m["T"], m["T"],
         m["H"], m["Hkv"], m["D"], bf16, 0, 0, True, TOL_BF16,
         (main_ids, main_ids)),
        ("(b) packed ragged bf16 T=1000", 1, 1000, 1000, m["H"], m["Hkv"],
         m["D"], bf16, 0, 0, True, TOL_BF16, (doc_ids(1, 1000, 7),) * 2),
        ("(c) packed fp32 T=333 H=8/2 D=64", 2, 333, 333, 8, 2, 64, f32, 0, 0,
         True, TOL_F32, (doc_ids(2, 333, 3000),) * 2),
        ("(d) packed bf16 kv ids != q ids T=512", 2, 512, 512, m["H"],
         m["Hkv"], m["D"], bf16, 0, 0, True, TOL_BF16, (ids_d, keys_d)),
        ("(e) packed bf16 one-token segments T=256", 2, 256, 256, m["H"],
         m["Hkv"], m["D"], bf16, 0, 0, True, TOL_BF16, (own, own)),
    ] + [
        (f"packed bf16 D={d} T=333 H=8/2", 2, 333, 333, 8, 2, d, bf16, 0, 0,
         True, TOL_BF16, (doc_ids(2, 333, 3000),) * 2) for d in (16, 32, 64)
    ]
    ok = True
    errs_main = None
    for *c, (sq, sk) in cases:
        c_ok, errs, kern, v = _case(*c, gen, seg=(_ids(sq), _ids(sk)))
        ok &= c_ok
        errs_main = errs_main or errs
        if c[0].startswith("(d)"):
            n_empty = int(np.isin(sq, sk, invert=True).sum())
            log(f"[check] (d): {n_empty} queries' documents have no key")
            ok &= n_empty > 0
        if c[0].startswith("(e)"):
            want = v.float().repeat_interleave(c[4] // c[5], dim=2)
            err = float((kern[0].float() - want).abs().max())
            log(f"[check] (e): out vs rep-expanded v max abs err {err:.3g} "
                f"| tol 0 -> {'ok' if err == 0.0 else 'FAIL'}")
            ok &= err == 0.0
    if not ok:
        raise PhaseFailed("a packed kernel disagrees with its plain version")
    return time_packed_kernels(gen, main_ids, errs_main, causal_tiles)


def time_kernels(gen, errs):
    """Kernel, plain and library times at the main path's shapes, with
    each kernel's bound."""
    import torch
    import torch.nn.functional as F

    from ddl_tpu_torch.ops import flash_attention as fa

    B, T, H, Hkv, D = (MAIN[k] for k in ("B", "T", "H", "Hkv", "D"))
    dt = torch.bfloat16
    rep = H // Hkv
    q = _rand((B, T, H, D), dt, gen, "cuda")
    k = _rand((B, T, Hkv, D), dt, gen, "cuda")
    v = _rand((B, T, Hkv, D), dt, gen, "cuda")
    dout = _rand((B, T, H, D), dt, gen, "cuda")
    out, lse = fa.flash_fwd(q, k, v)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dlse = torch.zeros_like(lse)

    # K1, K2 and K3 visit every tile of the causal loop: live_tiles and
    # live_tiles_dkv with one id.
    zeros = torch.zeros(B, T, dtype=torch.int32)
    causal_rule = H * int(fa.live_tiles(zeros, zeros).sum())
    fwd_ms, tiles = _timed_tile_visits(fa.flash_fwd, q, k, v, rule=causal_rule)
    dq_ms, dq_tiles = _timed_tile_visits(
        fa.flash_bwd_dq, q, k, v, dout, lse, delta, dlse, rule=causal_rule)
    dkv_ms, dkv_tiles = _timed_tile_visits(
        fa.flash_bwd_dkv, q, k, v, dout, lse, delta, dlse,
        rule=H * int(fa.live_tiles_dkv(zeros, zeros).sum()))
    ms = {"fwd": fwd_ms, "dq": dq_ms, "dkv": dkv_ms}

    # Plain versions: the dense forward, and its autograd backward asked
    # for dq alone (K2's function) or for dk, dv (K3's).
    def plain_graph():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        o, _ = fa.attention_plain(qq, kk, vv, kv_repeat=rep)
        return o, qq, kk, vv

    plain_ms = {"fwd": _time_ms(lambda: fa.attention_plain(q, k, v, kv_repeat=rep),
                                reps=5)}
    o, qq, kk, vv = plain_graph()
    plain_ms["dq"] = _time_ms(lambda: torch.autograd.grad(
        o, qq, dout, retain_graph=True), reps=5)
    plain_ms["dkv"] = _time_ms(lambda: torch.autograd.grad(
        o, (kk, vv), dout, retain_graph=True), reps=5)
    del o, qq, kk, vv
    torch.cuda.empty_cache()

    # The library yardstick: one scaled_dot_product_attention call on the
    # same inputs (timed here only; the port never calls it).
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_fwd = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    qs, ks_, vs = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
    so = F.scaled_dot_product_attention(qs, ks_, vs, is_causal=True,
                                        enable_gqa=True)
    sdpa_bwd = _time_ms(lambda: torch.autograd.grad(
        so, (qs, ks_, vs), dout.transpose(1, 2), retain_graph=True))
    del so, qs, ks_, vs

    # Bounds from this run's shapes: causal pairs (q, k) with k <= q.
    pairs = B * H * T * (T + 1) // 2
    isz = 2
    rows = B * H * T * 4  # one fp32 row statistic
    n_q, n_kv = B * T * H * D * isz, B * T * Hkv * D * isz
    work = {
        # flops, bytes (each input read once, each output written once)
        "fwd": (4 * D * pairs, n_q + 2 * n_kv + n_q + rows),
        "dq": (6 * D * pairs, n_q + 2 * n_kv + n_q + 3 * rows + n_q),
        "dkv": (8 * D * pairs, n_q + 2 * n_kv + n_q + 3 * rows + 2 * n_kv),
    }
    info = {
        "fwd": ("flash_fwd", "_fwd_kernel", 97),
        "dq": ("flash_bwd_dq", "_dq_kernel", 251),
        "dkv": ("flash_bwd_dkv", "_dkv_kernel", 287),
    }
    rows_out = _kernel_rows(info, work, errs, ms, plain_ms, library_fwd,
                            {"fwd": {"tiles_visited": tiles},
                             "dq": {"tiles_visited": dq_tiles},
                             "dkv": {"tiles_visited": dkv_tiles}})
    log(f"[time] sdpa backward (dq, dk, dv together): {sdpa_bwd:.3f} ms")
    return rows_out


def _bound(flops, nbytes):
    """(bound ms, what bounds it) on the H100's published peaks."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _kernel_rows(info, work, errs, ms, plain_ms, library_fwd, extra=None):
    """The kernels-JSON rows of one fwd/dq/dkv triple.  ``max_abs_err`` is
    the largest elementwise difference from the plain version in the main
    case, ``rel_err`` (backward) the relative Frobenius error the check
    holds.  The bf16 forward and backward kernels are the wgmma kernels of
    their own sources."""
    abs_err = {"fwd": errs["out_abs"], "dq": errs["dq_abs"],
               "dkv": max(errs["dk_abs"], errs["dv_abs"])}
    rel_err = {"fwd": None, "dq": errs["dq_rel"],
               "dkv": max(errs["dk_rel"], errs["dv_rel"])}
    rows_out = []
    for key in ("fwd", "dq", "dkv"):
        bound_ms, bound_by = _bound(*work[key])
        name, tpu_fn, line = info[key]
        rows_out.append({
            "name": name,
            "route": "cuda",
            "source": "ddl_tpu_torch/ops/csrc/" + {
                "fwd": "flash_fwd_sm90.cu", "dq": "flash_bwd_sm90.cu",
                "dkv": "flash_bwd_sm90.cu"}[key],
            "replaces": f"ddl_tpu/ops/flash_attention.py:{line} ({tpu_fn})",
            "launches": 0,
            "max_abs_err": abs_err[key],
            "rel_err": rel_err[key],
            "ms": ms[key],
            "plain_ms": plain_ms[key],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_fwd if key == "fwd" else None,
            **(extra.get(key, {}) if extra else {}),
        })
        log(f"[time] {name}: {ms[key]:.3f} ms  plain {plain_ms[key]:.3f} ms  "
            f"bound {bound_ms:.4f} ms ({bound_by})"
            + (f"  causal-only bound {extra[key]['causal_bound_ms']:.4f} ms"
               if extra and key in extra and "causal_bound_ms" in extra[key]
               else "")
            + (f"  {'query' if key == 'dkv' else 'key'} tiles loaded "
               f"{extra[key]['tiles_visited']} (counted)"
               if extra and key in extra and "tiles_visited" in extra[key]
               else "")
            + (f"  sdpa {library_fwd:.3f} ms" if key == "fwd" else ""))
    return rows_out


def time_packed_kernels(gen, ids_np, errs, causal_tiles):
    """K4-K6's kernel, plain and library times at the main shape on the
    packed-document ids of case (a), with the bound of the in-segment
    causal pairs (the work these ids need) and, beside it, the causal-only
    bound (the work of every causal tile).  K4's and K5's key tiles and
    K6's query tiles loaded, counted by the kernels, over ``causal_tiles``
    (by unpacked wrapper name), those K1, K2 and K3 loaded at the same
    shape."""
    import torch
    import torch.nn.functional as F

    from ddl_tpu_torch.ops import flash_attention as fa

    B, T, H, Hkv, D = (MAIN[k] for k in ("B", "T", "H", "Hkv", "D"))
    dt = torch.bfloat16
    rep = H // Hkv
    q = _rand((B, T, H, D), dt, gen, "cuda")
    k = _rand((B, T, Hkv, D), dt, gen, "cuda")
    v = _rand((B, T, Hkv, D), dt, gen, "cuda")
    dout = _rand((B, T, H, D), dt, gen, "cuda")
    sid = _ids(ids_np)
    out, lse = fa.flash_fwd_seg(q, k, v, sid, sid)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dlse = torch.zeros_like(lse)
    live_rule = H * int(fa.live_tiles(sid, sid).sum())
    fwd_ms, tiles = _timed_tile_visits(fa.flash_fwd_seg, q, k, v, sid, sid,
                                       rule=live_rule)
    dq_ms, dq_tiles = _timed_tile_visits(
        fa.flash_bwd_dq_seg, q, k, v, dout, lse, delta, dlse, sid, sid,
        rule=live_rule)
    dkv_ms, dkv_tiles = _timed_tile_visits(
        fa.flash_bwd_dkv_seg, q, k, v, dout, lse, delta, dlse, sid, sid,
        rule=H * int(fa.live_tiles_dkv(sid, sid).sum()))
    ms = {"fwd": fwd_ms, "dq": dq_ms, "dkv": dkv_ms}

    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    plain_ms = {"fwd": _time_ms(lambda: fa.attention_plain(
        q, k, v, kv_repeat=rep, seg_q=sid, seg_k=sid), reps=5)}
    o, _ = fa.attention_plain(qq, kk, vv, kv_repeat=rep, seg_q=sid, seg_k=sid)
    plain_ms["dq"] = _time_ms(lambda: torch.autograd.grad(
        o, qq, dout, retain_graph=True), reps=5)
    plain_ms["dkv"] = _time_ms(lambda: torch.autograd.grad(
        o, (kk, vv), dout, retain_graph=True), reps=5)
    del o, qq, kk, vv
    torch.cuda.empty_cache()

    # The library yardstick: one scaled_dot_product_attention call with a
    # boolean (B, 1, T, T) mask, causal AND same segment (timed here only;
    # the port never calls it).
    pos = torch.arange(T, device="cuda")
    mask = ((pos[None, :] <= pos[:, None])[None]
            & (sid[:, :, None] == sid[:, None, :]))[:, None]
    # k/v go in expanded to the query heads (outside the timed call): the
    # masked call then takes SDPA's memory-efficient kernel, not its math
    # fallback.
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(rep, dim=2).transpose(1, 2) for t in (k, v))
    library_fwd = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    qs, ks_, vs = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
    so = F.scaled_dot_product_attention(qs, ks_, vs, attn_mask=mask)
    sdpa_bwd = _time_ms(lambda: torch.autograd.grad(
        so, (qs, ks_, vs), dout.transpose(1, 2), retain_graph=True))
    del so, qs, ks_, vs, mask

    pairs = H * _in_segment_causal_pairs(ids_np)
    causal_pairs = B * H * T * (T + 1) // 2
    isz = 2
    rows = B * H * T * 4
    n_q, n_kv = B * T * H * D * isz, B * T * Hkv * D * isz
    n_ids = 2 * B * T * 4  # the two int32 id arrays

    def work_of(p):
        return {
            "fwd": (4 * D * p, n_q + 2 * n_kv + n_ids + n_q + rows),
            "dq": (6 * D * p, n_q + 2 * n_kv + n_q + 3 * rows + n_ids + n_q),
            "dkv": (8 * D * p, n_q + 2 * n_kv + n_q + 3 * rows + n_ids + 2 * n_kv),
        }

    causal = work_of(causal_pairs)
    extra = {key: {"causal_bound_ms": _bound(*causal[key])[0],
                   "in_segment_pairs": pairs, "causal_pairs": causal_pairs}
             for key in causal}
    # The tile skips on these ids, as the kernels counted them: the key
    # tiles K4 and K5 loaded against those K1 and K2 loaded at this shape,
    # the query tiles K6 loaded against K3's.
    for key, n, unpacked in (("fwd", tiles, "flash_fwd"),
                             ("dq", dq_tiles, "flash_bwd_dq"),
                             ("dkv", dkv_tiles, "flash_bwd_dkv")):
        extra[key].update(tiles_visited=n,
                          causal_tiles=causal_tiles[unpacked],
                          visited_share=n / causal_tiles[unpacked])
    log(f"[time] packed ids: {pairs} in-segment causal pairs of "
        f"{causal_pairs} causal ({pairs / causal_pairs:.3%}); K4 loaded "
        f"{tiles} of the {causal_tiles['flash_fwd']} key tiles K1 loaded "
        f"({tiles / causal_tiles['flash_fwd']:.3%}); K5 loaded {dq_tiles} "
        f"of the {causal_tiles['flash_bwd_dq']} key tiles K2 loaded "
        f"({dq_tiles / causal_tiles['flash_bwd_dq']:.3%}); K6 loaded {dkv_tiles} "
        f"of the {causal_tiles['flash_bwd_dkv']} query tiles K3 loaded "
        f"({dkv_tiles / causal_tiles['flash_bwd_dkv']:.3%})")
    info = {
        "fwd": ("flash_fwd_seg", "_fwd_kernel_seg", 334),
        "dq": ("flash_bwd_dq_seg", "_dq_kernel_seg", 340),
        "dkv": ("flash_bwd_dkv_seg", "_dkv_kernel_seg", 347),
    }
    rows_out = _kernel_rows(info, work_of(pairs), errs, ms, plain_ms,
                            library_fwd, extra)
    log(f"[time] sdpa masked backward (dq, dk, dv together): {sdpa_bwd:.3f} ms")
    return rows_out


# ------------------------------------------------------------- phase 3 ---

def _loss_and_grads(params, tokens, cfg, seg=None):
    """Loss and every parameter gradient, from fresh leaves."""
    from ddl_tpu_torch.models import llama

    leaves = [t.detach().clone().requires_grad_(True) for t in _leaves(params)]
    tree = _rebuild(params, iter(leaves))
    loss = llama.next_token_loss(tree, tokens, cfg, segment_ids=seg)
    loss.backward()
    return float(loss.detach()), [t.grad for t in leaves]


def phase_model_check():
    """The model's loss and every gradient through the kernels against the
    dense path on a small fp32 input (the repo's own oracle), unpacked
    and with packed-document ids, at head_dim 64 and at the widths of
    ``examples/train_llama.py`` (d_model 128, 4 heads, 2 KV heads, d_ff
    256, so head_dim 32); then each remat policy against
    "none" on the packed input, with its forward launch counts."""
    import numpy as np
    import torch

    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.ops import flash_attention as fa

    cfg = llama.LlamaConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=512, dtype=torch.float32,
                            attn_impl="flash")
    params = llama.init_params(cfg, seed=SEED, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 200), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    # Documents of ~40 tokens: a delimiter ends a document w.p. 1/40.
    ends = np.random.default_rng(SEED).random((2, 200)) < 1 / 40
    seg_np = np.zeros((2, 200), np.int64)
    seg_np[:, 1:] = np.cumsum(ends[:, :-1], axis=1)
    seg = torch.tensor(seg_np, device="cuda")
    example = dataclasses.replace(cfg, d_model=128, d_ff=256)
    example_params = llama.init_params(example, seed=SEED, device="cuda")
    for c, p in ((cfg, params), (example, example_params)):
        for label, ids in (("unpacked", None), ("packed", seg)):
            (l_f, g_f), (l_d, g_d) = (
                _loss_and_grads(p, tokens,
                                dataclasses.replace(c, attn_impl=impl), ids)
                for impl in ("flash", "dense"))
            worst = max(_rel(a, b) for a, b in zip(g_f, g_d))
            ok = abs(l_f - l_d) <= 1e-5 * abs(l_d) and worst <= 1e-4
            log(f"[check] llama fp32 head_dim {c.head_dim} {label} flash vs "
                f"dense: loss {l_f:.6f} vs {l_d:.6f}, worst grad rel err "
                f"{worst:.3g} | tol loss rel<=1e-5 grad rel<=1e-4 -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailed(f"{label} model at head_dim {c.head_dim} "
                                  "through the kernels disagrees with the "
                                  "dense path")

    # Forward kernel launches per layer: the backward re-runs attention
    # under "full" and "dots", never under "selective".
    fwd_per_layer = {"none": 1, "selective": 1, "full": 2, "dots": 2}
    base = None
    for policy, n in fwd_per_layer.items():
        fa.reset_launch_counts()
        loss, grads = _loss_and_grads(
            params, tokens, dataclasses.replace(cfg, remat=policy), seg)
        torch.cuda.synchronize()
        counts = [fn.launches for fn in fa.KERNELS]
        base = base or (loss, grads)
        worst = max(_rel(a, b) for a, b in zip(grads, base[1]))
        want = [0, 0, 0, cfg.n_layers * n, cfg.n_layers, cfg.n_layers]
        ok = (abs(loss - base[0]) <= 1e-6 * abs(base[0]) and worst <= 1e-6
              and counts == want)
        log(f"[check] remat={policy}: loss {loss:.6f}, worst grad rel err vs "
            f"none {worst:.3g}, launches K1-K6 {counts} (expected {want}) "
            f"| tol rel<=1e-6 -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailed(f"remat={policy} disagrees with remat=none")


def _leaves(tree):
    from ddl_tpu_torch.parallel.train import tree_leaves

    return tree_leaves(tree)


def _rebuild(tree, it):
    from ddl_tpu_torch.parallel.train import tree_map

    return tree_map(lambda _: next(it), tree)


# ------------------------------------------------------------- phase 4 ---

def _bytes(t):
    """A tensor's bytes, for byte-exact comparisons whatever its dtype."""
    import torch

    return t.contiguous().view(torch.uint8)


def _exchange_case(n, rows, num_exchange, cols, dtype, gen, normal=False):
    """The global input of one round: n pools of ``rows`` rows on the
    card, of which each contributes its first ``2 * half`` rows (an odd
    ``num_exchange`` leaves its last exchange row at home).  Random bytes,
    or standard-normal values (``normal``, as the path's pools hold)."""
    import torch

    half = num_exchange // 2
    if normal:
        pools = torch.randn((n, rows, cols), generator=gen, device="cuda",
                            dtype=torch.float32).to(dtype)
    else:
        isz = torch.empty(0, dtype=dtype).element_size()
        pools = torch.randint(0, 256, (n, rows, cols * isz), generator=gen,
                              device="cuda", dtype=torch.uint8).view(dtype)
    return pools[:, :2 * half].reshape(n * 2 * half, cols).contiguous()


def _routes(n, round_):
    import numpy as np

    from ddl_tpu_torch.shuffle import exchange_permutation, inverse_permutation

    p = exchange_permutation(n, SEED, round_)
    return p, np.stack([p, inverse_permutation(p)])


def _time_cold_ms(fn, flush, reps: int = 31, warmup: int = 5) -> float:
    """Median device time of ``fn`` with the L2 cache flushed before each
    call (the exchange's 32 MiB of traffic fits the 50 MB L2, which the
    path's freshly landed input would not find warm).  The flush must
    keep the card busy for longer than ``fn``'s host work, so that the
    start event does not time the card waiting for the launch."""
    import torch

    times = []
    for i in range(warmup + reps):
        flush()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def shuffle_kernel_checks():
    """K9 against its plain version, byte for byte, then its times at the
    bench geometry.  Returns the kernels-JSON row (launches filled in by
    the path)."""
    import torch

    from ddl_tpu_torch.ops import device_shuffle as dsh

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    f32, i32, u8, bf16 = torch.float32, torch.int32, torch.uint8, torch.bfloat16
    sh = SHUFFLE
    cases = [(f"n={n} fp32 x 256", n, 64, 64, 256, f32) for n in (2, 3, 4, 8)]
    cases += [
        ("odd num_exchange 7 of 16 rows, n=2, fp32 x 3", 2, 16, 7, 3, f32),
        ("12-byte rows (fp32 x 3), n=5", 5, 9, 5, 3, f32),
        ("10-byte rows (bf16 x 5), n=3", 3, 10, 10, 5, bf16),
        ("7-byte rows (uint8 x 7), n=8", 8, 12, 6, 7, u8),
        ("132-byte rows (int32 x 33), n=4", 4, 40, 22, 33, i32),
        ("int32 x 256, n=4", 4, 64, 64, 256, i32),
        ("uint8 x 256, n=4", 4, 64, 64, 256, u8),
        ("bf16 x 256, n=4", 4, 64, 64, 256, bf16),
        ("uint8 x 1000 (one lane of 2 rows), n=3", 3, 5, 5, 1000, u8),
    ]
    ok = True
    for i, (label, n, rows, nex, cols, dt) in enumerate(cases):
        gin = _exchange_case(n, rows, nex, cols, dt, gen)
        before = _bytes(gin).clone()
        _, routes = _routes(n, i)
        got = dsh.exchange_ring(gin, ["cuda:0"] * n, routes)
        want = dsh.exchange_plain(gin, routes)
        torch.cuda.synchronize()
        same = torch.equal(_bytes(got), _bytes(want))
        kept = torch.equal(_bytes(gin), before)
        log(f"[check] K9 {label}: byte-equal to plain {same}, input kept "
            f"{kept} -> {'ok' if same and kept else 'FAIL'}")
        ok &= same and kept

    n, half, cols = sh["n"], sh["rows"] // 2 // 2, sh["cols"]
    nex = int(sh["rows"] * sh["fraction"])
    gin = _exchange_case(n, sh["rows"], nex, cols, f32, gen, normal=True)
    _, routes = _routes(n, 0)
    devs = ["cuda:0"] * n
    got = dsh.exchange_ring(gin, devs, routes)
    want = dsh.exchange_plain(gin, routes)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    same = torch.equal(_bytes(got), _bytes(want))
    log(f"[check] K9 bench n={n} {sh['rows']}x{cols} fp32, num_exchange "
        f"{nex}: byte-equal {same}, max abs err {err} | tol 0 -> "
        f"{'ok' if same else 'FAIL'}")
    ok &= same
    if not ok:
        raise PhaseFailed("K9 disagrees with its plain version")

    # The library yardstick: two index_copy_ calls on precomputed indices
    # (timed here only; nothing in the port runs them).
    rows = 2 * half
    g = gin.view(n, rows, cols)
    out = torch.empty_like(g)
    r = torch.as_tensor(routes, dtype=torch.long, device="cuda")

    def library():
        out[:, :half].index_copy_(0, r[0], g[:, :half])
        out[:, half:].index_copy_(0, r[1], g[:, half:])

    # 1 GiB: ~0.3 ms of writes, several times the wrapper's host work.
    scratch = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    ms = _time_cold_ms(lambda: dsh.exchange_ring(gin, devs, routes), flush)
    plain_ms = _time_cold_ms(lambda: dsh.exchange_plain(gin, routes), flush)
    library_ms = _time_cold_ms(library, flush)
    # Back to back, a call costs the wrapper's host work (argument checks,
    # the pointer table, the output's allocation), not the kernel's time.
    call_ms = _time_ms(lambda: dsh.exchange_ring(gin, devs, routes), reps=50,
                       warmup=5)
    library()
    torch.cuda.synchronize()
    ok = torch.equal(_bytes(out.view_as(gin)), _bytes(want))
    del scratch
    if not ok:
        raise PhaseFailed("the library yardstick disagrees with K9")
    nbytes = 2 * n * rows * cols * 4  # each byte read once, written once
    bound_ms = nbytes / PEAK_BYTES * 1e3
    log(f"[time] exchange_ring (K9): {ms:.4f} ms (L2 cold; {call_ms:.4f} ms "
        f"a call back to back)  plain {plain_ms:.4f} ms  index_copy_ x2 {library_ms:.4f} ms"
        f"  bound {bound_ms:.4f} ms (bytes, {nbytes / 2**20:.0f} MiB)")
    return {
        "name": "exchange_ring",
        "route": "cuda",
        "source": "ddl_tpu_torch/ops/csrc/device_shuffle.cu",
        "replaces": "ddl_tpu/ops/device_shuffle.py:78 (_exchange_kernel)",
        "launches": 0,
        "max_abs_err": err,
        "ms": ms,
        "back_to_back_ms": call_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
    }


class PoolProducer:
    """A producer that keeps a pool (``examples/global_shuffle.py``'s
    shape): column 0 is ``instance * 1e6 + row``, the rest seeded
    standard-normal values; each refill shuffles the rows in place,
    so exchanged rows spread through the window.  Module-level, so a
    spawned PROCESS producer unpickles it; it imports the package only
    when called, so this script still starts without it.  Its first
    incarnation SIGKILLs itself at refill ``kill_at``, once, when a
    ``sentinel`` path is given (the file records the time of the kill).
    ``fast_forward`` replays only the RNG: a respawned pusher restores
    the pool from its ring's last committed slot."""

    def __init__(self, instance_idx, rows, cols, sentinel=None, kill_at=0):
        self.instance_idx, self.rows, self.cols = instance_idx, rows, cols
        self.sentinel, self.kill_at = sentinel, kill_at
        self.refills = 0

    def on_init(self, **kw):
        import numpy as np

        from ddl_tpu_torch import DataProducerOnInitReturn

        self._rng = np.random.default_rng([SEED, self.instance_idx])
        return DataProducerOnInitReturn(
            nData=self.rows, nValues=self.cols,
            shape=(self.rows, self.cols), splits=(self.cols,))

    def post_init(self, my_ary, **kw):
        import numpy as np

        my_ary[:, 1:] = self._rng.standard_normal(
            (self.rows, self.cols - 1), dtype=np.float32)
        my_ary[:, 0] = self.instance_idx * 1e6 + np.arange(self.rows)

    def execute_function(self, my_ary, **kw):
        self.refills += 1
        if self.refills == self.kill_at:
            _kill_once(self.sentinel, self.instance_idx)
        self._rng.shuffle(my_ary)

    def fast_forward(self, n, **kw):
        import numpy as np

        dummy = np.empty((self.rows, 1), np.float32)
        for _ in range(n):
            self._rng.shuffle(dummy)
        self.refills += n


def _pool_producer_class():
    return PoolProducer


def drain_instances(factory_of):
    """Four THREAD instances in this process, one producer each, drained
    to the card: returns (served streams, pushers, drain seconds)."""
    import threading

    import torch

    from ddl_tpu_torch import DistributedDataLoader, Marker, RunMode, Topology
    from ddl_tpu_torch.datapusher import DataPusher
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.transport.connection import (
        ConsumerConnection, ProducerConnection, ThreadChannel,
    )

    sh = SHUFFLE
    Pool = _pool_producer_class()
    streams, pushers, errors = {}, {}, []

    def run_instance(i):
        try:
            topo = Topology(n_instances=sh["n"], instance_idx=i,
                            n_producers=1, mode=RunMode.THREAD)
            cons_end, prod_end = ThreadChannel.pair()
            pconn = ProducerConnection(prod_end, 1, pin_memory=True)

            def producer():
                try:
                    pushers[i] = DataPusher(pconn, topo, 1,
                                            shuffler_factory=factory_of(),
                                            metrics=Metrics())
                    pushers[i].push_data()
                except Exception as e:  # reported by the main thread
                    errors.append((f"producer {i}", repr(e)))

            pt = threading.Thread(target=producer, daemon=True)
            pt.start()
            loader = DistributedDataLoader(
                Pool(i, sh["rows"], sh["cols"]), batch_size=sh["batch_size"],
                connection=ConsumerConnection([cons_end]),
                n_epochs=sh["n_epochs"],
                global_shuffle_fraction_exchange=sh["fraction"],
                output="device", device="cuda", metrics=Metrics(),
                timeout_s=120.0,
            )
            batches = []
            for _ in range(sh["n_epochs"]):
                for (b,) in loader:
                    batches.append(b)
                    loader.mark(Marker.END_OF_BATCH)
                loader.mark(Marker.END_OF_EPOCH)
            streams[i] = torch.cat(batches)
            torch.cuda.current_stream().synchronize()
            loader.shutdown()
            pt.join(60)
            if pt.is_alive():
                errors.append((f"producer {i}", "did not exit"))
        except Exception as e:  # reported by the main thread
            errors.append((f"instance {i}", repr(e)))

    t0 = time.perf_counter()
    ts = [threading.Thread(target=run_instance, args=(i,))
          for i in range(sh["n"])]
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in ts) or errors:
        raise PhaseFailed(f"global-shuffle drain failed: {errors or 'hung'}")
    return streams, pushers, wall


def fabric_leg_parts(reps: int = 10):
    """Host-clock time of one device-fabric leg at the path's geometry,
    part by part, each part ending in a synchronise: the landing (the
    page-locked staging copy and the H2D copy), the exchange (K9), the
    hand-back (the D2H copy and the copies out to the producers).  In the
    path the landing runs into the exchange on one stream with no
    synchronise between them."""
    import numpy as np
    import torch

    from ddl_tpu_torch.ops import device_shuffle as dsh

    sh = SHUFFLE
    n, half = sh["n"], int(sh["rows"] * sh["fraction"]) // 2
    rng = np.random.default_rng(SEED)
    blocks = [rng.standard_normal((2 * half, sh["cols"]), dtype=np.float32)
              for _ in range(n)]
    devs = ["cuda:0"] * n
    _, routes = _routes(n, 0)
    parts = dict(land=[], exchange=[], hand_back=[])
    for _ in range(reps + 2):
        t0 = time.perf_counter()
        gin = dsh.as_exchange_input(blocks, devs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = dsh.exchange_ring(gin, devs, routes)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dsh.exchange_output_blocks(out, devs)
        t3 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k].append(v * 1e3)
    return {k: sorted(v[2:])[reps // 2] for k, v in parts.items()}


def phase_shuffle(profile: bool = False):
    """K9's checks and times, then the global-shuffle path: drained over
    the host exchange, the one-card device fabric, the fabric again and
    the host exchange again (turns, so neither side gains from going
    first).  Each device drain has the launch count set to 0 just before
    it and read just after."""
    import numpy as np
    import torch

    from ddl_tpu_torch.ops import device_shuffle as dsh
    from ddl_tpu_torch.shuffle import (
        DeviceExchangeFabric, DeviceExchangeShuffler, Rendezvous,
        ThreadExchangeShuffler,
    )

    row = shuffle_kernel_checks()
    sh = SHUFFLE
    n = sh["n"]
    nex = int(sh["rows"] * sh["fraction"])
    round_bytes = dsh.exchange_wire_bytes(n, nex // 2, sh["cols"], np.float32)
    leg = fabric_leg_parts()
    log(f"[shuffle] one fabric leg, median of 10 (host clock, ms): "
        f"landing {leg['land']:.3f}, K9 round {leg['exchange']:.3f}, "
        f"hand-back {leg['hand_back']:.3f}")

    def host_drain():
        rdv = Rendezvous()
        return drain_instances(lambda: ThreadExchangeShuffler.factory(rdv))

    def device_drain():
        fabric = DeviceExchangeFabric(devices=["cuda:0"] * n)
        dsh.reset_launch_counts()
        streams, pushers, wall = drain_instances(
            lambda: DeviceExchangeShuffler.factory(fabric=fabric))
        torch.cuda.synchronize()
        return streams, pushers, wall, fabric, dsh.exchange_ring.launches

    host, host_pushers, host_s = host_drain()
    device_runs = [device_drain(), device_drain()]
    host2, _, host2_s = host_drain()

    ok = all(torch.equal(_bytes(host[i]), _bytes(host2[i])) for i in range(n))
    log(f"[shuffle] the two host-exchange drains serve the same streams {ok}")
    for k, (dev, pushers, _, fabric, launches) in enumerate(device_runs):
        for i in range(n):
            same = torch.equal(_bytes(host[i]), _bytes(dev[i]))
            origin = (dev[i][:, 0] / 1e6).floor().long().view(
                sh["n_epochs"], -1)
            mixed = all(bool((e != i).any()) for e in origin[1:])
            m = pushers[i].metrics
            fallbacks = m.counter("shuffle.device_fallbacks")
            rounds = m.counter("shuffle.device_rounds")
            inst_ok = (same and mixed and fallbacks == 0
                       and rounds >= sh["n_epochs"])
            log(f"[shuffle] device drain {k + 1}, instance {i}: stream "
                f"{tuple(dev[i].shape)} byte-identical to the host "
                f"exchange's {same}, epochs 1+ hold other instances' rows "
                f"{mixed}, device rounds {rounds:.0f}, fallbacks "
                f"{fallbacks:.0f} -> {'ok' if inst_ok else 'FAIL'}")
            ok &= inst_ok
        counted = launches == fabric.legs and launches > 0
        log(f"[shuffle] device drain {k + 1}: K9 launches {launches}, "
            f"fabric rounds {fabric.legs} -> {'ok' if counted else 'FAIL'}")
        ok &= counted
    host_rounds = min(p.shuffler.exchange_round for p in host_pushers.values())
    dev_rounds = [run[3].legs for run in device_runs]
    host_walls = [host_s, host2_s]
    dev_walls = [run[2] for run in device_runs]
    summary = {
        "host_drain_s": host_walls, "device_drain_s": dev_walls,
        "host_rounds": host_rounds, "device_rounds": dev_rounds,
        "round_bytes": round_bytes,
        "host_exchanged_bytes_per_s": [host_rounds * round_bytes / s
                                       for s in host_walls],
        "device_exchanged_bytes_per_s": [r * round_bytes / s for r, s
                                         in zip(dev_rounds, dev_walls)],
        "fabric_leg_ms": leg,
    }
    log(f"[shuffle] drains in turn (host, device, device, host): "
        f"{host_s:.3f}, {dev_walls[0]:.3f}, {dev_walls[1]:.3f}, "
        f"{host2_s:.3f} s; {host_rounds} / {dev_rounds[0]} / "
        f"{dev_rounds[1]} / {host_rounds} rounds of "
        f"{round_bytes / 2**20:.0f} MiB")
    if not ok:
        raise PhaseFailed("the global-shuffle path failed its checks")
    row["launches"] = device_runs[0][4]
    if profile:
        profile_run(device_drain, "device-fabric drain")
    return row, summary


# ------------------------------------------------------------- phase 5 ---

def _fanout_case(rows, cols, dtype, gen, offset=0):
    """A contiguous (rows, cols) block of random bytes of ``dtype`` on the
    card, starting ``offset`` bytes into its allocation (an offset that is
    not a multiple of 16 sends the kernels down their narrower paths)."""
    import torch

    isz = torch.empty(0, dtype=dtype).element_size()
    n = rows * cols * isz
    raw = torch.randint(0, 256, (n + offset,), generator=gen, device="cuda",
                        dtype=torch.uint8)
    return raw[offset:].view(dtype).view(rows, cols)


def _same_blocks(got, want):
    import torch

    return len(got.shards) == len(want) and all(
        torch.equal(_bytes(s.data), _bytes(w)) for s, w in zip(got.shards, want))


def fanout_kernel_checks():
    """K7 and K8 against their plain versions, byte for byte, on the shapes
    of phase (a) and on the 2-D views the main path hands them, then their
    times at the path's full-size geometry.  Returns the two kernels-JSON
    rows (launches filled in by the path)."""
    import torch

    from ddl_tpu_torch.ops import ici_fanout as fan
    from ddl_tpu_torch.parallel.ici import _to2d

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    f32, i32, u8, bf16 = torch.float32, torch.int32, torch.uint8, torch.bfloat16
    # (label, n, rows, cols, dtype, src, byte offset).  The reference
    # pipelines K7 in 4 chunks; its tail (10 rows) and its clamp (2 rows,
    # fewer than 16 chunks) are shapes here too.
    cases = [(f"n={n} fp32 x 256, src={n - 1}", n, 64, 256, f32, n - 1, 0)
             for n in (2, 3, 4, 8)]
    cases += [
        ("int32 x 256, n=4", 4, 64, 256, i32, 1, 0),
        ("uint8 x 256, n=4", 4, 64, 256, u8, 2, 0),
        ("bf16 x 256, n=4", 4, 64, 256, bf16, 3, 0),
        ("7-byte rows (uint8 x 7), n=8", 8, 24, 7, u8, 5, 0),
        ("10 rows (rows % 4 chunks != 0), n=2", 2, 10, 33, f32, 1, 0),
        ("2 rows (fewer than 16 chunks), n=2", 2, 2, 64, i32, 0, 0),
        ("source 3 bytes off 16-byte alignment, uint8 x 40, n=4", 4, 12, 40,
         u8, 1, 3),
        ("source 4 bytes off 16-byte alignment, fp32 x 9, n=3", 3, 6, 9, f32,
         2, 4),
    ]
    blocks = [(label, n, _fanout_case(rows, cols, dt, gen, offset), src)
              for label, n, rows, cols, dt, src, offset in cases]
    # The main path's own views (ici._to2d of its windows, on the anchor):
    # the 64 MiB window split on dim 1 (dp=4 and dp=2 x fsdp=2) and
    # flattened whole (replicated), and the token window split on dim 1.
    g = ICI
    window = (g["window"] // g["batch_size"], g["batch_size"], g["cols"])
    tokens = (TRAIN["window_rows"] // TRAIN["batch_size"],
              TRAIN["batch_size"], TRAIN["seq_len"])
    for label, shape, dt, split_dim in (
            ("window split on dim 1", window, f32, 1),
            ("window replicated", window, f32, 0),
            ("token window split on dim 1", tokens, i32, 1)):
        win = _fanout_case(math.prod(shape[:-1]), shape[-1], dt, gen).view(shape)
        view = _to2d(win, split_dim)
        blocks.append((f"path view {tuple(view.shape)} of the {shape} {label}",
                       g["n"], view, 0))
        del win
    ok = True
    for label, n, block, src in blocks:
        before = _bytes(block).clone()
        rows = block.shape[0]
        devs = ["cuda:0"] * n
        rep = fan.fanout_replicate(block, devs, src=src)
        shard = (fan.fanout_shard(block, devs, src=src) if rows % n == 0
                 else None)
        torch.cuda.synchronize()
        same_rep = _same_blocks(rep, fan.replicate_plain(block, n, src))
        same_shard = shard is None or _same_blocks(shard, fan.shard_plain(block, n))
        kept = torch.equal(_bytes(block), before)
        log(f"[check] K7/K8 {label}: K7 byte-equal to plain {same_rep}, K8 "
            + ("skipped (rows % n != 0)" if shard is None
               else f"byte-equal to plain {same_shard}")
            + f", input kept {kept} -> "
            + ("ok" if same_rep and same_shard and kept else "FAIL"))
        ok &= same_rep and same_shard and kept
    del blocks, block, rep, shard

    n, rows, cols = g["n"], g["rows"], g["cols"]
    block = torch.randn((rows, cols), generator=gen, device="cuda")
    devs = ["cuda:0"] * n
    rep = fan.fanout_replicate(block, devs)
    shard = fan.fanout_shard(block, devs)
    rep_want = fan.replicate_plain(block, n)
    shard_want = fan.shard_plain(block, n)
    torch.cuda.synchronize()
    errs = {
        "replicate": max(float((s.data - w).abs().max())
                         for s, w in zip(rep.shards, rep_want)),
        "shard": max(float((s.data - w).abs().max())
                     for s, w in zip(shard.shards, shard_want)),
    }
    full = _same_blocks(rep, rep_want) and _same_blocks(shard, shard_want)
    log(f"[check] K7/K8 full size n={n} ({rows}, {cols}) fp32: byte-equal "
        f"{full}, max abs err K7 {errs['replicate']} K8 {errs['shard']} | "
        f"tol 0 -> {'ok' if full else 'FAIL'}")
    ok &= full
    if not ok:
        raise PhaseFailed("K7/K8 disagree with their plain versions")
    del rep, shard, rep_want, shard_want

    # The library yardstick: one Tensor.copy_ per destination (timed here
    # only; nothing in the port runs it).
    block_rows = rows // n
    rep_dst = [torch.empty_like(block) for _ in range(n - 1)]
    shard_dst = [torch.empty((block_rows, cols), device="cuda")
                 for _ in range(n)]

    def copies_replicate():
        for d in rep_dst:
            d.copy_(block)

    def copies_shard():
        for i, d in enumerate(shard_dst):
            d.copy_(block[i * block_rows:(i + 1) * block_rows])

    # 4 GiB: ~1.3 ms of writes.  K7 launches only after allocating its
    # outputs (0.10-0.19 ms of host work a call, more on a slow host);
    # the flush must outlast that, or the start event times the wait.
    scratch = torch.empty(4 << 30, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    nbytes = rows * cols * 4
    timed = {
        "replicate": (lambda: fan.fanout_replicate(block, devs),
                      lambda: fan.replicate_plain(block, n), copies_replicate,
                      nbytes + (n - 1) * nbytes, f"copy_ x{n - 1}"),
        "shard": (lambda: fan.fanout_shard(block, devs),
                  lambda: fan.shard_plain(block, n), copies_shard,
                  2 * nbytes, f"copy_ x{n}"),
    }
    info = {"replicate": ("fanout_replicate", "_bcast_kernel", 99),
            "shard": ("fanout_shard", "_scatter_kernel", 155)}
    rows_out = []
    for mode, (kernel, plain, library, moved, lib_name) in timed.items():
        ms = _time_cold_ms(kernel, flush)
        plain_ms = _time_cold_ms(plain, flush)
        library_ms = _time_cold_ms(library, flush)
        call_ms = _time_ms(kernel, reps=50, warmup=5)
        bound_ms = moved / PEAK_BYTES * 1e3
        name, tpu_fn, line = info[mode]
        log(f"[time] {name}: {ms:.4f} ms (L2 cold; {call_ms:.4f} ms a call "
            f"back to back)  plain {plain_ms:.4f} ms  {lib_name} "
            f"{library_ms:.4f} ms  bound {bound_ms:.4f} ms (bytes, "
            f"{moved / 2**20:.0f} MiB)")
        rows_out.append({
            "name": name,
            "route": "cuda",
            "source": "ddl_tpu_torch/ops/csrc/ici_fanout.cu",
            "replaces": f"ddl_tpu/ops/ici_fanout.py:{line} ({tpu_fn})",
            "launches": 0,
            "max_abs_err": errs[mode],
            "ms": ms,
            "back_to_back_ms": call_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            "library_ms": library_ms,
            "library": lib_name,
        })
    del scratch, rep_dst, shard_dst
    return rows_out


def _sharding(axes, spec):
    from ddl_tpu_torch.parallel.mesh import NamedSharding, P, make_mesh

    n = int(math.prod(axes.values()))
    return NamedSharding(make_mesh(axes, ["cuda:0"] * n), P(*spec))


def _ici_drain(producer, batch_size, n_epochs, host_windows=None, axes=None,
               spec=None, distribute="ici"):
    """Drain ``n_epochs`` windows of ``producer`` through a THREAD loader
    (2 producers).  Without ``axes`` the windows go to the host and are
    returned; with them each window lands on that mesh of positions of
    cuda:0, and every position's shard is held against its slice of
    ``host_windows``.  Returns (windows or checks, metrics, wall s)."""
    import torch

    import ddl_tpu_torch
    from ddl_tpu_torch.observability import Metrics

    on_card = axes is not None
    metrics = Metrics()

    @ddl_tpu_torch.distributed_dataloader(n_producers=2, mode="thread",
                                          nslots=2, pin_memory=on_card)
    def run(env):
        loader = ddl_tpu_torch.DistributedDataLoader(
            producer, batch_size=batch_size, connection=env.connection,
            n_epochs=n_epochs, output="device",
            device="cuda" if on_card else "cpu",
            sharding=_sharding(axes, spec) if on_card else None,
            distribute=distribute, metrics=metrics, timeout_s=120.0,
        )
        out = []
        t0 = time.perf_counter()
        for k, win in enumerate(loader.windows(lookahead=1)):
            if not on_card:
                out.append(win.clone())
            else:
                host = host_windows[k]
                out.append(all(
                    s.data.is_contiguous() and torch.equal(
                        _bytes(s.data), _bytes(host[s.index].contiguous().cuda()))
                    for s in win.shards) and tuple(win.shape) == tuple(host.shape))
            loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    out, wall = run()
    return out, metrics, wall


def ici_ab(reps: int = 5):
    """The A/B of the JAX package's ICI bench: ``put_window`` of one 64 MiB
    window from page-locked memory through the ICI tier and through the
    plain per-position route, for the dp=4 and the replicated layouts,
    interleaved, each timed to a synchronise on the host clock; the
    minimum of ``reps``.  Then one window's parts, each synchronised."""
    import torch

    from ddl_tpu_torch.ingest import DeviceIngestor, device_put
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import ici_fanout as fan
    from ddl_tpu_torch.parallel import ici as ici_mod

    g = ICI
    shape = (g["window"] // g["batch_size"], g["batch_size"], g["cols"])
    window = torch.randn(shape, generator=torch.Generator().manual_seed(SEED))
    window = window.pin_memory()
    nbytes = window.numel() * 4
    out = {}
    for label, (axes, spec) in (("dp4", ({"dp": 4}, (None, "dp"))),
                                ("replicated", ({"dp": 4}, (None, None, None)))):
        sh = _sharding(axes, spec)
        ings = {d: DeviceIngestor(sharding=sh, distribute=d, metrics=Metrics())
                for d in ("ici", "xla")}
        times = {"ici": [], "xla": []}
        results = {}
        for _ in range(reps + 1):  # the first round warms both up
            for d, ing in ings.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                results[d] = ing.hand_off(ing.put_window(window.numpy()))
                torch.cuda.synchronize()
                times[d].append(time.perf_counter() - t0)
        best = {d: min(t[1:]) for d, t in times.items()}
        same = all(torch.equal(_bytes(a.data), _bytes(b.data)) for a, b in
                   zip(results["ici"].shards, results["xla"].shards))
        fallbacks = ings["ici"].ici().metrics.counter("ici.fallbacks")
        out[label] = {
            "ici_bytes_per_s": nbytes / best["ici"],
            "plain_bytes_per_s": nbytes / best["xla"],
            "vs_plain": best["xla"] / best["ici"],
            "ici_ms": best["ici"] * 1e3, "plain_ms": best["xla"] * 1e3,
            "byte_identical": same, "fallbacks": fallbacks,
        }
        log(f"[ici-ab] {label} 64 MiB window, min of {reps}: ICI tier "
            f"{nbytes / best['ici'] / 1e9:.2f} GB/s ({best['ici'] * 1e3:.3f} ms), "
            f"plain route {nbytes / best['xla'] / 1e9:.2f} GB/s "
            f"({best['xla'] * 1e3:.3f} ms), vs_plain {best['xla'] / best['ici']:.3f}, "
            f"byte_identical {same}")
        if not same or fallbacks:
            raise PhaseFailed(f"ICI A/B {label}: byte_identical {same}, "
                              f"fallbacks {fallbacks}")

    # One dp=4 window's parts, each ending in a synchronise.
    sh = _sharding({"dp": 4}, (None, "dp"))
    dist = ici_mod.IciDistributor(sh, metrics=Metrics())
    plan = dist.plan(shape, torch.float32)
    ring = [sh.mesh.device_list[p] for p in plan.ring_positions]
    parts = dict(h2d=[], view_2d=[], kernel=[], finish=[])
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block = device_put(window, dist.anchor(shape, torch.float32))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        flat = ici_mod._to2d(block, plan.split_dim)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ring_out = fan.fanout_shard(flat, ring)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ici_mod._finish_shard(ring_out, plan, sh)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[k].append(v * 1e3)
    out["dp4_parts_ms"] = {k: sorted(v[2:])[reps // 2] for k, v in parts.items()}
    log(f"[ici-ab] one dp=4 window's parts, median of {reps} (host clock, ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["dp4_parts_ms"].items()))
    return out


def phase_ici(tmpdir: str, profile: bool = False):
    """K7/K8's checks and times, then the ICI ingest path: the 64 MiB
    windows of an ArrayProducer drained on three meshes of positions of
    cuda:0 (K8, K8 with the gather leg, K7) and a token stream at the
    Llama path's window (K8), every position's shard held against its
    slice of the host window; one ragged geometry through the plain route;
    the A/B.  Each drain has the launch counts set to 0 just before it and
    read just after."""
    import numpy as np
    import torch

    from ddl_tpu_torch.ingest import DeviceIngestor
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import ici_fanout as fan
    from ddl_tpu_torch.readers import ArrayProducer, TokenStreamProducer

    rows = fanout_kernel_checks()
    g = ICI
    data = np.random.default_rng(SEED).standard_normal(
        (g["n_rows"], g["cols"]), dtype=np.float32)

    def array_producer():
        return ArrayProducer(data, window_size=g["window"], seed=SEED)

    host, _, host_s = _ici_drain(array_producer(), g["batch_size"], g["n_epochs"])
    log(f"[ici] host stream: {len(host)} windows of {tuple(host[0].shape)} "
        f"fp32 ({host[0].numel() * 4 / 2**20:.0f} MiB) in {host_s:.3f} s")
    token_file = os.path.join(tmpdir, "ici_tokens.bin")
    ranks = np.random.default_rng(SEED).zipf(1.2, 1 << 20) - 1
    (ranks % VOCAB).astype(np.int32).tofile(token_file)

    def token_producer():
        return TokenStreamProducer(token_file, TRAIN["seq_len"],
                                   TRAIN["window_rows"], seed=SEED)

    tokens, _, _ = _ici_drain(token_producer(), TRAIN["batch_size"],
                              g["n_epochs"])
    runs = [
        ("dp=4, P(None, 'dp')", array_producer, g["batch_size"], host,
         {"dp": 4}, (None, "dp"), fan.fanout_shard),
        ("dp=2 x fsdp=2, P(None, 'dp')", array_producer, g["batch_size"], host,
         {"dp": 2, "fsdp": 2}, (None, "dp"), fan.fanout_shard),
        ("dp=4, replicated", array_producer, g["batch_size"], host,
         {"dp": 4}, (None, None, None), fan.fanout_replicate),
        ("token stream (2, 4, 2048) int32, dp=4, P(None, 'dp')", token_producer,
         TRAIN["batch_size"], tokens, {"dp": 4}, (None, "dp"), fan.fanout_shard),
    ]
    ok = True
    launches = {fn.__name__: 0 for fn in fan.KERNELS}
    summary = {"host_drain_s": host_s}
    for label, make, batch, want, axes, spec, kernel in runs:
        torch.cuda.synchronize()
        fan.reset_launch_counts()
        checks, m, wall = _ici_drain(make(), batch, g["n_epochs"], want, axes,
                                     spec)
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in fan.KERNELS}
        windows = m.counter("ici.windows")
        fallbacks = m.counter("ici.fallbacks")
        idle = [fn for fn in fan.KERNELS if fn is not kernel]
        run_ok = (all(checks) and len(checks) == g["n_epochs"]
                  and fallbacks == 0 and windows == g["n_epochs"]
                  and counts[kernel.__name__] == windows
                  and all(counts[fn.__name__] == 0 for fn in idle))
        for name, c in counts.items():
            launches[name] += c
        log(f"[ici] {label}: {len(checks)} windows, every shard byte-equal to "
            f"its slice of the host window {all(checks)}, ici.windows "
            f"{windows:.0f}, ici.fallbacks {fallbacks:.0f}, launches {counts}, "
            f"drain {wall:.3f} s, ici.fanout {m.timer('ici.fanout').total_s * 1e3:.2f} ms"
            f", ici.redistribute {m.timer('ici.redistribute').total_s * 1e3:.2f} ms"
            f" (host clock, dispatch) -> {'ok' if run_ok else 'FAIL'}")
        summary[label] = {"drain_s": wall, "windows": windows,
                          "launches": counts}
        ok &= run_ok

    # A ragged geometry: a window whose batch dim (2) the dp=2 target
    # splits but the 4-position ring does not — no bounded plan, so it
    # takes the plain route, counted once.
    sh = _sharding({"dp": 2, "fsdp": 2}, (None, "dp"))
    ing = DeviceIngestor(sharding=sh, distribute="ici", metrics=Metrics())
    ragged = np.ascontiguousarray(host[0].numpy()[:, :2])
    fan.reset_launch_counts()
    got = [ing.hand_off(ing.put_window(ragged)) for _ in range(2)]
    torch.cuda.synchronize()
    fb = ing.metrics.counter("ici.fallbacks")
    same = all(torch.equal(_bytes(s.data), _bytes(
        torch.from_numpy(ragged)[s.index].contiguous().cuda()))
        for w in got for s in w.shards)
    ragged_ok = same and fb == 1 and sum(fn.launches for fn in fan.KERNELS) == 0
    log(f"[ici] ragged {ragged.shape} on dp=2 x fsdp=2: plain route, shards "
        f"byte-equal {same}, ici.fallbacks {fb:.0f} over 2 windows, no kernel "
        f"launch -> {'ok' if ragged_ok else 'FAIL'}")
    ok &= ragged_ok
    if not ok:
        raise PhaseFailed("the ICI ingest path failed its checks")
    if profile:
        profile_run(lambda: _ici_drain(array_producer(), g["batch_size"],
                                       g["n_epochs"], host, {"dp": 4},
                                       (None, "dp")), "ICI dp=4 drain")
    del host, tokens, got
    summary["ab"] = ici_ab()
    for row in rows:
        row["launches"] = launches[row["name"]]
    return rows, summary


# ------------------------------------------------------------- phase 6 ---

def profile_run(run, what: str) -> None:
    """Where a run's device time goes: ``torch.profiler`` over one more
    measured-size run (a fit, a drain).  Device-side events only
    (kernels, copies, sets), grouped; busy share is their summed time over
    the profiled run's wall (the side stream's copies overlap compute, so
    the sum can slightly exceed true occupancy)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side work only: not the CPU ops' attributed time, not the
    # device-side copies of annotation ranges (Optimizer.step#...), which
    # overlap the kernels they contain, nor CUPTI's queue-full markers.
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
        and not e.key.startswith(("Optimizer.", "ProfilerStep"))
        and "Command Buffer Full" not in e.key
    ]
    groups: dict = {}
    for e in events:
        name = e.key.lower()
        group = next((g for g, keys in (
            ("flash kernels", ("flash_", "id_range_kernel",
                               "row_terms_kernel", "pad_ids_kernel")),
            ("exchange kernel K9", ("exchange_kernel",)),
            ("fan-out kernels K7/K8", ("fanout_kernel",)),
            ("GEMM", ("nvjet", "gemm", "cutlass", "xmma")),
            ("optimizer", ("multi_tensor_apply",)),
            ("copies", ("memcpy", "memset")),
        ) if any(k in name for k in keys)), "other elementwise / reductions")
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3
    busy = sum(groups.values())
    log(f"[profile] profiled {what} {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({busy / (wall * 1e3):.1%})")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[profile] {ms:9.2f} ms  {ms / busy:6.1%}  {g}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:5d}x  {e.key[:90]}")


def _corpus_stats(token_file: str, seq_len: int):
    """Mean segments per row and the share of positions the boundary mask
    drops, over the file's rows of ``seq_len`` tokens (the rows the
    producers draw from)."""
    import numpy as np

    tokens = np.fromfile(token_file, np.int32)
    rows = tokens[: len(tokens) // seq_len * seq_len].reshape(-1, seq_len)
    seg = seg_ids(rows)
    boundary = (seg[:, :-1] != seg[:, 1:]).sum()
    return float((seg[:, -1] + 1).mean()), float(boundary / seg.size)


def _shm_free_bytes() -> int:
    st = os.statvfs("/dev/shm")
    return st.f_bavail * st.f_frsize


def _fit_mode(mode, producer, loss_fn, cfg, tag, card, profile=False):
    """One training path in one producer mode at full width: a fresh
    ``Trainer`` from ``init_params(seed=0)``, a one-window warm-up fit
    (cuBLAS handles, allocator pools, the producers' first spawn), then
    the measured fit with the flash launch counts set to 0 just before it
    and read just after.  Everything it allocated is dropped on return."""
    import torch

    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.trainer import Trainer

    tr = TRAIN
    trainer = Trainer(
        loss_fn=loss_fn,
        # No warm-up schedule in a 6-step smoke: a small rate keeps Adam's
        # first, sign-like steps from overshooting at this width.
        optimizer=adamw(1e-5),
        init_params=llama.init_params(cfg, seed=SEED, device="cuda"),
        device="cuda",
        metrics=Metrics(),
    )

    def run(n_epochs):
        return trainer.fit(producer, config=LoaderConfig(
            batch_size=tr["batch_size"], n_epochs=n_epochs,
            n_producers=tr["n_producers"], mode=mode, window_stream=True))

    warm = run(1)
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.metrics = m = Metrics()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    result = run(tr["n_epochs"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in fa.KERNELS}
    sm90 = {fn.__name__: fn.sm90_launches for fn in fa.KERNELS}
    steps_per_window = tr["window_rows"] // tr["batch_size"]
    steps = tr["n_epochs"] * steps_per_window
    tokens = steps * tr["batch_size"] * tr["seq_len"]
    # trainer.first_window: fit() to the first window handed to the steps
    # (spawn, handshake, first fill and copy); trainer.windows: from there
    # to the end of the last window's steps on the card's clock, every
    # step of the fit: the steady state.  The rest of the wall time is
    # teardown (loader shutdown, unregistering, joining the producers).
    first = m.timer("trainer.first_window").total_s
    steady_steps = steps
    steady_s = m.timer("trainer.windows").total_s
    summary = {
        "mode": mode, "losses": result.losses, "steps": steps,
        "step_ms": wall / steps * 1e3, "tokens_per_s": tokens / wall,
        "first_window_s": first,
        "handshake_s": m.timer("consumer.handshake").total_s,
        "teardown_s": wall - first - steady_s,
        "steady_step_ms": steady_s / steady_steps * 1e3,
        "steady_tokens_per_s": (steady_steps * tr["batch_size"]
                                * tr["seq_len"] / steady_s),
        "ingest_overlap_s": m.timer("trainer.ingest_overlap").total_s,
        "window_wait_s": m.timer("trainer.window_wait").total_s,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "counters": {k: m.counter(k) for k in (
            "transport.rings.NativeShmRing", "transport.rings.PyShmRing",
            "transport.rings.ThreadRing", "ingest.registered_rings",
            "consumer.windows", "staging.alias_windows",
            "staging.alias_fallbacks", "staging.pool_alias_drops",
            "integrity.staging_verify_failures", "staging.inline_fallbacks",
            "staging.pool_hits", "staging.pool_misses",
            "integrity.corrupt_windows", "producer.exits_clean",
            "producer.exits_failed")},
        "launches": launches, "sm90_launches": sm90,
    }
    log(f"{tag} {mode}: per-window losses {result.losses}")
    log(f"{tag} {mode}: {steps} steps in {wall:.3f} s: {wall / steps * 1e3:.1f} "
        f"ms/step, {tokens / wall:.0f} tokens/s, peak memory "
        f"{summary['peak_bytes'] / 2**30:.2f} GiB ({card})")
    log(f"{tag} {mode}: first window at the steps {first:.3f} s after "
        f"fit() (handshake {summary['handshake_s']:.3f} s); steady state, "
        f"the {steady_steps} steps from there, "
        f"{summary['steady_step_ms']:.1f} ms/step, "
        f"{summary['steady_tokens_per_s']:.0f} tokens/s; teardown "
        f"{summary['teardown_s']:.3f} s; "
        f"trainer.ingest_overlap {summary['ingest_overlap_s'] * 1e3:.2f} ms, "
        f"trainer.window_wait {summary['window_wait_s'] * 1e3:.2f} ms; "
        f"/dev/shm free {_shm_free_bytes()} bytes ({card})")
    log(f"{tag} {mode}: counters {json.dumps(summary['counters'])}")
    del result
    if profile:
        profile_run(lambda: run(tr["n_epochs"]), f"{tag} {mode} fit")
    del trainer
    free_device_memory()
    return summary


def phase_train(tmpdir: str, card: str, profile: bool = False,
                packed: bool = False):
    """One of the port's paths at full width: ``Trainer.fit`` over a
    ``TokenStreamProducer`` stream (K1-K3) or, ``packed``, over a
    ``PackedTokenProducer`` stream of documents into the segment-masked
    loss (K4-K6), first with THREAD producers, then with spawned PROCESS
    producers over native shm rings that the loader page-locks.  Both
    fits start from the same parameters and must see the same windows,
    run the same kernels and give the same losses."""
    import numpy as np

    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.readers import PackedTokenProducer, TokenStreamProducer

    tr = TRAIN
    tag = "[train-packed]" if packed else "[train]"
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=tr["n_layers"])
    token_file = os.path.join(tmpdir, "docs.bin" if packed else "tokens.bin")
    if packed:
        documents(tr["n_tokens"]).tofile(token_file)
        segs, dropped = _corpus_stats(token_file, tr["seq_len"])
        log(f"{tag} {tr['n_tokens']} tokens of documents: {segs:.2f} segments "
            f"per {tr['seq_len']}-token row, boundary mask drops {dropped:.3%} "
            f"of positions")
        producer = PackedTokenProducer(token_file, tr["seq_len"],
                                       tr["window_rows"], delimiter=EOT,
                                       seed=SEED)

        def loss_fn(p, b):
            return llama.next_token_loss(p, b[0], cfg, segment_ids=b[1])
    else:
        # A Zipf-distributed token stream (the rank-frequency law of
        # text): its unigram skew is learnable within a few steps, so the
        # losses should fall from the random-init level.
        ranks = np.random.default_rng(SEED).zipf(1.2, tr["n_tokens"]) - 1
        (ranks % cfg.vocab).astype(np.int32).tofile(token_file)
        producer = TokenStreamProducer(token_file, tr["seq_len"],
                                       tr["window_rows"], seed=SEED)

        def loss_fn(p, b):
            return llama.next_token_loss(p, b[0], cfg)
    log(f"{tag} llama3_8b widths, {cfg.n_layers} layers, "
        f"{llama.param_count(cfg) / 1e9:.3f} B params, dtype {cfg.dtype}, "
        f"attn_impl {cfg.attn_impl}, remat {cfg.remat}")

    thread = _fit_mode("thread", producer, loss_fn, cfg, tag, card, profile)
    proc = _fit_mode("process", producer, loss_fn, cfg, tag, card)

    steps = thread["steps"]
    expected = cfg.n_layers * steps
    fwd, dq, dkv = fa.KERNELS[3:] if packed else fa.KERNELS[:3]
    ran, idle = ((fa.KERNELS[3:], fa.KERNELS[:3]) if packed
                 else (fa.KERNELS[:3], fa.KERNELS[3:]))
    faults = []
    for s in (thread, proc):
        mode, c = s["mode"], s["counters"]
        log(f"{tag} {mode}: kernel launches in this run: {s['launches']} "
            f"(expected {cfg.n_layers} layers x {steps} steps = {expected} "
            f"for {[fn.__name__ for fn in ran]}, 0 for the others); on the "
            f"wgmma kernels: {s['sm90_launches']}")
        if not (len(s["losses"]) == tr["n_epochs"]
                and all(math.isfinite(x) for x in s["losses"])):
            faults.append(f"{mode}: losses {s['losses']}")
        if not (all(s["launches"][fn.__name__] == expected for fn in ran)
                and all(s["launches"][fn.__name__] == 0 for fn in idle)
                and all(s["sm90_launches"][fn.__name__] == expected
                        for fn in (fwd, dq, dkv))):
            faults.append(f"{mode}: flash launches {s['launches']} / "
                          f"{s['sm90_launches']}")
        windows = c["consumer.windows"]
        if not (windows == tr["n_epochs"]
                and c["staging.alias_windows"] == windows
                and c["staging.alias_fallbacks"] == 0
                and c["staging.pool_alias_drops"] == 0
                and c["integrity.staging_verify_failures"] == 0
                and c["staging.inline_fallbacks"] == 0
                and c["integrity.corrupt_windows"] == 0):
            faults.append(f"{mode}: staging counters {c}")
    c = proc["counters"]
    n = tr["n_producers"]
    if not (c["transport.rings.NativeShmRing"] == n
            and c["transport.rings.PyShmRing"] == 0
            and c["ingest.registered_rings"] == n
            and c["producer.exits_clean"] == n
            and c["producer.exits_failed"] == 0):
        faults.append(f"process: rings, registration or exits {c}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(proc["losses"],
                                                   thread["losses"]))
    log(f"{tag} process vs thread losses: max relative difference {rel:.3e} "
        f"({'bit-equal' if proc['losses'] == thread['losses'] else 'not bit-equal'})")
    if not rel <= 1e-5:
        faults.append(f"process losses {proc['losses']} vs thread "
                      f"{thread['losses']}")
    if faults:
        raise PhaseFailed(f"{tag} training runs failed their checks: "
                          + "; ".join(faults))
    summary = {
        "step_ms": thread["step_ms"], "tokens_per_s": thread["tokens_per_s"],
        "peak_bytes": thread["peak_bytes"], "losses": thread["losses"],
        "steps": steps, "sm90_launches": thread["sm90_launches"][fwd.__name__],
        "dq_sm90_launches": thread["sm90_launches"][dq.__name__],
        "dkv_sm90_launches": thread["sm90_launches"][dkv.__name__],
        "thread": thread, "process": proc,
    }
    if packed:
        summary.update(segments_per_row=segs, boundary_dropped=dropped)
    return thread["launches"], summary


# ------------------------------------------------------------- phase 7 ---

#: The recovery phase: the token cell of phase 6 over 6 windows (12 steps),
#: one producer SIGKILLed at its second refill; the global-shuffle
#: geometry of phase 4 with instance 0's producer SIGKILLed at its third.
RECOVERY = dict(n_epochs=6, kill_at=2, shuffle_kill_at=3)
#: /dev/shm the phase needs at least: the rings of the fits (2 x 2 slots
#: of 64 KiB) and of the four shuffle instances (4 x 2 slots of 8 MiB),
#: plus each round's lanes (2 x 2 MiB per instance) and their retained
#: copies, with room to spare.
RECOVERY_SHM_BYTES = 256 << 20


def _kill_once(sentinel, who) -> None:
    """SIGKILL this process (no ``finally`` runs, as under the OOM
    killer) unless the sentinel file says an earlier incarnation did; the
    file records the wall time of the kill and who died."""
    import signal

    if sentinel is None or os.path.exists(sentinel):
        return
    with open(sentinel, "w") as f:
        f.write(json.dumps({"t": time.time(), "who": who}))
    os.kill(os.getpid(), signal.SIGKILL)


class KillOnceProducer:
    """Wraps a producer function: producer ``victim``'s first
    incarnation SIGKILLs itself at its refill ``kill_at``, once
    (``_kill_once``); every call is otherwise the wrapped producer's, so
    a recovered run serves the same windows.  Module-level, so spawned
    producers unpickle it."""

    def __init__(self, inner, sentinel, kill_at, victim=1):
        self.inner, self.sentinel, self.kill_at = inner, sentinel, kill_at
        self.victim = victim
        self.refills = 0
        self.producer_idx = 0

    def __getattr__(self, name):
        # Capabilities (supports_inplace_fill) are the wrapped producer's.
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    def on_init(self, **kw):
        self.producer_idx = kw.get("producer_idx", 0)
        return self.inner.on_init(**kw)

    def post_init(self, **kw):
        return self.inner.post_init(**kw)

    def execute_function(self, **kw):
        self.refills += 1
        if self.refills == self.kill_at and self.producer_idx == self.victim:
            _kill_once(self.sentinel, self.producer_idx)
        return self.inner.execute_function(**kw)

    def fast_forward(self, n, **kw):
        self.refills += n
        return self.inner.fast_forward(n, **kw)


def _token_trainer(cfg, respawn: bool):
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.trainer import Trainer

    return Trainer(
        loss_fn=lambda p, b: llama.next_token_loss(p, b[0], cfg),
        optimizer=adamw(1e-5),
        init_params=llama.init_params(cfg, seed=SEED, device="cuda"),
        device="cuda", metrics=Metrics(), watchdog_respawn=respawn,
    )


def _recovery_fit(trainer, producer, mode, tag, card):
    """One measured fit of the recovery cell: flash launch counts set to
    0 just before and read just after; each window's wall time when the
    stream hands it to the steps."""
    import torch

    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import flash_attention as fa

    rc, tr = RECOVERY, TRAIN
    served = []

    def hook(win):
        served.append(time.time())
        return win

    trainer.metrics = m = Metrics()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    res = trainer.fit(producer, window_hook=hook, config=LoaderConfig(
        batch_size=tr["batch_size"], n_epochs=rc["n_epochs"],
        n_producers=tr["n_producers"], mode=mode, window_stream=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = rc["n_epochs"] * tr["window_rows"] // tr["batch_size"]
    out = {
        "mode": mode, "losses": res.losses, "served": served, "wall_s": wall,
        "launches": [fn.launches for fn in fa.KERNELS],
        "sm90_launches": [fn.sm90_launches for fn in fa.KERNELS],
        "steady_step_ms": m.timer("trainer.windows").total_s / steps * 1e3,
        "first_window_s": m.timer("trainer.first_window").total_s,
        "window_wait_s": m.timer("trainer.window_wait").total_s,
        "respawn_call_s": m.timer("watchdog.respawn").total_s,
        "replay_s": m.timer("integrity.replay").total_s,
        "counters": {k: m.counter(k) for k in (
            "watchdog.respawns", "watchdog.failures", "consumer.windows",
            "staging.alias_windows", "staging.alias_fallbacks",
            "staging.pool_alias_drops", "staging.inline_fallbacks",
            "integrity.staging_verify_failures", "integrity.corrupt_windows",
            "integrity.replays", "integrity.replay_exhausted",
            "ingest.registered_rings", "transport.rings.NativeShmRing",
            "transport.rings.PyShmRing", "producer.exits_clean",
            "producer.exits_failed", "ctrl.acked")},
    }
    log(f"{tag}: {steps} steps in {wall:.3f} s, steady state "
        f"{out['steady_step_ms']:.1f} ms/step, first window "
        f"{out['first_window_s']:.3f} s, trainer.window_wait "
        f"{out['window_wait_s'] * 1e3:.2f} ms ({card})")
    log(f"{tag}: losses {res.losses}")
    log(f"{tag}: counters {json.dumps(out['counters'])}")
    del res
    return out


def _fit_faults(run, clean, tag, faults, **want):
    """The gates every recovery fit shares, plus ``want``'s counters."""
    rc, c = RECOVERY, run["counters"]
    if run["losses"] != clean["losses"]:
        faults.append(f"{tag}: losses {run['losses']} != {clean['losses']}")
    if (run["launches"] != clean["launches"]
            or run["sm90_launches"] != clean["sm90_launches"]):
        faults.append(f"{tag}: launches {run['launches']} / "
                      f"{run['sm90_launches']} != {clean['launches']} / "
                      f"{clean['sm90_launches']}")
    base = {"consumer.windows": rc["n_epochs"],
            "staging.alias_windows": rc["n_epochs"],
            "staging.alias_fallbacks": 0, "staging.pool_alias_drops": 0,
            "staging.inline_fallbacks": 0,
            "integrity.staging_verify_failures": 0,
            "watchdog.failures": 0, "integrity.replay_exhausted": 0,
            "transport.rings.PyShmRing": 0}
    base.update(want)
    bad = {k: (c[k], v) for k, v in base.items() if c[k] != v}
    if bad:
        faults.append(f"{tag}: counters (got, want) {bad}")


def recovery_fits(tmpdir: str, card: str):
    """(a) the token cell in PROCESS mode, undisturbed and with one
    producer SIGKILLed at its second refill under a respawning watchdog;
    (b) the same cell in THREAD mode with one committed slot corrupted
    after its trailer was stamped, by a one-shot wrapper around the
    ring's commit.  Both must give the undisturbed fit's losses bit for
    bit and launch the same kernels as often."""
    import numpy as np

    from ddl_tpu_torch import integrity
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.readers import TokenStreamProducer
    from ddl_tpu_torch.transport.ring import ThreadRing

    rc, tr = RECOVERY, TRAIN
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=tr["n_layers"])
    token_file = os.path.join(tmpdir, "tokens.bin")
    if not os.path.exists(token_file):
        ranks = np.random.default_rng(SEED).zipf(1.2, tr["n_tokens"]) - 1
        (ranks % cfg.vocab).astype(np.int32).tofile(token_file)
    tokens = TokenStreamProducer(token_file, tr["seq_len"], tr["window_rows"],
                                 seed=SEED)
    trainer = _token_trainer(cfg, respawn=True)
    clean = _recovery_fit(trainer, tokens, "process", "[recovery] clean",
                          card)
    sentinel = os.path.join(tmpdir, "killed")
    killed = _recovery_fit(
        trainer, KillOnceProducer(tokens, sentinel, rc["kill_at"]),
        "process", "[recovery] sigkill", card)

    original, fired = ThreadRing.commit, []

    def corrupt_once(ring, slot, payload_bytes):
        """Flip one payload byte of producer 1's window 2, after its
        trailer was stamped (the slot then fails its CRC)."""
        hdr = integrity.read_header(ring.slot_view(slot), payload_bytes)
        if hdr.producer_idx == 1 and hdr.seq == 2 and not fired:
            ring.slot_view(slot)[payload_bytes // 2] ^= 0xFF
            fired.append(time.time())
        return original(ring, slot, payload_bytes)

    ThreadRing.commit = corrupt_once
    try:
        replayed = _recovery_fit(trainer, tokens, "thread",
                                 "[recovery] corrupt slot", card)
    finally:
        ThreadRing.commit = original
    del trainer
    free_device_memory()

    faults = []
    n = tr["n_producers"]
    proc = {"ingest.registered_rings": n, "transport.rings.NativeShmRing": n,
            "producer.exits_clean": n, "producer.exits_failed": 0,
            "integrity.corrupt_windows": 0, "integrity.replays": 0}
    _fit_faults(clean, clean, "clean", faults, **{"watchdog.respawns": 0},
                **proc)
    _fit_faults(killed, clean, "sigkill", faults,
                **{"watchdog.respawns": 1}, **proc)
    _fit_faults(replayed, clean, "corrupt slot", faults,
                **{"watchdog.respawns": 0, "integrity.corrupt_windows": 1,
                   "integrity.replays": 1, "ingest.registered_rings": 0})
    expected = cfg.n_layers * rc["n_epochs"] * tr["window_rows"] // tr[
        "batch_size"]
    if clean["launches"] != [expected] * 3 + [0] * 3:
        faults.append(f"clean fit launches {clean['launches']}, expected "
                      f"{expected} for K1-K3")
    if not os.path.exists(sentinel):
        faults.append("the SIGKILL never fired")
        recovery_s, died = float("nan"), None
    else:
        with open(sentinel) as f:
            kill = json.load(f)
        died = kill["who"]
        # Windows are served in rotation; the dead producer's first window
        # from its replacement is the one it was filling when it died.
        k = 2 * (rc["kill_at"] - 1) + (died - 1)
        recovery_s = killed["served"][k] - kill["t"]
    if len(fired) != 1:
        faults.append(f"the corruption fired {len(fired)} times")
    log(f"[recovery] producer {died} SIGKILLed at its refill "
        f"{rc['kill_at']}: recovery (kill to the replacement's first served "
        f"window) {recovery_s:.3f} s, of which the respawn call (spawn and "
        f"rejoin handshake) {killed['respawn_call_s']:.3f} s; "
        f"trainer.window_wait {killed['window_wait_s'] * 1e3:.1f} ms against "
        f"{clean['window_wait_s'] * 1e3:.1f} ms undisturbed; steady state "
        f"{killed['steady_step_ms']:.1f} against {clean['steady_step_ms']:.1f} "
        f"ms/step ({card})")
    log(f"[recovery] corrupt slot: replay (quarantine to the replayed "
        f"window) {replayed['replay_s'] * 1e3:.2f} ms; trainer.window_wait "
        f"{replayed['window_wait_s'] * 1e3:.1f} ms; steady state "
        f"{replayed['steady_step_ms']:.1f} ms/step ({card})")
    if faults:
        raise PhaseFailed("[recovery] fits failed their checks: "
                          + "; ".join(faults))
    return {
        "recovery_s": recovery_s,
        "respawn_call_s": killed["respawn_call_s"],
        "replay_s": replayed["replay_s"],
        "window_wait_s": {"clean": clean["window_wait_s"],
                          "sigkill": killed["window_wait_s"],
                          "corrupt": replayed["window_wait_s"]},
        "steady_step_ms": {"clean": clean["steady_step_ms"],
                           "sigkill": killed["steady_step_ms"],
                           "corrupt": replayed["steady_step_ms"]},
        "first_window_s": {"clean": clean["first_window_s"],
                           "sigkill": killed["first_window_s"],
                           "corrupt": replayed["first_window_s"]},
        "losses": clean["losses"],
    }


def process_shuffle_drain(session, sentinel=None):
    """The global-shuffle path with PROCESS producers: four instances in
    this process, each a WorkerSet of one spawned producer exchanging
    over ``ShmRendezvous(session)``, each loader draining its windows
    onto cuda:0 through the staged engine.  With ``sentinel``, instance
    0's producer SIGKILLs itself at its refill ``shuffle_kill_at`` and a
    watchdog respawns it.  Returns (per-instance windows as card tensors
    of shape (rows, cols) per epoch, the loaders' metrics, the drain's
    seconds, the watchdog's respawns)."""
    import threading

    import torch

    from ddl_tpu_torch import DistributedDataLoader, Marker, RunMode, Topology
    from ddl_tpu_torch.env import WorkerSet
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.shuffle import ShmRendezvous, ThreadExchangeShuffler
    from ddl_tpu_torch.watchdog import Watchdog

    sh, rc = SHUFFLE, RECOVERY
    factory = ThreadExchangeShuffler.factory(rendezvous=ShmRendezvous(session))
    streams, metrics, errors = {}, {}, []
    sets = [None] * sh["n"]
    t0 = time.perf_counter()
    for i in range(sh["n"]):  # the spawns start together
        sets[i] = WorkerSet(
            Topology(n_instances=sh["n"], instance_idx=i, n_producers=1,
                     mode=RunMode.PROCESS),
            nslots=2, pin_memory=True, shuffler_factory=factory)
    wd = None
    if sentinel is not None:
        wd = Watchdog(sets[0], poll_interval_s=0.2, stall_budget_s=60.0,
                      respawn=True, metrics=Metrics()).start()

    def run_instance(i):
        try:
            metrics[i] = Metrics()
            producer = PoolProducer(
                i, sh["rows"], sh["cols"],
                sentinel=sentinel if i == 0 else None,
                kill_at=rc["shuffle_kill_at"] if i == 0 else 0)
            loader = DistributedDataLoader(
                producer, batch_size=sh["batch_size"],
                connection=sets[i].connection, n_epochs=sh["n_epochs"],
                global_shuffle_fraction_exchange=sh["fraction"],
                output="device", device="cuda", metrics=metrics[i],
                timeout_s=120.0)
            wins = []
            for win in loader.windows(lookahead=1):
                wins.append(win.reshape(-1, sh["cols"]))
                loader.mark(Marker.END_OF_EPOCH)
            torch.cuda.current_stream().synchronize()
            streams[i] = wins
            loader.shutdown()
        except Exception as e:  # reported by the main thread
            errors.append((f"instance {i}", repr(e)))

    ts = [threading.Thread(target=run_instance, args=(i,))
          for i in range(sh["n"])]
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    wall = time.perf_counter() - t0
    if wd is not None:
        wd.stop()
    for ws in sets:
        ws.abort()
        ws.join(30.0)
    if any(t.is_alive() for t in ts) or errors:
        raise PhaseFailed(f"PROCESS shuffle drain failed: {errors or 'hung'}")
    codes = [ws.exitcodes for ws in sets]
    if codes != [[0]] * sh["n"]:
        raise PhaseFailed(f"PROCESS shuffle producers exited with {codes}")
    return streams, metrics, wall, list(wd.respawns) if wd else []


def recovery_shuffle(tmpdir: str, card: str):
    """(c) The cross-process global shuffle at phase 4's geometry: the
    THREAD tier's host drain, then four PROCESS instances over one
    ShmRendezvous session (byte-identical streams, rows mixed across
    instances, the session directory gone after cleanup), then again
    with instance 0's producer SIGKILLed mid-exchange and respawned
    (every round's windows across the instances partition the rows)."""
    import torch

    from ddl_tpu_torch.shuffle import (
        Rendezvous, ShmRendezvous, ThreadExchangeShuffler, make_session,
    )

    sh = SHUFFLE
    free = _shm_free_bytes()
    if free < RECOVERY_SHM_BYTES:
        raise PhaseFailed(f"/dev/shm has {free} bytes free, the recovery "
                          f"phase needs {RECOVERY_SHM_BYTES}")
    rdv = Rendezvous()
    host, _, host_s = drain_instances(
        lambda: ThreadExchangeShuffler.factory(rdv))
    faults = []
    session = make_session("ddl-smoke")
    proc, pmetrics, proc_s, _ = process_shuffle_drain(session)
    board = ShmRendezvous(session)
    board.cleanup()
    if os.path.exists(board._dir):
        faults.append(f"session directory {board._dir} left after cleanup")
    for i in range(sh["n"]):
        got = torch.cat(proc[i])
        same = torch.equal(_bytes(got), _bytes(host[i]))
        origin = (got[:, 0] / 1e6).floor().long().view(sh["n_epochs"], -1)
        mixed = all(bool((e != i).any()) for e in origin[1:])
        m = pmetrics[i]
        routes = (m.counter("staging.alias_windows") == sh["n_epochs"]
                  and m.counter("ingest.registered_rings") == 1
                  and m.counter("staging.alias_fallbacks") == 0
                  and m.counter("staging.inline_fallbacks") == 0
                  and m.counter("transport.rings.NativeShmRing") == 1)
        log(f"[recovery-shuffle] PROCESS instance {i}: stream byte-identical "
            f"to the THREAD host drain's {same}, rows from other instances "
            f"{mixed}, alias route on a registered native ring {routes}")
        if not (same and mixed and routes):
            faults.append(f"instance {i}: same {same} mixed {mixed} "
                          f"routes {routes}")
    sentinel = os.path.join(tmpdir, "shuffle-killed")
    session2 = make_session("ddl-smoke")
    killed, kmetrics, killed_s, respawns = process_shuffle_drain(
        session2, sentinel=sentinel)
    ShmRendezvous(session2).cleanup()
    import numpy as np

    everything = np.sort(np.concatenate([
        i * 1e6 + np.arange(sh["rows"]) for i in range(sh["n"])]))
    partitions = all(
        np.array_equal(np.sort(torch.cat([killed[i][e][:, 0]
                                          for i in range(sh["n"])])
                               .cpu().numpy().astype(np.float64)),
                       everything)
        for e in range(sh["n_epochs"]))
    still_same = all(torch.equal(_bytes(torch.cat(killed[i])),
                                 _bytes(host[i])) for i in range(sh["n"]))
    log(f"[recovery-shuffle] SIGKILL of instance 0's producer at its refill "
        f"{RECOVERY['shuffle_kill_at']}: fired {os.path.exists(sentinel)}, "
        f"respawns {respawns}, every round partitions the rows {partitions}, "
        f"streams still byte-identical to the THREAD drain's {still_same}")
    if not (os.path.exists(sentinel) and respawns == [1] and partitions):
        faults.append(f"kill run: respawns {respawns}, partitions "
                      f"{partitions}")
    log(f"[recovery-shuffle] drains: THREAD host {host_s:.3f} s, PROCESS "
        f"{proc_s:.3f} s, PROCESS with a SIGKILL and a respawn "
        f"{killed_s:.3f} s (spawns included; {card})")
    if faults:
        raise PhaseFailed("[recovery-shuffle] failed its checks: "
                          + "; ".join(faults))
    return {"thread_drain_s": host_s, "process_drain_s": proc_s,
            "process_killed_drain_s": killed_s, "respawns": respawns,
            "killed_streams_identical": still_same}


def phase_recovery(tmpdir: str, card: str):
    """Phase 7: recovery in PROCESS mode — the respawned producer, the
    quarantine and replay of a corrupt slot, and the cross-process global
    shuffle with a producer death during the exchange."""
    t0 = time.perf_counter()
    fits = recovery_fits(tmpdir, card)
    shuffle = recovery_shuffle(tmpdir, card)
    free_device_memory()
    log(f"[recovery] phase 7 took {time.perf_counter() - t0:.1f} s")
    return {"fits": fits, "shuffle": shuffle}


def free_device_memory() -> None:
    """Drop what a finished fit left cached, so the next full-width fit
    (~43 GiB peak each) starts on an empty card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[mem] after freeing: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one more of each fit, of the "
                    "device-fabric drain and of a dp=4 ICI drain with "
                    "torch.profiler")
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import ddl_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the ddl_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    try:
        card = phase_build()
        kernels = phase_kernels()
        free_device_memory()
        phase_model_check()
        shuffle_row, shuffle_summary = phase_shuffle(args.profile)
        free_device_memory()
        with tempfile.TemporaryDirectory() as tmp:
            ici_rows, ici_summary = phase_ici(tmp, args.profile)
            free_device_memory()
            launches, summary = phase_train(tmp, card, args.profile)
            packed_launches, packed_summary = phase_train(
                tmp, card, args.profile, packed=True)
            recovery_summary = phase_recovery(tmp, card)
        # Each kernel's launches come from the run of its own path.
        for row in kernels:
            row["launches"] = (packed_launches if row["name"].endswith("_seg")
                               else launches)[row["name"]]
        kernels.append(shuffle_row)
        kernels.extend(ici_rows)
        log(f"[summary-shuffle] {json.dumps(shuffle_summary)}")
        log(f"[summary-ici] {json.dumps(ici_summary)}")
        log(f"[summary] {json.dumps(summary)}")
        log(f"[summary-packed] {json.dumps(packed_summary)}")
        log(f"[summary-recovery] {json.dumps(recovery_summary)}")
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
