#!/usr/bin/env python3
"""Drive the ddl_tpu_torch port on one NVIDIA card and check it.

    python3 chip_smoke.py            # the three phases below
    python3 chip_smoke.py --profile  # + a torch.profiler breakdown of one fit

Phase 1 builds the hand-written CUDA kernels from the sources in this
checkout (``ddl_tpu_torch/ops/csrc``) and identifies the card.
Phase 2 holds each kernel against its plain PyTorch version at the main
path's attention shapes (plus a ragged length, fp32, and a call whose
query rows are all masked), times kernel, plain version and the PyTorch
library call, and computes each kernel's bound.
Phase 3 runs the port's main path: ``Trainer.fit`` in THREAD mode over a
``TokenStreamProducer`` window stream, at Llama-3-8B's published widths
cut to 2 layers, with random weights from a seed; it also checks the
model's loss and gradients through the kernels against the dense path on
a small input.

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


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailed(Exception):
    pass


# ------------------------------------------------------------- phase 1 ---

def phase_build():
    from ddl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build("flash_attention")
    log(f"[build] flash_attention.cu -> {os.path.basename(lib)} "
        f"in {time.perf_counter() - t0:.1f} s")
    report = lib.parent / f"{lib.name}.log"
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[ptxas] {line.strip()}")
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


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _case(name, B, Tq, Tk, H, Hkv, D, dtype, q_off, k_off, causal, tol, gen):
    """One kernel-vs-plain comparison: forward out/lse, then dq/dk/dv of a
    loss that weighs both outputs (so the lse cotangent is nonzero)."""
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

    kern = run(lambda a, b, c: fa.flash_attention_with_lse(
        a, b, c, q_off, k_off, causal, rep))
    plain = run(lambda a, b, c: fa.attention_plain(
        a, b, c, q_off, k_off, causal, rep))
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
        and errs["out_abs"] <= tol["out"]
        and errs["lse_abs"] <= tol["lse"]
        and max(errs["dq_rel"], errs["dk_rel"], errs["dv_rel"]) <= tol["grad"]
    )
    log(f"[check] {name}: " + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
        + f" | tol out<={tol['out']} lse<={tol['lse']} grad_rel<={tol['grad']}"
        + f" finite={finite} -> {'ok' if ok else 'FAIL'}")
    if q_off < k_off and causal:
        empty = kern[1][..., : k_off - q_off]
        if not (bool((empty <= -1e29).all())
                and float(kern[0][:, : k_off - q_off].abs().max()) == 0.0
                and float(kern[2][:, : k_off - q_off].abs().max()) == 0.0):
            log(f"[check] {name}: fully masked rows not zero / -1e30 -> FAIL")
            ok = False
    return ok, errs


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
    ]
    ok = True
    errs_main = None
    for c in cases:
        c_ok, errs = _case(*c, gen)
        ok &= c_ok
        if errs_main is None:
            errs_main = errs
    if not ok:
        raise PhaseFailed("a kernel disagrees with its plain version")
    return time_kernels(gen, errs_main)


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

    ms = {
        "fwd": _time_ms(lambda: fa.flash_fwd(q, k, v)),
        "dq": _time_ms(lambda: fa.flash_bwd_dq(q, k, v, dout, lse, delta, dlse)),
        "dkv": _time_ms(lambda: fa.flash_bwd_dkv(q, k, v, dout, lse, delta, dlse)),
    }

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
    # Largest elementwise difference from the plain version in the main
    # case, and (backward) the relative Frobenius error the check holds.
    abs_err = {"fwd": errs["out_abs"], "dq": errs["dq_abs"],
               "dkv": max(errs["dk_abs"], errs["dv_abs"])}
    rel_err = {"fwd": None, "dq": errs["dq_rel"],
               "dkv": max(errs["dk_rel"], errs["dv_rel"])}
    rows_out = []
    for key in ("fwd", "dq", "dkv"):
        flops, nbytes = work[key]
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        name, tpu_fn, line = info[key]
        rows_out.append({
            "name": name,
            "route": "cuda",
            "source": "ddl_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": f"ddl_tpu/ops/flash_attention.py:{line} ({tpu_fn})",
            "launches": 0,
            "max_abs_err": abs_err[key],
            "rel_err": rel_err[key],
            "ms": ms[key],
            "plain_ms": plain_ms[key],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_fwd if key == "fwd" else None,
        })
        log(f"[time] {name}: {ms[key]:.3f} ms  plain {plain_ms[key]:.3f} ms  "
            f"bound {max(t_ops, t_bytes):.4f} ms ({rows_out[-1]['bound_by']})"
            + (f"  sdpa {library_fwd:.3f} ms" if key == "fwd" else ""))
    log(f"[time] sdpa backward (dq, dk, dv together): {sdpa_bwd:.3f} ms")
    return rows_out


# ------------------------------------------------------------- phase 3 ---

def phase_model_check():
    """The model's loss and every gradient through the kernels against the
    dense path, on a small fp32 input (the repo's own oracle)."""
    import torch

    from ddl_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=512, dtype=torch.float32,
                            attn_impl="flash")
    params = llama.init_params(cfg, seed=SEED, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 200), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    grads = []
    losses = []
    for impl in ("flash", "dense"):
        leaves = [t.detach().clone().requires_grad_(True) for t in _leaves(params)]
        tree = _rebuild(params, iter(leaves))
        loss = llama.next_token_loss(tree, tokens, dataclasses.replace(cfg, attn_impl=impl))
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append([t.grad for t in leaves])
    worst = max(_rel(a, b) for a, b in zip(*grads))
    ok = abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1]) and worst <= 1e-4
    log(f"[check] llama fp32 flash vs dense: loss {losses[0]:.6f} vs "
        f"{losses[1]:.6f}, worst grad rel err {worst:.3g} | tol loss rel<=1e-5 "
        f"grad rel<=1e-4 -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("model through the kernels disagrees with the dense path")


def _leaves(tree):
    from ddl_tpu_torch.parallel.train import tree_leaves

    return tree_leaves(tree)


def _rebuild(tree, it):
    from ddl_tpu_torch.parallel.train import tree_map

    return tree_map(lambda _: next(it), tree)


def profile_fit(fit) -> None:
    """Where a fit's device time goes: ``torch.profiler`` over one more
    measured-size fit.  Device-side events only (kernels, copies, sets),
    grouped; busy share is their summed time over the profiled fit's
    wall (the side stream's copies overlap compute, so the sum can
    slightly exceed true occupancy)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
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
            ("flash kernels", ("flash_",)),
            ("GEMM", ("nvjet", "gemm", "cutlass", "xmma")),
            ("optimizer", ("multi_tensor_apply",)),
            ("copies", ("memcpy", "memset")),
        ) if any(k in name for k in keys)), "other elementwise / reductions")
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3
    busy = sum(groups.values())
    log(f"[profile] profiled fit {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({busy / (wall * 1e3):.1%})")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[profile] {ms:9.2f} ms  {ms / busy:6.1%}  {g}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:5d}x  {e.key[:90]}")


def phase_train(tmpdir: str, profile: bool = False):
    import numpy as np
    import torch

    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.readers import TokenStreamProducer
    from ddl_tpu_torch.trainer import Trainer

    tr = TRAIN
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=tr["n_layers"])
    # A Zipf-distributed token stream (the rank-frequency law of text):
    # its unigram skew is learnable within a few steps, so the losses
    # should fall from the random-init level.
    token_file = os.path.join(tmpdir, "tokens.bin")
    ranks = np.random.default_rng(SEED).zipf(1.2, tr["n_tokens"]) - 1
    (ranks % cfg.vocab).astype(np.int32).tofile(token_file)
    log(f"[train] llama3_8b widths, {cfg.n_layers} layers, "
        f"{llama.param_count(cfg) / 1e9:.3f} B params, dtype {cfg.dtype}, "
        f"attn_impl {cfg.attn_impl}")

    params = llama.init_params(cfg, seed=SEED, device="cuda")
    trainer = Trainer(
        loss_fn=lambda p, b: llama.next_token_loss(p, b[0], cfg),
        # No warm-up schedule in a 6-step smoke: a small rate keeps Adam's
        # first, sign-like steps from overshooting at this width.
        optimizer=adamw(1e-5),
        init_params=params,
        device="cuda",
    )
    del params
    producer = TokenStreamProducer(token_file, tr["seq_len"], tr["window_rows"],
                                   seed=SEED)

    def run(n_epochs):
        return trainer.fit(producer, config=LoaderConfig(
            batch_size=tr["batch_size"], n_epochs=n_epochs,
            n_producers=tr["n_producers"], mode="thread", window_stream=True))

    # Warm-up fit (one window: cuBLAS handles, allocator pools), then the
    # measured run with the launch counts set to 0 just before it.
    warm = run(1)
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    result = run(tr["n_epochs"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in fa.KERNELS}

    steps_per_window = tr["window_rows"] // tr["batch_size"]
    steps = tr["n_epochs"] * steps_per_window
    tokens = steps * tr["batch_size"] * tr["seq_len"]
    peak = torch.cuda.max_memory_allocated()
    log(f"[train] per-window losses {result.losses}")
    log(f"[train] {steps} steps in {wall:.3f} s: {wall / steps * 1e3:.1f} ms/step, "
        f"{tokens / wall:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB")
    log(f"[train] kernel launches in this run: {launches} "
        f"(expected {cfg.n_layers} layers x {steps} steps = {cfg.n_layers * steps} each)")
    expected = cfg.n_layers * steps
    ok = (
        len(result.losses) == tr["n_epochs"]
        and all(math.isfinite(x) for x in result.losses)
        and all(n == expected for n in launches.values())
    )
    if not ok:
        raise PhaseFailed("training run failed its checks")
    summary = {
        "step_ms": wall / steps * 1e3, "tokens_per_s": tokens / wall,
        "peak_bytes": peak, "losses": result.losses, "steps": steps,
    }
    del result
    if profile:
        profile_fit(lambda: run(tr["n_epochs"]))
    return launches, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one more fit with torch.profiler")
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
        phase_model_check()
        with tempfile.TemporaryDirectory() as tmp:
            launches, summary = phase_train(tmp, args.profile)
        for row in kernels:
            row["launches"] = launches[row["name"]]
        log(f"[summary] {json.dumps(summary)}")
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
