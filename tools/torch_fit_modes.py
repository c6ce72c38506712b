#!/usr/bin/env python3
"""Alternate THREAD and PROCESS fits of the port on one NVIDIA card.

    python3 tools/torch_fit_modes.py [--pairs 3] [--packed] [--trace]

Each fit is ``chip_smoke.py``'s phase-6 fit (``_fit_mode``: Llama-3-8B
widths cut to 2 layers, B=4, T=2048, 3 windows, a fresh ``Trainer`` from
``init_params(seed=0)``, a one-window warm-up fit, then the measured
fit), run in turns THREAD, PROCESS, PROCESS, THREAD, ... so that the two
modes meet the same card state.  Each line gives a fit's time to the
first window, its steady state (every step from the first window to the
end of the last steps, on the card's clock) and its teardown, with the SM clock and power
``nvidia-smi`` read every 0.2 s over the fit.  ``--trace`` adds, per
measured fit, each step's start on the host clock and on the card (a
timing event recorded as the loss function runs), and the host time
spent in the loader's shutdown and in unregistering the rings: where a
slow steady state went.  A comparison tool: it checks nothing that
``chip_smoke.py`` does not.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Clocks:
    """``clocks.sm`` and ``power.draw`` sampled in a thread."""

    def __init__(self):
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(0.2):
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=10)
            if out.returncode == 0:
                sm, power = out.stdout.strip().splitlines()[0].split(",")
                self.samples.append((float(sm), float(power)))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(10)


class _Trace:
    """Per-step host and card timestamps of the last fit, and the host
    time of the loader's shutdown and of each ``page_unlock``."""

    def __init__(self):
        import time

        import torch

        from ddl_tpu_torch.dataloader import DistributedDataLoader
        from ddl_tpu_torch.ops import host_register

        self._time, self._torch = time, torch
        self.reset()
        for owner, name, key in ((DistributedDataLoader, "shutdown", "shutdown"),
                                 (host_register, "page_unlock", "unlock"),
                                 (host_register, "page_lock", "lock")):
            setattr(owner, name, self._timed(getattr(owner, name), key))

    def reset(self):
        self.host, self.events, self.spans = [], [], []

    def _timed(self, fn, key):
        def timed(*a, **kw):
            t0 = self._time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.spans.append((key, t0, self._time.perf_counter()))
        return timed

    def wrap(self, loss_fn):
        def traced(p, b):
            ev = self._torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            self.host.append(self._time.perf_counter())
            return loss_fn(p, b)
        return traced

    def report(self):
        # The measured fit's steps are the last six loss calls.
        ev, host = self.events[-6:], self.host[-6:]
        t0 = host[0]
        return {
            "step_host_ms": [round((h - t0) * 1e3, 2) for h in host],
            "step_card_ms": [round(ev[0].elapsed_time(e), 2) for e in ev],
            "spans_ms": [(k, round((a - t0) * 1e3, 2), round((b - a) * 1e3, 2))
                         for k, a, b in self.spans],
        }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_fit_modes: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.readers import PackedTokenProducer, TokenStreamProducer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    tr = cs.TRAIN
    cfg = cs.dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                                 n_layers=tr["n_layers"])
    order = ["thread", "process", "process", "thread"] * args.pairs
    order = order[:2 * args.pairs]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens.bin")
        if args.packed:
            cs.documents(tr["n_tokens"]).tofile(path)
            producer = PackedTokenProducer(path, tr["seq_len"],
                                           tr["window_rows"],
                                           delimiter=cs.EOT, seed=cs.SEED)

            def loss_fn(p, b):
                return llama.next_token_loss(p, b[0], cfg, segment_ids=b[1])
        else:
            ranks = np.random.default_rng(cs.SEED).zipf(1.2, tr["n_tokens"]) - 1
            (ranks % cfg.vocab).astype(np.int32).tofile(path)
            producer = TokenStreamProducer(path, tr["seq_len"],
                                           tr["window_rows"], seed=cs.SEED)

            def loss_fn(p, b):
                return llama.next_token_loss(p, b[0], cfg)
        trace = _Trace() if args.trace else None
        if trace is not None:
            loss_fn = trace.wrap(loss_fn)
        for i, mode in enumerate(order):
            if trace is not None:
                trace.reset()
            with _Clocks() as clocks:
                s = cs._fit_mode(mode, producer, loss_fn, cfg,
                                 f"[fit {i}]", card)
            sm = [c for c, _ in clocks.samples]
            power = [p for _, p in clocks.samples]
            print(json.dumps({
                "fit": i, "mode": mode, "first_window_s": s["first_window_s"],
                "steady_step_ms": s["steady_step_ms"],
                "teardown_s": s["teardown_s"], "step_ms": s["step_ms"],
                "losses": s["losses"],
                "sm_mhz_min": min(sm, default=None),
                "sm_mhz_mean": sum(sm) / len(sm) if sm else None,
                "power_w_max": max(power, default=None),
                "card": card,
                **(trace.report() if trace is not None else {}),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
