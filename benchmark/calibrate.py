"""The readings a cell's limits are set from (not run by the benchmark's
own runs).

    python3 -m benchmark.calibrate --workload <name> \\
        [--program-seeds 1,2,...] [--control-seeds 7,8,9] [--out FILE]

- Program seeds: the cell run as the benchmark runs it, with a measured
  window of one window (the judged steps need none), each giving the
  numbers compared and its own judgement under the current limits.  Their
  largest reading is a number's lower end.
- Control seeds: the plain reference put in the program's place, at the
  cell's sizes on its inputs, against the float32 reference: computed in
  float8 (the control, one step below the configuration's bfloat16), with
  half of each batch left out and the mean taken over the rest, with one
  token or pixel of the first batch altered where it is produced, and
  with AdamW's step size 5 % too large.  (A state left unchanged reads 1
  on ``grad_gap`` and the update gaps by their definition and needs no
  run.)  Each is judged by ``compare.judge`` under the cell's limits, as
  a run of the benchmark would be.

One JSON line a reading on standard output, and in ``--out``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import json
import math
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional


def _ints(text: str) -> List[int]:
    return [int(s) for s in text.split(",") if s]


def control_readings(spec: Dict[str, Any], seed: int,
                     device: Any) -> List[Dict[str, Any]]:
    """The control's and the planted faults' readings on one seed."""
    import numpy as np
    import torch

    from benchmark import compare, generate, reference
    from benchmark.reference import common, stream

    config, traffic = spec["config"], spec["traffic"]
    spw, judged = int(traffic["steps_per_window"]), int(traffic["judged_steps"])
    B = int(traffic["batch_size"])
    out = []
    with tempfile.TemporaryDirectory(prefix="bench-") as scratch:
        inputs = generate.write_inputs(traffic, config, seed, scratch, device)
        _, whole = stream.expected(inputs, traffic, seed, 0,
                                   math.ceil(judged / spw))
        batches = common.step_batches(whole, traffic, judged)
    ref = reference.train(config, traffic, seed, batches, "float32", device)

    def reading(kind: str, got, mismatched: int = 0) -> None:
        vals = compare.readings(got.losses, got.grad_norms, got.delta_norms,
                                ref.losses, ref.grad_norms, ref.delta_norms,
                                mismatched)
        out.append({"kind": kind, "seed": seed,
                     "correct": compare.judge(vals, spec["limits"]),
                     "checks": vals,
                     "readings": {"program": dataclasses.asdict(got),
                                  "reference": dataclasses.asdict(ref)}})
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    reading("control_float8", reference.train(config, traffic, seed, batches,
                                              "float8", device))
    half = copy.deepcopy(traffic)
    half["batch_size"] = B // 2
    reading("fault_half_batch", reference.train(
        config, half, seed, [b[:B // 2] for b in batches], "float32", device))
    altered = [np.array(b) for b in batches]
    first = altered[0].reshape(-1)
    if first.dtype == np.int32:
        first[0] = (first[0] + 1) % int(config.get("vocab_size", 2 ** 31 - 1))
    else:
        first[0] += 1.0
    reading("fault_altered_value", reference.train(
        config, traffic, seed, altered, "float32", device),
        mismatched=int(stream.row_sums(altered[0]).tolist()
                       != stream.row_sums(batches[0]).tolist()))
    fast = copy.deepcopy(config)
    fast["optimizer"]["lr"] *= 1.05
    reading("fault_lr_5pct", reference.train(fast, traffic, seed, batches,
                                             "float32", device))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    from benchmark import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run._cache_dirs()
    import torch

    spec = run.cell_spec(args.workload)
    device = torch.device("cuda")
    sink = open(args.out, "a") if args.out else None

    def emit(rec: Dict[str, Any]) -> None:
        rec["workload"] = args.workload
        line = json.dumps(rec)
        print(line, flush=True)
        if sink is not None:
            sink.write(line + "\n")
            sink.flush()

    try:
        for seed in args.program_seeds:
            t0 = time.perf_counter()
            res = run.execute(spec, seed, 0.0, False, device=device, t0=t0)
            emit({"kind": "program", "seed": seed, "correct": res["correct"],
                  "checks": {k: v["value"] for k, v in res["checks"].items()},
                  "setup_s": res["metrics"]["setup_s"]["value"],
                  "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                  "elapsed_s": time.perf_counter() - t0,
                  "readings": res["_readings"]})
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        for seed in args.control_seeds:
            t0 = time.perf_counter()
            for rec in control_readings(spec, seed, device):
                rec["elapsed_s"] = time.perf_counter() - t0
                emit(rec)
    finally:
        if sink is not None:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
