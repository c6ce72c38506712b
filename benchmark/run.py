"""One run of one benchmark cell on one card.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``); its limits are
``benchmark/limits/<workload>.json`` and each metric's reader is
``benchmark/metrics/<metric>.py``.  The run writes the cell's inputs from
the seed under ``TMPDIR``, trains on the port for ``--seconds`` after the
warm-up (with ``--trace 1``, then profiles a few more windows), checks the
judged steps and the consumed stream against the plain reference, and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, ``breakdown`` (traced) and
``checks`` (each compared number with its limit), whose lines also end
standard error.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Top-level module names that must not be loaded once the window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "ddl_tpu")


def _json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, root: str = ROOT) -> Dict[str, Any]:
    """Everything one cell is, found by its name in ``BENCHMARK.json``."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    here = os.path.join(root, "benchmark")

    def mine(metrics: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return {
        "workload": workload,
        "chips": int(cell["chips"]),
        "config": _json(os.path.join(root, configs[cell["config"]]["file"])),
        "traffic": _json(os.path.join(here, "traffic", cell["traffic"] + ".json")),
        "limits": _json(os.path.join(here, "limits", workload + ".json")),
        "end_to_end": mine(bench["end_to_end"]),
        "per_layer": mine(bench["per_layer"]),
    }


def _device_info(device: Any) -> Dict[str, Any]:
    import platform

    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1}
    return {"platform": "cpu", "kind": platform.processor() or "cpu",
            "count": 1}


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def execute(spec: Dict[str, Any], seed: int, seconds: float, trace_on: bool,
            device: Any = "cuda", t0: float = T0,
            loss_wrapper: Any = None) -> Dict[str, Any]:
    """One run of the cell ``spec`` (:func:`cell_spec`); returns the result
    line's object."""
    import torch

    from benchmark import compare, families, generate, metrics, peaks, program
    from benchmark import trace as trace_mod
    from benchmark import reference
    from benchmark.reference import common, stream

    device = torch.device(device)
    config, traffic = spec["config"], spec["traffic"]
    fam = families.load(config["family"])
    with tempfile.TemporaryDirectory(prefix="bench-") as scratch:
        inputs = generate.write_inputs(traffic, config, seed, scratch, device)
        prun = program.run(config, traffic, inputs, seed, seconds, trace_on,
                           device, scratch, t0, loss_wrapper=loss_wrapper)
        summary = (trace_mod.reduce(prun.trace_path)
                   if prun.trace_path else None)
        dev = _device_info(device)
        unit, per_step = fam.items_per_step(traffic)
        view = metrics.RunView(
            config=config, traffic=traffic, item_unit=unit,
            items_per_step=per_step,
            step_flops=fam.step_flops(config, traffic),
            attention=fam.attention(config, traffic),
            peaks=peaks.lookup(dev["kind"]) if dev["platform"] == "gpu" else None,
            prog=prun, trace=summary)
        values: Dict[str, Any] = {}
        for m in (spec["per_layer"] if trace_on else spec["end_to_end"]):
            v = metrics.reader(m["name"]).read(view)
            if v is None and not trace_on:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
        # The reference: the stream regenerated, then the judged steps.
        spw = int(traffic["steps_per_window"])
        judged = int(traffic["judged_steps"])
        want, whole = stream.expected(inputs, traffic, seed,
                                      prun.windows_consumed,
                                      math.ceil(judged / spw))
        bad = compare.mismatched(prun.row_sums, want)
        ref = reference.train(config, traffic, seed,
                              common.step_batches(whole, traffic, judged),
                              "float32", device)
    checks = compare.readings(prun.losses, prun.grad_norms, prun.delta_norms,
                              ref.losses, ref.grad_norms, ref.delta_norms, bad)
    limits = spec["limits"]
    dev["memory_peak_bytes"] = prun.memory_peak_bytes
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    out: Dict[str, Any] = {
        "correct": compare.judge(checks, limits),
        "attempted": prun.windows_consumed * spw,
        "failed": bad * spw,
        "metrics": values,
        "device": dev,
    }
    if summary is not None:
        out["breakdown"] = {"device_ops": summary.device_ops(),
                            "idle_gaps": summary.idle_gaps()}
    out["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                     for k in compare.NAMES}
    out["_setup_phases"] = prun.setup_phases
    out["_readings"] = {"program": {"losses": prun.losses,
                                    "grad_norms": prun.grad_norms,
                                    "delta_norms": prun.delta_norms},
                        "reference": {"losses": ref.losses,
                                      "grad_norms": ref.grad_norms,
                                      "delta_norms": ref.delta_norms}}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    spec = cell_spec(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"benchmark: the cell needs {spec['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = execute(spec, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: forbidden modules loaded: {loaded}", file=sys.stderr)
        return 4
    readings = out.pop("_readings")
    print(f"benchmark: set-up phases (s from start) "
          f"{json.dumps(out.pop('_setup_phases'))}", file=sys.stderr)
    print(f"benchmark: readings {json.dumps(readings)}", file=sys.stderr)
    print(f"benchmark: card {_power_limit()}", file=sys.stderr)
    print(f"benchmark: memory_peak_bytes {out['device']['memory_peak_bytes']}",
          file=sys.stderr)
    limits = {k: v["limit"] for k, v in out["checks"].items()}
    values = {k: v["value"] for k, v in out["checks"].items()}
    from benchmark import compare

    for line in compare.lines(values, limits):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
