"""The traced window: a ``torch.profiler`` trace of the card's operations
and the host's named ranges over a few windows after the measured one,
reduced to what the per-layer readers take.

Device operations are the trace's kernels, copies and sets.  The busy
time is the union of their intervals; the traced window runs from the
first one's start to the last one's end.  Each idle gap in it is named by
the innermost ``ddl.*`` host range (the port's ``profiling.annotate``)
that covers its middle, on any thread, or ``host`` where none does.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    """Starts and stops one profiler over CPU and CUDA activity, all
    threads, and writes its Chrome trace under ``directory``."""

    def __init__(self, directory: str):
        self.directory = directory
        self._prof: Any = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        try:
            config = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        except (AttributeError, TypeError):
            config = None  # an older torch: the calling thread's ranges
        self._prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            experimental_config=config)
        self._prof.start()

    def stop(self) -> str:
        self._prof.stop()
        path = os.path.join(self.directory, "trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        return path


@dataclasses.dataclass
class Summary:
    """One traced window, in seconds."""

    window_s: float
    busy_s: float
    #: device operations: (name, category, start, duration, correlation)
    ops: List[Tuple[str, str, float, float, Optional[int]]]
    #: idle gaps: (host range or "host", seconds)
    gaps: List[Tuple[str, float]]
    #: kernel-launch correlations made inside each named host range
    launched_in: Dict[str, set]

    def device_ops(self, top: int = 10) -> List[List[Any]]:
        """The operations that took most time, summed by name."""
        by: Dict[str, float] = {}
        for name, _, _, dur, _ in self.ops:
            by[name] = by.get(name, 0.0) + dur
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List[Any]]:
        """Idle time summed by what the host was doing."""
        by: Dict[str, float] = {}
        for name, dur in self.gaps:
            by[name] = by.get(name, 0.0) + dur
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _load(path: str) -> List[Dict[str, Any]]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def reduce(path: str, range_patterns: Tuple[str, ...] = (r"^Optimizer\.step",)
           ) -> Optional[Summary]:
    """The trace at ``path`` as a :class:`Summary`, or None when it holds
    no device operation.  ``range_patterns`` name the host ranges whose
    kernel launches :attr:`Summary.launched_in` collects."""
    events = _load(path)
    ops: List[Tuple[str, str, float, float, Optional[int]]] = []
    ranges: List[Tuple[str, float, float]] = []
    launches: List[Tuple[int, float, int]] = []
    named: List[Tuple[str, int, float, float]] = []
    pats = [re.compile(p) for p in range_patterns]
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        ts, dur = float(ev.get("ts", 0.0)) * 1e-6, float(ev.get("dur", 0.0)) * 1e-6
        name = str(ev.get("name", ""))
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            ops.append((name, cat, ts, dur, args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if args.get("correlation") is not None:
                launches.append((ev.get("tid"), ts, args["correlation"]))
        elif cat in ("user_annotation", "cpu_op", "python_function"):
            if name.startswith("ddl."):
                ranges.append((name, ts, ts + dur))
            if any(p.search(name) for p in pats):
                named.append((name, ev.get("tid"), ts, ts + dur))
    if not ops:
        return None
    ops.sort(key=lambda o: o[2])
    start = ops[0][2]
    end = max(o[2] + o[3] for o in ops)
    busy = 0.0
    gaps: List[Tuple[str, float]] = []
    cur_s, cur_e = ops[0][2], ops[0][2] + ops[0][3]
    for _, _, s, d, _ in ops[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((_label(ranges, (cur_e + s) / 2), s - cur_e))
            cur_s, cur_e = s, s + d
        else:
            cur_e = max(cur_e, s + d)
    busy += cur_e - cur_s
    launched_in: Dict[str, set] = {}
    for pat in range_patterns:
        rx = re.compile(pat)
        spans = [(tid, a, b) for n, tid, a, b in named if rx.search(n)]
        launched_in[pat] = {c for tid, t, c in launches
                            if any(tid == rt and a <= t <= b for rt, a, b in spans)}
    return Summary(end - start, busy, ops, gaps, launched_in)


def _label(ranges: List[Tuple[str, float, float]], t: float) -> str:
    inside = [(b - a, n) for n, a, b in ranges if a <= t <= b]
    return min(inside)[1] if inside else "host"
