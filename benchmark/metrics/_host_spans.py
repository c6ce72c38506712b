"""The port's host ranges in a run's traced window (its
``profiling.annotate`` ranges, on every thread), read once a run from
the Chrome trace at ``run.prog.trace_path`` for the readers that time
them."""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional

from benchmark import trace

#: The categories a ``record_function`` range takes in the trace.
RANGE_CATS = ("user_annotation", "cpu_op", "python_function")


@functools.lru_cache(maxsize=1)
def _durations(path: str, mtime_ns: int, size: int) -> Dict[str, List[float]]:
    out: Dict[str, List[float]] = {}
    for ev in trace._load(path):
        if (ev.get("ph") == "X"
                and str(ev.get("cat", "")).lower() in RANGE_CATS):
            out.setdefault(str(ev.get("name", "")), []).append(
                float(ev.get("dur", 0.0)) * 1e-6)
    return out


def durations(run, name: str) -> List[float]:
    """Seconds of each ``name`` range in the traced window (empty when
    the run was not traced or the program opens no such range)."""
    path = run.prog.trace_path
    if not path:
        return []
    st = os.stat(path)
    return list(_durations(path, st.st_mtime_ns, st.st_size).get(name, []))


def per_step_ms(run, name: str) -> Optional[float]:
    """The ``name`` ranges' milliseconds a traced step, or None."""
    spans = durations(run, name)
    if not spans or not run.traced_steps:
        return None
    return 1e3 * sum(spans) / run.traced_steps
