"""Counters, gauges and timers (port of ``ddl_tpu/observability.py``'s
:class:`Metrics`: the counters, gauges and timers the slices record;
histograms, snapshots, cross-process adoption and the event tap serve
later slices).

Producers, the loader, the ingestor and the trainer record into one
shared registry: :func:`metrics` (the process default) or an explicit
instance injected by the caller.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict

from ddl_tpu_torch.concurrency import named_lock


@dataclasses.dataclass
class Timer:
    """Accumulates total seconds and call count for one labelled section."""

    total_s: float = 0.0
    count: int = 0

    def add(self, dt: float) -> None:
        self.total_s += dt
        self.count += 1


class Metrics:
    """Thread-safe counter/gauge/timer registry."""

    def __init__(self) -> None:
        self._lock = named_lock("obs.metrics")
        self._counters: Dict[str, float] = collections.defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._timers: Dict[str, Timer] = collections.defaultdict(Timer)

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def set_gauge(self, name: str, value: float) -> None:
        """Point-in-time level.  The high-water mark rides along as
        ``<name>.max``, so a peak between reads stays visible."""
        with self._lock:
            self._gauges[name] = value
            peak = self._gauges.get(f"{name}.max", value)
            self._gauges[f"{name}.max"] = max(peak, value)

    def gauge(self, name: str) -> float:
        with self._lock:
            return self._gauges.get(name, 0.0)

    def add_time(self, name: str, seconds: float) -> None:
        with self._lock:
            self._timers[name].add(seconds)

    def timed(self, name: str) -> "_TimedCtx":
        return _TimedCtx(self, name)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def timer(self, name: str) -> Timer:
        with self._lock:
            t = self._timers.get(name)
            return Timer(t.total_s, t.count) if t else Timer()


class _TimedCtx:
    def __init__(self, m: Metrics, name: str):
        self._m, self._name = m, name

    def __enter__(self) -> "_TimedCtx":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> None:
        self._m.add_time(self._name, time.perf_counter() - self._t0)


_default = Metrics()


def metrics() -> Metrics:
    """The process-default registry."""
    return _default
