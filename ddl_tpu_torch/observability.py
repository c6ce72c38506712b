"""Observability: counters, gauges, timers, histograms (port of
``ddl_tpu/observability.py``).

Producers, the loader, the ingestor and the trainer record into one
shared registry: :func:`metrics` (the process default) or an explicit
instance injected by the caller.  A PROCESS-mode producer records into
its own process's registry; it ships cumulative snapshots of it to the
consumer (:mod:`ddl_tpu_torch.obs.aggregate`), which adopts them under
``producer.<idx>.*`` (:meth:`Metrics.adopt`).

Beyond counters, gauges and timers, :meth:`Metrics.observe` records
values into fixed log-spaced bounded histograms
(:data:`HIST_BUCKETS_PER_DECADE` buckets per decade over
[:data:`HIST_MIN`, :data:`HIST_MAX`)), the JAX package's bucket layout,
and :meth:`Metrics.quantile` reads percentiles back.
:func:`install_event_tap` feeds every metric event to the flight
recorder (:mod:`ddl_tpu_torch.obs.recorder`).  ``snapshot()``'s keys are
the JAX package's.

The staging engine (``staging.py``) records the JAX package's names:
counters ``staging.pool_hits``, ``staging.pool_misses``,
``staging.pool_alias_drops``, ``staging.alias_windows``,
``staging.alias_fallbacks``, ``staging.retries``,
``staging.inline_fallbacks`` and ``integrity.staging_verify_failures``;
timers ``ingest.stage_copy``, ``ingest.transfer`` and ``ingest.stall``.
The loader adds ``consumer.handshake``, ``ingest.registered_rings`` and
``transport.rings.<ring class>``, the timer ``consumer.wait``, and the
histograms ``consumer.window_latency`` and ``consumer.admission_wait``;
the trainer the timers ``trainer.first_window`` (start-up),
``trainer.windows`` (every step after it, on the card's clock) and
``trainer.window_wait``, the counter ``trainer.overlapped_windows``
(fused-loop windows taken while the previous window's steps still ran),
and ``producer.exits_clean`` / ``producer.exits_failed``.
``profiling.annotate`` feeds the timers that share a host range's stage
(:mod:`ddl_tpu_torch.profiling` lists the pairs).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Dict, List, Optional

from ddl_tpu_torch.concurrency import named_lock


@dataclasses.dataclass
class Timer:
    """Accumulates total seconds and call count for one labelled section."""

    total_s: float = 0.0
    count: int = 0

    def add(self, dt: float) -> None:
        self.total_s += dt
        self.count += 1


#: Histogram geometry: FIXED log-spaced buckets, identical in every
#: process — cross-process aggregation (ddl_tpu_torch.obs) merges bucket
#: counts elementwise, which is only sound when every registry shares
#: one bucket layout.  6 buckets/decade ⇒ a bucket spans ×10^(1/6)
#: ≈ 1.47, so an interpolated quantile is exact to within ±47% — ample
#: for the order-of-magnitude questions p99s answer (and the reason
#: quantile() interpolates geometrically inside the bucket).
HIST_BUCKETS_PER_DECADE = 6
#: Values below HIST_MIN (including zero and negatives) land in the
#: underflow bucket; values >= HIST_MAX in the overflow bucket — the
#: histogram is BOUNDED by construction (DDL023's whole point).
HIST_MIN = 1e-7
HIST_MAX = 1e5
_HIST_DECADES = 12  # log10(HIST_MAX / HIST_MIN)
_HIST_N = HIST_BUCKETS_PER_DECADE * _HIST_DECADES  # finite buckets


def hist_bounds() -> List[float]:
    """Upper bounds of the finite buckets (shared, fixed layout)."""
    return [
        HIST_MIN * 10.0 ** ((i + 1) / HIST_BUCKETS_PER_DECADE)
        for i in range(_HIST_N)
    ]


class Histogram:
    """One bounded log-spaced histogram (see :func:`hist_bounds`).

    Layout: ``counts[0]`` is the underflow bucket (< HIST_MIN, incl. 0
    and negatives), ``counts[1+i]`` covers
    ``[HIST_MIN·10^(i/6), HIST_MIN·10^((i+1)/6))``, and ``counts[-1]``
    is the overflow bucket (>= HIST_MAX).  ``min``/``max`` track exact
    extremes so quantiles clamp to observed reality instead of bucket
    edges.  NOT thread-safe on its own — :class:`Metrics` serializes
    access under its registry lock.
    """

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self) -> None:
        self.counts = [0] * (_HIST_N + 2)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        if v < HIST_MIN:
            idx = 0
        elif v >= HIST_MAX:
            idx = _HIST_N + 1
        else:
            idx = 1 + int(
                math.log10(v / HIST_MIN) * HIST_BUCKETS_PER_DECADE
            )
            # Float round-off at an exact bucket edge can land one off.
            idx = max(1, min(idx, _HIST_N))
        self.counts[idx] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        """Interpolated quantile (geometric within the bucket), clamped
        to the exact observed [min, max].  0.0 when empty."""
        if self.count == 0:
            return 0.0
        q = min(1.0, max(0.0, q))
        target = q * self.count
        seen = 0.0
        idx = len(self.counts) - 1
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                idx = i
                break
        if idx == 0:
            lo, hi = 0.0, HIST_MIN
        elif idx == _HIST_N + 1:
            lo, hi = HIST_MAX, max(self.max, HIST_MAX)
        else:
            lo = HIST_MIN * 10.0 ** ((idx - 1) / HIST_BUCKETS_PER_DECADE)
            hi = HIST_MIN * 10.0 ** (idx / HIST_BUCKETS_PER_DECADE)
        # Geometric midpoint-ish interpolation by rank within the bucket.
        c = self.counts[idx]
        frac = (target - (seen - c)) / c if c else 0.5
        frac = min(1.0, max(0.0, frac))
        if lo <= 0.0:
            est = hi * frac
        else:
            est = lo * (hi / lo) ** frac
        return float(min(max(est, self.min), self.max))

    # -- cross-process merge/transport (ddl_tpu_torch.obs) -----------------------

    def state(self) -> Dict[str, object]:
        """Portable snapshot (the ObsReport wire format)."""
        return {
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
        }

    @classmethod
    def from_state(cls, d: Dict[str, object]) -> "Histogram":
        h = cls()
        counts = list(d.get("counts") or [])
        if len(counts) == len(h.counts):
            h.counts = [int(c) for c in counts]
        h.count = int(d.get("count", 0))
        h.sum = float(d.get("sum", 0.0))
        h.min = float(d["min"]) if d.get("min") is not None else math.inf
        h.max = float(d["max"]) if d.get("max") is not None else -math.inf
        return h


class Metrics:
    """Thread-safe counter/gauge/timer/histogram registry.

    Producers, the transport and the dataloader all record here; a single
    registry per pipeline is shared via :func:`metrics` (module default) or
    injected explicitly for tests.
    """

    def __init__(self) -> None:
        self._lock = named_lock("obs.metrics")
        self._counters: Dict[str, float] = collections.defaultdict(float)
        self._timers: Dict[str, Timer] = collections.defaultdict(Timer)
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        # Cross-process aggregation (ddl_tpu_torch.obs): prefix -> the LATEST
        # adopted flat snapshot / histogram states of a remote registry
        # (cumulative, so adoption REPLACES — bounded by the producer
        # set by construction).
        self._adopted: Dict[str, Dict[str, float]] = {}
        self._adopted_hists: Dict[str, Dict[str, Histogram]] = {}
        self._t0 = time.perf_counter()

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value
        tap = _EVENT_TAP
        if tap is not None:
            tap("counter", name, value)

    def set_gauge(self, name: str, value: float) -> None:
        """Point-in-time level (queue depth, pool size).  The high-water
        mark rides along as ``<name>.max`` so a burst between snapshots
        is still visible in the bench JSON.  :meth:`clear_gauge` is the
        ONLY correct retirement path — zeroing the base gauge leaves
        the companion pinned at its old peak on purpose (that is what a
        high-water mark is), so a gauge family keyed by a dynamic name
        (``serve.stall.<tenant>``) must be cleared, not zeroed, when
        its owner goes away."""
        with self._lock:
            self._gauges[name] = value
            peak = self._gauges.get(f"{name}.max", value)
            self._gauges[f"{name}.max"] = max(peak, value)
        tap = _EVENT_TAP
        if tap is not None:
            tap("gauge", name, value)

    def clear_gauge(self, name: str) -> None:
        """Retire a gauge AND its ``.max`` high-water companion.

        The companion is derived state: leaving it behind after its
        base gauge is dropped makes a departed owner (an unregistered
        tenant, a torn-down pool) show up as a phantom ``<name>.max``
        entry in :meth:`prefixed`/:meth:`snapshot` between bench reps.
        """
        with self._lock:
            self._gauges.pop(name, None)
            self._gauges.pop(f"{name}.max", None)

    def gauge(self, name: str) -> float:
        with self._lock:
            return self._gauges.get(name, 0.0)

    def add_time(self, name: str, seconds: float) -> None:
        with self._lock:
            self._timers[name].add(seconds)
        tap = _EVENT_TAP
        if tap is not None:
            tap("timer", name, seconds)

    # -- histograms (fixed log-spaced buckets) -----------------------------

    def observe(self, name: str, value: float) -> None:
        """Record one sample into the bounded log-spaced histogram
        ``name`` (created on first observe).  Per-window cost: one lock
        + one log10 — for per-window paths, not per-sample hot loops."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(value)
        tap = _EVENT_TAP
        if tap is not None:
            tap("observe", name, value)

    def quantile(self, name: str, q: float) -> float:
        """Interpolated quantile of histogram ``name`` (0.0 when the
        histogram is empty or was never observed)."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                # Adopted remote histograms (cross-process aggregation)
                # answer under their full prefixed name.
                for prefix, hists in self._adopted_hists.items():
                    if name.startswith(prefix):
                        h = hists.get(name[len(prefix):])
                        if h is not None:
                            break
            return h.quantile(q) if h is not None else 0.0

    def histogram(self, name: str) -> Optional[Histogram]:
        """A copy of histogram ``name`` (None when never observed)."""
        with self._lock:
            h = self._hists.get(name)
            return Histogram.from_state(h.state()) if h is not None else None

    def hist_names(self, prefix: str = "") -> List[str]:
        """Names of observed histograms under ``prefix`` (local +
        adopted, full prefixed names) — report assemblers enumerate
        dynamic families (``ingest.<tenant>.*``) with this."""
        with self._lock:
            out = [k for k in self._hists if k.startswith(prefix)]
            for apfx, hists in self._adopted_hists.items():
                out.extend(
                    f"{apfx}{k}"
                    for k in hists
                    if f"{apfx}{k}".startswith(prefix)
                )
            return sorted(set(out))

    def hist_state(self) -> Dict[str, Dict[str, object]]:
        """Portable state of every local histogram (the ObsReport wire
        format — ``Histogram.from_state`` round-trips it)."""
        with self._lock:
            return {k: h.state() for k, h in self._hists.items()}

    # -- cross-process aggregation (ddl_tpu_torch.obs) ---------------------------

    def adopt(
        self,
        prefix: str,
        snapshot: Dict[str, float],
        hists: Optional[Dict[str, Dict[str, object]]] = None,
    ) -> None:
        """Merge a remote registry's cumulative :meth:`snapshot` (and
        optional :meth:`hist_state`) under ``prefix`` (e.g.
        ``"producer.0."``).  Adoption REPLACES the previous snapshot for
        that prefix — remote snapshots are cumulative, so replacement is
        the only merge that cannot double-count.  Adopted keys surface
        through :meth:`snapshot`, :meth:`prefixed`, :meth:`counter` and
        :meth:`quantile` under their prefixed names."""
        flat = {k: v for k, v in snapshot.items() if isinstance(v, (int, float))}
        parsed = (
            {k: Histogram.from_state(d) for k, d in hists.items()}
            if hists
            else {}
        )
        with self._lock:
            self._adopted[prefix] = flat
            self._adopted_hists[prefix] = parsed

    def adopted_prefixes(self) -> List[str]:
        with self._lock:
            return sorted(self._adopted)

    def timed(self, name: str) -> "_TimedCtx":
        return _TimedCtx(self, name)

    def counter(self, name: str) -> float:
        with self._lock:
            if name in self._counters:
                return self._counters[name]
            for prefix, snap in self._adopted.items():
                if name.startswith(prefix):
                    v = snap.get(name[len(prefix):])
                    if v is not None:
                        return float(v)
            return 0.0

    def timer(self, name: str) -> Timer:
        with self._lock:
            t = self._timers.get(name)
            return Timer(t.total_s, t.count) if t else Timer()

    def elapsed_s(self) -> float:
        return time.perf_counter() - self._t0

    def reset(self) -> None:
        """Zero the registry for a fresh measurement span.  Clears the
        ``.max`` gauge companions WITH their base gauges, the
        histograms, and adopted remote snapshots — a bench rep that
        resets between legs must never report the previous leg's
        high-water marks or percentiles.
        """
        with self._lock:
            self._counters.clear()
            self._timers.clear()
            self._gauges.clear()
            self._hists.clear()
            self._adopted.clear()
            self._adopted_hists.clear()
            self._t0 = time.perf_counter()

    def snapshot(self) -> Dict[str, float]:
        """Flat dict of everything, for logging / bench JSON.

        Histograms surface as ``<name>.p50`` / ``<name>.p99`` /
        ``<name>.count`` summary keys (full bucket state travels via
        :meth:`hist_state`); adopted remote registries surface under
        their prefixes."""
        with self._lock:
            out: Dict[str, float] = dict(self._counters)
            for k, t in self._timers.items():
                out[f"{k}.total_s"] = t.total_s
                out[f"{k}.count"] = float(t.count)
            out.update(self._gauges)
            for k, h in self._hists.items():
                out[f"{k}.p50"] = h.quantile(0.5)
                out[f"{k}.p99"] = h.quantile(0.99)
                out[f"{k}.count"] = float(h.count)
            for prefix, snap in self._adopted.items():
                for k, v in snap.items():
                    out[f"{prefix}{k}"] = v
            out["elapsed_s"] = time.perf_counter() - self._t0
            return out

    def prefixed(self, prefix: str) -> Dict[str, float]:
        """Counters + gauges (and adopted remote keys) under one name
        family (``prefix`` up to and including its trailing dot, e.g.
        ``"cache."``), keys stripped of the prefix — the bench assembles
        its per-subsystem JSON blocks from this instead of hand-listing
        every counter."""
        with self._lock:
            out: Dict[str, float] = {
                k[len(prefix):]: v
                for k, v in self._counters.items()
                if k.startswith(prefix)
            }
            out.update(
                (k[len(prefix):], v)
                for k, v in self._gauges.items()
                if k.startswith(prefix)
            )
            for apfx, snap in self._adopted.items():
                for k, v in snap.items():
                    full = f"{apfx}{k}"
                    if full.startswith(prefix):
                        out[full[len(prefix):]] = v
            return out

    # Derived north-star metrics -------------------------------------------

    def rates(self) -> Dict[str, float]:
        """All derived rates over ONE elapsed snapshot.

        The single formula site: computing each rate with its own "now"
        (as the per-metric helpers below would if called in sequence)
        skews their ratios by the microseconds between calls, which is
        visible on short measurement spans — bytes/s and samples/s must
        agree exactly when their counters cover identical windows.
        """
        with self._lock:
            # ONE critical section for all three reads: a concurrent
            # finish() increments bytes then samples, and observing one
            # without the other would skew the ratio by a window.
            el = time.perf_counter() - self._t0
            samples = self._counters.get("consumer.samples", 0.0)
            nbytes = self._counters.get("ingest.bytes", 0.0)
            wait = self._timers.get("consumer.wait")
            stall = wait.total_s if wait else 0.0
        if el <= 0:
            return {
                "samples_per_sec": 0.0,
                "stall_fraction": 0.0,
                "ingest_bytes_per_sec": 0.0,
                "elapsed_s": el,
            }
        return {
            "samples_per_sec": samples / el,
            "stall_fraction": stall / el,
            "ingest_bytes_per_sec": nbytes / el,
            "elapsed_s": el,
        }

    def samples_per_sec(self) -> float:
        return self.rates()["samples_per_sec"]

    def stall_fraction(self) -> float:
        """Fraction of consumer wall time spent waiting on the pipeline."""
        return self.rates()["stall_fraction"]

    def ingest_bytes_per_sec(self) -> float:
        return self.rates()["ingest_bytes_per_sec"]


class _TimedCtx:
    def __init__(self, m: Metrics, name: str):
        self._m, self._name = m, name

    def __enter__(self) -> "_TimedCtx":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> None:
        self._m.add_time(self._name, time.perf_counter() - self._t0)


#: Optional metric-event tap (the chaos flight recorder's feed,
#: ddl_tpu_torch/obs/recorder.py).  Read unlocked on every metric op — a
#: single module-attribute load is the entire disarmed cost (the
#: faults._ARMED pattern); called OUTSIDE the registry lock so a tap
#: can never deadlock a registry reader.
_EVENT_TAP = None


def install_event_tap(tap) -> None:
    """Install (or, with ``None``, remove) the process-wide metric-event
    tap: ``tap(kind, name, value)`` fires after every ``incr`` /
    ``set_gauge`` / ``add_time`` / ``observe`` on EVERY registry.  One
    tap at a time — the flight recorder owns this seam."""
    global _EVENT_TAP
    _EVENT_TAP = tap


_default = Metrics()


def metrics() -> Metrics:
    """The process-default registry."""
    return _default
