"""Window-lifecycle span tracing: per-window stage events, exportable
as a Chrome/Perfetto ``trace_event`` timeline (port of
``ddl_tpu/obs/spans.py``).

Every window carries a unique identity in its integrity trailer,
``(producer_idx, seq)`` (:mod:`ddl_tpu_torch.integrity`; ``producer_idx``
is the 1-based trailer index, ``seq`` the logical window number).  A
:class:`SpanLog` records timestamped stage events keyed on it at the
pipeline's choke points: producer fill and stamp-commit, consumer
admission and acquire, wire decode, staging copy and transfer, the
ingest transfer, the ICI fan-out, trainer consume, yield and slot
release.

- **Zero cost disarmed.**  Every emission site reads ONE module
  attribute and returns: :func:`t0` returns 0.0 without reading the
  clock, :func:`record` is a no-op.
- **Bounded.**  The event buffer is a ``deque(maxlen=...)``: a forgotten
  armed log drops its oldest events.
- **Lock-cheap.**  One event is one ``deque.append`` of a tuple; draining
  snapshots under a small lock.
- **Cross-process.**  ``DDL_TORCH_TRACE`` carries arming across the spawn
  boundary (PROCESS producers arm on import, as ``DDL_TORCH_FAULT_PLAN``
  does); their span batches ride the ObsReports of
  :mod:`ddl_tpu_torch.obs.aggregate` into the consumer's log, where
  :func:`chrome_trace` stitches the processes' lanes by window id with
  flow arrows.

Timestamps are ``time.perf_counter()`` (CLOCK_MONOTONIC on Linux, one
machine-wide epoch), so producer-process and consumer events share one
axis.  Spans are host time: a span around a launch covers the host's
dispatch, not the card's work (``profiling.trace`` shows the card).
Emit per window, never per sample.
"""

from __future__ import annotations

import collections
import json
import os
import threading

import time

from ddl_tpu_torch import envspec
from ddl_tpu_torch.concurrency import named_lock
from typing import Any, Dict, Iterable, List, Optional, Tuple

#: One recorded event: (t0, t1, stage, producer_idx, seq, pid).
#: ``t1 is None`` marks an instant event (a point, not a span).
#: Timestamps are ``time.perf_counter()`` — CLOCK_MONOTONIC on Linux,
#: whose epoch is machine-wide, so producer-process and consumer
#: events land on one comparable axis without a handshake.
SpanEvent = Tuple[float, Optional[float], str, Optional[int], Optional[int], int]

#: Env var arming a default SpanLog in freshly spawned processes
#: (value: "1"/capacity).  The faults.PLAN_ENV pattern.
TRACE_ENV = "DDL_TORCH_TRACE"

#: Default event capacity (tuples of 6 slots — ~100 B/event, so the
#: default ring tops out around 13 MB).
DEFAULT_CAPACITY = 1 << 17

#: Stage lanes, in waterfall order — the exporter assigns Perfetto
#: ``tid``s in this order so every trace reads top-to-bottom as the
#: window's life: fill -> commit -> admission -> acquire -> decode ->
#: staging -> transfer/fan-out -> consume -> release.
STAGES = (
    "producer.fill",
    "producer.commit",
    "consumer.admission",
    "consumer.acquire",
    "wire.decode",
    "staging.copy",
    "staging.transfer",
    "ingest.transfer",
    "ici.fanout",
    "trainer.consume",
    "consumer.yield",
    "consumer.release",
)


class SpanLog:
    """Bounded, lock-cheap event log (see module docstring)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._events: collections.deque = collections.deque(
            maxlen=self.capacity
        )
        self._lock = named_lock("obs.spans")
        #: Total appends ever (monotone) — ``appended - len(events)``
        #: is the dropped-oldest count; exports surface it so a
        #: truncated trace is never mistaken for a complete one.
        self.appended = 0
        # Shipping cursor state (cross-process aggregation): events
        # drained so far, so each ObsReport carries only the delta.
        self._shipped = 0

    def record(
        self,
        stage: str,
        producer_idx: Optional[int],
        seq: Optional[int],
        t0: float,
        t1: Optional[float] = None,
    ) -> None:
        self._events.append(
            (t0, t1, stage, producer_idx, seq, os.getpid())
        )
        self.appended += 1
        rec = _recorder()
        if rec is not None:
            rec.note("span", stage, t1 - t0 if t1 is not None else 0.0,
                     producer_idx=producer_idx, seq=seq)

    def record_many(self, events: Iterable[SpanEvent]) -> None:
        """Adopt a batch of already-formed events (cross-process
        aggregation: producer span deltas land here with their own
        pids intact)."""
        with self._lock:
            for ev in events:
                self._events.append(tuple(ev))
                self.appended += 1

    def events(self) -> List[SpanEvent]:
        with self._lock:
            return list(self._events)

    def drain_new(self) -> List[SpanEvent]:
        """Events appended since the last drain (the ObsReport shipping
        cursor).  Overflow-aware: when the ring dropped oldest events
        past the cursor, the drain returns what survives."""
        with self._lock:
            have = list(self._events)
            new_count = self.appended - self._shipped
            self._shipped = self.appended
            if new_count <= 0:
                return []
            return have[-min(new_count, len(have)):]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.appended = 0
            self._shipped = 0

    def stage_totals(self) -> Dict[str, float]:
        """Total span seconds per stage (instants count 0) — the armed
        half of ``ingest.north_star_report``'s ``stage_breakdown``."""
        out: Dict[str, float] = {}
        for t0, t1, stage, _p, _s, _pid in self.events():
            if t1 is not None:
                out[stage] = out.get(stage, 0.0) + (t1 - t0)
        return out


#: The armed log, or None.  Read unlocked on every emission site — a
#: single module-attribute load is the entire disarmed cost.
_ARMED: Optional[SpanLog] = None

#: Thread-local current-window context: set by the window stream around
#: nested transfer/fan-out calls that have no identity of their own
#: (DeviceIngestor.put_window, IciDistributor.put), cleared after.
_CTX = threading.local()


def armed() -> bool:
    return _ARMED is not None


def log() -> Optional[SpanLog]:
    return _ARMED


def arm(span_log: Optional[SpanLog], export: bool = False) -> Optional[SpanLog]:
    """Arm ``span_log`` process-wide (``None`` disarms).  ``export=True``
    publishes :data:`TRACE_ENV` so PROCESS producers spawned afterwards
    arm their own log on import.  Returns the previously armed log."""
    global _ARMED
    prev = _ARMED
    _ARMED = span_log
    if export:
        if span_log is None:
            os.environ.pop(TRACE_ENV, None)
        else:
            os.environ[TRACE_ENV] = str(span_log.capacity)
    return prev


class tracing:
    """Context manager: arm a SpanLog for a scoped traced run.

    ::

        with obs.tracing(export=True) as span_log:
            run_pipeline()
        obs.write_chrome_trace(span_log.events(), "trace.json")

    Restores the previous log (and the env var) on exit, even when the
    pipeline under test raises — the ``faults.armed`` shape.
    """

    def __init__(
        self,
        span_log: Optional[SpanLog] = None,
        export: bool = False,
        capacity: int = DEFAULT_CAPACITY,
    ):
        self.span_log = span_log or SpanLog(capacity=capacity)
        self.export = export
        self._prev: Optional[SpanLog] = None
        self._prev_env: Optional[str] = None

    def __enter__(self) -> SpanLog:
        self._prev_env = envspec.raw(TRACE_ENV)
        self._prev = arm(self.span_log, export=self.export)
        return self.span_log

    def __exit__(self, *exc: Any) -> None:
        arm(self._prev)
        if self.export:
            if self._prev_env is None:
                os.environ.pop(TRACE_ENV, None)
            else:
                os.environ[TRACE_ENV] = self._prev_env


# -- emission primitives (the per-site API) --------------------------------


def t0() -> float:
    """Span start: the clock when armed, 0.0 (no clock read) disarmed."""
    return time.perf_counter() if _ARMED is not None else 0.0


def record(
    stage: str,
    producer_idx: Optional[int],
    seq: Optional[int],
    t_start: float,
    t_end: Optional[float] = None,
) -> None:
    """Record a completed span (``t_end`` defaults to now).  No-op (one
    attribute read) disarmed."""
    span_log = _ARMED
    if span_log is None:
        return
    span_log.record(
        stage, producer_idx, seq, t_start,
        time.perf_counter() if t_end is None else t_end,
    )


def mark(stage: str, producer_idx: Optional[int], seq: Optional[int]) -> None:
    """Record an instant event.  No-op disarmed."""
    span_log = _ARMED
    if span_log is None:
        return
    span_log.record(stage, producer_idx, seq, time.perf_counter(), None)


def set_window(producer_idx: Optional[int], seq: Optional[int]) -> None:
    """Publish the current thread's window identity for nested emission
    sites that cannot see it (put_window, the ICI distributor).  No-op
    disarmed."""
    if _ARMED is None:
        return
    _CTX.window = (producer_idx, seq)


def clear_window() -> None:
    if _ARMED is None:
        return
    _CTX.window = None


def current_window() -> Tuple[Optional[int], Optional[int]]:
    return getattr(_CTX, "window", None) or (None, None)


def _recorder():
    """The armed flight recorder, lazily resolved (import-cycle-free:
    recorder.py never imports spans)."""
    from ddl_tpu_torch.obs import recorder

    return recorder.armed_recorder()


# -- Chrome/Perfetto export ------------------------------------------------

#: Stages emitted by producer-side code: flow arrows start at the LAST
#: producer-side event of a window and finish at the first
#: consumer-side one, stitching the two process lanes by window id.
_PRODUCER_STAGES = ("producer.fill", "producer.commit", "pusher.")


def _is_producer_stage(stage: str) -> bool:
    return any(stage.startswith(p) for p in _PRODUCER_STAGES)


def chrome_trace(events: Iterable[SpanEvent]) -> Dict[str, Any]:
    """Build a Chrome ``trace_event`` object (Perfetto-loadable).

    - One Perfetto *process* per OS pid seen in the events; one
      *thread lane* per stage, ordered by :data:`STAGES` so every
      window reads as a top-to-bottom waterfall.
    - Spans are ``ph: "X"`` complete events; instants are ``ph: "i"``.
    - Windows whose events span MORE THAN ONE pid (PROCESS-mode
      producer -> consumer) get flow arrows (``ph: "s"``/``"f"``,
      ``id`` = the window identity) from their last producer-side
      event to their first consumer-side one — the cross-process
      stitch.
    """
    evs = sorted(
        (e for e in events),
        key=lambda e: (e[0], e[1] if e[1] is not None else e[0]),
    )
    lane = {s: i for i, s in enumerate(STAGES)}
    next_lane = len(STAGES)
    trace: List[Dict[str, Any]] = []
    pids_named: set = set()
    lanes_named: set = set()
    # window id -> per-pid event lists for flow stitching
    by_window: Dict[Tuple[int, int], List[SpanEvent]] = {}

    for ev in evs:
        s0, s1, stage, pidx, seq, pid = ev
        if stage not in lane:
            lane[stage] = next_lane
            next_lane += 1
        tid = lane[stage]
        if pid not in pids_named:
            pids_named.add(pid)
            trace.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": f"ddl pid {pid}"},
            })
        if (pid, tid) not in lanes_named:
            lanes_named.add((pid, tid))
            trace.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": stage},
            })
            trace.append({
                "ph": "M", "name": "thread_sort_index", "pid": pid,
                "tid": tid, "args": {"sort_index": tid},
            })
        args: Dict[str, Any] = {}
        if pidx is not None:
            args["producer_idx"] = pidx
            args["seq"] = seq
            args["window"] = f"p{pidx}/s{seq}"
            if seq is not None:
                by_window.setdefault((pidx, seq), []).append(ev)
        common = {
            "name": stage, "cat": "ddl", "pid": pid, "tid": tid,
            "ts": s0 * 1e6, "args": args,
        }
        if s1 is None:
            trace.append({**common, "ph": "i", "s": "t"})
        else:
            trace.append({**common, "ph": "X", "dur": (s1 - s0) * 1e6})

    # Flow arrows: producer process -> consumer process, per window.
    for (pidx, seq), wevs in sorted(by_window.items()):
        if len({e[5] for e in wevs}) < 2:
            continue  # single process: lanes already adjacent
        prod = [e for e in wevs if _is_producer_stage(e[2])]
        cons = [e for e in wevs if not _is_producer_stage(e[2])]
        if not prod or not cons:
            continue
        src = max(prod, key=lambda e: e[1] if e[1] is not None else e[0])
        dst = min(cons, key=lambda e: e[0])
        flow_id = (int(pidx) << 32) | (int(seq) & 0xFFFFFFFF)
        src_end = src[1] if src[1] is not None else src[0]
        trace.append({
            "ph": "s", "cat": "ddl.window", "name": "window",
            "id": flow_id, "pid": src[5], "tid": lane[src[2]],
            "ts": src_end * 1e6,
            "args": {"window": f"p{pidx}/s{seq}"},
        })
        trace.append({
            "ph": "f", "bp": "e", "cat": "ddl.window", "name": "window",
            "id": flow_id, "pid": dst[5], "tid": lane[dst[2]],
            "ts": dst[0] * 1e6,
            "args": {"window": f"p{pidx}/s{seq}"},
        })
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def write_chrome_trace(events: Iterable[SpanEvent], path: str) -> str:
    """Serialize :func:`chrome_trace` to ``path`` (atomic temp+rename —
    a trace is a post-mortem artifact, never worth a torn read)."""
    from ddl_tpu_torch.checkpoint import atomic_file_write

    data = json.dumps(chrome_trace(events)).encode()
    atomic_file_write(path, data, fsync=False)
    return path


# Spawned producer processes arm themselves at import when the consumer
# exported a trace request (the faults.PLAN_ENV pattern): their span
# batches ride ObsReport shipping back into the consumer's log.
_env_trace = envspec.raw(TRACE_ENV)
if _env_trace:
    try:
        _cap = int(_env_trace)
    except ValueError:
        _cap = DEFAULT_CAPACITY
    _ARMED = SpanLog(capacity=_cap if _cap > 1 else DEFAULT_CAPACITY)
del _env_trace
