"""Flight recorder: a bounded ring of recent span and metric events,
dumped atomically at failure sites for post-mortem analysis (port of
``ddl_tpu/obs/recorder.py``).

While armed, every span emission and every metric mutation (through
``observability.install_event_tap``) appends one tuple to a fixed-size
ring, and the failure sites — a corrupt window, an undecodable window,
an exhausted replay, a fired fault site, a preemption notice, a watchdog
failure, a lock-order inversion — dump the ring and a full metrics
snapshot to a JSON artifact through ``checkpoint.atomic_file_write``,
naming the faulted window's ``(producer_idx, seq)``.  The format
(:data:`DUMP_VERSION`, the keys) is the JAX package's, so either
package's ``python -m <package>.obs dump <artifact>`` reads the other's
dumps.

Bounded by construction (``deque(maxlen=...)``) and rate-limited
(:data:`MAX_DUMPS` a process), so a persistent fault cannot fill the
disk.  ``DDL_TORCH_FLIGHT`` (a capacity) and ``DDL_TORCH_FLIGHT_DIR``
arm spawned processes at import.
"""

from __future__ import annotations

import json
import logging
import os
import threading

import time
from collections import deque
from typing import Any, Dict, Optional

from ddl_tpu_torch import envspec
from ddl_tpu_torch.concurrency import named_lock

logger = logging.getLogger("ddl_tpu_torch")

#: Env var arming a default recorder in freshly spawned processes
#: ("1" or a capacity).  Exported by :class:`armed` like
#: ``faults.PLAN_ENV``.
FLIGHT_ENV = "DDL_TORCH_FLIGHT"

#: Where dumps land (created on first dump).
FLIGHT_DIR_ENV = "DDL_TORCH_FLIGHT_DIR"
DEFAULT_FLIGHT_DIR = "ddl_flight"

DEFAULT_CAPACITY = 4096

#: Per-process dump budget: a persistent fault must leave evidence,
#: not a full disk.
MAX_DUMPS = 8

#: Dump format version (the CLI refuses unknown majors).
DUMP_VERSION = 1


class FlightRecorder:
    """Fixed-size ring of recent observability events (see module doc)."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        directory: Optional[str] = None,
    ):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self.directory = (
            directory or envspec.raw(FLIGHT_DIR_ENV) or DEFAULT_FLIGHT_DIR
        )
        self._dump_lock = named_lock("obs.recorder.dump")
        self.dumps = 0
        self.noted = 0
        #: Paths written by this recorder (newest last).
        self.dumped_paths: deque = deque(maxlen=MAX_DUMPS)

    def note(
        self,
        kind: str,
        name: str,
        value: float,
        producer_idx: Optional[int] = None,
        seq: Optional[int] = None,
    ) -> None:
        """One ring entry (GIL-atomic append; no lock on the hot path)."""
        self._ring.append(
            (time.perf_counter(), kind, name, float(value),
             producer_idx, seq)
        )
        self.noted += 1

    def events(self) -> list:
        return list(self._ring)

    def dump(
        self,
        reason: str,
        producer_idx: Optional[int] = None,
        seq: Optional[int] = None,
        metrics: Any = None,
        extra: Optional[Dict[str, Any]] = None,
    ) -> Optional[str]:
        """Write one post-mortem artifact; returns its path (None when
        the per-process budget is exhausted).  Atomic temp+rename via
        ``checkpoint.atomic_file_write``: a half-written post-mortem of a
        crash is worse than none."""
        from ddl_tpu_torch.checkpoint import atomic_file_write
        from ddl_tpu_torch.observability import metrics as default_metrics

        with self._dump_lock:
            if self.dumps >= MAX_DUMPS:
                return None
            self.dumps += 1
            n = self.dumps
        m = metrics if metrics is not None else default_metrics()
        slug = "".join(
            c if c.isalnum() or c in "-_" else "-" for c in reason
        )[:60]
        path = os.path.join(
            self.directory,
            f"flight-{os.getpid()}-{n:02d}-{slug}.json",
        )
        record = {
            "version": DUMP_VERSION,
            "reason": reason,
            "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "pid": os.getpid(),
            "window": {"producer_idx": producer_idx, "seq": seq},
            "events": self.events(),
            "events_dropped": max(0, self.noted - len(self._ring)),
            "metrics": m.snapshot(),
        }
        if extra:
            record["extra"] = extra
        try:
            atomic_file_write(
                path, json.dumps(record).encode(), fsync=False
            )
        except OSError as e:  # pragma: no cover - disk-full etc.
            logger.error("flight-recorder dump failed: %s", e)
            return None
        self.dumped_paths.append(path)
        m.incr("obs.flight_dumps")
        logger.warning(
            "flight recorder: dumped %s (reason=%s window=%s/%s)",
            path, reason, producer_idx, seq,
        )
        return path


#: The armed recorder, or None — one module-attribute read per metric
#: event is the entire disarmed cost (the faults._ARMED pattern).
_ARMED: Optional[FlightRecorder] = None


def armed_recorder() -> Optional[FlightRecorder]:
    return _ARMED


def arm(
    rec: Optional[FlightRecorder], export: bool = False
) -> Optional[FlightRecorder]:
    """Arm ``rec`` process-wide (``None`` disarms) and install/remove
    the metric-event tap.  ``export=True`` publishes :data:`FLIGHT_ENV`
    (+ the dump dir) so PROCESS workers arm their own ring on import."""
    global _ARMED
    from ddl_tpu_torch import observability

    prev = _ARMED
    _ARMED = rec
    observability.install_event_tap(
        rec.note if rec is not None else None
    )
    if export:
        if rec is None:
            os.environ.pop(FLIGHT_ENV, None)
            os.environ.pop(FLIGHT_DIR_ENV, None)
        else:
            os.environ[FLIGHT_ENV] = str(rec.capacity)
            os.environ[FLIGHT_DIR_ENV] = rec.directory
    return prev


class armed:
    """Context manager: arm a recorder for a scoped run (restores the
    previous recorder and env on exit — the ``faults.armed`` shape)."""

    def __init__(
        self,
        rec: Optional[FlightRecorder] = None,
        export: bool = False,
        directory: Optional[str] = None,
    ):
        self.rec = rec or FlightRecorder(directory=directory)
        self.export = export
        self._prev: Optional[FlightRecorder] = None
        self._prev_env: Optional[str] = None
        self._prev_dir: Optional[str] = None

    def __enter__(self) -> FlightRecorder:
        self._prev_env = envspec.raw(FLIGHT_ENV)
        self._prev_dir = envspec.raw(FLIGHT_DIR_ENV)
        self._prev = arm(self.rec, export=self.export)
        return self.rec

    def __exit__(self, *exc: Any) -> None:
        arm(self._prev)
        if self.export:
            for var, prev in (
                (FLIGHT_ENV, self._prev_env),
                (FLIGHT_DIR_ENV, self._prev_dir),
            ):
                if prev is None:
                    os.environ.pop(var, None)
                else:
                    os.environ[var] = prev


def flight_dump(
    reason: str,
    producer_idx: Optional[int] = None,
    seq: Optional[int] = None,
    metrics: Any = None,
    extra: Optional[Dict[str, Any]] = None,
) -> Optional[str]:
    """Dump the armed recorder (no-op when disarmed) — THE call failure
    sites make: integrity corruption, fault-site trips, preemption
    notices, watchdog failures."""
    rec = _ARMED
    if rec is None:
        return None
    return rec.dump(
        reason, producer_idx=producer_idx, seq=seq,
        metrics=metrics, extra=extra,
    )


def flight_note(kind: str, name: str, value: float) -> None:
    """Append one event to the armed recorder (no-op when disarmed) —
    the audit hook for decisions that are not metrics but must appear in
    a post-mortem ring (the JAX package's ``tune`` notes every knob
    change here as ``("tune", knob, new_value)``)."""
    rec = _ARMED
    if rec is not None:
        rec.note(kind, name, value)


# Spawned processes arm themselves at import when the consumer exported
# a flight request (the faults.PLAN_ENV pattern).
_env_flight = envspec.raw(FLIGHT_ENV)
if _env_flight:
    try:
        _cap = int(_env_flight)
    except ValueError:
        _cap = DEFAULT_CAPACITY
    arm(FlightRecorder(capacity=_cap if _cap > 1 else DEFAULT_CAPACITY))
del _env_flight
