"""Cross-process metric and span aggregation: PROCESS-mode producer
registries merged into the consumer's under ``producer.<idx>.*`` (port
of ``ddl_tpu/obs/aggregate.py``).

A spawned producer records into its own process's registry.  Every
:func:`ship_every` windows (``DDL_TORCH_OBS_SHIP_EVERY``, default 32,
``0`` disables), and once more at shutdown, it ships an
:class:`~ddl_tpu_torch.types.ObsReport` — its cumulative
``Metrics.snapshot()``, its histogram states and the armed span log's
delta — up the control channel its acks ride.  The consumer merges each
report with ``Metrics.adopt``: replace-based (snapshots are cumulative)
and fenced (``report_idx`` is monotone per producer incarnation; a stale
report is dropped).  THREAD producers share the consumer's registry and
never ship.
"""

from __future__ import annotations

import logging
import os

from typing import Any, Dict, Optional

from ddl_tpu_torch import envspec

logger = logging.getLogger("ddl_tpu_torch")

SHIP_ENV = "DDL_TORCH_OBS_SHIP_EVERY"
DEFAULT_SHIP_EVERY = 32


def ship_every() -> int:
    """Windows between periodic worker ObsReports (0 = disabled)."""
    raw = envspec.raw(SHIP_ENV) or ""
    if not raw:
        return DEFAULT_SHIP_EVERY
    try:
        return max(0, int(raw))
    except ValueError:
        return DEFAULT_SHIP_EVERY


def build_report(
    producer_idx: int,
    report_idx: int,
    metrics: Any,
    view_epoch: int = 0,
) -> Any:
    """Assemble one worker-side ObsReport: cumulative snapshot +
    histogram states + (when spans are armed) the span delta since the
    last report."""
    from ddl_tpu_torch.obs import spans
    from ddl_tpu_torch.types import ObsReport

    span_log = spans.log()
    return ObsReport(
        producer_idx=producer_idx,
        report_idx=report_idx,
        pid=os.getpid(),
        snapshot=metrics.snapshot(),
        hists=metrics.hist_state(),
        spans=span_log.drain_new() if span_log is not None else [],
        view_epoch=view_epoch,
    )


class ReportMerger:
    """Consumer-side half: fence + merge ObsReports into a registry.

    One instance per loader; NOT thread-safe by design — reports are
    applied on the consumer thread at window boundaries.
    """

    def __init__(self, metrics: Any, span_log_getter: Any = None):
        self.metrics = metrics
        # Injected so the merger always appends into the CURRENTLY
        # armed log (arming can change between reports).
        self._span_log_getter = span_log_getter
        # producer_idx -> (pid, last applied report_idx).  The fence is
        # PER INCARNATION: a respawned producer (fresh process, fresh
        # counter) must not be fenced out by its predecessor's higher
        # report_idx — the pid change resets the fence.  Bounded by
        # the producer set by construction.
        self._applied: Dict[int, tuple] = {}  # ddl-lint: disable=DDL013 - one entry per producer
        self.applied_reports = 0
        self.stale_dropped = 0

    def fence_state(self) -> Dict[int, tuple]:
        """Copy of the per-producer (pid, report_idx) fence — drain
        loops compare states to detect 'a fresh report from every
        producer arrived' and exit before their deadline."""
        return dict(self._applied)

    def apply(self, report: Any) -> bool:
        """Merge one report; False when dropped as stale."""
        pid, last = self._applied.get(report.producer_idx, (None, -1))
        if pid == report.pid and report.report_idx <= last:
            self.stale_dropped += 1
            self.metrics.incr("obs.reports_stale")
            return False
        self._applied[report.producer_idx] = (
            report.pid, report.report_idx,
        )
        self.metrics.adopt(
            f"producer.{report.producer_idx}.",
            report.snapshot,
            report.hists,
        )
        if report.spans:
            from ddl_tpu_torch.obs import spans

            span_log = (
                self._span_log_getter()
                if self._span_log_getter is not None
                else spans.log()
            )
            if span_log is not None:
                span_log.record_many(report.spans)
        self.applied_reports += 1
        self.metrics.incr("obs.reports_applied")
        return True


def adopt_job(
    metrics: Any,
    job_id: str,
    snapshot: Dict[str, Any],
    hists: Optional[Dict[str, Any]] = None,
) -> None:
    """Merge one JOB's registry snapshot under ``job.<id>.*`` — the
    :class:`ReportMerger` ``producer.<idx>.*`` pattern one level up (the
    serve fabric's per-job view).  REPLACE-based, like every adopt:
    snapshots are cumulative, so re-merging is idempotent."""
    metrics.adopt(f"job.{job_id}.", snapshot, hists or {})


def convert(obj: Any) -> Any:
    """The port's form of an observability record of either package (the
    two share their wire and file formats): an ObsReport-shaped object
    becomes a :class:`~ddl_tpu_torch.types.ObsReport`, a histogram state
    dict a :class:`~ddl_tpu_torch.observability.Histogram`, and a flight
    record dict a JSON-equal copy of it (refused past this reader's
    :data:`~ddl_tpu_torch.obs.recorder.DUMP_VERSION`)."""
    import json

    from ddl_tpu_torch.obs.recorder import DUMP_VERSION
    from ddl_tpu_torch.observability import Histogram
    from ddl_tpu_torch.types import ObsReport

    if isinstance(obj, dict):
        if "counts" in obj and "count" in obj:
            return Histogram.from_state(obj)
        if "version" in obj and "events" in obj:
            if int(obj["version"]) > DUMP_VERSION:
                raise ValueError(
                    f"flight-record version {obj['version']} is newer than "
                    f"this reader's ({DUMP_VERSION})")
            return json.loads(json.dumps(obj))
        raise ValueError(f"not an observability record: {sorted(obj)[:6]}")
    return ObsReport(
        producer_idx=int(obj.producer_idx), report_idx=int(obj.report_idx),
        pid=int(obj.pid), snapshot=dict(obj.snapshot),
        hists={k: dict(v) for k, v in obj.hists.items()},
        spans=[tuple(e) for e in obj.spans],
        view_epoch=int(getattr(obj, "view_epoch", 0)))
