"""End-to-end data-plane tracing over the Metrics seam (port of
``ddl_tpu/obs``).

Four pieces:

- **Window lifecycle spans** (:mod:`~ddl_tpu_torch.obs.spans`): a
  bounded, zero-cost-when-disarmed :class:`SpanLog` of timestamped stage
  events keyed on each window's integrity-trailer identity
  ``(producer_idx, seq)``, exported as Chrome/Perfetto ``trace_event``
  JSON with a lane per stage and flow arrows across processes.
- **Histograms** (:meth:`~ddl_tpu_torch.observability.Metrics.observe`,
  ``quantile``): fixed log-spaced bounded buckets for the window-latency
  and admission-wait percentiles.
- **Cross-process aggregation** (:mod:`~ddl_tpu_torch.obs.aggregate`):
  PROCESS producers ship ObsReports up the control channel, merged into
  the consumer's registry under ``producer.<idx>.*``.
- **Flight recorder** (:mod:`~ddl_tpu_torch.obs.recorder`): a fixed-size
  ring of recent events, dumped atomically at failure sites;
  ``python -m ddl_tpu_torch.obs dump <artifact>`` prints one.

Arming any of them changes no byte the pipeline serves and no loss.
"""

from __future__ import annotations

from ddl_tpu_torch.obs.aggregate import (
    ReportMerger,
    build_report,
    convert,
    ship_every,
)
from ddl_tpu_torch.obs.recorder import (
    FlightRecorder,
    armed_recorder,
    flight_dump,
)
from ddl_tpu_torch.obs.recorder import armed as flight_armed
from ddl_tpu_torch.obs.spans import (
    STAGES,
    SpanLog,
    chrome_trace,
    tracing,
    write_chrome_trace,
)

__all__ = [
    "FlightRecorder",
    "ReportMerger",
    "STAGES",
    "SpanLog",
    "armed_recorder",
    "build_report",
    "convert",
    "chrome_trace",
    "flight_armed",
    "flight_dump",
    "ship_every",
    "tracing",
    "write_chrome_trace",
]
