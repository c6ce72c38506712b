"""Profiling integration: ``torch.profiler`` traces around pipeline
sections (port of ``ddl_tpu/profiling.py``, whose traces are
``jax.profiler``'s).

:func:`trace` records the host's named ranges and, on a card, the
kernels it ran into one Chrome trace in ``log_dir`` (open it in the
Perfetto UI or ``chrome://tracing``).  When a
:class:`~ddl_tpu_torch.obs.spans.SpanLog` is armed, its window-lifecycle
events join that file as one ``ddl spans`` process per source pid
(this process first, at :data:`SPANS_PID`) with a lane per stage, on the
profiler's clock: :func:`trace` reads the pair
``(time.perf_counter_ns(), time.time_ns())`` when it starts, and the
profiler's ``ts`` plus the file's ``baseTimeNanoseconds`` is Unix time.

:func:`annotate` is the named host range the pipeline puts around its
stages: a ``torch.profiler.record_function`` range while a profiler
runs, an NVTX range on a card (so Nsight shows it too), and, given a
:class:`~ddl_tpu_torch.observability.Metrics`, a timer.

Names.  A ``ddl.`` range runs on the consumer's thread (the trainer's,
under ``Trainer.fit``), so the innermost ``ddl.`` range over an idle gap
of the card says what held the card back:

- the loader: ``ddl.window_acquire`` (timer ``consumer.wait``), inside
  it ``ddl.ring_wait`` (the wait for a producer's commit) and
  ``ddl.integrity_verify`` (the window's CRC check);
  ``ddl.staging_transfer`` and
  ``ddl.ingest_put_window`` / ``ddl.ingest_put`` where this thread runs
  the transfer, ``ddl.staging_wait`` (``ingest.stall``) where it waits
  on a staging worker's;
- the trainer: ``ddl.window_wait`` (``trainer.window_wait``), inside it
  ``ddl.window_hook`` (the caller's hook), then ``ddl.step_dispatch``
  (the host's enqueue of the window's steps, including any block on a
  full launch queue), ``ddl.loss_readback`` and ``ddl.boundary`` (the
  epoch mark, checkpoint and preemption poll).

Work on other threads takes a name without the prefix: a staging
worker's ``staging.transfer``, ``ingest.put_window`` and ``ingest.put``
(:func:`mark_worker_thread`), a producer's ``producer.fill`` (exchange
and refill) and ``producer.stamp`` (copy into the slot, CRC, trailer and
commit).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

#: The file name :func:`trace` gives its Chrome trace in ``log_dir``.
TRACE_FILE = "ddl_trace_{pid}_{stamp}.pt.trace.json"

#: The Chrome-trace ``pid`` of the first ``ddl spans`` process
#: :func:`trace` adds (each further source pid takes the next): above
#: any Linux pid, and apart from the profiler's device pids.
SPANS_PID = 0x7FFF0000

_THREAD = threading.local()
#: ``torch.cuda.nvtx`` once a card is seen, False once none is, None
#: until torch is imported.
_NVTX: Any = None


def mark_worker_thread() -> None:
    """Declare the calling thread a worker: an :func:`annotate` given a
    ``worker`` name opens under that name here, not its ``ddl.`` one."""
    _THREAD.worker = True


def _profiler_on() -> bool:
    """Does a ``torch.profiler`` run in this process?  Read from torch's
    process-wide flag (every thread's ranges count under an all-thread
    profile); a process that never imported torch runs none."""
    ap = sys.modules.get("torch.autograd.profiler")
    return ap is not None and getattr(ap, "_is_profiler_enabled", True)


def _nvtx() -> Any:
    global _NVTX
    if _NVTX is None and "torch" in sys.modules:
        import torch

        _NVTX = torch.cuda.nvtx if torch.cuda.is_available() else False
    return _NVTX


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[object]:
    """Capture a ``torch.profiler`` trace of the enclosed block (host
    ranges, and the card's kernels when CUDA is available) and write it
    to ``log_dir`` as a Chrome trace, with the armed ``SpanLog``'s events
    of the block.  Yields the profiler; its ``trace_path`` attribute
    names the file once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ddl_tpu_torch.obs import spans as obs_spans

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    try:
        # Every thread's ranges: the staging worker runs transfers too.
        config = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        config = None  # an older torch: the calling thread's ranges
    prof = profile(activities=activities, experimental_config=config)
    prof.trace_path = None
    anchor = (time.perf_counter_ns(), time.time_ns())
    with prof:
        yield prof
    path = os.path.join(log_dir, TRACE_FILE.format(
        pid=os.getpid(), stamp=time.strftime("%Y%m%d-%H%M%S")))
    prof.export_chrome_trace(path)
    span_log = obs_spans.log()
    if span_log is not None:
        _add_spans(path, span_log.events(), anchor)
    prof.trace_path = path


def _add_spans(path: str, events: List[Any], anchor: tuple) -> None:
    """Append the ``SpanLog`` events that end after ``anchor`` to the
    Chrome trace at ``path``, a process per source pid (this one first),
    on the trace's clock: a
    ``perf_counter`` second ``t`` is Unix ``anchor[1] + (t - anchor[0])``
    ns, less the file's ``baseTimeNanoseconds``."""
    from ddl_tpu_torch.obs.spans import chrome_trace

    with open(path) as f:
        data = json.load(f)
    perf0_us = anchor[0] / 1e3
    shift_us = (anchor[1] - float(data.get("baseTimeNanoseconds", 0))) / 1e3
    kept = [e for e in events
            if (e[0] if e[1] is None else e[1]) * 1e6 >= perf0_us]
    pids = {os.getpid(): SPANS_PID}
    out: List[Dict[str, Any]] = []
    # chrome_trace's processes, lanes and flows, moved off the OS pids.
    for ev in chrome_trace(kept)["traceEvents"]:
        if ev["ph"] == "M":
            if ev["name"] == "process_name":
                ev["args"] = {"name": f"ddl spans {ev['pid']}"}
        else:
            ev["ts"] += shift_us - perf0_us
        ev["pid"] = pids.setdefault(ev["pid"], SPANS_PID + len(pids))
        out.append(ev)
    data["traceEvents"].extend(out)
    with open(path, "w") as f:
        json.dump(data, f)


class annotate:
    """Named host range: on the profiler timeline while a profiler runs,
    on Nsight's NVTX row on a card, and, given ``metrics``, a timer
    (``timer``, else ``name``) of the range's ``perf_counter`` time.
    ``worker`` is the range's name on a :func:`mark_worker_thread`
    thread.

    Usage::

        with annotate("ddl.window_acquire", metrics, timer="consumer.wait"):
            slot = ring.acquire_drain(timeout_s)
    """

    __slots__ = ("name", "_metrics", "_timer", "_rf", "_nvtx", "_t0")

    def __init__(self, name: str, metrics: Any = None,
                 timer: Optional[str] = None, worker: Optional[str] = None):
        self._timer = timer or name
        if worker is not None and getattr(_THREAD, "worker", False):
            name = worker
        self.name = name
        self._metrics = metrics

    def __enter__(self) -> "annotate":
        self._rf = self._nvtx = None
        if _profiler_on():
            import torch

            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        nvtx = _nvtx()
        if nvtx:
            nvtx.range_push(self.name)
            self._nvtx = nvtx
        if self._metrics is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> None:
        if self._metrics is not None:
            self._metrics.add_time(self._timer, time.perf_counter() - self._t0)
        if self._nvtx is not None:
            self._nvtx.range_pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)


@contextlib.contextmanager
def maybe_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace only when a log dir is configured (no-op otherwise)."""
    if log_dir:
        with trace(log_dir):
            yield
    else:
        yield
