"""Profiling integration: ``torch.profiler`` traces around pipeline
sections (port of ``ddl_tpu/profiling.py``, whose traces are
``jax.profiler``'s).

:func:`trace` records the host's named ranges and, on a card, the
kernels it ran into one Chrome trace in ``log_dir`` (open it in the
Perfetto UI or ``chrome://tracing``).  :func:`annotate` is the named host
range the pipeline puts around its stages (``ddl.window_acquire``,
``ddl.window_wait``, ``ddl.staging_transfer``,
``ddl.ingest_put_window``): a ``torch.profiler.record_function`` range,
and an NVTX range on a card so Nsight shows it too.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

#: The file name :func:`trace` gives its Chrome trace in ``log_dir``.
TRACE_FILE = "ddl_trace_{pid}_{stamp}.pt.trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[object]:
    """Capture a ``torch.profiler`` trace of the enclosed block (host
    ranges, and the card's kernels when CUDA is available) and write it
    to ``log_dir`` as a Chrome trace.  Yields the profiler; its
    ``trace_path`` attribute names the file once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    with prof:
        yield prof
    path = os.path.join(log_dir, TRACE_FILE.format(
        pid=os.getpid(), stamp=time.strftime("%Y%m%d-%H%M%S")))
    prof.export_chrome_trace(path)
    prof.trace_path = path


class annotate:
    """Named host range, visible on the profiler timeline (and on
    Nsight's NVTX row on a card).

    Usage::

        with annotate("ddl.window_drain"):
            batch = loader[i]
    """

    __slots__ = ("name", "_rf", "_nvtx")

    def __init__(self, name: str):
        self.name = name
        self._rf = None
        self._nvtx = False

    def __enter__(self) -> "annotate":
        import torch

        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(self.name)
            self._nvtx = True
        return self

    def __exit__(self, *exc: object) -> None:
        if self._nvtx:
            import torch

            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)


@contextlib.contextmanager
def maybe_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace only when a log dir is configured (no-op otherwise)."""
    if log_dir:
        with trace(log_dir):
            yield
    else:
        yield
