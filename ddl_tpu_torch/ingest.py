"""Device ingest: host windows → the trainer's device (port of
``ddl_tpu/ingest.py``: :class:`DeviceIngestor` and
:class:`PrefetchIterator` on the inline path).

On a CUDA device one window becomes one ``non_blocking`` copy on a side
``torch.cuda.Stream``, straight out of the (page-locked) ring slot; a
CUDA event marks the copy done.  The caller keeps the slot until that
event has fired — the contract :meth:`DeviceIngestor.
window_source_detached` states — and makes its compute stream wait on
the event before using the tensor (:meth:`DeviceIngestor.hand_off`).
On the CPU the window is copied out of the slot at once, so the slot
can be released at yield.  The staged engine of the JAX package
(``StagingPool`` / ``TransferExecutor``) is a later slice.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ddl_tpu_torch import envspec
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
from ddl_tpu_torch.utils import resolve_device


@dataclasses.dataclass
class Transfer:
    """One in-flight window copy: the device tensor and the event that
    fires once its bytes have landed (None on the CPU: already there)."""

    value: torch.Tensor
    done: Any = None


class DeviceIngestor:
    """Puts host windows and batches onto one device."""

    def __init__(self, device: Any = "cuda", metrics: Optional[Metrics] = None):
        self.device = resolve_device(device)
        self.metrics = metrics or default_metrics()
        self._stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )

    def put_window(self, window: np.ndarray, defer_metrics: bool = False) -> Transfer:
        """Start the transfer of a whole window WITHOUT a host copy.

        The source may be a live ring-slot view: on CUDA the caller must
        keep the slot acquired until ``Transfer.done`` has fired (that is
        what ``DistributedDataLoader.windows`` does), and must pass the
        transfer through :meth:`hand_off` before computing on it.
        ``defer_metrics`` leaves the ``ingest.bytes``/``ingest.windows``
        accounting to the caller, which records it at yield.
        """
        src = torch.from_numpy(window)
        if self._stream is None:
            out = Transfer(src.clone())  # detached from the slot now
        else:
            with torch.cuda.stream(self._stream):
                dev = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                dev.copy_(src, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._stream)
            out = Transfer(dev, done)
        if not defer_metrics:
            self.metrics.incr("ingest.bytes", float(window.nbytes))
            self.metrics.incr("ingest.windows")
        return out

    def hand_off(self, transfer: Transfer) -> torch.Tensor:
        """The transferred tensor, safe to use on the current stream: the
        stream waits (on the device, not the host) for the copy event,
        and the caching allocator learns the tensor is used there."""
        if transfer.done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(transfer.done)
            transfer.value.record_stream(cur)
        return transfer.value

    def window_source_detached(self) -> bool:
        """Does :meth:`put_window` detach the transfer from its host
        source?  True on the CPU (copied at once); on CUDA the copy reads
        the ring slot until ``Transfer.done`` fires."""
        return self._stream is None

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Copy ``arr`` out of its (possibly slot-backed) memory, then
        start its transfer on the current stream."""
        if self._stream is None:
            return torch.from_numpy(np.array(arr, copy=True))
        # A fresh page-locked staging copy: the slot may be released once
        # this returns, and the host allocator keeps the staging block
        # alive until the non_blocking copy has read it.
        tdtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        staging = torch.empty(arr.shape, dtype=tdtype, pin_memory=True)
        staging.numpy()[...] = arr
        return staging.to(self.device, non_blocking=True)

    def put_batch(
        self, batch: np.ndarray, splits: Sequence[int]
    ) -> Tuple[torch.Tensor, ...]:
        """Transfer one unsplit batch, splitting into columns on device."""
        dev = self._to_device(batch)
        self.metrics.incr("ingest.bytes", float(batch.nbytes))
        self.metrics.incr("ingest.batches")
        return _device_split(dev, splits)


class PrefetchIterator:
    """Wrap a host-batch iterator, keeping ``depth`` device transfers in
    flight ahead of compute (inline mode: each fill calls ``put`` — e.g. a
    bound :meth:`DeviceIngestor.put_batch` — on the caller thread).
    ``depth=None`` reads ``DDL_TORCH_PREFETCH_DEPTH``."""

    def __init__(self, it: Any, put: Any, depth: Optional[int] = None):
        self._it = iter(it)
        self._put = put
        if depth is None:
            depth = envspec.get("DDL_TORCH_PREFETCH_DEPTH")
        self._depth = max(1, depth)
        self._queue: collections.deque = collections.deque()

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self) -> Any:
        while len(self._queue) < self._depth:
            try:
                host_batch = next(self._it)
            except StopIteration:
                break
            self._queue.append(self._put(host_batch))
        if not self._queue:
            raise StopIteration
        return self._queue.popleft()


def _device_split(dev: torch.Tensor, splits: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """Column-split a transferred (B, sum(splits)) batch on device."""
    out, off = [], 0
    for w in splits:
        out.append(dev[:, off : off + w])
        off += w
    return tuple(out)
