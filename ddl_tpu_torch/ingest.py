"""Device ingest: host windows → the trainer's device or mesh (port of
``ddl_tpu/ingest.py``: :class:`DeviceIngestor`, :func:`device_put` and
:class:`PrefetchIterator` on the inline path).

On a CUDA device one window becomes one ``non_blocking`` copy on a side
``torch.cuda.Stream``, straight out of the (page-locked) ring slot; a
CUDA event marks the copy done.  The caller keeps the slot until that
event has fired — the contract :meth:`DeviceIngestor.
window_source_detached` states — and makes its compute stream wait on
the event before using the tensor (:meth:`DeviceIngestor.hand_off`).
On the CPU the window is copied out of the slot at once, so the slot
can be released at yield.

With a ``sharding`` (a :class:`~ddl_tpu_torch.parallel.mesh.
NamedSharding`) windows and batches land as :class:`~ddl_tpu_torch.
parallel.mesh.ShardedArray` s.  ``distribute="ici"`` crosses host→device
once, onto the plan's anchor position, and the ICI tier
(:mod:`ddl_tpu_torch.parallel.ici`, kernels K7/K8) fans the window out;
``"xla"`` takes the plain route (:func:`device_put`: each position
copies its slice from the host).  The H2D copy, the tier's kernels and
its finish all run on the side stream, and one event after them marks
the window done.  The staged engine of the JAX package (``StagingPool``
/ ``TransferExecutor``) is a later slice.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ddl_tpu_torch import envspec
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
from ddl_tpu_torch.parallel.mesh import NamedSharding, ShardedArray, one_card
from ddl_tpu_torch.utils import resolve_device

_DISTRIBUTE = ("ici", "xla", "auto")


def device_put(x: Any, target: Any) -> Any:
    """Copy ``x`` (a numpy array or a tensor on any device) to ``target``
    — a device, or a :class:`NamedSharding`, where every mesh position
    gets its own contiguous copy of its slice (the plain route, the
    port's ``jax.device_put(x, sharding)``).  Always a copy, never an
    alias of ``x``.  Copies run on the current stream; out of
    page-locked host memory they are asynchronous, so the source must
    stay valid until the stream has passed them."""
    src = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    if isinstance(target, NamedSharding):
        devices = target.mesh.device_list
        return ShardedArray(src.shape, target, [
            _copy_to(src[index], devices[p])
            for p, index in enumerate(target.shard_indices(src.shape))
        ])
    return _copy_to(src, torch.device(target))


def _copy_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t, non_blocking=True)
    return out


@dataclasses.dataclass
class Transfer:
    """One in-flight window copy: the device value (a tensor or a
    :class:`ShardedArray`) and the event that fires once it has landed
    (None on the CPU: already there)."""

    value: Any
    done: Any = None


def _tensors(value: Any) -> Tuple[torch.Tensor, ...]:
    if isinstance(value, ShardedArray):
        return tuple(s.data for s in value.shards)
    return (value,)


class DeviceIngestor:
    """Puts host windows and batches onto one device, or onto the mesh
    positions of ``sharding``.

    ``distribute`` picks the route to a sharded target: ``"ici"`` (the
    fan-out tier), ``"xla"`` (the plain route) or ``"auto"`` (the
    default): the tier on a CUDA mesh of two or more positions, the
    plain route on the CPU.  The mesh's positions decide the device; a
    CUDA mesh over several distinct cards is the multi-card slice and
    raises ``NotImplementedError``.
    """

    def __init__(self, device: Any = "cuda", metrics: Optional[Metrics] = None,
                 sharding: Optional[NamedSharding] = None,
                 distribute: str = "auto"):
        self.sharding = sharding
        if sharding is not None:
            device = one_card(sharding.mesh.device_list)
        self.device = resolve_device(device)
        self.metrics = metrics or default_metrics()
        if distribute not in _DISTRIBUTE:
            raise ValueError(
                f"distribute must be ici|xla|auto, got {distribute!r}"
            )
        self.distribute = distribute
        self._ici: Any = None  # the lazily built IciDistributor
        self._stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )

    @property
    def ici_active(self) -> bool:
        """Does a sharded transfer ride the ICI tier (fan-out kernel and
        finish) instead of the plain route?  Counts mesh positions, not
        distinct devices: four positions on one card engage it."""
        if self.distribute == "xla" or self.sharding is None:
            return False
        if self.sharding.mesh.size <= 1:
            return False
        return self.distribute == "ici" or self.device.type == "cuda"

    def ici(self):
        """The lazily built ICI distributor (plan cache)."""
        if self._ici is None:
            from ddl_tpu_torch.parallel.ici import IciDistributor

            self._ici = IciDistributor(self.sharding, metrics=self.metrics)
        return self._ici

    def _transfer(self, arr: Any) -> Any:
        """One host→device transfer on the current stream: through the
        ICI tier, or the plain route, or to the one device."""
        if self.ici_active:
            return self.ici().put(arr, device_put)
        return device_put(arr, self.sharding if self.sharding is not None
                          else self.device)

    def put_window(self, window: np.ndarray, defer_metrics: bool = False) -> Transfer:
        """Start the transfer of a whole window WITHOUT a host copy.

        The source may be a live ring-slot view: on CUDA the caller must
        keep the slot acquired until ``Transfer.done`` has fired (that is
        what ``DistributedDataLoader.windows`` does), and must pass the
        transfer through :meth:`hand_off` before computing on it.
        ``defer_metrics`` leaves the ``ingest.bytes``/``ingest.windows``
        accounting to the caller, which records it at yield.
        """
        if self._stream is None:
            out = Transfer(self._transfer(window))  # detached from the slot now
        else:
            with torch.cuda.stream(self._stream):
                value = self._transfer(window)
                done = torch.cuda.Event()
                done.record(self._stream)
            out = Transfer(value, done)
        if not defer_metrics:
            self.metrics.incr("ingest.bytes", float(window.nbytes))
            self.metrics.incr("ingest.windows")
        return out

    def hand_off(self, transfer: Transfer) -> Any:
        """The transferred value, safe to use on the current stream: the
        stream waits (on the device, not the host) for the transfer's
        event, and the caching allocator learns that every tensor of it
        — each shard of a sharded window — is used there."""
        if transfer.done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(transfer.done)
            for t in _tensors(transfer.value):
                t.record_stream(cur)
        return transfer.value

    def window_source_detached(self) -> bool:
        """Does :meth:`put_window` detach the transfer from its host
        source?  True on the CPU (copied at once); on CUDA the copy reads
        the ring slot until ``Transfer.done`` fires."""
        return self._stream is None

    def put_batch(
        self, batch: np.ndarray, splits: Sequence[int]
    ) -> Tuple[Any, ...]:
        """Transfer one unsplit batch, splitting into columns on device.
        On CUDA the batch is copied out of its (possibly slot-backed)
        memory into fresh page-locked staging first, so the slot may be
        released once this returns; the transfer runs on the current
        stream."""
        src = batch
        if self._stream is not None:
            tdtype = torch.from_numpy(np.empty(0, batch.dtype)).dtype
            src = torch.empty(batch.shape, dtype=tdtype, pin_memory=True)
            src.numpy()[...] = batch
        dev = self._transfer(src)
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


def _device_split(dev: Any, splits: Sequence[int]) -> Tuple[Any, ...]:
    """Column-split a transferred (B, sum(splits)) batch on device.  A
    sharded batch splits shard by shard, which needs its columns unsplit
    across positions (a column block spanning the whole width passes
    through as it is)."""
    if len(splits) == 1 and splits[0] == dev.shape[1]:
        return (dev,)
    if isinstance(dev, ShardedArray):
        if any(s.index[1] != slice(None) for s in dev.shards):
            raise NotImplementedError(
                "column split of a batch sharded along its columns: shard "
                "the batch dim instead"
            )
        out, off = [], 0
        for w in splits:
            out.append(ShardedArray(
                (dev.shape[0], w) + dev.shape[2:], dev.sharding,
                [s.data[:, off:off + w] for s in dev.shards]))
            off += w
        return tuple(out)
    out, off = [], 0
    for w in splits:
        out.append(dev[:, off : off + w])
        off += w
    return tuple(out)
