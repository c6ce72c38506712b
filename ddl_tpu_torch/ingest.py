"""Device ingest: host windows → the trainer's device or mesh (port of
``ddl_tpu/ingest.py``: :class:`DeviceIngestor`, :func:`device_put` and
:class:`PrefetchIterator`).

On a CUDA device one window becomes one ``non_blocking`` copy on a side
``torch.cuda.Stream``, straight out of the (page-locked) ring slot; a
CUDA event marks the copy done.  The caller keeps the slot until that
event has fired — the contract :meth:`DeviceIngestor.
window_source_detached` states — and makes its compute stream wait on
the event before using the tensor (:meth:`DeviceIngestor.hand_off`).
On the CPU the window is copied out of the slot at once, so the slot
can be released at yield.

The staged engine (:mod:`ddl_tpu_torch.staging`, ``staged=``, default
on the card and off on the CPU) runs those copies on a background
worker, releases a window's slot as soon as nothing reads it, and
recycles page-locked staging buffers for batches.  Where the slot itself
is page-locked (a THREAD ring's pinned slots, a registered shared-memory
ring) a staged window takes the alias route: its copy sources the slot.

With a ``sharding`` (a :class:`~ddl_tpu_torch.parallel.mesh.
NamedSharding`) windows and batches land as :class:`~ddl_tpu_torch.
parallel.mesh.ShardedArray` s.  ``distribute="ici"`` crosses host→device
once, onto the plan's anchor position, and the ICI tier
(:mod:`ddl_tpu_torch.parallel.ici`, kernels K7/K8) fans the window out;
``"xla"`` takes the plain route (:func:`device_put`: each position
copies its slice from the host).  The H2D copy, the tier's kernels and
its finish all run on the side stream, and one event after them marks
the window done.

:meth:`DeviceIngestor.put_window` records the ``ingest.transfer`` span
(:mod:`ddl_tpu_torch.obs`; the host's dispatch of the copy, keyed on the
thread's current window) under ``profiling.annotate(
"ddl.ingest_put_window")`` (``ingest.put_window`` on a staging worker;
:meth:`DeviceIngestor.put`'s range is ``ddl.ingest_put`` /
``ingest.put``).  :func:`north_star_report` reads the
registry's counters, timers and histograms into the JAX package's report
keys.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ddl_tpu_torch import envspec
from ddl_tpu_torch.concurrency import named_lock
from ddl_tpu_torch.obs import spans as obs_spans
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
from ddl_tpu_torch.parallel.mesh import NamedSharding, P, ShardedArray, one_card
from ddl_tpu_torch.staging import (
    StagedIngestEngine,
    StagedTransfer,
    shm_staging_enabled,
    staged_enabled,
)
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
    if isinstance(target, NamedSharding) and target.mesh.spans_processes:
        return make_global_array(src, target)
    if isinstance(target, NamedSharding):
        devices = target.mesh.device_list
        return ShardedArray(src.shape, target, [
            _copy_to(src[index], devices[p])
            for p, index in enumerate(target.shard_indices(src.shape))
        ])
    return _copy_to(src, torch.device(target))


def make_global_array(local_batch: Any, sharding: NamedSharding,
                      axis: str = "dp") -> ShardedArray:
    """A process-local host batch as this process's block of a global
    array sharded by ``sharding`` (the MULTIHOST ingest: each process's
    loader drains its own producers' windows, and each lands its block on
    its own positions, never gathered).  Over a mesh of one process the
    local batch IS the global batch: a sharded copy.

    The global shape scales each dim the process-spanning ``axis`` splits
    by the process count; every position this process owns gets a copy
    of its slice of the local block (its global index less the block's
    start)."""
    src = torch.as_tensor(local_batch)  # every position copies its slice
    mesh = sharding.mesh
    if not mesh.spans_processes:
        return device_put(src, sharding)
    from ddl_tpu_torch.parallel.mesh import _entry_axes

    entries = sharding._entries(src.dim())
    n_proc = len(set(mesh.processes.reshape(-1).tolist()))
    shape = tuple(n * n_proc if axis in _entry_axes(e) else n
                  for n, e in zip(src.shape, entries))
    indices = sharding.shard_indices(shape)
    mine = mesh.local_positions()
    start = [min(indices[p][d].indices(shape[d])[0] for p in mine)
             for d in range(len(shape))]
    devices = mesh.device_list
    datas = []
    for p in mine:
        local = tuple(slice(sl.indices(n)[0] - st, sl.indices(n)[1] - st)
                      for sl, n, st in zip(indices[p], shape, start))
        datas.append(_copy_to(src[local], devices[p]))
    return ShardedArray(shape, sharding, datas)


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
    if isinstance(value, (tuple, list)):
        return tuple(t for v in value for t in _tensors(v))
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

    ``staged`` (default: the ``DDL_TORCH_STAGED`` gate, on) lets the
    window stream and the batch prefetcher run through the staging
    engine where the device is a card (:attr:`stream_staged`);
    ``staged=True`` forces it on the CPU too, ``staged=False`` is the
    inline path everywhere.
    """

    def __init__(self, device: Any = "cuda", metrics: Optional[Metrics] = None,
                 sharding: Optional[NamedSharding] = None,
                 distribute: str = "auto", staged: Optional[bool] = None):
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
        self.staged = staged_enabled(staged)
        #: The explicit argument: ``True`` forces the engine on the CPU.
        self._staged_arg = staged
        self._engine: Any = None
        # A staged job's transfer runs on the worker or on a stealing
        # consumer: one at a time through the ICI tier's plan cache.
        self._lock = named_lock("ingest.transfer")

    @property
    def stream_staged(self) -> bool:
        """Does the WINDOW STREAM run through the staging engine?

        Inline, a window's copy sources the ring slot and holds it until
        the copy has landed.  Staged, a background worker runs the copy
        and the slot returns to the producer as soon as nothing reads it.
        On the card that buys early release and overlap; on the CPU the
        "transfer" is itself a host copy, and staging it adds one more.
        Default: staged on the card, inline on the CPU; ``staged=True``
        forces the engine everywhere (tests, experiments).
        """
        if not self.staged:
            return False
        if self._staged_arg is True:
            return True
        return self.device.type == "cuda"

    @property
    def batch_staged(self) -> bool:
        """Do the BATCH paths (``put_batch``, the prefetcher) stage through
        the recycled pool and the background executor?  The same decision
        as the stream's, so it delegates."""
        return self.stream_staged

    @property
    def stream_alias(self) -> bool:
        """May a staged window's copy source its ring slot directly (the
        alias route, ``DDL_TORCH_SHM_STAGING``)?  On the card, where the
        copy is a DMA that leaves nothing reading the slot once its event
        has fired; the loader takes it only for page-locked slots."""
        return (self.stream_staged and shm_staging_enabled()
                and self.device.type == "cuda")

    def engine(self):
        """The lazily built staging engine (pool + background executor),
        with page-locked buffers on the card."""
        if self._engine is None:
            self._engine = StagedIngestEngine(
                metrics=self.metrics, pin_memory=self.device.type == "cuda")
        return self._engine

    def close(self) -> None:
        """Stop the staging executor (its pooled buffers swept back) and
        wait for every copy issued on the side stream: afterwards nothing
        of this ingestor reads host memory."""
        if self._engine is not None:
            self._engine.close()
        if self._stream is not None:
            self._stream.synchronize()

    @property
    def ici_active(self) -> bool:
        """Does a sharded transfer ride the ICI tier (fan-out kernel and
        finish) instead of the plain route?  Counts mesh positions, not
        distinct devices: four positions on one card engage it."""
        if self.distribute == "xla" or self.sharding is None:
            return False
        if self.sharding.mesh.size <= 1:
            return False
        from ddl_tpu_torch.parallel.mesh import process_count

        if process_count() > 1:
            return False  # the multihost path lands each process's block
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

    def _put(self, arr: Any, stream: Any = None) -> Transfer:
        """One transfer, with the event that marks it done: on ``stream``
        (default: the side stream), which this thread enters explicitly —
        a worker thread's current stream is the default stream.  On the
        CPU the copy is complete when this returns."""
        if self._stream is None:
            with self._lock:
                return Transfer(self._transfer(arr))  # detached from arr now
        if stream is None:
            stream = self._stream
        with self._lock, torch.cuda.stream(stream):
            value = self._transfer(arr)
            done = torch.cuda.Event()
            done.record(stream)
        return Transfer(value, done)

    def put_window(self, window: np.ndarray, defer_metrics: bool = False) -> Transfer:
        """Start the transfer of a whole window WITHOUT a host copy.

        The source may be a live ring-slot view: on CUDA the caller must
        keep the slot acquired until ``Transfer.done`` has fired (that is
        what ``DistributedDataLoader.windows`` does), and must pass the
        transfer through :meth:`hand_off` before computing on it.
        ``defer_metrics`` leaves the ``ingest.bytes``/``ingest.windows``
        accounting to the caller, which records it at yield.
        """
        from ddl_tpu_torch.profiling import annotate

        span_t0 = obs_spans.t0()
        with annotate("ddl.ingest_put_window", worker="ingest.put_window"):
            out = self._put(window)
        obs_spans.record("ingest.transfer", *obs_spans.current_window(),
                         span_t0)
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

    def _stage(self, arr: np.ndarray) -> np.ndarray:
        """Copy ``arr`` into a pooled staging buffer (timed)."""
        buf = self.engine().pool.acquire(arr.shape, arr.dtype)
        t0 = time.perf_counter()
        np.copyto(buf, arr, casting="no")
        self.metrics.add_time("ingest.stage_copy", time.perf_counter() - t0)
        return buf

    def _fresh(self, arr: np.ndarray) -> Any:
        """A fresh copy of ``arr`` to transfer from: page-locked on CUDA
        (so the copy to the card can run asynchronously)."""
        if self._stream is None:
            return np.array(arr, copy=True)
        tdtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        src = torch.empty(arr.shape, dtype=tdtype, pin_memory=True)
        src.numpy()[...] = arr
        return src

    def put(self, cols: Sequence[np.ndarray]) -> Tuple[Any, ...]:
        """Transfer a tuple of column arrays; returns device tensors (or
        :class:`ShardedArray` s over ``sharding``).

        Each column is copied out of its (possibly slot-backed) memory
        before its transfer, so the producer may overwrite the slot as
        soon as this returns: into a recycled pool buffer when
        :attr:`batch_staged` (the buffer returns to the pool once the
        transfer's event has fired), else into fresh memory.  The
        transfers run on the current stream."""
        from ddl_tpu_torch.profiling import annotate

        with annotate("ddl.ingest_put", worker="ingest.put"):
            if self.batch_staged:
                pool = self.engine().pool
                cur = (torch.cuda.current_stream(self.device)
                       if self._stream is not None else None)
                out = []
                for c in cols:
                    buf = self._stage(c)
                    transfer = self._put(buf, stream=cur)
                    pool.recycle_when_ready(buf, transfer)
                    out.append(transfer.value)
                out = tuple(out)
                pool.sweep()
            else:
                out = tuple(self._transfer(self._fresh(c)) for c in cols)
        self.metrics.incr("ingest.bytes",
                          float(sum(int(c.nbytes) for c in cols)))
        self.metrics.incr("ingest.batches")
        return out

    def put_batch(
        self, batch: np.ndarray, splits: Sequence[int]
    ) -> Tuple[Any, ...]:
        """Transfer one unsplit batch, splitting into columns on device.
        The batch is copied out of its (possibly slot-backed) memory
        first — into a recycled staging buffer when :attr:`batch_staged`,
        else into fresh (on CUDA page-locked) memory — so the slot may be
        released once this returns; the transfer runs on the current
        stream."""
        if self.batch_staged:
            pool = self.engine().pool
            buf = self._stage(batch)
            cur = (torch.cuda.current_stream(self.device)
                   if self._stream is not None else None)
            transfer = self._put(buf, stream=cur)
            pool.recycle_when_ready(buf, transfer)
            pool.sweep()
            dev = transfer.value
        else:
            src = batch if self._stream is None else self._fresh(batch)
            dev = self._transfer(src)
        self.metrics.incr("ingest.bytes", float(batch.nbytes))
        self.metrics.incr("ingest.batches")
        return _device_split(dev, splits)

    def batch_transfer_fn(self, splits: Sequence[int]):
        """A :data:`~ddl_tpu_torch.staging.TransferFn` running this
        ingestor's batch put from an already staged buffer, on the side
        stream — what the background executor runs after its copy.  The
        consumer passes the value through :meth:`hand_off`."""

        def transfer(buf: np.ndarray):
            t = self._put(buf)
            self.metrics.incr("ingest.bytes", float(buf.nbytes))
            self.metrics.incr("ingest.batches")
            return Transfer(_device_split(t.value, splits), t.done), t

        return transfer


def measure_h2d_bandwidth(nbytes: int = 1 << 26, device: Any = None,
                          trials: int = 3) -> float:
    """Measured host-to-device link rate in bytes/s: the denominator of
    :func:`north_star_report`'s ``bandwidth_utilization``.

    A pageable numpy buffer of ``nbytes``, one warm-up copy, then the
    best of ``trials`` timed ``torch.from_numpy(buf).to(device)`` copies,
    each closed by a synchronize.  ``device=None`` is ``cuda:0`` and
    raises without a card; ``device="cpu"`` times the host copy."""
    dev = resolve_device("cuda:0" if device is None else device)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    buf = np.ones(nbytes, np.uint8)
    torch.from_numpy(buf).to(dev)  # warm-up
    sync()
    best = 0.0
    for _ in range(trials):
        t0 = time.perf_counter()
        out = torch.from_numpy(buf).to(dev)
        sync()
        best = max(best, nbytes / (time.perf_counter() - t0))
        del out
    return best


def north_star_report(metrics: Optional[Metrics] = None,
                      link_bytes_per_sec: Optional[float] = None) -> dict:
    """The JAX package's report (``ddl_tpu/ingest.py``
    ``north_star_report``), key for key, from a registry (the process
    default when ``metrics`` is None).

    A key whose measurement the port does not take yet reads 0 (an
    absent counter, timer, gauge or histogram), as the JAX package
    reports a registry that lacks it.  The ``pp.*`` and ``opt.*`` gauges
    are read from the process-default registry, where the pipeline and
    the sharded optimizer record them.  ``ingest_bytes_per_sec`` counts
    transfers to the device only; pass ``link_bytes_per_sec`` for
    ``bandwidth_utilization``.
    """
    m = metrics or default_metrics()
    dm = default_metrics()
    report = dict(m.rates())  # every rate over one elapsed snapshot
    report["windows"] = m.counter("consumer.windows")
    # Staged ingest.
    report["stage_copy_s"] = m.timer("ingest.stage_copy").total_s
    report["transfer_s"] = m.timer("ingest.transfer").total_s
    report["stall_s"] = m.timer("ingest.stall").total_s
    report["pool_hits"] = m.counter("staging.pool_hits")
    report["pool_misses"] = m.counter("staging.pool_misses")
    report["queue_depth_max"] = m.gauge("staging.queue_depth.max")
    report["alias_windows"] = m.counter("staging.alias_windows")
    report["alias_fallbacks"] = m.counter("staging.alias_fallbacks")
    # The training loop's overlap.
    report["window_wait_s"] = m.timer("trainer.window_wait").total_s
    report["release_wait_s"] = m.timer("ingest.release_wait").total_s
    report["pp_bubble"] = dm.gauge("pp.bubble")
    report["pp_chunks"] = dm.gauge("pp.chunks")
    # Recovery.
    report["respawns"] = m.counter("watchdog.respawns")
    report["watchdog_failures"] = m.counter("watchdog.failures")
    report["corrupt_windows"] = m.counter("integrity.corrupt_windows")
    report["replays"] = m.counter("integrity.replays")
    report["shuffle_degraded"] = m.counter("shuffle.degraded")
    report["staging_retries"] = m.counter("staging.retries")
    report["inline_fallbacks"] = m.counter("staging.inline_fallbacks")
    # The shard cache.
    report["cache_hits"] = m.counter("cache.hits")
    report["cache_misses"] = m.counter("cache.misses")
    report["cache_evictions"] = m.counter("cache.evictions")
    report["cache_spills"] = m.counter("cache.spills")
    report["cache_spill_hits"] = m.counter("cache.spill_hits")
    report["cache_quarantined"] = m.counter("cache.quarantined")
    report["cache_resident_bytes"] = m.gauge("cache.resident_bytes")
    report["cache_resident_bytes_max"] = m.gauge("cache.resident_bytes.max")
    # The ICI tier.
    report["ici_bytes"] = m.counter("ici.bytes")
    report["ici_windows"] = m.counter("ici.windows")
    report["ici_fallbacks"] = m.counter("ici.fallbacks")
    report["ici_fanout_s"] = m.timer("ici.fanout").total_s
    report["ici_redistribute_s"] = m.timer("ici.redistribute").total_s
    report["ici_peak_bytes"] = m.gauge("ici.peak_bytes")
    # The fused step.
    report["ingest_overlap_s"] = m.timer("trainer.ingest_overlap").total_s
    report["fused_windows"] = m.counter("trainer.fused_windows")
    report["slots_in_flight"] = m.gauge("ici.slots_in_flight.max")
    # The distributed optimizer.
    report["opt_state_bytes_per_replica"] = dm.gauge(
        "opt.state_bytes_per_replica")
    report["opt_state_bytes_total"] = dm.gauge("opt.state_bytes_total")
    report["opt_grad_comm_bytes_raw"] = dm.gauge("opt.grad_comm_bytes_raw")
    report["opt_grad_comm_bytes_quantized"] = dm.gauge(
        "opt.grad_comm_bytes_quantized")
    report["opt_gather_s"] = m.timer("opt.gather").total_s
    report["opt_scatter_s"] = m.timer("opt.scatter").total_s
    # The cluster control plane.
    report["view_changes"] = m.counter("cluster.view_changes")
    report["host_losses"] = m.counter("cluster.host_losses")
    report["host_rejoins"] = m.counter("cluster.rejoins")
    report["heartbeats_dropped"] = m.counter("cluster.heartbeats_dropped")
    report["shard_adoptions"] = m.counter("producer.shard_adoptions")
    report["cluster_cache_adoptions"] = m.counter("cluster.cache_adoptions")
    report["pool_updates"] = m.counter("consumer.pool_updates")
    # The multi-tenant service.
    report["serve_tenants"] = m.gauge("serve.tenants")
    report["serve_scale_ups"] = m.counter("serve.scale_ups")
    report["serve_scale_downs"] = m.counter("serve.scale_downs")
    report["serve_admission_waits_s"] = m.timer(
        "serve.admission_wait").total_s
    # Keyed by tenant name only: the ``.max`` companions are dropped.
    report["serve_tenant_stall"] = {
        k: v for k, v in m.prefixed("serve.stall.").items()
        if not k.endswith(".max")
    }
    # The wire formats.
    report["wire_encoded_bytes"] = m.counter("wire.encoded_bytes")
    report["wire_payload_bytes"] = m.counter("wire.payload_bytes")
    report["wire_decoded_windows"] = m.counter("wire.decoded_windows")
    report["wire_decode_fails"] = m.counter("wire.decode_fails")
    report["wire_fallbacks"] = m.counter("wire.fallbacks")
    # Preemption and the checkpoint tier.
    report["resilience_notices"] = m.counter("resilience.notices")
    report["resilience_drains"] = m.counter("resilience.drains")
    report["resilience_drain_s"] = m.timer("resilience.drain").total_s
    report["resilience_ckpts"] = m.counter("resilience.ckpts")
    report["resilience_final_ckpts"] = m.counter("resilience.final_ckpts")
    report["resilience_ckpt_submit_s"] = m.timer(
        "resilience.ckpt_submit").total_s
    report["resilience_ckpt_write_s"] = m.timer(
        "resilience.ckpt_write").total_s
    report["resilience_ckpt_quarantined"] = m.counter(
        "resilience.ckpt_quarantined")
    report["resilience_ckpt_cold_starts"] = m.counter(
        "resilience.ckpt_cold_starts")
    report["serve_revocations"] = m.counter("serve.revocations")
    # Percentiles from the bounded histograms: the window latency (a
    # blocking head acquire's wait for its committed window) and the
    # fair-share admission wait.
    report["window_latency_p50"] = m.quantile("consumer.window_latency", 0.5)
    report["window_latency_p99"] = m.quantile("consumer.window_latency",
                                              0.99)
    report["admission_wait_p99"] = m.quantile("serve.admission_wait", 0.99)
    # Per-tenant admission p99s, tenants found from the histogram names.
    suffix = ".admission_wait"
    report["serve_tenant_admission_p99"] = {
        name[len("ingest."):-len(suffix)]: m.quantile(name, 0.99)
        for name in m.hist_names("ingest.")
        if name.endswith(suffix)
    }
    # Where the per-window time went, by stage: the always-on timers, and
    # with span tracing armed the span log's per-stage totals.
    breakdown = {
        "acquire_wait": m.timer("consumer.wait").total_s,
        "stage_copy": m.timer("ingest.stage_copy").total_s,
        "transfer": m.timer("ingest.transfer").total_s,
        "release_wait": m.timer("ingest.release_wait").total_s,
        "window_wait": m.timer("trainer.window_wait").total_s,
        "admission_wait": m.timer("serve.admission_wait").total_s,
        "ici_fanout": m.timer("ici.fanout").total_s,
    }
    span_log = obs_spans.log()
    if span_log is not None:
        for stage, total in span_log.stage_totals().items():
            breakdown[f"span.{stage}"] = total
    report["stage_breakdown"] = breakdown
    report["obs_reports_applied"] = m.counter("obs.reports_applied")
    report["obs_reports_stale"] = m.counter("obs.reports_stale")
    report["obs_flight_dumps"] = m.counter("obs.flight_dumps")
    # Self-tuning audit (zeros until the tune slice).
    report["tune_decisions"] = m.counter("tune.decisions")
    report["tune_reverts"] = m.counter("tune.reverts")
    report["tune_cost_source"] = {
        src: m.counter(f"tune.cost_source.{src}")
        for src in ("measured", "declared", "default")
    }
    if link_bytes_per_sec:
        report["link_bytes_per_sec"] = link_bytes_per_sec
        report["bandwidth_utilization"] = (
            report["ingest_bytes_per_sec"] / link_bytes_per_sec)
    return report


class PrefetchIterator:
    """Wrap a host-batch iterator, keeping ``depth`` device transfers in
    flight ahead of compute.  ``depth=None`` reads
    ``DDL_TORCH_PREFETCH_DEPTH``.

    - **Inline** (default): each fill calls ``put`` — e.g. a bound
      :meth:`DeviceIngestor.put_batch` — on the caller thread.
    - **Staged** (``transfer`` given, e.g. ``ingestor.batch_transfer_fn``,
      and ``ingestor.batch_staged``): host batches are enqueued to the
      background executor, which stages and transfers them off-thread;
      ``__next__`` pops ready values (its waits count into
      ``ingest.stall``).  The offload adapts: when the consumer steals
      every job (a host with no spare core, where each handoff costs
      without buying overlap), fills turn to direct ``put`` calls for a
      span, then probe the executor again.
    """

    #: Consecutive stolen jobs before the worker counts as starved, and
    #: the span of direct puts before probing it again.
    PROBE_MISSES = 2
    DIRECT_SPAN = 256

    def __init__(self, it: Any, put: Any, depth: Optional[int] = None,
                 ingestor: Optional[DeviceIngestor] = None,
                 transfer: Any = None):
        self._it = iter(it)
        self._put = put
        self._ingestor = ingestor
        self._transfer = (
            transfer if ingestor is not None and ingestor.batch_staged
            else None
        )
        if depth is None:
            depth = envspec.get("DDL_TORCH_PREFETCH_DEPTH")
        self._depth = max(1, depth)
        self._queue: collections.deque = collections.deque()

    def set_depth(self, depth: int) -> None:
        """Retune the in-flight transfer count live (:mod:`ddl_tpu_torch.
        tune`).  Takes effect at the next fill: a shrink stops refilling
        until the queue drains below the new depth; a dispatched transfer
        is never cancelled."""
        self._depth = max(1, int(depth))

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self) -> Any:
        engine = self._ingestor.engine() if self._transfer is not None else None
        while len(self._queue) < self._depth:
            try:
                host_batch = next(self._it)
            except StopIteration:
                break
            if engine is not None and not engine.faulted and engine.direct_left == 0:
                self._queue.append(engine.submit(host_batch, self._transfer))
            else:
                if engine is not None and not engine.faulted:
                    engine.direct_left -= 1
                self._queue.append(self._put(host_batch))
        if not self._queue:
            raise StopIteration
        head = self._queue.popleft()
        if not isinstance(head, StagedTransfer):
            return head
        # An unstarted head job runs here; on retry exhaustion the
        # verified staging copy goes down the inline path.
        value = engine.complete_or_salvage(head, self._put)
        if head.worker_executed:
            engine.stolen_streak = 0
        else:
            engine.stolen_streak += 1
            if engine.stolen_streak >= self.PROBE_MISSES:
                engine.stolen_streak = 0
                engine.direct_left = self.DIRECT_SPAN
        if isinstance(value, Transfer):
            return self._ingestor.hand_off(value)
        return value


def _device_split(dev: Any, splits: Sequence[int]) -> Tuple[Any, ...]:
    """Column-split a transferred (B, sum(splits)) batch on device.  A
    sharded batch whose columns are whole at every position splits shard
    by shard; one sharded along its columns gives blocks replicated along
    the columns on the same mesh (as the JAX package's slice does), each
    built from the shards it overlaps.  A column block spanning the whole
    width passes through as it is."""
    if len(splits) == 1 and splits[0] == dev.shape[1]:
        return (dev,)
    if isinstance(dev, ShardedArray):
        if any(s.index[1] != slice(None) for s in dev.shards):
            return _gather_column_blocks(dev, splits)
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


def _gather_column_blocks(dev: ShardedArray,
                          splits: Sequence[int]) -> Tuple[ShardedArray, ...]:
    """The column blocks of a batch sharded along its columns, each
    replicated along the columns on ``dev``'s mesh (the other dims keep
    their split): a position's block is the concatenation of the column
    pieces of the shards that hold its rows."""
    entries = dev.sharding._entries(len(dev.shape))
    spec = P(*((entries[0], None) + tuple(entries[2:])))
    out, off = [], 0
    for w in splits:
        shape = (dev.shape[0], w) + dev.shape[2:]
        target = NamedSharding(dev.sharding.mesh, spec)
        datas = []
        for p, idx in enumerate(target.shard_indices(shape)):
            pieces = []
            for s in dev.shards:
                if s.index[0] != idx[0] or s.index[2:] != idx[2:]:
                    continue
                c0, c1, _ = s.index[1].indices(dev.shape[1])
                lo, hi = max(off, c0), min(off + w, c1)
                if lo < hi and not any(c0 == q[0] for q in pieces):
                    pieces.append((c0, s.data[:, lo - c0:hi - c0]))
            data = torch.cat([d for _, d in sorted(pieces, key=lambda q: q[0])],
                             dim=1)
            datas.append(data.to(dev.shards[p].device))
        out.append(ShardedArray(shape, target, datas))
        off += w
    return tuple(out)
