"""ICI ingest tier: the fan-out and the loader→trainer redistribution
(port of ``ddl_tpu/parallel/ici.py``).

A window crosses host→device once, onto one *anchor* mesh position, and
this module moves it to the target :class:`~ddl_tpu_torch.parallel.mesh.
NamedSharding`:

1. **Fan-out** (:mod:`ddl_tpu_torch.ops.ici_fanout`): K7 replicates or
   K8 shards the anchor's 2-D window view over a flat ring of positions.
2. **Finish**: the ring layout ("split n ways along one dim",
   ring-ordered target-major) becomes the target layout — a reshape for
   a replicated target; for a sharded one, a gather of each position's
   siblings over the replication axes, a reshape, and the split axis
   moved back.  Every position's shard is one contiguous tensor.

The plan (:func:`plan_distribution`) is the reference's, field for
field, pricing included: it decides which geometries have a
bounded-memory plan and which take the plain route.  It prices the
reference's ICI ring — landing blocks, sink chunk, transit buffers — so
on one card the port allocates less than the plan's ``peak_bytes``.

Everything is keyed by mesh position, never by device: on one card all
positions are the same device.  Ladder: an unplannable geometry takes
the plain route (:func:`ddl_tpu_torch.ingest.device_put`) for that
geometry only, counted once in ``ici.fallbacks``.  A failure while
distributing latches the whole tier to the plain route only where the
plain kernels run (CPU tensors); on the card a kernel's failure raises.

Observability: ``ici.bytes`` (the plan's wire bytes), ``ici.windows``,
``ici.fallbacks``, the ``ici.fanout`` (kernel dispatch) and
``ici.redistribute`` (2-D view and finish) timers, and the
``ici.peak_bytes`` / ``ici.slots_in_flight`` gauges.
"""

from __future__ import annotations

import dataclasses
import logging
import time
import weakref
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ddl_tpu_torch import envspec
from ddl_tpu_torch.exceptions import ShutdownRequested
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
from ddl_tpu_torch.parallel.mesh import NamedSharding, ShardedArray
from ddl_tpu_torch.utils import done_event, value_ready

logger = logging.getLogger("ddl_tpu_torch")

#: Redistribution legs may not exceed this multiple of the window size in
#: per-device live bytes, as the reference prices them (its worst case:
#: a single-chunk replicate = landing + payload output + sink chunk).
DEFAULT_MEMORY_FACTOR = 3.0

#: The wire encodings of the reference; the port carries raw only.
_WIRE_DTYPES = ("raw", "bf16", "int8")


def fused_enabled() -> bool:
    """The ``DDL_TORCH_FUSED`` gate (default on): a distributor prices
    the reference's two landing slots in its plans."""
    return envspec.flag("DDL_TORCH_FUSED")


class PlanError(ValueError):
    """The target sharding has no bounded-memory plan (the caller takes
    the plain route)."""


@dataclasses.dataclass(frozen=True)
class RedistLeg:
    """One plan step: what moves, over which axes, at what cost."""

    kind: str  #: "fanout.replicate" | "fanout.shard" | "all_gather" | "reshape"
    axes: Tuple[str, ...]  #: named mesh axes the leg communicates over
    ici_bytes: int  #: bytes the reference's leg moves over ICI, per window
    peak_bytes: int  #: max per-device live bytes during the leg
    asynchronous: bool = False  #: emitted as a start/wait pair (fused)
    wire_dtype: str = "raw"


@dataclasses.dataclass(frozen=True)
class DistributionPlan:
    """A geometry's full route from the anchor position to the target."""

    mode: str  #: "replicate" | "shard"
    shape: Tuple[int, ...]
    dtype: Any
    split_dim: Optional[int]  #: window dim the target shards (None = replicated)
    split_axes: Tuple[str, ...]  #: mesh axes sharding split_dim (target-major)
    rest_axes: Tuple[str, ...]  #: replication axes the finish leg gathers
    ring_positions: Tuple[int, ...]  #: fan-out ring, target-major order
    legs: Tuple[RedistLeg, ...]
    wire_bytes: int  #: total ICI bytes per window (the reference's ring)
    payload_bytes: int  #: bytes usefully delivered per window
    peak_bytes: int  #: max per-device live bytes across legs (incl. landing)
    dst_shard_bytes: int  #: destination per-position shard size
    peak_factor: float  #: peak_bytes / window bytes (asserted bound)
    n_slots: int = 1  #: landing slots priced in flight (2 = fused)
    wire_dtype: str = "raw"
    encoded_bytes: int = 0  #: 2D encoded bytes per window (== nbytes for raw)

    @property
    def anchor(self) -> int:
        """The position host→device lands on (ring source)."""
        return self.ring_positions[0]


def _dtype(dtype: Any) -> Any:
    """The numpy dtype of a numpy or torch dtype; ``torch.bfloat16``
    stays as it is (numpy has none)."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return dtype
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _split_layout(spec: Any, ndim: int) -> Tuple[Optional[int], Tuple[str, ...]]:
    """The single (dim, mesh-axes) pair a supported target spec shards,
    or (None, ()) for full replication.  Raises PlanError on specs the
    fan-out ring cannot source (more than one sharded dim)."""
    sharded = []
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    for dim, entry in enumerate(entries):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if axes:
            sharded.append((dim, axes))
    if not sharded:
        return None, ()
    if len(sharded) > 1:
        raise PlanError(
            f"target spec {spec} shards {len(sharded)} dims; the ICI "
            "fan-out sources a single split dim"
        )
    return sharded[0]


def _ring_order(mesh: Any, split_axes: Tuple[str, ...],
                rest_axes: Tuple[str, ...]) -> Tuple[int, ...]:
    """Mesh positions flattened target-major (split axes outermost, in
    spec order): ring block ``i`` then lands exactly where the target
    layout wants row-block ``i``, so the finish is a pure gather over
    ``rest_axes`` — never a permute."""
    names = list(mesh.axis_names)
    order = [names.index(a) for a in split_axes] + [
        names.index(a) for a in rest_axes
    ]
    return tuple(int(p) for p in np.transpose(mesh.positions(), order).reshape(-1))


def _check_raw(wire_dtype: str) -> None:
    """The port carries the raw wire only; the encoded wires are the
    wire.py slice."""
    if wire_dtype not in _WIRE_DTYPES:
        raise ValueError(f"wire_dtype must be one of {_WIRE_DTYPES}, got "
                         f"{wire_dtype!r}")
    if wire_dtype != "raw":
        raise NotImplementedError(
            f"wire_dtype={wire_dtype!r}: the encoded ICI wires are the wire.py "
            "slice of the port; use 'raw'"
        )


def wire_cols(cols: int, dtype: Any, wire_dtype: str) -> int:
    """Bytes of one encoded 2D row of ``cols`` values (raw only)."""
    _check_raw(wire_dtype)
    return cols * _dtype(dtype).itemsize


def plan_distribution(
    shape: Sequence[int],
    dtype: Any,
    sharding: NamedSharding,
    max_memory_factor: Optional[float] = None,
    n_chunks: Optional[int] = None,
    n_slots: int = 1,
    wire_dtype: str = "raw",
) -> DistributionPlan:
    """Plan the anchor→``sharding`` route for one window geometry, with
    the reference's pricing (``n_slots`` prices the fused two-slot
    protocol; ``max_memory_factor`` defaults to ``DEFAULT_MEMORY_FACTOR
    * n_slots``).

    Raises :class:`PlanError` when no bounded plan exists (a spec that
    shards two dims, a split dim not divisible by the positions, or a
    peak over ``max_memory_factor`` × the window) — callers take the
    plain route and count it.
    """
    from ddl_tpu_torch.ops import ici_fanout

    shape = tuple(int(s) for s in shape)
    dtype = _dtype(dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    mesh = sharding.mesh
    spec = sharding.spec
    n_dev = mesh.size
    split_dim, split_axes = _split_layout(spec, len(shape))
    rest_axes = tuple(
        a for a in mesh.axis_names if a not in split_axes
    )
    n_chunks = n_chunks or ici_fanout.DEFAULT_CHUNKS
    n_slots = max(1, min(int(n_slots), ici_fanout.N_SLOTS))
    if max_memory_factor is None:
        max_memory_factor = DEFAULT_MEMORY_FACTOR * n_slots
    fused = n_slots > 1
    _check_raw(wire_dtype)

    if split_dim is None:
        ring = _ring_order(mesh, (), rest_axes)
        # The reference's kernel clamps the chunk count to the rows.
        rows = shape[0]
        n_chunks = max(1, min(n_chunks, rows))
        enc = rows * wire_cols(int(np.prod(shape)) // rows, dtype, wire_dtype)
        wire = ici_fanout.wire_bytes(
            "replicate", enc, n_dev, n_chunks, rows=rows
        )
        payload = ici_fanout.payload_bytes("replicate", nbytes, n_dev)
        # Per-device live in the reference: the window-sized landing
        # block + the kernel output (the window plus the sink chunk), one
        # set per in-flight landing slot.
        chunk = -(-rows // n_chunks) * (enc // rows)
        slot_live = 2 * enc + chunk
        peak = n_slots * slot_live
        legs = (
            RedistLeg("fanout.replicate", ("x",), wire, peak,
                      asynchronous=fused, wire_dtype=wire_dtype),
        )
        plan = DistributionPlan(
            mode="replicate", shape=shape, dtype=dtype, split_dim=None,
            split_axes=(), rest_axes=rest_axes, ring_positions=ring,
            legs=legs, wire_bytes=wire, payload_bytes=payload,
            peak_bytes=peak, dst_shard_bytes=nbytes,
            peak_factor=peak / nbytes, n_slots=n_slots,
            wire_dtype=wire_dtype, encoded_bytes=enc,
        )
    else:
        split = shape[split_dim]
        if split % n_dev:
            raise PlanError(
                f"split dim {split_dim} ({split} rows) not divisible by "
                f"the {n_dev}-device ring"
            )
        g = int(np.prod([mesh.shape[a] for a in split_axes]))
        ring = _ring_order(mesh, split_axes, rest_axes)
        enc = split * wire_cols(int(np.prod(shape)) // split, dtype, wire_dtype)
        wire = ici_fanout.wire_bytes("shard", enc, n_dev)
        payload = ici_fanout.payload_bytes("shard", nbytes, n_dev)
        block = enc // n_dev
        dst = nbytes // g
        # Scatter slot-live in the reference: the landing block + the
        # output block + the double-buffered transit (2 blocks); the fused
        # protocol carries one more slot-live span through every leg.
        slot_live = enc + 3 * block
        extra = (n_slots - 1) * slot_live
        legs: List[RedistLeg] = [
            RedistLeg("fanout.shard", ("x",), wire, slot_live + extra,
                      asynchronous=fused, wire_dtype=wire_dtype),
        ]
        if rest_axes:
            m = n_dev // g
            # Tiled gather over the replication axes: each position
            # receives the m-1 sibling blocks of its target shard.
            legs.append(
                RedistLeg(
                    "all_gather", rest_axes, n_dev * (m - 1) * block,
                    enc + block + enc // g + extra,
                    wire_dtype=wire_dtype,
                )
            )
        legs.append(
            RedistLeg("reshape", (), 0, enc + dst + extra)
        )
        peak = max(leg.peak_bytes for leg in legs)
        plan = DistributionPlan(
            mode="shard", shape=shape, dtype=dtype, split_dim=split_dim,
            split_axes=split_axes, rest_axes=rest_axes, ring_positions=ring,
            legs=tuple(legs), wire_bytes=wire + (
                legs[1].ici_bytes if rest_axes else 0
            ),
            payload_bytes=payload, peak_bytes=peak, dst_shard_bytes=dst,
            peak_factor=peak / nbytes, n_slots=n_slots,
            wire_dtype=wire_dtype, encoded_bytes=enc,
        )
    if plan.peak_factor > max_memory_factor:
        raise PlanError(
            f"plan peak {plan.peak_bytes}B is {plan.peak_factor:.2f}x the "
            f"window ({nbytes}B) — over the "
            f"{max_memory_factor}x memory bound"
        )
    return plan


# -- execution pieces -------------------------------------------------------


def _to2d(block: torch.Tensor, split_dim: int) -> torch.Tensor:
    """The anchor-local ``(split, -1)`` view the ring moves: the split
    axis moved first and the rest flattened — a copy when ``split_dim``
    is not 0, else a view."""
    rows = block.shape[split_dim]
    return torch.movedim(block, split_dim, 0).reshape(rows, -1).contiguous()


def _finish_replicate(rep: ShardedArray, plan: DistributionPlan,
                      sharding: NamedSharding) -> ShardedArray:
    """Each ring position's replica, reshaped to the window (a view),
    placed at its mesh position."""
    by_position = [None] * len(plan.ring_positions)
    for r, p in enumerate(plan.ring_positions):
        by_position[p] = rep.shards[r].data.reshape(plan.shape)
    return ShardedArray(plan.shape, sharding, by_position)


def _finish_shard(ring_out: ShardedArray, plan: DistributionPlan,
                  sharding: NamedSharding) -> ShardedArray:
    """Mesh position ``p`` (ring index ``r = s * m + q``: split block
    ``s``, replica ``q`` of ``m``) gathers the ring blocks ``s * m ..
    (s + 1) * m - 1`` in order, reshapes them to the window's other dims
    and moves the split axis back: one contiguous tensor per position, a
    view of its ring block when there is nothing to gather or move."""
    shape, split_dim = plan.shape, plan.split_dim
    n = len(plan.ring_positions)
    m = n // int(np.prod([sharding.mesh.shape[a] for a in plan.split_axes]))
    other = tuple(shape[d] for d in range(len(shape)) if d != split_dim)
    shard_shape = sharding.shard_shape(shape)
    devices = sharding.mesh.device_list
    blocks = [s.data for s in ring_out.shards]
    rows = blocks[0].shape[0]
    by_position: List[Any] = [None] * n
    for r, p in enumerate(plan.ring_positions):
        s = r // m
        if m == 1 and split_dim == 0:
            by_position[p] = blocks[r].reshape(shard_shape)
            continue
        out = torch.empty(shard_shape, dtype=blocks[r].dtype, device=devices[p])
        lead = torch.movedim(out, split_dim, 0)
        for k in range(m):
            lead[k * rows:(k + 1) * rows].copy_(
                blocks[s * m + k].reshape((rows,) + other))
        by_position[p] = out
    return ShardedArray(shape, sharding, by_position)


class IciDistributor:
    """Executes :func:`plan_distribution` routes for one target sharding.

    Plans are cached (8 geometries, LRU by recency).  Two rungs of
    fallback to the plain route, scoped to their causes:

    - **Per geometry** — a shape with no bounded plan (ragged final
      batch, indivisible split) takes the plain route for THAT geometry
      only, counted once in ``ici.fallbacks``; plannable geometries keep
      riding the tier.
    - **Tier-wide latch, CPU only** — a failure while distributing CPU
      tensors (the plain kernels) latches the plain route for the
      distributor's life.  On the card a kernel's build or launch
      failure raises; the first window of each geometry synchronises
      inside :meth:`distribute`, so a fault of the kernel surfaces there.

    **Landing slots** (``n_slots``, default
    :data:`~ddl_tpu_torch.ops.ici_fanout.N_SLOTS`, 1 under
    ``DDL_TORCH_FUSED=0``): the plans price them, as the reference's
    do; the kernels allocate fresh outputs per window.  The
    ``ici.slots_in_flight`` gauge counts the windows whose distribution
    has not completed on the device (at most ``n_slots``, high-water on
    ``.max``), over weak references, so tracking never keeps a window
    alive.
    """

    def __init__(
        self,
        sharding: NamedSharding,
        metrics: Optional[Metrics] = None,
        max_memory_factor: Optional[float] = None,
        n_chunks: Optional[int] = None,
        n_slots: Optional[int] = None,
        wire_dtype: str = "raw",
    ):
        from ddl_tpu_torch.ops import ici_fanout

        _check_raw(wire_dtype)
        self.wire_dtype = wire_dtype
        self.sharding = sharding
        self.metrics = metrics or default_metrics()
        if n_slots is None:
            n_slots = ici_fanout.N_SLOTS if fused_enabled() else 1
        self.n_slots = max(1, min(int(n_slots), ici_fanout.N_SLOTS))
        if max_memory_factor is None:
            max_memory_factor = DEFAULT_MEMORY_FACTOR * self.n_slots
        self.max_memory_factor = max_memory_factor
        self.n_chunks = n_chunks
        self.faulted = False
        # (weak ref to a result, its done event): the slots_in_flight
        # gauge's view of recent windows, bounded by n_slots.
        self._in_flight: list = []
        # geometry -> DistributionPlan | PlanError, 8 entries LRU.
        self._plans: dict = {}
        # Geometries whose first window completed a synchronised dispatch.
        self._validated: set = set()
        # Unplannable geometries already logged and counted (once each,
        # even when the LRU evicts and re-derives their PlanError).
        self._counted_failures: set = set()

    def plan(self, shape: Sequence[int], dtype: Any) -> DistributionPlan:
        key = (tuple(int(s) for s in shape), str(_dtype(dtype)))
        # pop + re-insert marks recency (dicts keep insertion order).
        hit = self._plans.pop(key, None)
        if hit is None:
            try:
                hit = plan_distribution(
                    key[0], dtype, self.sharding,
                    max_memory_factor=self.max_memory_factor,
                    n_chunks=self.n_chunks, n_slots=self.n_slots,
                    wire_dtype=self.wire_dtype,
                )
            except PlanError as e:
                hit = e
                if key not in self._counted_failures:
                    self._counted_failures.add(key)
                    logger.warning(
                        "ddl_tpu_torch: no bounded ICI plan for %s/%s (%s) — "
                        "this geometry takes the plain route",
                        key[0], key[1], e,
                    )
                    self.metrics.incr("ici.fallbacks")
            if len(self._plans) >= 8:
                self._plans.pop(next(iter(self._plans)))
        self._plans[key] = hit
        if isinstance(hit, PlanError):
            raise hit
        return hit

    def anchor(self, shape: Sequence[int], dtype: Any) -> torch.device:
        """The device host→device must land on for this geometry."""
        return self.sharding.mesh.device_list[self.plan(shape, dtype).anchor]

    def put(self, arr: Any, device_put: Any) -> ShardedArray:
        """The ingest seam's one call: copy ``arr`` onto the plan's anchor
        with ``device_put(arr, device)``, then distribute it.  A geometry
        with no bounded plan takes ``device_put(arr, sharding)``, the
        plain route, instead."""
        if not self.faulted:
            try:
                anchor = self.anchor(arr.shape, arr.dtype)
            except PlanError:
                pass  # counted and logged once in plan()
            else:
                return self.distribute(device_put(arr, anchor))
        return device_put(arr, self.sharding)

    def distribute(self, block: torch.Tensor) -> ShardedArray:
        """Move an anchor-resident window to the target sharding.  An
        unplannable geometry takes the plain route (that geometry only);
        a failure while distributing CPU tensors takes it and latches."""
        if self.faulted:
            return self._plain_route(block)
        try:
            plan = self.plan(block.shape, block.dtype)
        except PlanError:
            return self._plain_route(block)
        try:
            return self._distribute_planned(block, plan)
        except (ShutdownRequested, KeyboardInterrupt):
            raise  # a shutdown is not a failed leg — never latch on it
        except Exception as e:  # noqa: BLE001 - ladder rung, re-routed
            if block.device.type != "cpu":
                raise  # a card's kernel failure is the run's failure
            self._latch(f"{type(e).__name__}: {e}")
            return self._plain_route(block)

    def _distribute_planned(self, block: torch.Tensor,
                            plan: DistributionPlan) -> ShardedArray:
        from ddl_tpu_torch.ops import ici_fanout

        m = self.metrics
        devices = self.sharding.mesh.device_list
        ring = [devices[p] for p in plan.ring_positions]
        t0 = time.perf_counter()
        flat = _to2d(block, 0 if plan.mode == "replicate" else plan.split_dim)
        t1 = time.perf_counter()
        if plan.mode == "replicate":
            out = ici_fanout.fanout_replicate(flat, ring)
        else:
            out = ici_fanout.fanout_shard(flat, ring)
        t2 = time.perf_counter()
        m.add_time("ici.fanout", t2 - t1)
        if plan.mode == "replicate":
            result = _finish_replicate(
                ici_fanout.replicated_view(out, ring), plan, self.sharding)
        else:
            result = _finish_shard(out, plan, self.sharding)
        m.add_time("ici.redistribute", (t1 - t0) + (time.perf_counter() - t2))
        key = (plan.shape, str(plan.dtype))
        if key not in self._validated:
            # First window of a geometry: wait for it, so a fault of the
            # kernel surfaces here rather than at the consumer.
            if block.device.type == "cuda":
                torch.cuda.current_stream(block.device).synchronize()
            self._validated.add(key)
        self._track_in_flight(result, done_event(block.device))
        m.incr("ici.bytes", float(plan.wire_bytes))
        m.incr("ici.windows")
        m.set_gauge("ici.peak_bytes", float(plan.peak_bytes))
        return result

    def _track_in_flight(self, result: ShardedArray, done: Any) -> None:
        """Sweep completed windows, record ``result``, refresh the
        ``ici.slots_in_flight`` gauge — all non-blocking.  Entries hold
        the result weakly: tracking never keeps a window alive."""
        self._in_flight = [
            (r, d) for r, d in self._in_flight
            if r() is not None and not value_ready(d, default=True)
        ]
        occupied = len(self._in_flight) + (
            0 if value_ready(done, default=True) else 1
        )
        self._in_flight.append((weakref.ref(result), done))
        del self._in_flight[: -max(1, self.n_slots)]  # bounded
        occupied = min(occupied, self.n_slots)
        self.metrics.set_gauge("ici.slots_in_flight", float(occupied))

    def _latch(self, why: str) -> None:
        if not self.faulted:
            logger.error(
                "ddl_tpu_torch: ICI distribution failed (%s) — latched "
                "the plain route", why,
            )
        self.faulted = True
        self._in_flight = []
        self.metrics.set_gauge("ici.slots_in_flight", 0.0)
        self.metrics.incr("ici.fallbacks")

    def _plain_route(self, block: torch.Tensor) -> ShardedArray:
        """The route without the tier: each position copies its slice of
        the anchor's window."""
        from ddl_tpu_torch.ingest import device_put

        return device_put(block, self.sharding)


#: The loader→trainer sharding pairs the planner's parity tests cover:
#: (mesh axes, target spec entries), as in the reference.
DRYRUN_MATRIX: Tuple[Tuple[Tuple[Tuple[str, int], ...], Tuple[Any, ...]], ...] = (
    ((("dp", 8),), ("dp", None)),
    ((("dp", 8),), (None, "dp")),
    ((("dp", 4), ("fsdp", 2)), (None, "dp")),
    ((("dp", 4), ("fsdp", 2)), (("dp", "fsdp"), None)),
    ((("dp", 2), ("fsdp", 2), ("tp", 2)), (None, "dp")),
    ((("dp", 2), ("fsdp", 2), ("tp", 2)), (("dp", "fsdp"), None)),
    ((("dp", 2), ("fsdp", 4)), (None, None)),
    ((("dp", 8),), (None, "dp", None)),
)
