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

Wire (``wire_dtype``, :mod:`ddl_tpu_torch.wire`): a float window may
cross the ring encoded.  The anchor encodes its 2-D view into ``(rows,
wire_cols)`` uint8 rows — bf16 bits, or int8 values followed by the
row's fp32 block scales, so any row split carries its own decode state —
K7/K8 move those rows, and every position decodes its rows at the
landing edge.  The encode and decode are plain torch ops on the card
(:func:`encode2d`, :func:`decode2d`), byte-identical to the host
``wire.encode_window``.  An int or token window plans raw.

Everything is keyed by mesh position, never by device: on one card all
positions are the same device.  Ladder: an unplannable geometry takes
the plain route (:func:`ddl_tpu_torch.ingest.device_put`) for that
geometry only, counted once in ``ici.fallbacks``.  A failure while
distributing CPU tensors — the ``ici.fanout`` fault site's injected leg
failure included — latches the whole tier to the plain route (counted in
``ici.fallbacks``); on the card any failure — a kernel's, an encode's, a
decode's or an injected one — raises.

Observability: ``ici.bytes`` (the plan's wire bytes), ``ici.windows``,
``ici.fused_windows`` (windows dispatched with two landing slots),
``ici.fallbacks``, the ``ici.fanout`` (encode and kernel dispatch) and
``ici.redistribute`` (2-D view, finish and decode) timers, the
``ici.peak_bytes`` / ``ici.slots_in_flight`` gauges, and on an encoded
wire ``wire.encoded_bytes`` / ``wire.payload_bytes``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
import weakref
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ddl_tpu_torch import envspec, wire
from ddl_tpu_torch.exceptions import ShutdownRequested
from ddl_tpu_torch.faults import fault_point
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
from ddl_tpu_torch.parallel.mesh import NamedSharding, ShardedArray
from ddl_tpu_torch.utils import done_event, value_ready

logger = logging.getLogger("ddl_tpu_torch")

#: Redistribution legs may not exceed this multiple of the window size in
#: per-device live bytes, as the reference prices them (its worst case:
#: a single-chunk replicate = landing + payload output + sink chunk).
DEFAULT_MEMORY_FACTOR = 3.0

def fused_enabled(default: bool = True) -> bool:
    """The ``DDL_TORCH_FUSED`` gate (default on): a distributor prices
    the reference's two landing slots in its plans, and the trainer runs
    its fused loop.  Only ``0`` turns it off, as in the JAX package."""
    val = envspec.raw("DDL_TORCH_FUSED")
    if val is None:
        return default
    return val != "0"


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


def _is_float(dtype: Any) -> bool:
    dtype = _dtype(dtype)
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    return wire.lossy_supported(dtype)


def wire_cols(cols: int, dtype: Any, wire_dtype: str) -> int:
    """uint8 columns of one encoded 2D row of ``cols`` values: the
    payload bytes plus, for int8, the row's fp32 block scales (which
    travel with their row).  The size formulas of :mod:`ddl_tpu_torch.
    wire`, so a plan prices what the encode produces."""
    wd = wire.check_wire_dtype(wire_dtype)
    if wd == "raw":
        return cols * _dtype(dtype).itemsize
    return (wire.encoded_nbytes((1, cols), np.float32, wd)
            + wire.scale_bytes_for((1, cols), wd))


def encode2d(x: torch.Tensor, wire_dtype: str) -> torch.Tensor:
    """Encode float rows ``(rows, cols)`` into ``(rows, wire_cols)`` uint8
    on ``x``'s device: bf16 bits, or int8 values then the row's fp32
    block scales.  The host ``wire.encode_window``'s numerics — block
    maxima over zero padding, a true division (tensor by tensor; a
    division by a Python scalar may run as a reciprocal product on the
    card), round half to even — so the bytes equal the host encode's."""
    rows, cols = x.shape
    if wire_dtype == "bf16":
        return x.to(torch.bfloat16).contiguous().view(torch.uint8).reshape(
            rows, 2 * cols)
    block = wire.QUANT_BLOCK
    nblk = -(-cols // block)
    xf = x.to(torch.float32)
    if nblk * block != cols:
        xf = torch.nn.functional.pad(xf, (0, nblk * block - cols))
    xb = xf.view(rows, nblk, block)
    s = xb.abs().amax(dim=-1) / torch.full_like(xb[..., 0], 127.0)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(xb / s.unsqueeze(-1)), -127.0, 127.0)
    out = torch.empty((rows, cols + 4 * nblk), dtype=torch.uint8,
                      device=x.device)
    out[:, :cols] = q.to(torch.int8).view(rows, -1)[:, :cols].view(torch.uint8)
    out[:, cols:] = s.contiguous().view(torch.uint8)
    return out


def decode2d(w: torch.Tensor, cols: int, dtype: torch.dtype,
             wire_dtype: str) -> torch.Tensor:
    """Inverse of :func:`encode2d`: ``(rows, wire_cols)`` uint8 rows back
    to ``(rows, cols)`` of ``dtype`` (the host ``wire.decode_window``'s
    numerics: int8 times its block scale in fp32)."""
    rows = w.shape[0]
    if wire_dtype == "bf16":
        return w.contiguous().view(torch.bfloat16).to(dtype)
    block = wire.QUANT_BLOCK
    nblk = -(-cols // block)
    q = w[:, :cols].contiguous().view(torch.int8).to(torch.float32)
    s = w[:, cols:].contiguous().view(torch.float32)
    if nblk * block != cols:
        q = torch.nn.functional.pad(q, (0, nblk * block - cols))
    out = (q.view(rows, nblk, block) * s.unsqueeze(-1)).view(rows, -1)
    return out[:, :cols].to(dtype).contiguous()


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
    # The lossy wire applies to float windows only: an int or token
    # geometry plans raw.
    wire_dtype = wire.check_wire_dtype(wire_dtype)
    if wire_dtype != "raw" and not _is_float(dtype):
        wire_dtype = "raw"

    if split_dim is None:
        ring = _ring_order(mesh, (), rest_axes)
        # The reference's kernel clamps the chunk count to the rows.
        rows = shape[0]
        n_chunks = max(1, min(n_chunks, rows))
        enc = rows * wire_cols(int(np.prod(shape)) // rows, dtype, wire_dtype)
        wire_b = ici_fanout.wire_bytes(
            "replicate", enc, n_dev, n_chunks, rows=rows
        )
        payload = ici_fanout.payload_bytes("replicate", nbytes, n_dev)
        # Per-device live in the reference: the window-sized landing
        # block + the kernel output (the window plus the sink chunk), one
        # set per in-flight landing slot, at the encoded size; a wire
        # plan adds the decoded window the landing edge materialises.
        chunk = -(-rows // n_chunks) * (enc // rows)
        slot_live = 2 * enc + chunk
        peak = n_slots * slot_live + (nbytes if wire_dtype != "raw" else 0)
        legs = (
            RedistLeg("fanout.replicate", ("x",), wire_b, peak,
                      asynchronous=fused, wire_dtype=wire_dtype),
        )
        plan = DistributionPlan(
            mode="replicate", shape=shape, dtype=dtype, split_dim=None,
            split_axes=(), rest_axes=rest_axes, ring_positions=ring,
            legs=legs, wire_bytes=wire_b, payload_bytes=payload,
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
        wire_b = ici_fanout.wire_bytes("shard", enc, n_dev)
        payload = ici_fanout.payload_bytes("shard", nbytes, n_dev)
        block = enc // n_dev
        dst = nbytes // g
        # Scatter slot-live in the reference: the landing block + the
        # output block + the double-buffered transit (2 blocks); the fused
        # protocol carries one more slot-live span through every leg.
        slot_live = enc + 3 * block
        extra = (n_slots - 1) * slot_live
        legs: List[RedistLeg] = [
            RedistLeg("fanout.shard", ("x",), wire_b, slot_live + extra,
                      asynchronous=fused, wire_dtype=wire_dtype),
        ]
        # The decoded shard a wire plan materialises at the landing edge.
        dec_extra = nbytes // g if wire_dtype != "raw" else 0
        if rest_axes:
            m = n_dev // g
            # Tiled gather over the replication axes: each position
            # receives the m-1 sibling blocks of its target shard.
            legs.append(
                RedistLeg(
                    "all_gather", rest_axes, n_dev * (m - 1) * block,
                    enc + block + enc // g + dec_extra + extra,
                    wire_dtype=wire_dtype,
                )
            )
        legs.append(
            RedistLeg("reshape", (), 0, enc + dst + dec_extra + extra)
        )
        peak = max(leg.peak_bytes for leg in legs)
        plan = DistributionPlan(
            mode="shard", shape=shape, dtype=dtype, split_dim=split_dim,
            split_axes=split_axes, rest_axes=rest_axes, ring_positions=ring,
            legs=tuple(legs), wire_bytes=wire_b + (
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
                      sharding: NamedSharding,
                      decode: Any = None) -> ShardedArray:
    """Each ring position's replica, decoded when the wire is encoded and
    reshaped to the window (a view of the raw replica), placed at its
    mesh position."""
    by_position = [None] * len(plan.ring_positions)
    for r, p in enumerate(plan.ring_positions):
        data = rep.shards[r].data
        if decode is not None:
            data = decode(data)
        by_position[p] = data.reshape(plan.shape)
    return ShardedArray(plan.shape, sharding, by_position)


def _finish_shard(ring_out: ShardedArray, plan: DistributionPlan,
                  sharding: NamedSharding,
                  decode: Any = None) -> ShardedArray:
    """Mesh position ``p`` (ring index ``r = s * m + q``: split block
    ``s``, replica ``q`` of ``m``) gathers the ring blocks ``s * m ..
    (s + 1) * m - 1`` in order, reshapes them to the window's other dims
    and moves the split axis back: one contiguous tensor per position, a
    view of its ring block when there is nothing to gather or move.  On
    an encoded wire the gathered rows are decoded first (the gather
    moves wire bytes, as in the reference)."""
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
        if decode is not None:
            rows_p = blocks[s * m:(s + 1) * m]
            enc = rows_p[0] if m == 1 else torch.cat(rows_p)
            lead = decode(enc).reshape((m * rows,) + other)
            by_position[p] = torch.movedim(lead, 0, split_dim).contiguous()
            continue
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
    - **Tier-wide latch** — any failure while distributing CPU tensors
      (the plain kernels), the ``ici.fanout`` fault site's injected leg
      failure included, latches the plain route for the distributor's
      life.  On the card any failure of a kernel, an encode, a decode or
      the fault site raises; the first window of each geometry
      synchronises inside :meth:`distribute`, so such a fault surfaces
      there.

    ``wire_dtype`` (None: ``DDL_TORCH_WIRE_DTYPE``, else raw) is the
    wire the ring carries.  Pass ``"raw"`` where the slot wire already
    encoded upstream: quantizing a decoded window again adds error.

    **Landing slots** (``n_slots``, default
    :data:`~ddl_tpu_torch.ops.ici_fanout.N_SLOTS`, 1 under
    ``DDL_TORCH_FUSED=0``): the plans price them, as the reference's
    do.  Each window's fan-out starts in the next slot
    (:func:`~ddl_tpu_torch.ops.ici_fanout.fanout_start`) and the finish
    waits on it on the device
    (:func:`~ddl_tpu_torch.ops.ici_fanout.fanout_wait`); with more than
    one slot each dispatch that succeeds cycles the slot and counts
    ``ici.fused_windows``.  The ``ici.slots_in_flight`` gauge counts the
    windows whose distribution has not completed on the device (at most
    ``n_slots``, high-water on ``.max``), over weak references, so
    tracking never keeps a window alive.
    """

    def __init__(
        self,
        sharding: NamedSharding,
        metrics: Optional[Metrics] = None,
        max_memory_factor: Optional[float] = None,
        n_chunks: Optional[int] = None,
        n_slots: Optional[int] = None,
        wire_dtype: Optional[str] = None,
    ):
        from ddl_tpu_torch.ops import ici_fanout

        self.wire_dtype = wire.resolve_wire_dtype(wire_dtype)
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
        self._slot = 0  # the next window's landing slot
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
                # The fan-out's dispatch span, keyed on the thread's
                # current window (the kernels run asynchronously).
                from ddl_tpu_torch.obs import spans as obs_spans

                span_t0 = obs_spans.t0()
                out = self.distribute(device_put(arr, anchor))
                obs_spans.record("ici.fanout", *obs_spans.current_window(),
                                 span_t0)
                return out
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

        fault_point("ici.fanout")
        m = self.metrics
        devices = self.sharding.mesh.device_list
        ring = [devices[p] for p in plan.ring_positions]
        t0 = time.perf_counter()
        flat = _to2d(block, 0 if plan.mode == "replicate" else plan.split_dim)
        t1 = time.perf_counter()
        decode = None
        if plan.wire_dtype != "raw":
            # Anchor-local encode; every position decodes its own rows.
            cols, dtype, wd = flat.shape[1], block.dtype, plan.wire_dtype
            flat = encode2d(flat, wd)

            def decode(w: torch.Tensor) -> torch.Tensor:
                return decode2d(w, cols, dtype, wd)
        slot = self._slot
        ticket = ici_fanout.fanout_start(plan.mode, flat, ring, slot=slot)
        t2 = time.perf_counter()
        m.add_time("ici.fanout", t2 - t1)
        # The finish consumes the landed blocks: its stream waits on the
        # kernel on the device.
        out = ici_fanout.fanout_wait(ticket)
        if plan.mode == "replicate":
            result = _finish_replicate(
                ici_fanout.replicated_view(out, ring), plan, self.sharding,
                decode)
        else:
            result = _finish_shard(out, plan, self.sharding, decode)
        m.add_time("ici.redistribute", (t1 - t0) + (time.perf_counter() - t2))
        key = (plan.shape, str(plan.dtype))
        if key not in self._validated:
            # First window of a geometry: wait for the kernel and the
            # finish, so a fault surfaces here, not at the consumer.
            if block.device.type == "cuda":
                torch.cuda.current_stream(block.device).synchronize()  # ddl-lint: disable=TDL020 - bring-up validation, once per geometry
            self._validated.add(key)
        # Cycle the landing slot only after a dispatch that succeeded: a
        # fault re-routes through the ladder without using up the slot.
        if plan.n_slots > 1:
            self._slot = (slot + 1) % plan.n_slots
            m.incr("ici.fused_windows")
        # Recorded behind the finish, which waited on the kernel.
        self._track_in_flight(result, done_event(block.device))
        m.incr("ici.bytes", float(plan.wire_bytes))
        if plan.wire_dtype != "raw":
            # What the ring moved per window beside the raw bytes it
            # delivered.
            m.incr("wire.encoded_bytes", float(plan.encoded_bytes))
            m.incr("wire.payload_bytes",
                   float(block.numel() * block.element_size()))
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
