"""Device-side collectives over mesh positions (port of
``ddl_tpu/parallel/collectives.py``): the global shuffle of a dp-sharded
window and the quantized gradient reduction.

Every move of data between positions goes through :func:`ppermute`, the
port's ``lax.ppermute``: on positions of one card it is a device copy
into the receiving position's buffer (differentiable, so the ring
attention's K/V hand-off rides it inside autograd); positions over
distinct cards raise ``NotImplementedError`` (:func:`~ddl_tpu_torch.
parallel.mesh.one_card`) until peer writes replace the copy.

- :class:`DeviceGlobalShuffler`: one exchange round of a window held
  rows-sharded over the ``dp`` positions — lanes along the shared
  permutation (``sendrecv_replace``) or one uniform redistribution
  (``all_to_all``), the pools byte for byte the JAX package's.
- The quantized half (EQuARX wire format): int8 payloads with one fp32
  scale per ``block`` values along the last axis (:func:`block_scales`,
  :func:`quantize_blockwise` with deterministic or stochastic rounding,
  :func:`dequantize_blockwise`, :func:`quantized_bytes`) and the
  two-phase :func:`quantized_all_reduce` over positions (int8
  reduce-scatter, fp32 accumulation, re-quantized int8 all-gather).
  Deterministic payloads and scales equal the JAX package's byte for
  byte; stochastic rounding draws from a ``torch.Generator`` seeded per
  key (unbiased, deterministic per key, not JAX's random numbers).

Both halves are plain tensor work, as in the JAX package (XLA ops there,
no Pallas kernel).

- :func:`psum` — ``lax.psum`` over the positions of one axis: the sum of
  the per-position partials (the tp-resident pipeline stages complete
  ``wo`` and ``w_down`` with it), differentiable.

MULTIHOST (a gloo group the user's main initialised; only the outermost
``dp`` axis spans processes, :mod:`~ddl_tpu_torch.parallel.mesh`): a
:func:`ppermute` move between positions of two processes goes over gloo
``isend``/``irecv`` through page-locked host buffers (not
differentiable), so :class:`DeviceGlobalShuffler` lanes cross processes;
:func:`process_allgather` gathers a whole array where a check needs it,
and :func:`process_mean` sums the gradients and the loss once per step
in one host-staged bucket.  gloo moves host tensors only: every card
tensor is staged, never handed to gloo.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ddl_tpu_torch.parallel.mesh import (
    PROCESS_AXIS,
    NamedSharding,
    P,
    ShardedArray,
    _entry_axes,
    one_card,
    process_count,
    shard,
)
from ddl_tpu_torch.shuffle import (
    EXCHANGE_METHODS,
    exchange_permutation,
    exchange_slices,
    inverse_permutation,
)


def ppermute(sharded: ShardedArray, pairs: Sequence[Tuple[int, int]],
             axis: Optional[str] = None) -> ShardedArray:
    """``lax.ppermute`` over mesh positions: for each ``(src, dst)`` of
    ``pairs`` (indices along ``axis``, default the mesh's only axis), every
    position at index ``dst`` receives a copy of the shard of the position
    at index ``src`` with the same coordinates on the other axes; a
    position that receives nothing gets zeros.  The result keeps the
    input's sharding.  On one card each move is a device copy
    (``clone``), differentiable; positions over distinct cards raise
    ``NotImplementedError``."""
    mesh = sharded.sharding.mesh
    one_card(mesh.device_list)
    if axis is None:
        if len(mesh.axis_names) != 1:
            raise ValueError(f"ppermute over {mesh.axis_names} needs an axis")
        axis = mesh.axis_names[0]
    ax = mesh.axis_names.index(axis)
    n = mesh.shape[axis]
    dst_of = {}
    for src, dst in pairs:
        if not (0 <= src < n and 0 <= dst < n):
            raise ValueError(f"pair {(src, dst)} outside axis {axis!r} of {n}")
        if dst in dst_of.values():
            raise ValueError(f"index {dst} receives twice in {pairs}")
        dst_of[src] = dst
    pos = mesh.positions()
    mine = {s.position: s.data for s in sharded.shards}
    datas: Dict[int, Any] = {}
    remote: List[Tuple[int, int]] = []
    for coords in mesh.coords():
        src = coords[ax]
        if src in dst_of:
            to = coords[:ax] + (dst_of[src],) + coords[ax + 1:]
            a, b = int(pos[coords]), int(pos[to])
            if a in mine and b in mine:
                datas[b] = mine[a].clone()
            elif a in mine or b in mine:
                remote.append((a, b))
    if remote:
        datas.update(_move_across_processes(mesh, mine, remote))
    out = []
    for p, d in mine.items():
        out.append(datas[p] if p in datas else torch.zeros_like(d))
    return ShardedArray(sharded.shape, sharded.sharding, out)


def _host_buffer(like: torch.Tensor) -> torch.Tensor:
    """A host tensor shaped like ``like``, page-locked where a card is
    present (the staging of every gloo transfer)."""
    return torch.empty(like.shape, dtype=like.dtype,
                       pin_memory=torch.cuda.is_available())


def _move_across_processes(mesh: Any, mine: Dict[int, torch.Tensor],
                           moves: Sequence[Tuple[int, int]]
                           ) -> Dict[int, torch.Tensor]:
    """The moves of a :func:`ppermute` whose source or destination
    position belongs to another process: each local source is staged to
    a page-locked host buffer and sent with ``isend``, each local
    destination receives into one with ``irecv``; every transfer is
    posted before any is waited on, so the exchange cannot deadlock.
    The tag names the (source, destination) pair."""
    import torch.distributed as dist

    owner = mesh.processes.reshape(-1)
    like = next(iter(mine.values()))
    reqs, landed = [], {}
    for a, b in moves:
        tag = a * mesh.size + b
        if a in mine:
            host = _host_buffer(like)
            host.copy_(mine[a].detach())
            reqs.append(dist.isend(host, dst=int(owner[b]), tag=tag))
        else:
            host = _host_buffer(like)
            reqs.append(dist.irecv(host, src=int(owner[a]), tag=tag))
            landed[b] = host
    for r in reqs:
        r.wait()  # ddl-lint: disable=DDL012 - the process group's timeout bounds a gloo wait
    return {b: h.to(like.device) for b, h in landed.items()}


def psum(parts: Sequence[torch.Tensor], mesh: Any, axis: str) -> torch.Tensor:
    """``lax.psum`` over the positions of ``axis``: ``parts[i]`` is the
    partial of the position at index ``i`` along it, and the result is
    their sum — the value every position of the axis holds after the
    reduction (on one card one tensor serves them all).  Added in index
    order, differentiable (each partial's cotangent is the sum's).  A
    sum over an axis whose positions span processes is the distinct-card
    slice (ROADMAP.md A5c)."""
    n = mesh.shape[axis]
    if len(parts) != n:
        raise ValueError(f"{len(parts)} partials for the {n} positions of "
                         f"axis {axis!r}")
    if mesh.spans_processes and axis == mesh.axis_names[0]:
        raise NotImplementedError(
            f"psum over {axis!r}, whose positions span processes "
            "(ROADMAP.md A5c)")
    one_card([t.device for t in parts])
    out = parts[0]
    for t in parts[1:]:
        out = out + t
    return out


def process_allgather(x: Any, tiled: bool = False) -> torch.Tensor:
    """Every process's value, gathered on this process's device (the port
    of ``multihost_utils.process_allgather``): a :class:`ShardedArray`
    over a process-spanning mesh comes back whole (each process's block
    joined along the dim the ``dp`` axis splits); a tensor comes back
    stacked along a new leading axis, or joined along dim 0 with
    ``tiled=True``.  gloo moves host copies; without a group of several
    processes nothing moves."""
    if isinstance(x, ShardedArray):
        if not x.spans_processes:
            return x.assemble()
        local = x.assemble_local()
        entries = x.sharding._entries(len(x.shape))
        dims = [d for d, e in enumerate(entries) if PROCESS_AXIS in _entry_axes(e)]
        if not dims:  # replicated over dp: every process holds it whole
            return local
        return torch.cat(_gather_host(local), dim=dims[0]).to(local.device)
    if process_count() == 1:
        return x[None] if not tiled else x
    parts = _gather_host(x)
    out = torch.cat(parts, 0) if tiled else torch.stack(parts)
    return out.to(x.device)


def _gather_host(t: torch.Tensor) -> List[torch.Tensor]:
    import torch.distributed as dist

    host = t.detach().to("cpu").contiguous()
    parts = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, host)
    return parts


class _HostBucket:
    """One staging bucket: a flat host tensor, page-locked where a card is
    present by registering exactly its bytes (``ops/host_register.py``).
    ``pin_memory=True`` would go through the caching host allocator,
    which rounds a request up to a power of two and keeps a freed block:
    a 5.1 GB bucket would pin 8 GiB until the process ends."""

    def __init__(self, numel: int, dtype: torch.dtype):
        self.tensor = torch.empty(numel, dtype=dtype)
        self.page_locked = False
        if torch.cuda.is_available() and numel:
            from ddl_tpu_torch.ops import host_register

            host_register.page_lock(self, torch.cuda.current_device())

    def mapping(self) -> Tuple[int, int]:
        return (self.tensor.data_ptr(),
                self.tensor.numel() * self.tensor.element_size())

    def release(self) -> None:
        """Unregister the bytes, after every queued copy that may still
        read or write them."""
        if self.page_locked:
            from ddl_tpu_torch.ops import host_register

            torch.cuda.synchronize()
            host_register.page_unlock(self)


#: Page-locked staging buckets of the gloo legs, one per purpose
#: (:func:`host_bucket`): a full-width model's gradients are gigabytes,
#: pinned once, not every step.
_BUCKETS: Dict[str, _HostBucket] = {}


def host_bucket(name: str, numel: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The flat host bucket of ``numel`` elements kept for ``name``,
    page-locked where a card is present; a request of another size or
    dtype frees the old one first.  Its contents are whatever the last
    user left."""
    bucket = _BUCKETS.get(name)
    if (bucket is None or bucket.tensor.numel() != numel
            or bucket.tensor.dtype != dtype):
        if bucket is not None:
            _BUCKETS.pop(name).release()
        bucket = _BUCKETS[name] = _HostBucket(numel, dtype)
    return bucket.tensor


def release_host_buckets() -> None:
    """Free every staging bucket (:func:`host_bucket`): a process whose
    next steps stage otherwise gives the pinned memory back first."""
    while _BUCKETS:
        _BUCKETS.popitem()[1].release()


def process_mean(tensors: Sequence[Optional[torch.Tensor]],
                 like: Sequence[torch.Tensor], metrics: Any = None,
                 weight: Any = None) -> None:
    """Average ``tensors`` over the processes of the group, in place: each
    tensor is copied into its slice of ONE flat page-locked fp32 host
    bucket, the bucket goes through ONE gloo ``all_reduce`` (sum), and
    each slice comes back divided — one call a step, not one a leaf, and
    no device-sized staging copy.  A ``None`` entry (a leaf without a
    gradient) takes part as zeros shaped like its ``like`` entry and
    stays ``None``.

    Without ``weight`` the divisor is the world size (the mean of the
    processes' values).  With ``weight`` (this process's count, a scalar
    tensor or number) each tensor is scaled by it before the sum, the
    count rides the bucket's last element, and the sums are divided by
    the summed count (at least 1): the weighted mean, which for a masked
    sum over a count is the value over the processes' joined batches.
    ``metrics`` (a registry) records ``mh.allreduce`` (seconds, the
    staging included) and ``mh.allreduce_bytes``."""
    import torch.distributed as dist

    world = process_count()
    if world == 1:
        return
    t0 = time.perf_counter()
    dev = like[0].device
    if dev.type == "cuda":
        # The last call's copies out of the bucket may still be queued.
        torch.cuda.current_stream(dev).synchronize()
    total = sum(int(l.numel()) for l in like) + (weight is not None)
    host = host_bucket("mean", total)
    slices = stage_bucket(tensors, like, host, weight)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    dist.all_reduce(host)
    unstage_bucket(tensors, slices, host, world, weight is not None)
    if metrics is not None:
        metrics.add_time("mh.allreduce", time.perf_counter() - t0)
        metrics.incr("mh.allreduce_bytes", float(total * 4))


def stage_bucket(tensors: Sequence[Optional[torch.Tensor]],
                 like: Sequence[torch.Tensor], host: torch.Tensor,
                 weight: Any = None) -> List[torch.Tensor]:
    """:func:`process_mean`'s first half: copy ``tensors`` into their
    slices of the flat fp32 ``host`` bucket (``None`` as zeros), each
    scaled in place by ``weight`` first when given, which then rides the
    bucket's last element.  Returns the slices."""
    slices, off = [], 0
    for t, l in zip(tensors, like):
        piece = host[off:off + l.numel()].view(l.shape)
        if t is None:
            piece.zero_()
        else:
            if weight is not None:
                t.mul_(weight)  # in place: no device-sized temporary
            piece.copy_(t.detach(), non_blocking=True)
        slices.append(piece)
        off += l.numel()
    if weight is not None:
        host[-1:].copy_(torch.as_tensor(weight, dtype=torch.float32)
                        .reshape(1), non_blocking=True)
    return slices


def unstage_bucket(tensors: Sequence[Optional[torch.Tensor]],
                   slices: Sequence[torch.Tensor], host: torch.Tensor,
                   world: int, weighted: bool) -> None:
    """:func:`process_mean`'s second half, on the summed bucket: each
    tensor takes its slice divided by the summed weight (at least 1) when
    ``weighted``, else by ``world``."""
    divisor = max(float(host[-1]), 1.0) if weighted else world
    for t, piece in zip(tensors, slices):
        if t is not None:
            t.copy_(piece, non_blocking=True)
            t.div_(divisor)


def _pairs(p: np.ndarray) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(i), int(pi)) for i, pi in enumerate(p))


class DeviceGlobalShuffler:
    """Per-round device-side global shuffle over a dp-sharded window.

    The window is one array of (instances x window rows) held rows-sharded
    over ``axis`` (a :class:`ShardedArray` with spec ``P(axis)``); each
    round, :meth:`shuffle` exchanges its lanes along a fresh shared
    permutation (``sendrecv_replace``: the first lane to ``p[i]``, the
    second from ``p^-1[i]``, both through :func:`ppermute`) or
    redistributes the exchange block uniformly over all instances
    (``all_to_all``).  Rounds, seeds and lanes are the JAX package's, so
    the pools are byte for byte its own.
    """

    #: Fabric reach, as in the JAX package.
    span = "global"

    def __init__(self, mesh: Any, axis: str = "dp", num_exchange: int = 0,
                 method: str = "sendrecv_replace", seed: int = 0):
        if method not in EXCHANGE_METHODS:
            raise NotImplementedError(
                f"method {method!r}; valid: {EXCHANGE_METHODS}"
            )
        one_card(mesh.device_list)
        self.mesh = mesh
        self.axis = axis
        self.num_exchange = num_exchange
        self.method = method
        self.seed = seed
        self._round = 0

    @property
    def n_instances(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def exchange_round(self) -> int:
        """Completed exchange rounds (checkpoints read this)."""
        return self._round

    def rejoin(self, round_: int) -> None:
        """Re-enter the schedule at ``round_`` (checkpoint resume)."""
        self._round = int(round_)

    def shuffle(self, window: ShardedArray) -> ShardedArray:
        """One exchange round; returns the window with lanes exchanged."""
        n = self.n_instances
        if n <= 1 or self.num_exchange < 2:
            return window
        if tuple(window.sharding.spec)[:1] not in ((self.axis,), ((self.axis,),)):
            raise ValueError(f"the window must be rows-sharded P({self.axis!r}), "
                             f"got {window.sharding.spec}")
        if self.method == "all_to_all":
            out = self._all_to_all(window, n)
        else:
            out = self._sendrecv(window, n)
        self._round += 1
        return out

    def _sendrecv(self, window: ShardedArray, n: int) -> ShardedArray:
        p = exchange_permutation(n, self.seed, self._round)
        lane_a, lane_b = exchange_slices(self.num_exchange)
        sub = window.sharding

        def lane(sl: slice) -> ShardedArray:
            datas = [s.data[sl] for s in window.shards]
            return ShardedArray(_lane_shape(window, datas[0]), sub, datas)

        a = ppermute(lane(lane_a), _pairs(p), self.axis)
        b = ppermute(lane(lane_b), _pairs(inverse_permutation(p)), self.axis)
        return ShardedArray(window.shape, sub, [
            torch.cat([sa.data, sb.data, w.data[lane_b.stop:]], dim=0)
            for sa, sb, w in zip(a.shards, b.shards, window.shards)
        ])

    def _all_to_all(self, window: ShardedArray, n: int) -> ShardedArray:
        """Every instance scatters its exchange block uniformly to all
        instances and gathers one sub-block from each: instance j's block
        becomes ``[block_0[j], ..., block_{n-1}[j]]``, each sub-block moved
        by a :func:`ppermute` round (``i -> (i + r) mod n``)."""
        k = self.num_exchange - (self.num_exchange % n)
        sub = window.sharding
        mesh = self.mesh
        ax = mesh.axis_names.index(self.axis)
        coords = mesh.coords()
        rows = k // n
        # received[j][i]: the sub-block local shard j gathered from index i.
        received = [[None] * n for _ in window.shards]
        for r in range(n):
            # Each position sends sub-block (i + r) mod n to index i + r.
            datas = []
            for s in window.shards:
                b = (coords[s.position][ax] + r) % n
                datas.append(s.data[b * rows:(b + 1) * rows])
            moved = ppermute(
                ShardedArray(_lane_shape(window, datas[0]), sub, datas),
                [(i, (i + r) % n) for i in range(n)], self.axis)
            for j, s in enumerate(moved.shards):
                received[j][(coords[s.position][ax] - r) % n] = s.data
        return ShardedArray(window.shape, sub, [
            torch.cat(received[j] + [s.data[k:]], dim=0)
            for j, s in enumerate(window.shards)
        ])

    def window_hook(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """Adapter for ``Trainer.fit(window_stream=True, window_hook=)``.

        The trainer hands each window ``(batches_per_window, batch,
        *features)`` as one tensor on the card; the hook flattens it to
        sample rows (batch-major, so contiguous dp blocks stay
        contiguous), cuts the rows over the ``axis`` positions, exchanges
        and restores the window layout.  The hook carries its owner
        (``hook.owner``) so the trainer can checkpoint the round counter.
        """
        row_sh = NamedSharding(self.mesh, P(self.axis))

        def hook(win: torch.Tensor) -> torch.Tensor:
            bpw, batch = win.shape[0], win.shape[1]
            feat = tuple(win.shape[2:])
            rows = win.transpose(0, 1).reshape(batch * bpw, -1)
            mixed = self.shuffle(shard(rows, row_sh)).assemble()
            return mixed.reshape((batch, bpw) + feat).transpose(0, 1).contiguous()

        hook.owner = self
        return hook


def _lane_shape(window: ShardedArray, local: torch.Tensor) -> Tuple[int, ...]:
    """The global shape of a lane array: ``local``'s rows on every
    position along the split dim."""
    g = window.shape[0] // window.shards[0].data.shape[0]
    return (local.shape[0] * g,) + tuple(local.shape[1:])


# -- quantized gradient communication (EQuARX wire format) -------------------
#
# Blockwise int8: one fp32 scale per ``block`` consecutive values along
# the LAST axis (leading axes untouched, so a leaf's placement survives
# quantization).  ``q`` keeps the input's shape (int8), ``scales`` is
# ``x.shape[:-1] + (ceil(last/block),)`` fp32.

#: Default quantization granularity (values per fp32 scale).
QUANT_BLOCK = 256


def block_scales(x: torch.Tensor, block: int = QUANT_BLOCK) -> torch.Tensor:
    """Per-block fp32 scales: ``max(|x|)/127`` over each ``block``-wide
    slice of the last axis (zero blocks get scale 1 so dequantize is
    exact there).  The division takes a tensor divisor: a division by a
    Python scalar may run as a reciprocal product on the card."""
    lead, last = tuple(x.shape[:-1]), x.shape[-1]
    pad = (-last) % block
    xf = x.float().abs()
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    m = xf.reshape(*lead, -1, block).amax(dim=-1)
    s = m / torch.full_like(m, 127.0)
    return torch.where(s == 0.0, torch.ones_like(s), s)


def _expand_scales(s: torch.Tensor, last: int, block: int) -> torch.Tensor:
    return s.repeat_interleave(block, dim=-1)[..., :last]


def key_generator(key: Any, device: Any) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``key`` (an int,
    or a tuple of ints folded in order): the port's stochastic-rounding
    key.  The same key draws the same numbers on the same device type."""
    seed = 0
    for part in (key if isinstance(key, (tuple, list)) else (key,)):
        seed = (seed * 0x9E3779B1 + (int(part) & 0xFFFFFFFF) + 1) % (2 ** 63)
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def stochastic_noise(shape: Sequence[int], key: Any, device: Any) -> torch.Tensor:
    """The ``U[0, 1)`` draws of :func:`quantize_blockwise`'s stochastic
    rounding for an array of ``shape`` under ``key``: a slice of an array
    rounds with the same slice of these (what a process holding one
    shard of a leaf needs to round it as the whole leaf)."""
    return torch.rand(tuple(shape), generator=key_generator(key, device),
                      device=device, dtype=torch.float32)


def quantize_blockwise(x: torch.Tensor, block: int = QUANT_BLOCK,
                       stochastic: bool = False, key: Any = None,
                       noise: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x -> (q int8, scales fp32)`` with per-block scales.

    Deterministic: round half to even (``jnp.round``'s rule), clip to
    +-127 — the JAX package's bytes.  ``stochastic=True`` rounds
    ``floor(v + u)``, ``u ~ U[0, 1)`` drawn from :func:`key_generator`
    (``key`` an int or a tuple of ints): unbiased in expectation, the
    same bytes for the same key.  ``noise`` (shaped like ``x``) gives the
    draws instead of ``key``: a slice of :func:`stochastic_noise`'s for
    the array ``x`` was cut from."""
    if stochastic and key is None and noise is None:
        raise ValueError("stochastic rounding requires an explicit key")
    s = block_scales(x, block)
    v = x.float() / _expand_scales(s, x.shape[-1], block)
    if stochastic:
        u = noise if noise is not None else stochastic_noise(x.shape, key,
                                                             x.device)
        v = torch.floor(v + u)
    else:
        v = torch.round(v)
    q = torch.clamp(v, -127.0, 127.0).to(torch.int8)
    return q, s


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor, dtype: Any,
                         block: int = QUANT_BLOCK) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise` (up to rounding error)."""
    out = q.float() * _expand_scales(scales, q.shape[-1], block)
    return out.to(dtype)


def quantize_dequantize(x: torch.Tensor, block: int = QUANT_BLOCK,
                        stochastic: bool = False, key: Any = None,
                        ) -> torch.Tensor:
    """Round-trip through the int8 wire format — the numerical effect a
    quantized collective applies to the values it moves."""
    q, s = quantize_blockwise(x, block, stochastic=stochastic, key=key)
    return dequantize_blockwise(q, s, x.dtype, block)


def quantized_bytes(shape: Sequence[int], block: int = QUANT_BLOCK) -> int:
    """Wire bytes of one quantized array: int8 payload + fp32 scales."""
    shape = tuple(shape)
    size = int(np.prod(shape)) if shape else 1
    last = int(shape[-1]) if shape else 1
    nblocks = -(-last // block)
    lead = size // max(last, 1)
    return size + 4 * lead * nblocks


def quantized_all_reduce(xs: Sequence[torch.Tensor], block: int = QUANT_BLOCK,
                         mean: bool = True, stochastic: bool = False,
                         key: Any = None) -> List[torch.Tensor]:
    """Two-phase quantized all-reduce over the positions of one axis.

    ``xs`` holds each position's contribution (equal shapes, positions of
    one device); every position gets the reduced value back.  Each
    contribution splits into ``n`` chunks and quantizes; position i
    gathers every peer's int8 chunk i (the reduce-scatter), accumulates
    it in fp32, re-quantizes, and the int8 chunks are gathered back by
    every position (the all-gather) — the JAX package's two phases,
    so the error model (quantize -> sum -> re-quantize) is its own.
    ``mean=True`` divides by ``n``.  ``stochastic=True`` + ``key``:
    stochastic rounding on both phases (each phase and position folds its
    own index into the key)."""
    n = len(xs)
    if n < 1:
        raise ValueError(f"axis_size must be >= 1, got {n}")
    one_card([x.device for x in xs])
    shape, dtype = tuple(xs[0].shape), xs[0].dtype
    size = int(np.prod(shape)) if shape else 1
    pad = (-size) % (n * block)

    def chunks(x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(size)
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        return flat.reshape(n, -1)  # chunk i -> position i

    def phase_key(phase: int, pos: int) -> Any:
        if not stochastic:
            return None
        parts = tuple(key) if isinstance(key, (tuple, list)) else (key,)
        return parts + (phase, pos)

    sent = [quantize_blockwise(chunks(x), block, stochastic, phase_key(0, p))
            for p, x in enumerate(xs)]
    # The reduce-scatter: position i receives every peer's chunk i.
    reduced = []
    for i in range(n):
        q = torch.stack([sent[p][0][i] for p in range(n)])
        s = torch.stack([sent[p][1][i] for p in range(n)])
        red = (q.float() * _expand_scales(s, q.shape[-1], block)).sum(0)
        if mean:
            red = red / torch.full_like(red, float(n))
        reduced.append(quantize_blockwise(red[None], block, stochastic,
                                          phase_key(1, i)))
    # The all-gather: every position receives every chunk.
    q2 = torch.cat([q for q, _ in reduced])
    s2 = torch.cat([s for _, s in reduced])
    out = (q2.float() * _expand_scales(s2, q2.shape[-1], block))
    full = out.reshape(-1)[:size].reshape(shape).to(dtype)
    return [full.clone() for _ in range(n)]
