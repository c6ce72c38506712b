"""Device meshes and sharded arrays (port of ``ddl_tpu/parallel/mesh.py``
plus the port's own small counterparts of ``jax.sharding``).

- :class:`Mesh` — named axes over an array of torch devices.  A device
  may repeat: ``Mesh(["cuda:0"] * 4, ("dp",))`` is four mesh *positions*
  on one card, the one-card layout of the ICI ingest tier.  Everything
  is keyed by mesh position (the flat C-order index into
  ``mesh.devices``), never by device.
- :class:`PartitionSpec` (``P``) and :class:`NamedSharding` — which
  array dims are split over which mesh axes, with ``jax.sharding``'s
  meaning: a dim named by axes ``(a, b)`` is cut into ``size(a) *
  size(b)`` blocks, ``a`` the major index.
- :class:`ShardedArray` — the result of a sharded transfer: one tensor
  per mesh position with its device and its index (slices into the
  global shape), like ``jax.Array.addressable_shards``.  :func:`shard`
  cuts a tensor into differentiable per-position views and
  :meth:`ShardedArray.assemble` puts them back together: the port's
  ``shard_map`` boundary, where per-position work begins and ends.
- :func:`named` / :func:`prune_indivisible` (the reference's ``_named``
  and ``_prune_indivisible``, ``ddl_tpu/parallel/train.py``): one spec
  tree for every mesh — axes the mesh lacks drop out, and an axis that
  does not divide a dimension leaves it unsharded.

Meshes take any axis names: ``dp``, ``fsdp``, ``tp``, ``sp``, the
pipeline axis ``pp`` (:mod:`ddl_tpu_torch.parallel.pipeline`) and the
expert axis ``ep`` (:mod:`ddl_tpu_torch.models.moe`: on one card the
expert stacks stay whole tensors, and ``ep`` in their specs places only
the sharded optimizer's state).

MULTIHOST (``torch.distributed`` processes, a gloo group the user's main
initialised): :func:`make_mesh` lays out ``world_size x local``
positions in process-major order, as ``jax.devices()`` orders them, and
each position records the process that owns it (``Mesh.processes``).
Only the outermost ``dp`` axis may span processes; a mesh whose ``sp``,
``pp``, ``tp`` or ``fsdp`` positions span processes raises
``NotImplementedError`` (distinct cards and peer writes, ROADMAP.md
A5c).  A :class:`ShardedArray` over a process-spanning mesh holds only
this process's shards, like ``addressable_shards``; the model runs on
:meth:`Mesh.local` over :meth:`ShardedArray.assemble_local`, and a whole
array comes back through ``collectives.process_allgather``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: The one axis that may span processes (the outermost, as in every
#: multihost mesh of the JAX package).
PROCESS_AXIS = "dp"


def process_rank() -> int:
    """This process's rank in the initialised ``torch.distributed`` group
    (0 without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_count() -> int:
    """The initialised group's world size (1 without one: no quiet
    reduction, as ``jax.process_count()`` reads 1 without
    ``jax.distributed``)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class Mesh:
    """Named mesh axes over an array of devices (positions may share a
    device)."""

    def __init__(self, devices: Any, axis_names: Sequence[str],
                 processes: Any = None):
        grid = np.asarray(devices, dtype=object)
        arr = np.empty(grid.size, dtype=object)
        arr[:] = [torch.device(d) for d in grid.reshape(-1)]
        self.devices = arr.reshape(grid.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(
                f"{len(self.axis_names)} axis names for a "
                f"{self.devices.ndim}-d device array"
            )
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")
        #: Each position's owning process (its rank); a mesh built
        #: without ``processes`` belongs to this process alone.
        self.processes = (
            np.full(self.devices.shape, process_rank(), dtype=np.int64)
            if processes is None
            else np.asarray(processes, dtype=np.int64).reshape(self.devices.shape)
        )
        self.process_index = process_rank()
        if self.spans_processes:
            self._check_process_layout()

    @property
    def spans_processes(self) -> bool:
        """Do this mesh's positions belong to more than one process?"""
        return len(np.unique(self.processes)) > 1

    def _check_process_layout(self) -> None:
        for i, name in enumerate(self.axis_names):
            first = np.take(self.processes, [0], axis=i)
            if i == 0 and name == PROCESS_AXIS:
                continue
            if not np.all(self.processes == first):
                raise NotImplementedError(
                    f"mesh axis {name!r} spans processes: only the "
                    f"outermost {PROCESS_AXIS!r} axis may (positions of "
                    "distinct processes on the inner axes need peer "
                    "writes over distinct cards, ROADMAP.md A5c)"
                )
        if self.process_index not in set(self.processes.reshape(-1).tolist()):
            raise ValueError(f"process {self.process_index} owns no position "
                             f"of this mesh")

    def local_positions(self) -> List[int]:
        """The positions this process owns, in position order."""
        return [int(p) for p in np.flatnonzero(
            self.processes.reshape(-1) == self.process_index)]

    def local(self) -> "Mesh":
        """The mesh over this process's positions alone (the outermost
        ``dp`` axis cut to this process's extent): what the model runs
        on over this process's rows.  A mesh of one process is its own
        local mesh."""
        if not self.spans_processes:
            return self
        # Only the outermost axis spans processes: pick its indices.
        owner = self.processes.reshape(self.devices.shape[0], -1)[:, 0]
        rows = np.flatnonzero(owner == self.process_index)
        return Mesh(self.devices[rows], self.axis_names,
                    processes=self.processes[rows])

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> List[torch.device]:
        """Each position's device, in position order."""
        return list(self.devices.reshape(-1))

    def positions(self) -> np.ndarray:
        """The position grid: ``positions()[coords]`` is the position at
        those mesh coordinates."""
        return np.arange(self.size).reshape(self.devices.shape)

    def coords(self) -> List[Tuple[int, ...]]:
        """Each position's mesh coordinates, in position order."""
        return list(np.ndindex(*self.devices.shape))

    def sub_mesh(self, axes: Sequence[Optional[str]]) -> "Mesh":
        """The mesh over ``axes`` alone (``None`` entries ignored): the
        positions that share this process's first position's coordinates
        on every other axis (coordinate 0 on a mesh of one process).
        Work that the other axes only replicate runs once, on these
        positions."""
        keep = [a for a in axes if a is not None]
        # Anchor the other axes at this process's first position: on a
        # process-spanning mesh that keeps an inner-axis sub-mesh local.
        anchor = self.coords()[self.local_positions()[0]]
        index = tuple(slice(None) if a in keep else anchor[i]
                      for i, a in enumerate(self.axis_names))
        return Mesh(self.devices[index],
                    tuple(a for a in self.axis_names if a in keep),
                    processes=self.processes[index])

    def __repr__(self) -> str:
        extra = (f", processes={self.processes.reshape(-1).tolist()}"
                 if self.spans_processes else "")
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.device_list]}{extra})")


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """Build a :class:`Mesh` with named axes whose sizes multiply to the
    number of positions.

    ``axes=None`` → a 1-axis ``dp`` mesh.  An axis size of ``-1`` is
    inferred (like a reshape).  ``devices=None`` → every visible card
    (raises without CUDA); pass e.g. ``["cuda:0"] * 4`` for four
    positions on one card, or ``["cpu"] * 8`` on the host.

    Under an initialised ``torch.distributed`` group of ``w > 1``
    processes, ``devices`` are this process's positions and the mesh
    holds ``w`` times as many, process-major (every process passes the
    same count): the global mesh of a MULTIHOST run.
    """
    if devices is None:
        from ddl_tpu_torch.utils import resolve_device

        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    world = process_count()
    procs = np.repeat(np.arange(world), len(devices))
    devices = devices * world
    n = len(devices)
    if axes is None:
        axes = {"dp": n}
    names = tuple(axes.keys())
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    known = int(np.prod([s for s in sizes if s != -1]))
    if -1 in sizes:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(
            f"mesh axes {dict(zip(names, sizes))} need {int(np.prod(sizes))} "
            f"devices, have {n}"
        )
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(sizes), names, processes=procs.reshape(sizes))


def data_parallel_mesh(n: Optional[int] = None,
                       devices: Optional[Sequence[Any]] = None) -> Mesh:
    """1-axis ``dp`` mesh over the first n (default: all) devices."""
    if devices is None:
        devices = make_mesh().device_list
    devices = list(devices)[: n or None]
    return make_mesh({"dp": len(devices)}, devices)


class PartitionSpec(tuple):
    """Per array dim: ``None`` (not split), a mesh axis name, or a tuple
    of axis names (split over their product, the first the major)."""

    def __new__(cls, *entries: Any) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _entry_axes(entry: Any) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A :class:`PartitionSpec` over a :class:`Mesh`."""

    def __init__(self, mesh: Mesh, spec: Any):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)
        used = [a for e in self.spec for a in _entry_axes(e)]
        for a in used:
            if a not in mesh.axis_names:
                raise ValueError(f"spec {self.spec} names axis {a!r}, not in "
                                 f"the mesh's {mesh.axis_names}")
        if len(set(used)) != len(used):
            raise ValueError(f"spec {self.spec} uses a mesh axis twice")

    def _entries(self, ndim: int) -> Tuple[Any, ...]:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"array's {ndim} dims")
        return tuple(self.spec) + (None,) * (ndim - len(self.spec))

    def shard_indices(self, shape: Sequence[int]) -> List[Tuple[slice, ...]]:
        """Each position's index into an array of global ``shape``, in
        position order: ``slice(None)`` on a dim that is not split, the
        position's block on one that is (ValueError if not divisible)."""
        shape = tuple(int(s) for s in shape)
        sizes = self.mesh.shape
        names = self.mesh.axis_names
        dims = []
        for d, entry in enumerate(self._entries(len(shape))):
            axes = _entry_axes(entry)
            g = int(np.prod([sizes[a] for a in axes])) if axes else 1
            if shape[d] % g:
                raise ValueError(
                    f"dim {d} of shape {shape} ({shape[d]}) is not divisible "
                    f"by the {g} shards of {entry!r}"
                )
            dims.append((axes, shape[d] // g))
        out = []
        for coords in np.ndindex(*self.mesh.devices.shape):
            index = []
            for axes, blk in dims:
                if not axes:
                    index.append(slice(None))
                    continue
                k = 0
                for a in axes:
                    k = k * sizes[a] + coords[names.index(a)]
                index.append(slice(k * blk, (k + 1) * blk))
            out.append(tuple(index))
        return out

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape every position's shard has."""
        return _index_shape(self.shard_indices(shape)[0], shape)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _index_shape(index: Tuple[slice, ...], shape: Sequence[int]) -> Tuple[int, ...]:
    return tuple(len(range(*s.indices(n))) for s, n in zip(index, shape))


@dataclasses.dataclass(frozen=True)
class Shard:
    """One mesh position's piece of a :class:`ShardedArray`."""

    position: int
    device: torch.device
    index: Tuple[slice, ...]
    data: torch.Tensor


class ShardedArray:
    """A global array held as one tensor per mesh position.

    ``shards`` are in position order; ``shards[p].data`` covers
    ``global[shards[p].index]``.  :meth:`numpy` / :meth:`tensor`
    assemble the global array on the host, as ``np.asarray`` does for a
    ``jax.Array``.  Over a mesh that spans processes, ``datas`` and
    ``shards`` are this process's positions only (``addressable_shards``):
    the whole array is then :func:`~ddl_tpu_torch.parallel.collectives.
    process_allgather`'s, and :meth:`assemble_local` gives this process's
    block.
    """

    def __init__(self, shape: Sequence[int], sharding: NamedSharding,
                 datas: Sequence[torch.Tensor]):
        self.shape = tuple(int(s) for s in shape)
        self.sharding = sharding
        mesh = sharding.mesh
        indices = sharding.shard_indices(self.shape)
        positions = (mesh.local_positions() if mesh.spans_processes
                     else list(range(len(indices))))
        if len(datas) != len(positions):
            raise ValueError(f"{len(datas)} shards for {len(positions)} positions")
        devices = mesh.device_list
        want = _index_shape(indices[0], self.shape)
        shards = []
        for p, data in zip(positions, datas):
            if tuple(data.shape) != want:
                raise ValueError(f"position {p}'s shard is {tuple(data.shape)}, "
                                 f"the sharding gives {want}")
            shards.append(Shard(p, devices[p], indices[p], data))
        self.shards: Tuple[Shard, ...] = tuple(shards)
        self.dtype = datas[0].dtype

    @property
    def spans_processes(self) -> bool:
        return self.sharding.mesh.spans_processes

    def _whole(self, what: str) -> None:
        if self.spans_processes:
            raise ValueError(
                f"{what} of an array over a process-spanning mesh: this "
                "process holds only its own shards; gather the whole "
                "array with collectives.process_allgather, or take this "
                "process's block with assemble_local()"
            )

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * self.shards[0].data.element_size()

    def tensor(self) -> torch.Tensor:
        """The global array, assembled on the host."""
        self._whole("tensor()")
        out = torch.empty(self.shape, dtype=self.dtype)
        for s in self.shards:
            out[s.index] = s.data.detach().cpu()
        return out

    def numpy(self) -> np.ndarray:
        return self.tensor().numpy()

    def assemble(self) -> torch.Tensor:
        """The global array on the shards' device, differentiable: the
        first position holding each block gives it, the blocks joined
        with ``torch.cat`` (positions that only replicate a block add
        nothing).  Raises over a process-spanning mesh."""
        self._whole("assemble()")
        return self.assemble_local()

    def assemble_local(self) -> torch.Tensor:
        """The block of the global array this process's shards cover,
        assembled on their device (differentiable); over a mesh of one
        process, the global array."""
        blocks: Dict[Tuple[int, ...], torch.Tensor] = {}
        for s in self.shards:
            blocks.setdefault(tuple(sl.start or 0 for sl in s.index), s.data)
        starts = [sorted({k[d] for k in blocks}) for d in range(len(self.shape))]

        def build(prefix: Tuple[int, ...], d: int) -> torch.Tensor:
            if d == len(self.shape):
                return blocks[prefix]
            parts = [build(prefix + (st,), d + 1) for st in starts[d]]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)

        return build((), 0)


def shard(t: torch.Tensor, sharding: NamedSharding) -> ShardedArray:
    """``t`` cut into one view a mesh position, differentiable (the
    port's entry into ``shard_map``).  Every position must live on
    ``t``'s device: a mesh over distinct cards raises
    ``NotImplementedError`` (:func:`one_card`)."""
    dev = one_card(sharding.mesh.device_list)
    if t.device != dev:
        raise ValueError(f"a tensor on {t.device} cut over positions of {dev}")
    if sharding.mesh.spans_processes:
        raise ValueError("shard() cuts a global tensor; over a process-"
                         "spanning mesh each process lands its own block "
                         "(ingest.make_global_array)")
    return ShardedArray(t.shape, sharding, [
        t[index] for index in sharding.shard_indices(t.shape)])


# -- spec trees (the reference's _named / _prune_indivisible) ----------------


def is_spec_leaf(x: Any) -> bool:
    """A leaf of a spec tree: a :class:`PartitionSpec` or ``None``."""
    return x is None or isinstance(x, PartitionSpec)


def map_specs(fn: Callable[..., Any], spec_tree: Any, *trees: Any) -> Any:
    """Map ``fn(spec, *leaves)`` over a nested dict/list spec tree and
    trees of the same structure (a :class:`PartitionSpec` is a tuple but
    a leaf here)."""
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)) and not is_spec_leaf(spec_tree):
        return [map_specs(fn, v, *(t[i] for t in trees))
                for i, v in enumerate(spec_tree)]
    return fn(spec_tree, *trees)


def named(mesh: Mesh, spec_tree: Any) -> Any:
    """Map a PartitionSpec tree to NamedShardings, dropping axes the mesh
    doesn't have (so one spec tree serves dp-only and dp x fsdp x tp
    meshes); a ``None`` leaf is replicated."""

    def fix(spec: Any) -> NamedSharding:
        parts = []
        for entry in (spec or ()):
            if entry is None:
                parts.append(None)
            elif isinstance(entry, (tuple, list)):
                kept = tuple(a for a in entry if a in mesh.axis_names)
                parts.append(kept if kept else None)
            else:
                parts.append(entry if entry in mesh.axis_names else None)
        return NamedSharding(mesh, P(*parts))

    return map_specs(fix, spec_tree)


def prune_indivisible(sh: NamedSharding, x: Any) -> NamedSharding:
    """Drop spec axes whose mesh size doesn't divide the array dimension:
    the leaf degrades to replicated on that dimension (logged) instead of
    failing.  An axis of size 1 drops too."""
    mesh = sh.mesh
    shape = tuple(x.shape) if hasattr(x, "shape") else tuple(np.shape(x))
    if len(tuple(sh.spec)) > len(shape):
        raise ValueError(
            f"param spec {sh.spec} has more entries than array rank "
            f"{len(shape)} (shape {shape})"
        )
    parts = []
    for dim_size, entry in zip(shape, tuple(sh.spec) + (None,) * len(shape)):
        axes = _entry_axes(entry)
        n = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
        keep = n > 1 and dim_size % n == 0
        if axes and n > 1 and not keep:
            logger.warning(
                "param spec axis %r (size %d) does not divide dim %d of "
                "shape %s — that dimension degrades to REPLICATED (memory "
                "cost: full copy per device group)",
                entry, n, dim_size, shape,
            )
        parts.append(entry if keep else None)
    return NamedSharding(mesh, P(*parts))


def one_card(devices: Sequence[Any]) -> torch.device:
    """The one device every position in ``devices`` (a mesh's, a ring's)
    lives on.  Positions spread over several distinct cards are the
    multi-card slice (peer-mapped pointers and flag semaphores) and
    raise; positions mixing the CPU and a card are an error."""
    devs = {torch.device(d) for d in devices}
    if any(d.type == "cuda" and d.index is None for d in devs):
        cur = torch.cuda.current_device() if torch.cuda.is_available() else 0
        devs = {torch.device("cuda", cur) if d.type == "cuda" and d.index is None
                else d for d in devs}
    if len(devs) > 1:
        if all(d.type == "cuda" for d in devs):
            raise NotImplementedError(
                "positions over several distinct cards are the multi-card "
                "slice (peer-mapped pointers with flag semaphores); pass "
                "devices=[cuda:k] * n for n positions on one card"
            )
        raise ValueError(f"positions mix device types: {sorted(map(str, devs))}")
    if not devs:
        raise ValueError("a ring or mesh needs at least one position")
    return devs.pop()
