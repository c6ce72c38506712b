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
  global shape), like ``jax.Array.addressable_shards``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """Named mesh axes over an array of devices (positions may share a
    device)."""

    def __init__(self, devices: Any, axis_names: Sequence[str]):
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

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.device_list]})"


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """Build a :class:`Mesh` with named axes whose sizes multiply to the
    number of positions.

    ``axes=None`` → a 1-axis ``dp`` mesh.  An axis size of ``-1`` is
    inferred (like a reshape).  ``devices=None`` → every visible card
    (raises without CUDA); pass e.g. ``["cuda:0"] * 4`` for four
    positions on one card, or ``["cpu"] * 8`` on the host.
    """
    if devices is None:
        from ddl_tpu_torch.utils import resolve_device

        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
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
    return Mesh(arr.reshape(sizes), names)


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
    ``jax.Array``.
    """

    def __init__(self, shape: Sequence[int], sharding: NamedSharding,
                 datas: Sequence[torch.Tensor]):
        self.shape = tuple(int(s) for s in shape)
        self.sharding = sharding
        indices = sharding.shard_indices(self.shape)
        if len(datas) != len(indices):
            raise ValueError(f"{len(datas)} shards for {len(indices)} positions")
        devices = sharding.mesh.device_list
        want = _index_shape(indices[0], self.shape)
        shards = []
        for p, (idx, data) in enumerate(zip(indices, datas)):
            if tuple(data.shape) != want:
                raise ValueError(f"position {p}'s shard is {tuple(data.shape)}, "
                                 f"the sharding gives {want}")
            shards.append(Shard(p, devices[p], idx, data))
        self.shards: Tuple[Shard, ...] = tuple(shards)
        self.dtype = datas[0].dtype

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * self.shards[0].data.element_size()

    def tensor(self) -> torch.Tensor:
        """The global array, assembled on the host."""
        out = torch.empty(self.shape, dtype=self.dtype)
        for s in self.shards:
            out[s.index] = s.data.detach().cpu()
        return out

    def numpy(self) -> np.ndarray:
        return self.tensor().numpy()


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
