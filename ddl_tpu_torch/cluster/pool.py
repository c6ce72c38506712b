"""Loader-pool seam: loader ranks as a resizable pool (port of
``ddl_tpu/cluster/pool.py``).

A loader's rank set is fixed at handshake and, without a pool, the
consumer rotates over all of it forever.  :class:`LoaderPool` is the
value a cluster view publishes instead: an immutable, generation-stamped
set of ring targets that grows and shrinks independently of the trainer
ranks.  ``DistributedDataLoader.apply_pool`` consumes it (rotation
restricted to members, stale generations ignored);
:meth:`ClusterView.loader_pool` mints it (generation == view epoch, so
the membership fence and the pool fence are the same number).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

from ddl_tpu_torch.exceptions import DDLError


@dataclasses.dataclass(frozen=True)
class LoaderPool:
    """An immutable set of active loader ring targets (0-based).

    ``generation`` is the epoch fence: appliers must ignore a pool whose
    generation is <= the last one they applied (a slow message from
    view N must never undo view N+1).
    """

    members: Tuple[int, ...]
    generation: int = 0

    def __post_init__(self) -> None:
        members = tuple(sorted(set(int(m) for m in self.members)))
        if any(m < 0 for m in members):
            raise DDLError(f"negative ring target in pool: {members}")
        object.__setattr__(self, "members", members)

    def __contains__(self, target: int) -> bool:
        return target in self.members

    def __len__(self) -> int:
        return len(self.members)

    def without(self, targets: Iterable[int]) -> "LoaderPool":
        gone = set(targets)
        return LoaderPool(
            members=tuple(m for m in self.members if m not in gone),
            generation=self.generation + 1,
        )

    def union(self, targets: Iterable[int]) -> "LoaderPool":
        return LoaderPool(
            members=tuple(set(self.members) | set(targets)),
            generation=self.generation + 1,
        )

    def next_member(self, after: int, include: bool = False) -> int:
        """The next pool member in cyclic target order strictly after
        ``after`` (or ``after`` itself when ``include`` and it is a
        member) — the rotation primitive the loader uses."""
        if not self.members:
            raise DDLError("loader pool is empty")
        if include and after in self.members:
            return after
        for m in self.members:
            if m > after:
                return m
        return self.members[0]
