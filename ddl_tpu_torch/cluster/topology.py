"""Topology model: inter-host link costs, declared or probed (port of
``ddl_tpu/cluster/topology.py``).

Cloud fabrics are not uniform — intra-rack links can run an order of
magnitude faster than cross-island ones (Cloud Collectives,
arXiv:2105.14088) — and reordering ranks onto the measured topology
recovers bandwidth without touching the transfer itself.  The window
transport (each loader host streams committed windows to a consumer
host) is such a rank-placement problem, so this module gives the
placement engine (:mod:`ddl_tpu_torch.cluster.placement`) its input: a
host→host bandwidth table, either **declared** (the operator knows the
racks) or **probed** (a pluggable pairwise transfer measured per link).

With no second host to probe against, the default probe transfer is a
host-local stand-in (a real memcpy of the payload, labelled by the
table's ``source``); deployments pass a ``transfer`` callable that moves
bytes over the real fabric.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ddl_tpu_torch.exceptions import DDLError

#: Effectively-infinite bandwidth stand-in for a host talking to itself
#: (loopback never crosses the fabric).
LOCAL_BYTES_PER_S = 1e15


class LinkCosts:
    """Symmetric host→host bandwidth table (bytes/s).

    ``bytes_per_s(a, b)`` is the modeled/measured bandwidth of the
    a→b link; unknown pairs fall back to ``default_bytes_per_s`` (the
    conservative cross-island floor), ``a == b`` to
    :data:`LOCAL_BYTES_PER_S`.
    """

    def __init__(
        self,
        bandwidth: Dict[Tuple[int, int], float],
        default_bytes_per_s: float = 1e9,
        source: str = "declared",
    ):
        # Bounded by construction: populated once here from the caller's
        # matrix (n_hosts^2 pairs), never grown afterwards.
        self._bw: Dict[Tuple[int, int], float] = {}  # ddl-lint: disable=DDL013 - filled once here, never grown
        for (a, b), v in bandwidth.items():
            if v <= 0:
                raise DDLError(f"non-positive bandwidth for link {(a, b)}")
            self._bw[self._key(a, b)] = float(v)
        self.default_bytes_per_s = float(default_bytes_per_s)
        #: Provenance label ("declared" / "probed") so a placement win
        #: can be traced to its cost input.
        self.source = source

    @staticmethod
    def _key(a: int, b: int) -> Tuple[int, int]:
        return (a, b) if a <= b else (b, a)

    def bytes_per_s(self, a: int, b: int) -> float:
        if a == b:
            return LOCAL_BYTES_PER_S
        return self._bw.get(self._key(a, b), self.default_bytes_per_s)

    def seconds(self, a: int, b: int, nbytes: int) -> float:
        return nbytes / self.bytes_per_s(a, b)

    def hosts(self) -> List[int]:
        out: set = set()
        for a, b in self._bw:
            out.add(a)
            out.add(b)
        return sorted(out)

    @property
    def n_links(self) -> int:
        return len(self._bw)

    @classmethod
    def islands(
        cls,
        groups: Iterable[Iterable[int]],
        intra_bytes_per_s: float,
        cross_bytes_per_s: float,
    ) -> "LinkCosts":
        """The canonical cloud shape: fast links within each island
        (rack / placement group), slow links across — the geometry
        Cloud Collectives measured.  Convenience for tests."""
        groups = [list(g) for g in groups]
        bw: Dict[Tuple[int, int], float] = {}
        flat = [h for g in groups for h in g]
        for gi, g in enumerate(groups):
            for a in g:
                for b in flat:
                    if a >= b:
                        continue
                    intra = any(a in gg and b in gg for gg in groups)
                    bw[(a, b)] = (
                        intra_bytes_per_s if intra else cross_bytes_per_s
                    )
        return cls(bw, default_bytes_per_s=cross_bytes_per_s)


def _memcpy_transfer(a: int, b: int, payload: np.ndarray) -> None:
    """Default probe transfer: a host-local memcpy of the payload — the
    honest stand-in when no cross-host fabric is reachable (it measures
    THIS host's memory bandwidth, clearly labeled by the probe's
    ``source``)."""
    np.copyto(np.empty_like(payload), payload)


def probe_link_costs(
    hosts: List[int],
    transfer: Optional[Callable[[int, int, np.ndarray], None]] = None,
    payload_bytes: int = 1 << 20,
    reps: int = 3,
    timeout_s: float = 30.0,
) -> LinkCosts:
    """Measure pairwise link bandwidth over ``transfer``.

    ``transfer(a, b, payload)`` moves ``payload`` from host ``a`` to
    host ``b`` once (a real deployment wires a cross-host send/recv
    pair here); best-of-
    ``reps`` wall time per pair becomes the link's bytes/s.  The probe
    is deadline-bounded: pairs not measured within ``timeout_s`` keep
    the default cost instead of stalling bootstrap (every cluster loop
    consults a deadline).
    """
    transfer = transfer or _memcpy_transfer
    payload = np.arange(
        max(1, payload_bytes // 4), dtype=np.float32
    )
    bw: Dict[Tuple[int, int], float] = {}
    deadline = time.monotonic() + timeout_s
    for i, a in enumerate(sorted(hosts)):
        for b in sorted(hosts)[i + 1:]:
            if time.monotonic() >= deadline:
                return LinkCosts(bw, source="probed-partial")
            best = 0.0
            for _ in range(max(1, reps)):
                t0 = time.perf_counter()
                transfer(a, b, payload)
                dt = time.perf_counter() - t0
                if dt > 0:
                    best = max(best, payload.nbytes / dt)
            if best > 0:
                bw[(a, b)] = best
    return LinkCosts(bw, source="probed")
