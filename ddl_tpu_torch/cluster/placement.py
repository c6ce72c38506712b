"""Placement engine: producer→consumer assignment over measured links
(port of ``ddl_tpu/cluster/placement.py``).

Every loader (producer) host streams its committed windows to one
consumer host, and on a non-uniform fabric (see
:mod:`ddl_tpu_torch.cluster.topology`) which consumer it streams to
decides whether the transport rides an intra-island link or crawls
across islands.  :func:`plan_placement` reorders the loader tier onto
the measured topology.

Guarantees:

- **Balanced**: every consumer host receives ``ceil(P/C)`` producers at
  most (the ingest fan-in the trainer was provisioned for).
- **Never slower**: the naive (rank-order round-robin) assignment is
  always a candidate — when the greedy reorder does not beat it under
  the cost model, the naive assignment is returned with
  ``reordered=False``.
- **Deterministic**: ties break on sorted host ids, so every process
  planning from the same (view, costs) pair gets the same assignment —
  the no-coordination property the membership layer has.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ddl_tpu_torch.cluster.membership import ClusterView
from ddl_tpu_torch.cluster.topology import LinkCosts
from ddl_tpu_torch.exceptions import DDLError

#: Assignment type: ``(producer_host, consumer_host)`` pairs, sorted by
#: producer host id.
Assignment = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class Placement:
    """One planned producer→consumer placement plus its modeled value."""

    assignment: Assignment
    modeled_bytes_per_s: float
    naive_bytes_per_s: float
    #: False when the naive order won (never-slower fallback engaged).
    reordered: bool

    @property
    def modeled_ratio(self) -> float:
        if self.naive_bytes_per_s <= 0:
            return 1.0
        return self.modeled_bytes_per_s / self.naive_bytes_per_s


def _roles(view: ClusterView) -> Tuple[List[int], List[int]]:
    producers = sorted(h.host_id for h in view.hosts if h.loader_ranks)
    consumers = sorted(h.host_id for h in view.hosts if h.trainer_ranks)
    if not consumers:
        # Colocated roles (every host both loads and trains): each host
        # is its own consumer candidate.
        consumers = sorted(h.host_id for h in view.hosts)
    if not producers:
        raise DDLError("placement: the view publishes no loader ranks")
    return producers, consumers


def modeled_bytes_per_s(
    assignment: Assignment, costs: LinkCosts
) -> float:
    """Aggregate transport rate under the shared-ingress model: each
    consumer's incoming streams share its ingress, so a pair's rate is
    its link bandwidth divided by the consumer's fan-in; the aggregate
    is the sum.  A model, not a measurement — :func:`measure_assignment`
    is the measurement."""
    fan_in: Dict[int, int] = {}
    for _p, c in assignment:
        fan_in[c] = fan_in.get(c, 0) + 1
    return float(
        sum(
            costs.bytes_per_s(p, c) / fan_in[c]
            for p, c in assignment
        )
    )


def naive_placement(view: ClusterView) -> Assignment:
    """The topology-blind baseline: producers in host-id order dealt
    round-robin onto consumers in host-id order — what a rank-ordered
    launch does today."""
    producers, consumers = _roles(view)
    return tuple(
        (p, consumers[i % len(consumers)])
        for i, p in enumerate(sorted(producers))
    )


def plan_placement(
    view: ClusterView, costs: LinkCosts
) -> Placement:
    """Greedy bandwidth-descending assignment with the never-slower
    fallback (module docstring has the guarantees)."""
    producers, consumers = _roles(view)
    cap = -(-len(producers) // len(consumers))  # ceil(P/C)
    edges = sorted(
        ((p, c) for p in producers for c in consumers),
        # Fastest links first; ties break deterministically on ids.
        key=lambda e: (-costs.bytes_per_s(e[0], e[1]), e[0], e[1]),
    )
    fan_in: Dict[int, int] = {c: 0 for c in consumers}
    chosen: Dict[int, int] = {}
    for p, c in edges:
        if p in chosen or fan_in[c] >= cap:
            continue
        chosen[p] = c
        fan_in[c] += 1
        if len(chosen) == len(producers):
            break
    planned: Assignment = tuple(sorted(chosen.items()))
    naive = naive_placement(view)
    planned_rate = modeled_bytes_per_s(planned, costs)
    naive_rate = modeled_bytes_per_s(naive, costs)
    if planned_rate < naive_rate:
        # Never-slower: the reorder lost under its own model (uniform
        # fabric, degenerate roles) — ship the naive order instead.
        return Placement(
            assignment=naive,
            modeled_bytes_per_s=naive_rate,
            naive_bytes_per_s=naive_rate,
            reordered=False,
        )
    return Placement(
        assignment=planned,
        modeled_bytes_per_s=planned_rate,
        naive_bytes_per_s=naive_rate,
        reordered=planned != naive,
    )


def costs_drift(old: LinkCosts, new: LinkCosts) -> float:
    """Max relative per-link bandwidth change between two cost tables.

    The drift signal a steady-state tuner watches: a
    placement planned against ``old`` is stale when any link's measured
    speed moved by more than the caller's tolerance.  Compared over the
    union of hosts both tables know, so a link that appeared or vanished
    registers as drift through the default-cost fallback rather than
    being skipped.
    """
    hosts = sorted(set(old.hosts()) | set(new.hosts()))
    drift = 0.0
    for i, a in enumerate(hosts):
        for b in hosts[i + 1:]:
            o = old.bytes_per_s(a, b)
            n = new.bytes_per_s(a, b)
            drift = max(drift, abs(n - o) / max(o, 1e-9))
    return drift


def replan_on_drift(
    view: ClusterView,
    old_costs: LinkCosts,
    new_costs: LinkCosts,
    rel_tol: float = 0.25,
) -> Optional[Placement]:
    """Re-run :func:`plan_placement` iff measured costs drifted.

    Returns the fresh :class:`Placement` when :func:`costs_drift`
    exceeds ``rel_tol``, else ``None`` (the current placement stands) —
    the hysteresis that keeps a noisy probe from thrashing assignments.
    """
    if costs_drift(old_costs, new_costs) <= rel_tol:
        return None
    return plan_placement(view, new_costs)


class SimulatedFabric:
    """A measurable stand-in fabric: transfers really move the payload
    (memcpy) and really take ``nbytes / bytes_per_s(a, b)`` wall time
    (a sleep models the wire).  :func:`placement_report` measures naive
    vs planned assignments over it, the role the throttled storage
    backend plays for the shard cache.  On a real cluster, pass a real
    ``transfer`` to :func:`measure_assignment` instead."""

    def __init__(self, costs: LinkCosts, time_scale: float = 1.0):
        self.costs = costs
        self.time_scale = float(time_scale)

    def __call__(self, a: int, b: int, payload: np.ndarray) -> None:
        np.copyto(np.empty_like(payload), payload)
        wire_s = self.costs.seconds(a, b, payload.nbytes) * self.time_scale
        if wire_s > 0:
            time.sleep(wire_s)


def measure_assignment(
    assignment: Assignment,
    transfer: Callable[[int, int, np.ndarray], None],
    payload_bytes: int = 1 << 20,
    reps: int = 3,
    timeout_s: float = 60.0,
) -> float:
    """Measured bytes/s of one full window-transport round over
    ``transfer``: every pair moves one payload, wall-clocked end to end;
    best of ``reps`` rounds.  Deadline-bounded: a wedged transfer ends
    the measurement with what was observed rather than stalling it."""
    if not assignment:
        raise DDLError("cannot measure an empty assignment")
    payload = np.arange(max(1, payload_bytes // 4), dtype=np.float32)
    total_bytes = payload.nbytes * len(assignment)
    best = 0.0
    deadline = time.monotonic() + timeout_s
    for _ in range(max(1, reps)):
        if time.monotonic() >= deadline:
            break
        t0 = time.perf_counter()
        for p, c in assignment:
            transfer(p, c, payload)
        dt = time.perf_counter() - t0
        if dt > 0:
            best = max(best, total_bytes / dt)
    return best


def placement_report(
    view: ClusterView,
    costs: LinkCosts,
    transfer: Optional[Callable[[int, int, np.ndarray], None]] = None,
    payload_bytes: int = 1 << 20,
    reps: int = 3,
) -> dict:
    """Plan, measure both assignments over ``transfer`` (default: the
    simulated fabric priced by ``costs``), report modeled and measured
    rates and the ratio.  The winner is never the slower measured
    assignment."""
    plan = plan_placement(view, costs)
    naive = naive_placement(view)
    fabric = transfer or SimulatedFabric(costs)
    measured_naive = measure_assignment(
        naive, fabric, payload_bytes, reps
    )
    measured_plan = (
        measure_assignment(plan.assignment, fabric, payload_bytes, reps)
        if plan.assignment != naive
        else measured_naive
    )
    ratio = (measured_plan / measured_naive) if measured_naive > 0 else 1.0
    winner = "topology" if measured_plan >= measured_naive else "naive"
    return {
        "n_hosts": len(view.hosts),
        "n_links": costs.n_links,
        "cost_source": costs.source,
        "payload_bytes": int(payload_bytes),
        "assignment": [list(pair) for pair in plan.assignment],
        "naive_assignment": [list(pair) for pair in naive],
        "reordered": bool(plan.reordered),
        "modeled_ratio": round(plan.modeled_ratio, 3),
        "naive_bytes_per_s": round(measured_naive, 1),
        "topo_bytes_per_s": round(measured_plan, 1),
        "bytes_per_s": round(max(measured_plan, measured_naive), 1),
        "ratio": round(ratio, 3),
        "winner": winner,
    }
