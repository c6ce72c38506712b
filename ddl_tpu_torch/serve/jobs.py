"""The job model of the multi-job ingest fabric (port of
``ddl_tpu/serve/jobs.py``).

A **job** is one training program drawing windows from the shared loader
fleet: the fabric's unit of admission, isolation and accounting.  This
module is the data half of :mod:`ddl_tpu_torch.serve.fabric`:

- **Integrity namespace.**  Every job owns a disjoint 2^32-window slice
  of the integrity trailer's u64 ``seq`` space (:func:`integrity_namespace`):
  producers serving job J stamp ``seq_base(J) + iteration`` and J's
  loader expects exactly that range, so a window that leaks across jobs
  fails seq verification instead of feeding the wrong trainer.  The base
  rides the producer function as a ``seq_base`` attribute (the
  ``wire_dtype`` pattern), so it crosses a spawn with the function.
  Bases reach 2^64 - 2^32: they stay Python ints end to end.
- **Checkpoint directories.**  :meth:`JobRecord.checkpoint_dir` gives each
  job its own generation directory, so job A's restore never resurrects
  job B's cursor.
- **Obs namespace.**  :meth:`JobRecord.obs_prefix` is the ``job.<id>.*``
  family (:func:`ddl_tpu_torch.obs.aggregate.adopt_job`).
- **Cache accounting.**  :class:`JobCacheView` fronts the ONE shared
  :class:`~ddl_tpu_torch.cache.CacheStore` with per-job hit/miss counters
  (``job.<id>.cache.*``).

The registry snapshot (:meth:`JobRegistry.export_state` /
:meth:`adopt_state`) round-trips bit-exact, the contract
``FairShareScheduler`` keeps: it is journaled beside the scheduler
ledger, and a promoted supervisor reconstructs both.
"""


from __future__ import annotations

import dataclasses
import os
import zlib

from ddl_tpu_torch.concurrency import named_lock
from typing import Any, Dict, List, Optional

from ddl_tpu_torch.exceptions import DDLError
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
from ddl_tpu_torch.serve.tenancy import TenantSpec

#: Width of each job's integrity-seq slice: bases are spaced 2^32
#: windows apart, far past any real run's window count.
NAMESPACE_SPAN = 1 << 32


def integrity_namespace(job_id: str) -> int:
    """Deterministic integrity-seq base for ``job_id``: a crc32-derived
    slot index scaled by :data:`NAMESPACE_SPAN`.  Stable across hosts
    and restarts (pure function of the id); collisions between distinct
    ids are possible in principle and rejected at registration
    (:meth:`JobRegistry.register`), where renaming is cheap."""
    return (zlib.crc32(job_id.encode("utf-8")) & 0xFFFFFFFF) * NAMESPACE_SPAN


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One training job's admission contract against the fabric.

    The fields mirror :class:`~ddl_tpu_torch.serve.tenancy.TenantSpec` —
    a job IS a tenant of the fabric's resident scheduler — plus the
    job identity the isolation seams key on.
    """

    job_id: str
    weight: float = 1.0
    byte_budget_per_s: float = 0.0
    slot_budget: int = 0

    def __post_init__(self) -> None:
        if not self.job_id or "." in self.job_id or "/" in self.job_id:
            # The id becomes a metrics key segment (job.<id>.*) AND a
            # checkpoint path segment — dots would alias metric
            # families, slashes would escape the checkpoint root.
            raise DDLError(f"invalid job id {self.job_id!r}")
        if self.weight <= 0:
            raise DDLError(f"job weight must be > 0, got {self.weight}")
        if self.byte_budget_per_s < 0 or self.slot_budget < 0:
            raise DDLError("job budgets must be >= 0")

    def tenant_spec(self) -> TenantSpec:
        """The scheduler-facing half: jobs register in the fabric's
        ``FairShareScheduler`` under their own id."""
        return TenantSpec(
            name=self.job_id,
            weight=self.weight,
            byte_budget_per_s=self.byte_budget_per_s,
            slot_budget=self.slot_budget,
        )

    def to_dict(self) -> dict:
        return {
            "job_id": self.job_id,
            "weight": self.weight,
            "byte_budget_per_s": self.byte_budget_per_s,
            "slot_budget": self.slot_budget,
        }


@dataclasses.dataclass(frozen=True)
class JobRecord:
    """One registered job: the spec plus the fabric-assigned identity
    (registration index for fault-site selection, integrity-seq base
    for namespace isolation)."""

    spec: JobSpec
    index: int
    seq_base: int

    @property
    def job_id(self) -> str:
        return self.spec.job_id

    @property
    def obs_prefix(self) -> str:
        """The job's metric family — the ``producer.<idx>.*`` merge
        pattern one level up."""
        return f"job.{self.spec.job_id}."

    def checkpoint_dir(self, root: str) -> str:
        """This job's private ``resilience/`` generation directory
        under the shared checkpoint root (created on first use)."""
        path = os.path.join(root, f"job-{self.spec.job_id}")
        os.makedirs(path, exist_ok=True)
        return path


class JobRegistry:
    """The fabric's job table: id → :class:`JobRecord`, with the same
    export/adopt snapshot contract the scheduler keeps so registrations
    survive supervisor failover bit-exact.

    Thread-safe under its own lock (``serve.fabric.jobs``): the fabric
    apply path mutates it while reporters read it.
    """

    def __init__(self, metrics: Optional[Metrics] = None):
        self.metrics = metrics or default_metrics()
        self._lock = named_lock("serve.fabric.jobs")
        # job_id -> record: bounded by the registered job set.
        self._jobs: Dict[str, JobRecord] = {}  # ddl-lint: disable=DDL013
        self._next_index = 0

    def register(self, spec: JobSpec) -> JobRecord:
        with self._lock:
            if spec.job_id in self._jobs:
                raise DDLError(f"job {spec.job_id!r} is already registered")
            base = integrity_namespace(spec.job_id)
            for rec in self._jobs.values():
                if rec.seq_base == base:
                    # A crc32 collision between distinct ids: renaming
                    # one job is cheap; silently sharing a namespace
                    # would void the isolation guarantee.
                    raise DDLError(
                        f"job {spec.job_id!r} collides with "
                        f"{rec.job_id!r} in the integrity namespace — "
                        "rename one of them"
                    )
            rec = JobRecord(spec=spec, index=self._next_index, seq_base=base)
            self._next_index += 1
            self._jobs[spec.job_id] = rec
            self.metrics.set_gauge("fabric.jobs", len(self._jobs))
            return rec

    def unregister(self, job_id: str) -> Optional[JobRecord]:
        with self._lock:
            rec = self._jobs.pop(job_id, None)
            if rec is not None:
                self.metrics.set_gauge("fabric.jobs", len(self._jobs))
            return rec

    def get(self, job_id: str) -> JobRecord:
        with self._lock:
            rec = self._jobs.get(job_id)
            if rec is None:
                raise DDLError(f"job {job_id!r} is not registered")
            return rec

    def jobs(self) -> List[str]:
        with self._lock:
            return sorted(self._jobs)

    def __len__(self) -> int:
        with self._lock:
            return len(self._jobs)

    def __contains__(self, job_id: str) -> bool:
        with self._lock:
            return job_id in self._jobs

    # -- failover state transfer (the scheduler export/adopt contract) --

    def export_state(self) -> dict:
        """Snapshot the registry as a JSON-serializable dict; adopting
        the same snapshot roundtrips bit-exact (the failover suite
        pins export → adopt → export equality)."""
        with self._lock:
            return {
                "version": 1,
                "next_index": self._next_index,
                "jobs": {
                    job_id: {
                        "spec": rec.spec.to_dict(),
                        "index": rec.index,
                        "seq_base": rec.seq_base,
                    }
                    for job_id, rec in self._jobs.items()
                },
            }

    def adopt_state(self, state: dict) -> None:
        if state.get("version") != 1:
            raise DDLError(
                f"unknown job-registry snapshot version "
                f"{state.get('version')!r}"
            )
        with self._lock:
            adopted: Dict[str, JobRecord] = {}
            for job_id, rec in state["jobs"].items():
                adopted[job_id] = JobRecord(
                    spec=JobSpec(**rec["spec"]),
                    index=int(rec["index"]),
                    seq_base=int(rec["seq_base"]),
                )
            self._jobs = adopted
            self._next_index = int(state["next_index"])
            self.metrics.set_gauge("fabric.jobs", len(self._jobs))


class JobCacheView:
    """Per-job accounting facade over the ONE shared
    :class:`~ddl_tpu_torch.cache.CacheStore`.

    The store's ``cache.*`` counters stay fleet-global; this view adds
    ``job.<id>.cache.hits`` / ``.misses`` so a report can attribute
    warm-tier value per job.  It holds no entries of its own — eviction
    and spill policy remain the shared store's.
    """

    def __init__(self, store: Any, job_id: str, metrics: Optional[Metrics] = None):
        self.store = store
        self.job_id = job_id
        self.metrics = metrics or default_metrics()
        self._prefix = f"job.{job_id}.cache."

    def get(self, key: Any) -> Any:
        arr = self.store.get(key)
        self.metrics.incr(
            self._prefix + ("hits" if arr is not None else "misses")
        )
        return arr

    def put(self, key: Any, arr: Any) -> Any:
        return self.store.put(key, arr)

    def get_or_load(self, key: Any, loader: Any) -> Any:
        arr = self.get(key)
        if arr is None:
            arr = self.store.put(key, loader())
        return arr

    def contains(self, key: Any) -> bool:
        return self.store.contains(key)

    def counts(self) -> Dict[str, float]:
        """This job's ``{hits, misses}`` counter pair."""
        return {
            "hits": self.metrics.counter(self._prefix + "hits"),
            "misses": self.metrics.counter(self._prefix + "misses"),
        }
