"""ddl_tpu_torch.serve — the multi-job ingest service over the elastic
cluster (port of ``ddl_tpu/serve/``).  Framework-free Python: no module
here touches torch or CUDA.

- **tenancy** — independent loader jobs register as tenants against one
  producer pool and one shard-cache tier; a deficit-round-robin
  fair-share scheduler with per-tenant byte and slot budgets arbitrates
  every window acquisition at the loader's acquire seam
  (:class:`AdmissionController`, :class:`FairShareScheduler`,
  :class:`TenantSpec`).
- **autoscaler** — a deadline loop reading the stall-fraction and
  queue-depth demand signals, growing the loader pool (``rejoin_host``
  of standby hosts) and shrinking it (drain, then release) under
  hysteresis, a cooldown and a never-empty floor, re-running
  ``plan_placement`` on every resize (:class:`Autoscaler`,
  :class:`AutoscalerPolicy`).
- **fabric** — one authoritative scheduler and job registry resident
  beside the journaled supervisor, driven over acked control envelopes,
  every decision journaled so the admission order survives a supervisor
  failover bit for bit (:class:`IngestFabric`, :class:`FabricClient`,
  :class:`FabricJob`); **jobs** — the job model and its isolation
  seams: integrity namespaces, checkpoint directories, obs and cache
  accounting (:class:`JobSpec`, :class:`JobRegistry`,
  :class:`JobCacheView`).
"""


from ddl_tpu_torch.serve.autoscaler import Autoscaler, AutoscalerPolicy
from ddl_tpu_torch.serve.fabric import FabricClient, FabricJob, IngestFabric
from ddl_tpu_torch.serve.jobs import (
    JobCacheView,
    JobRecord,
    JobRegistry,
    JobSpec,
    integrity_namespace,
)
from ddl_tpu_torch.serve.tenancy import (
    AdmissionController,
    FairShareScheduler,
    Tenant,
    TenantSpec,
)

__all__ = [
    "AdmissionController",
    "Autoscaler",
    "AutoscalerPolicy",
    "FabricClient",
    "FabricJob",
    "FairShareScheduler",
    "IngestFabric",
    "JobCacheView",
    "JobRecord",
    "JobRegistry",
    "JobSpec",
    "Tenant",
    "TenantSpec",
    "integrity_namespace",
]
