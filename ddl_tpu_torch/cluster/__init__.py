"""ddl_tpu_torch.cluster — the multi-host elastic control plane (port of
``ddl_tpu/cluster/``).  Framework-free Python: no module here touches
torch or CUDA.

- **membership** — host leases and heartbeats over the existing liveness
  signals, and the deterministic epoch-fenced view change
  (:class:`ClusterSupervisor`, :class:`ClusterView`).
- **topology** — inter-host link costs, declared or probed
  (:class:`LinkCosts`, :func:`probe_link_costs`).
- **placement** — producer→consumer rank reordering over those costs,
  with the never-slower fallback (:func:`plan_placement`,
  :func:`placement_report`).
- **elastic** — the recovery ladder binding view changes to the live
  pipeline: loader-pool shrink, shard adoption, cache warm start,
  degraded shuffle until rejoin (:class:`ElasticCluster`).
- **supervision** — the journaled supervisor and its lease-based
  failover (:class:`JournaledSupervisor`, :class:`SupervisorHA`).

The loader-pool seam (:class:`LoaderPool`) makes loader ranks a
resizable pool distinct from trainer ranks: ``DistributedDataLoader``
consumes whatever pool the view publishes.
"""

from ddl_tpu_torch.cluster.elastic import ElasticCluster, worker_alive_source
from ddl_tpu_torch.cluster.membership import (
    ClusterSupervisor,
    ClusterView,
    HostInfo,
    LeaseTable,
    partition_shards,
    view_change,
    view_rejoin,
)
from ddl_tpu_torch.cluster.placement import (
    Placement,
    SimulatedFabric,
    measure_assignment,
    modeled_bytes_per_s,
    naive_placement,
    placement_report,
    plan_placement,
)
from ddl_tpu_torch.cluster.pool import LoaderPool
from ddl_tpu_torch.cluster.supervision import (
    JournaledSupervisor,
    ReplayedState,
    SupervisorHA,
    SupervisorJournal,
    replay_journal,
)
from ddl_tpu_torch.cluster.topology import LinkCosts, probe_link_costs

__all__ = [
    "ClusterSupervisor",
    "ClusterView",
    "ElasticCluster",
    "HostInfo",
    "JournaledSupervisor",
    "LeaseTable",
    "LinkCosts",
    "LoaderPool",
    "Placement",
    "ReplayedState",
    "SimulatedFabric",
    "SupervisorHA",
    "SupervisorJournal",
    "measure_assignment",
    "modeled_bytes_per_s",
    "naive_placement",
    "partition_shards",
    "placement_report",
    "plan_placement",
    "probe_link_costs",
    "replay_journal",
    "view_change",
    "view_rejoin",
    "worker_alive_source",
]
