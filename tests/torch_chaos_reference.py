"""The JAX package's MULTIHOST ``chaos`` leg, with what it served recorded
(not a test module).

``tests/multihost_prog.py`` asserts the leg's gates in the process and
records nothing.  This runs its ``main`` unchanged and observes it from
outside: the loader's ``__getitem__`` (each window's shard, read from its
tag) and the ``ClusterSupervisor`` it builds (the view's epoch and the
lost ranks), then the process-wide counters.  It writes
``chaos_ref_<rank>.json`` in the keys of the port's chaos report, which
``tests/test_torch_multihost.py`` holds the port's leg to.

Usage (``DDL_MH_PROCS=2 DDL_MH_DEVS=2 DDL_MH_LEGS=chaos`` in the
environment): ``python torch_chaos_reference.py <rank> <coordinator>
<out_dir>``.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(rank: int, coordinator: str, out: str) -> None:
    import multihost_prog as prog
    import numpy as np
    from torch_multihost_prog import CHAOS_COUNTERS

    from ddl_tpu import cluster, dataloader
    from ddl_tpu.observability import metrics

    served, supervisors = [], []
    loader_cls = dataloader.DistributedDataLoader
    get_batch = loader_cls.__getitem__

    def observed_get(self, idx):
        cols = get_batch(self, idx)
        tag = float(np.asarray(cols[0])[0, 0])
        served.append(int((tag % 100_000) // 1000))
        return cols

    init_supervisor = cluster.ClusterSupervisor.__init__

    def observed_init(self, *args, **kw):
        init_supervisor(self, *args, **kw)
        supervisors.append(self)

    loader_cls.__getitem__ = observed_get
    cluster.ClusterSupervisor.__init__ = observed_init
    prog.main(rank, coordinator)
    (sup,) = supervisors
    shards = sorted(set(served))
    report = dict(
        sequence=served, shards=shards,
        counts=[served.count(s) for s in shards], epoch=sup.view.epoch,
        lost=sorted(sup.lost_ranks()),
        **{c: metrics().counter(c) for c in CHAOS_COUNTERS})
    with open(os.path.join(out, f"chaos_ref_{rank}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
