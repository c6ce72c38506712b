"""Producer functions for the cluster tests (not a test module).

Spawned producer processes unpickle these classes by module name, so the
module imports neither torch nor JAX: a child imports only numpy and the
package whose ``DataProducerOnInitReturn`` it returns (``pkg``).  One
class drives the JAX package (``pkg="ddl_tpu"``) and the port, so both
see the same producer.
"""

import importlib

import numpy as np

#: The shared geometry of ``tests/test_cluster.py``: 2 mock hosts x 1
#: producer, 4 shards, windows of (8, 4) float32.
N_SHARDS, ROWS, VALS = 4, 8, 4


def shard_pattern(shard: int) -> np.ndarray:
    """Byte-deterministic content of one shard's window."""
    return (
        shard * 1000.0 + np.arange(ROWS * VALS, dtype=np.float32) % 97
    ).reshape(ROWS, VALS)


class ShardRangeProducer:
    """Serves its host's shard ranges in a cycle; ``adopt_shards``
    re-partitions mid-run.  Initial ranges come from a per-producer map
    (the base assignment), keyed by ``producer_idx``: every producer gets
    a copy of this object, so per-producer state derives from
    ``on_init``.  ``pattern(shard)`` is a shard's window (module level,
    or a ``functools.partial`` of one: it is pickled with the object)."""

    def __init__(self, ranges_by_producer, pkg="ddl_tpu_torch",
                 pattern=shard_pattern):
        self.ranges_by_producer = dict(ranges_by_producer)
        self.pkg = pkg
        self.pattern = pattern
        self.ranges = ()

    def _shards(self):
        return [s for a, b in self.ranges for s in range(a, b)]

    def on_init(self, producer_idx=1, **kw):
        self.it = 0
        self.ranges = tuple(self.ranges_by_producer[producer_idx])
        rows, vals = self.pattern(0).shape
        ret = importlib.import_module(
            f"{self.pkg}.datasetwrapper").DataProducerOnInitReturn
        return ret(nData=rows, nValues=vals, shape=(rows, vals),
                   splits=(vals,))

    def post_init(self, my_ary, **kw):
        my_ary[:] = 0.0

    def execute_function(self, my_ary, **kw):
        shards = self._shards()
        my_ary[:] = self.pattern(shards[self.it % len(shards)])
        self.it += 1

    def fast_forward(self, n, **kw):
        # The skeleton's default: a respawned incarnation replays to its
        # predecessor's position instead of serving its windows again.
        for i in range(n):
            self.execute_function(iteration=i, **kw)

    def adopt_shards(self, ranges, **kw):
        self.ranges = tuple(tuple(r) for r in ranges)
