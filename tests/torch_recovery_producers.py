"""Producer functions for the recovery tests (not a test module).

Spawned producer processes unpickle these classes by module name, so the
module imports neither torch nor JAX: a child imports only numpy and the
package whose ``DataProducerOnInitReturn`` it returns (``pkg``).  The
same class drives the JAX package (``pkg="ddl_tpu"``, THREAD mode only
here) and the port, so both see the same producer.
"""

import importlib
import os
import signal
import sys
import time

import numpy as np


def _geometry(pkg, **kw):
    ret = importlib.import_module(f"{pkg}.datasetwrapper").DataProducerOnInitReturn
    return ret(**kw)


def _fire_once(sentinel):
    """True the first time any incarnation reaches this point: the
    sentinel file, created before the fault, records that it fired (the
    wall time of the fault, for the tests that time a recovery)."""
    if sentinel is None or os.path.exists(sentinel):
        return False
    with open(sentinel, "w") as f:
        f.write(repr(time.time()))
    return True


class TagProducer:
    """Windows (16, 4) tagged 1, 2, 3, ...; once, at refill ``fault_at``,
    the first incarnation fails as ``fault``: ``"raise"`` (a crash in
    the refill loop), ``"hang"`` (a wedged worker) or ``"sigkill"`` (the
    OOM killer's way: no ``finally`` runs)."""

    def __init__(self, sentinel=None, fault_at=4, fault="raise",
                 pkg="ddl_tpu_torch"):
        self.sentinel, self.fault_at, self.fault = sentinel, fault_at, fault
        self.pkg = pkg
        self.it = 0

    def on_init(self, **kw):
        self.it = 0
        return _geometry(self.pkg, nData=16, nValues=4, shape=(16, 4),
                         splits=(3, 1))

    def post_init(self, my_ary, **kw):
        my_ary[:] = 0.0

    def execute_function(self, my_ary, **kw):
        self.it += 1
        if self.it == self.fault_at and _fire_once(self.sentinel):
            if self.fault == "sigkill":
                os.kill(os.getpid(), signal.SIGKILL)
            if self.fault == "hang":
                time.sleep(3600)
            raise RuntimeError(f"injected crash at window {self.it}")
        my_ary[:] = float(self.it)

    def fast_forward(self, n, **kw):
        for i in range(n):
            self.execute_function(iteration=i, **kw)


class AlwaysCrash:
    """Every incarnation crashes at its first refill."""

    def __init__(self, pkg="ddl_tpu_torch"):
        self.pkg = pkg

    def on_init(self, **kw):
        return _geometry(self.pkg, nData=16, nValues=4, shape=(16, 4),
                         splits=(3, 1))

    def execute_function(self, my_ary, **kw):
        raise RuntimeError("injected crash (every incarnation)")


class ExchangeProducer:
    """Instance-tagged rows (``instance * 1000 + row``) with a seeded
    in-place row shuffle per refill, the global-shuffle workload; the
    first incarnation of instance 0 fails once at refill ``fault_at``
    (``"raise"`` or ``"sigkill"``).  ``fast_forward`` replays only the RNG
    stream: a respawned pusher restores ``my_ary`` from the last
    committed slot (it holds rows exchanged in from peers)."""

    def __init__(self, instance_idx, sentinel=None, fault_at=3,
                 fault="raise", pkg="ddl_tpu_torch", rows=16, cols=2):
        self.instance_idx, self.sentinel = instance_idx, sentinel
        self.fault_at, self.fault, self.pkg = fault_at, fault, pkg
        self.rows, self.cols = rows, cols
        self.it = 0

    def on_init(self, **kw):
        self._rng = np.random.default_rng(self.instance_idx)
        self.it = 0
        return _geometry(self.pkg, nData=self.rows, nValues=self.cols,
                         shape=(self.rows, self.cols),
                         splits=(1, self.cols - 1))

    def post_init(self, my_ary, **kw):
        tags = self.instance_idx * 1000 + np.arange(self.rows)
        my_ary[:] = tags[:, None].astype(np.float32)

    def execute_function(self, my_ary, **kw):
        self.it += 1
        if (self.instance_idx == 0 and self.it == self.fault_at
                and _fire_once(self.sentinel)):
            if self.fault == "sigkill":
                os.kill(os.getpid(), signal.SIGKILL)
            raise RuntimeError(f"injected crash at window {self.it}")
        self._rng.shuffle(my_ary)

    def fast_forward(self, n, **kw):
        dummy = np.empty((self.rows, self.cols), np.float32)
        for _ in range(n):
            self._rng.shuffle(dummy)
        self.it += n


class ModulesProducer:
    """Every value of a window says which frameworks the producer's
    process has imported: column 0 is 1.0 when ``torch`` is in
    ``sys.modules``, column 1 when ``jax`` is."""

    def __init__(self, pkg="ddl_tpu_torch"):
        self.pkg = pkg

    def on_init(self, **kw):
        return _geometry(self.pkg, nData=16, nValues=2, shape=(16, 2),
                         splits=(1, 1))

    def post_init(self, my_ary, **kw):
        self.execute_function(my_ary)

    def execute_function(self, my_ary, **kw):
        my_ary[:, 0] = float("torch" in sys.modules)
        my_ary[:, 1] = float("jax" in sys.modules)


def exchange_worker(n, instance_idx, session, root, seed, rounds, pool_path,
                    out_path):
    """One spawned instance of the cross-process exchange: the port's
    host shuffler over a ``ShmRendezvous``, ``rounds`` rounds on the pool
    saved at ``pool_path``; the result goes to ``out_path``."""
    from ddl_tpu_torch.shuffle import ShmRendezvous, ThreadExchangeShuffler
    from ddl_tpu_torch.types import RunMode, Topology

    pool = np.load(pool_path)
    topo = Topology(n_instances=n, instance_idx=instance_idx, n_producers=1,
                    mode=RunMode.PROCESS)
    sh = ThreadExchangeShuffler(topo, 1, num_exchange=len(pool) // 2,
                                rendezvous=ShmRendezvous(session, root=root),
                                seed=seed, exchange_timeout_s=60.0)
    for r in range(rounds):
        sh.global_shuffle(my_ary=pool, iteration=r)
    np.save(out_path, pool)


class CrashOnceWrapper:
    """Wraps a producer function (e.g. ``TokenStreamProducer``): producer
    ``victim``'s first incarnation fails once at refill ``fault_at`` as
    ``fault`` (``"raise"`` or ``"sigkill"``); every other call is the
    wrapped producer's, so a recovered run serves the same windows."""

    def __init__(self, inner, sentinel, fault_at=2, fault="raise",
                 victim=1):
        self.inner, self.sentinel = inner, sentinel
        self.fault_at, self.fault, self.victim = fault_at, fault, victim
        self.producer_idx = 0
        self.it = 0

    def __getattr__(self, name):
        # Capabilities such as supports_inplace_fill come from the inner
        # producer (only called for names this class lacks).
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    def on_init(self, **kw):
        self.producer_idx = kw.get("producer_idx", 0)
        return self.inner.on_init(**kw)

    def post_init(self, **kw):
        return self.inner.post_init(**kw)

    def execute_function(self, **kw):
        self.it += 1
        if (self.it == self.fault_at and self.producer_idx == self.victim
                and _fire_once(self.sentinel)):
            if self.fault == "sigkill":
                os.kill(os.getpid(), signal.SIGKILL)
            raise RuntimeError(f"injected crash at window {self.it}")
        return self.inner.execute_function(**kw)

    def fast_forward(self, n, **kw):
        self.it += n
        return self.inner.fast_forward(n, **kw)
