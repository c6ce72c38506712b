"""``Trainer.fit(config=LoaderConfig(exchange_method=...))`` hands the
exchange method to the producers' shufflers, as the JAX package's does
(``ddl_tpu/trainer.py`` ``loader_kwargs.setdefault("exchange_method",
config.exchange_method)``).

Two instances of a THREAD fit run side by side in one process, each in
its own thread, over one shared :class:`Rendezvous` (the two-host
harness of ``examples/global_shuffle.py``, driven through ``fit``): each
package's ``env.detect_topology`` is replaced by one that reports two
instances, the calling thread's index among them.  A recording factory
around ``ThreadExchangeShuffler.factory`` notes the method each
producer's shuffler was built with, and a ``window_hook`` records every
served window.

Held: the port's ``all_to_all`` fit serves windows byte-equal to the
JAX package's, and its shufflers are built with ``all_to_all`` as the
reference's are; the ``sendrecv_replace`` control builds its shufflers
with the other method (the two host exchanges move the same lanes for
either method, in both packages, so the method shows in what the
producers built, not in the rows); ``loader_kwargs`` win over the
config.
"""

import concurrent.futures
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import ddl_tpu
import ddl_tpu.env
import ddl_tpu_torch
import ddl_tpu_torch.env
from ddl_tpu.config import LoaderConfig as JaxLoaderConfig
from ddl_tpu.parallel.mesh import make_mesh
from ddl_tpu.shuffle import Rendezvous as JaxRendezvous
from ddl_tpu.shuffle import ThreadExchangeShuffler as JaxShuffler
from ddl_tpu.trainer import Trainer as JaxTrainer
from ddl_tpu_torch.config import LoaderConfig
from ddl_tpu_torch.observability import Metrics
from ddl_tpu_torch.parallel.train import adamw
from ddl_tpu_torch.shuffle import Rendezvous, ThreadExchangeShuffler
from ddl_tpu_torch.trainer import Trainer

N_DATA, N_VALUES, BATCH, EPOCHS = 16, 4, 4, 3

#: (instance, method) of every shuffler a recording factory built.
_BUILT: list = []
_local = threading.local()


def _tagged(pkg):
    """A pool producer of ``pkg``: rows tagged instance*1000 + row, a
    seeded in-place shuffle per refill (exchanged rows survive it)."""

    class Tagged(pkg.ProducerFunctionSkeleton):
        def on_init(self, producer_idx=0, instance_idx=0, **kw):
            self.instance_idx = instance_idx
            self._rng = np.random.default_rng(100 * instance_idx + producer_idx)
            return pkg.DataProducerOnInitReturn(
                nData=N_DATA, nValues=N_VALUES, shape=(N_DATA, N_VALUES),
                splits=(N_VALUES,), dtype=np.float32)

        def post_init(self, my_ary, **kw):
            tags = self.instance_idx * 1000 + np.arange(N_DATA)
            my_ary[:] = (tags[:, None] + np.arange(N_VALUES) / 10).astype(
                np.float32)

        def execute_function(self, my_ary, **kw):
            self._rng.shuffle(my_ary)

    return Tagged()


class _Recording:
    """Delegates to ``inner``; notes the method each shuffler gets."""

    def __init__(self, inner):
        self.inner = inner

    def __call__(self, topology, producer_idx, num_exchange, exchange_method):
        _BUILT.append((topology.instance_idx, exchange_method))
        return self.inner(topology=topology, producer_idx=producer_idx,
                          num_exchange=num_exchange,
                          exchange_method=exchange_method)


def _two_instances(topology_cls):
    def detect(n_producers=None, mode=None, host_id=None, n_hosts=None):
        return topology_cls(n_instances=2, instance_idx=_local.idx,
                            n_producers=n_producers or 1)

    return detect


@pytest.fixture
def two_instances(monkeypatch):
    monkeypatch.setattr(ddl_tpu.env, "detect_topology",
                        _two_instances(ddl_tpu.Topology))
    monkeypatch.setattr(ddl_tpu_torch.env, "detect_topology",
                        _two_instances(ddl_tpu_torch.Topology))
    _BUILT.clear()


def _run_pair(fit_one):
    """Run ``fit_one(idx, windows)`` for instances 0 and 1 in two threads;
    returns each instance's served windows."""
    windows = {0: [], 1: []}

    def body(idx):
        _local.idx = idx
        fit_one(idx, windows[idx])

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(body, i) for i in (0, 1)]
        for run in runs:
            run.result(timeout=120)  # re-raises a fit's error here
    return windows


def _jax_fit(method):
    rdv = JaxRendezvous()

    def fit_one(idx, out):
        trainer = JaxTrainer(
            loss_fn=lambda p, b: (p["w"] * jnp.mean(b[0])) ** 2,
            optimizer=optax.sgd(1e-3),
            mesh=make_mesh({"dp": 1}, devices=jax.local_devices()[:1]),
            param_specs={"w": P()},
            init_params={"w": jnp.ones((), jnp.float32)},
            batch_spec=P(("dp",)), watchdog=False,
            metrics=ddl_tpu.observability.Metrics(),
        )

        def hook(win):
            out.append(np.asarray(win).copy())
            return win

        trainer.fit(
            _tagged(ddl_tpu),
            config=JaxLoaderConfig(
                batch_size=BATCH, n_epochs=EPOCHS, n_producers=1,
                window_stream=True, exchange_method=method,
                global_shuffle_fraction_exchange=0.5),
            shuffler_factory=_Recording(JaxShuffler.factory(rdv)),
            window_hook=hook,
        )

    return _run_pair(fit_one)


def _torch_fit(method, **fit_kw):
    rdv = Rendezvous()

    def fit_one(idx, out):
        trainer = Trainer(
            loss_fn=lambda p, b: (p["w"] * b[0].mean()) ** 2,
            optimizer=adamw(1e-3),
            init_params={"w": torch.ones(())},
            device="cpu", watchdog=False, metrics=Metrics(),
        )

        def hook(win):
            out.append(win.numpy().copy())
            return win

        trainer.fit(
            _tagged(ddl_tpu_torch),
            config=LoaderConfig(
                batch_size=BATCH, n_epochs=EPOCHS, n_producers=1,
                window_stream=True, exchange_method=method,
                global_shuffle_fraction_exchange=0.5),
            shuffler_factory=_Recording(ThreadExchangeShuffler.factory(rdv)),
            window_hook=hook, **fit_kw,
        )

    return _run_pair(fit_one)


def _built():
    out = sorted(_BUILT)
    _BUILT.clear()
    return out


def _assert_mixed_and_equal(got, want):
    for idx in (0, 1):
        assert len(got[idx]) == len(want[idx]) == EPOCHS
        for g, w in zip(got[idx], want[idx]):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
            # The exchange ran: every window holds rows of both instances.
            assert set((g[..., 0] // 1000).astype(int).ravel()) == {0, 1}


def test_all_to_all_fit_matches_the_reference(two_instances):
    want = _jax_fit("all_to_all")
    assert _built() == [(0, "all_to_all"), (1, "all_to_all")]
    got = _torch_fit("all_to_all")
    assert _built() == [(0, "all_to_all"), (1, "all_to_all")]
    _assert_mixed_and_equal(got, want)


def test_sendrecv_replace_control_builds_the_other_method(two_instances):
    """The control: the default method reaches the shufflers as itself,
    so the ``all_to_all`` fit above is not the default in disguise; its
    windows equal the reference's control too."""
    want = _jax_fit("sendrecv_replace")
    assert _built() == [(0, "sendrecv_replace"), (1, "sendrecv_replace")]
    got = _torch_fit("sendrecv_replace")
    built = _built()
    assert built == [(0, "sendrecv_replace"), (1, "sendrecv_replace")]
    assert built != [(0, "all_to_all"), (1, "all_to_all")]
    _assert_mixed_and_equal(got, want)


def test_loader_kwargs_win_over_the_config(two_instances):
    _torch_fit("all_to_all",
               loader_kwargs={"exchange_method": "sendrecv_replace"})
    assert _built() == [(0, "sendrecv_replace"), (1, "sendrecv_replace")]
