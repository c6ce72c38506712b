"""Global shuffle on the PyTorch port: cross-instance sample exchange.

The twin of ``examples/global_shuffle.py``: two instances in one process
(each one producer + one consumer, like two hosts), a shared
:class:`~ddl_tpu_torch.shuffle.Rendezvous` standing in for the
interconnect, and a :class:`~ddl_tpu_torch.shuffle.ThreadExchangeShuffler`
exchanging half of every window per refill.  The exchange is host-side,
as the reference example's is: no device is touched.

Every served window mixes rows from both instances: the round-0 exchange
runs before the first window commit (producer loop order: exchange →
local shuffle → commit), and the local in-place shuffle spreads received
rows through the window so later rounds move fresh samples rather than
ping-ponging the same lanes back.

Run:

    python examples/global_shuffle_torch.py

Exit 0 with ``PASS`` as the last line is the pass criterion.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Any, Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ddl_tpu_torch import (  # noqa: E402
    DataProducerOnInitReturn,
    DistributedDataLoader,
    Marker,
    ProducerFunctionSkeleton,
)
from ddl_tpu_torch.datapusher import DataPusher  # noqa: E402
from ddl_tpu_torch.shuffle import Rendezvous, ThreadExchangeShuffler  # noqa: E402
from ddl_tpu_torch.transport.connection import (  # noqa: E402
    ConsumerConnection,
    ProducerConnection,
    ThreadChannel,
)
from ddl_tpu_torch.types import RunMode, Topology  # noqa: E402

N_DATA, N_VALUES = 32, 4
BATCH = 8
N_EPOCHS = 3
EXCHANGE_FRACTION = 0.5  # half of every window swaps each refill


class InstanceTagged(ProducerFunctionSkeleton):
    """Rows tagged <instance*1000 + row> so provenance is visible."""

    def __init__(self, instance_idx: int):
        self.instance_idx = instance_idx

    def on_init(self, producer_idx=0, **kw):
        self._rng = np.random.default_rng(self.instance_idx)
        return DataProducerOnInitReturn(
            nData=N_DATA, nValues=N_VALUES, shape=(N_DATA, N_VALUES),
            splits=(N_VALUES - 1, 1),
        )

    def post_init(self, my_ary, **kw):
        tags = self.instance_idx * 1000 + np.arange(N_DATA)
        my_ary[:] = tags[:, None].astype(np.float32)

    def execute_function(self, my_ary, **kw):
        # A local in-place shuffle per refill permutes rows without
        # rewriting them, so rows received from the other instance
        # survive and spread through the window.
        self._rng.shuffle(my_ary)


def run_instance(instance_idx: int, rendezvous: Rendezvous, results: dict,
                 served: Optional[list] = None) -> None:
    """One 'host': a producer thread + the consumer drain, THREAD mode.
    ``results[instance_idx]`` gets each epoch's set of origins;
    ``served``, when given, every served ``x`` batch (copied)."""
    topo = Topology(
        n_instances=2, instance_idx=instance_idx, n_producers=1,
        mode=RunMode.THREAD,
    )
    consumer_end, producer_end = ThreadChannel.pair()
    pconn = ProducerConnection(producer_end, 1, cross_process=False)

    def producer() -> None:
        DataPusher(
            pconn, topo, 1,
            shuffler_factory=ThreadExchangeShuffler.factory(rendezvous),
        ).push_data()

    threading.Thread(target=producer, daemon=True).start()

    loader = DistributedDataLoader(
        InstanceTagged(instance_idx),
        batch_size=BATCH,
        connection=ConsumerConnection([consumer_end]),
        n_epochs=N_EPOCHS,
        output="numpy",
        global_shuffle_fraction_exchange=EXCHANGE_FRACTION,
    )
    per_epoch: list = []
    for _epoch in range(N_EPOCHS):
        seen: set = set()
        for x, _y in loader:
            seen.update(int(t) // 1000 for t in x[:, 0])
            if served is not None:
                served.append(np.array(x))
            loader.mark(Marker.END_OF_BATCH)
        loader.mark(Marker.END_OF_EPOCH)
        per_epoch.append(seen)
    results[instance_idx] = per_epoch


def main() -> int:
    rendezvous = Rendezvous()
    results: dict[int, Any] = {}
    threads = [
        threading.Thread(
            target=run_instance, args=(i, rendezvous, results), daemon=True
        )
        for i in range(2)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    ok = len(results) == 2
    for i, epochs in sorted(results.items()):
        print(f"instance {i}: origins per epoch = {[sorted(e) for e in epochs]}")
        # EVERY epoch mixes both instances' rows (see module docstring).
        ok = ok and all(e == {0, 1} for e in epochs)
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
