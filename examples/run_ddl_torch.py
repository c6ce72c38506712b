"""End-to-end example on the PyTorch port: a synthetic pointwise dataset
through the full pipeline.

The twin of ``examples/run_ddl.py``: a synthetic CFD-flavoured pointwise
dataset, min-max normalised per column, loaded by a
``ProducerFunctionSkeleton`` subclass and drained by a decorated main
under the explicit ``mark()`` contract.  The loader serves numpy batches
as the reference's does, or device batches with ``--output device`` (on
the card unless ``--device cpu``).

Run:

    python examples/run_ddl_torch.py                  # THREAD mode
    python examples/run_ddl_torch.py process          # spawned producers
    python examples/run_ddl_torch.py --output device  # batches on the card
    DDL_TORCH_N_PRODUCERS=3 python examples/run_ddl_torch.py process

Exit code 0 after a deadlock-free drain of every epoch is the pass
criterion; the drain prints a line ending in ``OK``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
from typing import Any

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ddl_tpu_torch import (  # noqa: E402
    DataProducerOnInitReturn,
    DistributedDataLoader,
    Marker,
    ProducerFunctionSkeleton,
    distributed_dataloader,
)


@dataclasses.dataclass
class Params:
    """Workload knobs (the reference example's)."""

    nepoch: int = 4
    batch_size: int = 32
    n_data: int = 1024  # samples per producer window
    n_features: int = 10  # columns: 3 pos + 6 field + 1 weight


def make_pointwise_data(n: int, n_features: int, seed: int) -> np.ndarray:
    """Synthetic CFD-style pointwise samples, min-max normalised per
    column."""
    rng = np.random.default_rng(seed)
    raw = rng.random((n, n_features), dtype=np.float32)
    lo, hi = raw.min(axis=0), raw.max(axis=0)
    return (raw - lo) / np.maximum(hi - lo, 1e-12)


class DataProducer(ProducerFunctionSkeleton):
    """Loads its shard lazily in the worker and refreshes each window by
    an in-place shuffle."""

    def __init__(self, params: Params):
        self.params = params
        self._data: np.ndarray | None = None
        self._rng: np.random.Generator | None = None

    def on_init(self, producer_idx: int = 0, n_producers: int = 1,
                instance_idx: int = 0, n_instances: int = 1,
                **kwargs: Any) -> DataProducerOnInitReturn:
        p = self.params
        seed = instance_idx * 1000 + producer_idx
        self._data = make_pointwise_data(p.n_data, p.n_features, seed)
        self._rng = np.random.default_rng(seed + 1)
        return DataProducerOnInitReturn(
            nData=p.n_data,
            nValues=p.n_features,
            shape=(p.n_data, p.n_features),
            splits=(3, p.n_features - 4, 1),  # (pos, target, weight)
            dtype=np.float32,
        )

    def post_init(self, my_ary: np.ndarray, **kwargs: Any) -> None:
        np.copyto(my_ary, self._data)

    def execute_function(self, my_ary: np.ndarray, **kwargs: Any) -> None:
        assert self._rng is not None
        self._rng.shuffle(my_ary)  # in-place local shuffle per window


@distributed_dataloader
def main(params: Params, output: str, device: str, ddl_env: Any) -> int:
    """Consumer main: drain every epoch, checking batch geometry and the
    normalisation."""
    loader = DistributedDataLoader(
        data_producer_function=DataProducer(params),
        batch_size=params.batch_size,
        connection=ddl_env.connection,
        n_epochs=params.nepoch,
        output=output,
        device=device,
    )
    total_batches = 0
    try:
        for epoch in range(params.nepoch):
            for i, (pos, target, weight) in enumerate(loader):
                assert tuple(pos.shape) == (params.batch_size, 3)
                assert tuple(target.shape) == (params.batch_size,
                                               params.n_features - 4)
                assert tuple(weight.shape) == (params.batch_size, 1)
                assert 0.0 <= float(pos[0, 0]) <= 1.0  # normalised
                total_batches += 1
                loader.mark(Marker.END_OF_BATCH)
            loader.mark(Marker.END_OF_EPOCH)
    finally:
        loader.shutdown()
    expected = params.nepoch * (params.n_data // params.batch_size)
    assert total_batches == expected, (total_batches, expected)
    print(f"drained {total_batches} batches over {params.nepoch} epochs "
          f"({output} output): OK")
    return total_batches


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default=None,
                    choices=("thread", "process"),
                    help="producer realisation (default: DDL_TORCH_MODE)")
    ap.add_argument("--output", default="numpy", choices=("numpy", "device"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    if args.mode is not None:
        os.environ["DDL_TORCH_MODE"] = args.mode
    if args.output == "numpy":
        # A numpy run never touches a device; the card is still the
        # default, so say which one a numpy drain stands for.
        from ddl_tpu_torch.utils import resolve_device

        resolve_device(args.device)
    main(Params(), args.output, args.device)
