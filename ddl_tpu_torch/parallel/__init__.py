"""Parallel layers of the port of ``ddl_tpu/parallel``: meshes of one
device's positions and sharded arrays (``mesh``), training steps over
them (``train``), attention dispatch with ring and sharded local
attention (``ring_attention``), the device collectives (``collectives``:
the global shuffle over positions and the quantized all-reduce), ZeRO-1
(``optimizer``) and the ICI ingest tier (``ici``).  The pipeline
schedule (``pipeline.py``) is a later slice."""

from ddl_tpu_torch.parallel.collectives import (
    DeviceGlobalShuffler,
    quantized_all_reduce,
)
from ddl_tpu_torch.parallel.mesh import data_parallel_mesh, make_mesh
from ddl_tpu_torch.parallel.optimizer import ShardedOptimizer, hbm_accounting

__all__ = [
    "DeviceGlobalShuffler",
    "ShardedOptimizer",
    "data_parallel_mesh",
    "hbm_accounting",
    "make_mesh",
    "quantized_all_reduce",
]
