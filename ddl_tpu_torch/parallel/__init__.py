"""Parallel layers of the port of ``ddl_tpu/parallel``: meshes of one
device's positions, and process-spanning meshes over a gloo group, with
sharded arrays (``mesh``), training steps over them (``train``),
attention dispatch with ring and sharded local attention
(``ring_attention``), the device collectives (``collectives``: the
global shuffle over positions, ``psum``, the quantized all-reduce and
the cross-process moves), ZeRO-1 (``optimizer``), the pipeline schedule
(``pipeline``) and the ICI ingest tier (``ici``)."""

from ddl_tpu_torch.parallel.collectives import (
    DeviceGlobalShuffler,
    quantized_all_reduce,
)
from ddl_tpu_torch.parallel.mesh import data_parallel_mesh, make_mesh
from ddl_tpu_torch.parallel.optimizer import ShardedOptimizer, hbm_accounting
from ddl_tpu_torch.parallel.pipeline import (
    bubble_fraction,
    pipeline_apply,
    pipeline_spec,
    stack_stage_params,
)

__all__ = [
    "DeviceGlobalShuffler",
    "ShardedOptimizer",
    "bubble_fraction",
    "data_parallel_mesh",
    "hbm_accounting",
    "make_mesh",
    "pipeline_apply",
    "pipeline_spec",
    "quantized_all_reduce",
    "stack_stage_params",
]
