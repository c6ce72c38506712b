"""ddl_tpu_torch — the PyTorch/CUDA port of ``ddl_tpu``.

A second package beside the JAX one, mirroring it module for module
(``transport/``, ``ops/``, ``parallel/``, ``models/``).  It imports
``torch`` and numpy, never ``jax`` and nothing of ``ddl_tpu``.  The
JAX package stays the reference: tests run both on the same numpy
inputs and hold the port to it.

The port grows slice by slice (ROADMAP.md queue A).  Slice 1 is the
THREAD-mode window-stream ``Trainer.fit`` of a Llama decoder on one
NVIDIA card, with the flash-attention forward and backward written by
hand in CUDA C++ (``ops/csrc/flash_attention.cu``).

Public API keeps the reference's 5-symbol surface plus the topology
types and ``Trainer``; the heavy modules load lazily.
"""

from ddl_tpu_torch.datasetwrapper import (
    DataProducerOnInitReturn,
    ProducerFunctionSkeleton,
)
from ddl_tpu_torch.types import Marker, RunMode, Topology

__version__ = "0.1.0"

__all__ = [
    "DataProducerOnInitReturn",
    "DistributedDataLoader",
    "Marker",
    "ProducerFunctionSkeleton",
    "RunMode",
    "Topology",
    "Trainer",
    "distributed_dataloader",
]


def __getattr__(name: str):
    # Lazy imports keep `import ddl_tpu_torch` light and avoid cycles.
    if name == "DistributedDataLoader":
        from ddl_tpu_torch.dataloader import DistributedDataLoader

        return DistributedDataLoader
    if name == "distributed_dataloader":
        from ddl_tpu_torch.env import distributed_dataloader

        return distributed_dataloader
    if name == "Trainer":
        from ddl_tpu_torch.trainer import Trainer

        return Trainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
