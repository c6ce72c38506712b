"""The plain float32 references, one module a model family
(``benchmark/reference/<family>.py``: ``leaf_specs``, ``block_loss``,
``batch_count``, ``block_rows``), and the driver that trains one from the
seed's weights on the judged steps' batches.  Nothing here imports the
system under test.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark import weights
from benchmark.reference import common


def family(name: str) -> Any:
    return importlib.import_module(f"benchmark.reference.{name}")


def train(config: Dict[str, Any], traffic: Dict[str, Any], seed: int,
          batches: List[np.ndarray], precision: str,
          device: Any) -> common.Readings:
    """The reference's readings of the judged steps: the configuration's
    model made from ``seed``, trained by AdamW on ``batches`` (each
    (rows, features)) with every matrix product in ``precision``."""
    ref = family(config["family"])
    common.exact_float32()
    specs = ref.leaf_specs(config)
    _, made = weights.make(specs, seed, device)
    leaves = [t.detach().clone().requires_grad_(True) for t in made]
    del made
    params = weights.tree(specs, leaves)
    on_device = [torch.from_numpy(np.ascontiguousarray(b)).to(device)
                 for b in batches]

    def block_loss(batch, lo, hi):
        return ref.block_loss(params, batch[lo:hi], config, traffic, precision)

    return common.train(
        leaves, block_loss, lambda b: ref.batch_count(b, config, traffic),
        on_device, rows=int(traffic["batch_size"]),
        block_rows=ref.block_rows(config, traffic), hp=config["optimizer"])
