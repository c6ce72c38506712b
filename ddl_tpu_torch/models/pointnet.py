"""Pointwise MLP regressor (port of ``ddl_tpu/models/pointnet.py``): the
reference harness's model, trained per point on the ``(pos, target,
weight)`` column tuple its example producer emits.  It runs no kernel of
its own: GELU (tanh-approximated, ``jax.nn.gelu``'s default) hidden
layers and a linear output.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ddl_tpu_torch.models.llama import params_from_numpy  # noqa: F401

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PointNetConfig:
    n_inputs: int = 3  # point position columns
    n_outputs: int = 6  # field value columns
    hidden: Tuple[int, ...] = (64, 64)
    dtype: Any = torch.float32


def init_params(cfg: PointNetConfig, seed: int = 0, device: Any = "cuda") -> Params:
    """``1/sqrt(fan_in)``-scaled normal weights and zero biases, fp32,
    from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    from ddl_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sizes = (cfg.n_inputs, *cfg.hidden, cfg.n_outputs)
    layers: List[Dict[str, torch.Tensor]] = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((fan_in, fan_out), generator=gen, device=dev)
        layers.append({"w": w / float(np.sqrt(fan_in)),
                       "b": torch.zeros(fan_out, device=dev)})
    return {"layers": layers}


def param_specs(cfg: PointNetConfig) -> Params:
    """Replicated params — the model is tiny; dp handles the scale."""
    from ddl_tpu_torch.parallel.mesh import P

    return {"layers": [{"w": P(None, None), "b": P(None)}
                       for _ in range(len(cfg.hidden) + 1)]}


def forward(params: Params, x: torch.Tensor, cfg: PointNetConfig) -> torch.Tensor:
    h = x.to(cfg.dtype)
    layers = params["layers"]
    for layer in layers[:-1]:
        h = F.gelu(h @ layer["w"] + layer["b"], approximate="tanh")
    return h @ layers[-1]["w"] + layers[-1]["b"]


def weighted_mse_loss(params: Params, batch: Tuple[Any, Any, Any],
                      cfg: PointNetConfig) -> torch.Tensor:
    """Weighted MSE over (pos, target, weight) — the example producer's
    column tuple."""
    pos, target, weight = batch
    pred = forward(params, pos, cfg)
    err = (pred - target.to(pred.dtype)) ** 2
    return (err * weight.to(pred.dtype)).mean()
