"""Vision Transformer (port of ``ddl_tpu/models/vit.py``): the image
classification family, over the ``[pixels..., label]`` rows the image
readers serve.

Plain functions over a params dict in the JAX package's layout (weights
``(in, out)`` applied as ``x @ W``, so ``params_from_numpy`` carries
them across): a convolution-free patch embedding (reshape + one matrix
product), learned position embeddings, pre-norm encoder blocks with
non-causal attention through the shared dispatcher
(:func:`~ddl_tpu_torch.parallel.ring_attention.attention`: the flash
kernels K1-K3 with ``causal=False`` on the card, the dense reference on
the CPU), a tanh-approximated GELU MLP (``jax.nn.gelu``'s default), and
a mean-pooled head multiplied in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ddl_tpu_torch.models.llama import _rms_norm
from ddl_tpu_torch.models.llama import params_from_numpy  # noqa: F401

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 32
    patch_size: int = 4
    n_channels: int = 3
    d_model: int = 128
    n_layers: int = 4
    n_heads: int = 4
    d_ff: int = 512
    n_classes: int = 10
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    attn_impl: str = "auto"  # "auto" | "flash" | "dense"

    def __post_init__(self) -> None:
        if self.image_size % self.patch_size:
            raise ValueError(
                f"patch_size {self.patch_size} must divide image_size "
                f"{self.image_size}"
            )
        if self.attn_impl not in ("auto", "flash", "dense"):
            raise ValueError(f"bad attn_impl {self.attn_impl!r}")

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.n_channels

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _build(cfg: ViTConfig, dense: Any, ones: Any, small: Any) -> Params:
    """The params tree from ``dense(shape, fan_in)``, ``ones(shape)`` and
    ``small(shape)`` (the position embedding), in the JAX package's
    order."""
    d = cfg.d_model
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "attn_norm": ones((d,)),
            "wq": dense((d, d), d),
            "wk": dense((d, d), d),
            "wv": dense((d, d), d),
            "wo": dense((d, d), d),
            "mlp_norm": ones((d,)),
            "w_up": dense((d, cfg.d_ff), d),
            "w_down": dense((cfg.d_ff, d), cfg.d_ff),
        })
    return {
        "patch_embed": dense((cfg.patch_dim, d), cfg.patch_dim),
        "pos_embed": small((cfg.n_patches, d)),
        "layers": layers,
        "final_norm": ones((d,)),
        "head": dense((d, cfg.n_classes), d),
    }


def init_params(cfg: ViTConfig, seed: int = 0, device: Any = "cuda") -> Params:
    """fp32 ``1/sqrt(fan_in)``-scaled normal weights, unit norms and
    ``0.02``-scaled position embeddings, drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device``."""
    from ddl_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    return _build(
        cfg,
        lambda shape, fan_in: normal(shape).div_(float(np.sqrt(fan_in))),
        lambda shape: torch.ones(shape, device=dev, dtype=torch.float32),
        lambda shape: normal(shape).mul_(0.02),
    )


def param_shapes(cfg: ViTConfig) -> Params:
    """The params tree of :func:`init_params` as ``meta`` tensors."""
    def meta(shape, fan_in=None):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    return _build(cfg, meta, meta, meta)


def param_specs(cfg: ViTConfig) -> Params:
    """fsdp shards the model axis, tp shards heads/ffn (Megatron layout)."""
    from ddl_tpu_torch.parallel.mesh import P

    layer = {
        "attn_norm": P(None),
        "wq": P("fsdp", "tp"),
        "wk": P("fsdp", "tp"),
        "wv": P("fsdp", "tp"),
        "wo": P("tp", "fsdp"),
        "mlp_norm": P(None),
        "w_up": P("fsdp", "tp"),
        "w_down": P("tp", "fsdp"),
    }
    return {
        "patch_embed": P(None, "fsdp"),
        "pos_embed": P(None, "fsdp"),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
        "final_norm": P(None),
        "head": P("fsdp", None),
    }


def patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """(B, H, W, C) → (B, n_patches, patch_dim) by pure reshapes."""
    B = images.shape[0]
    p = cfg.patch_size
    g = cfg.image_size // p
    x = images.reshape(B, g, p, g, p, cfg.n_channels)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, g, g, p, p, C)
    return x.reshape(B, g * g, cfg.patch_dim)


def _layer_apply(layer: Params, x: torch.Tensor, cfg: ViTConfig,
                 mesh: Optional[Any] = None) -> torch.Tensor:
    """One encoder block on the residual stream — shared by
    :func:`forward` and :func:`forward_pp`."""
    from ddl_tpu_torch.parallel.ring_attention import attention

    B, T = x.shape[:2]
    dt = x.dtype
    h = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    shape = (B, T, cfg.n_heads, cfg.head_dim)
    q = (h @ layer["wq"].to(dt)).reshape(shape)
    k = (h @ layer["wk"].to(dt)).reshape(shape)
    v = (h @ layer["wv"].to(dt)).reshape(shape)
    attn = attention(q.contiguous(), k.contiguous(), v.contiguous(),
                     impl=cfg.attn_impl, causal=False, mesh=mesh)
    x = x + attn.reshape(B, T, -1) @ layer["wo"].to(dt)
    h = _rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    up = F.gelu(h @ layer["w_up"].to(dt), approximate="tanh")
    return x + up @ layer["w_down"].to(dt)


def _embed(params: Params, images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Patchify + project + position-embed (shared by both forwards).
    Images come as (B, H, W, C) or as the loader's flat pixel rows."""
    dt = cfg.dtype
    if images.dim() == 2:
        images = images.reshape(-1, cfg.image_size, cfg.image_size,
                                cfg.n_channels)
    x = patchify(images.to(dt), cfg) @ params["patch_embed"].to(dt)
    return x + params["pos_embed"].to(dt)[None]


def _head(params: Params, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Final norm + mean pool + classification head, the head's product in
    fp32."""
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    pooled = x.float().mean(1)  # (B, d)
    return pooled @ params["head"]


def forward(params: Params, images: torch.Tensor, cfg: ViTConfig,
            mesh: Optional[Any] = None) -> torch.Tensor:
    """Class logits (B, n_classes); images (B, H, W, C) or flat
    (B, H*W*C)."""
    x = _embed(params, images, cfg)
    for layer in params["layers"]:
        x = _layer_apply(layer, x, cfg, mesh=mesh)
    return _head(params, x, cfg)


# -- pipeline parallelism ----------------------------------------------------


def stage_params(params: Params, n_stages: int) -> Params:
    """Regroup an :func:`init_params` tree for pipeline parallelism (the
    ``(S, L/S)`` stage layout of ``parallel.pipeline.stack_layer_stages``);
    the embeddings and the head stay outside the pipe."""
    from ddl_tpu_torch.parallel.pipeline import stack_layer_stages

    return {
        "patch_embed": params["patch_embed"],
        "pos_embed": params["pos_embed"],
        "stages": stack_layer_stages(params["layers"], n_stages),
        "final_norm": params["final_norm"],
        "head": params["head"],
    }


def pp_param_specs(cfg: ViTConfig, axis: str = "pp") -> Params:
    """PartitionSpecs for the :func:`stage_params` layout."""
    from ddl_tpu_torch.parallel.mesh import P
    from ddl_tpu_torch.parallel.pipeline import stage_spec_tree

    return {
        "patch_embed": P(None, "fsdp"),
        "pos_embed": P(None, "fsdp"),
        "stages": stage_spec_tree(param_specs(cfg)["layers"][0], axis),
        "final_norm": P(None),
        "head": P("fsdp", None),
    }


def forward_pp(params: Params, images: torch.Tensor, cfg: ViTConfig,
               mesh: Any, n_microbatches: int, axis: str = "pp",
               metrics: Any = None) -> torch.Tensor:
    """Class logits with the encoder blocks pipelined over ``axis`` (the
    GPipe schedule of ``parallel.pipeline.pipeline_apply``); attention
    inside a stage runs on one position."""
    from ddl_tpu_torch.parallel.pipeline import pipeline_apply

    x = _embed(params, images, cfg)

    def stage_fn(stage: Params, h: torch.Tensor) -> torch.Tensor:
        for i in range(stage["wq"].shape[0]):
            h = _layer_apply({k: v[i] for k, v in stage.items()}, h, cfg)
        return h

    local = mesh.local() if mesh is not None else None
    x = pipeline_apply(params["stages"], x, stage_fn, local, n_microbatches,
                       axis=axis, metrics=metrics)
    return _head(params, x, cfg)


def classification_loss(params: Params, batch: Any, cfg: ViTConfig,
                        mesh: Optional[Any] = None) -> torch.Tensor:
    """Mean cross-entropy over the loader's ``(pixels, label)`` columns."""
    from ddl_tpu_torch.models.losses import cross_entropy

    pixels, labels = batch[0], batch[1]
    return cross_entropy(forward(params, pixels, cfg, mesh), labels.reshape(-1))


def classification_loss_pp(params: Params, batch: Any, cfg: ViTConfig,
                           mesh: Any, n_microbatches: int, axis: str = "pp",
                           metrics: Any = None) -> torch.Tensor:
    """:func:`classification_loss` over the pipelined forward."""
    from ddl_tpu_torch.models.losses import cross_entropy

    pixels, labels = batch[0], batch[1]
    logits = forward_pp(params, pixels, cfg, mesh, n_microbatches, axis=axis,
                        metrics=metrics)
    return cross_entropy(logits, labels.reshape(-1))


def accuracy(params: Params, batch: Any, cfg: ViTConfig,
             mesh: Optional[Any] = None) -> torch.Tensor:
    """Share of rows whose arg-max class is the label."""
    pixels, labels = batch[0], batch[1]
    pred = forward(params, pixels, cfg, mesh).argmax(-1)
    return (pred == labels.reshape(-1).long()).float().mean()
