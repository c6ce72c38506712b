"""The image family on the port: ``ddl_tpu_torch.models.vit`` with the
configuration's widths, bfloat16 compute over float32 master weights."""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from benchmark import flops


def _patches(cfg: Dict[str, Any]) -> Tuple[int, int]:
    p = cfg["patch_size"]
    return (cfg["image_size"] // p) ** 2, p * p * cfg["num_channels"]


def program_config(cfg: Dict[str, Any], traffic: Dict[str, Any]) -> Any:
    from ddl_tpu_torch.models.vit import ViTConfig

    return ViTConfig(
        image_size=cfg["image_size"], patch_size=cfg["patch_size"],
        n_channels=cfg["num_channels"], d_model=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"], n_heads=cfg["num_attention_heads"],
        d_ff=cfg["intermediate_size"], n_classes=cfg["num_labels"],
        norm_eps=cfg["norm_eps"], dtype=getattr(torch, cfg["compute_dtype"]),
    )


def loss_fn(pcfg: Any, traffic: Dict[str, Any]) -> Callable[[Any, Any], Any]:
    from ddl_tpu_torch.models import vit

    return lambda p, b: vit.classification_loss(p, b, pcfg)


def items_per_step(traffic: Dict[str, Any]) -> Tuple[str, int]:
    return "images", int(traffic["batch_size"])


def step_flops(cfg: Dict[str, Any], traffic: Dict[str, Any]) -> float:
    n_patches, patch_dim = _patches(cfg)
    return int(traffic["batch_size"]) * flops.encoder_flops_per_image(
        cfg["hidden_size"], cfg["num_attention_heads"],
        cfg["intermediate_size"], cfg["num_hidden_layers"], n_patches,
        patch_dim, cfg["num_labels"])


def attention(cfg: Dict[str, Any], traffic: Dict[str, Any]) -> Dict[str, Any]:
    """One step's attention calls: their shape and count."""
    heads = cfg["num_attention_heads"]
    return dict(batch=int(traffic["batch_size"]), seq=_patches(cfg)[0],
                heads=heads, kv_heads=heads,
                head_dim=cfg["hidden_size"] // heads, causal=False,
                calls=cfg["num_hidden_layers"])
