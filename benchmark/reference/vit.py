"""Plain float32 reference of the image family (ViT-B/16's widths in the
block the port's ``models.vit`` computes, which departs from the paper as
the configuration lists): patches cut from (H, W, C) pixel rows and
projected by one matrix, learned position embeddings, pre-norm blocks of
RMSNorm with a gain, non-causal multi-head attention and a tanh-GELU MLP,
no biases, a final RMSNorm, mean pooling over the patches, a float32
head, and the mean cross-entropy over the rows.

Configuration keys are the source's (``hidden_size``, ``patch_size``,
...).  Weights are ``(in, out)`` matrices applied as ``x @ W``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from benchmark.reference.common import matmul


def _dims(cfg: Dict[str, Any]):
    side, p, c = cfg["image_size"], cfg["patch_size"], cfg["num_channels"]
    return side, p, c, (side // p) ** 2, p * p * c


def leaf_specs(cfg: Dict[str, Any]) -> List[tuple]:
    """The params tree's leaves (path, shape, init), in the port's order."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    _, _, _, n_patches, patch_dim = _dims(cfg)
    specs = [(("patch_embed",), (patch_dim, d),
              ("normal", 1 / math.sqrt(patch_dim))),
             (("pos_embed",), (n_patches, d), ("normal", 0.02))]
    for i in range(cfg["num_hidden_layers"]):
        for name, shape in (("attn_norm", (d,)), ("wq", (d, d)),
                            ("wk", (d, d)), ("wv", (d, d)), ("wo", (d, d)),
                            ("mlp_norm", (d,)), ("w_up", (d, ff)),
                            ("w_down", (ff, d))):
            init = (("ones",) if len(shape) == 1
                    else ("normal", 1 / math.sqrt(shape[0])))
            specs.append((("layers", i, name), shape, init))
    specs.append((("final_norm",), (d,), ("ones",)))
    specs.append((("head",), (d, cfg["num_labels"]),
                  ("normal", 1 / math.sqrt(d))))
    return specs


def _rms(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * gain


def block_rows(cfg: Dict[str, Any], traffic: Dict[str, Any]) -> int:
    return 64


def block_loss(params: Dict[str, Any], rows: torch.Tensor,
               cfg: Dict[str, Any], traffic: Dict[str, Any],
               prec: str) -> torch.Tensor:
    """Summed cross-entropy of ``rows`` (B, pixels + 1), the label last."""
    side, p, c, n_patches, patch_dim = _dims(cfg)
    eps, H = cfg["norm_eps"], cfg["num_attention_heads"]
    B, g = rows.shape[0], side // p
    d = cfg["hidden_size"]
    hd = d // H
    px = rows[:, :-1].reshape(B, g, p, g, p, c).permute(0, 1, 3, 2, 4, 5)
    x = matmul(px.reshape(B, n_patches, patch_dim), params["patch_embed"], prec)
    x = x + params["pos_embed"][None]
    for layer in params["layers"]:
        h = _rms(x, layer["attn_norm"], eps)
        q, k, v = (matmul(h, layer[w], prec).reshape(B, n_patches, H, hd)
                   .transpose(1, 2) for w in ("wq", "wk", "wv"))
        s = matmul(q, k.transpose(-1, -2), prec) / math.sqrt(hd)
        o = matmul(torch.softmax(s, dim=-1), v, prec)
        x = x + matmul(o.transpose(1, 2).reshape(B, n_patches, d),
                       layer["wo"], prec)
        h = _rms(x, layer["mlp_norm"], eps)
        up = torch.nn.functional.gelu(matmul(h, layer["w_up"], prec),
                                      approximate="tanh")
        x = x + matmul(up, layer["w_down"], prec)
    pooled = _rms(x, params["final_norm"], eps).mean(1)
    logits = matmul(pooled, params["head"], prec)
    labels = rows[:, -1].long()
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, labels[:, None])[:, 0]
    return nll.sum()


def batch_count(rows: torch.Tensor, cfg: Dict[str, Any],
                traffic: Dict[str, Any]) -> float:
    return float(rows.shape[0])

