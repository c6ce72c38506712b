"""Plain float32 reference of the decoder family (Mistral-7B's block as the
port's ``models.llama`` computes it): RMSNorm with a gain, rotary
embedding on split halves, grouped-query causal attention (query head
``h`` reads key/value head ``h // (heads / kv_heads)``), SwiGLU, an
untied head, and the mean next-token cross-entropy over every position
but each row's last.  The sliding window is not applied: the cells keep
T <= the window.

Configuration keys are the source's (``hidden_size``,
``num_attention_heads``, ...).  Weights are ``(in, out)`` matrices applied
as ``x @ W``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from benchmark.reference.common import matmul


def leaf_specs(cfg: Dict[str, Any]) -> List[tuple]:
    """The params tree's leaves (path, shape, init), in the port's order."""
    d, ff, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    hd = d // cfg["num_attention_heads"]
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    specs = [(("embed",), (v, d), ("normal", 1 / math.sqrt(d)))]
    for i in range(cfg["num_hidden_layers"]):
        for name, shape in (("attn_norm", (d,)), ("wq", (d, q)),
                            ("wk", (d, kv)), ("wv", (d, kv)), ("wo", (q, d)),
                            ("mlp_norm", (d,)), ("w_gate", (d, ff)),
                            ("w_up", (d, ff)), ("w_down", (ff, d))):
            init = (("ones",) if len(shape) == 1
                    else ("normal", 1 / math.sqrt(shape[0])))
            specs.append((("layers", i, name), shape, init))
    specs.append((("final_norm",), (d,), ("ones",)))
    specs.append((("lm_head",), (d, v), ("normal", 1 / math.sqrt(d))))
    return specs


def _rms(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * gain


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, T, H, D); positions 0..T-1 of each row."""
    T, D = x.shape[1], x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64) / half)
    ang = torch.arange(T, dtype=torch.float64)[:, None] * freqs[None, :]
    cos = torch.cos(ang).to(x)[None, :, None, :]
    sin = torch.sin(ang).to(x)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, prec: str) -> torch.Tensor:
    """q (B, T, H, D), k/v (B, T, Hkv, D) -> (B, T, H*D), causal."""
    B, T, H, D = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, T, D)
    s = matmul(q, k.transpose(-1, -2), prec) / math.sqrt(D)
    keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~keep, float("-inf"))
    o = matmul(torch.softmax(s, dim=-1), v, prec)
    return o.transpose(1, 2).reshape(B, T, H * D)


def _mask(tokens: torch.Tensor) -> torch.Tensor:
    """Every position but each row's last has a next token."""
    T = tokens.shape[1]
    return (torch.arange(T, device=tokens.device) < T - 1)[None].expand_as(tokens)


def block_rows(cfg: Dict[str, Any], traffic: Dict[str, Any]) -> int:
    """Rows a block: one 4096-token row's float32 attention scores take
    2 GiB a layer at 32 heads."""
    return max(1, 4096 // int(traffic["seq_len"]))


def block_loss(params: Dict[str, Any], rows: torch.Tensor,
               cfg: Dict[str, Any], traffic: Dict[str, Any],
               prec: str) -> torch.Tensor:
    """Summed next-token loss of ``rows`` (B, T) int ids."""
    tokens = rows.long()
    eps = cfg["rms_norm_eps"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    B, T = tokens.shape
    hd = cfg["hidden_size"] // H
    x = params["embed"][tokens]
    for layer in params["layers"]:
        h = _rms(x, layer["attn_norm"], eps)
        q = _rope(matmul(h, layer["wq"], prec).reshape(B, T, H, hd),
                  cfg["rope_theta"])
        k = _rope(matmul(h, layer["wk"], prec).reshape(B, T, Hkv, hd),
                  cfg["rope_theta"])
        v = matmul(h, layer["wv"], prec).reshape(B, T, Hkv, hd)
        x = x + matmul(_attention(q, k, v, prec), layer["wo"], prec)
        h = _rms(x, layer["mlp_norm"], eps)
        gate = torch.nn.functional.silu(matmul(h, layer["w_gate"], prec))
        x = x + matmul(gate * matmul(h, layer["w_up"], prec),
                       layer["w_down"], prec)
    logits = matmul(_rms(x, params["final_norm"], eps), params["lm_head"], prec)
    target = torch.roll(tokens, -1, dims=1)
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, target[..., None])[..., 0]
    return (nll * _mask(tokens)).sum()


def batch_count(rows: torch.Tensor, cfg: Dict[str, Any],
                traffic: Dict[str, Any]) -> float:
    """The count the batch's loss is a mean over."""
    return float(_mask(rows).sum())

