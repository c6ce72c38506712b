"""Llama-style decoder LM (port of ``ddl_tpu/models/llama.py``'s training
path: config, init, forward and the next-token loss).

Plain functions over an explicit parameter dict with the JAX package's
layout — ``{"embed", "layers": [{...}], "final_norm", "lm_head"}``,
weights ``(in, out)`` applied as ``x @ W`` — so weights carry across as a
copy (:func:`params_from_numpy`), never a transpose.  Parameters are
stored in ``cfg.param_dtype`` (fp32) and cast to ``cfg.dtype`` at each
use; RMSNorm accumulates in fp32; RoPE, grouped-query attention and
SwiGLU make the Llama-3 block.  Packed-document batches pass
``segment_ids`` (attention stays within each document; RoPE positions
stay row-global, the JAX package's convention), and ``cfg.remat`` picks
the named remat policy around each layer (:mod:`.remat`).
Decode/generate and pipeline/tensor parallelism are later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 256
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 352
    max_seq: int = 512
    rope_theta: float = 500000.0  # Llama-3 base frequency
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    #: Storage dtype of the params (fp32 master weights).
    param_dtype: Any = torch.float32
    #: Rematerialisation policy for the backward pass
    #: (:mod:`ddl_tpu_torch.models.remat`): "none" | "full" | "selective"
    #: | "dots"; bools accepted (True == "full", False == "none").
    remat: Any = False
    #: "auto": the flash kernels on CUDA, dense elsewhere; "flash" /
    #: "dense" force one path.
    attn_impl: str = "auto"

    def __post_init__(self) -> None:
        if self.attn_impl not in ("auto", "flash", "dense"):
            raise ValueError(
                f"attn_impl must be 'auto', 'flash', or 'dense', "
                f"got {self.attn_impl!r}"
            )
        from ddl_tpu_torch.models import remat as _remat

        _remat.resolve(self.remat)  # fail on junk at config build time

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        """Llama-3-8B's published widths."""
        return LlamaConfig(
            vocab=128256, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14336, max_seq=8192,
        )


def _layer_shapes(cfg: LlamaConfig) -> Dict[str, tuple]:
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": (d, cfg.n_heads * hd),
        "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, d),
        "w_gate": (d, cfg.d_ff),
        "w_up": (d, cfg.d_ff),
        "w_down": (cfg.d_ff, d),
    }


def init_params(cfg: LlamaConfig, seed: int = 0, device: Any = "cuda") -> Params:
    """Initialise a params dict: ``1/sqrt(fan_in)``-scaled normal weights
    and unit norms, in ``cfg.param_dtype``, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the JAX
    package's distributions; not its random numbers)."""
    from ddl_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pdt = cfg.param_dtype

    def dense(shape):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w / float(np.sqrt(shape[0]))).to(pdt)

    d = cfg.d_model
    layers = []
    for _ in range(cfg.n_layers):
        layer = {"attn_norm": torch.ones(d, device=dev, dtype=pdt)}
        for name, shape in _layer_shapes(cfg).items():
            if name == "w_gate":
                layer["mlp_norm"] = torch.ones(d, device=dev, dtype=pdt)
            layer[name] = dense(shape)
        layers.append(layer)
    embed = torch.randn((cfg.vocab, d), generator=gen, device=dev)
    return {
        "embed": (embed / float(np.sqrt(d))).to(pdt),
        "layers": layers,
        "final_norm": torch.ones(d, device=dev, dtype=pdt),
        "lm_head": dense((d, cfg.vocab)),
    }


def params_from_numpy(tree: Any, device: Any = "cuda") -> Params:
    """The port's params from the JAX package's ``init_params`` tree
    given as numpy arrays (any array-like leaf): the same nested
    dict/list layout, each leaf copied to ``device`` at its dtype."""
    from ddl_tpu_torch.utils import resolve_device

    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(tree)


def _rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale * gain).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding; x: (B, T, H, D), positions: (T,)."""
    d_half = x.shape[-1] // 2
    freqs = theta ** (
        -torch.arange(0, d_half, dtype=torch.float32, device=x.device) / d_half
    )
    angles = positions[:, None].float() * freqs[None, :]  # (T, Dh)
    cos = torch.cos(angles)[None, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :d_half], x[..., d_half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attn_qkv(layer: Params, h: torch.Tensor, cfg: LlamaConfig,
              positions: torch.Tensor):
    """Project + rope one block's q/k/v."""
    B, T = h.shape[:2]
    dt = h.dtype
    q = (h @ layer["wq"].to(dt)).reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = (h @ layer["wk"].to(dt)).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ layer["wv"].to(dt)).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    return (
        _rope(q, positions, cfg.rope_theta),
        _rope(k, positions, cfg.rope_theta),
        v,
    )


def _attn_block(layer: Params, x: torch.Tensor, cfg: LlamaConfig,
                positions: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention sub-block (norm → qkv/rope → attention → wo residual).
    GQA k/v stay compact: the kernels expand them per query-head group.
    The attention call is the piece remat="selective" keeps."""
    from ddl_tpu_torch.models import remat as _remat
    from ddl_tpu_torch.parallel.ring_attention import attention

    B, T = x.shape[:2]
    dt = x.dtype
    h = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q, k, v = _attn_qkv(layer, h, cfg, positions)
    attn = _remat.keep(
        attention, q.contiguous(), k.contiguous(), v.contiguous(),
        impl=cfg.attn_impl, causal=True,
        kv_repeat=cfg.n_heads // cfg.n_kv_heads, segment_ids=segment_ids,
    )
    return x + attn.reshape(B, T, -1) @ layer["wo"].to(dt)


def _swiglu(layer: Params, h: torch.Tensor) -> torch.Tensor:
    dt = h.dtype
    gate = torch.nn.functional.silu(h @ layer["w_gate"].to(dt))
    up = h @ layer["w_up"].to(dt)
    return (gate * up) @ layer["w_down"].to(dt)


def _mlp_block(layer: Params, x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """SwiGLU MLP sub-block with residual."""
    return x + _swiglu(layer, _rms_norm(x, layer["mlp_norm"], cfg.norm_eps))


def _layer_apply(layer: Params, x: torch.Tensor, cfg: LlamaConfig,
                 positions: torch.Tensor,
                 segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One transformer block on the residual stream."""
    x = _attn_block(layer, x, cfg, positions, segment_ids)
    return _mlp_block(layer, x, cfg)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token logits, (B, T, vocab) fp32.

    ``segment_ids`` (B, T): packed-pretraining batches — attention stays
    within each packed document; RoPE positions remain row-global.  The
    ids may come as any integer view (the trainer hands each column as a
    strided view of the window); they become one contiguous int32 tensor
    here, once for all layers.
    """
    from ddl_tpu_torch.models import remat as _remat

    T = tokens.shape[1]
    dt = cfg.dtype
    positions = torch.arange(T, device=tokens.device)
    seg = (None if segment_ids is None
           else segment_ids.to(torch.int32).contiguous())
    # Gather, then cast: the same values as the JAX package's
    # cast-then-gather, without a full-vocab cast per step.
    x = params["embed"][tokens.long()].to(dt)  # (B, T, D)

    def layer_fn(x: torch.Tensor, layer: Params) -> torch.Tensor:
        return _layer_apply(layer, x, cfg, positions, seg)

    layer_fn = _remat.wrap(layer_fn, cfg.remat)
    for layer in params["layers"]:
        x = layer_fn(x, layer)
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"].to(dt)).float()


def next_token_loss(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                    segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy of next-token prediction over (B, T) tokens.
    With ``segment_ids`` (packed batches) attention is segment-masked and
    the loss also drops the positions whose next token belongs to another
    document."""
    from ddl_tpu_torch.models.losses import next_token_cross_entropy

    logits = forward(params, tokens, cfg, segment_ids=segment_ids)
    return next_token_cross_entropy(logits, tokens, segment_ids=segment_ids)


def param_count(cfg: LlamaConfig) -> int:
    """Number of parameters ``init_params`` builds for ``cfg``."""
    per_layer = 2 * cfg.d_model + sum(
        int(np.prod(s)) for s in _layer_shapes(cfg).values()
    )
    return (
        cfg.n_layers * per_layer + 2 * cfg.vocab * cfg.d_model + cfg.d_model
    )
