"""Llama-style decoder LM (port of ``ddl_tpu/models/llama.py``: config,
init, forward, the next-token loss, and KV-cache decode and generation).

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

Decode (:func:`init_cache`, :func:`forward_with_cache`, :func:`generate`)
keeps a static-length stacked cache ``(L, B, len, kv, hd)`` updated in
place, and attends it densely with grouped einsums — decode steps are
matmul-thin, and the JAX package computes them outside any kernel too.

Over a mesh (``forward(..., mesh=)``, :func:`param_specs`) the model
still runs on global tensors; only attention names mesh positions (ring
attention over ``sp``, batch/head-sharded attention otherwise), as
GSPMD leaves the rest to the compiler in the JAX package.

The pipeline path (:func:`stage_params`, :func:`pp_param_specs`,
:func:`forward_pp`, :func:`next_token_loss_pp`) runs the blocks through
:func:`ddl_tpu_torch.parallel.pipeline.pipeline_apply` over a ``pp``
axis; with a ``tp`` axis whose size divides the head counts and
``d_ff``, the stages run tensor-parallel resident: each tp position
computes its ``n_heads/tp`` heads and ``d_ff/tp`` hidden units on its
column and row blocks, and the two partial products a layer are summed
over the positions (:func:`ddl_tpu_torch.parallel.collectives.psum`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

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

    @staticmethod
    def llama_4b() -> "LlamaConfig":
        """~4.6B params at the 8B config's layer shape (20 layers, a
        32768 vocab): the JAX package's ZeRO-1 accounting geometry."""
        return LlamaConfig(
            vocab=32768, d_model=4096, n_layers=20, n_heads=32,
            n_kv_heads=8, d_ff=14336, max_seq=4096,
        )

    @staticmethod
    def tiny() -> "LlamaConfig":
        return LlamaConfig()


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


def param_shapes(cfg: LlamaConfig) -> Params:
    """The params tree of :func:`init_params` as ``meta`` tensors (shape
    and dtype, no storage): the zero-FLOP input of
    :func:`ddl_tpu_torch.parallel.optimizer.hbm_accounting`."""
    def meta(shape):
        return torch.empty(shape, dtype=cfg.param_dtype, device="meta")

    d = cfg.d_model
    layers = []
    for _ in range(cfg.n_layers):
        layer = {"attn_norm": meta((d,))}
        for name, shape in _layer_shapes(cfg).items():
            if name == "w_gate":
                layer["mlp_norm"] = meta((d,))
            layer[name] = meta(shape)
        layers.append(layer)
    return {"embed": meta((cfg.vocab, d)), "layers": layers,
            "final_norm": meta((d,)), "lm_head": meta((d, cfg.vocab))}


def param_specs(cfg: LlamaConfig) -> Params:
    """PartitionSpecs mirroring :func:`init_params`: fsdp shards the
    d_model-ish axis, tp shards heads / ffn-hidden (the JAX package's
    Megatron layout).  On one card the specs place the sharded
    optimizer's state (:mod:`ddl_tpu_torch.parallel.optimizer`); the
    weights themselves stay whole."""
    from ddl_tpu_torch.parallel.mesh import P

    layer = {
        "attn_norm": P(None),
        "wq": P("fsdp", "tp"),
        "wk": P("fsdp", "tp"),
        "wv": P("fsdp", "tp"),
        "wo": P("tp", "fsdp"),
        "mlp_norm": P(None),
        "w_gate": P("fsdp", "tp"),
        "w_up": P("fsdp", "tp"),
        "w_down": P("tp", "fsdp"),
    }
    return {
        "embed": P(None, "fsdp"),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
        "final_norm": P(None),
        "lm_head": P("fsdp", "tp"),
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
              positions: torch.Tensor, n_heads: Optional[int] = None,
              n_kv_heads: Optional[int] = None):
    """Project + rope one block's q/k/v (shared by train, decode and the
    tp-resident pipeline stage, which passes its LOCAL head counts:
    column blocks of the projections are contiguous head blocks)."""
    B, T = h.shape[:2]
    dt = h.dtype
    nh = cfg.n_heads if n_heads is None else n_heads
    nkv = cfg.n_kv_heads if n_kv_heads is None else n_kv_heads
    q = (h @ layer["wq"].to(dt)).reshape(B, T, nh, cfg.head_dim)
    k = (h @ layer["wk"].to(dt)).reshape(B, T, nkv, cfg.head_dim)
    v = (h @ layer["wv"].to(dt)).reshape(B, T, nkv, cfg.head_dim)
    return (
        _rope(q, positions, cfg.rope_theta),
        _rope(k, positions, cfg.rope_theta),
        v,
    )


def _attn_block(layer: Params, x: torch.Tensor, cfg: LlamaConfig,
                positions: torch.Tensor, mesh: Optional[Any] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention sub-block (norm → qkv/rope → attention → wo residual).
    GQA k/v stay compact: the kernels expand them per query-head group,
    and the ring rotates them unexpanded.  The attention call is the
    piece remat="selective" keeps."""
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
        mesh=mesh,
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
                 positions: torch.Tensor, mesh: Optional[Any] = None,
                 segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One transformer block on the residual stream."""
    x = _attn_block(layer, x, cfg, positions, mesh=mesh,
                    segment_ids=segment_ids)
    return _mlp_block(layer, x, cfg)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            mesh: Optional[Any] = None,
            segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token logits, (B, T, vocab) fp32.

    With a mesh carrying an ``sp`` axis of size > 1, attention runs as
    ring attention over the ``sp`` positions; any other mesh shards it
    over batch and heads.  RoPE positions are global either way (the
    token axis is only cut, never re-indexed).

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
        return _layer_apply(layer, x, cfg, positions, mesh=mesh,
                            segment_ids=seg)

    layer_fn = _remat.wrap(layer_fn, cfg.remat)
    for layer in params["layers"]:
        x = layer_fn(x, layer)
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"].to(dt)).float()


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               device: Any = "cuda") -> Params:
    """Stacked KV cache buffers ``(n_layers, batch, max_len, n_kv_heads,
    head_dim)`` in ``cfg.dtype`` for autoregressive decoding."""
    from ddl_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
    }


def forward_with_cache(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                       cache: Params, pos: int, last_only: bool = False,
                       ) -> Tuple[torch.Tensor, Params]:
    """Process ``tokens`` (B, T) starting at position ``pos`` against a KV
    cache (prefill: T = prompt length at pos 0; decode: T = 1).

    Returns (logits, cache): logits (B, T, vocab) fp32, or (B, 1, vocab)
    with ``last_only`` (prefill needs only the frontier).  Each layer
    writes its new keys and values into the stacked buffers in place at
    ``(li, :, pos)``; attention is dense over the cache with a
    causal-position mask, on the compact GQA cache (q regrouped per KV
    head, no rep-expanded copy)."""
    dt = cfg.dtype
    T = tokens.shape[1]
    positions = pos + torch.arange(T, device=tokens.device)
    cache_idx = torch.arange(cache["k"].shape[2], device=tokens.device)
    x = params["embed"][tokens.long()].to(dt)
    for li, layer in enumerate(params["layers"]):
        x = _attn_with_cache(layer, x, cfg, cache["k"], cache["v"], li, pos,
                             positions, cache_idx)
        x = _mlp_block(layer, x, cfg)
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return (x @ params["lm_head"].to(dt)).float(), cache


def _attn_with_cache(layer: Params, x: torch.Tensor, cfg: LlamaConfig,
                     k_all: torch.Tensor, v_all: torch.Tensor, li: int,
                     pos: int, positions: torch.Tensor,
                     cache_idx: torch.Tensor) -> torch.Tensor:
    """Attention sub-block (norm → qkv → cache update → GQA attention →
    residual) against the stacked cache; returns x after attention."""
    B, T = x.shape[:2]
    dt = x.dtype
    rep = cfg.n_heads // cfg.n_kv_heads
    scale = 1.0 / (cfg.head_dim ** 0.5)
    h = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q, k, v = _attn_qkv(layer, h, cfg, positions)
    k_all[li, :, pos:pos + T] = k.to(dt)
    v_all[li, :, pos:pos + T] = v.to(dt)
    ck, cv = k_all[li], v_all[li]
    qg = q.reshape(B, T, cfg.n_kv_heads, rep, cfg.head_dim)
    s = torch.einsum("bqkrd,bskd->bkrqs", qg, ck) * scale
    # Causal over absolute positions; slots past the frontier (zeros) are
    # masked the same way.
    mask = cache_idx[None, :] > positions[:, None]  # (T, L)
    s = torch.where(mask[None, None, None], torch.full((), -1e30, dtype=s.dtype,
                                                       device=s.device), s)
    p = torch.softmax(s.float(), dim=-1).to(dt)
    attn = torch.einsum("bkrqs,bskd->bqkrd", p, cv)
    return x + attn.reshape(B, T, -1) @ layer["wo"].to(dt)


def generate(params: Params, prompt: torch.Tensor, cfg: LlamaConfig,
             max_new_tokens: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             eos_id: Optional[int] = None) -> torch.Tensor:
    """Autoregressive generation: greedy (``temperature == 0``) or
    temperature sampling, optionally filtered by ``top_k`` and/or nucleus
    ``top_p`` (temperature first, then the filters).  With ``eos_id``, a
    row that emits it keeps emitting ``eos_id`` (truncate at the first
    EOS).  Returns (B, prompt_len + max_new_tokens).

    Sampling requires an explicit ``generator`` (a ``torch.Generator`` on
    the prompt's device), where the JAX package requires a ``key``: a
    silent default would sample the same tokens on every call.

    Prefill is one cached forward over the prompt; decode is a loop of
    ``T = 1`` cached forwards over the static-length cache, all under
    ``torch.no_grad()``."""
    return _generate(forward_with_cache, init_cache, params, prompt, cfg,
                     max_new_tokens, temperature, generator, top_k=top_k,
                     top_p=top_p, eos_id=eos_id)


def _sample_filter(logits_t: torch.Tensor, top_k: Optional[int],
                   top_p: Optional[float]) -> torch.Tensor:
    """Mask logits for top-k / nucleus (top-p) sampling.  top-k keeps the
    k highest logits; top-p keeps the smallest prefix of the
    probability-sorted vocab whose mass reaches ``top_p`` (the first token
    always kept).  Both compose, in that order."""
    ninf = torch.full((), float("-inf"), dtype=logits_t.dtype,
                      device=logits_t.device)
    if top_k is not None:
        kth = torch.topk(logits_t, top_k, dim=-1).values[..., -1:]
        logits_t = torch.where(logits_t < kth, ninf, logits_t)
    if top_p is not None:
        sorted_logits = torch.sort(logits_t, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # Keep ranks whose PRECEDING mass is < top_p (rank 0 always).
        keep_sorted = torch.cat(
            [torch.ones_like(cum[..., :1], dtype=torch.bool),
             cum[..., :-1] < top_p], dim=-1)
        cutoff = torch.where(keep_sorted, sorted_logits,
                             torch.full((), float("inf"), dtype=logits_t.dtype,
                                        device=logits_t.device)
                             ).min(dim=-1, keepdim=True).values
        logits_t = torch.where(logits_t < cutoff, ninf, logits_t)
    return logits_t


@torch.no_grad()
def _generate(fwd_cache: Any, init_cache_fn: Any, params: Params,
              prompt: torch.Tensor, cfg: Any, max_new_tokens: int,
              temperature: float, generator: Optional[torch.Generator],
              top_k: Optional[int] = None, top_p: Optional[float] = None,
              eos_id: Optional[int] = None) -> torch.Tensor:
    """Family-agnostic generation core: prefill via one cached forward,
    then ``T = 1`` decode steps over a static-length cache.
    ``fwd_cache(params, tokens, cfg, cache, pos, last_only=...)`` and
    ``init_cache_fn(cfg, B, L, device)`` are the family's hooks."""
    if (top_k is not None or top_p is not None) and temperature <= 0.0:
        raise ValueError(
            "top_k/top_p filter the SAMPLING distribution — they have "
            "no effect on greedy decoding; pass temperature > 0"
        )
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if eos_id is not None and not 0 <= eos_id < cfg.vocab:
        raise ValueError(
            f"eos_id {eos_id} outside the model vocab [0, {cfg.vocab})"
        )
    B, P_len = prompt.shape
    if max_new_tokens <= 0:
        return prompt
    total = P_len + max_new_tokens
    cache = init_cache_fn(cfg, B, total, prompt.device)
    logits, cache = fwd_cache(params, prompt, cfg, cache, 0, last_only=True)
    last = logits[:, -1]
    if generator is None and temperature > 0.0:
        raise ValueError(
            "temperature sampling requires an explicit generator: pass "
            "generator=torch.Generator(device).manual_seed(seed) (every "
            "call with a default would sample the SAME tokens)"
        )

    def pick(logits_t: torch.Tensor) -> torch.Tensor:
        if temperature <= 0.0:
            return torch.argmax(logits_t, dim=-1).to(prompt.dtype)
        filtered = _sample_filter(logits_t / temperature, top_k, top_p)
        probs = torch.softmax(filtered, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            prompt.dtype)

    eos = (None if eos_id is None
           else torch.full((B,), eos_id, dtype=prompt.dtype,
                           device=prompt.device))
    done = torch.zeros(B, dtype=torch.bool, device=prompt.device)
    new = []
    for pos in range(P_len, total - 1):
        tok = pick(last)
        if eos is not None:
            tok = torch.where(done, eos, tok)
            done = done | (tok == eos_id)
        new.append(tok)
        logits_t, cache = fwd_cache(params, tok[:, None], cfg, cache, pos)
        last = logits_t[:, 0]
    final = pick(last)
    if eos is not None:
        final = torch.where(done, eos, final)
    new.append(final)
    return torch.cat([prompt, torch.stack(new, dim=1)], dim=1)


def next_token_loss(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                    mesh: Optional[Any] = None,
                    segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy of next-token prediction over (B, T) tokens.
    Targets are ``roll(tokens, -1)`` with the final position masked, so
    the sequence axis keeps its full length and stays divisible by
    ``sp``.  With ``segment_ids`` (packed batches) attention is
    segment-masked and the loss also drops the positions whose next token
    belongs to another document."""
    from ddl_tpu_torch.models.losses import next_token_cross_entropy

    logits = forward(params, tokens, cfg, mesh, segment_ids=segment_ids)
    return next_token_cross_entropy(logits, tokens, segment_ids=segment_ids)


# -- pipeline parallelism ----------------------------------------------------


def stage_params(params: Params, n_stages: int, n_chunks: int = 1) -> Params:
    """Rearrange an :func:`init_params` tree for pipeline parallelism: the
    ``n_layers`` per-layer dicts regroup into ``n_stages`` equal stages
    stacked into ``(S, L/S, ...)`` leaves (``(S, V, L/(S·V), ...)`` with
    ``n_chunks = V > 1``, for ``schedule="1f1b"``: position d chunk c holds
    global stage c·S+d).  Embedding, final norm and lm head stay outside
    the pipe.  Training checkpoints save THIS layout; the non-pp layout is
    only an initialization convenience."""
    from ddl_tpu_torch.parallel.pipeline import stack_layer_stages

    return {
        "embed": params["embed"],
        "stages": stack_layer_stages(params["layers"], n_stages,
                                     n_chunks=n_chunks),
        "final_norm": params["final_norm"],
        "lm_head": params["lm_head"],
    }


def pp_param_specs(cfg: LlamaConfig, axis: str = "pp",
                   n_chunks: int = 1) -> Params:
    """PartitionSpecs for the :func:`stage_params` layout: ``axis`` shards
    the stage axis, the chunk (1f1b only) and per-stage layer axes are
    unsharded, and the trailing axes keep :func:`param_specs`' Megatron
    layout."""
    from ddl_tpu_torch.parallel.mesh import P
    from ddl_tpu_torch.parallel.pipeline import stage_spec_tree

    return {
        "embed": P(None, "fsdp"),
        "stages": stage_spec_tree(param_specs(cfg)["layers"][0], axis,
                                  n_chunks=n_chunks),
        "final_norm": P(None),
        "lm_head": P("fsdp", "tp"),
    }


def _tp_layer(stage: Params, i: int, n_tp: int) -> Params:
    """Layer ``i`` of a tp-resident stage: each leaf as the list of the
    ``n_tp`` positions' local blocks (replicated leaves repeat)."""
    return {k: [sh.data[i] for sh in v.shards] for k, v in stage.items()}


def _layer_apply_tp_local(layer: Params, x: torch.Tensor, cfg: LlamaConfig,
                          positions: torch.Tensor, mesh: Any, tp_axis: str,
                          n_tp: int) -> torch.Tensor:
    """One transformer block on LOCAL tensor-parallel weight blocks
    (Megatron layout) — the tp-resident pipeline stage body.  ``layer``
    maps each leaf to its ``n_tp`` positions' blocks.  ``wq/wk/wv`` are
    column blocks (each position computes its ``n_heads/tp`` heads end to
    end), ``wo`` a row block (partial residual contributions summed over
    the positions), ``w_gate/w_up`` column blocks (``d_ff/tp`` hidden),
    ``w_down`` a row block (summed): two sums a layer, the same
    projection/rope/SwiGLU helpers as the plain block."""
    from ddl_tpu_torch.models import remat as _remat
    from ddl_tpu_torch.parallel.collectives import psum
    from ddl_tpu_torch.parallel.ring_attention import attention

    B, T = x.shape[:2]
    dt = x.dtype
    lh = cfg.n_heads // n_tp  # local query heads
    lkv = cfg.n_kv_heads // n_tp  # local KV heads
    local = [{k: v[j] for k, v in layer.items()} for j in range(n_tp)]
    # The norms are replicated over tp: every position's input is the
    # same, so the first position's result serves them all.
    h = _rms_norm(x, local[0]["attn_norm"], cfg.norm_eps)
    parts = []
    for lj in local:
        q, k, v = _attn_qkv(lj, h, cfg, positions, n_heads=lh, n_kv_heads=lkv)
        attn = _remat.keep(
            attention, q.contiguous(), k.contiguous(), v.contiguous(),
            impl=cfg.attn_impl, causal=True, kv_repeat=lh // lkv,
        )
        parts.append(attn.reshape(B, T, -1) @ lj["wo"].to(dt))
    x = x + psum(parts, mesh, tp_axis)
    h = _rms_norm(x, local[0]["mlp_norm"], cfg.norm_eps)
    return x + psum([_swiglu(lj, h) for lj in local], mesh, tp_axis)


def _tp_stage_specs() -> Params:
    """Per-stage inner PartitionSpecs of tp-RESIDENT stages (leading
    per-stage layer axis unsharded; Megatron column/row blocks on the
    weight dims).  Only ``tp`` appears: fsdp shards at-rest storage
    only."""
    from ddl_tpu_torch.parallel.mesh import P

    return {
        "attn_norm": P(None, None),
        "wq": P(None, None, "tp"),
        "wk": P(None, None, "tp"),
        "wv": P(None, None, "tp"),
        "wo": P(None, "tp", None),
        "mlp_norm": P(None, None),
        "w_gate": P(None, None, "tp"),
        "w_up": P(None, None, "tp"),
        "w_down": P(None, "tp", None),
    }


#: :func:`_tp_stage_specs` (the JAX package's module constant).
_TP_STAGE_SPECS = _tp_stage_specs()


def tp_resident(cfg: LlamaConfig, mesh: Any, axis: str = "pp") -> int:
    """The tp extent the pipelined stages run resident over: the mesh's
    ``tp`` size when a real ``axis`` (> 1) exists and ``tp`` divides both
    head counts and ``d_ff``; else 1 (pp=1 takes the sequential
    fallback, where the sums over tp cannot resolve)."""
    if mesh is None:
        return 1
    shape = mesh.shape
    n_tp = (shape["tp"] if "tp" in shape and shape.get(axis, 1) > 1 else 1)
    if (n_tp > 1 and cfg.n_heads % n_tp == 0 and cfg.n_kv_heads % n_tp == 0
            and cfg.d_ff % n_tp == 0):
        return n_tp
    return 1


def forward_pp(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
               mesh: Any, n_microbatches: int, axis: str = "pp",
               schedule: str = "gpipe", n_chunks: Optional[int] = None,
               metrics: Any = None) -> torch.Tensor:
    """Next-token logits, (B, T, vocab) fp32, with the transformer blocks
    pipelined over the mesh's ``axis`` (``schedule`` gpipe, or the
    interleaved 1f1b with ``stage_params(..., n_chunks=)`` weights;
    :func:`ddl_tpu_torch.parallel.pipeline.pipeline_apply`).

    ``params`` is the :func:`stage_params` layout.  Each stage runs its
    ``L/S`` layers over the residual stream with single-position
    attention (no sequence parallelism and no ``segment_ids`` here, as in
    the JAX package: use :func:`forward` for packed batches).  With a
    ``tp`` axis that divides the head counts and ``d_ff``
    (:func:`tp_resident`), the stages run tensor-parallel resident.
    ``cfg.remat`` wraps every layer."""
    from ddl_tpu_torch.models import remat as _remat
    from ddl_tpu_torch.parallel.pipeline import pipeline_apply

    T = tokens.shape[1]
    dt = cfg.dtype
    positions = torch.arange(T, device=tokens.device)
    x = params["embed"][tokens.long()].to(dt)
    local = mesh.local() if mesh is not None else None
    n_tp = tp_resident(cfg, local, axis)

    if n_tp > 1:
        def one_layer(x: torch.Tensor, layer: Params) -> torch.Tensor:
            return _layer_apply_tp_local(layer, x, cfg, positions, local,
                                         "tp", n_tp)

        def layer_of(stage: Params, i: int) -> Params:
            return _tp_layer(stage, i, n_tp)

        def depth(stage: Params) -> int:
            return stage["wq"].shards[0].data.shape[0]
    else:
        def one_layer(x: torch.Tensor, layer: Params) -> torch.Tensor:
            return _layer_apply(layer, x, cfg, positions, mesh=None)

        def layer_of(stage: Params, i: int) -> Params:
            return {k: v[i] for k, v in stage.items()}

        def depth(stage: Params) -> int:
            return stage["wq"].shape[0]

    layer_fn = _remat.wrap(one_layer, cfg.remat)

    def stage_fn(stage: Params, h: torch.Tensor) -> torch.Tensor:
        for i in range(depth(stage)):
            h = layer_fn(h, layer_of(stage, i))
        return h

    x = pipeline_apply(
        params["stages"], x, stage_fn, local, n_microbatches, axis=axis,
        stage_param_specs=_TP_STAGE_SPECS if n_tp > 1 else None,
        schedule=schedule, n_chunks=n_chunks, metrics=metrics,
    )
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"].to(dt)).float()


def next_token_loss_pp(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                       mesh: Any, n_microbatches: int, axis: str = "pp",
                       schedule: str = "gpipe", n_chunks: Optional[int] = None,
                       metrics: Any = None) -> torch.Tensor:
    """:func:`next_token_loss` over the pipelined forward — the loss for
    ``make_train_step`` or the Trainer over a pp-axis mesh; the backward
    is the reverse schedule, through autograd."""
    from ddl_tpu_torch.models.losses import next_token_cross_entropy

    logits = forward_pp(params, tokens, cfg, mesh, n_microbatches, axis=axis,
                        schedule=schedule, n_chunks=n_chunks, metrics=metrics)
    return next_token_cross_entropy(logits, tokens)


def param_count(cfg: LlamaConfig) -> int:
    """Number of parameters ``init_params`` builds for ``cfg``."""
    per_layer = 2 * cfg.d_model + sum(
        int(np.prod(s)) for s in _layer_shapes(cfg).values()
    )
    return (
        cfg.n_layers * per_layer + 2 * cfg.vocab * cfg.d_model + cfg.d_model
    )
