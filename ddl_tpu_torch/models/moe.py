"""Mixture-of-Experts decoder LM (port of ``ddl_tpu/models/moe.py``:
config, init, the two dispatch implementations, the mesh-aware routed
MLP, forward and loss, the pipelined path, and KV-cache decode).

The layer is llama's attention block (:func:`~ddl_tpu_torch.models.llama.
_attn_block`, so the flash kernels K1-K6) followed by top-k routed SwiGLU
experts stacked ``(E, D, F)``:

- Router: softmax gate in fp32 from the compute-dtype product, top-k
  (ties go to the lower expert id, as ``lax.top_k``: a stable descending
  sort), probabilities renormalised over the chosen experts.
- ``moe_impl="einsum"`` (GShard/Switch): per-expert capacity ``C =
  ceil(topk·N/E·capacity_factor)`` over the N tokens routed together;
  slots come from a cumulative sum over the slot-major ``(k·N, E)``
  one-hot mask (every slot-0 pick queues before any slot-1 pick), and
  picks past the capacity are dropped.  So a token's output depends on
  which tokens were routed with it (see "Routing groups").
- ``moe_impl="ragged"``: dropless.  The ``k·N`` token copies are stably
  sorted by expert and each expert's contiguous rows go through its
  weights (the JAX package's ``ragged_dot``, here one matrix product an
  expert).
- Load-balance aux loss (Switch): ``E · Σ_e frac_slot0(e) ·
  mean_prob(e)``.

Routing groups (which tokens one routing sees), as GSPMD gives them in
the JAX package:

- :func:`forward` with ``mesh=None`` or any one-process mesh, einsum
  impl: one group, the whole batch.  Over a mesh whose ``dp`` spans
  processes each process holds its rows, and the routing is still the
  global batch's: one gather of the ``(k, E)`` pick counts a layer
  (:func:`~ddl_tpu_torch.parallel.collectives.process_allgather`) gives
  the capacity of the global token count and each process's arrival
  offsets, and the aux becomes this process's additive share of the
  global value (``E·Σ_e f_e·S_{p,e}/N``, f and N global, S this
  process's router-probability sums), which the loss passes through
  :func:`~ddl_tpu_torch.models.losses.global_term`.
- The ragged impl over ``dp`` / ``sp`` / ``tp``: one group per token
  shard (the JAX package's ``shard_map``), the expert hidden dim split
  over ``tp`` when it divides ``d_ff`` (the partial outputs summed), and
  the aux the mean of the shards' aux.
- :func:`forward_pp`: one group per ``dp`` shard of a microbatch when a
  real pipeline axis runs and ``dp`` divides the microbatch, else the
  whole microbatch.

On one card a mesh's expert stacks stay whole tensors: ``param_specs``'
``ep`` entries place only the sharded optimizer's state
(``parallel.optimizer``) and gate :func:`_validate_impl_mesh`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ddl_tpu_torch.models import llama as _llama
from ddl_tpu_torch.models.llama import params_from_numpy  # noqa: F401

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    vocab: int = 256
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 256  # per-expert hidden size
    n_experts: int = 4
    topk: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    max_seq: int = 512
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    #: Storage dtype of the params (bf16 halves the expert stacks).
    param_dtype: Any = torch.float32
    #: Remat policy around each layer (:mod:`ddl_tpu_torch.models.remat`).
    remat: Any = False
    attn_impl: str = "auto"
    #: "einsum" (capacity-bounded dispatch/combine) or "ragged"
    #: (sort-based, dropless; rejected with an ``ep`` axis > 1).
    moe_impl: str = "einsum"

    def __post_init__(self) -> None:
        from ddl_tpu_torch.models import remat as _remat

        _remat.resolve(self.remat)  # fail on junk at config build time

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def capacity(self, n_tokens: int) -> int:
        per_expert = self.topk * n_tokens / self.n_experts
        return max(1, math.ceil(per_expert * self.capacity_factor))

    @staticmethod
    def tiny() -> "MoeConfig":
        return MoeConfig()

    @staticmethod
    def mixtral_8x7b() -> "MoeConfig":
        """Mixtral-8x7B's published widths (Jiang et al. 2024, Table 1)."""
        return MoeConfig(
            vocab=32000, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14336, n_experts=8, topk=2, max_seq=8192,
        )


def _layer_shapes(cfg: MoeConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """Each dense leaf of a layer: (shape, fan_in), in init order."""
    d, hd, E, Fh = cfg.d_model, cfg.head_dim, cfg.n_experts, cfg.d_ff
    return {
        "wq": ((d, cfg.n_heads * hd), d),
        "wk": ((d, cfg.n_kv_heads * hd), d),
        "wv": ((d, cfg.n_kv_heads * hd), d),
        "wo": ((cfg.n_heads * hd, d), cfg.n_heads * hd),
        "w_router": ((d, E), d),
        "w_gate": ((E, d, Fh), d),
        "w_up": ((E, d, Fh), d),
        "w_down": ((E, Fh, d), Fh),
    }


def _build(cfg: MoeConfig, dense: Any, ones: Any) -> Params:
    """The params tree, its leaves from ``dense(shape, fan_in)`` and
    ``ones(shape)`` in the JAX package's order."""
    d = cfg.d_model
    layers = []
    for _ in range(cfg.n_layers):
        layer = {"attn_norm": ones((d,))}
        for name, (shape, fan_in) in _layer_shapes(cfg).items():
            if name == "w_router":
                layer["mlp_norm"] = ones((d,))
            layer[name] = dense(shape, fan_in)
        layers.append(layer)
    return {
        "embed": dense((cfg.vocab, d), d),
        "layers": layers,
        "final_norm": ones((d,)),
        "lm_head": dense((d, cfg.vocab), d),
    }


def init_params(cfg: MoeConfig, seed: int = 0, device: Any = "cuda") -> Params:
    """``1/sqrt(fan_in)``-scaled normal weights and unit norms in
    ``cfg.param_dtype``, drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the JAX package's distributions, not its
    random numbers)."""
    from ddl_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pdt = cfg.param_dtype

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return w.div_(float(np.sqrt(fan_in))).to(pdt)

    return _build(cfg, dense,
                  lambda shape: torch.ones(shape, device=dev, dtype=pdt))


def param_shapes(cfg: MoeConfig) -> Params:
    """The params tree of :func:`init_params` as ``meta`` tensors: prices
    a Mixtral-scale layout without allocating it."""
    def meta(shape, fan_in=None):
        return torch.empty(shape, dtype=cfg.param_dtype, device="meta")

    return _build(cfg, meta, meta)


def param_specs(cfg: MoeConfig) -> Params:
    """Expert stacks shard their leading E axis over ``ep``; within an
    expert the dense Megatron layout (fsdp × tp) applies.  Axes absent
    from the mesh drop out (``parallel.mesh.named``)."""
    from ddl_tpu_torch.parallel.mesh import P

    layer = {
        "attn_norm": P(None),
        "wq": P("fsdp", "tp"),
        "wk": P("fsdp", "tp"),
        "wv": P("fsdp", "tp"),
        "wo": P("tp", "fsdp"),
        "mlp_norm": P(None),
        "w_router": P(None, None),
        "w_gate": P("ep", "fsdp", "tp"),
        "w_up": P("ep", "fsdp", "tp"),
        "w_down": P("ep", "tp", "fsdp"),
    }
    return {
        "embed": P(None, "fsdp"),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
        "final_norm": P(None),
        "lm_head": P("fsdp", "tp"),
    }


# -- routing and the two dispatch impls ----------------------------------------


def _router_topk(x: torch.Tensor, layer: Params, cfg: MoeConfig):
    """Softmax gate → top-k → renormalised gates, shared by both impls:
    ``(probs (N, E) fp32, top_p (N, k), top_e (N, k) int64)``.  A stable
    descending sort takes the top k, so equal probabilities go to the
    lower expert id on every device (``lax.top_k``'s order)."""
    logits = (x @ layer["w_router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :cfg.topk], top_e[:, :cfg.topk]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def _switch_aux(probs: torch.Tensor, top_e: torch.Tensor, E: int) -> torch.Tensor:
    """Switch load-balance loss on the slot-0 picks —
    ``E · Σ_e fraction_dispatched(e) · mean_router_prob(e)``."""
    frac = F.one_hot(top_e[:, 0], E).float().mean(0)
    return E * torch.sum(frac * probs.mean(0))


def _global_routing(mask: torch.Tensor, n_local: int):
    """The cross-process part of the einsum routing over a ``dp`` that
    spans processes: one gather of every process's ``(k, E)`` slot pick
    counts and token count.  Returns ``(offset (k, E), n_global,
    slot0 (E,))``: ``offset[s, e]`` is what this process's slot-``s``
    picks of expert ``e`` queue behind beyond its own earlier slots —
    every other process's picks of slots before ``s`` and the slot-``s``
    picks of lower ranks (the global batch is process-major, as
    ``make_mesh`` lays it out); ``slot0`` the global slot-0 pick count of
    each expert."""
    from ddl_tpu_torch.parallel.collectives import process_allgather
    from ddl_tpu_torch.parallel.mesh import process_rank

    k, E = mask.shape[1], mask.shape[2]
    mine = mask.sum(0)  # (k, E)
    row = torch.cat([mine.reshape(-1), mine.new_tensor([float(n_local)])])
    every = process_allgather(row)  # (P, k*E + 1)
    counts = every[:, :-1].reshape(-1, k, E)
    total = counts.sum(0)  # (k, E)
    rank = process_rank()
    before = torch.cumsum(total - mine, 0) - (total - mine)  # slots < s
    offset = before + counts[:rank].sum(0)
    return offset, int(every[:, -1].sum()), total[0]


def _arrival(mask: torch.Tensor) -> torch.Tensor:
    """Each pick's arrival index at its expert, (N, k) fp32, from the
    (N, k, E) one-hot picks.  Slot-major priority: all slot-0 picks
    queue before any slot-1 pick (a cumulative sum over the ``(k·N, E)``
    mask, exact in fp32 below 2^24 tokens)."""
    N, k, E = mask.shape
    mask_f = mask.transpose(0, 1).reshape(k * N, E)
    pos_f = torch.cumsum(mask_f, 0) - mask_f
    return (pos_f * mask_f).sum(-1).reshape(k, N).t()


def moe_mlp(x: torch.Tensor, layer: Params, cfg: MoeConfig,
            across: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed SwiGLU experts over flat tokens x: (N, D), capacity
    bounded; returns (out (N, D), aux scalar).  ``across``: x is this
    process's rows of a batch whose ``dp`` spans processes — the routing
    is the global batch's and the aux this process's share of it
    (module docstring)."""
    N, D = x.shape
    E, k = cfg.n_experts, cfg.topk
    dt = x.dtype

    probs, top_p, top_e = _router_topk(x, layer, cfg)
    mask = F.one_hot(top_e, E).float()  # (N, k, E)
    pos = _arrival(mask)
    if across:
        offset, n_tokens, slot0 = _global_routing(mask, N)
        pos = pos + (mask * offset[None]).sum(-1)
        # This process's share of E·Σ_e f_e·mean_prob_e over the global
        # batch: f global (no gradient), the probabilities' sum local.
        aux = E * torch.sum(slot0 / n_tokens * probs.sum(0) / n_tokens)
    else:
        n_tokens = N
        aux = _switch_aux(probs, top_e, E)
    C = cfg.capacity(n_tokens)
    pos = pos.long()
    keep = (pos < C) & (mask.sum(-1) > 0)  # (N, k)
    gates = top_p * keep  # dropped picks get zero combine weight
    slots = (pos[..., None] == torch.arange(C, device=x.device)).float()
    # combine[n, e, c] = gate of token n at expert e, slot c: one batched
    # (E, k) @ (k, C) product a token, no (N, k, E, C) intermediate.
    combine = torch.einsum("nke,nkc->nec", gates[..., None] * mask, slots)
    dispatch = (combine > 0).to(dt)  # (N, E, C)

    expert_in = torch.einsum("nec,nd->ecd", dispatch, x)  # (E, C, D)
    gate = F.silu(torch.bmm(expert_in, layer["w_gate"].to(dt)))
    up = torch.bmm(expert_in, layer["w_up"].to(dt))
    expert_out = torch.bmm(gate * up, layer["w_down"].to(dt))  # (E, C, D)
    out = torch.einsum("nec,ecd->nd", combine.to(dt), expert_out)
    return out, aux


def _ragged_rows(xs: torch.Tensor, sizes: List[int], layer: Params,
                 dt: torch.dtype, lo: int, hi: int) -> torch.Tensor:
    """Each expert's contiguous rows of the expert-sorted copies through
    its SwiGLU, on the hidden units ``[lo, hi)`` (all of ``d_ff``, or one
    tp slice whose down projection is a partial sum)."""
    outs, start = [], 0
    for e, n in enumerate(sizes):
        rows = xs[start:start + n]
        start += n
        g = F.silu(rows @ layer["w_gate"][e, :, lo:hi].to(dt))
        u = rows @ layer["w_up"][e, :, lo:hi].to(dt)
        outs.append((g * u) @ layer["w_down"][e, lo:hi].to(dt))
    return torch.cat(outs)


def moe_mlp_ragged(x: torch.Tensor, layer: Params, cfg: MoeConfig,
                   n_tp: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dropless top-k routing: each token's ``topk`` copies
    stably sorted by expert id, each expert's contiguous rows through
    one matrix product per weight (the JAX package's ``ragged_dot``), no
    capacity, no drops.  The router, gates and aux are :func:`moe_mlp`'s.
    ``n_tp > 1`` runs the hidden dim in ``n_tp`` slices and sums their
    partial outputs (the JAX package's tp ``psum``).

    The group sizes come from a ``bincount`` on the device and reach the
    host (``.tolist()``) to slice the rows: one host sync a call."""
    N, D = x.shape
    E, k = cfg.n_experts, cfg.topk
    dt = x.dtype

    probs, top_p, top_e = _router_topk(x, layer, cfg)
    flat_e = top_e.reshape(-1)  # copy i belongs to token i // k
    order = torch.argsort(flat_e, stable=True)  # ties keep token order
    xs = x[order // k]  # (N*k, D) grouped by expert
    sizes = torch.bincount(flat_e, minlength=E).tolist()
    step = cfg.d_ff // n_tp
    out = None
    for j in range(n_tp):
        rows = _ragged_rows(xs, sizes, layer, dt, j * step, (j + 1) * step)
        per_copy = torch.empty_like(rows)
        per_copy[order] = rows  # back to (token, slot) order
        part = torch.einsum("nk,nkd->nd", top_p.to(dt),
                            per_copy.reshape(N, k, D))
        out = part if out is None else out + part
    return out, _switch_aux(probs, top_e, E)


def _moe_mlp_dispatch(x: torch.Tensor, layer: Params, cfg: MoeConfig,
                      across: bool = False):
    if cfg.moe_impl == "ragged":
        return moe_mlp_ragged(x, layer, cfg)
    if cfg.moe_impl != "einsum":
        raise ValueError(
            f"unknown moe_impl {cfg.moe_impl!r} (want einsum|ragged)"
        )
    return moe_mlp(x, layer, cfg, across=across)


def _validate_impl_mesh(cfg: MoeConfig, mesh: Optional[Any]) -> None:
    """The ragged impl's expert groups are contiguous row ranges of a
    locally sorted copy list: they cannot align with an ``ep``-sharded
    expert stack, so that combination is rejected up front."""
    if (
        cfg.moe_impl == "ragged"
        and mesh is not None
        and "ep" in mesh.axis_names
        and mesh.shape["ep"] > 1
    ):
        raise ValueError(
            "moe_impl='ragged' does not compose with an ep>1 mesh axis "
            "(expert groups are contiguous local row ranges); use the "
            "einsum impl for expert parallelism"
        )


def _blocked(h: torch.Tensor, nb: int, nt: int, fn: Any):
    """``fn`` over each of the ``nb x nt`` (rows, sequence) blocks of h
    (B, T, D), each flattened to tokens; returns the outputs put back in
    place and the blocks' aux values, row-block major."""
    B, T, D = h.shape
    rows, auxes = [], []
    for hb in h.chunk(nb, 0):
        cols = []
        for blk in hb.chunk(nt, 1):
            b, t = blk.shape[:2]
            out, aux = fn(blk.reshape(b * t, D))
            cols.append(out.reshape(b, t, D))
            auxes.append(aux)
        rows.append(torch.cat(cols, 1))
    return torch.cat(rows, 0), auxes


def _routed_mlp(h: torch.Tensor, layer: Params, cfg: MoeConfig,
                mesh: Optional[Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE MLP on the (B, T, D) residual stream, mesh-aware (the
    module docstring's routing groups).  Over a mesh that spans
    processes ``h`` holds this process's rows."""
    B, T, D = h.shape
    across = mesh is not None and mesh.spans_processes
    if cfg.moe_impl == "ragged" and mesh is not None:
        shape, local = mesh.shape, mesh.local().shape
        n_dp = shape["dp"] if shape.get("dp", 1) > 1 else 1
        n_sp = shape["sp"] if shape.get("sp", 1) > 1 else 1
        n_tp = (shape["tp"] if shape.get("tp", 1) > 1
                and cfg.d_ff % shape["tp"] == 0 else 1)
        nb = local["dp"] if n_dp > 1 else 1  # this process's dp blocks
        if (n_dp > 1 and B % nb) or (n_sp > 1 and T % n_sp):
            raise ValueError(
                "moe_impl='ragged': dp/sp mesh axes must divide the "
                f"(B={B}, T={T}) token grid"
            )
        if n_dp > 1 or n_sp > 1 or n_tp > 1:
            out, auxes = _blocked(
                h, nb, n_sp,
                lambda t: moe_mlp_ragged(t, layer, cfg, n_tp=n_tp))
            # The mean of every token shard's aux: over a dp that spans
            # processes, this process's part of that mean.
            return out, torch.stack(auxes).sum() / (n_dp * n_sp)
    out, aux = _moe_mlp_dispatch(h.reshape(B * T, D), layer, cfg,
                                 across=across)
    return out.reshape(B, T, D), aux


def _layer_apply(layer: Params, x: torch.Tensor, cfg: MoeConfig,
                 positions: torch.Tensor, mesh: Optional[Any] = None,
                 segment_ids: Optional[torch.Tensor] = None):
    """One MoE block on the residual stream → (x, router aux): llama's
    attention block, then the routed experts."""
    x = _llama._attn_block(layer, x, cfg, positions, mesh=mesh,
                           segment_ids=segment_ids)
    h = _llama._rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    moe_out, aux = _routed_mlp(h, layer, cfg, mesh)
    return x + moe_out, aux


def forward(params: Params, tokens: torch.Tensor, cfg: MoeConfig,
            mesh: Optional[Any] = None,
            segment_ids: Optional[torch.Tensor] = None):
    """(logits (B, T, vocab) fp32, mean router aux over layers).

    ``segment_ids`` (B, T): packed-batch attention masking, as in
    ``llama.forward``.  Over a mesh whose ``dp`` spans processes the aux
    is this process's share of the global value (module docstring)."""
    from ddl_tpu_torch.models import remat as _remat

    _validate_impl_mesh(cfg, mesh)
    dt = cfg.dtype
    T = tokens.shape[1]
    positions = torch.arange(T, device=tokens.device)
    seg = (None if segment_ids is None
           else segment_ids.to(torch.int32).contiguous())
    x = params["embed"][tokens.long()].to(dt)

    def layer_fn(x: torch.Tensor, layer: Params):
        return _layer_apply(layer, x, cfg, positions, mesh=mesh,
                            segment_ids=seg)

    layer_fn = _remat.wrap(layer_fn, cfg.remat)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for layer in params["layers"]:
        x, aux = layer_fn(x, layer)
        aux_total = aux_total + aux
    x = _llama._rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"].to(dt)).float()
    return logits, aux_total / cfg.n_layers


def next_token_loss(params: Params, tokens: torch.Tensor, cfg: MoeConfig,
                    mesh: Optional[Any] = None,
                    segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy + weighted router load-balance loss.  With
    ``segment_ids`` attention is segment-masked and cross-document
    predictions drop from the CE, as in ``llama.next_token_loss``."""
    from ddl_tpu_torch.models.losses import global_term, next_token_cross_entropy

    logits, aux = forward(params, tokens, cfg, mesh, segment_ids=segment_ids)
    ce = next_token_cross_entropy(logits, tokens, segment_ids=segment_ids)
    if mesh is not None and mesh.spans_processes:
        aux = global_term(aux)
    return ce + cfg.router_aux_weight * aux


# -- pipeline parallelism ----------------------------------------------------


def stage_params(params: Params, n_stages: int, n_chunks: int = 1) -> Params:
    """Regroup an :func:`init_params` tree for pipeline parallelism (the
    shared ``(S, [V,] L/(S·V), ...)`` layout of
    ``parallel.pipeline.stack_layer_stages``); expert stacks keep their
    E axis inside each stage leaf.  Embed and head stay outside."""
    from ddl_tpu_torch.parallel.pipeline import stack_layer_stages

    return {
        "embed": params["embed"],
        "stages": stack_layer_stages(params["layers"], n_stages,
                                     n_chunks=n_chunks),
        "final_norm": params["final_norm"],
        "lm_head": params["lm_head"],
    }


def pp_param_specs(cfg: MoeConfig, axis: str = "pp", n_chunks: int = 1) -> Params:
    """PartitionSpecs for the :func:`stage_params` layout: ``axis``
    shards the stages, the per-layer layout of :func:`param_specs`
    follows (``ep`` still on the expert axis)."""
    from ddl_tpu_torch.parallel.mesh import P
    from ddl_tpu_torch.parallel.pipeline import stage_spec_tree

    return {
        "embed": P(None, "fsdp"),
        "stages": stage_spec_tree(param_specs(cfg)["layers"][0], axis,
                                  n_chunks=n_chunks),
        "final_norm": P(None),
        "lm_head": P("fsdp", "tp"),
    }


def forward_pp(params: Params, tokens: torch.Tensor, cfg: MoeConfig,
               mesh: Any, n_microbatches: int, axis: str = "pp",
               schedule: str = "gpipe", n_chunks: Optional[int] = None,
               metrics: Any = None):
    """(logits, mean router aux) with the MoE blocks pipelined over
    ``axis`` (``parallel.pipeline.pipeline_apply``; ``params`` in the
    :func:`stage_params` layout).

    The aux accumulates through the pipe: the activation tree carries a
    per-row accumulator beside the residual stream, each layer adds its
    routing group's aux to that group's rows, and the caller averages
    over rows.  Routing groups: one ``dp`` shard of one microbatch when a
    real ``axis`` runs and ``dp`` divides the microbatch, else the whole
    microbatch.  Logits equal :func:`forward`'s whenever capacity does
    not bind; the aux is the mean of per-group aux (not the full batch's:
    it is not linear in token subsets)."""
    from ddl_tpu_torch.models import remat as _remat
    from ddl_tpu_torch.parallel.pipeline import pipeline_apply

    _validate_impl_mesh(cfg, mesh)
    local = mesh.local() if mesh is not None else None
    shape = local.shape if local is not None else {}
    piped = shape.get(axis, 1) > 1
    if cfg.moe_impl == "ragged" and not piped:
        # Without a real pp axis the stages run in sequence over whole
        # microbatches, where the JAX package's global argsort would
        # gather the token shards.
        for ax in ("dp", "sp"):
            if shape.get(ax, 1) > 1:
                raise ValueError(
                    f"moe_impl='ragged' with forward_pp needs a real "
                    f"{axis}>1 mesh axis when {ax}>1 (the sequential "
                    "fallback would gather token shards); use the "
                    "einsum impl or a pipelined mesh"
                )
    B, T = tokens.shape
    mb = B // n_microbatches
    n_dp = shape.get("dp", 1)
    groups = n_dp if piped and n_dp > 1 and mb % n_dp == 0 else 1
    dt = cfg.dtype
    positions = torch.arange(T, device=tokens.device)
    x = params["embed"][tokens.long()].to(dt)

    def one_layer(h: torch.Tensor, aux_rows: torch.Tensor, layer: Params):
        h = _llama._attn_block(layer, h, cfg, positions, mesh=None)
        hn = _llama._rms_norm(h, layer["mlp_norm"], cfg.norm_eps)
        out, auxes = _blocked(hn, groups, 1,
                              lambda t: _moe_mlp_dispatch(t, layer, cfg))
        per_row = torch.stack(auxes).repeat_interleave(h.shape[0] // groups)
        return h + out, aux_rows + per_row

    layer_fn = _remat.wrap(one_layer, cfg.remat)

    def stage_fn(stage: Params, state: Any) -> Any:
        h, aux_rows = state
        for i in range(stage["wq"].shape[0]):
            h, aux_rows = layer_fn(h, aux_rows, {k: v[i] for k, v in stage.items()})
        return h, aux_rows

    x, aux_rows = pipeline_apply(
        params["stages"],
        (x, torch.zeros(B, dtype=torch.float32, device=tokens.device)),
        stage_fn, local, n_microbatches, axis=axis, schedule=schedule,
        n_chunks=n_chunks, metrics=metrics,
    )
    x = _llama._rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"].to(dt)).float()
    return logits, aux_rows.mean() / cfg.n_layers


def next_token_loss_pp(params: Params, tokens: torch.Tensor, cfg: MoeConfig,
                       mesh: Any, n_microbatches: int, axis: str = "pp",
                       schedule: str = "gpipe", n_chunks: Optional[int] = None,
                       metrics: Any = None) -> torch.Tensor:
    """Cross-entropy + weighted router aux over the pipelined forward."""
    from ddl_tpu_torch.models.losses import next_token_cross_entropy

    logits, aux = forward_pp(params, tokens, cfg, mesh, n_microbatches,
                             axis=axis, schedule=schedule, n_chunks=n_chunks,
                             metrics=metrics)
    return next_token_cross_entropy(logits, tokens) + cfg.router_aux_weight * aux


# -- inference: KV-cache decode + generate -----------------------------------


def init_cache(cfg: MoeConfig, batch: int, max_len: int,
               device: Any = "cuda") -> Params:
    """Llama's stacked KV cache (the routed MLP needs none: routing
    re-decides per decoded token)."""
    return _llama.init_cache(cfg, batch, max_len, device=device)


def forward_with_cache(params: Params, tokens: torch.Tensor, cfg: MoeConfig,
                       cache: Params, pos: int, last_only: bool = False):
    """Cached MoE forward (prefill: T = prompt length at pos 0; decode:
    T = 1): llama's cached attention, then the routed MLP over the
    call's flat (B*T, D) tokens with ``cfg.moe_impl``.

    The einsum impl's capacity comes from the call's own token count:
    prefill routes the prompt as the training forward does (its logits
    equal :func:`forward`'s, drops included); a decode step routes its B
    tokens with fresh capacity, so it drops less than teacher forcing,
    never more.  The ragged impl is dropless: decode equals the full
    forward.  Returns (logits, cache); no aux."""
    dt = cfg.dtype
    B, T = tokens.shape
    positions = pos + torch.arange(T, device=tokens.device)
    cache_idx = torch.arange(cache["k"].shape[2], device=tokens.device)
    x = params["embed"][tokens.long()].to(dt)
    for li, layer in enumerate(params["layers"]):
        x = _llama._attn_with_cache(layer, x, cfg, cache["k"], cache["v"], li,
                                    pos, positions, cache_idx)
        h = _llama._rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
        out, _aux = _moe_mlp_dispatch(h.reshape(B * T, -1), layer, cfg)
        x = x + out.reshape(B, T, -1)
    x = _llama._rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return (x @ params["lm_head"].to(dt)).float(), cache


def generate(params: Params, prompt: torch.Tensor, cfg: MoeConfig,
             max_new_tokens: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             eos_id: Optional[int] = None) -> torch.Tensor:
    """Autoregressive MoE generation: ``llama.generate``'s contract
    (greedy, or sampling with an explicit ``generator``; top-k / top-p
    filters; EOS masking) over :func:`forward_with_cache`."""
    return _llama._generate(forward_with_cache, init_cache, params, prompt,
                            cfg, max_new_tokens, temperature, generator,
                            top_k=top_k, top_p=top_p, eos_id=eos_id)
