"""Operation and byte counts of the work a cell asks for, from its shapes
alone, so they read the same work whatever implements it.

Model FLOPs follow the usual MFU convention (the JAX package's
``bench.py``, rewritten here): matrix-product FLOPs of the forward pass,
the backward counted as twice the forward, a causal attention's masked
half not counted, recomputation not counted.
"""

from __future__ import annotations

from typing import Dict, Tuple


def decoder_flops_per_token(d_model: int, n_heads: int, n_kv_heads: int,
                            d_ff: int, n_layers: int, vocab: int,
                            seq: int) -> float:
    """Forward + backward model FLOPs per token of a GQA decoder with a
    SwiGLU MLP and an untied head."""
    hd = d_model // n_heads
    per_layer = (
        2 * d_model * (n_heads + 2 * n_kv_heads) * hd  # q, k, v
        + 2 * n_heads * hd * d_model  # out projection
        + 2 * 2 * seq * n_heads * hd / 2  # scores and attn @ v, causal half
        + 3 * 2 * d_model * d_ff  # gate, up, down
    )
    return 3.0 * (n_layers * per_layer + 2 * d_model * vocab)


def encoder_flops_per_image(d_model: int, n_heads: int, d_ff: int,
                            n_layers: int, n_patches: int, patch_dim: int,
                            n_classes: int) -> float:
    """Forward + backward model FLOPs per image of a ViT: patch
    projection, non-causal attention over the patches, a two-matrix MLP,
    a pooled head."""
    per_token_layer = (
        2 * d_model * 3 * d_model  # q, k, v
        + 2 * d_model * d_model  # out projection
        + 2 * 2 * n_patches * d_model  # scores and attn @ v, all pairs
        + 2 * 2 * d_model * d_ff  # up, down
    )
    per_token = n_layers * per_token_layer + 2 * patch_dim * d_model
    return 3.0 * (n_patches * per_token + 2 * d_model * n_classes)


def attention_work(batch: int, seq: int, heads: int, kv_heads: int,
                   head_dim: int, causal: bool,
                   elem_bytes: int = 2) -> Dict[str, Tuple[float, float]]:
    """(FLOPs, bytes) of one attention call's forward and backward.

    FLOPs: the forward's two products over the attended pairs (half the
    square, diagonal included, when causal); the backward's five (the
    scores again, dV, dP, dQ, dK).  Bytes: each input read once and each
    output written once: q, k, v, o, dO, dq, dk, dv in ``elem_bytes``, the
    float32 log-sum-exp a row and head.
    """
    pairs = seq * (seq + 1) / 2 if causal else float(seq * seq)
    unit = batch * heads * head_dim * pairs
    q = batch * seq * heads * head_dim * elem_bytes
    kv = batch * seq * kv_heads * head_dim * elem_bytes
    lse = batch * heads * seq * 4
    return {
        "fwd": (4.0 * unit, float(q + 2 * kv + q + lse)),
        "bwd": (10.0 * unit, float((q + 2 * kv + q + q + lse) + (q + 2 * kv))),
    }


def bound_s(flops: float, nbytes: float, peak_flops: float,
            peak_bytes_per_s: float) -> float:
    """The least time the chip could take: the larger of the operations at
    peak rate and the bytes at peak bandwidth."""
    return max(flops / peak_flops, nbytes / peak_bytes_per_s)
