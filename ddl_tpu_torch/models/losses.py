"""Shared loss primitives (port of ``ddl_tpu/models/losses.py``).

Gather-then-logsumexp cross-entropy, as in the JAX package: the target
logit is gathered and subtracted from the row's logsumexp, so no second
full ``(..., vocab)`` log-softmax array is materialised.
"""

from __future__ import annotations

from typing import Optional

import torch


def cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean CE of integer ``targets`` under ``logits`` over the last axis;
    positions with ``mask`` 0 are excluded from the mean."""
    sel = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = torch.logsumexp(logits, dim=-1) - sel
    if mask is None:
        return nll.mean()
    mask = torch.broadcast_to(mask.to(nll.dtype), nll.shape)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def next_token_cross_entropy(
    logits: torch.Tensor,
    tokens: torch.Tensor,
    extra_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean CE of next-token prediction over (B, T) ``tokens``: targets
    are ``roll(tokens, -1)`` with the final position masked (the sequence
    axis keeps its full length).  ``extra_mask`` True drops positions.
    ``segment_ids`` (packed batches) drops the cross-document boundary
    positions, where the "next token" belongs to another document."""
    T = tokens.shape[1]
    targets = torch.roll(tokens, -1, dims=1)
    mask = torch.broadcast_to(
        (torch.arange(T, device=tokens.device) < T - 1)[None, :], tokens.shape
    )
    if segment_ids is not None:
        mask = mask & (segment_ids == torch.roll(segment_ids, -1, dims=1))
    if extra_mask is not None:
        mask = mask & ~extra_mask
    return cross_entropy(logits, targets, mask)
