"""Shared loss primitives (port of ``ddl_tpu/models/losses.py``).

Gather-then-logsumexp cross-entropy, as in the JAX package: the target
logit is gathered and subtracted from the row's logsumexp, so no second
full ``(..., vocab)`` log-softmax array is materialised.

Every :func:`cross_entropy` is a masked sum over a count.  Inside a
:class:`loss_weight` scope it also notes that count, so a step whose
batch is split over processes can weight each process's loss and grads
by it and divide the sums by the summed count: the global batch's loss
(the MULTIHOST step, ``parallel/train.py``; ``Trainer.evaluate``).
A term that is instead a process's share of a global sum (the MoE
router aux over a process-spanning batch) goes through
:func:`global_term`, which undoes that weighting for it.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

_SCOPE = threading.local()


class loss_weight:
    """Context: notes the count of every :func:`cross_entropy` call made
    inside it on this thread.  ``weight(default)`` is the count of the
    one call (a tensor on the loss's device, a number without a mask), or
    ``default`` when the scope saw no call or several (whose counts do
    not weight one sum)."""

    def __enter__(self) -> "loss_weight":
        self.counts: list = []
        self._prev = getattr(_SCOPE, "active", None)
        _SCOPE.active = self
        return self

    def __exit__(self, *exc) -> None:
        _SCOPE.active = self._prev

    def weight(self, default):
        return self.counts[0] if len(self.counts) == 1 else default


def global_term(term: torch.Tensor) -> torch.Tensor:
    """``term``, a loss term that is this process's additive share of a
    sum over the processes (a global quantity split so that the shares
    add up to it), scaled so that the way a step or ``Trainer.evaluate``
    combines the processes' losses adds the shares unweighted.  Inside a
    :class:`loss_weight` scope that noted one count ``c``, the processes'
    losses are weighted by their counts and divided by the summed count
    ``C``, so the share is scaled by ``C / c`` (one gloo ``all_reduce``
    of the count); otherwise the losses are averaged, and the share is
    scaled by the world size.  In a group of one process, ``term``."""
    from ddl_tpu_torch.parallel.mesh import process_count

    world = process_count()
    if world == 1:
        return term
    scope = getattr(_SCOPE, "active", None)
    count = scope.weight(None) if scope is not None else None
    if count is None:
        return term * world
    import torch.distributed as dist

    mine = float(count)
    total = torch.tensor([mine], dtype=torch.float64)
    dist.all_reduce(total)
    return term * (float(total) / max(mine, 1.0))


def cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean CE of integer ``targets`` under ``logits`` over the last axis;
    positions with ``mask`` 0 are excluded from the mean."""
    sel = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = torch.logsumexp(logits, dim=-1) - sel
    scope = getattr(_SCOPE, "active", None)
    if mask is None:
        if scope is not None:
            scope.counts.append(float(nll.numel()))
        return nll.mean()
    mask = torch.broadcast_to(mask.to(nll.dtype), nll.shape)
    count = mask.sum()
    if scope is not None:
        scope.counts.append(count.detach().float())
    return (nll * mask).sum() / torch.clamp(count, min=1.0)


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
