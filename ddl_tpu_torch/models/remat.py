"""Named rematerialisation policies (port of ``ddl_tpu/models/remat.py``).

What the backward pass saves and what it recomputes, per layer
(``LlamaConfig.remat``; the legacy bools still map: ``True`` is
``"full"``, ``False`` is ``"none"``):

- ``"none"`` — save every layer intermediate (fastest step, most memory).
- ``"full"`` — save only each layer's input; the backward re-runs the
  whole layer, the attention kernel included
  (``torch.utils.checkpoint.checkpoint``, non-reentrant).
- ``"selective"`` — keep the attention call's output, and what the call
  saves for its own backward, and recompute the cheap rest: norms, the
  q/k/v projections and rope, the output projection and the MLP.  The
  backward never re-runs the attention kernel.
- ``"dots"`` — save every matrix-product output without batch dimensions
  (``aten.mm``: the weight projections) and recompute elementwise work
  and attention (selective activation checkpointing through
  ``torch.utils.checkpoint.create_selective_checkpoint_contexts``).

One wrap site per model (:func:`wrap` around the layer body) and one
kept-call site per attention block (:func:`keep`, the counterpart of the
JAX package's ``tag_attn_out``), so the policies cannot drift between
call sites.

How ``"selective"`` keeps the attention call out of the checkpoint: the
layer runs under a non-reentrant checkpoint, but :func:`keep` runs the
attention call under its own saved-tensor hooks, so what it saves is
stored as under ``"none"`` and never counted by the checkpoint; the
backward's recompute of the layer gets the call's first output back
instead of calling it again.  Both runs save the same tensors in the
same order around the call, which the checkpoint's bookkeeping needs.
(Selective activation checkpointing cannot do this: it caches ATen ops'
outputs, and a kernel launched from a ``torch.autograd.Function``
through ``ctypes`` is no ATen op, so it would run again.)
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

#: Every accepted policy name, in cheapest-memory-first order.
POLICIES = ("none", "full", "selective", "dots")

#: The matrix products "dots" saves: those without batch dimensions.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

_state = threading.local()


def resolve(remat: Any) -> str:
    """Normalise a config's ``remat`` field to a policy name.

    Accepts the policy strings plus the legacy booleans (``True`` ->
    ``"full"``, ``False``/``None`` -> ``"none"``)."""
    if remat is None or remat is False:
        return "none"
    if remat is True:
        return "full"
    if remat in POLICIES:
        return str(remat)
    raise ValueError(
        f"remat must be a bool or one of {POLICIES}, got {remat!r}"
    )


class _Kept:
    """The kept calls' outputs of one checkpointed layer call, in order;
    ``replay`` iterates them while the backward recomputes the layer."""

    def __init__(self) -> None:
        self.outs: list = []
        self.replay = None


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def keep(fn: Callable[..., torch.Tensor], *args: Any,
         **kwargs: Any) -> torch.Tensor:
    """Run ``fn(*args, **kwargs)`` — an attention call returning one
    tensor — as the piece the ``"selective"`` policy keeps; a plain call
    under every other policy."""
    kept = getattr(_state, "kept", None)
    if kept is None:
        return fn(*args, **kwargs)
    if kept.replay is not None:  # the backward's recompute of the layer
        return next(kept.replay)
    with torch.autograd.graph.saved_tensors_hooks(_same, _same):
        out = fn(*args, **kwargs)
    kept.outs.append(out.detach().requires_grad_(out.requires_grad))
    return out


def _dots_policy(ctx: Any, op: Any, *args: Any, **kwargs: Any) -> Any:
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _selective(layer_fn: Callable[..., Any]) -> Callable[..., Any]:
    def run(*args: Any) -> Any:
        kept = _Kept()

        def body(*a: Any) -> Any:
            prev = getattr(_state, "kept", None)
            _state.kept = kept
            try:
                return layer_fn(*a)
            finally:
                _state.kept = prev
                # Any later run of body is the backward's recompute.
                kept.replay = iter(kept.outs)

        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False)

    return run


def wrap(layer_fn: Callable[..., Any], remat: Any) -> Callable[..., Any]:
    """Apply the configured remat policy to a per-layer body
    (``layer_fn(*args)``, tensors or params trees in and out)."""
    name = resolve(remat)
    if name == "none":
        return layer_fn
    if name == "selective":
        return _selective(layer_fn)
    if name == "full":
        return lambda *args: checkpoint(
            layer_fn, *args, use_reentrant=False, preserve_rng_state=False)
    return lambda *args: checkpoint(
        layer_fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: create_selective_checkpoint_contexts(_dots_policy))
