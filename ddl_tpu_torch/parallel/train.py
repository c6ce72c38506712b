"""One-device training steps (port of ``ddl_tpu/parallel/train.py``:
``_make_apply_step``, ``make_train_step`` and ``make_multistep`` on one
device).

PyTorch runs eagerly, so the JAX package's jitted window ``lax.scan``
becomes a Python loop of per-batch steps with the same math.  The
optimizer is a factory of a ``torch.optim.Optimizer`` over the param
leaves; :func:`adamw` builds one with ``optax.adamw``'s hyper-parameters
(they differ from ``torch.optim.AdamW``'s defaults).  Sharded meshes,
ZeRO-1 and quantized gradient communication are later slices.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, List, Tuple

import torch


@dataclasses.dataclass
class TrainState:
    params: Any
    optimizer: Any  # a torch.optim.Optimizer over tree_leaves(params)
    step: int = 0


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Map ``fn`` over the leaves of a nested dict/list params tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a params tree, in insertion order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4):
    """``optax.adamw``'s signature and defaults as a factory of
    ``torch.optim.AdamW`` (whose own defaults differ: weight decay 1e-2).
    The two agree step by step once these are equal: both decay the
    pre-update parameter by ``lr * weight_decay`` and divide the
    bias-corrected first moment by ``sqrt(bias-corrected second) + eps``.
    """
    return functools.partial(
        torch.optim.AdamW, lr=learning_rate, betas=(b1, b2), eps=eps,
        weight_decay=weight_decay,
    )


def _make_apply_step(loss_fn: Callable[..., torch.Tensor],
                     accum_steps: int = 1):
    """One loss/grad/update step, shared by the single- and multi-step
    factories.  ``accum_steps > 1`` splits the batch's leading axis into
    equal microbatches, averages their grads and applies ONE update."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    inv = 1.0 / accum_steps

    def apply_step(state: TrainState, batch: Any) -> torch.Tensor:
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        if accum_steps == 1:
            loss = loss_fn(state.params, batch)
            loss.backward()
        else:
            lead = batch[0].shape[0]
            if lead % accum_steps:
                raise ValueError(
                    f"batch leading dim {lead} is not divisible by "
                    f"accum_steps={accum_steps}"
                )
            micro = zip(*(b.chunk(accum_steps, dim=0) for b in batch))
            loss = torch.zeros((), device=batch[0].device)
            for mb in micro:
                mb_loss = loss_fn(state.params, tuple(mb))
                (mb_loss * inv).backward()  # grads accumulate in fp32
                loss = loss + mb_loss.detach()
            loss = loss * inv
        opt.step()
        return loss.detach()

    return apply_step


def _init_fn(optimizer: Callable[..., Any], device: torch.device):
    def init_fn(params: Any) -> TrainState:
        # Fresh leaves the step may update in place: the caller's tree is
        # never aliased (the JAX package's "jitted identity" copy).
        params = tree_map(
            lambda p: torch.as_tensor(p).detach().to(device, copy=True)
            .requires_grad_(True),
            params,
        )
        return TrainState(params, optimizer(tree_leaves(params)), 0)

    return init_fn


def make_train_step(
    loss_fn: Callable[..., torch.Tensor],
    optimizer: Callable[..., Any],
    device: Any,
    accum_steps: int = 1,
) -> Tuple[Callable[..., TrainState], Callable[..., Any]]:
    """Build ``(init_fn, step_fn)`` for a one-device training loop.

    ``loss_fn(params, batch) -> scalar`` over the loader's column tuple;
    ``optimizer(param_list) -> torch.optim.Optimizer`` (e.g.
    :func:`adamw`).  ``step_fn(state, batch) -> (state, loss)`` updates
    the params in place and returns the loss as a device tensor (no
    host sync).
    """
    apply_step = _make_apply_step(loss_fn, accum_steps)

    def step_fn(state: TrainState, batch: Any):
        loss = apply_step(state, batch)
        return TrainState(state.params, state.optimizer, state.step + 1), loss

    return _init_fn(optimizer, torch.device(device)), step_fn


def make_multistep(
    loss_fn: Callable[..., torch.Tensor],
    optimizer: Callable[..., Any],
    device: Any,
    n_steps: int = 8,
    accum_steps: int = 1,
) -> Tuple[Callable[..., TrainState], Callable[..., Any]]:
    """Like :func:`make_train_step`, but each call runs ``n_steps``
    optimizer steps.  ``multi_step_fn(state, batch, per_step=False) ->
    (state, losses[n_steps])``; with ``per_step=True`` every batch leaf
    carries a leading ``n_steps`` axis (one batch per step), otherwise
    the single batch is reused by every step."""
    apply_step = _make_apply_step(loss_fn, accum_steps)

    def multi_step_fn(state: TrainState, batch: Any, per_step: bool = False):
        losses = [
            apply_step(state, tuple(b[i] for b in batch) if per_step else batch)
            for i in range(n_steps)
        ]
        new = TrainState(state.params, state.optimizer, state.step + n_steps)
        return new, torch.stack(losses)

    return _init_fn(optimizer, torch.device(device)), multi_step_fn
