"""What the plain references share: exact float32 matrix products (or, for
the control, float8 ones), AdamW written out, and the training loop over
row blocks whose readings the comparison takes.

Nothing here imports the system under test: the references are plain
PyTorch, and the weights and batches they train on are made by the
benchmark from the seed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

_E4M3_MAX = 448.0


def exact_float32() -> None:
    """Float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Float8(torch.autograd.Function):
    """Rounds the forward value (``fwd``) and the incoming gradient
    (``bwd``) to float8, so every product of the forward and the backward
    pass takes float8 operands."""

    @staticmethod
    def forward(ctx, x, fwd: bool, bwd: bool):
        ctx.bwd = bwd
        return _e4m3(x) if fwd else x

    @staticmethod
    def backward(ctx, g):
        return (_e4m3(g) if ctx.bwd else g), None, None


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in ``precision``: ``"float32"`` (the reference), or
    ``"float8"`` (the control, one step below the configurations'
    bfloat16: e4m3 operands under per-tensor scales, float32 sums)."""
    if precision == "float32":
        return a @ b
    if precision != "float8":
        raise ValueError(f"unknown precision {precision!r}")
    out = _Float8.apply(a, True, False) @ _Float8.apply(b, True, False)
    return _Float8.apply(out, False, True)


@dataclasses.dataclass
class Readings:
    """What one side of the comparison gives for the judged steps."""

    losses: List[float]  # each judged step's loss
    grad_norms: List[float]  # per leaf: the first step's gradient
    delta_norms: List[float]  # per leaf: the change over the judged steps


def adamw_step(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               m: List[torch.Tensor], v: List[torch.Tensor], step: int,
               hp: Dict[str, float]) -> None:
    """One AdamW update in place (optax's form: the decay multiplies the
    pre-update parameter; eps is added to the bias-corrected root)."""
    lr, b1, b2 = hp["lr"], hp["b1"], hp["b2"]
    c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    with torch.no_grad():
        for p, g, mi, vi in zip(params, grads, m, v):
            p.mul_(1.0 - lr * hp["weight_decay"])
            mi.mul_(b1).add_(g, alpha=1.0 - b1)
            vi.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.sub_((mi / c1) / ((vi / c2).sqrt() + hp["eps"]) * lr)


def train(leaves: List[torch.Tensor],
          block_loss: Callable[[Any, int, int], torch.Tensor],
          batch_count: Callable[[Any], float], batches: Sequence[Any],
          rows: int, block_rows: int, hp: Dict[str, float]) -> Readings:
    """Train ``leaves`` (float32, updated in place) for ``len(batches)``
    AdamW steps.  ``block_loss(batch, lo, hi)`` is the summed loss of rows
    ``lo:hi``, ``batch_count(batch)`` the count the batch's loss is a mean
    over; each step's gradient is that of the mean, accumulated block by
    block."""
    p0 = [p.detach().clone() for p in leaves]
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    losses: List[float] = []
    grad_norms: List[float] = []
    for step, batch in enumerate(batches, start=1):
        for p in leaves:
            p.grad = None
        count = float(batch_count(batch))
        total = 0.0
        for lo in range(0, rows, block_rows):
            part = block_loss(batch, lo, min(lo + block_rows, rows))
            (part / count).backward()
            total += float(part.detach())
        losses.append(total / count)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in leaves]
        if step == 1:
            grad_norms = [float(torch.linalg.vector_norm(g)) for g in grads]
        adamw_step(leaves, grads, m, v, step, hp)
    delta = [float(torch.linalg.vector_norm(p.detach() - q))
             for p, q in zip(leaves, p0)]
    return Readings(losses, grad_norms, delta)


def step_batches(windows: List[Any], traffic: Dict[str, Any],
                 n_steps: int) -> List[Any]:
    """The judged steps' batches: step ``s`` takes batch ``s % spw`` of
    window ``s // spw`` (windows as (rows, features))."""
    B, spw = int(traffic["batch_size"]), int(traffic["steps_per_window"])
    return [windows[s // spw][(s % spw) * B:(s % spw + 1) * B]
            for s in range(n_steps)]
