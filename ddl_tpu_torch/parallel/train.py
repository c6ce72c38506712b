"""Training steps (port of ``ddl_tpu/parallel/train.py``:
``_make_apply_step``, ``make_train_step`` and ``make_multistep``, on one
device or over a mesh of its positions).

PyTorch runs eagerly, so the JAX package's jitted window ``lax.scan``
becomes a Python loop of per-batch steps with the same math.  The
optimizer is a factory of a ``torch.optim.Optimizer`` over the param
leaves; :func:`adamw` builds one with ``optax.adamw``'s hyper-parameters
(they differ from ``torch.optim.AdamW``'s defaults).

Over a mesh (``mesh=``, ``param_specs=``, ``batch_spec=``) the step runs
on global tensors on the mesh's one device, as GSPMD presents them to
the JAX package's step: a batch that landed as a :class:`~ddl_tpu_torch.
parallel.mesh.ShardedArray` is assembled, the loss closes over the mesh
for its attention, and the distributed-optimizer knobs
(``optimizer_sharding="zero1"``, ``grad_comm="int8"``,
``stochastic_rounding``, ``grad_comm_block``) wrap the optimizer in
:class:`~ddl_tpu_torch.parallel.optimizer.ShardedOptimizer`.  With
``mesh=None`` the steps are the one-device steps.

Over a mesh whose outermost ``dp`` axis spans the processes of a gloo
group (MULTIHOST), each process's step computes loss and grads over its
own rows (:meth:`~ddl_tpu_torch.parallel.mesh.ShardedArray.
assemble_local`), then the grads and the loss cross the group in one
host-staged bucket
(:func:`~ddl_tpu_torch.parallel.collectives.process_mean`) before the
update, so every process applies the same update.  The rule: a loss
built on :func:`~ddl_tpu_torch.models.losses.cross_entropy` (one call a
step: ``next_token_cross_entropy``, ``llama.next_token_loss`` with
``segment_ids``, the pipelined ``next_token_loss_pp``) is a masked sum
over a count, so each process scales its loss and grads by its own
count, the count rides the bucket, and the sums are divided by the
summed count — the loss and gradients of the global batch, whatever
tokens each process keeps.  A loss that makes no such call (or several)
is averaged over the processes, which is the global value only for a
mean over equal row blocks; a loss that is not a masked sum over a count
(a square of means) cannot be split across processes without gathering
the batch.  The JAX package's multihost legs train ``cross_entropy``
losses only.  With ``accum_steps > 1`` the processes' means of
microbatch means are averaged.  ``grad_comm="int8"`` over such a dp
quantizes the reduced grads, as the JAX package does after GSPMD's sum;
``optimizer_sharding="zero1"`` replaces the bucket with the sharded
optimizer's own legs under the same weighting: a reduce-scatter of the
grads, the update of the replicas this process owns, an all-gather of
the updated slices (of their int8 payloads and scales under
``grad_comm="int8"``) —
:meth:`~ddl_tpu_torch.parallel.optimizer.Zero1Optimizer.reduce_step`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
from typing import Any, Callable, List, Tuple

import torch

from ddl_tpu_torch.parallel.mesh import P, ShardedArray, one_card

logger = logging.getLogger(__name__)

#: Valid ``optimizer_sharding`` values for the step factories.
OPTIMIZER_SHARDING = ("none", "zero1")



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


def _maybe_shard_optimizer(optimizer: Any, mesh: Any, param_spec_tree: Any,
                           optimizer_sharding: str, grad_comm: str,
                           stochastic_rounding: bool,
                           grad_comm_block: int) -> Any:
    """Wrap ``optimizer`` in the distributed-optimizer subsystem when the
    config asks for it (:mod:`ddl_tpu_torch.parallel.optimizer`):
    ``"zero1"`` shards state + weight update over dp; ``grad_comm="int8"``
    alone applies only the quantized wire format.  An already-wrapped
    ShardedOptimizer passes through untouched."""
    from ddl_tpu_torch.parallel.optimizer import ShardedOptimizer

    if optimizer_sharding not in OPTIMIZER_SHARDING:
        raise ValueError(
            f"optimizer_sharding must be one of {OPTIMIZER_SHARDING}, "
            f"got {optimizer_sharding!r}"
        )
    if isinstance(optimizer, ShardedOptimizer):
        return optimizer
    if optimizer_sharding == "none" and grad_comm == "fp32":
        return optimizer
    if optimizer_sharding == "zero1" and mesh is None:
        raise ValueError("optimizer_sharding='zero1' needs a mesh")
    return ShardedOptimizer(
        optimizer,
        mesh,
        param_spec_tree,
        axis="dp" if optimizer_sharding == "zero1" else None,
        grad_comm=grad_comm,
        stochastic_rounding=stochastic_rounding,
        block=grad_comm_block or None,
    )


def _lead_extent(mesh: Any, batch_spec: Any) -> int:
    """Mesh extent sharding the batch's LEADING axis (1 if unsharded)."""
    entry = tuple(batch_spec)[0] if tuple(batch_spec) else None
    axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
    ext = 1
    for a in axes:
        if mesh is not None and a in mesh.axis_names:
            ext *= mesh.shape[a]
    return ext


def _global(batch: Any) -> Any:
    """The batch as global tensors: a leaf that landed as a
    :class:`ShardedArray` is assembled on its device (over a mesh that
    spans processes, this process's rows)."""
    if isinstance(batch, ShardedArray):
        return batch.assemble_local()
    if isinstance(batch, (tuple, list)):
        return tuple(_global(b) for b in batch)
    return batch


def _make_apply_step(loss_fn: Callable[..., torch.Tensor],
                     accum_steps: int = 1, lead_divisor: int = 1,
                     mesh: Any = None):
    """One loss/grad/update step, shared by the single- and multi-step
    factories.  ``accum_steps > 1`` splits the batch's leading axis into
    equal microbatches, averages their grads and applies ONE update.
    Over a mesh that spans processes the grads and the loss cross the
    group before the update in one bucket, weighted by the step's
    ``cross_entropy`` count (the module docstring's rule); a ZeRO-1
    optimizer over those processes moves them in its own legs."""
    across = mesh is not None and mesh.spans_processes
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    inv = 1.0 / accum_steps

    def apply_step(state: TrainState, batch: Any) -> torch.Tensor:
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        weight = None
        if accum_steps == 1:
            from ddl_tpu_torch.models.losses import loss_weight

            with loss_weight() if across else contextlib.nullcontext() as scope:
                loss = loss_fn(state.params, batch)
            loss.backward()
            if across:
                weight = scope.weight(None)
        else:
            lead = batch[0].shape[0]
            if lead % accum_steps:
                raise ValueError(
                    f"batch leading dim {lead} is not divisible by "
                    f"accum_steps={accum_steps}"
                )
            if (lead // accum_steps) % lead_divisor:
                # Not incorrect: the microbatches are global tensors; on
                # a mesh the batch-sharded work (attention) then splits
                # unevenly or runs replicated.
                logger.warning(
                    "gradient accumulation: microbatch size %d is not "
                    "divisible by the batch-sharding extent %d",
                    lead // accum_steps, lead_divisor,
                )
            micro = zip(*(b.chunk(accum_steps, dim=0) for b in batch))
            loss = torch.zeros((), device=batch[0].device)
            for mb in micro:
                mb_loss = loss_fn(state.params, tuple(mb))
                (mb_loss * inv).backward()  # grads accumulate in fp32
                loss = loss + mb_loss.detach()
            loss = loss * inv
        loss = loss.detach()
        if across:
            from ddl_tpu_torch.observability import metrics as _metrics

            if getattr(opt, "spans_processes", False):
                opt.reduce_step(loss, weight=weight, metrics=_metrics())
                return loss
            from ddl_tpu_torch.parallel.collectives import process_mean

            leaves = tree_leaves(state.params)
            process_mean([p.grad for p in leaves] + [loss], leaves + [loss],
                         metrics=_metrics(), weight=weight)
        opt.step()
        return loss

    return apply_step


def _init_fn(optimizer: Callable[..., Any], device: torch.device):
    from ddl_tpu_torch.parallel.optimizer import ShardedOptimizer

    def init_fn(params: Any) -> TrainState:
        # Fresh leaves the step may update in place: the caller's tree is
        # never aliased (the JAX package's "jitted identity" copy).
        params = tree_map(
            lambda p: torch.as_tensor(p).detach().to(device, copy=True)
            .requires_grad_(True),
            params,
        )
        opt = (optimizer.init(params) if isinstance(optimizer, ShardedOptimizer)
               else optimizer(tree_leaves(params)))
        return TrainState(params, opt, 0)

    return init_fn


def _resolve(device: Any, mesh: Any) -> torch.device:
    """The step's device: the mesh's one device, or ``device``."""
    if mesh is None:
        if device is None:
            raise ValueError("a step needs a device or a mesh")
        return torch.device(device)
    dev = one_card(mesh.device_list)
    if device is not None and torch.device(device) != dev and not (
            torch.device(device).type == dev.type == "cuda"
            and torch.device(device).index is None):
        raise ValueError(f"device {device} differs from the mesh's {dev}")
    return dev


def _spec_tree(param_specs: Any, param_spec_tree: Any) -> Any:
    """The params' spec tree under either of its two names."""
    if param_specs is not None and param_spec_tree is not None:
        raise ValueError("pass param_specs or param_spec_tree, not both")
    return param_specs if param_specs is not None else param_spec_tree


def make_train_step(
    loss_fn: Callable[..., torch.Tensor],
    optimizer: Callable[..., Any],
    device: Any = None,
    accum_steps: int = 1,
    mesh: Any = None,
    param_specs: Any = None,
    batch_spec: Any = P(("dp",)),
    optimizer_sharding: str = "none",
    grad_comm: str = "fp32",
    stochastic_rounding: bool = False,
    grad_comm_block: int = 0,
    param_spec_tree: Any = None,
) -> Tuple[Callable[..., TrainState], Callable[..., Any]]:
    """Build ``(init_fn, step_fn)`` for a training loop.

    ``loss_fn(params, batch) -> scalar`` over the loader's column tuple;
    ``optimizer(param_list) -> torch.optim.Optimizer`` (e.g.
    :func:`adamw`).  ``step_fn(state, batch) -> (state, loss)`` updates
    the params in place and returns the loss as a device tensor (no
    host sync).

    Over a ``mesh`` of one device's positions: ``param_specs`` (a
    PartitionSpec tree matching the params; axes absent from the mesh are
    dropped) places the sharded optimizer's state, ``batch_spec`` is the
    batch's sharding (its leading axis' extent is the accumulation
    check's divisor), and ``optimizer_sharding`` / ``grad_comm`` /
    ``stochastic_rounding`` / ``grad_comm_block`` mirror
    :class:`ddl_tpu_torch.config.TrainConfig`'s fields.  ``device`` may be
    left out (the mesh's) or must name the mesh's device.
    ``param_spec_tree`` is the JAX package's name of ``param_specs``:
    pass one or the other.

    Over a mesh whose ``dp`` spans processes, a loss that makes one
    :func:`~ddl_tpu_torch.models.losses.cross_entropy` call gives the
    loss and gradients of the global batch (each process's are weighted
    by its mask count).  Any other loss is averaged over the processes:
    a loss that is not a masked sum over a count (a square of means)
    cannot be split across processes without gathering the batch.  The
    JAX package's multihost legs use ``cross_entropy`` losses only.
    """
    dev = _resolve(device, mesh)
    optimizer = _maybe_shard_optimizer(
        optimizer, mesh, _spec_tree(param_specs, param_spec_tree),
        optimizer_sharding, grad_comm,
        stochastic_rounding, grad_comm_block,
    )
    apply_step = _make_apply_step(loss_fn, accum_steps,
                                  _lead_extent(mesh, batch_spec), mesh)

    def step_fn(state: TrainState, batch: Any):
        loss = apply_step(state, _global(batch))
        return TrainState(state.params, state.optimizer, state.step + 1), loss

    return _init_fn(optimizer, dev), step_fn


def make_multistep(
    loss_fn: Callable[..., torch.Tensor],
    optimizer: Callable[..., Any],
    device: Any = None,
    n_steps: int = 8,
    accum_steps: int = 1,
    mesh: Any = None,
    param_specs: Any = None,
    batch_spec: Any = P(("dp",)),
    optimizer_sharding: str = "none",
    grad_comm: str = "fp32",
    stochastic_rounding: bool = False,
    grad_comm_block: int = 0,
    param_spec_tree: Any = None,
) -> Tuple[Callable[..., TrainState], Callable[..., Any]]:
    """Like :func:`make_train_step`, but each call runs ``n_steps``
    optimizer steps.  ``multi_step_fn(state, batch, per_step=False) ->
    (state, losses[n_steps])``; with ``per_step=True`` every batch leaf
    carries a leading ``n_steps`` axis (one batch per step), otherwise
    the single batch is reused by every step.  The distributed-optimizer
    knobs wrap the optimizer once, for the init path and every step."""
    dev = _resolve(device, mesh)
    optimizer = _maybe_shard_optimizer(
        optimizer, mesh, _spec_tree(param_specs, param_spec_tree),
        optimizer_sharding, grad_comm,
        stochastic_rounding, grad_comm_block,
    )
    apply_step = _make_apply_step(loss_fn, accum_steps,
                                  _lead_extent(mesh, batch_spec), mesh)

    def multi_step_fn(state: TrainState, batch: Any, per_step: bool = False):
        batch = _global(batch)
        losses = [
            apply_step(state, tuple(b[i] for b in batch) if per_step else batch)
            for i in range(n_steps)
        ]
        new = TrainState(state.params, state.optimizer, state.step + n_steps)
        return new, torch.stack(losses)

    return _init_fn(optimizer, dev), multi_step_fn
