"""Distributed optimizer: ZeRO-1 cross-replica weight-update sharding
(port of ``ddl_tpu/parallel/optimizer.py``).

The JAX package shards the optimizer state and the weight update over
the ``dp`` axis (reduce-scatter of the grads, a shard-local update, an
all-gather of the update) through sharding constraints.  The port runs
the same split explicitly over the positions of one card:

- **state sharding**: :func:`zero1_sharding` picks, per leaf, the
  dimension that takes the ``dp`` axis (on top of what its spec already
  shards there); replica ``j`` owns the blocks of that dimension whose
  ``dp`` digit is ``j`` — views of the leaf, and, for Adam/AdamW, views
  of full-shaped moment buffers, so the replicas' slices are views of
  the same values and a checkpoint reads each moment whole.
- **reduce-scatter**: each replica's slice of a leaf's grad is a view of
  the grad the backward computed over the global batch (the reduced
  grad); ``grad_comm="int8"`` first rounds it through the int8 wire
  format (:func:`~ddl_tpu_torch.parallel.collectives.quantize_dequantize`).
- **shard-local update**: one inner optimizer per replica over its
  slices (the factory the trainer takes, e.g. ``adamw(lr)``); leaves no
  dimension of which divides stay replicated under one more inner
  optimizer.
- **all-gather**: the slices are views of the leaves, so the fp32 gather
  is the update in place; with ``grad_comm="int8"`` the update
  (new - old) goes through the int8 wire format before it lands.

fp32 ZeRO-1 is bit-equal to the replicated optimizer: the update is
elementwise and the slices are views.  Stochastic rounding keys fold
``seed`` ⊕ phase ⊕ leaf index ⊕ the bits of the leaf's first element,
as the JAX package's do.  Positions over distinct cards raise
``NotImplementedError`` (the multi-card slice).

Observability: ``opt.state_bytes_per_replica`` / ``opt.state_bytes_total``
gauges (at init), ``opt.grad_comm_bytes_raw`` /
``opt.grad_comm_bytes_quantized`` (at the first step) and the
``opt.gather`` / ``opt.scatter`` timers (:meth:`ShardedOptimizer.
measure_legs`), on the process-wide registry as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ddl_tpu_torch.parallel.mesh import (
    NamedSharding,
    P,
    is_spec_leaf,
    named,
    one_card,
    prune_indivisible,
)

#: Relative loss-drift tolerance of the int8 grad-comm parity gate: the
#: quantized run's loss curve must stay within this of the fp32 curve
#: at every compared step (the JAX package's value).
PARITY_REL_TOL = 2e-2

_VALID_GRAD_COMM = ("fp32", "int8")


def _axes_of(entry: Any) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def zero1_sharding(named_sh: NamedSharding, shape: Sequence[int],
                   axis: str = "dp") -> NamedSharding:
    """The dp-extended NamedSharding of one param leaf.

    Adds ``axis`` to the first dimension it divides (on top of whatever
    the spec already shards there); leaves already sharded over ``axis``
    pass through, and a leaf no dimension of which divides stays
    replicated over ``axis``.  The new entry is a tuple of axis names
    (``("dp",)``), as the JAX package builds it."""
    mesh = named_sh.mesh
    if axis not in mesh.axis_names or mesh.shape[axis] <= 1:
        return named_sh
    n_axis = mesh.shape[axis]
    spec = tuple(named_sh.spec)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    if any(axis in _axes_of(e) for e in parts):
        return named_sh
    for i, dim in enumerate(shape):
        axes = _axes_of(parts[i])
        n = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
        if dim % (n * n_axis) == 0:
            parts[i] = axes + (axis,)
            return NamedSharding(mesh, P(*parts))
    return named_sh


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _zip_tree(params: Any, specs: Any) -> List[Tuple[torch.Tensor, Any]]:
    """(leaf, spec) pairs in the params tree's leaf order (the train
    step's ``tree_leaves`` order), specs looked up by the same keys; no
    spec tree (``None``) leaves every leaf unsharded."""
    if specs is None:
        return [(leaf, None) for leaf in _leaves(params)]
    if isinstance(params, dict):
        return [pair for k, v in params.items() for pair in _zip_tree(v, specs[k])]
    if isinstance(params, (list, tuple)):
        return [pair for i, v in enumerate(params)
                for pair in _zip_tree(v, specs[i])]
    if not is_spec_leaf(specs):
        raise ValueError(f"spec tree does not match the params at {specs!r}")
    return [(params, specs)]


@dataclasses.dataclass
class _Leaf:
    """One param leaf's ZeRO-1 layout: ``views[j]`` are replica j's
    slices (views of the leaf), ``dim``/``index[j]`` where they sit."""

    param: torch.Tensor
    views: List[List[torch.Tensor]]
    index: List[List[Tuple[int, int]]]
    dim: int


def _replica_slices(shape: Sequence[int], sh: NamedSharding, axis: str
                    ) -> Optional[Tuple[int, List[List[Tuple[int, int]]]]]:
    """``(dim, [[(start, length), ...] per replica])`` of a zero1
    sharding: the blocks of the dimension carrying ``axis`` whose
    ``axis`` digit (mixed radix over the entry's axes, the first the
    major) is the replica's index.  None when no dimension carries it."""
    mesh = sh.mesh
    for d, entry in enumerate(tuple(sh.spec)):
        axes = _axes_of(entry)
        if axis not in axes:
            continue
        sizes = [mesh.shape[a] for a in axes]
        g = int(np.prod(sizes))
        t = axes.index(axis)
        minor = int(np.prod(sizes[t + 1:]))
        blk = int(shape[d]) // g
        out: List[List[Tuple[int, int]]] = [[] for _ in range(sizes[t])]
        for k in range(g):
            out[(k // minor) % sizes[t]].append((k * blk, blk))
        return d, out
    return None


def _is_adam(opt: torch.optim.Optimizer) -> bool:
    return isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)) and not any(
        g.get("amsgrad") for g in opt.param_groups)


def _fresh_step(opt: torch.optim.Optimizer, p: torch.Tensor) -> torch.Tensor:
    """A zero ``step`` as torch's Adam creates it for ``p``."""
    g = opt.param_groups[0]
    if g.get("capturable") or g.get("fused"):
        return torch.zeros((), dtype=torch.float32, device=p.device)
    return torch.tensor(0.0, dtype=torch.float32)


class ShardedOptimizer:
    """ZeRO-1 over the ``dp`` positions of one card, around an optimizer
    factory ``inner(param_list) -> torch.optim.Optimizer``.

    ``ShardedOptimizer(inner, mesh, param_spec_tree)`` is itself the
    factory the step factories take (they wrap automatically from
    ``optimizer_sharding="zero1"`` or ``grad_comm="int8"``): :meth:`init`
    builds the runtime optimizer over a params tree.

    - ``axis``: the replica axis to shard over (default ``"dp"``); a mesh
      without it (or extent 1) makes the wrapper an exact pass-through
      (modulo ``grad_comm``).
    - ``grad_comm``: ``"fp32"`` (exact) or ``"int8"`` (the EQuARX wire
      format on the grad reduce and the update gather; gate with
      :func:`loss_parity`).
    - ``stochastic_rounding``: the int8 path rounds stochastically —
      unbiased in expectation, deterministic per step.
    """

    def __init__(self, inner: Any, mesh: Any, param_spec_tree: Any,
                 axis: Optional[str] = "dp", grad_comm: str = "fp32",
                 stochastic_rounding: bool = False,
                 block: Optional[int] = None, seed: int = 0):
        from ddl_tpu_torch.parallel.collectives import QUANT_BLOCK

        if grad_comm not in _VALID_GRAD_COMM:
            raise ValueError(
                f"grad_comm must be one of {_VALID_GRAD_COMM}, "
                f"got {grad_comm!r}"
            )
        if mesh is not None:
            one_card(mesh.device_list)
        self._inner = inner
        self.mesh = mesh
        self.spec_tree = param_spec_tree
        self.axis = axis
        self.grad_comm = grad_comm
        self.stochastic_rounding = bool(stochastic_rounding)
        self.block = int(block or QUANT_BLOCK)
        self.seed = int(seed)
        # axis=None: the wrapper applies ONLY the grad_comm wire format
        # (the optimizer_sharding="none", grad_comm="int8" combination).
        self.active = (
            axis is not None
            and mesh is not None
            and axis in mesh.axis_names
            and mesh.shape[axis] > 1
        )
        self.n_replicas = mesh.shape[axis] if self.active else 1

    def shardings(self, params: Any) -> List[Tuple[NamedSharding, NamedSharding]]:
        """(param sharding, zero1 sharding) of each leaf, in the params
        tree's leaf order."""
        out = []
        for leaf, spec in _zip_tree(params, self.spec_tree):
            sh = prune_indivisible(named(self.mesh, spec), leaf)
            out.append((sh, zero1_sharding(sh, tuple(leaf.shape), self.axis)))
        return out

    def init(self, params: Any) -> "Zero1Optimizer":
        return Zero1Optimizer(self, params)

    # -- legs -----------------------------------------------------------------

    def measure_legs(self, params: Any, metrics: Any = None,
                     trials: int = 3) -> Dict[str, float]:
        """Wall time of the two legs on a params-sized tree: ``gather``
        (every replica's slices copied into a whole leaf — the gather the
        update pays) and ``scatter`` (each replica's slices copied out of
        the whole leaf).  On one card both are device copies; recorded
        into the ``opt.gather`` / ``opt.scatter`` timers."""
        from ddl_tpu_torch.observability import metrics as default_metrics

        m = metrics or default_metrics()
        if not self.active:
            return {"gather_s": 0.0, "scatter_s": 0.0}
        leaves = [leaf for leaf, _ in _zip_tree(params, self.spec_tree)]
        layouts = [_replica_slices(leaf.shape, z1, self.axis)
                   for leaf, (_, z1) in zip(leaves, self.shardings(params))]
        shards = [[leaf.detach().narrow(lay[0], s, n).clone()
                   for rep in lay[1] for s, n in rep] if lay else [leaf.detach()]
                  for leaf, lay in zip(leaves, layouts)]

        def gather():
            for leaf, lay, parts in zip(leaves, layouts, shards):
                out = torch.empty_like(leaf)
                if lay is None:
                    out.copy_(parts[0])
                    continue
                it = iter(parts)
                for rep in lay[1]:
                    for s, n in rep:
                        out.narrow(lay[0], s, n).copy_(next(it))

        def scatter():
            for leaf, lay in zip(leaves, layouts):
                if lay is not None:
                    for rep in lay[1]:
                        for s, n in rep:
                            leaf.detach().narrow(lay[0], s, n).clone()

        out = {}
        for name, fn in (("gather", gather), ("scatter", scatter)):
            fn()
            _sync(leaves)
            best = float("inf")
            for _ in range(trials):
                t0 = time.perf_counter()
                fn()
                _sync(leaves)
                best = min(best, time.perf_counter() - t0)
            m.add_time(f"opt.{name}", best)
            out[f"{name}_s"] = best
        return out


def _sync(leaves: Sequence[torch.Tensor]) -> None:
    if leaves and leaves[0].device.type == "cuda":
        torch.cuda.synchronize(leaves[0].device)


class Zero1Optimizer:
    """The runtime ZeRO-1 optimizer over one params tree (what
    :meth:`ShardedOptimizer.init` returns; the train state's
    ``optimizer``).  Speaks the part of ``torch.optim.Optimizer`` the
    train step and checkpoints use: ``zero_grad``, ``step``,
    ``state_dict`` / ``load_state_dict``; :attr:`state` maps each leaf to
    its whole-leaf Adam state."""

    def __init__(self, cfg: ShardedOptimizer, params: Any):
        self.cfg = cfg
        self.params = _leaves(params)
        self.leaves: List[_Leaf] = []
        replicated: List[torch.Tensor] = []
        if cfg.active:
            for leaf, (_, z1) in zip(self.params, cfg.shardings(params)):
                lay = _replica_slices(tuple(leaf.shape), z1, cfg.axis)
                if lay is None:
                    replicated.append(leaf)
                    continue
                d, index = lay
                base = leaf.detach()
                self.leaves.append(_Leaf(
                    leaf, [[base.narrow(d, s, n) for s, n in rep]
                           for rep in index], index, d))
        else:
            replicated = list(self.params)
        self.replicated = [leaf.detach() for leaf in replicated]
        self._replicated_of = {id(leaf): v for leaf, v in
                               zip(replicated, self.replicated)}
        n = cfg.n_replicas
        self.replicas = [
            cfg._inner([v for lf in self.leaves for v in lf.views[j]])
            for j in range(n)
        ] if self.leaves else []
        self.whole = cfg._inner(self.replicated) if self.replicated else None
        # One entry a sharded leaf, filled here and never grown.
        self._moments: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}  # ddl-lint: disable=DDL013
        if self.replicas and _is_adam(self.replicas[0]):
            self._share_moments()
        self._comm_recorded = False
        if cfg.active:
            self._record_state_bytes()

    # -- state layout -----------------------------------------------------

    def _share_moments(self) -> None:
        """Adam's moments as full-shaped buffers, each replica's state a
        view of its slices: the replicas' states are views of the same
        values (what a checkpoint reads whole)."""
        for lf in self.leaves:
            mu = torch.zeros_like(lf.param, memory_format=torch.preserve_format)
            nu = torch.zeros_like(lf.param, memory_format=torch.preserve_format)
            self._moments[id(lf.param)] = (mu, nu)
            for j, opt in enumerate(self.replicas):
                for v, (s, n) in zip(lf.views[j], lf.index[j]):
                    opt.state[v] = {
                        "step": _fresh_step(opt, v),
                        "exp_avg": mu.detach().narrow(lf.dim, s, n),
                        "exp_avg_sq": nu.detach().narrow(lf.dim, s, n),
                    }

    @property
    def is_adam(self) -> bool:
        opts = self.replicas + ([self.whole] if self.whole is not None else [])
        return bool(opts) and all(_is_adam(o) for o in opts) and (
            not self.replicas or bool(self._moments))

    @property
    def state(self) -> Dict[torch.Tensor, Dict[str, torch.Tensor]]:
        """Each leaf's Adam state, whole: ``step`` (a replica's), and the
        full-shaped ``exp_avg`` / ``exp_avg_sq``."""
        out: Dict[torch.Tensor, Dict[str, torch.Tensor]] = {}
        for lf in self.leaves:
            mu, nu = self._moments[id(lf.param)]
            out[lf.param] = {"step": self.replicas[0].state[lf.views[0][0]]["step"],
                             "exp_avg": mu, "exp_avg_sq": nu}
        if self.whole is not None:
            for leaf in self.params:
                rv = self._replicated_of.get(id(leaf))
                if rv is not None and self.whole.state.get(rv):
                    out[leaf] = self.whole.state[rv]
        return out

    def load_leaf_state(self, leaf: torch.Tensor, count: int,
                        exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor) -> None:
        """Set one leaf's Adam state from whole-leaf moments (a restored
        generation)."""
        moments = self._moments.get(id(leaf))
        if moments is not None:
            with torch.no_grad():
                moments[0].copy_(exp_avg)
                moments[1].copy_(exp_avg_sq)
            lf = next(x for x in self.leaves if x.param is leaf)
            for j, opt in enumerate(self.replicas):
                for v in lf.views[j]:
                    opt.state[v]["step"] = torch.full_like(
                        opt.state[v]["step"], float(count))
            return
        rv = self._replicated_of[id(leaf)]
        old = self.whole.state.get(rv)
        step = (torch.full_like(old["step"], float(count)) if old
                else torch.tensor(float(count), dtype=torch.float32))
        self.whole.state[rv] = {"step": step, "exp_avg": exp_avg.to(leaf.device),
                                "exp_avg_sq": exp_avg_sq.to(leaf.device)}

    def _optimizers(self) -> List[torch.optim.Optimizer]:
        return self.replicas + ([self.whole] if self.whole is not None else [])

    def state_dict(self) -> dict:
        return {"replicas": [o.state_dict() for o in self.replicas],
                "whole": None if self.whole is None else self.whole.state_dict()}

    def load_state_dict(self, saved: dict) -> None:
        for o, sd in zip(self.replicas, saved["replicas"]):
            if self._moments:
                # Into the shared buffers, keeping the views.
                for slot, st in sd["state"].items():
                    v = o.param_groups[0]["params"][slot]
                    cur = o.state[v]
                    with torch.no_grad():
                        cur["exp_avg"].copy_(st["exp_avg"])
                        cur["exp_avg_sq"].copy_(st["exp_avg_sq"])
                    cur["step"] = st["step"].clone().to(cur["step"].device)
            else:
                o.load_state_dict(sd)
        if self.whole is not None and saved["whole"] is not None:
            self.whole.load_state_dict(saved["whole"])

    # -- the step ---------------------------------------------------------

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()
        for lf in self.leaves:
            for rep in lf.views:
                for v in rep:
                    v.grad = None
        for v in self.replicated:
            v.grad = None

    def _key(self, leaf_idx: int, x: torch.Tensor, phase: int) -> Any:
        """seed ⊕ phase ⊕ leaf index ⊕ the bits of the first element."""
        first = int(x.reshape(-1)[:1].float().view(torch.int32).item())
        return (self.cfg.seed + 7919 * phase, leaf_idx, first & 0xFFFFFFFF)

    def _qdq(self, x: torch.Tensor, leaf_idx: int, phase: int) -> torch.Tensor:
        from ddl_tpu_torch.parallel.collectives import quantize_dequantize

        cfg = self.cfg
        key = (self._key(leaf_idx, x, phase) if cfg.stochastic_rounding
               else None)
        return quantize_dequantize(x, cfg.block,
                                   stochastic=cfg.stochastic_rounding, key=key)

    @torch.no_grad()
    def step(self) -> None:
        """reduce-scatter → shard-local inner update → all-gather."""
        cfg = self.cfg
        int8 = cfg.grad_comm == "int8"
        if not self._comm_recorded:
            self._record_comm_bytes()
        grads = {}
        for i, p in enumerate(self.params):
            g = p.grad
            if g is not None and int8 and g.dim() > 0:
                g = self._qdq(g, i, phase=0)
            grads[id(p)] = g
        for lf in self.leaves:
            g = grads[id(lf.param)]
            for j, rep in enumerate(lf.views):
                for v, (s, n) in zip(rep, lf.index[j]):
                    v.grad = None if g is None else g.narrow(lf.dim, s, n)
        for p in self.params:
            rv = self._replicated_of.get(id(p))
            if rv is not None:
                rv.grad = grads[id(p)]
        old = ([p.detach().clone() for p in self.params]
               if int8 and cfg.active else None)
        for opt in self._optimizers():
            opt.step()
        if old is None:
            return
        # The all-gather of the update in the int8 wire format.
        for i, (p, before) in enumerate(zip(self.params, old)):
            if p.dim() == 0 or p.grad is None:
                continue
            upd = self._qdq(p.detach() - before, i, phase=1)
            p.detach().copy_(before + upd)

    # -- observability ----------------------------------------------------

    def _record_state_bytes(self) -> None:
        from ddl_tpu_torch.observability import metrics as default_metrics

        m = default_metrics()
        m.set_gauge("opt.state_bytes_total", float(sum(
            _nbytes(t) for t in _state_tensors(self))))
        m.set_gauge("opt.state_bytes_per_replica",
                    float(state_bytes_per_replica(self, self.cfg.axis)))

    def _record_comm_bytes(self) -> None:
        from ddl_tpu_torch.observability import metrics as default_metrics
        from ddl_tpu_torch.parallel.collectives import quantized_bytes

        self._comm_recorded = True
        raw = 2 * sum(_nbytes(p) for p in self.params)
        quant = 2 * sum(
            quantized_bytes(tuple(p.shape), self.cfg.block) if p.dim() > 0
            else p.element_size() for p in self.params)
        m = default_metrics()
        m.set_gauge("opt.grad_comm_bytes_raw", float(raw))
        m.set_gauge("opt.grad_comm_bytes_quantized",
                    float(quant if self.cfg.grad_comm == "int8" else raw))


def _leaves(tree: Any) -> List[Any]:
    from ddl_tpu_torch.parallel.train import tree_leaves

    return tree_leaves(tree)


def _state_tensors(opt: Any, axis: Optional[str] = None) -> List[torch.Tensor]:
    """Every state tensor of a torch optimizer or a
    :class:`Zero1Optimizer` (all replicas), or, with ``axis`` the axis a
    Zero1Optimizer shards over, those one replica stores: replica 0's
    slices and the replicated leaves' whole state."""
    if isinstance(opt, Zero1Optimizer):
        per_replica = axis is not None and opt.cfg.active and opt.cfg.axis == axis
        opts = (opt.replicas[:1] if per_replica else opt.replicas) + (
            [opt.whole] if opt.whole is not None else [])
    else:
        opts = [opt]
    return [t for o in opts for st in o.state.values() for t in st.values()
            if isinstance(t, torch.Tensor)]


def state_bytes_per_replica(optimizer: Any, axis: str = "dp",
                            moments_only: bool = False) -> int:
    """Optimizer-state bytes STORED per data-parallel replica along
    ``axis``.  A plain ``torch.optim`` optimizer is replicated: all its
    state.  A :class:`Zero1Optimizer` over ``axis``: one replica's slices
    of the sharded leaves plus the replicated leaves' whole state, so
    this shrinks ~dp x.  ``moments_only`` leaves out the 0-d tensors
    (torch keeps one fp32 ``step`` a leaf where optax keeps one int32
    count)."""
    return sum(_nbytes(t) for t in _state_tensors(optimizer, axis)
               if not (moments_only and t.dim() == 0))


# -- HBM accounting ----------------------------------------------------------


@dataclasses.dataclass
class HbmAccount:
    """Per-device HBM bytes of the persistent training residents."""

    param_bytes: int
    grad_bytes: int
    opt_state_bytes: int

    @property
    def total_bytes(self) -> int:
        return self.param_bytes + self.grad_bytes + self.opt_state_bytes


def hbm_accounting(
    shape_tree: Any,
    spec_tree: Any,
    mesh_axes: Dict[str, int],
    optimizer_sharding: str = "none",
    axis: str = "dp",
    moments_per_param: int = 2,
) -> HbmAccount:
    """Analytic per-device bytes for params + grads + optimizer state.

    Pure shape/spec arithmetic over a tree of tensors with ``shape`` and
    ``dtype`` (e.g. ``llama.param_shapes(cfg)``, meta tensors) and a
    mesh-shape dict — no device needed.  Mirrors :func:`~ddl_tpu_torch.
    parallel.mesh.prune_indivisible`: a spec axis only shards a dimension
    it divides.  ``moments_per_param``: Adam/AdamW keep 2 param-shaped
    moments, SGD with momentum 1.  Transient peaks are out of scope.
    """

    def shard_extent(spec: Any, shape: Any, extra_axis: bool) -> int:
        parts = list(tuple(spec)) + [None] * (len(shape) - len(tuple(spec)))
        ext = 1
        extra_placed = not extra_axis
        for i, dim in enumerate(shape):
            axes = tuple(
                a for a in _axes_of(parts[i]) if mesh_axes.get(a, 1) > 1
            )
            n = int(np.prod([mesh_axes[a] for a in axes])) if axes else 1
            if n > 1 and dim % n == 0:
                ext *= n
            else:
                n = 1  # degrades replicated, as prune_indivisible would
            if not extra_placed and dim % (n * mesh_axes.get(axis, 1)) == 0:
                ext *= mesh_axes.get(axis, 1)
                extra_placed = True
        return ext

    if optimizer_sharding not in ("none", "zero1"):
        raise ValueError(
            f"optimizer_sharding must be 'none' or 'zero1', "
            f"got {optimizer_sharding!r}"
        )
    pairs = _zip_tree(shape_tree, spec_tree)
    zero1 = optimizer_sharding == "zero1"
    p_bytes = g_bytes = o_bytes = 0
    for leaf, spec in pairs:
        spec = spec if isinstance(spec, P) else P()
        shape = tuple(leaf.shape)
        itemsize = torch.empty((), dtype=leaf.dtype).element_size()
        nbytes = int(np.prod(shape) or 1) * itemsize
        base = shard_extent(spec, shape, extra_axis=False)
        p_bytes += nbytes // base
        g_bytes += nbytes // base
        z1 = shard_extent(spec, shape, extra_axis=True) if zero1 else base
        o_bytes += moments_per_param * (nbytes // z1)
    return HbmAccount(p_bytes, g_bytes, o_bytes)


# -- the parity gate ---------------------------------------------------------


def loss_parity(ref_losses: Any, test_losses: Any,
                rel_tol: float = PARITY_REL_TOL) -> Dict[str, Any]:
    """The loss-curve-parity gate the int8 path is licensed by: two
    per-step loss sequences (same init, same batches) and
    ``{"parity": bool, "max_rel_drift": float, "rel_tol": ...}`` —
    parity holds when every step's relative drift stays under
    ``rel_tol``.  fp32 ZeRO-1 gives ``max_rel_drift == 0.0``."""
    ref = np.asarray(ref_losses, dtype=np.float64)
    test = np.asarray(test_losses, dtype=np.float64)
    if ref.shape != test.shape:
        raise ValueError(
            f"loss curves differ in length: {ref.shape} vs {test.shape}"
        )
    denom = np.maximum(np.abs(ref), 1e-12)
    drift = float(np.max(np.abs(test - ref) / denom)) if ref.size else 0.0
    return {
        "parity": bool(drift <= rel_tol),
        "max_rel_drift": drift,
        "rel_tol": float(rel_tol),
    }
