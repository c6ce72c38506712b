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

MULTIHOST (a mesh whose outermost ``dp`` axis spans the processes of a
gloo group): replica ``j`` belongs to the process that holds the dp
index ``j`` (``mesh.processes``), and each process builds inner
optimizers, and allocates moments, only for the replicas it owns, so
its state is its share of the total.  A step is the JAX package's
lowering made explicit over gloo, in host-staged page-locked buckets
(:meth:`Zero1Optimizer.reduce_step`):

- **scatter leg**: every sharded leaf's local grad goes into one flat
  fp32 bucket laid out replica-major (:class:`ReplicaLayout`: replica by
  replica, leaf by leaf, block by block), so each process's share is one
  contiguous chunk, and one ``all_to_all_single`` hands each process its
  chunk of every process's bucket, summed in rank order (gloo's own
  ``reduce_scatter_tensor`` is an all-reduce and a slice).  Each
  process scales its grads by its ``cross_entropy`` count first, as
  :func:`~ddl_tpu_torch.parallel.collectives.process_mean` does; the
  replicated leaves' grads, the loss, the count and (under stochastic
  int8) each process's first grad element of every sharded leaf, in its
  rank's slot, ride one small ``all_reduce`` bucket; the sums are divided
  by the summed count, and the first elements are summed in rank order,
  as the chunks are (the phase-0 keys fold the reduced element's bits).
- **shard-local update** on the owned slices (``grad_comm="int8"``
  quantizes the reduced grad slices first, phase 0).
- **gather leg**: fp32 — one ``all_gather_into_tensor`` of the owned
  updated slices into every process's leaves; int8 — the owned update
  slices (new - old) quantize (phase 1), their int8 payloads and fp32
  block scales go through one all-gather of a byte bucket as they are,
  and every process dequantizes and applies ``before + update``: the
  reference's s8 all-gather.

Every slice quantizes as its part of the whole leaf, as the reference
quantizes the logical leaf: a slice along the last dim must start and
end on a block edge (``ValueError`` naming the leaf otherwise);
stochastic draws are the leaf's draws, sliced; the phase-1 keys' first
elements are broadcast from replica 0's owner.  The legs record
``mh.scatter`` / ``mh.scatter_bytes`` (the reduce-scatter's input),
``mh.gather`` / ``mh.gather_bytes`` (this process's part of the
all-gather) and the small bucket under ``mh.allreduce`` /
``mh.allreduce_bytes``, on the process-wide registry.  Checkpoints gather
the moment slices to rank 0 (:meth:`Zero1Optimizer.state_dict`,
:meth:`Zero1Optimizer.whole_state`; every rank calls them) and write the
one-process format; a restore loads only the owned slices.

Observability: ``opt.state_bytes_per_replica`` / ``opt.state_bytes_total``
gauges (at init; over a process-spanning mesh ``opt.state_bytes_local``
is what this process allocated), ``opt.grad_comm_bytes_raw`` /
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


def _leaf_paths(tree: Any, prefix: str = "") -> List[str]:
    """Each leaf's path (``layers/0/wq``), in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _leaf_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/") or "."]


def owned_replicas(mesh: Any, axis: str) -> List[int]:
    """The replicas of ``axis`` this process owns over a process-spanning
    mesh: replica ``j`` belongs to the process holding dp index ``j``.
    The axis must be the outermost, and every process must own an equal
    contiguous run of replicas in rank order (what :func:`~ddl_tpu_torch.
    parallel.mesh.make_mesh` lays out under a group), so that each
    process's share of a replica-major bucket is one chunk."""
    from ddl_tpu_torch.parallel.mesh import process_count, process_rank

    if mesh.axis_names[0] != axis:
        raise ValueError(
            f"ZeRO-1 over a process-spanning mesh shards over its outermost "
            f"axis; {axis!r} is not {mesh.axis_names[0]!r}")
    n = mesh.shape[axis]
    owners = mesh.processes.reshape(n, -1)[:, 0]
    world, rank = process_count(), process_rank()
    k = n // world
    if n % world or owners.tolist() != [j // k for j in range(n)]:
        raise ValueError(
            f"ZeRO-1 over processes needs each of the {world} processes to "
            f"own an equal contiguous run of the {n} {axis!r} replicas in "
            f"rank order; the owners are {owners.tolist()}")
    return list(range(rank * k, (rank + 1) * k))


class ReplicaLayout:
    """The replica-major layout of the sharded leaves' slices in a flat
    bucket: replica ``j``'s region is ``[j * size, (j + 1) * size)`` (or
    its position among the replicas a bucket holds); inside it, leaf by
    leaf in the optimizer's order of sharded leaves, block by block, each
    block's elements in C order of its shape.  Every replica's region has
    the same structure, since its blocks have equal shapes.

    :meth:`quantized` gives the byte layout of the int8 gather: per
    replica the fp32 block scales of every block, then the int8 payloads,
    the region padded to 4 bytes (so every replica's scales stay
    fp32-aligned)."""

    def __init__(self, leaves: Sequence["_Leaf"]):
        self.leaves = list(leaves)
        self.offsets: List[List[Tuple[int, Tuple[int, ...]]]] = []
        off = 0
        for lf in self.leaves:
            row = []
            for _s, n in lf.index[0]:
                shape = list(lf.param.shape)
                shape[lf.dim] = n
                row.append((off, tuple(shape)))
                off += int(np.prod(shape))
            self.offsets.append(row)
        #: Elements of one replica's region.
        self.size = off

    def pieces(self, host: torch.Tensor, replicas: Sequence[int],
               regions: Optional[Sequence[int]] = None):
        """``(replica, leaf position, block position, view of host)`` for
        every block of ``replicas`` (their regions ``regions``, default
        ``0, 1, ...``), in bucket order."""
        regions = range(len(replicas)) if regions is None else regions
        for r, j in zip(regions, replicas):
            base = r * self.size
            for li, row in enumerate(self.offsets):
                for b, (o, shape) in enumerate(row):
                    numel = int(np.prod(shape))
                    yield j, li, b, host[base + o:base + o + numel].view(shape)

    def quantized(self, block: int) -> Tuple[int, List[List[Tuple[int, Tuple[int, ...], int]]]]:
        """``(region bytes, [[(scale offset, scale shape, payload offset)
        per block] per leaf])`` of the int8 gather's byte bucket; offsets
        in bytes from the region's start."""
        rows, off = [], 0
        for row in self.offsets:
            out = []
            for _o, shape in row:
                sshape = tuple(shape[:-1]) + (-(-shape[-1] // block),)
                out.append([off, sshape, 0])
                off += 4 * int(np.prod(sshape))
            rows.append(out)
        for row, orow in zip(self.offsets, rows):
            for (_o, shape), entry in zip(row, orow):
                entry[2] = off
                off += int(np.prod(shape))
        return off + (-off) % 4, [[tuple(e) for e in r] for r in rows]

    def qpieces(self, host: torch.Tensor, block: int, replicas: Sequence[int],
                regions: Optional[Sequence[int]] = None):
        """``(replica, leaf position, block position, scales view, payload
        view)`` of every block of ``replicas`` in the uint8 bucket
        ``host`` (:meth:`quantized`'s layout)."""
        size, rows = self.quantized(block)
        regions = range(len(replicas)) if regions is None else regions
        for r, j in zip(regions, replicas):
            base = r * size
            for li, (row, qrow) in enumerate(zip(self.offsets, rows)):
                for b, ((_o, shape), (so, sshape, po)) in enumerate(zip(row, qrow)):
                    ns, npay = int(np.prod(sshape)), int(np.prod(shape))
                    scales = host[base + so:base + so + 4 * ns].view(
                        torch.float32).view(sshape)
                    payload = host[base + po:base + po + npay].view(
                        torch.int8).view(shape)
                    yield j, li, b, scales, payload


def _reduce_scatter(inp: torch.Tensor, recv: torch.Tensor,
                    world: int) -> torch.Tensor:
    """The scatter leg: one gloo ``all_to_all_single`` hands each process
    its chunk of every process's bucket ``inp`` (into ``recv``), and the
    chunks are summed here in rank order — a reduce-scatter in the bytes
    it moves.  gloo's own ``reduce_scatter_tensor`` all-reduces the whole
    bucket and keeps a slice, which moves an all-reduce's bytes
    (``tools/torch_gloo_legs.py`` times both).  Returns the summed chunk,
    a view of ``recv``."""
    import torch.distributed as dist

    dist.all_to_all_single(recv, inp)
    size = recv.numel() // world
    acc = recv[:size]
    for r in range(1, world):
        acc.add_(recv[r * size:(r + 1) * size])
    return acc


def _all_gather(out: torch.Tensor, inp: torch.Tensor) -> None:
    import torch.distributed as dist

    fn = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    fn(out, inp)


def _bits(x: torch.Tensor) -> int:
    """The fp32 bits of a tensor's first element (the stochastic keys'
    data-derived fold)."""
    return int(x.reshape(-1)[:1].float().view(torch.int32).item())


class Zero1Optimizer:
    """The runtime ZeRO-1 optimizer over one params tree (what
    :meth:`ShardedOptimizer.init` returns; the train state's
    ``optimizer``).  Speaks the part of ``torch.optim.Optimizer`` the
    train step and checkpoints use: ``zero_grad``, ``step``,
    ``state_dict`` / ``load_state_dict``; :attr:`state` maps each leaf to
    its whole-leaf Adam state.

    Over a process-spanning mesh (:attr:`spans_processes`) it holds inner
    optimizers and moments for :attr:`owned` replicas only; a step is
    :meth:`reduce_step` (the gloo legs), and the whole moments exist only
    as :meth:`whole_state` / :meth:`state_dict` gather them to rank 0."""

    def __init__(self, cfg: ShardedOptimizer, params: Any):
        self.cfg = cfg
        self.params = _leaves(params)
        self.names = _leaf_paths(params)
        self.leaves: List[_Leaf] = []
        replicated: List[torch.Tensor] = []
        self.spans_processes = bool(cfg.active and cfg.mesh.spans_processes)
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
        #: The replicas whose inner optimizer and state this process holds.
        self.owned = (owned_replicas(cfg.mesh, cfg.axis) if self.spans_processes
                      else list(range(cfg.n_replicas)))
        self._leaf_pos = {id(lf.param): i for i, lf in enumerate(self.leaves)}
        self._index = {id(p): i for i, p in enumerate(self.params)}
        self.replicated = [leaf.detach() for leaf in replicated]
        self._replicated_of = {id(leaf): v for leaf, v in
                               zip(replicated, self.replicated)}
        self.replicas = [
            cfg._inner([v for lf in self.leaves for v in lf.views[j]])
            for j in self.owned
        ] if self.leaves else []
        self.whole = cfg._inner(self.replicated) if self.replicated else None
        # One entry a sharded leaf, filled here and never grown.
        self._moments: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}  # ddl-lint: disable=DDL013
        if self.replicas and _is_adam(self.replicas[0]):
            if self.spans_processes:
                self._own_moments()
            else:
                self._share_moments()
        self.layout = ReplicaLayout(self.leaves) if self.spans_processes else None
        if self.spans_processes and cfg.grad_comm == "int8":
            self._check_block_edges()
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

    def _own_moments(self) -> None:
        """Adam's moments for the owned replicas' slices only, allocated
        now (what ``torch.optim.Adam`` would allocate at its first step):
        this process's share of the state, not the whole."""
        for opt, j in zip(self.replicas, self.owned):
            for lf in self.leaves:
                for v in lf.views[j]:
                    opt.state[v] = {
                        "step": _fresh_step(opt, v),
                        "exp_avg": torch.zeros(v.shape, dtype=v.dtype,
                                               device=v.device),
                        "exp_avg_sq": torch.zeros(v.shape, dtype=v.dtype,
                                                  device=v.device),
                    }

    def _check_block_edges(self) -> None:
        """The int8 slices must be parts of the whole leaf's quantization:
        a slice along the last dim starts and ends on a block edge."""
        block = self.cfg.block
        for lf in self.leaves:
            last = lf.param.shape[-1]
            if lf.dim != lf.param.dim() - 1:
                continue
            for rep in lf.index:
                for s, n in rep:
                    if s % block or ((s + n) % block and s + n != last):
                        name = self.names[self._index[id(lf.param)]]
                        raise ValueError(
                            f"ZeRO-1 int8 over processes: leaf {name!r} of "
                            f"shape {tuple(lf.param.shape)} is sliced along "
                            f"its last dim into [{s}, {s + n}), which cuts its "
                            f"quantization blocks of {block} values; pick a "
                            "grad_comm_block that divides the slices")

    @property
    def is_adam(self) -> bool:
        opts = self.replicas + ([self.whole] if self.whole is not None else [])
        return bool(opts) and all(_is_adam(o) for o in opts) and (
            not self.replicas or bool(self._moments) or self.spans_processes)

    @property
    def state(self) -> Dict[torch.Tensor, Dict[str, torch.Tensor]]:
        """Each leaf's Adam state, whole: ``step`` (a replica's), and the
        full-shaped ``exp_avg`` / ``exp_avg_sq``.  Over a process-spanning
        mesh no process holds them whole: :meth:`whole_state` gathers
        them (a collective)."""
        if self.spans_processes:
            raise RuntimeError(
                "the moments of a ZeRO-1 optimizer over processes are "
                "sharded; whole_state() gathers them to rank 0 (every rank "
                "must call it)")
        out: Dict[torch.Tensor, Dict[str, torch.Tensor]] = {}
        for lf in self.leaves:
            mu, nu = self._moments[id(lf.param)]
            out[lf.param] = {"step": self.replicas[0].state[lf.views[0][0]]["step"],
                             "exp_avg": mu, "exp_avg_sq": nu}
        out.update(self._whole_entries())
        return out

    def _whole_entries(self) -> Dict[torch.Tensor, Dict[str, torch.Tensor]]:
        out = {}
        if self.whole is not None:
            for leaf in self.params:
                rv = self._replicated_of.get(id(leaf))
                if rv is not None and self.whole.state.get(rv):
                    out[leaf] = self.whole.state[rv]
        return out

    def _moment_keys(self) -> List[str]:
        """The state entries shaped like their slice (Adam's moments), in
        a fixed order; 0-d entries (``step``) are the same on every
        replica."""
        if not self.replicas:
            return []
        v = self.leaves[0].views[self.owned[0]][0]
        st = self.replicas[0].state.get(v, {})
        return sorted(k for k, t in st.items() if isinstance(t, torch.Tensor)
                      and tuple(t.shape) == tuple(v.shape) and t.dim() > 0)

    def _gather_moments(self) -> Optional[Dict[str, List[torch.Tensor]]]:
        """Every replica's moment slices, gathered to rank 0 whole: ``{key:
        [the whole-leaf host tensor per sharded leaf]}`` on rank 0, None on
        the other ranks.  A collective: every rank calls it."""
        import torch.distributed as dist

        from ddl_tpu_torch.parallel.mesh import process_count, process_rank

        keys, lay = self._moment_keys(), self.layout
        k, world = len(self.owned), process_count()
        chunk = k * lay.size
        send = torch.empty(len(keys) * chunk, dtype=torch.float32)
        for ki, key in enumerate(keys):
            part = send[ki * chunk:(ki + 1) * chunk]
            for j, li, b, piece in lay.pieces(part, self.owned):
                opt = self.replicas[self.owned.index(j)]
                piece.copy_(opt.state[self.leaves[li].views[j][b]][key])
        rank0 = process_rank() == 0
        recv = [torch.empty_like(send) for _ in range(world)] if rank0 else None
        if keys:
            dist.gather(send, gather_list=recv, dst=0)
        if not rank0:
            return None
        out: Dict[str, List[torch.Tensor]] = {}
        for ki, key in enumerate(keys):
            whole = [torch.empty(lf.param.shape, dtype=lf.param.dtype)
                     for lf in self.leaves]
            for r in range(world):
                part = recv[r][ki * chunk:(ki + 1) * chunk]
                for j, li, b, piece in lay.pieces(
                        part, list(range(r * k, (r + 1) * k))):
                    lf = self.leaves[li]
                    s, n = lf.index[j][b]
                    whole[li].narrow(lf.dim, s, n).copy_(piece)
            out[key] = whole
        return out

    def whole_state(self) -> Optional[Dict[torch.Tensor, Dict[str, torch.Tensor]]]:
        """:attr:`state`, also over a process-spanning mesh: there every
        rank must call it (the moment slices are gathered to rank 0, on
        the host), and ranks other than 0 get None."""
        if not self.spans_processes:
            return self.state
        moments = self._gather_moments()
        if moments is None:
            return None
        out: Dict[torch.Tensor, Dict[str, torch.Tensor]] = {}
        for li, lf in enumerate(self.leaves):
            st = {"step": self.replicas[0].state[
                lf.views[self.owned[0]][0]]["step"]}
            st.update({key: moments[key][li] for key in moments})
            out[lf.param] = st
        out.update(self._whole_entries())
        return out

    def load_leaf_state(self, leaf: torch.Tensor, count: int,
                        exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor) -> None:
        """Set one leaf's Adam state from whole-leaf moments (a restored
        generation); over processes, this process's slices of them."""
        moments = self._moments.get(id(leaf))
        if moments is not None:
            with torch.no_grad():
                moments[0].copy_(exp_avg)
                moments[1].copy_(exp_avg_sq)
        if id(leaf) in self._leaf_pos:
            lf = self.leaves[self._leaf_pos[id(leaf)]]
            for opt, j in zip(self.replicas, self.owned):
                for v, (s, n) in zip(lf.views[j], lf.index[j]):
                    st = opt.state[v]
                    st["step"] = torch.full_like(st["step"], float(count))
                    if moments is None:
                        with torch.no_grad():
                            st["exp_avg"].copy_(exp_avg.narrow(lf.dim, s, n))
                            st["exp_avg_sq"].copy_(exp_avg_sq.narrow(lf.dim, s, n))
            return
        rv = self._replicated_of[id(leaf)]
        old = self.whole.state.get(rv)
        step = (torch.full_like(old["step"], float(count)) if old
                else torch.tensor(float(count), dtype=torch.float32))
        self.whole.state[rv] = {"step": step, "exp_avg": exp_avg.to(leaf.device),
                                "exp_avg_sq": exp_avg_sq.to(leaf.device)}

    def _optimizers(self) -> List[torch.optim.Optimizer]:
        return self.replicas + ([self.whole] if self.whole is not None else [])

    def state_dict(self) -> Optional[dict]:
        """``{"replicas": [each replica's state dict], "whole": ...}``.
        Over processes every rank must call it: the moment slices are
        gathered to rank 0, which gets the one-process format (its host
        tensors); the other ranks get None."""
        whole = None if self.whole is None else self.whole.state_dict()
        if not self.spans_processes:
            return {"replicas": [o.state_dict() for o in self.replicas],
                    "whole": whole}
        moments = self._gather_moments() if self.replicas else {}
        if moments is None:
            return None
        if not self.replicas:
            return {"replicas": [], "whole": whole}
        import copy

        mine = self.replicas[0].state_dict()
        replicas = []
        for j in range(self.cfg.n_replicas):
            state, slot = {}, 0
            for li, lf in enumerate(self.leaves):
                for b, (s, n) in enumerate(lf.index[j]):
                    st = {"step": mine["state"][slot]["step"].clone()}
                    st.update({key: moments[key][li].narrow(lf.dim, s, n)
                               for key in moments})
                    state[slot] = st
                    slot += 1
            replicas.append({"state": state,
                             "param_groups": copy.deepcopy(mine["param_groups"])})
        return {"replicas": replicas, "whole": whole}

    def load_state_dict(self, saved: dict) -> None:
        if len(saved["replicas"]) != (self.cfg.n_replicas if self.replicas else 0):
            raise ValueError(
                f"a state of {len(saved['replicas'])} replicas does not fit "
                f"a ZeRO-1 optimizer over {self.cfg.n_replicas}")
        for o, j in zip(self.replicas, self.owned):
            sd = saved["replicas"][j]
            if self._moments or self.spans_processes:
                # Into the held buffers, keeping the views.
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

    def _fold(self, leaf_idx: int, bits: int, phase: int) -> Any:
        return (self.cfg.seed + 7919 * phase, leaf_idx, bits & 0xFFFFFFFF)

    def _key(self, leaf_idx: int, x: torch.Tensor, phase: int) -> Any:
        """seed ⊕ phase ⊕ leaf index ⊕ the bits of the first element."""
        return self._fold(leaf_idx, _bits(x), phase)

    def _qdq(self, x: torch.Tensor, leaf_idx: int, phase: int) -> torch.Tensor:
        from ddl_tpu_torch.parallel.collectives import quantize_dequantize

        cfg = self.cfg
        key = (self._key(leaf_idx, x, phase) if cfg.stochastic_rounding
               else None)
        return quantize_dequantize(x, cfg.block,
                                   stochastic=cfg.stochastic_rounding, key=key)

    def _slice_noise(self, lf: "_Leaf", bits: Optional[int], phase: int
                     ) -> Optional[torch.Tensor]:
        """The whole leaf's stochastic draws under its key (None when
        rounding is deterministic): each slice rounds with its part."""
        from ddl_tpu_torch.parallel.collectives import stochastic_noise

        if not self.cfg.stochastic_rounding:
            return None
        key = self._fold(self._index[id(lf.param)], bits, phase)
        return stochastic_noise(lf.param.shape, key, lf.param.device)

    def quantize_slices(self, lf: "_Leaf", j: int, xs: Sequence[torch.Tensor],
                        bits: Optional[int], phase: int
                        ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """``(q, scales)`` of replica ``j``'s blocks ``xs`` of leaf ``lf``:
        the blocks' parts of the whole leaf's quantization, whose first
        element has the fp32 ``bits`` (the stochastic key's fold)."""
        from ddl_tpu_torch.parallel.collectives import quantize_blockwise

        cfg = self.cfg
        noise = self._slice_noise(lf, bits, phase)
        return [quantize_blockwise(
            x, cfg.block, stochastic=cfg.stochastic_rounding,
            noise=None if noise is None else noise.narrow(lf.dim, s, n))
            for x, (s, n) in zip(xs, lf.index[j])]

    @torch.no_grad()
    def step(self) -> None:
        """reduce-scatter → shard-local inner update → all-gather.  Over
        processes this is :meth:`reduce_step` (the plain mean)."""
        if self.spans_processes:
            self.reduce_step()
            return
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

    @torch.no_grad()
    def reduce_step(self, loss: Optional[torch.Tensor] = None, weight: Any = None,
                    metrics: Any = None) -> Optional[torch.Tensor]:
        """One step over a process-spanning mesh, from each process's
        local grads (and ``loss``): the scatter leg, the small bucket, the
        shard-local update, the gather leg (the module docstring).

        Without ``weight`` the sums are divided by the world size (the
        processes' mean); with ``weight`` (this process's count) every
        grad and the loss are scaled by it in place, the count rides the
        small bucket, and the sums are divided by the summed count (at
        least 1).  ``loss`` comes back reduced, in place.  Afterwards each
        ``p.grad`` holds the reduced grad on this process's slices only.
        ``metrics`` (a registry, default the process-wide one) records the
        legs' ``mh.*`` times and bytes."""
        import torch.distributed as dist

        from ddl_tpu_torch.observability import metrics as default_metrics
        from ddl_tpu_torch.parallel.collectives import (
            dequantize_blockwise,
            host_bucket,
        )
        from ddl_tpu_torch.parallel.mesh import process_count, process_rank

        cfg, lay = self.cfg, self.layout
        m = metrics if metrics is not None else default_metrics()
        int8 = cfg.grad_comm == "int8"
        stoch = int8 and cfg.stochastic_rounding
        if not self._comm_recorded:
            self._record_comm_bytes()
        world, n = process_count(), cfg.n_replicas
        k = len(self.owned)
        dev = self.params[0].device
        sync = (torch.cuda.current_stream(dev).synchronize if dev.type == "cuda"
                else (lambda: None))
        sharded = [lf.param for lf in self.leaves]
        rep = [p for p in self.params if id(p) in self._replicated_of]

        # The scatter leg's staging: the last step's copies out of the
        # buckets may still be queued, then the weighted grads go in.
        t0 = time.perf_counter()
        sync()
        if weight is not None:
            for p in self.params:
                if p.grad is not None:
                    p.grad.mul_(weight)  # in place, as process_mean
            if loss is not None:
                loss.mul_(weight)
        big = host_bucket("zero1.big", n * lay.size)
        for j, li, b, piece in lay.pieces(big, range(n)):
            lf = self.leaves[li]
            g = lf.param.grad
            if g is None:
                piece.zero_()
            else:
                s, cnt = lf.index[j][b]
                piece.copy_(g.narrow(lf.dim, s, cnt), non_blocking=True)
        t_scatter = time.perf_counter() - t0
        # The small bucket: replicated grads, the sharded leaves' first
        # elements (stochastic keys), the loss, the count.
        t0 = time.perf_counter()
        n_first = world * len(sharded) if stoch else 0
        n_small = (sum(p.numel() for p in rep) + n_first
                   + (loss is not None) + (weight is not None))
        small = host_bucket("zero1.small", n_small)
        off = 0
        for p in rep:
            piece = small[off:off + p.numel()].view(p.shape)
            if p.grad is None:
                piece.zero_()
            else:
                piece.copy_(p.grad, non_blocking=True)
            off += p.numel()
        first_at = off
        if stoch:
            # Each process's first elements in its rank's slot, the other
            # slots -0.0: the all-reduce adds -0.0s to each slot's one
            # value, which is exact (an all-gather), and the slots are
            # summed below in rank order, as the scatter leg sums the
            # chunks (gloo's all-reduce adds in another order past two
            # processes).
            small[off:off + n_first].fill_(-0.0)
            mine = off + process_rank() * len(sharded)
            for li, p in enumerate(sharded):
                if p.grad is not None:
                    small[mine + li:mine + li + 1].copy_(
                        p.grad.reshape(-1)[:1], non_blocking=True)
            off += n_first
        if loss is not None:
            small[off:off + 1].copy_(loss.reshape(1), non_blocking=True)
        if weight is not None:
            small[-1:].copy_(torch.as_tensor(weight, dtype=torch.float32)
                             .reshape(1), non_blocking=True)
        sync()
        t_small = time.perf_counter() - t0
        t0 = time.perf_counter()
        recv = host_bucket("zero1.recv", n * lay.size)
        chunk = (_reduce_scatter(big, recv, world) if lay.size
                 else recv[:k * lay.size])
        t_scatter += time.perf_counter() - t0
        t0 = time.perf_counter()
        dist.all_reduce(small)
        divisor = max(float(small[-1]), 1.0) if weight is not None else float(world)
        off = 0
        for p in rep:
            if p.grad is not None:
                p.grad.copy_(small[off:off + p.numel()].view(p.shape),
                             non_blocking=True)
                p.grad.div_(divisor)
            off += p.numel()
        firsts: List[Optional[int]] = [None] * len(sharded)
        if stoch:
            slots = small[first_at:first_at + n_first].view(world, len(sharded))
            for li, p in enumerate(sharded):
                if p.grad is not None:
                    # The reduced element as the scatter leg's sum and
                    # division make it, on the grad's device and in its
                    # dtype.
                    acc = slots[0, li:li + 1].clone()
                    for r in range(1, world):
                        acc.add_(slots[r, li:li + 1])
                    t = acc.to(p.grad.device, p.grad.dtype, copy=True)
                    firsts[li] = _bits(t.div_(divisor))
        if loss is not None:
            loss.copy_(small[-1 - (weight is not None)].reshape(loss.shape),
                       non_blocking=True)
            loss.div_(divisor)
        t_small += time.perf_counter() - t0
        t0 = time.perf_counter()
        for j, li, b, piece in lay.pieces(chunk, self.owned):
            lf = self.leaves[li]
            if lf.param.grad is not None:
                s, cnt = lf.index[j][b]
                dst = lf.param.grad.narrow(lf.dim, s, cnt)
                dst.copy_(piece, non_blocking=True)
                dst.div_(divisor)
        t_scatter += time.perf_counter() - t0

        # The shard-local update (phase 0 on the reduced slices first).
        for opt, j in zip(self.replicas, self.owned):
            for li, lf in enumerate(self.leaves):
                g = lf.param.grad
                if g is None:
                    for v in lf.views[j]:
                        v.grad = None
                    continue
                xs = [g.narrow(lf.dim, s, cnt) for s, cnt in lf.index[j]]
                if int8:
                    xs = [dequantize_blockwise(q, sc, g.dtype, cfg.block)
                          for q, sc in self.quantize_slices(lf, j, xs,
                                                            firsts[li], 0)]
                for v, x in zip(lf.views[j], xs):
                    v.grad = x
        for p in rep:
            g = p.grad
            if g is not None and int8 and g.dim() > 0:
                g = self._qdq(g, self._index[id(p)], phase=0)
            self._replicated_of[id(p)].grad = g
        before = None
        if int8:
            before = {(j, li): [v.clone() for v in self.leaves[li].views[j]]
                      for j in self.owned for li in range(len(self.leaves))}
            before_rep = [p.detach().clone() for p in rep]
        for opt in self._optimizers():
            opt.step()

        # The gather leg.
        t0 = time.perf_counter()
        if int8:
            self._gather_int8(before, sync, m)
            for p, b0 in zip(rep, before_rep):
                if p.dim() == 0 or p.grad is None:
                    continue
                upd = self._qdq(p.detach() - b0, self._index[id(p)], phase=1)
                p.detach().copy_(b0 + upd)
        else:
            for j, li, b, piece in lay.pieces(chunk, self.owned):
                piece.copy_(self.leaves[li].views[j][b], non_blocking=True)
            sync()
            if lay.size:
                _all_gather(big, chunk)
            others = [j for j in range(n) if j not in self.owned]
            for j, li, b, piece in lay.pieces(big, others, regions=others):
                self.leaves[li].views[j][b].copy_(piece, non_blocking=True)
            m.incr("mh.gather_bytes", float(chunk.numel() * 4))
        m.add_time("mh.gather", time.perf_counter() - t0)
        m.add_time("mh.scatter", t_scatter)
        m.incr("mh.scatter_bytes", float(big.numel() * 4))
        m.add_time("mh.allreduce", t_small)
        m.incr("mh.allreduce_bytes", float(small.numel() * 4))
        return loss

    def _gather_int8(self, before: Dict[Tuple[int, int], List[torch.Tensor]],
                     sync: Any, m: Any) -> None:
        """The int8 gather leg: the owned update slices quantize (phase 1)
        into a byte bucket of payloads and scales, one all-gather moves
        every replica's, and each process applies ``before + update``."""
        import torch.distributed as dist

        from ddl_tpu_torch.parallel.collectives import (
            dequantize_blockwise,
            host_bucket,
        )

        cfg, lay = self.cfg, self.layout
        n = cfg.n_replicas
        region, _ = lay.quantized(cfg.block)
        k = len(self.owned)
        bits: List[Optional[int]] = [None] * len(self.leaves)
        if cfg.stochastic_rounding:
            # The phase-1 keys fold the update's first element, which only
            # replica 0's owner holds: it broadcasts the bits.
            vec = torch.zeros(len(self.leaves), dtype=torch.int32)
            if 0 in self.owned:
                for li, lf in enumerate(self.leaves):
                    vec[li] = _bits(lf.views[0][0] - before[(0, li)][0])
            dist.broadcast(vec, src=int(self.cfg.mesh.processes.reshape(
                n, -1)[0, 0]))
            bits = vec.tolist()
        send = host_bucket("zero1.qsend", k * region, torch.uint8)
        recv = host_bucket("zero1.qrecv", n * region, torch.uint8)
        qs = {}
        for j in self.owned:
            for li, lf in enumerate(self.leaves):
                xs = [v - b for v, b in zip(lf.views[j], before[(j, li)])]
                qs[(j, li)] = self.quantize_slices(lf, j, xs, bits[li], 1)
        for j, li, b, scales, payload in lay.qpieces(send, cfg.block, self.owned):
            q, s = qs[(j, li)][b]
            scales.copy_(s, non_blocking=True)
            payload.copy_(q, non_blocking=True)
        sync()
        if region:
            _all_gather(recv, send)
        for j, li, b, scales, payload in lay.qpieces(recv, cfg.block, range(n)):
            lf = self.leaves[li]
            v = lf.views[j][b]
            q = payload.to(v.device, non_blocking=True)
            s = scales.to(v.device, non_blocking=True)
            upd = dequantize_blockwise(q, s, v.dtype, cfg.block)
            base = before[(j, li)][b] if j in self.owned else v
            v.copy_(base + upd)
        m.incr("mh.gather_bytes", float(send.numel()))

    # -- observability ----------------------------------------------------

    def _record_state_bytes(self) -> None:
        from ddl_tpu_torch.observability import metrics as default_metrics

        m = default_metrics()
        local = float(sum(_nbytes(t) for t in _state_tensors(self)))
        total = local
        if self.spans_processes:
            whole = float(sum(_nbytes(t) for t in _state_tensors(self.whole))
                          if self.whole is not None else 0)
            total = (local - whole) * self.cfg.n_replicas / len(self.owned) + whole
            m.set_gauge("opt.state_bytes_local", local)
        m.set_gauge("opt.state_bytes_total", total)
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
