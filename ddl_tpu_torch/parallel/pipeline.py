"""Pipeline (model) parallelism over a ``pp`` mesh axis (port of
``ddl_tpu/parallel/pipeline.py``).

Two schedules behind one ``schedule=`` knob, with the JAX package's
journey indexing:

- ``"gpipe"`` (default) — S stages, M microbatches, ticks
  ``t = 0 .. M+S-2``: stage 0 feeds microbatch t into the pipe while
  t < M, every stage applies its layers to the buffer it received, the
  buffers hop to the next stage between ticks, stage S-1 emits
  microbatch t-S+1.  Fill and drain idle ``S-1`` of the ``M+S-1`` ticks:
  bubble = (S-1)/(M+S-1).
- ``"1f1b"`` — the interleaved-stage (Megatron "virtual pipeline")
  schedule: each position hosts ``n_chunks`` non-adjacent stage chunks
  (position d owns global stages c·S+d) and activations circle the ring
  ``n_chunks`` times: bubble = (S-1)/(n_chunks·M+S-1).  Needs
  ``M % S == 0`` and params stacked with ``stack_layer_stages(...,
  n_chunks=)``.

The JAX package writes the schedule as one ``lax.scan`` under
``shard_map``.  The port runs it as a Python loop over ticks, each tick a
loop over the ``pp`` positions: a position whose journey offset
``q = t - d`` lies outside ``[0, M·V)`` does nothing; a live one runs
``stage_fn`` on its buffer with its live chunk's weights (an index into
its ``(V, L/(S·V), ...)`` stack).  The buffers then hop one position
through :func:`~ddl_tpu_torch.parallel.collectives.ppermute`, the port's
one move between positions; the last stage writes its microbatch into
the outputs (on one card the JAX package's masked sum over pp is the
last position's outputs).  Autograd through the loop is the reverse
schedule, as ``jax.grad`` is there.

On one card the positions of a stage share one call over each
microbatch's rows: ``batch_spec`` (by default the microbatch rows over
``dp`` when ``dp`` divides them) is checked, and a dp split is the same
per-row function.  With ``stage_param_specs`` (tensor-parallel-resident
stages) the live chunk's weights reach ``stage_fn`` as
:class:`~ddl_tpu_torch.parallel.mesh.ShardedArray` s over the inner axes
the specs name, and ``stage_fn`` owns the sums over them
(:func:`~ddl_tpu_torch.parallel.collectives.psum`).  On a mesh that spans
processes the pipeline runs on this process's positions
(:meth:`~ddl_tpu_torch.parallel.mesh.Mesh.local`) over its rows.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch

from ddl_tpu_torch.parallel.mesh import (
    NamedSharding,
    P,
    ShardedArray,
    _entry_axes,
    map_specs,
    shard,
)

#: Schedules :func:`pipeline_apply` implements (``bubble_fraction``
#: prices both analytically).
SCHEDULES = ("gpipe", "1f1b")


def _resolve_chunks(schedule: str, n_chunks: "int | None") -> int:
    """Stage chunks per position for a schedule (gpipe: always 1; 1f1b:
    the caller's ``n_chunks``, default 2 — 1 would be a gpipe relabel)."""
    if schedule not in SCHEDULES:
        raise ValueError(
            f"unknown schedule {schedule!r} (want one of {SCHEDULES})"
        )
    if schedule == "gpipe":
        if n_chunks not in (None, 1):
            raise ValueError(
                f"schedule='gpipe' is single-chunk; got n_chunks={n_chunks}"
                " (use schedule='1f1b' for interleaved stage chunks)"
            )
        return 1
    v = 2 if n_chunks is None else int(n_chunks)
    if v < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    return v


def bubble_fraction(n_stages: int, n_microbatches: int,
                    schedule: str = "gpipe",
                    n_chunks: "int | None" = None) -> float:
    """Analytic fill/drain idle fraction of a schedule: gpipe
    ``(S-1)/(M+S-1)``, 1f1b ``(S-1)/(v·M+S-1)`` with ``v = n_chunks``
    (at S=4, M=4, v=2: 3/11 = 0.273 against gpipe's 3/7 = 0.429)."""
    if n_stages < 1 or n_microbatches < 1:
        raise ValueError((n_stages, n_microbatches))
    v = _resolve_chunks(schedule, n_chunks)
    return (n_stages - 1) / (v * n_microbatches + n_stages - 1)


def _map(fn: Callable[..., Any], *trees: Any) -> Any:
    """Map ``fn`` over the leaves of nested dict/list/tuple trees of the
    same structure."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        out = [_map(fn, *(t[i] for t in trees)) for i in range(len(head))]
        return tuple(out) if isinstance(head, tuple) else out
    return fn(*trees)


def _leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    _map(out.append, tree)
    return out


def stack_stage_params(per_stage: list) -> Any:
    """Stack a list of per-stage param trees along a new leading axis."""
    return _map(lambda *xs: torch.stack(xs), *per_stage)


def stack_layer_stages(layers: list, n_stages: int, n_chunks: int = 1) -> Any:
    """Regroup a model's per-layer param list into the stacked layout
    :func:`pipeline_apply` schedules.

    ``n_chunks == 1`` (gpipe): ``(S, L/S, ...)`` leaves, ``n_stages``
    equal consecutive stages.  ``n_chunks > 1`` (1f1b): ``(S, V,
    L/(S·V), ...)`` leaves with the virtual-pipeline assignment —
    position ``d`` chunk ``c`` holds global stage ``c·S + d``."""
    L = len(layers)
    total = n_stages * n_chunks
    if n_stages < 1 or n_chunks < 1 or L % total:
        raise ValueError(
            f"n_layers={L} must divide into n_stages={n_stages} x "
            f"n_chunks={n_chunks}"
        )
    per = L // total

    def group(s: int) -> Any:
        return stack_stage_params(layers[s * per:(s + 1) * per])

    if n_chunks == 1:
        return stack_stage_params([group(s) for s in range(n_stages)])
    return stack_stage_params([
        stack_stage_params([group(c * n_stages + d) for c in range(n_chunks)])
        for d in range(n_stages)
    ])


def stage_spec_tree(layer_spec: Any, axis: str = "pp", n_chunks: int = 1) -> Any:
    """PartitionSpecs for a :func:`stack_layer_stages` tree: ``axis``
    shards the stages, the chunk (1f1b only) and per-stage layer axes are
    unsharded, trailing axes keep the model's per-layer layout."""
    lead = (None,) * (2 if n_chunks > 1 else 1)
    return map_specs(lambda s: P(axis, *lead, *tuple(s or ())), layer_spec)


def pipeline_spec(inner_spec_tree: Any, axis: str = "pp") -> Any:
    """Prepend the pipeline axis to every leaf spec of a stage param tree
    (pass the same ``axis`` as to :func:`pipeline_apply`)."""
    return map_specs(lambda s: P(axis, *tuple(s or ())), inner_spec_tree)


def pipeline_apply(
    stacked_params: Any,
    x: Any,
    stage_fn: Callable[[Any, Any], Any],
    mesh: Any,
    n_microbatches: int,
    axis: str = "pp",
    batch_spec: Any = None,
    stage_param_specs: Any = None,
    schedule: str = "gpipe",
    n_chunks: "int | None" = None,
    metrics: Any = None,
) -> Any:
    """Apply S pipelined stages to a batch ``x`` (B, ...).

    - ``schedule``: ``"gpipe"`` or ``"1f1b"`` with ``n_chunks`` (default
      2) stage chunks a position (:func:`bubble_fraction`).  Outputs and
      gradients are the same function under both at identical total
      stages and M — on the CPU bit for bit, since the same layer ops run
      on the same microbatch shapes in the same order.
    - ``stacked_params``: stage params stacked on a leading S axis
      (:func:`stack_stage_params` / :func:`stack_layer_stages`).
    - ``stage_fn(stage_params, x) -> y`` with y shaped like x; ``x`` may be
      a tree whose leaves share the leading batch axis (every leaf hops
      together).
    - Falls back to the stages in sequence, microbatch by microbatch (the
      1f1b layout flattened back to global stage order), when the mesh
      has no ``axis`` or it has size 1.
    - ``batch_spec``: how the ``(M, mb, ...)`` microbatches' rows spread
      (default: over ``dp`` when ``dp`` divides ``mb``, else replicated);
      ``stage_param_specs``: one stage's inner specs (no leading S axis)
      for tp-resident stages, whose ``stage_fn`` then gets the live
      chunk's weights as ShardedArrays over those axes and owns the sums.
    - ``metrics``: the registry of the ``pp.bubble`` / ``pp.chunks``
      gauges and the ``pp.ticks`` / ``pp.live_ticks`` counters (default:
      the process-wide one).
    """
    V = _resolve_chunks(schedule, n_chunks)
    S = _leaves(stacked_params)[0].shape[0]
    B = _leaves(x)[0].shape[0]
    assert B % n_microbatches == 0, (B, n_microbatches)
    if V > 1:
        if n_microbatches % S:
            raise ValueError(
                f"schedule='1f1b' needs n_microbatches ({n_microbatches}) "
                f"divisible by n_stages ({S}): microbatch groups of S "
                "pack the chunk laps seamlessly"
            )
        bad = [tuple(leaf.shape) for leaf in _leaves(stacked_params)
               if leaf.dim() < 2 or leaf.shape[1] != V]
        if bad:
            raise ValueError(
                f"schedule='1f1b' with n_chunks={V} expects stage leaves "
                f"shaped (S, {V}, ...) — stack with "
                f"stack_layer_stages(layers, n_stages, n_chunks={V}); got "
                f"leading shapes {bad[:3]}"
            )
        # NB this check is necessary, not sufficient: a gpipe stack with
        # L/S == n_chunks is shape-INDISTINGUISHABLE from a chunked one
        # (its layer axis would be misread as the chunk axis and layers
        # would apply in the wrong global order).  The layout contract —
        # stack with the same n_chunks you schedule with — is the
        # caller's; the model-side stage_params(n_chunks=) helpers keep
        # the two knobs adjacent for exactly this reason.
    M = n_microbatches
    mb = B // M
    if mesh is not None:
        mesh = mesh.local()
    names = mesh.axis_names if mesh is not None else ()
    if batch_spec is None:
        batch_spec = (
            P(None, "dp")
            if "dp" in names and mesh.shape["dp"] > 1 and mb % mesh.shape["dp"] == 0
            else P()
        )
    _check_batch_spec(batch_spec, mesh, M, mb)
    xm = _map(lambda a: a.reshape((M, mb) + tuple(a.shape[1:])), x)

    if axis not in names or mesh.shape[axis] == 1:
        if stage_param_specs is not None:
            raise ValueError(
                "stage_param_specs (tensor-parallel-resident stages) "
                f"requires a {axis!r} mesh axis: the sequential fallback "
                "runs stage_fn outside the positions, where its named-axis "
                "sums cannot resolve"
            )
        # Per MICROBATCH, as the pipelined path: a batch-coupled stage
        # sees the same row groups on every mesh shape.  Stage c·S+d of a
        # 1f1b stack lives at [d, c]: (S, V) transposes to (V, S) first.
        seq = (stacked_params if V == 1 else _map(
            lambda a: a.transpose(0, 1).reshape((S * V,) + tuple(a.shape[2:])),
            stacked_params))
        outs = []
        for m in range(M):
            h = _map(lambda a: a[m], xm)
            for s in range(S * V):
                h = stage_fn(_map(lambda a: a[s], seq), h)
            outs.append(h)
        return _stack_outputs(outs, x)
    assert mesh.shape[axis] == S, (
        f"stacked params have {S} stages but mesh {axis}={mesh.shape[axis]}"
    )
    if metrics is None:
        from ddl_tpu_torch.observability import metrics as _default

        metrics = _default()
    metrics.set_gauge("pp.bubble", bubble_fraction(S, M, schedule=schedule,
                                                   n_chunks=V))
    metrics.set_gauge("pp.chunks", float(V))
    outs = _pipeline_ticks(stacked_params, xm, stage_fn, mesh, axis, M, V,
                           stage_param_specs, metrics)
    return _stack_outputs(outs, x)


def _stack_outputs(outs: List[Any], x: Any) -> Any:
    """The M per-microbatch output trees stacked back into ``x``'s
    structure and shapes."""
    leaves, rebuild = _flatten(x)
    per = [_leaves(o) for o in outs]
    return rebuild([torch.stack([p[k] for p in per]).reshape(leaf.shape)
                    for k, leaf in enumerate(leaves)])


def _check_batch_spec(spec: Any, mesh: Any, M: int, mb: int) -> None:
    """The microbatched input's spec must name mesh axes that divide its
    dims (as ``shard_map`` requires of its in_specs)."""
    dims = (M, mb)
    for d, entry in enumerate(tuple(spec)[:2]):
        n = 1
        for a in _entry_axes(entry):
            if mesh is None or a not in mesh.axis_names:
                raise ValueError(f"batch_spec {spec} names axis {a!r}, not "
                                 "in the mesh")
            n *= mesh.shape[a]
        if dims[d] % n:
            raise ValueError(f"batch_spec {spec}: dim {d} ({dims[d]}) is not "
                             f"divisible by {n}")


def _pipeline_ticks(stacked: Any, xm: Any, stage_fn: Callable[[Any, Any], Any],
                    mesh: Any, axis: str, M: int, V: int,
                    stage_param_specs: Any, metrics: Any) -> List[Any]:
    """The schedule: ``M·V + S - 1`` ticks over the ``S`` positions of
    ``axis``; returns the M outputs in microbatch order."""
    from ddl_tpu_torch.parallel.collectives import ppermute

    S = mesh.shape[axis]
    span = V * S  # journey length in ticks (one full set of chunk laps)
    ring = NamedSharding(mesh.sub_mesh((axis,)), P(axis))
    inner = None
    if stage_param_specs is not None:
        used: set = set()
        map_specs(lambda spec: used.update(
            a for e in tuple(spec or ()) for a in _entry_axes(e)),
            stage_param_specs)
        inner = mesh.sub_mesh(tuple(a for a in mesh.axis_names if a in used))
    hop = [(d, (d + 1) % S) for d in range(S)]
    n_ticks = M * V + S - 1
    bufs: List[Any] = [None] * S
    outputs: List[Any] = [None] * M
    live_ticks = 0
    for t in range(n_ticks):
        ys: List[Any] = [None] * S
        for d in range(S):
            q = t - d
            if q < 0 or q >= M * V:
                continue  # fill/drain: this position does nothing
            live_ticks += 1
            chunk = (q % span) // S
            m = (q // span) * S + (q % S)
            # Position 0 ingests microbatch m whenever the arriving journey
            # position is a chunk-0 stage (global stage 0).
            inp = _map(lambda a: a[m], xm) if d == 0 and chunk == 0 else bufs[d]
            params = _map(lambda p: p[d] if V == 1 else p[d, chunk], stacked)
            if inner is not None:
                params = map_specs(
                    lambda spec, p: shard(p, NamedSharding(inner, spec)),
                    stage_param_specs, params)
            ys[d] = stage_fn(params, inp)
            if d == S - 1 and chunk == V - 1:
                outputs[m] = ys[d]
        if t + 1 < n_ticks:
            bufs = _hop(ys, ring, hop, axis, ppermute)
    metrics.incr("pp.ticks", float(n_ticks * S))
    metrics.incr("pp.live_ticks", float(live_ticks))
    return outputs


def _flatten(tree: Any):
    """``(leaves, rebuild)``: the leaves in order and the function that
    puts a list of the same length back into the tree's structure."""
    leaves = _leaves(tree)

    def rebuild(values: List[Any]) -> Any:
        it = iter(values)
        return _map(lambda _: next(it), tree)

    return leaves, rebuild


def _hop(ys: List[Any], ring: NamedSharding, pairs: List[Any], axis: str,
         ppermute: Callable[..., ShardedArray]) -> List[Any]:
    """Every live position's output moves one position along the ring
    (leaf by leaf, through ``ppermute``); a position that ran nothing
    sends a zero-stride placeholder, which no live tick reads."""
    live = [d for d, y in enumerate(ys) if y is not None]
    if not live:
        return [None] * len(ys)
    template, rebuild = _flatten(ys[live[0]])
    send = [(d, e) for d, e in pairs if ys[d] is not None]
    per_pos = [_leaves(y) if y is not None else None for y in ys]
    moved = []
    for k, like in enumerate(template):
        datas = [v[k] if v is not None else torch.zeros(
            (), dtype=like.dtype, device=like.device).expand(like.shape)
            for v in per_pos]
        arr = ShardedArray((len(datas) * like.shape[0],) + tuple(like.shape[1:]),
                           ring, datas)
        moved.append([sh.data for sh in ppermute(arr, send, axis).shards])
    received = {(d + 1) % len(ys) for d in live}
    return [rebuild([leaf[d] for leaf in moved]) if d in received else None
            for d in range(len(ys))]
