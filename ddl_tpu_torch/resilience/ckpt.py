"""Async integrity-checked train-state checkpoints (port of
``ddl_tpu/resilience/ckpt.py``).

- :class:`AsyncCheckpointer` snapshots a
  :class:`~ddl_tpu_torch.parallel.train.TrainState` into recycled host
  buffers and hands the snapshot to a background writer thread.  The
  snapshot's copies run on the current (compute) stream and ``submit``
  returns once they have landed, so the next step's in-place AdamW
  update can never tear the snapshot; the caller's stall is that wait
  (``resilience.ckpt_submit``).  Serialization, CRC, fsync and rename
  hide behind training (``resilience.ckpt_write``).
- Every generation is ONE file, ``gen_<step>.ckpt``, in the JAX
  package's format byte for byte: 8-byte magic, u32 header length,
  header JSON, the leaves' bytes, and the 32-byte ring-slot integrity
  trailer (:mod:`ddl_tpu_torch.integrity`: crc32 over everything before
  it, seq = step, producer 0).  The leaves come in the JAX package's
  order and dtypes — ``jax.tree_util.tree_leaves({"params": ...,
  "opt_state": ...})`` over an ``optax.adam``/``adamw`` state: the int32
  step ``count``, then ``mu``, then ``nu``, then the params, each tree
  in sorted-key order (:func:`train_state_leaves`) — so a generation
  either package wrote restores in the other.
- The loader's logical clock captured at the same window boundary
  travels inside the generation (``loader.json`` is mirrored beside it
  for tooling; the embedded copy is authoritative).
- Restore walks generations newest→oldest, quarantines unverifiable ones
  (``.quarantined``) and falls back; exhaustion returns None — a cold
  start, counted ``resilience.ckpt_cold_starts``.

Retention is keep-K.  A generation is never joined in memory: the writer
streams its parts through :func:`~ddl_tpu_torch.checkpoint.
atomic_file_write`, and verification and restore read it in chunks (a
2-layer Llama-3-8B state is ~17.8 GB) — except while a fault plan is
armed: the ``resilience.ckpt_write`` site (:mod:`ddl_tpu_torch.faults`)
needs the stamped bytes as one mutable array, so the writer then joins
them and ``CKPT_CORRUPTION`` flips bytes after the CRC stamp.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import struct
import threading
import time
import zlib
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ddl_tpu_torch import integrity
from ddl_tpu_torch.checkpoint import (
    LoaderCheckpoint,
    atomic_file_write,
    quarantine_path,
)
from ddl_tpu_torch.concurrency import named_condition
from ddl_tpu_torch.exceptions import CheckpointError, ShutdownRequested
from ddl_tpu_torch.faults import armed_plan, fault_point
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
from ddl_tpu_torch.parallel.train import TrainState

logger = logging.getLogger("ddl_tpu_torch")

#: Generation-file magic (8 bytes), ahead of the u32 header length.
_MAGIC = b"DDLRES1\0"
_GEN_RE = re.compile(r"^gen_(\d{10})\.ckpt$")

#: Trailer identity for checkpoint blobs (ring trailers carry the
#: 1-based producer index there; 0 is used by no producer).
_CKPT_PRODUCER = 0

#: Read/CRC chunk of the streaming verify and restore.
_CHUNK = 1 << 26


def _gen_name(step: int) -> str:
    return f"gen_{int(step):010d}.ckpt"


def list_generations(directory: str) -> List[Tuple[int, str]]:
    """``[(step, path)]`` of every generation file, oldest first."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _GEN_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def verify_generation(path: str, expect_step: int) -> Optional[str]:
    """Full read-side check of one generation file.  Returns a failure
    description, or None when the blob is intact and is the generation
    its filename claims (trailer seq == step).  Reads in chunks."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            min_size = len(_MAGIC) + 4 + integrity.HEADER_BYTES
            if size < min_size:
                return f"truncated: {size} bytes < minimum {min_size}"
            payload_bytes = size - integrity.HEADER_BYTES
            f.seek(payload_bytes)
            hdr = integrity.read_header(
                np.frombuffer(f.read(integrity.HEADER_BYTES), np.uint8), 0)
            if not hdr.valid_magic:
                return (f"bad header magic 0x{hdr.magic:08x} (torn or "
                        "unstamped commit)")
            if hdr.producer_idx != _CKPT_PRODUCER:
                return (f"window from producer {hdr.producer_idx}, "
                        f"expected producer {_CKPT_PRODUCER}")
            if hdr.seq != int(expect_step):
                return (f"window seq {hdr.seq}, expected {int(expect_step)} "
                        "(drop/duplicate)")
            f.seek(0)
            head = b""
            crc, left = 0, payload_bytes
            while left:
                chunk = f.read(min(_CHUNK, left))
                if not chunk:
                    return "short read"
                if not head:
                    head = chunk[: len(_MAGIC)]
                crc = zlib.crc32(chunk, crc)
                left -= len(chunk)
    except OSError as e:
        return f"unreadable: {e}"
    crc &= 0xFFFFFFFF
    if crc != hdr.crc:
        return (f"payload crc32 0x{crc:08x} != committed 0x{hdr.crc:08x} "
                f"(seq {hdr.seq}, producer {hdr.producer_idx})")
    if head != _MAGIC:
        return f"bad file magic {head!r}"
    return None


def latest_verified_generation(
    directory: str, quarantine: bool = True,
    metrics: Optional[Metrics] = None,
) -> Optional[Tuple[int, str]]:
    """The newest ``(step, path)`` whose integrity trailer verifies;
    unverifiable generations are quarantined and skipped.  None at
    exhaustion."""
    m = metrics or default_metrics()
    for step, path in reversed(list_generations(directory)):
        err = verify_generation(path, step)
        if err is None:
            return step, path
        logger.error(
            "resilience: checkpoint generation %s failed verification "
            "(%s)", path, err,
        )
        if quarantine:
            quarantine_path(path, metrics=m)
        else:
            m.incr("resilience.ckpt_quarantined")
    return None


@dataclasses.dataclass
class RestoredRun:
    """One verified restore: the train state, the loader cursor fenced to
    it (None for state-only generations), and the step."""

    state: TrainState
    loader: Optional[LoaderCheckpoint]
    step: int


# -- the JAX package's leaf layout -------------------------------------------


def _sorted_leaves(tree: Any) -> List[Any]:
    """Leaves in ``jax.tree_util`` order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _sorted_leaves(v)]
    return [tree]


def _check_adam(opt: Any) -> None:
    """Generations carry optax's Adam layout: the optimizer must keep it."""
    # A ZeRO-1 optimizer (parallel.optimizer.Zero1Optimizer) gives each
    # leaf's moments whole (gathered to rank 0 over processes).
    sharded = hasattr(opt, "load_leaf_state")
    if (not opt.is_adam) if sharded else (
        not isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)) or any(
            g.get("amsgrad") for g in opt.param_groups)):
        raise CheckpointError(
            "generations carry Adam/AdamW state (optax's count/mu/nu "
            f"layout); got {type(opt).__name__}"
        )


def _adam_state(state: TrainState, held: Any) -> Tuple[List[torch.Tensor], int]:
    """The params in the JAX package's order and the optimizer's step
    count, from ``held`` (each param's whole state)."""
    params = _sorted_leaves(state.params)
    steps = {float(held[p]["step"]) for p in params if held.get(p)}
    if len(steps) > 1:
        raise CheckpointError(f"params at different optimizer steps {steps}")
    return params, int(steps.pop()) if steps else 0


def _moment(held: Any, p: torch.Tensor, key: str) -> torch.Tensor:
    st = held.get(p)
    if st:
        return st[key]
    return torch.zeros_like(p, memory_format=torch.preserve_format)


def train_state_leaves(state: TrainState) -> Optional[List[Any]]:
    """The state's leaves in the JAX package's generation order: the
    int32 ``count`` (a numpy scalar), then every param's ``exp_avg``
    (optax's ``mu``), every ``exp_avg_sq`` (``nu``), and the params —
    each in sorted-key tree order.  Tensors stay where they live, except
    the moments of a ZeRO-1 optimizer over processes: every rank must
    call this, their slices are gathered to rank 0 on the host, and the
    other ranks get None."""
    opt = state.optimizer
    _check_adam(opt)
    whole = getattr(opt, "whole_state", None)
    held = whole() if whole is not None else opt.state
    if held is None:
        return None
    params, count = _adam_state(state, held)
    return (
        [np.asarray(count, dtype=np.int32)]
        + [_moment(held, p, "exp_avg") for p in params]
        + [_moment(held, p, "exp_avg_sq") for p in params]
        + params
    )


def _leaf_meta(leaf: Any) -> Tuple[Tuple[int, ...], np.dtype]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), np.dtype(str(leaf.dtype).split(".")[-1])
    arr = np.asarray(leaf)
    return arr.shape, arr.dtype


def _generation_parts(
    step: int, leaves: Sequence[np.ndarray], loader_dict: Optional[dict],
) -> Tuple[List[Any], int]:
    """The generation's byte parts in file order (the leaves as views,
    not copies) with the trailer last, and its total size."""
    header = json.dumps({
        "step": int(step),
        "loader": loader_dict,
        "leaves": [
            {"shape": list(a.shape), "dtype": str(a.dtype)} for a in leaves
        ],
    }).encode()
    parts: List[Any] = [_MAGIC, struct.pack("<I", len(header)), header]
    parts += [np.ascontiguousarray(a).view(np.uint8).reshape(-1)
              for a in leaves]
    crc = 0
    for part in parts:
        crc = zlib.crc32(part, crc)
    payload_bytes = sum(len(p) if isinstance(p, bytes) else p.nbytes
                        for p in parts)
    trailer = np.zeros(integrity.HEADER_BYTES, np.uint8)
    integrity.write_header(trailer, 0, seq=int(step),
                           producer_idx=_CKPT_PRODUCER,
                           crc=crc & 0xFFFFFFFF)
    parts.append(trailer)
    return parts, payload_bytes + integrity.HEADER_BYTES


def serialize_generation(
    step: int, leaves: List[np.ndarray], loader_dict: Optional[dict],
) -> np.ndarray:
    """The stamped generation blob: magic | u32 header-len | header JSON
    | leaf payload | 32-byte integrity trailer (crc over everything
    before it, seq = step) — the JAX package's bytes for the same
    leaves."""
    parts, total = _generation_parts(step, leaves, loader_dict)
    blob = np.empty(total, dtype=np.uint8)
    off = 0
    for part in parts:
        view = np.frombuffer(part, np.uint8) if isinstance(part, bytes) else part
        blob[off : off + view.nbytes] = view
        off += view.nbytes
    return blob


def _parse_header(f: Any) -> Tuple[dict, int]:
    """(header dict, payload offset) of an open generation file."""
    f.seek(len(_MAGIC))
    (hlen,) = struct.unpack("<I", f.read(4))
    header = json.loads(f.read(hlen).decode())
    return header, len(_MAGIC) + 4 + hlen


def _read_leaf(f: Any, shape: Tuple[int, ...], dtype: np.dtype) -> np.ndarray:
    n = int(np.prod(shape, dtype=np.int64))
    out = np.fromfile(f, dtype=dtype, count=n)
    if out.size != n:
        raise CheckpointError("generation ends inside a leaf")
    return out.reshape(shape)


def restore_latest(
    directory: str,
    like: TrainState,
    metrics: Optional[Metrics] = None,
    found: Optional[Tuple[int, str]] = None,
) -> Optional[RestoredRun]:
    """Restore the newest verified generation INTO ``like``: its params
    are overwritten in place and its optimizer's state is set (step,
    ``exp_avg``, ``exp_avg_sq`` per param).  Returns None when no
    verified generation exists (a cold start, counted
    ``resilience.ckpt_cold_starts`` only when unverifiable generations
    were present and exhausted).  ``found`` skips the verification scan
    with a ``(step, path)`` the caller already verified."""
    m = metrics or default_metrics()
    had_any = bool(list_generations(directory))
    if found is None:
        found = latest_verified_generation(directory, metrics=m)
    if found is None:
        if had_any:
            m.incr("resilience.ckpt_cold_starts")
            logger.error(
                "resilience: EVERY checkpoint generation under %s failed "
                "verification — COLD START (all quarantined)", directory,
            )
        return None
    step, path = found
    opt = like.optimizer
    _check_adam(opt)
    params = _sorted_leaves(like.params)
    # count, then mu, nu and the params, each shaped as its param.
    like_metas = ([((), np.dtype(np.int32))]
                  + [_leaf_meta(p) for p in params] * 3)
    with open(path, "rb") as f:
        header, off = _parse_header(f)
        meta = header["leaves"]
        if len(meta) != len(like_metas):
            raise CheckpointError(
                f"generation {path} holds {len(meta)} leaves; the current "
                f"model/optimizer has {len(like_metas)} — geometry changed"
            )
        for i, (want, (shape, dtype)) in enumerate(zip(meta, like_metas)):
            if tuple(want["shape"]) != shape or want["dtype"] != str(dtype):
                raise CheckpointError(
                    f"generation {path} leaf {i}: saved {want['dtype']}"
                    f"{tuple(want['shape'])} vs current {dtype}{shape} — "
                    "geometry changed"
                )
        f.seek(off)
        count = int(_read_leaf(f, (), np.dtype(np.int32)))
        n = len(params)
        moments: List[List[torch.Tensor]] = [[], []]
        with torch.no_grad():
            for i, want in enumerate(meta[1:]):
                host = torch.from_numpy(
                    _read_leaf(f, tuple(want["shape"]), np.dtype(want["dtype"])))
                p = params[i % n]
                if i < 2 * n:
                    moments[i // n].append(host.to(p.device, copy=True))
                else:
                    p.copy_(host)
        step_dtype = torch.float32
        for p, mu, nu in zip(params, *moments):
            if hasattr(opt, "load_leaf_state"):
                opt.load_leaf_state(p, count, mu, nu)
                continue
            old = opt.state.get(p)
            if old and isinstance(old.get("step"), torch.Tensor):
                step_t = torch.full_like(old["step"], float(count))
            else:
                step_t = torch.tensor(float(count), dtype=step_dtype)
            opt.state[p] = {"step": step_t, "exp_avg": mu, "exp_avg_sq": nu}
    loader_ck = None
    if header.get("loader"):
        loader_ck = LoaderCheckpoint(**header["loader"])
    m.incr("resilience.ckpt_restores")
    return RestoredRun(
        state=TrainState(like.params, opt, int(header["step"])),
        loader=loader_ck,
        step=step,
    )


class AsyncCheckpointer:
    """Background-thread checkpoint writer with recycled host staging.

    ``submit`` is the hot-path call: it copies the state into recycled
    host buffers on the current stream, waits for those copies, and
    enqueues the write.  The writer thread serializes, stamps the
    trailer, writes atomically, mirrors ``loader.json`` and trims
    retention.  At most two buffer sets exist: a writer that falls
    behind makes ``submit`` SKIP a periodic checkpoint (counted
    ``resilience.ckpt_skipped``) rather than grow host memory; the forced
    final checkpoint (:meth:`checkpoint_now`) waits instead.  The writer
    thread starts on first use and exits after a few idle seconds.

    MULTIHOST (several processes of an initialised group on one shared
    ``directory``): the state is replicated, so only rank 0 snapshots and
    writes; :meth:`flush` ends at a barrier of every rank, after which the
    generation is live for all of them to restore.  A ZeRO-1 optimizer
    over the processes keeps only its slices of the moments: every rank
    calls :meth:`submit`, which gathers them to rank 0 first, and a
    restore loads each process's slices of the whole moments."""

    #: Idle seconds after which the parked writer thread exits.
    _IDLE_EXIT_S = 5.0

    def __init__(self, directory: str, keep: int = 3,
                 metrics: Optional[Metrics] = None,
                 submit_timeout_s: float = 120.0):
        if keep < 1:
            raise CheckpointError(f"keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(directory)
        self.keep = int(keep)
        self.metrics = metrics or default_metrics()
        self.submit_timeout_s = float(submit_timeout_s)
        self._cond = named_condition("resilience.ckpt.cv")
        self._queue: List[Tuple[int, List[np.ndarray], Optional[dict]]] = []
        self._free: List[List[np.ndarray]] = []
        self._n_sets = 0
        self._busy = False
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._last_error: Optional[BaseException] = None

    # -- staging (at most two host buffer sets) ---------------------------

    def _acquire_buffers(self, metas: List[Tuple[Tuple[int, ...], np.dtype]],
                         block: bool, timeout_s: Optional[float] = None,
                         ) -> Optional[List[np.ndarray]]:
        wait_s = self.submit_timeout_s if timeout_s is None else timeout_s
        with self._cond:
            deadline = time.monotonic() + wait_s
            while not self._free and self._n_sets >= 2:
                if not block:
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise CheckpointError(
                        "checkpoint writer wedged: no staging buffer "
                        f"freed within {wait_s}s"
                    )
                self._cond.wait(min(0.2, remaining))
            if self._free:
                bufs = self._free.pop()
                if len(bufs) == len(metas) and all(
                    b.shape == s and b.dtype == d
                    for b, (s, d) in zip(bufs, metas)
                ):
                    return bufs
                # Geometry changed: drop the stale set, allocate below.
                self._n_sets -= 1
            self._n_sets += 1
        return [np.empty(s, dtype=d) for s, d in metas]

    def _release_buffers(self, bufs: List[np.ndarray]) -> None:
        with self._cond:
            self._free.append(bufs)
            self._cond.notify_all()

    # -- the hot-path call -------------------------------------------------

    def submit(self, state: TrainState,
               loader_ckpt: Optional[LoaderCheckpoint] = None,
               block: bool = False, timeout_s: Optional[float] = None) -> bool:
        """Snapshot ``state`` (+ the fenced loader cursor) and enqueue the
        write.  Returns False when the writer is backed up and this
        periodic checkpoint was skipped (``block=True``, the forced path,
        waits for a buffer instead, up to ``timeout_s``).  The snapshot's
        copies run on the current stream, behind the steps that made the
        state, and have landed when this returns: a step enqueued after
        it cannot change the generation."""
        if self._closed:
            raise CheckpointError("checkpointer is closed")
        from ddl_tpu_torch.parallel.mesh import process_rank

        t0 = time.perf_counter()
        # Every rank: a ZeRO-1 optimizer over the processes gathers its
        # moment slices to rank 0 here.  Rank 0 writes the generation.
        leaves = train_state_leaves(state)
        if process_rank() != 0:
            return True
        metas = [_leaf_meta(leaf) for leaf in leaves]
        bufs = self._acquire_buffers(metas, block=block, timeout_s=timeout_s)
        if bufs is None:
            self.metrics.incr("resilience.ckpt_skipped")
            logger.warning(
                "resilience: checkpoint writer backed up — skipping "
                "step-%d checkpoint (lost-work bound grows one interval)",
                int(state.step),
            )
            return False
        with torch.no_grad():
            for buf, leaf in zip(bufs, leaves):
                if isinstance(leaf, torch.Tensor):
                    # A blocking copy on the current stream: it waits for
                    # the steps that produced the state, and lands before
                    # any later step can update the tensor in place.
                    torch.from_numpy(buf).copy_(leaf.detach())
                else:
                    np.copyto(buf, leaf, casting="no")
        loader_dict = (dataclasses.asdict(loader_ckpt)
                       if loader_ckpt is not None else None)
        with self._cond:
            self._queue.append((int(state.step), bufs, loader_dict))
            self._ensure_writer()
            self._cond.notify_all()
        self.metrics.add_time("resilience.ckpt_submit",
                              time.perf_counter() - t0)
        return True

    def checkpoint_now(self, state: TrainState,
                       loader_ckpt: Optional[LoaderCheckpoint] = None,
                       timeout_s: float = 60.0) -> None:
        """The forced checkpoint (preemption drain): submit with
        backpressure-wait, then flush; raises :class:`CheckpointError`
        if the generation is not durably written inside ``timeout_s``
        (one budget for both halves).  A stale failure of an earlier
        periodic write is cleared first."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._cond:
            self._last_error = None
        self.submit(state, loader_ckpt, block=True, timeout_s=timeout_s)
        self.flush(timeout_s=max(0.0, deadline - time.monotonic()))
        self.metrics.incr("resilience.final_ckpts")

    def flush(self, timeout_s: float = 60.0) -> None:
        """Bounded wait for every queued write to land (raises
        :class:`CheckpointError` on timeout or a writer failure; a raised
        failure is consumed)."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._cond:
            while self._queue or self._busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise CheckpointError(
                        f"checkpoint flush timed out after {timeout_s}s "
                        f"({len(self._queue)} generation(s) still queued)"
                    )
                self._cond.wait(min(0.2, remaining))
            err, self._last_error = self._last_error, None
        from ddl_tpu_torch.parallel.mesh import process_count

        if process_count() > 1:
            import torch.distributed as dist

            dist.barrier()  # rank 0's generations are live for every rank
        if err is not None:
            raise CheckpointError(
                f"checkpoint write failed: {type(err).__name__}: {err}"
            ) from err

    def close(self, timeout_s: float = 60.0) -> None:
        if self._closed:
            return
        try:
            self.flush(timeout_s=timeout_s)
        finally:
            self._closed = True
            with self._cond:
                t = self._thread
                self._free.clear()
                self._cond.notify_all()
            if t is not None:
                t.join(timeout_s)

    # -- the writer thread -------------------------------------------------

    def _ensure_writer(self) -> None:
        # Caller holds self._cond.
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="ddl-ckpt-writer", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        idle_since = time.monotonic()
        while True:
            with self._cond:
                while not self._queue:
                    if self._closed or (
                        time.monotonic() - idle_since > self._IDLE_EXIT_S
                    ):
                        self._thread = None
                        self._cond.notify_all()
                        return
                    self._cond.wait(0.2)
                step, bufs, loader_dict = self._queue.pop(0)
                self._busy = True
            try:
                with self.metrics.timed("resilience.ckpt_write"):
                    self._write_generation(step, bufs, loader_dict)
                self.metrics.incr("resilience.ckpts")
            except (ShutdownRequested, KeyboardInterrupt):
                with self._cond:
                    self._busy = False
                    self._thread = None
                    self._cond.notify_all()
                raise
            except Exception as e:  # the writer survives one bad write
                self.metrics.incr("resilience.ckpt_write_failures")
                logger.exception(
                    "resilience: checkpoint write for step %d failed", step
                )
                with self._cond:
                    self._last_error = e
            finally:
                self._release_buffers(bufs)
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()
            idle_since = time.monotonic()

    def _write_generation(self, step: int, leaves: List[np.ndarray],
                          loader_dict: Optional[dict]) -> None:
        parts, total = _generation_parts(step, leaves, loader_dict)
        plan = armed_plan()
        if plan is not None and any(s.site == "resilience.ckpt_write"
                                    for s in plan.specs):
            # The chaos site flips bytes of the stamped payload; joined
            # only while a spec names it (the leaves may be views of
            # live memory, and a plan for another site costs nothing).
            blob = np.concatenate([
                np.frombuffer(p, np.uint8) if isinstance(p, bytes) else p
                for p in parts
            ])
            fault_point("resilience.ckpt_write",
                        view=blob[: total - integrity.HEADER_BYTES])
            parts = [blob]
        atomic_file_write(os.path.join(self.directory, _gen_name(step)), parts)
        self.metrics.set_gauge("resilience.ckpt_bytes", float(total))
        if loader_dict is not None:
            # Mirror for tooling; the embedded copy is authoritative.
            atomic_file_write(
                os.path.join(self.directory, "loader.json"),
                json.dumps(loader_dict).encode(),
            )
        self._trim_retention()

    def _trim_retention(self) -> None:
        gens = list_generations(self.directory)
        for _step, path in gens[: -self.keep] if len(gens) > self.keep else []:
            try:
                os.unlink(path)
                self.metrics.incr("resilience.ckpt_retired")
            except OSError:
                logger.warning("resilience: could not retire generation %s",
                               path)
        # Quarantined blobs are retired once their step ages past the
        # retained window (forensics, not a disk leak).
        if not gens[-self.keep:]:
            return
        oldest_kept = gens[-self.keep:][0][0]
        for name in os.listdir(self.directory):
            if ".ckpt.quarantined" not in name:
                continue
            m = re.match(r"^gen_(\d{10})\.ckpt\.quarantined", name)
            if m and int(m.group(1)) < oldest_kept:
                try:
                    os.unlink(os.path.join(self.directory, name))
                    self.metrics.incr("resilience.ckpt_retired")
                except OSError:
                    logger.warning(
                        "resilience: could not retire quarantined %s", name)
