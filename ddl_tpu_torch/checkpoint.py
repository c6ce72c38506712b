"""Checkpoint / resume for train state and loader progress (port of
``ddl_tpu/checkpoint.py``).

- :func:`save_train_state` / :func:`restore_train_state` — the params
  and optimizer state as a torch state dict (where the JAX package uses
  Orbax), saved into a ``.tmp.<pid>`` directory, stamped with a per-file
  crc32 manifest and only then renamed to ``step_<n>``; a same-step
  overwrite parks the old copy first.  :func:`latest_verified_step`
  verifies the manifest on read and quarantines a torn or bit-rotted
  generation (``.quarantined``), so the previous one restores instead.
- :class:`LoaderCheckpoint` — the loader's logical clock (epoch, window
  target, batch-in-window, shuffle round), small JSON, the same fields
  in the same order as the JAX package's, so the files are identical.

:func:`atomic_file_write` is the one write primitive for checkpoint
bytes: temp file in the target's directory, fsync, ``os.replace``, fsync
of the directory.  The async generation tier
(:mod:`ddl_tpu_torch.resilience`) writes through it too.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import zlib
from typing import Any, Iterable, Optional, Union

import torch

from ddl_tpu_torch import cache as cache_mod
from ddl_tpu_torch.parallel.train import TrainState, tree_leaves

logger = logging.getLogger("ddl_tpu_torch")

#: Per-generation integrity manifest written inside every step directory
#: before the atomic rename: relpath -> {size, crc32}.
MANIFEST_NAME = "ddl_manifest.json"

#: The state file inside a step directory.
STATE_NAME = "state.pt"


def atomic_file_write(path: str, data: Union[bytes, Any, Iterable[Any]],
                      fsync: bool = True) -> None:
    """The checkpoint-byte write primitive: a temp file in the target's
    own directory, then ``os.replace`` — readers see the old bytes or the
    new bytes, never a torn mix, and a crash mid-write leaves only a
    ``.tmp.<pid>`` orphan no reader matches.  ``data`` is a bytes-like
    object or a list of them, written in order (a multi-GB generation
    goes out leaf by leaf, never joined in memory).  ``fsync=True``
    flushes to stable storage before the rename and fsyncs the
    directory entry after it."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    parts = data if isinstance(data, (list, tuple)) else (data,)
    with open(tmp, "wb") as f:
        for part in parts:
            f.write(part)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        try:
            dfd = os.open(os.path.dirname(path), os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass  # a filesystem without directory fsync


def _file_crc(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _write_manifest(step_dir: str) -> None:
    """Stamp ``MANIFEST_NAME`` over every file in ``step_dir`` (size and
    crc32 per file)."""
    entries = {}
    for root, _dirs, files in os.walk(step_dir):
        for name in files:
            if name == MANIFEST_NAME or ".tmp." in name:
                continue
            full = os.path.join(root, name)
            rel = os.path.relpath(full, step_dir)
            entries[rel] = {
                "size": os.path.getsize(full), "crc32": _file_crc(full),
            }
    atomic_file_write(
        os.path.join(step_dir, MANIFEST_NAME),
        json.dumps({"version": 1, "files": entries}).encode(),
    )


def verify_step_dir(step_dir: str) -> Optional[str]:
    """Check a step directory against its manifest.  Returns a failure
    description, or None when every file matches (or the directory has
    no manifest: such a generation stays restorable, logged)."""
    manifest = os.path.join(step_dir, MANIFEST_NAME)
    if not os.path.exists(manifest):
        logger.warning(
            "checkpoint %s has no integrity manifest — accepting "
            "unverified", step_dir,
        )
        _metrics().incr("resilience.ckpt_unverified")
        return None
    try:
        with open(manifest) as f:
            entries = json.load(f)["files"]
    except (OSError, ValueError, KeyError) as e:
        return f"unreadable manifest: {e}"
    for rel, want in entries.items():
        full = os.path.join(step_dir, rel)
        if not os.path.exists(full):
            return f"missing file {rel}"
        size = os.path.getsize(full)
        if size != want["size"]:
            return f"{rel}: size {size} != manifest {want['size']} (torn)"
        if _file_crc(full) != want["crc32"]:
            return f"{rel}: crc32 mismatch (bit rot or partial write)"
    return None


def _metrics():
    from ddl_tpu_torch.observability import metrics as default_metrics

    return default_metrics()


def quarantine_path(path: str, metrics=None) -> str:
    """Rename a corrupt checkpoint (file or step dir) out of the restore
    namespace — ``<path>.quarantined``, uniquified if taken — and count
    ``resilience.ckpt_quarantined`` on ``metrics`` (the process default
    when None).  Returns the quarantine path."""
    dest = f"{path}.quarantined"
    n = 1
    while os.path.exists(dest):
        dest = f"{path}.quarantined.{n}"
        n += 1
    m = metrics if metrics is not None else _metrics()
    try:
        os.replace(path, dest)
    except OSError:
        logger.warning("checkpoint quarantine rename of %s lost a race", path)
        return dest
    m.incr("resilience.ckpt_quarantined")
    logger.error(
        "checkpoint %s failed verification — quarantined to %s", path, dest,
    )
    return dest


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_train_state(state: TrainState, path: str) -> None:
    """Persist params + optimizer state + step — atomically.

    The state dict lands in a ``.tmp.<pid>`` sibling directory, a
    per-file crc32 manifest is stamped inside it, and only then is the
    directory renamed to ``step_<n>``; a same-step overwrite parks the
    old copy under ``.old.<pid>`` until the new one is live.  A crash at
    any point leaves the previous generations intact plus ignorable
    orphans, or the complete verified new generation."""
    path = os.path.abspath(path)
    final = os.path.join(path, f"step_{state.step}")
    tmp = f"{final}.tmp.{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(
        {"params": _to_cpu(state.params),
         "optimizer": _to_cpu(state.optimizer.state_dict()),
         "step": int(state.step)},
        os.path.join(tmp, STATE_NAME),
    )
    _write_manifest(tmp)
    old = None
    if os.path.exists(final):
        old = f"{final}.old.{os.getpid()}"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.replace(final, old)
    os.replace(tmp, final)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def latest_verified_step(path: str, quarantine: bool = True) -> Optional[int]:
    """The newest step under ``path`` whose manifest verifies.
    Unverifiable generations are quarantined and skipped; exhaustion
    returns None (cold start).  Temp and quarantined directories never
    match the ``step_<n>`` pattern."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return None
    steps = sorted(
        (
            int(d.split("_", 1)[1])
            for d in os.listdir(path)
            if d.startswith("step_") and d.split("_", 1)[1].isdigit()
        ),
        reverse=True,
    )
    for step in steps:
        step_dir = os.path.join(path, f"step_{step}")
        err = verify_step_dir(step_dir)
        if err is None:
            return step
        logger.error("checkpoint step_%d failed verification (%s)", step, err)
        if quarantine:
            quarantine_path(step_dir)
    return None


latest_step = latest_verified_step


def restore_train_state(path: str, like: TrainState,
                        step: Optional[int] = None) -> TrainState:
    """Restore the newest verified checkpoint under ``path`` INTO
    ``like``: its parameter tensors are overwritten in place (the
    optimizer keeps referencing them) and its optimizer loads the saved
    state.  Pass ``step`` when the caller already verified it."""
    if step is None:
        step = latest_verified_step(path)
    if step is None:
        raise FileNotFoundError(f"no verified checkpoints under {path!r}")
    saved = torch.load(
        os.path.join(os.path.abspath(path), f"step_{step}", STATE_NAME),
        map_location="cpu", weights_only=True,
    )
    src, dst = tree_leaves(saved["params"]), tree_leaves(like.params)
    if len(src) != len(dst) or any(
        s.shape != d.shape or s.dtype != d.dtype for s, d in zip(src, dst)
    ):
        from ddl_tpu_torch.exceptions import CheckpointError

        raise CheckpointError(
            f"step_{step} under {path} does not fit the current params — "
            "geometry changed"
        )
    with torch.no_grad():
        for s, d in zip(src, dst):
            d.copy_(s)
    like.optimizer.load_state_dict(saved["optimizer"])
    return TrainState(like.params, like.optimizer, int(saved["step"]))


def adopt_cache_manifest(path: str) -> bool:
    """Pre-spawn cache warm-start: read only the cache manifest of the
    loader checkpoint at ``path`` and adopt it
    (:func:`ddl_tpu_torch.cache.adopt_manifest`).

    Spawned producers inherit their environment at spawn, so a PROCESS
    resume calls this before ``distributed_dataloader`` starts them.  (A
    THREAD resume does not need it: ``LoaderCheckpoint.apply`` attaches
    the tier to the live shared store.)  Returns False — a cold cache,
    never an error — when the checkpoint is missing or unreadable, has no
    manifest, or the manifest is refused."""
    try:
        ck = LoaderCheckpoint.load(path)
    except (OSError, ValueError, TypeError, KeyError):
        return False
    if not ck.cache_spill_dir:
        return False
    return cache_mod.adopt_manifest(ck.cache_spill_dir, ck.cache_key_schema)


@dataclasses.dataclass
class LoaderCheckpoint:
    """The loader's logical position (enough to resume deterministically).

    ``shuffle_round`` tracks a consumer-owned shuffler's schedule (any
    object with ``exchange_round`` or ``_round``): pass it to
    ``capture``/``apply``.  The cache manifest (``cache_spill_dir`` and
    the key schema it was written under) points a resumed run's shard
    cache at the earlier run's disk tier, so its first epoch reads
    decoded shards instead of refetching; a refused manifest resumes
    with a cold cache.  ``cluster_epoch`` fences a cluster view
    (duck-typed: a supervisor with ``.view.epoch`` or a view with
    ``.epoch``, restored through ``restore_epoch``)."""

    epoch: int = 0
    target: int = 0
    batches_in_window: int = 0
    shuffle_round: int = 0
    cache_spill_dir: Optional[str] = None
    cache_key_schema: int = 0
    cluster_epoch: int = 0

    @staticmethod
    def capture(loader: Any, shuffler: Any = None, cache: Any = None,
                cluster: Any = None) -> "LoaderCheckpoint":
        """The loader's position; ``cache`` is the store whose disk tier
        the manifest names (default: the process-default store if one
        was built — capturing never builds one)."""
        round_ = 0
        if shuffler is not None:
            round_ = getattr(
                shuffler, "exchange_round", getattr(shuffler, "_round", 0)
            )
        store = cache if cache is not None else cache_mod.active_store()
        spill = getattr(store, "spill_dir", None) if store else None
        cluster_epoch = 0
        if cluster is not None:
            view = getattr(cluster, "view", cluster)
            cluster_epoch = int(getattr(view, "epoch", 0))
        return LoaderCheckpoint(
            cluster_epoch=cluster_epoch,
            epoch=loader._epoch,
            target=loader._target,
            batches_in_window=loader._batches_in_window,
            shuffle_round=int(round_),
            cache_spill_dir=spill,
            cache_key_schema=cache_mod.KEY_SCHEMA_VERSION if spill else 0,
        )

    def apply(self, loader: Any, shuffler: Any = None,
              cluster: Any = None) -> None:
        loader._epoch = self.epoch
        loader._target = self.target
        loader._batches_in_window = self.batches_in_window
        if cluster is not None and self.cluster_epoch:
            restore = getattr(cluster, "restore_epoch", None)
            if callable(restore):
                restore(self.cluster_epoch)
        if self.cache_spill_dir:
            if not cache_mod.adopt_manifest(self.cache_spill_dir,
                                            self.cache_key_schema):
                logger.warning(
                    "checkpoint cache manifest not adopted (%s, schema %d)"
                    " — resuming with a cold cache",
                    self.cache_spill_dir, self.cache_key_schema,
                )
        if shuffler is not None:
            rejoin = getattr(shuffler, "rejoin", None)
            if callable(rejoin):
                rejoin(self.shuffle_round)
            else:
                shuffler._round = self.shuffle_round

    def save(self, path: str) -> None:
        atomic_file_write(path, json.dumps(dataclasses.asdict(self)).encode())

    @staticmethod
    def load(path: str) -> "LoaderCheckpoint":
        with open(path) as f:
            return LoaderCheckpoint(**json.load(f))
