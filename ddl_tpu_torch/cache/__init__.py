"""ddl_tpu_torch.cache — the content-addressed shard cache (port of
``ddl_tpu/cache/``).

Every file-based producer of :mod:`ddl_tpu_torch.readers` fetches shard
bytes through a :class:`StorageBackend` and, when the cache is on, keeps
decoded shards in a :class:`CacheStore` — a byte-budgeted RAM LRU over a
verified disk spill tier — so epochs after the first skip both the fetch
and the decode.  A :class:`CacheWarmer` prefetches the next shards in
epoch order.

Environment knobs (the ``LoaderConfig`` fields of the same lower-case
names mirror the first six; ``distributed_dataloader(config=...)``
exports a config's cache fields before the producers start, so spawned
producers inherit them):

=============================  ============================================
``DDL_TORCH_CACHE``            gate (default **off**; ``1`` enables)
``DDL_TORCH_CACHE_RAM_MB``     RAM tier budget (default 256)
``DDL_TORCH_CACHE_SPILL_DIR``  disk tier directory (unset = no disk tier)
``DDL_TORCH_CACHE_SPILL_MB``   disk tier budget (default 1024)
``DDL_TORCH_CACHE_WARM``       background warmer gate (default on)
``DDL_TORCH_CACHE_CODEC``      codec of the disk entries (unset = raw)
``DDL_TORCH_CACHE_RETRIES``    backend fetch retries (default 3)
``DDL_TORCH_CACHE_BACKOFF_S``  base retry backoff, seconds (default 0.05)
=============================  ============================================

The default store is per process: PROCESS producers each build their own
from the environment, THREAD producers share the consumer's.  Tests pass
explicit ``CacheStore`` and backend instances to the readers instead.
"""

from __future__ import annotations

import os
from typing import Optional

from ddl_tpu_torch import envspec
from ddl_tpu_torch.cache.backends import (
    CodecBackend,
    LocalBackend,
    StorageBackend,
    ThrottledBackend,
    open_with_retry,
)
from ddl_tpu_torch.cache.store import KEY_SCHEMA_VERSION, CacheKey, CacheStore
from ddl_tpu_torch.cache.warmer import CacheWarmer
from ddl_tpu_torch.concurrency import named_lock

__all__ = [
    "CacheKey",
    "CacheStore",
    "CacheWarmer",
    "KEY_SCHEMA_VERSION",
    "CodecBackend",
    "LocalBackend",
    "StorageBackend",
    "ThrottledBackend",
    "active_store",
    "adopt_manifest",
    "cache_enabled",
    "default_store",
    "open_with_retry",
    "reset_default_store",
    "retry_settings_from_env",
    "settings_from_env",
    "warm_enabled",
]


def cache_enabled(override: Optional[bool] = None) -> bool:
    """The ``DDL_TORCH_CACHE`` gate — default off: the cache spends host
    RAM and disk, which is the operator's call."""
    return envspec.flag("DDL_TORCH_CACHE", override)


def warm_enabled(override: Optional[bool] = None) -> bool:
    """The ``DDL_TORCH_CACHE_WARM`` gate (default on; read only when the
    cache itself is on)."""
    return envspec.flag("DDL_TORCH_CACHE_WARM", override)


def settings_from_env() -> dict:
    """The ``DDL_TORCH_CACHE*`` store knobs, parsed into
    :class:`CacheStore` arguments."""
    return {
        "ram_budget_bytes": envspec.get("DDL_TORCH_CACHE_RAM_MB") << 20,
        "spill_dir": envspec.raw("DDL_TORCH_CACHE_SPILL_DIR") or None,
        "spill_budget_bytes": envspec.get("DDL_TORCH_CACHE_SPILL_MB") << 20,
        "codec": envspec.raw("DDL_TORCH_CACHE_CODEC") or None,
    }


def retry_settings_from_env() -> dict:
    """The backend retry knobs, as :func:`open_with_retry` arguments."""
    return {
        "retries": envspec.get("DDL_TORCH_CACHE_RETRIES"),
        "backoff_s": envspec.get("DDL_TORCH_CACHE_BACKOFF_S"),
    }


_default_store: Optional[CacheStore] = None
_store_lock = named_lock("cache.registry")


def default_store() -> CacheStore:
    """The process-default :class:`CacheStore`, built once from the
    environment."""
    global _default_store
    with _store_lock:
        if _default_store is None:
            _default_store = CacheStore(**settings_from_env())
        return _default_store


def active_store() -> Optional[CacheStore]:
    """The default store if one was built, else ``None``: a checkpoint
    capture must not build a store as a side effect."""
    with _store_lock:
        return _default_store


def reset_default_store() -> None:
    """Drop the process-default store (tests re-gate the environment)."""
    global _default_store
    with _store_lock:
        _default_store = None


def adopt_manifest(spill_dir: str, key_schema: int) -> bool:
    """Adopt a checkpoint's cache manifest, so a resumed run warm-starts
    from an earlier run's disk tier.

    The spill dir goes into ``DDL_TORCH_CACHE_SPILL_DIR``, where workers
    and a default store built later pick it up (spawned producers inherit
    it, so adopt before ``distributed_dataloader`` starts them:
    :func:`ddl_tpu_torch.checkpoint.adopt_cache_manifest`), and a default
    store already built RAM-only gets the tier attached in place (the
    THREAD resume).  Refused (False) for another key schema, a missing
    directory, or a live store already on a different spill dir."""
    if key_schema != KEY_SCHEMA_VERSION:
        return False
    if not spill_dir or not os.path.isdir(spill_dir):
        return False
    with _store_lock:
        store = _default_store
    if store is not None and not store.attach_spill_dir(spill_dir):
        return False
    os.environ["DDL_TORCH_CACHE_SPILL_DIR"] = spill_dir
    return True
