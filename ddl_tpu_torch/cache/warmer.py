"""Background cache warmer: prefetch upcoming shards off the fill path
(port of ``ddl_tpu/cache/warmer.py``).

A :class:`CacheWarmer` walks a reader's shard list in epoch order (the
order refills will ask for them) on one daemon thread, loading whatever
is not cached yet until a byte budget is spent, so a shard's fetch and
decode are paid before its refill asks.

``close()`` sets a stop event and joins with a bound.  The loop checks
the event between jobs and hands every loader a ``should_abort``
callback, so a prefetch blocked in a backend retry's backoff aborts
promptly (:class:`~ddl_tpu_torch.exceptions.ShutdownRequested`, a clean
exit).  Warming is best effort: any other loader failure is logged and
the shard left for the fill path, which retries it with the full ladder.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np

from ddl_tpu_torch.cache.store import CacheKey, CacheStore
from ddl_tpu_torch.exceptions import ShutdownRequested

logger = logging.getLogger("ddl_tpu_torch")

#: One prefetch job: the entry's key, or a zero-argument thunk giving it
#: (resolved on the warmer thread: a key's fingerprint may cost a backend
#: round trip), and a loader called as ``loader(should_abort)`` that
#: returns the decoded shard.
WarmJob = Tuple[
    Union[CacheKey, Callable[[], CacheKey]],
    Callable[[Callable[[], bool]], np.ndarray],
]


class CacheWarmer:
    """Prefetch ``jobs`` into ``store`` on a background daemon thread.

    ``budget_bytes`` bounds what the warmer itself loads (default: the
    store's RAM budget, past which warming would evict what it just
    warmed).  Cached entries are skipped through ``store.contains``,
    which leaves the hit and miss counters alone."""

    def __init__(
        self,
        store: CacheStore,
        jobs: Sequence[WarmJob],
        budget_bytes: Optional[int] = None,
        name: str = "ddl-cache-warmer",
    ):
        self._store = store
        self._jobs = list(jobs)
        self._budget = (
            store.ram_budget_bytes if budget_bytes is None else int(budget_bytes)
        )
        self._stop = threading.Event()
        self._warmed_bytes = 0
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True
        )
        self._thread.start()

    def should_abort(self) -> bool:
        return self._stop.is_set()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    @property
    def warmed_bytes(self) -> int:
        return self._warmed_bytes

    def _run(self) -> None:
        try:
            for key_ref, loader in self._jobs:
                if self._stop.is_set():
                    raise ShutdownRequested("cache warmer stopped")
                if self._warmed_bytes >= self._budget:
                    logger.debug(
                        "cache warmer: budget spent (%d bytes), stopping",
                        self._warmed_bytes,
                    )
                    break
                try:
                    key = key_ref() if callable(key_ref) else key_ref
                    if self._store.contains(key):
                        continue
                    arr = loader(self._stop.is_set)
                except ShutdownRequested:
                    raise
                except Exception:
                    # Best effort: the fill path retries this shard with
                    # the full retry and quarantine ladder.
                    logger.exception(
                        "cache warmer: prefetch failed; shard left cold"
                    )
                    continue
                self._store.put(key, arr)
                self._warmed_bytes += int(arr.nbytes)
                self._store.metrics.incr("cache.warmed")
        except ShutdownRequested:
            logger.debug("cache warmer: clean shutdown mid-prefetch")

    def close(self, timeout_s: float = 10.0) -> bool:
        """Stop and join (bounded).  True when the thread exited within
        the bound; idempotent."""
        self._stop.set()
        self._thread.join(timeout_s)
        return not self._thread.is_alive()
