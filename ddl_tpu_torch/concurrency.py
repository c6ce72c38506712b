"""Named lock factories (port of ``ddl_tpu/concurrency.py``, minus the
armed lock-order sanitizer, which is a later slice).

Every lock in the port is built through these factories so a lock has a
name and the declared order below documents the hierarchy: a thread
holding a lock only takes locks that come later in :data:`LOCK_ORDER`.
"""

from __future__ import annotations

import threading
from typing import Any, Tuple

#: The port's lock hierarchy, outermost first.
LOCK_ORDER: Tuple[str, ...] = (
    "transport.connection",
    "transport.ring.cond",
    # The staging engine's queue, then its buffer pool; the ingestor's
    # transfer lock is taken by either thread that runs a staged job.
    "staging.executor.cv",
    "staging.pool",
    "ingest.transfer",
    # The device-tier exchange board ranks above the host board: the
    # device tier latches to the host exchange, never the reverse.
    "shuffle.device.cond",
    "shuffle.device.landing",
    "shuffle.exchange.cond",
    "obs.metrics",
)


def _check(name: str) -> None:
    if name not in LOCK_ORDER:
        raise ValueError(f"lock {name!r} is not in LOCK_ORDER")


def named_lock(name: str) -> Any:
    _check(name)
    return threading.Lock()


def named_rlock(name: str) -> Any:
    _check(name)
    return threading.RLock()


def named_condition(name: str) -> Any:
    _check(name)
    return threading.Condition(threading.Lock())
