"""ddl_tpu_torch.resilience — preemption-tolerant training (port of
``ddl_tpu/resilience/``).

- :class:`AsyncCheckpointer` — background-thread generation checkpoints
  (atomic temp+rename, integrity-trailer stamped, step-derived seq,
  keep-K retention, the loader cursor fenced into the same file), in the
  JAX package's file format.
- :class:`PreemptionGuard` — SIGTERM / ``DDL_TORCH_PREEMPT_NOTICE`` /
  programmatic notices turned into a deadline-bounded graceful drain.
- The restore ladder — :func:`latest_verified_generation` /
  :func:`restore_latest`: unverifiable generations quarantined and
  skipped, fallback to the previous verified one, a counted cold start
  at exhaustion.
"""

from ddl_tpu_torch.resilience.ckpt import (
    AsyncCheckpointer,
    RestoredRun,
    latest_verified_generation,
    list_generations,
    restore_latest,
    serialize_generation,
    verify_generation,
)
from ddl_tpu_torch.resilience.guard import (
    DEADLINE_ENV,
    DEFAULT_DEADLINE_S,
    NOTICE_ENV,
    PreemptionGuard,
)

__all__ = [
    "AsyncCheckpointer",
    "DEADLINE_ENV",
    "DEFAULT_DEADLINE_S",
    "NOTICE_ENV",
    "PreemptionGuard",
    "RestoredRun",
    "latest_verified_generation",
    "list_generations",
    "restore_latest",
    "serialize_generation",
    "verify_generation",
]
