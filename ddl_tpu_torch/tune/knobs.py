"""Tunable-knob bindings: one get/set seam per live knob (port of
``ddl_tpu/tune/knobs.py``).

A :class:`TunableKnob` binds a knob NAME to the object that owns it at
run time — the PrefetchIterator's depth, the TransferExecutor's queue
bound, the StagingPool's per-geometry cap, a shuffler's per-round
``wire_dtype`` — with bounds the controller never steps outside, and a
``live`` flag separating knobs that retune mid-run from handshake-time
ones the Calibrator may set only before boot.  The controller touches
knobs only through this seam.
"""


from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional

from ddl_tpu_torch import envspec


@dataclasses.dataclass
class TunableKnob:
    """One live tuning point: name + bound get/set + legal range."""

    name: str
    getter: Callable[[], Any]
    setter: Callable[[Any], None]
    #: Inclusive numeric bounds (None = unbounded on that side);
    #: ignored for non-numeric knobs like wire_dtype.
    lo: Optional[float] = None
    hi: Optional[float] = None
    #: False = boot-time only (slot-layout/handshake knobs): the
    #: steady-state controller must refuse to touch it mid-run.
    live: bool = True

    def read(self) -> Any:
        return self.getter()

    def clamp(self, value: Any) -> Any:
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            if self.lo is not None and value < self.lo:
                value = type(value)(self.lo)
            if self.hi is not None and value > self.hi:
                value = type(value)(self.hi)
        return value

    def write(self, value: Any) -> Any:
        """Clamp to bounds, apply, and return what was actually set."""
        value = self.clamp(value)
        self.setter(value)
        return value


def prefetch_knob(prefetch_iter: Any, lo: int = 1, hi: int = 16) -> TunableKnob:
    """Bind a :class:`~ddl_tpu_torch.ingest.PrefetchIterator`'s depth."""
    return TunableKnob(
        name="prefetch_depth",
        getter=lambda: prefetch_iter._depth,
        setter=lambda v: prefetch_iter.set_depth(int(v)),
        lo=lo, hi=hi,
    )


def staging_queue_knob(executor: Any, lo: int = 1, hi: int = 32) -> TunableKnob:
    """Bind a :class:`~ddl_tpu_torch.staging.TransferExecutor`'s queue bound."""
    return TunableKnob(
        name="staging_queue",
        getter=lambda: executor._max_queue,
        setter=lambda v: executor.set_max_queue(int(v)),
        lo=lo, hi=hi,
    )


def staging_pool_knob(pool: Any, lo: int = 1, hi: int = 64) -> TunableKnob:
    """Bind a :class:`~ddl_tpu_torch.staging.StagingPool`'s per-geometry cap."""
    return TunableKnob(
        name="staging_pool_cap",
        getter=lambda: pool.max_per_key,
        setter=lambda v: pool.set_max_per_key(int(v)),
        lo=lo, hi=hi,
    )


def wire_dtype_knob(shuffler: Any) -> TunableKnob:
    """Bind an exchange shuffler's per-round ``wire_dtype``.

    Live for :class:`~ddl_tpu_torch.shuffle.ThreadExchangeShuffler` (the
    attribute is consulted per exchange round); slot-transport wire
    dtypes are handshake-time and must NOT be bound here.
    """
    return TunableKnob(
        name="wire_dtype",
        getter=lambda: getattr(shuffler, "wire_dtype", "raw") or "raw",
        setter=lambda v: setattr(shuffler, "wire_dtype", v),
    )


def env_knob(
    var: str,
    lo: Optional[float] = None,
    hi: Optional[float] = None,
    live: bool = False,
) -> TunableKnob:
    """Bind a registered ``DDL_TORCH_*`` env knob (the envspec seam).

    Boot-time by default: env writes only reach call sites that read
    the registry lazily (loader construction, worker spawn) — a
    :class:`~ddl_tpu_torch.tune.calibrate.TunedConfig` export, not a mid-run
    retune.  The var must exist in the envspec registry (typo guard).
    """
    envspec.require(var)

    def _set(value: Any) -> None:
        os.environ[var] = str(value)

    return TunableKnob(
        name=var,
        getter=lambda: envspec.get(var),
        setter=_set,
        lo=lo, hi=hi, live=live,
    )
