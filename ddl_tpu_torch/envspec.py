"""Registry of the environment knobs the port reads (the slice's subset
of ``ddl_tpu/envspec.py``).

Each knob keeps the meaning and default of its ``DDL_TPU_*`` twin but
lives under the port's own prefix, ``DDL_TORCH_``, so a test that sets
one package's knob cannot steer the other.  Reading an unregistered name
raises, so a knob cannot exist outside this table.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

PREFIX = "DDL_TORCH_"

#: Values a bool knob reads as False (case-insensitive).
FALSY = ("0", "off", "false", "no")


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    type: str  # "bool" | "int" | "float" | "str"
    default: Any
    doc: str


REGISTRY: Dict[str, Knob] = {
    k.name: k
    for k in (
        Knob("DDL_TORCH_MODE", "str", "thread",
             "Producer realisation: thread | process."),
        Knob("DDL_TORCH_N_PRODUCERS", "int", 2,
             "Producer workers per consumer instance."),
        Knob("DDL_TORCH_NSLOTS", "int", 2,
             "Ring slots (window buffers) per producer."),
        Knob("DDL_TORCH_INPLACE", "bool", True,
             "Write-once producer fills straight into live ring slots "
             "(0 = private array + commit copy per window)."),
        Knob("DDL_TORCH_INTEGRITY", "bool", True,
             "Checksummed window trailers + drain-time verification "
             "(0/off disables)."),
        Knob("DDL_TORCH_PREFETCH_DEPTH", "int", 2,
             "Device transfers kept in flight by the batch prefetcher."),
        Knob("DDL_TORCH_FUSED", "bool", True,
             "Fused compute/ingest stream loop (0 = synchronous loop)."),
        Knob("DDL_TORCH_FORCE_PY_RING", "bool", False,
             "Force the pure-Python ring even where the native shm ring "
             "builds (test/debug escape hatch)."),
        Knob("DDL_TORCH_STAGED", "bool", True,
             "Staged-ingest engine (0 = inline copy per window/batch)."),
        Knob("DDL_TORCH_SHM_STAGING", "bool", True,
             "Alias staging: a staged window's copy to the card sources "
             "its page-locked ring slot directly (0 = copying pool)."),
        Knob("DDL_TORCH_STAGING_POOL_CAP", "int", 8,
             "StagingPool buffer cap per geometry."),
        Knob("DDL_TORCH_STAGING_QUEUE", "int", 4,
             "TransferExecutor queue depth (in-flight staged transfers)."),
        Knob("DDL_TORCH_STAGING_RETRIES", "int", 2,
             "Staged-transfer retries before the inline fallback."),
        Knob("DDL_TORCH_MAX_REPLAYS", "int", 2,
             "Replay attempts per quarantined corrupt window before "
             "IntegrityError escalation."),
        Knob("DDL_TORCH_CTRL_RETRIES", "int", 5,
             "Acked control-envelope retry cap per send "
             "(transport/envelope.py)."),
        Knob("DDL_TORCH_CTRL_BACKOFF_S", "float", 0.02,
             "Initial acked control-envelope retry backoff, seconds "
             "(doubles per retry)."),
        Knob("DDL_TORCH_DEVICE_SHUFFLE", "str", "auto",
             "Device-tier exchange gate: auto = engage when plannable "
             "(THREAD topology, raw wire, in-process fabric), "
             "0/off/false = host exchange only."),
    )
}


def require(name: str) -> Knob:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unregistered knob {name!r}") from None


def get(name: str, override: Any = None) -> Any:
    """Typed read: explicit ``override`` wins, then the environment, then
    the registered default (an empty string reads as unset)."""
    knob = require(name)
    if override is not None:
        return override
    val = os.environ.get(name)
    if val is None or val == "":
        return knob.default
    if knob.type == "bool":
        return val.lower() not in FALSY
    if knob.type == "int":
        return int(val)
    if knob.type == "float":
        return float(val)
    return val


def flag(name: str, override: Optional[bool] = None) -> bool:
    """Boolean read: truthy unless ``0``/``off``/``false``/``no``."""
    return bool(get(name, override))
