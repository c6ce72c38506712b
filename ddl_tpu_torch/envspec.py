"""Registry of the environment knobs the port reads (port of
``ddl_tpu/envspec.py``).

Each knob keeps the meaning, type and default of its ``DDL_TPU_*`` twin
but lives under the port's own prefix, ``DDL_TORCH_``, so a test that
sets one package's knob cannot steer the other.  Reading an unregistered
name raises, so a knob cannot exist outside this table.

Three knob sources, as in the JAX package: explicit entries for knobs
read by name, and the ``DDL_TORCH_<FIELD>`` / ``DDL_TORCH_TRAIN_<FIELD>``
families derived from :class:`~ddl_tpu_torch.config.LoaderConfig` and
:class:`~ddl_tpu_torch.config.TrainConfig`.  :data:`KNOB_MAP` states
where each knob of the JAX package stands in the port, the way
``_manifest.py`` does for files: its twin, ``"todo"`` while its module
is not ported, or ``"n/a: <reason>"``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

from ddl_tpu_torch.config import LoaderConfig, TrainConfig

PREFIX = "DDL_TORCH_"

#: Values (lowercased) a bool knob reads as False; anything else set is
#: True.  The JAX package's set: ``no`` reads as True there, and here.
FALSY = ("0", "off", "false")


class UnknownKnobError(KeyError):
    """An env read named a ``DDL_TORCH_*`` variable the registry does not
    declare."""


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    type: str  # "bool" | "int" | "float" | "str"
    default: Any  # typed default; None = sentinel (unset is meaningful)
    doc: str
    #: LoaderConfig field this knob mirrors (the DDL_TORCH_<FIELD> family).
    config_field: Optional[str] = None
    #: TrainConfig field this knob mirrors (DDL_TORCH_TRAIN_<FIELD>).
    train_field: Optional[str] = None


_EXPLICIT: List[Knob] = [
    # -- topology / spawn ------------------------------------------------
    Knob("DDL_TORCH_MODE", "str", "thread",
         "Producer realisation: thread | process | multihost.", config_field="mode"),
    Knob("DDL_TORCH_N_PRODUCERS", "int", 2,
         "Producer workers per consumer instance.",
         config_field="n_producers"),
    Knob("DDL_TORCH_NSLOTS", "int", 2,
         "Ring slots (window buffers) per producer.", config_field="nslots"),
    Knob("DDL_TORCH_HOST_ID", "int", None,
         "Physical host id of this consumer (env.detect_host_identity).",
         config_field="host_id"),
    Knob("DDL_TORCH_N_HOSTS", "int", None,
         "Physical host count (env.detect_host_identity).",
         config_field="n_hosts"),
    Knob("DDL_TORCH_PROCS_PER_HOST", "int", None,
         "Consumer processes per host (env.detect_host_identity).",
         config_field="procs_per_host"),
    # -- transport rings -------------------------------------------------
    Knob("DDL_TORCH_FORCE_PY_RING", "bool", False,
         "Force the pure-Python ring even where the native shm ring "
         "builds (test/debug escape hatch)."),
    Knob("DDL_TORCH_UNSAFE_PY_RING", "bool", False,
         "Allow the Python ring cross-process on a machine whose memory "
         "order is not known to be TSO (testing only)."),
    Knob("DDL_TORCH_INPLACE", "bool", True,
         "Write-once producer fills straight into live ring slots "
         "(0 = private array + commit copy per window)."),
    Knob("DDL_TORCH_INTEGRITY", "bool", True,
         "Checksummed window trailers + drain-time verification "
         "(0/off disables)."),
    Knob("DDL_TORCH_MAX_REPLAYS", "int", 2,
         "Replay attempts per quarantined corrupt window before "
         "IntegrityError escalation."),
    # -- staging / ingest ------------------------------------------------
    Knob("DDL_TORCH_STAGED", "bool", True,
         "Staged-ingest engine (0 = inline copy per window/batch)."),
    Knob("DDL_TORCH_SHM_STAGING", "bool", True,
         "Alias staging: a staged window's copy to the card sources its "
         "page-locked ring slot directly (0 = copying pool)."),
    Knob("DDL_TORCH_STAGING_POOL_CAP", "int", 8,
         "StagingPool buffer cap per geometry."),
    Knob("DDL_TORCH_STAGING_QUEUE", "int", 4,
         "TransferExecutor queue depth (in-flight staged transfers)."),
    Knob("DDL_TORCH_STAGING_RETRIES", "int", 2,
         "Staged-transfer retries before the inline fallback."),
    Knob("DDL_TORCH_FUSED", "bool", None,
         "Fused compute/ingest stream loop (unset = on; 0 restores the "
         "synchronous loop everywhere)."),
    # -- shard cache (cache/) ---------------------------------------------
    Knob("DDL_TORCH_CACHE", "bool", False, "Shard cache gate.",
         config_field="cache"),
    Knob("DDL_TORCH_CACHE_RAM_MB", "int", 256, "RAM tier budget, MiB.",
         config_field="cache_ram_mb"),
    Knob("DDL_TORCH_CACHE_SPILL_DIR", "str", None,
         "Disk spill directory (unset = RAM tier only).",
         config_field="cache_spill_dir"),
    Knob("DDL_TORCH_CACHE_SPILL_MB", "int", 1024, "Disk spill budget, MiB.",
         config_field="cache_spill_mb"),
    Knob("DDL_TORCH_CACHE_WARM", "bool", True,
         "Background warmer thread prefetching the shard schedule.",
         config_field="cache_warm"),
    Knob("DDL_TORCH_CACHE_CODEC", "str", None,
         "Lossless codec for spilled cache entries.",
         config_field="cache_codec"),
    Knob("DDL_TORCH_CACHE_RETRIES", "int", 3,
         "Backend fetch retries before IntegrityError."),
    Knob("DDL_TORCH_CACHE_BACKOFF_S", "float", 0.05,
         "Base backoff between backend fetch retries, seconds."),
    # -- readers ---------------------------------------------------------
    Knob("DDL_TORCH_TFRECORD_CRC", "bool", True,
         "CRC32C verification of TFRecord length/payload frames."),
    # -- wire format (ROADMAP.md A3) -------------------------------------
    Knob("DDL_TORCH_WIRE_DTYPE", "str", None,
         "Wire transport override: raw = kill switch, bf16/int8 = force "
         "the lossy tier.", config_field="wire_dtype"),
    Knob("DDL_TORCH_WIRE_CODEC", "str", None,
         "Lossless wire codec for the shuffle exchange + shard reads.",
         config_field="wire_codec"),
    # -- global shuffle --------------------------------------------------
    Knob("DDL_TORCH_DEVICE_SHUFFLE", "str", "auto",
         "Device-tier exchange gate: auto = engage when plannable "
         "(THREAD topology, raw wire, in-process fabric), 0/off/false = "
         "host exchange only.",
         config_field="device_shuffle"),
    # -- resilience ------------------------------------------------------
    Knob("DDL_TORCH_CKPT_ASYNC", "bool", True,
         "AsyncCheckpointer (D2H-only stall) vs synchronous writes."),
    Knob("DDL_TORCH_PREEMPT_NOTICE", "str", None,
         "Out-of-band preemption notice: set non-empty (optionally "
         "'<grace_s>') to trigger the graceful-drain ladder."),
    Knob("DDL_TORCH_PREEMPT_DEADLINE_S", "float", 30.0,
         "Default drain deadline after a preemption notice, seconds."),
    # -- control envelopes -----------------------------------------------
    Knob("DDL_TORCH_CTRL_RETRIES", "int", 5,
         "Acked control-envelope retry cap per send "
         "(transport/envelope.py)."),
    Knob("DDL_TORCH_CTRL_BACKOFF_S", "float", 0.02,
         "Initial acked control-envelope retry backoff, seconds "
         "(doubles per retry)."),
    # -- fault injection -------------------------------------------------
    Knob("DDL_TORCH_FAULT_PLAN", "str", None,
         "JSON FaultPlan (faults.py): spawned producers arm it at import."),
    # -- observability ---------------------------------------------------
    Knob("DDL_TORCH_TRACE", "int", None,
         "Span tracing armed at import with this event capacity "
         "(unset = tracing disarmed; obs/spans.py)."),
    Knob("DDL_TORCH_FLIGHT", "int", None,
         "Flight recorder armed at import with this ring capacity "
         "(unset = disarmed; obs/recorder.py)."),
    Knob("DDL_TORCH_FLIGHT_DIR", "str", None,
         "Flight-record dump directory (default ./ddl_flight)."),
    Knob("DDL_TORCH_OBS_SHIP_EVERY", "int", 32,
         "Windows between periodic worker ObsReports (0 = disabled; "
         "obs/aggregate.py)."),
]

#: Every knob of the JAX package's registry → its twin here, ``"todo"``
#: (its module is not ported yet; ROADMAP.md queue A names the item), or
#: ``"n/a: <reason>"``.  Data only; ``tests/test_torch_envspec.py`` holds
#: it to both registries.
KNOB_MAP: Dict[str, str] = {
    "DDL_TPU_MODE": "DDL_TORCH_MODE",
    "DDL_TPU_N_PRODUCERS": "DDL_TORCH_N_PRODUCERS",
    "DDL_TPU_NSLOTS": "DDL_TORCH_NSLOTS",
    "DDL_TPU_HOST_ID": "DDL_TORCH_HOST_ID",
    "DDL_TPU_N_HOSTS": "DDL_TORCH_N_HOSTS",
    "DDL_TPU_PROCS_PER_HOST": "DDL_TORCH_PROCS_PER_HOST",
    "DDL_TPU_FORCE_PY_RING": "DDL_TORCH_FORCE_PY_RING",
    "DDL_TPU_UNSAFE_PY_RING": "DDL_TORCH_UNSAFE_PY_RING",
    "DDL_TPU_INPLACE": "DDL_TORCH_INPLACE",
    "DDL_TPU_INTEGRITY": "DDL_TORCH_INTEGRITY",
    "DDL_TPU_MAX_REPLAYS": "DDL_TORCH_MAX_REPLAYS",
    "DDL_TPU_STAGED": "DDL_TORCH_STAGED",
    "DDL_TPU_SHM_STAGING": "DDL_TORCH_SHM_STAGING",
    "DDL_TPU_STAGING_POOL_CAP": "DDL_TORCH_STAGING_POOL_CAP",
    "DDL_TPU_STAGING_QUEUE": "DDL_TORCH_STAGING_QUEUE",
    "DDL_TPU_STAGING_RETRIES": "DDL_TORCH_STAGING_RETRIES",
    "DDL_TPU_DISTRIBUTE": (
        "n/a: the route to a mesh is DeviceIngestor's distribute= "
        "argument only (the env knob went in the ICI slice's review)"),
    "DDL_TPU_ICI_INGEST": (
        "n/a: the auto-mode kill switch of the ICI tier went with "
        "DDL_TPU_DISTRIBUTE; pass distribute='xla'"),
    "DDL_TPU_FUSED": "DDL_TORCH_FUSED",
    "DDL_TPU_CACHE": "DDL_TORCH_CACHE",
    "DDL_TPU_CACHE_RAM_MB": "DDL_TORCH_CACHE_RAM_MB",
    "DDL_TPU_CACHE_SPILL_DIR": "DDL_TORCH_CACHE_SPILL_DIR",
    "DDL_TPU_CACHE_SPILL_MB": "DDL_TORCH_CACHE_SPILL_MB",
    "DDL_TPU_CACHE_WARM": "DDL_TORCH_CACHE_WARM",
    "DDL_TPU_CACHE_CODEC": "DDL_TORCH_CACHE_CODEC",
    "DDL_TPU_CACHE_RETRIES": "DDL_TORCH_CACHE_RETRIES",
    "DDL_TPU_CACHE_BACKOFF_S": "DDL_TORCH_CACHE_BACKOFF_S",
    "DDL_TPU_WIRE_DTYPE": "DDL_TORCH_WIRE_DTYPE",
    "DDL_TPU_WIRE_CODEC": "DDL_TORCH_WIRE_CODEC",
    "DDL_TPU_DEVICE_SHUFFLE": "DDL_TORCH_DEVICE_SHUFFLE",
    "DDL_TPU_SHUFFLE_IMPL": "DDL_TORCH_SHUFFLE_IMPL",
    "DDL_TPU_TFRECORD_CRC": "DDL_TORCH_TFRECORD_CRC",
    "DDL_TPU_CKPT_ASYNC": "DDL_TORCH_CKPT_ASYNC",
    "DDL_TPU_PREEMPT_NOTICE": "DDL_TORCH_PREEMPT_NOTICE",
    "DDL_TPU_PREEMPT_DEADLINE_S": "DDL_TORCH_PREEMPT_DEADLINE_S",
    "DDL_TPU_SUPERVISOR_LEASE_S": "todo",
    "DDL_TPU_SUPERVISOR_STANDBYS": "todo",
    "DDL_TPU_CTRL_RETRIES": "DDL_TORCH_CTRL_RETRIES",
    "DDL_TPU_CTRL_BACKOFF_S": "DDL_TORCH_CTRL_BACKOFF_S",
    "DDL_TPU_FABRIC_QUANTUM_BYTES": "todo",
    "DDL_TPU_FABRIC_SNAPSHOT_EVERY": "todo",
    "DDL_TPU_FABRIC_ADMIT_TIMEOUT_S": "todo",
    "DDL_TPU_FABRIC_DRAIN_SLO_S": "todo",
    "DDL_TPU_TUNE_DEADLINE_S": "todo",
    "DDL_TPU_TUNE_INTERVAL_S": "todo",
    "DDL_TPU_TUNE_SUSTAIN_S": "todo",
    "DDL_TPU_TUNE_COOLDOWN_S": "todo",
    "DDL_TPU_TUNE_REVERT_TOL": "todo",
    "DDL_TPU_TUNE_PARITY_HEADROOM": "todo",
    "DDL_TPU_FAULT_PLAN": "DDL_TORCH_FAULT_PLAN",
    "DDL_TPU_TRACE": "DDL_TORCH_TRACE",
    "DDL_TPU_FLIGHT": "DDL_TORCH_FLIGHT",
    "DDL_TPU_FLIGHT_DIR": "DDL_TORCH_FLIGHT_DIR",
    "DDL_TPU_OBS_SHIP_EVERY": "DDL_TORCH_OBS_SHIP_EVERY",
    "DDL_TPU_ONCHIP": "n/a: a TPU test-harness gate (the card's tests "
                      "carry the cuda marker)",
    "DDL_TPU_BATCH_SIZE": "DDL_TORCH_BATCH_SIZE",
    "DDL_TPU_N_EPOCHS": "DDL_TORCH_N_EPOCHS",
    "DDL_TPU_GLOBAL_SHUFFLE_FRACTION_EXCHANGE":
        "DDL_TORCH_GLOBAL_SHUFFLE_FRACTION_EXCHANGE",
    "DDL_TPU_EXCHANGE_METHOD": "DDL_TORCH_EXCHANGE_METHOD",
    "DDL_TPU_SHUFFLE_SEED": "DDL_TORCH_SHUFFLE_SEED",
    "DDL_TPU_OUTPUT": "DDL_TORCH_OUTPUT",
    "DDL_TPU_WINDOW_STREAM": "DDL_TORCH_WINDOW_STREAM",
    "DDL_TPU_RING_TIMEOUT_S": "DDL_TORCH_RING_TIMEOUT_S",
    "DDL_TPU_STALL_BUDGET_S": "DDL_TORCH_STALL_BUDGET_S",
    "DDL_TPU_CHECKPOINT_DIR": "DDL_TORCH_CHECKPOINT_DIR",
    "DDL_TPU_CHECKPOINT_EVERY_EPOCHS": "DDL_TORCH_CHECKPOINT_EVERY_EPOCHS",
    "DDL_TPU_PREFETCH_DEPTH": "DDL_TORCH_PREFETCH_DEPTH",
    "DDL_TPU_TRAIN_REMAT": "DDL_TORCH_TRAIN_REMAT",
    "DDL_TPU_TRAIN_SCHEDULE": "DDL_TORCH_TRAIN_SCHEDULE",
    "DDL_TPU_TRAIN_PP_CHUNKS": "DDL_TORCH_TRAIN_PP_CHUNKS",
    "DDL_TPU_TRAIN_N_MICROBATCHES": "DDL_TORCH_TRAIN_N_MICROBATCHES",
    "DDL_TPU_TRAIN_ACCUM_STEPS": "DDL_TORCH_TRAIN_ACCUM_STEPS",
    "DDL_TPU_TRAIN_OPTIMIZER_SHARDING": "DDL_TORCH_TRAIN_OPTIMIZER_SHARDING",
    "DDL_TPU_TRAIN_GRAD_COMM": "DDL_TORCH_TRAIN_GRAD_COMM",
    "DDL_TPU_TRAIN_GRAD_COMM_BLOCK": "DDL_TORCH_TRAIN_GRAD_COMM_BLOCK",
    "DDL_TPU_TRAIN_STOCHASTIC_ROUNDING": "DDL_TORCH_TRAIN_STOCHASTIC_ROUNDING",
}


def _annot_type(annot: Any) -> str:
    s = str(annot)
    if "bool" in s:
        return "bool"
    if "int" in s:
        return "int"
    if "float" in s:
        return "float"
    return "str"


def _build_registry() -> Dict[str, Knob]:
    reg: Dict[str, Knob] = {}
    for k in _EXPLICIT:
        if k.name in reg:
            raise ValueError(f"duplicate knob {k.name}")
        reg[k.name] = k
    # The DDL_TORCH_<FIELD> / DDL_TORCH_TRAIN_<FIELD> families, derived
    # from the dataclasses so a new config field registers itself.
    for cls, field_attr in ((LoaderConfig, "config_field"),
                            (TrainConfig, "train_field")):
        for f in dataclasses.fields(cls):
            name = cls._ENV_PREFIX + f.name.upper()
            if name not in reg:
                reg[name] = Knob(name, _annot_type(f.type), f.default,
                                 f"{cls.__name__}.{f.name} (see config.py).",
                                 **{field_attr: f.name})
    return reg


REGISTRY: Dict[str, Knob] = _build_registry()


def require(name: str) -> Knob:
    try:
        return REGISTRY[name]
    except KeyError:
        raise UnknownKnobError(f"unregistered knob {name!r}") from None


def raw(name: str) -> Optional[str]:
    """The raw environment string of a registered knob (None = unset)."""
    require(name)
    return os.environ.get(name)


def get(name: str, override: Any = None) -> Any:
    """Typed read: explicit ``override`` wins, then the environment, then
    the registered default (an empty string reads as unset)."""
    knob = require(name)
    if override is not None:
        return override
    val = os.environ.get(name)
    if knob.type == "bool":
        if val is None or val == "":
            return bool(knob.default)
        return val.lower() not in FALSY
    if val is None or val == "":
        return knob.default
    if knob.type == "int":
        return int(val)
    if knob.type == "float":
        return float(val)
    return val


def flag(name: str, override: Optional[bool] = None) -> bool:
    """Boolean read: truthy unless ``0``/``off``/``false``
    (case-insensitive)."""
    return bool(get(name, override))
