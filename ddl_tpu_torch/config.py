"""Run configuration (port of ``ddl_tpu/config.py``): one typed dataclass
per half of a run, layered defaults → JSON file → ``DDL_TORCH_*`` env
vars → explicit kwargs, later layers winning.

Every field of the JAX package's ``LoaderConfig`` and ``TrainConfig`` is
here and loads and saves.  ``output`` names the port's device container
``"device"`` where the JAX package says ``"jax"``.  A field whose module
the port has not ported yet (host identity, the pipeline schedule,
ZeRO-1, int8 gradient communication)
raises ``NotImplementedError`` naming its ``ROADMAP.md`` item when a
consumer is handed a non-default value (:meth:`LoaderConfig.check_ported`,
:meth:`TrainConfig.check_ported`); it is never silently ignored.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

from ddl_tpu_torch.types import RunMode


@dataclasses.dataclass
class LoaderConfig:
    """Everything the pipeline needs, in one place."""

    # topology: "thread" or "process" (spawned producers over shm rings)
    mode: str = RunMode.THREAD.value
    n_producers: int = 2
    nslots: int = 2
    # host identity (-1/0 = auto-detect; the multi-host slice)
    host_id: int = -1
    n_hosts: int = 0
    procs_per_host: int = 0
    # batch geometry
    batch_size: int = 32
    n_epochs: int = 1
    # global shuffle
    global_shuffle_fraction_exchange: float = 0.0
    exchange_method: str = "sendrecv_replace"
    shuffle_seed: int = 0
    # consumer output: "device" (the trainer's card), "numpy" or "torch"
    output: str = "device"
    # zero-copy window streaming (Trainer.fit window_stream)
    window_stream: bool = False
    # failure detection
    ring_timeout_s: float = 300.0
    stall_budget_s: float = 120.0
    # checkpointing (Trainer constructor arguments read these in callers)
    checkpoint_dir: Optional[str] = None
    checkpoint_every_epochs: int = 0  # 0 = disabled
    # shard cache (ddl_tpu_torch.cache): exported to DDL_TORCH_CACHE* by
    # distributed_dataloader(config=...) before producers start
    cache: bool = False
    cache_ram_mb: int = 256
    cache_spill_dir: Optional[str] = None
    cache_spill_mb: int = 1024
    cache_warm: bool = True
    cache_codec: str = ""
    # wire format (ddl_tpu_torch.wire): "" = no opinion (the reader's
    # capability decides), "raw"/"bf16"/"int8" force the slot wire;
    # wire_codec names the exchange lanes' lossless codec ("none" = off).
    # Exported to DDL_TORCH_WIRE_DTYPE/_CODEC before producers start.
    wire_dtype: str = ""
    wire_codec: str = ""
    # device-tier global shuffle: "auto" engages it when plannable,
    # "0"/"off"/"false" keeps the host exchange; the port's one device
    # exchange is the ring (K9)
    device_shuffle: str = "auto"
    shuffle_impl: str = "ring"
    # device transfers kept in flight by the batch prefetcher
    prefetch_depth: int = 2

    _ENV_PREFIX = "DDL_TORCH_"

    @classmethod
    def load(cls, path: Optional[str] = None, **overrides: Any) -> "LoaderConfig":
        """defaults → JSON file → env (``DDL_TORCH_<FIELD>``) → kwargs."""
        return _load_layered(cls, path, overrides)

    def save(self, path: str) -> None:
        _save_json(self, path)

    def run_mode(self) -> RunMode:
        return RunMode(self.mode)

    def check_ported(self) -> None:
        """Raise ``NotImplementedError`` for a non-default value of a field
        whose module is not ported yet."""
        _check_unported(self, _LOADER_UNPORTED)
        if self.mode == RunMode.MULTIHOST.value:
            raise NotImplementedError(
                "mode='multihost' waits for the multi-host slice "
                "(ROADMAP.md A5b)"
            )
        if self.shuffle_impl == "xla":
            raise NotImplementedError(
                "LoaderConfig.shuffle_impl='xla' (ppermute lanes) waits for "
                "ROADMAP.md A5b; the port's device exchange is the ring"
            )
        if self.shuffle_impl != "ring":
            raise ValueError(
                f"shuffle_impl must be ring|xla, got {self.shuffle_impl!r}"
            )


@dataclasses.dataclass
class TrainConfig:
    """Training hot-path knobs, env-overridable as
    ``DDL_TORCH_TRAIN_<FIELD>``.

    ``remat`` names the rematerialisation policy
    (:mod:`ddl_tpu_torch.models.remat`) and applies to a model config
    through :meth:`model_config`; ``accum_steps`` flows into the
    :class:`~ddl_tpu_torch.trainer.Trainer`; the distributed-optimizer
    knobs flow through :meth:`optimizer_kwargs` into every step factory
    the Trainer builds.  The pipeline schedule loads and saves; a
    non-default value raises where it is consumed
    (:meth:`pipeline_kwargs`, the Trainer)."""

    remat: str = "none"
    schedule: str = "gpipe"
    pp_chunks: int = 0
    n_microbatches: int = 1
    accum_steps: int = 1
    optimizer_sharding: str = "none"
    grad_comm: str = "fp32"
    grad_comm_block: int = 0
    stochastic_rounding: bool = False

    _ENV_PREFIX = "DDL_TORCH_TRAIN_"

    @classmethod
    def load(cls, path: Optional[str] = None, **overrides: Any) -> "TrainConfig":
        """defaults → JSON file → env (``DDL_TORCH_TRAIN_<FIELD>``) → kwargs."""
        cfg = _load_layered(cls, path, overrides)
        from ddl_tpu_torch.models import remat as _remat

        _remat.resolve(cfg.remat)  # fail on junk at load time
        if cfg.schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown schedule {cfg.schedule!r}")
        if cfg.optimizer_sharding not in ("none", "zero1"):
            raise ValueError(
                f"unknown optimizer_sharding {cfg.optimizer_sharding!r} "
                "(valid: none, zero1)"
            )
        if cfg.grad_comm not in ("fp32", "int8"):
            raise ValueError(
                f"unknown grad_comm {cfg.grad_comm!r} (valid: fp32, int8)"
            )
        return cfg

    def save(self, path: str) -> None:
        _save_json(self, path)

    def model_config(self, model_cfg: Any) -> Any:
        """The model config with this TrainConfig's remat policy applied."""
        return dataclasses.replace(model_cfg, remat=self.remat)

    def pipeline_kwargs(self) -> dict:
        """kwargs for a pipeline schedule (ROADMAP.md A5b)."""
        _check_unported(self, _PIPELINE_UNPORTED)
        return {"schedule": self.schedule, "n_chunks": self.pp_chunks or None}

    def optimizer_kwargs(self) -> dict:
        """The distributed-optimizer knobs, shaped for ``**`` splatting
        into ``make_train_step`` / ``make_multistep`` (the Trainer passes
        them to both)."""
        return {
            "optimizer_sharding": self.optimizer_sharding,
            "grad_comm": self.grad_comm,
            "grad_comm_block": self.grad_comm_block,
            "stochastic_rounding": self.stochastic_rounding,
        }

    def check_ported(self) -> None:
        """Raise ``NotImplementedError`` for a non-default value of a knob
        whose module is not ported yet (what the Trainer checks)."""
        _check_unported(self, _PIPELINE_UNPORTED)


#: (fields, what waits for them) of the unported LoaderConfig fields.
_LOADER_UNPORTED: Tuple[Tuple[Tuple[str, ...], str], ...] = (
    (("host_id", "n_hosts", "procs_per_host"),
     "host identity waits for the multi-host slice (ROADMAP.md A5b)"),
)
_PIPELINE_UNPORTED = (
    (("schedule", "pp_chunks", "n_microbatches"),
     "the pipeline schedule waits for parallel/pipeline.py (ROADMAP.md A5b)"),
)


def _check_unported(cfg: Any, groups: Tuple[Tuple[Tuple[str, ...], str], ...]) -> None:
    defaults: Dict[str, Any] = {
        f.name: f.default for f in dataclasses.fields(type(cfg))
    }
    for names, why in groups:
        for name in names:
            value = getattr(cfg, name)
            if value != defaults[name]:
                raise NotImplementedError(
                    f"{type(cfg).__name__}.{name}={value!r}: {why}"
                )


def _load_layered(cls: Any, path: Optional[str], overrides: dict) -> Any:
    """The layered loader both config classes share: defaults → JSON file
    → env (``<cls._ENV_PREFIX><FIELD>``) → kwargs, unknown JSON keys
    refused."""
    values: dict = {}
    if path:
        with open(path) as f:
            loaded = json.load(f)
        unknown = set(loaded) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(
                f"unknown config keys in {path}: {sorted(unknown)}"
            )
        values.update(loaded)
    # Lazy: envspec imports this module to derive the knob families.
    from ddl_tpu_torch import envspec

    for field in dataclasses.fields(cls):
        if field.name.startswith("_"):
            continue
        env = envspec.raw(cls._ENV_PREFIX + field.name.upper())
        if env is not None:
            values[field.name] = _coerce(env, field.type)
    values.update(overrides)
    return cls(**values)


def _save_json(cfg: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


def _coerce(raw: str, annot: Any) -> Any:
    """An env string as the field's type.  A bool field is true only for
    ``1``/``true``/``yes``: the config layer's rule, which differs from
    the knob registry's (anything but ``0``/``off``/``false``) in the
    JAX package too."""
    annot = str(annot)
    if "int" in annot:
        return int(raw)
    if "float" in annot:
        return float(raw)
    if "bool" in annot:
        return raw.lower() in ("1", "true", "yes")
    return raw
