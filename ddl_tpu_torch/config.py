"""Run configuration (port of ``ddl_tpu/config.py``): one typed dataclass
per half of a run, layered defaults → JSON file → ``DDL_TORCH_*`` env
vars → explicit kwargs, later layers winning.

Every field of the JAX package's ``LoaderConfig`` and ``TrainConfig`` is
here, loads, saves and reaches its consumer: host identity and
``mode="multihost"`` the topology (:func:`ddl_tpu_torch.env.
detect_topology`), ``shuffle_impl`` the exchange fabric, the pipeline
fields :meth:`TrainConfig.pipeline_kwargs`.  ``output`` names the
port's device container ``"device"`` where the JAX package says
``"jax"``.  :meth:`LoaderConfig.check_ported` / :meth:`TrainConfig.
check_ported` stay the one place a consumer asks whether a value is
ported; nothing is silently ignored.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

from ddl_tpu_torch.types import RunMode


@dataclasses.dataclass
class LoaderConfig:
    """Everything the pipeline needs, in one place."""

    # topology: "thread", "process" (spawned producers over shm rings) or
    # "multihost" (PROCESS producers under each process of a gloo group)
    mode: str = RunMode.THREAD.value
    n_producers: int = 2
    nslots: int = 2
    # host identity (-1/0 = auto-detect, ddl_tpu_torch.env.detect_host_identity)
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
    # "0"/"off"/"false" keeps the host exchange; shuffle_impl picks the
    # device exchange: "ring" (K9) or "xla" (two ppermute lane moves)
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
        """Validate the fields a consumer reads before it starts (every
        field is ported: a bad mode or exchange route raises here)."""
        RunMode(self.mode)
        if self.shuffle_impl not in ("ring", "xla"):
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
    the Trainer builds; the pipeline schedule's through
    :meth:`pipeline_kwargs` into ``llama.next_token_loss_pp``."""

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
        """kwargs for a pipeline schedule (``pp_chunks`` 0 = the
        schedule's default), shaped for ``**`` splatting into
        ``llama.next_token_loss_pp`` / ``pipeline_apply``."""
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
        """Validate the knobs a consumer reads (what the Trainer checks):
        every field is ported, and :meth:`load` validated them."""


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
