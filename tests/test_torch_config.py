"""The port's layered configs against the JAX package's.

The same JSON file, the same env values (``DDL_TPU_*`` for the reference,
``DDL_TORCH_*`` for the port) and the same kwargs load equal field
values (``output``: the port's ``"device"`` is the reference's
``"jax"``); unknown JSON keys are refused with the same message;
``TrainConfig`` validation errors match; ``_coerce`` matches; and a
non-default value of a field whose module is not ported raises
``NotImplementedError`` naming its roadmap item.
"""

import dataclasses
import json
import os

import pytest

from ddl_tpu import config as jconfig
from ddl_tpu_torch import config as tconfig
from ddl_tpu_torch.models import llama as tllama
from ddl_tpu_torch.parallel.train import adamw
from ddl_tpu_torch.trainer import Trainer

OUTPUT = {"jax": "device"}


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    if "output" in d:
        d["output"] = OUTPUT.get(d["output"], d["output"])
    return d


def test_field_names_and_defaults_match():
    for jcls, tcls in ((jconfig.LoaderConfig, tconfig.LoaderConfig),
                       (jconfig.TrainConfig, tconfig.TrainConfig)):
        assert [f.name for f in dataclasses.fields(tcls)] == [
            f.name for f in dataclasses.fields(jcls)]
        assert _fields(tcls()) == _fields(jcls())
        assert [str(f.type) for f in dataclasses.fields(tcls)] == [
            str(f.type) for f in dataclasses.fields(jcls)]


LOADER_JSON = {"batch_size": 16, "n_epochs": 3, "mode": "process",
               "checkpoint_dir": "/ckpt", "window_stream": True}
LOADER_ENV = {"N_PRODUCERS": "4", "NSLOTS": "3", "RING_TIMEOUT_S": "12.5",
              "WINDOW_STREAM": "no", "CHECKPOINT_EVERY_EPOCHS": "2",
              "CACHE_CODEC": "zlib", "BATCH_SIZE": "24"}
LOADER_KW = {"n_epochs": 5, "prefetch_depth": 3}
TRAIN_JSON = {"remat": "full", "accum_steps": 2}
TRAIN_ENV = {"SCHEDULE": "1f1b", "STOCHASTIC_ROUNDING": "YES",
             "GRAD_COMM_BLOCK": "64", "ACCUM_STEPS": "4"}
TRAIN_KW = {"remat": "selective"}


@pytest.mark.parametrize("which", ["loader", "train"])
def test_layers_load_equal_values(tmp_path, monkeypatch, which):
    js, env, kw, jcls, tcls, sub = {
        "loader": (LOADER_JSON, LOADER_ENV, LOADER_KW, jconfig.LoaderConfig,
                   tconfig.LoaderConfig, ""),
        "train": (TRAIN_JSON, TRAIN_ENV, TRAIN_KW, jconfig.TrainConfig,
                  tconfig.TrainConfig, "TRAIN_"),
    }[which]
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(js))
    # Both env layers start empty: another test in this process may have
    # exported a knob (the reference's cache adoption exports
    # DDL_TPU_CACHE_SPILL_DIR).
    for f in dataclasses.fields(jcls):
        for prefix in ("DDL_TPU_", "DDL_TORCH_"):
            monkeypatch.delenv(f"{prefix}{sub}{f.name.upper()}",
                               raising=False)
    for name, value in env.items():
        monkeypatch.setenv(f"DDL_TPU_{sub}{name}", value)
        monkeypatch.setenv(f"DDL_TORCH_{sub}{name}", value)
    want = jcls.load(str(path), **kw)
    got = tcls.load(str(path), **kw)
    assert _fields(got) == _fields(want)
    # Each layer moved something: JSON < env < kwargs.
    if which == "loader":
        assert (got.mode, got.batch_size, got.n_epochs) == ("process", 24, 5)
        assert got.window_stream is False  # the config layer's bool rule
    else:
        assert (got.remat, got.accum_steps, got.stochastic_rounding) == (
            "selective", 4, True)


def test_save_then_load_round_trips(tmp_path):
    cfg = tconfig.LoaderConfig(batch_size=7, checkpoint_dir="/x")
    cfg.save(str(tmp_path / "c.json"))
    assert tconfig.LoaderConfig.load(str(tmp_path / "c.json")) == cfg
    tc = tconfig.TrainConfig(remat="dots", accum_steps=3)
    tc.save(str(tmp_path / "t.json"))
    assert tconfig.TrainConfig.load(str(tmp_path / "t.json")) == tc


@pytest.mark.parametrize("which", ["loader", "train"])
def test_unknown_json_keys_are_refused(tmp_path, which):
    jcls, tcls = {
        "loader": (jconfig.LoaderConfig, tconfig.LoaderConfig),
        "train": (jconfig.TrainConfig, tconfig.TrainConfig),
    }[which]
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"batch_size": 1, "bogus": 2, "zz": 3}))
    with pytest.raises(ValueError) as jerr:
        jcls.load(str(path))
    with pytest.raises(ValueError) as terr:
        tcls.load(str(path))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kw", [
    {"remat": "sometimes"}, {"schedule": "zigzag"},
    {"optimizer_sharding": "zero3"}, {"grad_comm": "fp8"},
])
def test_train_validation_errors_match(kw):
    with pytest.raises(ValueError) as jerr:
        jconfig.TrainConfig.load(**kw)
    with pytest.raises(ValueError) as terr:
        tconfig.TrainConfig.load(**kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("raw,annot", [
    ("7", "int"), ("-3", "Optional[int]"), ("2.5", "float"),
    ("1", "bool"), ("true", "bool"), ("YES", "bool"), ("no", "bool"),
    ("0", "bool"), ("on", "bool"), ("", "bool"), ("abc", "str"),
    ("", "Optional[str]"),
])
def test_coerce_matches(raw, annot):
    assert tconfig._coerce(raw, annot) == jconfig._coerce(raw, annot)


def test_model_config_applies_remat():
    cfg = tconfig.TrainConfig(remat="full").model_config(
        tllama.LlamaConfig(n_layers=1))
    assert cfg.remat == "full"


@pytest.mark.parametrize("field,value,item", [
    ("host_id", 1, "A5b"), ("n_hosts", 2, "A5b"), ("mode", "multihost", "A5b"),
    ("shuffle_impl", "xla", "A5b"),
])
def test_unported_loader_fields_raise(field, value, item, monkeypatch):
    """The fields A5b ported (``item``) load and reach their consumer:
    host identity the topology ``distributed_dataloader`` builds,
    ``mode="multihost"`` the topology (one instance without a process
    group, as ``jax.process_count()`` without ``jax.distributed``), and
    ``shuffle_impl="xla"`` the exchange fabric."""
    from ddl_tpu_torch import env as tenv_mod
    from ddl_tpu_torch.shuffle import DeviceExchangeFabric
    from ddl_tpu_torch.types import RunMode

    for var in ("HOST_ID", "N_HOSTS", "PROCS_PER_HOST", "SHUFFLE_IMPL"):
        monkeypatch.setenv("DDL_TORCH_" + var, "")
        monkeypatch.delenv("DDL_TORCH_" + var)
    cfg = tconfig.LoaderConfig(**{field: value})
    cfg.check_ported()
    if field in ("host_id", "n_hosts"):
        cfg = tconfig.LoaderConfig(n_producers=1, **{field: value})

        @tenv_mod.distributed_dataloader(config=cfg, pin_memory=False)
        def main(env):
            return env.topology

        topo = main()
        assert getattr(topo, field) == value
        assert os.environ["DDL_TORCH_" + field.upper()] == str(value)
    elif field == "mode":
        topo = tenv_mod.detect_topology(1, cfg.mode)
        assert topo.mode is RunMode.MULTIHOST
        assert (topo.n_instances, topo.instance_idx) == (1, 0)
    else:
        tenv_mod.export_shuffle_knobs(cfg)
        assert DeviceExchangeFabric(devices=["cpu"] * 2).impl == "xla"
        tenv_mod.export_shuffle_knobs(tconfig.LoaderConfig())
        assert DeviceExchangeFabric(devices=["cpu"] * 2).impl == "ring"
    with pytest.raises(ValueError):
        tconfig.LoaderConfig(shuffle_impl="pallas").check_ported()
    tconfig.LoaderConfig(wire_codec="none").check_ported()  # "none" = off


@pytest.mark.parametrize("field,value,var", [
    ("cache", True, "DDL_TORCH_CACHE"),
    ("cache_spill_dir", "/spill", None),
    ("cache_codec", "zlib", None),
    ("cache_ram_mb", 8, None),
    ("cache_warm", False, None),
])
def test_cache_fields_pass_through(field, value, var, monkeypatch):
    """The shard-cache fields are ported: ``check_ported`` takes them and
    ``distributed_dataloader(config=...)`` exports them, gated on
    ``cache`` as in the reference (a cache-off config exports nothing)."""
    from ddl_tpu_torch import env as tenv_mod

    for k in ("CACHE", "CACHE_SPILL_DIR", "CACHE_CODEC", "CACHE_RAM_MB",
              "CACHE_WARM", "CACHE_SPILL_MB"):
        # Recorded, so the export's writes are undone after the test.
        monkeypatch.setenv("DDL_TORCH_" + k, "")
        monkeypatch.delenv("DDL_TORCH_" + k)
    cfg = tconfig.LoaderConfig(**{field: value})
    cfg.check_ported()
    tenv_mod.export_cache_knobs(cfg)
    if var is None:
        assert not any(k.startswith("DDL_TORCH_CACHE") for k in os.environ)
        on = tconfig.LoaderConfig(cache=True, **{field: value})
        tenv_mod.export_cache_knobs(on)
        name = "DDL_TORCH_" + field.upper()
        want = {True: "1", False: "0"}.get(value, str(value))
        assert os.environ[name] == want
    else:
        assert os.environ[var] == "1"


@pytest.mark.parametrize("field,value", [
    ("wire_dtype", "int8"), ("wire_codec", "zlib"), ("wire_dtype", "bf16"),
])
def test_wire_fields_pass_through(field, value, monkeypatch):
    """The wire fields are ported: a consumer takes them, and ``fit``
    exports them to the env knobs producers read, as the reference's
    ``distributed_dataloader(config=)`` does; an empty field clears only
    the export."""
    from ddl_tpu_torch import env as tenv_mod

    var = "DDL_TORCH_" + field.upper()
    monkeypatch.delenv(var, raising=False)
    cfg = tconfig.LoaderConfig(**{field: value})
    cfg.check_ported()
    tenv_mod.export_wire_knobs(cfg)
    assert os.environ[var] == value
    tenv_mod.export_wire_knobs(tconfig.LoaderConfig())
    assert var not in os.environ


@pytest.mark.parametrize("field,value", [
    ("schedule", "1f1b"), ("pp_chunks", 2), ("n_microbatches", 4),
    ("optimizer_sharding", "zero1"), ("grad_comm", "int8"),
    ("grad_comm_block", 64), ("stochastic_rounding", True),
])
def test_unported_train_fields_raise(field, value):
    """Every train field is ported: the pipeline fields reach
    ``pipeline_kwargs()`` (the reference's dict) and a Trainer takes
    them; the distributed-optimizer fields ``optimizer_kwargs``, and a
    Trainer over a mesh takes them."""
    tc = tconfig.TrainConfig(**{field: value})
    if field in ("schedule", "pp_chunks", "n_microbatches"):
        Trainer(lambda p, b: 0, adamw(1e-3), {}, device="cpu",
                train_config=tc)
        assert tc.pipeline_kwargs() == jconfig.TrainConfig(
            **{field: value}).pipeline_kwargs()
        assert getattr(tc, field) == value
        return
    tc.check_ported()
    assert tc.optimizer_kwargs()[field] == value
    from ddl_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"dp": 2}, ["cpu"] * 2)
    trainer = Trainer(lambda p, b: 0, adamw(1e-3), {}, device="cpu",
                      train_config=tc, mesh=mesh, param_specs={})
    assert trainer._mesh_kwargs()[field] == value
    assert tconfig.TrainConfig().optimizer_kwargs()["grad_comm"] == "fp32"
