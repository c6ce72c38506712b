"""The port's knob registry against the JAX package's.

- Every entry of ``ddl_tpu.envspec.REGISTRY`` is mapped in
  ``ddl_tpu_torch.envspec.KNOB_MAP`` (twin, ``"todo"`` or ``"n/a: …"``),
  and nothing else is.
- A twin keeps its reference's type, default and config field (``output``'s default is the port's name for the same container:
  ``"device"`` for ``"jax"``).
- C3: the same raw strings read the same through both registries — bool
  knobs, the fused gate and the device-shuffle gate.
- The distributed-optimizer twins (``DDL_TORCH_TRAIN_OPTIMIZER_SHARDING``,
  ``_GRAD_COMM``, ``_GRAD_COMM_BLOCK``, ``_STOCHASTIC_ROUNDING``) load as
  the reference's and reach ``optimizer_kwargs``.
"""

import dataclasses

import pytest

from ddl_tpu import envspec as jenv
from ddl_tpu import shuffle as jshuffle
from ddl_tpu.parallel import ici as jici
from ddl_tpu.types import RunMode as JaxRunMode
from ddl_tpu.types import Topology as JaxTopology
from ddl_tpu_torch import envspec as tenv
from ddl_tpu_torch import shuffle as tshuffle
from ddl_tpu_torch.parallel import ici as tici
from ddl_tpu_torch.types import RunMode, Topology

#: The port's name for a reference default where the two differ on
#: purpose (the container the trainer's device output lands in).
RENAMED_DEFAULTS = {"DDL_TPU_OUTPUT": ("jax", "device")}

RAW_STRINGS = ["no", "NO", "off", "OFF", "0", "false", "False", "", "yes",
               "2", "1", "true", "on"]


def _twins():
    return {ref: port for ref, port in tenv.KNOB_MAP.items()
            if not (port == "todo" or port.startswith("n/a: "))}


def _unmapped(ref_registry, knob_map):
    return sorted(set(ref_registry) - set(knob_map))


def test_every_reference_knob_is_mapped():
    assert _unmapped(jenv.REGISTRY, tenv.KNOB_MAP) == []
    assert sorted(set(tenv.KNOB_MAP) - set(jenv.REGISTRY)) == []
    for ref, port in tenv.KNOB_MAP.items():
        assert (port == "todo" or port.startswith("n/a: ")
                or port in tenv.REGISTRY), (ref, port)
    # Knobs removed from the port carry a reason; the new twins exist.
    for name in ("DDL_TPU_DISTRIBUTE", "DDL_TPU_ICI_INGEST", "DDL_TPU_ONCHIP"):
        assert tenv.KNOB_MAP[name].startswith("n/a: ")
    for name in ("DDL_TPU_UNSAFE_PY_RING", "DDL_TPU_SHUFFLE_IMPL",
                 "DDL_TPU_CKPT_ASYNC", "DDL_TPU_PREEMPT_NOTICE",
                 "DDL_TPU_PREEMPT_DEADLINE_S", "DDL_TPU_FAULT_PLAN",
                 "DDL_TPU_CACHE_RETRIES", "DDL_TPU_CACHE_BACKOFF_S",
                 "DDL_TPU_TFRECORD_CRC", "DDL_TPU_TRACE", "DDL_TPU_FLIGHT",
                 "DDL_TPU_FLIGHT_DIR", "DDL_TPU_OBS_SHIP_EVERY"):
        assert tenv.KNOB_MAP[name] in tenv.REGISTRY
    # The supervisor knobs are ported, and so are the serve and tune
    # layers' ten: no knob is left to do.
    for name in ("DDL_TPU_SUPERVISOR_LEASE_S", "DDL_TPU_SUPERVISOR_STANDBYS"):
        assert tenv.KNOB_MAP[name] == name.replace("DDL_TPU_", "DDL_TORCH_")
    todo = sorted(ref for ref, port in tenv.KNOB_MAP.items()
                  if port == "todo")
    assert todo == []
    fabric_tune = [ref for ref in tenv.KNOB_MAP
                   if ref.startswith(("DDL_TPU_FABRIC_", "DDL_TPU_TUNE_"))]
    assert len(fabric_tune) == 10
    for ref in fabric_tune:
        assert tenv.KNOB_MAP[ref] == ref.replace("DDL_TPU_", "DDL_TORCH_")
    # The shard cache and the readers leave no knob to do.
    for ref, port in tenv.KNOB_MAP.items():
        if ref.startswith(("DDL_TPU_CACHE", "DDL_TPU_TFRECORD")):
            assert port == ref.replace("DDL_TPU_", "DDL_TORCH_", 1), ref


def test_an_unmapped_knob_fails_the_pairing():
    extra = dict(jenv.REGISTRY)
    extra["DDL_TPU_NEW_KNOB"] = jenv.Knob("DDL_TPU_NEW_KNOB", "int", 1, "x")
    assert _unmapped(extra, tenv.KNOB_MAP) == ["DDL_TPU_NEW_KNOB"]


def _pair_mismatches(ref_registry, port_registry):
    out = []
    for ref, port in _twins().items():
        a, b = ref_registry[ref], port_registry[port]
        want = RENAMED_DEFAULTS.get(ref, (a.default, a.default))
        if a.default != want[0]:
            out.append((ref, "reference default moved", a.default))
        for field in ("type", "config_field", "train_field"):
            if getattr(a, field) != getattr(b, field):
                out.append((ref, field, getattr(a, field), getattr(b, field)))
        if b.default != want[1]:
            out.append((ref, "default", a.default, b.default))
        if port.replace("DDL_TORCH_", "DDL_TPU_", 1) != ref:
            out.append((ref, "name", port))
    return out


def test_twins_keep_the_reference_types_and_defaults():
    assert _pair_mismatches(jenv.REGISTRY, tenv.REGISTRY) == []


def test_a_changed_default_fails_the_pairing():
    moved = dict(tenv.REGISTRY)
    moved["DDL_TORCH_MAX_REPLAYS"] = dataclasses.replace(
        moved["DDL_TORCH_MAX_REPLAYS"], default=3)
    assert _pair_mismatches(jenv.REGISTRY, moved) == [
        ("DDL_TPU_MAX_REPLAYS", "default", 2, 3)]


def test_config_families_derive_from_the_dataclasses():
    from ddl_tpu_torch.config import LoaderConfig, TrainConfig

    for cls in (LoaderConfig, TrainConfig):
        for f in dataclasses.fields(cls):
            knob = tenv.REGISTRY[cls._ENV_PREFIX + f.name.upper()]
            assert knob.type == tenv._annot_type(f.type)


def test_unknown_knob_raises():
    with pytest.raises(tenv.UnknownKnobError):
        tenv.raw("DDL_TORCH_NOT_A_KNOB")
    with pytest.raises(KeyError):
        tenv.get("DDL_TORCH_NOT_A_KNOB")


@pytest.mark.parametrize("value", RAW_STRINGS)
def test_bool_knobs_read_raw_strings_as_the_reference(monkeypatch, value):
    """C3: ``no`` was FALSE in the port and TRUE in the reference."""
    bools = [(r, p) for r, p in _twins().items()
             if jenv.REGISTRY[r].type == "bool" and r != "DDL_TPU_FUSED"]
    assert len(bools) >= 8
    for ref, port in bools:
        monkeypatch.setenv(ref, value)
        monkeypatch.setenv(port, value)
        assert tenv.flag(port) == jenv.flag(ref), (ref, value)
        assert tenv.get(port) == jenv.get(ref), (ref, value)


@pytest.mark.parametrize("value", RAW_STRINGS + [None])
def test_fused_gate_reads_raw_strings_as_the_reference(monkeypatch, value):
    for name in ("DDL_TPU_FUSED", "DDL_TORCH_FUSED"):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert tici.fused_enabled() == jici.fused_enabled()


class _Fabric:
    """Any non-None fabric: the gate is decided before it is used."""


@pytest.mark.parametrize("value", RAW_STRINGS + [None])
def test_device_shuffle_gate_reads_raw_strings_as_the_reference(
        monkeypatch, value):
    for name in ("DDL_TPU_DEVICE_SHUFFLE", "DDL_TORCH_DEVICE_SHUFFLE"):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    ref = jshuffle.DeviceExchangeShuffler(
        JaxTopology(mode=JaxRunMode.THREAD, n_instances=2, instance_idx=0,
                    n_producers=1), 0, 4, fabric=_Fabric())
    port = tshuffle.DeviceExchangeShuffler(
        Topology(mode=RunMode.THREAD, n_instances=2, instance_idx=0,
                 n_producers=1), 0, 4, fabric=_Fabric())
    assert port.device_exchange_active == ref.device_exchange_active
    assert port.device_exchange_active == (
        (value or "auto").lower() not in ("0", "off", "false"))


@pytest.mark.parametrize("field,raw,want", [
    ("OPTIMIZER_SHARDING", "zero1", "zero1"),
    ("GRAD_COMM", "int8", "int8"),
    ("GRAD_COMM_BLOCK", "64", 64),
    ("STOCHASTIC_ROUNDING", "1", True),
])
def test_optimizer_twins_load_as_the_reference(monkeypatch, field, raw, want):
    """The four ``TRAIN_*`` distributed-optimizer twins: the same raw
    string loads the same ``TrainConfig`` field in both packages, and the
    port's reaches ``optimizer_kwargs`` (what the step factories take)."""
    from ddl_tpu.config import TrainConfig as JaxTrainConfig
    from ddl_tpu_torch.config import TrainConfig

    assert tenv.KNOB_MAP["DDL_TPU_TRAIN_" + field] == "DDL_TORCH_TRAIN_" + field
    monkeypatch.setenv("DDL_TPU_TRAIN_" + field, raw)
    monkeypatch.setenv("DDL_TORCH_TRAIN_" + field, raw)
    name = field.lower()
    ref = getattr(JaxTrainConfig.load(), name)
    port = TrainConfig.load()
    assert getattr(port, name) == ref == want
    assert port.optimizer_kwargs()[name] == want
