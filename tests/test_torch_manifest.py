"""The port's module manifest (``ddl_tpu_torch/_manifest.py``) against
both trees: every module of the JAX package is a key, every mapped port
path exists, every ``n/a`` gives its reason, and the modules ported so
far are not ``todo``."""

import pathlib

import pytest

from ddl_tpu_torch._manifest import MANIFEST

REPO = pathlib.Path(__file__).resolve().parent.parent
REF = REPO / "ddl_tpu"


def test_every_reference_module_is_a_key():
    files = {p.relative_to(REF).as_posix() for p in REF.rglob("*.py")
             if "__pycache__" not in p.parts}
    files.add("transport/csrc/shm_ring.cpp")
    assert len(files) == 78
    assert set(MANIFEST) == files


def test_values_are_a_port_path_todo_or_a_reason():
    for key, value in MANIFEST.items():
        if value == "todo":
            continue
        if value.startswith("n/a"):
            assert value.startswith("n/a: ") and len(value) > len("n/a: ") + 10, key
            continue
        assert value.startswith("ddl_tpu_torch/"), (key, value)
        assert (REPO / value).is_file(), (key, value)


def test_ported_paths_mirror_the_reference_layout():
    """A module's port sits at the same path under the port's package."""
    for key, value in MANIFEST.items():
        if value.startswith("ddl_tpu_torch/"):
            assert value == f"ddl_tpu_torch/{key}", (key, value)


@pytest.mark.parametrize("module", [
    "env.py", "staging.py", "ingest.py", "dataloader.py", "datapusher.py",
    "envspec.py", "observability.py", "trainer.py", "config.py", "types.py",
    "transport/connection.py", "transport/shm_ring.py",
    "transport/csrc/shm_ring.cpp",
    "watchdog.py", "transport/envelope.py", "shuffle.py",
    "checkpoint.py", "concurrency.py", "resilience/__init__.py",
    "resilience/ckpt.py", "resilience/guard.py", "models/llama.py",
    "faults.py", "wire.py", "readers.py", "cache/__init__.py",
    "cache/backends.py", "cache/store.py", "cache/warmer.py",
    "parallel/collectives.py", "parallel/optimizer.py",
    "parallel/ring_attention.py", "parallel/train.py", "parallel/mesh.py",
    "parallel/pipeline.py", "obs/__init__.py", "obs/__main__.py",
    "obs/aggregate.py", "obs/recorder.py", "obs/spans.py", "profiling.py",
    "models/moe.py", "models/vit.py", "models/pointnet.py",
])
def test_this_slices_modules_are_ported(module):
    assert MANIFEST[module] == f"ddl_tpu_torch/{module}"
