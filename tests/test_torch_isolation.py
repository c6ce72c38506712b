"""ddl_tpu_torch stands alone: it imports neither JAX nor the JAX package
(nor Pillow, which only a WebDataset producer imports when it starts),
calls no library attention, and its entry points refuse to drift onto
the CPU when CUDA is absent.  ``chip_smoke.py`` and the port's examples
(every ``examples/*_torch.py``) are held to the same rules, and
``_manifest.EXAMPLES`` names a twin for every example of the JAX
package.

The import check runs in a subprocess: this test process already
imported JAX (conftest pins it to the CPU).
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "ddl_tpu_torch"

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import ddl_tpu_torch
names = ["ddl_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(ddl_tpu_torch.__path__, "ddl_tpu_torch.")
]
for n in names:
    importlib.import_module(n)
import chip_smoke  # the chip script imports only the port
import glob, runpy
twins = sorted(glob.glob(sys.argv[1] + "/examples/*_torch.py"))
sys.path.insert(0, sys.argv[1] + "/examples")  # as a script run sees it
for path in twins:  # and its examples
    runpy.run_path(path)
for attr in ddl_tpu_torch.__all__:
    getattr(ddl_tpu_torch, attr)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "ddl_tpu"
             or m.startswith("ddl_tpu.") or m == "PIL" or m.startswith("PIL."))
print(json.dumps({"modules": names, "bad": bad,
                  "twins": [p.rsplit("/", 1)[1] for p in twins]}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(REPO)], capture_output=True,
        text=True, timeout=120, env=env, cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert report["twins"] == sorted(p.name for p in _twins())
    assert len(report["twins"]) == 6
    assert "ddl_tpu_torch.ops.flash_attention" in report["modules"]
    assert "ddl_tpu_torch.trainer" in report["modules"]
    for mod in ("checkpoint", "resilience.ckpt", "resilience.guard",
                "config", "envspec", "concurrency", "wire", "faults",
                "readers", "cache", "cache.backends", "cache.store",
                "cache.warmer", "cluster", "cluster.pool",
                "cluster.membership", "cluster.topology",
                "cluster.placement", "cluster.elastic",
                "cluster.supervision", "serve", "serve.tenancy",
                "serve.jobs", "serve.autoscaler", "serve.fabric", "tune",
                "tune.knobs", "tune.calibrate", "tune.controller"):
        assert f"ddl_tpu_torch.{mod}" in report["modules"]


def _twins():
    return sorted((REPO / "examples").glob("*_torch.py"))


def test_every_reference_example_has_its_twin():
    """``_manifest.EXAMPLES`` maps every runnable example of the JAX
    package (the platform pin ``_common.py`` aside) to a twin that
    exists, and names every twin; no twin reaches for the reference's
    ``_common`` pin."""
    from ddl_tpu_torch._manifest import EXAMPLES

    ref = {f"examples/{p.name}" for p in (REPO / "examples").glob("*.py")
           if not p.name.endswith("_torch.py") and p.name != "_common.py"}
    assert set(EXAMPLES) == ref
    assert len(ref) == 6
    for src, twin in EXAMPLES.items():
        assert twin == src[:-3] + "_torch.py", (src, twin)
        assert (REPO / twin).is_file(), twin
    assert sorted(EXAMPLES.values()) == [
        p.relative_to(REPO).as_posix() for p in _twins()]
    pin = re.compile(r"^\s*(import|from)\s+_common\b", re.MULTILINE)
    assert [p.name for p in _twins() if pin.search(p.read_text())] == []


@pytest.mark.parametrize("module", ["wire", "faults"])
def test_wire_and_faults_import_alone(module):
    """The wire and fault modules, imported first and alone, pull in
    neither JAX nor the JAX package (nor any ``ml_dtypes``: the port's
    bf16 is bit arithmetic)."""
    probe = (
        "import json, sys; sys.path.insert(0, sys.argv[1]); "
        f"import ddl_tpu_torch.{module}; "
        "print(json.dumps(sorted(m for m in sys.modules if m in "
        "('jax', 'ddl_tpu', 'ml_dtypes') or m.startswith(('jax.', "
        "'ddl_tpu.')))))"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", probe, str(REPO)],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_name_no_jax_and_no_library_attention():
    """Static guard over every port source: no JAX or ddl_tpu import, no
    scaled_dot_product_attention / cuDNN / packaged-kernel call."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|ddl_tpu)(\.|\s|$)"
        r"|scaled_dot_product_attention|cudnn|flash_attn|xformers",
        re.MULTILINE,
    )
    sources = (sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu"))
               + _twins())
    assert len(sources) > 20
    hits = [
        f"{p.relative_to(REPO)}: {m.group(0).strip()}"
        for p in sources
        for m in pattern.finditer(p.read_text())
    ]
    assert hits == []


@pytest.mark.parametrize("entry", ["trainer", "ingestor", "init_params",
                                   "init_cache"])
def test_entry_points_need_cuda_unless_cpu_is_asked(entry):
    from ddl_tpu_torch.ingest import DeviceIngestor
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.trainer import Trainer

    make = {
        "trainer": lambda **kw: Trainer(lambda p, b: 0, adamw(1e-3), {}, **kw),
        "ingestor": lambda **kw: DeviceIngestor(**kw),
        "init_params": lambda **kw: llama.init_params(
            llama.LlamaConfig(n_layers=1), **kw),
        "init_cache": lambda **kw: llama.init_cache(
            llama.LlamaConfig(n_layers=1), 1, 4, **kw),
    }[entry]
    assert make(device="cpu") is not None
    if torch.cuda.is_available():
        assert make() is not None
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
