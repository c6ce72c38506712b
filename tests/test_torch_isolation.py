"""ddl_tpu_torch stands alone: it imports neither JAX nor the JAX package,
calls no library attention, and its entry points refuse to drift onto
the CPU when CUDA is absent.

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
for attr in ddl_tpu_torch.__all__:
    getattr(ddl_tpu_torch, attr)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "ddl_tpu"
             or m.startswith("ddl_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
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
    assert "ddl_tpu_torch.ops.flash_attention" in report["modules"]
    assert "ddl_tpu_torch.trainer" in report["modules"]


def test_sources_name_no_jax_and_no_library_attention():
    """Static guard over every port source: no JAX or ddl_tpu import, no
    scaled_dot_product_attention / cuDNN / packaged-kernel call."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|ddl_tpu)(\.|\s|$)"
        r"|scaled_dot_product_attention|cudnn|flash_attn|xformers",
        re.MULTILINE,
    )
    sources = sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu"))
    assert len(sources) > 20
    hits = [
        f"{p.relative_to(REPO)}: {m.group(0).strip()}"
        for p in sources
        for m in pattern.finditer(p.read_text())
    ]
    assert hits == []


@pytest.mark.parametrize("entry", ["trainer", "ingestor", "init_params"])
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
    }[entry]
    assert make(device="cpu") is not None
    if torch.cuda.is_available():
        assert make() is not None
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
