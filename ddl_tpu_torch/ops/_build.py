"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds.  Builds run at first use,
from the sources in the checkout, into ``ddl_tpu_torch/_build/`` (listed
in ``.gitignore``), keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds.
:func:`publish` (lock, temporary output, atomic rename) builds the
shared-memory ring of ``transport/shm_ring.py`` with ``g++`` too.
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

from ddl_tpu_torch.concurrency import named_lock

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}  # ddl-lint: disable=DDL013 - one entry per csrc source
_lock = named_lock("ops.build")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on ``PATH``."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to for the current source and
    headers."""
    text = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its current build exists; the
    compiler's ``-Xptxas -v`` report lands beside the library as
    ``<lib>.log``."""
    out = library_path(name)
    return publish(out, name, [nvcc_path(), *NVCC_FLAGS, "-o", "{out}",
                               str(CSRC / f"{name}.cu")])


def publish(out: Path, name: str, cmd: List[str]) -> Path:
    """Build ``out`` with ``cmd`` (``"{out}"`` in it names the output)
    unless it exists.  Safe against concurrent builds, in threads or in
    processes: a file lock per ``name``, a per-process temporary output,
    and an atomic rename that publishes only a complete library.  The
    compiler's output lands beside the library as ``<lib>.log``."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [str(tmp) if c == "{out}" else c for c in cmd]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (out.parent / f"{out.name}.log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{cmd[0]} failed for {name}:\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
