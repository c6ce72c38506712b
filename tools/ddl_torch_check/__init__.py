"""ddl-torch-check: the reference static gates over ``ddl_tpu_torch``.

The JAX package is held by ddl-lint (``tools/ddl_lint``) and ddl-verify
(``tools/ddl_verify``) under the ``[tool.ddl_lint]`` / ``[tool.ddl_verify]``
tables of ``pyproject.toml``.  This package runs the same tools over the
port, with a config built in Python that names the port's functions and
modules (``config.py``), the port's variant of VP003 (``envknobs.py``)
and two checks of its own for CUDA host syncs (``checkers.py``):

- TDL001  CUDA host sync inside a kernel wrapper or autograd Function
- TDL020  CUDA host sync inside a fused compute/ingest step function

Usage, from the repo root::

    python -m tools.ddl_torch_check lint [paths ...]
    python -m tools.ddl_torch_check verify [paths ...]

The default path is ``ddl_tpu_torch/``; each command exits 1 on any
finding.  In-process: ``runner.lint(paths)`` / ``runner.verify(paths)``
return the findings.  docs/LINT_TORCH.md documents TDL001 and TDL020.
"""

from tools.ddl_torch_check.checkers import TORCH_CODES, TORCH_REGISTRY
from tools.ddl_torch_check.config import (
    JAX_ONLY,
    PORT_CODES,
    port_lint_config,
    port_verify_config,
)
from tools.ddl_torch_check.runner import lint, torch_checks, verify

__all__ = [
    "JAX_ONLY",
    "PORT_CODES",
    "TORCH_CODES",
    "TORCH_REGISTRY",
    "lint",
    "port_lint_config",
    "port_verify_config",
    "torch_checks",
    "verify",
]
