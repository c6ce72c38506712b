"""VP003 over the port: the env-knob contract under ``DDL_TORCH_``.

The reference pass (``tools/ddl_verify/passes/envknobs.py``) reads its
prefix from the module constant ``PREFIX = "DDL_TPU_"``.  The variant
here runs the same method bodies against a copy of that module's globals
in which ``PREFIX`` is the port's, so the reference module is never
patched (a patch would leak into the reference gate when both run in one
process).  It also takes the port's spelling of the spawn-boundary
mirrors, ``export_<group>_knobs`` (the reference's ``_export_...``).
"""

from __future__ import annotations

import ast
import types
from typing import Dict, Set, Tuple

from tools.ddl_verify.passes import envknobs
from tools.ddl_verify.passes.envknobs import EnvKnobContract
from tools.ddl_verify.project import ModuleInfo

PREFIX = "DDL_TORCH_"

_GLOBALS = dict(vars(envknobs), PREFIX=PREFIX)


def _rebound(fn):
    """``fn`` with the reference module's globals but the port's prefix."""
    return types.FunctionType(fn.__code__, _GLOBALS, fn.__name__,
                              fn.__defaults__, fn.__closure__)


class TorchEnvKnobContract(EnvKnobContract):
    """VP003 with the ``DDL_TORCH_`` prefix and the port's mirrors."""

    _all_ddl_literals = _rebound(EnvKnobContract._all_ddl_literals)
    _scan_module = _rebound(EnvKnobContract._scan_module)
    _scan_call = _rebound(EnvKnobContract._scan_call)

    def _collect_exports(
        self, mod: ModuleInfo,
        out: Dict[str, Tuple[str, int, Set[str]]],
    ) -> None:
        # Keyed as the reference's run() looks the mirror up.
        for node in mod.tree.body:
            name = getattr(node, "name", "")
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and name.lstrip("_").startswith("export_")
                    and name.endswith("_knobs")):
                names = {
                    n.value for n in ast.walk(node)
                    if isinstance(n, ast.Constant)
                    and isinstance(n.value, str)
                    and n.value.startswith(PREFIX)
                }
                out["_" + name.lstrip("_")] = (mod.path, node.lineno, names)
