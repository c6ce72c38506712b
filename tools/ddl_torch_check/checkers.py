"""CUDA host syncs: TDL020 in the fused step, TDL001 at a kernel boundary.

The reference's DDL020 names the host waits of a JAX step
(``block_until_ready``, ``device_get``, ``.item()``, ``float(f(...))``)
and DDL001 those of a ``jax.jit`` body.  The port waits on the card in
other spellings: a stream or event ``synchronize()``, a copy to the host
(``.cpu()``, ``.numpy()``, ``.tolist()``, ``.to("cpu")``), and ops whose
output shape depends on the data (``nonzero``, ``masked_select``,
``unique``), which must read the card before they can allocate.  The two
checks here name those spellings where the port must not wait.

They are ``Checker`` subclasses but stay out of the reference registry
(``tools.ddl_lint.checkers.REGISTRY``): :data:`TORCH_REGISTRY` holds
them, and ``tools.ddl_torch_check.runner`` runs them beside the
reference checks.  A finding is silenced like any ddl-lint finding, with
``# ddl-lint: disable=TDL020 - <reason>`` on its line.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple, Type

from tools.ddl_lint.checkers.base import Checker
from tools.ddl_lint.context import dotted_name

#: Method calls that wait for the card: an explicit wait, or a copy of
#: device memory into host memory the caller reads at once.
_SYNC_METHODS = {"synchronize", "item", "tolist", "cpu", "numpy"}

#: Ops whose output shape depends on the data: the host reads the card
#: before it can size the result.
_DATA_SHAPED = {"nonzero", "masked_select", "unique", "unique_consecutive"}

#: ``torch.*`` calls that return a Python bool computed on the card.
_HOST_BOOL = {"equal", "allclose"}

#: Reductions that are a sync when their result decides a branch.
_TRUTH = {"any", "all"}

#: Scalar casts: of a computed tensor they read it back to the host.
_CASTS = {"float", "int", "bool"}

#: Calls whose result is already a host value: a cast of one reads
#: nothing from the card (``int(bool(causal))``, ``int(t.numel())``).
_HOST_VALUED = {
    "int", "float", "bool", "len", "round", "str", "abs",
    "numel", "nelement", "element_size", "dim", "data_ptr", "size",
    "stride", "get_device",
}

#: Module names whose calls are host numpy, never a tensor method.
_HOST_MODULES = {"np", "numpy"}


def classify(node: ast.Call, ctx) -> Optional[str]:
    """The host-sync spelling ``node`` is, or None."""
    method = isinstance(node.func, ast.Attribute)
    # A chain through a call (``torch.cuda.current_stream(d).synchronize``)
    # has no dotted name: name it by its source.
    dotted = dotted_name(node.func) or ast.unparse(node.func)
    seg = node.func.attr if method else dotted
    base = dotted.split(".", 1)[0] if "." in dotted else ""
    if method and base in _HOST_MODULES:
        return None
    if method and seg in _SYNC_METHODS:
        return f"{dotted}()"
    if method and seg == "to" and _to_host(node):
        return f"{dotted}(cpu)"
    if seg in _DATA_SHAPED and method:
        return f"{dotted}(...) (output shape depends on the data)"
    if dotted == "torch.where" and len(node.args) == 1 and not node.keywords:
        return "torch.where(cond) (output shape depends on the data)"
    if dotted in {f"torch.{n}" for n in _HOST_BOOL}:
        return f"{dotted}(...) (a host bool)"
    if seg in _TRUTH and method and _decides_branch(node, ctx):
        return f"{dotted}() as a branch condition"
    if dotted in _CASTS and node.args and _reads_device(node.args[0]):
        return f"{dotted}(...) scalar read-back"
    return None


def _to_host(node: ast.Call) -> bool:
    """``.to("cpu")`` / ``.to(device="cpu")`` / ``.to(torch.device("cpu"))``
    without ``non_blocking=True`` (which lands in page-locked memory and
    returns before the copy ends)."""
    for kw in node.keywords:
        if (kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant)
                and kw.value.value is True):
            return False
    targets = list(node.args[:1]) + [
        kw.value for kw in node.keywords if kw.arg == "device"]
    return any(_is_cpu(t) for t in targets)


def _is_cpu(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value.split(":", 1)[0] == "cpu"
    if isinstance(expr, ast.Call) and (dotted_name(expr.func) or "").endswith(
            "device") and expr.args:
        return _is_cpu(expr.args[0])
    return False


def _reads_device(arg: ast.AST) -> bool:
    """A cast's argument that may be a tensor computed on the card: a
    call or a subscript.  A plain name or attribute (``float(loss)``,
    DDL020's carve-out) is not flagged, nor is a host-valued call or a
    ``.shape`` index."""
    if isinstance(arg, ast.Call):
        seg = (dotted_name(arg.func) or "").rsplit(".", 1)[-1]
        return seg not in _HOST_VALUED
    if isinstance(arg, ast.Subscript):
        return not (isinstance(arg.value, ast.Attribute)
                    and arg.value.attr in ("shape", "stride"))
    return False


def _decides_branch(node: ast.AST, ctx) -> bool:
    """Is ``node`` inside the test of an ``if`` / ``while`` / conditional
    expression / ``assert``?"""
    child = node
    for anc in ctx.ancestors(node):
        if isinstance(anc, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            return child is anc.test
        if isinstance(anc, (ast.stmt, ast.Lambda, ast.comprehension)):
            return False
        child = anc
    return False


def _qualname(fn: ast.AST, ctx) -> str:
    for anc in ctx.ancestors(fn):
        if isinstance(anc, ast.ClassDef):
            return f"{anc.name}.{fn.name}"  # type: ignore[attr-defined]
    return fn.name  # type: ignore[attr-defined]


def _calls(fn: ast.AST) -> Iterator[ast.Call]:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            yield node


class FusedStepCudaSync(Checker):
    """TDL020: no CUDA host sync in a fused compute/ingest step function.

    Functions named in the port config's ``fused_step_functions`` (bare
    names or ``Class.method``; nested defs included, as DDL020 has it)
    run between dispatching window N's steps and taking window N+1.
    Inside them, flag ``torch.cuda.synchronize()`` and any
    ``<x>.synchronize()`` (a stream, an event,
    ``torch.cuda.current_stream(d)``); ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``.to("cpu")`` / ``.to(device="cpu")``;
    ``float`` / ``int`` / ``bool`` of a call or subscript (not of a plain
    name or attribute); ``nonzero`` / ``masked_select`` / ``unique`` /
    one-argument ``torch.where``; ``torch.equal`` / ``torch.allclose``;
    and ``.any()`` / ``.all()`` deciding a branch.  Non-blocking probes
    (``Event.query()``, ``value_ready``) stay clean.

    The trainer's deferred loss read is the one wait the fused loop
    makes: it copies each window's mean loss into page-locked memory
    behind the window's steps, and reads the PREVIOUS window's copy after
    ``<event>.synchronize()`` on that window's event, an annotated line
    (``# ddl-lint: disable=TDL020 - <reason>``).  A ``float`` of the
    device loss would queue behind the steps just enqueued and wait for
    the stream's tail; the event waits for steps one window old.
    """

    code = "TDL020"
    summary = "CUDA host sync inside a fused compute/ingest step function"

    def run(self) -> List:
        hot = set(getattr(self.config, "fused_step_functions", []))
        for fn in ast.walk(self.ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name not in hot and _qualname(fn, self.ctx) not in hot:
                continue
            for call in _calls(fn):
                hit = classify(call, self.ctx)
                if hit:
                    self.report(
                        call,
                        f"{hit} in fused step function {fn.name}(); the "
                        "host must not wait on the card between "
                        "dispatching window N's steps and taking window "
                        "N+1 — defer it out of the loop or pragma-disable "
                        "with a reason",
                    )
        return self.findings


class KernelBoundaryCudaSync(Checker):
    """TDL001: no CUDA host sync inside a kernel boundary.

    A kernel boundary is ``forward`` / ``backward`` of a
    ``torch.autograd.Function`` subclass, and every function a module
    lists in its ``KERNELS`` tuple (the kernel wrappers that count their
    launches), together with the module-level functions of the same
    module they call by name, transitively: a wrapper launches on the
    current stream and returns, and a wait in its helpers is its wait.
    The spellings are TDL020's.  A wrapper that raises on a bad return
    code of the launch (``_raise_on``) stays clean: the code is a host
    int.
    """

    code = "TDL001"
    summary = "CUDA host sync inside a kernel wrapper or autograd Function"

    def run(self) -> List:
        tree = self.ctx.tree
        module_fns: Dict[str, ast.AST] = {
            n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        roots: List[Tuple[ast.AST, str]] = []
        for node in tree.body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "KERNELS"
                    for t in node.targets) and isinstance(
                    node.value, (ast.Tuple, ast.List)):
                for e in node.value.elts:
                    if isinstance(e, ast.Name) and e.id in module_fns:
                        roots.append((module_fns[e.id], f"kernel wrapper {e.id}"))
        for cls in ast.walk(tree):
            if isinstance(cls, ast.ClassDef) and _is_autograd_function(cls):
                for m in cls.body:
                    if isinstance(m, ast.FunctionDef) and m.name in (
                            "forward", "backward", "setup_context"):
                        roots.append((m, f"autograd {cls.name}.{m.name}"))
        seen: Set[ast.AST] = set()
        for root, why in roots:
            stack = [root]
            while stack:
                fn = stack.pop()
                if fn in seen:
                    continue
                seen.add(fn)
                for call in _calls(fn):
                    hit = classify(call, self.ctx)
                    if hit:
                        where = ("" if fn is root else
                                 f" (in {fn.name}(), called from it)")  # type: ignore[attr-defined]
                        self.report(
                            call,
                            f"{hit} inside {why}{where}; a kernel "
                            "boundary launches on the current stream and "
                            "returns — a host wait here stalls every "
                            "caller's dispatch",
                        )
                    if isinstance(call.func, ast.Name):
                        callee = module_fns.get(call.func.id)
                        if callee is not None:
                            stack.append(callee)
        return self.findings


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    for base in cls.bases:
        name = dotted_name(base) or ""
        if name.endswith("autograd.Function") or name == "Function":
            return True
    return False


#: code -> checker class, for the port's checks only.
TORCH_REGISTRY: Dict[str, Type[Checker]] = {
    c.code: c for c in (KernelBoundaryCudaSync, FusedStepCudaSync)
}

#: The port's own check codes, in order.
TORCH_CODES = tuple(sorted(TORCH_REGISTRY))
