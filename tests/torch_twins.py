"""Run one suite of cases against both packages and compare what they saw.

A *case module* (``tests/torch_*_cases.py``) is written once, against a
package root it reads from its own ``ROOT`` global: ``"ddl_tpu"`` (the
JAX package, the reference) or ``"ddl_tpu_torch"`` (the port).
:func:`load` executes it once per root, so each package gets its own
module object with its own classes.  A case is a ``test_*`` function or
a ``test_*`` method of a ``Test*`` class (parametrize marks expanded);
it asserts what the reference suite asserts and may return what it
observed (grant orders, exported ledgers, decisions, served bytes), which
:func:`run_twin` requires to be equal across the two packages.

This module imports neither package itself.
"""

import importlib.util
import inspect
import itertools
import json
import pathlib

import numpy as np

ROOTS = ("ddl_tpu", "ddl_tpu_torch")


def load(path, root):
    """Execute the case module at ``path`` with ``ROOT = root``."""
    path = pathlib.Path(path)
    name = f"{path.stem}__{root}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    mod.ROOT = root
    spec.loader.exec_module(mod)
    return mod


def _expand(fn):
    """The parameter sets of ``fn``'s parametrize marks (their product)."""
    marks = [m for m in getattr(fn, "pytestmark", ())
             if m.name == "parametrize"]
    axes = []
    for m in marks:
        names = [n.strip() for n in m.args[0].split(",")] \
            if isinstance(m.args[0], str) else list(m.args[0])
        sets = []
        for v in m.args[1]:
            v = v.values if hasattr(v, "values") else v
            sets.append(dict(zip(names, v if len(names) > 1 else (v,))))
        axes.append(sets)
    out = []
    for combo in itertools.product(*axes):
        kw = {}
        for d in combo:
            kw.update(d)
        out.append(kw)
    return out


def collect(mod):
    """``[(case id, class name or None, function name, params)]`` in
    source order."""
    cases = []
    for name, obj in vars(mod).items():
        if name.startswith("Test") and inspect.isclass(obj):
            for meth, fn in vars(obj).items():
                if meth.startswith("test_") and callable(fn):
                    for kw in _expand(fn):
                        cases.append((name, meth, kw))
        elif name.startswith("test_") and inspect.isfunction(obj):
            for kw in _expand(obj):
                cases.append((None, name, kw))
    out = []
    for cls, fn, kw in cases:
        cid = f"{cls}::{fn}" if cls else fn
        if kw:
            cid += "[" + "-".join(str(v) for v in kw.values()) + "]"
        out.append((cid, cls, fn, kw))
    return out


def _call(mod, cls, fn, kw, fixtures):
    target = getattr(getattr(mod, cls)(), fn) if cls else getattr(mod, fn)
    params = inspect.signature(target).parameters
    args = dict(kw)
    for p in params:
        if p not in args and p in fixtures:
            args[p] = fixtures[p]
    return target(**args)


def canon(value):
    """A package-neutral, comparable reading of a case's result."""
    if isinstance(value, np.ndarray):
        return ("ndarray", value.dtype.str, value.shape, value.tobytes())
    if isinstance(value, (list, tuple)):
        return [canon(v) for v in value]
    if isinstance(value, dict):
        return {str(k): canon(v) for k, v in sorted(value.items(),
                                                    key=lambda kv: str(kv[0]))}
    if isinstance(value, float) and value != value:
        return "nan"
    if isinstance(value, np.generic):
        return value.item()
    if hasattr(value, "as_dict"):
        return canon(value.as_dict())
    return value


def run_twin(mods, case, tmp_path, monkeypatch):
    """Run ``case`` against each package's module; the results must be
    equal.  Each package gets its own ``tmp_path`` subdirectory."""
    _cid, cls, fn, kw = case
    results = []
    for root, mod in zip(ROOTS, mods):
        d = tmp_path / root
        d.mkdir()
        results.append(canon(_call(mod, cls, fn, kw, {
            "tmp_path": d, "monkeypatch": monkeypatch})))
    assert results[1] == results[0], (
        json.dumps(results, default=repr)[:2000])
    return results[1]


def env_name(root, suffix):
    """The package's env knob ``<prefix>_<suffix>``."""
    return ("DDL_TPU_" if root == "ddl_tpu" else "DDL_TORCH_") + suffix


