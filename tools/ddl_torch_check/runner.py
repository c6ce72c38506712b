"""Run the reference tools over the port, with the port's config.

``lint`` calls ``tools.ddl_lint.run_paths`` with
:func:`~tools.ddl_torch_check.config.port_lint_config` and runs the
port's own checks (TDL001, TDL020) over the same files in a loop of its
own; ``verify`` calls ``tools.ddl_verify.runner.run_paths`` with
:func:`~tools.ddl_torch_check.config.port_verify_config` for VP001,
VP002 and VP004 and runs the port's VP003 beside it.

Paths are resolved against the repo root, not the working directory:
the reference runners report a path as they were given it when the
config comes in-process, and ``per_path_ignores`` matches repo-relative
prefixes.  So the files go in absolute, and every finding comes back
repo-relative with the port's per-path ignores applied here.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

from tools.ddl_lint.config import LintConfig
from tools.ddl_lint.context import ModuleContext
from tools.ddl_lint.findings import Finding
from tools.ddl_lint.runner import collect_project_enums, discover_files
from tools.ddl_lint.runner import run_paths as lint_run_paths
from tools.ddl_lint.suppress import collect_suppressions, is_suppressed
from tools.ddl_torch_check.checkers import TORCH_REGISTRY
from tools.ddl_torch_check.config import (
    PORT,
    port_lint_config,
    port_verify_config,
)
from tools.ddl_torch_check.envknobs import TorchEnvKnobContract
from tools.ddl_verify.config import VerifyConfig
from tools.ddl_verify.project import ModuleInfo, build_index
from tools.ddl_verify.runner import run_paths as verify_run_paths

#: The repo root: this package lives at ``<root>/tools/ddl_torch_check``.
ROOT = Path(__file__).resolve().parents[2]


def _absolute(paths: Sequence[str]) -> List[str]:
    return [str(Path(p).resolve()) for p in (paths or [str(ROOT / PORT)])]


def _relative(path: str) -> str:
    try:
        return Path(path).resolve().relative_to(ROOT).as_posix()
    except ValueError:
        return path


def _settle(findings: Iterable[Finding], config) -> List[Finding]:
    """Repo-relative paths, then the config's per-path ignores."""
    out = []
    for f in findings:
        f = dataclasses.replace(f, path=_relative(f.path))
        if f.code not in config.ignored_for(f.path):
            out.append(f)
    return sorted(out)


def torch_checks(paths: Sequence[str], config: LintConfig) -> List[Finding]:
    """The port's own checks (:data:`TORCH_REGISTRY`) over ``paths``,
    with ddl-lint's inline suppressions."""
    findings: List[Finding] = []
    parsed = []
    for f in discover_files(paths):
        source = f.read_text(encoding="utf-8")
        try:
            parsed.append((f, source, ast.parse(source)))
        except SyntaxError:
            continue  # the reference run reports it as DDL000
    enums = collect_project_enums((f, tree) for f, _, tree in parsed)
    for f, source, tree in parsed:
        ctx = ModuleContext(path=str(f), source=source, tree=tree,
                            project_enums=enums)
        per_line, file_wide = collect_suppressions(source)
        for checker in TORCH_REGISTRY.values():
            for finding in checker(ctx, config).run():
                if not is_suppressed(finding.code, finding.line, per_line,
                                     file_wide):
                    findings.append(finding)
    return findings


def lint(paths: Sequence[str] = (),
         config: Optional[LintConfig] = None) -> List[Finding]:
    """The reference checks the port enables, then TDL001 and TDL020,
    over ``paths`` (default: the port's package)."""
    config = config or port_lint_config()
    files = _absolute(paths)
    findings = lint_run_paths(
        files, config=dataclasses.replace(config, per_path_ignores={}))
    findings += torch_checks(files, config)
    return _settle(findings, config)


def verify(paths: Sequence[str] = (),
           config: Optional[VerifyConfig] = None) -> List[Finding]:
    """VP001, VP002 and VP004 through the reference runner, VP003 as the
    port's variant, over ``paths`` (default: the port's package)."""
    config = config or port_verify_config()
    files = _absolute(paths)
    reference = dataclasses.replace(
        config, disable=[*config.disable, "VP003"], per_path_ignores={})
    findings = verify_run_paths(files, config=reference)
    if "VP003" in config.enabled_passes():
        findings += _vp003(files, config)
    return _settle(findings, config)


def _vp003(files: Sequence[str], config: VerifyConfig) -> List[Finding]:
    modules, suppressions = [], {}
    for f in discover_files(files):
        source = f.read_text(encoding="utf-8")
        try:
            tree = ast.parse(source)
        except SyntaxError:
            continue  # the reference run reports it as VP000
        modules.append(ModuleInfo(path=str(f), source=source, tree=tree))
        suppressions[str(f)] = collect_suppressions(source, tag="ddl-verify:")
    out = []
    for finding in TorchEnvKnobContract(build_index(modules), config).run():
        per_line, file_wide = suppressions.get(finding.path, ({}, set()))
        if not is_suppressed(finding.code, finding.line, per_line, file_wide):
            out.append(finding)
    return out
