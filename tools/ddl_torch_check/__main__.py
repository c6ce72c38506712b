"""CLI: ``python -m tools.ddl_torch_check {lint,verify} [paths ...]``.

Exit codes: 0 clean, 1 findings, 2 usage error (a path that does not
exist).  Findings print as the reference tools print them.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from tools.ddl_lint.findings import render_report
from tools.ddl_torch_check.runner import lint, verify


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tools.ddl_torch_check",
        description="ddl-lint and ddl-verify over the ddl_tpu_torch port",
    )
    parser.add_argument("command", choices=("lint", "verify"))
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories (default: the ddl_tpu_torch package)",
    )
    args = parser.parse_args(argv)
    run, tool = ((lint, "ddl-lint") if args.command == "lint"
                 else (verify, "ddl-verify"))
    try:
        findings = run(args.paths)
    except (OSError, ValueError) as e:
        print(f"{tool}: {e}", file=sys.stderr)
        return 2
    print(render_report(findings, tool=tool))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
