"""CLI for the port's contract linter: ``python -m repro_torch.analysis
--contracts src/repro_torch [--rules R001,...]``. Exit code 1 when any
error-severity diagnostic fires. Copy of ``repro/analysis/__main__.py``;
standard library only."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .contracts import ALL_RULES, lint_contracts


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static repo-contract linter (R0xx rules).",
    )
    parser.add_argument(
        "--contracts",
        metavar="PACKAGE_DIR",
        help="package directory to lint (e.g. src/repro_torch)",
    )
    parser.add_argument(
        "--rules",
        default=None,
        help=f"comma-separated rule subset (default: {','.join(ALL_RULES)})",
    )
    args = parser.parse_args(argv)
    if not args.contracts:
        parser.error("nothing to do: pass --contracts <package dir>")
    root = Path(args.contracts)
    if not root.is_dir():
        parser.error(f"not a directory: {root}")
    rules = (
        tuple(r.strip() for r in args.rules.split(",") if r.strip())
        if args.rules
        else None
    )
    diags = lint_contracts(root, rules=rules)
    for d in diags:
        print(d.render())
    errors = sum(1 for d in diags if d.severity == "error")
    print(
        f"contracts: {errors} error(s), {len(diags) - errors} warning(s) "
        f"over {root}"
    )
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
