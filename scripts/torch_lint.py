#!/usr/bin/env python
"""torchlint CLI — run the port's invariant linter
(``repro_torch.analysis.lint``, the twin of ``scripts/jaxlint.py``).

    python scripts/torch_lint.py src/repro_torch examples/torch_*.py \\
        scripts/torch_*.py chip_smoke.py
    python scripts/torch_lint.py --baseline src/repro_torch > torchlint-baseline.json

Exit status is 1 when any non-suppressed finding exists (0 with
``--baseline``, which always writes the full JSON report, suppressed
findings included).

Pure stdlib: the linter module is loaded from its file, not through the
``repro_torch`` package, so the CLI runs straight from a checkout without
torch installed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

_LINT = (Path(__file__).resolve().parent.parent / "src" / "repro_torch"
         / "analysis" / "lint.py")


def _load_lint():
    spec = importlib.util.spec_from_file_location("torchlint", _LINT)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses resolve the module by name
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    lint = _load_lint()
    parser = argparse.ArgumentParser(
        prog="torchlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("paths", nargs="+",
                        help="files or directories to lint")
    parser.add_argument("--baseline", action="store_true",
                        help="emit the full findings report (suppressed "
                             "included) as JSON on stdout and exit 0")
    parser.add_argument("--select", default=None,
                        help="comma-separated rule ids (default: all)")
    parser.add_argument("--exclude", action="append", default=[],
                        help="path component to skip (repeatable)")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="also print pragma-suppressed findings")
    args = parser.parse_args(argv)

    selected = (set(r.strip().upper() for r in args.select.split(","))
                if args.select else set(lint.RULES) | {"TL000"})
    findings = [f for f in lint.lint_paths(args.paths, exclude=args.exclude)
                if f.rule in selected]

    if args.baseline:
        report = {
            "rules": lint.RULES,
            "findings": [
                {"rule": f.rule, "path": f.path, "line": f.line,
                 "col": f.col, "message": f.message,
                 "suppressed": f.suppressed}
                for f in findings
            ],
            "counts": {
                "active": sum(not f.suppressed for f in findings),
                "suppressed": sum(f.suppressed for f in findings),
            },
        }
        json.dump(report, sys.stdout, indent=2)
        sys.stdout.write("\n")
        return 0

    active = [f for f in findings if not f.suppressed]
    shown = findings if args.show_suppressed else active
    for f in shown:
        print(f.format())
    n_sup = len(findings) - len(active)
    summary = f"torchlint: {len(active)} finding(s)"
    if n_sup:
        summary += f", {n_sup} suppressed"
    print(summary, file=sys.stderr)
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
