"""CLI: `python -m dgraph_tpu_torch.analysis [paths] [--rule R] [--format F]`.

Exit status: 0 clean, 1 findings, 2 usage error — so CI can gate on it
(chip_smoke.py's last phase does). `--format=json` emits a machine-
readable finding list; `--list-rules` prints every rule with its doc.
With no paths it scans the dgraph_tpu_torch package it was loaded from.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from .runner import RULES, analyze_sources, iter_sources


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dgraph_tpu_torch.analysis",
        description="dgraph-tpu port project-invariant static analysis")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to analyze (default: the "
                         "installed dgraph_tpu_torch package)")
    ap.add_argument("--rule", action="append", dest="rules",
                    metavar="RULE",
                    help="run only this rule (repeatable)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name in sorted(RULES):
            print(f"{name:24s} {RULES[name]().doc}")
        return 0

    paths = [Path(p) for p in args.paths] or \
        [Path(__file__).resolve().parent.parent]
    for p in paths:
        if not p.exists():
            print(f"error: no such path {p}", file=sys.stderr)
            return 2
    t0 = time.perf_counter()
    files = iter_sources(paths)
    try:
        findings = analyze_sources(files, args.rules)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    dt = time.perf_counter() - t0
    if args.format == "json":
        print(json.dumps({"findings": [f.to_dict() for f in findings],
                          "files": len(files),
                          "elapsed_s": round(dt, 3)}, indent=2))
    else:
        for f in findings:
            print(f.format())
        print(f"{len(findings)} finding(s) in {len(files)} file(s) "
              f"[{', '.join(sorted(args.rules or RULES))}] "
              f"in {dt:.2f}s", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
