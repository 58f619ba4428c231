"""Analysis runner: load files once, run every (selected) checker.

Skips generated protobuf modules (*_pb2.py) and anything that does not
parse as the running interpreter's Python. Findings come back sorted by
(path, line, rule) so output is stable across runs.
"""

from __future__ import annotations

from pathlib import Path

from .checkers import ALL_CHECKERS
from .core import Checker, Finding, ProjectChecker, SourceFile

RULES: dict[str, type] = {cls().rule: cls for cls in ALL_CHECKERS}

_SKIP_SUFFIXES = ("_pb2.py",)


def iter_sources(paths: list[Path]) -> list[SourceFile]:
    files: list[SourceFile] = []
    for p in paths:
        p = Path(p)
        root = p if p.is_dir() else p.parent
        targets = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for py in targets:
            if any(py.name.endswith(s) for s in _SKIP_SUFFIXES):
                continue
            if "__pycache__" in py.parts:
                continue
            try:
                files.append(SourceFile.load(py, root))
            except (SyntaxError, UnicodeDecodeError):
                continue
    return files


def analyze_paths(paths: list[Path | str],
                  rules: list[str] | None = None) -> list[Finding]:
    """Run the selected checkers (default: all) over every .py under
    `paths`; suppressions already applied."""
    return analyze_sources(iter_sources([Path(p) for p in paths]), rules)


def analyze_sources(files: list[SourceFile],
                    rules: list[str] | None = None) -> list[Finding]:
    """analyze_paths over files already loaded (the CLI counts them)."""
    selected = list(RULES) if rules is None else list(rules)
    unknown = [r for r in selected if r not in RULES]
    if unknown:
        raise ValueError(
            f"unknown rule(s) {unknown}; known: {sorted(RULES)}")
    findings: list[Finding] = []
    checkers: list[Checker] = [RULES[r]() for r in selected]
    for sf in files:
        for c in checkers:
            if isinstance(c, ProjectChecker):
                c.collect(sf)
            else:
                findings.extend(c.run(sf))
    for c in checkers:
        if isinstance(c, ProjectChecker):
            findings.extend(c.finalize_run())
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
