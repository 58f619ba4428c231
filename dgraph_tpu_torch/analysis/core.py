"""Checker framework core: parsed-file model, findings, suppressions.

Parsing happens ONCE per file (ast.parse + a line scan for suppression
comments); every checker walks the same tree. Checkers come in two
shapes: per-file (`check(sf)` yields findings) and project-wide
(`collect(sf)` per file, then `finalize()` once — for invariants that
only hold across the whole tree, like the metric-registration and
fault-point cross-checks).

No imports of torch/numpy/grpc here or in any checker: the analyzer must
start fast (`python -m dgraph_tpu_torch.analysis` budget is 10s including
the interpreter) and run anywhere, including boxes without the accelerator
stack.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

# `# dgraph: allow(rule-a, rule-b) optional free-text rationale`
_ALLOW_RE = re.compile(r"#\s*dgraph:\s*allow\(([a-z0-9_\-, ]+)\)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}


class SourceFile:
    """One parsed module + its suppression map.

    `rel` is the path relative to the analysis root (scoped rules match
    on its parts: a file under query/ or parallel/ is request-path
    code). `allow` maps line number -> set of suppressed rule names; a
    finding on line L is suppressed by a comment on L or on L-1."""

    def __init__(self, path: Path, rel: str, text: str) -> None:
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text)
        self.allow: dict[int, set[str]] = {}
        for i, ln in enumerate(self.lines, start=1):
            if "dgraph:" not in ln:          # cheap pre-filter
                continue
            m = _ALLOW_RE.search(ln)
            if m:
                rules = {r.strip() for r in m.group(1).split(",")
                         if r.strip()}
                self.allow.setdefault(i, set()).update(rules)

    @classmethod
    def load(cls, path: Path, root: Path) -> "SourceFile":
        try:
            rel = str(path.relative_to(root))
        except ValueError:
            rel = str(path)
        return cls(path, rel, path.read_text())

    def suppressed(self, rule: str, line: int) -> bool:
        """A finding on `line` is suppressed by an allow() on the line
        itself or anywhere in the contiguous comment block directly
        above it (multi-line rationales are encouraged)."""
        def hit(ln: int) -> bool:
            rules = self.allow.get(ln)
            return bool(rules and (rule in rules or "all" in rules))

        if hit(line):
            return True
        ln = line - 1
        while ln >= 1 and self.lines[ln - 1].lstrip().startswith("#"):
            if hit(ln):
                return True
            ln -= 1
        return False

    def in_dirs(self, names: tuple[str, ...]) -> bool:
        """True when a directory segment (or the filename stem) matches —
        how scoped rules decide a file is request-path / seam code.
        Besides the analysis-root-relative segments, the ENCLOSING
        PACKAGE chain counts (directories with __init__.py walking up
        from the file): a single-file run roots at the file's parent and
        rel alone would drop the very segments the scoped rules key on.
        Only package dirs qualify — matching the raw absolute path would
        make the verdict depend on where the repo happens to be cloned
        (a checkout under /home/ci/api/… must not put the whole tree in
        seam scope)."""
        parts = set(Path(self.rel).parts[:-1])
        parts.add(Path(self.rel).stem)
        try:
            d = self.path.resolve().parent
            while (d / "__init__.py").exists() and d != d.parent:
                parts.add(d.name)
                d = d.parent
        except OSError:
            pass
        return any(p in names for p in parts)

    def src(self, node: ast.AST) -> str:
        """Source text of a node ('' when unavailable). Hand-rolled
        against the cached line list: ast.get_source_segment re-splits
        the whole file per call, which alone blew the analyzer's 10s
        budget across ~100 files."""
        try:
            lo = node.lineno - 1
            hi = node.end_lineno - 1
            if lo == hi:
                return self.lines[lo][node.col_offset:node.end_col_offset]
            parts = [self.lines[lo][node.col_offset:]]
            parts.extend(self.lines[lo + 1:hi])
            parts.append(self.lines[hi][:node.end_col_offset])
            return "\n".join(parts)
        except (AttributeError, IndexError, TypeError):
            return ""


@dataclass
class Checker:
    """Base: per-file checker. Subclasses set `rule`/`doc` and override
    `check`."""

    rule: str = ""
    doc: str = ""

    def check(self, sf: SourceFile) -> list[Finding]:
        raise NotImplementedError

    def run(self, sf: SourceFile) -> list[Finding]:
        return [f for f in self.check(sf)
                if not sf.suppressed(f.rule, f.line)]


@dataclass
class ProjectChecker(Checker):
    """Cross-file checker: `collect` per file, `finalize` once. The
    collected state lives on the instance — the runner constructs a
    fresh instance per analysis run."""

    _files: list[SourceFile] = field(default_factory=list)

    def collect(self, sf: SourceFile) -> None:
        self._files.append(sf)

    def finalize(self) -> list[Finding]:
        raise NotImplementedError

    def finalize_run(self) -> list[Finding]:
        by_path = {sf.rel: sf for sf in self._files}
        out = []
        for f in self.finalize():
            sf = by_path.get(f.path)
            if sf is not None and sf.suppressed(f.rule, f.line):
                continue
            out.append(f)
        return out


# -- shared AST helpers ------------------------------------------------------

def call_name(node: ast.Call) -> str:
    """Dotted name of the called object ('' for computed callees):
    `time.sleep` -> "time.sleep", `Thread` -> "Thread"."""
    return dotted(node.func)


def dotted(node: ast.AST) -> str:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif parts:
        parts.append("")                 # computed base: "<x>.attr"
    return ".".join(reversed(parts))


def const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def kw(node: ast.Call, name: str) -> ast.AST | None:
    for k in node.keywords:
        if k.arg == name:
            return k.value
    return None


def enclosing_functions(tree: ast.Module) -> dict[int, ast.AST]:
    """Map every node id to its nearest enclosing FunctionDef (or the
    module). Built once per file by checkers that need scope context."""
    owner: dict[int, ast.AST] = {}

    def walk(node: ast.AST, fn: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            nfn = child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
            owner[id(child)] = nfn
            walk(child, nfn)

    owner[id(tree)] = tree
    walk(tree, tree)
    return owner
