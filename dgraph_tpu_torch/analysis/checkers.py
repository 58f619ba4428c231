"""The eight project checkers, one per invariant the serving code keeps.

README.md "Project invariants (port)" is the operator-facing companion.
Heuristics are deliberate: this is a project linter for THIS codebase's
idioms, not a general soundness tool — anything it cannot see
(cross-function lock nesting, dynamically-built metric names) is covered
by the runtime halves (utils/locks.py lockdep, the fresh-node /metrics
audit in tests/test_torch_metric_audit.py, which consumes this module's
collector).

`_PKG_ROOT` is the dgraph_tpu_torch package: the metric and fault-point
cross-checks read the port's own utils/metrics.py and utils/faults.py.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

from .core import (Checker, Finding, ProjectChecker, SourceFile, call_name,
                   const_str, dotted, enclosing_functions, kw)

_PKG_ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# 1. metric-registration (the runtime /metrics audit, static + shared)
# ---------------------------------------------------------------------------

# f-string placeholders used at metric call sites, expanded mechanically;
# a NEW placeholder must be added here or the checker flags the site as
# unexpandable (the invariant stays mechanical, never hand-maintained)
METRIC_PLACEHOLDERS: dict[str, tuple[str, ...]] = {
    "prefix": ("task", "result"),
    "ep": ("query", "mutate", "commit", "abort", "alter"),
}

_METRIC_METHODS = ("counter", "histogram", "keyed")


def _metric_templates(sf: SourceFile):
    """(template, lineno) for every dgraph_* name passed to a metric
    constructor method. f-strings come back as '{placeholder}'
    templates."""
    for node in ast.walk(sf.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _METRIC_METHODS and node.args):
            continue
        arg = node.args[0]
        s = const_str(arg)
        if s is not None:
            if s.startswith("dgraph_"):
                yield s, node.lineno
            continue
        if isinstance(arg, ast.JoinedStr):
            parts = []
            for v in arg.values:
                if isinstance(v, ast.Constant):
                    parts.append(str(v.value))
                elif isinstance(v, ast.FormattedValue):
                    parts.append("{%s}" % (dotted(v.value) or "?"))
            tpl = "".join(parts)
            if tpl.startswith("dgraph_"):
                yield tpl, node.lineno


def expand_metric_template(tpl: str) -> list[str] | None:
    """Expand {placeholder}s via METRIC_PLACEHOLDERS; None when a
    placeholder is unknown (the checker flags that site)."""
    m = re.search(r"\{([^{}]*)\}", tpl)
    if m is None:
        return [tpl]
    key = m.group(1)
    vals = METRIC_PLACEHOLDERS.get(key)
    if vals is None:
        return None
    out: list[str] = []
    for v in vals:
        sub = expand_metric_template(tpl.replace("{%s}" % key, v, 1))
        if sub is None:
            return None
        out.extend(sub)
    return out


def registered_metric_names(metrics_path: Path | None = None) -> set[str]:
    """Every dgraph_* literal inside utils/metrics.Registry.__init__ —
    the statically-extracted pre-registration set."""
    path = metrics_path or (_PKG_ROOT / "utils" / "metrics.py")
    tree = ast.parse(path.read_text())
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "Registry":
            for fn in node.body:
                if isinstance(fn, ast.FunctionDef) and \
                        fn.name == "__init__":
                    for c in ast.walk(fn):
                        s = const_str(c)
                        if s and s.startswith("dgraph_"):
                            out.add(s)
    return out


def collect_metric_names(root: Path) -> set[str]:
    """Every expanded dgraph_* name constructed anywhere under `root` —
    the shared collector the runtime /metrics audit consumes (one
    implementation, two consumers)."""
    names: set[str] = set()
    for py in sorted(Path(root).rglob("*.py")):
        if py.name.endswith("_pb2.py"):
            continue
        try:
            sf = SourceFile.load(py, Path(root))
        except SyntaxError:
            continue
        for tpl, _ in _metric_templates(sf):
            names.update(expand_metric_template(tpl) or ())
    return names


@dataclass
class MetricRegistrationChecker(ProjectChecker):
    rule: str = "metric-registration"
    doc: str = ("every dgraph_* metric name constructed anywhere must be "
                "pre-registered in utils/metrics.Registry.__init__ (a "
                "fresh node's /metrics must expose it at 0)")

    @staticmethod
    def _is_registry_file(sf: SourceFile) -> bool:
        """Exactly utils/metrics.py — a future obs/fleet_metrics.py must
        be checked like any other file, never exempted or (worse) let to
        shadow the real pre-registration set."""
        p = Path(sf.rel)
        return p.name == "metrics.py" and p.parent.name == "utils"

    def finalize(self) -> list[Finding]:
        registered: set[str] | None = None
        for sf in self._files:
            if self._is_registry_file(sf) and any(
                    isinstance(n, ast.ClassDef) and n.name == "Registry"
                    for n in sf.tree.body):
                registered = registered_metric_names(sf.path)
        if registered is None:        # subset/fixture run: canonical set
            registered = registered_metric_names()
        out = []
        for sf in self._files:
            if self._is_registry_file(sf):
                continue              # Registry itself + its docstrings
            for tpl, line in _metric_templates(sf):
                names = expand_metric_template(tpl)
                if names is None:
                    out.append(Finding(
                        self.rule, sf.rel, line,
                        f"metric name {tpl!r} uses a placeholder not in "
                        f"analysis.checkers.METRIC_PLACEHOLDERS — add its "
                        f"expansion so the audit stays mechanical"))
                    continue
                for name in names:
                    if name not in registered:
                        out.append(Finding(
                            self.rule, sf.rel, line,
                            f"metric {name!r} is constructed here but "
                            f"not pre-registered in utils/metrics."
                            f"Registry.__init__ — a fresh node's "
                            f"/metrics would omit it"))
        return out


# ---------------------------------------------------------------------------
# 2. ctxvar-copy (hedged replicas / the batcher's worker threads)
# ---------------------------------------------------------------------------

@dataclass
class CtxvarChecker(Checker):
    rule: str = "ctxvar-copy"
    doc: str = ("ThreadPoolExecutor.submit / Thread(target=) must carry "
                "contextvars (submit(ctx.run, fn, ...)) or annotate the "
                "task as deliberately detached — deadlines, trace spans, "
                "and cost ledgers all ride contextvars")

    def check(self, sf: SourceFile) -> list[Finding]:
        out = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name.split(".")[-1] == "submit" and "." in name:
                if node.args and isinstance(node.args[0], ast.Attribute) \
                        and node.args[0].attr == "run":
                    continue          # pool.submit(ctx.run, fn, ...)
                out.append(Finding(
                    self.rule, sf.rel, node.lineno,
                    "pool.submit() without a contextvars copy — request "
                    "context (deadline/trace/cost ledger) is lost across "
                    "the thread seam; submit(contextvars.copy_context()"
                    ".run, fn, ...) or annotate a detached task"))
            elif name.split(".")[-1] == "Thread":
                tgt = kw(node, "target")
                if tgt is None or (isinstance(tgt, ast.Attribute)
                                   and tgt.attr == "run"):
                    continue
                out.append(Finding(
                    self.rule, sf.rel, node.lineno,
                    "Thread(target=) without a contextvars copy — use "
                    "target=contextvars.copy_context().run or annotate "
                    "a deliberately-detached background thread"))
        return out


# ---------------------------------------------------------------------------
# 3. deadline-wait (the request-lifeline contract at every wait point)
# ---------------------------------------------------------------------------

_DEADLINE_MARKERS = re.compile(
    r"clamp\(|remaining|deadline|expires|budget")
_WAIT_SCOPE = ("query", "parallel", "api", "coord")


def _name_resolves_to_deadline(name: str, assigns: dict[str, list[str]],
                               depth: int = 3,
                               seen: set[str] | None = None) -> bool:
    """One-level-at-a-time dataflow: does `name`'s assignment chain in
    this function reach a deadline-derived expression? `seen` caps the
    walk so mutually-referencing assignments cannot recurse forever."""
    if depth <= 0:
        return False
    seen = seen if seen is not None else set()
    if name in seen:
        return False
    seen.add(name)
    for rhs in assigns.get(name, ()):
        if _DEADLINE_MARKERS.search(rhs):
            return True
        for ref in set(re.findall(r"[A-Za-z_]\w*", rhs)):
            if ref != name and ref in assigns and \
                    _name_resolves_to_deadline(ref, assigns,
                                               depth - 1, seen):
                return True
    return False


@dataclass
class DeadlineWaitChecker(Checker):
    rule: str = "deadline-wait"
    doc: str = ("blocking waits (Condition/Event.wait, Queue.get, "
                "time.sleep, lock acquires) on request paths must consult "
                "the utils/deadline scope — clamp the timeout or check "
                "the budget; a budgeted request must never hang")

    def check(self, sf: SourceFile) -> list[Finding]:
        if not sf.in_dirs(_WAIT_SCOPE):
            return []
        owner = enclosing_functions(sf.tree)
        # per-function Name -> [RHS source] for the dataflow heuristic
        fn_assigns: dict[int, dict[str, list[str]]] = {}
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                fn = owner.get(id(node))
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name) and node.value is not None:
                        fn_assigns.setdefault(id(fn), {}).setdefault(
                            t.id, []).append(sf.src(node.value))
        out = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call) or \
                    not isinstance(node.func, ast.Attribute):
                continue
            attr = node.func.attr
            recv = dotted(node.func.value).lower()
            if attr == "sleep":
                if recv not in ("time", ""):
                    continue
            elif attr in ("wait", "wait_for"):
                if "stop" in recv:     # background-loop stop events
                    continue
            elif attr == "acquire":
                blocking = kw(node, "blocking") or (
                    node.args[0] if node.args else None)
                if isinstance(blocking, ast.Constant) and \
                        blocking.value is False:
                    continue           # non-blocking probe
            elif attr == "get":
                if "queue" not in recv:
                    continue
            else:
                continue
            if self._compliant(sf, node, fn_assigns.get(
                    id(owner.get(id(node))), {})):
                continue
            out.append(Finding(
                self.rule, sf.rel, node.lineno,
                f"blocking {recv or 'call'}.{attr}() on a request path "
                f"without consulting the deadline scope — clamp the "
                f"timeout (utils/deadline.clamp) or bound the loop by "
                f"the remaining budget"))
        return out

    def _compliant(self, sf: SourceFile, node: ast.Call,
                   assigns: dict[str, list[str]]) -> bool:
        exprs = list(node.args) + [k.value for k in node.keywords]
        for e in exprs:
            src = sf.src(e)
            if src and _DEADLINE_MARKERS.search(src):
                return True
            if isinstance(e, ast.Name) and \
                    _name_resolves_to_deadline(e.id, assigns):
                return True
        # context window: a deadline-bounded loop or a pre-checked budget
        # right above the wait (`while ... monotonic() < deadline:` /
        # `if pause >= dl.remaining(): raise`)
        lo = max(node.lineno - 8, 1)
        ctx = "\n".join(sf.lines[lo - 1:node.lineno])
        return bool(_DEADLINE_MARKERS.search(ctx))


# ---------------------------------------------------------------------------
# 4. except-seam (silent swallows at dispatch/wire seams)
# ---------------------------------------------------------------------------

_SEAM_SCOPE = ("api", "parallel", "zero_service")


@dataclass
class ExceptSeamChecker(Checker):
    rule: str = "except-seam"
    doc: str = ("bare `except:`/`except Exception:` handlers that "
                "silently swallow (pass/continue-only bodies) are banned "
                "at dispatch/wire seams — narrow to transport-shaped "
                "types, record the failure, or annotate why dropping it "
                "is correct")

    def check(self, sf: SourceFile) -> list[Finding]:
        if not sf.in_dirs(_SEAM_SCOPE):
            return []
        out = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            t = node.type
            broad = t is None or (isinstance(t, ast.Name)
                                  and t.id in ("Exception", "BaseException"))
            if not broad:
                continue
            if all(isinstance(s, (ast.Pass, ast.Continue)) or
                   (isinstance(s, ast.Expr)
                    and isinstance(s.value, ast.Constant))
                   for s in node.body):
                out.append(Finding(
                    self.rule, sf.rel, node.lineno,
                    "broad except silently swallows at a wire/dispatch "
                    "seam — narrow to transport-shaped types "
                    "(ConnectionError/OSError/grpc.RpcError), count or "
                    "log it, or annotate why dropping is correct"))
        return out


# ---------------------------------------------------------------------------
# 5. rpc-error-taxonomy (typed errors at RPC boundaries)
# ---------------------------------------------------------------------------

@dataclass
class TypedErrorChecker(Checker):
    rule: str = "rpc-error-taxonomy"
    doc: str = ("RPC-boundary failures must raise the typed taxonomy "
                "(utils/errors.Unavailable/FailedPrecondition, "
                "utils/deadline.DeadlineExceeded/ResourceExhausted), "
                "never bare Exception/RuntimeError strings — retry "
                "policy, breakers, and HTTP status mapping match on type")

    def check(self, sf: SourceFile) -> list[Finding]:
        if not sf.in_dirs(_SEAM_SCOPE):
            return []
        out = []
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Raise)
                    and isinstance(node.exc, ast.Call)
                    and isinstance(node.exc.func, ast.Name)
                    and node.exc.func.id in ("Exception", "RuntimeError")):
                continue
            out.append(Finding(
                self.rule, sf.rel, node.lineno,
                f"raise {node.exc.func.id} at an RPC boundary — use the "
                f"typed seam taxonomy (utils/errors.Unavailable / "
                f"FailedPrecondition / deadline.DeadlineExceeded / "
                f"ResourceExhausted) so callers can match on type"))
        return out


# ---------------------------------------------------------------------------
# 6. capture-purity (torch code traced once and replayed)
# ---------------------------------------------------------------------------

# dotted-name suffixes of the calls that trace a callable once: the
# callable given to them (or decorated by them) is captured
_CAPTURE_CALLS = ("torch.compile", "jit.script", "jit.trace",
                  "jit.trace_module", "make_graphed_callables")
# `with torch.cuda.graph(g):` records its body into a CUDA graph
_CAPTURE_BLOCKS = ("cuda.graph",)
_IMPURE_CALLS = re.compile(
    r"^(time\.(time|monotonic|perf_counter|sleep|time_ns)"
    r"|random\.\w+|np\.random\.\w+|numpy\.random\.\w+"
    r"|datetime\.(now|utcnow)|print)$")


def _is_capture(name: str, suffixes: tuple[str, ...]) -> bool:
    return any(name == s or name.endswith("." + s) for s in suffixes)


@dataclass
class CapturePurityChecker(Checker):
    rule: str = "capture-purity"
    doc: str = ("no Python RNG/clock/print inside torch code that is "
                "traced once and replayed — a torch.compile'd or "
                "jit.script/trace'd function, a callable given to "
                "cuda.make_graphed_callables, or a `with torch.cuda."
                "graph(...)` body: it runs at capture time, not per "
                "replay (the JAX rule's donation half has no torch "
                "counterpart: torch has no donate_argnums)")

    def check(self, sf: SourceFile) -> list[Finding]:
        out = []
        for body in self._captured(sf):
            for node in ast.walk(body):
                if isinstance(node, ast.Call) and \
                        _IMPURE_CALLS.match(call_name(node) or ""):
                    out.append(Finding(
                        self.rule, sf.rel, node.lineno,
                        f"impure call {call_name(node)}() inside captured "
                        f"torch code — it runs ONCE at capture time, not "
                        f"per replay; thread values in as tensors "
                        f"instead"))
        return out

    def _captured(self, sf: SourceFile) -> list[ast.AST]:
        """Nodes whose code torch traces once: capture-decorated defs,
        defs/lambdas passed into a capture call (by name, as a method
        attribute, or inside a tuple/list), and the statements of a
        `with torch.cuda.graph(...)` block."""
        by_name: dict[str, list[ast.AST]] = {}
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                by_name.setdefault(node.name, []).append(node)
        out: list[ast.AST] = []
        seen: set[int] = set()

        def add(node: ast.AST) -> None:
            if id(node) not in seen:
                seen.add(id(node))
                out.append(node)

        def add_callable(arg: ast.AST) -> None:
            if isinstance(arg, ast.Lambda):
                add(arg)
            elif isinstance(arg, (ast.Tuple, ast.List)):
                for elt in arg.elts:
                    add_callable(elt)
            elif isinstance(arg, (ast.Name, ast.Attribute)):
                name = arg.id if isinstance(arg, ast.Name) else arg.attr
                for fn in by_name.get(name, ()):
                    add(fn)

        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    d = dec.func if isinstance(dec, ast.Call) else dec
                    if _is_capture(dotted(d), _CAPTURE_CALLS):
                        add(node)
            elif isinstance(node, ast.Call) and \
                    _is_capture(call_name(node), _CAPTURE_CALLS):
                for arg in node.args[:1]:
                    add_callable(arg)
            elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    isinstance(it.context_expr, ast.Call) and _is_capture(
                        call_name(it.context_expr), _CAPTURE_BLOCKS)
                    for it in node.items):
                for stmt in node.body:
                    add(stmt)
        return out


# ---------------------------------------------------------------------------
# 7. fault-points (registry <-> code cross-check)
# ---------------------------------------------------------------------------

@dataclass
class FaultPointChecker(ProjectChecker):
    rule: str = "fault-points"
    doc: str = ("utils/faults.POINTS and faults.fire(...) sites must "
                "agree both ways: every wired point is declared (ops "
                "runbook lists POINTS), every declared point is wired "
                "somewhere (no dead registry entries)")

    def finalize(self) -> list[Finding]:
        declared: dict[str, tuple[str, int]] = {}
        declared_rel = None
        fired: list[tuple[str, str, int]] = []
        for sf in self._files:
            is_faults = Path(sf.rel).name == "faults.py"
            if is_faults:
                for node in sf.tree.body:
                    if isinstance(node, ast.Assign) and any(
                            isinstance(t, ast.Name) and t.id == "POINTS"
                            for t in node.targets):
                        declared_rel = sf.rel
                        for c in ast.walk(node.value):
                            s = const_str(c)
                            if s:
                                declared[s] = (sf.rel, c.lineno)
                continue               # fire() defined here, not wired
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                callee = call_name(node)
                if callee.split(".")[-1] != "fire":
                    continue
                s = const_str(node.args[0])
                if s:
                    fired.append((s, sf.rel, node.lineno))
        if declared_rel is None:       # subset run: canonical declaration
            for name, line in self._canonical_points():
                declared[name] = ("utils/faults.py", line)
        out = []
        for name, rel, line in fired:
            if name not in declared:
                out.append(Finding(
                    self.rule, rel, line,
                    f"fault point {name!r} is fired here but not "
                    f"declared in utils/faults.POINTS — declare it so "
                    f"the ops runbook and chaos schedules can see it"))
        if declared_rel is not None:
            fired_names = {n for n, _, _ in fired}
            for name, (rel, line) in sorted(declared.items()):
                if name not in fired_names:
                    out.append(Finding(
                        self.rule, rel, line,
                        f"fault point {name!r} is declared in POINTS but "
                        f"never fired anywhere — dead registry entry "
                        f"(or the wiring was removed)"))
        return out

    @staticmethod
    def _canonical_points() -> list[tuple[str, int]]:
        path = _PKG_ROOT / "utils" / "faults.py"
        tree = ast.parse(path.read_text())
        out = []
        for node in tree.body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "POINTS"
                    for t in node.targets):
                for c in ast.walk(node.value):
                    s = const_str(c)
                    if s:
                        out.append((s, c.lineno))
        return out


# ---------------------------------------------------------------------------
# 8. lock-order (static sibling of utils/locks.py lockdep)
# ---------------------------------------------------------------------------

_LOCKISH = re.compile(r"lock|_cv$|_mutex")


@dataclass
class LockOrderChecker(ProjectChecker):
    rule: str = "lock-order"
    doc: str = ("`with <lock>` nesting across the tree must form an "
                "acyclic order graph — a static A->B in one function and "
                "B->A in another is a deadlock schedule even if no run "
                "has hit it yet (runtime sibling: utils/locks.py)")

    edges: dict[tuple[str, str], tuple[str, int]] = field(
        default_factory=dict)

    def collect(self, sf: SourceFile) -> None:
        super().collect(sf)
        mod = Path(sf.rel).stem

        def lock_key(expr: ast.AST, cls: str | None) -> str | None:
            if isinstance(expr, ast.Attribute) and \
                    isinstance(expr.value, ast.Name) and \
                    expr.value.id == "self" and \
                    _LOCKISH.search(expr.attr):
                return f"{mod}.{cls or '?'}.{expr.attr}"
            if isinstance(expr, ast.Name) and _LOCKISH.search(expr.id):
                return f"{mod}.{expr.id}"
            return None

        def walk(node: ast.AST, cls: str | None,
                 stack: list[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    walk(child, child.name, [])
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef, ast.Lambda)):
                    # a nested def's body is NOT dynamically inside the
                    # enclosing with-block — fresh stack
                    walk(child, cls, [])
                elif isinstance(child, ast.With):
                    keys = []
                    for item in child.items:
                        k = lock_key(item.context_expr, cls)
                        if k is not None:
                            keys.append(k)
                    held = list(stack)
                    for k in keys:
                        for h in held:
                            if h != k and (h, k) not in self.edges:
                                self.edges[(h, k)] = (sf.rel,
                                                      child.lineno)
                        held.append(k)
                    walk(child, cls, held)
                else:
                    walk(child, cls, stack)

        walk(sf.tree, None, [])

    def finalize(self) -> list[Finding]:
        graph: dict[str, set[str]] = {}
        for a, b in self.edges:
            graph.setdefault(a, set()).add(b)

        def path(src: str, dst: str) -> list[str] | None:
            stack, seen = [(src, [src])], {src}
            while stack:
                n, p = stack.pop()
                if n == dst:
                    return p
                for nx in graph.get(n, ()):
                    if nx not in seen:
                        seen.add(nx)
                        stack.append((nx, p + [nx]))
            return None

        out, reported = [], set()
        for (a, b), (rel, line) in sorted(self.edges.items()):
            back = path(b, a)
            if back is None:
                continue
            cyc = frozenset(back)
            if cyc in reported:
                continue
            reported.add(cyc)
            out.append(Finding(
                self.rule, rel, line,
                f"lock-order cycle: {a} -> {b} here, but "
                f"{' -> '.join(back)} elsewhere — two threads "
                f"interleaving these orders deadlock"))
        return out


# ---------------------------------------------------------------------------

ALL_CHECKERS = (MetricRegistrationChecker, CtxvarChecker,
                DeadlineWaitChecker, ExceptSeamChecker, TypedErrorChecker,
                CapturePurityChecker, FaultPointChecker, LockOrderChecker)
