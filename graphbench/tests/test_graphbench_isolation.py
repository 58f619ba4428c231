"""Nothing under graphbench/ imports jax, jaxlib, flax or the JAX package,
by an AST scan and by what a run loads; names are compared by their whole
top-level part (dgraph_tpu_torch begins with dgraph_tpu); and the reference
imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from graphbench import run, spec

FORBIDDEN = set(run.FORBIDDEN)


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


def test_ast_scan():
    files = sorted(spec.HERE.rglob("*.py"))
    assert len(files) > 10
    bad = {str(f): _imports(f) & FORBIDDEN for f in files
           if _imports(f) & FORBIDDEN}
    assert not bad


def test_reference_imports_nothing_of_the_program():
    for f in sorted((spec.HERE / "reference").rglob("*.py")):
        assert not _imports(f) & (FORBIDDEN | {"dgraph_tpu_torch"}), f


def test_top_level_names_are_compared_whole():
    assert run.forbidden_modules(["dgraph_tpu_torch.api.server",
                                  "dgraph_tpu_torch", "jaxtyping"]) == []
    assert run.forbidden_modules(["dgraph_tpu.query", "jax.numpy",
                                  "flax"]) == ["dgraph_tpu", "flax", "jax"]


SCRIPT = """
import json, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
before = set(sys.modules)
from conftest import tiny_cell
from graphbench import run
out = run.run_cell(tiny_cell("g500s20.khop3-analytic"), 3, 0.5, False,
                   "cpu", t_start=time.perf_counter())
assert out["correct"], out
print(json.dumps(sorted(set(sys.modules) - before)))
"""


def test_a_run_loads_none_of_them():
    code = SCRIPT.format(root=str(spec.ROOT), tests=str(Path(__file__)
                                                         .parent))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=spec.ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert "dgraph_tpu_torch.api.server" in loaded
    assert not {m.split(".")[0] for m in loaded} & FORBIDDEN
