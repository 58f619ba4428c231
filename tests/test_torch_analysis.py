"""The port's project-invariant analyzer (dgraph_tpu_torch/analysis).

Mirrors tests/test_analysis.py case for case with the port's analyzer,
the port package and `python -m dgraph_tpu_torch.analysis`: every checker
catches its known-bad fixture, suppressions silence annotated violations,
the port package comes up clean inside the 10 s budget, and the CLI keeps
its contract. Then it holds the port's findings equal to the JAX
analyzer's for the seven shared rules, pins `capture-purity` (the torch
counterpart of `jax-purity`) on its own fixtures and on torch's other
capture sites, and checks that the analyzer loads neither jax, torch nor
the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from dgraph_tpu.analysis import analyze_paths as jax_analyze_paths
from dgraph_tpu_torch.analysis import RULES, analyze_paths
from dgraph_tpu_torch.analysis.checkers import (collect_metric_names,
                                                registered_metric_names)

REPO = Path(__file__).parent.parent
FIXTURES = Path(__file__).parent / "fixtures" / "analysis"
TFIXTURES = Path(__file__).parent / "fixtures" / "analysis_torch"
PKG = REPO / "dgraph_tpu_torch"

SHARED_RULES = ("metric-registration", "ctxvar-copy", "deadline-wait",
                "except-seam", "rpc-error-taxonomy", "fault-points",
                "lock-order")
PORT_RULES = {*SHARED_RULES, "capture-purity"}


def _findings(rule: str, root: Path = FIXTURES):
    return [f for f in analyze_paths([root], [rule]) if f.rule == rule]


# ---------------------------------------------------------------------------
# each checker catches its known-bad fixture
# ---------------------------------------------------------------------------

def test_metric_registration_fixture():
    fs = _findings("metric-registration")
    assert any(f.path == "bad_metric.py" and
               "dgraph_bogus_surprise_total" in f.message for f in fs)
    # unknown f-string placeholder is its own finding
    assert any("placeholder" in f.message for f in fs)


def test_ctxvar_fixture():
    fs = _findings("ctxvar-copy")
    assert {f.line for f in fs if f.path == "bad_ctxvar.py"} == {11, 12}


def test_deadline_wait_fixture():
    fs = [f for f in _findings("deadline-wait")
          if f.path == "parallel/bad_deadline.py"]
    # sleep, cv.wait, lock.acquire, queue.get
    assert len(fs) == 4, fs


def test_except_seam_fixture():
    fs = _findings("except-seam")
    assert [f.path for f in fs] == ["parallel/bad_except.py"]


def test_typed_error_fixture():
    fs = _findings("rpc-error-taxonomy")
    assert [f.path for f in fs] == ["parallel/bad_typed.py"]


def test_capture_purity_fixture():
    fs = [f for f in _findings("capture-purity", TFIXTURES)
          if f.path == "bad_capture.py"]
    by_line = {f.line: f.message for f in fs}
    assert "time.time" in by_line[12]         # @torch.compile body
    assert "random.random" in by_line[16]     # make_graphed_callables fn
    assert "print" in by_line[25]             # with torch.cuda.graph(g):
    assert len(fs) == 3, fs


def test_fault_points_fixture():
    fs = _findings("fault-points")
    assert any("bogus.chunk_ship" in f.message for f in fs)


def test_lock_order_fixture():
    fs = _findings("lock-order")
    assert any(f.path == "bad_lockorder.py" and "cycle" in f.message
               for f in fs)


# ---------------------------------------------------------------------------
# suppression + scoping semantics
# ---------------------------------------------------------------------------

def test_suppressions_silence_annotated_violations():
    for f in analyze_paths([FIXTURES, TFIXTURES]):
        assert f.path not in ("parallel/suppressed_ok.py",
                              "suppressed_capture.py"), f


def test_single_file_run_keeps_scope_segments():
    fs = analyze_paths([FIXTURES / "parallel" / "bad_typed.py"],
                       ["rpc-error-taxonomy"])
    assert len(fs) == 1, fs


def test_scoped_rules_ignore_out_of_scope_files(tmp_path):
    (tmp_path / "tool.py").write_text(
        "import time\n\ndef run():\n    time.sleep(1.0)\n")
    assert analyze_paths([tmp_path], ["deadline-wait"]) == []


def test_unknown_rule_rejected():
    with pytest.raises(ValueError, match="unknown rule"):
        analyze_paths([FIXTURES], ["no-such-rule"])
    # the JAX rule id is not a port rule
    with pytest.raises(ValueError, match="unknown rule"):
        analyze_paths([FIXTURES], ["jax-purity"])


# ---------------------------------------------------------------------------
# the tier-1 gate: the port package itself is clean, fast
# ---------------------------------------------------------------------------

def test_package_is_clean_and_fast():
    t0 = time.perf_counter()
    findings = analyze_paths([PKG])
    dt = time.perf_counter() - t0
    assert findings == [], "analyzer findings in dgraph_tpu_torch/:\n" + \
        "\n".join(f.format() for f in findings)
    assert dt < 10.0, f"analyzer took {dt:.1f}s over the package"


def test_rule_registry_shape():
    assert set(RULES) == PORT_RULES
    for name, cls in RULES.items():
        assert cls().doc, name
    assert "donate_argnums" in RULES["capture-purity"]().doc


# ---------------------------------------------------------------------------
# shared metric collector (one implementation, two consumers)
# ---------------------------------------------------------------------------

def test_metric_collector_sees_the_tree():
    names = collect_metric_names(PKG)
    assert len(names) > 80, names
    assert "dgraph_task_cache_hits_total" in names    # {prefix} expansion
    assert "dgraph_http_query_latency_s" in names     # {ep} expansion
    assert "dgraph_kernel_launches" in names          # port-only series
    reg = registered_metric_names()
    assert names <= reg, sorted(names - reg)
    # the canonical set is the port's own Registry, not the JAX one
    assert "dgraph_kernel_launches" in reg


# ---------------------------------------------------------------------------
# CLI contract
# ---------------------------------------------------------------------------

def _cli(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "dgraph_tpu_torch.analysis", *args],
        capture_output=True, text=True, timeout=120, cwd=cwd,
        env=dict(os.environ, PYTHONPATH=str(REPO)))


def test_cli_findings_exit_nonzero_and_json():
    p = _cli(str(FIXTURES), "--format=json")
    assert p.returncode == 1, p.stderr
    out = json.loads(p.stdout)
    assert out["findings"], out
    rules = {f["rule"] for f in out["findings"]}
    assert "lock-order" in rules and "metric-registration" in rules


def test_cli_rule_filter_and_clean_exit():
    p = _cli(str(FIXTURES / "bad_ctxvar.py"), "--rule", "except-seam")
    assert p.returncode == 0, (p.stdout, p.stderr)
    p = _cli(str(FIXTURES), "--rule", "bogus")
    assert p.returncode == 2
    p = _cli("--list-rules")
    assert p.returncode == 0 and "deadline-wait" in p.stdout


@pytest.mark.slow
def test_cli_package_clean():
    p = _cli("dgraph_tpu_torch")
    assert p.returncode == 0, p.stdout


# ---------------------------------------------------------------------------
# beyond the mirror: the port's CLI over both fixture trees
# ---------------------------------------------------------------------------

def test_cli_list_rules_is_exactly_the_port_rules():
    p = _cli("--list-rules")
    assert p.returncode == 0, p.stderr
    assert {ln.split()[0] for ln in p.stdout.splitlines()} == PORT_RULES


def test_cli_flags_every_fixture_and_honours_suppressions():
    p = _cli(str(FIXTURES), str(TFIXTURES), "--format=json")
    assert p.returncode == 1, p.stderr
    out = json.loads(p.stdout)
    paths = {f["path"] for f in out["findings"]}
    bad = {"bad_ctxvar.py", "bad_faults.py", "bad_lockorder.py",
           "bad_metric.py", "parallel/bad_deadline.py",
           "parallel/bad_except.py", "parallel/bad_typed.py",
           "bad_capture.py"}
    assert bad <= paths, sorted(bad - paths)
    assert not paths & {"parallel/suppressed_ok.py",
                        "suppressed_capture.py"}, paths
    # the JAX-only fixture holds nothing a port rule flags
    assert "bad_jax.py" not in paths
    assert out["elapsed_s"] < 10.0


def test_cli_default_scans_the_port_package(tmp_path):
    # no paths: the package the CLI was loaded from, wherever it is run
    p = _cli("--format=json", cwd=tmp_path)
    assert p.returncode == 0, p.stdout[-2000:]
    out = json.loads(p.stdout)
    assert out["findings"] == []
    assert out["files"] == sum(
        1 for py in PKG.rglob("*.py") if not py.name.endswith("_pb2.py")
        and "__pycache__" not in py.parts)


# ---------------------------------------------------------------------------
# equal to the JAX analyzer on the seven shared rules
# ---------------------------------------------------------------------------

def _key(fs):
    return [(f.rule, f.path, f.line, f.message) for f in fs]


@pytest.mark.parametrize("rule", SHARED_RULES)
def test_shared_rule_matches_jax_on_the_fixture_tree(rule):
    want = _key(jax_analyze_paths([FIXTURES], [rule]))
    assert want, rule                  # every shared rule has a fixture
    assert _key(analyze_paths([FIXTURES], [rule])) == want


@pytest.mark.parametrize(
    "rel", sorted(p.relative_to(FIXTURES).as_posix()
                  for p in FIXTURES.rglob("*.py")))
def test_shared_rules_match_jax_file_by_file(rel):
    path = FIXTURES / rel
    rules = list(SHARED_RULES)
    assert _key(analyze_paths([path], rules)) == \
        _key(jax_analyze_paths([path], rules))


def test_purity_rules_do_not_cross():
    # the JAX fixture's jit/fori_loop/donation sites are not torch
    # capture sites, and torch's capture sites are not JAX device code
    assert analyze_paths([FIXTURES / "bad_jax.py"], ["capture-purity"]) == []
    assert jax_analyze_paths([TFIXTURES], ["jax-purity"]) == []
    assert jax_analyze_paths([TFIXTURES]) == []


# ---------------------------------------------------------------------------
# capture-purity on torch's other capture sites
# ---------------------------------------------------------------------------

_CAPTURE_SITES = '''\
import time

import numpy as np
import torch


@torch.jit.script
def scripted(x):
    return x + time.perf_counter()


@torch.compile(mode="reduce-overhead")
def compiled(x):
    return x * np.random.rand()


def traced_fn(x):
    print(x)
    return x


traced = torch.jit.trace(traced_fn, (torch.zeros(2),))


class Step:
    def body(self, x):
        return x + time.monotonic()

    def build(self):
        return torch.compile(self.body)


pair = torch.cuda.make_graphed_callables(
    (lambda x: x + time.time_ns(),), ((torch.zeros(2),),))


def plain(x):
    print(x)                  # never captured: not flagged
    return compile("1", "<s>", "eval")
'''


def test_capture_purity_sees_every_capture_site(tmp_path):
    (tmp_path / "sites.py").write_text(_CAPTURE_SITES)
    fs = analyze_paths([tmp_path], ["capture-purity"])
    got = {f.line: f.message.split()[2] for f in fs}
    assert got == {9: "time.perf_counter()", 14: "np.random.rand()",
                   18: "print()", 27: "time.monotonic()",
                   34: "time.time_ns()"}, fs


# ---------------------------------------------------------------------------
# the analyzer loads no accelerator stack and nothing of the JAX package
# ---------------------------------------------------------------------------

def test_cli_loads_neither_jax_torch_nor_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "dgraph_tpu_torch.analysis", "--list-rules"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr
    mods = {ln.rsplit("|", 1)[-1].strip() for ln in proc.stderr.splitlines()
            if ln.startswith("import time:")}
    assert "dgraph_tpu_torch.analysis.checkers" in mods, sorted(mods)
    bad = sorted(m for m in mods if m.split(".")[0] in
                 ("jax", "jaxlib", "torch", "numpy", "dgraph_tpu"))
    assert bad == []
