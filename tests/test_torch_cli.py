"""`python -m dgraph_tpu_torch` as a user starts it, on the CPU.

Subprocess runs of the port's CLI: `version`; `serve --device cpu` with an
HTTP and a gRPC port, its banners parsed, then an alter, a mutation and two
golden queries over HTTP and over gRPC (the answers equal
tests/golden/expected.json), and /admin/shutdown, after which the process
exits 0; `export` over a posting directory, equal to the JAX package's
`export` of the same directory; `serve` without `--device` on a machine
without CUDA, failing with the device named; `serve --mesh` over the golden
battery, equal to a JAX mesh Node; `serve` with the serving-seam flags (`--no_batch`,
`--no_planner`, `--no_devprof`, `--device_budget_mb`, `--residency_pin`,
`--memory_mb`), each acting as on a JAX Node with the same setting; and a
subprocess guard that the wire modules load
neither jax nor the JAX package. Every read of the server's output and
every request has a timeout, and every process is killed in a `finally`.
"""

import gzip
import importlib.util
import json
import os
import queue
import re
import socket
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import pytest

from dgraph_tpu.api.server import Node as JNode

from dgraph_tpu_torch.api.grpc_client import DgraphClient

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
START_S = 90          # torch's import on a loaded CPU host


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GOLDEN = _load("golden_battery_cli", REPO / "tests" / "test_golden.py")
EXPECTED = json.loads((REPO / "tests" / "golden" / "expected.json")
                      .read_text())


def _cli(*args, timeout=START_S):
    return subprocess.run([sys.executable, "-m", "dgraph_tpu_torch", *args],
                          cwd=REPO, env=ENV, capture_output=True, text=True,
                          timeout=timeout)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, path, body, ctype="application/graphql+-"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 body.encode(), {"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.status == 200
        return json.loads(r.read())


def test_version():
    proc = _cli("version")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("dgraph-tpu ")
    assert "dgraph_tpu_torch" in proc.stdout


def test_serve_http_and_grpc_then_shutdown():
    gport = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dgraph_tpu_torch", "serve", "--device", "cpu",
         "--port", "0", "--grpc_port", str(gport)],
        cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    client = None
    try:
        banners = {}
        while len(banners) < 2:
            ln = lines.get(timeout=START_S)
            m = re.match(r"serving (gRPC|HTTP) on [\d.]+:(\d+)", ln)
            if m:
                banners[m.group(1)] = int(m.group(2))
        assert banners["gRPC"] == gport
        hport = banners["HTTP"]
        assert _post(hport, "/alter", GOLDEN.SCHEMA)["data"]["code"] == \
            "Success"
        out = _post(hport, "/mutate?commitNow=true",
                    "{ set {\n" + GOLDEN._dataset() + "\n} }")
        assert out["extensions"]["txn"]["commit_ts"] > 0
        client = DgraphClient(f"127.0.0.1:{gport}")
        picks = dict(GOLDEN.QUERIES)
        for name in ("recurse", "groupby"):
            assert _post(hport, "/query", picks[name])["data"] == \
                EXPECTED[name], name
            assert client.txn(read_only=True).query(picks[name]) == \
                EXPECTED[name], name
        assert _post(hport, "/admin/shutdown", "")["code"] == "Success"
        assert proc.wait(timeout=30) == 0
    finally:
        if client is not None:
            client.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        reader.join(timeout=5)


def test_export_equals_the_jax_export(tmp_path):
    # the golden dataset but its geo values: the export of a geo value
    # raises in both packages (a reference behaviour the port keeps)
    d = tmp_path / "p"
    node = JNode(dirpath=str(d), planner=False, batching=False,
                 devprof=False)
    try:
        node.alter(schema_text=GOLDEN.SCHEMA)
        node.mutate(set_nquads="\n".join(
            ln for ln in GOLDEN._dataset().splitlines()
            if "<loc>" not in ln), commit_now=True)
        node.mutate(set_nquads='<0x1000> <name> "d0 \\"renamed\\""@en .',
                    commit_now=True)
    finally:
        node.close()
    outs = {}
    for pkg in ("dgraph_tpu", "dgraph_tpu_torch"):
        rdf, schema = tmp_path / f"{pkg}.rdf.gz", tmp_path / f"{pkg}.schema"
        proc = subprocess.run(
            [sys.executable, "-m", pkg, "export", "-p", str(d), "-o",
             str(rdf), "--out-schema", str(schema)],
            cwd=REPO, env=dict(ENV, JAX_PLATFORMS="cpu"), capture_output=True,
            text=True, timeout=START_S)
        assert proc.returncode == 0, proc.stderr
        assert "export done" in proc.stdout
        outs[pkg] = (gzip.decompress(rdf.read_bytes()), schema.read_bytes())
    assert outs["dgraph_tpu_torch"] == outs["dgraph_tpu"]
    assert outs["dgraph_tpu"][0].count(b"\n") > 500


def test_serve_without_device_needs_cuda():
    proc = _cli("serve", "--port", "0", "--grpc_port", "0")
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert "serving" not in proc.stdout


@pytest.mark.parametrize("flags,slice_name", [
    (["--mesh"], "mesh"),
], ids=["mesh"])
def test_later_slice_flag_fails_naming_it(flags, slice_name):
    """`serve --mesh` (a flag that failed naming its slice until the mesh
    came) serves the golden battery over HTTP as expected.json and as a
    JAX mesh Node with the same shards; its /debug/metrics mesh section
    equals the JAX Node's."""
    from dgraph_tpu.api.http import _serving_metrics

    proc = subprocess.Popen(
        [sys.executable, "-m", "dgraph_tpu_torch", "serve", "--device", "cpu",
         "--port", "0", "--grpc_port", "0", *flags, "--mesh_devices", "8",
         "--mesh_min_edges", "1"],
        cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    j = JNode(mesh_devices=8, mesh_min_edges=1)
    try:
        port = None
        while port is None:
            m = re.match(r"serving HTTP on [\d.]+:(\d+)",
                         lines.get(timeout=START_S))
            port = int(m.group(1)) if m else None
        _post(port, "/alter", GOLDEN.SCHEMA)
        _post(port, "/mutate?commitNow=true",
              "{ set {\n" + GOLDEN._dataset() + "\n} }")
        j.alter(schema_text=GOLDEN.SCHEMA)
        j.mutate(set_nquads=GOLDEN._dataset(), commit_now=True)
        for name, q in GOLDEN.QUERIES:
            got = _post(port, "/query", q)["data"]
            assert got == EXPECTED[name] == json.loads(
                json.dumps(j.query(q)[0], default=str)), name
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/metrics", timeout=10) as r:
            t = json.loads(r.read())[slice_name]
        want = json.loads(json.dumps(_serving_metrics(j)[slice_name]))
        assert t == want and t["enabled"] and t["devices"] == 8
        assert t["fused_queries"] > 0 and t["sharded_tablets"] > 0
        assert _post(port, "/admin/shutdown", "")["code"] == "Success"
        assert proc.wait(timeout=30) == 0
    finally:
        j.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        reader.join(timeout=5)


@pytest.mark.parametrize("flags,kw", [
    (["--no_batch", "--no_planner", "--no_devprof"],
     dict(batching=False, planner=False, devprof=False)),
    (["--device_budget_mb", "1", "--residency_pin", "friend",
      "--memory_mb", "64"],
     dict(device_budget_mb=1, residency_pin="friend", memory_mb=64)),
], ids=["seams_off", "budget_pin_memory"])
def test_serving_seam_flags_act(flags, kw, tmp_path):
    """The flags reach the Node: its /debug/metrics sections read as a JAX
    Node's with the same settings."""
    from dgraph_tpu.api.http import _serving_metrics

    proc = subprocess.Popen(
        [sys.executable, "-m", "dgraph_tpu_torch", "serve", "--device", "cpu",
         "--port", "0", "--grpc_port", "0", "-p", str(tmp_path / "p"),
         *flags],
        cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    j = JNode(dirpath=str(tmp_path / "j"), **kw)
    try:
        if "memory_mb" in kw:
            j.set_memory_budget(kw["memory_mb"] << 20)
        port = None
        while port is None:
            m = re.match(r"serving HTTP on [\d.]+:(\d+)",
                         lines.get(timeout=START_S))
            port = int(m.group(1)) if m else None
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/metrics", timeout=10) as r:
            t = json.loads(r.read())
        want = _serving_metrics(j)
        assert t["batching"]["enabled"] is want["batching"]["enabled"]
        assert t["planner"]["enabled"] is want["planner"]["enabled"]
        assert t["devprof"]["enabled"] is want["devprof"]["enabled"]
        for k in ("budget_mb", "enabled", "pinned"):
            assert t["residency"][k] == want["residency"][k], k
        assert _post(port, "/admin/shutdown", "")["code"] == "Success"
        assert proc.wait(timeout=30) == 0
    finally:
        j.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        reader.join(timeout=5)


_GUARD = """
import json, sys
before = set(sys.modules)
import dgraph_tpu_torch.api.http, dgraph_tpu_torch.api.grpc_server
import dgraph_tpu_torch.api.grpc_client, dgraph_tpu_torch.live
import dgraph_tpu_torch.loader, dgraph_tpu_torch.obs.prom
import dgraph_tpu_torch.__main__ as cli
cli.build_parser().parse_args(["serve", "--device", "cpu"])
new = set(sys.modules) - before
print(json.dumps(sorted(m for m in new if m.split(".")[0] in
                        ("jax", "jaxlib", "dgraph_tpu"))))
"""


def test_wire_modules_import_no_jax():
    proc = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO, env=ENV,
                          capture_output=True, text=True, timeout=START_S)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_export_of_a_geo_value_raises_in_both(tmp_path):
    """The reference's export cannot write a geo value (its Geom does not
    serialize to JSON); the port keeps that behaviour, so both raise."""
    from dgraph_tpu.loader.export import export_rdf as jexport
    from dgraph_tpu.storage.store import Store as JStore
    from dgraph_tpu_torch.loader import export_rdf as texport
    from dgraph_tpu_torch.storage.store import Store as TStore

    d = tmp_path / "p"
    node = JNode(dirpath=str(d), planner=False, batching=False,
                 devprof=False)
    try:
        node.alter(schema_text="loc: geo @index(geo) .")
        node.mutate(set_nquads='<0x1> <loc> "{\\"type\\":\\"Point\\",'
                               '\\"coordinates\\":[1.5,2.5]}"^^<geo:geojson> .',
                    commit_now=True)
    finally:
        node.close()
    for store_cls, export in ((JStore, jexport), (TStore, texport)):
        store = store_cls(str(d))
        try:
            with pytest.raises(TypeError, match="Geom"):
                export(store, str(tmp_path / "out.rdf"))
        finally:
            store.close()
