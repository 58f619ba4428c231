"""The golden battery over a wire cluster of the port's CLI processes.

`python -m dgraph_tpu_torch zero --groups 2` and two `python -m
dgraph_tpu_torch worker --device cpu --zero ...` processes (the golden
schema from a file), loaded through `ClusterClient.mutate`; every golden
query, through the port's ClusterClient and the JAX package's, must equal
tests/golden/expected.json (chip_smoke.py phase 14 (b) runs the same on the
card, where the JAX ClusterClient answers every golden query too). The
tablets land on both groups.
"""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

grpc = pytest.importorskip("grpc")

from dgraph_tpu.parallel.client import ClusterClient as JClusterClient

from dgraph_tpu_torch.parallel.client import ClusterClient

from test_golden import QUERIES, SCHEMA, _dataset

REPO = Path(__file__).resolve().parents[1]
EXPECTED = json.loads((REPO / "tests" / "golden" / "expected.json")
                      .read_text())


def _spawn(args):
    """Start a CLI process; (proc, port) from its `serving ... on` line."""
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen([sys.executable, "-m", "dgraph_tpu_torch"] + args,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env, cwd=str(REPO))
    lines = []
    deadline = time.time() + 120
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                raise RuntimeError(f"{args[0]} died: {''.join(lines)}")
            continue
        lines.append(line)
        m = re.search(r"serving .* on [\w.]+:(\d+)", line)
        if m:
            return proc, int(m.group(1)), line
    proc.kill()
    raise RuntimeError(f"{args[0]} never reported a port: {''.join(lines)}")


@pytest.fixture(scope="module")
def cli_cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    schema = tmp / "schema.txt"
    schema.write_text(SCHEMA)
    procs = []
    try:
        zp, zport, _ = _spawn(["zero", "--port", "0", "--groups", "2"])
        procs.append(zp)
        groups, banners = {}, []
        for g in range(2):
            wp, wport, banner = _spawn([
                "worker", "--port", "0", "-p", str(tmp / f"w{g}"),
                "--schema", str(schema), "--zero", f"127.0.0.1:{zport}",
                "--group", str(g), "--device", "cpu"])
            procs.append(wp)
            groups[g] = [f"127.0.0.1:{wport}"]
            banners.append(banner)
        client = ClusterClient(f"127.0.0.1:{zport}", groups,
                               default_timeout_ms=30000)
        client.mutate(set_nquads=_dataset())
        jclient = JClusterClient(f"127.0.0.1:{zport}", groups,
                                 default_timeout_ms=30000)
        yield client, jclient, banners
        client.close()
        jclient.close()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            try:
                p.wait(timeout=10)
            except Exception:
                pass


@pytest.mark.parametrize("name,q", QUERIES, ids=[n for n, _ in QUERIES])
def test_golden_over_cli_cluster(cli_cluster, name, q):
    client, _jclient, _banners = cli_cluster
    assert client.query(q) == EXPECTED[name]


def test_jax_client_over_cli_cluster_and_tablet_spread(cli_cluster):
    client, jclient, banners = cli_cluster
    for name, q in QUERIES:
        assert jclient.query(q) == EXPECTED[name], name
    assert set(client.zero.tablets().values()) == {0, 1}
    assert all("device=cpu" in b for b in banners), banners
