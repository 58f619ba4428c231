"""The PyTorch port's HTTP API against the JAX package's, on the CPU.

A JAX Node behind the JAX `make_server` and a port Node(device="cpu")
behind the port's `make_server` run side by side (the `Pair`) and get the
same requests. Equality is byte-identical bodies and equal statuses, with
one exception: `extensions.server_latency.total_ns` is a clock reading, so
it is zeroed on both sides before the bytes are compared. Both Nodes run
with their planner, batcher and device observatory off, so timestamps,
uids and counters line up; the `pair_defaults` cases run both at the
defaults they share (planner, batcher and observatory on, an HBM
working-set manager, EXPLAIN over ?explain=true, POST
/admin/config/memory_mb).

Covered: /alter, /mutate in RDF and in JSON, commitNow, /commit and /abort
with startTs, a conflicting pair (409), a namespace violation (403), an
upsert block, all 38 golden queries over /query (equal to
tests/golden/expected.json as well), a bad query, /health, /state, /metrics (parsed as Prometheus text), /debug and
/debug/metrics (the per-tablet load book's `tablet_load` and
`dgraph_tablet_load` included, serve seconds aside), /admin/export,
/admin/tenant with X-Dgraph-Tenant requests, /admin/shutdown, POST
/analytics over a Node without a mesh (the mesh bodies:
tests/test_torch_analytics.py), and HTTPS.

The reference records an endpoint's meter and latency after the response
is written (api/http.py's `finally`), so a client's next request can
arrive first: every read of a counter after a response polls for at most
2 s instead of asserting on the first read. Every socket read has a
timeout; each test shuts its servers down in a `finally`.
"""

import gzip
import http.client
import importlib.util
import json
import re
import ssl
import subprocess
import threading
import time
from pathlib import Path

import pytest
import torch

from dgraph_tpu.api import http as jhttp
from dgraph_tpu.api.server import Node as JNode
from dgraph_tpu.obs import prom as jprom

from dgraph_tpu_torch.api import http as thttp
from dgraph_tpu_torch.api.server import Node as TNode
from dgraph_tpu_torch.obs import prom as tprom

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 5


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GOLDEN = _load("golden_battery_http", REPO / "tests" / "test_golden.py")
EXPECTED = json.loads((REPO / "tests" / "golden" / "expected.json")
                      .read_text())

SCHEMA = "name: string @index(exact, term) .\nage: int @index(int) .\n" \
         "friend: [uid] @reverse .\nemail: string @index(exact) @upsert ."
_LATENCY = re.compile(rb'"total_ns": \d+')


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _call(port, method, path, body=None, headers=None, tls=None):
    """(status, headers, body bytes) of one request; the socket times out."""
    if tls is None:
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=TIMEOUT_S)
    else:
        conn = http.client.HTTPSConnection("localhost", port,
                                           timeout=TIMEOUT_S, context=tls)
    try:
        if isinstance(body, (dict, list)):
            body = json.dumps(body)
            headers = {"Content-Type": "application/json", **(headers or {})}
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


class Pair:
    """A JAX server and a port server, each over its own Node."""

    def __init__(self, seams_on=False, **kw):
        if not seams_on:
            kw.update(planner=False, batching=False, devprof=False)
        self.nodes = (JNode(**kw), TNode(device="cpu", **kw))
        self.srvs = (jhttp.make_server(self.nodes[0], port=0),
                     thttp.make_server(self.nodes[1], port=0))
        self.threads = [threading.Thread(target=s.serve_forever, daemon=True)
                        for s in self.srvs]
        for t in self.threads:
            t.start()
        self.ports = [s.server_address[1] for s in self.srvs]

    @property
    def port(self):
        return self.ports[1]

    def both(self, method, path, body=None, headers=None):
        return [_call(p, method, path, body, headers) for p in self.ports]

    def same(self, method, path, body=None, headers=None, status=200):
        """Send to both; assert equal status and equal bytes (latency
        zeroed); return the port's parsed body."""
        (sj, _, bj), (st, _, bt) = self.both(method, path, body, headers)
        bj, bt = _LATENCY.sub(b'"total_ns": 0', bj), \
            _LATENCY.sub(b'"total_ns": 0', bt)
        assert (sj, bj) == (st, bt), (path, body)
        assert st == status, (path, bt)
        return json.loads(bt)

    def close(self):
        for s in self.srvs:
            s.shutdown()
            s.server_close()
        for t in self.threads:
            t.join(timeout=5)
        for n in self.nodes:
            n.close()


@pytest.fixture
def pair():
    p = Pair()
    try:
        yield p
    finally:
        p.close()


@pytest.fixture
def pair_defaults():
    p = Pair(seams_on=True)
    try:
        yield p
    finally:
        p.close()


def _seed(pair):
    pair.same("POST", "/alter", SCHEMA)
    return pair.same("POST", "/mutate?commitNow=true",
                     '{ set { _:a <name> "alice" .\n_:a <age> "30" .\n'
                     '_:b <name> "bob" .\n_:a <friend> _:b . } }')


def _poll(read, want, timeout=2.0):
    """read() until it returns want, for at most `timeout` seconds: the
    reference's meters are recorded after the response is written."""
    deadline = time.monotonic() + timeout
    got = read()
    while got != want and time.monotonic() < deadline:
        time.sleep(0.02)
        got = read()
    return got


# ---------------------------------------------------------------------------
# writes and transactions
# ---------------------------------------------------------------------------

def test_alter_mutate_query_rdf_and_json(pair):
    out = _seed(pair)
    assert set(out["data"]["uids"]) == {"a", "b"}
    assert out["extensions"]["txn"]["commit_ts"] > 0
    out = pair.same("POST", "/mutate?commitNow=true",
                    {"set": [{"uid": "_:c", "name": "carol", "age": 41,
                              "friend": [{"uid": out["data"]["uids"]["a"]}]}]})
    assert set(out["data"]["uids"]) == {"c"}
    q = '{ q(func: has(name), orderasc: name) { uid name age friend { name } } }'
    got = pair.same("POST", "/query", q)
    assert [r["name"] for r in got["data"]["q"]] == ["alice", "bob", "carol"]
    got = pair.same("POST", "/query", {"query": "query q($n: string) { q(func: "
                                                "eq(name, $n)) { ~friend { name } } }",
                                       "variables": {"$n": "bob"}})
    assert got["data"] == {"q": [{"~friend": [{"name": "alice"}]}]}
    # a JSON delete, then a DQL upsert block through /mutate
    pair.same("POST", "/mutate?commitNow=true",
              {"delete": [{"uid": out["data"]["uids"]["c"], "age": None}]})
    pair.same("POST", "/mutate?commitNow=true",
              'upsert { query { v as var(func: eq(email, "a@x.io")) } '
              'mutation @if(eq(len(v), 0)) { set { _:n <email> "a@x.io" . '
              '_:n <name> "newcomer" . } } }')
    got = pair.same("POST", "/query?ro=true",
                    '{ q(func: has(name), orderasc: name) { name age email } }')
    assert {"name": "newcomer", "email": "a@x.io"} in got["data"]["q"]
    assert {"name": "carol"} in got["data"]["q"]


def test_open_txn_commit_abort_and_read_your_writes(pair):
    _seed(pair)
    opened = pair.same("POST", "/mutate", '{ set { <0x50> <name> "dora" . } }')
    ts = opened["extensions"]["txn"]["start_ts"]
    assert opened["extensions"]["txn"]["commit_ts"] == 0
    q = '{ q(func: eq(name, "dora")) { name } }'
    assert pair.same("POST", "/query", q)["data"] == {}
    own = pair.same("POST", f"/query?startTs={ts}", q)
    assert own["data"] == {"q": [{"name": "dora"}]}
    pair.same("POST", f"/mutate?startTs={ts}",
              '{ set { <0x50> <age> "7" . } }')
    done = pair.same("POST", f"/commit?startTs={ts}")
    assert done["extensions"]["txn"]["commit_ts"] > ts
    assert pair.same("POST", "/query", q)["data"] == {"q": [{"name": "dora"}]}
    gone = pair.same("POST", "/mutate", '{ set { <0x51> <name> "gone" . } }',
                     headers={"X-Dgraph-CommitNow": "false"})
    pair.same("POST", f"/abort?startTs={gone['extensions']['txn']['start_ts']}")
    assert pair.same("POST", "/query", '{ q(func: eq(name, "gone")) '
                                       '{ name } }')["data"] == {}
    # committing an unknown txn is the 400 envelope on both
    err = pair.same("POST", f"/commit?startTs={ts}", status=400)
    assert err["errors"][0]["code"] == "ErrorInvalidRequest"


def test_conflicting_pair_is_409(pair):
    _seed(pair)
    t1 = pair.same("POST", "/mutate", '{ set { <0x77> <name> "one" . } }')
    t2 = pair.same("POST", "/mutate", '{ set { <0x77> <name> "two" . } }')
    pair.same("POST", f"/commit?startTs={t1['extensions']['txn']['start_ts']}")
    err = pair.same(
        "POST", f"/commit?startTs={t2['extensions']['txn']['start_ts']}",
        status=409)
    assert err["errors"][0]["code"] == "ErrorAborted"
    got = pair.same("POST", "/query", "{ q(func: uid(0x77)) { name } }")
    assert got["data"] == {"q": [{"name": "one"}]}


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------

def test_golden_battery_over_http(pair):
    pair.same("POST", "/alter", GOLDEN.SCHEMA)
    pair.same("POST", "/mutate?commitNow=true",
              "{ set {\n" + GOLDEN._dataset() + "\n} }")
    names = []
    for name, q in GOLDEN.QUERIES:
        got = pair.same("POST", "/query", q)
        assert got["data"] == EXPECTED[name], name
        names.append(name)
    assert len(names) == 38 and sorted(names) == sorted(EXPECTED)


def test_bad_query_is_the_same_400(pair):
    err = pair.same("POST", "/query", "{ not valid dql !!!", status=400)
    assert err["errors"][0]["code"] == "ErrorInvalidRequest"
    pair.same("POST", "/nosuchpath", "", status=404)
    pair.same("GET", "/nosuchpath", status=404)


def test_health_state_and_debug_index(pair):
    _seed(pair)
    assert pair.same("GET", "/health")["status"] == "healthy"
    pair.same("GET", "/state")
    pair.same("GET", "/debug")
    (sj, hj, bj), (st, ht, bt) = pair.both("GET", "/")
    assert sj == st == 200 and bj == bt
    assert ht["Content-Type"] == "text/html"


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------

def test_metrics_parse_and_cover_the_jax_names(pair):
    _seed(pair)
    pair.same("POST", "/query", '{ q(func: eq(name, "alice")) { name } }')
    counts = []
    for port in pair.ports:
        counts.append(_poll(
            lambda: json.loads(_call(port, "GET", "/debug/metrics")[2])
            ["endpoints"]["query"]["latency"]["count"], 1))
    assert counts == [1, 1]
    (sj, hj, bj), (st, ht, bt) = pair.both("GET", "/metrics")
    assert sj == st == 200
    assert ht["Content-Type"] == hj["Content-Type"] == tprom.CONTENT_TYPE_TEXT
    jnames, tnames = set(jprom.parse(bj.decode())), \
        set(tprom.parse(bt.decode()))
    # both exporters parse either text
    assert set(tprom.parse(bj.decode())) == jnames
    assert set(jprom.parse(bt.decode())) == tnames
    for want in ("dgraph_num_queries_total", "dgraph_query_latency_s_bucket",
                 "dgraph_http_query_latency_s_count", "dgraph_endpoint_qps"):
        assert want in tnames
    # every series the JAX server exports, the port exports too, the
    # per-tablet load book's included, with the same reads/writes/bytes
    assert jnames <= tnames, sorted(jnames - tnames)
    assert "dgraph_tablet_load" in tnames

    def load(text):
        return sorted((tuple(sorted(ls.items())), v) for ls, v in
                      tprom.parse(text)["dgraph_tablet_load"]
                      if ls["stat"] != "serve_ms")

    assert load(bt.decode()) == load(bj.decode()) != []
    assert any(n.startswith("dgraph_residency_") for n in tnames)
    # OpenMetrics on request, as the JAX server negotiates it
    (_, hj, bj), (_, ht, bt) = pair.both(
        "GET", "/metrics", headers={"Accept": "application/openmetrics-text"})
    assert ht["Content-Type"] == hj["Content-Type"]
    assert bt.endswith(b"# EOF\n") and bj.endswith(b"# EOF\n")


def test_debug_metrics_sections(pair):
    _seed(pair)
    (sj, _, bj), (st, _, bt) = pair.both("GET", "/debug/metrics")
    assert sj == st == 200
    j, t = json.loads(bj), json.loads(bt)
    assert list(t) == list(j)
    # the seams of later slices read as the JAX server's do with them off
    for sec in ("batching", "planner", "mesh", "devprof", "subscriptions",
                "journal", "writes", "dispatch", "caches", "costs"):
        assert list(t[sec]) == list(j[sec]), sec
    assert t["batching"]["enabled"] is j["batching"]["enabled"] is False
    assert t["planner"]["enabled"] is j["planner"]["enabled"] is False
    assert t["mesh"]["enabled"] is j["mesh"]["enabled"] is False
    assert t["devprof"] == j["devprof"] == {"enabled": False}
    # the HBM working-set manager is always present, unbounded here: the
    # same section; its byte totals differ by design (the port's PredData
    # keeps int64/float64 host mirrors, the JAX one int32/float32 device
    # columns), every counter is equal
    assert list(t["residency"]) == list(j["residency"])
    for k in ("budget_mb", "enabled", "admissions", "evictions",
              "prefetch_hits", "prefetch_wasted", "thrash", "cold_serves",
              "upload_failures", "budget_overruns", "pinned"):
        assert t["residency"][k] == j["residency"][k], k
    # the per-tablet load book: the same rows, serve seconds aside (a
    # clock reading)
    strip = lambda sect: {a: {k: v for k, v in row.items() if k != "d"}
                          for a, row in sect.items()}
    assert strip(t["tablet_load"]) == strip(j["tablet_load"])
    assert t["tablet_load"]["name"]["w"] >= 1
    writes = [_poll(lambda: json.loads(_call(p, "GET", "/debug/metrics")[2])
                    ["endpoints"]["mutate"]["latency"]["count"], 1)
              for p in pair.ports]
    assert writes == [1, 1]
    for path in ("/debug/vars", "/debug/requests", "/debug/traces",
                 "/debug/slow", "/debug/top", "/debug/faults",
                 "/debug/compiles", "/debug/timeline"):
        assert _call(pair.port, "GET", path)[0] == 200, path


# ---------------------------------------------------------------------------
# admin
# ---------------------------------------------------------------------------

def test_admin_export_equals_the_jax_export(pair, tmp_path):
    _seed(pair)
    pair.same("POST", "/mutate?commitNow=true",
              '{ set { <0x9> <name> "q\\"uote"@en .\n<0x9> <age> "5" . } }')
    outs = []
    for side, port in zip(("jax", "port"), pair.ports):
        dest = tmp_path / side
        st, _, body = _call(port, "POST", f"/admin/export?dest={dest}")
        assert st == 200, body
        outs.append(json.loads(body))
    j, t = outs
    assert Path(t["file"]).name == Path(j["file"]).name
    assert (t["quads"], t["predicates"]) == (j["quads"], j["predicates"])
    rdf_j = gzip.decompress(Path(j["file"]).read_bytes())
    rdf_t = gzip.decompress(Path(t["file"]).read_bytes())
    assert rdf_t == rdf_j and b'"q\\"uote"@en' in rdf_t
    assert Path(t["schema"]).read_bytes() == Path(j["schema"]).read_bytes()


def test_admin_tenant_and_tenant_requests(pair):
    cfg = {"tenants": {"acme": {"weight": 2.0, "edges_per_s": 1e9},
                       "beta": {"weight": 1.0}}}
    got = pair.same("POST", "/admin/tenant", cfg)
    assert set(got["tenants"]) >= {"acme", "beta"}
    for tenant, who in (("acme", "wile"), ("beta", "roadrunner")):
        hdr = {"X-Dgraph-Tenant": tenant}
        pair.same("POST", "/alter", "name: string @index(exact) .",
                  headers=hdr)
        pair.same("POST", "/mutate?commitNow=true",
                  '{ set { _:a <name> "%s" . } }' % who, headers=hdr)
    for tenant, who in (("acme", "wile"), ("beta", "roadrunner")):
        got = pair.same("POST", "/query", "{ q(func: has(name)) { name } }",
                        headers={"X-Dgraph-Tenant": tenant})
        assert got["data"] == {"q": [{"name": who}]}
    # a cross-namespace reference is the typed 403 on both
    err = pair.same("POST", "/alter", "beta/leak: string .",
                    headers={"X-Dgraph-Tenant": "acme"}, status=403)
    assert err["errors"][0]["code"] == "ErrorNamespace"
    pair.same("POST", "/admin/tenant", "")


def test_admin_shutdown_stops_the_server():
    p = Pair()
    try:
        for port in p.ports:
            st, _, body = _call(port, "POST", "/admin/shutdown")
            assert st == 200
            assert json.loads(body)["message"] == "Server is shutting down"
        for t in p.threads:
            t.join(timeout=5)
            assert not t.is_alive()
    finally:
        for n in p.nodes:
            n.close()
        for s in p.srvs:
            s.server_close()


@pytest.mark.parametrize("method,path,body,slice_name", [
    ("POST", "/analytics", {"kind": "pagerank", "pred": "friend"}, "mesh"),
], ids=["analytics"])
def test_later_slice_routes_name_their_slice(pair, method, path, body,
                                              slice_name):
    """The route the mesh slice brought answers as the JAX server's: over
    a Node without a mesh, the float64 host oracles, byte for byte (its
    mesh bodies: tests/test_torch_analytics.py)."""
    _seed(pair)
    out = pair.same(method, path, body)["data"]["analytics"]
    assert out["device"] is False and out["kind"] == "pagerank"
    assert out["nodes"] == 2 and out["edges"] == 1
    for kind in ("cc", "triangles"):
        pair.same(method, path, dict(body, kind=kind))
    pair.same(method, path, {"kind": "pagerank"}, status=400)


# ---------------------------------------------------------------------------
# the shared defaults: planner, batcher, observatory, working-set manager
# ---------------------------------------------------------------------------

def test_golden_battery_with_the_defaults(pair_defaults):
    p = pair_defaults
    p.same("POST", "/alter", GOLDEN.SCHEMA)
    p.same("POST", "/mutate?commitNow=true",
           "{ set {\n" + GOLDEN._dataset() + "\n} }")
    for name, q in GOLDEN.QUERIES:
        assert p.same("POST", "/query", q)["data"] == EXPECTED[name], name
    j, t = (json.loads(_call(port, "GET", "/debug/metrics")[2])
            for port in p.ports)
    assert list(t) == list(j)
    for sec in ("batching", "planner", "devprof", "residency", "dispatch",
                "caches"):
        assert list(t[sec]) == list(j[sec]), sec
    assert t["batching"]["enabled"] is j["batching"]["enabled"] is True
    assert t["planner"]["enabled"] is j["planner"]["enabled"] is True
    for k in ("plans_built", "root_swaps", "filter_reorders",
              "sibling_reorders", "host_expands", "device_expands",
              "fallbacks"):
        assert t["planner"][k] == j["planner"][k], k
    assert t["devprof"]["enabled"] is j["devprof"]["enabled"] is True
    assert t["devprof"]["dispatches"] > 0
    assert t["residency"]["enabled"] is j["residency"]["enabled"] is False
    jnames, tnames = (set(tprom.parse(_call(port, "GET", "/metrics")[2]
                                      .decode())) for port in p.ports)
    assert jnames <= tnames, sorted(jnames - tnames)
    for prefix in ("dgraph_residency_", "dgraph_batch_", "dgraph_planner_",
                   "dgraph_devprof_"):
        want = {n for n in jnames if n.startswith(prefix)}
        assert want and want <= tnames, prefix


def test_explain_over_http(pair_defaults):
    p = pair_defaults
    _seed(p)
    q = '{ q(func: has(name)) @filter(eq(name, "bob")) { name friend ' \
        '{ name } } }'
    out = p.same("POST", "/query?explain=true", q)
    ex = out["extensions"]["explain"]
    assert ex["planner"] == "on"
    assert set(ex["decisions"]) == {"root_swaps", "filter_reorders",
                                    "sibling_reorders", "cutover_overrides"}
    assert ex["blocks"][0]["root"]["actual"] is not None
    assert "explain" not in out["data"]


def test_admin_memory_budget(pair_defaults):
    p = pair_defaults
    _seed(p)
    assert p.same("POST", "/admin/config/memory_mb", "64")["code"] == \
        "Success"
    assert [n.memory_budget for n in p.nodes] == [64 << 20] * 2
    p.same("POST", "/admin/config/memory_mb", "nope", status=400)


# ---------------------------------------------------------------------------
# TLS
# ---------------------------------------------------------------------------

def test_https_round_trip(tmp_path):
    cert, key = str(tmp_path / "cert.pem"), str(tmp_path / "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "1", "-subj",
         "/CN=localhost", "-addext", "subjectAltName=DNS:localhost"],
        check=True, capture_output=True, timeout=60)
    node = TNode(device="cpu")
    srv = thttp.make_server(node, "localhost", 0, tls_cert=cert, tls_key=key)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        node.alter(schema_text="name: string @index(exact) .")
        node.mutate(set_nquads='_:a <name> "tls" .', commit_now=True)
        port = srv.server_address[1]
        ctx = ssl.create_default_context(cafile=cert)
        st, _, body = _call(port, "POST", "/query",
                            {"query": '{ q(func: eq(name, "tls")) { name } }'},
                            tls=ctx)
        assert st == 200
        assert json.loads(body)["data"] == {"q": [{"name": "tls"}]}
        # plaintext against the TLS port fails
        with pytest.raises(Exception):
            _call(port, "GET", "/health")
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=5)
        node.close()
