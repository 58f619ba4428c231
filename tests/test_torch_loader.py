"""The port's loaders (loader/{bulk,live,xidmap,convert}.py,
ingest/spill.py, models/{ldbc,film}.py and the CLI's `ldbc_gen`,
`convert`, `bulk` and `live`) against the JAX package's, on the CPU.

The loaders are host code in both packages, so the outputs must be equal
byte for byte: the same (sf, seed) writes the same LDBC-shaped CSVs; the
same dump and GeoJSON convert to the same N-Quads and schema; the same
N-Quads bulk-load to the same snapshot.bin (in RAM, out of core under a
spill budget, with one and two parse workers), which each package's Store
opens and serves equal to the other; exports are equal; xid maps persist,
resume after a crash and cross between the packages; a live load through
the port's Node(device="cpu") exports equal to a bulk load of the same
N-Quads; vectors load through bulk; and the four CLI subcommands run as
subprocesses.
"""

import gzip
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dgraph_tpu.api.server import Node as JNode
from dgraph_tpu.coord.zero import UidLease as JLease
from dgraph_tpu.loader import bulk as jbulk
from dgraph_tpu.loader import convert as jconv
from dgraph_tpu.loader import export as jexp
from dgraph_tpu.loader import live as jlive
from dgraph_tpu.loader.xidmap import XidMap as JXidMap
from dgraph_tpu.models import ldbc as jldbc
from dgraph_tpu.storage.store import Store as JStore

from dgraph_tpu_torch.api.server import Node as TNode
from dgraph_tpu_torch.coord.zero import UidLease as TLease
from dgraph_tpu_torch.ingest import spill as tspill
from dgraph_tpu_torch.loader import bulk as tbulk
from dgraph_tpu_torch.loader import convert as tconv
from dgraph_tpu_torch.loader import export as texp
from dgraph_tpu_torch.loader import live as tlive
from dgraph_tpu_torch.loader.xidmap import XidMap as TXidMap
from dgraph_tpu_torch.models import film as tfilm
from dgraph_tpu_torch.models import ldbc as tldbc
from dgraph_tpu_torch.storage.store import Store as TStore

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")

SCHEMA = """
name: string @index(exact, term) .
age: int @index(int) .
follows: [uid] @reverse @count .
bio: string @lang .
weight: float .
nick: [string] @index(term) .
"""


def _rich_rdf(n=200, edges=5, seed=11):
    """tests/test_ingest.py's _rich_rdf: values, langs, facets, list
    values, uid edges with duplicates — every reduce branch."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        lines.append(f'_:p{i} <name> "person {i}" .')
        lines.append(f'_:p{i} <age> "{20 + i % 60}"^^<xs:int> .')
        if i % 3 == 0:
            lines.append(f'_:p{i} <bio> "hello {i}"@en .')
            lines.append(f'_:p{i} <bio> "bonjour {i}"@fr .')
        if i % 5 == 0:
            lines.append(f'_:p{i} <nick> "nick{i}" .')
            lines.append(f'_:p{i} <nick> "alias{i % 7}" .')
        for j in rng.choice(n, size=edges, replace=False):
            if j % 11 == 3:
                lines.append(f'_:p{i} <follows> _:p{j} '
                             f'(since={1990 + int(j) % 30}) .')
            else:
                lines.append(f'_:p{i} <follows> _:p{j} .')
    lines += lines[:40]
    return "\n".join(lines) + "\n"


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _tree(d):
    """{relative path: sha256} of every file under d."""
    return {str(p.relative_to(d)): _sha(p)
            for p in sorted(Path(d).rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def ldbc_dump(tmp_path_factory):
    """One small LDBC-shaped dump written by each package, plus each
    package's conversion of it."""
    d = tmp_path_factory.mktemp("ldbc")
    jldbc.generate_ldbc(str(d / "j"), sf=0.003, seed=9)
    tldbc.generate_ldbc(str(d / "t"), sf=0.003, seed=9)
    jconv.convert_ldbc(str(d / "j"), str(d / "j.rdf.gz"))
    tconv.convert_ldbc(str(d / "t"), str(d / "t.rdf.gz"))
    return d


# ---------------------------------------------------------------------------
# generation and conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sf,seed", [(0.003, 9), (0.01, 1)])
def test_ldbc_gen_writes_the_jax_bytes(tmp_path, sf, seed):
    js = jldbc.generate_ldbc(str(tmp_path / "j"), sf=sf, seed=seed)
    ts = tldbc.generate_ldbc(str(tmp_path / "t"), sf=sf, seed=seed)
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    assert (ts.persons, ts.knows, ts.posts, ts.comments, ts.edges) == \
        (js.persons, js.knows, js.posts, js.comments, js.edges)


def test_convert_ldbc_equals_jax(ldbc_dump):
    d = ldbc_dump
    assert gzip.decompress((d / "t.rdf.gz").read_bytes()) == \
        gzip.decompress((d / "j.rdf.gz").read_bytes())
    assert (d / "t.rdf.gz.schema").read_text() == \
        (d / "j.rdf.gz.schema").read_text()


def test_convert_ldbc_fixture_equals_jax(tmp_path):
    fixture = REPO / "tests" / "fixtures" / "ldbc"
    js = jconv.convert_ldbc(str(fixture), str(tmp_path / "j.rdf.gz"))
    ts = tconv.convert_ldbc(str(fixture), str(tmp_path / "t.rdf.gz"))
    assert ts == js or vars(ts) == vars(js)
    assert gzip.decompress((tmp_path / "t.rdf.gz").read_bytes()) == \
        gzip.decompress((tmp_path / "j.rdf.gz").read_bytes())


def test_convert_geojson_equals_jax(tmp_path):
    geo = tmp_path / "cities.json"
    geo.write_text(json.dumps({"type": "FeatureCollection", "features": [
        {"type": "Feature",
         "geometry": {"type": "Point", "coordinates": [-122.42, 37.77]},
         "properties": {"name": "SF", "pop": 880000, "coastal": True}},
        {"type": "Feature",
         "geometry": {"type": "Polygon", "coordinates": [
             [[0, 0], [1, 0], [1, 1], [0, 0]]]},
         "properties": {"name": "tri"}},
        {"type": "Feature", "geometry": None, "properties": {"name": "x"}},
    ]}))
    js = jconv.convert_geojson(str(geo), str(tmp_path / "j.rdf.gz"))
    ts = tconv.convert_geojson(str(geo), str(tmp_path / "t.rdf.gz"))
    assert (ts.features, ts.triples) == (js.features, js.triples) == (2, 6)
    assert gzip.decompress((tmp_path / "t.rdf.gz").read_bytes()) == \
        gzip.decompress((tmp_path / "j.rdf.gz").read_bytes())


# ---------------------------------------------------------------------------
# bulk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(workers=1), dict(workers=2), dict(workers=1, spill_mb=0.02),
    dict(workers=2, spill_mb=0.02, xidmap_cache=64),
], ids=["inram_w1", "inram_w2", "spill_w1", "spill_w2_capped"])
def test_bulk_output_is_the_jax_bytes(tmp_path, kw):
    rdf = tmp_path / "d.rdf"
    rdf.write_text(_rich_rdf())
    js = jbulk.bulk_load(str(rdf), SCHEMA, str(tmp_path / "j"), **kw)
    ts = tbulk.bulk_load(str(rdf), SCHEMA, str(tmp_path / "t"), **kw)
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    for f in ("edges", "uid_edges", "values", "nodes", "predicates", "xids",
              "xidmap_hit_rate"):
        assert getattr(ts, f) == getattr(js, f), f
    if "spill_mb" in kw:
        # the framed runs hold pickled values, whose pickles name the
        # package's module, so run bytes (and where the budget cuts a run)
        # differ a little; the snapshot above is the same bytes
        assert ts.spill_runs > 10 and ts.merge_fanin > 1
        assert abs(ts.spill_bytes - js.spill_bytes) < 0.05 * js.spill_bytes


def test_spill_output_equals_in_ram(tmp_path):
    rdf = tmp_path / "d.rdf"
    rdf.write_text(_rich_rdf(n=150))
    tbulk.bulk_load(str(rdf), SCHEMA, str(tmp_path / "a"), workers=1)
    st = tbulk.bulk_load(str(rdf), SCHEMA, str(tmp_path / "b"), workers=2,
                         spill_mb=0.01, xidmap_cache=32)
    assert st.spill_runs > 10
    assert _sha(tmp_path / "a" / "snapshot.bin") == \
        _sha(tmp_path / "b" / "snapshot.bin")


def test_spill_pairs_and_framed_roundtrip(tmp_path):
    from dgraph_tpu.ingest import spill as jspill

    rng = np.random.default_rng(4)
    rows = {}
    for mod, tag in ((tspill, "t"), (jspill, "j")):
        st = mod.SpillStats()
        pool = mod.SpillSet(str(tmp_path / tag), 2048, st)
        ps = mod.UidPairSpiller(pool)
        for a, b in zip(rng.integers(0, 50, 3000), rng.integers(0, 9, 3000)):
            ps.add("ch", int(a), int(b))
        pool.flush()
        assert st.spill_runs > 4
        rows[tag] = [(a, row.tolist()) for a, row in
                     mod.merge_pairs(ps.runs("ch"), st, max_fanin=3)]
    assert rows["t"] == rows["j"] and len(rows["t"]) == 50


@pytest.mark.parametrize("q", [
    '{ q(func: eq(name, "person 3")) { name bio@fr fc: count(follows) '
    'follows @facets(since) { name } } }',
    '{ q(func: anyofterms(nick, "alias3")) { count(uid) } }',
    '{ q(func: eq(name, "person 1")) { ~follows { name } } }',
    '{ q(func: ge(age, 70), orderasc: name, first: 5) { name age } }',
])
def test_each_store_opens_the_others_bulk_output(tmp_path, q):
    rdf = tmp_path / "d.rdf"
    rdf.write_text(_rich_rdf(n=120))
    jbulk.bulk_load(str(rdf), SCHEMA, str(tmp_path / "j"), workers=1)
    tbulk.bulk_load(str(rdf), SCHEMA, str(tmp_path / "t"), workers=1,
                    spill_mb=0.02)
    outs = []
    for cls, d in ((JNode, "t"), (TNode, "j"), (JNode, "j"), (TNode, "t")):
        kw = dict(device="cpu") if cls is TNode else {}
        n = cls(str(tmp_path / d), **kw)
        try:
            outs.append(json.dumps(n.query(q)[0]))
        finally:
            n.close()
    assert len(set(outs)) == 1 and outs[0] != '{"q": []}', outs


def test_exports_equal(tmp_path):
    rdf = tmp_path / "d.rdf"
    rdf.write_text(_rich_rdf(n=80))
    tbulk.bulk_load(str(rdf), SCHEMA, str(tmp_path / "p"), workers=1)
    outs = []
    for S, exp in ((JStore, jexp), (TStore, texp)):
        s = S(str(tmp_path / "p"))
        try:
            o = tmp_path / f"{exp.__name__}.rdf.gz"
            exp.export_rdf(s, str(o),
                           schema_path=str(tmp_path / f"{exp.__name__}.s"))
        finally:
            s.close()
        outs.append((gzip.decompress(o.read_bytes()),
                     (tmp_path / f"{exp.__name__}.s").read_text()))
    assert outs[0] == outs[1] and outs[0][0].count(b"\n") > 500


def test_bulk_typed_errors_equal_jax(tmp_path):
    cases = [("<_:a> <name> _:b .\n<_:a> <name> \"x\" .", "name: string ."),
             ('<_:a> <emb> "[1, 2]"^^<xs:float32vector> .',
              "emb: float32vector @index(vector(dim: 3)) .")]
    for i, (text, schema) in enumerate(cases):
        p = tmp_path / f"bad{i}.rdf"
        p.write_text(text)
        msgs = []
        for mod in (jbulk, tbulk):
            with pytest.raises(mod.BulkError) as ex:
                mod.bulk_load(str(p), schema,
                              str(tmp_path / f"o{i}{mod.__name__}"),
                              workers=1)
            msgs.append(str(ex.value))
        assert msgs[0] == msgs[1], msgs
    p = tmp_path / "del.rdf"
    p.write_text('<0x1> <name> * .\n')
    good = tmp_path / "good.rdf"
    good.write_text('_:a <name> "A" .\n')
    for mod in (jbulk, tbulk):
        with pytest.raises(mod.BulkError, match="delete"):
            mod.bulk_load(str(p), "name: string .",
                          str(tmp_path / f"d{mod.__name__}"), workers=1)
        out = str(tmp_path / f"full{mod.__name__}")
        mod.bulk_load(str(good), "name: string .", out, workers=1)
        with pytest.raises(mod.BulkError, match="already contains"):
            mod.bulk_load(str(good), "name: string .", out, workers=1)


def test_bulk_metrics_populate_registry(tmp_path):
    from dgraph_tpu_torch.utils import metrics as m

    rdf = tmp_path / "d.rdf"
    rdf.write_text(_rich_rdf(n=120, edges=3))
    reg = m.Registry()
    tbulk.bulk_load(str(rdf), SCHEMA, str(tmp_path / "p"), workers=1,
                    spill_mb=0.02, xidmap_cache=64, metrics=reg)
    assert reg.counter("dgraph_ingest_spill_bytes_total").value > 0
    assert reg.counter("dgraph_ingest_spill_runs_total").value > 0
    assert reg.counter("dgraph_ingest_merge_fanin").value > 0
    assert reg.counter("dgraph_xidmap_lookups_total").value > 0
    assert reg.counter("dgraph_xidmap_evictions_total").value > 0


def test_iter_quads_equals_jax(tmp_path):
    rdf = tmp_path / "d.rdf"
    rdf.write_text(_rich_rdf(n=40))
    def plain(x):
        if hasattr(x, "tid"):                 # a Val of either package
            return (int(x.tid), x.value)
        if isinstance(x, tuple):              # facets: ((name, Val), ...)
            return tuple(plain(y) for y in x)
        return x

    def rows(mod):
        return [plain(r) for r in mod.iter_quads([str(rdf)], 1)]

    assert rows(tbulk) == rows(jbulk) and len(rows(tbulk)) > 300


def test_bulk_load_vectors(tmp_path):
    """tests/test_vector.py::test_bulk_load_vectors on the port: embeddings
    load through bulk and answer similar_to as the JAX package's do."""
    rng = np.random.default_rng(11)
    vecs = {i: rng.normal(size=4) for i in range(1, 21)}
    rdf = tmp_path / "v.rdf"
    rdf.write_text("\n".join(
        f'<0x{i:x}> <emb> "[{", ".join(repr(float(x)) for x in v)}]"'
        f'^^<xs:float32vector> .' for i, v in vecs.items()))
    schema = "emb: float32vector @index(vector(dim: 4, metric: l2)) .\n"
    jbulk.bulk_load(str(rdf), schema, str(tmp_path / "j"))
    tbulk.bulk_load(str(rdf), schema, str(tmp_path / "t"))
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    q = '{ q(func: similar_to(emb, "[0.1, 0.2, -0.3, 0.4]", 5)) ' \
        '{ uid d : val(vector_distance) } }'
    outs = []
    for cls, d in ((JNode, "j"), (TNode, "t")):
        kw = dict(device="cpu") if cls is TNode else {}
        n = cls(str(tmp_path / d), **kw)
        try:
            outs.append(json.dumps(n.query(q)[0]))
            assert n.snapshot().pred("emb").vecindex.n == 20
        finally:
            n.close()
    assert outs[0] == outs[1] and len(json.loads(outs[0])["q"]) == 5


# ---------------------------------------------------------------------------
# xidmap
# ---------------------------------------------------------------------------

def test_xidmap_identity_and_persistence(tmp_path):
    got = []
    for XM, L in ((JXidMap, JLease), (TXidMap, TLease)):
        lease = L()
        xm = XM(lease, block=4)
        ids = [xm.uid("alice"), xm.uid("0x2a"), xm.uid("bob")]
        ids.append(xm.uid(f"0x{ids[2] + 1:x}"))
        ids.append(xm.uid("carol"))
        got.append(ids)
    assert got[0] == got[1]


def test_xidmap_sharded_dirs_cross_packages(tmp_path):
    """A capped map written by one package attaches in the other with the
    same mappings, and new names never collide."""
    d = str(tmp_path / "xm")
    xm = TXidMap(TLease(), dirpath=d, cache_entries=100)
    first = {f"node{i}": xm.uid(f"node{i}") for i in range(800)}
    assert xm.stats.evictions > 0
    xm.flush()
    jx = JXidMap(JLease(), dirpath=d, cache_entries=100)
    assert all(jx.uid(x) == u for x, u in first.items())
    assert jx.uid("fresh") > max(first.values())
    tx = TXidMap(TLease(), dirpath=d, cache_entries=100)
    assert all(tx.uid(x) == u for x, u in first.items())


@pytest.mark.parametrize("cap", [None, 50], ids=["unbounded", "capped"])
def test_xidmap_crash_resume(tmp_path, cap):
    """Kill after sync (no close, no flush), plus a torn trailing record:
    both packages replay the same identities from the port's log."""
    wal = str(tmp_path / "x.log")
    kw = dict(cache_entries=cap) if cap else {}
    xm = TXidMap.open(wal, TLease(), **kw)
    first = {f"n{i}": xm.uid(f"n{i}") for i in range(400)}
    xm.sync()
    del xm
    with open(wal, "ab") as f:
        f.write(b"n9999\t12")
    news = []
    for XM, L in ((TXidMap, TLease), (JXidMap, JLease)):
        # the second attach sees the first's replay, so each package
        # reopens a copy of the crashed log
        w = str(tmp_path / f"{XM.__module__}.log")
        with open(wal, "rb") as src, open(w, "wb") as dst:
            dst.write(src.read())
        if cap:
            import shutil

            if os.path.exists(wal + ".shards"):
                shutil.copytree(wal + ".shards", w + ".shards")
        lease = L()
        xm2 = XM.open(w, lease, **kw)
        assert all(xm2.uid(x) == u for x, u in first.items())
        news.append(xm2.uid("n9999"))
        nxt, _ = lease.assign(1)
        assert nxt > max(first.values())
        xm2.close()
    assert news[0] == news[1] and news[0] not in first.values()


# ---------------------------------------------------------------------------
# live
# ---------------------------------------------------------------------------

def test_live_load_matches_bulk(tmp_path):
    rdf = tmp_path / "d.rdf"
    rdf.write_text(_rich_rdf(n=60, edges=3))
    tbulk.bulk_load(str(rdf), SCHEMA, str(tmp_path / "b"), workers=1)
    nb = TNode(str(tmp_path / "b"), device="cpu")
    nl = TNode(str(tmp_path / "l"), device="cpu")
    nj = JNode()
    try:
        nl.alter(schema_text=SCHEMA)
        nj.alter(schema_text=SCHEMA)
        st = tlive.live_load(nl, str(rdf), batch=97)
        sj = jlive.live_load(nj, str(rdf), batch=97)
        assert (st.quads, st.txns) == (sj.quads, sj.txns)
        q = ('{ q(func: has(name), orderasc: name) { name age bio@en nick '
             'follows (orderasc: name) { name } } }')
        rb = json.dumps(nb.query(q)[0])
        assert json.dumps(nl.query(q)[0]) == rb == json.dumps(nj.query(q)[0])
    finally:
        for n in (nb, nl, nj):
            n.close()


def test_live_load_resume_keeps_identities(tmp_path):
    a = tmp_path / "a.rdf"
    b = tmp_path / "b.rdf"
    a.write_text('_:x <name> "X" .\n_:y <name> "Y" .\n')
    b.write_text('_:x <follows> _:y .\n_:z <name> "Z" .\n_:x <follows> _:z .')
    outs = []
    for cls, mod, tag in ((TNode, tlive, "t"), (JNode, jlive, "j")):
        kw = dict(device="cpu") if cls is TNode else {}
        wal = str(tmp_path / f"{tag}.xlog")
        n = cls(str(tmp_path / tag), **kw)
        try:
            n.alter(schema_text=SCHEMA)
            mod.live_load(n, [str(a)], xidmap_path=wal)
            mod.live_load(n, [str(b)], xidmap_path=wal)
            outs.append(json.dumps(n.query(
                '{ q(func: eq(name, "X")) { name follows '
                '(orderasc: name) { name } } }')[0]))
        finally:
            n.close()
    assert outs[0] == outs[1]
    assert json.loads(outs[0])["q"][0]["follows"] == [{"name": "Y"},
                                                      {"name": "Z"}]


def test_film_node_equals_jax():
    from dgraph_tpu.models import film as jfilm

    t = tfilm.film_node(n_people=200, follows=3, device="cpu")
    j = jfilm.film_node(n_people=200, follows=3)
    try:
        q = ('{ q(func: eq(genre, "noir"), first: 5) { name age '
             'follows (first: 3) { name } } }')
        assert json.dumps(t.query(q)[0]) == json.dumps(j.query(q)[0])
    finally:
        t.close()
        j.close()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(*args, timeout=180):
    return subprocess.run([sys.executable, "-m", "dgraph_tpu_torch", *args],
                          cwd=REPO, env=ENV, capture_output=True, text=True,
                          timeout=timeout)


def test_cli_ldbc_gen_convert_bulk_live(tmp_path):
    """ldbc_gen | convert --ldbc | bulk, then live of a prefix through a
    port Node on the CPU: each output equals the JAX library's, and the
    live load exports equal to a bulk load of the same prefix."""
    d, rdf, post = tmp_path / "dump", tmp_path / "q.rdf.gz", tmp_path / "p"
    p = _cli("ldbc_gen", "--sf", "0.003", "--seed", "5", "--out", str(d))
    assert p.returncode == 0, p.stderr
    jldbc.generate_ldbc(str(tmp_path / "jd"), sf=0.003, seed=5)
    assert _tree(d) == _tree(tmp_path / "jd")
    p = _cli("convert", "--ldbc", str(d), "--out", str(rdf))
    assert p.returncode == 0, p.stderr
    jconv.convert_ldbc(str(d), str(tmp_path / "j.rdf.gz"))
    assert gzip.decompress(rdf.read_bytes()) == \
        gzip.decompress((tmp_path / "j.rdf.gz").read_bytes())
    p = _cli("bulk", "-f", str(rdf), "-s", f"{rdf}.schema", "-o", str(post),
             "-j", "2", "--log_json")
    assert p.returncode == 0, p.stderr
    done = [json.loads(ln) for ln in (p.stdout + p.stderr).splitlines()
            if ln.startswith("{") and "bulk load done" in ln]
    assert done and done[0]["nodes"] > 0
    jbulk.bulk_load([str(rdf)], open(f"{rdf}.schema").read(),
                    str(tmp_path / "jp"), workers=1)
    assert _sha(post / "snapshot.bin") == \
        _sha(tmp_path / "jp" / "snapshot.bin")
    # live of a prefix against bulk of the same prefix
    lines = gzip.decompress(rdf.read_bytes()).decode().splitlines()[:400]
    pre = tmp_path / "pre.rdf"
    pre.write_text("\n".join(lines) + "\n")
    p = _cli("live", "-f", str(pre), "-s", f"{rdf}.schema", "-p",
             str(tmp_path / "lp"), "--batch", "100", "--device", "cpu")
    assert p.returncode == 0, p.stderr
    jbulk.bulk_load(str(pre), open(f"{rdf}.schema").read(),
                    str(tmp_path / "bp"), workers=1)
    exports = []
    for src in ("lp", "bp"):
        p = _cli("export", "-p", str(tmp_path / src), "-o",
                 str(tmp_path / f"{src}.rdf.gz"))
        assert p.returncode == 0, p.stderr
        exports.append(sorted(gzip.decompress(
            (tmp_path / f"{src}.rdf.gz").read_bytes()).splitlines()))
    assert exports[0] == exports[1] and len(exports[0]) >= 300


def test_cli_live_needs_cuda_by_default(tmp_path):
    (tmp_path / "a.rdf").write_text('_:a <name> "A" .\n')
    p = _cli("live", "-f", str(tmp_path / "a.rdf"), "-p",
             str(tmp_path / "lp"))
    assert p.returncode != 0
    assert "torch.cuda.is_available() is False" in p.stderr


def test_cli_convert_geo_and_bulk_spill(tmp_path):
    geo = tmp_path / "g.json"
    geo.write_text(json.dumps({"type": "FeatureCollection", "features": [
        {"type": "Feature",
         "geometry": {"type": "Point", "coordinates": [1.5, 2.5]},
         "properties": {"name": "A"}}]}))
    p = _cli("convert", "--geo", str(geo), "--out", str(tmp_path / "g.rdf"))
    assert p.returncode == 0, p.stderr
    rdf = tmp_path / "d.rdf"
    rdf.write_text(_rich_rdf(n=60))
    sch = tmp_path / "s.txt"
    sch.write_text(SCHEMA)
    p = _cli("bulk", "-f", str(rdf), "-s", str(sch), "-o",
             str(tmp_path / "sp"), "-j", "1", "--spill_mb", "0.02",
             "--xidmap_cache_mb", "0.01")
    assert p.returncode == 0, p.stderr
    jbulk.bulk_load(str(rdf), SCHEMA, str(tmp_path / "jp"), workers=1)
    assert _sha(tmp_path / "sp" / "snapshot.bin") == \
        _sha(tmp_path / "jp" / "snapshot.bin")
