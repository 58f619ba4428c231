"""Dataset → RDF converters.

Copy of dgraph_tpu/loader/convert.py for the PyTorch port (host code only).

- GeoJSON (reference: dgraph/cmd/dgraph-converter/main.go — one blank node
  per feature, geometry as a geo:geojson literal, properties as value
  triples).
- LDBC-SNB interactive CSV dumps: the
  persons/knows/posts subset of the DATAGEN "social_network" layout mapped
  to N-Quads, so `bulk -f <out>` ingests a social-network benchmark graph.
  The SF10/SF100 ingest itself rides the out-of-core bulk tier
  (`bulk --spill_mb`); this is only the format bridge.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from dataclasses import dataclass


@dataclass
class ConvertStats:
    features: int = 0
    triples: int = 0


@dataclass
class LdbcStats:
    persons: int = 0
    knows: int = 0
    posts: int = 0
    comments: int = 0
    reply_of: int = 0
    triples: int = 0


def _esc(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def convert_geojson(geo_path: str, out_path: str,
                    geopred: str = "loc") -> ConvertStats:
    op = gzip.open if geo_path.endswith(".gz") else open
    with op(geo_path, "rt", encoding="utf-8") as f:
        doc = json.load(f)
    feats = doc.get("features", []) if doc.get("type") == "FeatureCollection" \
        else [doc]
    stats = ConvertStats()
    with gzip.open(out_path, "wt", encoding="utf-8") as out:
        for i, feat in enumerate(feats):
            geom = feat.get("geometry")
            if not geom:
                continue
            node = f"_:f{i}"
            out.write(f'{node} <{geopred}> '
                      f'"{_esc(json.dumps(geom, separators=(",", ":")))}"'
                      f'^^<geo:geojson> .\n')
            stats.triples += 1
            for k, v in (feat.get("properties") or {}).items():
                if v is None:
                    continue
                if isinstance(v, bool):
                    lit = f'"{str(v).lower()}"^^<xs:boolean>'
                elif isinstance(v, int):
                    lit = f'"{v}"^^<xs:int>'
                elif isinstance(v, float):
                    lit = f'"{v}"^^<xs:float>'
                else:
                    lit = f'"{_esc(str(v))}"'
                out.write(f"{node} <{k}> {lit} .\n")
                stats.triples += 1
            stats.features += 1
    return stats


# -- LDBC-SNB interactive (persons / knows / posts subset) -------------------
#
# DATAGEN CSV layout: pipe-separated with one header row; entity files
# carry `id|...` columns, relation files carry `<Type>.id|<Type>.id|...`.
# Blank-node ids are namespaced per entity type (person ids and post ids
# overlap numerically in the dumps).

# entity value columns kept, in header name -> (predicate, xsd type) form
_PERSON_COLS = {"firstName": ("firstName", None),
                "lastName": ("lastName", None),
                "gender": ("gender", None),
                "birthday": ("birthday", None),
                "creationDate": ("creationDate", None)}
_POST_COLS = {"content": ("content", None),
              "imageFile": ("imageFile", None),
              "language": ("language", None),
              "creationDate": ("creationDate", None),
              "length": ("length", "xs:int")}
_COMMENT_COLS = {"content": ("content", None),
                 "creationDate": ("creationDate", None),
                 "length": ("length", "xs:int")}


def _ldbc_file(dirpath: str, stem: str) -> str | None:
    """Find `<stem>_0_0.csv(.gz)` / `<stem>.csv(.gz)` under the dump dir
    (DATAGEN shards entity files; the fixture uses the bare name)."""
    for pat in (f"{stem}_0_0.csv", f"{stem}_0_0.csv.gz",
                f"{stem}.csv", f"{stem}.csv.gz"):
        hits = sorted(glob.glob(os.path.join(dirpath, pat)))
        if hits:
            return hits[0]
    return None


def _ldbc_rows(path: str):
    """(header list, row iterator) over one pipe-separated CSV."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt", encoding="utf-8") as f:
        header = None
        for line in f:
            line = line.rstrip("\n\r")
            if not line:
                continue
            if header is None:
                header = line.split("|")
                continue
            yield header, line.split("|")


def _emit_entity(out, path: str | None, prefix: str, id_pred: str,
                 cols: dict, stats: LdbcStats, count_attr: str) -> None:
    if path is None:
        return
    n = triples = 0
    for header, row in _ldbc_rows(path):
        vals = dict(zip(header, row))
        ident = vals.get("id")
        if ident is None:
            continue
        node = f"_:{prefix}{ident}"
        out.write(f'{node} <{id_pred}> "{ident}"^^<xs:int> .\n')
        triples += 1
        for col, (pred, typ) in cols.items():
            v = vals.get(col, "")
            if not v:
                continue
            lit = f'"{v}"^^<{typ}>' if typ else f'"{_esc(v)}"'
            out.write(f"{node} <{pred}> {lit} .\n")
            triples += 1
        n += 1
    setattr(stats, count_attr, getattr(stats, count_attr) + n)
    stats.triples += triples


def _emit_relation(out, path: str | None, src_prefix: str, pred: str,
                   dst_prefix: str, stats: LdbcStats,
                   count_attr: str | None) -> None:
    if path is None:
        return
    n = 0
    for header, row in _ldbc_rows(path):
        if len(row) < 2:
            continue
        out.write(f"_:{src_prefix}{row[0]} <{pred}> "
                  f"_:{dst_prefix}{row[1]} .\n")
        n += 1
    if count_attr is not None:
        setattr(stats, count_attr, getattr(stats, count_attr) + n)
    stats.triples += n


LDBC_SCHEMA = """\
person.id: int @index(int) @upsert .
firstName: string @index(exact) .
lastName: string @index(exact) .
gender: string .
birthday: string .
creationDate: string .
knows: [uid] @reverse @count .
post.id: int @index(int) @upsert .
content: string .
imageFile: string .
language: string .
length: int .
hasCreator: [uid] @reverse @count .
comment.id: int @index(int) @upsert .
replyOf: [uid] @reverse @count .
"""


def convert_ldbc(dirpath: str, out_path: str) -> LdbcStats:
    """Map an LDBC-SNB interactive CSV dump (persons/knows/posts/comments
    subset) to gzipped N-Quads for `bulk -f`. Also writes `<out>.schema`
    with the matching schema text. Blank-node identity is `_:p<id>` /
    `_:post<id>` / `_:c<id>` so relation files join without an id map.

    Comment entities carry the `replyOf` chains (comment→post and
    comment→comment) so depth-3 traversals over
    replyOf/hasCreator have realistic fan-out, not just person.knows."""
    stats = LdbcStats()
    with gzip.open(out_path, "wt", encoding="utf-8") as out:
        _emit_entity(out, _ldbc_file(dirpath, "person"), "p", "person.id",
                     _PERSON_COLS, stats, "persons")
        _emit_relation(out, _ldbc_file(dirpath, "person_knows_person"),
                       "p", "knows", "p", stats, "knows")
        _emit_entity(out, _ldbc_file(dirpath, "post"), "post", "post.id",
                     _POST_COLS, stats, "posts")
        _emit_relation(out, _ldbc_file(dirpath, "post_hasCreator_person"),
                       "post", "hasCreator", "p", stats, None)
        _emit_entity(out, _ldbc_file(dirpath, "comment"), "c", "comment.id",
                     _COMMENT_COLS, stats, "comments")
        _emit_relation(out, _ldbc_file(dirpath, "comment_replyOf_post"),
                       "c", "replyOf", "post", stats, "reply_of")
        _emit_relation(out, _ldbc_file(dirpath, "comment_replyOf_comment"),
                       "c", "replyOf", "c", stats, "reply_of")
        _emit_relation(out, _ldbc_file(dirpath, "comment_hasCreator_person"),
                       "c", "hasCreator", "p", stats, None)
    with open(out_path + ".schema", "w", encoding="utf-8") as f:
        f.write(LDBC_SCHEMA)
    return stats
