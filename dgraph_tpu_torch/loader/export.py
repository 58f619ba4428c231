"""RDF export: posting store → N-Quads (+ schema file), gzip-able.

Copy of dgraph_tpu/loader/export.py for the PyTorch port, over the port's
Store; the bytes it writes are the JAX export's for the same store.

Reference semantics: worker/export.go:198-359 — each group's leader walks
its tablets converting posting lists back to N-Quads (uids as <0x..>, typed
literals, lang tags, facets) plus a schema file, gzipped. Here the walk is
over the store's DATA tablets at a read_ts; output round-trips through the
bulk loader to an identical store (the JAX package's tests/test_loader.py).
"""

from __future__ import annotations

import base64
import gzip
from dataclasses import dataclass

from dgraph_tpu_torch.storage import keys as K
from dgraph_tpu_torch.storage.postings import VALUE_UID
from dgraph_tpu_torch.storage.store import Store
from dgraph_tpu_torch.utils.types import TypeID, Val, marshal

_TYPE_TAG = {
    TypeID.INT: "xs:int",
    TypeID.FLOAT: "xs:float",
    TypeID.BOOL: "xs:boolean",
    TypeID.DATETIME: "xs:dateTime",
    TypeID.STRING: "xs:string",
    TypeID.GEO: "geo:geojson",
    TypeID.PASSWORD: "pwd:hashed",     # raw hash — re-imports without re-hash
    TypeID.BINARY: "xs:base64Binary",
    TypeID.VECTOR: "xs:float32vector",
}


def _escape(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n").replace("\t", "\\t"))


def _val_literal(v: Val, lang: str) -> str:
    if v.tid == TypeID.DEFAULT:
        body = f'"{_escape(str(v.value))}"'
        return body + (f"@{lang}" if lang else "")
    if v.tid == TypeID.BINARY:
        text = base64.b64encode(marshal(v)).decode("ascii")
    elif v.tid == TypeID.BOOL:
        text = "true" if v.value else "false"
    elif v.tid == TypeID.DATETIME:
        text = v.value.isoformat()
    elif v.tid == TypeID.GEO:
        import json

        text = json.dumps(v.value, separators=(",", ":"))
    elif v.tid == TypeID.VECTOR:
        from dgraph_tpu_torch.utils.types import vector_str

        text = vector_str(v.value)
    else:
        text = str(v.value)
    if lang:
        return f'"{_escape(text)}"@{lang}'
    return f'"{_escape(text)}"^^<{_TYPE_TAG[v.tid]}>'


def _facet_str(facets) -> str:
    parts = []
    for name, fv in facets:
        if fv.tid == TypeID.BOOL:
            parts.append(f"{name}={'true' if fv.value else 'false'}")
        elif fv.tid == TypeID.DATETIME:
            parts.append(f"{name}={fv.value.isoformat()}")
        elif fv.tid in (TypeID.INT, TypeID.FLOAT):
            parts.append(f"{name}={fv.value}")
        else:
            # strings (and anything else) quoted + escaped so the facet
            # grammar round-trips quotes, commas, and parens
            parts.append(f'{name}="{_escape(str(fv.value))}"')
    return " (" + ", ".join(parts) + ")"


@dataclass
class ExportStats:
    quads: int = 0
    predicates: int = 0


def export_rdf(store: Store, out_path: str, read_ts: int | None = None,
               schema_path: str | None = None) -> ExportStats:
    """Write every visible posting at read_ts as N-Quads."""
    read_ts = read_ts if read_ts is not None else store.max_seen_commit_ts
    stats = ExportStats()
    op = gzip.open if out_path.endswith(".gz") else open
    attrs = store.predicates()
    with op(out_path, "wt", encoding="utf-8") as f:
        for attr in attrs:
            stats.predicates += 1
            pred = f"<{attr}>"
            for kb in store.keys_of(K.KeyKind.DATA, attr):
                key = K.parse_key(kb)
                subj = f"<0x{key.uid:x}>"
                for p in store.lists[kb].postings(read_ts):
                    fac = _facet_str(p.facets) if p.facets else ""
                    if p.value is None:
                        if p.uid == VALUE_UID:
                            continue   # placeholder
                        f.write(f"{subj} {pred} <0x{p.uid:x}>{fac} .\n")
                    else:
                        f.write(f"{subj} {pred} "
                                f"{_val_literal(p.value, p.lang)}{fac} .\n")
                    stats.quads += 1
    if schema_path:
        with open(schema_path, "w") as f:
            f.write(store.schema.to_text())
    return stats
