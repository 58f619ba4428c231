"""Mutation execution: NQuads → UID assignment → DirectedEdges → store.

Copy of dgraph_tpu/query/mutation.py for the PyTorch port.

Reference semantics:
  - query/mutation.go:111 AssignUids — collect blank ("_:x") nodes, lease a
    UID block from Zero, return the name→uid map.
  - query/mutation.go:169 ToInternal — NQuad → DirectedEdge (uid parse, typed
    object values, star deletes).
  - query/mutation.go:19-46 ApplyMutations / expandEdges — `S * *` deletes
    expand to one DEL_ALL edge per predicate the subject has data for.
  - edgraph/nquads_from_json.go — JSON mutation format: arbitrary objects →
    NQuads with `uid` linking, facet keys ("pred|facet"), geo detection,
    language-tagged keys ("name@fr").

Redesign notes: the reference fans edges out per-group over gRPC
(worker/mutation.go populateMutationMap); here application is a host-side
loop into the posting store — the device only ever sees committed snapshot
CSRs (SURVEY.md §7 stance: mutations are host work, reads are device work).
"""

from __future__ import annotations

from typing import Any, Iterable

from dgraph_tpu_torch.query import rdf
from dgraph_tpu_torch.storage import index as idx
from dgraph_tpu_torch.storage import keys as K
from dgraph_tpu_torch.storage.postings import DirectedEdge, Op
from dgraph_tpu_torch.storage.store import Store
from dgraph_tpu_torch.utils.types import TypeID, Val, convert, parse_datetime


class MutationError(ValueError):
    pass


def parse_uid(s: str) -> int:
    """'0x1' / '123' → int uid (reference gql/mutation.go ParseUid)."""
    try:
        u = int(s, 0)
    except ValueError:
        raise MutationError(f"invalid uid {s!r}")
    if u <= 0:
        raise MutationError(f"invalid uid {s!r} (must be > 0)")
    return u


def assign_uids(nquads: Iterable[rdf.NQuad], zero_uids) -> dict[str, int]:
    """Lease uids for blank nodes (reference AssignUids, query/mutation.go:111).

    Explicit uids in the same mutation advance the lease first, so a leased
    blank-node uid can never collide with a client-chosen `<0x..>` uid."""
    blanks: list[str] = []
    seen: set[str] = set()
    max_explicit = 0
    for nq in nquads:
        for name in (nq.subject, nq.object_id):
            if not name:
                continue
            if name.startswith("_:"):
                if name not in seen:
                    seen.add(name)
                    blanks.append(name)
            else:
                max_explicit = max(max_explicit, parse_uid(name))
    if max_explicit:
        zero_uids.bump_to(max_explicit)
    if not blanks:
        return {}
    start, _end = zero_uids.assign(len(blanks))
    return {b: start + i for i, b in enumerate(blanks)}


def to_edges(nquads: Iterable[rdf.NQuad], uid_map: dict[str, int],
             op: Op = Op.SET) -> list[DirectedEdge]:
    """NQuads → DirectedEdges (reference ToInternal, query/mutation.go:169).

    `S P *` becomes a DEL_ALL edge; `S * *` keeps attr="*" and is expanded
    against the store by apply_mutations (expandEdges analog).
    """
    edges: list[DirectedEdge] = []
    for nq in nquads:
        if nq.subject_var or nq.object_var or nq.val_var:
            raise MutationError(
                "uid(v)/val(v) terms are only valid inside an upsert block")
        subject = uid_map[nq.subject] if nq.subject.startswith("_:") \
            else parse_uid(nq.subject)
        eop = op
        if nq.star:
            if op != Op.DEL:
                raise MutationError("* object is only valid in delete")
            eop = Op.DEL_ALL
        if nq.object_id:
            obj = uid_map[nq.object_id] if nq.object_id.startswith("_:") \
                else parse_uid(nq.object_id)
            edges.append(DirectedEdge(subject, nq.predicate, object_uid=obj,
                                      op=eop, lang=nq.lang,
                                      facets=tuple(nq.facets)))
        else:
            edges.append(DirectedEdge(subject, nq.predicate,
                                      value=nq.object_value, op=eop,
                                      lang=nq.lang, facets=tuple(nq.facets)))
    return edges


def expand_edges(store: Store, edges: list[DirectedEdge]) -> list[DirectedEdge]:
    """Expand `S * *` into per-predicate DEL_ALL edges (mutation.go:46)."""
    out: list[DirectedEdge] = []
    for e in edges:
        if e.attr == "*":
            if e.op != Op.DEL_ALL:
                raise MutationError("predicate * requires object *")
            for attr in store.predicates():
                pl = store.get_no_store(K.data_key(attr, e.subject))
                if pl is not None:
                    out.append(DirectedEdge(e.subject, attr, op=Op.DEL_ALL))
        else:
            out.append(e)
    return out


def _validate_and_convert(store: Store, e: DirectedEdge) -> DirectedEdge:
    """Coerce the edge's value to the schema's scalar type (reference
    ValidateAndConvert, worker/mutation.go:243): `_:a <age> "30" .` under
    `age: int` stores an INT, so index tokens, sort keys, and output all see
    the declared type. Unconvertible values reject the mutation."""
    entry = store.schema.get(e.attr)
    if entry is None or e.value is None or e.op == Op.DEL_ALL:
        return e
    want = entry.type_id
    if want in (TypeID.DEFAULT, TypeID.UID) or e.value.tid == want:
        if e.value.tid == TypeID.VECTOR:
            _check_vector(entry, e.value)
        return e
    try:
        v = convert(e.value, want)
    except ValueError as ex:
        raise MutationError(
            f"cannot convert value {e.value.value!r} for predicate "
            f"{e.attr!r} to schema type {want.name.lower()}: {ex}") from None
    if v.tid == TypeID.VECTOR:
        _check_vector(entry, v)
    return DirectedEdge(e.subject, e.attr, value=v, op=e.op, lang=e.lang,
                        facets=e.facets)


def _check_vector(entry, v: Val) -> None:
    """Typed client error for a vector literal that violates the schema's
    @index(vector(dim: D)) declaration. NaN/Inf components are rejected at
    parse time (types.parse_vector) — a poisoned row would corrupt every
    similarity score it touches."""
    if entry.vector is not None and len(v.value) != entry.vector.dim:
        raise MutationError(
            f"vector for predicate {entry.predicate!r} has dimension "
            f"{len(v.value)}, schema declares dim {entry.vector.dim}")


def split_edges_by_group(edges, n_groups: int, owner_fn) -> dict[int, list]:
    """populateMutationMap (worker/mutation.go:470): group a txn's edges by
    owning tablet; `S * *` deletes fan to EVERY group (each expands against
    its own predicates). Shared by the in-process cluster and the networked
    fan-out so the two write paths can't drift."""
    by_group: dict[int, list] = {}
    for e in edges:
        if e.attr == "*":
            for g in range(n_groups):
                by_group.setdefault(g, []).append(e)
            continue
        by_group.setdefault(owner_fn(e.attr), []).append(e)
    return by_group


def apply_mutations(store: Store, edges: list[DirectedEdge],
                    start_ts: int) -> tuple[list[bytes], list[bytes], set[str]]:
    """Buffer edges under start_ts with index/reverse/count maintenance.

    Returns (all touched key bytes, conflict key bytes, touched predicates).
    All touched keys are needed at commit time to promote the txn's layers;
    the conflict subset feeds the oracle's SSI check: DATA and REVERSE keys
    always; INDEX keys only for @upsert predicates (shared token rows would
    otherwise serialize unrelated writers); COUNT bucket keys never (they are
    per-degree shared rows). Reference: posting/mvcc.go:222 Fill + the
    @upsert directive contract.
    """
    touched_all: list[bytes] = []
    conflict: list[bytes] = []
    preds: set[str] = set()
    # validate as a pre-pass so a bad value rejects the WHOLE mutation before
    # any edge is buffered (reference ValidateAndConvert runs over all edges
    # first) — no orphaned uncommitted layers on error
    expanded = [_validate_and_convert(store, e)
                for e in expand_edges(store, edges)]
    for e in expanded:
        touched = idx.add_mutation_with_index(store, e, start_ts)
        preds.add(e.attr)
        entry = store.schema.get(e.attr)
        upsert = bool(entry is not None and entry.upsert)
        touched_all.extend(touched)
        for kb in touched:
            kind = K.KeyKind(kb[0])
            if kind in (K.KeyKind.DATA, K.KeyKind.REVERSE):
                conflict.append(kb)
            elif kind == K.KeyKind.INDEX and upsert:
                conflict.append(kb)
    return touched_all, conflict, preds


# ---------------------------------------------------------------------------
# JSON mutation format (edgraph/nquads_from_json.go)
# ---------------------------------------------------------------------------

def _is_geo(v: dict) -> bool:
    return isinstance(v, dict) and "type" in v and "coordinates" in v and \
        v.get("type") in ("Point", "Polygon", "MultiPolygon")


def _scalar_val(v: Any) -> Val:
    if isinstance(v, bool):
        return Val(TypeID.BOOL, v)
    if isinstance(v, int):
        return Val(TypeID.INT, v)
    if isinstance(v, float):
        return Val(TypeID.FLOAT, v)
    if isinstance(v, dict) and _is_geo(v):
        from dgraph_tpu_torch.utils import geo as geomod
        import json as _json

        return Val(TypeID.GEO, geomod.parse_geojson(_json.dumps(v)))
    if isinstance(v, str):
        # datetime detection mirrors the reference's time.Parse probe
        if len(v) >= 10 and v[:4].isdigit() and v[4:5] == "-":
            try:
                return Val(TypeID.DATETIME, parse_datetime(v))
            except ValueError:
                pass
        return Val(TypeID.DEFAULT, v)
    raise MutationError(f"unsupported JSON value {v!r}")


def nquads_from_json(obj: Any, op: Op = Op.SET,
                     schema=None) -> list[rdf.NQuad]:
    """JSON object(s) → NQuads (reference edgraph/nquads_from_json.go).

    - "uid" field names the node ("0x1", or "_:b" blanks); absent → a fresh
      blank node is minted.
    - nested objects / lists of objects become uid edges.
    - "pred|facet" keys attach facets to the sibling "pred" edge.
    - in delete mode a null value means "delete all values of pred"
      (S P * star), and {"uid": u} alone means delete the whole node (S * *).
    - with `schema` (a SchemaState), a JSON number array under a
      float32vector predicate becomes ONE vector literal instead of
      per-element scalar quads (NaN components and empty arrays reject
      with a typed error; dim is checked downstream against the schema).
    """
    out: list[rdf.NQuad] = []
    counter = [0]
    items = obj if isinstance(obj, list) else [obj]
    for item in items:
        if not isinstance(item, dict):
            raise MutationError("JSON mutation must be an object or list of objects")
        _json_node(item, op, counter, out, schema)
    return out


def _is_vector_pred(schema, pred: str) -> bool:
    if schema is None:
        return False
    e = schema.get(pred)
    return e is not None and e.type_id == TypeID.VECTOR


def _vector_val(v) -> Val:
    from dgraph_tpu_torch.utils.types import parse_vector

    try:
        return Val(TypeID.VECTOR, parse_vector(v))
    except ValueError as ex:
        raise MutationError(f"bad vector value: {ex}") from None


def _json_node(obj: dict, op: Op, counter: list[int],
               out: list[rdf.NQuad], schema=None) -> str:
    """Emit one object's NQuads; returns its uid / blank-node name."""
    uid = obj.get("uid")
    if uid is None or uid == "":
        if op == Op.DEL:
            raise MutationError("delete mutation needs an explicit uid")
        counter[0] += 1
        uid = f"_:json-{counter[0]}"
    else:
        uid = str(uid)

    fields = {k: v for k, v in obj.items() if k != "uid"}
    if op == Op.DEL and not fields:
        out.append(rdf.NQuad(subject=uid, predicate="*", star=True))
        return uid

    # facets grouped by their base predicate
    facet_map: dict[str, list[tuple[str, Val]]] = {}
    for k, v in list(fields.items()):
        if "|" in k:
            base, fname = k.split("|", 1)
            facet_map.setdefault(base, []).append((fname, _scalar_val(v)))
            del fields[k]

    for k, v in fields.items():
        pred, _, lang = k.partition("@")
        if v is None:
            if op == Op.DEL:
                out.append(rdf.NQuad(subject=uid, predicate=pred, star=True))
            continue
        facets = facet_map.get(pred, [])
        if isinstance(v, dict) and not _is_geo(v):
            child = _json_node(v, op, counter, out, schema)
            out.append(rdf.NQuad(subject=uid, predicate=pred,
                                 object_id=child, facets=facets))
        elif isinstance(v, list) and v and all(
                isinstance(x, dict) and not _is_geo(x) for x in v):
            for x in v:
                child = _json_node(x, op, counter, out, schema)
                out.append(rdf.NQuad(subject=uid, predicate=pred,
                                     object_id=child, facets=facets))
        elif isinstance(v, list) and _is_vector_pred(schema, pred):
            # float32vector predicate: the JSON array IS one embedding
            out.append(rdf.NQuad(subject=uid, predicate=pred,
                                 object_value=_vector_val(v), lang=lang,
                                 facets=facets))
        elif isinstance(v, list):
            for x in v:
                out.append(rdf.NQuad(subject=uid, predicate=pred,
                                     object_value=_scalar_val(x), lang=lang,
                                     facets=facets))
        else:
            out.append(rdf.NQuad(subject=uid, predicate=pred,
                                 object_value=_scalar_val(v), lang=lang,
                                 facets=facets))
    return uid
