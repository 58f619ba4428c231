"""Secondary index maintenance, synchronous with mutations.

Copy of dgraph_tpu/storage/index.py for the PyTorch port.

Reference semantics: posting/index.go — indexTokens runs the schema's
tokenizers (:44); addIndexMutation writes subject uids into IndexKey(attr,
token) posting lists (:120); reverse-edge mutations mirror uid edges under
ReverseKey (:190); count-index mutations move subjects between
CountKey(attr, n) buckets as their degree changes (:283-326);
AddMutationWithIndex orchestrates data + index + reverse + count edits under
one transaction (:377); full rebuilds iterate the data tablet and re-tokenize
(:609-839).
"""

from __future__ import annotations

from dgraph_tpu_torch.storage import keys as K
from dgraph_tpu_torch.storage.postings import DirectedEdge, Op, Posting
from dgraph_tpu_torch.storage.store import Store
from dgraph_tpu_torch.utils import tok
from dgraph_tpu_torch.utils.schema import SchemaEntry
from dgraph_tpu_torch.utils.types import TypeID, Val, convert


def index_tokens(entry: SchemaEntry, v: Val, lang: str = "") -> list[bytes]:
    """All index terms for a value under a predicate's tokenizers
    (reference posting/index.go:44 indexTokens). The lang tag selects the
    full-text analyzer (tok/fts.go) — index and query must agree."""
    out: list[bytes] = []
    for name in entry.tokenizers:
        tz = tok.get(name)
        if name == "fulltext" and lang:
            out.extend(bytes([tz.ident]) + t
                       for t in tok.fulltext_tokens(str(v.value), lang))
            continue
        sv = convert(v, tz.type_id) if v.tid != tz.type_id else v
        out.extend(tz.tokens(sv))
    return out


def _edge_val(edge: DirectedEdge, entry: SchemaEntry) -> Val | None:
    if edge.value is None:
        return None
    if entry.type_id not in (TypeID.DEFAULT, edge.value.tid):
        return convert(edge.value, entry.type_id)
    return edge.value


def add_mutation_with_index(store: Store, edge: DirectedEdge, start_ts: int) -> list[bytes]:
    """Apply one edge with all derived index/reverse/count mutations.

    Returns the conflict-relevant key bytes touched (fed to the transaction
    context for SSI conflict detection, posting/mvcc.go:222 Fill).
    """
    attr = edge.attr
    inferred = edge.value.tid if edge.value is not None else TypeID.UID
    entry = store.schema.ensure(attr, inferred)
    data_k = K.data_key(attr, edge.subject)
    pl = store.get(data_k)
    touched = [data_k.encode()]

    old_count = len(pl.uids(start_ts, own_start_ts=start_ts)) if entry.count else 0

    # index edits for value predicates
    if entry.indexed:
        if edge.op == Op.DEL_ALL:
            for p in pl.postings(start_ts, own_start_ts=start_ts):
                if p.value is not None:
                    _index_edit(store, entry, p.value, edge.subject,
                                start_ts, Op.DEL, touched, lang=p.lang)
        elif edge.value is not None:
            new_val = _edge_val(edge, entry)
            if entry.is_list:
                # list-valued scalars accumulate; only an explicit DEL of one
                # value removes that value's tokens
                _index_edit(store, entry, new_val, edge.subject, start_ts,
                            edge.op, touched, lang=edge.lang)
            else:
                # single-valued: the old value lives in exactly this slot —
                # a lang-agnostic read here would wrongly delete another
                # language's (or the untagged) index terms
                from dgraph_tpu_torch.storage.postings import lang_uid

                old_val = pl.value_for_slot(start_ts, lang_uid(edge.lang),
                                            own_start_ts=start_ts)
                if old_val is not None:
                    _index_edit(store, entry, old_val, edge.subject, start_ts,
                                Op.DEL, touched, lang=edge.lang)
                if edge.op == Op.SET:
                    _index_edit(store, entry, new_val, edge.subject, start_ts,
                                Op.SET, touched, lang=edge.lang)
                elif edge.op == Op.DEL and old_val is None:
                    _index_edit(store, entry, new_val, edge.subject, start_ts,
                                Op.DEL, touched, lang=edge.lang)

    # reverse edges (uid predicates with @reverse)
    if entry.reverse and edge.value is None and edge.op != Op.DEL_ALL:
        rk = K.reverse_key(attr, edge.object_uid)
        store.add_mutation(start_ts, rk, Posting(edge.subject, edge.op))
        touched.append(rk.encode())
    if entry.reverse and edge.op == Op.DEL_ALL:
        for obj in pl.uids(start_ts, own_start_ts=start_ts):
            rk = K.reverse_key(attr, int(obj))
            store.add_mutation(start_ts, rk, Posting(edge.subject, Op.DEL))
            touched.append(rk.encode())

    # the data edge itself
    store.add_mutation(start_ts, data_k, edge.to_posting(is_list=entry.is_list))

    # count index: move subject between degree buckets
    if entry.count:
        new_count = len(pl.uids(start_ts, own_start_ts=start_ts))
        if new_count != old_count:
            ck_old = K.count_key(attr, old_count)
            ck_new = K.count_key(attr, new_count)
            store.add_mutation(start_ts, ck_old, Posting(edge.subject, Op.DEL))
            store.add_mutation(start_ts, ck_new, Posting(edge.subject, Op.SET))
            touched += [ck_old.encode(), ck_new.encode()]

    return touched


def _index_edit(store: Store, entry: SchemaEntry, v: Val | None, subject: int,
                start_ts: int, op: Op, touched: list[bytes],
                lang: str = "") -> None:
    if v is None:
        return
    for term in index_tokens(entry, v, lang):
        ik = K.index_key(entry.predicate, term)
        store.add_mutation(start_ts, ik, Posting(subject, op))
        touched.append(ik.encode())


# ---------------------------------------------------------------------------
# Full rebuilds (reference posting/index.go:609-839)
# ---------------------------------------------------------------------------

def rebuild_index(store: Store, attr: str, read_ts: int, commit_ts: int) -> None:
    """Drop and rebuild the token index of a predicate from its data tablet."""
    entry = store.schema.get(attr)
    if entry is None or not entry.indexed:
        return
    store.drop_kind(attr, K.KeyKind.INDEX)
    sts = -commit_ts  # synthetic rebuild txn
    for kb in store.keys_of(K.KeyKind.DATA, attr):
        key = K.parse_key(kb)
        for p in store.lists[kb].postings(read_ts):
            if p.value is not None:
                _index_edit(store, entry, p.value, key.uid, sts, Op.SET, [],
                            lang=p.lang)
    _commit_synthetic(store, attr, K.KeyKind.INDEX, sts, commit_ts)


def rebuild_reverse(store: Store, attr: str, read_ts: int, commit_ts: int) -> None:
    entry = store.schema.get(attr)
    if entry is None or not entry.reverse:
        return
    store.drop_kind(attr, K.KeyKind.REVERSE)
    sts = -commit_ts
    for kb in store.keys_of(K.KeyKind.DATA, attr):
        key = K.parse_key(kb)
        for obj in store.lists[kb].uids(read_ts):
            store.add_mutation(sts, K.reverse_key(attr, int(obj)), Posting(key.uid, Op.SET))
    _commit_synthetic(store, attr, K.KeyKind.REVERSE, sts, commit_ts)


def rebuild_count(store: Store, attr: str, read_ts: int, commit_ts: int) -> None:
    entry = store.schema.get(attr)
    if entry is None or not entry.count:
        return
    store.drop_kind(attr, K.KeyKind.COUNT)
    sts = -commit_ts
    for kb in store.keys_of(K.KeyKind.DATA, attr):
        key = K.parse_key(kb)
        n = store.lists[kb].length(read_ts)
        if n:
            store.add_mutation(sts, K.count_key(attr, n), Posting(key.uid, Op.SET))
    _commit_synthetic(store, attr, K.KeyKind.COUNT, sts, commit_ts)


def _commit_synthetic(store: Store, attr: str, kind: K.KeyKind,
                      start_ts: int, commit_ts: int) -> None:
    store.commit(start_ts, commit_ts, store.keys_of(kind, attr))


def needs_reindex(old: SchemaEntry | None, new: SchemaEntry) -> bool:
    """Schema change requires an index rebuild (worker/mutation.go:199)."""
    if old is None:
        return bool(new.tokenizers or new.reverse or new.count or new.vector)
    return (set(old.tokenizers) != set(new.tokenizers)
            or old.reverse != new.reverse
            or old.count != new.count
            or old.type_id != new.type_id
            or old.vector != new.vector)
