"""Load a generated data set into a serving Node through the port's store.

A copy of chip_smoke.py's `encoded_keys`, `packed_rows` and `packed_store`
path, frozen here: each posting list is packed by the port's native codec
(`storage.native.pack_many`) and the lists go into the Node's own in-memory
Store with `Store.bulk_install`, as loader/bulk.py's reduce installs them.
The install takes a commit timestamp leased from the Node's oracle, so every
read the Node serves after it sees the data; the uid lease moves past the
largest uid. Index keys come from the port's tokenizer (`index_tokens`).
"""

from __future__ import annotations

import time

import numpy as np


def encoded_keys(make, attr: str, uids) -> list[bytes]:
    """Encoded keys of one kind for many uids: the key's head once and the
    uid as 8 big-endian bytes (checked against storage/keys.py)."""
    head = make(attr, 0).encode()[:-8]
    raw = np.asarray(uids, dtype=">u8").tobytes()
    out = [head + raw[i: i + 8] for i in range(0, len(raw), 8)]
    if out and out[-1] != make(attr, int(uids[-1])).encode():
        raise RuntimeError("key layout differs from storage/keys.py")
    return out


def rows_of(src: np.ndarray, dst: np.ndarray):
    """(subjects, rows) of an edge list sorted by (src, dst)."""
    subjects, starts = np.unique(src, return_index=True)
    return subjects, np.split(dst.astype(np.uint64), starts[1:])


def install(node, data: dict) -> dict:
    """Put `data` (a generator's output) into `node`; returns the seconds
    of each step."""
    from dgraph_tpu_torch.storage import keys as K
    from dgraph_tpu_torch.storage import native
    from dgraph_tpu_torch.storage.index import index_tokens
    from dgraph_tpu_torch.storage.postings import (VALUE_UID, Op, Posting,
                                                   PostingList)
    from dgraph_tpu_torch.utils.types import Val

    if not native.available():
        raise RuntimeError("the port's native codec did not build")
    secs: dict = {}
    t0 = time.perf_counter()
    node.alter(data["schema"])
    schema = node.store.schema
    keys: list[bytes] = []
    rows: list[np.ndarray] = []
    for attr, (src, dst) in data["edges"].items():
        s, d = src.cpu().numpy(), dst.cpu().numpy()
        subjects, r = rows_of(s, d)
        keys += encoded_keys(K.data_key, attr, subjects)
        rows += r
        if schema.get(attr).reverse:
            order = np.lexsort((s, d))
            subjects, r = rows_of(d[order], s[order])
            keys += encoded_keys(K.reverse_key, attr, subjects)
            rows += r
    secs["uid_rows"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    values: dict[bytes, Posting] = {}
    uids = np.arange(1, data["n"] + 1, dtype=np.int64)
    for attr, column in data["values"].items():
        entry = schema.get(attr)
        tid = entry.type_id
        vals = [Val(tid, v) for v in column]
        values.update(zip(encoded_keys(K.data_key, attr, uids),
                          (Posting(VALUE_UID, Op.SET, v) for v in vals)))
        if entry.indexed:
            by_token: dict[bytes, list[int]] = {}
            for u, v in zip(uids.tolist(), vals):
                for tk in index_tokens(entry, v):
                    by_token.setdefault(tk, []).append(u)
            for tk, members in by_token.items():
                keys.append(K.index_key(attr, tk).encode())
                rows.append(np.asarray(members, dtype=np.uint64))
    secs["value_rows"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed = native.pack_many(rows)
    del rows
    secs["pack"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    def posting_list(pu, postings):
        pl = PostingList()
        pl.base_postings = postings
        pl.base_packed = pu
        return pl

    lists = {kb: posting_list(pu, {}) for kb, pu in zip(keys, packed)}
    if values:
        (shared,) = native.pack_many([np.asarray([VALUE_UID], np.uint64)])
        lists.update((kb, posting_list(shared, {VALUE_UID: post}))
                     for kb, post in values.items())
    ts = node.zero.oracle.timestamps(1)
    for pl in lists.values():
        pl.base_ts = ts
    node.store.bulk_install(lists, ts)
    node.zero.uids.bump_to(data["n"])
    secs["install"] = time.perf_counter() - t0
    return secs
