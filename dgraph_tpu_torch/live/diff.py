"""Canonical result serialization + JSON diffs for live queries.

Copy of dgraph_tpu/live/diff.py for the PyTorch port.

A live notification must be verifiable: "byte-identical to re-running the
query at the carried watermark" is only testable if both sides serialize
the same way. `canon()` is that one serialization — sorted keys, no
whitespace — used by the manager for change detection, by the SSE surface
for the wire bytes, and by the correctness gates in tests/smoke.

Diffs are computed per top-level query block (the root keys of a DQL
result). Entries that carry a `uid` are matched BY uid — an entry whose
uid persists but whose body changed reports as `changed` — while uid-less
entries (aggregates, @groupby buckets, var blocks) are matched as a
multiset of canonical encodings: those rows have no identity, so a
modification is an add+remove pair. This mirrors what a feed consumer
actually wants: patch-by-key when keys exist, replace-by-value when not.
"""

from __future__ import annotations

import json
from collections import Counter


def canon(obj) -> str:
    """THE canonical encoding of a query result. Every byte-identity
    check in the subsystem compares exactly this."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str)


def _entry_uid(e):
    if isinstance(e, dict):
        return e.get("uid")
    return None


def _block_diff(old: list, new: list) -> dict | None:
    """added/removed/changed for one result block's entry list."""
    old_by_uid: dict = {}
    new_by_uid: dict = {}
    old_anon: Counter = Counter()
    new_anon: Counter = Counter()
    for e in old:
        u = _entry_uid(e)
        if u is not None:
            old_by_uid[u] = e
        else:
            old_anon[canon(e)] += 1
    for e in new:
        u = _entry_uid(e)
        if u is not None:
            new_by_uid[u] = e
        else:
            new_anon[canon(e)] += 1
    added, removed, changed = [], [], []
    for u, e in new_by_uid.items():
        o = old_by_uid.get(u)
        if o is None:
            added.append(e)
        elif canon(o) != canon(e):
            changed.append(e)
    for u, e in old_by_uid.items():
        if u not in new_by_uid:
            removed.append(e)
    for c, n in (new_anon - old_anon).items():
        added.extend([json.loads(c)] * n)
    for c, n in (old_anon - new_anon).items():
        removed.extend([json.loads(c)] * n)
    if not (added or removed or changed):
        return None
    return {"added": added, "removed": removed, "changed": changed}


def result_diff(old: dict | None, new: dict) -> dict | None:
    """Per-block diff of two query results; None when nothing changed.
    Non-list block values (explain payloads are rejected at subscribe
    time, but schema-ish scalars could appear) diff as whole-value
    `changed` entries."""
    old = old or {}
    out: dict = {}
    for block in sorted(set(old) | set(new)):
        ov, nv = old.get(block), new.get(block)
        if isinstance(ov, list) or isinstance(nv, list):
            d = _block_diff(ov if isinstance(ov, list) else [],
                            nv if isinstance(nv, list) else [])
        elif canon(ov) != canon(nv):
            d = {"added": [], "removed": [], "changed": [nv]}
        else:
            d = None
        if d is not None:
            out[block] = d
    return out or None
