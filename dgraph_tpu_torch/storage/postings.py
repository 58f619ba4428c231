"""Posting slots of value postings.

Port of the slot helpers of dgraph_tpu/storage/postings.py (the MVCC
posting lists wait for the storage slice). A value posting lives at a slot
of its subject's posting list: VALUE_UID for the untagged value, lang_uid
for a language-tagged one, value_fingerprint for each value of a [type]
list predicate. Facets on value postings are keyed by (subject, slot).
"""

from __future__ import annotations

import hashlib

from dgraph_tpu_torch.utils.types import Val, marshal

# uid slot used by non-lang value postings (reference uses math.MaxUint64 for
# the value fingerprint; we reserve 0 — real uids start at 1).
VALUE_UID = 0


def lang_uid(lang: str) -> int:
    """Fingerprint for @lang value postings (stable per language tag)."""
    if not lang:
        return VALUE_UID
    h = int.from_bytes(hashlib.blake2b(lang.encode(), digest_size=7).digest(), "big")
    return h | (1 << 60)  # keep clear of real uid space


def value_fingerprint(v: Val) -> int:
    """Posting slot for one value of a list-valued scalar predicate
    (reference: multi-valued postings keyed by value fingerprint)."""
    raw = bytes([int(v.tid)]) + marshal(v)
    h = int.from_bytes(hashlib.blake2b(raw, digest_size=7).digest(), "big")
    return h | (1 << 61)  # distinct from lang (1<<60) and uid space
