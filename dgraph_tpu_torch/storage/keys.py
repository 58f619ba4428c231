"""Storage key scheme.

Copy of dgraph_tpu/storage/keys.py for the PyTorch port.

Reference semantics: x/keys.go — one byte space per key kind (data / index /
reverse / count / schema), attr-prefixed so all keys of one predicate are
contiguous and a "tablet" (unit of shard placement) is a contiguous key range
(x/keys.go:25-121, SURVEY.md §2.1).

This build keys the host-side segment store the same way, but with its own
encoding: kind byte, big-endian u32 attr length, attr utf8, then a
kind-specific payload. uids are encoded big-endian so lexicographic order ==
numeric order (needed for range scans / predicate iteration).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from enum import IntEnum


class KeyKind(IntEnum):
    DATA = 0x00      # (attr, subject uid)   -> object uids / value posting
    INDEX = 0x02     # (attr, token)         -> subject uids
    REVERSE = 0x04   # (attr, object uid)    -> subject uids
    COUNT = 0x08     # (attr, rev, count)    -> subject uids with that degree
    SCHEMA = 0x10    # (attr,)               -> schema entry


_U64 = struct.Struct(">Q")
_U32 = struct.Struct(">I")


@dataclass(frozen=True)
class Key:
    kind: KeyKind
    attr: str
    uid: int = 0          # DATA / REVERSE
    term: bytes = b""     # INDEX (tokenizer-id-prefixed token)
    count: int = 0        # COUNT
    reverse: bool = False  # COUNT on reverse edges

    def encode(self) -> bytes:
        a = self.attr.encode("utf-8")
        head = bytes([self.kind]) + _U32.pack(len(a)) + a
        if self.kind in (KeyKind.DATA, KeyKind.REVERSE):
            return head + _U64.pack(self.uid)
        if self.kind == KeyKind.INDEX:
            return head + self.term
        if self.kind == KeyKind.COUNT:
            return head + bytes([1 if self.reverse else 0]) + _U32.pack(self.count)
        return head  # SCHEMA


def data_key(attr: str, uid: int) -> Key:
    return Key(KeyKind.DATA, attr, uid=uid)


def reverse_key(attr: str, uid: int) -> Key:
    return Key(KeyKind.REVERSE, attr, uid=uid)


def index_key(attr: str, term: bytes) -> Key:
    return Key(KeyKind.INDEX, attr, term=term)


def count_key(attr: str, count: int, reverse: bool = False) -> Key:
    return Key(KeyKind.COUNT, attr, count=count, reverse=reverse)


def schema_key(attr: str) -> Key:
    return Key(KeyKind.SCHEMA, attr)


def kind_attr_of(b: bytes) -> tuple[int, str]:
    """Fast partial parse — just (kind, attr), no Key object. Hot in snapshot
    load and uid-lease recovery, which touch every key once."""
    (alen,) = _U32.unpack_from(b, 1)
    return b[0], b[5: 5 + alen].decode("utf-8")


def uid_of(b: bytes) -> int:
    """Subject/object uid of a DATA/REVERSE key without a full parse."""
    return _U64.unpack(b[-8:])[0]


def parse_key(b: bytes) -> Key:
    """Inverse of Key.encode (reference: x/keys.go:253 Parse)."""
    kind = KeyKind(b[0])
    (alen,) = _U32.unpack_from(b, 1)
    attr = b[5 : 5 + alen].decode("utf-8")
    rest = b[5 + alen :]
    if kind in (KeyKind.DATA, KeyKind.REVERSE):
        (uid,) = _U64.unpack(rest)
        return Key(kind, attr, uid=uid)
    if kind == KeyKind.INDEX:
        return Key(kind, attr, term=rest)
    if kind == KeyKind.COUNT:
        rev = rest[0] == 1
        (cnt,) = _U32.unpack_from(rest, 1)
        return Key(kind, attr, count=cnt, reverse=rev)
    return Key(kind, attr)


def predicate_prefix(attr: str, kind: KeyKind | None = None) -> bytes:
    """Prefix covering all keys of a predicate (one kind, or every kind when
    iterating a whole tablet for e.g. predicate move / export).

    Reference: x/keys.go:189-251 prefix helpers.
    """
    a = attr.encode("utf-8")
    if kind is None:
        raise ValueError("kind required; iterate kinds explicitly for a full tablet scan")
    return bytes([kind]) + _U32.pack(len(a)) + a
