"""Value type system: scalar types, conversion matrix, comparison.

Copy of dgraph_tpu/utils/types.py for the PyTorch port, cut to what the
uid-traversal slice reads (TypeID, Val, convert, compare_vals, sort_key).
Reference semantics: types/ — 10 scalar types (types/scalar_types.go:35-44),
the conversion matrix (types/conversion.go), ordering (types/compare.go,
types/sort.go). Geo values raise NotImplementedError until the geo slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime, timezone
from enum import IntEnum
from typing import Any


class TypeID(IntEnum):
    DEFAULT = 0
    BINARY = 1
    INT = 2
    FLOAT = 3
    BOOL = 4
    DATETIME = 5
    STRING = 6
    GEO = 7
    UID = 8
    PASSWORD = 9
    VECTOR = 10          # float32vector: dense embedding (tuple of floats)

    @classmethod
    def from_name(cls, name: str) -> "TypeID":
        try:
            return _NAME_TO_TYPE[name.lower()]
        except KeyError:
            raise ValueError(f"unknown type {name!r}") from None


_NAME_TO_TYPE = {
    "default": TypeID.DEFAULT,
    "binary": TypeID.BINARY,
    "int": TypeID.INT,
    "float": TypeID.FLOAT,
    "bool": TypeID.BOOL,
    "datetime": TypeID.DATETIME,
    "string": TypeID.STRING,
    "geo": TypeID.GEO,
    "uid": TypeID.UID,
    "password": TypeID.PASSWORD,
    "float32vector": TypeID.VECTOR,
}

TYPE_NAMES = {v: k for k, v in _NAME_TO_TYPE.items()}


@dataclass(frozen=True)
class Val:
    """A typed value."""

    tid: TypeID
    value: Any

    def __repr__(self) -> str:
        return f"Val({TYPE_NAMES[self.tid]}, {self.value!r})"


# ---------------------------------------------------------------------------
# Parsing / conversion (reference: types/conversion.go Convert)
# ---------------------------------------------------------------------------

_RFC3339_FORMATS = (
    "%Y-%m-%dT%H:%M:%S.%f%z", "%Y-%m-%dT%H:%M:%S%z",
    "%Y-%m-%dT%H:%M:%S.%f", "%Y-%m-%dT%H:%M:%S",
    "%Y-%m-%dT%H:%M", "%Y-%m-%d", "%Y-%m", "%Y",
)


def parse_datetime(s: str) -> datetime:
    for fmt in _RFC3339_FORMATS:
        try:
            dt = datetime.strptime(s, fmt)
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=timezone.utc)
            return dt
        except ValueError:
            continue
    raise ValueError(f"cannot parse datetime {s!r}")


def _check_int64(v: int) -> int:
    if not (-(1 << 63) <= v < (1 << 63)):
        raise ValueError(f"int value {v} outside int64 range")
    return v


def parse_vector(raw) -> tuple[float, ...]:
    """Parse a float32vector literal: a `"[0.1, 0.2, ...]"` string or a
    JSON array of numbers. Values are snapped to float32 (the storage and
    device precision) so WAL/snapshot round-trips are bit-exact; NaN/Inf
    components reject the value — a NaN row would poison every similarity
    score it touches."""
    import math

    if isinstance(raw, str):
        s = raw.strip()
        if not (s.startswith("[") and s.endswith("]")):
            raise ValueError(f"vector literal must be [v1, v2, ...]: {raw!r}")
        body = s[1:-1].strip()
        parts = [p for p in body.split(",") if p.strip()] if body else []
        try:
            xs = [float(p) for p in parts]
        except ValueError:
            raise ValueError(f"bad vector component in {raw!r}") from None
    elif isinstance(raw, (list, tuple)):
        xs = []
        for x in raw:
            if isinstance(x, bool) or not isinstance(x, (int, float)):
                raise ValueError(f"vector component {x!r} is not a number")
            xs.append(float(x))
    else:
        raise ValueError(f"cannot parse vector from {type(raw).__name__}")
    if not xs:
        raise ValueError("empty vector")
    if any(not math.isfinite(x) for x in xs):
        raise ValueError("vector contains NaN/Inf components")
    import numpy as _np

    return tuple(float(x) for x in _np.asarray(xs, dtype=_np.float32))


def vector_str(v: tuple[float, ...]) -> str:
    """Canonical string form of a vector value (repr round-trips float32
    exactly through parse_vector)."""
    return "[" + ", ".join(repr(float(x)) for x in v) + "]"


def convert(src: Val, to: TypeID) -> Val:
    """Convert a value between scalar types; raises ValueError when undefined.

    Mirrors the reference's conversion matrix (types/conversion.go): any type
    converts from its string form and to its string form; numeric types
    interconvert; datetime <-> int (unix seconds) / float.
    """
    if src.tid == to:
        return src
    v = src.value
    try:
        if src.tid in (TypeID.STRING, TypeID.DEFAULT):
            s = str(v)
            if to in (TypeID.STRING, TypeID.DEFAULT):
                return Val(to, s)
            if to == TypeID.INT:
                return Val(to, _check_int64(int(s)))
            if to == TypeID.FLOAT:
                return Val(to, float(s))
            if to == TypeID.BOOL:
                if s.lower() in ("true", "1"):
                    return Val(to, True)
                if s.lower() in ("false", "0"):
                    return Val(to, False)
                raise ValueError(s)
            if to == TypeID.DATETIME:
                return Val(to, parse_datetime(s))
            if to == TypeID.BINARY:
                return Val(to, s.encode("utf-8"))
            if to == TypeID.PASSWORD:
                return Val(to, hash_password(s))
            if to == TypeID.GEO:
                raise geo_unported()
            if to == TypeID.VECTOR:
                return Val(to, parse_vector(s))
        elif src.tid == TypeID.INT:
            if to == TypeID.FLOAT:
                return Val(to, float(v))
            if to == TypeID.BOOL:
                return Val(to, bool(v))
            if to in (TypeID.STRING, TypeID.DEFAULT):
                return Val(to, str(v))
            if to == TypeID.DATETIME:
                return Val(to, datetime.fromtimestamp(v, tz=timezone.utc))
        elif src.tid == TypeID.FLOAT:
            if to == TypeID.INT:
                return Val(to, _check_int64(int(v)))
            if to == TypeID.BOOL:
                return Val(to, bool(v))
            if to in (TypeID.STRING, TypeID.DEFAULT):
                return Val(to, repr(v) if isinstance(v, float) else str(v))
            if to == TypeID.DATETIME:
                return Val(to, datetime.fromtimestamp(v, tz=timezone.utc))
        elif src.tid == TypeID.BOOL:
            if to == TypeID.INT:
                return Val(to, int(v))
            if to == TypeID.FLOAT:
                return Val(to, float(v))
            if to in (TypeID.STRING, TypeID.DEFAULT):
                return Val(to, "true" if v else "false")
        elif src.tid == TypeID.DATETIME:
            if to in (TypeID.STRING, TypeID.DEFAULT):
                return Val(to, v.isoformat())
            if to == TypeID.INT:
                return Val(to, int(v.timestamp()))
            if to == TypeID.FLOAT:
                return Val(to, v.timestamp())
        elif src.tid == TypeID.BINARY:
            if to in (TypeID.STRING, TypeID.DEFAULT):
                return Val(to, v.decode("utf-8"))
        elif src.tid == TypeID.GEO:
            raise geo_unported()
        elif src.tid == TypeID.VECTOR:
            if to in (TypeID.STRING, TypeID.DEFAULT):
                return Val(to, vector_str(v))
    except (ValueError, TypeError, OverflowError) as e:
        raise ValueError(f"cannot convert {src!r} to {TYPE_NAMES[to]}: {e}") from None
    raise ValueError(f"no conversion from {TYPE_NAMES[src.tid]} to {TYPE_NAMES[to]}")


# ---------------------------------------------------------------------------
# Comparison / sort keys (reference: types/compare.go CompareVals)
# ---------------------------------------------------------------------------

def compare_vals(op: str, a: Val, b: Val) -> bool:
    """Apply a comparison operator (lt/le/gt/ge/eq/ne) between same-type values."""
    if a.tid != b.tid:
        try:
            b = convert(b, a.tid)
        except ValueError:
            return False
    av, bv = a.value, b.value
    if a.tid == TypeID.DATETIME:
        av, bv = av.timestamp(), bv.timestamp()
    return {
        "lt": lambda: av < bv,
        "le": lambda: av <= bv,
        "gt": lambda: av > bv,
        "ge": lambda: av >= bv,
        "eq": lambda: av == bv,
        "ne": lambda: av != bv,
    }[op]()


def sort_key(v: Val):
    """Total-order sort key within one type."""
    if v.tid == TypeID.DATETIME:
        return v.value.timestamp()
    return v.value


# ---------------------------------------------------------------------------
# Passwords (reference: types/password.go, bcrypt)
# ---------------------------------------------------------------------------

def hash_password(pw: str) -> str:
    """Salted PBKDF2-HMAC-SHA256 (stdlib; the reference vendors bcrypt)."""
    import hashlib
    import os

    if len(pw) < 6:
        raise ValueError("password too short, i.e. should have at least 6 chars")
    salt = os.urandom(16)
    dk = hashlib.pbkdf2_hmac("sha256", pw.encode("utf-8"), salt, 100_000)
    return "pbkdf2$" + salt.hex() + "$" + dk.hex()


def geo_unported() -> NotImplementedError:
    return NotImplementedError(
        "geo values are not ported yet: they wait for the geo slice of "
        "dgraph_tpu_torch")
