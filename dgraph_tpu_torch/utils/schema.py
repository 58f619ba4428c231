"""Predicate schema: state, text parser, directives.

Copy of dgraph_tpu/utils/schema.py for the PyTorch port.

Reference semantics: schema/ — per-predicate SchemaEntry (type + directives
@index(tokenizers) / @reverse / @count / @upsert / @lang / list) held in an
in-memory map backed by SCHEMA keys in the store (schema/schema.go:44-56,
accessors :114-233; text parser schema/parse.go).

Schema text:   pred: type .            pred: [type] .        (list)
               pred: string @index(term, exact) @count @upsert .
               friend: uid @reverse @count .
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field

from dgraph_tpu_torch.utils import tok
from dgraph_tpu_torch.utils.types import TypeID


VECTOR_METRICS = ("cosine", "l2", "dot")


@dataclass(frozen=True)
class VectorSpec:
    """@index(vector(dim: D[, metric: cosine|l2|dot])) — the TPU-native
    index type (ROADMAP item 4): a dense-embedding similarity index whose
    probe is a segmented matmul + top-k (storage/vecindex.py)."""

    dim: int
    metric: str = "cosine"

    def __str__(self) -> str:
        return f"vector(dim: {self.dim}, metric: {self.metric})"


@dataclass
class SchemaEntry:
    predicate: str
    type_id: TypeID = TypeID.DEFAULT
    is_list: bool = False
    tokenizers: list[str] = field(default_factory=list)  # @index(...)
    reverse: bool = False                                # @reverse
    count: bool = False                                  # @count
    upsert: bool = False                                 # @upsert
    lang: bool = False                                   # @lang
    vector: VectorSpec | None = None                     # @index(vector(...))

    @property
    def indexed(self) -> bool:
        return bool(self.tokenizers)

    def directives_str(self) -> str:
        parts = []
        if self.tokenizers:
            parts.append("@index(" + ", ".join(self.tokenizers) + ")")
        if self.vector is not None:
            parts.append(f"@index({self.vector})")
        if self.reverse:
            parts.append("@reverse")
        if self.count:
            parts.append("@count")
        if self.upsert:
            parts.append("@upsert")
        if self.lang:
            parts.append("@lang")
        return " ".join(parts)

    def __str__(self) -> str:
        from dgraph_tpu_torch.utils.types import TYPE_NAMES

        t = TYPE_NAMES[self.type_id]
        if self.is_list:
            t = f"[{t}]"
        d = self.directives_str()
        return f"{self.predicate}: {t} {d + ' ' if d else ''}."


_LINE_RE = re.compile(
    r"^\s*(?P<pred>[^\s:]+)\s*:\s*(?P<list>\[)?\s*(?P<type>\w+)\s*\]?\s*(?P<dirs>[^.]*)\.\s*$"
)
_DIR_RE = re.compile(r"@(?P<name>\w+)(?:\((?P<args>[^)]*)\))?")
# the vector index form nests parens (@index(vector(dim: 8))), which the
# flat _DIR_RE cannot express — extracted separately before the flat scan
_VEC_RE = re.compile(r"@index\(\s*vector\s*\((?P<args>[^)]*)\)\s*\)")


def _parse_vector_spec(args: str, e: "SchemaEntry") -> VectorSpec:
    if e.type_id != TypeID.VECTOR:
        raise ValueError(
            f"@index(vector) needs float32vector type ({e.predicate})")
    if e.is_list:
        raise ValueError(
            f"@index(vector) on [float32vector] is unsupported ({e.predicate})")
    dim, metric = 0, "cosine"
    for part in args.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition(":")
        k, v = k.strip(), v.strip()
        if k == "dim":
            try:
                dim = int(v)
            except ValueError:
                raise ValueError(
                    f"vector index dim must be an int ({e.predicate})") from None
        elif k == "metric":
            metric = v.strip("\"'").lower()
        else:
            raise ValueError(f"unknown vector index arg {k!r} ({e.predicate})")
    if dim < 1:
        raise ValueError(f"vector index needs dim >= 1 ({e.predicate})")
    if metric not in VECTOR_METRICS:
        raise ValueError(
            f"vector metric must be one of {VECTOR_METRICS} ({e.predicate})")
    return VectorSpec(dim=dim, metric=metric)


def parse_schema(text: str) -> list[SchemaEntry]:
    """Parse schema text into entries; validates tokenizer/type compatibility
    (reference: schema/parse.go)."""
    entries = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        m = _LINE_RE.match(line)
        if not m:
            raise ValueError(f"invalid schema line: {raw!r}")
        e = SchemaEntry(m.group("pred"))
        e.type_id = TypeID.from_name(m.group("type"))
        e.is_list = m.group("list") is not None
        dirs = m.group("dirs") or ""
        vm = _VEC_RE.search(dirs)
        if vm is not None:
            e.vector = _parse_vector_spec(vm.group("args"), e)
            dirs = dirs[: vm.start()] + dirs[vm.end():]
        for d in _DIR_RE.finditer(dirs):
            name, args = d.group("name"), d.group("args")
            if name == "index":
                toks = [a.strip() for a in (args or "").split(",") if a.strip()]
                if not toks:
                    toks = [tok.default_tokenizer(e.type_id).name]
                for t in toks:
                    tz = tok.get(t)
                    want = e.type_id if e.type_id != TypeID.DEFAULT else tz.type_id
                    if tz.type_id != want:
                        raise ValueError(
                            f"tokenizer {t!r} is for type {tz.type_id.name}, "
                            f"not {e.type_id.name} ({e.predicate})")
                e.tokenizers = toks
            elif name == "reverse":
                if e.type_id != TypeID.UID:
                    raise ValueError(f"@reverse needs uid type ({e.predicate})")
                e.reverse = True
            elif name == "count":
                e.count = True
            elif name == "upsert":
                e.upsert = True
            elif name == "lang":
                e.lang = True
            else:
                raise ValueError(f"unknown directive @{name} ({e.predicate})")
        if e.upsert and not e.indexed:
            raise ValueError(f"@upsert needs @index ({e.predicate})")
        entries.append(e)
    return entries


class SchemaState:
    """Mutable predicate→SchemaEntry map with mutation-time auto-population.

    Reference: schema/schema.go State() singleton; unknown predicates get a
    type inferred from the first mutation's value (schema.go:? mutation path),
    which we mirror in ensure().
    """

    def __init__(self) -> None:
        self._m: dict[str, SchemaEntry] = {}
        self._lock = threading.RLock()

    def set(self, e: SchemaEntry) -> None:
        with self._lock:
            self._m[e.predicate] = e

    def get(self, pred: str) -> SchemaEntry | None:
        with self._lock:
            return self._m.get(pred)

    def ensure(self, pred: str, tid: TypeID, is_list: bool = False) -> SchemaEntry:
        with self._lock:
            e = self._m.get(pred)
            if e is None:
                e = SchemaEntry(pred, tid, is_list=is_list)
                self._m[pred] = e
            elif e.type_id == TypeID.DEFAULT and tid != TypeID.DEFAULT:
                e.type_id = tid
            return e

    def delete(self, pred: str) -> None:
        with self._lock:
            self._m.pop(pred, None)

    def predicates(self) -> list[str]:
        with self._lock:
            return sorted(self._m)

    def entries(self) -> list[SchemaEntry]:
        with self._lock:
            return [self._m[p] for p in sorted(self._m)]

    def type_of(self, pred: str) -> TypeID:
        e = self.get(pred)
        return e.type_id if e else TypeID.DEFAULT

    def is_indexed(self, pred: str) -> bool:
        e = self.get(pred)
        return bool(e and e.tokenizers)

    def is_reversed(self, pred: str) -> bool:
        e = self.get(pred)
        return bool(e and e.reverse)

    def has_count(self, pred: str) -> bool:
        e = self.get(pred)
        return bool(e and e.count)

    def is_list(self, pred: str) -> bool:
        e = self.get(pred)
        return bool(e and e.is_list)

    def tokenizer_names(self, pred: str) -> list[str]:
        e = self.get(pred)
        return list(e.tokenizers) if e else []

    def vector_spec(self, pred: str) -> VectorSpec | None:
        e = self.get(pred)
        return e.vector if e else None

    def to_text(self) -> str:
        return "\n".join(str(e) for e in self.entries())


def schema_json(state: "SchemaState", preds: list[str] | None = None) -> list[dict]:
    """`schema {}` response entries (the reference's schema-query JSON
    shape, edgraph/server.go schema handling). Shared by the embedded
    server and the cluster client so the two surfaces cannot drift."""
    out = []
    for attr in (preds or state.predicates()):
        e = state.get(attr)
        if e is None:
            continue
        d: dict = {"predicate": e.predicate, "type": e.type_id.name.lower()}
        if e.indexed:
            d["index"] = True
            d["tokenizer"] = list(e.tokenizers)
        if e.vector is not None:
            d["index"] = True
            d["vector"] = {"dim": e.vector.dim, "metric": e.vector.metric}
        for flag in ("reverse", "count", "upsert", "lang"):
            if getattr(e, flag, False):
                d[flag] = True
        if e.is_list:
            d["list"] = True
        out.append(d)
    return out
