"""RDF N-Quad parser for mutations.

Copy of dgraph_tpu/query/rdf.py for the PyTorch port.

Reference semantics: rdf/parse.go (:56 Parse) + rdf/state.go — N-Quads with
typed literals (`"25"^^<xs:int>`), language tags (`"chat"@fr`), blank nodes
(`_:x`), star wildcards for deletion (`<s> <p> *` and `<s> * *`), and facets
in trailing parens (`(weight=0.5, since=2006-01-02T15:04:05)`).

Fresh regex-based implementation (the reference uses the lex/ state machine).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from dgraph_tpu_torch.utils.types import TypeID, Val, convert, parse_datetime


class RDFError(ValueError):
    pass


@dataclass
class NQuad:
    subject: str                 # "0x1" | "_:name"
    predicate: str               # "*" for S * * deletion
    object_id: str = ""          # uid/blank object ("" if literal)
    object_value: Val | None = None
    lang: str = ""
    facets: list[tuple[str, Val]] = field(default_factory=list)
    star: bool = False           # object is *
    # upsert-block var references (reference: gql upsert uid(v)/val(v) in
    # mutation quads) — resolved by query/upsert.py expand(); rejected by the
    # plain mutation path
    subject_var: str = ""        # subject was uid(v)
    object_var: str = ""         # object was uid(v)
    val_var: str = ""            # object was val(v)


_XSD_TYPES = {
    "xs:int": TypeID.INT, "xs:integer": TypeID.INT,
    "xs:positiveInteger": TypeID.INT,
    "xs:float": TypeID.FLOAT, "xs:double": TypeID.FLOAT, "xs:decimal": TypeID.FLOAT,
    "xs:boolean": TypeID.BOOL, "xs:bool": TypeID.BOOL,
    "xs:dateTime": TypeID.DATETIME, "xs:date": TypeID.DATETIME,
    "xs:string": TypeID.STRING,
    "geo:geojson": TypeID.GEO,
    "xs:password": TypeID.PASSWORD, "pwd:password": TypeID.PASSWORD,
    "xs:base64Binary": TypeID.BINARY,
    "xs:float32vector": TypeID.VECTOR,
}
# full http://www.w3.org/2001/XMLSchema# forms
for _k, _v in list(_XSD_TYPES.items()):
    if _k.startswith("xs:"):
        _XSD_TYPES["http://www.w3.org/2001/XMLSchema#" + _k[3:]] = _v

_LINE_RE = re.compile(
    r"""^\s*
    (?P<subj><[^>]+>|_:[A-Za-z0-9_.\-]+|uid\([A-Za-z0-9_]+\))\s+
    (?P<pred><[^>]+>|\*|[^\s<>]+)\s+
    (?P<obj><[^>]+>|_:[A-Za-z0-9_.\-]+|\*|(?:uid|val)\([A-Za-z0-9_]+\)
        |"(?:\\.|[^"\\])*"(?:@[A-Za-z\-:]+|\^\^<[^>]+>)?)
    \s*(?P<facets>\((?:"(?:\\.|[^"\\])*"|[^)"])*\))?\s*
    (?:<[^>]*>\s*)?      # optional label/graph — ignored
    \.\s*(?:\#.*)?$""",
    re.VERBOSE,
)

_VAR_TERM = re.compile(r"^(uid|val)\(([A-Za-z0-9_]+)\)$")


def _strip_angle(s: str) -> str:
    return s[1:-1] if s.startswith("<") else s


def _parse_facet_val(raw: str) -> Val:
    raw = raw.strip()
    if re.fullmatch(r"-?\d+", raw):
        return Val(TypeID.INT, int(raw))
    if re.fullmatch(r"-?\d+\.\d*", raw):
        return Val(TypeID.FLOAT, float(raw))
    if raw in ("true", "false"):
        return Val(TypeID.BOOL, raw == "true")
    if raw.startswith('"') and raw.endswith('"'):
        # quoted facet string: unescape \" \\ \n \t (export round-trip)
        body = re.sub(r"\\(.)",
                      lambda m: {"n": "\n", "t": "\t"}.get(m.group(1), m.group(1)),
                      raw[1:-1])
        return Val(TypeID.STRING, body)
    try:
        return Val(TypeID.DATETIME, parse_datetime(raw))
    except ValueError:
        return Val(TypeID.STRING, raw)


def parse_line(line: str) -> NQuad | None:
    """Parse one N-Quad line; returns None for blank/comment lines."""
    s = line.strip()
    if not s or s.startswith("#"):
        return None
    m = _LINE_RE.match(line)
    if not m:
        raise RDFError(f"bad N-Quad: {line!r}")
    subj = _strip_angle(m.group("subj"))
    pred = _strip_angle(m.group("pred"))
    obj = m.group("obj")
    nq = NQuad(subject=subj, predicate=pred)
    vm = _VAR_TERM.match(subj)
    if vm:
        nq.subject, nq.subject_var = "", vm.group(2)
    if pred == "*" and obj != "*":
        raise RDFError("predicate * requires object *")
    ovm = _VAR_TERM.match(obj)
    if obj == "*":
        nq.star = True
    elif ovm:
        if ovm.group(1) == "uid":
            nq.object_var = ovm.group(2)
        else:
            nq.val_var = ovm.group(2)
    elif obj.startswith("<") or obj.startswith("_:"):
        nq.object_id = _strip_angle(obj)
    else:
        body_m = re.match(r'"((?:\\.|[^"\\])*)"(?:@([A-Za-z\-:]+)|\^\^<([^>]+)>)?$', obj)
        if not body_m:
            raise RDFError(f"bad literal in: {line!r}")
        text = re.sub(r"\\(.)", lambda mm: {"n": "\n", "t": "\t"}.get(mm.group(1), mm.group(1)),
                      body_m.group(1))
        lang, typ = body_m.group(2), body_m.group(3)
        if typ == "pwd:hashed":
            # already-hashed password (export round-trip: converting through
            # STRING->PASSWORD would bcrypt the hash again)
            nq.object_value = Val(TypeID.PASSWORD, text)
        elif typ:
            tid = _XSD_TYPES.get(typ)
            if tid is None:
                raise RDFError(f"unknown literal type <{typ}>")
            nq.object_value = convert(Val(TypeID.STRING, text), tid)
        else:
            nq.object_value = Val(TypeID.DEFAULT, text)
        if lang:
            nq.lang = lang
    if m.group("facets"):
        inner = m.group("facets")[1:-1].strip()
        if inner:
            for part in _split_facets(inner):
                k, _, v = part.partition("=")
                nq.facets.append((k.strip(), _parse_facet_val(v)))
    return nq


def _split_facets(s: str) -> list[str]:
    out, cur, in_str, esc = [], [], False, False
    for c in s:
        if esc:
            esc = False
        elif c == "\\" and in_str:
            esc = True
        elif c == '"':
            in_str = not in_str
        if c == "," and not in_str:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    if cur:
        out.append("".join(cur))
    return out


def _split_statements(line: str) -> list[str]:
    """Split one physical line into N-Quad statements at unquoted ' . '
    terminators (the HTTP mutation body often carries several quads on one
    line; the reference's chunker is newline-based but its lexer terminates
    statements at the dot, so accept both)."""
    out, cur, in_str, in_iri, esc = [], [], False, False, False
    i, n = 0, len(line)
    while i < n:
        c = line[i]
        if c == "#" and not in_str and not in_iri:
            # trailing comment: the rest of the line belongs to the current
            # statement (parse_line's grammar accepts `. # comment`)
            cur.extend(line[i:])
            break
        cur.append(c)
        if esc:
            esc = False
        elif c == "\\" and in_str:
            esc = True
        elif c == '"' and not in_iri:
            in_str = not in_str
        elif c == "<" and not in_str:
            in_iri = True
        elif c == ">" and not in_str:
            in_iri = False
        elif c == "." and not in_str and not in_iri:
            nxt = line[i + 1: i + 2]
            if nxt in ("", " ", "\t"):
                out.append("".join(cur))
                cur = []
        i += 1
    if "".join(cur).strip():
        out.append("".join(cur))
    return out


def parse(text: str) -> list[NQuad]:
    """Parse a block of N-Quad lines."""
    out = []
    for line in text.splitlines():
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        for stmt in _split_statements(line):
            nq = parse_line(stmt)
            if nq is not None:
                out.append(nq)
    return out
