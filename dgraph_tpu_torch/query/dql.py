"""DQL ("GraphQL+-") lexer + parser.

Copy of dgraph_tpu/query/dql.py (pure Python) for the PyTorch port.

Reference semantics: gql/ — Parse (gql/parser.go:433) producing GraphQuery
trees (:39-83) with root functions, filter trees (:137), directives (@filter /
@cascade / @normalize / @groupby / @recurse / @facets / @ignorereflex), vars
(`uid(x)`, `val(x)`, `x as pred`), GraphQL variables with typed declarations
(:922), fragments (:103,:781), shortest-path blocks, math() expressions
(gql/math.go operator-precedence parser), and the lex/ rune lexer.

This is a fresh recursive-descent implementation (the reference uses a
state-function lexer feeding a hand-rolled parser); the surface grammar is
kept compatible so reference queries run unchanged.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any


class ParseError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>[\s,]+)
  | (?P<comment>\#[^\n]*)
  | (?P<string>"(?:\\.|[^"\\])*")
  | (?P<hexnum>0x[0-9a-fA-F]+)
  | (?P<number>-?\d+\.\d+|-?\d+|-?\.\d+)
  | (?P<name>[a-zA-Z_][a-zA-Z0-9_.]*|<[^>\s]+>)  # IRIs never contain spaces
                                                 # (else `a < b ... >` would
                                                 # lex as one giant IRI)
  | (?P<varname>\$[a-zA-Z_][a-zA-Z0-9_]*)
  | (?P<spread>\.\.\.)
  | (?P<punct>[{}()\[\]:@~*]|!=|<=|>=|==|[<>=!+\-*/%])
  | (?P<other>\S)
    """,
    re.VERBOSE,
)


@dataclass(frozen=True)
class Tok:
    kind: str
    text: str
    pos: int


def lex(src: str) -> list[Tok]:
    toks: list[Tok] = []
    i = 0
    while i < len(src):
        m = _TOKEN_RE.match(src, i)
        if not m:
            raise ParseError(f"lex error at offset {i}: {src[i:i+20]!r}")
        kind = m.lastgroup
        if kind not in ("ws", "comment"):
            toks.append(Tok(kind, m.group(), i))
        i = m.end()
    toks.append(Tok("eof", "", len(src)))
    return toks


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclass
class FilterTree:
    """Boolean filter tree (reference gql/parser.go:137)."""

    op: str = ""                                # "and" | "or" | "not" | "" (leaf)
    children: list["FilterTree"] = field(default_factory=list)
    func: "Function | None" = None


@dataclass
class Function:
    """A function call: name, attr, args (reference gql.Function)."""

    name: str
    attr: str = ""
    args: list[Any] = field(default_factory=list)  # literals / VarRef
    is_count: bool = False                          # eq(count(pred), n)
    is_valvar: bool = False                         # eq(val(x), n)
    lang: str = ""


@dataclass
class VarRef:
    name: str
    typ: str  # "uid" | "val"


@dataclass
class FacetSpec:
    keys: list[tuple[str, str]] = field(default_factory=list)  # (alias, key); empty=all
    filter: FilterTree | None = None
    order: list[tuple[str, bool]] = field(default_factory=list)  # (key, desc)
    var_map: dict[str, str] = field(default_factory=dict)       # facet key -> var name


@dataclass
class MathTree:
    op: str = ""                     # operator or "" for leaf
    children: list["MathTree"] = field(default_factory=list)
    const: Any = None                # literal leaf
    var: str = ""                    # val-var leaf


@dataclass
class GroupBySpec:
    attrs: list[tuple[str, str, str]] = field(default_factory=list)  # (alias, attr, lang)


@dataclass
class RecurseSpec:
    depth: int = 0
    allow_loop: bool = False


@dataclass
class ShortestSpec:
    from_: Any = None       # int uid or VarRef
    to: Any = None
    numpaths: int = 1
    depth: int = 0
    minweight: float = float("-inf")
    maxweight: float = float("inf")


@dataclass
class Order:
    attr: str = ""
    desc: bool = False
    lang: str = ""
    is_val: bool = False    # orderasc: val(x)
    facet: str = ""         # @facets(orderasc: key) handled in FacetSpec


@dataclass
class GraphQuery:
    """One query block / child attribute (reference gql.GraphQuery :39)."""

    alias: str = ""
    attr: str = ""
    is_query_block: bool = False
    func: Function | None = None
    uids: list[int] = field(default_factory=list)
    filter: FilterTree | None = None
    children: list["GraphQuery"] = field(default_factory=list)
    # pagination / order
    args: dict[str, Any] = field(default_factory=dict)   # first / offset / after
    order: list[Order] = field(default_factory=list)
    # vars
    var_name: str = ""           # `x as ...`
    needs_vars: list[str] = field(default_factory=list)
    # vars that SOURCE the root uid set (func: uid(v)) — a strict subset of
    # needs_vars; filter/order vars schedule the block but don't widen the root
    root_uid_vars: list[str] = field(default_factory=list)
    # directives
    cascade: bool = False
    normalize: bool = False
    ignore_reflex: bool = False
    facets: FacetSpec | None = None
    groupby: GroupBySpec | None = None
    recurse: RecurseSpec | None = None
    shortest: ShortestSpec | None = None
    lang: str = ""               # name@en (full chain "fr:es:.")
    is_count: bool = False       # count(pred)
    is_uid_node: bool = False    # the `uid` leaf
    expand: str = ""             # expand(_all_) / expand(val)
    math: MathTree | None = None
    val_ref: str = ""            # val(x) child
    checkpwd: str = ""           # checkpwd(pwd, "<candidate>") child

    def all_needs(self) -> list[str]:
        """Var names this block consumes (for dependency waves)."""
        out = list(self.needs_vars)
        if self.shortest is not None:
            for end in (self.shortest.from_, self.shortest.to):
                if isinstance(end, VarRef):
                    out.append(end.name)
        return out


@dataclass
class ParsedRequest:
    queries: list[GraphQuery]
    mutations: list[dict] | None = None   # {"set": [nquads], "delete": [...]}
    schema_request: list[str] | None = None
    fragments: dict[str, list[GraphQuery]] = field(default_factory=dict)
    # upsert block (gql/upsert.go ParseMutation):
    # {"query": dql text, "mutations": [{"cond", "set", "delete"}]}
    upsert: dict | None = None


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, toks: list[Tok], gql_vars: dict[str, Any], src: str = ""):
        self.toks = toks
        self.i = 0
        self.vars = gql_vars or {}
        self.src = src

    def _relex_regex(self) -> tuple[str, str]:
        """Re-scan a /pattern/flags literal from the source at the current
        '/' token. '/' is lexed as punct (it is also math division); only a
        function-argument position treats it as a regex opener."""
        t = self.next()
        if t.text != "/":
            raise ParseError(f"expected regex, got {t.text!r} at {t.pos}")
        j = t.pos + 1
        while j < len(self.src):
            if self.src[j] == "\\":
                j += 2
                continue
            if self.src[j] == "/":
                break
            j += 1
        if j >= len(self.src):
            raise ParseError("unterminated regex literal")
        pattern = self.src[t.pos + 1 : j]
        flags = ""
        if j + 1 < len(self.src) and self.src[j + 1] == "i":
            flags = "i"
            j += 1
        # skip tokens consumed by the raw scan
        while self.peek().kind != "eof" and self.peek().pos <= j:
            self.next()
        return pattern, flags

    # -- token helpers ------------------------------------------------------

    def peek(self) -> Tok:
        # clamp to the trailing eof token: loops that consume until a
        # closer must see eof (and error), never run off the list
        return self.toks[min(self.i, len(self.toks) - 1)]

    def next(self) -> Tok:
        t = self.peek()
        self.i += 1
        return t

    def expect(self, text: str) -> Tok:
        t = self.next()
        if t.text != text:
            raise ParseError(f"expected {text!r}, got {t.text!r} at {t.pos}")
        return t

    def accept(self, text: str) -> bool:
        if self.peek().text == text:
            self.i += 1
            return True
        return False

    def name(self) -> str:
        t = self.next()
        if t.kind not in ("name", "number"):
            raise ParseError(f"expected name, got {t.text!r} at {t.pos}")
        return t.text.strip("<>")

    # -- literals -----------------------------------------------------------

    def literal(self) -> Any:
        t = self.next()
        if t.kind == "string":
            return _unquote(t.text)
        if t.kind == "hexnum":
            return t.text  # uid literal; converted by _parse_uid_str at use site
        if t.kind == "number":
            return float(t.text) if "." in t.text else int(t.text)
        if t.kind == "varname":
            if t.text not in self.vars:
                raise ParseError(f"undefined GraphQL variable {t.text}")
            return self.vars[t.text]
        if t.kind == "name":
            return t.text
        raise ParseError(f"expected literal, got {t.text!r} at {t.pos}")

    # -- top level ----------------------------------------------------------

    def parse(self) -> ParsedRequest:
        req = ParsedRequest(queries=[])
        # optional `query name($v: type = default)` header
        if self.peek().text == "query":
            self.next()
            if self.peek().kind == "name":
                self.next()  # query name
            if self.accept("("):
                self._parse_var_decls()
        while self.peek().text == "fragment":
            self.next()
            fname = self.name()
            self.expect("{")
            req.fragments[fname] = self._parse_children(req)
        if self.peek().kind == "eof":
            return req
        if self.peek().text == "upsert":
            req.upsert = self._parse_upsert_block()
            return req
        if self.peek().text == "schema":
            # top-level `schema {}` / `schema(pred: [..]) {..}` — the form
            # the reference's clients send (gql/parser.go schema handling);
            # the braced `{ schema {} }` form is also accepted below
            req.schema_request = self._parse_schema_block()
            return req
        self.expect("{")
        while not self.accept("}"):
            t = self.peek()
            if t.text in ("set", "delete"):
                req.mutations = req.mutations or []
                req.mutations.append(self._parse_mutation_block())
            elif t.text == "schema":
                req.schema_request = self._parse_schema_block()
            else:
                req.queries.append(self._parse_query_block(req))
        while self.peek().text == "fragment":
            self.next()
            fname = self.name()
            self.expect("{")
            req.fragments[fname] = self._parse_children(req)
        _expand_fragments_all(req)
        return req

    def _parse_var_decls(self) -> None:
        while not self.accept(")"):
            t = self.next()
            if t.kind != "varname":
                raise ParseError(f"expected $var, got {t.text!r}")
            self.expect(":")
            self.name()  # type — values arrive pre-typed from the API layer
            if self.accept("="):
                default = self.literal()
                self.vars.setdefault(t.text, default)
            if t.text not in self.vars:
                raise ParseError(f"variable {t.text} not supplied")

    def _parse_schema_block(self) -> list[str]:
        self.expect("schema")
        preds: list[str] = []
        if self.accept("("):
            self.expect("pred")
            self.expect(":")
            if self.accept("["):
                while not self.accept("]"):
                    preds.append(str(self.literal()))
            else:
                preds.append(str(self.literal()))
            self.expect(")")
        if self.accept("{"):
            while not self.accept("}"):
                if self.peek().kind == "eof":
                    raise ParseError("unterminated schema block")
                self.next()  # field selection is cosmetic; all fields return
        return preds

    # -- mutations ----------------------------------------------------------

    def _parse_mutation_block(self) -> dict:
        kind = self.next().text  # set | delete
        self.expect("{")
        # raw RDF until matching }
        start = self.peek().pos
        depth = 1
        src_end = start
        while depth > 0:
            t = self.next()
            if t.kind == "eof":
                raise ParseError("unterminated mutation block")
            if t.text == "{":
                depth += 1
            elif t.text == "}":
                depth -= 1
                src_end = t.pos
        return {"op": kind, "rdf_span": (start, src_end)}

    def _raw_brace_span(self) -> tuple[int, int]:
        """Consume `{ ... }` (already at `{`), returning the raw source span
        of the inside (same scan as _parse_mutation_block's tail)."""
        self.expect("{")
        start = self.peek().pos
        depth, src_end = 1, start
        while depth > 0:
            t = self.next()
            if t.kind == "eof":
                raise ParseError("unterminated block")
            if t.text == "{":
                depth += 1
            elif t.text == "}":
                depth -= 1
                src_end = t.pos
        return start, src_end

    def _parse_upsert_block(self) -> dict:
        """upsert { query {...} mutation [@if(...)] { set/delete {...} } }
        (gql/upsert.go ParseMutation). Query text and RDF bodies are captured
        as raw spans; @if conditions as the text inside the parens."""
        self.expect("upsert")
        self.expect("{")
        q_text = ""
        muts: list[dict] = []
        while not self.accept("}"):
            t = self.peek()
            if t.text == "query":
                self.next()
                s, e = self._raw_brace_span()
                q_text = "{" + self.src[s:e] + "}"
            elif t.text == "mutation":
                self.next()
                cond = ""
                if self.accept("@"):
                    if self.name() != "if":
                        raise ParseError("expected @if on mutation")
                    self.expect("(")
                    cs = self.peek().pos
                    depth, ce = 1, cs
                    while depth > 0:
                        tk = self.next()
                        if tk.kind == "eof":
                            raise ParseError("unterminated @if")
                        if tk.text == "(":
                            depth += 1
                        elif tk.text == ")":
                            depth -= 1
                            ce = tk.pos
                    cond = self.src[cs:ce]
                m = {"cond": cond, "set": "", "delete": ""}
                self.expect("{")
                while not self.accept("}"):
                    kind = self.peek().text
                    if kind not in ("set", "delete"):
                        raise ParseError(
                            f"expected set/delete in mutation, got {kind!r}")
                    self.next()
                    s, e = self._raw_brace_span()
                    m[kind] = self.src[s:e]
                muts.append(m)
            else:
                raise ParseError(
                    f"expected query/mutation in upsert, got {t.text!r}")
        if not muts:
            raise ParseError("upsert block needs at least one mutation")
        return {"query": q_text, "mutations": muts}

    # -- query blocks -------------------------------------------------------

    def _parse_query_block(self, req: ParsedRequest) -> GraphQuery:
        gq = GraphQuery(is_query_block=True)
        first = self.name()
        if self.peek().text == "as":
            # `x as var(func: ...)`, `x as q(func: ...)`
            self.next()
            gq.var_name = first
            first = self.name()
        gq.alias = first
        gq.attr = first
        if first == "shortest":
            return self._parse_shortest_block(gq, req)
        self.expect("(")
        while not self.accept(")"):
            key = self.name()
            self.expect(":")
            self._parse_block_arg(gq, key)
        self._parse_directives(gq)
        if self.peek().text != "{" and first == "var":
            # body-less VAR block: `v as var(func: ...)` — standard in upsert
            # queries where only the uid var matters (gql accepts it); named
            # output blocks still require a selection set
            gq.children = []
            return gq
        self.expect("{")
        gq.children = self._parse_children(req)
        return gq

    def _parse_block_arg(self, gq: GraphQuery, key: str) -> None:
        if key == "func":
            gq.func = self._parse_function()
            if gq.func.name == "uid":
                gq.uids, refs = _split_uid_args(gq.func.args)
                gq.needs_vars += refs
                gq.root_uid_vars += refs
                gq.func = None
        elif key in ("first", "offset", "after"):
            v = self.literal()
            gq.args[key] = _parse_uid_str(v) if key == "after" else int(v)
        elif key in ("orderasc", "orderdesc"):
            gq.order.append(self._parse_order(desc=key == "orderdesc"))
        elif key == "lang":
            gq.lang = str(self.literal())
        else:
            gq.args[key] = self.literal()

    def _parse_order(self, desc: bool) -> Order:
        o = Order(desc=desc)
        nm = self.name()
        if nm == "val":
            self.expect("(")
            o.attr = self.name()
            o.is_val = True
            self.expect(")")
        else:
            o.attr = nm
            if self.accept("@"):
                o.lang = self.name()
        return o

    def _parse_shortest_block(self, gq: GraphQuery, req: ParsedRequest) -> GraphQuery:
        gq.shortest = ShortestSpec()
        gq.attr = "_path_"
        gq.alias = "_path_"
        self.expect("(")
        while not self.accept(")"):
            key = self.name()
            self.expect(":")
            if key in ("from", "to"):
                t = self.peek()
                if t.text == "uid":
                    self.next()
                    self.expect("(")
                    inner = self.literal()
                    self.expect(")")
                    val = VarRef(str(inner), "uid")
                else:
                    val = _parse_uid_str(self.literal())
                setattr(gq.shortest, "from_" if key == "from" else "to", val)
            elif key == "numpaths":
                gq.shortest.numpaths = int(self.literal())
            elif key == "depth":
                gq.shortest.depth = int(self.literal())
            elif key == "minweight":
                gq.shortest.minweight = float(self.literal())
            elif key == "maxweight":
                gq.shortest.maxweight = float(self.literal())
            else:
                raise ParseError(f"unknown shortest arg {key}")
        self.expect("{")
        gq.children = self._parse_children(req)
        return gq

    # -- functions ----------------------------------------------------------

    def _parse_function(self) -> Function:
        fname = self.name().lower()
        fn = Function(fname)
        self.expect("(")
        first = True
        while not self.accept(")"):
            t = self.peek()
            if first and t.kind == "name" and t.text == "count":
                self.next()
                self.expect("(")
                if self.peek().text == "~":   # count(~rev) degree compare
                    self.next()
                    fn.attr = "~" + self.name()
                else:
                    fn.attr = self.name()
                self.expect(")")
                fn.is_count = True
            elif first and t.kind == "name" and t.text == "val":
                self.next()
                self.expect("(")
                fn.args.append(VarRef(self.name(), "val"))
                fn.is_valvar = True
                self.expect(")")
            elif first and t.kind == "name" and fname != "uid":
                fn.attr = self.name()
                if self.accept("@"):
                    fn.lang = self.name()
            elif first and t.text == "~":
                self.next()
                fn.attr = "~" + self.name()
            elif t.kind == "name" and t.text == "uid" and self.toks[self.i + 1].text == "(":
                self.next()
                self.expect("(")
                while not self.accept(")"):
                    fn.args.append(VarRef(str(self.literal()), "uid"))
            elif t.kind == "name" and t.text == "val" and self.toks[self.i + 1].text == "(":
                self.next()
                self.expect("(")
                fn.args.append(VarRef(self.name(), "val"))
                fn.is_valvar = True
                self.expect(")")
            elif t.text == "/":
                pattern, rflags = self._relex_regex()
                fn.args.append(pattern)
                fn.args.append(rflags)
            elif fname == "uid" and t.kind == "name":
                fn.args.append(VarRef(self.name(), "uid"))
            elif t.text == "[":
                self.next()
                lst = []
                while not self.accept("]"):
                    lst.append(self.literal())
                fn.args.append(lst)
            else:
                fn.args.append(self.literal())
            first = False
        if fname in ("eq", "uid_in"):
            # eq(pred, [v1, v2]) / uid_in(pred, [u1, u2]) list form == the
            # variadic form: flatten here so every consumer (root func,
            # filters, val-var compares) sees one value list (gql parses
            # both the same way).
            fn.args = [x for a in fn.args
                       for x in (a if isinstance(a, list) else (a,))]
        return fn

    # -- directives ---------------------------------------------------------

    def _parse_directives(self, gq: GraphQuery) -> None:
        while self.accept("@"):
            d = self.name()
            if d == "filter":
                gq.filter = self._parse_filter_tree_paren()
            elif d == "cascade":
                gq.cascade = True
            elif d == "normalize":
                gq.normalize = True
            elif d == "ignorereflex":
                gq.ignore_reflex = True
            elif d == "groupby":
                gq.groupby = self._parse_groupby()
            elif d == "recurse":
                gq.recurse = RecurseSpec()
                if self.accept("("):
                    while not self.accept(")"):
                        key = self.name()
                        self.expect(":")
                        v = self.literal()
                        if key == "depth":
                            gq.recurse.depth = int(v)
                        elif key == "loop":
                            gq.recurse.allow_loop = str(v).lower() == "true"
            elif d == "facets":
                self._parse_facets(gq)
            else:
                raise ParseError(f"unknown directive @{d}")

    def _parse_groupby(self) -> GroupBySpec:
        spec = GroupBySpec()
        self.expect("(")
        while not self.accept(")"):
            nm = self.name()
            alias = ""
            if self.accept(":"):
                alias, nm = nm, self.name()
            lang = ""
            if self.accept("@"):
                lang = self.name()
            spec.attrs.append((alias, nm, lang))
        return spec

    def _parse_facets(self, gq: GraphQuery) -> None:
        if gq.facets is None:
            gq.facets = FacetSpec()
        if not self.accept("("):
            return  # @facets — all facets
        # could be: key list / alias:key / filter tree / orderasc:key / var as key
        while not self.accept(")"):
            t = self.peek()
            if t.kind == "name" and t.text in ("orderasc", "orderdesc"):
                self.next()
                self.expect(":")
                gq.facets.order.append((self.name(), t.text == "orderdesc"))
            elif t.text.lower() == "not" or t.text == "(" or (
                    t.kind == "name" and _is_func_ahead(self.toks, self.i)):
                # filter trees can open with NOT / a paren group, not just a
                # function name: @facets(NOT eq(close, true))
                gq.facets.filter = self._parse_filter_tree()
            else:
                nm = self.name()
                if self.peek().text == "as":
                    self.next()
                    key = self.name()
                    gq.facets.var_map[key] = nm
                elif self.accept(":"):
                    gq.facets.keys.append((nm, self.name()))
                else:
                    gq.facets.keys.append((nm, nm))

    def _parse_filter_tree_paren(self) -> FilterTree:
        self.expect("(")
        t = self._parse_filter_tree()
        self.expect(")")
        return t

    def _parse_filter_tree(self) -> FilterTree:
        """or-precedence boolean tree: A and B or not C."""
        left = self._parse_filter_and()
        while self.peek().text.lower() == "or":
            self.next()
            right = self._parse_filter_and()
            if left.op == "or":
                left.children.append(right)
            else:
                left = FilterTree(op="or", children=[left, right])
        return left

    def _parse_filter_and(self) -> FilterTree:
        left = self._parse_filter_atom()
        while self.peek().text.lower() == "and":
            self.next()
            right = self._parse_filter_atom()
            if left.op == "and":
                left.children.append(right)
            else:
                left = FilterTree(op="and", children=[left, right])
        return left

    def _parse_filter_atom(self) -> FilterTree:
        if self.peek().text.lower() == "not":
            self.next()
            return FilterTree(op="not", children=[self._parse_filter_atom()])
        if self.accept("("):
            t = self._parse_filter_tree()
            self.expect(")")
            return t
        return FilterTree(func=self._parse_function())

    # -- children -----------------------------------------------------------

    def _parse_children(self, req: ParsedRequest) -> list[GraphQuery]:
        out: list[GraphQuery] = []
        while not self.accept("}"):
            t = self.peek()
            if t.kind == "spread":
                self.next()
                out.append(GraphQuery(attr="...", alias=self.name()))
                continue
            child = self._parse_child(req)
            out.append(child)
        return out

    def _parse_child(self, req: ParsedRequest) -> GraphQuery:
        gq = GraphQuery()
        rev = self.accept("~")
        nm = ("~" if rev else "") + self.name()
        # `x as pred` variable definition
        if self.peek().text == "as":
            self.next()
            gq.var_name = nm
            nm = self.name()
            # `x as math(expr)` value-var definition (gql parser_v2: vars can
            # bind computed nodes, not just preds). Alias by var name so two
            # math definitions in one block don't collide on the "math" key.
            if nm == "math" and self.peek().text == "(":
                self.expect("(")
                gq.math = self._parse_math()
                self.expect(")")
                gq.attr = "math"
                gq.alias = gq.var_name
                _collect_math_vars(gq.math, gq.needs_vars)
                return gq
        # alias : pred
        if self.accept(":"):
            gq.alias = nm
            t = self.peek()
            if t.text == "count" and self.toks[self.i + 1].text == "(":
                self.next()
                self._parse_count_into(gq)
            elif t.text == "val" and self.toks[self.i + 1].text == "(":
                self.next()
                self.expect("(")
                gq.val_ref = self.name()
                gq.needs_vars.append(gq.val_ref)
                self.expect(")")
                gq.attr = "val"
            elif t.text == "math" and self.toks[self.i + 1].text == "(":
                self.next()
                self.expect("(")
                gq.math = self._parse_math()
                self.expect(")")
                gq.attr = "math"
                _collect_math_vars(gq.math, gq.needs_vars)
            elif t.text in ("min", "max", "sum", "avg") and self.toks[self.i + 1].text == "(":
                agg = self.next().text
                self.expect("(")
                self.expect("val")
                self.expect("(")
                gq.val_ref = self.name()
                gq.needs_vars.append(gq.val_ref)
                self.expect(")")
                self.expect(")")
                gq.attr = f"__agg_{agg}"
            else:
                gq.attr = self.name()
        else:
            gq.alias = nm
            gq.attr = nm
            if nm == "count" and self.peek().text == "(":
                gq.alias = ""
                self._parse_count_into(gq)
            elif nm == "val" and self.peek().text == "(":
                self.expect("(")
                gq.val_ref = self.name()
                gq.needs_vars.append(gq.val_ref)
                self.expect(")")
                gq.attr = "val"
                gq.alias = f"val({gq.val_ref})"
            elif nm == "uid" and self.peek().text == "(":
                self.expect("(")
                while not self.accept(")"):
                    gq.needs_vars.append(str(self.literal()))
                gq.attr = "uid"
                gq.is_uid_node = True
            elif nm == "checkpwd" and self.peek().text == "(":
                # checkpwd(pwd, "candidate") selection: per-uid bool keyed
                # "checkpwd(pwd)" (reference query/outputnode.go checkPwd)
                self.expect("(")
                gq.attr = self.name()
                gq.checkpwd = str(self.literal())
                self.expect(")")
                gq.alias = f"checkpwd({gq.attr})"
            elif nm == "uid":
                gq.is_uid_node = True
            elif nm == "expand":
                self.expect("(")
                gq.expand = self.name()
                self.expect(")")
                gq.attr = "expand"
                if gq.expand != "_all_":
                    # expand(var) consumes the variable: register it so the
                    # wave scheduler orders the defining block first
                    gq.needs_vars.append(gq.expand)
        # language tags: name@en / name@en:fr / name@.
        if self.accept("@"):
            langs = [self.name() if self.peek().kind == "name" else self.next().text]
            while self.accept(":"):
                # chain elements are langs or the untagged-fallback "."
                if self.peek().kind == "name":
                    langs.append(self.name())
                elif self.peek().text == ".":
                    self.next()
                    langs.append(".")
                else:
                    raise ParseError(
                        f"bad language tag after ':' at {self.peek().pos}")
            # beware: @facets etc. are directives, not langs
            if langs[0] in ("filter", "cascade", "normalize", "facets", "groupby",
                            "recurse", "ignorereflex"):
                self.i -= 2 if len(langs) == 1 else 0
            else:
                # the full chain travels in .lang ("fr:es:."): the task layer
                # walks it and the output key mirrors it (name@fr:es:.)
                gq.lang = ":".join(langs)
        # (args) and @directives in either order (dgraph accepts both)
        while True:
            if self.accept("("):
                while not self.accept(")"):
                    key = self.name()
                    self.expect(":")
                    self._parse_block_arg(gq, key)
            elif self.peek().text == "@":
                self._parse_directives(gq)
            else:
                break
        if self.accept("{"):
            gq.children = self._parse_children(req)
        return gq

    def _parse_count_into(self, gq: GraphQuery) -> None:
        """Parse `(pred)` after the caller consumed the `count` name."""
        self.expect("(")
        inner = self.name()
        gq.is_count = True
        if inner == "uid":
            gq.attr = "uid"
            gq.is_uid_node = True
            if not gq.alias:
                gq.alias = "count"
        else:
            gq.attr = inner
            if self.accept("@"):
                gq.lang = self.name()
            if not gq.alias:
                gq.alias = f"count({inner})"
        self.expect(")")

    # -- math ---------------------------------------------------------------

    # comparisons bind loosest (math(a + 1 > b) parses as (a+1) > b), like
    # the reference's mathOpPrecedence (gql/math.go)
    _MATH_BINOPS = [("<", ">", "<=", ">=", "==", "!="), ("+", "-"),
                    ("*", "/", "%")]

    def _parse_math(self, level: int = 0) -> MathTree:
        if level >= len(self._MATH_BINOPS):
            return self._parse_math_atom()
        left = self._parse_math(level + 1)
        while self.peek().text in self._MATH_BINOPS[level]:
            op = self.next().text
            right = self._parse_math(level + 1)
            left = MathTree(op=op, children=[left, right])
        return left

    def _parse_math_atom(self) -> MathTree:
        t = self.peek()
        if t.text == "(":
            self.next()
            node = self._parse_math(0)
            self.expect(")")
            return node
        if t.kind == "number":
            self.next()
            return MathTree(const=float(t.text) if "." in t.text else int(t.text))
        if t.kind == "name":
            nm = self.next().text
            if self.accept("("):
                if nm == "val":
                    node = MathTree(var=self.name())
                    self.expect(")")
                    return node
                args = [self._parse_math(0)]
                while not self.accept(")"):
                    args.append(self._parse_math(0))
                return MathTree(op=nm, children=args)
            return MathTree(var=nm)
        raise ParseError(f"bad math expression at {t.text!r}")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _unquote(s: str) -> str:
    body = s[1:-1]
    return re.sub(r"\\(.)", lambda m: {"n": "\n", "t": "\t"}.get(m.group(1), m.group(1)), body)


def _parse_uid_str(v: Any) -> int:
    if isinstance(v, int):
        return v
    s = str(v)
    return int(s, 16) if s.startswith("0x") else int(s)


def _split_uid_args(args: list) -> tuple[list[int], list[str]]:
    uids: list[int] = []
    refs: list[str] = []
    for a in args:
        if isinstance(a, VarRef):
            refs.append(a.name)
        elif isinstance(a, list):
            for x in a:
                uids.append(_parse_uid_str(x))
        else:
            try:
                uids.append(_parse_uid_str(a))
            except ValueError:
                refs.append(str(a))
    return uids, refs


def _is_func_ahead(toks: list[Tok], i: int) -> bool:
    """name '(' name ... — looks like a function call, not a key list."""
    return (toks[i].kind == "name" and toks[i + 1].text == "("
            and toks[i].text.lower() in _FUNC_NAMES)


_FUNC_NAMES = {"eq", "le", "lt", "ge", "gt", "anyofterms", "allofterms", "anyoftext",
               "alloftext", "regexp", "near", "within", "contains", "intersects",
               "uid", "uid_in", "has", "checkpwd", "val", "not", "and", "or",
               "similar_to"}


def _collect_math_vars(m: MathTree, out: list[str]) -> None:
    if m.var:
        out.append(m.var)
    for c in m.children:
        _collect_math_vars(c, out)


def _expand_fragments_all(req: ParsedRequest) -> None:
    def expand(children: list[GraphQuery], depth: int = 0) -> list[GraphQuery]:
        if depth > 16:
            raise ParseError("fragment nesting too deep (cycle?)")
        out = []
        for c in children:
            if c.attr == "...":
                if c.alias not in req.fragments:
                    raise ParseError(f"unknown fragment {c.alias}")
                out.extend(expand(req.fragments[c.alias], depth + 1))
            else:
                c.children = expand(c.children, depth)
                out.append(c)
        return out

    for q in req.queries:
        q.children = expand(q.children)


def collect_filter_vars(ft: FilterTree | None, out: list[str]) -> None:
    if ft is None:
        return
    if ft.func is not None:
        for a in ft.func.args:
            if isinstance(a, VarRef):
                out.append(a.name)
    for c in ft.children:
        collect_filter_vars(c, out)


def parse(src: str, gql_vars: dict[str, Any] | None = None) -> ParsedRequest:
    """Parse a DQL request (reference gql.Parse, gql/parser.go:433)."""
    req = _Parser(lex(src), gql_vars or {}, src).parse()
    for q in req.queries:
        collect_filter_vars(q.filter, q.needs_vars)
        _collect_child_needs(q)
    if req.mutations:
        for m in req.mutations:
            start, end = m.pop("rdf_span")
            m["rdf"] = src[start:end]
    return req


def _collect_child_needs(gq: GraphQuery) -> None:
    for c in gq.children:
        collect_filter_vars(c.filter, c.needs_vars)
        _collect_child_needs(c)
