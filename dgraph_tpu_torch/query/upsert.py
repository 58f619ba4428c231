"""Upsert blocks: query + conditional mutation in one transaction.

Copy of dgraph_tpu/query/upsert.py for the PyTorch port.

Reference semantics: the DQL upsert block (gql/upsert.go ParseMutation,
edgraph/server.go doQueryInUpsert): the query runs first at the txn's
start_ts, its variables feed `@if` conditions (`eq(len(v), 0)`) and
`uid(v)` / `val(v)` terms inside mutation quads, and only the surviving
mutations apply. Empty variables drop the quads that reference them.

This module is engine-agnostic: it maps (parsed NQuads, executor vars) to
concrete NQuads and evaluates cond trees; Node.upsert (api/server.py) owns
the txn plumbing.
"""

from __future__ import annotations

import re

from dgraph_tpu_torch.query import rdf

_CMP = {
    "eq": lambda a, b: a == b,
    "le": lambda a, b: a <= b,
    "lt": lambda a, b: a < b,
    "ge": lambda a, b: a >= b,
    "gt": lambda a, b: a > b,
}


class UpsertError(ValueError):
    pass


def _var_uids(vars_map: dict, name: str) -> list[int]:
    vv = vars_map.get(name)
    if vv is None:
        return []
    if vv.uids is not None:
        return [int(u) for u in vv.uids]
    return sorted(int(u) for u in vv.vals)


def expand(nquads: list[rdf.NQuad], vars_map: dict) -> list[rdf.NQuad]:
    """Resolve uid(v)/val(v) terms against the query's variables.

    - `uid(v) <p> o`   → one quad per uid bound to v (none → dropped)
    - `s <p> uid(v)`   → one quad per uid (cross product with subject)
    - `s <p> val(v)`   → the value v recorded FOR THAT SUBJECT uid
                         (subjects with no value are dropped)
    """
    out: list[rdf.NQuad] = []
    for nq in nquads:
        subjects = ([f"0x{u:x}" for u in _var_uids(vars_map, nq.subject_var)]
                    if nq.subject_var else [nq.subject])
        objects = ([f"0x{u:x}" for u in _var_uids(vars_map, nq.object_var)]
                   if nq.object_var else [None])
        for s in subjects:
            for o in objects:
                if nq.val_var:
                    vv = vars_map.get(nq.val_var)
                    if vv is None:
                        continue
                    try:
                        su = int(s, 16) if s.startswith("0x") else int(s)
                    except ValueError:
                        raise UpsertError(
                            f"val({nq.val_var}) needs a concrete subject "
                            f"uid, got {s!r}") from None
                    v = vv.vals.get(su)
                    if v is None:
                        continue
                    out.append(rdf.NQuad(
                        subject=s, predicate=nq.predicate, object_value=v,
                        lang=nq.lang, facets=list(nq.facets)))
                else:
                    out.append(rdf.NQuad(
                        subject=s, predicate=nq.predicate,
                        object_id=o if o is not None else nq.object_id,
                        object_value=nq.object_value, lang=nq.lang,
                        facets=list(nq.facets), star=nq.star))
    return out


# ---------------------------------------------------------------------------
# @if(...) condition trees: cmp(len(v), N) atoms + AND / OR / NOT / parens
# (gql/upsert.go parseCondition — same surface)
# ---------------------------------------------------------------------------

_TOK = re.compile(
    r"\s*(?:(?P<cmp>eq|le|lt|ge|gt)\s*\(\s*len\s*\(\s*(?P<var>[A-Za-z0-9_]+)"
    r"\s*\)\s*,\s*(?P<num>\d+)\s*\)|(?P<op>[()]|and|or|not|AND|OR|NOT))")


def _lex_cond(src: str) -> list:
    toks, i = [], 0
    while i < len(src):
        if src[i:].strip() == "":
            break
        m = _TOK.match(src, i)
        if not m:
            raise UpsertError(f"bad @if condition near {src[i:]!r}")
        if m.group("cmp"):
            toks.append(("atom", m.group("cmp"), m.group("var"),
                         int(m.group("num"))))
        else:
            toks.append(("op", m.group("op").lower()))
        i = m.end()
    return toks


def eval_cond(cond: str, vars_map: dict) -> bool:
    """Evaluate an @if condition. `cond` is the text inside @if(...)."""
    toks = _lex_cond(cond)
    pos = [0]

    def peek():
        return toks[pos[0]] if pos[0] < len(toks) else None

    def eat():
        t = toks[pos[0]]
        pos[0] += 1
        return t

    def atom() -> bool:
        t = peek()
        if t is None:
            raise UpsertError("empty @if condition")
        if t == ("op", "not"):
            eat()
            return not atom()
        if t == ("op", "("):
            eat()
            v = expr()
            if peek() != ("op", ")"):
                raise UpsertError("unbalanced parens in @if")
            eat()
            return v
        if t[0] == "atom":
            eat()
            _, cmp_name, var, num = t
            return _CMP[cmp_name](len(_var_uids(vars_map, var)), num)
        raise UpsertError(f"unexpected token in @if: {t}")

    def and_expr() -> bool:
        v = atom()
        while peek() == ("op", "and"):
            eat()
            v = atom() and v   # evaluate both: keep parse position moving
        return v

    def expr() -> bool:   # AND binds tighter than OR (gql filter precedence)
        v = and_expr()
        while peek() == ("op", "or"):
            eat()
            v = and_expr() or v
        return v

    out = expr()
    if pos[0] != len(toks):
        raise UpsertError("trailing tokens in @if condition")
    return out
