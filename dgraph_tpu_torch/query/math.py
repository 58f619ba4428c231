"""math() expression evaluation over value-variable maps.

Copy of dgraph_tpu/query/math.py for the PyTorch port.

Reference semantics: query/math.go:198 evalMathTree + query/aggregator.go
ApplyVal — per-uid arithmetic over value variables with binary ops
(+ - * / %), unary/named funcs (ln, exp, sqrt, floor, ceil, since, pow,
logbase, max, min, cond, and comparisons). Evaluation runs on the host,
per uid.
"""

from __future__ import annotations

import math as pymath
from datetime import datetime, timezone

from dgraph_tpu_torch.query.dql import MathTree
from dgraph_tpu_torch.utils.types import TypeID, Val


class MathError(ValueError):
    pass


def _num(v: Val) -> float:
    if v.tid == TypeID.INT:
        return float(v.value)
    if v.tid == TypeID.FLOAT:
        return float(v.value)
    if v.tid == TypeID.BOOL:
        return 1.0 if v.value else 0.0
    if v.tid == TypeID.DATETIME:
        return v.value.timestamp()
    raise MathError(f"non-numeric value in math: {v!r}")


def _wrap(x: float, prefer_int: bool) -> Val:
    if prefer_int and float(x).is_integer() and abs(x) < 2**53:
        return Val(TypeID.INT, int(x))
    return Val(TypeID.FLOAT, float(x))


_BINOPS = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b if b != 0 else (_ for _ in ()).throw(MathError("division by zero")),
    "%": lambda a, b: pymath.fmod(a, b) if b != 0 else (_ for _ in ()).throw(MathError("mod by zero")),
    "pow": lambda a, b: a ** b,
    "logbase": lambda a, b: pymath.log(a, b),
    "max": max,
    "min": min,
    "<": lambda a, b: a < b, ">": lambda a, b: a > b,
    "<=": lambda a, b: a <= b, ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
}

_UNOPS = {
    "ln": pymath.log,
    "exp": pymath.exp,
    "sqrt": pymath.sqrt,
    "floor": pymath.floor,
    "ceil": pymath.ceil,
    "u-": lambda a: -a,
    "since": lambda ts: datetime.now(timezone.utc).timestamp() - ts,
}


def eval_math(tree: MathTree, variables: dict, frontier) -> dict[int, Val]:
    """Evaluate per-uid over the union of var keys restricted to frontier."""
    uids = [int(u) for u in frontier]
    out: dict[int, Val] = {}
    for u in uids:
        try:
            v = _eval_for(tree, variables, u)
        except KeyError:
            continue
        except MathError:
            continue
        if v is not None:
            out[u] = v
    return out


def _eval_for(t: MathTree, variables: dict, uid: int) -> Val | None:
    if t.var:
        vv = variables.get(t.var)
        if vv is None or uid not in vv.vals:
            raise KeyError(t.var)
        return vv.vals[uid]
    if t.const is not None:
        return Val(TypeID.INT, t.const) if isinstance(t.const, int) else Val(TypeID.FLOAT, t.const)
    if t.op == "cond":
        c = _eval_for(t.children[0], variables, uid)
        branch = t.children[1] if c is not None and _num(c) != 0 else t.children[2]
        return _eval_for(branch, variables, uid)
    vals = [_eval_for(c, variables, uid) for c in t.children]
    if any(v is None for v in vals):
        return None
    prefer_int = all(v.tid == TypeID.INT for v in vals)
    if t.op in _BINOPS and len(vals) == 2:
        r = _BINOPS[t.op](_num(vals[0]), _num(vals[1]))
        if isinstance(r, bool):
            return Val(TypeID.BOOL, r)
        return _wrap(r, prefer_int and t.op not in ("/",))
    if t.op in _UNOPS and len(vals) == 1:
        return _wrap(_UNOPS[t.op](_num(vals[0])), False)
    if t.op in ("max", "min"):
        f = max if t.op == "max" else min
        return _wrap(f(_num(v) for v in vals), prefer_int)
    raise MathError(f"unknown math op {t.op!r}/{len(vals)} args")
