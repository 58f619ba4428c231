"""Typed aggregation engine (reference query/aggregator.go:91-257).

Copy of dgraph_tpu/query/aggregator.py for the PyTorch port.

min / max / sum / avg over Val lists, with numeric widening: int+int stays
int for sum; avg is float; min/max work on any comparable type (datetime,
string) as the reference's aggregator does.
"""

from __future__ import annotations

from dgraph_tpu_torch.utils.types import TypeID, Val, compare_vals


def aggregate(op: str, vals: list[Val]) -> Val | None:
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    if op in ("min", "max"):
        best = vals[0]
        cmp = "lt" if op == "min" else "gt"
        for v in vals[1:]:
            try:
                if compare_vals(cmp, v, best):
                    best = v
            except ValueError:
                continue
        return best
    if op in ("sum", "avg"):
        nums = []
        any_float = False
        for v in vals:
            if v.tid == TypeID.INT:
                nums.append(int(v.value))
            elif v.tid == TypeID.FLOAT:
                nums.append(float(v.value))
                any_float = True
            else:
                continue
        if not nums:
            return None
        total = sum(nums)
        if op == "avg":
            return Val(TypeID.FLOAT, float(total) / len(nums))
        return Val(TypeID.FLOAT, float(total)) if any_float else Val(TypeID.INT, int(total))
    raise ValueError(f"unknown aggregate {op}")
