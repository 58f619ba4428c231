"""@groupby: group a level's uids by attribute values, aggregate per group.

Reference semantics: query/groupby.go — dedup maps value→uid-list per group
attr (:91-140); formGroups crosses group keys intersecting uid lists via
algo.IntersectSorted (:169); count/min/max/sum/avg per group (:43-75);
processGroupBy (:371); groupby value vars fillGroupedVars (:274).

Port of dgraph_tpu/query/groupby.py. Grouping is a segmented reduction:
uids map to group ids (factorize over value/neighbor keys) and aggregates
are one ops/segments pass per (group attr, agg) pair on the snapshot's
device once a group set passes _HOST_AGG_MAX members; the host covers
smaller sets and string/datetime keys. The device functions run on
`ex.snap.device`, so a CPU snapshot reduces with torch ops on CPU tensors.

Grouped vars (fillGroupedVars): where a block groups by one uid
predicate, an aggregate child written `x as <agg>` binds x, in a `var`
block and a rendered one alike, mapping each group's key uid to the value
its row shows (count(uid): the distinct members, an INT). The var is
bound as columns (engine.ValueColumns), sorted by key. A value key, or
two keys or more, binds nothing (the reference refuses those; the JAX
package binds no grouped var at all). A `var` block whose children are
all count(uid) builds no rows: its member expand takes the expand's own
route (task.expand_route), and where the targets stay on the card and
pass _HOST_AGG_MAX, they are counted there against the level's dest
(segments.count_in_table), since a posting list is a set and the members
are distinct: the keys and counts come back once, and the targets never.
Every other block assembles its rows as before and binds its vars from
them. process_groupby is the `groupby` span; its time, the groups, the
member–key pairs, the counts made on the card and the keys bound are
booked in the request's registry (dgraph_groupby_*, dgraph_grouped_var_
keys_total).

`fused` is the device terminal a whole-plan mesh fusion stashes on the
level (engine._mesh_fused_plan): per key-rank member counts and f32 agg
candidates, held against the host assembly (which stays authoritative) by
_fused_check_counts and _check_fused_agg. `[uid]` group keys reach them
through the rank-space path here (the JAX package takes its dict path;
the rows are the same). With a plan (query/planner.py) the @groupby step
records its group count for EXPLAIN.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from dgraph_tpu_torch.obs import costs, otrace
from dgraph_tpu_torch.query import dql
from dgraph_tpu_torch.query.aggregator import aggregate
from dgraph_tpu_torch.query.task import TaskQuery
from dgraph_tpu_torch.utils.types import TypeID, Val


VECTORIZE = True    # tests flip to force the per-uid reference path

# up to this member count the vectorized HOST segmented reduction beats the
# device pass's copies and sync: on an H100 80GB HBM3 at 700 W
# (bench_torch_crossover.py section 4) the host won at 2^14 members (0.22
# against 0.35 ms, 100 groups) and lost at 2^16 (1.01 against 0.65 ms)
_HOST_AGG_MAX = 1 << 15

# groupby key expansions pin the HOST mirrors (resolve_leaf's "task"
# idiom): under whole-plan fusion the aggregation already reduced on the
# mesh — the host assembly must not cost a second device dispatch
_PIN_HOST = 1 << 62


def process_groupby(ex, sg) -> None:
    """Fill sg.group_result for a level with @groupby, and bind its
    grouped vars."""
    gq = sg.gq
    t0 = time.perf_counter_ns()
    with otrace.span("groupby"):
        binds = _grouped_var_children(ex, gq)
        ngroups = _count_only(ex, sg, binds) if binds else None
        if ngroups is not None:
            sg.group_result = []
        else:
            vals_out: dict | None = {} if binds else None
            sg.group_result = _build_group_rows(ex, sg, vals_out)
            ngroups = len(sg.group_result)
            if binds:
                _bind_from_rows(ex, gq, binds, sg.group_result, vals_out)
        if ex.plan is not None:
            # EXPLAIN: the planner's groupby terminal step (keyed on the
            # GroupBy AST node) records the actual group count
            ex.plan.record(gq.groupby, ngroups, ex.explain)
    otrace.count("dgraph_groupby_ns_total", time.perf_counter_ns() - t0)
    otrace.count("dgraph_groupby_groups_total", ngroups)


def _uid_key(ex, attr: str) -> bool:
    pd = ex.snap.pred(attr)
    return ex.schema.type_of(attr) == TypeID.UID or (
        pd is not None and pd.csr is not None)


def _grouped_var_children(ex, gq) -> list:
    """The aggregate children that bind a grouped var: those with a var
    name, where the block groups by exactly one uid predicate; else
    none."""
    if len(gq.groupby.attrs) != 1:
        return []
    _alias, attr, lang = gq.groupby.attrs[0]
    if lang or not _uid_key(ex, attr):
        return []
    return [c for c in gq.children if c.var_name and (
        (c.is_uid_node and c.is_count) or c.attr.startswith("__agg_"))]


def _count_only(ex, sg, binds) -> int | None:
    """A `var` block's count(uid) grouped vars with no rows built: binds
    each var to (keys, counts) as columns and returns the group count, or
    None where the block renders rows, asks for another aggregate, or its
    key tablet is overlaid or sharded (the rows path serves those)."""
    from dgraph_tpu_torch.query.engine import ValueColumns, VarValue, _sorted
    from dgraph_tpu_torch.storage.delta import OverlayCSR

    gq = sg.gq
    if gq.attr != "var" or getattr(sg, "_fused_gb", None) is not None or \
            not all(c.is_uid_node and c.is_count for c in gq.children):
        return None
    attr = gq.groupby.attrs[0][1]
    pd = ex.snap.pred(attr)
    csr = pd.csr if pd is not None else None
    if isinstance(csr, OverlayCSR) or getattr(csr, "is_dist", False):
        return None
    uids = _sorted(sg.dest_uids)
    keys, counts, keys_dev = np.zeros(0, np.int64), np.zeros(0, np.int64), None
    pairs = 0
    if len(uids):
        res = ex._dispatch(TaskQuery(attr, frontier=uids))
        matrix = res.uid_matrix
        pairs = int(matrix.offsets[-1])
        flat_d = matrix.on_card()
        if flat_d is not None and res.dest_dev is not None and \
                pairs > _HOST_AGG_MAX:
            from dgraph_tpu_torch.ops import segments as segs

            with costs.kernel("segments.count_in_table", pairs=pairs) as ck:
                counts = segs.count_in_table(res.dest_dev,
                                             flat_d).cpu().numpy()
                ck.set(d2h=int(counts.nbytes))
            keys, keys_dev = res.dest_uids, res.dest_dev
            otrace.count("dgraph_groupby_on_device_total")
        elif pairs:
            keys, counts = np.unique(matrix.flat, return_counts=True)
    otrace.count("dgraph_groupby_pairs_total", pairs)
    for c in binds:
        ex.vars[c.var_name] = VarValue(
            is_uid=False, cols=ValueColumns(keys, counts, TypeID.INT,
                                            keys_dev))
    otrace.count("dgraph_grouped_var_keys_total", len(keys) * len(binds))
    return len(keys)


def _bind_from_rows(ex, gq, binds, rows: list[dict], vals_out: dict) -> None:
    """Bind each grouped var from the assembled rows: the key uid of each
    row (its hex display) and the Val its aggregate gave the row."""
    from dgraph_tpu_torch.query.engine import ValueColumns, VarValue

    alias, attr, _lang = gq.groupby.attrs[0]
    keys = np.asarray([int(r[alias or attr], 16) for r in rows],
                      dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    bound = 0
    for c in binds:
        per_group = vals_out.get(id(c)) or [None] * len(rows)
        got = [(int(keys[i]), per_group[i]) for i in order.tolist()
               if per_group[i] is not None]
        tids = {v.tid for _, v in got}
        cols = None
        if len(tids) == 1 and tids <= {TypeID.INT, TypeID.FLOAT}:
            tid = tids.pop()
            try:
                values = np.asarray([v.value for _, v in got],
                                    dtype=np.int64 if tid == TypeID.INT
                                    else np.float64)
            except OverflowError:
                values = None          # an INT past int64: the dict holds it
            if values is not None:
                cols = ValueColumns(
                    np.asarray([k for k, _ in got], dtype=np.int64), values,
                    tid)
        ex.vars[c.var_name] = VarValue(is_uid=False, cols=cols) \
            if cols is not None else VarValue(vals=dict(got), is_uid=False)
        bound += len(got)
    otrace.count("dgraph_grouped_var_keys_total", bound)


def _build_group_rows(ex, sg, vals_out: dict | None = None) -> list[dict]:
    """The block's rows; vals_out (when given) takes each var child's Val
    per row (_assemble_rows)."""
    gq = sg.gq
    fused = getattr(sg, "_fused_gb", None)
    uids = np.sort(sg.dest_uids)
    if len(uids) == 0:
        return []

    # vectorized fast path: a single NUMERIC value key groups via one
    # searchsorted + np.unique over the exact float64 mirror — no per-uid
    # Python (the segmented-reduction stance of the module docstring,
    # applied to the grouping itself)
    fast = _numeric_single_key_groups(ex, gq, uids)
    if fast is not None:
        keys_sorted, members_per, alias = fast
        return _assemble_rows(
            ex, gq, [{alias: kv} for kv in keys_sorted], members_per, fused,
            vals_out)

    # vectorized GENERAL path: every column — string/bool/datetime
    # value keys and multi-valued uid keys alike — factorizes to dense int
    # codes (one cached pass per predicate per snapshot), multi-key groups
    # are a vectorized cartesian join of the code columns (mixed-radix
    # packed), and members come from one argsort. Per-uid Python only
    # remains for lang-tagged keys, [list] scalar keys, and remote value
    # tablets (the dict fallback below).
    if VECTORIZE:
        vec = _vectorized_groups(ex, gq, uids)
        if vec is not None:
            row_seeds, members_per = vec
            return _assemble_rows(ex, gq, row_seeds, members_per, fused,
                                  vals_out)

    # group keys per uid, one column per groupby attr
    columns: list[tuple[str, dict[int, Any]]] = []  # (alias, uid -> key val)
    for alias, attr, lang in gq.groupby.attrs:
        col: dict[int, Any] = {}
        if _uid_key(ex, attr):
            res = ex._dispatch(TaskQuery(attr, frontier=uids,
                                         cutover=_PIN_HOST))
            for u, targets in zip(uids, res.uid_matrix):
                for t in targets:
                    col.setdefault(int(u), []).append(int(t))
        else:
            # value keys through the dispatch seam: the tablet may live on
            # a remote group where ex.snap has no local arrays
            res = ex._dispatch(TaskQuery(attr, frontier=uids, lang=lang))
            for u, vals in zip(uids, res.value_matrix):
                if vals:
                    col[int(u)] = vals[0]
        columns.append((alias or attr, col))

    # build group map: key tuple -> member uids (uid attrs contribute each edge)
    groups: dict[tuple, list[int]] = {}
    for u in uids:
        keysets: list[list] = []
        for _alias, col in columns:
            v = col.get(int(u))
            if v is None:
                keysets = []
                break
            keysets.append(v if isinstance(v, list) else [v])
        if not keysets:
            continue
        # cartesian over multi-valued (uid) group attrs
        from itertools import product

        for combo in product(*keysets):
            key = tuple(_group_key(x) for x in combo)
            groups.setdefault(key, []).append(int(u))

    # aggregates from the block's children — numeric ops run as ONE
    # segmented reduction across every group (ops/segments.py); count and
    # non-numeric min/max fall back per group
    keys_sorted = sorted(groups.keys(), key=repr)
    members_per = [np.unique(np.asarray(groups[k], dtype=np.int64))
                   for k in keys_sorted]
    seeds = []
    for key in keys_sorted:
        row: dict = {}
        for (alias, _col), kv in zip(columns, key):
            row[alias] = kv if not isinstance(kv, tuple) else kv[1]
        seeds.append(row)
    return _assemble_rows(ex, gq, seeds, members_per, fused, vals_out)


def _pred_value_codes(pd):
    """Factorize a predicate's stored (untagged, non-list) values to dense
    codes — ONCE per immutable snapshot, cached on the PredData. Returns
    (value_subjects int64[N], codes int64[N], displays list, ok bool[N])
    where ok=False marks lang-only subjects (no untagged value). Group
    identity is the display (_val_json) value, exactly like _group_key."""
    got = getattr(pd, "_gb_codes", None)
    if got is not None:
        return got
    if pd.value_subjects_host is None:
        return None
    from dgraph_tpu_torch.query.outputnode import _val_json

    vsub = pd.value_subjects_host
    code_of: dict = {}
    displays: list = []
    codes = np.zeros(len(vsub), dtype=np.int64)
    ok = np.ones(len(vsub), dtype=bool)
    for i, u in enumerate(vsub.tolist()):
        v = pd.host_values.get(int(u))
        if v is None:
            ok[i] = False
            continue
        j = _val_json(v)
        k = j if isinstance(j, (str, int, float, bool)) else repr(j)
        c = code_of.get(k)
        if c is None:
            c = code_of[k] = len(displays)
            displays.append(j)
        codes[i] = c
    pd._gb_codes = (vsub, codes, displays, ok)
    return pd._gb_codes


def _uid_key_table(pd):
    """(sorted distinct-target table int64, hex display list) of a uid-key
    predicate — cached once per immutable CSR. Group codes become one
    rank lookup per edge against this table; it is also the rank space the
    fused mesh terminal reduces into, so host group order and device
    segment ids agree by construction."""
    csr = pd.csr if pd is not None else None
    if csr is None:
        return None
    got = getattr(csr, "_gb_tgt", None)
    if got is not None:
        return got
    try:
        _sub, _ptr, idx = csr.host_arrays()
    except (AttributeError, ValueError):
        return None
    tbl = np.unique(np.asarray(idx, dtype=np.int64))
    csr._gb_tgt = (tbl, [hex(int(t)) for t in tbl])
    return csr._gb_tgt


def _cartesian_join(a_uidx, a_code, b_uidx, b_code, kb: int, n_uids: int):
    """Per-uid cartesian of two (uidx, code) entry columns (both sorted by
    uidx): every (a, b) pair of the same uid, codes packed a*kb + b."""
    if len(b_uidx) == 0 or len(a_uidx) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if np.all(np.diff(b_uidx) > 0):
        # single-valued right column (the common multi-key shape): the
        # cartesian is a merge-join — one searchsorted, no repeat machinery
        if len(b_uidx) == n_uids:
            # b covers every uid: b_uidx IS arange(n) — identity join
            return a_uidx, a_code * kb + b_code[a_uidx]
        pos = np.searchsorted(b_uidx, a_uidx)
        posc = np.clip(pos, 0, len(b_uidx) - 1)
        hit = b_uidx[posc] == a_uidx
        return a_uidx[hit], a_code[hit] * kb + b_code[posc[hit]]
    cnt_b = np.bincount(b_uidx, minlength=n_uids)
    b_start = np.zeros(n_uids + 1, dtype=np.int64)
    np.cumsum(cnt_b, out=b_start[1:])
    rep = cnt_b[a_uidx]
    total = int(rep.sum())
    offs = np.zeros(len(a_uidx) + 1, dtype=np.int64)
    np.cumsum(rep, out=offs[1:])
    idx_a = np.repeat(np.arange(len(a_uidx)), rep)
    within = np.arange(total) - np.repeat(offs[:-1], rep)
    out_uidx = a_uidx[idx_a]
    b_idx = b_start[out_uidx] + within
    return out_uidx, a_code[idx_a] * kb + b_code[b_idx]


def _vectorized_groups(ex, gq, uids: np.ndarray):
    """(row_seeds, members_per) for the general multi-key case, or None
    when a column needs the per-uid fallback."""
    from dgraph_tpu_torch.ops.uidset import host_rank_of

    if not gq.groupby.attrs:
        return None            # empty @groupby(): dict path's shape
    # eligibility pre-pass BEFORE any dispatch — a late fallback would make
    # the dict path re-run every uid traversal already paid here. A [uid]
    # key is multi-valued by nature and codes through the rank table like
    # any uid key; only [scalar] list keys keep the dict path's
    # first-value semantics. (The JAX package tests is_list first and so
    # sends [uid] keys to the dict path too: the same groups, per uid.)
    for _alias, attr, lang in gq.groupby.attrs:
        if lang:
            return None
        pd = ex.snap.pred(attr)
        if not _uid_key(ex, attr) and (ex.schema.is_list(attr) or pd is None
                           or _pred_value_codes(pd) is None):
            return None        # list / remote / no value table: dict path

    n = len(uids)
    cols = []        # (alias, uidx int64[], code int64[], displays, single)
    for alias, attr, lang in gq.groupby.attrs:
        pd = ex.snap.pred(attr)
        if _uid_key(ex, attr):
            res = ex._dispatch(TaskQuery(attr, frontier=uids,
                                         cutover=_PIN_HOST))
            counts = res.uid_matrix.counts()
            flat = res.uid_matrix.flat
            uidx = np.repeat(np.arange(n), counts)
            # rank-space coding: codes are ranks in the tablet's cached
            # distinct-target table (one searchsorted — host below the
            # device cutover, segments._rank_kernel above it) instead of a
            # fresh per-query np.unique sort; targets the table does not
            # know (overlay-added edges) fall back to the sort
            code = displays = None
            tbl = _uid_key_table(pd)
            if tbl is not None and len(flat):
                from dgraph_tpu_torch.ops import segments as segs

                pos, hitt = segs.rank_in_table(tbl[0], flat,
                                               device=ex.snap.device)
                if hitt.all():
                    code, displays = pos, tbl[1]
            if code is None:
                targets, code = np.unique(flat, return_inverse=True)
                displays = [hex(int(t)) for t in targets]
            single = False          # multi-valued: dedup members later
        else:
            vsub, vcodes, displays, vok = _pred_value_codes(pd)
            if len(vsub) == n and vsub[0] == uids[0] \
                    and vsub[-1] == uids[-1] and np.array_equal(vsub, uids):
                # aligned case: every uid has a value slot — no rank search
                uidx = np.flatnonzero(vok)
                code = vcodes[vok]
            else:
                pos = host_rank_of(vsub, uids, -1)
                keep = (pos >= 0)
                keep[keep] = vok[pos[keep]]
                uidx = np.flatnonzero(keep)
                code = vcodes[pos[keep]]
            single = True           # <= one entry per uid by construction
        cols.append((alias or attr, uidx.astype(np.int64),
                     np.asarray(code, dtype=np.int64), displays, single))

    import math

    _alias0, uidx, code, _d0, _s0 = cols[0]
    bases = [len(cols[0][3])]
    for _alias_k, uidx_k, code_k, disp_k, _sk in cols[1:]:
        kb = max(len(disp_k), 1)
        if math.prod(max(b, 1) for b in bases) * kb > 2 ** 62:
            return None          # packed code would overflow: fallback
        uidx, code = _cartesian_join(uidx, code, uidx_k, code_k, kb, n)
        bases.append(kb)
    if len(uidx) == 0:
        return [], []

    # one stable sort does both factorization and member extraction;
    # uidx is already ascending, so within a group members come out sorted
    if code.size and int(code.max()) < 2 ** 31:
        code = code.astype(np.int32)   # radix-sorts ~2x faster
    order = np.argsort(code, kind="stable")
    sc = code[order]
    brk = np.flatnonzero(np.concatenate(
        [np.ones(1, bool), sc[1:] != sc[:-1]]))
    gkeys = sc[brk]
    bounds = np.concatenate([brk, [len(sc)]])
    multi = any(not c[4] for c in cols)   # any multi-valued (uid) column
    members_per = []
    for i in range(len(gkeys)):
        m = uids[uidx[order[bounds[i]: bounds[i + 1]]]]
        members_per.append(np.unique(m) if multi else m)
    rows = []
    for gk in gkeys.tolist():
        parts = []
        for kb in reversed(bases[1:]):
            parts.append(gk % kb)
            gk //= kb
        parts.append(gk)
        parts.reverse()
        row = {}
        for (alias, _u, _c, displays, _s), p in zip(cols, parts):
            row[alias] = displays[int(p)]
        rows.append(row)
    # match the dict path's group order: repr of the key tuple
    perm = sorted(range(len(rows)),
                  key=lambda i: repr(tuple(rows[i].values())))
    return [rows[i] for i in perm], [members_per[i] for i in perm]


def _host_segment_reduce(op: str, seg: np.ndarray, vals: np.ndarray,
                         ng: int) -> np.ndarray:
    """float64 segmented reduction via ufunc.at (inputs pre-filtered to
    valid entries); empty groups yield NaN."""
    cnt = np.zeros(ng, dtype=np.int64)
    np.add.at(cnt, seg, 1)
    if op in ("sum", "avg"):
        out = np.zeros(ng, dtype=np.float64)
        np.add.at(out, seg, vals)
        if op == "avg":
            out = out / np.maximum(cnt, 1)
    elif op == "min":
        out = np.full(ng, np.inf)
        np.minimum.at(out, seg, vals)
    else:
        out = np.full(ng, -np.inf)
        np.maximum.at(out, seg, vals)
    return np.where(cnt == 0, np.nan, out)


def _count_metric(ex, name: str) -> None:
    m = getattr(ex.snap, "metrics", None)
    if m is not None:
        m.counter(name).inc()


def _batch_aggregates(ex, children, members_per: list[np.ndarray],
                      fused=None, ranks=None, vals_out=None) -> dict:
    """Per-child batched aggregation: {id(child): [row_dict per group]};
    vals_out (when given) takes {id(child): [Val or None per group]}.

    Children whose op/type can't run on the float64 lattice are omitted —
    the caller falls back to the per-group path for those.

    fused/ranks: the stashed device terminal of a whole-plan mesh fusion
    (engine._mesh_fused_plan) plus each group's rank in its key table.
    The host stays authoritative (no second dispatch); wherever the
    f32-exactness rule holds the device candidates are cross-checked
    against the host result and any disagreement is a hard error."""
    from dgraph_tpu_torch.ops import segments as segs
    from dgraph_tpu_torch.query.outputnode import _val_json
    from dgraph_tpu_torch.utils.types import to_device_scalar

    ng = len(members_per)
    if ng == 0:
        return {}
    lens = np.asarray([len(m) for m in members_per], dtype=np.int64)
    flat = np.concatenate(members_per) if ng else np.zeros(0, np.int64)
    out: dict = {}
    for cgq in children:
        if not (cgq.attr.startswith("__agg_") and cgq.val_ref):
            continue
        op = cgq.attr[len("__agg_"):]
        if op not in ("sum", "avg", "min", "max"):
            continue
        vv = ex.vars.get(cgq.val_ref)
        if vv is None or not vv.vals:
            continue
        vuids = np.asarray(sorted(vv.vals), dtype=np.int64)
        raw = [vv.vals[int(u)] for u in vuids]
        scalars = [to_device_scalar(v) if isinstance(v, Val) else float(v)
                   for v in raw]
        if any(s is None for s in scalars):
            continue   # string/geo values: host path handles them
        tids = {v.tid for v in raw if isinstance(v, Val)}
        if op in ("min", "max") and not tids <= {TypeID.INT, TypeID.FLOAT}:
            continue   # min/max must return the original Val (datetime etc.)
        vals64 = np.asarray(scalars, dtype=np.float64)
        pos = np.searchsorted(vuids, flat)
        posc = np.clip(pos, 0, max(len(vuids) - 1, 0))
        hit = (len(vuids) > 0) & (vuids[posc] == flat)
        all_int = tids <= {TypeID.INT}
        f32_exact = all_int and np.abs(vals64).sum() < 2 ** 24
        if fused is None and f32_exact and len(flat) > _HOST_AGG_MAX:
            # exact in f32: one fused device reduction with segment ids
            # derived ON DEVICE from the group lengths (only worth the
            # fixed dispatch+sync cost above the host crossover — the
            # same size-adaptive rule as task.HOST_EXPAND_MAX)
            x = np.where(hit, vals64[posc], np.nan).astype(np.float32)
            res = segs.fused_group_reduce((op,), x, lens, ng,
                                          device=ex.snap.device)[op]
            _count_metric(ex, "dgraph_agg_device_reduces_total")
        else:
            # float64 exactness the f32 device candidates can't give:
            # vectorized host segmented reduction, same semantics
            seg_ids = np.repeat(np.arange(ng, dtype=np.int32), lens)
            res = _host_segment_reduce(op, seg_ids[hit], vals64[posc[hit]],
                                       ng)
            _count_metric(ex, "dgraph_agg_host_reduces_total")
        if fused is not None and ranks is not None:
            _check_fused_agg(fused, cgq, op, res, ranks, f32_exact)
        name = cgq.alias or f"{op}(val({cgq.val_ref}))"
        rows, vals = [], []
        for g in range(ng):
            r = float(res[g])
            if np.isnan(r):
                rows.append({})
                vals.append(None)
                continue
            if op == "avg":
                v = Val(TypeID.FLOAT, r)
            elif all_int:
                v = Val(TypeID.INT, int(round(r)))
            else:
                v = Val(TypeID.FLOAT, r)
            rows.append({name: _val_json(v)})
            vals.append(v)
        out[id(cgq)] = rows
        if vals_out is not None:
            vals_out[id(cgq)] = vals
    return out


def _check_fused_agg(fused, cgq, op, res, ranks, f32_exact) -> None:
    """Cross-check a device terminal agg candidate against the host's
    authoritative f64 result. Only where the f32-exactness rule holds —
    outside it the candidates are best-effort and skipped."""
    cand = fused.get("aggs", {}).get(id(cgq))
    if cand is None or not f32_exact:
        return
    from dgraph_tpu_torch.query.engine import QueryError

    vals = np.asarray(cand["cand"], dtype=np.float64)[ranks]
    cntv = np.asarray(cand["cntv"], dtype=np.float64)[ranks]
    empty = np.isnan(res)
    if np.any(empty & (cntv != 0)):
        raise QueryError("mesh fused aggregation diverged (empty groups)")
    got = vals
    if op == "avg":
        got = vals / np.maximum(cntv, 1.0)
    if not np.array_equal(got[~empty], res[~empty]):
        raise QueryError("mesh fused aggregation diverged")


def _fused_check_counts(fused, row_seeds, members_per) -> np.ndarray:
    """Map each host group to its rank in the device terminal's key table
    and require the device per-rank member counts to agree EXACTLY with
    the host replay — the byte-identity invariant of the fused terminal.
    Returns the per-group rank vector for the agg cross-checks."""
    from dgraph_tpu_torch.query.engine import QueryError

    table = fused["table"]
    counts = np.asarray(fused["counts"], dtype=np.int64)
    keys = np.asarray(
        [int(next(iter(r.values()), "0x0"), 16) for r in row_seeds],
        dtype=np.int64)
    pos = np.searchsorted(table, keys)
    bad = (pos >= len(table)) | (pos < 0)
    if bad.any() or (len(keys) and not np.array_equal(table[pos], keys)):
        raise QueryError("mesh fused groupby terminal diverged (keys)")
    host_counts = np.asarray([len(m) for m in members_per], dtype=np.int64)
    if not np.array_equal(counts[pos], host_counts) \
            or np.count_nonzero(counts) != len(keys):
        raise QueryError("mesh fused groupby terminal diverged (counts)")
    return pos


def _assemble_rows(ex, gq, row_seeds: list[dict],
                   members_per: list[np.ndarray], fused=None,
                   vals_out: dict | None = None) -> list[dict]:
    """Attach each group's child aggregates to its key row (shared by the
    vectorized and generic grouping paths). vals_out (when given) takes
    {id(child): [Val or None per row]} for each child with a var name.
    Books the member–group pairs in dgraph_groupby_pairs_total."""
    from dgraph_tpu_torch.query.outputnode import _val_json

    ranks = None
    if fused is not None:
        ranks = _fused_check_counts(fused, row_seeds, members_per)
    batched = _batch_aggregates(ex, gq.children, members_per, fused, ranks,
                                vals_out)
    per_group = set() if vals_out is None else \
        {id(c) for c in gq.children if c.var_name and id(c) not in batched}
    for k in per_group:
        vals_out[k] = []
    for gi, row in enumerate(row_seeds):
        for cgq in gq.children:
            got = batched.get(id(cgq))
            if got is not None:
                row.update(got[gi])
                continue
            name, v = _group_agg_val(ex, cgq, members_per[gi])
            if v is not None:
                row[name] = _val_json(v)
            if id(cgq) in per_group:
                vals_out[id(cgq)].append(v)
    otrace.count("dgraph_groupby_pairs_total",
                 sum(len(m) for m in members_per))
    return row_seeds


def _numeric_single_key_groups(ex, gq, uids):
    """(sorted key-json list, member arrays, alias) for the vectorized
    single-numeric-key case, else None (generic path). Requires the key
    predicate's exact numeric mirror locally (non-list INT/FLOAT/BOOL/
    DATETIME); string keys and remote tablets keep the generic path."""
    if len(gq.groupby.attrs) != 1:
        return None
    alias, attr, lang = gq.groupby.attrs[0]
    if lang:
        return None
    pd = ex.snap.pred(attr)
    if pd is None or pd.num_values_host is None \
            or pd.value_subjects_host is None or ex.schema.is_list(attr):
        return None
    tid = ex.schema.type_of(attr)
    # DATETIME excluded: equal instants with different tz offsets collapse
    # in the float mirror but display as distinct isoformat keys
    if tid not in (TypeID.INT, TypeID.FLOAT, TypeID.BOOL):
        return None
    from dgraph_tpu_torch.ops.uidset import host_rank_of
    from dgraph_tpu_torch.query.outputnode import _val_json

    pos = host_rank_of(pd.value_subjects_host, uids, -1)
    ok = pos >= 0
    vals = np.where(ok, pd.num_values_host[np.clip(pos, 0, None)], np.nan)
    nan_slots = ok & np.isnan(vals)
    if nan_slots.any():
        # a NaN mirror is EITHER a missing/lang-only value (skip, like the
        # generic path) OR a stored float NaN (a real group key the mirror
        # cannot carry) — bail to generic when any stored NaN exists
        for u in uids[nan_slots].tolist():
            v = pd.host_values.get(int(u))
            if v is not None and isinstance(v.value, float) \
                    and v.value != v.value:
                return None
    ok &= ~np.isnan(vals)
    if not ok.any():
        return [], [], (alias or attr)
    if tid == TypeID.INT and np.abs(vals[ok]).max() >= 2.0 ** 53:
        return None     # float64 mirror is lossy past 2^53: keys could merge
    grp_vals, inverse = np.unique(vals[ok], return_inverse=True)
    kept = uids[ok]
    order = np.argsort(inverse, kind="stable")
    bounds = np.searchsorted(inverse[order], np.arange(len(grp_vals) + 1))
    members_per = [np.unique(kept[order[bounds[i]: bounds[i + 1]]])
                   for i in range(len(grp_vals))]
    # key display values from the exact per-uid Val of one representative
    keys = []
    for i in range(len(grp_vals)):
        rep = int(members_per[i][0])
        keys.append(_val_json(pd.host_values[rep]))
    # generic path sorts groups by repr of the key tuple — sort to match
    perm = sorted(range(len(keys)), key=lambda i: repr((keys[i],)))
    return [keys[i] for i in perm], [members_per[i] for i in perm], \
        (alias or attr)


def _group_key(x):
    if isinstance(x, Val):
        from dgraph_tpu_torch.query.outputnode import _val_json

        return _val_json(x)
    if isinstance(x, int):
        return hex(x)  # uid group keys render as uid strings
    return x


def _group_agg_val(ex, cgq: dql.GraphQuery, members: np.ndarray):
    """(the row's name, the group's Val) of one child: count(uid) an INT,
    an aggregate its aggregator's Val; the Val is None where the row shows
    nothing."""
    if cgq.is_uid_node and cgq.is_count:
        return cgq.alias or "count", Val(TypeID.INT, int(len(members)))
    if cgq.attr.startswith("__agg_"):
        op = cgq.attr[len("__agg_"):]
        vv = ex.vars.get(cgq.val_ref)
        vals = [vv.vals[int(u)] for u in members if vv and int(u) in vv.vals]
        return cgq.alias or f"{op}(val({cgq.val_ref}))", aggregate(op, vals)
    return cgq.alias or cgq.attr, None
