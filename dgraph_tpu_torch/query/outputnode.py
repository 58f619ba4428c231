"""Result encoding: SubGraph tree → JSON-able dict.

Port of dgraph_tpu/query/outputnode.py (pure host code, copied).
Reference semantics: query/outputnode.go — preTraverse walks the SubGraph per
root uid building the response tree (query/query.go:370), fastJsonNode writes
it (:81-271), @normalize flattens aliased leaves (:296), ToJson (:43).

Formats kept: uid preds → list of objects; value preds → scalar under alias
(lang-tagged as "name@en"); count(pred) → int; count(uid) → {"count": n};
aggregates/math appended as their own objects in the block list (dgraph's
"me": [{"min(val(x))": ...}] form). Edge facets are emitted with the
"pred|facet" key convention inside the target object.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from dgraph_tpu_torch.utils.types import TypeID, Val

NORMALIZE_NODE_LIMIT = 10_000  # reference x/config.go NormalizeNodeLimit


def _uid_hex(u: int) -> str:
    return hex(int(u))


def _val_json(v: Val) -> Any:
    if v.tid == TypeID.DATETIME:
        return v.value.isoformat()
    if v.tid == TypeID.GEO:
        import json as _json

        from dgraph_tpu_torch.utils import geo as geomod

        return _json.loads(geomod.to_geojson(v.value))
    if v.tid == TypeID.BINARY:
        import base64

        return base64.b64encode(v.value).decode("ascii")
    if v.tid == TypeID.VECTOR:
        return [float(x) for x in v.value]
    return v.value


def encode_result(ex, sg, out: dict) -> None:
    """Encode one query block into the response dict (ToJson per block)."""
    gq = sg.gq
    alias = gq.alias or gq.attr
    if gq.shortest is not None:
        from dgraph_tpu_torch.query.shortest import encode_paths

        encode_paths(ex, sg, out)
        return
    if sg.group_result is not None:
        out[alias] = [{"@groupby": sg.group_result}]
        return
    nodes: list[dict] = []
    if any(not _block_level(c.gq) for c in sg.children):
        frontier = np.sort(sg.dest_uids)
        # @ignorereflex: a node never appears in its own subtree — an
        # ancestor stack is threaded through preTraverse
        # (query/query.go:371,433,541)
        parents: list[int] | None = [] if gq.ignore_reflex else None
        for u in sg.dest_uids:
            node = pre_traverse(sg, frontier, int(u), parents)
            if node:
                nodes.append(node)
    else:
        # no child renders per uid: pre_traverse would give {} for each
        metrics = getattr(ex.snap, "metrics", None)
        if metrics is not None:
            metrics.counter("dgraph_encode_walks_skipped_total").inc()
    # block-level scalars: aggregates and count(uid) become their own objects
    # (dgraph's "me": [..., {"count": n}] / [{"min(val(x))": v}] shape)
    for child in sg.children:
        cgq = child.gq
        if cgq.attr.startswith("__agg_") and child.agg_value is not None:
            name = cgq.alias or f"{cgq.attr[6:]}(val({cgq.val_ref}))"
            nodes.append({name: _val_json(child.agg_value)})
        elif cgq.is_uid_node and cgq.is_count:
            nodes.append({cgq.alias or "count": len(sg.dest_uids)})
    if gq.normalize:
        flat: list[dict] = []
        for n in nodes:
            flat.extend(_normalize(n))
            if len(flat) > NORMALIZE_NODE_LIMIT:
                raise ValueError("normalize result exceeds node limit")
        nodes = flat
    if nodes:
        out[alias] = nodes


def _block_level(cgq) -> bool:
    """An aggregate or count(uid): rendered once for the block, never per
    uid."""
    return cgq.attr.startswith("__agg_") or (cgq.is_uid_node and cgq.is_count)


def pre_traverse(sg, frontier: np.ndarray, uid: int,
                 parents: list[int] | None = None) -> dict:
    """Build the response object for one uid at one level.

    parents: the @ignorereflex ancestor stack (None = directive absent) —
    pushed here, popped before return, reflexive targets skipped below."""
    node: dict = {}
    if parents is not None:
        parents.append(uid)
    idx = int(np.searchsorted(frontier, uid))
    in_frontier = idx < len(frontier) and frontier[idx] == uid
    for child in sg.children:
        cgq = child.gq
        alias = cgq.alias or cgq.attr
        if _block_level(cgq):
            continue  # block-level, handled by encode_result
        if cgq.is_uid_node:
            node["uid"] = _uid_hex(uid)
            continue
        if not in_frontier:
            continue
        if cgq.attr in ("val", "math"):
            if idx < len(child.value_matrix) and child.value_matrix[idx]:
                node[alias] = _val_json(child.value_matrix[idx][0])
            continue
        if cgq.is_count:
            if idx < len(child.counts):
                node[alias] = int(child.counts[idx])
            continue
        if child.uid_matrix:
            targets = child.uid_matrix[idx] if idx < len(child.uid_matrix) else []
            facets = (child.facet_matrix[idx]
                      if child.facet_matrix and idx < len(child.facet_matrix) else [])
            # memoized per CHILD, not per parent uid: pre_traverse runs once
            # per parent and these were rebuilt every call (the JSON-encode
            # hot spot at scale)
            sub_frontier = getattr(child, "_sorted_dest", None)
            if sub_frontier is None:
                sub_frontier = child._sorted_dest = np.sort(child.dest_uids)
            kept = getattr(child, "_kept_set", None)
            if kept is None:
                kept = child._kept_set = set(
                    int(x) for x in child.dest_uids)
            objs = []
            # nested count(uid): emit a per-parent {"count": n} object over the
            # kept (post-filter) targets, ALONGSIDE any sibling attributes —
            # the reference appends it as one more list entry (query.go:472)
            for cc in child.children:
                if cc.gq.is_uid_node and cc.gq.is_count:
                    n_kept = sum(1 for t in targets if int(t) in kept
                                 and not (parents is not None
                                          and int(t) in parents))
                    objs.append({cc.gq.alias or "count": n_kept})
            for j, t in enumerate(targets):
                if int(t) not in kept:
                    continue  # pruned by child filter/pagination
                if parents is not None and int(t) in parents:
                    continue  # @ignorereflex: already on the ancestor path
                obj = pre_traverse(child, sub_frontier, int(t),
                                   parents) if child.children else {}
                if not child.children:
                    obj = {"uid": _uid_hex(t)}
                elif not obj:
                    continue
                if facets and j < len(facets):
                    for fk, fv in facets[j]:
                        keys = dict((k, a) for a, k in (cgq.facets.keys if cgq.facets else []))
                        if cgq.facets is not None and cgq.facets.keys and fk not in keys:
                            continue
                        fa = keys.get(fk, fk)
                        obj[f"{cgq.attr}|{fa}"] = _val_json(fv)
                objs.append(obj)
            if objs:
                node[alias] = objs
            continue
        if child.value_matrix:
            vals = child.value_matrix[idx] if idx < len(child.value_matrix) else []
            if vals:
                key = alias if not cgq.lang else f"{alias}@{cgq.lang}"
                # [type] list predicates return a JSON array; single-valued
                # ones a scalar (reference outputnode list handling)
                node[key] = ([_val_json(v) for v in vals] if len(vals) > 1
                             else _val_json(vals[0]))
                # facets on the value edge: name|since etc.
                vfac = (child.facet_matrix[idx]
                        if child.facet_matrix
                        and idx < len(child.facet_matrix) else [])
                if vfac and vfac[0]:
                    sel = dict((k, a) for a, k in
                               (cgq.facets.keys if cgq.facets else []))
                    for fk, fv in vfac[0]:
                        if cgq.facets is not None and cgq.facets.keys \
                                and fk not in sel:
                            continue
                        node[f"{cgq.attr}|{sel.get(fk, fk)}"] = _val_json(fv)
    if parents is not None:
        parents.pop()
    return node


def _normalize(node: dict) -> list[dict]:
    """Flatten one object into a list of flat objects (cartesian over lists).

    Reference: outputnode.go:296 normalize — only *aliased* leaves survive in
    the reference; we keep all scalar leaves (superset, documented)."""
    scalars = {k: v for k, v in node.items() if not isinstance(v, list)}
    list_items = [(k, v) for k, v in node.items() if isinstance(v, list)]
    rows = [dict(scalars)]
    for _k, sublist in list_items:
        new_rows = []
        flat_subs: list[dict] = []
        for sub in sublist:
            flat_subs.extend(_normalize(sub) if isinstance(sub, dict) else [{}])
        if not flat_subs:
            flat_subs = [{}]
        for r in rows:
            for fs in flat_subs:
                merged = dict(r)
                merged.update(fs)
                new_rows.append(merged)
        rows = new_rows
    return rows
