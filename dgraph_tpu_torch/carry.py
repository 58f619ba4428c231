"""Carry state across from the JAX package: numpy in, port state out.

The database's counterpart of a model's weights is the snapshot. These two
functions build the port's snapshot (adjacencies, values, token indexes,
facets) and pull-BFS layout from the numpy arrays and value dicts the JAX
package exposes, so the same state can be fed to both packages (the parity
tests) without this package importing the other.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from dgraph_tpu_torch import resolve_device
from dgraph_tpu_torch.ops.pull_bfs import DEVICE_FIELDS, PullGraph
from dgraph_tpu_torch.storage.csr_build import (GraphSnapshot, PredCSR,
                                                PredData, TokenIndex)
from dgraph_tpu_torch.utils import geo as geomod
from dgraph_tpu_torch.utils.types import TypeID, Val


def snapshot_from_numpy(preds: Mapping[str, tuple], read_ts: int,
                        device: str | torch.device = "cuda",
                        facets: Mapping[str, Mapping] | None = None,
                        values: Mapping[str, Mapping] | None = None
                        ) -> GraphSnapshot:
    """Build a GraphSnapshot from {attr: (type_id, subjects, indptr,
    indices)}, the arrays PredCSR.host_arrays() returns in either package.
    A key "~attr" carries attr's reverse CSR (its rev_csr); a reverse entry
    without a forward one is refused.

    values: {attr: {"type_id", "value_subjects", "num_values", "host_values",
    "list_values", "lang_values", "indexes"}}, the value fields of the JAX
    package's PredData (value_subjects_host, num_values_host, the three
    value dicts, and each TokenIndex as (terms, indptr, uids)). A value
    predicate needs no CSR; one that has one merges into it.

    facets: {attr: {(subject, object or value slot): ((name, value), ...)}},
    the JAX package's PredData.facets.

    Every value (Val, facet) is anything with `tid` and `value` and becomes
    this package's Val with the same type id and value; a geo value becomes
    this package's Geom from the other's kind and coords, or from its
    GeoJSON text. Dict and name orders are kept."""
    dev = resolve_device(device)
    snap = GraphSnapshot(read_ts, dev)
    for attr in sorted(preds, key=lambda a: a.startswith("~")):
        type_id, subjects, indptr, indices = preds[attr]
        csr = PredCSR(np.asarray(subjects), np.asarray(indptr),
                      np.asarray(indices), dev)
        if attr.startswith("~"):
            pd = snap.preds.get(attr[1:])
            if pd is None:
                raise ValueError(f"reverse CSR {attr!r} has no forward "
                                 f"predicate {attr[1:]!r}")
            pd.rev_csr = csr
        else:
            snap.preds[attr] = PredData(attr, TypeID(int(type_id)), csr=csr)
    for attr, cols in (values or {}).items():
        pd = snap.preds.get(attr)
        if pd is None:
            pd = snap.preds[attr] = PredData(attr,
                                             TypeID(int(cols["type_id"])))
        if cols.get("value_subjects") is not None:
            pd.value_subjects_host = np.asarray(cols["value_subjects"],
                                                dtype=np.int64)
            pd.num_values_host = np.asarray(cols["num_values"],
                                            dtype=np.float64)
        pd.host_values = {int(u): _val(v)
                          for u, v in cols.get("host_values", {}).items()}
        pd.list_values = {int(u): [_val(v) for v in vs]
                          for u, vs in cols.get("list_values", {}).items()}
        pd.lang_values = {int(u): {str(lg): _val(v) for lg, v in lv.items()}
                          for u, lv in cols.get("lang_values", {}).items()}
        pd.indexes = {
            name: TokenIndex([bytes(t) for t in terms], np.asarray(indptr),
                             np.asarray(uids), dev)
            for name, (terms, indptr, uids) in cols.get("indexes",
                                                        {}).items()}
    for attr, edges in (facets or {}).items():
        pd = snap.preds.get(attr)
        if pd is None:
            raise ValueError(f"facets for {attr!r}, which has no CSR or "
                             f"values")
        pd.facets = {
            (int(s), int(o)): tuple((str(name), _val(v)) for name, v in fs)
            for (s, o), fs in edges.items()}
    return snap


def _val(v) -> Val:
    """This package's Val of another package's Val."""
    tid = TypeID(int(v.tid))
    value = v.value
    if tid == TypeID.GEO:
        value = (geomod.Geom(str(value.kind), value.coords)
                 if hasattr(value, "kind") else geomod.parse_geojson(value))
    return Val(tid, value)


def pull_graph_from_numpy(fields: Mapping[str, object],
                          device: str | torch.device = "cuda") -> PullGraph:
    """Build a PullGraph from np.asarray of every field of a JAX PullGraph
    (its _asdict()): device arrays become int32 tensors on `device`, the
    integer fields ints, the host mirrors stay numpy (None where absent)."""
    dev = resolve_device(device)
    vals = []
    for name in PullGraph._fields:
        v = fields.get(name)
        if name in DEVICE_FIELDS:
            vals.append(torch.from_numpy(
                np.array(v, dtype=np.int32, copy=True)).to(dev))
        elif name in ("num_nodes", "num_edges", "chunks", "chunks_d"):
            vals.append(int(v))
        else:
            vals.append(None if v is None or np.ndim(v) == 0
                        else np.asarray(v))
    return PullGraph(*vals)
