"""Carry state across from the JAX package: numpy in, port state out.

The database's counterpart of a model's weights is the snapshot. These two
functions build the port's snapshot and pull-BFS layout from the numpy
arrays the JAX package exposes, so the same state can be fed to both
packages (the parity tests) without this package importing the other.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from dgraph_tpu_torch import resolve_device
from dgraph_tpu_torch.ops.pull_bfs import DEVICE_FIELDS, PullGraph
from dgraph_tpu_torch.storage.csr_build import GraphSnapshot, PredCSR, PredData
from dgraph_tpu_torch.utils.types import TypeID


def snapshot_from_numpy(preds: Mapping[str, tuple], read_ts: int,
                        device: str | torch.device = "cuda") -> GraphSnapshot:
    """Build a GraphSnapshot from {attr: (type_id, subjects, indptr,
    indices)}, the arrays PredCSR.host_arrays() returns in either package.
    A key "~attr" carries attr's reverse CSR (its rev_csr); a reverse entry
    without a forward one is refused."""
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
    return snap


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
