"""Distributed worker: route a snapshot's predicates onto the mesh by tablet.

Port of dgraph_tpu/parallel/worker.py over the port's own mesh
(parallel/mesh.Mesh, a list of torch devices) in place of
`jax.sharding.Mesh`.

Reference semantics: worker/groups.go — each predicate ("tablet") is served
by one group (BelongsTo :292); query execution fans each per-predicate task
out to the owning group (worker/task.go:137 ProcessTaskOverNetwork). Here a
"group" is a contiguous slice of the mesh's devices, a predicate's CSR is
row-sharded across its group's submesh (parallel/dist.shard_csr), and the
per-level expand runs over the shards with a gather onto the leader instead
of gRPC (parallel/dist.DistPredCSR.expand_matrix).

The Executor (query/engine.py) is unchanged: distribute_snapshot returns a
GraphSnapshot whose uid adjacencies are DistPredCSR, and the process_task
seam (query/task.py:_expand_csr) dispatches on `is_dist`. Value tables and
token indexes stay where the source snapshot holds them.
"""

from __future__ import annotations

from dataclasses import replace

from dgraph_tpu_torch.coord.zero import Zero
from dgraph_tpu_torch.parallel.dist import DistPredCSR
from dgraph_tpu_torch.parallel.mesh import Mesh, make_mesh
from dgraph_tpu_torch.storage.csr_build import GraphSnapshot


def group_submesh(mesh: Mesh, n_groups: int, group: int) -> Mesh:
    """Contiguous device slice serving one group's tablets.

    With n_groups=1 this is the whole mesh. Mirrors the reference's cluster
    layout where groups partition the server fleet (dgraph/cmd/zero/zero.go
    :328 Connect fills groups with --replicas servers each)."""
    devs = list(mesh.devices)
    if n_groups <= 1 or len(devs) < 2 * n_groups:
        return mesh
    per = len(devs) // n_groups
    lo = group * per
    hi = len(devs) if group == n_groups - 1 else lo + per
    return make_mesh(hi - lo, devices=devs[lo:hi])


def distribute_snapshot(snap: GraphSnapshot, mesh: Mesh,
                        zero: Zero | None = None) -> GraphSnapshot:
    """Re-home a snapshot's uid adjacencies onto the mesh, tablet-routed.

    Each predicate asks the Zero tablet map for its group (zero.should_serve,
    the ShouldServe analog) and shards its forward/reverse CSR over that
    group's submesh. The returned snapshot is a drop-in for the Executor;
    its own device is the source snapshot's."""
    out = GraphSnapshot(snap.read_ts, device=snap.device)
    for attr, pd in snap.preds.items():
        sub = group_submesh(mesh, zero.n_groups, zero.should_serve(attr)) \
            if zero is not None else mesh
        csr = pd.csr
        rev = pd.rev_csr
        if csr is not None:
            # shard from the host fold — re-sharding must not force a
            # single-device upload of the whole tablet first
            s, p, i = csr.host_arrays()
            csr = DistPredCSR(s, p, i, sub)
        if rev is not None:
            s, p, i = rev.host_arrays()
            rev = DistPredCSR(s, p, i, sub)
        out.preds[attr] = replace(pd, csr=csr, rev_csr=rev)
    return out
