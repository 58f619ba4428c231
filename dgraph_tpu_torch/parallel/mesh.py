"""Device mesh: a single-controller list of torch devices with one axis,
"shard", and the per-shard collectives the mesh programs use.

Port of dgraph_tpu/parallel/mesh.py. The JAX mesh is one process driving a
`jax.sharding.Mesh`; its programs are `shard_map`s whose only collectives
are psum, pmin/pmax and all_gather. Here the same single controller holds a
list of devices: a sharded array is a list of per-shard tensors (shard s on
`devices[s]`), a program body runs once per shard in a Python loop, and a
collective folds the per-shard results onto the leader device
(`devices[0]`) and hands the replicated result back on every shard's
device. The list may repeat a device — the counterpart of the JAX tests'
forced host-platform device count — and then `.to` is a no-op and the
replicas are one tensor: replicated values are read-only in every program.
With distinct cards the fold copies over NVLink; no process group is
involved.
"""

from __future__ import annotations

import numpy as np
import torch

from dgraph_tpu_torch.obs import costs


class Mesh:
    """Shard-axis device list: `shape["shard"]` reads as on a JAX Mesh."""

    def __init__(self, devices) -> None:
        self.devices = [torch.device(d) for d in devices]
        self.shape = {"shard": len(self.devices)}

    @property
    def leader(self) -> torch.device:
        return self.devices[0]

    # -- placement ------------------------------------------------------------

    def shard_put(self, arr: np.ndarray) -> list[torch.Tensor]:
        """[S, ...] host array → S tensors, shard s on devices[s] (the
        device_put(..., P("shard")) counterpart)."""
        assert arr.shape[0] == len(self.devices), (arr.shape, self.devices)
        costs.transfer(h2d=int(arr.nbytes))
        return [torch.from_numpy(np.ascontiguousarray(arr[s])).to(d)
                for s, d in enumerate(self.devices)]

    def replicate(self, t: torch.Tensor) -> list[torch.Tensor]:
        """One tensor → its copy on every shard's device (one copy per
        distinct device)."""
        per: dict = {}
        out = []
        for d in self.devices:
            r = per.get(d)
            if r is None:
                r = per[d] = t.to(d)
            out.append(r)
        return out

    def put(self, arr) -> list[torch.Tensor]:
        """Host array or scalar → replicated tensors (P() in_specs)."""
        arr = np.asarray(arr)
        costs.transfer(h2d=int(arr.nbytes) * len(set(self.devices)))
        return self.replicate(torch.as_tensor(arr))

    # -- collectives ----------------------------------------------------------

    def _fold(self, parts, op) -> torch.Tensor:
        lead = self.leader
        acc = parts[0].to(lead)
        for p in parts[1:]:
            acc = op(acc, p.to(lead))
        return acc

    def psum(self, parts) -> list[torch.Tensor]:
        return self.replicate(self._fold(parts, torch.add))

    def pmin(self, parts) -> list[torch.Tensor]:
        return self.replicate(self._fold(parts, torch.minimum))

    def pmax(self, parts) -> list[torch.Tensor]:
        return self.replicate(self._fold(parts, torch.maximum))

    def all_gather(self, parts) -> list[torch.Tensor]:
        """[S, ...] stack of the per-shard blocks, replicated."""
        lead = self.leader
        return self.replicate(torch.stack([p.to(lead) for p in parts]))


def make_mesh(n_shards: int | None = None, devices=None) -> Mesh:
    """A mesh over `devices` (any list, repeats included) or, without it,
    over the visible CUDA cards. Asking for more shards than devices raises
    as the JAX make_mesh does."""
    devs = list(devices) if devices is not None else [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = n_shards or len(devs)
    if n > len(devs) or n < 1:
        raise ValueError(f"need {max(n, 1)} devices, have {len(devs)}")
    return Mesh(devs[:n])
