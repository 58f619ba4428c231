"""On-device decode of block-packed uid lists (device-resident packed postings).

Port of dgraph_tpu/ops/packed_decode.py. Counterpart of the reference's bp128
unpack kernels (bp128/unpack_amd64.s, one unrolled kernel per bit width).
One branch-free program of torch ops covers every width: the packed delta
of lane i in block b sits at bit position i*w(b) in the block's word stream,
so

    v = (words[k] >> s) | (words[k+1] << (32-s))   (two-word funnel shift)
    uid[b, i] = first[b] + cumsum_i(v & mask(w))

CUDA torch has no general uint32 shifts, so the words live on the device as
int64 holding the uint32 values, and the funnel shift runs in int64 with
the high half masked back to 32 bits. The decoded layout is a [nb*128]
sentinel-padded sorted uid-set, consumable by ops.uidset with no host
round trip.

Device lists use int32 uids (max uid < 2**31 - 1, the padding sentinel), so
every delta fits in 31 bits and the raw64 escape never appears on the
device; storage/packed.py keeps full uint64 fidelity on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dgraph_tpu_torch import resolve_device
from dgraph_tpu_torch.ops.uidset import sentinel
from dgraph_tpu_torch.storage import packed as hostpacked

BLOCK = hostpacked.BLOCK

_LOW32 = (1 << 32) - 1


class DevicePackedList(NamedTuple):
    """Struct-of-arrays packed list, uploaded once and decoded on the
    device."""

    block_first: torch.Tensor  # int32[nb]
    block_count: torch.Tensor  # int32[nb]
    block_width: torch.Tensor  # int32[nb]
    block_off: torch.Tensor    # int32[nb]
    words: torch.Tensor        # int64[W+1] uint32 values (one pad word for
                               # funnel reads)

    @property
    def capacity(self) -> int:
        return self.block_first.shape[0] * BLOCK


def to_device(pl: hostpacked.PackedUidList,
              device: str | torch.device = "cuda") -> DevicePackedList:
    """Upload one host packed list to `device`. Rejects raw64 blocks and
    uids at or past the int32 sentinel, as the JAX decoder does."""
    if (pl.block_width == 64).any():
        raise ValueError("raw64 blocks imply uids >= 2**32; device lists are int32")
    if pl.count and int(pl.block_last[-1]) >= 2**31 - 1:
        raise ValueError("device uid space is int32; max uid must be < 2**31 - 1 "
                         "(2**31 - 1 is the padding sentinel)")
    dev = resolve_device(device)
    words = np.concatenate([pl.words, np.zeros(1, dtype=np.uint32)])
    return DevicePackedList(*(
        torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            pl.block_first.astype(np.int32),
            pl.block_count.astype(np.int32),
            pl.block_width.astype(np.int32),
            pl.block_off.astype(np.int32),
            words.astype(np.int64))))


def unpack_device(pl: DevicePackedList) -> torch.Tensor:
    """Decode to a sentinel-padded sorted uid-set of shape [nb*BLOCK], int32,
    on the list's device."""
    nb = pl.block_first.shape[0]
    dev = pl.words.device
    if nb == 0:
        return torch.zeros((0,), dtype=torch.int32, device=dev)
    lane = torch.arange(BLOCK, dtype=torch.int64, device=dev)[None, :]
    w = pl.block_width.to(torch.int64)[:, None]
    bitpos = lane * w
    widx = pl.block_off.to(torch.int64)[:, None] + (bitpos >> 5)
    shift = bitpos & 31
    # lanes past a block's count may point past the stream (jnp.take
    # clamps there, torch indexing raises): clamp them, their results
    # are masked to the sentinel below and never reach a valid lane's sum
    last = pl.words.shape[0] - 1
    w0 = pl.words[torch.clamp(widx, max=last)]
    w1 = pl.words[torch.clamp(widx + 1, max=last)]
    # funnel shift in int64; at shift 0 the high word contributes nothing
    hi = torch.where(shift == 0, 0, (w1 << (32 - shift)) & _LOW32)
    v = (w0 >> shift) | hi
    mask = (torch.ones_like(w) << torch.clamp(w, 0, 32)) - 1
    deltas = v & mask
    deltas[:, 0] = 0
    uids = pl.block_first.to(torch.int64)[:, None] + torch.cumsum(deltas, 1)
    valid = lane < pl.block_count.to(torch.int64)[:, None]
    return torch.where(valid, uids, int(sentinel(torch.int32))).to(
        torch.int32).reshape(-1)
