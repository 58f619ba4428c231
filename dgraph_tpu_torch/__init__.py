"""dgraph_tpu_torch — the PyTorch/CUDA port of dgraph_tpu for NVIDIA Hopper.

The JAX package `dgraph_tpu` stays the reference; this package imports
nothing of it and never imports jax. Module paths mirror the JAX package so
each counterpart is easy to find. The two Pallas active-prefix kernels of
`dgraph_tpu/ops/pallas_bfs.py` are hand-written CUDA kernels here
(`ops/csrc/active_prefix.cu`, wrapped by `ops/prefix.py`).

Every entry point takes an explicit `device` (default "cuda"). The default
raises when CUDA is missing: the CPU runs only when the caller passes
device="cpu", and then each kernel wrapper uses its plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device an entry point runs on; raises rather than falling
    back to the CPU when CUDA is asked for and missing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dgraph_tpu_torch: device 'cuda' requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return dev
