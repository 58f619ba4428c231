"""Active-edge prefix kernels: the CUDA replacements of the two Pallas
kernels of dgraph_tpu/ops/pallas_bfs.py.

    K1 active_prefix(words, src_pad, chunks)   <- _prefix_kernel
    K2 active_prefix_sparse(ftab, src_pad)     <- _prefix_kernel_sparse

Both return int32[E_pad], the inclusive prefix count of frontier-active
edges over the destination-sorted stream `src_pad` (out[-1] = active
total). K1 reads the frontier from the bit-plane bitmap of
pull_bfs.pack_words, K2 from the (33, 128) search table of
pull_bfs._frontier_table. The kernels live in csrc/active_prefix.cu; their
design notes and bounds are there.

Dispatch is by the tensors' device: CPU tensors take the plain PyTorch
versions (active_prefix_ref / active_prefix_sparse_ref); CUDA tensors launch
the kernel or raise. There is no fallback between the two. Each launch adds
one to LAUNCHES[name]; the plain versions count nothing.

The shared library is built at first use with nvcc (sm_90a) into
build/dgraph_tpu_torch/ at the repository root, named by a hash of the
source, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

EDGE_BLOCK = 8192   # E_pad granularity: the TPU grid step (pallas_bfs), kept
                    # by name; the CUDA tile (dg_tile_edges) must divide it
LANES = 128
WORDS_PER_CHUNK = 1024
NODES_PER_CHUNK = WORDS_PER_CHUNK * 32
FRONTIER_CAP = 4096             # sparse table capacity: 128 buckets x 32
INT32_MAX = 2**31 - 1

LAUNCHES = {"active_prefix": 0, "active_prefix_sparse": 0}

_SRC = Path(__file__).resolve().parent / "csrc" / "active_prefix.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dgraph_tpu_torch"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lib = None
_lib_lock = threading.Lock()
_tile = 0          # edges per kernel tile (dg_tile_edges), read at load


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libactive_prefix-{digest}.so"


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile csrc/active_prefix.cu unless the hashed library exists.
    Returns (path, compiler output); raises with nvcc's output on failure.
    verbose adds -Xptxas -v (registers, shared memory, spills per kernel)."""
    path = library_path()
    if path.exists() and not verbose:
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, path)
    return path, log


def _load():
    global _lib, _tile
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.dg_tile_edges.argtypes = []
            lib.dg_tile_edges.restype = i32
            # (words, n_rows | ftab), src, out, scratch, n_edges, stream
            lib.dg_active_prefix.argtypes = [ptr, i32, ptr, ptr, ptr, i64,
                                             ptr]
            lib.dg_active_prefix.restype = i32
            lib.dg_active_prefix_sparse.argtypes = [ptr, ptr, ptr, ptr, i64,
                                                    ptr]
            lib.dg_active_prefix_sparse.restype = i32
            _tile = lib.dg_tile_edges()
            if EDGE_BLOCK % _tile:
                raise RuntimeError("kernel tile does not divide EDGE_BLOCK")
            _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the kernels' parity reference)
# ---------------------------------------------------------------------------

def active_prefix_ref(words: torch.Tensor, src_pad: torch.Tensor,
                      chunks: int) -> torch.Tensor:
    """Plain K1: bit of src rank n at word row n>>12, lane n&127, bit
    (n>>7)&31; ranks whose row is outside the bitmap are inactive."""
    s = src_pad.to(torch.int64)
    n_rows = chunks * 8
    row = s >> 12
    ok = (s >= 0) & (row < n_rows)
    flat = words.reshape(-1)
    w = flat[torch.where(ok, row * LANES + (s & (LANES - 1)), 0)]
    active = ((w.to(torch.int64) >> ((s >> 7) & 31)) & 1) * ok
    return torch.cumsum(active, 0).to(torch.int32)


def active_prefix_sparse_ref(ftab: torch.Tensor,
                             src_pad: torch.Tensor) -> torch.Tensor:
    """Plain K2: the 7-step lower bound over the bucket maxima, then the
    32-way equality test in the chosen bucket (as the Pallas kernel)."""
    seps = ftab[0]
    b = torch.zeros(src_pad.shape, dtype=torch.int64, device=src_pad.device)
    for k in (64, 32, 16, 8, 4, 2, 1):
        cand = b + k
        sep = seps[torch.clamp(cand - 1, max=LANES - 1)]
        b = torch.where(sep < src_pad, cand, b)
    b = torch.clamp(b, max=LANES - 1)
    active = torch.zeros(src_pad.shape, dtype=torch.bool,
                         device=src_pad.device)
    for j in range(32):
        active |= ftab[1 + j][b] == src_pad
    return torch.cumsum(active.to(torch.int64), 0).to(torch.int32)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_stream(src_pad: torch.Tensor) -> None:
    _check("src_pad", src_pad, src_pad.device)
    if src_pad.dim() != 1 or src_pad.numel() % EDGE_BLOCK:
        raise ValueError(f"src_pad must be 1-D with length % {EDGE_BLOCK} "
                         f"== 0, got shape {tuple(src_pad.shape)}")
    if src_pad.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {src_pad.device}")


def _launch(fn, src_pad: torch.Tensor, *ptrs) -> torch.Tensor:
    n = src_pad.numel()
    out = torch.empty_like(src_pad)
    with torch.cuda.device(src_pad.device):
        # one status word per tile, then the tile counter; the entry point
        # zeroes them on the launch stream before its launch
        scratch = torch.empty(n // _tile + 1, dtype=torch.int64,
                              device=src_pad.device)
        stream = torch.cuda.current_stream(src_pad.device).cuda_stream
        rc = fn(*ptrs, src_pad.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError {rc}")
    return out


def active_prefix(words: torch.Tensor, src_pad: torch.Tensor,
                  chunks: int) -> torch.Tensor:
    """K1: inclusive prefix-count of frontier-active edges, frontier as the
    (chunks*8, 128) int32 bit-plane bitmap."""
    _check_stream(src_pad)
    _check("words", words, src_pad.device)
    if tuple(words.shape) != (chunks * 8, LANES):
        raise ValueError(f"words must be ({chunks * 8}, {LANES}), got "
                         f"{tuple(words.shape)}")
    if src_pad.device.type == "cpu":
        return active_prefix_ref(words, src_pad, chunks)
    if src_pad.numel() == 0:
        return torch.empty_like(src_pad)
    lib = _load()
    out = _launch(lib.dg_active_prefix, src_pad, words.data_ptr(),
                  chunks * 8)
    LAUNCHES["active_prefix"] += 1
    return out


def active_prefix_sparse(ftab: torch.Tensor,
                         src_pad: torch.Tensor) -> torch.Tensor:
    """K2: the same output as K1, frontier as the (33, 128) search table.

    The kernel computes "src_pad[e] is an entry of ftab[1:]" (a hash set of
    those 4,096 entries). For the tables _frontier_table builds (sorted,
    unique ranks >= 0, INT32_MAX pads) that equals the plain version's
    bucket search, for every int32 rank in src_pad. A table holding -1 (the
    kernel's free-slot marker) is outside that domain."""
    _check_stream(src_pad)
    _check("ftab", ftab, src_pad.device)
    if tuple(ftab.shape) != (33, LANES):
        raise ValueError(f"ftab must be (33, {LANES}), got "
                         f"{tuple(ftab.shape)}")
    if src_pad.device.type == "cpu":
        return active_prefix_sparse_ref(ftab, src_pad)
    if src_pad.numel() == 0:
        return torch.empty_like(src_pad)
    lib = _load()
    out = _launch(lib.dg_active_prefix_sparse, src_pad, ftab.data_ptr())
    LAUNCHES["active_prefix_sparse"] += 1
    return out
