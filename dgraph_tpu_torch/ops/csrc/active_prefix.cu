// Active-edge inclusive prefix kernels for the pull-BFS / @recurse hot path.
//
// Both kernels compute, over a destination-sorted edge stream `src` of
// source ranks (int32[E], E % 2048 == 0), the inclusive prefix sum of
//     active[e] = 1 if src[e] is in the frontier, else 0
// so out[E-1] is the number of frontier-active edges. They differ only in
// how the frontier is held (a bitmap, or a sorted list of <= 4096 ranks).
//
// Stream-wide scan in three launches (CUDA blocks run in no order, so the
// TPU kernels' sequential-grid carry in SMEM has no counterpart):
//   1. *_tiles:          each block takes one tile of kTile edges, computes
//                        active, scans it (thread-serial over kItems edges,
//                        then warp shuffles across the block), writes the
//                        tile-local inclusive prefix and the tile total;
//   2. scan_tile_totals: one block scans the tile totals into exclusive
//                        tile offsets (in place);
//   3. add_tile_offsets: adds each tile's offset to its prefix values.
// Decoupled look-back (one pass) is later work.
//
// Built by dgraph_tpu_torch/ops/prefix.py with nvcc for sm_90a into a shared
// library with a plain C interface (loaded by ctypes). Every entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() after its launches (0 = success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;              // threads per tile block
constexpr int kItems = 8;                  // consecutive edges per thread
constexpr int kTile = kThreads * kItems;   // 2048 edges per block
constexpr int kLanes = 128;                // bitmap row width (words)
constexpr int kScanThreads = 1024;         // tile-total scan block
constexpr int kTabRows = 33;               // sparse table rows
constexpr int kBuckets = 128;              // sparse table buckets

// Inclusive scan of one int per thread across the block (blockDim.x a
// multiple of 32, at most 1024). warp_sums is shared scratch of 32 ints.
// Returns the thread's inclusive value; *total receives the block total.
// Ends with a barrier so the caller may call it again in a loop.
__device__ __forceinline__ int block_inclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += n;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += n;
    }
    if (lane < nwarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int incl = v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[nwarps - 1];
  __syncthreads();
  return incl;
}

// Shared tile body: kItems consecutive edges per thread, loaded as two
// 16-byte vectors; member(rank) -> 0/1 is the frontier test.
template <class Member>
__device__ __forceinline__ void scan_tile(const int* __restrict__ src,
                                          int* __restrict__ out,
                                          int* __restrict__ tile_totals,
                                          const Member& member) {
  __shared__ int warp_sums[32];
  const long long base =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  const int4* s4 = reinterpret_cast<const int4*>(src + base);
  const int4 a = __ldg(s4);
  const int4 b = __ldg(s4 + 1);
  const int v[kItems] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  int pre[kItems];
  int run = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    run += member(v[i]);
    pre[i] = run;
  }
  int total;
  const int excl = block_inclusive_scan(run, warp_sums, &total) - run;
  int4* o4 = reinterpret_cast<int4*>(out + base);
  o4[0] = make_int4(pre[0] + excl, pre[1] + excl, pre[2] + excl, pre[3] + excl);
  o4[1] = make_int4(pre[4] + excl, pre[5] + excl, pre[6] + excl, pre[7] + excl);
  if (threadIdx.x == 0) tile_totals[blockIdx.x] = total;
}

// Replaces dgraph_tpu/ops/pallas_bfs.py:_prefix_kernel (K1, dense frontier).
// Frontier as the bit-plane bitmap of pack_words: node n -> word row n>>12,
// lane n&127, bit (n>>7)&31; words is (n_rows, 128) int32. A rank whose row
// is outside the bitmap is inactive (the Pallas chunk loop never matches
// it), so padding may point anywhere past the real ranks.
// Bound: streaming 4 B in + 4 B out per edge (R-MAT scale 20, E_pad 16.1M:
// ~129 MB, ~38 us at 3.35 TB/s); the per-edge word gather is 4 B from a
// bitmap of a few hundred KB that stays L2-resident (50 MB L2). This simple
// design reads words through the read-only cache instead of staging them in
// shared memory (a 68 KB bitmap at scale 20 would fit; above ~1.86M ranks it
// passes the 227 KB a block can hold), and spends two extra E-sized passes
// (read + write of out in add_tile_offsets) on the scan: ~16 B per edge.
struct DenseMember {
  const unsigned* words;
  unsigned n_rows;
  __device__ __forceinline__ int operator()(int s) const {
    const unsigned u = static_cast<unsigned>(s);
    const unsigned row = u >> 12;
    if (row >= n_rows) return 0;
    const unsigned w = __ldg(words + row * kLanes + (u & (kLanes - 1)));
    return static_cast<int>((w >> ((u >> 7) & 31u)) & 1u);
  }
};

__global__ void __launch_bounds__(kThreads)
dense_tiles(const unsigned* __restrict__ words, unsigned n_rows,
            const int* __restrict__ src, int* __restrict__ out,
            int* __restrict__ tile_totals) {
  scan_tile(src, out, tile_totals, DenseMember{words, n_rows});
}

// Replaces dgraph_tpu/ops/pallas_bfs.py:_prefix_kernel_sparse (K2, frontier
// of <= 4096 sorted ranks). Table (33, 128) int32 as _frontier_table builds
// it: row 0 holds each 32-entry bucket's max, rows 1..32 the entries,
// INT32_MAX pads. Per edge: the same 7-step branchless lower bound over the
// bucket maxima, then a 32-way equality test in the chosen bucket.
// Bound: integer operations, not bytes. It streams the same 8 B per edge as
// K1, but does ~79 integer operations per edge (7 compare + select steps,
// 32 compares + ors, the scan add): at the H100's INT32 rate (~16.7e12/s)
// that is ~76 us at scale 20 against ~38 us of streaming. The 16.9 KB
// table lives in shared memory (loaded once per block), so that work is
// ~40 shared-memory reads and no global gather.
struct SparseMember {
  const int* tab;   // shared memory
  __device__ __forceinline__ int operator()(int s) const {
    int b = 0;
#pragma unroll
    for (int k = 64; k >= 1; k >>= 1) {
      const int cand = b + k;
      const int sep = tab[min(cand - 1, kBuckets - 1)];
      if (sep < s) b = cand;
    }
    b = min(b, kBuckets - 1);
    int hit = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) hit |= (tab[(1 + j) * kBuckets + b] == s);
    return hit;
  }
};

__global__ void __launch_bounds__(kThreads)
sparse_tiles(const int* __restrict__ ftab, const int* __restrict__ src,
             int* __restrict__ out, int* __restrict__ tile_totals) {
  __shared__ int tab[kTabRows * kBuckets];
  for (int i = threadIdx.x; i < kTabRows * kBuckets; i += kThreads)
    tab[i] = ftab[i];
  __syncthreads();
  scan_tile(src, out, tile_totals, SparseMember{tab});
}

// In-place exclusive scan of n tile totals by one block (the carry the TPU
// kept in SMEM across its sequential grid).
__global__ void __launch_bounds__(kScanThreads)
scan_tile_totals(int* __restrict__ totals, int n) {
  __shared__ int warp_sums[32];
  int carry = 0;
  for (int base = 0; base < n; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < n ? totals[i] : 0;
    int chunk_total;
    const int incl = block_inclusive_scan(v, warp_sums, &chunk_total);
    if (i < n) totals[i] = carry + incl - v;
    carry += chunk_total;
  }
}

__global__ void __launch_bounds__(kThreads)
add_tile_offsets(int* __restrict__ out, const int* __restrict__ offsets) {
  const int off = offsets[blockIdx.x];
  if (off == 0) return;
  int4* o4 = reinterpret_cast<int4*>(
      out + (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems);
  int4 a = o4[0];
  int4 b = o4[1];
  a.x += off; a.y += off; a.z += off; a.w += off;
  b.x += off; b.y += off; b.z += off; b.w += off;
  o4[0] = a;
  o4[1] = b;
}

int finish_scan(int* out, int* tile_totals, int n_tiles, cudaStream_t stream) {
  scan_tile_totals<<<1, kScanThreads, 0, stream>>>(tile_totals, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_tiles > 1) {
    add_tile_offsets<<<n_tiles, kThreads, 0, stream>>>(out, tile_totals);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Edges per tile block: the wrapper sizes the tile-total scratch with it.
int dg_tile_edges() { return kTile; }

// K1. words: (n_rows, 128) int32; src, out: int32[n_edges], n_edges a
// positive multiple of kTile, both 16-byte aligned; tile_totals:
// int32[n_edges / kTile] scratch.
int dg_active_prefix(const int* words, int n_rows, const int* src, int* out,
                     int* tile_totals, long long n_edges, void* stream) {
  const int n_tiles = static_cast<int>(n_edges / kTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dense_tiles<<<n_tiles, kThreads, 0, st>>>(
      reinterpret_cast<const unsigned*>(words),
      static_cast<unsigned>(n_rows), src, out, tile_totals);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return finish_scan(out, tile_totals, n_tiles, st);
}

// K2. ftab: (33, 128) int32; the rest as for K1.
int dg_active_prefix_sparse(const int* ftab, const int* src, int* out,
                            int* tile_totals, long long n_edges,
                            void* stream) {
  const int n_tiles = static_cast<int>(n_edges / kTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sparse_tiles<<<n_tiles, kThreads, 0, st>>>(ftab, src, out, tile_totals);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return finish_scan(out, tile_totals, n_tiles, st);
}

}  // extern "C"
