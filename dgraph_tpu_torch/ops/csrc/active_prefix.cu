// Active-edge inclusive prefix kernels for the pull-BFS / @recurse hot path.
//
// Both kernels compute, over a destination-sorted edge stream `src` of
// source ranks (int32[E], E % kTile == 0), the inclusive prefix sum of
//     active[e] = 1 if src[e] is in the frontier, else 0
// so out[E-1] is the number of frontier-active edges. They differ only in
// the membership test (a bitmap, or a set of <= 4096 ranks); the scan is
// one and the same.
//
// Each call is one launch that reads the stream once and writes the output
// once: a single-pass scan with decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016).
//   - The grid is persistent: blocks per SM (occupancy API) x SMs, at most
//     one block per chunk. Each block builds its frontier structure in
//     shared memory once, then claims chunks of kChunk tiles of kTile edges
//     from a global counter until the counter passes the chunk count.
//     Claiming, not blockIdx, means a chunk a block waits on is always held
//     by a block that is running: blocks are scheduled in no order, so a
//     blockIdx walk could wait on a block that never becomes resident.
//   - Stream ahead, resolve behind. A block tests a whole chunk (each thread
//     kItems consecutive edges of every tile, loaded one tile ahead), keeps
//     only the membership bits (one 8-bit mask a thread and tile, in
//     registers) and publishes the chunk aggregate at once. Only then does
//     warp 0 look back for the chunk it streamed before, and the block writes
//     that chunk from its masks while the next chunk's first tile loads. So a
//     claimed chunk gets its aggregate without waiting on any look-back, and a
//     look-back mostly finds its predecessors already resolved.
//   - The look-back reads the predecessors' status words 32 at a time, waits
//     while any is empty, sums aggregates to the nearest inclusive prefix.
//   - A status word is 64 bits: the flag (0 none, 1 aggregate, 2 inclusive
//     prefix) in bits 32-33 and the value in bits 0-31, written with one
//     st.release.gpu and read with ld.acquire.gpu, so a reader never sees a
//     flag without its value.
//   - Scratch comes from the caller and the entry point zeroes it with one
//     memset on the launch stream before every launch: uint64[n_tiles]
//     (room for the n_tiles / kChunk chunk status words), then one more
//     uint64 whose low 32 bits are the counter.
// The shape was chosen on an H100 among timed variants: one tile at a time
// with a look-back per tile (claimed before or after the look-back) was
// about 1.5x slower, and so were blocks of 256 threads; chunks of 8 tiles,
// 8192-edge tiles, a chunk's loads all issued at once and a look-back
// window wider than 32 were no faster.
// Bytes: 4 B read and 4 B written per edge, plus the frontier structure
// once per block (from L2). At R-MAT scale 20 (E_pad 16,089,088) that is
// 128.7 MB, 38.4 us at 3.35 TB/s: both kernels are bound by bytes.
//
// Built by dgraph_tpu_torch/ops/prefix.py with nvcc for sm_90a into a shared
// library with a plain C interface (loaded by ctypes). Every entry point
// launches on the caller's stream, allocates nothing, and returns the CUDA
// error of its set-up calls or cudaGetLastError() after its launch
// (0 = success).

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kThreads = 512;               // threads per block
constexpr int kTile = 4096;                 // edges per tile; divides the
                                            // wrapper's EDGE_BLOCK (8192)
constexpr int kChunk = 4;                   // tiles per claimed chunk
constexpr int kItems = kTile / kThreads;    // 8 consecutive edges a thread
constexpr int kVecs = kItems / 4;           // loaded as two int4
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;                 // bitmap row width (words)
constexpr int kRowBytes = kLanes * 4;
constexpr int kMaxStagedRows = 400;         // 204,800 B: a block this large
                                            // still fits on one SM
constexpr int kTabEntries = 32 * kLanes;    // sparse table rows 1..32
constexpr int kSlotBits = 13;
constexpr int kSlots = 1 << kSlotBits;      // hash slots (32 KB)
constexpr int kEmpty = -1;                  // free slot; never a rank
constexpr unsigned long long kFlagAggregate = 1ull << 32;
constexpr unsigned long long kFlagPrefix = 2ull << 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kItems <= 32 && kVecs * 4 == kItems, "a mask holds kItems");
static_assert(8192 % kTile == 0, "the tile must divide EDGE_BLOCK");
static_assert(kSlots >= 2 * kTabEntries, "hash set at most half full");
static_assert(kWarps <= 32, "one warp scans the warp totals");

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned flag_of(unsigned long long s) {
  return static_cast<unsigned>(s >> 32);
}

struct ScanShared {
  int first;                      // the block's first chunk, broadcast
  int next;                       // the chunk claimed next, broadcast
  int prefix;                     // exclusive prefix of the chunk to write
  // warp totals of each tile, for three chunks in turn: the one being
  // streamed, the one being written, and the one whose total warp 0 sums
  int wtot[3][kChunk][kWarps];
};

__device__ __forceinline__ int warp_inclusive(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += n;
  }
  return v;
}

__device__ __forceinline__ void load_tile(const int* __restrict__ src,
                                          int tile, int4 (&v)[kVecs]) {
  const int4* p = reinterpret_cast<const int4*>(src + (long long)tile * kTile)
                  + threadIdx.x * kVecs;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) v[k] = __ldg(p + k);
}

__device__ __forceinline__ int claim(ScanShared& sh, unsigned* counter) {
  if (threadIdx.x == 0) sh.first = static_cast<int>(atomicAdd(counter, 1u));
  __syncthreads();
  return sh.first;
}

// Warp 0 only, every lane. The sum of all chunks before `chunk` (> 0), from
// the status words of its predecessors: lane i reads chunk pred - i, the
// warp waits until none of the 32 is empty, sums the aggregates up to the
// nearest inclusive prefix and stops there, or moves 32 chunks back.
__device__ __forceinline__ int look_back(const unsigned long long* status,
                                         int chunk) {
  const int lane = threadIdx.x & 31;
  int prefix = 0;
  for (int pred = chunk - 1;; pred -= 32) {
    const int idx = pred - lane;
    // chunk 0 always publishes an inclusive prefix, so no lane needs more
    unsigned long long s = idx >= 0 ? load_acquire(status + idx) : kFlagPrefix;
    while (__any_sync(kFull, flag_of(s) == 0)) {
      if (flag_of(s) == 0) s = load_acquire(status + idx);
    }
    const unsigned incl = __ballot_sync(kFull, flag_of(s) == 2);
    const int stop = incl ? __ffs(static_cast<int>(incl)) - 1 : 31;
    int v = lane <= stop ? static_cast<int>(static_cast<unsigned>(s)) : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    prefix += v;
    if (incl) return prefix;
  }
}

// All threads. Tests the chunk's tiles (its first tile already in `cur`)
// into `mask` and records each tile's warp totals in sh.wtot[buf]. Loads
// run one tile ahead of the tests.
template <class Member>
__device__ __forceinline__ void stream_chunk(
    ScanShared& sh, const int* __restrict__ src, int n_tiles, int chunk,
    int buf, int4 (&cur)[kVecs], unsigned (&mask)[kChunk],
    const Member& member) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = chunk * kChunk;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    int4 nxt[kVecs];
    const bool more = j + 1 < kChunk && t0 + j + 1 < n_tiles;
    if (more) load_tile(src, t0 + j + 1, nxt);
    unsigned m = 0;
    if (t0 + j < n_tiles) {
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        m |= static_cast<unsigned>(member(cur[k].x)) << (4 * k);
        m |= static_cast<unsigned>(member(cur[k].y)) << (4 * k + 1);
        m |= static_cast<unsigned>(member(cur[k].z)) << (4 * k + 2);
        m |= static_cast<unsigned>(member(cur[k].w)) << (4 * k + 3);
      }
    }
    mask[j] = m;
    const int x = warp_inclusive(__popc(m));
    if (lane == 31) sh.wtot[buf][j][warp] = x;
    if (more) {
#pragma unroll
      for (int k = 0; k < kVecs; ++k) cur[k] = nxt[k];
    }
  }
}

// Warp 0 only: the chunk aggregate from sh.wtot[buf].
__device__ __forceinline__ int chunk_total(const ScanShared& sh, int buf) {
  const int lane = threadIdx.x & 31;
  int v = 0;
  for (int i = lane; i < kChunk * kWarps; i += 32)
    v += (&sh.wtot[buf][0][0])[i];
#pragma unroll
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// All threads. Writes the chunk's prefix values from its masks, given the
// sum `carry` of everything before it. Every thread sums the warp totals
// itself: 16 independent broadcast loads measured faster on the H100 than
// one warp scan of them passed on by shuffles.
__device__ __forceinline__ void write_chunk(const ScanShared& sh,
                                            int* __restrict__ out,
                                            int n_tiles, int chunk, int buf,
                                            int carry,
                                            const unsigned (&mask)[kChunk]) {
  const int warp = threadIdx.x >> 5;
  const int t0 = chunk * kChunk;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (t0 + j >= n_tiles) break;
    const unsigned m = mask[j];
    const int run = __popc(m);
    const int x = warp_inclusive(run);
    int below = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = sh.wtot[buf][j][w];
      below += w < warp ? t : 0;
      total += t;
    }
    const int base = carry + below + x - run;
    int4* o = reinterpret_cast<int4*>(out + (long long)(t0 + j) * kTile)
              + threadIdx.x * kVecs;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int i = 4 * k;
      o[k] = make_int4(base + __popc(m & ((2u << i) - 1)),
                       base + __popc(m & ((2u << (i + 1)) - 1)),
                       base + __popc(m & ((2u << (i + 2)) - 1)),
                       base + __popc(m & ((2u << (i + 3)) - 1)));
    }
    carry += total;
  }
}

// The persistent chunk loop shared by both kernels. Chunk c0 was claimed
// and its first tile loaded into `cur` by the caller; member(rank) -> 0/1
// is the frontier test.
template <class Member>
__device__ __forceinline__ void scan_stream(
    ScanShared& sh, const int* __restrict__ src, int* __restrict__ out,
    unsigned long long* __restrict__ status, unsigned* __restrict__ counter,
    int n_tiles, int c0, int4 (&cur)[kVecs], const Member& member) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_chunks = (n_tiles + kChunk - 1) / kChunk;
  unsigned m0[kChunk], m1[kChunk];   // masks of chunks c0 and c1
  int b0 = 0;                        // sh.wtot slot of c0
  stream_chunk(sh, src, n_tiles, c0, b0, cur, m0, member);
  if (threadIdx.x == 0) sh.next = static_cast<int>(atomicAdd(counter, 1u));
  __syncthreads();
  int agg0 = 0;
  if (warp == 0) {
    agg0 = chunk_total(sh, b0);
    if (lane == 0)
      store_release(status + c0, (c0 == 0 ? kFlagPrefix : kFlagAggregate) |
                                     static_cast<unsigned>(agg0));
  }
  int c1 = sh.next;
  if (c1 < n_chunks) load_tile(src, c1 * kChunk, cur);
  while (true) {
    const int b1 = b0 == 2 ? 0 : b0 + 1;
    if (c1 < n_chunks) stream_chunk(sh, src, n_tiles, c1, b1, cur, m1, member);
    __syncthreads();        // c1's warp totals in
    int agg1 = 0;
    if (warp == 0) {
      unsigned claimed = 0;
      if (c1 < n_chunks) {
        if (lane == 0) claimed = atomicAdd(counter, 1u);
        agg1 = chunk_total(sh, b1);
        if (lane == 0)
          store_release(status + c1,
                        kFlagAggregate | static_cast<unsigned>(agg1));
      }
      int prefix = 0;
      if (c0 > 0) {
        prefix = look_back(status, c0);
        if (lane == 0)
          store_release(status + c0,
                        kFlagPrefix | static_cast<unsigned>(prefix + agg0));
      }
      if (lane == 0) {
        sh.prefix = prefix;
        sh.next = c1 < n_chunks ? static_cast<int>(claimed) : n_chunks;
      }
    }
    __syncthreads();        // c0's prefix and the next claim in
    const int c2 = sh.next;
    if (c2 < n_chunks) load_tile(src, c2 * kChunk, cur);   // during the writes
    write_chunk(sh, out, n_tiles, c0, b0, sh.prefix, m0);
    if (c1 >= n_chunks) break;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) m0[j] = m1[j];
    agg0 = agg1;
    c0 = c1;
    c1 = c2;
    b0 = b1;
  }
}

// Replaces dgraph_tpu/ops/pallas_bfs.py:_prefix_kernel (K1, dense frontier).
// Frontier as the bit-plane bitmap of pack_words: node n -> word row n>>12,
// lane n&127, bit (n>>7)&31; words is (n_rows, 128) int32. A rank whose row
// is outside the bitmap is inactive (the Pallas chunk loop never matches
// it), so padding may point anywhere past the real ranks.
// The per-edge bitmap gather is random: through L2 it costs a 32-byte
// sector per 4-byte word (515 MB at scale 20, four times the stream). So a
// bitmap of up to kMaxStagedRows rows (1,638,400 ranks; 68 KB at scale 20)
// is staged once per block in dynamic shared memory and each test is one
// shared-memory load; a larger one is read through the read-only path.
// The launch picks the variant by the bitmap's size; both give the same
// output. Integer operations per edge: 22 — the test 8 (row, range compare,
// word index 2, bit index 2, shift, and), the mask 2, the output 3 (and,
// popc, add), and what a thread does once per tile for its 8 edges (two
// warp scans, 20; the warp offsets, 48): 9. At the H100's INT32 rate that
// is 21.2 us at scale 20, below the 38.4 us of bytes.
struct StagedBitmap {
  const unsigned* words;   // shared memory
  unsigned n_rows;
  __device__ __forceinline__ int operator()(int s) const {
    const unsigned u = static_cast<unsigned>(s);
    const unsigned row = u >> 12;
    if (row >= n_rows) return 0;
    return static_cast<int>((words[(row << 7) | (u & (kLanes - 1))] >>
                             ((u >> 7) & 31u)) & 1u);
  }
};

struct GlobalBitmap {
  const unsigned* words;   // device memory, read-only
  unsigned n_rows;
  __device__ __forceinline__ int operator()(int s) const {
    const unsigned u = static_cast<unsigned>(s);
    const unsigned row = u >> 12;
    if (row >= n_rows) return 0;
    return static_cast<int>((__ldg(words + ((row << 7) | (u & (kLanes - 1))))
                             >> ((u >> 7) & 31u)) & 1u);
  }
};

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
dense_scan(const unsigned* __restrict__ words, unsigned n_rows,
           const int* __restrict__ src, int* __restrict__ out,
           unsigned long long* __restrict__ status, int n_tiles) {
  extern __shared__ int4 staged[];
  __shared__ ScanShared sh;
  unsigned* counter = reinterpret_cast<unsigned*>(status + n_tiles);
  const int chunk = claim(sh, counter);
  if (chunk * kChunk >= n_tiles) return;
  int4 cur[kVecs];
  load_tile(src, chunk * kChunk, cur);   // in flight while the bitmap stages
  if constexpr (kStaged) {
    const int4* g = reinterpret_cast<const int4*>(words);
    for (int i = threadIdx.x; i < static_cast<int>(n_rows) * (kLanes / 4);
         i += kThreads)
      staged[i] = __ldg(g + i);
    __syncthreads();
    scan_stream(sh, src, out, status, counter, n_tiles, chunk, cur,
                StagedBitmap{reinterpret_cast<const unsigned*>(staged),
                             n_rows});
  } else {
    scan_stream(sh, src, out, status, counter, n_tiles, chunk, cur,
                GlobalBitmap{words, n_rows});
  }
}

// Replaces dgraph_tpu/ops/pallas_bfs.py:_prefix_kernel_sparse (K2, frontier
// of <= 4096 ranks). Table (33, 128) int32 as _frontier_table builds it:
// row 0 holds each 32-entry bucket's max, rows 1..32 the sorted entries,
// INT32_MAX pads. The Pallas kernel's test (a 7-step lower bound over the
// bucket maxima, then a 32-way compare: ~40 shared-memory loads an edge)
// is, for such a table, "src[e] is an entry of rows 1..32". So each block
// builds once an open-addressed hash set of those entries in shared memory
// (8192 slots, at most half full; multiplicative hash, linear probing,
// atomicCAS inserts; a run of equal entries such as the pads inserts once,
// and INT32_MAX is inserted like any entry), and an edge costs an expected
// 1-3 probes. A probe tests for the free marker before the key, so a rank
// equal to kEmpty misses. Integer operations per edge with one probe (a
// table of 128 ranks in 8192 slots): 19 — hash 2 (multiply, shift), the
// probe 3 (free and key compares, select), the mask 2, the output 3, the
// per-tile work as for K1, 9: 18.3 us at scale 20, below the 38.4 us of
// bytes.
__device__ __forceinline__ unsigned slot_of(int v) {
  return (static_cast<unsigned>(v) * 0x9E3779B9u) >> (32 - kSlotBits);
}

struct HashSet {
  const int* slots;        // shared memory
  __device__ __forceinline__ int operator()(int s) const {
    // terminates: at most kTabEntries keys, so at least half the slots free
    for (unsigned h = slot_of(s);; h = (h + 1) & (kSlots - 1)) {
      const int t = slots[h];
      if (t == kEmpty) return 0;
      if (t == s) return 1;
    }
  }
};

__global__ void __launch_bounds__(kThreads)
sparse_scan(const int* __restrict__ ftab, const int* __restrict__ src,
            int* __restrict__ out, unsigned long long* __restrict__ status,
            int n_tiles) {
  __shared__ int slots[kSlots];
  __shared__ ScanShared sh;
  unsigned* counter = reinterpret_cast<unsigned*>(status + n_tiles);
  const int chunk = claim(sh, counter);
  if (chunk * kChunk >= n_tiles) return;
  int4 cur[kVecs];
  load_tile(src, chunk * kChunk, cur);   // in flight while the set is built
  for (int i = threadIdx.x; i < kSlots; i += kThreads) slots[i] = kEmpty;
  __syncthreads();
  const int* entries = ftab + kLanes;
  for (int i = threadIdx.x; i < kTabEntries; i += kThreads) {
    const int v = __ldg(entries + i);
    if (i > 0 && __ldg(entries + i - 1) == v) continue;
    for (unsigned h = slot_of(v);; h = (h + 1) & (kSlots - 1)) {
      const int old = atomicCAS(slots + h, kEmpty, v);
      if (old == kEmpty || old == v) break;
    }
  }
  __syncthreads();
  scan_stream(sh, src, out, status, counter, n_tiles, chunk, cur,
              HashSet{slots});
}

// ---- launch set-up, cached per device -------------------------------------

// 0 = not read yet.
struct DeviceCache {
  std::atomic<int> sms;                          // SM count
  std::atomic<int> staged_attr;                  // dynamic smem limit raised
  std::atomic<int> occ_staged[kMaxStagedRows + 1];   // blocks per SM
  std::atomic<int> occ_global;
  std::atomic<int> occ_sparse;
};
constexpr int kMaxDevices = 64;
DeviceCache g_cache[kMaxDevices];

// The current device's cache; a device past kMaxDevices is refused.
cudaError_t device_cache(DeviceCache** c) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *c = &g_cache[dev];
  return cudaSuccess;
}

// Reads slot, or computes it with read(v) and stores it.
template <class Read>
cudaError_t cached(std::atomic<int>& slot, int* v, Read read) {
  *v = slot.load(std::memory_order_relaxed);
  if (*v) return cudaSuccess;
  const cudaError_t err = read(v);
  if (err == cudaSuccess) slot.store(*v, std::memory_order_relaxed);
  return err;
}

// The persistent grid: blocks per SM x SMs, at most one block per chunk.
// occ is the kernel's blocks-per-SM slot in c.
cudaError_t persistent_grid(const void* kernel, size_t smem, DeviceCache& c,
                            std::atomic<int>& occ, int n_tiles, int* grid) {
  const int dev = static_cast<int>(&c - g_cache);
  int sms = 0, per_sm = 0;
  cudaError_t err = cached(c.sms, &sms, [&](int* v) {
    return cudaDeviceGetAttribute(v, cudaDevAttrMultiProcessorCount, dev);
  });
  if (err != cudaSuccess) return err;
  err = cached(occ, &per_sm, [&](int* v) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(v, kernel, kThreads,
                                                         smem);
  });
  if (err != cudaSuccess) return err;
  // per_sm 0 (the block cannot fit): launch one a SM and let it be refused
  const long long blocks =
      static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int n_chunks = (n_tiles + kChunk - 1) / kChunk;
  *grid = static_cast<int>(blocks < n_chunks ? blocks : n_chunks);
  return cudaSuccess;
}

// Zeroes the status words and the counter on the launch stream.
cudaError_t clear_scratch(unsigned long long* scratch, int n_tiles,
                          cudaStream_t st) {
  return cudaMemsetAsync(scratch, 0,
                         (static_cast<size_t>(n_tiles) + 1) * sizeof(*scratch),
                         st);
}

}  // namespace

extern "C" {

// Edges per tile: the wrapper sizes the status scratch with it.
int dg_tile_edges() { return kTile; }

// K1. words: (n_rows, 128) int32; src, out: int32[n_edges], n_edges a
// positive multiple of kTile; words, src, out 16-byte aligned; scratch:
// uint64[n_edges / kTile + 1], zeroed here before the launch.
int dg_active_prefix(const int* words, int n_rows, const int* src, int* out,
                     unsigned long long* scratch, long long n_edges,
                     void* stream) {
  const int n_tiles = static_cast<int>(n_edges / kTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned* w = reinterpret_cast<const unsigned*>(words);
  DeviceCache* c = nullptr;
  cudaError_t err = device_cache(&c);
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = 0;
  if (n_rows <= kMaxStagedRows) {
    const void* kernel = reinterpret_cast<const void*>(&dense_scan<true>);
    if (!c->staged_attr.load()) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxStagedRows * kRowBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      c->staged_attr.store(1);
    }
    const size_t smem = static_cast<size_t>(n_rows) * kRowBytes;
    err = persistent_grid(kernel, smem, *c, c->occ_staged[n_rows], n_tiles,
                          &grid);
    if (err == cudaSuccess) err = clear_scratch(scratch, n_tiles, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    dense_scan<true><<<grid, kThreads, smem, st>>>(
        w, static_cast<unsigned>(n_rows), src, out, scratch, n_tiles);
  } else {
    const void* kernel = reinterpret_cast<const void*>(&dense_scan<false>);
    err = persistent_grid(kernel, 0, *c, c->occ_global, n_tiles, &grid);
    if (err == cudaSuccess) err = clear_scratch(scratch, n_tiles, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    dense_scan<false><<<grid, kThreads, 0, st>>>(
        w, static_cast<unsigned>(n_rows), src, out, scratch, n_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2. ftab: (33, 128) int32; the rest as for K1.
int dg_active_prefix_sparse(const int* ftab, const int* src, int* out,
                            unsigned long long* scratch, long long n_edges,
                            void* stream) {
  const int n_tiles = static_cast<int>(n_edges / kTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DeviceCache* c = nullptr;
  cudaError_t err = device_cache(&c);
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = 0;
  err = persistent_grid(reinterpret_cast<const void*>(&sparse_scan), 0, *c,
                        c->occ_sparse, n_tiles, &grid);
  if (err == cudaSuccess) err = clear_scratch(scratch, n_tiles, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  sparse_scan<<<grid, kThreads, 0, st>>>(ftab, src, out, scratch, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
