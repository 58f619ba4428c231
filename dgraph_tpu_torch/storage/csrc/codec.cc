// Native block-packed sorted-uid codec — C++ twin of storage/packed.py.
//
// Role: the reference's hot codec is 146k lines of generated SSE2 asm
// (bp128/unpack_amd64.s) behind a Go shim; ours is one branch-light scalar
// loop the compiler auto-vectorizes, because the FORMAT was redesigned so a
// single kernel handles every bit width (see storage/packed.py's header).
// Wire format is bit-identical to the numpy codec: 128-lane blocks,
// struct-of-arrays metadata {first, last, count, width, word offset},
// little-endian deltas in a uint32 word stream, width-64 raw escape.
//
// Flat C ABI for ctypes (no pybind11 in this image). All buffers are
// caller-allocated numpy arrays:
//   nb        = ceil(n / 128)
//   words cap = 256 * nb          (raw-escape worst case)
//
// Copy of native/codec.cc for the PyTorch port. Built at first use by
// dgraph_tpu_torch/storage/native.py (g++ -O3 -shared) into
// build/dgraph_tpu_torch/ and loaded there.

#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t kBlock = 128;

inline int width_for(uint64_t maxd) {
  int w = 0;
  while (maxd >> w && w < 64) w++;
  return w > 32 ? 64 : w;
}

// Pack one 128-lane block whose deltas and count are prepared.
// Returns words consumed.
inline int64_t pack_block(const uint64_t* deltas, int w, uint32_t* words) {
  if (w == 64) {
    for (int i = 0; i < kBlock; i++) {
      words[2 * i] = (uint32_t)(deltas[i] & 0xFFFFFFFFu);
      words[2 * i + 1] = (uint32_t)(deltas[i] >> 32);
    }
    return 2 * kBlock;
  }
  if (w == 0) return 0;
  int64_t nwords = (kBlock * (int64_t)w) / 32;  // 128*w is always 32-aligned
  std::memset(words, 0, (size_t)nwords * 4);
  for (int i = 0; i < kBlock; i++) {
    int64_t bitpos = (int64_t)i * w;
    int64_t wi = bitpos >> 5;
    int sh = (int)(bitpos & 31);
    uint64_t v = deltas[i];
    words[wi] |= (uint32_t)((v << sh) & 0xFFFFFFFFu);
    uint32_t hi = (uint32_t)(v >> (32 - sh));  // sh==0 → v>>32 == 0 (w<=32)
    if (hi) words[wi + 1] |= hi;               // last lane never spills
  }
  return nwords;
}

inline int64_t pack_one(const uint64_t* uids, int64_t n, uint64_t* bfirst,
                        uint64_t* blast, int32_t* bcount, int32_t* bwidth,
                        int64_t* boff, uint32_t* words, int64_t woff0) {
  int64_t nb = (n + kBlock - 1) / kBlock;
  int64_t woff = woff0;
  uint64_t deltas[kBlock];
  for (int64_t b = 0; b < nb; b++) {
    int64_t s = b * kBlock;
    int64_t cnt = (s + kBlock <= n) ? kBlock : (n - s);
    deltas[0] = 0;
    uint64_t maxd = 0;
    for (int64_t i = 1; i < cnt; i++) {
      uint64_t d = uids[s + i] - uids[s + i - 1];
      deltas[i] = d;
      if (d > maxd) maxd = d;
    }
    for (int64_t i = cnt; i < kBlock; i++) deltas[i] = 0;
    int w = width_for(maxd);
    bfirst[b] = uids[s];
    blast[b] = uids[s + cnt - 1];
    bcount[b] = (int32_t)cnt;
    bwidth[b] = w;
    boff[b] = woff;
    woff += pack_block(deltas, w, words + woff);
  }
  return woff - woff0;
}

// Decode one block's deltas into acc-prefixed uids. `ws` must have one
// readable word past the block's packed span (caller pads the stream).
inline int64_t unpack_one(const uint64_t* bfirst, const int32_t* bcount,
                          const int32_t* bwidth, const int64_t* boff,
                          const uint32_t* words, int64_t nb, uint64_t* out) {
  int64_t k = 0;
  for (int64_t b = 0; b < nb; b++) {
    int w = bwidth[b];
    int cnt = bcount[b];
    uint64_t acc = bfirst[b];
    const uint32_t* ws = words + boff[b];
    out[k++] = acc;
    if (w == 64) {
      for (int i = 1; i < cnt; i++) {
        acc += (uint64_t)ws[2 * i] | ((uint64_t)ws[2 * i + 1] << 32);
        out[k++] = acc;
      }
    } else if (w == 0) {
      for (int i = 1; i < cnt; i++) out[k++] = acc;
    } else {
      uint64_t mask = (w >= 32) ? 0xFFFFFFFFull : ((1ull << w) - 1);
      for (int i = 1; i < cnt; i++) {
        int64_t bitpos = (int64_t)i * w;
        int64_t wi = bitpos >> 5;
        int sh = (int)(bitpos & 31);
        uint64_t pair = (uint64_t)ws[wi] | ((uint64_t)ws[wi + 1] << 32);
        acc += (pair >> sh) & mask;
        out[k++] = acc;
      }
    }
  }
  return k;
}

}  // namespace

extern "C" {

// Returns total words written (metadata arrays sized nb = ceil(n/128)).
int64_t dgt_pack(const uint64_t* uids, int64_t n, uint64_t* bfirst,
                 uint64_t* blast, int32_t* bcount, int32_t* bwidth,
                 int64_t* boff, uint32_t* words) {
  if (n == 0) return 0;
  return pack_one(uids, n, bfirst, blast, bcount, bwidth, boff, words, 0);
}

// words must carry >= 1 pad word past the packed span. Returns uids written.
int64_t dgt_unpack(const uint64_t* bfirst, const int32_t* bcount,
                   const int32_t* bwidth, const int64_t* boff,
                   const uint32_t* words, int64_t nb, uint64_t* out) {
  return unpack_one(bfirst, bcount, bwidth, boff, words, nb, out);
}

// Batched pack over R rows of a concatenated uid stream.
//   row_len[r]         length of row r
//   row_block_start[r] block index where row r's metadata begins (precomputed
//                      exclusive prefix sum of ceil(len/128))
// Global boff entries are row-relative (match pack_many's slicing contract);
// row_word_start[r] receives each row's base into the shared word stream.
// Returns total words written.
int64_t dgt_pack_many(const uint64_t* uids, const int64_t* row_len,
                      const int64_t* row_block_start, int64_t R,
                      uint64_t* bfirst, uint64_t* blast, int32_t* bcount,
                      int32_t* bwidth, int64_t* boff, uint32_t* words,
                      int64_t* row_word_start) {
  int64_t uoff = 0, woff = 0;
  for (int64_t r = 0; r < R; r++) {
    int64_t n = row_len[r];
    row_word_start[r] = woff;
    if (n == 0) continue;
    int64_t b0 = row_block_start[r];
    woff += pack_one(uids + uoff, n, bfirst + b0, blast + b0, bcount + b0,
                     bwidth + b0, boff + b0, words + woff, 0);
    uoff += n;
  }
  return woff;
}

// Batched unpack over R rows (shared metadata arrays laid out row-major,
// row_nb[r] blocks each; each row's boff entries are relative to its own
// word span starting at row_word_start[r]). words must carry >=1 pad word.
// Returns total uids written.
int64_t dgt_unpack_many(const uint64_t* bfirst, const int32_t* bcount,
                        const int32_t* bwidth, const int64_t* boff,
                        const uint32_t* words, const int64_t* row_nb,
                        const int64_t* row_word_start, int64_t R,
                        uint64_t* out) {
  int64_t k = 0, b0 = 0;
  for (int64_t r = 0; r < R; r++) {
    int64_t nb = row_nb[r];
    if (nb == 0) continue;
    k += unpack_one(bfirst + b0, bcount + b0, bwidth + b0, boff + b0,
                    words + row_word_start[r], nb, out + k);
    b0 += nb;
  }
  return k;
}

}  // extern "C"
