// Native host-side kernels for the TPU-native framework.
//
// The reference keeps its host/runtime hot paths native (Rust + C++
// RocksDB/jemalloc; SURVEY.md §2.1 "TPU-native equivalence note"). This
// library is the C++ analog for the paths JAX/XLA cannot express and
// Python is too slow for:
//   - CRC32C checksums for blob parts and control-transport framing
//     (service/src/transport.rs length-prefix + integrity analog)
//   - zigzag-varint delta compression of integer columns in persist
//     batch parts (the columnar codec of persist-client/src/batch.rs;
//     sorted time columns compress ~10x)
//   - multi-column lexicographic sort + run detection, the host-side
//     consolidation used by shard compaction (differential's
//     consolidate_updates; spine merge bookkeeping of row-spine)
//
// C ABI only: loaded via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli), slice-by-1 software table (portable).
// ---------------------------------------------------------------------------

static uint32_t crc32c_table[256];
static bool crc32c_init_done = false;

static void crc32c_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
    crc32c_table[i] = c;
  }
  crc32c_init_done = true;
}

uint32_t mtn_crc32c(const uint8_t* data, size_t n) {
  if (!crc32c_init_done) crc32c_init();
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++)
    crc = crc32c_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// Zigzag varint delta codec for int64 columns.
// Encodes deltas between consecutive values as zigzag varints; monotone
// (time) and clustered (dictionary code, key) columns shrink massively.
// ---------------------------------------------------------------------------

// All delta arithmetic is done in uint64 (mod 2^64): int64 deltas can
// overflow, which is UB in signed arithmetic under -O3. Zigzag of a
// two's-complement value held in a uint64: (d << 1) ^ (0 - (d >> 63)).

// Returns bytes written, or -1 if out_cap is insufficient.
int64_t mtn_vbyte_encode_i64(const int64_t* in, size_t n, uint8_t* out,
                             size_t out_cap) {
  size_t pos = 0;
  uint64_t prev = 0;
  for (size_t i = 0; i < n; i++) {
    uint64_t cur = static_cast<uint64_t>(in[i]);
    uint64_t d = cur - prev;  // mod 2^64
    uint64_t v = (d << 1) ^ (0 - (d >> 63));
    prev = cur;
    do {
      if (pos >= out_cap) return -1;
      uint8_t byte = v & 0x7F;
      v >>= 7;
      out[pos++] = byte | (v ? 0x80 : 0);
    } while (v);
  }
  return static_cast<int64_t>(pos);
}

// Returns bytes consumed, or -1 on malformed input.
int64_t mtn_vbyte_decode_i64(const uint8_t* in, size_t in_len, int64_t* out,
                             size_t n) {
  size_t pos = 0;
  uint64_t prev = 0;
  for (size_t i = 0; i < n; i++) {
    uint64_t v = 0;
    int shift = 0;
    while (true) {
      if (pos >= in_len || shift > 63) return -1;
      uint8_t byte = in[pos++];
      v |= static_cast<uint64_t>(byte & 0x7F) << shift;
      if (!(byte & 0x80)) break;
      shift += 7;
    }
    uint64_t d = (v >> 1) ^ (0 - (v & 1));
    prev += d;  // mod 2^64
    out[i] = static_cast<int64_t>(prev);
  }
  return static_cast<int64_t>(pos);
}

// ---------------------------------------------------------------------------
// Multi-column lexsort + run detection (host consolidation).
// cols: array of ncols pointers, each to an n-length int64 column,
// most-significant first. perm_out receives the stable sort permutation.
// ---------------------------------------------------------------------------

void mtn_lexsort_i64(const int64_t** cols, int ncols, size_t n,
                     int64_t* perm_out) {
  std::iota(perm_out, perm_out + n, static_cast<int64_t>(0));
  std::stable_sort(perm_out, perm_out + n,
                   [cols, ncols](int64_t a, int64_t b) {
                     for (int c = 0; c < ncols; c++) {
                       int64_t va = cols[c][a], vb = cols[c][b];
                       if (va != vb) return va < vb;
                     }
                     return false;
                   });
}

// Consolidate in one call: given key columns and a diff column, produce
// for each output run: the representative input row index and the summed
// diff. Returns the number of runs with nonzero summed diff.
// out_rows/out_diffs must have capacity n.
int64_t mtn_consolidate_i64(const int64_t** key_cols, int ncols,
                            const int64_t* diffs, size_t n,
                            int64_t* out_rows, int64_t* out_diffs) {
  if (n == 0) return 0;
  std::vector<int64_t> perm(n);
  mtn_lexsort_i64(key_cols, ncols, n, perm.data());
  size_t out = 0;
  size_t i = 0;
  while (i < n) {
    size_t j = i + 1;
    int64_t sum = diffs[perm[i]];
    while (j < n) {
      bool same = true;
      for (int c = 0; c < ncols; c++) {
        if (key_cols[c][perm[j]] != key_cols[c][perm[i]]) {
          same = false;
          break;
        }
      }
      if (!same) break;
      sum += diffs[perm[j]];
      j++;
    }
    if (sum != 0) {
      out_rows[out] = perm[i];
      out_diffs[out] = sum;
      out++;
    }
    i = j;
  }
  return static_cast<int64_t>(out);
}

}  // extern "C"
