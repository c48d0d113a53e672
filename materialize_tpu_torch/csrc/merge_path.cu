// Merge-path merge of two sorted lane matrices: the spine's fold merge.
//
// Replaces materialize_tpu/ops/merge_pallas.py:pallas_search_right (the
// Pallas call at :157, kernel body _merge_sweep_kernel at :93: a two-pointer
// merge sweep that yields each b row's right insertion point) and, in the
// same pass, the mark/cumsum inversion and the lanes gather that turned
// those points into the merged run (ops/merge.py:merge_source_map_torch is
// the plain version of all three outputs).
//
// Inputs: a [m, L] and b [n, L] int64 in the port's stored lane form
// (stored = u64_bits ^ (1 << 63), ops/lanes.py), compared as SIGNED int64,
// which is exactly the reference's u64 order. The valid prefixes are
// a[:a_count] and b[:b_count], both sorted; the counts are read from device
// memory (the spine keeps them there: a host read would add a sync to every
// fold). b's rows past b_count may hold anything and are never read as keys.
//
// Outputs, each optional (null pointer: not written):
//   pos    [n] int32            for each b row placed in the output, the
//                               count of a rows before it (the right
//                               insertion point, ties placing a first);
//   src    [out_capacity] int64 the merged run's source map, an index into
//                               concat(a, b) (b's rows offset by cap_a);
//   merged [out_capacity, L]    the merged run's lanes, concat(a, b)[src].
// With T = min(a_count + b_count, out_capacity), slots [0, T) hold the
// stable merge (on overflow the b rows past the end are dropped) and slots
// k in [T, out_capacity) take src = min(k - b_count, max(cap_a - 1, 0)),
// bit for bit as the plain formula.
//
// Design. The grid covers the output slots in tiles of K slots, K sized
// from L so that both input tiles fit in shared memory (2*K*L*8 bytes;
// smaller K for wide rows). Each block:
//  1. finds the co-rank (a rows among the first d slots) of its first and
//     its last slot by a merge-path diagonal search over a[:a_count] and
//     b[:b_count] with the rule a[i] <= b[j] => a first (the TPU sweep's
//     lex_le), so ties keep a first and runs of equal rows longer than a
//     tile split exactly. One warp per diagonal probes 32 points per step:
//     ~5 dependent loads at 2^23 rows instead of 23;
//  2. stages its a and b tiles (contiguous row ranges) in dynamic shared
//     memory with cp.async: 16-byte pieces, plus one 8-byte piece at a
//     tile's head or tail where it starts off a 16-byte boundary;
//  3. lets each thread find its own split inside the tiles (binary search
//     in shared memory) and merge V consecutive slots serially, recording
//     each slot's source row and each b row's insertion point in shared
//     memory;
//  4. writes src, the merged lanes and pos from shared memory, consecutive
//     threads on consecutive addresses (coalesced stores);
//  5. fills its tile's padding slots (k >= T) straight from their source
//     rows, which are consecutive rows of a.
// There is no product here, so tensor cores (wgmma) have no role.
//
// Bound: memory. Counting each input byte read once and each output byte
// written once:
//   bytes = T*L*8             the valid a and b rows the merge consumes
//         + P*L*8             the distinct padding source rows
//         + out*8 + out*L*8   src and merged lanes (when requested)
//         + placed*4          pos (when requested)
// over 3.35 TB/s on an H100 SXM; the compares are a few integer operations
// per byte.
//
// Against the first version (one thread per b row binary-searching a):
//  - the search was latency-bound (~23 dependent, uncoalesced probes per
//    row); here each a and b row is read once, in whole tiles, and the
//    dependent chain is ~5 loads per block;
//  - the insertion points were only the start of the merge: ~16 eager
//    launches (mark, cumsum, where/clamp, cat + gather) followed, moving
//    about 4x the bytes of this single pass;
//  - its timing measured the host path around one launch; the wrapper's
//    warm path (ops/merge_kernel.py) now takes no lock and enters no device
//    context, and chip_smoke.py times runs of many launches.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBudget = 96 * 1024;  // bytes a block may stage
constexpr int kSmemMax = 227 * 1024;    // H100: per-block maximum

// Lexicographic compare of two rows of L int64 lanes (-1, 0, 1).
// L > 0: lane count fixed at compile time; L == 0: runtime `lanes`.
template <int L>
__device__ __forceinline__ int lex_cmp(const int64_t* x, const int64_t* y,
                                       int /*lanes*/) {
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int64_t xv = x[k], yv = y[k];
    if (xv != yv) return xv < yv ? -1 : 1;
  }
  return 0;
}

template <>
__device__ __forceinline__ int lex_cmp<0>(const int64_t* x, const int64_t* y,
                                          int lanes) {
  for (int k = 0; k < lanes; ++k) {
    const int64_t xv = x[k], yv = y[k];
    if (xv != yv) return xv < yv ? -1 : 1;
  }
  return 0;
}

// Co-rank of diagonal d in device memory: the number of a rows among the
// first d slots of the stable merge of a[:na] and b[:nb]. All 32 lanes of
// one warp call it. The predicate a[i] <= b[d-1-i] is true then false over
// i in [max(0, d-nb), min(d, na)); each step probes 32 points spread over
// the range and keeps the gap where it turns false.
template <int L>
__device__ int64_t corank_warp(const int64_t* a, int64_t na, const int64_t* b,
                               int64_t nb, int64_t d, int w, int lane) {
  int64_t lo = d - nb > 0 ? d - nb : 0;
  int64_t hi = d < na ? d : na;
  while (lo < hi) {
    const int64_t r = hi - lo;
    const int64_t i = lo + (static_cast<int64_t>(lane + 1) * r) / 33;  // < hi
    const bool p = lex_cmp<L>(a + i * w, b + (d - 1 - i) * w, w) <= 0;
    const int c = __popc(__ballot_sync(0xffffffffu, p));  // a prefix of lanes
    if (c == 0) {
      hi = lo + r / 33;
    } else {
      const int64_t last_true = lo + (static_cast<int64_t>(c) * r) / 33;
      if (c < 32) hi = lo + (static_cast<int64_t>(c + 1) * r) / 33;
      lo = last_true + 1;
    }
  }
  return lo;
}

// The same co-rank by one thread, over tiles in shared memory.
template <int L>
__device__ int corank_seq(const int64_t* as, int na, const int64_t* bs, int nb,
                          int d, int w) {
  int lo = d - nb > 0 ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lex_cmp<L>(as + mid * w, bs + (d - 1 - mid) * w, w) <= 0) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ void cp_async16(int64_t* dst, const int64_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async8(int64_t* dst, const int64_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

// Start copying words src[0, nwords) to shared memory at dst + phase, where
// the phase (0 or 1 word) gives the copy the same 16-byte alignment as src.
// dst is 16-byte aligned and holds nwords + 2 words. Returns the phase; the
// caller commits and waits.
__device__ int stage_async(int64_t* dst, const int64_t* src, int64_t nwords) {
  const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 3) & 1);
  int64_t* d = dst + phase;
  if (nwords <= 0) return phase;
  const int64_t head = phase < nwords ? phase : nwords;  // words before a 16-byte boundary
  const int64_t pairs = (nwords - head) >> 1;
  for (int64_t q = threadIdx.x; q < pairs; q += blockDim.x) {
    cp_async16(d + head + 2 * q, src + head + 2 * q);
  }
  if (threadIdx.x == 0 && head == 1) cp_async8(d, src);
  if (threadIdx.x == blockDim.x - 1 && ((nwords - head) & 1)) {
    cp_async8(d + nwords - 1, src + nwords - 1);
  }
  return phase;
}

template <int L>
__global__ void __launch_bounds__(kThreads)
merge_path_kernel(const int64_t* __restrict__ a,
                  const int32_t* __restrict__ a_count_dev,
                  const int64_t* __restrict__ b,
                  const int32_t* __restrict__ b_count_dev, int64_t m,
                  int64_t n, int64_t cap_a, int64_t out_cap, int lanes,
                  int tile, int32_t* __restrict__ pos,
                  int64_t* __restrict__ src, int64_t* __restrict__ merged) {
  extern __shared__ __align__(16) int64_t smem[];
  __shared__ int64_t split[2];
  const int w = L > 0 ? L : lanes;
  const int tid = threadIdx.x;

  int64_t na = *a_count_dev;
  na = na < 0 ? 0 : (na > m ? m : na);
  int64_t nb = b_count_dev != nullptr ? static_cast<int64_t>(*b_count_dev) : n;
  nb = nb < 0 ? 0 : (nb > n ? n : nb);
  const int64_t total = na + nb < out_cap ? na + nb : out_cap;  // T
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t kend = k0 + tile < out_cap ? k0 + tile : out_cap;

  if (k0 < total) {
    // -- 1. the tile's split points ------------------------------------------
    const int64_t k1 = kend < total ? kend : total;
    const int warp = tid >> 5, lane = tid & 31;
    if (warp < 2) {
      const int64_t i = corank_warp<L>(a, na, b, nb, warp == 0 ? k0 : k1, w, lane);
      if (lane == 0) split[warp] = i;
    }
    __syncthreads();
    const int64_t i0 = split[0], i1 = split[1];
    const int64_t j0 = k0 - i0, j1 = k1 - i1;
    const int na_t = static_cast<int>(i1 - i0);
    const int nb_t = static_cast<int>(j1 - j0);
    const int nk = static_cast<int>(k1 - k0);

    // -- 2. stage both tiles ---------------------------------------------------
    const int64_t region = static_cast<int64_t>(tile) * w + 2;  // even: tile >= 4
    int64_t* sa = smem;
    int64_t* sb = smem + region;
    int32_t* rowsel = reinterpret_cast<int32_t*>(smem + 2 * region);  // [tile]
    int32_t* bpos = rowsel + tile;                                      // [tile]
    const int pa = stage_async(sa, a + i0 * w, static_cast<int64_t>(na_t) * w);
    const int pb = stage_async(sb, b + j0 * w, static_cast<int64_t>(nb_t) * w);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    const int64_t* as = sa + pa;
    const int64_t* bs = sb + pb;

    // -- 3. per-thread split and serial merge --------------------------------
    // rowsel[k]: a row r as r >= 0, b row r as ~r; bpos[j]: a rows before b row j.
    const int v = (tile + kThreads - 1) / kThreads;
    const int d0 = tid * v < nk ? tid * v : nk;
    const int d1 = d0 + v < nk ? d0 + v : nk;
    if (d0 < d1) {
      int ii = corank_seq<L>(as, na_t, bs, nb_t, d0, w);
      int jj = d0 - ii;
      for (int k = d0; k < d1; ++k) {
        const bool take_a =
            jj >= nb_t || (ii < na_t && lex_cmp<L>(as + ii * w, bs + jj * w, w) <= 0);
        if (take_a) {
          rowsel[k] = ii++;
        } else {
          rowsel[k] = ~jj;
          bpos[jj++] = ii;
        }
      }
    }
    __syncthreads();

    // -- 4. coalesced stores -------------------------------------------------
    if (src != nullptr) {
      for (int k = tid; k < nk; k += kThreads) {
        const int r = rowsel[k];
        src[k0 + k] = r >= 0 ? i0 + r : cap_a + j0 + ~r;
      }
    }
    if (merged != nullptr) {
      int64_t* out = merged + k0 * w;
      const int words = nk * w;
      for (int q = tid; q < words; q += kThreads) {
        const int k = q / w;
        const int r = rowsel[k];
        out[q] = (r >= 0 ? as + r * w : bs + (~r) * w)[q - k * w];
      }
    }
    if (pos != nullptr) {
      for (int jj = tid; jj < nb_t; jj += kThreads) {
        pos[j0 + jj] = static_cast<int32_t>(i0 + bpos[jj]);
      }
    }
  }

  // -- 5. padding slots [T, out_capacity) of this tile ------------------------
  const int64_t p0 = k0 > total ? k0 : total;
  if (p0 < kend) {
    const int64_t top = cap_a > 0 ? cap_a - 1 : 0;
    if (src != nullptr) {
      for (int64_t k = p0 + tid; k < kend; k += kThreads) {
        const int64_t r = k - nb;
        src[k] = r < top ? r : top;
      }
    }
    if (merged != nullptr) {
      const int64_t words = (kend - p0) * w;
      for (int64_t q = tid; q < words; q += kThreads) {
        const int64_t dk = q / w;
        const int64_t k = p0 + dk;
        const int64_t r = k - nb < top ? k - nb : top;
        const int64_t* row = r < cap_a ? a + r * w : b + (r - cap_a) * w;
        merged[k * w + (q - dk * w)] = row[q - dk * w];
      }
    }
  }
}

// Slots per tile for rows of `lanes` lanes: the largest power of two up to
// 2048 whose two input tiles and per-slot records fit the staging budget.
int tile_for(int lanes) {
  int tile = 2048;
  while (tile > 4 && static_cast<int64_t>(tile) * (16 * lanes + 8) + 32 > kSmemBudget) {
    tile >>= 1;
  }
  return tile;
}

template <int L>
int launch(const int64_t* a, const int32_t* a_count_dev, const int64_t* b,
           const int32_t* b_count_dev, int64_t m, int64_t n, int lanes,
           int64_t cap_a, int64_t out_cap, int32_t* pos, int64_t* src,
           int64_t* merged, cudaStream_t stream) {
  const int tile = tile_for(lanes);
  const int64_t smem = static_cast<int64_t>(tile) * (16 * lanes + 8) + 32;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  // The attribute belongs to the current device: remember, per device,
  // the largest size set so far (0: none, so the default 48 KiB holds).
  constexpr int kMaxDevices = 64;
  static int64_t smem_allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024 && (dev >= kMaxDevices || smem > smem_allowed[dev])) {
    err = cudaFuncSetAttribute(merge_path_kernel<L>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) smem_allowed[dev] = smem;
  }
  const int64_t blocks = (out_cap + tile - 1) / tile;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  merge_path_kernel<L><<<static_cast<unsigned>(blocks), kThreads,
                         static_cast<size_t>(smem), stream>>>(
      a, a_count_dev, b, b_count_dev, m, n, cap_a, out_cap, lanes, tile, pos,
      src, merged);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a [m, L], b [n, L]; a_count and b_count are int32 device scalars
// (b_count null: all n rows). Returns a cudaError_t code (0: launched).
extern "C" int merge_path(const int64_t* a, const int32_t* a_count_dev,
                          const int64_t* b, const int32_t* b_count_dev,
                          int64_t m, int64_t n, int L, int64_t cap_a,
                          int64_t out_capacity, int32_t* pos, int64_t* src,
                          int64_t* merged, void* stream) {
  if (L <= 0 || cap_a < 0 || cap_a > m || m < 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (out_capacity <= 0) return 0;
  if ((src != nullptr || merged != nullptr) && cap_a == 0 && n == 0) {
    return static_cast<int>(cudaErrorInvalidValue);  // no row to pad from
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 1: return launch<1>(a, a_count_dev, b, b_count_dev, m, n, L, cap_a, out_capacity, pos, src, merged, s);
    case 2: return launch<2>(a, a_count_dev, b, b_count_dev, m, n, L, cap_a, out_capacity, pos, src, merged, s);
    case 3: return launch<3>(a, a_count_dev, b, b_count_dev, m, n, L, cap_a, out_capacity, pos, src, merged, s);
    case 4: return launch<4>(a, a_count_dev, b, b_count_dev, m, n, L, cap_a, out_capacity, pos, src, merged, s);
    case 8: return launch<8>(a, a_count_dev, b, b_count_dev, m, n, L, cap_a, out_capacity, pos, src, merged, s);
    default: return launch<0>(a, a_count_dev, b, b_count_dev, m, n, L, cap_a, out_capacity, pos, src, merged, s);
  }
}
