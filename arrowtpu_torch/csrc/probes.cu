// Probe kernels: the H100 counterparts of the TPU micro-probes
// scripts/prof_*.py (P1-P7).  Each asks one question of the card: what a
// plain stream costs (the measured copy floor), what a chain of in-row
// rolls costs, and what each in-tile gather pattern costs over a copy.
//
// Replaces the pl.pallas_call bodies of
//   * stream_kernel: P4 (scripts/prof_floor.py:35 and :82, out = x + keep,
//     BlockSpec and manual DMA), P1's copy (prof_gather.py:51) and the
//     "copy 256" of P2 (prof_gather256.py:61) and P3 (prof_deint.py:79);
//   * lane_roll_kernel: P1's roll chains (prof_gather.py:55-76) and P7's
//     roll calibration (prof_v3.py:91-102);
//   * tile_gather_kernel: the in-tile gathers of P1 (prof_gather.py:78-141),
//     P2 (prof_gather256.py:64-96), P3 (prof_deint.py:81-95), P5
//     (prof_pairlayout.py:68-71) and P7 (prof_v3.py:133, :167), the
//     sublane gather of P1 (prof_gather.py:90-96) and P7 by
//     sublane_gather_kernel.
// The TPU machinery (lane rolls on the XLU, the MXU one-hot row move, DMA
// strategies) does not carry over; the function each body computes does.
//
// Bound on an H100 SXM: all three move data, so bytes over 3.35 TB/s of
// HBM3 (each input word read once, each output word written once), except
// lane_roll's selected chains, which do one select a word a roll.  The
// designs:
//   * stream: a grid-stride loop of 16-byte loads and stores per plane
//     (blockIdx.y), with scalar edges, so any n and any plane offset work;
//   * lane_roll: a lane holds 16 contiguous words of a row (8 lanes a row,
//     4 rows a warp, staged through shared memory so that every global
//     access is a coalesced 16-byte-a-lane row); a selected roll by s is s
//     shuffles a warp and one select a word, and the unselected rolls
//     compose into one rotation (16 shuffles a lane): the selected chains
//     are bound by the selects' issue rate, the rest by HBM;
//   * tile_gather: each thread writes 4 consecutive output words (one
//     16-byte store) and reads its sources through L1 / L2, except for the
//     sublane gather.  The row of a lane gather is in L1 after its first
//     touch; static patterns compute their sources in registers (the round
//     trip deinterleaves a quad of pairs and reinterleaves it in registers:
//     one launch, where two would write both planes to HBM and read them
//     back).  A sublane gather reads a column of a row chosen at random,
//     so it is staged: a (512, 128) u32 tile is 256 KB, more than a
//     block's 227 KB of shared memory, so a block takes one column slab of
//     a tile, 512 rows x 32 words (64 KB of dynamic shared memory, 3
//     blocks an SM), copies it in by 16-byte cp.async and gathers from it
//     (sublane_gather_kernel): each x word is read from HBM once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 512;  // T: rows of a gather tile
constexpr int kRowWords = 128;  // words of a rolled row
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// stream: out[p, i] = in[p, i] (+ keep[i])
// ---------------------------------------------------------------------------

template <bool kAddKeep>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
              const uint8_t* __restrict__ keep, int64_t n) {
  const int64_t p = blockIdx.y;
  const uint32_t* __restrict__ src = in + p * n;
  uint32_t* __restrict__ dst = out + p * n;
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  const uintptr_t da = reinterpret_cast<uintptr_t>(dst);
  // words before src's first 16-byte boundary; all words go scalar when src
  // and dst are not aligned alike
  int64_t head = static_cast<int64_t>(((16 - (sa & 15)) & 15) >> 2);
  if (((sa ^ da) & 15) != 0 || head > n) head = n;
  const int64_t quads = (n - head) >> 2;
  const int64_t tail = head + quads * 4;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;

  for (int64_t i = tid; i < head; i += stride) {
    dst[i] = src[i] + (kAddKeep ? keep[i] : 0u);
  }
  for (int64_t i = tail + tid; i < n; i += stride) {
    dst[i] = src[i] + (kAddKeep ? keep[i] : 0u);
  }
  const uint4* __restrict__ s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* __restrict__ d4 = reinterpret_cast<uint4*>(dst + head);
  const uint8_t* __restrict__ k = keep + head;
  const bool k4 = kAddKeep && (reinterpret_cast<uintptr_t>(k) & 3) == 0;
  for (int64_t q = tid; q < quads; q += stride) {
    uint4 v = s4[q];
    if (kAddKeep) {
      uchar4 b;
      if (k4) {
        b = reinterpret_cast<const uchar4*>(k)[q];
      } else {
        b = make_uchar4(k[4 * q], k[4 * q + 1], k[4 * q + 2], k[4 * q + 3]);
      }
      v.x += b.x;
      v.y += b.y;
      v.z += b.z;
      v.w += b.w;
    }
    d4[q] = v;
  }
}

// ---------------------------------------------------------------------------
// lane_roll: k rolls of each 128-word row, the first nsel of them selects
// ---------------------------------------------------------------------------

// Roll j shifts the row by s = 1 + j % 7 words in np.roll's direction,
// y[l] = v[(l - s) mod 128], then v = m ? y : v for j < nsel, else v = y.
// m is mask > 2^30 (mask given) or x > 7 of the original x.
//
// A lane holds kRollW contiguous words of a row (a row is kRowLanes lanes,
// a warp kWarpRows rows), so a roll by a compile-time s is register
// renaming inside the lane plus s shuffles from the row's previous lane,
// each shuffle serving every row of the warp, and one select (a LOP3
// against the word's m, kept as a full-word mask) per word.  The rolls
// j >= nsel compose into one rotation by their summed shift (`tail`, mod
// 128), done once at the end by 16 shuffles; with nsel = 0 the kernel is a
// copy through a rotated index.
constexpr int kRollW = 16;
constexpr int kRowLanes = kRowWords / kRollW;  // 8
constexpr int kWarpRows = 32 / kRowLanes;      // 4
constexpr int kRowsPerBlock = kThreads / 32 * kWarpRows;

// (y & m) | (v & ~m) as one LOP3: written out, the compiler turns m back
// into predicates, which do not fit in the predicate registers
__device__ __forceinline__ uint32_t select_word(uint32_t m, uint32_t y,
                                                uint32_t v) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xE4;" : "=r"(d) : "r"(y), "r"(v), "r"(m));
  return d;
}

// v = m ? roll(v, S) : v; prev: the lane holding the row's previous words
template <int S>
__device__ __forceinline__ void select_roll(uint32_t (&v)[kRollW],
                                            const uint32_t (&m)[kRollW],
                                            int prev) {
  uint32_t t[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    t[i] = __shfl_sync(kFull, v[kRollW - S + i], prev);
  }
#pragma unroll
  for (int i = kRollW - 1; i >= S; --i) v[i] = select_word(m[i], v[i - S], v[i]);
#pragma unroll
  for (int i = 0; i < S; ++i) v[i] = select_word(m[i], t[i], v[i]);
}

// v = roll(v, 16 q + R): word i from register (i - R) mod 16 of lane
// from_a (the row's lane t - q) for i >= R, of lane from_b (t - q - 1)
// below; R is a template argument so that every register index is fixed.
template <int R>
__device__ __forceinline__ void rotate_row(uint32_t (&v)[kRollW], int r,
                                           int from_a, int from_b) {
  if (r != R) {
    if constexpr (R + 1 < kRollW) rotate_row<R + 1>(v, r, from_a, from_b);
    return;
  }
  uint32_t o[kRollW];
#pragma unroll
  for (int i = 0; i < kRollW; ++i) {
    o[i] = __shfl_sync(kFull, v[(i - R) & (kRollW - 1)],
                       i >= R ? from_a : from_b);
  }
#pragma unroll
  for (int i = 0; i < kRollW; ++i) v[i] = o[i];
}

// A warp's rows pass through shared memory on their way in and out, so
// that every global access is one coalesced 512-byte row: 16-byte chunk u
// of the warp's rows is chunk u % 4 of lane u / 4, kept at chunk_at(lane,
// chunk), a swizzle under which neither side's 16-byte accesses meet on a
// bank.  vec: x, mask and out 16-byte aligned (a row is 512 bytes, so then
// every chunk is); else each lane reads and writes its words alone.
constexpr int kWarpChunks = kWarpRows * kRowWords / 4;  // 128

__device__ __forceinline__ int chunk_at(int lane, int chunk) {
  return 4 * lane + (chunk ^ ((lane >> 1) & 3));
}

// v = the lane's words of the warp's rows at p, of which `live` exist
__device__ __forceinline__ void load_words(uint32_t (&v)[kRollW],
                                           const uint32_t* p, int live,
                                           int lane, uint4* stage, bool vec) {
  if (!vec) {
    if (lane / kRowLanes < live) {
#pragma unroll
      for (int i = 0; i < kRollW; ++i) v[i] = p[lane * kRollW + i];
    }
    return;
  }
  const uint4* src = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int c = 0; c < kWarpRows; ++c) {
    if (c < live) {
      stage[chunk_at(c * 8 + lane / 4, lane & 3)] = src[c * 32 + lane];
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kRollW / 4; ++j) {
    const uint4 q = stage[chunk_at(lane, j)];
    v[4 * j] = q.x;
    v[4 * j + 1] = q.y;
    v[4 * j + 2] = q.z;
    v[4 * j + 3] = q.w;
  }
  __syncwarp();
}

__device__ __forceinline__ void store_words(const uint32_t (&v)[kRollW],
                                            uint32_t* p, int live, int lane,
                                            uint4* stage, bool vec) {
  if (!vec) {
    if (lane / kRowLanes < live) {
#pragma unroll
      for (int i = 0; i < kRollW; ++i) p[lane * kRollW + i] = v[i];
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kRollW / 4; ++j) {
    stage[chunk_at(lane, j)] =
        make_uint4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  }
  __syncwarp();
  uint4* dst = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int c = 0; c < kWarpRows; ++c) {
    if (c < live) {
      dst[c * 32 + lane] = stage[chunk_at(c * 8 + lane / 4, lane & 3)];
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
lane_roll_kernel(const uint32_t* __restrict__ x,
                 const uint32_t* __restrict__ mask, uint32_t* __restrict__ out,
                 int64_t rows, int nsel, int tail, bool vec) {
  const int lane = threadIdx.x & 31;
  const int t = lane % kRowLanes;  // the lane's place in its row
  const int first = lane - t;
  const int prev = first + (t + kRowLanes - 1) % kRowLanes;
  const int q = tail / kRollW;
  const int r = tail % kRollW;
  const int from_a = first + (t - q + kRowLanes) % kRowLanes;
  const int from_b = first + (t - q - 1 + 2 * kRowLanes) % kRowLanes;
  // one warp a group of kWarpRows rows, and no loop over groups: under a
  // loop whose trip count the compiler cannot see is the same for a whole
  // warp, every shuffle is compiled with a divergent fallback
  __shared__ uint4 stages[kThreads / 32][kWarpChunks];
  uint4* stage = stages[threadIdx.x >> 5];
  const int64_t g =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  // every lane shuffles; only the rows < rows are read and written (none
  // in the last block's warps past the last group)
  const int64_t left = rows - g * kWarpRows;
  const int live = static_cast<int>(
      left < 0 ? 0 : (left < kWarpRows ? left : kWarpRows));
  const int64_t base = g * kWarpRows * kRowWords;
  uint32_t v[kRollW] = {};
  load_words(v, x + base, live, lane, stage, vec);
  if (nsel > 0) {
    uint32_t m[kRollW] = {};
    if (mask != nullptr) {
      load_words(m, mask + base, live, lane, stage, vec);
#pragma unroll
      for (int i = 0; i < kRollW; ++i) m[i] = m[i] > (1u << 30) ? kFull : 0u;
    } else {
#pragma unroll
      for (int i = 0; i < kRollW; ++i) m[i] = v[i] > 7u ? kFull : 0u;
    }
    // the shifts repeat with period 7: 1, 2, ..., 7
#pragma unroll 1
    for (int p = nsel / 7; p > 0; --p) {
      select_roll<1>(v, m, prev);
      select_roll<2>(v, m, prev);
      select_roll<3>(v, m, prev);
      select_roll<4>(v, m, prev);
      select_roll<5>(v, m, prev);
      select_roll<6>(v, m, prev);
      select_roll<7>(v, m, prev);
    }
    const int rem = nsel % 7;
    if (rem > 0) select_roll<1>(v, m, prev);
    if (rem > 1) select_roll<2>(v, m, prev);
    if (rem > 2) select_roll<3>(v, m, prev);
    if (rem > 3) select_roll<4>(v, m, prev);
    if (rem > 4) select_roll<5>(v, m, prev);
    if (rem > 5) select_roll<6>(v, m, prev);
  }
  if (tail != 0) rotate_row<0>(v, r, from_a, from_b);
  store_words(v, out + base, live, lane, stage, vec);
}

// ---------------------------------------------------------------------------
// tile_gather: in-tile gathers of (rows, W) tiles of kTileRows rows
// ---------------------------------------------------------------------------

// The patterns (kernels/probes.py PATTERNS keeps the same numbers).  Indices
// are taken modulo the extent they index (W, kTileRows, or 128 pairs).
enum Pattern : int {
  kLanes = 0,        // out[r, l] = x[r, idx[r, l]]
  kSublanes = 1,     // out[r, l] = x[(r / T) T + idx[r, l], l]
  kTable = 2,        // out[r, l] = x[(r / T) T, idx[r, l]]
  kChained = 3,      // a = lanes(x, idx); out[r, l] = a[r, idx[r, l] ^ 63]
  kRowMove = 4,      // out[r] = x[r - 1] in a tile, row 0 of a tile zero
  kDeinterleave = 5, // (rows, 128) pairs -> planes: out[c][r, j] = x[r, 2j + c]
  kReinterleave = 6, // planes -> pairs: out[r, 2j + c] = x[c][r, j]
  kPairs = 7,        // out pair (r, j) = x pair (r, idx[r, j])
  kRoundtrip = 8,    // deinterleave then reinterleave: out = x (rows, 256)
};

template <int kPattern, int kW>
__global__ void __launch_bounds__(kThreads)
tile_gather_kernel(const uint32_t* __restrict__ x,
                   const int32_t* __restrict__ idx, uint32_t* __restrict__ out,
                   int64_t rows) {
  constexpr bool kPairwise =
      kPattern == kDeinterleave || kPattern == kReinterleave ||
      kPattern == kPairs || kPattern == kRoundtrip;
  // a quad is 4 output words, or 4 pairs for the pairwise patterns
  constexpr int kQuadsPerRow = (kPairwise ? 128 : kW) / 4;
  const int64_t quads = rows * kQuadsPerRow;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       q < quads; q += stride) {
    const int64_t r = q / kQuadsPerRow;
    const int l = static_cast<int>(q % kQuadsPerRow) * 4;
    if constexpr (kPattern == kDeinterleave) {
      const uint4* pair = reinterpret_cast<const uint4*>(x + r * 256 + 2 * l);
      const uint4 a = pair[0], b = pair[1];
      const int64_t plane = rows * 128;
      reinterpret_cast<uint4*>(out + r * 128 + l)[0] =
          make_uint4(a.x, a.z, b.x, b.z);
      reinterpret_cast<uint4*>(out + plane + r * 128 + l)[0] =
          make_uint4(a.y, a.w, b.y, b.w);
    } else if constexpr (kPattern == kRoundtrip) {
      // the quad's 4 pairs deinterleaved into lo / hi, then reinterleaved
      const uint4* pair = reinterpret_cast<const uint4*>(x + r * 256 + 2 * l);
      const uint4 a = pair[0], b = pair[1];
      const uint4 lo = make_uint4(a.x, a.z, b.x, b.z);
      const uint4 hi = make_uint4(a.y, a.w, b.y, b.w);
      uint4* dst = reinterpret_cast<uint4*>(out + r * 256 + 2 * l);
      dst[0] = make_uint4(lo.x, hi.x, lo.y, hi.y);
      dst[1] = make_uint4(lo.z, hi.z, lo.w, hi.w);
    } else if constexpr (kPattern == kReinterleave) {
      const int64_t plane = rows * 128;
      const uint4 lo = reinterpret_cast<const uint4*>(x + r * 128 + l)[0];
      const uint4 hi = reinterpret_cast<const uint4*>(x + plane + r * 128 + l)[0];
      uint4* dst = reinterpret_cast<uint4*>(out + r * 256 + 2 * l);
      dst[0] = make_uint4(lo.x, hi.x, lo.y, hi.y);
      dst[1] = make_uint4(lo.z, hi.z, lo.w, hi.w);
    } else if constexpr (kPattern == kPairs) {
      const int4 j = reinterpret_cast<const int4*>(idx + r * 128 + l)[0];
      const uint2* src = reinterpret_cast<const uint2*>(x + r * 256);
      const uint2 p0 = src[j.x & 127], p1 = src[j.y & 127];
      const uint2 p2 = src[j.z & 127], p3 = src[j.w & 127];
      uint4* dst = reinterpret_cast<uint4*>(out + r * 256 + 2 * l);
      dst[0] = make_uint4(p0.x, p0.y, p1.x, p1.y);
      dst[1] = make_uint4(p2.x, p2.y, p3.x, p3.y);
    } else if constexpr (kPattern == kRowMove) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r % kTileRows != 0) {
        v = reinterpret_cast<const uint4*>(x + (r - 1) * kW + l)[0];
      }
      reinterpret_cast<uint4*>(out + r * kW + l)[0] = v;
    } else {
      const int4 j4 = reinterpret_cast<const int4*>(idx + r * kW + l)[0];
      const int j[4] = {j4.x, j4.y, j4.z, j4.w};
      const uint32_t* row = x + r * kW;
      const int64_t tile = r - r % kTileRows;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kPattern == kLanes) {
          v[e] = row[j[e] & (kW - 1)];
        } else if constexpr (kPattern == kTable) {
          v[e] = x[tile * kW + (j[e] & (kW - 1))];
        } else {  // kChained
          const int m = (j[e] ^ 63) & (kW - 1);
          v[e] = row[idx[r * kW + m] & (kW - 1)];
        }
      }
      reinterpret_cast<uint4*>(out + r * kW + l)[0] =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// sublane_gather: out[r, l] = x[(r / T) T + idx[r, l], l], staged
// ---------------------------------------------------------------------------

constexpr int kSlabWords = 32;  // columns of a slab
constexpr int kSlabQuads = kSlabWords / 4;
constexpr int kSlabBytes = kTileRows * kSlabWords * 4;  // 64 KB

__device__ __forceinline__ void copy16_async(void* shared,
                                             const void* global) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(global)
               : "memory");
}

// Element s of the result is element (s + k) % 4 of v.
__device__ __forceinline__ uint4 rotate(uint4 v, int k) {
  if (k & 1) v = make_uint4(v.y, v.z, v.w, v.x);
  if (k & 2) v = make_uint4(v.z, v.w, v.x, v.y);
  return v;
}

// Block b takes column slab b % (W / 32) of tile b / (W / 32): its 512 rows
// x 32 words are copied into shared memory by 16-byte cp.async (8
// consecutive threads a 128-byte row segment), then the block writes
// out[r, c0 + l] = slab[idx[r, c0 + l] % 512][l] for the tile's rows.  A
// thread takes quad q = tid % 8 of the slab's columns in rows rho + 32 i
// (rho = tid / 8): it reads that quad of idx as an int4 and stores a
// uint4, so a warp reads and writes 4 rows x 128 contiguous bytes.  Column
// l of the slab is bank l; the 4 threads of a warp that share q (rho % 4 =
// 0..3) read the quad's elements in an order rotated by rho % 4, so at
// each of the 4 reads the warp's 32 threads read 32 distinct columns and
// banks, whatever rows idx picks.  The indices of the first 4 rows of a
// thread load while the slab lands, the next 4 while the first are
// gathered.
template <int kW>
__global__ void __launch_bounds__(kThreads, 3)
sublane_gather_kernel(const uint32_t* __restrict__ x,
                      const int32_t* __restrict__ idx,
                      uint32_t* __restrict__ out) {
  extern __shared__ uint4 slab4[];  // [kTileRows][kSlabQuads]
  constexpr int kSlabs = kW / kSlabWords;
  constexpr int kRowStep = kThreads / kSlabQuads;  // 32 rows a pass
  constexpr int kBatch = 4;                        // rows a thread a batch
  constexpr int kBatches = kTileRows / (kRowStep * kBatch);
  const int64_t tile = static_cast<int64_t>(blockIdx.x / kSlabs) * kTileRows;
  const int c0 = static_cast<int>(blockIdx.x % kSlabs) * kSlabWords;
  for (int v = threadIdx.x; v < kTileRows * kSlabQuads; v += kThreads) {
    copy16_async(&slab4[v], x + (tile + v / kSlabQuads) * kW + c0 +
                                (v % kSlabQuads) * 4);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");

  const int q = threadIdx.x % kSlabQuads;
  const int rho = threadIdx.x / kSlabQuads;
  const int rot = rho & 3;
  const int col = c0 + q * 4;
  const auto row_of = [&](int b, int i) {
    return tile + rho + (b * kBatch + i) * kRowStep;
  };
  uint4 j[kBatch];
  const auto load = [&](int b) {
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      j[i] = *reinterpret_cast<const uint4*>(idx + row_of(b, i) * kW + col);
    }
  };
  load(0);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  const uint32_t* slab = reinterpret_cast<const uint32_t*>(slab4) + q * 4;
#pragma unroll
  for (int b = 0; b < kBatches; ++b) {
    uint4 cur[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) cur[i] = j[i];
    if (b + 1 < kBatches) load(b + 1);
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const uint4 r = rotate(cur[i], rot);  // r.x is element rot
      uint4 v;
      v.x = slab[(r.x & (kTileRows - 1)) * kSlabWords + rot];
      v.y = slab[(r.y & (kTileRows - 1)) * kSlabWords + ((rot + 1) & 3)];
      v.z = slab[(r.z & (kTileRows - 1)) * kSlabWords + ((rot + 2) & 3)];
      v.w = slab[(r.w & (kTileRows - 1)) * kSlabWords + ((rot + 3) & 3)];
      *reinterpret_cast<uint4*>(out + row_of(b, i) * kW + col) =
          rotate(v, (4 - rot) & 3);
    }
  }
}

template <int kW>
cudaError_t launch_sublanes(const uint32_t* x, const int32_t* idx,
                            uint32_t* out, int64_t rows, cudaStream_t s) {
  // the attribute belongs to the current device: set it at every launch
  const cudaError_t err = cudaFuncSetAttribute(
      sublane_gather_kernel<kW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSlabBytes);
  if (err != cudaSuccess) return err;
  const int64_t blocks = rows / kTileRows * (kW / kSlabWords);
  sublane_gather_kernel<kW><<<static_cast<unsigned>(blocks), kThreads,
                              kSlabBytes, s>>>(x, idx, out);
  return cudaGetLastError();
}

unsigned grid_for(int64_t items, int64_t cap) {
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks);
}

template <int kW>
cudaError_t launch_gather(int pattern, const uint32_t* x, const int32_t* idx,
                          uint32_t* out, int64_t rows, unsigned blocks,
                          cudaStream_t s) {
  switch (pattern) {
    case kLanes:
      tile_gather_kernel<kLanes, kW><<<blocks, kThreads, 0, s>>>(x, idx, out, rows);
      break;
    case kSublanes:
      if (rows % kTileRows) return cudaErrorInvalidValue;
      return launch_sublanes<kW>(x, idx, out, rows, s);
    case kTable:
      tile_gather_kernel<kTable, kW><<<blocks, kThreads, 0, s>>>(x, idx, out, rows);
      break;
    case kChained:
      tile_gather_kernel<kChained, kW><<<blocks, kThreads, 0, s>>>(x, idx, out, rows);
      break;
    case kRowMove:
      tile_gather_kernel<kRowMove, kW><<<blocks, kThreads, 0, s>>>(x, idx, out, rows);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// in, out: (P, n) u32 planes, plane p at in + p * n; keep: (n,) u8 or null
// for a copy.
int arrowtpu_stream(const void* in, void* out, const void* keep, int64_t P,
                    int64_t n, void* stream) {
  if (P < 1 || P > 65535 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_for(n / 4 + 1, 2048), static_cast<unsigned>(P));
  const uint32_t* src = static_cast<const uint32_t*>(in);
  uint32_t* dst = static_cast<uint32_t*>(out);
  if (keep != nullptr) {
    stream_kernel<true><<<grid, kThreads, 0, s>>>(
        src, dst, static_cast<const uint8_t*>(keep), n);
  } else {
    stream_kernel<false><<<grid, kThreads, 0, s>>>(src, dst, nullptr, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, out: (rows, 128) u32; mask: the same shape, or null for m = x > 7.
int arrowtpu_lane_roll(const void* x, const void* mask, void* out,
                       int64_t rows, int k, int nsel, void* stream) {
  if (rows < 1 || k < 0 || nsel < 0 || nsel > k)
    return static_cast<int>(cudaErrorInvalidValue);
  int tail = 0;  // the unselected rolls' summed shift
  for (int j = nsel; j < k; ++j) tail = (tail + 1 + j % 7) % kRowWords;
  if (nsel == 0) mask = nullptr;  // m is not read
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(mask) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  lane_roll_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(mask),
      static_cast<uint32_t*>(out), rows, nsel, tail, vec);
  return static_cast<int>(cudaGetLastError());
}

// pattern: a Pattern; width: W (128 or 256) for the word patterns, 256 for
// the pairwise ones and the round trip.  x, idx, out: 16-byte aligned; rows
// a multiple of 512 for the sublane, table and row-move patterns.
int arrowtpu_tile_gather(int pattern, int width, const void* x,
                         const void* idx, void* out, int64_t rows,
                         void* stream) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* src = static_cast<const uint32_t*>(x);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  uint32_t* dst = static_cast<uint32_t*>(out);
  if (pattern == kDeinterleave || pattern == kReinterleave ||
      pattern == kPairs || pattern == kRoundtrip) {
    if (width != 256) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = grid_for(rows * 32, 8192);
    if (pattern == kDeinterleave) {
      tile_gather_kernel<kDeinterleave, 256><<<blocks, kThreads, 0, s>>>(
          src, ix, dst, rows);
    } else if (pattern == kReinterleave) {
      tile_gather_kernel<kReinterleave, 256><<<blocks, kThreads, 0, s>>>(
          src, ix, dst, rows);
    } else if (pattern == kRoundtrip) {
      tile_gather_kernel<kRoundtrip, 256><<<blocks, kThreads, 0, s>>>(
          src, ix, dst, rows);
    } else {
      tile_gather_kernel<kPairs, 256><<<blocks, kThreads, 0, s>>>(
          src, ix, dst, rows);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (width == 128) {
    return static_cast<int>(launch_gather<128>(
        pattern, src, ix, dst, rows, grid_for(rows * 32, 8192), s));
  }
  if (width == 256) {
    return static_cast<int>(launch_gather<256>(
        pattern, src, ix, dst, rows, grid_for(rows * 64, 8192), s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
