// K1 at 16-byte words on Hopper: compact16_kernel compacts (P, n) planes
// of 16-byte words (a row of a (n, 4) int32 tensor: a Decimal128, an
// interval month_day_nano, a string view) by one (n,) u8 keep mask.  Kept
// words first, in row order, then zeros up to out_rows.  K1 runs it in the
// look-back frame (group extraction: no tile offsets); in the offs frame
// (the filter's plan) K1's 16-byte words stay on tile_compact_kernel<uint4>
// (tile_rank.cuh), whose sparse gather is faster there (below), and this
// kernel's offs frame serves the stage ablation.  It shares the tile body's
// tile shape (one block a tile of kTile = 4096 rows), its two offset frames,
// its look-back and its zero fill.
//
// What holds a 16-byte compaction, read on an H100 80GB HBM3 at TPC-H
// Q6's call (7 planes x 60,006,528 rows, 1.9 % kept) by the stage ablation
// (kernels/probes.py compaction_stages, as chip_smoke.py phase 13 prints
// it, for this kernel and for the tile_compact_kernel<uint4> it replaced):
// the rank stage (the mask and the block scan) is about a tenth of the
// time, the kept stage (+ the gather of ~8M words, each alone in its
// 32-byte sector) the rest, and the kept stage at one plane takes about a
// third of it at seven.  The gather is held by the HBM's rate of random
// sector reads, not by a tile's chain of round trips: variants tried on
// the card while choosing this design (a resident grid walking the tiles
// with the next tile's mask prefetched in registers; more blocks an SM;
// L2-only, streaming and per-word bulk-copy loads; cp.async staging with
// more L1 left to it) moved the sparse gather by a few per cent at most,
// none below the tile body's cp.async staging, which needs the L1 that
// its 4 blocks an SM leave.  This kernel loads a sparse tile's kept words
// into registers and so needs no staging, which keeps 5 blocks an SM and
// makes the look-back frame's calls (group extraction, mostly the mask and
// the look-back's chain) faster; in the offs frame it is a few per cent
// slower at Q6's sparse call, so K1 does not run it there (PERF.md
// section 6).
//
// The design:
//   - rank: each thread owns 16 consecutive rows of the tile (one 16-byte
//     load of the mask); its kept rows are the nonzero bytes, a warp scan
//     (shuffles) and the warps' totals in shared memory give each thread
//     its first rank; one __syncthreads, no ballot a round;
//   - a sparse tile (under half its rows kept) lists its kept rows'
//     in-tile indices (u16) at their ranks; items (plane, kept row) are
//     flattened over the block, consecutive threads on consecutive kept
//     rows of one plane, kBatch16 items a thread loaded straight into
//     registers (ld.global.nc.v4) before their stores, so the stores are
//     coalesced;
//   - a dense tile shares each thread's bits and first rank in shared
//     memory and copies each plane's tile in chunks of kChunk16 rows (16
//     KB) by cp.async.bulk (the TMA unit) on an mbarrier, two buffers in
//     turn (they share their 32 KB with the sparse index list); the
//     threads store the chunk's kept rows at their ranks, coalesced;
//   - the tile's dropped rows' zeros as in tile_compact_kernel, written
//     while a dense tile's first copies land.
//
// Bound on an H100 SXM: data movement.  The least bytes are the mask, the
// kept words read once and out_rows words of every plane written once,
// over 3.35 TB/s (Q6's call: 0.0942 ms).  A kept word alone in its 32-byte
// sector costs the whole sector: at 1.9 % nearly every kept word does, so
// the sector floor (mask + 32 B a kept word read + 16 B written) is 0.132
// ms.  Each such sector is a random access to the HBM, and at Q6's call
// their rate, not the bytes, sets the kernel's pace.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_rank.cuh"

namespace arrowtpu {
namespace {

// kept words a thread holds in registers at once; rows of a dense tile's
// bulk copy (16 KB); blocks an SM
constexpr int kBatch16 = 4;
constexpr int kChunk16 = 1024;
constexpr int kMinBlocks16 = 4;

// The 16 keep bytes of this thread's rows [tile + 16 tid, + 16) of the
// tile at row `tile`: one 16-byte load when they are whole and aligned,
// else byte by byte (rows past n are not kept).
__device__ __forceinline__ uint4 mask16(const uint8_t* __restrict__ keep,
                                        int64_t n, int64_t tile) {
  const int64_t first = tile + static_cast<int64_t>(threadIdx.x) * 16;
  if (first + 16 <= n && (reinterpret_cast<uintptr_t>(keep) & 15) == 0) {
    return __ldcs(reinterpret_cast<const uint4*>(keep + first));
  }
  unsigned w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16; ++i) {
    if (first + i < n && keep[first + i]) w[i >> 2] |= 1u << ((i & 3) * 8);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Bit i set where byte i of the 16 is nonzero.
__device__ __forceinline__ unsigned kept_bits16(uint4 m) {
  const unsigned w[4] = {m.x, m.y, m.z, m.w};
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned x = w[q] | (w[q] >> 4);
    x |= x >> 2;
    x |= x >> 1;
    x &= 0x01010101u;
    bits |= ((x | (x >> 7) | (x >> 14) | (x >> 21)) & 0xFu) << (4 * q);
  }
  return bits;
}

// kFrame: a Frame of tile_rank.cuh.  kStage: kStageRank (the mask, the
// ranks and the block scan; the tile's kept count to aux[tile]),
// kStageKept (+ the kept words, no zero fill) or kStageFull (the
// production kernel).  Operands as tile_compact_kernel's.  Block t owns
// tile t.
template <int kFrame, int kStage>
__global__ void __launch_bounds__(kThreads, kMinBlocks16)
compact16_kernel(const uint8_t* __restrict__ keep, int64_t n,
                 const int64_t* __restrict__ offs, int num_planes,
                 const __grid_constant__ PlanePtrs<uint4> planes,
                 int64_t out_rows, Status* __restrict__ status,
                 int64_t* __restrict__ aux) {
  static_assert(kStage == kStageRank || kStage == kStageKept ||
                    kStage == kStageFull,
                "compact16_kernel has the rank, kept and full stages");
  constexpr bool kLookback = kFrame == kFrameLookback;
  __shared__ int totals[kWarps];
  // a sparse tile's index list, or a dense tile's two chunk buffers
  __shared__ union {
    uint16_t kept_rows[kTile];
    uint4 chunk[2][kChunk16];
  } stage;
  __shared__ uint16_t own_bits[kThreads];  // a dense tile's mask and ranks
  __shared__ int own_rank[kThreads];
  __shared__ int64_t shared_before;
  __shared__ Status bars[2];
  uint16_t* kept_rows = stage.kept_rows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = blockIdx.x;
  const int64_t tile = t * kTile;
  const int rows = n - tile < kTile ? static_cast<int>(n - tile) : kTile;
  // the tile's offset and the count, loaded while the tile is ranked
  const int64_t off_t = kLookback || kStage == kStageRank ? 0 : offs[t];
  const int64_t count =
      kLookback || kStage != kStageFull ? 0 : offs[gridDim.x];

  if (kStage != kStageRank && threadIdx.x == 0) {
    barrier_init(&bars[0]);
    barrier_init(&bars[1]);
  }

  // 1. rank: the thread's kept rows, a warp scan, the warps' totals
  unsigned bits = kept_bits16(mask16(keep, n, tile));
  const int own = __popc(bits);
  int incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) totals[warp] = incl;
  __syncthreads();
  int kept = 0, rank = incl - own;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = totals[w];
    kept += v;
    if (w < warp) rank += v;
  }
  if constexpr (kStage == kStageRank) {
    if (threadIdx.x == 0) aux[t] = kept;
    return;
  }
  if constexpr (kLookback) {
    if (threadIdx.x == 0) publish_aggregate(status, t, kept);
  }

  // 2. a dense tile (half its rows kept or more) shares each thread's
  //    bits and first rank; a sparse one lists its kept rows' in-tile
  //    indices at their ranks
  const bool dense = kept * 2 >= rows;
  // a dense tile's unit u = (plane u / chunks, chunk u % chunks): one bulk
  // copy of the chunk's rows into buffer u % 2, the first two issued now
  const int chunks = (rows + kChunk16 - 1) / kChunk16;
  const int units = num_planes * chunks;
  const auto issue = [&](int u) {
    if (threadIdx.x == 0 && u < units) {
      const int c = u % chunks;
      const int r = rows - c * kChunk16 < kChunk16 ? rows - c * kChunk16
                                                   : kChunk16;
      expect_bytes(&bars[u & 1], r * 16u);
      bulk_copy(stage.chunk[u & 1], planes.in[u / chunks] + tile +
                                        c * kChunk16,
                r * 16u, &bars[u & 1]);
    }
  };
  if (dense) {
    issue(0);
    issue(1);
    own_bits[threadIdx.x] = static_cast<uint16_t>(bits);
    own_rank[threadIdx.x] = rank;
  } else {
    while (bits) {
      kept_rows[rank++] =
          static_cast<uint16_t>(threadIdx.x * 16 + __ffs(bits) - 1);
      bits &= bits - 1;
    }
  }
  if constexpr (kLookback) {
    if (warp == 0) {
      const int64_t e = look_back(status, t, kept, lane);
      if (lane == 0) shared_before = e;
    }
  }
  __syncthreads();
  int64_t before;
  if constexpr (kLookback) {
    before = shared_before;
    if constexpr (kStage == kStageFull) {
      if (aux != nullptr && threadIdx.x == 0 && t + 1 == gridDim.x) {
        *aux = before + kept;
      }
    }
  } else {
    before = off_t;
  }

  // 3. the tile's dropped rows' zeros (the frames' ranges, as in
  //    tile_compact_kernel), while a dense tile's first copies land
  if constexpr (kStage == kStageFull) {
    const int64_t dropped = rows - kept;
    const int64_t dropped_before = tile - before;
    int64_t lo, hi;
    if constexpr (kLookback) {
      hi = n - dropped_before;
      lo = hi - dropped;
    } else {
      lo = count + dropped_before;
      hi = lo + dropped;
    }
    if (hi > out_rows) hi = out_rows;
    if (lo < hi) zero_fill(planes, num_planes, lo, hi);
  }

  if (dense) {
    // 4, dense: each unit once its copy has landed: its chunk's rows r =
    //    c * kChunk16 + q * kThreads + tid, the kept ones stored at their
    //    ranks (coalesced), then its buffer refilled with unit u + 2
    for (int u = 0; u < units; ++u) {
      const int c = u % chunks;
      uint4* __restrict__ dst = planes.out[u / chunks] + before;
      barrier_wait(&bars[u & 1], (u >> 1) & 1);
#pragma unroll
      for (int q = 0; q < kChunk16 / kThreads; ++q) {
        const int i = q * kThreads + threadIdx.x;
        const int row = c * kChunk16 + i;
        const unsigned b = own_bits[row >> 4];
        if (row < rows && ((b >> (row & 15)) & 1u)) {
          const int at =
              own_rank[row >> 4] + __popc(b & ((1u << (row & 15)) - 1u));
          if (before + at < out_rows) dst[at] = stage.chunk[u & 1][i];
        }
      }
      if (u + 2 < units) {
        __syncthreads();
        issue(u + 2);
      }
    }
  } else if (kept > 0) {
    // 4, sparse: item i = (plane i / kept, kept row i % kept); a thread
    //    takes items threadIdx.x + j * kThreads, stepped without a
    //    division, kBatch16 loads before their stores
    int lp = static_cast<int>(threadIdx.x) / kept;
    int lk = static_cast<int>(threadIdx.x) % kept;
    const int dp = kThreads / kept, dk = kThreads % kept;
    int sp = lp, sk = lk;
    while (lp < num_planes) {
      uint4 v[kBatch16];
#pragma unroll
      for (int j = 0; j < kBatch16; ++j) {
        if (lp < num_planes) {
          v[j] = __ldg(planes.in[lp] + tile + kept_rows[lk]);
          lk += dk;
          lp += dp;
          if (lk >= kept) {
            lk -= kept;
            ++lp;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch16; ++j) {
        if (sp < num_planes) {
          const int64_t at = before + sk;
          if (at < out_rows) planes.out[sp][at] = v[j];
          sk += dk;
          sp += dp;
          if (sk >= kept) {
            sk -= kept;
            ++sp;
          }
        }
      }
    }
  }
}

// One launch of compact16_kernel over ceil(n / kTile) tiles; for
// kFrameLookback the scratch (one 8-byte status word a tile) is zeroed on
// the stream first.
template <int kFrame, int kStage>
int launch_compact16(const void* keep, int64_t n, const void* offs,
                     int num_planes, const void* const* in, void* const* out,
                     int64_t out_rows, void* scratch, void* aux,
                     cudaStream_t stream) {
  if (n <= 0 || num_planes < 1 || num_planes > kMaxPlanes || out_rows < 0 ||
      out_rows > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (kFrame == kFrameLookback) {
    const cudaError_t e =
        cudaMemsetAsync(scratch, 0, tiles * sizeof(Status), stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  PlanePtrs<uint4> planes{};
  for (int p = 0; p < num_planes; ++p) {
    planes.in[p] = static_cast<const uint4*>(in[p]);
    planes.out[p] = static_cast<uint4*>(out[p]);
  }
  compact16_kernel<kFrame, kStage>
      <<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
          static_cast<const uint8_t*>(keep), n,
          static_cast<const int64_t*>(offs), num_planes, planes, out_rows,
          static_cast<Status*>(scratch), static_cast<int64_t*>(aux));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace arrowtpu
