// What the compaction kernels share: the tile shape, the plane pointers
// passed by value, and the in-block ranking of a tile's kept rows.
//
// A block owns one tile of kTile = 4096 rows.  Row order inside a tile is
// (round, warp, lane): row = tile + r*256 + tid, so a warp touches 32
// consecutive rows of every plane in each round.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace arrowtpu {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;  // rows per block
constexpr int kMaxPlanes = 16;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRounds * kWarps == 4 * 32, "warp 0 scans 4 counts per lane");

// The stages of the compaction kernels' stage ablation (kernels/probes.py
// compaction_stages keeps the same numbers).  Each stage adds one piece of
// the production kernel to the one before it:
//   kStageCopy      the planes copied straight through (no mask);
//   kStageRank      + the mask staged, the ballots and the block scan; the tile's
//                   kept count written to aux[tile] keeps the work live;
//   kStageLookback  + the decoupled look-back (K3 only); the tile's exclusive
//                   prefix written to aux[tile];
//   kStageKept      + the kept rows' loads and scatter, no stores for dropped
//                   rows (words from the count on are not written);
//   kStageFull      the production kernel, the only stage the entry points of
//                   K1, K2 and K3 instantiate.
enum Stage : int {
  kStageCopy = 0,
  kStageRank = 1,
  kStageLookback = 2,
  kStageKept = 3,
  kStageFull = 4,
};

template <typename T>
struct PlanePtrs {
  const T* in[kMaxPlanes];
  T* out[kMaxPlanes];
};

// The block's shared memory for ranking one tile.
struct TileRanks {
  alignas(16) uint8_t keep[kTile];
  int counts[kRounds * kWarps];
  int prefix[kRounds * kWarps];  // exclusive kept offset of each (round, warp)
};

// Rank the kept rows of the tile starting at row `tile`: stage its keep
// bytes in shared memory (one 16-byte load a thread), take a ballot per
// (round, warp) into `ballots`, then warp 0 scans the 128 (round, warp)
// counts in row order into s.prefix.  A row's rank among the tile's kept
// rows is then prefix[r * kWarps + warp] + popc(ballots[r] & lanes below).
// Ends with a __syncthreads.  Returns the tile's kept count in warp 0 (0
// in the other warps).
__device__ __forceinline__ int rank_tile(const uint8_t* __restrict__ keep,
                                         int64_t n, int64_t tile,
                                         TileRanks& s,
                                         unsigned (&ballots)[kRounds]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  {
    const int64_t first = tile + static_cast<int64_t>(threadIdx.x) * 16;
    uint8_t* mine = s.keep + threadIdx.x * 16;
    if (first + 16 <= n && (reinterpret_cast<uintptr_t>(keep) & 15) == 0) {
      *reinterpret_cast<uint4*>(mine) =
          *reinterpret_cast<const uint4*>(keep + first);
    } else {
      for (int i = 0; i < 16; ++i) {
        mine[i] = first + i < n ? keep[first + i] : 0;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    ballots[r] = __ballot_sync(kFull, s.keep[r * kThreads + threadIdx.x]);
    if (lane == 0) s.counts[r * kWarps + warp] = __popc(ballots[r]);
  }
  __syncthreads();
  int total = 0;
  if (warp == 0) {
    int v[4];
    int own = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = s.counts[lane * 4 + i];
      own += v[i];
    }
    int incl = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    int run = incl - own;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s.prefix[lane * 4 + i] = run;
      run += v[i];
    }
    total = __shfl_sync(kFull, incl, 31);
  }
  __syncthreads();
  return total;
}

// The planes of the tile starting at row `tile` copied straight through
// (the stages before kStageKept): every load of a thread, then its stores,
// as the scatter does.
template <typename T>
__device__ __forceinline__ void copy_tile(int64_t n, int num_planes,
                                          const PlanePtrs<T>& planes,
                                          int64_t tile) {
  for (int p = 0; p < num_planes; ++p) {
    const T* __restrict__ src = planes.in[p] + tile + threadIdx.x;
    T* __restrict__ out = planes.out[p] + tile + threadIdx.x;
    T v[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      v[r] = tile + r * kThreads + threadIdx.x < n ? src[r * kThreads] : T(0);
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (tile + r * kThreads + threadIdx.x < n) out[r * kThreads] = v[r];
    }
  }
}

}  // namespace arrowtpu
