// Single-pass masked stream compaction of u32 planes on Hopper: (P, n)
// planes compacted by one (n,) u8 keep mask; kept words first, in row
// order, then zeros.  No count pass, no prefix sum, and no count returned.
//
// Replaces the Pallas TPU kernel arrowtpu/pallas/compact2.py,
// _compact2_kernel (entry compact_planes), whose running output offset is
// carried in SMEM across a sequential grid.  Blocks on the H100 run in no
// order, so the offset is carried by a decoupled look-back instead:
//   1. each block takes the next tile id from a global counter (not
//      blockIdx.x): a block then only ever waits on tiles whose blocks are
//      already running, so the wait cannot deadlock;
//   2. it ranks its tile's kept rows with warp ballots (tile_rank.cuh);
//   3. warp 0 publishes the tile's kept count (flag AGGREGATE), then looks
//      back over its predecessors' status words, 32 at a time, summing
//      their counts until it meets an INCLUSIVE prefix, and publishes its
//      own inclusive prefix.  A status word is 64 bits, flag and value in
//      one word, written with st.release.gpu and read with ld.acquire.gpu;
//      the status array and the tile counter are zeroed on the stream
//      before every launch;
//   4. it scatters as the two-pass kernel (compact.cu) does: a kept row
//      writes its value at its global rank, and a dropped row with global
//      dropped rank d writes the zero at n - 1 - d, so every output word is
//      written exactly once and the zero tail needs no count.
// Bound on an H100 SXM: pure data movement, n mask bytes + 4*P*count kept
// words read + 4*P*n words written, over 3.35 TB/s of HBM3.  The status
// traffic is 8 bytes a tile.  None of the TPU machinery carries over: no
// MXU one-hot scatter, no roll rounds, no DMA windows.
//
// The kernel is templated on a Stage (tile_rank.cuh) for the stage
// ablation of the TPU probes (scripts/prof_v3.py:65-78, the Pallas K3's
// `stages` bitmask): arrowtpu_compact2 instantiates only kStageFull;
// arrowtpu_compact2_stage runs the others.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_rank.cuh"

namespace {

using arrowtpu::kFull;
using arrowtpu::kMaxPlanes;
using arrowtpu::kRounds;
using arrowtpu::kThreads;
using arrowtpu::kTile;
using arrowtpu::kWarps;
using arrowtpu::PlanePtrs;

using Status = unsigned long long;
constexpr int kFlagShift = 62;
constexpr Status kAggregate = 1ull << kFlagShift;  // the tile's own count
constexpr Status kInclusive = 2ull << kFlagShift;  // count through the tile
constexpr Status kValue = kAggregate - 1;

__device__ __forceinline__ void store_release(Status* p, Status v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ Status load_acquire(const Status* p) {
  Status v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Warp 0 of tile t: publish, look back, publish; -> the kept rows before
// the tile (in every lane).
__device__ __forceinline__ int64_t look_back(Status* status, int64_t t,
                                             int aggregate, int lane) {
  if (t == 0) {
    if (lane == 0) store_release(status, kInclusive | aggregate);
    return 0;
  }
  if (lane == 0) store_release(status + t, kAggregate | aggregate);
  int64_t exclusive = 0;
  for (int64_t base = t - 1;; base -= 32) {
    const int64_t p = base - lane;  // lane 0 reads the nearest predecessor
    Status s = kInclusive;          // before tile 0: an inclusive prefix 0
    if (p >= 0) {
      do {
        s = load_acquire(status + p);
      } while ((s >> kFlagShift) == 0);
    }
    const unsigned inclusive =
        __ballot_sync(kFull, (s & ~kValue) == kInclusive);
    // lanes up to the nearest inclusive prefix count (all 32 if none)
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    Status v = lane <= stop ? (s & kValue) : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    exclusive += static_cast<int64_t>(v);
    if (inclusive) break;
  }
  if (lane == 0) {
    store_release(status + t,
                  kInclusive | static_cast<Status>(exclusive + aggregate));
  }
  return exclusive;
}

// kStage: a Stage of tile_rank.cuh; aux: one int64 a tile for kRank (the
// tile's count) and kLookback (its exclusive prefix), else unused.
template <int kStage>
__global__ void __launch_bounds__(kThreads, 3)
compact2_kernel(const uint8_t* __restrict__ keep, int64_t n, int num_planes,
                const __grid_constant__ PlanePtrs<uint32_t> planes,
                Status* __restrict__ status,
                unsigned* __restrict__ next_tile, int64_t* __restrict__ aux) {
  __shared__ arrowtpu::TileRanks ranks;
  __shared__ int64_t tile_id;
  __shared__ int64_t kept_before;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if constexpr (kStage < arrowtpu::kStageLookback) {
    const int64_t tile = static_cast<int64_t>(blockIdx.x) * kTile;
    if constexpr (kStage == arrowtpu::kStageRank) {
      unsigned ballots[kRounds];
      const int aggregate = arrowtpu::rank_tile(keep, n, tile, ranks, ballots);
      if (threadIdx.x == 0) aux[blockIdx.x] = aggregate;
    }
    arrowtpu::copy_tile(n, num_planes, planes, tile);
    return;
  }

  if (threadIdx.x == 0) tile_id = atomicAdd(next_tile, 1u);
  __syncthreads();
  const int64_t t = tile_id;
  const int64_t tile = t * kTile;

  unsigned ballots[kRounds];
  const int aggregate = arrowtpu::rank_tile(keep, n, tile, ranks, ballots);
  if (warp == 0) {
    const int64_t e = look_back(status, t, aggregate, lane);
    if (lane == 0) kept_before = e;
  }
  __syncthreads();
  if constexpr (kStage == arrowtpu::kStageLookback) {
    if (threadIdx.x == 0) aux[t] = kept_before;
    arrowtpu::copy_tile(n, num_planes, planes, tile);
    return;
  }

  // a kept row goes to kept_before + its rank in the tile; a dropped row's
  // zero to n - 1 - (its global dropped rank) = drop_top - its dropped
  // rank in the tile.  loc: that rank, -1 past n.
  const int64_t kept_base = kept_before;
  const int64_t drop_top = n - 1 - (tile - kept_base);
  const unsigned lane_lt = (1u << lane) - 1u;
  int loc[kRounds];
  unsigned kept_bits = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int in_tile = r * kThreads + threadIdx.x;
    const int rank =
        ranks.prefix[r * kWarps + warp] + __popc(ballots[r] & lane_lt);
    const bool kept = (ballots[r] >> lane) & 1u;
    loc[r] = tile + in_tile < n ? (kept ? rank : in_tile - rank) : -1;
    kept_bits |= static_cast<unsigned>(kept) << r;
  }

  for (int p = 0; p < num_planes; ++p) {
    const uint32_t* __restrict__ src = planes.in[p] + tile + threadIdx.x;
    uint32_t* __restrict__ out = planes.out[p];
    uint32_t v[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      v[r] = ((kept_bits >> r) & 1u) && loc[r] >= 0 ? src[r * kThreads] : 0u;
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      // kKept: the dropped rows' zeros are not stored
      if (loc[r] >= 0 &&
          (kStage == arrowtpu::kStageFull || ((kept_bits >> r) & 1u))) {
        out[(kept_bits >> r) & 1u ? kept_base + loc[r] : drop_top - loc[r]] =
            v[r];
      }
    }
  }
}

template <int kStage>
int launch_compact2(const void* keep, int64_t n, int num_planes,
                    const void* const* in, void* const* out, void* scratch,
                    void* aux, void* stream) {
  if (n <= 0 || num_planes < 1 || num_planes > kMaxPlanes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (kStage >= arrowtpu::kStageLookback) {
    cudaError_t err =
        cudaMemsetAsync(scratch, 0, (tiles + 1) * sizeof(Status), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  PlanePtrs<uint32_t> planes{};
  for (int p = 0; p < num_planes; ++p) {
    planes.in[p] = static_cast<const uint32_t*>(in[p]);
    planes.out[p] = static_cast<uint32_t*>(out[p]);
  }
  Status* status = static_cast<Status*>(scratch);
  compact2_kernel<kStage><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(keep), n, num_planes, planes, status,
      reinterpret_cast<unsigned*>(status + tiles),
      static_cast<int64_t*>(aux));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// in / out: host arrays of num_planes (1..16) device pointers to n u32
// words each; scratch: (ceil(n / kTile) + 1) 8-byte words of device
// memory, zeroed here on the stream before the launch (the tiles' status
// words, then the tile counter).
int arrowtpu_compact2(const void* keep, int64_t n, int num_planes,
                      const void* const* in, void* const* out, void* scratch,
                      void* stream) {
  return launch_compact2<arrowtpu::kStageFull>(keep, n, num_planes, in, out,
                                          scratch, nullptr, stream);
}

// The stage ablation: as arrowtpu_compact2, for a Stage of tile_rank.cuh;
// aux: (ceil(n / kTile),) int64 for kRank and kLookback.
int arrowtpu_compact2_stage(int stage, const void* keep, int64_t n,
                            int num_planes, const void* const* in,
                            void* const* out, void* scratch, void* aux,
                            void* stream) {
  switch (stage) {
    case arrowtpu::kStageCopy:
      return launch_compact2<arrowtpu::kStageCopy>(keep, n, num_planes, in, out,
                                              scratch, aux, stream);
    case arrowtpu::kStageRank:
      return launch_compact2<arrowtpu::kStageRank>(keep, n, num_planes, in, out,
                                              scratch, aux, stream);
    case arrowtpu::kStageLookback:
      return launch_compact2<arrowtpu::kStageLookback>(keep, n, num_planes, in,
                                                  out, scratch, aux, stream);
    case arrowtpu::kStageKept:
      return launch_compact2<arrowtpu::kStageKept>(keep, n, num_planes, in, out,
                                              scratch, aux, stream);
    case arrowtpu::kStageFull:
      return launch_compact2<arrowtpu::kStageFull>(keep, n, num_planes, in, out,
                                              scratch, aux, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
