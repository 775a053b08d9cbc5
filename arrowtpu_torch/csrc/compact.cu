// Masked stream compaction on Hopper: (P, n) planes of one word size are
// compacted by one (n,) u8 keep mask.  Kept words come first, in row order;
// words at positions >= count are zero.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * arrowtpu/pallas/compact3.py, _compact3_kernel (entry compact_planes):
//     the u32 plane compaction of the filter and of group extraction (K1).
//     Here it is tile_compact_kernel (tile_rank.cuh, which gives the design
//     and the bound) at uint32 and uint64 words, so 8-byte columns move as
//     whole words with no limb split, in one of two frames:
//       - kFrameOffs when the caller passes `offs`, the exclusive prefix of
//         the tile counts (the filter's plan, which K2 shares): a tile's
//         zeros go to [count + db, count + db + D);
//       - kFrameLookback when it does not (group extraction): one launch
//         after a scratch memset, no count pass and no cumsum; the offset
//         comes from the decoupled look-back and a tile's zeros go to
//         [n - db - D, n - db), as in K3 (csrc/compact2.cu).
//     Zeros past out_rows (the filter and group extraction cut the output
//     near the count) are never written.
//   * arrowtpu/pallas/compact.py, _compact_kernel (entries
//     compact_planes_info / compact_words / compact_bytes): the same contract
//     in u32 or u8 mode (K2), plus the count.  K2 is tile_counts_kernel, a
//     torch.cumsum of the counts, then compact_scatter_kernel at uint8 (the
//     bool and validity planes) and uint32 words:
//       1. tile_counts_kernel: one block per tile of kTile rows counts the
//          kept rows (16-byte vector loads, popcount of the 0/1 bytes);
//       2. the caller takes the exclusive prefix over the tile counts (a
//          torch.cumsum, as the JAX package leaves tile_offsets to XLA);
//       3. compact_scatter_kernel ranks its tile's rows (tile_rank.cuh), then
//          every row writes each plane at most once: a kept row its value at
//          its rank, a dropped row a zero at count + (its rank among dropped
//          rows), a thread's 16 loads of a plane in flight before it stores.
//     Bound: n + P*w*count + P*w*out_rows bytes over 3.35 TB/s (the mask
//     read twice by the design).  Its redesign on K1's tile body is next.
//
// The Stage parameter (tile_rank.cuh) serves the stage ablation of the TPU
// probe scripts/prof_kernel.py (P8): the entry points of K1 and K2
// instantiate only kStageFull; arrowtpu_compact_tiles_stage runs K1's other
// stages at 4-byte words in kFrameOffs.

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

__device__ __forceinline__ int nonzero_bytes(uint32_t w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;
  return __popc(w & 0x01010101u);
}

__global__ void __launch_bounds__(kThreads)
tile_counts_kernel(const uint8_t* __restrict__ keep, int64_t n,
                   int64_t* __restrict__ counts) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTile +
                        static_cast<int64_t>(threadIdx.x) * 16;
  int c = 0;
  if (first + 16 <= n && (reinterpret_cast<uintptr_t>(keep) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(keep + first);
    c = nonzero_bytes(v.x) + nonzero_bytes(v.y) + nonzero_bytes(v.z) +
        nonzero_bytes(v.w);
  } else {
    for (int i = 0; i < 16; ++i) {
      if (first + i < n) c += keep[first + i] != 0;
    }
  }
  c = __reduce_add_sync(kFull, c);
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += warp_sums[w];
    counts[blockIdx.x] = t;
  }
}

// kStage: a Stage of tile_rank.cuh other than kLookback (for K1 that is the
// count pass and the cumsum, separate launches); aux: one int64 a tile for
// kRank, else unused.  kCopy and kRank write all n rows and read no offs.
template <typename T, int kStage>
__global__ void __launch_bounds__(kThreads, 3)
compact_scatter_kernel(const uint8_t* __restrict__ keep, int64_t n,
                       const int64_t* __restrict__ offs, int num_planes,
                       const __grid_constant__ PlanePtrs<T> planes,
                       int64_t out_rows, int64_t* __restrict__ aux) {
  __shared__ arrowtpu::TileRanks ranks;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kTile;

  if constexpr (kStage < arrowtpu::kStageKept) {
    if constexpr (kStage == arrowtpu::kStageRank) {
      unsigned ballots[kRounds];
      const int aggregate = arrowtpu::rank_tile(keep, n, tile, ranks, ballots);
      if (threadIdx.x == 0) aux[blockIdx.x] = aggregate;
    }
    arrowtpu::copy_tile(n, num_planes, planes, tile);
    return;
  }

  // 1-2. the tile's kept rows ranked (tile_rank.cuh)
  unsigned ballots[kRounds];
  arrowtpu::rank_tile(keep, n, tile, ranks, ballots);
  const int* prefix = ranks.prefix;

  // 3. each row's destination: a kept row goes to its rank, a dropped row
  //    writes a zero at count + its rank among dropped rows.  loc is the
  //    offset from the tile's first kept / dropped slot, -1 for no write
  //    (past n, or a zero past out_rows).
  const int64_t kept_base = offs[blockIdx.x];
  const int64_t drop_base = offs[gridDim.x] + tile - kept_base;
  const unsigned lane_lt = (1u << lane) - 1u;
  int loc[kRounds];
  unsigned kept_bits = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int in_tile = r * kThreads + threadIdx.x;
    const int rank = prefix[r * kWarps + warp] + __popc(ballots[r] & lane_lt);
    const bool kept = (ballots[r] >> lane) & 1u;
    const int64_t dst = kept ? kept_base + rank : drop_base + in_tile - rank;
    loc[r] = (tile + in_tile < n && dst < out_rows)
                 ? (kept ? rank : in_tile - rank)
                 : -1;
    kept_bits |= static_cast<unsigned>(kept) << r;
  }

  // 4. every plane: all of a thread's loads in flight, then its stores
  for (int p = 0; p < num_planes; ++p) {
    const T* __restrict__ src = planes.in[p] + tile + threadIdx.x;
    T* __restrict__ out = planes.out[p];
    T v[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      v[r] = ((kept_bits >> r) & 1u) && loc[r] >= 0 ? src[r * kThreads] : T(0);
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      // kKept: the dropped rows' zeros are not stored
      if (loc[r] >= 0 &&
          (kStage == arrowtpu::kStageFull || ((kept_bits >> r) & 1u))) {
        out[((kept_bits >> r) & 1u ? kept_base : drop_base) + loc[r]] = v[r];
      }
    }
  }
}

template <typename T, int kStage = arrowtpu::kStageFull>
int launch_scatter(const void* keep, int64_t n, const void* offs,
                   int num_planes, const void* const* in, void* const* out,
                   int64_t out_rows, cudaStream_t stream,
                   void* aux = nullptr) {
  PlanePtrs<T> planes{};
  for (int p = 0; p < num_planes; ++p) {
    planes.in[p] = static_cast<const T*>(in[p]);
    planes.out[p] = static_cast<T*>(out[p]);
  }
  const int64_t blocks = (n + kTile - 1) / kTile;
  compact_scatter_kernel<T, kStage><<<static_cast<unsigned>(blocks), kThreads,
                                      0, stream>>>(
      static_cast<const uint8_t*>(keep), n, static_cast<const int64_t*>(offs),
      num_planes, planes, out_rows, static_cast<int64_t*>(aux));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int arrowtpu_compact_tile_rows() { return kTile; }

int arrowtpu_compact_max_planes() { return kMaxPlanes; }

const char* arrowtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// counts: (ceil(n / kTile),) int64, one kept count per tile.
int arrowtpu_tile_counts(const void* keep, int64_t n, void* counts,
                         void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kTile - 1) / kTile;
  tile_counts_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(keep), n, static_cast<int64_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// offs: (ceil(n / kTile) + 1,) int64 exclusive prefix of the tile counts;
// in: host array of num_planes device pointers to n words each; out: the
// same to out_rows words each, count <= out_rows <= n (words from out_rows
// on, all zeros of the tail, are not written).
int arrowtpu_compact_scatter(int word_bytes, const void* keep, int64_t n,
                             const void* offs, int num_planes,
                             const void* const* in, void* const* out,
                             int64_t out_rows, void* stream) {
  if (n <= 0 || num_planes < 1 || num_planes > kMaxPlanes || out_rows < 0 ||
      out_rows > n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes) {
    case 1:
      return launch_scatter<uint8_t>(keep, n, offs, num_planes, in, out,
                                      out_rows, s);
    case 4:
      return launch_scatter<uint32_t>(keep, n, offs, num_planes, in, out,
                                      out_rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K1: in / out as for arrowtpu_compact_scatter, words of 4 or 8 bytes.
// offs: the tile offsets (kFrameOffs), or null for the look-back frame, in
// which scratch (ceil(n / kTile) 8-byte status words) is zeroed here on the
// stream before the launch.
int arrowtpu_compact_tiles(int word_bytes, const void* keep, int64_t n,
                           const void* offs, int num_planes,
                           const void* const* in, void* const* out,
                           int64_t out_rows, void* scratch, void* stream) {
  using arrowtpu::kFrameLookback;
  using arrowtpu::kFrameOffs;
  using arrowtpu::kStageFull;
  using arrowtpu::launch_tile_compact;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (offs == nullptr && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (word_bytes * 2 + (offs == nullptr)) {
    case 8:
      return launch_tile_compact<uint32_t, kFrameOffs, kStageFull>(
          keep, n, offs, num_planes, in, out, out_rows, nullptr, nullptr, s);
    case 9:
      return launch_tile_compact<uint32_t, kFrameLookback, kStageFull>(
          keep, n, nullptr, num_planes, in, out, out_rows, scratch, nullptr,
          s);
    case 16:
      return launch_tile_compact<uint64_t, kFrameOffs, kStageFull>(
          keep, n, offs, num_planes, in, out, out_rows, nullptr, nullptr, s);
    case 17:
      return launch_tile_compact<uint64_t, kFrameLookback, kStageFull>(
          keep, n, nullptr, num_planes, in, out, out_rows, scratch, nullptr,
          s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The stage ablation of K1 at 4-byte words in kFrameOffs: as
// arrowtpu_compact_tiles with out_rows = n, for a Stage of tile_rank.cuh
// other than kLookback (K1's offsets there come from its count pass and
// cumsum, separate launches); aux: (ceil(n / kTile),) int64 for kRank.
// offs is read by kKept and kFull only.
int arrowtpu_compact_tiles_stage(int stage, const void* keep, int64_t n,
                                 const void* offs, int num_planes,
                                 const void* const* in, void* const* out,
                                 void* aux, void* stream) {
  using arrowtpu::kFrameOffs;
  using arrowtpu::launch_tile_compact;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case arrowtpu::kStageCopy:
      return launch_tile_compact<uint32_t, kFrameOffs, arrowtpu::kStageCopy>(
          keep, n, offs, num_planes, in, out, n, nullptr, aux, s);
    case arrowtpu::kStageRank:
      return launch_tile_compact<uint32_t, kFrameOffs, arrowtpu::kStageRank>(
          keep, n, offs, num_planes, in, out, n, nullptr, aux, s);
    case arrowtpu::kStageKept:
      return launch_tile_compact<uint32_t, kFrameOffs, arrowtpu::kStageKept>(
          keep, n, offs, num_planes, in, out, n, nullptr, aux, s);
    case arrowtpu::kStageFull:
      return launch_tile_compact<uint32_t, kFrameOffs, arrowtpu::kStageFull>(
          keep, n, offs, num_planes, in, out, n, nullptr, aux, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
