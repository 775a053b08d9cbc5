// Masked stream compaction on Hopper: (P, n) planes of one word size are
// compacted by one (n,) u8 keep mask.  Kept words come first, in row order;
// words at positions >= count are zero.
//
// Replaces two Pallas TPU kernels of the JAX package, both now
// tile_compact_kernel (tile_rank.cuh, which gives the design and the
// bound) but for K1's 16-byte words in the look-back frame, which run
// compact16_kernel (compact16.cuh, its own design and bound, and the
// readings that chose between the two for each frame):
//   * arrowtpu/pallas/compact3.py, _compact3_kernel (entry compact_planes):
//     the u32 plane compaction of the filter and of group extraction (K1),
//     here at uint32, uint64 and 16-byte (uint4) words, so 8-byte columns
//     move as whole words with no limb split, and a row of four int32
//     words (a Decimal128, an interval month_day_nano, a string view) as
//     one word with no transpose (the JAX package transposes such a value
//     into four u32 planes, arrowtpu/ops/filter.py:141-151);
//   * arrowtpu/pallas/compact.py, _compact_kernel (entries
//     compact_planes_info / compact_words / compact_bytes): the same
//     contract in u8 or u32 mode, plus the count (K2), here at uint8 (the
//     filter's bool and validity planes) and uint32 (K1's instantiation).
//     A tile of a byte plane is 4 KB, so a dense tile (a fifth of its rows
//     kept) copies four planes' tiles into one 16 KB buffer with one bulk
//     copy each; a sparser tile reads its kept bytes with plain loads.  A
//     block of bytes holds one buffer and 32 registers a thread, so 7
//     blocks fit an SM: the kernel is bound by each tile's chain of
//     dependent memory round trips (mask, kept bytes, stores) more than by
//     its bytes, and more blocks in flight hide it.
// Both take one of two frames for a tile's output offset:
//   - kFrameOffs when the caller passes `offs`, the exclusive prefix of the
//     tile counts (the filter's plan: tile_counts_kernel, then a
//     torch.cumsum of the counts, as the JAX package leaves tile_offsets to
//     XLA): a tile's zeros go to [count + db, count + db + D);
//   - kFrameLookback when it does not (group extraction; K2 without
//     `info`): one launch after a scratch memset, no count pass and no
//     cumsum; the offset comes from the decoupled look-back, a tile's zeros
//     go to [n - db - D, n - db), as in K3 (csrc/compact2.cu), and the last
//     tile writes the count to the device word `count` when one is given.
// Zeros past out_rows (the filter and group extraction cut the output near
// the count) are never written.
//
// The Stage parameter (tile_rank.cuh) serves the stage ablations: of the
// TPU probe scripts/prof_kernel.py (P8) at 4-byte words, and of K1's
// 16-byte word, compact16_kernel beside tile_compact_kernel<uint4>.  The
// entry points of K1 and K2 instantiate only kStageFull;
// arrowtpu_compact_tiles_stage runs the other stages in kFrameOffs.

#include <cstdint>
#include <cuda_runtime.h>

#include "compact16.cuh"
#include "tile_rank.cuh"

namespace {

using arrowtpu::kFull;
using arrowtpu::kMaxPlanes;
using arrowtpu::kThreads;
using arrowtpu::kTile;
using arrowtpu::kWarps;

__device__ __forceinline__ int nonzero_bytes(uint32_t w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;
  return __popc(w & 0x01010101u);
}

// One block per tile of kTile rows counts the kept rows (16-byte vector
// loads, popcount of the 0/1 bytes): the tile counts of the filter's plan.
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

// K1 and K2: in: host array of num_planes (1..16) device pointers to n
// words of 1, 4, 8 or 16 bytes each (16-byte words 16-byte aligned); out: the same to out_rows words each,
// count <= out_rows <= n (words from out_rows on, all zeros of the tail,
// are not written).  offs: the tile offsets (kFrameOffs), or null for the
// look-back frame, in which scratch (ceil(n / kTile) 8-byte status words)
// is zeroed here on the stream before the launch and `count` (one int64 of
// device memory, or null) receives the kept count.
int arrowtpu_compact_tiles(int word_bytes, const void* keep, int64_t n,
                           const void* offs, int num_planes,
                           const void* const* in, void* const* out,
                           int64_t out_rows, void* scratch, void* count,
                           void* stream) {
  using arrowtpu::kFrameLookback;
  using arrowtpu::kFrameOffs;
  using arrowtpu::kStageFull;
  using arrowtpu::launch_tile_compact;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (offs == nullptr && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (word_bytes * 2 + (offs == nullptr)) {
    case 2:
      return launch_tile_compact<uint8_t, kFrameOffs, kStageFull>(
          keep, n, offs, num_planes, in, out, out_rows, nullptr, nullptr, s);
    case 3:
      return launch_tile_compact<uint8_t, kFrameLookback, kStageFull>(
          keep, n, nullptr, num_planes, in, out, out_rows, scratch, count, s);
    case 8:
      return launch_tile_compact<uint32_t, kFrameOffs, kStageFull>(
          keep, n, offs, num_planes, in, out, out_rows, nullptr, nullptr, s);
    case 9:
      return launch_tile_compact<uint32_t, kFrameLookback, kStageFull>(
          keep, n, nullptr, num_planes, in, out, out_rows, scratch, count, s);
    case 16:
      return launch_tile_compact<uint64_t, kFrameOffs, kStageFull>(
          keep, n, offs, num_planes, in, out, out_rows, nullptr, nullptr, s);
    case 17:
      return launch_tile_compact<uint64_t, kFrameLookback, kStageFull>(
          keep, n, nullptr, num_planes, in, out, out_rows, scratch, count, s);
    case 32:  // the sparse gather's cp.async staging is faster here
      return launch_tile_compact<uint4, kFrameOffs, kStageFull>(
          keep, n, offs, num_planes, in, out, out_rows, nullptr, nullptr, s);
    case 33:
      return arrowtpu::launch_compact16<kFrameLookback, kStageFull>(
          keep, n, nullptr, num_planes, in, out, out_rows, scratch, count, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The stage ablation of K1 in kFrameOffs: as arrowtpu_compact_tiles (4-byte
// words with out_rows = n), for a Stage of tile_rank.cuh other than
// kLookback (K1's offsets there come from its count pass and cumsum,
// separate launches).
// word_bytes 4: tile_compact_kernel<uint32>, every stage; 16: body 0 is
// compact16_kernel, body 1 tile_compact_kernel<uint4>, kRank, kKept and
// kFull, whose kRank copies no plane.  aux: (ceil(n / kTile),) int64 for
// kRank.  offs is read by kKept and kFull only.
int arrowtpu_compact_tiles_stage(int stage, int word_bytes, int body,
                                 const void* keep, int64_t n,
                                 const void* offs, int num_planes,
                                 const void* const* in, void* const* out,
                                 int64_t out_rows, void* aux, void* stream) {
  using arrowtpu::kFrameOffs;
  using arrowtpu::kStageCopy;
  using arrowtpu::kStageFull;
  using arrowtpu::kStageKept;
  using arrowtpu::kStageRank;
  using arrowtpu::launch_compact16;
  using arrowtpu::launch_tile_compact;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (word_bytes == 4 && body == 0) {
    switch (stage) {
      case kStageCopy:
        return launch_tile_compact<uint32_t, kFrameOffs, kStageCopy>(
            keep, n, offs, num_planes, in, out, n, nullptr, aux, s);
      case kStageRank:
        return launch_tile_compact<uint32_t, kFrameOffs, kStageRank>(
            keep, n, offs, num_planes, in, out, n, nullptr, aux, s);
      case kStageKept:
        return launch_tile_compact<uint32_t, kFrameOffs, kStageKept>(
            keep, n, offs, num_planes, in, out, n, nullptr, aux, s);
      case kStageFull:
        return launch_tile_compact<uint32_t, kFrameOffs, kStageFull>(
            keep, n, offs, num_planes, in, out, n, nullptr, aux, s);
    }
  } else if (word_bytes == 16 && body == 0) {
    switch (stage) {
      case kStageRank:
        return launch_compact16<kFrameOffs, kStageRank>(
            keep, n, offs, num_planes, in, out, out_rows, nullptr, aux, s);
      case kStageKept:
        return launch_compact16<kFrameOffs, kStageKept>(
            keep, n, offs, num_planes, in, out, out_rows, nullptr, aux, s);
      case kStageFull:
        return launch_compact16<kFrameOffs, kStageFull>(
            keep, n, offs, num_planes, in, out, out_rows, nullptr, aux, s);
    }
  } else if (word_bytes == 16 && body == 1) {
    switch (stage) {
      case kStageRank:
        return launch_tile_compact<uint4, kFrameOffs, kStageRank>(
            keep, n, offs, num_planes, in, out, out_rows, nullptr, aux, s);
      case kStageKept:
        return launch_tile_compact<uint4, kFrameOffs, kStageKept>(
            keep, n, offs, num_planes, in, out, out_rows, nullptr, aux, s);
      case kStageFull:
        return launch_tile_compact<uint4, kFrameOffs, kStageFull>(
            keep, n, offs, num_planes, in, out, out_rows, nullptr, aux, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
