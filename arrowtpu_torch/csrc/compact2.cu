// K3: single-pass masked stream compaction of u32 planes on Hopper: (P, n)
// planes compacted by one (n,) u8 keep mask; kept words first, in row
// order, then zeros.  No count pass, no prefix sum, and no count returned.
//
// Replaces the Pallas TPU kernel arrowtpu/pallas/compact2.py,
// _compact2_kernel (entry compact_planes), whose running output offset is
// carried in SMEM across a sequential grid.  Blocks on the H100 run in no
// order, so the offset is carried by a decoupled look-back instead.
//
// The kernel is tile_compact_kernel<uint32_t, kFrameLookback, stage>
// (tile_rank.cuh, which gives the design and the bound): each tile ranks
// its rows, lists its kept rows, issues its first gather loads, looks back
// for its offset, writes its dropped rows' zeros as one contiguous range
// [n - db - D, n - db) of every plane (db dropped rows before the tile, D
// in it), then stores its kept words at their global ranks.  Every output
// word is written exactly once and the zero tail needs no count.  The
// status words are zeroed on the stream before every launch.
//
// The Stage parameter serves the stage ablation of the TPU probes
// (scripts/prof_v3.py:65-78, the Pallas K3's `stages` bitmask):
// arrowtpu_compact2 instantiates only kStageFull; arrowtpu_compact2_stage
// runs the others.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_rank.cuh"

namespace {

template <int kStage>
int launch_compact2(const void* keep, int64_t n, int num_planes,
                    const void* const* in, void* const* out, void* scratch,
                    void* aux, void* stream) {
  return arrowtpu::launch_tile_compact<uint32_t, arrowtpu::kFrameLookback,
                                       kStage>(
      keep, n, nullptr, num_planes, in, out, n, scratch, aux,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// in / out: host arrays of num_planes (1..16) device pointers to n u32
// words each; scratch: ceil(n / kTile) 8-byte words of device memory, the
// tiles' status words, zeroed here on the stream before the launch.
int arrowtpu_compact2(const void* keep, int64_t n, int num_planes,
                      const void* const* in, void* const* out, void* scratch,
                      void* stream) {
  return launch_compact2<arrowtpu::kStageFull>(keep, n, num_planes, in, out,
                                               scratch, nullptr, stream);
}

// The stage ablation: as arrowtpu_compact2, for a Stage of tile_rank.cuh;
// aux: (ceil(n / kTile),) int64 for kRank and kLookback (kFull writes the
// count to aux[0]).
int arrowtpu_compact2_stage(int stage, const void* keep, int64_t n,
                            int num_planes, const void* const* in,
                            void* const* out, void* scratch, void* aux,
                            void* stream) {
  switch (stage) {
    case arrowtpu::kStageCopy:
      return launch_compact2<arrowtpu::kStageCopy>(keep, n, num_planes, in,
                                                   out, scratch, aux, stream);
    case arrowtpu::kStageRank:
      return launch_compact2<arrowtpu::kStageRank>(keep, n, num_planes, in,
                                                   out, scratch, aux, stream);
    case arrowtpu::kStageLookback:
      return launch_compact2<arrowtpu::kStageLookback>(
          keep, n, num_planes, in, out, scratch, aux, stream);
    case arrowtpu::kStageKept:
      return launch_compact2<arrowtpu::kStageKept>(keep, n, num_planes, in,
                                                   out, scratch, aux, stream);
    case arrowtpu::kStageFull:
      return launch_compact2<arrowtpu::kStageFull>(keep, n, num_planes, in,
                                                   out, scratch, aux, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
