// The compaction kernels' tile body: the tile shape, the plane pointers
// passed by value, the in-block ranking of a tile's kept rows, the
// decoupled look-back, the zero fill, and tile_compact_kernel, the
// compaction kernel of K1 (csrc/compact.cu; 4-, 8- and, with tile offsets,
// 16-byte words: a row of a (n, 4) int32 tensor, a Decimal128, an interval
// month_day_nano, a string view), K2 at 1- and 4-byte words (the same
// source) and K3 (csrc/compact2.cu).  K1's 16-byte words without tile
// offsets (the look-back frame) run compact16_kernel (csrc/compact16.cuh),
// which shares the tile shape, the frames, the look-back and the zero fill.
//
// A block owns one tile of kTile = 4096 rows.  Row order inside a tile is
// (round, warp, lane): row = tile + r*256 + tid, so a warp touches 32
// consecutive rows of every plane in each round.
//
// tile_compact_kernel, for (P, n) planes of 1-, 4-, 8- or 16-byte words and an
// (n,) u8 keep mask; kept words first in row order, then zeros up to
// out_rows:
//   1. rank: the tile's mask staged in shared memory (one 16-byte load a
//      thread), a ballot per (round, warp), a 128-entry scan in warp 0
//      (rank_tile);
//   2. a kept-row index list: each kept row writes its in-tile index (u16,
//      8 KB of shared memory) at its rank;
//   3. the kept gather: consecutive threads take consecutive kept rows of
//      one plane, so the stores to out[p][kept_before + k] are coalesced.
//      A tile is dense when kept * kDenseDiv<T> >= rows (a quarter of
//      the rows for u32, half for u64 and 16-byte words, a fifth for u8),
//      else sparse:
//      - a dense tile copies its planes' tile rows whole into shared
//        memory with cp.async.bulk (the TMA unit) on an mbarrier, into
//        chunk buffers of 16 KB in turn: one plane's tile (u32), half a
//        plane's tile (u64), a quarter of one (16-byte words: 1024 rows,
//        so a tile is four chunks) or four planes' tiles (u8, 4 KB each) a
//        buffer, two buffers for words, one for bytes (so that 7 blocks
//        of bytes fit an SM); the few words outside the copies' 16-byte
//        units are read from global memory (none for 16-byte words, whose
//        planes are 16-byte aligned);
//      - a sparse tile of 4-, 8- or 16-byte words loads only its kept
//        words, by per-word cp.async over flattened work items (plane,
//        kept row) into 32 KB of shared memory, so that many loads are in
//        flight with no register held for them: 16 u32, 8 u64 or 4
//        16-byte items a thread a half, two halves in flight, across
//        planes;
//      - a sparse tile of bytes (cp.async moves 4, 8 or 16 bytes, never 1)
//        loads its kept bytes with plain loads into registers, 8 items a
//        thread a batch, over the same flattened items;
//   4. the tile's output offset (kept rows before it) from one of two
//      frames: kFrameOffs reads it from `offs`, the exclusive prefix of the
//      tile counts (K1 and K2 when the caller has it: the filter's plan);
//      in kFrameLookback warp 0 runs a decoupled look-back (K3, and K1 and
//      K2 when the caller passes no offs; the last tile then writes the
//      count, its inclusive prefix, to `aux` when that is given).  The
//      first loads (or bulk copies) are issued before the block waits on
//      the offset, so the look-back costs no load time;
//   5. the tile's dropped rows' zeros as one contiguous range of every
//      plane, written with 16-byte stores aligned on the output address
//      (scalar head and tail words): with db dropped rows before the tile
//      and D in it, [n - db - D, n - db) in kFrameLookback (the dropped
//      rows' reversed positions, which need no count) and [count + db,
//      count + db + D) in kFrameOffs, each cut to [0, out_rows).
// Every output word below out_rows is written exactly once.
//
// Bound on an H100 SXM: pure data movement.  The least bytes are n mask
// bytes + P*w*count kept words read + P*w*out_rows words written, over
// 3.35 TB/s of HBM3; the look-back's status traffic is 8 bytes a tile.
// The card reads whole 32-byte sectors, so a sparse mask reads more than
// the bound counts: at 5.5 % kept, 1 - 0.945^8 = 36 % of the sectors of
// 4-byte words and 1 - 0.945^32 = 84 % of those of bytes hold a kept
// word.  Nothing of the TPU's machinery (MXU one-hot scatter, lane roll
// rounds, DMA windows, SMEM carries across a sequential grid) carries
// over.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace arrowtpu {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;  // rows per block
constexpr int kMaxPlanes = 16;
constexpr int kStagedBytes = 32 * 1024;  // a block's gather staging
constexpr unsigned kFull = 0xffffffffu;

// A tile is dense (staged whole by bulk copies) when kept * kDenseDiv<T>
// >= rows: a quarter of the rows for u32 and half for u64, where nearly
// every 32-byte sector holds a kept word; a fifth for bytes, between the
// densities where the card read plain loads faster (up to 12.5 % kept) and
// bulk copies faster (from 25 %), though the sectors are all touched from
// about 12 %.  16-byte words take half too: a sector holds two of them, so
// the sector rule would stage a tile only when every row is kept, and a
// sparse item is already one 16-byte copy.
template <typename T>
constexpr int kDenseDiv =
    sizeof(T) == 1 ? 5 : (sizeof(T) == 16 ? 2 : 16 / static_cast<int>(sizeof(T)));

static_assert(kRounds * kWarps == 4 * 32, "warp 0 scans 4 counts per lane");
static_assert(kTile <= 65536, "kept rows are listed as u16");

// The stages of the compaction kernels' stage ablation (kernels/probes.py
// compaction_stages keeps the same numbers).  Each stage adds one piece of
// the production kernel to the one before it:
//   kStageCopy      the planes copied straight through (no mask);
//   kStageRank      + the mask staged, the ballots and the block scan; the tile's
//                   kept count written to aux[tile] keeps the work live;
//   kStageLookback  + the decoupled look-back (kFrameLookback only); the
//                   tile's exclusive prefix written to aux[tile];
//   kStageKept      + the index list and the kept gather, no zero fill
//                   (words from the count on are not written);
//   kStageFull      the production kernel, the only stage the entry points of
//                   K1, K2 and K3 instantiate.
enum Stage : int {
  kStageCopy = 0,
  kStageRank = 1,
  kStageLookback = 2,
  kStageKept = 3,
  kStageFull = 4,
};

// Where a tile's output offset comes from (see the header).
enum Frame : int {
  kFrameOffs = 0,
  kFrameLookback = 1,
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
// (the stages before kStageKept): every load of a thread, then its
// stores.
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
      v[r] = tile + r * kThreads + threadIdx.x < n ? src[r * kThreads] : T{};
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (tile + r * kThreads + threadIdx.x < n) out[r * kThreads] = v[r];
    }
  }
}

// ---------------------------------------------------------------------------
// the decoupled look-back
// ---------------------------------------------------------------------------
//
// Block b owns tile b.  Blocks are dispatched in increasing blockIdx order
// (the order CUB's single-pass scan relies on as well), so a block only
// ever waits on tiles whose blocks were dispatched before it, and the wait
// cannot deadlock; no tile ticket sits on a block's path.  Thread 0
// publishes the tile's kept count (flag AGGREGATE) as soon as the tile is
// ranked; warp 0 then looks back over its predecessors' status words, 32 at
// a time, summing their counts until it meets an INCLUSIVE prefix, and
// publishes its own inclusive prefix.  A status word is 64 bits, flag and
// value in one word, so the words alone carry what a tile reads: relaxed
// loads and stores at gpu scope suffice, with no fence.  The status words
// are zeroed on the stream before every launch.

using Status = unsigned long long;
constexpr int kFlagShift = 62;
constexpr Status kAggregate = 1ull << kFlagShift;  // the tile's own count
constexpr Status kInclusive = 2ull << kFlagShift;  // count through the tile
constexpr Status kValue = kAggregate - 1;

__device__ __forceinline__ void store_relaxed(Status* p, Status v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ Status load_relaxed(const Status* p) {
  Status v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// One thread of tile t: the tile's kept count, inclusive for tile 0.
__device__ __forceinline__ void publish_aggregate(Status* status, int64_t t,
                                                  int aggregate) {
  store_relaxed(status + t, (t == 0 ? kInclusive : kAggregate) |
                                static_cast<Status>(aggregate));
}

// Warp 0 of tile t, after publish_aggregate: look back, publish the
// inclusive prefix; -> the kept rows before the tile (in every lane).
__device__ __forceinline__ int64_t look_back(Status* status, int64_t t,
                                             int aggregate, int lane) {
  if (t == 0) return 0;
  int64_t exclusive = 0;
  for (int64_t base = t - 1;; base -= 32) {
    const int64_t p = base - lane;  // lane 0 reads the nearest predecessor
    Status s = kInclusive;          // before tile 0: an inclusive prefix 0
    if (p >= 0) {
      do {
        s = load_relaxed(status + p);
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
    store_relaxed(status + t,
                  kInclusive | static_cast<Status>(exclusive + aggregate));
  }
  return exclusive;
}

// ---------------------------------------------------------------------------
// tile_compact_kernel (in an unnamed namespace: each source that includes
// this header launches its own instantiations)
// ---------------------------------------------------------------------------

namespace {

// A thread's cp.async of one 4-, 8- or 16-byte word into shared memory;
// its groups; a wait until at most kPending of its groups are in flight.
template <typename T>
__device__ __forceinline__ void copy_async(T* shared, const T* global) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8 || sizeof(T) == 16,
                "cp.async moves 4, 8 or 16 bytes");
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(dst),
               "l"(global), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// The dense tiles' bulk copies (the TMA unit): one mbarrier a buffer,
// initialised by one thread for one arrival; that thread arms it with the
// byte count of the copies that fill the buffer and issues them, and every
// thread waits on the barrier's phase.
__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(Status* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   shared_address(bar)),
               "r"(1)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arm the barrier's phase for `bytes`, the sum of the bulk copies that
// complete it (0 completes it at once).  The fence orders the block's
// earlier reads of the buffer (a __syncthreads before it) before the
// copies' writes.
__device__ __forceinline__ void expect_bytes(Status* bar, unsigned bytes) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   shared_address(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16, maybe 0) from 16-byte aligned `src` to
// 16-byte aligned shared `dst`, counted on the barrier's phase.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, Status* bar) {
  if (bytes) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(shared_address(dst)),
        "l"(src), "r"(bytes), "r"(shared_address(bar))
        : "memory");
  }
}

__device__ __forceinline__ void barrier_wait(Status* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(shared_address(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A chunk of a dense tile's plane: `bytes` from `start`.  The bulk copy
// takes the whole 16-byte units between the first and last 16-byte
// boundaries; the words before and after them (a plane of a (P, n) tensor
// is 16-byte aligned only when n * w is a multiple of 16) are read from
// global memory by the gather.  In shared memory the chunk starts `pad`
// bytes into its slot, so that the copied units land on 16-byte
// boundaries.
struct Chunk {
  const char* src;
  unsigned pad, head, body;  // bytes

  __device__ __forceinline__ Chunk(const void* start, unsigned bytes)
      : src(static_cast<const char*>(start)) {
    pad = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src) & 15);
    head = (16 - pad) & 15;
    if (head > bytes) head = bytes;
    body = (bytes - head) & ~15u;
  }
};

// The gather's position: plane p, kept row k of the tile.
struct Walk {
  int p, k;
};

// Zeros at words [lo, hi) of every plane: 16-byte stores from the first
// 16-byte boundary of the output address, scalar words before it and after
// the last whole vector.  A plane of a (P, n) tensor is 16-byte aligned
// only when n * sizeof(T) is a multiple of 16, so each plane finds its own.
template <typename T>
__device__ __forceinline__ void zero_fill(const PlanePtrs<T>& planes,
                                          int num_planes, int64_t lo,
                                          int64_t hi) {
  constexpr int kPerVec = 16 / sizeof(T);
  for (int p = 0; p < num_planes; ++p) {
    T* __restrict__ out = planes.out[p];
    const uintptr_t a = reinterpret_cast<uintptr_t>(out + lo);
    int64_t head = static_cast<int64_t>(((16 - (a & 15)) & 15) / sizeof(T));
    if (head > hi - lo) head = hi - lo;
    const int64_t vecs = (hi - lo - head) / kPerVec;
    const int64_t tail = lo + head + vecs * kPerVec;
    if (threadIdx.x < head) out[lo + threadIdx.x] = T{};
    if (tail + threadIdx.x < hi) out[tail + threadIdx.x] = T{};
    uint4* __restrict__ v = reinterpret_cast<uint4*>(out + lo + head);
    for (int64_t q = threadIdx.x; q < vecs; q += kThreads) {
      v[q] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// kFrame: a Frame; kStage: a Stage (kStageLookback in kFrameLookback only).
// offs: (tiles + 1,) exclusive prefix of the tile counts (kFrameOffs);
// status: the look-back's zeroed status words, one a tile (kFrameLookback);
// aux: one int64 a tile for kStageRank and kStageLookback; for kStageFull
// in kFrameLookback the count, written by the last tile, or null.
template <typename T, int kFrame, int kStage>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 1 ? 7 : 4)
tile_compact_kernel(const uint8_t* __restrict__ keep, int64_t n,
                    const int64_t* __restrict__ offs, int num_planes,
                    const __grid_constant__ PlanePtrs<T> planes,
                    int64_t out_rows, Status* __restrict__ status,
                    int64_t* __restrict__ aux) {
  static_assert(kFrame == kFrameLookback || kStage != kStageLookback,
                "the look-back stage needs the look-back frame");
  constexpr bool kLookback = kFrame == kFrameLookback;
  constexpr int kWord = static_cast<int>(sizeof(T));
  // A dense tile's unit is the chunks of kChunkRows rows of up to
  // kUnitPlanes planes, one bulk copy each, into one of kBuffers buffers
  // of kUnitPlanes slots (each 16 bytes longer than its chunk, for the
  // pad): a 16 KB buffer holds one plane's tile of u32, half of one of
  // u64, a quarter of one of 16-byte words, or the tiles of four planes
  // of bytes.  Bytes keep one buffer (the
  // sparse byte path stages nothing), so that 7 blocks fit an SM.
  constexpr int kChunkBytes = kStagedBytes / 2;
  constexpr int kPlaneBytes = kTile * kWord;
  constexpr int kUnitPlanes =
      kPlaneBytes < kChunkBytes ? kChunkBytes / kPlaneBytes : 1;
  constexpr int kChunkRows = kUnitPlanes > 1 ? kTile : kChunkBytes / kWord;
  constexpr int kSlotBytes = kChunkRows * kWord + 16;
  constexpr int kBufferBytes = kUnitPlanes * kSlotBytes;
  constexpr int kBuffers = kWord == 1 ? 1 : 2;
  constexpr int kStagingBytes =
      kWord == 1 ? kBufferBytes
                 : (2 * kBufferBytes > kStagedBytes ? 2 * kBufferBytes
                                                    : kStagedBytes);
  __shared__ TileRanks ranks;
  __shared__ uint16_t kept_rows[kTile];
  __shared__ int64_t shared_before;
  // the gather's staging: the unit buffers of a dense tile, 32 KB of
  // words for a sparse tile of 4- or 8-byte words
  __shared__ alignas(16) unsigned char staging[kStagingBytes];
  __shared__ Status bars[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int64_t t = blockIdx.x;
  const int64_t tile = t * kTile;
  if constexpr (kStage < kStageLookback) {
    if constexpr (kStage == kStageRank) {
      unsigned ballots[kRounds];
      const int aggregate = rank_tile(keep, n, tile, ranks, ballots);
      if (threadIdx.x == 0) aux[t] = aggregate;
      // 16-byte words' rank stage stands beside compact16_kernel's, which
      // copies no plane (kernels/probes.py compaction_stages, "k1_tile")
      if constexpr (kWord == 16) return;
    }
    copy_tile(n, num_planes, planes, tile);
    return;
  }

  // 1. the tile, ranked; its count published at once for the look-back
  if constexpr (kStage >= kStageKept) {
    if (threadIdx.x == 0) {
      barrier_init(&bars[0]);
      barrier_init(&bars[1]);
    }
  }
  unsigned ballots[kRounds];
  rank_tile(keep, n, tile, ranks, ballots);
  constexpr int kLast = kRounds * kWarps - 1;
  const int kept = ranks.prefix[kLast] + ranks.counts[kLast];
  if constexpr (kLookback) {
    if (threadIdx.x == 0) publish_aggregate(status, t, kept);
  }
  const int rows = n - tile < kTile ? static_cast<int>(n - tile) : kTile;

  // 3, dense: unit u = (plane group u / chunks, chunk u % chunks) is up to
  //    kUnitPlanes bulk copies into buffer u % kBuffers, the first
  //    kBuffers units issued at once
  const bool dense = kept * kDenseDiv<T> >= rows;
  const int chunks = (rows + kChunkRows - 1) / kChunkRows;
  const int units = (num_planes + kUnitPlanes - 1) / kUnitPlanes * chunks;
  const auto unit_planes = [&](int u) {
    const int first = u / chunks * kUnitPlanes;
    return num_planes - first < kUnitPlanes ? num_planes - first
                                            : kUnitPlanes;
  };
  const auto chunk_of = [&](int p, int c) {
    const int chunk_rows =
        rows - c * kChunkRows < kChunkRows ? rows - c * kChunkRows
                                           : kChunkRows;
    return Chunk(planes.in[p] + tile + c * kChunkRows, chunk_rows * kWord);
  };
  const auto slot = [&](int u, int q) {
    return staging + (u % kBuffers) * kBufferBytes + q * kSlotBytes;
  };
  const auto issue = [&](int u) {
    if (threadIdx.x == 0 && u < units) {
      const int c = u % chunks;
      const int first = u / chunks * kUnitPlanes;
      const int count = unit_planes(u);
      unsigned bytes = 0;
      for (int q = 0; q < count; ++q) bytes += chunk_of(first + q, c).body;
      expect_bytes(&bars[u % kBuffers], bytes);
      for (int q = 0; q < count; ++q) {
        const Chunk ch = chunk_of(first + q, c);
        bulk_copy(slot(u, q) + ch.pad + ch.head, ch.src + ch.head, ch.body,
                  &bars[u % kBuffers]);
      }
    }
  };
  if constexpr (kStage >= kStageKept) {
    if (dense) {
      for (int u = 0; u < kBuffers; ++u) issue(u);
    }
  }
  if constexpr (kStage == kStageLookback) {
    if (warp == 0) {
      const int64_t e = look_back(status, t, kept, lane);
      if (lane == 0) aux[t] = e;
    }
    copy_tile(n, num_planes, planes, tile);
    return;
  }

  // 2. the kept-row index list
  const unsigned lane_lt = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if ((ballots[r] >> lane) & 1u) {
      kept_rows[ranks.prefix[r * kWarps + warp] +
                __popc(ballots[r] & lane_lt)] =
          static_cast<uint16_t>(r * kThreads + threadIdx.x);
    }
  }
  __syncthreads();

  // 3, sparse: item i = (plane i / kept, kept row i % kept); a thread takes
  //    items threadIdx.x + j * kThreads, (p, k) stepped without a division.
  int dp = 0, dk = 0;
  Walk load{num_planes, 0};
  if (kept > 0 && !dense) {
    load = {static_cast<int>(threadIdx.x) / kept,
            static_cast<int>(threadIdx.x) % kept};
    dp = kThreads / kept;
    dk = kThreads % kept;
  }
  Walk store = load;
  const auto next = [&](Walk& w) {
    w.k += dk;
    w.p += dp;
    if (w.k >= kept) {
      w.k -= kept;
      ++w.p;
    }
  };
  // 4-, 8- and 16-byte words land in the thread's own column of `staged` by
  // cp.async, so no register holds them: two halves of kHalf items each,
  // one half stored while the other is in flight
  constexpr int kHalf = kStagedBytes / (2 * kThreads * kWord);
  T (*staged)[kThreads] = reinterpret_cast<T (*)[kThreads]>(staging);
  const auto load_half = [&](int h) {
    if constexpr (kWord >= 4) {
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        if (load.p < num_planes) {
          copy_async(&staged[h * kHalf + j][threadIdx.x],
                     planes.in[load.p] + tile + kept_rows[load.k]);
          next(load);
        }
      }
      commit_async();
    }
  };
  // bytes are loaded into registers, kBatch items a batch
  constexpr int kBatch = 8;
  T held[kBatch];
  const auto load_batch = [&]() {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (load.p < num_planes) {
        held[j] = planes.in[load.p][tile + kept_rows[load.k]];
        next(load);
      }
    }
  };
  if (!dense) {
    if constexpr (kWord >= 4) {
      load_half(0);
      load_half(1);
    } else {
      load_batch();
    }
  }

  // 4. the tile's offset: every thread's first loads are in flight meanwhile
  int64_t kept_before;
  if constexpr (kLookback) {
    if (warp == 0) {
      const int64_t e = look_back(status, t, kept, lane);
      if (lane == 0) shared_before = e;
    }
    __syncthreads();
    kept_before = shared_before;
    if constexpr (kStage == kStageFull) {
      if (aux != nullptr && threadIdx.x == 0 && t + 1 == gridDim.x) {
        *aux = kept_before + kept;
      }
    }
  } else {
    kept_before = offs[t];
  }

  // 5. the zero range, while the first loads land
  if constexpr (kStage == kStageFull) {
    const int64_t dropped = rows - kept;
    const int64_t before = tile - kept_before;  // dropped rows before
    int64_t lo, hi;
    if constexpr (kLookback) {
      hi = n - before;
      lo = hi - dropped;
    } else {
      lo = offs[gridDim.x] + before;
      hi = lo + dropped;
    }
    if (hi > out_rows) hi = out_rows;
    if (lo < hi) zero_fill(planes, num_planes, lo, hi);
  }

  // 3, dense, continued: each unit once its copies have landed, its
  //    planes' kept words in row order (consecutive threads take
  //    consecutive kept rows; kept_rows is ascending, so a chunk's kept
  //    rows are one range of it), then its buffer refilled with unit u +
  //    kBuffers.  Bytes cost a few instructions each, so a unit of bytes
  //    first reads the bytes outside its copies' 16-byte units (at most 15
  //    before and 15 after each) into their places in its buffer, and the
  //    gather reads shared memory alone, up to a bound taken once.
  if (dense && kWord == 1) {
    const int64_t end = out_rows - kept_before < kept ? out_rows - kept_before
                                                      : kept;
    for (int u = 0; u < units; ++u) {
      const int first = u * kUnitPlanes;  // one chunk a plane
      const int count = unit_planes(u);
      if (threadIdx.x < 32) {
        for (int q = 0; q < count; ++q) {
          const Chunk ch = chunk_of(first + q, 0);
          const int x = threadIdx.x < 16
                            ? static_cast<int>(threadIdx.x)
                            : static_cast<int>(ch.head + ch.body +
                                               threadIdx.x - 16);
          if (threadIdx.x < 16 ? x < static_cast<int>(ch.head) : x < rows) {
            reinterpret_cast<T*>(slot(u, q) + ch.pad)[x] =
                reinterpret_cast<const T*>(ch.src)[x];
          }
        }
      }
      barrier_wait(&bars[u % kBuffers], (u / kBuffers) & 1);
      __syncthreads();
      for (int q = 0; q < count; ++q) {
        const T* s = reinterpret_cast<const T*>(slot(u, q) +
                                                chunk_of(first + q, 0).pad);
        T* __restrict__ out = planes.out[first + q] + kept_before;
        for (int k = threadIdx.x; k < end; k += kThreads) {
          out[k] = s[kept_rows[k]];
        }
      }
      if (u + kBuffers < units) {
        __syncthreads();
        issue(u + kBuffers);
      }
    }
    return;
  }
  // Words keep a loop of their own: the bytes' loop taken chunk by chunk
  // for them (the words outside the copies filled in first) held 8 (u32)
  // or 21-28 (u64) more registers and was 1-3 % slower at 96 % kept.
  if (dense) {
    // the (round, warp) entries a chunk spans (8- and 16-byte words cut a
    // tile into chunks: chunk c starts at entry c * kSplit)
    constexpr int kSplit =
        kChunkRows < kTile ? (kChunkRows / kThreads) * kWarps : 0;
    for (int u = 0; u < units; ++u) {
      const int c = u % chunks;
      const int k0 = c == 0 ? 0 : ranks.prefix[c * kSplit];
      const int k1 = c + 1 == chunks ? kept : ranks.prefix[(c + 1) * kSplit];
      const int first = u / chunks * kUnitPlanes;
      const int row0 = c * kChunkRows;
      barrier_wait(&bars[u % kBuffers], (u / kBuffers) & 1);
      for (int q = 0, count = unit_planes(u); q < count; ++q) {
        const Chunk ch = chunk_of(first + q, c);
        const int hw = ch.head / kWord;  // words read from global memory
        const int tw = (ch.head + ch.body) / kWord;
        const T* __restrict__ g = reinterpret_cast<const T*>(ch.src);
        const T* s = reinterpret_cast<const T*>(slot(u, q) + ch.pad);
        T* __restrict__ out = planes.out[first + q];
        for (int k = k0 + threadIdx.x; k < k1; k += kThreads) {
          const int64_t dst = kept_before + k;
          if (dst >= out_rows) break;
          const int r = kept_rows[k] - row0;
          out[dst] = r < hw || r >= tw ? g[r] : s[r];
        }
      }
      if (u + kBuffers < units) {
        __syncthreads();
        issue(u + kBuffers);
      }
    }
    return;
  }

  // 3, sparse, continued: store the items in flight, then load the next
  if constexpr (kWord >= 4) {
    for (int h = 0;; h ^= 1) {
      wait_async<1>();
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        if (store.p < num_planes) {
          const int64_t dst = kept_before + store.k;
          if (dst < out_rows) {
            planes.out[store.p][dst] = staged[h * kHalf + j][threadIdx.x];
          }
          next(store);
        }
      }
      if (store.p >= num_planes) break;  // the half in flight holds no item
      load_half(h);
    }
  } else {
    for (;;) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (store.p < num_planes) {
          const int64_t dst = kept_before + store.k;
          if (dst < out_rows) planes.out[store.p][dst] = held[j];
          next(store);
        }
      }
      if (store.p >= num_planes) break;
      load_batch();
    }
  }
}

// One launch of tile_compact_kernel over ceil(n / kTile) tiles; for
// kFrameLookback the scratch (one 8-byte status word a tile) is zeroed on
// the stream first.
template <typename T, int kFrame, int kStage>
int launch_tile_compact(const void* keep, int64_t n, const void* offs,
                        int num_planes, const void* const* in,
                        void* const* out, int64_t out_rows, void* scratch,
                        void* aux, cudaStream_t stream) {
  if (n <= 0 || num_planes < 1 || num_planes > kMaxPlanes || out_rows < 0 ||
      out_rows > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (kFrame == kFrameLookback && kStage >= kStageLookback) {
    const cudaError_t err =
        cudaMemsetAsync(scratch, 0, tiles * sizeof(Status), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  PlanePtrs<T> planes{};
  for (int p = 0; p < num_planes; ++p) {
    planes.in[p] = static_cast<const T*>(in[p]);
    planes.out[p] = static_cast<T*>(out[p]);
  }
  tile_compact_kernel<T, kFrame, kStage>
      <<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
          static_cast<const uint8_t*>(keep), n,
          static_cast<const int64_t*>(offs), num_planes, planes, out_rows,
          static_cast<Status*>(scratch), static_cast<int64_t*>(aux));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace arrowtpu
