// The compaction kernels' tile body: the tile shape, the plane pointers
// passed by value, the in-block ranking of a tile's kept rows, the
// decoupled look-back, and tile_compact_kernel, the one kernel of K1
// (csrc/compact.cu, 4- and 8-byte words) and K3 (csrc/compact2.cu).
//
// A block owns one tile of kTile = 4096 rows.  Row order inside a tile is
// (round, warp, lane): row = tile + r*256 + tid, so a warp touches 32
// consecutive rows of every plane in each round.
//
// tile_compact_kernel, for (P, n) planes of 4- or 8-byte words and an (n,)
// u8 keep mask; kept words first in row order, then zeros up to out_rows:
//   1. rank: the tile's mask staged in shared memory (one 16-byte load a
//      thread), a ballot per (round, warp), a 128-entry scan in warp 0
//      (rank_tile);
//   2. a kept-row index list: each kept row writes its in-tile index (u16,
//      8 KB of shared memory) at its rank;
//   3. the kept gather: consecutive threads take consecutive kept rows of
//      one plane, so the stores to out[p][kept_before + k] are coalesced.
//      The loads are staged in 32 KB of shared memory, so that many are in
//      flight with no register held for them (loads into registers cap
//      them: more a thread costs occupancy), in one of two ways:
//      - a sparse tile (fewer than 16 / w of its rows kept) loads only its
//        kept words, by per-word cp.async over flattened work items (plane,
//        kept row): 16 u32 or 8 u64 items a thread a half, two halves in
//        flight, across planes;
//      - a dense tile, whose kept words touch nearly every 32-byte sector,
//        copies each plane's tile (u32) or half tile (u64) whole with one
//        cp.async.bulk (the TMA unit) on an mbarrier, two 16 KB buffers in
//        turn; the few words outside the copy's 16-byte units are read
//        from global memory by the gather;
//   4. the tile's output offset (kept rows before it) from one of two
//      frames: kFrameOffs reads it from `offs`, the exclusive prefix of the
//      tile counts (K1 when the caller has it: the filter's plan); in
//      kFrameLookback warp 0 runs a decoupled look-back (K3, and K1 when the
//      caller passes no offs).  The first two halves (or bulk copies) are
//      issued before the block waits on the offset, so the look-back costs
//      no load time;
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
// 4-byte words hold a kept word.  Nothing of the TPU's machinery (MXU
// one-hot scatter, lane roll rounds, DMA windows, SMEM carries across a
// sequential grid) carries over.
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

// A thread's cp.async of one word into shared memory; its groups; a wait
// until at most kPending of its groups are in flight.
template <typename T>
__device__ __forceinline__ void copy_async(T* shared, const T* global) {
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
// copy's byte count and issues the copy, and every thread waits on the
// barrier's phase.
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

// `bytes` (a multiple of 16, maybe 0) from 16-byte aligned `src` to
// 16-byte aligned shared `dst`; completes the barrier's phase on arrival.
// The fence orders the block's earlier reads of `dst` (a __syncthreads
// before it) before the copy's writes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, Status* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   shared_address(bar)),
               "r"(bytes)
               : "memory");
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

// Chunk c of a dense tile's plane: rows [c * kChunkRows, +rows) of the
// tile, `rows * w` bytes from `src`.  The bulk copy takes the whole 16-byte
// units between the first and last 16-byte boundaries; the words before
// and after them (a plane of a (P, n) tensor is 16-byte aligned only when
// n * w is a multiple of 16) are read from global memory by the gather.
// In shared memory the chunk starts `pad` bytes into its buffer, so that
// the copied units land on 16-byte boundaries.
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
    if (threadIdx.x < head) out[lo + threadIdx.x] = T(0);
    if (tail + threadIdx.x < hi) out[tail + threadIdx.x] = T(0);
    uint4* __restrict__ v = reinterpret_cast<uint4*>(out + lo + head);
    for (int64_t q = threadIdx.x; q < vecs; q += kThreads) {
      v[q] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// kFrame: a Frame; kStage: a Stage (kStageLookback in kFrameLookback only).
// offs: (tiles + 1,) exclusive prefix of the tile counts (kFrameOffs);
// status: the look-back's zeroed status words, one a tile (kFrameLookback);
// aux: one int64 a tile for kStageRank and kStageLookback, else unused.
template <typename T, int kFrame, int kStage>
__global__ void __launch_bounds__(kThreads, 4)
tile_compact_kernel(const uint8_t* __restrict__ keep, int64_t n,
                    const int64_t* __restrict__ offs, int num_planes,
                    const __grid_constant__ PlanePtrs<T> planes,
                    int64_t out_rows, Status* __restrict__ status,
                    int64_t* __restrict__ aux) {
  static_assert(kFrame == kFrameLookback || kStage != kStageLookback,
                "the look-back stage needs the look-back frame");
  constexpr bool kLookback = kFrame == kFrameLookback;
  constexpr int kChunkBytes = kStagedBytes / 2;  // a dense chunk's buffer
  constexpr int kChunkRows = kChunkBytes / sizeof(T);
  __shared__ TileRanks ranks;
  __shared__ uint16_t kept_rows[kTile];
  __shared__ int64_t shared_before;
  // the gather's staging: 32 KB of words for a sparse tile, two chunk
  // buffers (16 bytes longer for their `pad`) for a dense one
  __shared__ alignas(16) unsigned char staging[kStagedBytes + 32];
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

  // 3, dense: a tile with at least 16 / w of its rows kept (nearly every
  //    32-byte sector of a plane holds a kept word) stages all its words:
  //    unit u = (plane u / chunks, chunk u % chunks) is one bulk copy into
  //    buffer u % 2, the first two issued at once
  const bool dense = kept * 16 >= rows * static_cast<int>(sizeof(T));
  const int chunks = (rows + kChunkRows - 1) / kChunkRows;
  const int units = num_planes * chunks;
  const auto chunk_of = [&](int u) {
    const int c = u % chunks;
    const int chunk_rows =
        rows - c * kChunkRows < kChunkRows ? rows - c * kChunkRows
                                           : kChunkRows;
    return Chunk(planes.in[u / chunks] + tile + c * kChunkRows,
                 chunk_rows * sizeof(T));
  };
  const auto buffer = [&](int u) {
    return staging + (u & 1) * (kChunkBytes + 16);
  };
  const auto issue = [&](int u) {
    if (threadIdx.x == 0 && u < units) {
      const Chunk ch = chunk_of(u);
      bulk_copy(buffer(u) + ch.pad + ch.head, ch.src + ch.head, ch.body,
                &bars[u & 1]);
    }
  };
  if constexpr (kStage >= kStageKept) {
    if (dense) {
      issue(0);
      issue(1);
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
  //    items threadIdx.x + j * kThreads, (p, k) stepped without a division.  Its
  //    loads land in its own column of `staged` by cp.async, so no register
  //    holds them: two halves of kHalf items each, one half stored while
  //    the other is in flight.
  constexpr int kHalf = kStagedBytes / (2 * kThreads * sizeof(T));
  T (*staged)[kThreads] = reinterpret_cast<T (*)[kThreads]>(staging);
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
  const auto load_half = [&](int h) {
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      if (load.p < num_planes) {
        copy_async(&staged[h * kHalf + j][threadIdx.x],
                   planes.in[load.p] + tile + kept_rows[load.k]);
        next(load);
      }
    }
    commit_async();
  };
  if (!dense) {
    load_half(0);
    load_half(1);
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

  // 3, dense, continued: each unit once its copy has landed, its kept
  //    words in row order (kept_rows is ascending, so a chunk's kept rows
  //    are one range of it), then its buffer refilled with unit u + 2
  if (dense) {
    // the (round, warp) where chunk 1 starts (8-byte words only)
    constexpr int kSplit =
        kChunkRows < kTile ? (kChunkRows / kThreads) * kWarps : 0;
    for (int u = 0; u < units; ++u) {
      const int c = u % chunks;
      const int k0 = c == 0 ? 0 : ranks.prefix[kSplit];
      const int k1 = c + 1 == chunks ? kept : ranks.prefix[kSplit];
      const Chunk ch = chunk_of(u);
      const int row0 = c * kChunkRows;
      const int hw = ch.head / sizeof(T);  // words read from global memory
      const int tw = (ch.head + ch.body) / sizeof(T);
      const T* __restrict__ g = reinterpret_cast<const T*>(ch.src);
      const T* s = reinterpret_cast<const T*>(buffer(u) + ch.pad);
      T* __restrict__ out = planes.out[u / chunks];
      barrier_wait(&bars[u & 1], (u >> 1) & 1);
      for (int k = k0 + threadIdx.x; k < k1; k += kThreads) {
        const int64_t dst = kept_before + k;
        if (dst >= out_rows) break;
        const int r = kept_rows[k] - row0;
        out[dst] = r < hw || r >= tw ? g[r] : s[r];
      }
      if (u + 2 < units) {
        __syncthreads();
        issue(u + 2);
      }
    }
    return;
  }

  // 3, continued: store a half once it has landed, then refill it
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
