// Dense-range GROUP BY aggregate on Hopper: per bucket of a small integer
// key range, the rows present and, per value column, the valid count, the
// int64 sum (wrapping mod 2**64), the min and the max.
//
// Replaces what XLA fuses from the JAX package's dense-range engine,
// arrowtpu/ops/groupby.py _dense_group_by (its per-bucket presence counts)
// and _dense_agg_column (per-bucket count, sum and min/max): there about
// NB masked reductions per output, which XLA fuses into about one pass
// over the rows on the TPU.  That code is not a Pallas kernel.  PyTorch
// eager cannot fuse 128-256 masked reductions, and its scatter calls
// (index_add_, scatter_reduce) send every row to one of NB addresses in
// device memory with a global atomic; this kernel is the card's form of
// the one pass.
//
// A row's bucket: key - kmin + off for a row with a valid key, 0 for a row
// with a null key (off is then 1); rows at or past n (dead rows) and rows
// whose bucket falls outside [0, nb) are skipped.  A value counts only
// where it is valid.  kmin is read from device memory, so the caller needs
// no read-back for it.  Values of any integer width up to 64 bits are
// widened to int64 (unsigned ones zero-extended, which keeps their order),
// so min and max compare in the column's own order.
//
// Design (the kernel before it ran an init kernel, then one row a thread a
// step with a 64-bit shared atomic add, which the card runs as a
// compare-and-swap loop, and asked the runtime for the attribute and
// occupancy on every call):
//   - one launch on a persistent grid: the SMs times the blocks an SM that
//     the occupancy query allows at the call's shared size; the
//     shared-size attribute is set once per key type and the query asked
//     once per key type and size;
//   - a thread takes 4 consecutive rows a step (a warp 128): the keys and
//     each value column by one vector load each (two 16-byte loads for
//     int64), a validity's 4 bits from one byte;
//   - each block keeps its nb buckets of every column in shared memory:
//     the rows by a 32-bit atomic add (which the compiler aggregates over
//     a warp's equal addresses), the sum as two 32-bit atomic adds with
//     the low half's carry (add_sum), the min and max by a 64-bit atomic
//     only when the row beats the bucket's current value; a column
//     without a validity bitmap keeps no count (its count is its bucket's
//     rows);
//   - each block adds its non-empty buckets into `acc`, a fixed-layout
//     accumulator that the caller keeps per device and stream (rows, then
//     per column count, sum, min, max; kMaxBuckets entries each), with
//     global atomics; the last block to finish (an atomic ticket) copies
//     the call's part of acc to the output, sets it back to the identity
//     (0, 0, INT64_MAX, INT64_MIN) and the ticket to 0, so no init kernel
//     runs and the next call on the stream finds acc ready.
// Two variants were tried on the card while choosing this design and not
// kept: a warp's rows grouped by bucket first (__match_any_sync, then
// reductions over each group) was many times slower at 100 keys; a warp
// whose rows share one bucket reduced in registers first helped only that
// worst case and cost time at 100 keys.  Integer results do not depend on
// the order in which the atomics land, so the kernel is bit-exact against
// its plain version (kernels/dense_agg.py dense_aggregate_plain), run
// after run.
//
// Bound on the card: bytes.  It reads each key and value once (config 4:
// n x (4 + 8) bytes, 96 MB at 8M rows, 0.029 ms at 3.35 TB/s) and writes
// (1 + 4 C) x nb int64.  At config 4 it runs at about half that bound
// (PERF.md section 6); the rest is its ~3 shared atomics a row (not
// measured apart).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;          // rows a thread a step
constexpr int kMaxCols = 8;       // value columns per launch
constexpr int kMaxBuckets = 4096;
constexpr int kAccRows = 1 + 4 * kMaxCols;
// the shared memory a block may ask for (kernels/dense_agg.py SMEM_BUDGET)
constexpr int kSmemBudget = 200 * 1024;

// element types of the key and value columns
enum Code : int { kI8 = 0, kI16, kI32, kI64, kU8, kU16, kU32 };

struct Cols {
  const void* values[kMaxCols];
  const uint8_t* validity[kMaxCols];  // LSB bitmaps, or null: all valid
  int code[kMaxCols];
};

template <typename T, typename V>
__device__ __forceinline__ void widen4(V x, long long (&v)[kRows]) {
  v[0] = static_cast<T>(x.x);
  v[1] = static_cast<T>(x.y);
  v[2] = static_cast<T>(x.z);
  v[3] = static_cast<T>(x.w);
}

// Rows i..i+3 (i a multiple of 4) of a column of element type T, widened
// to int64: one vector load when the 4 rows lie below n and the column is
// aligned to 4 elements, else one load a row below n.
template <typename T>
__device__ __forceinline__ void load4(const void* p, long long i, long long n,
                                      long long (&v)[kRows]) {
  const T* col = static_cast<const T*>(p);
  constexpr uintptr_t kAlign = 4 * sizeof(T);
  if (i + kRows <= n && (reinterpret_cast<uintptr_t>(col) % kAlign) == 0) {
    if constexpr (sizeof(T) == 1) {
      const uchar4 x = __ldcs(reinterpret_cast<const uchar4*>(col + i));
      widen4<T>(x, v);
    } else if constexpr (sizeof(T) == 2) {
      const ushort4 x = __ldcs(reinterpret_cast<const ushort4*>(col + i));
      widen4<T>(x, v);
    } else if constexpr (sizeof(T) == 4) {
      const uint4 x = __ldcs(reinterpret_cast<const uint4*>(col + i));
      widen4<T>(x, v);
    } else {
      const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(col + i));
      const longlong2 b =
          __ldcs(reinterpret_cast<const longlong2*>(col + i + 2));
      v[0] = a.x;
      v[1] = a.y;
      v[2] = b.x;
      v[3] = b.y;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    v[j] = i + j < n ? static_cast<long long>(col[i + j]) : 0;
  }
}

__device__ __forceinline__ void load_value4(const void* p, int code,
                                            long long i, long long n,
                                            long long (&v)[kRows]) {
  switch (code) {
    case kI8: return load4<int8_t>(p, i, n, v);
    case kI16: return load4<int16_t>(p, i, n, v);
    case kI32: return load4<int32_t>(p, i, n, v);
    case kI64: return load4<long long>(p, i, n, v);
    case kU8: return load4<uint8_t>(p, i, n, v);
    case kU16: return load4<uint16_t>(p, i, n, v);
    default: return load4<uint32_t>(p, i, n, v);
  }
}

// The validity bits of rows i..i+3 (i a multiple of 4), all set for null.
__device__ __forceinline__ unsigned valid4(const uint8_t* bitmap,
                                           long long i) {
  return bitmap == nullptr ? 0xFu : (bitmap[i >> 3] >> (i & 7)) & 0xFu;
}

// The block's buckets in shared memory: per column sum, min, max (int64)
// and count (u32), then the rows (u32).
struct Buckets {
  unsigned long long* sum;
  long long* min;
  long long* max;
  unsigned* cnt;
  unsigned* rows;
};

// One row's value into its bucket j = c * nb + b.  The min and max are
// skipped when the bucket already beats the value: a volatile 64-bit load
// is one access (no torn value), and a bucket's min only falls and its max
// only rises, so a value that does not beat what it reads cannot change
// the result.
// A bucket's sum as two 32-bit halves (the card has no 64-bit shared
// atomic add: atomicAdd on a 64-bit shared word compiles to a compare-and-
// swap loop): the lane whose low add wraps carries one into the high half,
// so the pair is the 64-bit sum mod 2**64, read back as one word.
__device__ __forceinline__ void add_sum(unsigned long long* sum,
                                        unsigned long long u) {
  unsigned* w = reinterpret_cast<unsigned*>(sum);
  const unsigned lo = static_cast<unsigned>(u);
  const unsigned old = atomicAdd(w, lo);
  atomicAdd(w + 1, static_cast<unsigned>(u >> 32) + (old + lo < old));
}

// One row's value into its bucket j = c * nb + b.  The min and max are
// skipped when the bucket already beats the value: a volatile 64-bit load
// is one access (no torn value), and a bucket's min only falls and its max
// only rises, so a value that does not beat what it reads cannot change
// the result.
__device__ __forceinline__ void add_value(const Buckets& s, int j,
                                          long long v, bool counted) {
  if (counted) atomicAdd(&s.cnt[j], 1u);
  add_sum(&s.sum[j], static_cast<unsigned long long>(v));
  if (v < *static_cast<volatile long long*>(&s.min[j])) atomicMin(&s.min[j], v);
  if (v > *static_cast<volatile long long*>(&s.max[j])) atomicMax(&s.max[j], v);
}

template <typename K>
__global__ void __launch_bounds__(kThreads) dense_agg_kernel(
    const K* __restrict__ key, const uint8_t* __restrict__ key_valid,
    const long long* __restrict__ kmin_p, int off, int nb, long long n,
    int ncols, Cols cols, long long* __restrict__ acc,
    unsigned* __restrict__ ticket, long long* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  const int cn = ncols * nb;
  Buckets s;
  s.sum = smem;
  s.min = reinterpret_cast<long long*>(smem + cn);
  s.max = s.min + cn;
  s.cnt = reinterpret_cast<unsigned*>(s.max + cn);
  s.rows = s.cnt + cn;
  for (int j = threadIdx.x; j < cn; j += kThreads) {
    s.sum[j] = 0;
    s.min[j] = LLONG_MAX;
    s.max[j] = LLONG_MIN;
    s.cnt[j] = 0;
  }
  for (int j = threadIdx.x; j < nb; j += kThreads) s.rows[j] = 0;
  __syncthreads();

  const long long kmin = *kmin_p;
  const int lane = threadIdx.x & 31;
  const long long stride =
      static_cast<long long>(gridDim.x) * kThreads * kRows;
  // a warp takes 128 consecutive rows a step, 4 a lane
  for (long long base = (static_cast<long long>(blockIdx.x) * kThreads +
                         (threadIdx.x & ~31)) * kRows;
       base < n; base += stride) {
    const long long i = base + lane * kRows;
    long long kv[kRows];
    load4<K>(key, i, n, kv);
    const unsigned kvalid = key_valid == nullptr ? 0xFu : (
        i < n ? valid4(key_valid, i) : 0u);
    int b[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const long long x = (kvalid >> j) & 1u ? kv[j] - kmin + off : 0;
      b[j] = i + j < n && x >= 0 && x < nb ? static_cast<int>(x) : -1;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (b[j] >= 0) atomicAdd(&s.rows[b[j]], 1u);
    }
    for (int c = 0; c < ncols; ++c) {
      long long v[kRows];
      load_value4(cols.values[c], cols.code[c], i, n, v);
      const bool has_validity = cols.validity[c] != nullptr;
      const unsigned ok = i < n ? valid4(cols.validity[c], i) : 0u;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (b[j] >= 0 && ((ok >> j) & 1u)) {
          add_value(s, c * nb + b[j], v[j], has_validity);
        }
      }
    }
  }
  __syncthreads();

  // the block's buckets into acc (a column without validity counts its
  // bucket's rows)
  for (int j = threadIdx.x; j < nb; j += kThreads) {
    if (s.rows[j] != 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(acc) + j,
                static_cast<unsigned long long>(s.rows[j]));
  }
  for (int j = threadIdx.x; j < cn; j += kThreads) {
    const int c = j / nb, b = j - c * nb;
    const unsigned count =
        cols.validity[c] == nullptr ? s.rows[b] : s.cnt[j];
    if (count == 0) continue;
    long long* a = acc + static_cast<long long>(1 + 4 * c) * kMaxBuckets + b;
    atomicAdd(reinterpret_cast<unsigned long long*>(a),
              static_cast<unsigned long long>(count));
    atomicAdd(reinterpret_cast<unsigned long long*>(a + kMaxBuckets),
              s.sum[j]);
    atomicMin(a + 2 * kMaxBuckets, s.min[j]);
    atomicMax(a + 3 * kMaxBuckets, s.max[j]);
  }

  // the last block: acc's part of this call to out, then back to the
  // identity, the ticket to 0
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int total = (1 + 4 * ncols) * nb;
  for (int j = threadIdx.x; j < total; j += kThreads) {
    const int q = j / nb, b = j - q * nb;  // 0: rows; 1 + 4 c + part
    const int part = (q - 1) & 3;
    long long* a = acc + static_cast<long long>(q) * kMaxBuckets + b;
    out[j] = __ldcg(a);
    *a = q == 0 || part < 2 ? 0 : part == 2 ? LLONG_MAX : LLONG_MIN;
  }
  if (threadIdx.x == 0) *ticket = 0;
}

size_t smem_bytes(int nb, int ncols) {
  return static_cast<size_t>(nb) * (28u * ncols + 4u);
}

// The resident blocks an SM of dense_agg_kernel<K> at `smem` bytes:
// the shared-size attribute set once to the budget, the occupancy query
// asked once for each size (a few sizes a process), the SM count once a
// device.
template <typename K>
int resident(size_t smem, int* blocks) {
  static bool attribute = false;
  constexpr int kSizes = 32;
  static size_t sizes[kSizes];
  static int per_sm[kSizes];
  static int known = 0;
  cudaError_t err;
  if (!attribute) {
    err = cudaFuncSetAttribute(dense_agg_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBudget);
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute = true;
  }
  int found = -1;
  for (int q = 0; q < known; ++q) {
    if (sizes[q] == smem) found = per_sm[q];
  }
  if (found < 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &found, dense_agg_kernel<K>, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found < 1) found = 1;
    if (known < kSizes) {
      sizes[known] = smem;
      per_sm[known] = found;
      known = known + 1;
    }
  }
  constexpr int kDevices = 64;
  static int sms[kDevices] = {};
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess)
    return static_cast<int>(err);
  int count = dev < kDevices ? sms[dev] : 0;
  if (count == 0) {
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) sms[dev] = count;
  }
  *blocks = found * count;
  return 0;
}

template <typename K>
int launch(const void* key, const void* key_valid, const void* kmin, int off,
           int nb, int64_t n, int ncols, const Cols& cols, void* acc,
           void* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(nb, ncols);
  if (smem > static_cast<size_t>(kSmemBudget))
    return static_cast<int>(cudaErrorInvalidValue);
  int most = 0;
  const int err = resident<K>(smem, &most);
  if (err != 0) return err;
  const int64_t want = (n + kThreads * kRows - 1) / (kThreads * kRows);
  const unsigned blocks =
      static_cast<unsigned>(want < 1 ? 1 : want < most ? want : most);
  long long* a = static_cast<long long*>(acc);
  dense_agg_kernel<K><<<blocks, kThreads, smem, stream>>>(
      static_cast<const K*>(key), static_cast<const uint8_t*>(key_valid),
      static_cast<const long long*>(kmin), off, nb, n, ncols, cols, a,
      reinterpret_cast<unsigned*>(a + kAccRows * kMaxBuckets),
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

int launch_key(int key_code, const void* key, const void* key_valid,
               const void* kmin, int off, int nb, int64_t n, int ncols,
               const Cols& cols, void* acc, void* out, cudaStream_t s) {
  switch (key_code) {
    case kI8:
      return launch<int8_t>(key, key_valid, kmin, off, nb, n, ncols, cols,
                          acc, out, s);
    case kI16:
      return launch<int16_t>(key, key_valid, kmin, off, nb, n, ncols, cols,
                           acc, out, s);
    case kI32:
      return launch<int32_t>(key, key_valid, kmin, off, nb, n, ncols, cols,
                           acc, out, s);
    case kU8:
      return launch<uint8_t>(key, key_valid, kmin, off, nb, n, ncols, cols,
                           acc, out, s);
    case kU16:
      return launch<uint16_t>(key, key_valid, kmin, off, nb, n, ncols, cols,
                            acc, out, s);
    case kU32:
      return launch<uint32_t>(key, key_valid, kmin, off, nb, n, ncols, cols,
                            acc, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int arrowtpu_dense_agg_max_cols() { return kMaxCols; }

int arrowtpu_dense_agg_max_buckets() { return kMaxBuckets; }

// int64 words of the accumulator a caller keeps per device and stream:
// kAccRows x kMaxBuckets, then one word whose low half is the ticket.
int arrowtpu_dense_agg_acc_words() { return kAccRows * kMaxBuckets + 1; }

// key: n elements of type key_code (int8/16/32 or uint8/16/32), key_valid
// its LSB bitmap or null; kmin: one int64 of device memory; values /
// validity / codes: host arrays of ncols (0..kMaxCols) device pointers,
// bitmaps (or null) and type codes; acc: arrowtpu_dense_agg_acc_words()
// int64 of device memory, the identity and a zero ticket before the first
// call (the kernel leaves it so); out: (1 + 4 ncols, nb) int64 of device
// memory, written in full.
int arrowtpu_dense_agg(int key_code, const void* key, const void* key_valid,
                       const void* kmin, int off, int nb, int64_t n,
                       int ncols, const void* const* values,
                       const void* const* validity, const int* codes,
                       void* acc, void* out, void* stream) {
  if (nb < 1 || nb > kMaxBuckets || ncols < 0 || ncols > kMaxCols || n < 0 ||
      (off != 0 && off != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Cols cols{};
  for (int c = 0; c < ncols; ++c) {
    if (codes[c] < kI8 || codes[c] > kU32)
      return static_cast<int>(cudaErrorInvalidValue);
    cols.values[c] = values[c];
    cols.validity[c] = static_cast<const uint8_t*>(validity[c]);
    cols.code[c] = codes[c];
  }
  return launch_key(key_code, key, key_valid, kmin, off, nb, n, ncols, cols,
                    acc, out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
