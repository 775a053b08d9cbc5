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
// Design (a simple one): a grid-stride loop over the rows; each block
// keeps its nb buckets of every column in shared memory and updates them
// with shared-memory atomics (32-bit adds for the counts, 64-bit add, min
// and max for the rest; a min or max is skipped when the bucket's current
// value already beats the row's, which after the first rows is nearly
// always), then flushes its non-empty buckets into the output with global
// atomics.  Integer results do not depend on the order in which the
// atomics land, so the kernel is bit-exact against its plain version
// (kernels/dense_agg.py dense_aggregate_plain), run after run.
//
// Bound on the card: bytes.  It reads each key and value once (config 4:
// n x (4 + 8) bytes, 96 MB at 8M rows, 0.029 ms at 3.35 TB/s) and writes
// (1 + 4 C) x nb int64.  At a low cardinality every warp's 32 rows fall on
// few buckets and their shared atomics serialise; aggregating equal
// buckets inside a warp first (__match_any_sync) is the next step if the
// measured time says so.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 8;       // value columns per launch
constexpr int kMaxBuckets = 4096;

// element types of the key and value columns
enum Code : int { kI8 = 0, kI16, kI32, kI64, kU8, kU16, kU32 };

struct Cols {
  const void* values[kMaxCols];
  const uint8_t* validity[kMaxCols];  // LSB bitmaps, or null: all valid
  int code[kMaxCols];
};

__device__ __forceinline__ long long load_int(const void* p, int code,
                                              long long i) {
  switch (code) {
    case kI8: return static_cast<const int8_t*>(p)[i];
    case kI16: return static_cast<const int16_t*>(p)[i];
    case kI32: return static_cast<const int32_t*>(p)[i];
    case kI64: return static_cast<const long long*>(p)[i];
    case kU8: return static_cast<const uint8_t*>(p)[i];
    case kU16: return static_cast<const uint16_t*>(p)[i];
    default: return static_cast<const uint32_t*>(p)[i];
  }
}

__device__ __forceinline__ bool bit(const uint8_t* bitmap, long long i) {
  return (bitmap[i >> 3] >> (i & 7)) & 1;
}

// out: (1 + 4 ncols, nb) int64: the rows present, then per column its
// count, sum, min and max.
__global__ void dense_agg_init_kernel(long long* out, int nb, int ncols) {
  const int total = (1 + 4 * ncols) * nb;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < total;
       j += gridDim.x * blockDim.x) {
    const int q = j / nb;  // 0: rows; then 1 + 4 c + {count, sum, min, max}
    const int part = (q - 1) & 3;
    out[j] = q == 0 || part < 2 ? 0 : part == 2 ? LLONG_MAX : LLONG_MIN;
  }
}

template <typename K>
__global__ void __launch_bounds__(kThreads) dense_agg_kernel(
    const K* __restrict__ key, const uint8_t* __restrict__ key_valid,
    const long long* __restrict__ kmin_p, int off, int nb, long long n,
    int ncols, Cols cols, int count_rows, long long* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  const int cn = ncols * nb;
  unsigned long long* s_sum = smem;
  long long* s_min = reinterpret_cast<long long*>(smem + cn);
  long long* s_max = s_min + cn;
  unsigned* s_cnt = reinterpret_cast<unsigned*>(s_max + cn);
  unsigned* s_rows = s_cnt + cn;
  for (int j = threadIdx.x; j < cn; j += blockDim.x) {
    s_sum[j] = 0;
    s_min[j] = LLONG_MAX;
    s_max[j] = LLONG_MIN;
    s_cnt[j] = 0;
  }
  for (int j = threadIdx.x; j < nb; j += blockDim.x) s_rows[j] = 0;
  __syncthreads();

  const long long kmin = *kmin_p;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long b = key_valid != nullptr && !bit(key_valid, i)
                            ? 0
                            : static_cast<long long>(key[i]) - kmin + off;
    if (b < 0 || b >= nb) continue;
    if (count_rows) atomicAdd(&s_rows[b], 1u);
    for (int c = 0; c < ncols; ++c) {
      if (cols.validity[c] != nullptr && !bit(cols.validity[c], i)) continue;
      const long long v = load_int(cols.values[c], cols.code[c], i);
      const int j = c * nb + static_cast<int>(b);
      atomicAdd(&s_cnt[j], 1u);
      atomicAdd(&s_sum[j], static_cast<unsigned long long>(v));
      // a volatile 64-bit load is one access (no torn value), and the
      // bucket's min only falls and its max only rises, so a row that
      // does not beat what it reads cannot change the result
      if (v < *static_cast<volatile long long*>(&s_min[j]))
        atomicMin(&s_min[j], v);
      if (v > *static_cast<volatile long long*>(&s_max[j]))
        atomicMax(&s_max[j], v);
    }
  }
  __syncthreads();

  if (count_rows) {
    for (int j = threadIdx.x; j < nb; j += blockDim.x)
      if (s_rows[j] != 0)
        atomicAdd(reinterpret_cast<unsigned long long*>(out) + j,
                  static_cast<unsigned long long>(s_rows[j]));
  }
  for (int j = threadIdx.x; j < cn; j += blockDim.x) {
    if (s_cnt[j] == 0) continue;
    const int c = j / nb, b = j - c * nb;
    long long* o = out + static_cast<long long>(1 + 4 * c) * nb + b;
    atomicAdd(reinterpret_cast<unsigned long long*>(o),
              static_cast<unsigned long long>(s_cnt[j]));
    atomicAdd(reinterpret_cast<unsigned long long*>(o + nb), s_sum[j]);
    atomicMin(o + 2 * nb, s_min[j]);
    atomicMax(o + 3 * nb, s_max[j]);
  }
}

size_t smem_bytes(int nb, int ncols) {
  return static_cast<size_t>(nb) * (28u * ncols + 4u);
}

template <typename K>
int launch(const void* key, const void* key_valid, const void* kmin, int off,
           int nb, int64_t n, int ncols, const Cols& cols, int count_rows,
           void* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(nb, ncols);
  cudaError_t err = cudaFuncSetAttribute(
      dense_agg_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, dense_agg_kernel<K>, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t most = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks =
      static_cast<unsigned>(want < 1 ? 1 : want < most ? want : most);
  const int total = (1 + 4 * ncols) * nb;
  dense_agg_init_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(static_cast<long long*>(out), nb, ncols);
  dense_agg_kernel<K><<<blocks, kThreads, smem, stream>>>(
      static_cast<const K*>(key), static_cast<const uint8_t*>(key_valid),
      static_cast<const long long*>(kmin), off, nb, n, ncols, cols,
      count_rows, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int arrowtpu_dense_agg_max_cols() { return kMaxCols; }

int arrowtpu_dense_agg_max_buckets() { return kMaxBuckets; }

// key: n elements of type key_code (int8/16/32 or uint8/16/32), key_valid
// its LSB bitmap or null; kmin: one int64 of device memory; values /
// validity / codes: host arrays of ncols (0..kMaxCols) device pointers,
// bitmaps (or null) and type codes; out: (1 + 4 ncols, nb) int64 of device
// memory, initialised here on the stream (rows, counts and sums 0, mins
// INT64_MAX, maxes INT64_MIN).  count_rows 0 leaves row 0 at zero (a second
// launch over more columns of the same key).
int arrowtpu_dense_agg(int key_code, const void* key, const void* key_valid,
                       const void* kmin, int off, int nb, int64_t n,
                       int ncols, const void* const* values,
                       const void* const* validity, const int* codes,
                       int count_rows, void* out, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_code) {
    case kI8:
      return launch<int8_t>(key, key_valid, kmin, off, nb, n, ncols, cols,
                            count_rows, out, s);
    case kI16:
      return launch<int16_t>(key, key_valid, kmin, off, nb, n, ncols, cols,
                             count_rows, out, s);
    case kI32:
      return launch<int32_t>(key, key_valid, kmin, off, nb, n, ncols, cols,
                             count_rows, out, s);
    case kU8:
      return launch<uint8_t>(key, key_valid, kmin, off, nb, n, ncols, cols,
                             count_rows, out, s);
    case kU16:
      return launch<uint16_t>(key, key_valid, kmin, off, nb, n, ncols, cols,
                              count_rows, out, s);
    case kU32:
      return launch<uint32_t>(key, key_valid, kmin, off, nb, n, ncols, cols,
                              count_rows, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
