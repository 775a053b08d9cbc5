// Content-defined chunking boundaries for the Parquet writer
// (the FastCDC-inspired gearhash scheme of
// the reference's parquet/src/column/chunker/cdc.rs:88: per-byte
// rolling gear hash, min-size skip window, 8-consecutive-match
// central-limit normalization across distinct gear tables, max-size
// hard cap; implemented from the published algorithm, not translated).
//
// The gear tables are generated deterministically from splitmix64 —
// any fixed random table works; boundaries are then a pure function of
// the data and options, which is the property dedup needs.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kNumTables = 8;

uint64_t splitmix64(uint64_t& x) {
  x += 0x9E3779B97F4A7C15ULL;
  uint64_t z = x;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

struct Chunker {
  const uint64_t* tables;  // kNumTables * 256
  uint64_t mask;
  int64_t min_size, max_size;
  uint64_t rolling = 0;
  bool has_matched = false;
  int nth_run = 0;
  int64_t chunk_size = 0;

  inline void roll(const uint8_t* p, int64_t n) {
    chunk_size += n;
    if (chunk_size < min_size) return;
    const uint64_t* t = tables + 256 * nth_run;
    uint64_t h = rolling;
    bool m = has_matched;
    for (int64_t i = 0; i < n; ++i) {
      h = (h << 1) + t[p[i]];
      m = m || ((h & mask) == 0);
    }
    rolling = h;
    has_matched = m;
  }

  inline bool need_new_chunk() {
    if (has_matched) {
      has_matched = false;
      if (++nth_run >= kNumTables) {
        nth_run = 0;
        chunk_size = 0;
        return true;
      }
    }
    if (chunk_size >= max_size) {
      chunk_size = 0;
      return true;
    }
    return false;
  }
};

}  // namespace

extern "C" {

void arrowtpu_cdc_tables(uint64_t* out /* kNumTables*256 */) {
  uint64_t seed = 0x6172727774707565ULL;  // fixed: boundaries must be
                                          // stable across processes
  for (int i = 0; i < kNumTables * 256; ++i) out[i] = splitmix64(seed);
}

// data: concatenated per-row value bytes; row_off: (nrows+1) offsets.
// levels: optional per-row def level (rolled as little-endian i16).
// out_boundary[r] = 1 when a new chunk starts AFTER row r.
void arrowtpu_cdc_boundaries(
    const uint8_t* data, const int64_t* row_off, int64_t nrows,
    const uint8_t* levels, int has_levels, const uint64_t* tables,
    uint64_t mask, int64_t min_size, int64_t max_size,
    uint8_t* out_boundary) {
  Chunker c{tables, mask, min_size, max_size};
  for (int64_t r = 0; r < nrows; ++r) {
    if (has_levels) {
      uint8_t lv[2] = {levels[r], 0};
      c.roll(lv, 2);
    }
    c.roll(data + row_off[r], row_off[r + 1] - row_off[r]);
    out_boundary[r] = c.need_new_chunk() ? 1 : 0;
  }
}

}  // extern "C"
