// Avro block decoder for flat records: one native pass over a decoded
// OCF block, writing per-field typed buffers (the columnar counterpart
// of arrow-rs's arrow-avro/src/reader/record.rs; implemented from
// the Avro 1.11 binary-encoding spec, not translated).
//
// Supports: null, boolean, int, long, float, double, bytes, string,
// fixed(N), and two-branch unions [null, X] / [X, null].  The Python
// layer falls back to the per-row decoder for anything else.

#include <cstdint>
#include <cstring>

namespace {

enum FType {
  T_NULL = 0,
  T_BOOL = 1,
  T_INT = 2,
  T_LONG = 3,
  T_FLOAT = 4,
  T_DOUBLE = 5,
  T_BYTES = 6,
  T_STRING = 7,
  T_FIXED = 8,
};

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  int64_t read_long() {
    uint64_t v = 0;
    int shift = 0;
    while (true) {
      if (p >= end || shift > 63) {
        ok = false;
        return 0;
      }
      uint8_t b = *p++;
      v |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
    }
    return static_cast<int64_t>((v >> 1) ^ (~(v & 1) + 1));  // unzigzag
  }
};

}  // namespace

extern "C" {

// fdesc: nfields * 4 int32s: [type, nullable, null_branch, fixed_size]
// out_vals / out_lens / out_valid: row-major (nrows x nfields)
// Returns bytes consumed; -1 on parse error; -2 on arena overflow.
int64_t arrowtpu_avro_decode_block(
    const uint8_t* buf, int64_t len, int64_t nrows, const int32_t* fdesc,
    int32_t nfields, int64_t* out_vals, int64_t* out_lens,
    uint8_t* out_valid, uint8_t* arena, int64_t arena_cap,
    int64_t* arena_used_out, uint32_t* out_views) {
  Cursor c{buf, buf + len};
  int64_t arena_used = 0;
  for (int64_t r = 0; r < nrows; ++r) {
    for (int32_t f = 0; f < nfields; ++f) {
      const int32_t* d = fdesc + 4 * f;
      int32_t type = d[0];
      bool valid = true;
      if (d[1]) {  // nullable union [null, X] or [X, null]
        int64_t branch = c.read_long();
        if (!c.ok) return -1;
        if (branch == d[2]) valid = false;
        else if (branch != (d[2] ^ 1)) return -1;
      }
      int64_t idx = r * nfields + f;
      out_valid[idx] = valid ? 1 : 0;
      if (!valid) {
        out_vals[idx] = 0;
        out_lens[idx] = 0;
        continue;
      }
      switch (type) {
        case T_NULL:
          out_vals[idx] = 0;
          break;
        case T_BOOL: {
          if (c.p >= c.end) return -1;
          out_vals[idx] = *c.p++ ? 1 : 0;
          break;
        }
        case T_INT:
        case T_LONG: {
          out_vals[idx] = c.read_long();
          if (!c.ok) return -1;
          break;
        }
        case T_FLOAT: {
          if (c.p + 4 > c.end) return -1;
          uint32_t v;
          std::memcpy(&v, c.p, 4);
          c.p += 4;
          out_vals[idx] = static_cast<int64_t>(v);
          break;
        }
        case T_DOUBLE: {
          if (c.p + 8 > c.end) return -1;
          uint64_t v;
          std::memcpy(&v, c.p, 8);
          c.p += 8;
          out_vals[idx] = static_cast<int64_t>(v);
          break;
        }
        case T_BYTES:
        case T_STRING:
        case T_FIXED: {
          int64_t n = (type == T_FIXED) ? d[3] : c.read_long();
          if (!c.ok || n < 0 || c.p + n > c.end) return -1;
          if (arena_used + n > arena_cap) return -2;
          std::memcpy(arena + arena_used, c.p, n);
          // emit the Arrow byte-view word directly (len, prefix,
          // inline-tail | buffer_index, inline-tail | offset)
          uint32_t* w = out_views + 4 * idx;
          w[0] = static_cast<uint32_t>(n);
          uint8_t tmp[12] = {0};
          std::memcpy(tmp, c.p, n < 12 ? n : 12);
          std::memcpy(&w[1], tmp, 4);
          if (n <= 12) {
            std::memcpy(&w[2], tmp + 4, 8);
          } else {
            w[2] = 0;
            w[3] = static_cast<uint32_t>(arena_used);
          }
          c.p += n;
          out_vals[idx] = arena_used;
          out_lens[idx] = n;
          arena_used += n;
          break;
        }
        default:
          return -1;
      }
    }
  }
  *arena_used_out = arena_used;
  return c.p - buf;
}

}  // extern "C"
