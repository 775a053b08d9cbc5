// Nested Avro block decoder: one native pass over a decoded OCF block,
// writing per-NODE columnar buffers for an arbitrary schema tree of
// records / arrays / maps / enums / nullable unions / primitives (the
// columnar counterpart of arrow-rs's arrow-avro/src/reader/
// record.rs's resolved-record decoder; implemented from the Avro 1.11
// binary-encoding spec, not translated).
//
// The schema compiles to a node table (7 int32s per node):
//   [0] type        (FType below)
//   [1] nullable    (wrapped in a two-branch [null, X] union)
//   [2] null_branch (which union branch is null)
//   [3] fixed_size  (T_FIXED byte width)
//   [4] nchildren   (record: fields; array: 1; map: 2 [key, value])
//   [5] child_off   (offset into the flat child_idx table; the node's
//                    children are child_idx[child_off .. +nchildren))
//   [6] reserved
//
// Per node the caller provides flat output buffers sized by `caps`:
//   vals[node]  int64  — primitive storage (bits for float/double)
//   views[node] u32x4  — byte-view words for bytes/string/fixed
//   valid[node] u8     — occurrence validity
//   lens[node]  int32  — per-occurrence element count (array/map)
// counts[node] returns the number of occurrences appended.  A null
// record occurrence appends one null occurrence to every descendant so
// struct children stay 1:1 with their parent (arrow struct layout).
//
// Returns bytes consumed, -1 on malformed input, -2 when any cap or the
// arena would overflow (caller doubles and retries).

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
  T_RECORD = 9,
  T_ARRAY = 10,
  T_MAP = 11,
  T_ENUM = 12,
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
    return static_cast<int64_t>((v >> 1) ^ (~(v & 1) + 1));
  }
};

struct Ctx {
  Cursor c;
  const int32_t* desc;
  const int32_t* child_idx;
  int64_t** vals;
  uint32_t** views;
  uint8_t** valid;
  int32_t** lens;
  int64_t* counts;
  const int64_t* caps;
  uint8_t* arena;
  int64_t arena_cap;
  int64_t arena_used = 0;
  int rc = 0;  // 0 ok, -1 malformed, -2 overflow

  // append one null occurrence to node and every descendant (keeps
  // struct children aligned with their parent)
  void append_null(int32_t node) {
    const int32_t* d = desc + 7 * node;
    int64_t i = counts[node];
    if (i >= caps[node]) {
      rc = -2;
      return;
    }
    valid[node][i] = 0;
    if (vals[node]) vals[node][i] = 0;
    if (views[node]) std::memset(views[node] + 4 * i, 0, 16);
    if (lens[node]) lens[node][i] = 0;
    counts[node] = i + 1;
    if (d[0] == T_RECORD) {
      for (int32_t k = 0; k < d[4]; ++k) append_null(child_idx[d[5] + k]);
    }
    // array/map children get no occurrences for a null (length 0)
  }

  void decode(int32_t node) {
    if (rc) return;
    const int32_t* d = desc + 7 * node;
    if (d[1]) {
      int64_t branch = c.read_long();
      if (!c.ok) {
        rc = -1;
        return;
      }
      if (branch == d[2]) {
        append_null(node);
        return;
      }
      if (branch != (d[2] ^ 1)) {
        rc = -1;
        return;
      }
    }
    int64_t i = counts[node];
    if (i >= caps[node]) {
      rc = -2;
      return;
    }
    switch (d[0]) {
      case T_RECORD: {
        valid[node][i] = 1;
        counts[node] = i + 1;
        for (int32_t k = 0; k < d[4] && !rc; ++k)
          decode(child_idx[d[5] + k]);
        return;
      }
      case T_ARRAY:
      case T_MAP: {
        valid[node][i] = 1;
        counts[node] = i + 1;
        int64_t total = 0;
        while (!rc) {
          int64_t n = c.read_long();
          if (!c.ok) {
            rc = -1;
            return;
          }
          if (n == 0) break;
          if (n < 0) {  // block byte size follows; skip it
            c.read_long();
            if (!c.ok) {
              rc = -1;
              return;
            }
            n = -n;
          }
          for (int64_t k = 0; k < n && !rc; ++k) {
            if (d[0] == T_MAP) {
              decode(child_idx[d[5]]);      // key (string leaf)
              decode(child_idx[d[5] + 1]);  // value
            } else {
              decode(child_idx[d[5]]);
            }
          }
          total += n;
        }
        lens[node][i] = static_cast<int32_t>(total);
        return;
      }
      case T_NULL:
        valid[node][i] = 1;
        vals[node][i] = 0;
        counts[node] = i + 1;
        return;
      case T_BOOL: {
        if (c.p >= c.end) {
          rc = -1;
          return;
        }
        valid[node][i] = 1;
        vals[node][i] = *c.p++ ? 1 : 0;
        counts[node] = i + 1;
        return;
      }
      case T_INT:
      case T_LONG:
      case T_ENUM: {
        int64_t v = c.read_long();
        if (!c.ok) {
          rc = -1;
          return;
        }
        valid[node][i] = 1;
        vals[node][i] = v;
        counts[node] = i + 1;
        return;
      }
      case T_FLOAT: {
        if (c.p + 4 > c.end) {
          rc = -1;
          return;
        }
        uint32_t v;
        std::memcpy(&v, c.p, 4);
        c.p += 4;
        valid[node][i] = 1;
        vals[node][i] = static_cast<int64_t>(v);
        counts[node] = i + 1;
        return;
      }
      case T_DOUBLE: {
        if (c.p + 8 > c.end) {
          rc = -1;
          return;
        }
        uint64_t v;
        std::memcpy(&v, c.p, 8);
        c.p += 8;
        valid[node][i] = 1;
        vals[node][i] = static_cast<int64_t>(v);
        counts[node] = i + 1;
        return;
      }
      case T_BYTES:
      case T_STRING:
      case T_FIXED: {
        int64_t n = (d[0] == T_FIXED) ? d[3] : c.read_long();
        if (!c.ok || n < 0 || c.p + n > c.end) {
          rc = -1;
          return;
        }
        if (arena_used + n > arena_cap) {
          rc = -2;
          return;
        }
        std::memcpy(arena + arena_used, c.p, n);
        uint32_t* w = views[node] + 4 * i;
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
        valid[node][i] = 1;
        vals[node][i] = n;  // byte length (len_bound computation)
        c.p += n;
        arena_used += n;
        counts[node] = i + 1;
        return;
      }
      default:
        rc = -1;
    }
  }
};

}  // namespace

extern "C" {

int64_t arrowtpu_avro_decode_nested(
    const uint8_t* buf, int64_t len, int64_t nrows, const int32_t* desc,
    int32_t nnodes, const int32_t* child_idx, int64_t** vals,
    uint32_t** views, uint8_t** valid, int32_t** lens, int64_t* counts,
    const int64_t* caps, uint8_t* arena, int64_t arena_cap,
    int64_t* arena_used_out) {
  (void)nnodes;
  Ctx ctx{Cursor{buf, buf + len}, desc, child_idx, vals,  views, valid,
          lens,                   counts, caps,    arena, arena_cap};
  for (int64_t r = 0; r < nrows; ++r) {
    ctx.decode(0);
    if (ctx.rc) return ctx.rc;
  }
  *arena_used_out = ctx.arena_used;
  return ctx.c.p - buf;
}

}  // extern "C"
