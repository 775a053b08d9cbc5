// LZ4 *block* compressor: greedy hash-table matcher, implemented from the
// LZ4 Block Format spec (v1.6.1).  arrow-rs wraps the lz4_flex crate
// (arrow-ipc/src/compression.rs:142); this is a from-spec implementation,
// a copy of arrowtpu/native/src/lz4block.cpp for arrowtpu_torch's host
// helpers (formats/lz4.py).
//
// C ABI, so Python loads it with ctypes and needs no binding library.

#include <cstdint>
#include <cstring>

namespace {

constexpr int MINMATCH = 4;
constexpr int MFLIMIT = 12;   // last match must start >= 12 B before end
constexpr int LASTLITERALS = 5;  // final 5 bytes are always literals
constexpr int HASH_LOG = 16;
constexpr uint32_t HASH_SIZE = 1u << HASH_LOG;
constexpr uint32_t MAX_DISTANCE = 65535;

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash4(uint32_t v) {
  return (v * 2654435761u) >> (32 - HASH_LOG);
}

// write a literal-run / match-length with 255-extension bytes
inline uint8_t* write_length(uint8_t* op, int len) {
  while (len >= 255) {
    *op++ = 255;
    len -= 255;
  }
  *op++ = static_cast<uint8_t>(len);
  return op;
}

}  // namespace

extern "C" {

// Compress src[0..n) into dst (capacity dst_cap).  Returns the compressed
// size, or -1 if dst would overflow (caller then stores uncompressed).
int64_t arrowtpu_lz4_compress_block(const uint8_t* src, int64_t n,
                                    uint8_t* dst, int64_t dst_cap) {
  if (n < 0) return -1;
  uint8_t* op = dst;
  uint8_t* const op_end = dst + dst_cap;
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  const uint8_t* anchor = src;

  if (n >= MFLIMIT) {
    const uint8_t* const mflimit = iend - MFLIMIT;
    // position table; 0 means "empty" so skip offset 0 by storing pos+1
    static thread_local uint32_t table[HASH_SIZE];
    std::memset(table, 0, sizeof(table));

    while (ip <= mflimit) {
      uint32_t seq = read32(ip);
      uint32_t h = hash4(seq);
      uint32_t cand1 = table[h];
      uint64_t pos = static_cast<uint64_t>(ip - src);
      table[h] = static_cast<uint32_t>(pos + 1);
      if (cand1 != 0 && pos + 1 - cand1 <= MAX_DISTANCE &&
          read32(src + cand1 - 1) == seq) {
        const uint8_t* match = src + cand1 - 1;
        // extend match forward (bounded so the last 5 bytes stay literals)
        const uint8_t* const match_limit = iend - LASTLITERALS;
        const uint8_t* mp = match + MINMATCH;
        const uint8_t* cp = ip + MINMATCH;
        while (cp < match_limit && *cp == *mp) {
          ++cp;
          ++mp;
        }
        int match_len = static_cast<int>(cp - ip);
        int lit_len = static_cast<int>(ip - anchor);
        // worst-case space: token + lit extensions + literals + offset +
        // match extensions
        if (op + 1 + lit_len / 255 + 1 + lit_len + 2 + match_len / 255 + 1 >
            op_end)
          return -1;
        uint8_t* token = op++;
        int ml_code = match_len - MINMATCH;
        if (lit_len >= 15) {
          *token = 15 << 4;
          op = write_length(op, lit_len - 15);
        } else {
          *token = static_cast<uint8_t>(lit_len << 4);
        }
        std::memcpy(op, anchor, lit_len);
        op += lit_len;
        uint16_t offset = static_cast<uint16_t>(ip - match);
        *op++ = static_cast<uint8_t>(offset & 0xFF);
        *op++ = static_cast<uint8_t>(offset >> 8);
        if (ml_code >= 15) {
          *token |= 15;
          op = write_length(op, ml_code - 15);
        } else {
          *token |= static_cast<uint8_t>(ml_code);
        }
        ip += match_len;
        anchor = ip;
        // seed the table inside the match span (stride 2: cheap, helps
        // repetitive data) — positions only, correctness is unaffected
        for (const uint8_t* p = ip - match_len + 1;
             p + 4 <= ip && p <= mflimit; p += 2) {
          table[hash4(read32(p))] =
              static_cast<uint32_t>(p - src) + 1;
        }
      } else {
        ++ip;
      }
    }
  }

  // trailing literals
  int lit_len = static_cast<int>(iend - anchor);
  if (op + 1 + lit_len / 255 + 1 + lit_len > op_end) return -1;
  if (lit_len >= 15) {
    *op++ = 15 << 4;
    op = write_length(op, lit_len - 15);
  } else {
    *op++ = static_cast<uint8_t>(lit_len << 4);
  }
  std::memcpy(op, anchor, lit_len);
  op += lit_len;
  return op - dst;
}

}  // extern "C"
