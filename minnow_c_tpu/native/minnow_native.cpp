// Native host-side kernels for minnow_c_tpu.
//
// The device owns the array math (quantization, binning, bitpacking); this
// library owns the byte-granular, inherently sequential host stages:
//
//   * mnw_checksum      -- BSD-style rotating checksum over a byte stream
//                          (reference util.c:438-445; init value is a
//                          parameter so both the code's init=1 and the
//                          spec's init=0xff are expressible).
//   * mnw_lz4_*         -- an LZ4 *block format* codec written from the
//                          public format description (token byte with
//                          4-bit literal/match length nibbles, 255-byte
//                          length extensions, 2-byte little-endian match
//                          offsets, min-match 4, trailing literal rules).
//                          This replaces the reference's vendored lz4
//                          submodule (Makefile:92-93) and is wire
//                          compatible with standard LZ4 block streams.
//
// Parallelism: functions are pure and thread-safe; callers fan out across
// independent fields/blocks (the segment model's decomposition unit) from
// Python threads -- ctypes releases the GIL during calls.
//
// Build: see native/Makefile (g++ -O3 -shared).

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Checksum
// ---------------------------------------------------------------------------

uint32_t mnw_checksum(const uint8_t *data, int64_t len, uint32_t init) {
  uint32_t c = init;
  for (int64_t i = 0; i < len; i++) {
    c = (c >> 1) + ((c & 1u) << 31);
    c += (uint32_t)data[i];
  }
  return c;
}

// ---------------------------------------------------------------------------
// LZ4 block codec
// ---------------------------------------------------------------------------

// Worst case size for an incompressible input (matches the classic
// LZ4_compressBound formula so buffers interoperate with other LZ4 users).
int32_t mnw_lz4_compress_bound(int32_t n) {
  if (n < 0 || n > 0x7E000000) return 0;
  return n + n / 255 + 16;
}

namespace {

constexpr int kMinMatch = 4;
constexpr int kHashLog = 16;
constexpr int kMaxOffset = 65535;
// Format rules: the last 5 bytes are always literals; a match may not start
// within the last 12 bytes of the block.
constexpr int kLastLiterals = 5;
constexpr int kMatchEndGuard = 12;

static inline uint32_t read32(const uint8_t *p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

static inline uint32_t hash4(uint32_t v) {
  return (v * 2654435761u) >> (32 - kHashLog);
}

static inline uint64_t read64(const uint8_t *p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

}  // namespace

// Compress src[0..src_len) into dst (capacity dst_cap, which must be at
// least mnw_lz4_compress_bound(src_len)).  Returns compressed size, or 0 on
// failure.  accel >= 1 trades ratio for speed like LZ4_compress_fast.
int32_t mnw_lz4_compress(const uint8_t *src, int32_t src_len, uint8_t *dst,
                         int32_t dst_cap, int32_t accel) {
  // Oversize inputs make compress_bound return 0, which would pass the
  // dst_cap guard for ANY capacity -- reject them explicitly.
  if (src_len < 0 || src_len > 0x7E000000) return 0;
  if (dst_cap < mnw_lz4_compress_bound(src_len)) return 0;
  if (accel < 1) accel = 1;

  uint8_t *op = dst;
  const uint8_t *ip = src;
  const uint8_t *anchor = src;
  const uint8_t *const iend = src + src_len;
  const uint8_t *const match_limit = iend - kLastLiterals;
  const uint8_t *const mf_limit = iend - kMatchEndGuard;

  int32_t table[1 << kHashLog];
  for (int i = 0; i < (1 << kHashLog); i++) table[i] = -1;

  auto emit_sequence = [&](const uint8_t *lit_start, int lit_len,
                           int match_off, int match_len) {
    uint8_t *token = op++;
    // Literal length.
    if (lit_len >= 15) {
      *token = (uint8_t)(15 << 4);
      int rem = lit_len - 15;
      while (rem >= 255) {
        *op++ = 255;
        rem -= 255;
      }
      *op++ = (uint8_t)rem;
    } else {
      *token = (uint8_t)(lit_len << 4);
    }
    std::memcpy(op, lit_start, (size_t)lit_len);
    op += lit_len;
    if (match_len == 0) return;  // final literals-only sequence
    // Offset.
    *op++ = (uint8_t)(match_off & 0xff);
    *op++ = (uint8_t)(match_off >> 8);
    // Match length (stored as len - 4).
    int ml = match_len - kMinMatch;
    if (ml >= 15) {
      *token |= 15;
      ml -= 15;
      while (ml >= 255) {
        *op++ = 255;
        ml -= 255;
      }
      *op++ = (uint8_t)ml;
    } else {
      *token |= (uint8_t)ml;
    }
  };

  if (src_len >= kMatchEndGuard + 1) {
    int step_base = accel << 6;  // skip-acceleration like LZ4_fast
    int search_steps = step_base;
    ip++;
    while (ip <= mf_limit) {
      uint32_t h = hash4(read32(ip));
      int32_t cand = table[h];
      table[h] = (int32_t)(ip - src);
      if (cand >= 0 && (ip - src) - cand <= kMaxOffset &&
          read32(src + cand) == read32(ip)) {
        // Extend match backwards over pending literals.
        const uint8_t *match = src + cand;
        while (ip > anchor && match > src && ip[-1] == match[-1]) {
          ip--;
          match--;
        }
        // Extend forwards, 8 bytes at a time.
        const uint8_t *mp = match + kMinMatch;
        const uint8_t *cp = ip + kMinMatch;
        while (cp + 8 <= match_limit) {
          uint64_t diff = read64(cp) ^ read64(mp);
          if (diff) {
            cp += __builtin_ctzll(diff) >> 3;
            goto extended;
          }
          cp += 8;
          mp += 8;
        }
        while (cp < match_limit && *cp == *mp) {
          cp++;
          mp++;
        }
      extended:;
        int match_len = (int)(cp - ip);
        emit_sequence(anchor, (int)(ip - anchor), (int)(ip - match),
                      match_len);
        ip = cp;
        anchor = ip;
        search_steps = step_base;
        // Insert a position inside the match to improve later finds.
        if (ip <= mf_limit) {
          table[hash4(read32(ip - 2))] = (int32_t)(ip - 2 - src);
        }
      } else {
        ip += (search_steps++ >> 6);
      }
    }
  }

  // Final literals.
  emit_sequence(anchor, (int)(iend - anchor), 0, 0);
  return (int32_t)(op - dst);
}

// Decompress exactly dst_len bytes from src[0..src_len).  Returns the number
// of source bytes consumed, or -1 on malformed input.
int32_t mnw_lz4_decompress(const uint8_t *src, int32_t src_len, uint8_t *dst,
                           int32_t dst_len) {
  const uint8_t *ip = src;
  const uint8_t *const iend = src + src_len;
  uint8_t *op = dst;
  uint8_t *const oend = dst + dst_len;

  while (ip < iend) {
    uint32_t token = *ip++;
    // Literals.  Lengths accumulate in int64: crafted runs of 0xff
    // extension bytes overflow int32 (UB) and would bypass the bounds
    // checks below (a ~8 MB malicious block reached memcpy with a
    // negative length).  Compare against remaining space, never via
    // pointer arithmetic that could overflow.
    int64_t lit_len = (int64_t)(token >> 4);
    if (lit_len == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit_len += b;
      } while (b == 255);
    }
    if (lit_len > (int64_t)(iend - ip) || lit_len > (int64_t)(oend - op))
      return -1;
    std::memcpy(op, ip, (size_t)lit_len);
    ip += lit_len;
    op += lit_len;
    if (op == oend) return (int32_t)(ip - src);  // final sequence
    // Match.
    if (ip + 2 > iend) return -1;
    int offset = (int)ip[0] | ((int)ip[1] << 8);
    ip += 2;
    if (offset == 0 || op - dst < offset) return -1;
    int64_t match_len = (int64_t)(token & 15);
    if (match_len == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        match_len += b;
      } while (b == 255);
    }
    match_len += kMinMatch;
    if (match_len > (int64_t)(oend - op)) return -1;
    const uint8_t *match = op - offset;
    if (offset >= 8) {
      // Non-overlapping (or far enough) -- copy in chunks.
      int64_t n = match_len;
      while (n >= 8) {
        std::memcpy(op, match, 8);
        op += 8;
        match += 8;
        n -= 8;
      }
      while (n-- > 0) *op++ = *match++;
    } else {
      // Overlapping short-offset match (RLE-like).  Materialize a whole
      // number of pattern periods >= 8 bytes, then copy with that period
      // multiple as the stride (>= 8, so 8-byte chunk copies are safe and
      // preserve the periodicity).
      int rep = offset;
      while (rep < 8) rep += offset;
      int head = match_len < rep ? match_len : rep;
      int written = 0;
      while (written < head) {
        int chunk = offset < head - written ? offset : head - written;
        std::memcpy(op + written, match, (size_t)chunk);
        written += chunk;
      }
      if (match_len > head) {
        int n = match_len - head;
        const uint8_t *srcp = op;
        uint8_t *dstp = op + rep;
        while (n >= 8) {
          std::memcpy(dstp, srcp, 8);
          dstp += 8;
          srcp += 8;
          n -= 8;
        }
        while (n-- > 0) *dstp++ = *srcp++;
      }
      op += match_len;
    }
  }
  return (op == oend) ? (int32_t)(ip - src) : -1;
}

// ---------------------------------------------------------------------------
// Host-side uniform bitpack reference (bit-exact oracle for the device pack,
// mirrors util_U32UniformPack / UndoUniformPack semantics).
// ---------------------------------------------------------------------------

void mnw_uniform_pack(const uint32_t *x, int32_t n, int32_t width,
                      uint32_t *out, int32_t out_words) {
  for (int32_t i = 0; i < out_words; i++) out[i] = 0;
  if (width <= 0 || width > 32 || n == 0) return;
  if (width == 32) {
    int32_t avail = n < out_words ? n : out_words;
    std::memcpy(out, x, (size_t)(avail < 0 ? 0 : avail) * 4);
    return;
  }
  uint32_t mask = (1u << width) - 1u;
  for (int32_t i = 0; i < n; i++) {
    uint64_t start = (uint64_t)width * (uint64_t)i;
    uint64_t v = (uint64_t)(x[i] & mask) << (start & 31);
    int64_t w = (int64_t)(start >> 5);
    out[w] |= (uint32_t)(v & 0xffffffffu);
    uint32_t hi = (uint32_t)(v >> 32);
    if (hi && w + 1 < out_words) out[w + 1] |= hi;
  }
}

void mnw_uniform_unpack(const uint32_t *x, int32_t n_words, int32_t width,
                        uint32_t *out, int32_t n) {
  if (width <= 0 || width > 32) {
    for (int32_t i = 0; i < n; i++) out[i] = 0;
    return;
  }
  if (width == 32) {
    // Honor n_words: a header advertising more elements than the blob
    // holds must not read past the input.
    int32_t avail = n < n_words ? n : n_words;
    std::memcpy(out, x, (size_t)(avail < 0 ? 0 : avail) * 4);
    for (int32_t i = avail; i < n; i++) out[i] = 0;
    return;
  }
  uint32_t mask = (1u << width) - 1u;
  for (int32_t i = 0; i < n; i++) {
    uint64_t start = (uint64_t)width * (uint64_t)i;
    int64_t w = (int64_t)(start >> 5);
    uint64_t window = (w < n_words) ? (uint64_t)x[w] : 0;
    if (w + 1 < n_words) window |= (uint64_t)x[w + 1] << 32;
    out[i] = (uint32_t)((window >> (start & 31)) & mask);
  }
}

}  // extern "C"
