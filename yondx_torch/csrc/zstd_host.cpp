// Host codecs for the port's checkpoint reader (yondx_torch/io/ocdbt.py):
// a Zstandard frame decoder written to RFC 8878, and CRC-32C.
//
// zstd_decompress decodes one buffer of concatenated zstd frames: the frame
// header (window descriptor, frame content size, checksum flag), raw, RLE
// and compressed blocks, the literals section (raw, RLE, Huffman with one or
// four streams, treeless), the sequences section (predefined, RLE,
// FSE-compressed and repeat tables, repeat offsets) and the XXH64 content
// checksum. A dictionary ID, a skippable frame, reserved fields or any
// inconsistency raise with a message naming the feature. No encoder: the
// port writes its checkpoints uncompressed.
//
// C interface (ctypes, yondx_torch/native.py):
//   long long zstd_decompress(const uint8_t* src, size_t n, uint8_t** out,
//                             char* err, int err_len)
//       -> decoded size (the buffer is malloc'd into *out; free it with
//          zstd_free), or -1 with a message in err.
//   void zstd_free(uint8_t* p)
//   uint32_t crc32c(const uint8_t* p, size_t n)
//   uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed)
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct ZError : std::runtime_error {
  explicit ZError(const std::string& m) : std::runtime_error(m) {}
};

[[noreturn]] void fail(const std::string& m) { throw ZError(m); }

inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }

// ----------------------------------------------------------------- XXH64
const uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
               P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
               P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t rd64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }
inline uint32_t rd32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl64(acc, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  acc ^= xround(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64_impl(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = seed + P5;
  }
  h += (uint64_t)n;
  while (p + 8 <= end) {
    h ^= xround(0, rd64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)rd32(p) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (uint64_t)(*p) * P5;
    h = rotl64(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------- CRC-32C
uint32_t crc_table[8][256];
bool crc_ready = false;

void crc_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
    crc_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      crc_table[t][i] = (crc_table[t - 1][i] >> 8) ^
                        crc_table[0][crc_table[t - 1][i] & 0xFF];
  crc_ready = true;
}

uint32_t crc32c_impl(const uint8_t* p, size_t n) {
  if (!crc_ready) crc_init();
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint64_t v = rd64(p) ^ c;
    c = crc_table[7][v & 0xFF] ^ crc_table[6][(v >> 8) & 0xFF] ^
        crc_table[5][(v >> 16) & 0xFF] ^ crc_table[4][(v >> 24) & 0xFF] ^
        crc_table[3][(v >> 32) & 0xFF] ^ crc_table[2][(v >> 40) & 0xFF] ^
        crc_table[1][(v >> 48) & 0xFF] ^ crc_table[0][v >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ crc_table[0][(c ^ *p++) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

// ------------------------------------------------------------- bitstreams
// Forward little-endian bit reader (FSE table descriptions).
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;
  uint32_t peek(int nb) const {  // bits past the end read as 0
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i) {
      size_t b = bit + i;
      if ((b >> 3) < n) v |= (uint32_t)((p[b >> 3] >> (b & 7)) & 1) << i;
    }
    return v;
  }
  void skip(int nb) { bit += nb; }
};

// Backward bit reader: the stream is read from its last byte down, starting
// under the highest set bit of the last byte (the padding marker).
struct BackBits {
  std::vector<uint8_t> buf;  // 8 zero bytes of padding on each side
  int64_t pos = 0;           // bits left above bit 0 of the stream
  BackBits(const uint8_t* p, size_t n, const char* what) {
    if (n == 0) fail(std::string(what) + ": empty bitstream");
    uint8_t last = p[n - 1];
    if (last == 0) fail(std::string(what) + ": bitstream without end mark");
    buf.assign(n + 16, 0);
    memcpy(buf.data() + 8, p, n);
    pos = (int64_t)(n - 1) * 8 + highbit32(last);
  }
  // the nb (<= 56) bits below pos, MSB first; bits under bit 0 read as 0
  uint64_t peek(int nb) const {
    if (nb == 0 || pos <= 0) return 0;
    int64_t start = pos - nb;          // lowest bit of the field
    if (start < 0)                     // the pos bits above bit 0, then 0s
      return (rd64(buf.data() + 8) & ((1ULL << pos) - 1)) << (-start);
    int64_t s = start + 64;            // in the padded buffer
    uint64_t w = rd64(buf.data() + (s >> 3));
    return (w >> (s & 7)) & ((1ULL << nb) - 1);
  }
  uint64_t read(int nb) {
    uint64_t v = peek(nb);
    pos -= nb;
    return v;
  }
  bool overflow() const { return pos < 0; }
};

// ------------------------------------------------------------------- FSE
struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
};

// Reads an FSE table description at p (max n bytes); returns bytes used.
size_t read_ncount(const uint8_t* p, size_t n, int max_log, int max_symbol,
                   std::vector<int16_t>& norm, int& log, const char* what) {
  if (n == 0) fail(std::string(what) + ": FSE table description truncated");
  FwdBits br{p, n};
  log = (int)br.peek(4) + 5;
  br.skip(4);
  if (log > max_log)
    fail(std::string(what) + ": FSE accuracy log " + std::to_string(log) +
         " above " + std::to_string(max_log));
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int sym = 0;
  norm.assign(max_symbol + 1, 0);
  bool prev0 = false;
  while (remaining > 1 && sym <= max_symbol) {
    if (prev0) {
      int rep = (int)br.peek(2);
      br.skip(2);
      int n0 = rep;
      while (rep == 3) {
        rep = (int)br.peek(2);
        br.skip(2);
        n0 += rep;
      }
      if (sym + n0 > max_symbol + 1)
        fail(std::string(what) + ": FSE zero run past the last symbol");
      sym += n0;
      if (sym > max_symbol) break;
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = br.peek(nbits - 1);
    if ((int)low < max) {
      count = (int)low;
      br.skip(nbits - 1);
    } else {
      count = (int)br.peek(nbits);
      if (count >= threshold) count -= max;
      br.skip(nbits);
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = (int16_t)count;
    prev0 = count == 0;
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
  }
  if (remaining != 1)
    fail(std::string(what) + ": FSE probabilities do not sum to the table");
  size_t used = (br.bit + 7) >> 3;
  if (used > n) fail(std::string(what) + ": FSE table description truncated");
  norm.resize(sym);
  return used;
}

void build_fse(const std::vector<int16_t>& norm, int log, FseTable& out,
               const char* what) {
  int size = 1 << log;
  out.log = log;
  out.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      if (high < 0) fail(std::string(what) + ": FSE table overfull");
      out.t[high--].symbol = (uint16_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint32_t)norm[s];
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      out.t[pos].symbol = (uint16_t)s;
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) fail(std::string(what) + ": FSE spread did not close");
  for (int u = 0; u < size; ++u) {
    uint16_t s = out.t[u].symbol;
    uint32_t ns = next[s]++;
    int nb = log - highbit32(ns);
    out.t[u].nbits = (uint8_t)nb;
    out.t[u].base = (uint16_t)((ns << nb) - size);
  }
}

void build_rle(uint16_t symbol, FseTable& out) {
  out.log = 0;
  out.t.assign(1, FseEntry{symbol, 0, 0});
}

void build_predef(const int16_t* norm, int n, int log, FseTable& out) {
  std::vector<int16_t> v(norm, norm + n);
  build_fse(v, log, out, "predefined table");
}

// --------------------------------------------------------------- Huffman
struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> sym, nbits;  // 1 << max_bits entries
  bool ready = false;
};

// Decodes the Huffman tree description at p; returns bytes used.
size_t read_huffman(const uint8_t* p, size_t n, HufTable& h) {
  if (n < 1) fail("Huffman tree description truncated");
  std::vector<uint8_t> w;
  size_t used;
  uint8_t hb = p[0];
  if (hb >= 128) {  // direct 4-bit weights
    int nsym = hb - 127;
    used = 1 + (size_t)((nsym + 1) / 2);
    if (used > n) fail("Huffman weights truncated");
    for (int i = 0; i < nsym; ++i) {
      uint8_t b = p[1 + i / 2];
      w.push_back(i % 2 == 0 ? b >> 4 : b & 15);
    }
  } else {  // FSE-compressed weights, two interleaved states
    used = 1 + (size_t)hb;
    if (used > n || hb == 0) fail("Huffman FSE weights truncated");
    std::vector<int16_t> norm;
    int log;
    size_t t = read_ncount(p + 1, hb, 6, 255, norm, log, "Huffman weights");
    FseTable ft;
    build_fse(norm, log, ft, "Huffman weights");
    BackBits bb(p + 1 + t, hb - t, "Huffman weights");
    uint32_t s1 = (uint32_t)bb.read(log), s2 = (uint32_t)bb.read(log);
    while (true) {
      if (w.size() >= 255) fail("Huffman weights: too many symbols");
      const FseEntry& e1 = ft.t[s1];
      w.push_back((uint8_t)e1.symbol);
      s1 = e1.base + (uint32_t)bb.read(e1.nbits);
      if (bb.overflow()) {
        w.push_back((uint8_t)ft.t[s2].symbol);
        break;
      }
      if (w.size() >= 255) fail("Huffman weights: too many symbols");
      const FseEntry& e2 = ft.t[s2];
      w.push_back((uint8_t)e2.symbol);
      s2 = e2.base + (uint32_t)bb.read(e2.nbits);
      if (bb.overflow()) {
        w.push_back((uint8_t)ft.t[s1].symbol);
        break;
      }
    }
  }
  uint32_t total = 0;
  for (uint8_t x : w) {
    if (x > 11) fail("Huffman weight above 11");
    if (x) total += 1u << (x - 1);
  }
  if (total == 0) fail("Huffman weights all zero");
  int max_bits = highbit32(total) + 1;
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("Huffman weights: last weight not a power of 2");
  w.push_back((uint8_t)(highbit32(rest) + 1));
  if (max_bits > 11) fail("Huffman code longer than 11 bits");
  if (w.size() > 256) fail("Huffman tree: more than 256 symbols");
  h.max_bits = max_bits;
  size_t size = (size_t)1 << max_bits;
  h.sym.assign(size, 0);
  h.nbits.assign(size, 0);
  size_t pos = 0;
  for (int wt = 1; wt <= max_bits; ++wt) {
    for (size_t s = 0; s < w.size(); ++s) {
      if (w[s] != wt) continue;
      size_t len = (size_t)1 << (wt - 1);
      for (size_t i = 0; i < len; ++i) {
        h.sym[pos + i] = (uint8_t)s;
        h.nbits[pos + i] = (uint8_t)(max_bits + 1 - wt);
      }
      pos += len;
    }
  }
  if (pos != size) fail("Huffman table does not fill its range");
  h.ready = true;
  return used;
}

void huf_stream(const HufTable& h, const uint8_t* p, size_t n, uint8_t* out,
                size_t count) {
  BackBits bb(p, n, "Huffman stream");
  for (size_t i = 0; i < count; ++i) {
    uint64_t idx = bb.peek(h.max_bits);
    out[i] = h.sym[idx];
    bb.pos -= h.nbits[idx];
    if (bb.overflow()) fail("Huffman stream read past its start");
  }
  if (bb.pos != 0) fail("Huffman stream not fully consumed");
}

// ----------------------------------------------------------- sequences
const int16_t LL_NORM[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_NORM[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_NORM[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,
                              9,  10, 11,  12,  13,  14,   15,   16,   18,
                              20, 22, 24,  28,  32,  40,   48,   64,   128,
                              256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13,  14,  15,  16,   17,   18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,   33,   34,
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,  131, 259, 515,  1027, 2051,
    4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  bool ll_ok = false, of_ok = false, ml_ok = false;
  uint64_t rep[3] = {1, 4, 8};
};

// Reads one table of the sequences section; returns bytes used.
size_t seq_table(int mode, const uint8_t* p, size_t n, FseTable& t, bool& ok,
                 const int16_t* predef, int npredef, int predef_log,
                 int max_log, int max_symbol, const char* what) {
  switch (mode) {
    case 0:
      build_predef(predef, npredef, predef_log, t);
      ok = true;
      return 0;
    case 1:
      if (n < 1) fail(std::string(what) + ": RLE symbol missing");
      if (p[0] > max_symbol) fail(std::string(what) + ": RLE symbol too large");
      build_rle(p[0], t);
      ok = true;
      return 1;
    case 2: {
      std::vector<int16_t> norm;
      int log;
      size_t used = read_ncount(p, n, max_log, max_symbol, norm, log, what);
      build_fse(norm, log, t, what);
      ok = true;
      return used;
    }
    default:
      if (!ok) fail(std::string(what) + ": repeat mode with no previous table");
      return 0;
  }
}

void decode_block(const uint8_t* p, size_t n, FrameState& st,
                  std::vector<uint8_t>& out, size_t frame_start,
                  size_t block_max) {
  // ---- literals section
  if (n < 1) fail("compressed block: empty");
  int ltype = p[0] & 3, sf = (p[0] >> 2) & 3;
  size_t regen = 0, csize = 0, hdr = 0;
  int streams = 1;
  if (ltype < 2) {
    if ((sf & 1) == 0) {
      hdr = 1;
      regen = p[0] >> 3;
    } else if (sf == 1) {
      hdr = 2;
      if (n < 2) fail("literals header truncated");
      regen = (p[0] >> 4) + ((size_t)p[1] << 4);
    } else {
      hdr = 3;
      if (n < 3) fail("literals header truncated");
      regen = (p[0] >> 4) + ((size_t)p[1] << 4) + ((size_t)p[2] << 12);
    }
  } else {
    hdr = sf < 2 ? 3 : sf == 2 ? 4 : 5;
    if (n < hdr) fail("literals header truncated");
    uint64_t v = 0;
    for (size_t i = 0; i < hdr; ++i) v |= (uint64_t)p[i] << (8 * i);
    int bits = sf < 2 ? 10 : sf == 2 ? 14 : 18;
    regen = (v >> 4) & ((1u << bits) - 1);
    csize = (v >> (4 + bits)) & ((1u << bits) - 1);
    streams = sf == 0 ? 1 : 4;
  }
  if (regen > block_max) fail("literals larger than the block maximum");
  std::vector<uint8_t> lit(regen);
  size_t off = hdr;
  if (ltype == 0) {
    if (off + regen > n) fail("raw literals truncated");
    memcpy(lit.data(), p + off, regen);
    off += regen;
  } else if (ltype == 1) {
    if (off + 1 > n) fail("RLE literals truncated");
    memset(lit.data(), p[off], regen);
    off += 1;
  } else {
    if (off + csize > n) fail("compressed literals truncated");
    const uint8_t* q = p + off;
    size_t qn = csize;
    if (ltype == 2) {
      size_t t = read_huffman(q, qn, st.huf);
      q += t;
      qn -= t;
    } else if (!st.huf.ready) {
      fail("treeless literals with no previous Huffman table");
    }
    if (streams == 1) {
      huf_stream(st.huf, q, qn, lit.data(), regen);
    } else {
      if (qn < 6) fail("Huffman jump table truncated");
      size_t s1 = q[0] | (q[1] << 8), s2 = q[2] | (q[3] << 8),
             s3 = q[4] | (q[5] << 8);
      if (6 + s1 + s2 + s3 > qn) fail("Huffman streams larger than literals");
      size_t s4 = qn - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("4-stream literals too short");
      const uint8_t* sp = q + 6;
      size_t sizes[4] = {s1, s2, s3, s4};
      for (int i = 0; i < 4; ++i) {
        size_t cnt = i < 3 ? seg : regen - 3 * seg;
        huf_stream(st.huf, sp, sizes[i], lit.data() + i * seg, cnt);
        sp += sizes[i];
      }
    }
    off += csize;
  }
  // ---- sequences section
  if (off >= n) fail("sequences section missing");
  size_t nseq;
  uint8_t b0 = p[off];
  if (b0 < 128) {
    nseq = b0;
    off += 1;
  } else if (b0 < 255) {
    if (off + 2 > n) fail("sequence count truncated");
    nseq = ((size_t)(b0 - 128) << 8) + p[off + 1];
    off += 2;
  } else {
    if (off + 3 > n) fail("sequence count truncated");
    nseq = p[off + 1] + ((size_t)p[off + 2] << 8) + 0x7F00;
    off += 3;
  }
  size_t out0 = out.size();
  if (nseq == 0) {
    if (off != n) fail("bytes after an empty sequences section");
    out.insert(out.end(), lit.begin(), lit.end());
    return;
  }
  if (off >= n) fail("symbol compression modes missing");
  uint8_t modes = p[off++];
  if (modes & 3) fail("reserved bits of the symbol compression modes set");
  off += seq_table(modes >> 6, p + off, n - off, st.ll, st.ll_ok, LL_NORM, 36,
                   6, 9, 35, "literals-length table");
  off += seq_table((modes >> 4) & 3, p + off, n - off, st.of, st.of_ok,
                   OF_NORM, 29, 5, 8, 31, "offset table");
  off += seq_table((modes >> 2) & 3, p + off, n - off, st.ml, st.ml_ok,
                   ML_NORM, 53, 6, 9, 52, "match-length table");
  if (off >= n) fail("sequences bitstream missing");
  BackBits bb(p + off, n - off, "sequences");
  uint32_t sll = (uint32_t)bb.read(st.ll.log);
  uint32_t sof = (uint32_t)bb.read(st.of.log);
  uint32_t sml = (uint32_t)bb.read(st.ml.log);
  size_t lpos = 0;
  for (size_t i = 0; i < nseq; ++i) {
    const FseEntry& ell = st.ll.t[sll];
    const FseEntry& eof = st.of.t[sof];
    const FseEntry& eml = st.ml.t[sml];
    uint32_t ofc = eof.symbol, llc = ell.symbol, mlc = eml.symbol;
    if (ofc > 31) fail("offset code above 31");
    if (llc > 35 || mlc > 52) fail("length code out of range");
    uint64_t ov = (1ULL << ofc) + bb.read((int)ofc);
    uint64_t ml = ML_BASE[mlc] + bb.read(ML_BITS[mlc]);
    uint64_t ll = LL_BASE[llc] + bb.read(LL_BITS[llc]);
    uint64_t offset;
    if (ov > 3) {
      offset = ov - 3;
      st.rep[2] = st.rep[1];
      st.rep[1] = st.rep[0];
      st.rep[0] = offset;
    } else {
      int idx = (int)ov - 1 + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = st.rep[0];
      } else if (idx == 1) {
        offset = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = offset;
      } else if (idx == 2) {
        offset = st.rep[2];
        st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = offset;
      } else {
        offset = st.rep[0] - 1;
        st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      sll = ell.base + (uint32_t)bb.read(ell.nbits);
      sml = eml.base + (uint32_t)bb.read(eml.nbits);
      sof = eof.base + (uint32_t)bb.read(eof.nbits);
    }
    if (bb.overflow()) fail("sequences bitstream read past its start");
    if (lpos + ll > lit.size()) fail("sequence copies more literals than exist");
    out.insert(out.end(), lit.begin() + lpos, lit.begin() + lpos + ll);
    lpos += ll;
    if (offset == 0 || offset > out.size() - frame_start)
      fail("match offset reaches before the frame's start (a dictionary?)");
    size_t src = out.size() - offset;
    for (uint64_t k = 0; k < ml; ++k) out.push_back(out[src + k]);
    if (out.size() - out0 > block_max) fail("block larger than its maximum");
  }
  if (bb.pos != 0) fail("sequences bitstream not fully consumed");
  out.insert(out.end(), lit.begin() + lpos, lit.end());
  if (out.size() - out0 > block_max) fail("block larger than its maximum");
}

size_t decode_frame(const uint8_t* p, size_t n, std::vector<uint8_t>& out) {
  if (n < 4) fail("truncated frame magic");
  uint32_t magic = rd32(p);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u)
    fail("skippable frame (magic 0x" + [&] {
      char b[16];
      snprintf(b, sizeof b, "%08X", magic);
      return std::string(b);
    }() + ") where a zstd frame was expected");
  if (magic != 0xFD2FB528u) fail("not a zstd frame (bad magic number)");
  size_t off = 4;
  if (off >= n) fail("frame header truncated");
  uint8_t fhd = p[off++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
      did_flag = fhd & 3;
  if (fhd & 8) fail("reserved bit of the frame header descriptor set");
  uint64_t window = 0;
  if (!single) {
    if (off >= n) fail("window descriptor truncated");
    uint8_t wd = p[off++];
    int wlog = 10 + (wd >> 3);
    uint64_t base = 1ULL << wlog;
    window = base + (base / 8) * (wd & 7);
  }
  static const int did_size[4] = {0, 1, 2, 4};
  if (off + did_size[did_flag] > n) fail("dictionary ID truncated");
  uint32_t did = 0;
  for (int i = 0; i < did_size[did_flag]; ++i)
    did |= (uint32_t)p[off + i] << (8 * i);
  off += did_size[did_flag];
  if (did != 0)
    fail("frame needs dictionary ID " + std::to_string(did) +
         " (dictionaries are not supported)");
  int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : 1 << fcs_flag;
  uint64_t fcs = 0;
  bool has_fcs = fcs_size > 0;
  if (off + fcs_size > n) fail("frame content size truncated");
  for (int i = 0; i < fcs_size; ++i) fcs |= (uint64_t)p[off + i] << (8 * i);
  if (fcs_size == 2) fcs += 256;
  off += fcs_size;
  if (single) window = fcs;
  uint64_t block_max = window < (1u << 17) ? window : (1u << 17);
  size_t frame_start = out.size();
  FrameState st;
  while (true) {
    if (off + 3 > n) fail("block header truncated");
    uint32_t bh = p[off] | (p[off + 1] << 8) | (p[off + 2] << 16);
    off += 3;
    int last = bh & 1, btype = (bh >> 1) & 3;
    size_t bsize = bh >> 3;
    if (btype == 3) fail("reserved block type");
    if (btype == 1) {
      if (off + 1 > n) fail("RLE block truncated");
      if (bsize > block_max) fail("RLE block larger than its maximum");
      out.insert(out.end(), bsize, p[off]);
      off += 1;
    } else {
      if (off + bsize > n) fail("block truncated");
      if (btype == 0) {
        if (bsize > block_max) fail("raw block larger than its maximum");
        out.insert(out.end(), p + off, p + off + bsize);
      } else {
        if (bsize > block_max) fail("compressed block larger than its maximum");
        decode_block(p + off, bsize, st, out, frame_start, (size_t)block_max);
      }
      off += bsize;
    }
    if (last) break;
  }
  size_t produced = out.size() - frame_start;
  if (has_fcs && produced != fcs)
    fail("frame content size " + std::to_string(fcs) + " but " +
         std::to_string(produced) + " bytes decoded");
  if (checksum) {
    if (off + 4 > n) fail("content checksum truncated");
    uint32_t want = rd32(p + off);
    uint32_t got =
        (uint32_t)xxh64_impl(out.data() + frame_start, produced, 0);
    if (want != got) fail("content checksum (XXH64) mismatch");
    off += 4;
  }
  return off;
}

}  // namespace

extern "C" {

long long zstd_decompress(const uint8_t* src, size_t n, uint8_t** out,
                          char* err, int err_len) {
  *out = nullptr;
  try {
    if (n == 0) fail("empty input");
    std::vector<uint8_t> buf;
    size_t off = 0;
    while (off < n) off += decode_frame(src + off, n - off, buf);
    uint8_t* mem = (uint8_t*)malloc(buf.size() ? buf.size() : 1);
    if (!mem) fail("out of memory");
    if (!buf.empty()) memcpy(mem, buf.data(), buf.size());
    *out = mem;
    return (long long)buf.size();
  } catch (const std::exception& e) {
    snprintf(err, (size_t)err_len, "%s", e.what());
    return -1;
  }
}

void zstd_free(uint8_t* p) { free(p); }

uint32_t crc32c(const uint8_t* p, size_t n) { return crc32c_impl(p, n); }

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  return xxh64_impl(p, n, seed);
}

}  // extern "C"
