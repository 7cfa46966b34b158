// A zstd frame decoder (RFC 8878), host C++ with a plain C interface.
//
// The port reads orbax snapshots (OCDBT nodes and zarr chunks, both zstd)
// on machines that have no zstd module, so it carries its own decoder:
//
//   * frames: header with window descriptor or single segment, dictionary
//     ID (a frame that needs a dictionary is refused), frame content size,
//     skippable frames, concatenated frames, the optional XXH64 content
//     checksum (verified);
//   * blocks: raw, RLE and compressed, at most 128 KiB each;
//   * literals: raw, RLE, Huffman-coded with 1 or 4 streams (jump table) and
//     treeless (the previous block's table); Huffman weights direct or FSE;
//   * sequences: predefined, RLE, FSE-coded and repeat modes for the
//     literal-length, offset and match-length codes; the three repeat
//     offsets with the rule for a zero literal length.
//
// It also carries CRC-32C, the checksum of OCDBT's manifests and nodes.
//
// Every read is bounds-checked. A malformed or truncated frame fails with a
// message that names the byte offset in the input; the decoder never hands
// back short output. Build: g++ -O3 -shared -fPIC -std=c++17.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Failure {
  size_t offset;
  std::string what;
};

[[noreturn]] void fail(size_t offset, const std::string& what) { throw Failure{offset, what}; }

inline uint64_t load_le(const uint8_t* p, size_t n) {  // n <= 8
  uint64_t v = 0;
  for (size_t i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// The decoded bytes: a growing heap buffer, or the caller's buffer of the
// expected size (which the output may not pass).
struct Buf {
  uint8_t* p = nullptr;
  size_t n = 0, cap = 0;
  bool fixed = false;
  Buf() = default;
  Buf(uint8_t* dst, size_t c) : p(dst), cap(c), fixed(true) {}
  Buf(const Buf&) = delete;
  ~Buf() {
    if (!fixed) std::free(p);
  }
  size_t size() const { return n; }
  uint8_t* data() { return p; }
  void reserve(size_t want, size_t at) {
    if (want <= cap) return;
    if (fixed) throw Failure{at, "output past the expected " + std::to_string(cap) + " bytes"};
    size_t c = cap ? cap : 4096;
    while (c < want) c *= 2;
    uint8_t* q = static_cast<uint8_t*>(std::realloc(p, c));
    if (!q) throw std::bad_alloc();
    p = q;
    cap = c;
  }
  uint8_t* extend(size_t k, size_t at) {  // k more bytes at the end
    reserve(n + k, at);
    uint8_t* r = p + n;
    n += k;
    return r;
  }
  void append(const uint8_t* src, size_t k, size_t at) {
    if (k) std::memcpy(extend(k, at), src, k);
  }
};

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr size_t kBlockMax = 128 * 1024;

// ------------------------------------------------------------- XXH64
constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL, P3 = 0x165667B19E3779F9ULL,
                   P4 = 0x85EBCA77C2B2AE63ULL, P5 = 0x27D4EB2F165667C5ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, load_le(p, 8));
      v2 = xround(v2, load_le(p + 8, 8));
      v3 = xround(v3, load_le(p + 16, 8));
      v4 = xround(v4, load_le(p + 24, 8));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += len;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, load_le(p, 8)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (load_le(p, 4) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------- CRC-32C
uint32_t crc32c(const uint8_t* p, size_t n) {
  static uint32_t table[256];
  static bool ready = [] {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0u);
      table[i] = c;
    }
    return true;
  }();
  (void)ready;
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ------------------------------------------------------- bit readers
// Forward, least significant bit first (FSE table descriptions).
struct FwdBits {
  const uint8_t* p;
  size_t n;      // bytes
  size_t pos;    // bits read
  size_t base;   // offset of p in the input, for messages
  uint32_t read(int nb) {
    if (nb == 0) return 0;
    size_t b = pos >> 3;
    int sh = int(pos & 7);
    uint64_t v = b < n ? load_le(p + b, n - b < 8 ? n - b : 8) >> sh : 0;
    pos += size_t(nb);
    return uint32_t(v & ((1ull << nb) - 1));
  }
  uint32_t peek(int nb) const {
    FwdBits c = *this;
    return c.read(nb);
  }
};

// Backward: the stream ends with a byte whose highest set bit marks its
// start; bits are read from there towards the first byte. Reading past the
// first byte gives zeros ("overflow"), which FSE's end condition uses.
struct BackBits {
  const uint8_t* p;
  int64_t n;
  int64_t pos;  // bits left
  size_t base;
  BackBits(const uint8_t* p_, size_t n_, size_t base_) : p(p_), n(int64_t(n_)), base(base_) {
    if (n_ == 0) fail(base_, "empty bitstream");
    uint8_t last = p_[n_ - 1];
    if (last == 0) fail(base_ + n_ - 1, "bitstream without its end marker");
    pos = 8 * (n - 1) + highbit(last);
  }
  uint64_t get(int64_t at, int nb) const {  // bits [at - nb, at)
    int64_t lo = at - nb;
    uint64_t v;
    if (lo >= 0) {
      int64_t b = lo >> 3;
      if (b + 8 <= n) {
        std::memcpy(&v, p + b, 8);  // little-endian host
      } else {
        v = load_le(p + b, size_t(n - b));
      }
      v >>= (lo & 7);
    } else {
      if (-lo >= nb) return 0;
      v = load_le(p, size_t(n < 8 ? n : 8)) << (-lo);
    }
    return v & ((1ull << nb) - 1);
  }
  uint64_t read(int nb) {
    if (nb == 0) return 0;
    uint64_t v = get(pos, nb);
    pos -= nb;
    return v;
  }
  uint64_t peek(int nb) const { return get(pos, nb); }
  bool overflowed() const { return pos < 0; }
};

// ------------------------------------------------------------------ FSE
struct FseEntry {
  uint16_t symbol;
  uint8_t nb_bits;
  uint16_t base;
};

struct FseTable {
  int log = -1;  // -1: no table
  std::vector<FseEntry> t;
};

void fse_build(FseTable& out, const int16_t* norm, int max_symbol, int log, size_t at) {
  size_t size = size_t(1) << log;
  out.log = log;
  out.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(max_symbol + 1);
  int64_t high = int64_t(size) - 1;
  for (int s = 0; s <= max_symbol; ++s) {
    if (norm[s] == -1) {
      out.t[size_t(high--)].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  size_t mask = size - 1, step = (size >> 1) + (size >> 3) + 3, position = 0;
  for (int s = 0; s <= max_symbol; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      out.t[position].symbol = uint16_t(s);
      do position = (position + step) & mask;
      while (int64_t(position) > high);
    }
  }
  if (position != 0) fail(at, "FSE distribution does not fill its table");
  for (size_t u = 0; u < size; ++u) {
    uint32_t state = next[out.t[u].symbol]++;
    int nb = log - highbit(state);
    out.t[u].nb_bits = uint8_t(nb);
    out.t[u].base = uint16_t((state << nb) - size);
  }
}

void fse_rle(FseTable& out, uint8_t symbol) {
  out.log = 0;
  out.t.assign(1, FseEntry{symbol, 0, 0});
}

// Reads a table description at p[0..n); returns the bytes it took.
size_t fse_read(FseTable& out, const uint8_t* p, size_t n, int max_symbol, int max_log, size_t at) {
  if (n == 0) fail(at, "truncated FSE table description");
  FwdBits bits{p, n, 0, at};
  int log = int(bits.read(4)) + 5;
  if (log > max_log) fail(at, "FSE accuracy log " + std::to_string(log) + " above " + std::to_string(max_log));
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1, symbol = 0;
  std::vector<int16_t> norm(size_t(max_symbol) + 1, 0);
  bool previous0 = false;
  while (remaining > 1 && symbol <= max_symbol) {
    if (previous0) {
      int repeat;
      do {
        repeat = int(bits.read(2));
        for (int i = 0; i < repeat; ++i) {
          if (symbol > max_symbol) fail(at, "FSE zero run past the last symbol");
          norm[size_t(symbol++)] = 0;
        }
      } while (repeat == 3);
      if (symbol > max_symbol) break;
    }
    int max = (2 * threshold - 1) - remaining, count;
    uint32_t v = bits.peek(nb);
    if (int(v & uint32_t(threshold - 1)) < max) {
      count = int(v & uint32_t(threshold - 1));
      bits.pos += size_t(nb - 1);
    } else {
      count = int(v & uint32_t(2 * threshold - 1));
      if (count >= threshold) count -= max;
      bits.pos += size_t(nb);
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    norm[size_t(symbol++)] = int16_t(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail(at, "FSE distribution does not add up");
  size_t used = (bits.pos + 7) / 8;
  if (used > n) fail(at, "truncated FSE table description");
  fse_build(out, norm.data(), symbol - 1, log, at);
  return used;
}

struct FseState {
  const FseTable* t;
  uint32_t state;
  void init(BackBits& b) { state = uint32_t(b.read(t->log)); }
  uint16_t symbol() const { return t->t[state].symbol; }
  void update(BackBits& b) {
    const FseEntry& e = t->t[state];
    state = e.base + uint32_t(b.read(e.nb_bits));
  }
};

// -------------------------------------------------------------- Huffman
struct HufTable {
  int max_bits = 0;  // 0: no table yet
  std::vector<uint8_t> symbol, nb_bits;
};

// Reads a Huffman tree description; returns the bytes it took.
size_t huf_read(HufTable& out, const uint8_t* p, size_t n, size_t at) {
  if (n == 0) fail(at, "truncated Huffman tree description");
  uint8_t header = p[0];
  std::vector<uint8_t> weights;
  size_t used;
  if (header >= 128) {
    size_t count = header - 127;
    used = 1 + (count + 1) / 2;
    if (used > n) fail(at, "truncated Huffman weights");
    for (size_t i = 0; i < count; ++i) weights.push_back(i % 2 == 0 ? p[1 + i / 2] >> 4 : p[1 + i / 2] & 15);
  } else {
    used = 1 + size_t(header);
    if (used > n) fail(at, "truncated Huffman weights");
    FseTable table;
    size_t desc = fse_read(table, p + 1, header, 255, 6, at + 1);
    if (desc >= header) fail(at + 1, "Huffman weights without a bitstream");
    BackBits b(p + 1 + desc, header - desc, at + 1 + desc);
    FseState s1{&table, 0}, s2{&table, 0};
    s1.init(b);
    s2.init(b);
    // two interleaved states until the stream runs out: then the other
    // state's symbol is the last
    FseState* s[2] = {&s1, &s2};
    for (int k = 0;; k ^= 1) {
      if (weights.size() >= 255) fail(at, "too many Huffman weights");
      weights.push_back(uint8_t(s[k]->symbol()));
      s[k]->update(b);
      if (b.overflowed()) {
        if (weights.size() >= 255) fail(at, "too many Huffman weights");
        weights.push_back(uint8_t(s[k ^ 1]->symbol()));
        break;
      }
    }
  }
  if (weights.size() > 255) fail(at, "too many Huffman weights");
  uint32_t total = 0;
  for (uint8_t w : weights) {
    if (w > 11) fail(at, "Huffman weight above 11");
    if (w) total += 1u << (w - 1);
  }
  if (total == 0) fail(at, "Huffman weights all zero");
  int max_bits = highbit(total) + 1;
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail(at, "Huffman weights leave no power of two for the last symbol");
  if (max_bits > 11) fail(at, "Huffman code longer than 11 bits");
  weights.push_back(uint8_t(highbit(rest) + 1));
  out.max_bits = max_bits;
  out.symbol.assign(size_t(1) << max_bits, 0);
  out.nb_bits.assign(size_t(1) << max_bits, 0);
  size_t position = 0;
  for (int w = 1; w <= max_bits; ++w) {
    for (size_t s = 0; s < weights.size(); ++s) {
      if (weights[s] != w) continue;
      size_t span = size_t(1) << (w - 1);
      for (size_t i = 0; i < span; ++i) {
        out.symbol[position + i] = uint8_t(s);
        out.nb_bits[position + i] = uint8_t(max_bits + 1 - w);
      }
      position += span;
    }
  }
  if (position != (size_t(1) << max_bits)) fail(at, "Huffman table not full");
  return used;
}

void huf_stream(const HufTable& h, const uint8_t* p, size_t n, size_t at, uint8_t* dst, size_t count) {
  BackBits b(p, n, at);
  const int mb = h.max_bits;
  const uint8_t* sym = h.symbol.data();
  const uint8_t* nbits = h.nb_bits.data();
  size_t i = 0;
  // with 64 bits left, four codes (at most 44 bits) cannot run past the start
  while (i + 4 <= count && b.pos >= 64) {
    int64_t top = (b.pos - 1) >> 3;  // the byte that holds the next bit
    uint64_t w;
    std::memcpy(&w, p + top - 7, 8);
    w <<= 7 - ((b.pos - 1) & 7);  // next bit at bit 63; 57 or more valid below it
    for (int k = 0; k < 4; ++k) {
      uint32_t v = uint32_t(w >> (64 - mb));
      dst[i++] = sym[v];
      w <<= nbits[v];
      b.pos -= nbits[v];
    }
  }
  for (; i < count; ++i) {
    uint32_t v = uint32_t(b.peek(mb));
    dst[i] = sym[v];
    b.pos -= nbits[v];
    if (b.pos < 0) fail(at, "Huffman stream ends early");
  }
  if (b.pos != 0) fail(at, "Huffman stream has bits left over");
}

// ------------------------------------------------------------ sequences
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,   16,   17,   18,    19,    20,
                              21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,  33,   34,   35,   37,    39,    41,
                              43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Tables {
  FseTable ll, of, ml;  // the previous block's, for repeat mode
  FseTable ll_default, of_default, ml_default;
  Tables() {
    fse_build(ll_default, kLLDefault, 35, 6, 0);
    fse_build(of_default, kOFDefault, 28, 5, 0);
    fse_build(ml_default, kMLDefault, 52, 6, 0);
  }
};

// Mode byte field -> the table to decode with; returns the bytes it took.
size_t seq_table(int mode, FseTable& prev, const FseTable& def, const uint8_t* p, size_t n, int max_symbol,
                 int max_log, size_t at, const char* name) {
  switch (mode) {
    case 0:
      prev = def;
      return 0;
    case 1:
      if (n < 1) fail(at, std::string("truncated RLE ") + name + " code");
      if (p[0] > max_symbol) fail(at, std::string(name) + " code out of range");
      fse_rle(prev, p[0]);
      return 1;
    case 2:
      return fse_read(prev, p, n, max_symbol, max_log, at);
    default:
      if (prev.log < 0) fail(at, std::string("repeat mode for ") + name + " with no previous table");
      return 0;
  }
}

struct Frame {
  Buf& out;
  size_t frame_start;  // where this frame's output begins in out
  uint64_t window;
  size_t block_cap;  // most bytes a block may decode to
  uint32_t rep[3] = {1, 4, 8};
  HufTable huf;
  Tables tables;
  std::vector<uint8_t> literals;

  Frame(Buf& o, size_t start, uint64_t w, size_t cap) : out(o), frame_start(start), window(w), block_cap(cap) {}

  // Literals section at p[0..n); returns its size and sets lit / lit_n.
  size_t read_literals(const uint8_t* p, size_t n, size_t at, const uint8_t*& lit, size_t& lit_n) {
    if (n < 1) fail(at, "truncated literals header");
    int type = p[0] & 3, format = (p[0] >> 2) & 3;
    if (type <= 1) {  // raw or RLE
      size_t hdr, size;
      if ((format & 1) == 0) {
        hdr = 1;
        size = p[0] >> 3;
      } else if (format == 1) {
        hdr = 2;
        if (n < 2) fail(at, "truncated literals header");
        size = (p[0] >> 4) + (size_t(p[1]) << 4);
      } else {
        hdr = 3;
        if (n < 3) fail(at, "truncated literals header");
        size = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
      }
      if (size > kBlockMax) fail(at, "literals above 128 KiB");
      if (type == 0) {
        if (hdr + size > n) fail(at, "truncated raw literals");
        lit = p + hdr;
        lit_n = size;
        return hdr + size;
      }
      if (hdr + 1 > n) fail(at, "truncated RLE literals");
      literals.assign(size, p[hdr]);
      lit = literals.data();
      lit_n = size;
      return hdr + 1;
    }
    size_t hdr, regen, comp;
    bool four = format != 0;
    if (format <= 1) {
      hdr = 3;
      if (n < 3) fail(at, "truncated literals header");
      uint64_t h = load_le(p, 3);
      regen = (h >> 4) & 0x3FF;
      comp = (h >> 14) & 0x3FF;
    } else if (format == 2) {
      hdr = 4;
      if (n < 4) fail(at, "truncated literals header");
      uint64_t h = load_le(p, 4);
      regen = (h >> 4) & 0x3FFF;
      comp = (h >> 18) & 0x3FFF;
    } else {
      hdr = 5;
      if (n < 5) fail(at, "truncated literals header");
      uint64_t h = load_le(p, 5);
      regen = (h >> 4) & 0x3FFFF;
      comp = (h >> 22) & 0x3FFFF;
    }
    if (regen > kBlockMax) fail(at, "literals above 128 KiB");
    if (hdr + comp > n) fail(at, "truncated compressed literals");
    const uint8_t* q = p + hdr;
    size_t q_at = at + hdr, q_n = comp;
    if (type == 2) {
      size_t tree = huf_read(huf, q, q_n, q_at);
      q += tree;
      q_at += tree;
      q_n -= tree;
    } else if (huf.max_bits == 0) {
      fail(at, "treeless literals with no previous Huffman table");
    }
    literals.resize(regen);
    if (!four) {
      huf_stream(huf, q, q_n, q_at, literals.data(), regen);
    } else {
      if (q_n < 6) fail(q_at, "truncated jump table");
      size_t s[4];
      s[0] = load_le(q, 2);
      s[1] = load_le(q + 2, 2);
      s[2] = load_le(q + 4, 2);
      if (s[0] + s[1] + s[2] + 6 > q_n) fail(q_at, "jump table past the literals");
      s[3] = q_n - 6 - s[0] - s[1] - s[2];
      size_t per = (regen + 3) / 4, off = 6, done = 0;
      if (per * 3 > regen) fail(q_at, "too few literals for four streams");
      for (int i = 0; i < 4; ++i) {
        size_t count = i < 3 ? per : regen - 3 * per;
        huf_stream(huf, q + off, s[i], q_at + off, literals.data() + done, count);
        off += s[i];
        done += count;
      }
    }
    lit = literals.data();
    lit_n = regen;
    return hdr + comp;
  }

  void copy_match(size_t offset, size_t length, size_t at) {
    size_t have = out.size() - frame_start;
    if (offset == 0 || offset > have) fail(at, "match offset " + std::to_string(offset) + " before the frame's start");
    if (offset > window) fail(at, "match offset " + std::to_string(offset) + " beyond the window");
    size_t from = out.size() - offset, to = out.size();
    out.extend(length, at);
    uint8_t* o = out.data();
    if (offset >= length) {
      std::memcpy(o + to, o + from, length);
    } else {
      for (size_t i = 0; i < length; ++i) o[to + i] = o[from + i];
    }
  }

  void compressed_block(const uint8_t* p, size_t n, size_t at) {
    size_t block_start = out.size();
    const uint8_t* lit;
    size_t lit_n;
    size_t used = read_literals(p, n, at, lit, lit_n);
    p += used;
    n -= used;
    at += used;
    if (n < 1) fail(at, "truncated sequences header");
    size_t nseq, hdr;
    if (p[0] < 128) {
      nseq = p[0];
      hdr = 1;
    } else if (p[0] < 255) {
      if (n < 2) fail(at, "truncated sequences header");
      nseq = (size_t(p[0] - 128) << 8) + p[1];
      hdr = 2;
    } else {
      if (n < 3) fail(at, "truncated sequences header");
      nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
      hdr = 3;
    }
    if (nseq == 0) {
      if (hdr != n) fail(at, "bytes after an empty sequences section");
      if (lit_n > block_cap) fail(at, "block decodes past the block size limit");
      out.append(lit, lit_n, at);
      return;
    }
    if (hdr + 1 > n) fail(at, "truncated sequences header");
    uint8_t modes = p[hdr];
    if (modes & 3) fail(at + hdr, "reserved bits set in the sequence modes");
    size_t q = hdr + 1;
    q += seq_table(modes >> 6, tables.ll, tables.ll_default, p + q, n - q, 35, 9, at + q, "literal-length");
    q += seq_table((modes >> 4) & 3, tables.of, tables.of_default, p + q, n - q, 31, 8, at + q, "offset");
    q += seq_table((modes >> 2) & 3, tables.ml, tables.ml_default, p + q, n - q, 52, 9, at + q, "match-length");
    if (q >= n) fail(at + q, "sequences without a bitstream");
    BackBits b(p + q, n - q, at + q);
    FseState ll{&tables.ll, 0}, of{&tables.of, 0}, ml{&tables.ml, 0};
    ll.init(b);
    of.init(b);
    ml.init(b);
    size_t lit_pos = 0;
    for (size_t i = 0; i < nseq; ++i) {
      unsigned of_code = of.symbol(), ll_code = ll.symbol(), ml_code = ml.symbol();
      if (of_code > 31) fail(at, "offset code out of range");
      uint64_t of_value = (uint64_t(1) << of_code) + b.read(int(of_code));
      uint32_t ml_value = kMLBase[ml_code] + uint32_t(b.read(kMLBits[ml_code]));
      uint32_t ll_value = kLLBase[ll_code] + uint32_t(b.read(kLLBits[ll_code]));
      uint64_t offset;
      if (of_value > 3) {
        offset = of_value - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = uint32_t(offset);
      } else {
        int idx = int(of_value) - 1 + (ll_value == 0 ? 1 : 0);
        if (idx == 0) {
          offset = rep[0];
        } else if (idx == 1) {
          offset = rep[1];
          rep[1] = rep[0];
          rep[0] = uint32_t(offset);
        } else if (idx == 2) {
          offset = rep[2];
          rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = uint32_t(offset);
        } else {
          offset = uint64_t(rep[0]) - 1;
          if (offset == 0) fail(at, "repeat offset 1 - 1 is zero");
          rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = uint32_t(offset);
        }
      }
      if (ll_value > lit_n - lit_pos) fail(at, "sequence takes more literals than the block has");
      out.append(lit + lit_pos, ll_value, at);
      lit_pos += ll_value;
      copy_match(size_t(offset), ml_value, at);
      if (out.size() - block_start > block_cap) fail(at, "block decodes past the block size limit");
      if (i + 1 < nseq) {
        ll.update(b);
        ml.update(b);
        of.update(b);
      }
      if (b.overflowed()) fail(at + q, "sequence bitstream ends early");
    }
    if (b.pos != 0) fail(at + q, "sequence bitstream has bits left over");
    out.append(lit + lit_pos, lit_n - lit_pos, at);
    if (out.size() - block_start > block_cap) fail(at, "block decodes past the block size limit");
  }
};

// Decodes one frame at src[pos..n); returns the position after it.
size_t decode_frame(const uint8_t* src, size_t n, size_t pos, Buf& out) {
  if (n - pos < 4 + 1) fail(pos, "truncated frame header");
  pos += 4;
  uint8_t fhd = src[pos++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
  if (fhd & 8) fail(pos - 1, "reserved bit set in the frame header");
  uint64_t window = 0;
  if (!single) {
    if (pos >= n) fail(pos, "truncated frame header");
    uint8_t wd = src[pos++];
    int exponent = wd >> 3, mantissa = wd & 7;
    uint64_t base = uint64_t(1) << (10 + exponent);
    window = base + (base / 8) * uint64_t(mantissa);
  }
  static const int dict_size[4] = {0, 1, 2, 4};
  if (n - pos < size_t(dict_size[dict_flag])) fail(pos, "truncated dictionary ID");
  uint64_t dict = load_le(src + pos, size_t(dict_size[dict_flag]));
  if (dict != 0) fail(pos, "frame needs dictionary " + std::to_string(dict));
  pos += size_t(dict_size[dict_flag]);
  static const int fcs_size[4] = {0, 2, 4, 8};
  int fcs_n = fcs_flag == 0 && single ? 1 : fcs_size[fcs_flag];
  bool has_fcs = fcs_n > 0;
  uint64_t fcs = 0;
  if (has_fcs) {
    if (n - pos < size_t(fcs_n)) fail(pos, "truncated frame content size");
    fcs = load_le(src + pos, size_t(fcs_n)) + (fcs_n == 2 ? 256 : 0);
    pos += size_t(fcs_n);
  }
  if (single) window = fcs;
  size_t block_cap = window < kBlockMax ? size_t(window) : kBlockMax;
  size_t out_start = out.size();
  if (has_fcs && !out.fixed) out.reserve(out_start + size_t(fcs), pos);
  Frame frame(out, out_start, window, block_cap);
  for (;;) {
    if (n - pos < 3) fail(pos, "truncated block header");
    uint32_t bh = uint32_t(load_le(src + pos, 3));
    size_t at = pos;
    pos += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) fail(at, "reserved block type");
    if (type == 1) {
      if (size > block_cap) fail(at, "RLE block above the block size limit");
      if (pos >= n) fail(pos, "truncated RLE block");
      std::memset(out.extend(size, at), src[pos], size);
      pos += 1;
    } else {
      if (size > (type == 0 ? block_cap : kBlockMax)) fail(at, "block above the block size limit");
      if (n - pos < size) fail(pos, "truncated block");
      if (type == 0) {
        out.append(src + pos, size, at);
      } else {
        frame.compressed_block(src + pos, size, pos);
      }
      pos += size;
    }
    if (has_fcs && out.size() - out_start > fcs) fail(at, "frame decodes past its content size");
    if (last) break;
  }
  if (has_fcs && out.size() - out_start != fcs)
    fail(pos, "frame decodes to " + std::to_string(out.size() - out_start) + " bytes, its header says " +
                  std::to_string(fcs));
  if (checksum) {
    if (n - pos < 4) fail(pos, "truncated content checksum");
    uint32_t want = uint32_t(load_le(src + pos, 4));
    uint32_t got = uint32_t(xxh64(out.data() + out_start, out.size() - out_start));
    if (want != got) fail(pos, "content checksum mismatch");
    pos += 4;
  }
  return pos;
}

void decode_all(const uint8_t* src, size_t n, Buf& out) {
  size_t pos = 0;
  if (n == 0) fail(0, "no zstd frame");
  while (pos < n) {
    if (n - pos < 4) fail(pos, "truncated frame magic");
    uint32_t magic = uint32_t(load_le(src + pos, 4));
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
      if (n - pos < 8) fail(pos, "truncated skippable frame");
      uint64_t size = load_le(src + pos + 4, 4);
      if (n - pos - 8 < size) fail(pos, "truncated skippable frame");
      pos += 8 + size_t(size);
    } else if (magic == kMagic) {
      pos = decode_frame(src, n, pos, out);
    } else {
      fail(pos, "not a zstd frame");
    }
  }
}

void set_error(char* err, size_t cap, const std::string& msg) {
  if (err && cap) std::snprintf(err, cap, "%s", msg.c_str());
}

int run(const uint8_t* src, size_t n, Buf& out, char* err, size_t errcap) {
  try {
    decode_all(src, n, out);
    return 0;
  } catch (const Failure& f) {
    set_error(err, errcap, "zstd: " + f.what + " at byte " + std::to_string(f.offset));
  } catch (const std::bad_alloc&) {
    set_error(err, errcap, "zstd: out of memory");
  }
  return 1;
}

}  // namespace

extern "C" {

// Decodes every frame of src into a buffer allocated with malloc (free it
// with msmc_zstd_free). Returns 0, or 1 with a message in err.
int msmc_zstd_decompress(const uint8_t* src, size_t n, uint8_t** dst, size_t* dst_n, char* err, size_t errcap) {
  Buf out;
  int rc = run(src, n, out, err, errcap);
  if (rc) return rc;
  *dst = out.p ? out.p : static_cast<uint8_t*>(std::malloc(1));
  *dst_n = out.n;
  out.p = nullptr;  // handed over
  return 0;
}

// Decodes into dst, which the output must fill exactly (cap bytes).
int msmc_zstd_decompress_into(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, char* err, size_t errcap) {
  Buf out(dst, cap);
  int rc = run(src, n, out, err, errcap);
  if (rc) return rc;
  if (out.n != cap) {
    set_error(err, errcap, "zstd: decodes to " + std::to_string(out.n) + " bytes, expected " + std::to_string(cap));
    return 1;
  }
  return 0;
}

void msmc_zstd_free(uint8_t* p) { std::free(p); }

uint32_t msmc_crc32c(const uint8_t* p, size_t n) { return crc32c(p, n); }
}
