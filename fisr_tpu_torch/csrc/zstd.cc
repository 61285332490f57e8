// Zstandard frame decoder of the host runtime (RFC 8878), compiled into the
// same library as native.cc and bound in fisr_tpu_torch/native/bindings.py.
// It reads the chunks of the JAX package's orbax checkpoints (zarr arrays,
// zstd level 1) where no zstd library is installed.
//
// Everything of RFC 8878 but dictionaries:
//   * frames back to back, skippable frames skipped; the window descriptor
//     or a single segment, an optional content size (checked) and an
//     optional xxh64 content checksum (checked);
//   * raw, RLE and compressed blocks;
//   * literals raw, RLE, Huffman-coded (weights FSE-compressed or direct, one
//     or four streams) and treeless (the previous Huffman table);
//   * sequences with predefined, RLE, FSE-compressed and repeat tables, the
//     three repeat offsets with their literal-length-0 rule, and offsets of
//     up to 31 bits.
// A nonzero Dictionary_ID and the legacy frame formats are refused by name.
//
// The caller gives the output's size. Every read is checked against the end
// of its section, every write against the output's size, and every match
// offset against the bytes the frame has produced, so a malformed frame
// returns an error message and never reads or writes out of bounds.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>

namespace {

constexpr int64_t kMaxBlock = 128 << 10;  // Block_Maximum_Size's ceiling
constexpr uint32_t kMagic = 0xFD2FB528u;

struct Failure {
  char msg[256];
};

[[noreturn]] void fail(const char* fmt, ...) {
  Failure f;
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(f.msg, sizeof f.msg, fmt, ap);
  va_end(ap);
  throw f;
}

int highbit(uint64_t v) { return 63 - __builtin_clzll(v); }  // v > 0

uint64_t le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = n - 1; i >= 0; --i) v = (v << 8) | p[i];
  return v;
}

// ---------------------------------------------------------------------------
// Readers
// ---------------------------------------------------------------------------

// Bytes read forward, each read checked against the end.
struct Input {
  const uint8_t* p;
  int64_t n;
  int64_t pos = 0;
  Input(const uint8_t* p_, int64_t n_) : p(p_), n(n_) {}
  int64_t left() const { return n - pos; }
  const uint8_t* take(int64_t k, const char* what) {
    if (k < 0 || k > n - pos)
      fail("%s: needs %lld bytes, %lld remain", what, (long long)k, (long long)(n - pos));
    const uint8_t* r = p + pos;
    pos += k;
    return r;
  }
  uint64_t le_n(int k, const char* what) { return le(take(k, what), k); }
  uint8_t byte(const char* what) { return *take(1, what); }
};

// A bitstream read forward from bit 0 (FSE table descriptions); bits past
// the end read as 0, and the caller checks how far it went.
struct ForwardBits {
  const uint8_t* p;
  int64_t n;
  int64_t bitpos = 0;
  uint32_t peek(int nb) const {
    uint64_t w = 0;
    int64_t k = bitpos >> 3;
    for (int i = 0; i < 4 && k + i < n; ++i) w |= uint64_t(p[k + i]) << (8 * i);
    return uint32_t((w >> (bitpos & 7)) & ((1u << nb) - 1));
  }
  uint32_t read(int nb) {
    uint32_t v = peek(nb);
    bitpos += nb;
    return v;
  }
};

// A bitstream read backward from its end mark (the highest set bit of its
// last byte): bits [0, bitpos) are unread; bits below 0 read as 0, and the
// caller checks that the stream ended exactly.
struct BackwardBits {
  const uint8_t* p;
  int64_t bitpos;
  BackwardBits(const uint8_t* p_, int64_t n, const char* what) : p(p_) {
    if (n <= 0) fail("%s: empty bitstream", what);
    if (!p[n - 1]) fail("%s: the bitstream's last byte is 0 (no end mark)", what);
    bitpos = 8 * (n - 1) + highbit(p[n - 1]);
  }
  // bits [bitpos - nb, bitpos), nb <= 56
  uint64_t peek(int nb) const {
    if (bitpos <= 0 || nb == 0) return 0;
    int64_t hi = (bitpos + 7) >> 3, k = hi - 8;
    uint64_t w = 0;
    if (k >= 0) {
      memcpy(&w, p + k, 8);
    } else {
      k = 0;
      memcpy(&w, p, size_t(hi));
    }
    int64_t start = bitpos - nb - 8 * k;
    uint64_t v = start >= 0 ? w >> start : w << -start;
    return v & ((uint64_t(1) << nb) - 1);
  }
  uint64_t read(int nb) {
    uint64_t v = peek(nb);
    bitpos -= nb;
    return v;
  }
};

// ---------------------------------------------------------------------------
// FSE
// ---------------------------------------------------------------------------

struct FseCell {
  uint16_t base;
  uint8_t symbol;
  uint8_t nbits;
};

struct FseTable {
  int log = -1;  // -1: none yet in this frame
  FseCell cell[1 << 9];
};

// Distribution -> decoding table (RFC 8878 4.1.1).
void build_fse(const int16_t* norm, int nsym, int log, FseTable* t, const char* what) {
  const int size = 1 << log;
  int high = size - 1;
  uint16_t next[256];
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t->cell[high--].symbol = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s)
    for (int i = 0; i < norm[s]; ++i) {
      t->cell[pos].symbol = uint8_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  if (pos != 0) fail("%s: FSE distribution does not fill its table", what);
  for (int u = 0; u < size; ++u) {
    int ns = next[t->cell[u].symbol]++;
    int nb = log - highbit(uint64_t(ns));
    t->cell[u].nbits = uint8_t(nb);
    t->cell[u].base = uint16_t((ns << nb) - size);
  }
  t->log = log;
}

// A one-symbol table (RLE mode).
void rle_fse(int symbol, FseTable* t) {
  t->cell[0] = {0, uint8_t(symbol), 0};
  t->log = 0;
}

// An FSE table description (RFC 8878 4.1.1) at the start of `in`: the
// distribution into norm[0..*nsym), its accuracy log into *log. Returns the
// bytes it took.
int64_t read_fse_description(const uint8_t* p, int64_t n, int max_symbol, int max_log,
                             int16_t* norm, int* nsym, int* log, const char* what) {
  if (n < 1) fail("%s: FSE table description truncated", what);
  ForwardBits in{p, n};
  *log = int(in.read(4)) + 5;
  if (*log > max_log) fail("%s: FSE accuracy log %d exceeds %d", what, *log, max_log);
  int remaining = (1 << *log) + 1, threshold = 1 << *log, nbits = *log + 1;
  int s = 0;
  bool previous0 = false;
  while (remaining > 1 && s <= max_symbol) {
    if (previous0) {
      for (uint32_t r = 3; r == 3;) {
        r = in.read(2);
        for (uint32_t i = 0; i < r; ++i) {
          if (s > max_symbol) fail("%s: FSE distribution has more than %d symbols", what,
                                   max_symbol + 1);
          norm[s++] = 0;
        }
        if (in.bitpos > 8 * n) fail("%s: FSE table description truncated", what);
      }
      if (s > max_symbol) fail("%s: FSE distribution has more than %d symbols", what,
                               max_symbol + 1);
    }
    const int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t v = in.peek(nbits);
    if (int(v & uint32_t(threshold - 1)) < max) {
      count = int(v & uint32_t(threshold - 1));
      in.bitpos += nbits - 1;
    } else {
      count = int(v & uint32_t(2 * threshold - 1));
      if (count >= threshold) count -= max;
      in.bitpos += nbits;
    }
    --count;  // -1: "less than 1", one cell
    remaining -= count < 0 ? -count : count;
    if (remaining < 1) fail("%s: FSE distribution overflows its table", what);
    norm[s++] = int16_t(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("%s: FSE distribution does not sum to its table size", what);
  int64_t used = (in.bitpos + 7) >> 3;
  if (used > n) fail("%s: FSE table description truncated", what);
  *nsym = s;
  return used;
}

// ---------------------------------------------------------------------------
// Sequence codes (RFC 8878 3.1.1.3.2.1) and predefined distributions
// ---------------------------------------------------------------------------

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,   4,   5,   6,    7,    8,    9,    10,    11,    12,   13,
                              14,  15,  16,  17,   18,   19,   20,   21,    22,    23,   24,
                              25,  26,  27,  28,   29,   30,   31,   32,    33,    34,   35,
                              37,  39,  41,  43,   47,   51,   59,   67,    83,    99,   131,
                              259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// ---------------------------------------------------------------------------
// Huffman literals (RFC 8878 4.2)
// ---------------------------------------------------------------------------

constexpr int kMaxHuffBits = 11;

struct HuffTable {
  int bits = 0;  // 0: none yet in this frame
  uint8_t symbol[1 << kMaxHuffBits];
  uint8_t nbits[1 << kMaxHuffBits];
};

// Huffman weights compressed with FSE: two interleaved states over one
// backward bitstream, until an update reads past its start (the reference
// decoder's rule for the number of weights).
int fse_weights(const uint8_t* p, int64_t n, uint8_t* w) {
  int16_t norm[256];
  int nsym, log;
  FseTable table;
  const FseTable* t = &table;
  int64_t used = read_fse_description(p, n, 255, 6, norm, &nsym, &log, "Huffman weights");
  build_fse(norm, nsym, log, &table, "Huffman weights");
  BackwardBits bits(p + used, n - used, "Huffman weights");
  uint32_t s1 = uint32_t(bits.read(log)), s2 = uint32_t(bits.read(log));
  int k = 0;
  for (;;) {
    if (k > 253) fail("Huffman weights: more than 255");
    w[k++] = t->cell[s1].symbol;
    s1 = t->cell[s1].base + uint32_t(bits.read(t->cell[s1].nbits));
    if (bits.bitpos < 0) {
      w[k++] = t->cell[s2].symbol;
      break;
    }
    if (k > 253) fail("Huffman weights: more than 255");
    w[k++] = t->cell[s2].symbol;
    s2 = t->cell[s2].base + uint32_t(bits.read(t->cell[s2].nbits));
    if (bits.bitpos < 0) {
      w[k++] = t->cell[s1].symbol;
      break;
    }
  }
  return k;
}

// A Huffman tree description at the start of `in` -> `t`.
void read_huffman_tree(Input& in, HuffTable* t) {
  uint8_t w[256];
  int nw;
  uint8_t header = in.byte("Huffman tree description");
  if (header >= 128) {
    nw = header - 127;
    const uint8_t* p = in.take((nw + 1) / 2, "Huffman weights");
    for (int i = 0; i < nw; ++i) w[i] = i & 1 ? p[i / 2] & 15 : p[i / 2] >> 4;
  } else {
    if (header == 0) fail("Huffman weights: FSE-compressed size 0");
    nw = fse_weights(in.take(header, "Huffman weights"), header, w);
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > kMaxHuffBits) fail("Huffman weight %d exceeds %d", w[i], kMaxHuffBits);
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (!total) fail("Huffman weights are all 0");
  const int bits = highbit(total) + 1;
  if (bits > kMaxHuffBits) fail("Huffman codes of %d bits exceed %d", bits, kMaxHuffBits);
  const uint32_t rest = (1u << bits) - total;
  if (rest & (rest - 1)) fail("Huffman weights leave %u, not a power of 2", rest);
  w[nw++] = uint8_t(highbit(rest) + 1);  // the last symbol's, implied
  int count[kMaxHuffBits + 2] = {0};
  for (int i = 0; i < nw; ++i) ++count[w[i]];
  if (count[1] < 2 || (count[1] & 1)) fail("Huffman weights: %d of weight 1", count[1]);
  int start[kMaxHuffBits + 2];
  start[1] = 0;
  for (int k = 1; k <= kMaxHuffBits; ++k) start[k + 1] = start[k] + (count[k] << (k - 1));
  for (int s = 0; s < nw; ++s) {
    if (!w[s]) continue;
    const int len = 1 << (w[s] - 1), nb = bits + 1 - w[s];
    memset(t->symbol + start[w[s]], s, size_t(len));
    memset(t->nbits + start[w[s]], nb, size_t(len));
    start[w[s]] += len;
  }
  t->bits = bits;
}

void huffman_stream(const HuffTable& t, const uint8_t* p, int64_t n, uint8_t* out, int64_t count) {
  BackwardBits bits(p, n, "Huffman literals stream");
  const int b = t.bits;
  int64_t i = 0;
  // 5 symbols (at most 55 bits) from each 8-byte load while 8 bytes lie
  // below the unread bits' top
  for (; count - i >= 5 && bits.bitpos >= 64; i += 5) {
    const int64_t k = (bits.bitpos - 56) >> 3;
    uint64_t w;
    memcpy(&w, p + k, 8);
    w <<= 64 - (bits.bitpos - 8 * k);  // the unread bits at the top
    for (int j = 0; j < 5; ++j) {
      const uint32_t v = uint32_t(w >> (64 - b));
      out[i + j] = t.symbol[v];
      w <<= t.nbits[v];
      bits.bitpos -= t.nbits[v];
    }
  }
  for (; i < count; ++i) {
    uint32_t v = uint32_t(bits.peek(b));
    out[i] = t.symbol[v];
    bits.bitpos -= t.nbits[v];
  }
  if (bits.bitpos != 0)
    fail("Huffman literals stream: %lld bits %s after %lld literals",
         (long long)(bits.bitpos < 0 ? -bits.bitpos : bits.bitpos),
         bits.bitpos < 0 ? "missing" : "left", (long long)count);
}

// ---------------------------------------------------------------------------
// Frames and blocks
// ---------------------------------------------------------------------------

struct Frame {
  HuffTable huff;
  FseTable ll, of, ml;
  uint64_t rep[3];
  uint8_t literals[kMaxBlock];
  void reset() {
    huff.bits = 0;
    ll.log = of.log = ml.log = -1;
    rep[0] = 1;
    rep[1] = 4;
    rep[2] = 8;
  }
};

struct Output {
  uint8_t* p;
  int64_t cap;
  int64_t pos = 0;
  void room(int64_t k) const {
    if (k > cap - pos) fail("the frames decode to more than %lld bytes", (long long)cap);
  }
};

// The literals section at the start of `in` -> f->literals; returns their count.
int64_t read_literals(Input& in, Frame* f) {
  const uint8_t b0 = in.byte("literals section header");
  const int type = b0 & 3, size_format = (b0 >> 2) & 3;
  int64_t regen, comp = 0;
  int streams = 1;
  if (type < 2) {  // raw, RLE
    if (size_format == 0 || size_format == 2) {
      regen = b0 >> 3;
    } else if (size_format == 1) {
      regen = (b0 >> 4) + (int64_t(in.byte("literals section header")) << 4);
    } else {
      const uint8_t* h = in.take(2, "literals section header");
      regen = (b0 >> 4) + (int64_t(h[0]) << 4) + (int64_t(h[1]) << 12);
    }
  } else {  // Huffman, treeless
    const int extra = size_format < 2 ? 2 : size_format == 2 ? 3 : 4;
    const uint64_t v = b0 | (in.le_n(extra, "literals section header") << 8);
    const int field = size_format < 2 ? 10 : size_format == 2 ? 14 : 18;
    regen = int64_t((v >> 4) & ((1u << field) - 1));
    comp = int64_t((v >> (4 + field)) & ((1u << field) - 1));
    streams = size_format == 0 ? 1 : 4;
  }
  if (regen > kMaxBlock) fail("literals section of %lld bytes exceeds 128 KiB", (long long)regen);
  if (type == 0) {
    memcpy(f->literals, in.take(regen, "raw literals"), size_t(regen));
  } else if (type == 1) {
    memset(f->literals, in.byte("RLE literals"), size_t(regen));
  } else {
    Input sec(in.take(comp, "Huffman literals"), comp);
    if (type == 2) {
      read_huffman_tree(sec, &f->huff);
    } else if (!f->huff.bits) {
      fail("treeless literals without an earlier Huffman table in the frame");
    }
    if (streams == 1) {
      huffman_stream(f->huff, sec.p + sec.pos, sec.left(), f->literals, regen);
    } else {
      const uint8_t* jump = sec.take(6, "Huffman jump table");
      int64_t sizes[4] = {int64_t(le(jump, 2)), int64_t(le(jump + 2, 2)),
                          int64_t(le(jump + 4, 2)), 0};
      sizes[3] = sec.left() - sizes[0] - sizes[1] - sizes[2];
      if (sizes[3] < 0) fail("Huffman jump table exceeds its %lld bytes", (long long)comp);
      const int64_t seg = (regen + 3) / 4;
      if (regen - 3 * seg < 0) fail("4 Huffman streams for %lld literals", (long long)regen);
      for (int i = 0; i < 4; ++i) {
        const int64_t count = i < 3 ? seg : regen - 3 * seg;
        huffman_stream(f->huff, sec.take(sizes[i], "Huffman stream"), sizes[i],
                       f->literals + i * seg, count);
      }
    }
  }
  return regen;
}

void read_table(Input& in, int mode, int max_symbol, int max_log, const int16_t* def,
                int def_n, int def_log, FseTable* t, const char* what) {
  if (mode == 0) {
    build_fse(def, def_n, def_log, t, what);
  } else if (mode == 1) {
    const uint8_t s = in.byte(what);
    if (s > max_symbol) fail("%s: RLE symbol %d exceeds %d", what, s, max_symbol);
    rle_fse(s, t);
  } else if (mode == 2) {
    int16_t norm[256];
    int nsym, log;
    in.pos += read_fse_description(in.p + in.pos, in.left(), max_symbol, max_log, norm, &nsym,
                                   &log, what);
    build_fse(norm, nsym, log, t, what);
  } else if (t->log < 0) {
    fail("%s: repeat mode without an earlier table in the frame", what);
  }
}

void copy_literals(Output& out, const uint8_t* lit, int64_t n) {
  out.room(n);
  memcpy(out.p + out.pos, lit, size_t(n));
  out.pos += n;
}

void compressed_block(Input in, Frame* f, Output& out, int64_t frame_start,
                      int64_t block_max) {
  const int64_t block_start = out.pos;
  const int64_t nlit = read_literals(in, f);
  const uint8_t b0 = in.byte("sequences section header");
  int64_t nseq = b0;
  if (b0 == 255) {
    nseq = int64_t(in.le_n(2, "sequences section header")) + 0x7F00;
  } else if (b0 >= 128) {
    nseq = (int64_t(b0 - 128) << 8) + in.byte("sequences section header");
  }
  if (nseq == 0) {
    if (in.left()) fail("%lld bytes after a block's empty sequences section",
                        (long long)in.left());
    copy_literals(out, f->literals, nlit);
    return;
  }
  const uint8_t modes = in.byte("symbol compression modes");
  if (modes & 3) fail("symbol compression modes: reserved bits set (0x%02x)", modes);
  read_table(in, modes >> 6, 35, 9, kLLDefault, 36, 6, &f->ll, "literals-length table");
  read_table(in, (modes >> 4) & 3, 31, 8, kOFDefault, 29, 5, &f->of, "offset table");
  read_table(in, (modes >> 2) & 3, 52, 9, kMLDefault, 53, 6, &f->ml, "match-length table");
  BackwardBits bits(in.p + in.pos, in.left(), "sequences bitstream");
  uint32_t ll_state = uint32_t(bits.read(f->ll.log));
  uint32_t of_state = uint32_t(bits.read(f->of.log));
  uint32_t ml_state = uint32_t(bits.read(f->ml.log));
  const uint8_t* lit = f->literals;
  int64_t lit_left = nlit;
  uint64_t* rep = f->rep;
  for (int64_t i = 0; i < nseq; ++i) {
    const FseCell& lc = f->ll.cell[ll_state];
    const FseCell& oc = f->of.cell[of_state];
    const FseCell& mc = f->ml.cell[ml_state];
    const int of_code = oc.symbol;
    const uint64_t of_value = (uint64_t(1) << of_code) + bits.read(of_code);
    const int64_t ml = kMLBase[mc.symbol] + int64_t(bits.read(kMLBits[mc.symbol]));
    const int64_t ll = kLLBase[lc.symbol] + int64_t(bits.read(kLLBits[lc.symbol]));
    uint64_t offset;
    if (of_value > 3) {
      offset = of_value - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      const int idx = int(of_value - 1) + (ll == 0);
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx == 3 ? rep[0] - 1 : rep[idx];
        if (!offset) fail("repeat offset 0");
        if (idx != 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      ll_state = lc.base + uint32_t(bits.read(lc.nbits));
      ml_state = mc.base + uint32_t(bits.read(mc.nbits));
      of_state = oc.base + uint32_t(bits.read(oc.nbits));
    }
    if (ll > lit_left)
      fail("sequence %lld takes %lld literals, %lld remain", (long long)i, (long long)ll,
           (long long)lit_left);
    copy_literals(out, lit, ll);
    lit += ll;
    lit_left -= ll;
    if (offset > uint64_t(out.pos - frame_start))
      fail("match offset %llu reaches before the %lld bytes the frame has decoded",
           (unsigned long long)offset, (long long)(out.pos - frame_start));
    out.room(ml);
    uint8_t* dst = out.p + out.pos;
    const uint8_t* src = dst - offset;
    if (offset >= uint64_t(ml)) {
      memcpy(dst, src, size_t(ml));
    } else {
      for (int64_t k = 0; k < ml; ++k) dst[k] = src[k];
    }
    out.pos += ml;
  }
  if (bits.bitpos != 0)
    fail("sequences bitstream: %lld bits %s after %lld sequences",
         (long long)(bits.bitpos < 0 ? -bits.bitpos : bits.bitpos),
         bits.bitpos < 0 ? "missing" : "left", (long long)nseq);
  copy_literals(out, lit, lit_left);
  if (out.pos - block_start > block_max)
    fail("a block decodes to %lld bytes, more than Block_Maximum_Size %lld",
         (long long)(out.pos - block_start), (long long)block_max);
}

// ---- xxh64 (seed 0), the content checksum ----------------------------------

constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;

uint64_t rotl(uint64_t v, int r) { return (v << r) | (v >> (64 - r)); }
uint64_t xxh_round(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }
uint64_t xxh_merge(uint64_t h, uint64_t v) { return (h ^ xxh_round(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, int64_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v[4] = {P1 + P2, P2, 0, 0 - P1};
    for (; end - p >= 32; p += 32)
      for (int i = 0; i < 4; ++i) v[i] = xxh_round(v[i], le(p + 8 * i, 8));
    h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
    for (int i = 0; i < 4; ++i) h = xxh_merge(h, v[i]);
  } else {
    h = P5;
  }
  h += uint64_t(n);
  for (; end - p >= 8; p += 8) h = rotl(h ^ xxh_round(0, le(p, 8)), 27) * P1 + P4;
  if (end - p >= 4) {
    h = rotl(h ^ (le(p, 4) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

void frame(Input& in, Frame* f, Output& out) {
  const int64_t start = out.pos;
  const uint8_t fhd = in.byte("frame header");
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
  if (fhd & 8) fail("frame header: reserved bit set (0x%02x)", fhd);
  uint64_t window = 0;
  if (!single) {
    const uint8_t wd = in.byte("window descriptor");
    const uint64_t base = uint64_t(1) << (10 + (wd >> 3));
    window = base + base / 8 * (wd & 7);
  }
  static const int kDidBytes[4] = {0, 1, 2, 4};
  const uint64_t did = in.le_n(kDidBytes[fhd & 3], "Dictionary_ID");
  if (did)
    fail("frame names Dictionary_ID %llu: dictionaries are not supported",
         (unsigned long long)did);
  static const int kFcsBytes[4] = {0, 2, 4, 8};
  const int fcs_bytes = fcs_flag == 0 ? single : kFcsBytes[fcs_flag];
  const bool has_fcs = fcs_bytes > 0;
  uint64_t fcs = in.le_n(fcs_bytes, "Frame_Content_Size");
  if (fcs_bytes == 2) fcs += 256;
  if (single) window = fcs;
  // Block_Maximum_Size: no block holds or decodes to more
  const int64_t block_max = int64_t(window < uint64_t(kMaxBlock) ? window : kMaxBlock);
  f->reset();
  for (bool last = false; !last;) {
    const uint32_t h = uint32_t(in.le_n(3, "block header"));
    last = h & 1;
    const int type = (h >> 1) & 3;
    const int64_t size = h >> 3;
    if (type == 3) fail("block type 3 is reserved");
    if (size > block_max)
      fail("block of %lld bytes exceeds Block_Maximum_Size %lld", (long long)size,
           (long long)block_max);
    if (type == 0) {
      copy_literals(out, in.take(size, "raw block"), size);
    } else if (type == 1) {
      const uint8_t b = in.byte("RLE block");
      out.room(size);
      memset(out.p + out.pos, b, size_t(size));
      out.pos += size;
    } else {
      compressed_block(Input(in.take(size, "compressed block"), size), f, out, start,
                       block_max);
    }
  }
  const int64_t produced = out.pos - start;
  if (has_fcs && uint64_t(produced) != fcs)
    fail("frame decodes to %lld bytes, its header says %llu", (long long)produced,
         (unsigned long long)fcs);
  if (checksum) {
    const uint32_t want = uint32_t(in.le_n(4, "content checksum"));
    const uint32_t got = uint32_t(xxh64(out.p + start, produced));
    if (got != want) fail("content checksum mismatch: 0x%08x, the frame says 0x%08x", got, want);
  }
}

int64_t decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  if (n <= 0) fail("no zstd frame in 0 bytes");
  Input in(src, n);
  Output out{dst, cap};
  Frame* f = new Frame;  // 140 KiB: off the caller's stack
  struct Free {
    Frame* f;
    ~Free() { delete f; }
  } guard{f};
  while (in.left()) {
    const uint32_t magic = uint32_t(in.le_n(4, "frame magic"));
    if (magic == kMagic) {
      frame(in, f, out);
    } else if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      in.take(int64_t(in.le_n(4, "skippable frame size")), "skippable frame");
    } else if (magic == 0xFD2FB51Eu || (magic >= 0xFD2FB522u && magic <= 0xFD2FB527u)) {
      fail("legacy zstd frame (magic 0x%08X, format v0.%u) is not supported", magic,
           magic == 0xFD2FB51Eu ? 1u : magic - 0xFD2FB520u);
    } else {
      fail("not a zstd frame: magic 0x%08X at byte %lld", magic, (long long)(in.pos - 4));
    }
  }
  return out.pos;
}

}  // namespace

extern "C" {

// Decodes the frames of src[0, n) into dst, at most cap bytes; *size = the
// bytes they decode to. Returns 0, or 1 with the reason in msg (256 bytes).
int fisr_zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                         int64_t* size, char* msg) {
  try {
    *size = decompress(src, n, dst, cap);
    return 0;
  } catch (const Failure& e) {
    snprintf(msg, 256, "%s", e.msg);
  } catch (const std::bad_alloc&) {
    snprintf(msg, 256, "no memory to decode the zstd frame");
  }
  return 1;
}

}  // extern "C"
