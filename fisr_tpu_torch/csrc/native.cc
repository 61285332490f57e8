// Host runtime of the port: the data path's CPU work in threaded C++, bound
// with ctypes through fisr_tpu_torch/native/bindings.py.
//
//   * PNG decode (8-bit grey, grey + alpha, RGB, RGBA, palette; not
//     interlaced; every filter type) from a path or a buffer, and a batch of
//     same-sized files decoded on threads into one [n, h, w, 3] array. It
//     accepts and rejects what data/png_io.decode_png does, in the same
//     order, and says why in the code and `info` it returns.
//   * PNG encode of u8 RGB, one IDAT, by a deflate coder of its own: strips
//     of 32 rows coded on the kept thread pool, each unfiltered or
//     Up-filtered by a sample's entropy, one dynamic-Huffman block of
//     literals and of matches 1 byte or 1, 2, 4 or 8 pixels back (or stored
//     blocks), joined under one zlib header and written straight into the
//     caller's buffer. The same bytes at every thread count; data/png_io's
//     pixels, not its bytes.
//   * u8 colour: out = trunc(clip(M x + B, 0, 255)) in double, M and B passed
//     in, summed left to right (the build has -ffp-contract=off, so no FMA):
//     the bits of each numpy version whose constants it is given.
//   * a threaded row gather, halo patch extraction, slice-by-8 crc32c.
//   * a flow training sample in one pass: crop, flips, shift, resize by a
//     ratio kept at size, and / 255, read from the u8 pair and f32 flow and
//     written as f32 (data/augment.apply_plan's bits: its float64 bilinear
//     expression term for term, rounded to float32 where numpy rounds).
//   * a batch of zstd buffers decoded on threads by csrc/zstd.cc's decoder
//     (compiled into the same library).
//
// Links zlib only. Work runs on the host's cores; the encoder takes a cap
// on its threads.

#include <emmintrin.h>
#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <functional>
#include <memory>
#include <mutex>
#include <new>
#include <system_error>
#include <thread>
#include <vector>

#include <sys/stat.h>
#include <unistd.h>

namespace {

int resolve_threads(int threads) {
  if (threads > 0) return threads;
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 4;
}

// fn(i) for i in [0, n) on up to `threads` threads (0: the host's cores)
// pulling indices in turn.
template <typename F>
void parallel_for(int64_t n, int threads, F fn) {
  int nt = static_cast<int>(std::min<int64_t>(resolve_threads(threads), n));
  if (nt <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t)
    pool.emplace_back([&] {
      for (int64_t i; (i = next.fetch_add(1)) < n;) fn(i);
    });
  for (auto& th : pool) th.join();
}

// parallel_for on threads kept for the process: the host's cores less one,
// started at first use (anew in a forked child, which inherits no threads),
// with the calling thread taking indices too, and at most `threads` in all
// (0: every one). For passes of a millisecond or two, where starting threads
// on each call costs as much as the work, and for callers on several threads
// at once, which then never put more threads to work than the host has
// cores. One run at a time. A run ends once its indices are done: a worker
// that wakes after the caller has taken the last index stays out, so a busy
// host's late workers hold no run up. A run that throws rethrows its first
// exception in the caller once every index is done.
class Pool {
 public:
  static void run(int64_t n, const std::function<void(int64_t)>& fn, int threads = 0) {
    static std::mutex make;
    static Pool* pool = nullptr;  // never freed: its threads live as long as the process
    Pool* p;
    {
      std::lock_guard<std::mutex> lock(make);
      if (pool == nullptr || pool->pid_ != getpid()) {
        pool = new Pool();
        pool->start(resolve_threads(0) - 1);
      }
      p = pool;
    }
    p->go(n, fn, threads);
  }

 private:
  Pool() : pid_(getpid()) {}

  // as many workers as the system lets start, up to `workers`
  void start(int workers) {
    for (int k = 0; k < workers; ++k) {
      try {
        std::thread([this] { serve(); }).detach();
      } catch (const std::system_error&) {
        break;
      }
    }
  }

  void go(int64_t n, const std::function<void(int64_t)>& fn, int threads) {
    std::lock_guard<std::mutex> one_run(run_);
    {
      std::lock_guard<std::mutex> lock(mu_);
      job_ = &fn;
      n_ = n;
      next_ = 0;
      helpers_ = threads > 0 ? threads - 1 : INT32_MAX;
      joined_ = 0;
      open_ = true;
      error_ = nullptr;
      ++round_;
    }
    wake_.notify_all();
    take();
    std::unique_lock<std::mutex> lock(mu_);
    open_ = false;  // every index is taken: later workers stay out
    done_.wait(lock, [&] { return active_ == 0; });
    job_ = nullptr;
    if (error_) std::rethrow_exception(error_);
  }

  // indices in turn until none is left
  void take() {
    for (int64_t i; (i = next_.fetch_add(1)) < n_;) {
      try {
        (*job_)(i);
      } catch (...) {
        std::lock_guard<std::mutex> lock(mu_);
        if (!error_) error_ = std::current_exception();
      }
    }
  }

  void serve() {
    uint64_t seen = 0;
    for (;;) {
      {
        std::unique_lock<std::mutex> lock(mu_);
        wake_.wait(lock, [&] { return open_ && round_ != seen; });
        seen = round_;
        if (joined_ >= helpers_) continue;
        ++joined_;
        ++active_;
      }
      take();
      std::lock_guard<std::mutex> lock(mu_);
      if (--active_ == 0) done_.notify_one();
    }
  }

  const pid_t pid_;
  std::mutex run_, mu_;
  std::condition_variable wake_, done_;
  const std::function<void(int64_t)>* job_ = nullptr;
  int64_t n_ = 0;
  std::atomic<int64_t> next_{0};
  int helpers_ = 0, joined_ = 0, active_ = 0;
  bool open_ = false;
  uint64_t round_ = 0;
  std::exception_ptr error_;
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

void put_be32(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v >> 24);
  p[1] = uint8_t(v >> 16);
  p[2] = uint8_t(v >> 8);
  p[3] = uint8_t(v);
}

// ---------------------------------------------------------------------------
// crc32c (Castagnoli, reflected 0x82F63B78), slice-by-8
// ---------------------------------------------------------------------------

struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (int i = 0; i < 256; ++i) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Crc32cTables& crc32c_tables() {
  static const Crc32cTables tables;  // built once, thread-safe
  return tables;
}

// ---------------------------------------------------------------------------
// PNG decode
// ---------------------------------------------------------------------------

const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
const int64_t kMaxPixels = 178956970;  // png_io._MAX_PIXELS (PIL's bomb limit)

// Status codes, shared with bindings.py. `info` (8 x int64) carries the
// numbers each message needs: w, h, depth, colour type, interlace, bytes
// inflated (at most want + 1), bytes the header says, and one extra value
// (the chunk length, the largest filter type).
enum Status {
  kOk = 0,
  kNotPng = 1,        // signature
  kIhdrLength = 2,    // IHDR body not 13 bytes (info[7] = its length)
  kPlteLength = 3,    // PLTE body not a multiple of 3 (info[7])
  kNoIhdr = 4,
  kFormat = 5,        // not 8-bit, unknown colour type, or interlaced
  kTooLarge = 6,      // more than kMaxPixels
  kZlib = 7,          // inflate error (msg filled)
  kSize = 8,          // inflated bytes != what the header says
  kFilter = 9,        // a row's filter type > 4 (info[7] = the largest)
  kNoPlte = 10,       // palette image without PLTE
  kSpace = 11,        // `out` holds fewer than w * h * 3 bytes (info[0..1] set)
  kShape = 12,        // batch: a frame not of the batch's size
  kMemory = 13,
  kIo = 14,           // file could not be opened or read (info[7] = errno)
};

int channels_of(int ctype) {
  switch (ctype) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p, pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo row `f`'s filter on `raw` (n bytes) into `cur`, `prev` the row above.
void unfilter_row(int f, const uint8_t* raw, const uint8_t* prev, uint8_t* cur, int64_t n,
                  int bpp) {
  switch (f) {
    case 0:
      std::memcpy(cur, raw, n);
      break;
    case 1:
      for (int64_t i = 0; i < n; ++i) cur[i] = uint8_t(raw[i] + (i >= bpp ? cur[i - bpp] : 0));
      break;
    case 2:
      for (int64_t i = 0; i < n; ++i) cur[i] = uint8_t(raw[i] + prev[i]);
      break;
    case 3:
      for (int64_t i = 0; i < n; ++i)
        cur[i] = uint8_t(raw[i] + (((i >= bpp ? cur[i - bpp] : 0) + prev[i]) >> 1));
      break;
    default:
      for (int64_t i = 0; i < bpp && i < n; ++i) cur[i] = uint8_t(raw[i] + prev[i]);
      for (int64_t i = bpp; i < n; ++i)
        cur[i] = uint8_t(raw[i] + paeth(cur[i - bpp], prev[i], prev[i - bpp]));
  }
}

void zlib_message(char* msg, int code, const char* zmsg) {
  if (!msg) return;
  if (!zmsg) {  // the text Python's zlib module gives when zlib gives none
    if (code == Z_BUF_ERROR) zmsg = "incomplete or truncated stream";
    if (code == Z_STREAM_ERROR) zmsg = "inconsistent stream state";
    if (code == Z_DATA_ERROR) zmsg = "invalid input data";
  }
  if (zmsg)
    std::snprintf(msg, 256, "Error %d while decompressing data: %.200s", code, zmsg);
  else
    std::snprintf(msg, 256, "Error %d while decompressing data", code);
}

// png_io.decode_png on a buffer: out[h, w, 3] u8 RGB.
int decode_buffer(const uint8_t* d, int64_t n, uint8_t* out, int64_t cap, int64_t* info,
                  char* msg) {
  std::fill(info, info + 8, int64_t(0));
  if (n < 8 || std::memcmp(d, kSig, 8) != 0) return kNotPng;
  bool have_hdr = false;
  const uint8_t* plte = nullptr;
  int64_t plte_len = 0;
  uint32_t w = 0, h = 0;
  int depth = 0, ctype = 0, interlace = 0;
  std::vector<std::pair<const uint8_t*, int64_t>> idat;
  for (int64_t pos = 8; pos + 8 <= n;) {
    int64_t len = be32(d + pos);
    const uint8_t* tag = d + pos + 4;
    const uint8_t* body = d + pos + 8;
    int64_t body_len = std::min(len, n - (pos + 8));  // a short last chunk is cut, as a slice
    if (!std::memcmp(tag, "IHDR", 4)) {
      if (body_len != 13) {
        info[7] = body_len;
        return kIhdrLength;
      }
      w = be32(body);
      h = be32(body + 4);
      depth = body[8];
      ctype = body[9];
      interlace = body[12];
      have_hdr = true;
    } else if (!std::memcmp(tag, "PLTE", 4)) {
      if (body_len % 3) {
        info[7] = body_len;
        return kPlteLength;
      }
      plte = body;
      plte_len = body_len;
    } else if (!std::memcmp(tag, "IDAT", 4)) {
      idat.emplace_back(body, body_len);
    } else if (!std::memcmp(tag, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (!have_hdr) return kNoIhdr;
  info[0] = w;
  info[1] = h;
  info[2] = depth;
  info[3] = ctype;
  info[4] = interlace;
  const int bpp = channels_of(ctype);
  if (depth != 8 || bpp == 0 || interlace) return kFormat;
  if (int64_t(w) * int64_t(h) > kMaxPixels) return kTooLarge;
  const int64_t row = int64_t(w) * bpp;
  const int64_t want = int64_t(h) * (1 + row);
  info[6] = want;
  if (cap < int64_t(w) * h * 3) return kSpace;

  // inflate no further than want + 1 bytes, as decompressobj().decompress
  // (data, want + 1) does: later input, and errors in it, are not read
  std::vector<uint8_t> raw(want + 1);
  z_stream zs;
  std::memset(&zs, 0, sizeof zs);
  if (inflateInit(&zs) != Z_OK) return kMemory;
  zs.next_out = raw.data();
  zs.avail_out = uInt(want + 1);
  int err = Z_OK;
  for (size_t k = 0; k < idat.size() && err != Z_STREAM_END && zs.avail_out; ++k) {
    zs.next_in = const_cast<Bytef*>(idat[k].first);
    zs.avail_in = uInt(idat[k].second);
    while (zs.avail_in && zs.avail_out) {
      err = inflate(&zs, Z_SYNC_FLUSH);
      if (err == Z_STREAM_END || err == Z_BUF_ERROR) break;
      if (err != Z_OK) {
        zlib_message(msg, err, zs.msg);
        inflateEnd(&zs);
        return kZlib;
      }
    }
  }
  const int64_t got = int64_t(want + 1) - zs.avail_out;
  inflateEnd(&zs);
  info[5] = got;
  if (got != want) return kSize;

  int max_filter = 0;
  for (int64_t y = 0; y < h; ++y) max_filter = std::max<int>(max_filter, raw[y * (1 + row)]);
  if (max_filter > 4) {
    info[7] = max_filter;
    return kFilter;
  }
  if (ctype == 3 && !plte) return kNoPlte;
  if (row == 0) return kOk;  // w = 0: no pixels
  uint8_t lut[256][3] = {};
  if (plte) std::memcpy(lut, plte, std::min<int64_t>(plte_len, 768));

  std::vector<uint8_t> rows(2 * row);
  uint8_t* prev = rows.data();
  uint8_t* cur = prev + row;
  std::fill(prev, prev + row, uint8_t(0));
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* r = raw.data() + y * (1 + row);
    unfilter_row(r[0], r + 1, prev, cur, row, bpp);
    uint8_t* o = out + y * int64_t(w) * 3;
    switch (ctype) {
      case 2:
        std::memcpy(o, cur, row);
        break;
      case 6:
        for (int64_t x = 0; x < w; ++x) std::memcpy(o + 3 * x, cur + 4 * x, 3);
        break;
      case 3:
        for (int64_t x = 0; x < w; ++x) std::memcpy(o + 3 * x, lut[cur[x]], 3);
        break;
      default:  // grey, grey + alpha
        for (int64_t x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = cur[bpp * x];
    }
    std::swap(prev, cur);
  }
  return kOk;
}

int read_file(const char* path, std::vector<uint8_t>* buf, int64_t* info) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) {
    info[7] = errno;
    return kIo;
  }
  struct stat st;
  int rc = kOk;
  if (fstat(fileno(fp), &st) != 0) {
    info[7] = errno;
    rc = kIo;
  } else if (S_ISDIR(st.st_mode)) {
    info[7] = EISDIR;
    rc = kIo;
  } else {
    buf->resize(st.st_size);
    if (std::fread(buf->data(), 1, buf->size(), fp) != buf->size()) {
      info[7] = errno ? errno : EIO;
      rc = kIo;
    }
  }
  std::fclose(fp);
  return rc;
}

// decode_buffer on the bytes of a file; any allocation failure is kMemory
int decode_file(const char* path, uint8_t* out, int64_t cap, int64_t* info, char* msg) {
  std::fill(info, info + 8, int64_t(0));
  try {
    std::vector<uint8_t> buf;
    int rc = read_file(path, &buf, info);
    return rc == kOk ? decode_buffer(buf.data(), int64_t(buf.size()), out, cap, info, msg) : rc;
  } catch (const std::exception&) {
    return kMemory;
  }
}

// ---------------------------------------------------------------------------
// PNG encode
// ---------------------------------------------------------------------------
//
// A deflate coder for the rows of one RGB frame, after fpng's: the rows cut
// into strips of kStripRows, each coded on its own into one dynamic-Huffman
// block, or into stored blocks where those are no larger. A strip's rows are
// all unfiltered or all Up-filtered (the first row of the frame unfiltered),
// whichever a sample of its rows gives the fewer bits of entropy (Up needs a
// margin: unfiltered rows of the model's outputs repeat at a few pixels, which
// matches take). Matches are looked for at a few fixed distances alone, by
// SIMD compares, no hashing: runs of a byte, and the same bytes 1, 2, 4 and 8
// pixels back; a match is taken from the length at which it costs fewer bits
// than its bytes would as literals, at the sample's entropy. Every strip but
// the last ends byte-aligned with an empty stored block, as zlib's
// Z_FULL_FLUSH, so the strips join under one zlib header, their adler32s
// combined. The strips depend on the frame's height alone, so its bytes do not
// depend on the threads.

constexpr int64_t kStripRows = 32;
constexpr int64_t kSampleStep = 8;      // every 8th row of a strip chooses its filter
constexpr double kUpMargin = 0.5;       // bits a byte by which Up must beat no filter
constexpr int64_t kDists[] = {1, 3, 6, 12, 24};  // a byte, and 1, 2, 4 and 8 pixels back
constexpr int kNumDists = sizeof kDists / sizeof kDists[0];
constexpr int64_t kMinMatch = 4;        // deflate's shortest is 3
constexpr int64_t kMaxMinMatch = 16;    // the shortest match taken, at most
constexpr int64_t kWindowStarts = 48;   // of the 64 positions compared at once
constexpr int64_t kMaxMatch = 258;      // deflate's longest
constexpr int64_t kStoredMax = 65535;
constexpr int kPad = 64;                // bytes read past a strip's filtered rows
constexpr int kSlack = 8;               // bytes BitWriter may write past its end
constexpr int64_t kHead = 43;           // signature, IHDR, IDAT's length and tag, zlib header
constexpr int64_t kTail = 20;           // adler32, IDAT's crc, IEND

// Deflate's length symbols 257..285 of lengths 3..258, with their extra bits.
struct LengthCodes {
  uint16_t sym[kMaxMatch + 1];
  uint8_t bits[kMaxMatch + 1];
  uint16_t extra[kMaxMatch + 1];
  LengthCodes() {
    static const uint16_t base[29] = {3,  4,  5,  6,  7,  8,  9,   10,  11,  13,
                                      15, 17, 19, 23, 27, 31, 35,  43,  51,  59,
                                      67, 83, 99, 115, 131, 163, 195, 227, 258};
    for (int s = 0; s < 29; ++s) {
      const int nbits = s < 8 || s == 28 ? 0 : (s - 4) / 4;
      for (int l = base[s]; l < base[s] + (1 << nbits) && l <= kMaxMatch; ++l) {
        sym[l] = uint16_t(257 + s);  // 258 ends as 285, after 284's range
        bits[l] = uint8_t(nbits);
        extra[l] = uint16_t(l - base[s]);
      }
    }
  }
};

const LengthCodes& length_codes() {
  static const LengthCodes codes;
  return codes;
}

// Deflate's distance symbols 0..29 of distances 1..32768, with their extra
// bits; `of` is the symbol of a distance.
struct DistCodes {
  uint16_t base[30];
  uint8_t bits[30];
  DistCodes() {
    for (int s = 0; s < 30; ++s) {
      bits[s] = uint8_t(s < 4 ? 0 : (s - 2) / 2);
      base[s] = uint16_t(s ? base[s - 1] + (1 << bits[s - 1]) : 1);
    }
  }
  int of(int64_t d) const {
    int s = 0;
    while (s < 29 && base[s + 1] <= d) ++s;
    return s;
  }
};

const DistCodes& dist_codes() {
  static const DistCodes codes;
  return codes;
}

// Code lengths of at most `limit` bits for the n symbols of freq (at least two
// in use), 0 for those unused: Huffman's, the least frequent longest, with
// miniz's repair of the Kraft sum where a code outgrows the limit.
void huffman_lengths(const uint32_t* freq, int n, int limit, uint8_t* len) {
  int sym[288], m = 0;
  for (int s = 0; s < n; ++s) {
    len[s] = 0;
    if (freq[s]) sym[m++] = s;
  }
  std::sort(sym, sym + m,
            [&](int a, int b) { return freq[a] != freq[b] ? freq[a] < freq[b] : a < b; });
  // two queues: leaves in sym's order, inner nodes in the order they are made
  uint64_t wt[2 * 288];
  int parent[2 * 288], depth[2 * 288];
  for (int i = 0; i < m; ++i) wt[i] = freq[sym[i]];
  int leaf = 0, inner = m, made = m;
  auto lightest = [&] {
    return leaf < m && (inner == made || wt[leaf] <= wt[inner]) ? leaf++ : inner++;
  };
  for (; made < 2 * m - 1; ++made) {
    const int a = lightest(), b = lightest();
    wt[made] = wt[a] + wt[b];
    parent[a] = parent[b] = made;
  }
  depth[2 * m - 2] = 0;
  for (int i = 2 * m - 3; i >= 0; --i) depth[i] = depth[parent[i]] + 1;
  int count[16] = {};
  for (int i = 0; i < m; ++i) ++count[std::min(depth[i], limit)];
  uint32_t kraft = 0;
  for (int d = 1; d <= limit; ++d) kraft += uint32_t(count[d]) << (limit - d);
  for (; kraft > (1u << limit); --kraft) {  // a code at the limit goes; a shorter one splits
    --count[limit];
    for (int d = limit - 1; d > 0; --d)
      if (count[d]) {
        --count[d];
        count[d + 1] += 2;
        break;
      }
  }
  for (int d = limit, i = 0; d > 0; --d)
    for (int k = 0; k < count[d]; ++k) len[sym[i++]] = uint8_t(d);
}

// Canonical codes of the lengths, bit-reversed for deflate's LSB-first stream.
void canonical_codes(const uint8_t* len, int n, uint32_t* code) {
  int count[16] = {};
  for (int s = 0; s < n; ++s) ++count[len[s]];
  uint32_t next[16] = {}, c = 0;
  for (int b = 1; b < 16; ++b) next[b] = c = (c + (b > 1 ? count[b - 1] : 0)) << 1;
  for (int s = 0; s < n; ++s) {
    uint32_t v = len[s] ? next[len[s]]++ : 0, r = 0;
    for (int b = 0; b < len[s]; ++b, v >>= 1) r = (r << 1) | (v & 1);
    code[s] = r;
  }
}

// freq's first unused symbols set to 1 until two are in use, so that every
// code is complete: inflate refuses an incomplete code-length code.
void two_in_use(uint32_t* freq, int n) {
  int used = 0;
  for (int s = 0; s < n; ++s) used += freq[s] != 0;
  for (int s = 0; used < 2; ++s)
    if (!freq[s]) freq[s] = 1, ++used;
}

// Deflate's LSB-first bits through a 64-bit buffer, flushed 8 bytes at a time:
// between flushes at most 56 bits.
struct BitWriter {
  uint8_t* p;
  uint64_t buf = 0;
  int n = 0;
  explicit BitWriter(uint8_t* out) : p(out) {}
  void put(uint64_t v, int k) {
    buf |= v << n;
    n += k;
  }
  void flush() {
    std::memcpy(p, &buf, 8);
    const int b = n >> 3;
    p += b;
    buf = b ? buf >> (8 * b) : buf;
    n &= 7;
  }
  void align() { n = (n + 7) & ~7; }
  uint8_t* end() {
    flush();
    return p + ((n + 7) >> 3);
  }
};

// A dynamic block's header after its 3 bits: HLIT, HDIST, HCLEN, the
// code-length code and the run-length coded lengths of both alphabets.
struct BlockHeader {
  int hlit, hdist, hclen, items = 0;
  uint8_t item[286 + 30], item_extra[286 + 30], cl_len[19];
  uint32_t cl_code[19];
  int64_t bits = 14;

  static constexpr uint8_t kOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                         11, 4,  12, 3, 13, 2, 14, 1, 15};
  static constexpr int kExtraBits[19] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 3, 7};

  BlockHeader(const uint8_t* ll, const uint8_t* dl) {
    hlit = 286;
    while (hlit > 257 && !ll[hlit - 1]) --hlit;
    hdist = 30;
    while (hdist > 1 && !dl[hdist - 1]) --hdist;
    uint8_t lens[286 + 30];
    std::memcpy(lens, ll, hlit);
    std::memcpy(lens + hlit, dl, hdist);
    const int n = hlit + hdist;
    auto add = [&](int s, int x) { item[items] = uint8_t(s), item_extra[items++] = uint8_t(x); };
    for (int i = 0; i < n;) {
      const uint8_t l = lens[i];
      int run = 1;
      while (i + run < n && lens[i + run] == l) ++run;
      i += run;
      if (l == 0) {
        for (; run >= 11; run -= std::min(run, 138)) add(18, std::min(run, 138) - 11);
        if (run >= 3) add(17, run - 3), run = 0;
      } else {
        add(l, 0), --run;
        for (; run >= 3; run -= std::min(run, 6)) add(16, std::min(run, 6) - 3);
      }
      for (; run > 0; --run) add(l, 0);
    }
    uint32_t freq[19] = {};
    for (int k = 0; k < items; ++k) ++freq[item[k]];
    two_in_use(freq, 19);
    huffman_lengths(freq, 19, 7, cl_len);
    canonical_codes(cl_len, 19, cl_code);
    hclen = 19;
    while (hclen > 4 && !cl_len[kOrder[hclen - 1]]) --hclen;
    bits += 3 * hclen;
    for (int k = 0; k < items; ++k) bits += cl_len[item[k]] + kExtraBits[item[k]];
  }

  void write(BitWriter* bw) const {
    bw->put(hlit - 257, 5);
    bw->put(hdist - 1, 5);
    bw->put(hclen - 4, 4);
    bw->flush();
    for (int k = 0; k < hclen; ++k) {
      bw->put(cl_len[kOrder[k]], 3);
      bw->flush();
    }
    for (int k = 0; k < items; ++k) {
      bw->put(cl_code[item[k]], cl_len[item[k]]);
      bw->put(item_extra[k], kExtraBits[item[k]]);
      bw->flush();
    }
  }
};

// Row y of img (row bytes a row) as PNG stores it, into r: the filter byte,
// then the row Up-filtered (up) or as it is.
void filter_row(const uint8_t* img, int64_t row, int64_t y, bool up, uint8_t* r) {
  const uint8_t* cur = img + y * row;
  r[0] = up ? 2 : 0;
  if (!up) {
    std::memcpy(r + 1, cur, row);
    return;
  }
  for (int64_t i = 0; i < row; ++i) r[1 + i] = uint8_t(cur[i] - cur[i - row]);
}

// Bits of the order-0 code of the counts (n in all): sum c log2(n / c).
double entropy_bits(const uint32_t* count, int64_t n) {
  double bits = 0;
  for (int k = 0; k < 256; ++k)
    if (count[k]) bits += count[k] * std::log2(double(n) / count[k]);
  return bits;
}

// Rows [y0, y1) of the frame: Up-filtered or not (the frame's first row is
// never), from every kSampleStep-th row; *min_match: the shortest match that
// costs fewer bits than its bytes would as literals, at the sample's entropy
// (a match's codes take ~11 bits).
bool choose_filter(const uint8_t* img, int64_t row, int64_t y0, int64_t y1, int64_t* min_match) {
  uint32_t none[4][256] = {}, up[4][256] = {};  // four of each in turn, as the token counts
  const int64_t first = std::max<int64_t>(1, std::min(y0 + kSampleStep - 1, y1 - 1));
  int64_t n = 0;
  for (int64_t y = first; y < y1; y += kSampleStep, n += row) {
    const uint8_t* cur = img + y * row;
    for (int64_t i = 0; i < row; ++i)
      ++none[i & 3][cur[i]], ++up[i & 3][uint8_t(cur[i] - cur[i - row])];
  }
  for (int k = 0; k < 256; ++k) {
    none[0][k] += none[1][k] + none[2][k] + none[3][k];
    up[0][k] += up[1][k] + up[2][k] + up[3][k];
  }
  const double bits_none = entropy_bits(none[0], n), bits_up = entropy_bits(up[0], n);
  const bool use_up = n && bits_up + kUpMargin * n < bits_none;
  const double per_byte = n ? (use_up ? bits_up : bits_none) / n : 8.0;
  const int64_t worth = int64_t(std::ceil(11.0 / std::max(per_byte, 0.1)));
  *min_match = std::max(kMinMatch, std::min(kMaxMinMatch, worth));
  return use_up;
}

uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// Bit j of the result: p[j] == p[j - d], for j in [0, 64).
uint64_t equal_to_back(const uint8_t* p, int64_t d) {
  uint64_t m = 0;
  for (int k = 0; k < 4; ++k) {
    const uint8_t* q = p + 16 * k;
    const __m128i eq = _mm_cmpeq_epi8(_mm_loadu_si128(reinterpret_cast<const __m128i*>(q)),
                                      _mm_loadu_si128(reinterpret_cast<const __m128i*>(q - d)));
    m |= uint64_t(uint32_t(_mm_movemask_epi8(eq))) << (16 * k);
  }
  return m;
}

// t[0, n) = the bytes p[0, n) as literal tokens, sixteen a store, the first
// sixteen stored whatever n (t holds 16 tokens past n).
uint16_t* literals(const uint8_t* p, int64_t n, uint16_t* t) {
  const __m128i zero = _mm_setzero_si128();
  int64_t k = 0;
  do {
    const __m128i v = _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + k));
    __m128i* out = reinterpret_cast<__m128i*>(t + k);
    _mm_storeu_si128(out, _mm_unpacklo_epi8(v, zero));
    _mm_storeu_si128(out + 1, _mm_unpackhi_epi8(v, zero));
    k += 16;
  } while (k < n);
  return t + n;
}

// Tokens of a strip's filtered bytes f[0, n) (f holds kPad bytes past n): a
// literal is its byte; a match of l bytes at kDists[k] is 256 (k + 1) + l - 3.
// Matches of at least min_match bytes are looked for at the kDists alone:
// each distance's equal bytes over a window of 64 positions at once, whose
// first kWindowStarts may start matches; the bytes before a start go as
// literals, and the longest match there is taken.
uint16_t* tokenize(const uint8_t* f, int64_t n, int64_t min_match, uint16_t* t) {
  int64_t i = std::min(n, kDists[kNumDists - 1]);
  t = literals(f, i, t);
  while (i < n) {
    uint64_t eq[kNumDists], starts = 0;
    for (int k = 0; k < kNumDists; ++k) {  // bit j: min_match bytes from i + j match at kDists[k]
      uint64_t m = eq[k] = equal_to_back(f + i, kDists[k]);
      for (int64_t run = 1, s; run < min_match; run += s)
        m &= m >> (s = std::min(run, min_match - run));
      starts |= m;
    }
    // starts at most kWindowStarts in, whose match fits before n
    const int64_t lim = std::min(kWindowStarts, n - i - min_match + 1);
    starts &= lim > 0 ? (uint64_t(1) << lim) - 1 : 0;
    int64_t p = 0;  // bytes of the window tokenized
    for (uint64_t c; (c = starts >> p << p);) {
      const int64_t q = __builtin_ctzll(c);
      t = literals(f + i + p, q - p, t);
      // each distance's match length within the window, the longest (the
      // nearest of equals) carried on past it: key 8 length + 7 - k
      uint64_t key = 0;
      for (int k = 0; k < kNumDists; ++k) {
        const uint64_t differ = ~(eq[k] >> q);
        const uint64_t m = differ ? __builtin_ctzll(differ) : 64;
        key = std::max(key, m << 3 | (7 - k));
      }
      const int64_t best = 7 - int64_t(key & 7), d = kDists[best];
      int64_t l = int64_t(key >> 3);
      const int64_t most = std::min(kMaxMatch, n - i - q);
      if (l == 64 - q)
        for (uint64_t x; l < most; l += 8)
          if ((x = load64(f + i + q + l) ^ load64(f + i + q + l - d))) {
            l += __builtin_ctzll(x) >> 3;
            break;
          }
      l = std::min(l, most);
      *t++ = uint16_t(256 * (best + 1) + l - 3);
      p = q + l;
      if (p >= 64) break;
    }
    if (p < kWindowStarts) {  // no start left before kWindowStarts
      const int64_t to = std::min(kWindowStarts, n - i);
      t = literals(f + i + p, to - p, t);
      p = to;
    }
    i += p;
  }
  return t;
}

// adler32(adler, p[0, n)) as zlib computes it, sixteen bytes a step: a sums
// the bytes, b the running a, so a step adds 16 a + (16, 15, .., 1) . bytes
// to b.
uint32_t adler32_sse2(uint32_t adler, const uint8_t* p, int64_t n) {
  constexpr uint32_t kMod = 65521;
  constexpr int64_t kSteps = 5552 / 16;  // zlib's NMAX: no 32-bit lane overflows before the modulo
  uint64_t a = adler & 0xFFFF, b = adler >> 16;
  const __m128i zero = _mm_setzero_si128(), w_lo = _mm_set_epi16(9, 10, 11, 12, 13, 14, 15, 16),
                w_hi = _mm_set_epi16(1, 2, 3, 4, 5, 6, 7, 8);
  auto sum32 = [](__m128i v) {
    uint32_t x[4];
    _mm_storeu_si128(reinterpret_cast<__m128i*>(x), v);
    return uint64_t(x[0]) + x[1] + x[2] + x[3];
  };
  while (n >= 16) {
    const int64_t steps = std::min(n / 16, kSteps);
    __m128i s1 = zero, s1_before = zero, s2 = zero;
    for (int64_t k = 0; k < steps; ++k, p += 16) {
      const __m128i v = _mm_loadu_si128(reinterpret_cast<const __m128i*>(p));
      s1_before = _mm_add_epi32(s1_before, s1);
      s1 = _mm_add_epi32(s1, _mm_sad_epu8(v, zero));
      s2 = _mm_add_epi32(s2, _mm_madd_epi16(_mm_unpacklo_epi8(v, zero), w_lo));
      s2 = _mm_add_epi32(s2, _mm_madd_epi16(_mm_unpackhi_epi8(v, zero), w_hi));
    }
    b = (b + 16 * (a * steps + sum32(s1_before)) + sum32(s2)) % kMod;
    a = (a + sum32(s1)) % kMod;
    n -= 16 * steps;
  }
  for (; n > 0; --n) a += *p++, b += a;
  return uint32_t((b % kMod) << 16 | (a % kMod));
}

int64_t stored_size(int64_t n) {
  return n + 5 * std::max<int64_t>(1, (n + kStoredMax - 1) / kStoredMax);
}

int64_t strip_count(int64_t h) { return std::max<int64_t>(1, (h + kStripRows - 1) / kStripRows); }

int64_t strip_rows(int64_t h, int64_t k) {
  return std::max<int64_t>(0, std::min(kStripRows, h - k * kStripRows));
}

// Bytes `out` needs for an h x w frame: the file's own and, per strip, its
// stored size and the slack.
int64_t png_bound(int64_t h, int64_t w) {
  int64_t total = kHead + kTail;
  for (int64_t k = 0, n = strip_count(h); k < n; ++k)
    total += stored_size(strip_rows(h, k) * (1 + 3 * w)) + kSlack;
  return total;
}

struct Strip {
  int64_t bytes = 0;
  uLong adler = 1, crc = 0;
  bool stored = false;
};

// Rows [y0, y1) of img ([h, w, 3] u8) as deflate blocks at dst, which holds
// their stored size and kSlack; the final block when `last`.
Strip code_strip(const uint8_t* img, int64_t w, int64_t y0, int64_t y1, bool last, uint8_t* dst) {
  const LengthCodes& lc = length_codes();
  const DistCodes& dc = dist_codes();
  const int64_t row = 3 * w, n_raw = (y1 - y0) * (1 + row);
  thread_local std::vector<uint8_t> filtered;
  thread_local std::vector<uint16_t> tokens;
  filtered.resize(n_raw + kPad);
  tokens.resize(n_raw + 16);
  uint8_t* f = filtered.data();

  Strip s;
  int64_t min_match;
  const bool up = choose_filter(img, row, y0, y1, &min_match);
  for (int64_t y = y0; y < y1; ++y) filter_row(img, row, y, up && y > 0, f + (y - y0) * (1 + row));
  std::fill(f + n_raw, f + n_raw + kPad, uint8_t(0));
  s.adler = adler32_sse2(1, f, n_raw);
  const uint16_t* end = tokenize(f, n_raw, min_match, tokens.data());

  // four tables in turn, so that a run of one token does not wait on itself
  constexpr int kTokens = 256 * (kNumDists + 1);
  thread_local std::vector<uint32_t> part;
  part.assign(4 * kTokens, 0);
  uint32_t* p4[4] = {&part[0], &part[kTokens], &part[2 * kTokens], &part[3 * kTokens]};
  const uint16_t* t = tokens.data();
  for (; end - t >= 4; t += 4) ++p4[0][t[0]], ++p4[1][t[1]], ++p4[2][t[2]], ++p4[3][t[3]];
  for (; t < end; ++t) ++p4[0][*t];
  for (int k = 0; k < kTokens; ++k) p4[0][k] += p4[1][k] + p4[2][k] + p4[3][k];
  const uint32_t* hist = p4[0];

  uint32_t lf[286] = {}, df[30] = {};
  std::copy(hist, hist + 256, lf);
  lf[256] = 1;  // end of block
  int64_t extra_bits = 0;
  for (int k = 0; k < kNumDists; ++k) {
    const int ds = dc.of(kDists[k]);
    for (int l = kMinMatch; l <= kMaxMatch; ++l) {
      const uint32_t c = hist[256 * (k + 1) + l - 3];
      lf[lc.sym[l]] += c;
      df[ds] += c;
      extra_bits += int64_t(c) * (lc.bits[l] + dc.bits[ds]);
    }
  }
  two_in_use(lf, 286);
  two_in_use(df, 30);
  uint8_t ll[286], dl[30];
  huffman_lengths(lf, 286, 15, ll);
  huffman_lengths(df, 30, 15, dl);
  const BlockHeader head(ll, dl);
  int64_t bits = 3 + head.bits + extra_bits;
  for (int k = 0; k < 286; ++k) bits += int64_t(lf[k]) * ll[k];
  for (int k = 0; k < 30; ++k) bits += int64_t(df[k]) * dl[k];
  const int64_t coded = last ? (bits + 7) / 8 : (bits + 3 + 7) / 8 + 4;

  if (coded < stored_size(n_raw)) {
    uint32_t lcode[286], dcode[30];
    canonical_codes(ll, 286, lcode);
    canonical_codes(dl, 30, dcode);
    // token -> its bits, with their count in the top byte: a literal's code
    // (at most 15 bits), or a match's length code and extra bits, distance
    // code and extra bits (at most 15 + 5 + 4 + 3: five distance symbols in
    // use at most, the farthest with 3 extra bits)
    uint64_t enc[kTokens];
    for (int k = 0; k < 256; ++k) enc[k] = lcode[k] | uint64_t(ll[k]) << 56;
    for (int k = 0; k < kNumDists; ++k) {
      const int ds = dc.of(kDists[k]);
      const uint64_t dbits = dcode[ds] | uint64_t(kDists[k] - dc.base[ds]) << dl[ds];
      for (int l = 3; l <= kMaxMatch; ++l) {
        const int ls = lc.sym[l], n = ll[ls] + lc.bits[l];
        enc[256 * (k + 1) + l - 3] = lcode[ls] | uint64_t(lc.extra[l]) << ll[ls] | dbits << n |
                                     uint64_t(n + dl[ds] + dc.bits[ds]) << 56;
      }
    }
    BitWriter bw(dst);
    bw.put(4 | (last ? 1 : 0), 3);
    head.write(&bw);
    constexpr uint64_t kBits = (uint64_t(1) << 56) - 1;
    for (t = tokens.data(); t < end; t += 2) {  // two tokens, at most 54 bits, a flush
      const uint64_t e0 = enc[t[0]], e1 = end - t > 1 ? enc[t[1]] : 0;
      bw.put(e0 & kBits, int(e0 >> 56));
      bw.put(e1 & kBits, int(e1 >> 56));
      bw.flush();
    }
    bw.put(lcode[256], ll[256]);
    if (!last) {  // an empty stored block: zlib's full flush
      bw.put(0, 3);
      bw.align();
      bw.flush();
      bw.put(0xFFFF0000u, 32);
    }
    s.bytes = bw.end() - dst;
  } else {
    s.stored = true;
    uint8_t* p = dst;
    int64_t done = 0;
    do {
      const int64_t len = std::min(n_raw - done, kStoredMax);
      p[0] = last && done + len == n_raw;
      p[1] = uint8_t(len), p[2] = uint8_t(len >> 8);
      p[3] = uint8_t(~len), p[4] = uint8_t(~len >> 8);
      std::memcpy(p + 5, f + done, len);
      p += 5 + len, done += len;
    } while (done < n_raw);
    s.bytes = p - dst;
  }
  s.crc = crc32(0L, dst, uInt(s.bytes));
  return s;
}

// The PNG file of img ([h, w, 3] u8: signature, IHDR, one IDAT, IEND) into
// out, which holds png_bound(h, w) bytes, its strips on up to `threads`
// threads (0: the host's cores). Returns its length; *stored counts the
// strips in stored blocks.
int64_t encode(const uint8_t* img, int64_t h, int64_t w, int threads, uint8_t* out,
               int64_t* stored) {
  const int64_t row = 1 + 3 * w, n = strip_count(h);
  std::vector<int64_t> slot(n);
  std::vector<Strip> strips(n);
  for (int64_t k = 0, at = kHead; k < n; ++k) {
    slot[k] = at;
    at += stored_size(strip_rows(h, k) * row) + kSlack;
  }
  const std::function<void(int64_t)> job = [&](int64_t k) {
    const int64_t y0 = k * kStripRows;
    strips[k] = code_strip(img, w, y0, y0 + strip_rows(h, k), k == n - 1, out + slot[k]);
  };
  if (threads == 1 || n == 1)
    for (int64_t k = 0; k < n; ++k) job(k);
  else
    Pool::run(n, job, threads);

  std::memcpy(out, kSig, 8);
  put_be32(out + 8, 13);
  std::memcpy(out + 12, "IHDR", 4);
  put_be32(out + 16, uint32_t(w));
  put_be32(out + 20, uint32_t(h));
  const uint8_t ihdr_tail[5] = {8, 2, 0, 0, 0};  // 8-bit RGB, not interlaced
  std::memcpy(out + 24, ihdr_tail, 5);
  put_be32(out + 29, uint32_t(crc32(0L, out + 12, 17)));
  std::memcpy(out + 37, "IDAT", 4);
  out[41] = 0x78, out[42] = 0x01;  // deflate, 32 KiB window, the fastest level
  uLong adler = 1, crc = crc32(0L, out + 37, 6);
  int64_t pos = kHead;
  *stored = 0;
  for (int64_t k = 0; k < n; ++k) {  // the strips closed up, in order
    const Strip& s = strips[k];
    std::memmove(out + pos, out + slot[k], s.bytes);
    pos += s.bytes;
    adler = adler32_combine(adler, s.adler, z_off_t(strip_rows(h, k) * row));
    crc = crc32_combine(crc, s.crc, z_off_t(s.bytes));
    *stored += s.stored;
  }
  put_be32(out + pos, uint32_t(adler));
  crc = crc32(crc, out + pos, 4);
  pos += 4;
  put_be32(out + 33, uint32_t(pos - 41));
  put_be32(out + pos, uint32_t(crc));
  pos += 4;
  const uint8_t iend[12] = {0, 0, 0, 0, 'I', 'E', 'N', 'D', 0xAE, 0x42, 0x60, 0x82};
  std::memcpy(out + pos, iend, 12);
  return pos + 12;
}

// ---------------------------------------------------------------------------
// Flow training sample (data/flow_dataset, data/augment)
// ---------------------------------------------------------------------------

// One axis of a flow sample's crop: n of the source axis from `origin`,
// flipped, and frame 2 shifted by `shift`. For crop index p: the source
// index of frame 1 and the flow (src0) and of frame 2 (src1; -1 where the
// shift exposes zeros). For output index o: the crop indices of its two taps
// (a, b) and b's weight w; without a resize both taps are o, with one (n
// resized to sn and kept at n, augment.scale_keep_size) they and w are
// _resize_bilinear's double expressions, and a = -1 in the zero pad of a
// ratio below 1.
struct Axis {
  std::vector<int64_t> src0, src1, a, b;
  std::vector<double> w;
};

Axis make_axis(int64_t n, int64_t origin, bool flip, int64_t shift, bool scaled, int64_t sn) {
  Axis ax{std::vector<int64_t>(n), std::vector<int64_t>(n), std::vector<int64_t>(n),
          std::vector<int64_t>(n), std::vector<double>(n, 0.0)};
  for (int64_t p = 0; p < n; ++p) {
    const int64_t q = p - shift;
    ax.src0[p] = origin + (flip ? n - 1 - p : p);
    ax.src1[p] = q < 0 || q >= n ? -1 : origin + (flip ? n - 1 - q : q);
  }
  const double step = scaled ? double(n) / double(sn) : 1.0;
  // crop (sn >= n) or pad (sn < n) offset of output index o in the resized axis
  const int64_t off = !scaled ? 0 : sn >= n ? (sn - n) / 2 : -((n - sn) / 2);
  for (int64_t o = 0; o < n; ++o) {
    const int64_t i = o + off;
    if (!scaled) {
      ax.a[o] = ax.b[o] = o;
    } else if (i < 0 || i >= sn) {
      ax.a[o] = ax.b[o] = -1;
    } else {
      double s = (double(i) + 0.5) * step - 0.5;
      s = s < 0.0 ? 0.0 : (s > double(n - 1) ? double(n - 1) : s);
      ax.a[o] = static_cast<int64_t>(std::floor(s));
      ax.b[o] = std::min(ax.a[o] + 1, n - 1);
      ax.w[o] = s - double(ax.a[o]);
    }
  }
  return ax;
}

// u8 value i -> float(i) / 255.0f: a frame's `/ 255` without a resize
const float* u8_unit() {
  static const std::vector<float> table = [] {
    std::vector<float> t(256);
    for (int i = 0; i < 256; ++i) t[i] = float(i) / 255.0f;
    return t;
  }();
  return table.data();
}

}  // namespace

extern "C" {

int fisr_zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                         int64_t* size, char* msg);

// zlib's version string, to compare with the one Python's zlib module uses.
const char* fisr_zlib_version() { return zlibVersion(); }

uint32_t fisr_crc32c(const uint8_t* p, int64_t n, uint32_t crc) {
  const auto& t = crc32c_tables().t;
  crc = ~crc;
  for (; n >= 8; p += 8, n -= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);  // little-endian host
    v ^= crc;
    crc = t[7][v & 0xFF] ^ t[6][(v >> 8) & 0xFF] ^ t[5][(v >> 16) & 0xFF] ^
          t[4][(v >> 24) & 0xFF] ^ t[3][(v >> 32) & 0xFF] ^ t[2][(v >> 40) & 0xFF] ^
          t[1][(v >> 48) & 0xFF] ^ t[0][v >> 56];
  }
  for (; n > 0; --n) crc = (crc >> 8) ^ t[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

// out[i] = src[idx[i]], rows of row_bytes; indices checked by the caller.
void fisr_gather_rows(const uint8_t* src, int64_t row_bytes, const int64_t* idx, int64_t n,
                      uint8_t* out) {
  // on the kept threads: a batch is six calls of a few rows each, where
  // starting a thread a row cost more than its copy
  Pool::run(n, [&](int64_t i) {
    std::memcpy(out + i * row_bytes, src + idx[i] * row_bytes, row_bytes);
  });
}

// out[p] = src[y0s[p]:y0s[p] + ph, x0s[p]:x0s[p] + pw] of src [H, W] pixels
// of px_bytes; rectangles checked by the caller. One job a patch row.
void fisr_extract_patches(const uint8_t* src, int64_t W, int64_t px_bytes,
                          const int64_t* y0s, const int64_t* x0s, int64_t n, int64_t ph,
                          int64_t pw, uint8_t* out) {
  parallel_for(n * ph, 0, [&](int64_t job) {
    const int64_t p = job / ph, r = job % ph;
    std::memcpy(out + job * pw * px_bytes, src + ((y0s[p] + r) * W + x0s[p]) * px_bytes,
                pw * px_bytes);
  });
}

// out[i, r] = trunc(clip(m[r][0] x[i, 0] + m[r][1] x[i, 1] + m[r][2] x[i, 2] + b[r],
// 0, 255)) over n_px pixels of 3 u8, in double, summed in that order.
void fisr_color_u8(const uint8_t* in, uint8_t* out, int64_t n_px, const double* m,
                   const double* b) {
  const int64_t chunk = 1 << 16;
  parallel_for((n_px + chunk - 1) / chunk, 0, [&](int64_t c) {
    const int64_t hi = std::min(n_px, (c + 1) * chunk);
    for (int64_t i = c * chunk; i < hi; ++i) {
      const double x0 = in[3 * i], x1 = in[3 * i + 1], x2 = in[3 * i + 2];
      for (int r = 0; r < 3; ++r) {
        double v = m[3 * r] * x0 + m[3 * r + 1] * x1 + m[3 * r + 2] * x2 + b[r];
        v = v < 0.0 ? 0.0 : (v > 255.0 ? 255.0 : v);
        out[3 * i + r] = static_cast<uint8_t>(v);  // truncation, as astype(uint8)
      }
    }
  });
}

// One flow training sample: the [ch, cw] crop at (y0, x0) of the u8 pair
// [2, H, W, 3] and its f32 flow [H, W, 2], flipped (flip_lr, flip_ud), frame
// 2 shifted by (tx, ty) with zero fill and the flow offset by it (both 0:
// none), resized by `ratio` to [sh, sw] and kept at [ch, cw] when `scaled`;
// the frames / 255 into x_out [2, ch, cw, 3], the flow into y_out
// [ch, cw, 2]. Arguments checked by the caller. One job an output row.
// Returns 0, or kMemory.
int fisr_flow_sample(const uint8_t* pair, const float* flow, int64_t H, int64_t W, int64_t y0,
                     int64_t x0, int64_t ch, int64_t cw, int flip_lr, int flip_ud, int64_t tx,
                     int64_t ty, int scaled, double ratio, int64_t sh, int64_t sw, float* x_out,
                     float* y_out) {
  try {
    const bool lr = flip_lr != 0, ud = flip_ud != 0, shifted = tx != 0 || ty != 0;
    const Axis rows = make_axis(ch, y0, ud, ty, scaled != 0, sh);
    const Axis cols = make_axis(cw, x0, lr, tx, scaled != 0, sw);
    const float fratio = float(ratio), shift[2] = {float(tx), float(ty)};
    const bool negate[2] = {lr, ud};
    const float* unit = u8_unit();
    // frame t's source row at crop row p (null: zeros), the flow's
    auto frame_row = [&](int t, int64_t p) -> const uint8_t* {
      const int64_t s = t ? rows.src1[p] : rows.src0[p];
      return s < 0 ? nullptr : pair + (t * H + s) * W * 3;
    };
    auto flow_row = [&](int64_t p) { return flow + rows.src0[p] * W * 2; };
    // the flow's component k at crop column p of a source row, flipped and shifted
    auto flow_at = [&](const float* row, int64_t p, int k) {
      float v = row[cols.src0[p] * 2 + k];
      if (negate[k]) v = -v;
      return shifted ? v + shift[k] : v;
    };
    Pool::run(ch, [&](int64_t r) {
      float* xo[2] = {x_out + r * cw * 3, x_out + (ch + r) * cw * 3};
      float* yo = y_out + r * cw * 2;
      if (rows.a[r] < 0) {  // the zero pad of a ratio below 1
        std::fill(xo[0], xo[0] + cw * 3, 0.0f);
        std::fill(xo[1], xo[1] + cw * 3, 0.0f);
        std::fill(yo, yo + cw * 2, 0.0f);
        return;
      }
      if (!scaled) {
        for (int t = 0; t < 2; ++t) {
          const uint8_t* row = frame_row(t, r);
          for (int64_t c = 0; c < cw; ++c) {
            const int64_t q = t ? cols.src1[c] : cols.src0[c];
            for (int k = 0; k < 3; ++k)
              xo[t][c * 3 + k] = row && q >= 0 ? unit[row[q * 3 + k]] : 0.0f;
          }
        }
        const float* g = flow_row(r);
        for (int64_t c = 0; c < cw; ++c)
          for (int k = 0; k < 2; ++k) yo[c * 2 + k] = flow_at(g, c, k);
        return;
      }
      // _resize_bilinear's sum at output (r, c), in its order:
      //   ((A (1 - wy)) (1 - wx) + (B (1 - wy)) wx) + (C wy) (1 - wx) + (D wy) wx
      // with A, B on crop row a and C, D on row b: ua and ub hold those rows'
      // values times (1 - wy) and wy at every crop column, in double.
      const int64_t pa = rows.a[r], pb = rows.b[r];
      const double wy = rows.w[r], omy = 1.0 - wy;
      std::vector<double> ua(cw * 3), ub(cw * 3);
      auto sum = [&](int64_t c, int64_t n, int k) {
        const int64_t a = cols.a[c] * n + k, b = cols.b[c] * n + k;
        const double wx = cols.w[c], omx = 1.0 - wx;
        return ((ua[a] * omx + ua[b] * wx) + ub[a] * omx) + ub[b] * wx;
      };
      for (int t = 0; t < 2; ++t) {
        const uint8_t *ra = frame_row(t, pa), *rb = frame_row(t, pb);
        for (int64_t p = 0; p < cw; ++p) {
          const int64_t q = t ? cols.src1[p] : cols.src0[p];
          for (int k = 0; k < 3; ++k) {
            ua[p * 3 + k] = double(ra && q >= 0 ? ra[q * 3 + k] : 0) * omy;
            ub[p * 3 + k] = double(rb && q >= 0 ? rb[q * 3 + k] : 0) * wy;
          }
        }
        for (int64_t c = 0; c < cw; ++c)
          for (int k = 0; k < 3; ++k)
            xo[t][c * 3 + k] = cols.a[c] < 0 ? 0.0f : float(sum(c, 3, k));
        for (int64_t i = 0; i < cw * 3; ++i) xo[t][i] = xo[t][i] / 255.0f;  // vectorised
      }
      const float *ga = flow_row(pa), *gb = flow_row(pb);
      for (int64_t p = 0; p < cw; ++p)
        for (int k = 0; k < 2; ++k) {
          ua[p * 2 + k] = double(flow_at(ga, p, k)) * omy;
          ub[p * 2 + k] = double(flow_at(gb, p, k)) * wy;
        }
      for (int64_t c = 0; c < cw; ++c)
        for (int k = 0; k < 2; ++k)
          yo[c * 2 + k] = cols.a[c] < 0 ? 0.0f : float(sum(c, 2, k)) * fratio;
    });
    return kOk;
  } catch (const std::exception&) {
    return kMemory;
  }
}

// Decode a PNG held in memory into out (cap bytes). Status codes above.
int fisr_png_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap, int64_t* info,
                    char* msg) {
  try {
    return decode_buffer(data, n, out, cap, info, msg);
  } catch (const std::exception&) {
    return kMemory;
  }
}

int fisr_png_decode_file(const char* path, uint8_t* out, int64_t cap, int64_t* info,
                         char* msg) {
  return decode_file(path, out, cap, info, msg);
}

// Decode n files (NUL-terminated, `stride` bytes apart in `paths`) of h x w
// into out[n, h, w, 3] on threads. codes[i], info[8 i ..], msgs[256 i ..]
// hold each file's outcome; returns the number of files that failed.
int64_t fisr_png_decode_batch(const char* paths, int64_t stride, int64_t n, uint8_t* out,
                              int64_t h, int64_t w, int32_t* codes, int64_t* info,
                              char* msgs) {
  const int64_t frame = h * w * 3;
  std::atomic<int64_t> failed(0);
  parallel_for(n, 0, [&](int64_t i) {
    int64_t* inf = info + 8 * i;
    char* msg = msgs + 256 * i;
    int rc = decode_file(paths + i * stride, out + i * frame, frame, inf, msg);
    if (rc == kSpace) {  // larger than the batch's frames: its own outcome first
      try {
        std::vector<uint8_t> own(inf[0] * inf[1] * 3);
        rc = decode_file(paths + i * stride, own.data(), int64_t(own.size()), inf, msg);
      } catch (const std::exception&) {
        rc = kMemory;
      }
    }
    if (rc == kOk && (inf[0] != w || inf[1] != h)) rc = kShape;
    codes[i] = rc;
    if (rc != kOk) failed.fetch_add(1);
  });
  return failed.load();
}

// Decode n zstd buffers (srcs[i], ns[i] bytes) into dsts[i], at most caps[i]
// bytes each, on `threads` threads (0: the host's cores). sizes[i], codes[i]
// and msgs[256 i ..] hold each one's outcome; returns the number that failed.
int64_t fisr_zstd_decompress_batch(const uint8_t* const* srcs, const int64_t* ns,
                                   uint8_t* const* dsts, const int64_t* caps, int64_t n,
                                   int threads, int64_t* sizes, int32_t* codes, char* msgs) {
  std::atomic<int64_t> failed(0);
  parallel_for(n, threads, [&](int64_t i) {
    codes[i] = fisr_zstd_decompress(srcs[i], ns[i], dsts[i], caps[i], sizes + i, msgs + 256 * i);
    if (codes[i]) failed.fetch_add(1);
  });
  return failed.load();
}

// The bytes fisr_png_encode needs at `out` for an h x w frame.
int64_t fisr_png_bound(int64_t h, int64_t w) { return png_bound(h, w); }

// The PNG file of img [h, w, 3] u8 into out (cap bytes), on up to `threads`
// threads (0: the host's cores). Returns its length, -1 when cap is under
// fisr_png_bound, -2 when memory ran out; *stored counts the strips stored.
int64_t fisr_png_encode(const uint8_t* img, int64_t h, int64_t w, int threads, uint8_t* out,
                        int64_t cap, int64_t* stored) {
  if (cap < png_bound(h, w)) return -1;
  try {
    return encode(img, h, w, threads, out, stored);
  } catch (const std::bad_alloc&) {
    return -2;
  }
}

// Write the PNG file of img to path (all threads). Returns 0, an errno, or
// -2 when memory ran out; *stored as fisr_png_encode.
int fisr_png_write(const char* path, const uint8_t* img, int64_t h, int64_t w, int64_t* stored) {
  std::unique_ptr<uint8_t[]> png;
  int64_t n;
  try {
    png.reset(new uint8_t[png_bound(h, w)]);
    n = encode(img, h, w, 0, png.get(), stored);
  } catch (const std::bad_alloc&) {
    return -2;
  }
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return errno ? errno : EIO;
  int rc = std::fwrite(png.get(), 1, n, fp) == size_t(n) ? 0 : (errno ? errno : EIO);
  if (std::fclose(fp) != 0 && rc == 0) rc = errno ? errno : EIO;
  return rc;
}

}  // extern "C"
