// Host runtime of the port: the data path's CPU work in threaded C++, bound
// with ctypes through fisr_tpu_torch/native/bindings.py.
//
//   * PNG decode (8-bit grey, grey + alpha, RGB, RGBA, palette; not
//     interlaced; every filter type) from a path or a buffer, and a batch of
//     same-sized files decoded on threads into one [n, h, w, 3] array. It
//     accepts and rejects what data/png_io.decode_png does, in the same
//     order, and says why in the code and `info` it returns.
//   * PNG encode of u8 RGB in data/png_io's format: filter 0 rows, zlib
//     level 1, one IDAT. The IDAT stream is deflated in row strips on
//     threads, each a raw deflate stream ending in Z_FULL_FLUSH (the last in
//     Z_FINISH), under one zlib header, with the strips' adler32s combined.
//     One strip is zlib's compress at level 1: png_io's bytes.
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
// Links zlib only. Work runs on the host's cores; the encoder takes its
// thread count (one thread gives zlib.compress's bytes).

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
// with the calling thread taking indices too. For passes of a millisecond or
// two, where starting threads on each call costs as much as the work. One
// run at a time; a run that throws rethrows its first exception in the
// caller once every index is done.
class Pool {
 public:
  static void run(int64_t n, const std::function<void(int64_t)>& fn) {
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
    p->go(n, fn);
  }

 private:
  Pool() : pid_(getpid()) {}

  // as many workers as the system lets start, up to `workers`
  void start(int workers) {
    for (; workers_ < workers; ++workers_) {
      try {
        std::thread([this] { serve(); }).detach();
      } catch (const std::system_error&) {
        break;
      }
    }
  }

  void go(int64_t n, const std::function<void(int64_t)>& fn) {
    std::lock_guard<std::mutex> one_run(run_);
    {
      std::lock_guard<std::mutex> lock(mu_);
      job_ = &fn;
      n_ = n;
      next_ = 0;
      busy_ = workers_;
      error_ = nullptr;
      ++round_;
    }
    wake_.notify_all();
    take();
    std::unique_lock<std::mutex> lock(mu_);
    done_.wait(lock, [&] { return busy_ == 0; });
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
        wake_.wait(lock, [&] { return round_ != seen; });
        seen = round_;
      }
      take();
      std::lock_guard<std::mutex> lock(mu_);
      if (--busy_ == 0) done_.notify_one();
    }
  }

  const pid_t pid_;
  int workers_ = 0;
  std::mutex run_, mu_;
  std::condition_variable wake_, done_;
  const std::function<void(int64_t)>* job_ = nullptr;
  int64_t n_ = 0;
  std::atomic<int64_t> next_{0};
  int busy_ = 0;
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

struct Strip {
  std::vector<uint8_t> z;  // compressed bytes
  uLong adler = 1;         // adler32 of the strip's filtered rows
  int64_t raw_len = 0;
  int status = Z_OK;
};

// Filter-0 rows [y0, y1) of img ([h, w, 3] u8): a zero byte, then the row.
std::vector<uint8_t> filtered_rows(const uint8_t* img, int64_t w, int64_t y0, int64_t y1) {
  const int64_t row = 3 * w;
  std::vector<uint8_t> raw((y1 - y0) * (1 + row));
  for (int64_t y = y0; y < y1; ++y) {
    uint8_t* r = raw.data() + (y - y0) * (1 + row);
    r[0] = 0;
    std::memcpy(r + 1, img + y * row, row);
  }
  return raw;
}

void append_chunk(std::vector<uint8_t>* png, const char* tag, const uint8_t* body, int64_t n) {
  uint8_t head[8];
  put_be32(head, uint32_t(n));
  std::memcpy(head + 4, tag, 4);
  png->insert(png->end(), head, head + 8);
  png->insert(png->end(), body, body + n);
  uLong crc = crc32(0L, head + 4, 4);
  if (n) crc = crc32(crc, body, uInt(n));  // (zlib's crc32 of a null buffer restarts)
  uint8_t tail[4];
  put_be32(tail, uint32_t(crc));
  png->insert(png->end(), tail, tail + 4);
}

// The PNG file of img: signature, IHDR, one IDAT, IEND. Returns a zlib
// status (Z_OK on success).
int encode(const uint8_t* img, int64_t h, int64_t w, int threads, std::vector<uint8_t>* png) {
  const int64_t raw_total = h * (1 + 3 * w);
  // strips of at least 256 KiB of rows: a strip's stream costs its flush marker
  const int64_t n_strips = std::max<int64_t>(
      1, std::min<int64_t>({resolve_threads(threads), h, raw_total / (256 << 10)}));
  std::vector<Strip> strips(n_strips);
  parallel_for(n_strips, n_strips, [&](int64_t k) {
    Strip& s = strips[k];
    const int64_t y0 = h * k / n_strips, y1 = h * (k + 1) / n_strips;
    try {
      std::vector<uint8_t> raw = filtered_rows(img, w, y0, y1);
      s.raw_len = int64_t(raw.size());
      z_stream zs;
      std::memset(&zs, 0, sizeof zs);
      // one strip: a whole zlib stream, as zlib.compress(raw, 1); more: raw
      // deflate streams joined under one header below
      s.status = n_strips == 1 ? deflateInit(&zs, 1)
                               : deflateInit2(&zs, 1, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY);
      if (s.status != Z_OK) return;
      s.z.resize(deflateBound(&zs, uLong(raw.size())) + 64);
      zs.next_in = raw.data();
      zs.avail_in = uInt(raw.size());
      zs.next_out = s.z.data();
      zs.avail_out = uInt(s.z.size());
      const bool last = k == n_strips - 1;
      int rc = deflate(&zs, last ? Z_FINISH : Z_FULL_FLUSH);
      s.status = (rc == (last ? Z_STREAM_END : Z_OK) && zs.avail_in == 0) ? Z_OK : Z_BUF_ERROR;
      s.z.resize(zs.total_out);
      deflateEnd(&zs);
      if (n_strips > 1) s.adler = adler32(1L, raw.data(), uInt(raw.size()));
    } catch (const std::bad_alloc&) {
      s.status = Z_MEM_ERROR;
    }
  });
  for (const Strip& s : strips)
    if (s.status != Z_OK) return s.status;

  std::vector<uint8_t> idat;
  if (n_strips == 1) {
    idat.swap(strips[0].z);
  } else {
    int64_t total = 6;
    for (const Strip& s : strips) total += int64_t(s.z.size());
    idat.reserve(total);
    const uint8_t zhead[2] = {0x78, 0x01};  // deflate, 32 KiB window, level 1's FLEVEL
    idat.insert(idat.end(), zhead, zhead + 2);
    uLong adler = 1;
    for (const Strip& s : strips) {
      idat.insert(idat.end(), s.z.begin(), s.z.end());
      adler = adler32_combine(adler, s.adler, z_off_t(s.raw_len));
    }
    uint8_t tail[4];
    put_be32(tail, uint32_t(adler));
    idat.insert(idat.end(), tail, tail + 4);
  }
  uint8_t ihdr[13];
  put_be32(ihdr, uint32_t(w));
  put_be32(ihdr + 4, uint32_t(h));
  ihdr[8] = 8;  // bit depth
  ihdr[9] = 2;  // RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  png->clear();
  png->reserve(idat.size() + 57);
  png->insert(png->end(), kSig, kSig + 8);
  append_chunk(png, "IHDR", ihdr, 13);
  append_chunk(png, "IDAT", idat.data(), int64_t(idat.size()));
  append_chunk(png, "IEND", nullptr, 0);
  return Z_OK;
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
  parallel_for(n, 0, [&](int64_t i) {
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

// The PNG file of img [h, w, 3] u8 into out (cap bytes). Returns its length,
// -1 when cap is too small (*need = the length), -2 when zlib failed.
int64_t fisr_png_encode(const uint8_t* img, int64_t h, int64_t w, int threads, uint8_t* out,
                        int64_t cap, int64_t* need) {
  std::vector<uint8_t> png;
  try {
    if (encode(img, h, w, threads, &png) != Z_OK) return -2;
  } catch (const std::bad_alloc&) {
    return -2;
  }
  *need = int64_t(png.size());
  if (*need > cap) return -1;
  std::memcpy(out, png.data(), png.size());
  return *need;
}

// Write the PNG file of img to path (all threads). Returns 0, an errno, or
// -2 when zlib failed.
int fisr_png_write(const char* path, const uint8_t* img, int64_t h, int64_t w) {
  std::vector<uint8_t> png;
  try {
    if (encode(img, h, w, 0, &png) != Z_OK) return -2;
  } catch (const std::bad_alloc&) {
    return -2;
  }
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return errno ? errno : EIO;
  int rc = std::fwrite(png.data(), 1, png.size(), fp) == png.size() ? 0 : (errno ? errno : EIO);
  if (std::fclose(fp) != 0 && rc == 0) rc = errno ? errno : EIO;
  return rc;
}

}  // extern "C"
