// frameio — native image decode + prefetching frame loader.
//
// The native counterpart of the reference's host-side IO layer: the
// reference's C++ examples do synchronous cv::imread per frame
// (Examples/*/*.cc [U]); this module decodes PNG (8-bit gray / RGB->gray
// / 16-bit gray depth) and PGM natively and runs a pthread prefetcher
// that keeps N decoded frames ahead of the SLAM loop, so host decode
// overlaps device compute.  Exposed as a C ABI consumed from Python via
// ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -march=native -shared -fPIC frameio.cpp -o libframeio.so -lz -lpthread

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <thread>
#include <mutex>
#include <condition_variable>
#include <queue>
#include <zlib.h>

namespace {

struct Image {
  int w = 0, h = 0, channels = 0, bitdepth = 8;
  std::vector<uint8_t> data;  // row-major; 16-bit stored big-endian as in PNG
};

// ----------------------------------------------------------------- PNG

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool inflate_all(const std::vector<uint8_t>& in, std::vector<uint8_t>& out) {
  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(in.data());
  zs.avail_in = static_cast<uInt>(in.size());
  std::vector<uint8_t> buf(1 << 20);
  int ret = Z_OK;
  while (ret != Z_STREAM_END) {
    zs.next_out = buf.data();
    zs.avail_out = static_cast<uInt>(buf.size());
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) { inflateEnd(&zs); return false; }
    out.insert(out.end(), buf.data(), buf.data() + (buf.size() - zs.avail_out));
  }
  inflateEnd(&zs);
  return true;
}

bool decode_png(const uint8_t* bytes, size_t n, Image& img) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (n < 8 || memcmp(bytes, sig, 8) != 0) return false;
  size_t off = 8;
  std::vector<uint8_t> idat;
  int color_type = -1;
  while (off + 8 <= n) {
    uint32_t len = be32(bytes + off);
    const char* type = reinterpret_cast<const char*>(bytes + off + 4);
    const uint8_t* payload = bytes + off + 8;
    if (off + 12 + len > n) return false;
    if (memcmp(type, "IHDR", 4) == 0) {
      img.w = be32(payload);
      img.h = be32(payload + 4);
      img.bitdepth = payload[8];
      color_type = payload[9];
      if (payload[12] != 0) return false;  // interlace unsupported
      if (img.bitdepth != 8 && img.bitdepth != 16) return false;
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), payload, payload + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    off += 12 + len;
  }
  int ch;
  switch (color_type) {
    case 0: ch = 1; break;   // gray
    case 2: ch = 3; break;   // rgb
    case 4: ch = 2; break;   // gray+alpha
    case 6: ch = 4; break;   // rgba
    default: return false;    // palette unsupported
  }
  img.channels = ch;
  const int bpp = ch * (img.bitdepth / 8);
  const size_t stride = size_t(img.w) * bpp;

  std::vector<uint8_t> raw;
  raw.reserve((stride + 1) * img.h);
  if (!inflate_all(idat, raw)) return false;
  if (raw.size() < (stride + 1) * img.h) return false;

  img.data.assign(stride * img.h, 0);
  std::vector<uint8_t> prev(stride, 0);
  for (int y = 0; y < img.h; ++y) {
    const uint8_t* src = raw.data() + size_t(y) * (stride + 1);
    uint8_t filter = src[0];
    ++src;
    uint8_t* dst = img.data.data() + size_t(y) * stride;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
      int b = prev[x];
      int c = x >= size_t(bpp) ? prev[x - bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return false;
      }
      dst[x] = uint8_t(v);
    }
    memcpy(prev.data(), dst, stride);
  }
  return true;
}

// ----------------------------------------------------------------- PGM

bool decode_pgm(const uint8_t* bytes, size_t n, Image& img) {
  if (n < 2 || bytes[0] != 'P' || (bytes[1] != '5' && bytes[1] != '2'))
    return false;
  bool ascii = bytes[1] == '2';
  size_t off = 2;
  auto next_int = [&](int& out) -> bool {
    while (off < n) {
      if (bytes[off] == '#') { while (off < n && bytes[off] != '\n') ++off; }
      else if (isspace(bytes[off])) ++off;
      else break;
    }
    int v = 0; bool any = false;
    while (off < n && isdigit(bytes[off])) { v = v * 10 + (bytes[off] - '0'); ++off; any = true; }
    out = v;
    return any;
  };
  int maxv;
  if (!next_int(img.w) || !next_int(img.h) || !next_int(maxv)) return false;
  img.channels = 1;
  img.bitdepth = maxv > 255 ? 16 : 8;
  const size_t count = size_t(img.w) * img.h;
  const int bpp = img.bitdepth / 8;
  img.data.assign(count * bpp, 0);
  if (ascii) {
    for (size_t i = 0; i < count; ++i) {
      int v; if (!next_int(v)) return false;
      if (bpp == 1) img.data[i] = uint8_t(v);
      else { img.data[2 * i] = uint8_t(v >> 8); img.data[2 * i + 1] = uint8_t(v); }
    }
  } else {
    ++off;  // single whitespace after maxval
    if (off + count * bpp > n) return false;
    memcpy(img.data.data(), bytes + off, count * bpp);
  }
  return true;
}

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize(sz);
  bool ok = fread(out.data(), 1, sz, f) == size_t(sz);
  fclose(f);
  return ok;
}

bool decode_file(const char* path, Image& img) {
  std::vector<uint8_t> bytes;
  if (!read_file(path, bytes)) return false;
  if (decode_png(bytes.data(), bytes.size(), img)) return true;
  img = Image{};
  return decode_pgm(bytes.data(), bytes.size(), img);
}

// convert any decoded image to 8-bit gray (luma for RGB) or pass
// through 16-bit gray (depth); out buffers are caller-provided.
void to_gray8(const Image& img, uint8_t* out) {
  const int bpp = img.bitdepth / 8;
  const size_t count = size_t(img.w) * img.h;
  for (size_t i = 0; i < count; ++i) {
    const uint8_t* p = img.data.data() + i * img.channels * bpp;
    int v;
    if (img.channels >= 3) {
      int r = bpp == 2 ? p[0] : p[0];
      int g = bpp == 2 ? p[2] : p[1];
      int b = bpp == 2 ? p[4] : p[2];
      v = (r * 299 + g * 587 + b * 114) / 1000;
    } else {
      v = p[0];
    }
    out[i] = uint8_t(v);
  }
}

void to_gray16(const Image& img, uint16_t* out) {
  const size_t count = size_t(img.w) * img.h;
  if (img.bitdepth == 16) {
    for (size_t i = 0; i < count; ++i) {
      const uint8_t* p = img.data.data() + i * img.channels * 2;
      out[i] = uint16_t((p[0] << 8) | p[1]);  // PNG is big-endian
    }
  } else {
    for (size_t i = 0; i < count; ++i)
      out[i] = img.data[i * img.channels];
  }
}

// ------------------------------------------------------------ prefetcher

struct Prefetcher {
  std::vector<std::string> paths;
  int gray16 = 0;
  size_t next_submit = 0;
  size_t next_emit = 0;
  size_t capacity = 0;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::thread> workers;
  bool stop = false;

  struct Slot { bool ready = false; bool ok = false; Image img; };
  std::vector<Slot> slots;

  void worker() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] {
          return stop || (next_submit < paths.size() &&
                          next_submit < next_emit + capacity);
        });
        if (stop) return;
        idx = next_submit++;
      }
      Image img;
      bool ok = decode_file(paths[idx].c_str(), img);
      {
        std::unique_lock<std::mutex> lk(mu);
        Slot& s = slots[idx % capacity];
        s.img = std::move(img);
        s.ok = ok;
        s.ready = true;
        cv.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

// single-shot decode: returns 0 on failure; fills w/h/bitdepth.
// out8 must hold w*h bytes; out16 (nullable) w*h uint16s for 16-bit.
int fio_decode_gray(const char* path, uint8_t* out8, uint16_t* out16,
                    int cap_pixels, int* w, int* h, int* bitdepth) {
  Image img;
  if (!decode_file(path, img)) return 0;
  if (img.w * img.h > cap_pixels) return 0;
  *w = img.w; *h = img.h; *bitdepth = img.bitdepth;
  if (img.bitdepth == 16 && out16) to_gray16(img, out16);
  else if (out8) to_gray8(img, out8);
  else return 0;
  return 1;
}

void* fio_open(const char** paths, int n, int prefetch, int threads,
               int want16) {
  auto* p = new Prefetcher();
  p->paths.assign(paths, paths + n);
  p->capacity = prefetch > 0 ? prefetch : 8;
  p->gray16 = want16;
  p->slots.resize(p->capacity);
  int nt = threads > 0 ? threads : 2;
  for (int i = 0; i < nt; ++i)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// blocking next; returns 0 at end of sequence or on decode failure.
int fio_next(void* handle, uint8_t* out8, uint16_t* out16,
             int cap_pixels, int* w, int* h, int* bitdepth) {
  auto* p = static_cast<Prefetcher*>(handle);
  size_t idx;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    if (p->next_emit >= p->paths.size()) return 0;
    idx = p->next_emit;
    p->cv.wait(lk, [&] { return p->slots[idx % p->capacity].ready; });
  }
  Prefetcher::Slot& s = p->slots[idx % p->capacity];
  int ok = 0;
  if (s.ok && s.img.w * s.img.h <= cap_pixels) {
    *w = s.img.w; *h = s.img.h; *bitdepth = s.img.bitdepth;
    if (s.img.bitdepth == 16 && out16) to_gray16(s.img, out16);
    else if (out8) to_gray8(s.img, out8);
    ok = 1;
  }
  {
    std::unique_lock<std::mutex> lk(p->mu);
    s.ready = false;
    p->next_emit++;
    p->cv.notify_all();
  }
  return ok;
}

void fio_close(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->stop = true;
    p->cv.notify_all();
  }
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
