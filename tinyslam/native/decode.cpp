// Native image decoding for the dataset loaders.
//
// The reference's native layer is its Rust host orchestration + the
// tiny_wgpu runtime (reference src/orb.rs, SURVEY §2c); under JAX that
// layer dissolves into XLA, so the native code that remains valuable is the part
// XLA cannot do: dataset IO.  This file decodes the formats TUM RGB-D and
// EuRoC ship (8/16-bit grayscale + 8-bit RGB/RGBA PNG, plus PGM/PPM) with
// zlib as the only dependency.
//
// C ABI (ctypes-friendly):
//   ts_decode_image(path, out, out_cap, &w, &h, &channels, &bitdepth) -> 0 ok
//     out receives row-major interleaved samples; 16-bit values are
//     native-endian uint16.  Call with out == NULL to query dimensions.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cctype>
#include <cmath>
#include <vector>

#include <zlib.h>

namespace {

struct Image {
  uint32_t w = 0, h = 0;
  uint32_t channels = 0;   // 1, 3 or 4
  uint32_t bitdepth = 0;   // 8 or 16
  std::vector<uint8_t> data;  // interleaved, 16-bit native-endian
};

bool read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n <= 0) { std::fclose(f); return false; }
  buf.resize(static_cast<size_t>(n));
  size_t got = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  return got == buf.size();
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// ---------------------------------------------------------------- PNG ----
bool decode_png(const std::vector<uint8_t>& file, Image& out) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', 0x0d, 0x0a, 0x1a, 0x0a};
  if (file.size() < 8 || std::memcmp(file.data(), sig, 8) != 0) return false;

  uint32_t w = 0, h = 0;
  uint8_t bitdepth = 0, color = 0, interlace = 0;
  std::vector<uint8_t> idat;

  size_t pos = 8;
  while (pos + 8 <= file.size()) {
    uint32_t len = be32(&file[pos]);
    const uint8_t* type = &file[pos + 4];
    if (pos + 12 + len > file.size()) return false;
    const uint8_t* payload = &file[pos + 8];
    if (!std::memcmp(type, "IHDR", 4)) {
      if (len < 13) return false;
      w = be32(payload);
      h = be32(payload + 4);
      bitdepth = payload[8];
      color = payload[9];
      interlace = payload[12];
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), payload, payload + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (!w || !h || interlace != 0) return false;
  uint32_t channels;
  switch (color) {
    case 0: channels = 1; break;  // grayscale
    case 2: channels = 3; break;  // RGB
    case 4: channels = 2; break;  // gray+alpha
    case 6: channels = 4; break;  // RGBA
    default: return false;        // palette unsupported
  }
  if (bitdepth != 8 && bitdepth != 16) return false;

  const size_t bpp = channels * (bitdepth / 8);      // bytes per pixel
  const size_t stride = size_t(w) * bpp;             // bytes per row
  std::vector<uint8_t> raw(h * (stride + 1));
  {
    uLongf dst_len = raw.size();
    if (uncompress(raw.data(), &dst_len, idat.data(), idat.size()) != Z_OK ||
        dst_len != raw.size()) {
      return false;
    }
  }

  out.w = w;
  out.h = h;
  out.channels = channels;
  out.bitdepth = bitdepth;
  out.data.assign(h * stride, 0);

  std::vector<uint8_t> prev(stride, 0);
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* src = &raw[y * (stride + 1)];
    uint8_t filter = src[0];
    const uint8_t* in = src + 1;
    uint8_t* cur = &out.data[y * stride];
    for (size_t i = 0; i < stride; ++i) {
      int a = (i >= bpp) ? cur[i - bpp] : 0;
      int b = prev[i];
      int c = (i >= bpp) ? prev[i - bpp] : 0;
      int x = in[i];
      switch (filter) {
        case 0: cur[i] = uint8_t(x); break;
        case 1: cur[i] = uint8_t(x + a); break;
        case 2: cur[i] = uint8_t(x + b); break;
        case 3: cur[i] = uint8_t(x + ((a + b) >> 1)); break;
        case 4: cur[i] = uint8_t(x + paeth(a, b, c)); break;
        default: return false;
      }
    }
    std::memcpy(prev.data(), cur, stride);
  }

  // PNG 16-bit samples are big-endian; convert to native (little) endian.
  if (bitdepth == 16) {
    for (size_t i = 0; i + 1 < out.data.size(); i += 2) {
      std::swap(out.data[i], out.data[i + 1]);
    }
  }
  return true;
}

// ------------------------------------------------------------ PGM/PPM ----
bool decode_pnm(const std::vector<uint8_t>& file, Image& out) {
  if (file.size() < 2 || file[0] != 'P') return false;
  char kind = char(file[1]);
  if (kind != '5' && kind != '6') return false;  // binary gray / RGB
  size_t pos = 2;
  auto next_int = [&](uint32_t& v) -> bool {
    // skip whitespace + comments
    while (pos < file.size()) {
      if (file[pos] == '#') {
        while (pos < file.size() && file[pos] != '\n') ++pos;
      } else if (std::isspace(file[pos])) {
        ++pos;
      } else {
        break;
      }
    }
    uint64_t acc = 0;
    bool any = false;
    while (pos < file.size() && std::isdigit(file[pos])) {
      acc = acc * 10 + (file[pos] - '0');
      ++pos;
      any = true;
    }
    v = uint32_t(acc);
    return any;
  };
  uint32_t w, h, maxv;
  if (!next_int(w) || !next_int(h) || !next_int(maxv)) return false;
  ++pos;  // single whitespace after maxval
  uint32_t channels = (kind == '5') ? 1 : 3;
  uint32_t bitdepth = (maxv > 255) ? 16 : 8;
  size_t need = size_t(w) * h * channels * (bitdepth / 8);
  if (pos + need > file.size()) return false;
  out.w = w;
  out.h = h;
  out.channels = channels;
  out.bitdepth = bitdepth;
  out.data.assign(file.begin() + pos, file.begin() + pos + need);
  if (bitdepth == 16) {  // PNM 16-bit is big-endian
    for (size_t i = 0; i + 1 < out.data.size(); i += 2) {
      std::swap(out.data[i], out.data[i + 1]);
    }
  }
  return true;
}

bool decode_any(const char* path, Image& out) {
  std::vector<uint8_t> file;
  if (!read_file(path, file)) return false;
  if (decode_png(file, out)) return true;
  return decode_pnm(file, out);
}

}  // namespace

extern "C" {

// Query or decode.  Returns 0 on success, negative on failure.
int ts_decode_image(const char* path, uint8_t* out, int64_t out_cap,
                    int32_t* w, int32_t* h, int32_t* channels,
                    int32_t* bitdepth) {
  Image img;
  if (!decode_any(path, img)) return -1;
  *w = int32_t(img.w);
  *h = int32_t(img.h);
  *channels = int32_t(img.channels);
  *bitdepth = int32_t(img.bitdepth);
  if (out == nullptr) return 0;
  if (out_cap < int64_t(img.data.size())) return -2;
  std::memcpy(out, img.data.data(), img.data.size());
  return 0;
}

}  // extern "C"
