// Native runtime components for topo-renderer-tpu (copy of the JAX package's
// native/src/topo_native.cc for the PyTorch port).
//
// The reference implements its data path in Rust (the `tiff` crate decode in
// `topo-renderer/src/control/background_runner.rs:111-136`); this C++ module
// is the renderer's native equivalent for the host-side hot paths:
//
//   * GeoTIFF decoding: classic TIFF, strips or tiles, compression
//     none/LZW/Deflate, predictors 1 (none), 2 (horizontal int),
//     3 (floating-point), sample formats u8..u32/i8..i32/f32/f64,
//     geo tags ModelPixelScale (33550), ModelTiepoint (33922),
//     ModelTransformation (34264).
//   * Label overlay compositing: leader lines, rounded label backgrounds,
//     A8 glyph blitting into an RGB8 frame (the lyon/glyphon equivalent,
//     `src/render/line_renderer.rs:97-207`, `src/render/text_renderer.rs`).
//
// Exposed with a plain C ABI for ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

struct Reader {
  const uint8_t* data;
  size_t len;
  bool little;

  bool ok(size_t off, size_t n) const { return off + n <= len; }
  uint16_t u16(size_t off) const {
    uint16_t v;
    std::memcpy(&v, data + off, 2);
    if (!little) v = static_cast<uint16_t>((v >> 8) | (v << 8));
    return v;
  }
  uint32_t u32(size_t off) const {
    uint32_t v;
    std::memcpy(&v, data + off, 4);
    if (!little) v = __builtin_bswap32(v);
    return v;
  }
  uint64_t u64swapped(size_t off) const {
    uint64_t v;
    std::memcpy(&v, data + off, 8);
    if (!little) v = __builtin_bswap64(v);
    return v;
  }
  double f64(size_t off) const {
    uint64_t v = u64swapped(off);
    double d;
    std::memcpy(&d, &v, 8);
    return d;
  }
  float f32at(size_t off) const {
    uint32_t v = u32(off);
    float f;
    std::memcpy(&f, &v, 4);
    return f;
  }
};

size_t type_size(uint16_t t) {
  switch (t) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: return 4;
    case 5: case 10: case 12: return 8;
    default: return 1;
  }
}

struct Entry {
  uint16_t type;
  uint32_t count;
  size_t value_off;  // offset into file where values live
};

struct Tiff {
  Reader r;
  uint32_t width = 0, height = 0;
  uint16_t bits = 32, compression = 1, predictor = 1, sample_format = 1,
           samples = 1;
  uint32_t rows_per_strip = 0xFFFFFFFFu;
  uint32_t tile_w = 0, tile_h = 0;
  std::vector<uint64_t> offsets, counts;
  bool tiled = false;
  std::vector<double> pixel_scale, tiepoint, model_transform;
};

bool get_values(const Reader& r, const Entry& e, std::vector<uint64_t>* out) {
  size_t ts = type_size(e.type);
  out->clear();
  out->reserve(e.count);
  for (uint32_t i = 0; i < e.count; ++i) {
    size_t off = e.value_off + i * ts;
    if (!r.ok(off, ts)) return false;
    switch (e.type) {
      case 1: out->push_back(r.data[off]); break;
      case 3: out->push_back(r.u16(off)); break;
      case 4: out->push_back(r.u32(off)); break;
      default: return false;
    }
  }
  return true;
}

bool get_doubles(const Reader& r, const Entry& e, std::vector<double>* out) {
  out->clear();
  if (e.type != 12) return false;
  for (uint32_t i = 0; i < e.count; ++i) {
    size_t off = e.value_off + i * 8;
    if (!r.ok(off, 8)) return false;
    out->push_back(r.f64(off));
  }
  return true;
}

bool parse(Tiff* t) {
  Reader& r = t->r;
  if (r.len < 8) { set_error("too short"); return false; }
  if (r.data[0] == 'I' && r.data[1] == 'I') r.little = true;
  else if (r.data[0] == 'M' && r.data[1] == 'M') r.little = false;
  else { set_error("bad byte-order mark"); return false; }
  if (r.u16(2) != 42) { set_error("not classic TIFF"); return false; }
  uint32_t ifd = r.u32(4);
  if (!r.ok(ifd, 2)) { set_error("bad IFD offset"); return false; }
  uint16_t n = r.u16(ifd);
  std::vector<uint64_t> vals;
  for (uint16_t i = 0; i < n; ++i) {
    size_t off = ifd + 2 + 12 * static_cast<size_t>(i);
    if (!r.ok(off, 12)) { set_error("truncated IFD"); return false; }
    uint16_t tag = r.u16(off);
    Entry e;
    e.type = r.u16(off + 2);
    e.count = r.u32(off + 4);
    size_t size = type_size(e.type) * e.count;
    e.value_off = size <= 4 ? off + 8 : r.u32(off + 8);
    switch (tag) {
      case 256: if (get_values(r, e, &vals) && !vals.empty()) t->width = static_cast<uint32_t>(vals[0]); break;
      case 257: if (get_values(r, e, &vals) && !vals.empty()) t->height = static_cast<uint32_t>(vals[0]); break;
      case 258: if (get_values(r, e, &vals) && !vals.empty()) t->bits = static_cast<uint16_t>(vals[0]); break;
      case 259: if (get_values(r, e, &vals) && !vals.empty()) t->compression = static_cast<uint16_t>(vals[0]); break;
      case 273: if (get_values(r, e, &vals)) { t->offsets.assign(vals.begin(), vals.end()); } break;
      case 277: if (get_values(r, e, &vals) && !vals.empty()) t->samples = static_cast<uint16_t>(vals[0]); break;
      case 278: if (get_values(r, e, &vals) && !vals.empty()) t->rows_per_strip = static_cast<uint32_t>(vals[0]); break;
      case 279: if (get_values(r, e, &vals)) { t->counts.assign(vals.begin(), vals.end()); } break;
      case 317: if (get_values(r, e, &vals) && !vals.empty()) t->predictor = static_cast<uint16_t>(vals[0]); break;
      case 322: if (get_values(r, e, &vals) && !vals.empty()) { t->tile_w = static_cast<uint32_t>(vals[0]); } break;
      case 323: if (get_values(r, e, &vals) && !vals.empty()) { t->tile_h = static_cast<uint32_t>(vals[0]); } break;
      case 324: if (get_values(r, e, &vals)) { t->offsets.assign(vals.begin(), vals.end()); t->tiled = true; } break;
      case 325: if (get_values(r, e, &vals)) { t->counts.assign(vals.begin(), vals.end()); t->tiled = true; } break;
      case 339: if (get_values(r, e, &vals) && !vals.empty()) t->sample_format = static_cast<uint16_t>(vals[0]); break;
      case 33550: get_doubles(r, e, &t->pixel_scale); break;
      case 33922: get_doubles(r, e, &t->tiepoint); break;
      case 34264: get_doubles(r, e, &t->model_transform); break;
      default: break;
    }
  }
  if (t->width == 0 || t->height == 0) { set_error("missing dimensions"); return false; }
  if (t->samples != 1) { set_error("only single-sample DEMs supported"); return false; }
  if (t->offsets.empty() || t->offsets.size() != t->counts.size()) {
    set_error("missing strip/tile offsets");
    return false;
  }
  if (t->tiled && (t->tile_w == 0 || t->tile_h == 0)) {
    set_error("tiled TIFF without TileWidth/TileLength");
    return false;
  }
  return true;
}

bool lzw_decode(const uint8_t* in, size_t in_len, std::vector<uint8_t>* out,
                size_t max_out) {
  constexpr int kClear = 256, kEoi = 257;
  struct Dict {
    // Each entry: previous code + appended byte; strings materialized on emit.
    std::vector<int32_t> prev;
    std::vector<uint8_t> last;
  } d;
  auto reset = [&d]() {
    d.prev.assign(258, -1);
    d.last.assign(258, 0);
    for (int i = 0; i < 256; ++i) d.last[i] = static_cast<uint8_t>(i);
  };
  reset();
  out->clear();
  out->reserve(max_out);
  std::vector<uint8_t> scratch;
  auto emit = [&](int code) {
    scratch.clear();
    for (int c = code; c >= 0; c = d.prev[c]) scratch.push_back(d.last[c]);
    for (size_t i = scratch.size(); i-- > 0;) out->push_back(scratch[i]);
  };
  auto first_byte = [&](int code) -> uint8_t {
    int c = code;
    while (d.prev[c] >= 0) c = d.prev[c];
    return d.last[c];
  };

  uint64_t buffer = 0;
  int bits = 0, code_bits = 9, prev = -1;
  for (size_t i = 0; i < in_len; ++i) {
    buffer = (buffer << 8) | in[i];
    bits += 8;
    while (bits >= code_bits) {
      bits -= code_bits;
      int code = static_cast<int>((buffer >> bits) & ((1u << code_bits) - 1));
      if (code == kClear) {
        reset();
        code_bits = 9;
        prev = -1;
        continue;
      }
      if (code == kEoi) return true;
      if (prev < 0) {
        if (code >= static_cast<int>(d.last.size())) { set_error("bad LZW code"); return false; }
        emit(code);
      } else if (code < static_cast<int>(d.prev.size())) {
        emit(code);
        d.prev.push_back(prev);
        d.last.push_back(first_byte(code));
      } else if (code > static_cast<int>(d.prev.size())) {
        // Valid LZW only permits code == next table index (the KwKwK case);
        // anything beyond would make `prev` walk out of the dictionary.
        set_error("bad LZW code");
        return false;
      } else {
        d.prev.push_back(prev);
        d.last.push_back(first_byte(prev));
        emit(static_cast<int>(d.prev.size()) - 1);
      }
      prev = code;
      if (out->size() >= max_out) return true;
      if (d.prev.size() + 1 >= (1u << code_bits) && code_bits < 12) ++code_bits;
    }
  }
  return true;
}

bool inflate_bytes(const uint8_t* in, size_t in_len, std::vector<uint8_t>* out,
                   size_t expected) {
  out->resize(expected);
  uLongf dest_len = expected;
  int rc = uncompress(out->data(), &dest_len, in, in_len);
  if (rc != Z_OK) { set_error("zlib inflate failed"); return false; }
  out->resize(dest_len);
  return true;
}

// Undo predictors on a [rows x row_bytes] block, item size `isz`.
void undo_predictor(std::vector<uint8_t>* block, uint16_t predictor, int rows,
                    int row_bytes, int isz, bool little) {
  if (predictor == 2) {
    for (int r = 0; r < rows; ++r) {
      uint8_t* row = block->data() + static_cast<size_t>(r) * row_bytes;
      int w = row_bytes / isz;
      if (isz == 2) {
        auto* p = reinterpret_cast<uint16_t*>(row);
        for (int i = 1; i < w; ++i) p[i] = static_cast<uint16_t>(p[i] + p[i - 1]);
      } else if (isz == 4) {
        auto* p = reinterpret_cast<uint32_t*>(row);
        for (int i = 1; i < w; ++i) p[i] += p[i - 1];
      } else {
        for (int i = 1; i < row_bytes; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - 1]);
      }
    }
  } else if (predictor == 3) {
    // Floating-point predictor: per row, byte planes + horizontal diff.
    std::vector<uint8_t> tmp(row_bytes);
    int w = row_bytes / isz;
    for (int r = 0; r < rows; ++r) {
      uint8_t* row = block->data() + static_cast<size_t>(r) * row_bytes;
      for (int i = 1; i < row_bytes; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - 1]);
      // planes are big-endian ordered; recombine to big-endian values.
      for (int i = 0; i < w; ++i)
        for (int b = 0; b < isz; ++b) tmp[i * isz + b] = row[b * w + i];
      std::memcpy(row, tmp.data(), row_bytes);
    }
  }
  (void)little;
}

inline float load_sample(const uint8_t* p, uint16_t fmt, uint16_t bits,
                         bool big_endian_bytes, bool file_little) {
  // big_endian_bytes: predictor-3 output is big-endian regardless of file order.
  bool little = big_endian_bytes ? false : file_little;
  auto rd16 = [&]() -> uint16_t {
    return little ? static_cast<uint16_t>(p[0] | (p[1] << 8))
                  : static_cast<uint16_t>((p[0] << 8) | p[1]);
  };
  auto rd32 = [&]() -> uint32_t {
    return little ? (static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
                     (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24))
                  : (static_cast<uint32_t>(p[3]) | (static_cast<uint32_t>(p[2]) << 8) |
                     (static_cast<uint32_t>(p[1]) << 16) | (static_cast<uint32_t>(p[0]) << 24));
  };
  auto rd64 = [&]() -> uint64_t {
    uint64_t v = 0;
    if (little)
      for (int i = 7; i >= 0; --i) v = (v << 8) | p[i];
    else
      for (int i = 0; i < 8; ++i) v = (v << 8) | p[i];
    return v;
  };
  if (fmt == 3) {
    if (bits == 32) {
      uint32_t v = rd32();
      float f;
      std::memcpy(&f, &v, 4);
      return f;
    }
    uint64_t v = rd64();
    double d;
    std::memcpy(&d, &v, 8);
    return static_cast<float>(d);
  }
  if (fmt == 2) {
    if (bits == 8) return static_cast<float>(static_cast<int8_t>(p[0]));
    if (bits == 16) return static_cast<float>(static_cast<int16_t>(rd16()));
    return static_cast<float>(static_cast<int32_t>(rd32()));
  }
  if (bits == 8) return static_cast<float>(p[0]);
  if (bits == 16) return static_cast<float>(rd16());
  return static_cast<float>(rd32());
}

bool decode_block(const Tiff& t, size_t idx, int block_w, int block_h,
                  std::vector<uint8_t>* raw) {
  size_t off = t.offsets[idx], cnt = t.counts[idx];
  if (!t.r.ok(off, cnt)) { set_error("block out of range"); return false; }
  int isz = t.bits / 8;
  size_t expected = static_cast<size_t>(block_w) * block_h * isz;
  const uint8_t* src = t.r.data + off;
  if (t.compression == 1) {
    raw->assign(src, src + std::min(cnt, expected));
    raw->resize(expected, 0);
  } else if (t.compression == 8 || t.compression == 32946) {
    if (!inflate_bytes(src, cnt, raw, expected)) return false;
    raw->resize(expected, 0);
  } else if (t.compression == 5) {
    if (!lzw_decode(src, cnt, raw, expected)) return false;
    raw->resize(expected, 0);
  } else {
    set_error("unsupported compression " + std::to_string(t.compression));
    return false;
  }
  undo_predictor(raw, t.predictor, block_h, block_w * isz, isz, t.r.little);
  return true;
}

}  // namespace

extern "C" {

struct TopoTiffInfo {
  int32_t width;
  int32_t height;
  int32_t has_pixel_scale;
  int32_t has_tiepoint;
  int32_t has_model_transform;
  double pixel_scale[3];
  double tiepoint[6];
};

const char* topo_last_error() { return g_error.c_str(); }

int topo_tiff_probe(const uint8_t* data, size_t len, TopoTiffInfo* info) {
  Tiff t;
  t.r = {data, len, true};
  if (!parse(&t)) return 1;
  info->width = static_cast<int32_t>(t.width);
  info->height = static_cast<int32_t>(t.height);
  info->has_pixel_scale = t.pixel_scale.size() == 3;
  info->has_tiepoint = t.tiepoint.size() >= 6;
  info->has_model_transform = !t.model_transform.empty();
  for (int i = 0; i < 3; ++i)
    info->pixel_scale[i] = info->has_pixel_scale ? t.pixel_scale[i] : 0.0;
  for (int i = 0; i < 6; ++i)
    info->tiepoint[i] = info->has_tiepoint ? t.tiepoint[i] : 0.0;
  return 0;
}

int topo_tiff_decode(const uint8_t* data, size_t len, float* out,
                     size_t out_count) {
  Tiff t;
  t.r = {data, len, true};
  if (!parse(&t)) return 1;
  if (out_count < static_cast<size_t>(t.width) * t.height) {
    set_error("output buffer too small");
    return 1;
  }
  if (t.bits != 8 && t.bits != 16 && t.bits != 32 && t.bits != 64) {
    set_error("unsupported bit depth");
    return 1;
  }
  int isz = t.bits / 8;
  bool pred3 = t.predictor == 3;
  std::vector<uint8_t> raw;

  if (t.tiled) {
    uint32_t across = (t.width + t.tile_w - 1) / t.tile_w;
    for (size_t idx = 0; idx < t.offsets.size(); ++idx) {
      uint32_t ty = static_cast<uint32_t>(idx) / across;
      uint32_t tx = static_cast<uint32_t>(idx) % across;
      if (!decode_block(t, idx, t.tile_w, t.tile_h, &raw)) return 1;
      uint32_t y0 = ty * t.tile_h, x0 = tx * t.tile_w;
      for (uint32_t y = 0; y < t.tile_h && y0 + y < t.height; ++y) {
        const uint8_t* rowp = raw.data() + static_cast<size_t>(y) * t.tile_w * isz;
        for (uint32_t x = 0; x < t.tile_w && x0 + x < t.width; ++x) {
          out[static_cast<size_t>(y0 + y) * t.width + x0 + x] =
              load_sample(rowp + static_cast<size_t>(x) * isz, t.sample_format,
                          t.bits, pred3, t.r.little);
        }
      }
    }
  } else {
    uint32_t rps = t.rows_per_strip == 0xFFFFFFFFu ? t.height : t.rows_per_strip;
    if (rps == 0) rps = t.height;
    for (size_t idx = 0; idx < t.offsets.size(); ++idx) {
      uint32_t y0 = static_cast<uint32_t>(idx) * rps;
      // More strips than ceil(height/rps) would underflow t.height - y0 and
      // write past the caller's width*height buffer; tile bytes come from the
      // network, so treat the excess as malformed data and stop.
      if (y0 >= t.height) break;
      uint32_t rows = std::min(rps, t.height - y0);
      if (!decode_block(t, idx, t.width, static_cast<int>(rows), &raw)) return 1;
      for (uint32_t y = 0; y < rows; ++y) {
        const uint8_t* rowp = raw.data() + static_cast<size_t>(y) * t.width * isz;
        for (uint32_t x = 0; x < t.width; ++x) {
          out[static_cast<size_t>(y0 + y) * t.width + x] =
              load_sample(rowp + static_cast<size_t>(x) * isz, t.sample_format,
                          t.bits, pred3, t.r.little);
        }
      }
    }
  }
  return 0;
}

// ---- overlay compositor ---------------------------------------------------

static inline void put_px(uint8_t* img, int w, int h, int x, int y, uint8_t r,
                          uint8_t g, uint8_t b) {
  if (x < 0 || y < 0 || x >= w || y >= h) return;
  size_t i = (static_cast<size_t>(y) * w + x) * 3;
  img[i] = r;
  img[i + 1] = g;
  img[i + 2] = b;
}

void topo_draw_line(uint8_t* img, int w, int h, float x0, float y0, float x1,
                    float y1, uint8_t r, uint8_t g, uint8_t b) {
  // Bresenham on rounded endpoints (lyon stroke width ~1 equivalent).
  int ix0 = static_cast<int>(std::lround(x0)), iy0 = static_cast<int>(std::lround(y0));
  int ix1 = static_cast<int>(std::lround(x1)), iy1 = static_cast<int>(std::lround(y1));
  int dx = std::abs(ix1 - ix0), dy = -std::abs(iy1 - iy0);
  int sx = ix0 < ix1 ? 1 : -1, sy = iy0 < iy1 ? 1 : -1;
  int err = dx + dy;
  while (true) {
    put_px(img, w, h, ix0, iy0, r, g, b);
    if (ix0 == ix1 && iy0 == iy1) break;
    int e2 = 2 * err;
    if (e2 >= dy) { err += dy; ix0 += sx; }
    if (e2 <= dx) { err += dx; iy0 += sy; }
  }
}

void topo_fill_round_rect(uint8_t* img, int w, int h, float x, float y,
                          float rw, float rh, float radius, uint8_t r,
                          uint8_t g, uint8_t b) {
  int y0 = std::max(0, static_cast<int>(std::floor(y)));
  int y1 = std::min(h, static_cast<int>(std::ceil(y + rh)));
  int x0 = std::max(0, static_cast<int>(std::floor(x)));
  int x1 = std::min(w, static_cast<int>(std::ceil(x + rw)));
  for (int py = y0; py < y1; ++py) {
    for (int px = x0; px < x1; ++px) {
      float cx = px + 0.5f - x, cy = py + 0.5f - y;
      // corner rounding test
      float qx = std::max(std::max(radius - cx, cx - (rw - radius)), 0.0f);
      float qy = std::max(std::max(radius - cy, cy - (rh - radius)), 0.0f);
      if (qx * qx + qy * qy <= radius * radius + 0.25f)
        put_px(img, w, h, px, py, r, g, b);
    }
  }
}

void topo_blit_glyph(uint8_t* img, int w, int h, const uint8_t* alpha, int gw,
                     int gh, int x, int y, uint8_t r, uint8_t g, uint8_t b) {
  for (int j = 0; j < gh; ++j) {
    int py = y + j;
    if (py < 0 || py >= h) continue;
    for (int i = 0; i < gw; ++i) {
      int px = x + i;
      if (px < 0 || px >= w) continue;
      uint8_t a = alpha[static_cast<size_t>(j) * gw + i];
      if (a == 0) continue;
      size_t idx = (static_cast<size_t>(py) * w + px) * 3;
      img[idx] = static_cast<uint8_t>((img[idx] * (255 - a) + r * a) / 255);
      img[idx + 1] = static_cast<uint8_t>((img[idx + 1] * (255 - a) + g * a) / 255);
      img[idx + 2] = static_cast<uint8_t>((img[idx + 2] * (255 - a) + b * a) / 255);
    }
  }
}

}  // extern "C"
