// mafed_tpu_torch native data engine: JPEG/PNG decode + antialiased bicubic
// resize + center crop (a copy of mafed_tpu/native/image_engine.cpp; keep the
// two byte-for-byte equal in what they compute: the port's decoded pixels
// are held bit for bit against the JAX package's).
//
// The host side of the image path: decode + resize runs here in C++,
// emitting uint8 HWC ready for the on-device normalize
// (data/images.py make_normalizer).
//
// Geometry matches the Python path: bicubic (a=-0.5, PIL-style kernel
// widened by the scale factor when downscaling) short-side resize to
// floor(target/crop_pct), then center crop target x target.
//
// Exports (C ABI, used via ctypes):
//   mafed_decode_file     — one image file -> uint8 HWC buffer
//   mafed_engine_version

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Image {
  int width = 0;
  int height = 0;
  std::vector<uint8_t> rgb;  // HWC, 3 channels
};

// ---------------------------------------------------------------- JPEG ----
struct JpegErrorMgr {
  jpeg_error_mgr pub;
  std::jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  std::longjmp(err->jump, 1);
}

bool decode_jpeg(const uint8_t* data, size_t size, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, size);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->width = cinfo.output_width;
  out->height = cinfo.output_height;
  out->rgb.resize(size_t(out->width) * out->height * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ----------------------------------------------------------------- PNG ----
struct PngReadCtx {
  const uint8_t* data;
  size_t size;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  auto* ctx = static_cast<PngReadCtx*>(png_get_io_ptr(png));
  if (ctx->pos + n > ctx->size) {
    png_error(png, "read past end");
  }
  std::memcpy(out, ctx->data + ctx->pos, n);
  ctx->pos += n;
}

bool decode_png(const uint8_t* data, size_t size, Image* out) {
  if (size < 8 || png_sig_cmp(data, 0, 8)) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadCtx ctx{data, size, 0};
  png_set_read_fn(png, &ctx, png_read_fn);
  png_read_info(png, info);

  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->width = png_get_image_width(png, info);
  out->height = png_get_image_height(png, info);
  out->rgb.resize(size_t(out->width) * out->height * 3);
  std::vector<png_bytep> rows(out->height);
  for (int y = 0; y < out->height; ++y) {
    rows[y] = out->rgb.data() + size_t(y) * out->width * 3;
  }
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// ------------------------------------------------------ bicubic resize ----
// PIL-compatible: cubic kernel a=-0.5, support 2.0, widened by the scale
// factor when downscaling (antialias).
double cubic_kernel(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct FilterTaps {
  std::vector<int> bounds;      // per output index: first input index
  std::vector<int> counts;      // per output index: number of taps
  std::vector<double> weights;  // flattened [out, max_taps]
  int max_taps = 0;
};

FilterTaps build_taps(int in_size, int out_size) {
  FilterTaps taps;
  const double scale = double(in_size) / out_size;
  const double filter_scale = std::max(scale, 1.0);
  const double support = 2.0 * filter_scale;
  taps.max_taps = int(std::ceil(support)) * 2 + 1;
  taps.bounds.resize(out_size);
  taps.counts.resize(out_size);
  taps.weights.assign(size_t(out_size) * taps.max_taps, 0.0);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int lo = std::max(int(center - support + 0.5), 0);
    int hi = std::min(int(center + support + 0.5), in_size);
    double sum = 0.0;
    for (int j = lo; j < hi; ++j) {
      double w = cubic_kernel((j + 0.5 - center) / filter_scale);
      taps.weights[size_t(i) * taps.max_taps + (j - lo)] = w;
      sum += w;
    }
    if (sum != 0.0) {
      for (int j = 0; j < hi - lo; ++j) {
        taps.weights[size_t(i) * taps.max_taps + j] /= sum;
      }
    }
    taps.bounds[i] = lo;
    taps.counts[i] = hi - lo;
  }
  return taps;
}

uint8_t clamp_u8(double v) {
  return uint8_t(std::min(std::max(v + 0.5, 0.0), 255.0));
}

// separable resize HWC uint8 via double intermediate
void resize_bicubic(const Image& in, int out_w, int out_h, Image* out) {
  FilterTaps tx = build_taps(in.width, out_w);
  FilterTaps ty = build_taps(in.height, out_h);

  // horizontal pass: [in_h, out_w, 3] doubles
  std::vector<double> tmp(size_t(in.height) * out_w * 3);
  for (int y = 0; y < in.height; ++y) {
    const uint8_t* row = in.rgb.data() + size_t(y) * in.width * 3;
    double* trow = tmp.data() + size_t(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      const int lo = tx.bounds[x];
      const int n = tx.counts[x];
      const double* w = tx.weights.data() + size_t(x) * tx.max_taps;
      double acc[3] = {0, 0, 0};
      for (int j = 0; j < n; ++j) {
        const uint8_t* px = row + size_t(lo + j) * 3;
        acc[0] += w[j] * px[0];
        acc[1] += w[j] * px[1];
        acc[2] += w[j] * px[2];
      }
      trow[x * 3 + 0] = acc[0];
      trow[x * 3 + 1] = acc[1];
      trow[x * 3 + 2] = acc[2];
    }
  }
  // vertical pass
  out->width = out_w;
  out->height = out_h;
  out->rgb.resize(size_t(out_w) * out_h * 3);
  for (int y = 0; y < out_h; ++y) {
    const int lo = ty.bounds[y];
    const int n = ty.counts[y];
    const double* w = ty.weights.data() + size_t(y) * ty.max_taps;
    uint8_t* orow = out->rgb.data() + size_t(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      double acc[3] = {0, 0, 0};
      for (int j = 0; j < n; ++j) {
        const double* px = tmp.data() + (size_t(lo + j) * out_w + x) * 3;
        acc[0] += w[j] * px[0];
        acc[1] += w[j] * px[1];
        acc[2] += w[j] * px[2];
      }
      orow[x * 3 + 0] = clamp_u8(acc[0]);
      orow[x * 3 + 1] = clamp_u8(acc[1]);
      orow[x * 3 + 2] = clamp_u8(acc[2]);
    }
  }
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size <= 0) {
    std::fclose(f);
    return false;
  }
  out->resize(size_t(size));
  size_t got = std::fread(out->data(), 1, size_t(size), f);
  std::fclose(f);
  return got == size_t(size);
}

// decode + short-side resize to scale_size + center crop target x target
int process_one(const char* path, int target, int scale_size, uint8_t* out_buf) {
  std::vector<uint8_t> bytes;
  if (!read_file(path, &bytes)) return -1;
  Image img;
  bool ok = false;
  if (bytes.size() >= 3 && bytes[0] == 0xFF && bytes[1] == 0xD8) {
    ok = decode_jpeg(bytes.data(), bytes.size(), &img);
  } else {
    ok = decode_png(bytes.data(), bytes.size(), &img);
    if (!ok) ok = decode_jpeg(bytes.data(), bytes.size(), &img);
  }
  if (!ok || img.width <= 0 || img.height <= 0) return -2;

  int new_w, new_h;
  if (img.width <= img.height) {
    new_w = scale_size;
    new_h = int(std::lround(double(img.height) * scale_size / img.width));
  } else {
    new_h = scale_size;
    new_w = int(std::lround(double(img.width) * scale_size / img.height));
  }
  Image resized;
  resize_bicubic(img, new_w, new_h, &resized);

  const int left = (new_w - target) / 2;
  const int top = (new_h - target) / 2;
  if (left < 0 || top < 0) return -3;
  for (int y = 0; y < target; ++y) {
    std::memcpy(
        out_buf + size_t(y) * target * 3,
        resized.rgb.data() + (size_t(top + y) * new_w + left) * 3,
        size_t(target) * 3);
  }
  return 0;
}

}  // namespace

extern "C" {

int mafed_engine_version() { return 1; }

// Decode one file into out (target*target*3 uint8 HWC). Returns 0 on success.
int mafed_decode_file(const char* path, int target, int scale_size, uint8_t* out) {
  return process_one(path, target, scale_size, out);
}

}  // extern "C"
