// Native host-side image pipeline: JPEG/PNG decode + bilinear resize.
//
// The port's copy of mvsdet_tpu/data/_native/image_ops.cpp (the
// reference's C-backed image IO, mmcv imread/imresize, used in
// multiview_pipeline.py:193-220 and the per-view load loop :478-516).
// Exposed to python through a plain C ABI (ctypes), with a std::thread pool
// for batch loading: each MVSDet scene reads 40-100 JPEGs.
//
// Built at first use by mvsdet_torch/data/native_loader.py:
//   g++ -O3 -shared -fPIC image_ops.cpp -o <build>/libimage_ops-<hash>.so \
//       -ljpeg -lpng -pthread

#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file to tightly-packed RGB8.  Returns true on success.
bool decode_jpeg(const char* path, std::vector<unsigned char>* pixels,
                 int* width, int* height) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *width = cinfo.output_width;
  *height = cinfo.output_height;
  pixels->resize(size_t(*width) * *height * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = pixels->data()
        + size_t(cinfo.output_scanline) * *width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Decode a PNG to RGB8 (color) or keep 16-bit grey (depth maps).
bool decode_png(const char* path, std::vector<unsigned char>* pixels,
                int* width, int* height, int* channels, int* bit_depth) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  *width = png_get_image_width(png, info);
  *height = png_get_image_height(png, info);
  *bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && *bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  png_set_strip_alpha(png);
  // 16-bit depth pngs stay 16-bit big-endian; swap to host order
  if (*bit_depth == 16) png_set_swap(png);
  png_read_update_info(png, info);
  *channels = png_get_channels(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  pixels->resize(rowbytes * *height);
  std::vector<png_bytep> rows(*height);
  for (int y = 0; y < *height; ++y) rows[y] = pixels->data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  return true;
}

bool has_suffix(const char* s, const char* suf) {
  size_t n = strlen(s), m = strlen(suf);
  return n >= m && strncmp(s + n - m, suf, m) == 0;
}

// Bilinear resize (half-pixel centres, matching cv2.INTER_LINEAR).
void resize_bilinear_rgb(const unsigned char* src, int sh, int sw,
                         unsigned char* dst, int dh, int dw) {
  const float fy = float(sh) / dh;
  const float fx = float(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float syf = (y + 0.5f) * fy - 0.5f;
    int y0 = syf < 0 ? 0 : int(syf);
    if (y0 > sh - 2) y0 = sh - 2;
    float wy = syf - y0;
    if (wy < 0) wy = 0;
    if (wy > 1) wy = 1;
    for (int x = 0; x < dw; ++x) {
      float sxf = (x + 0.5f) * fx - 0.5f;
      int x0 = sxf < 0 ? 0 : int(sxf);
      if (x0 > sw - 2) x0 = sw - 2;
      float wx = sxf - x0;
      if (wx < 0) wx = 0;
      if (wx > 1) wx = 1;
      const unsigned char* p00 = src + (size_t(y0) * sw + x0) * 3;
      const unsigned char* p01 = p00 + 3;
      const unsigned char* p10 = p00 + size_t(sw) * 3;
      const unsigned char* p11 = p10 + 3;
      unsigned char* out = dst + (size_t(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = (1 - wy) * ((1 - wx) * p00[c] + wx * p01[c])
                + wy * ((1 - wx) * p10[c] + wx * p11[c]);
        out[c] = (unsigned char)(v + 0.5f);
      }
    }
  }
}

void resize_bilinear_f32(const float* src, int sh, int sw, float* dst,
                         int dh, int dw) {
  const float fy = float(sh) / dh;
  const float fx = float(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float syf = (y + 0.5f) * fy - 0.5f;
    int y0 = syf < 0 ? 0 : int(syf);
    if (y0 > sh - 2) y0 = sh - 2;
    float wy = syf - y0;
    if (wy < 0) wy = 0;
    if (wy > 1) wy = 1;
    for (int x = 0; x < dw; ++x) {
      float sxf = (x + 0.5f) * fx - 0.5f;
      int x0 = sxf < 0 ? 0 : int(sxf);
      if (x0 > sw - 2) x0 = sw - 2;
      float wx = sxf - x0;
      if (wx < 0) wx = 0;
      if (wx > 1) wx = 1;
      const float* p00 = src + size_t(y0) * sw + x0;
      dst[size_t(y) * dw + x] =
          (1 - wy) * ((1 - wx) * p00[0] + wx * p00[1])
          + wy * ((1 - wx) * p00[sw] + wx * p00[sw + 1]);
    }
  }
}

int load_one_rgb(const char* path, int out_h, int out_w,
                 unsigned char* out) {
  std::vector<unsigned char> pixels;
  int w = 0, h = 0;
  if (has_suffix(path, ".png") || has_suffix(path, ".PNG")) {
    int ch = 0, bd = 0;
    if (!decode_png(path, &pixels, &w, &h, &ch, &bd)) return 1;
    if (bd != 8 || ch != 3) return 2;
  } else {
    if (!decode_jpeg(path, &pixels, &w, &h)) return 1;
  }
  resize_bilinear_rgb(pixels.data(), h, w, out, out_h, out_w);
  return 0;
}

}  // namespace

extern "C" {

// Decode one image and bilinearly resize to (out_h, out_w) RGB8.
// Returns 0 on success.
int mvsdet_load_resize_rgb(const char* path, int out_h, int out_w,
                           unsigned char* out) {
  return load_one_rgb(path, out_h, out_w, out);
}

// Decode a 16-bit depth PNG (millimetres), resize, output metres.
int mvsdet_load_depth_png(const char* path, int out_h, int out_w,
                          float* out, float scale) {
  std::vector<unsigned char> pixels;
  int w = 0, h = 0, ch = 0, bd = 0;
  if (!decode_png(path, &pixels, &w, &h, &ch, &bd)) return 1;
  if (ch != 1) return 2;
  std::vector<float> metres(size_t(w) * h);
  if (bd == 16) {
    const unsigned short* p =
        reinterpret_cast<const unsigned short*>(pixels.data());
    for (size_t i = 0; i < metres.size(); ++i) metres[i] = p[i] * scale;
  } else {
    for (size_t i = 0; i < metres.size(); ++i) metres[i] = pixels[i] * scale;
  }
  resize_bilinear_f32(metres.data(), h, w, out, out_h, out_w);
  return 0;
}

// Thread-pooled batch load: n images -> (n, out_h, out_w, 3) uint8.
// Returns the number of failures.
int mvsdet_load_batch_rgb(const char** paths, int n, int out_h, int out_w,
                          unsigned char* out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<int> errors(n, 0);
  std::vector<std::thread> pool;
  const size_t stride = size_t(out_h) * out_w * 3;
  for (int t = 0; t < n_threads; ++t) {
    pool.emplace_back([&, t]() {
      for (int i = t; i < n; i += n_threads) {
        errors[i] = load_one_rgb(paths[i], out_h, out_w, out + stride * i);
      }
    });
  }
  for (auto& th : pool) th.join();
  int bad = 0;
  for (int e : errors) bad += (e != 0);
  return bad;
}

}  // extern "C"
