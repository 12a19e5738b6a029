// Native host-side data loader for ccvpe_torch (a copy of
// ccvpe_tpu/native/dataloader.cc, built by ccvpe_torch/data/native_loader.py).
//
// The reference pipeline decodes and resizes every image in Python worker
// processes (reference datasets.py:98-177 + torchvision transforms) — the
// 14 FPS host-side ceiling.  This library is the device feed's equivalent:
// a C++ thread pool that decodes JPEG/PNG and resamples to the model input
// size with Pillow's exact fixed-point bilinear algorithm (so outputs are
// bit-identical to the PIL path used for checkpoint-parity evaluation),
// writing straight into a caller-provided NHWC uint8 batch buffer.
//
// C API (ctypes-friendly):
//   ccvpe_load_batch(paths, n, out, out_h, out_w, n_threads, statuses)
//     -> decodes + resizes n images concurrently; statuses[i] = 0 on
//        success, nonzero on failure (caller applies the blank-image
//        fallback semantics of datasets.py:100-105).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------------------
// Pillow-compatible bilinear resampling (two-pass, INT16-ish fixed point).
// Mirrors Pillow's Resample.c precompute_coeffs + ImagingResampleHorizontal/
// Vertical_8bpc for the BILINEAR filter so results match PIL bit-for-bit.

constexpr int kPrecisionBits = 32 - 8 - 2;

inline double bilinear_filter(double x) {
  x = x < 0 ? -x : x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

struct Coeffs {
  int ksize = 0;
  std::vector<int> bounds;  // xmin, xcount per output pixel
  std::vector<int> kk;      // fixed-point coefficients, ksize per pixel
};

Coeffs precompute_coeffs(int in_size, int out_size) {
  Coeffs c;
  const double support_base = 1.0;  // bilinear
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = support_base * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.ksize = ksize;
  c.bounds.resize(out_size * 2);
  c.kk.resize(static_cast<size_t>(out_size) * ksize);
  std::vector<double> w(ksize);
  const double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double wsum = 0.0;
    int x = 0;
    for (; x < xmax; ++x) {
      double ww = bilinear_filter((x + xmin - center + 0.5) * ss);
      w[x] = ww;
      wsum += ww;
    }
    for (int i = 0; i < xmax; ++i) {
      if (wsum != 0.0) w[i] /= wsum;
    }
    int* kk = &c.kk[static_cast<size_t>(xx) * ksize];
    for (int i = 0; i < xmax; ++i) {
      const double v = w[i] * (1 << kPrecisionBits);
      kk[i] = static_cast<int>(v < 0 ? v - 0.5 : v + 0.5);
    }
    for (int i = xmax; i < ksize; ++i) kk[i] = 0;
    c.bounds[xx * 2] = xmin;
    c.bounds[xx * 2 + 1] = xmax;
  }
  return c;
}

inline uint8_t clip8(int in) {
  const int v = in >> kPrecisionBits;
  return v < 0 ? 0 : (v > 255 ? 255 : static_cast<uint8_t>(v));
}

// in: [in_h, in_w, 3]; out: [in_h, out_w, 3]
void resample_horizontal(const uint8_t* in, int in_w, int h, uint8_t* out,
                         int out_w, const Coeffs& c) {
  for (int yy = 0; yy < h; ++yy) {
    const uint8_t* row = in + static_cast<size_t>(yy) * in_w * 3;
    uint8_t* orow = out + static_cast<size_t>(yy) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      const int xmin = c.bounds[xx * 2];
      const int xcount = c.bounds[xx * 2 + 1];
      const int* k = &c.kk[static_cast<size_t>(xx) * c.ksize];
      int ss0 = 1 << (kPrecisionBits - 1), ss1 = ss0, ss2 = ss0;
      for (int x = 0; x < xcount; ++x) {
        const uint8_t* p = row + static_cast<size_t>(x + xmin) * 3;
        ss0 += p[0] * k[x];
        ss1 += p[1] * k[x];
        ss2 += p[2] * k[x];
      }
      orow[xx * 3] = clip8(ss0);
      orow[xx * 3 + 1] = clip8(ss1);
      orow[xx * 3 + 2] = clip8(ss2);
    }
  }
}

// in: [in_h, w, 3]; out: [out_h, w, 3]
void resample_vertical(const uint8_t* in, int w, uint8_t* out, int out_h,
                       const Coeffs& c) {
  for (int yy = 0; yy < out_h; ++yy) {
    const int ymin = c.bounds[yy * 2];
    const int ycount = c.bounds[yy * 2 + 1];
    const int* k = &c.kk[static_cast<size_t>(yy) * c.ksize];
    uint8_t* orow = out + static_cast<size_t>(yy) * w * 3;
    for (int xx = 0; xx < w * 3; ++xx) {
      int ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ycount; ++y) {
        ss += in[static_cast<size_t>(y + ymin) * w * 3 + xx] * k[y];
      }
      orow[xx] = clip8(ss);
    }
  }
}

void resize_bilinear(const std::vector<uint8_t>& src, int in_h, int in_w,
                     uint8_t* dst, int out_h, int out_w) {
  if (in_h == out_h && in_w == out_w) {
    std::memcpy(dst, src.data(), src.size());
    return;
  }
  const Coeffs ch = precompute_coeffs(in_w, out_w);
  const Coeffs cv = precompute_coeffs(in_h, out_h);
  std::vector<uint8_t> tmp(static_cast<size_t>(in_h) * out_w * 3);
  resample_horizontal(src.data(), in_w, in_h, tmp.data(), out_w, ch);
  resample_vertical(tmp.data(), out_w, dst, out_h, cv);
}

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg)

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// target_h/target_w > 0 enables DCT-domain scaled decode: libjpeg decodes at
// the smallest M/8 scale whose output still covers the target size, cutting
// IDCT + colorspace work ~quadratically when downscaling (the PIL-`draft`
// trick, but at M/8 granularity).  raw_h/raw_w always report the full
// pre-scale image size.
bool decode_jpeg(FILE* f, std::vector<uint8_t>* out, int* h, int* w,
                 int target_h, int target_w, int* raw_h, int* raw_w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *raw_h = cinfo.image_height;
  *raw_w = cinfo.image_width;
  cinfo.out_color_space = JCS_RGB;
  if (target_h > 0 && target_w > 0 &&
      (target_h < static_cast<int>(cinfo.image_height) ||
       target_w < static_cast<int>(cinfo.image_width))) {
    const int num_h = (8 * target_h + cinfo.image_height - 1) /
                      cinfo.image_height;
    const int num_w = (8 * target_w + cinfo.image_width - 1) /
                      cinfo.image_width;
    int num = std::max(num_h, num_w);
    num = std::min(std::max(num, 1), 8);
    cinfo.scale_num = num;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(static_cast<size_t>(*h) * *w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() +
                   static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------------------
// PNG decode (libpng simplified API)

bool decode_png(const char* path, std::vector<uint8_t>* out, int* h, int* w) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) return false;
  image.format = PNG_FORMAT_RGB;
  *w = image.width;
  *h = image.height;
  out->resize(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, out->data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  return true;
}

// target_h/target_w: fast DCT-scaled JPEG decode hint (0 = exact full-size
// decode).  raw_h/raw_w receive the full pre-scale size.
bool decode_image(const char* path, std::vector<uint8_t>* out, int* h,
                  int* w, int target_h, int target_w, int* raw_h,
                  int* raw_w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  unsigned char magic[8] = {0};
  const size_t got = std::fread(magic, 1, 8, f);
  bool ok = false;
  if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8) {
    std::rewind(f);
    ok = decode_jpeg(f, out, h, w, target_h, target_w, raw_h, raw_w);
    std::fclose(f);
  } else if (got >= 8 && magic[0] == 0x89 && magic[1] == 'P') {
    std::fclose(f);
    ok = decode_png(path, out, h, w);
    *raw_h = *h;
    *raw_w = *w;
  } else {
    std::fclose(f);
  }
  return ok;
}

}  // namespace

extern "C" {

// Decode + resize one image into out[out_h * out_w * 3] (RGB, NHWC order).
// Returns 0 on success.  raw_hw (optional): receives the pre-resize
// (height, width) — consumers like the VIGOR sampler rescale ground-truth
// pixel offsets by the raw satellite size (reference datasets.py:140-141).
// fast != 0 enables DCT-scaled JPEG decode (decode at the smallest M/8 scale
// covering out_h x out_w, then Pillow-bilinear to the target): ~2-4x faster
// on large panoramas, not bit-identical to the full-decode PIL path — use
// for training feeds, not checkpoint-parity eval.
int ccvpe_load_image_fast(const char* path, uint8_t* out, int out_h,
                          int out_w, int* raw_hw, int fast) {
  std::vector<uint8_t> raw;
  int h = 0, w = 0, full_h = 0, full_w = 0;
  if (!decode_image(path, &raw, &h, &w, fast ? out_h : 0, fast ? out_w : 0,
                    &full_h, &full_w)) {
    return 1;
  }
  if (raw_hw != nullptr) {
    raw_hw[0] = full_h;
    raw_hw[1] = full_w;
  }
  resize_bilinear(raw, h, w, out, out_h, out_w);
  return 0;
}

int ccvpe_load_image_ex(const char* path, uint8_t* out, int out_h, int out_w,
                        int* raw_hw) {
  return ccvpe_load_image_fast(path, out, out_h, out_w, raw_hw, 0);
}

int ccvpe_load_image(const char* path, uint8_t* out, int out_h, int out_w) {
  return ccvpe_load_image_fast(path, out, out_h, out_w, nullptr, 0);
}

// Batched, multi-threaded variant: out is [n, out_h, out_w, 3];
// raw_hw (optional) is [n, 2]; fast enables DCT-scaled JPEG decode.
void ccvpe_load_batch_fast(const char** paths, int n, uint8_t* out,
                           int out_h, int out_w, int n_threads,
                           int* statuses, int* raw_hw, int fast) {
  const size_t stride = static_cast<size_t>(out_h) * out_w * 3;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      statuses[i] = ccvpe_load_image_fast(
          paths[i], out + stride * i, out_h, out_w,
          raw_hw == nullptr ? nullptr : raw_hw + 2 * i, fast);
    }
  };
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  const int use = std::min(n_threads, n);
  threads.reserve(use);
  for (int t = 0; t < use; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

void ccvpe_load_batch_ex(const char** paths, int n, uint8_t* out, int out_h,
                         int out_w, int n_threads, int* statuses,
                         int* raw_hw) {
  ccvpe_load_batch_fast(paths, n, out, out_h, out_w, n_threads, statuses,
                        raw_hw, 0);
}

void ccvpe_load_batch(const char** paths, int n, uint8_t* out, int out_h,
                      int out_w, int n_threads, int* statuses) {
  ccvpe_load_batch_fast(paths, n, out, out_h, out_w, n_threads, statuses,
                        nullptr, 0);
}

// Pillow-exact bilinear resize of a raw RGB buffer (for testing / reuse).
void ccvpe_resize_bilinear(const uint8_t* in, int in_h, int in_w,
                           uint8_t* out, int out_h, int out_w) {
  std::vector<uint8_t> src(in, in + static_cast<size_t>(in_h) * in_w * 3);
  resize_bilinear(src, in_h, in_w, out, out_h, out_w);
}

}  // extern "C"
