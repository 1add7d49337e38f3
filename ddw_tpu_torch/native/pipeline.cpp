// Native image-decode pipeline: JPEG -> RGB -> bilinear resize -> [-1, 1] f32.
//
// The port's copy of ddw_tpu/native/pipeline.cpp, the same source line for
// line below this header, so both packages decode a JPEG to the same pixels
// bit for bit. Host input preprocessing in C++ off the Python interpreter
// (the role tf.image's C++ kernels and petastorm's reader pool play in the
// reference workshop). Plain C ABI for ctypes.
//
// ddws_decode_one:   decode a single JPEG into a caller-provided f32 buffer.
// ddws_decode_batch: decode n JPEGs with an internal std::thread pool; the
//                    whole call releases the GIL on the Python side, so decode
//                    parallelism is real OS-thread parallelism.
//
// Decode uses libjpeg DCT scaling (1/2, 1/4, 1/8) to the smallest scale that
// still covers the target, then separable bilinear interpolation. Failures are
// per-image (ok_flags), never fatal: Python retries failed images via PIL.

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode JPEG into an RGB byte image (DCT-scaled to cover (out_h, out_w) when
// possible). Returns false on any decode error.
bool decode_rgb(const unsigned char* data, long len, int out_h, int out_w,
                std::vector<unsigned char>& pixels, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;  // libjpeg converts YCbCr and grayscale
  // Largest DCT downscale whose output still covers the target box.
  cinfo.scale_num = 1;
  cinfo.scale_denom = 1;
  for (int d = 8; d > 1; d /= 2) {
    if (static_cast<int>(cinfo.image_height) / d >= out_h &&
        static_cast<int>(cinfo.image_width) / d >= out_w) {
      cinfo.scale_denom = d;
      break;
    }
  }
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  *h = static_cast<int>(cinfo.output_height);
  *w = static_cast<int>(cinfo.output_width);
  pixels.resize(static_cast<size_t>(*h) * *w * 3);
  const size_t stride = static_cast<size_t>(*w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = pixels.data() + cinfo.output_scanline * stride;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Separable bilinear resize (align-corners=false, the tf.image/PIL convention)
// from (h, w) RGB bytes to (out_h, out_w), normalized to [-1, 1] f32.
void resize_normalize(const std::vector<unsigned char>& src, int h, int w,
                      int out_h, int out_w, float* out) {
  const float sy = static_cast<float>(h) / out_h;
  const float sx = static_cast<float>(w) / out_w;
  std::vector<int> x0s(out_w), x1s(out_w);
  std::vector<float> xws(out_w);
  for (int ox = 0; ox < out_w; ++ox) {
    float fx = (ox + 0.5f) * sx - 0.5f;
    if (fx < 0) fx = 0;
    int x0 = static_cast<int>(fx);
    if (x0 > w - 1) x0 = w - 1;
    int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
    x0s[ox] = x0;
    x1s[ox] = x1;
    xws[ox] = fx - x0;
  }
  const size_t stride = static_cast<size_t>(w) * 3;
  for (int oy = 0; oy < out_h; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    if (y0 > h - 1) y0 = h - 1;
    int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    const float wy = fy - y0;
    const unsigned char* r0 = src.data() + y0 * stride;
    const unsigned char* r1 = src.data() + y1 * stride;
    float* orow = out + static_cast<size_t>(oy) * out_w * 3;
    for (int ox = 0; ox < out_w; ++ox) {
      const int x0 = x0s[ox] * 3, x1 = x1s[ox] * 3;
      const float wx = xws[ox];
      for (int c = 0; c < 3; ++c) {
        const float top = r0[x0 + c] + (r0[x1 + c] - r0[x0 + c]) * wx;
        const float bot = r1[x0 + c] + (r1[x1 + c] - r1[x0 + c]) * wx;
        const float v = top + (bot - top) * wy;
        orow[ox * 3 + c] = v * (1.0f / 127.5f) - 1.0f;
      }
    }
  }
}

bool decode_resize(const unsigned char* data, long len, int out_h, int out_w,
                   float* out) {
  std::vector<unsigned char> pixels;
  int h = 0, w = 0;
  if (!decode_rgb(data, len, out_h, out_w, pixels, &h, &w) || h <= 0 || w <= 0) {
    return false;
  }
  if (h == out_h && w == out_w) {
    // DCT scaling landed exactly on the target (e.g. 448 -> 224 via
    // scale_denom=2, or same-size sources): skip interpolation entirely,
    // just normalize. A tight auto-vectorizable loop.
    const size_t n = static_cast<size_t>(h) * w * 3;
    const unsigned char* p = pixels.data();
    constexpr float kScale = 1.0f / 127.5f;
    for (size_t i = 0; i < n; ++i) out[i] = p[i] * kScale - 1.0f;
    return true;
  }
  resize_normalize(pixels, h, w, out_h, out_w, out);
  return true;
}

}  // namespace

extern "C" {

// Decode one JPEG into out[out_h * out_w * 3] (f32, [-1, 1]). Returns 0 on
// success, -1 on decode failure.
int ddws_decode_one(const unsigned char* data, long len, int out_h, int out_w,
                    float* out) {
  return decode_resize(data, len, out_h, out_w, out) ? 0 : -1;
}

// Decode n JPEGs from a concatenated blob. offsets has n+1 entries; image i is
// blob[offsets[i]:offsets[i+1]]. Output i goes to out + i*out_h*out_w*3;
// ok_flags[i] is 1 on success, 0 on failure (failed slots are left untouched).
// Returns the number of successfully decoded images.
long ddws_decode_batch(const unsigned char* blob, const long* offsets, long n,
                       int out_h, int out_w, int nthreads, float* out,
                       unsigned char* ok_flags) {
  if (n <= 0) return 0;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = static_cast<int>(n);
  const size_t img_elems = static_cast<size_t>(out_h) * out_w * 3;
  std::atomic<long> next(0), n_ok(0);
  auto worker = [&]() {
    for (long i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      const bool ok = decode_resize(blob + offsets[i], offsets[i + 1] - offsets[i],
                                    out_h, out_w, out + i * img_elems);
      ok_flags[i] = ok ? 1 : 0;
      if (ok) n_ok.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(nthreads - 1);
  for (int t = 1; t < nthreads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  return n_ok.load();
}

}  // extern "C"
