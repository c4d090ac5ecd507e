// fastimage: GIL-free JPEG decode + crop + bilinear resize worker pool.
//
// The port's own copy of multimodal_dataset_distillation_tpu/native/
// fastimage.cpp (same code, same C ABI, so both packages decode a JPEG to
// the same bytes).  The reference feeds its GPUs through torch DataLoader
// worker *processes* running PIL (data/__init__.py:236-256); full-
// resolution JPEG decode + RandomResizedCrop dominates the host side of
// the expert phase.  This is a C++ thread pool (no GIL, no worker
// processes, no pickle) that decodes each JPEG directly to the crop
// rectangle and bilinearly resizes to the target square, returning uint8
// RGB ready for the cheap Python-side RandAugment + normalize.  Host code,
// not a device kernel.
//
// Exposed C ABI (ctypes):
//   fi_read_dims(data, size, &w, &h)              -> 0 ok
//   fi_decode_batch(tasks, n, out, out_size, nthreads) -> #failures
//     tasks[i]: {data, size, crop_x, crop_y, crop_w, crop_h, hflip}
//     out: n * out_size * out_size * 3 uint8 (RGB)
//     a failed image leaves zeros at its slot; caller falls back to PIL.
//
// Build (native/__init__.py, at first use):
//   g++ -O3 -fPIC -shared -std=c++17 fastimage.cpp -ljpeg
//       -o build/native/_fastimage.so

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

extern "C" {

struct FiTask {
  const uint8_t* data;
  int64_t size;
  int32_t crop_x, crop_y, crop_w, crop_h;
  int32_t hflip;
};

struct FiErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void fi_error_exit(j_common_ptr cinfo) {
  FiErr* e = reinterpret_cast<FiErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode `data` and write the crop rect resized to (out_size x out_size)
// RGB uint8 into `out`. Returns 0 on success.
static int decode_one(const FiTask& t, uint8_t* out, int out_size) {
  jpeg_decompress_struct cinfo;
  FiErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = fi_error_exit;
  std::vector<uint8_t> pixels;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, t.data, static_cast<unsigned long>(t.size));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  cinfo.out_color_space = JCS_RGB;
  // DCT scaling: decode at the smallest scale that still covers the crop
  // at >= out_size resolution (big decode-time win on large photos).
  int full_w = cinfo.image_width;
  int full_h = cinfo.image_height;
  int crop_w = t.crop_w > 0 ? t.crop_w : full_w;
  for (int denom = 8; denom >= 1; denom /= 2) {
    // scaled crop width must stay >= out_size (no upsampling loss)
    if ((long)crop_w * 1 / denom >= out_size || denom == 1) {
      cinfo.scale_num = 1;
      cinfo.scale_denom = denom;
      break;
    }
  }
  jpeg_start_decompress(&cinfo);
  const int W = cinfo.output_width, H = cinfo.output_height;
  const int C = cinfo.output_components;  // 3 (JCS_RGB)
  pixels.resize((size_t)W * H * C);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pixels.data() + (size_t)cinfo.output_scanline * W * C;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // crop rect in original coords -> scaled coords
  double sx = (double)W / full_w;
  double sy = (double)H / full_h;
  double cx = t.crop_x * sx, cy = t.crop_y * sy;
  double cw = (t.crop_w > 0 ? t.crop_w : full_w) * sx;
  double ch = (t.crop_h > 0 ? t.crop_h : full_h) * sy;
  if (cw < 1) cw = 1;
  if (ch < 1) ch = 1;

  // bilinear resample crop -> out_size^2
  for (int oy = 0; oy < out_size; ++oy) {
    double fy = cy + (oy + 0.5) * ch / out_size - 0.5;
    if (fy < 0) fy = 0;
    if (fy > H - 1) fy = H - 1;
    int y0 = (int)fy, y1 = y0 + 1 < H ? y0 + 1 : y0;
    double wy = fy - y0;
    for (int ox = 0; ox < out_size; ++ox) {
      double fx = cx + (ox + 0.5) * cw / out_size - 0.5;
      if (fx < 0) fx = 0;
      if (fx > W - 1) fx = W - 1;
      int x0 = (int)fx, x1 = x0 + 1 < W ? x0 + 1 : x0;
      double wx = fx - x0;
      int tx = t.hflip ? (out_size - 1 - ox) : ox;
      uint8_t* dst = out + ((size_t)oy * out_size + tx) * 3;
      for (int c = 0; c < 3 && c < C; ++c) {
        double v00 = pixels[((size_t)y0 * W + x0) * C + c];
        double v01 = pixels[((size_t)y0 * W + x1) * C + c];
        double v10 = pixels[((size_t)y1 * W + x0) * C + c];
        double v11 = pixels[((size_t)y1 * W + x1) * C + c];
        double v = (v00 * (1 - wx) + v01 * wx) * (1 - wy) +
                   (v10 * (1 - wx) + v11 * wx) * wy;
        dst[c] = (uint8_t)(v + 0.5);
      }
    }
  }
  return 0;
}

int fi_read_dims(const uint8_t* data, int64_t size, int32_t* w, int32_t* h) {
  jpeg_decompress_struct cinfo;
  FiErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = fi_error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(size));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int fi_decode_batch(const FiTask* tasks, int32_t n, uint8_t* out,
                    int32_t out_size, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), failures(0);
  const size_t stride = (size_t)out_size * out_size * 3;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      if (decode_one(tasks[i], out + stride * i, out_size) != 0) {
        std::memset(out + stride * i, 0, stride);
        failures.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> pool;
  int nt = n_threads < n ? n_threads : n;
  for (int i = 0; i < nt - 1; ++i) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
