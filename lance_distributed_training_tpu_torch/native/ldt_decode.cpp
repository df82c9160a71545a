// Native batch JPEG decoder: a copy of the JAX package's
// `native/ldt_decode.cpp`, reduced to its two decode entry points (the
// coefficient-extraction half waits for the device-decode slice). The pixels
// are the same as the JAX package's decoder gives for the same payloads:
//   * libjpeg decode with DCT scaling (decode directly at 1/2, 1/4, 1/8 when
//     the target is smaller, skipping most of the IDCT work),
//   * fixed-point 16.16 bilinear resize to the target square (integer only,
//     so the output does not depend on the CPU the library was built for),
//   * a C++ thread pool writing each image straight into its slot of the
//     caller's NHWC uint8 batch buffer.
//
// Build (lance_distributed_training_tpu_torch/native/jpeg.py does it at
// first use): g++ -O3 -std=c++17 -shared -fPIC ldt_decode.cpp -ljpeg -pthread
// C ABI only; bound from Python with ctypes.

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Bilinear resize RGB u8, src (sw x sh) -> dst (dw x dh). Fixed-point 16.16.
void resize_bilinear(const uint8_t* src, int sw, int sh, uint8_t* dst, int dw,
                     int dh) {
  const int64_t x_ratio = ((int64_t)(sw - 1) << 16) / (dw > 1 ? dw - 1 : 1);
  const int64_t y_ratio = ((int64_t)(sh - 1) << 16) / (dh > 1 ? dh - 1 : 1);
  for (int y = 0; y < dh; ++y) {
    const int64_t sy_fix = y * y_ratio;
    const int sy = (int)(sy_fix >> 16);
    const int wy = (int)(sy_fix & 0xFFFF);
    const int sy1 = sy + 1 < sh ? sy + 1 : sy;
    const uint8_t* row0 = src + (size_t)sy * sw * 3;
    const uint8_t* row1 = src + (size_t)sy1 * sw * 3;
    uint8_t* out = dst + (size_t)y * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const int64_t sx_fix = x * x_ratio;
      const int sx = (int)(sx_fix >> 16);
      const int wx = (int)(sx_fix & 0xFFFF);
      const int sx1 = sx + 1 < sw ? sx + 1 : sx;
      for (int c = 0; c < 3; ++c) {
        const int p00 = row0[sx * 3 + c], p01 = row0[sx1 * 3 + c];
        const int p10 = row1[sx * 3 + c], p11 = row1[sx1 * 3 + c];
        const int64_t top = ((int64_t)p00 << 16) + (int64_t)(p01 - p00) * wx;
        const int64_t bot = ((int64_t)p10 << 16) + (int64_t)(p11 - p10) * wx;
        const int64_t val = (top << 16) + (bot - top) * wy;  // 32.32
        out[x * 3 + c] = (uint8_t)(val >> 32);
      }
    }
  }
}

// Decode one JPEG into dst (out_size x out_size x 3 u8). Returns 0 on success.
int decode_one(const uint8_t* data, size_t len, int out_size, uint8_t* dst,
               std::vector<uint8_t>& scratch) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data), (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  // DCT scaling: pick the largest denominator whose output still covers the
  // target (the same trick as PIL draft / libjpeg-turbo tjscalingfactors).
  cinfo.scale_num = 1;
  cinfo.scale_denom = 1;
  for (int denom = 8; denom > 1; denom /= 2) {
    if ((int)cinfo.image_width / denom >= out_size &&
        (int)cinfo.image_height / denom >= out_size) {
      cinfo.scale_denom = denom;
      break;
    }
  }
  cinfo.dct_method = JDCT_IFAST;
  cinfo.do_fancy_upsampling = FALSE;
  jpeg_start_decompress(&cinfo);
  const int sw = cinfo.output_width, sh = cinfo.output_height;
  const size_t row_bytes = (size_t)sw * cinfo.output_components;
  const bool direct =
      sw == out_size && sh == out_size && cinfo.output_components == 3;
  uint8_t* sink = dst;
  if (!direct) {
    scratch.resize(row_bytes * sh);
    sink = scratch.data();
  }
  // Already at target size: decode scanlines straight into the caller's
  // batch slot — no scratch buffer, no copy. Otherwise decode to scratch
  // and resize.
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = sink + (size_t)cinfo.output_scanline * row_bytes;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  // out_color_space was forced to JCS_RGB before jpeg_start_decompress, so
  // libjpeg itself converts grayscale/YCbCr → 3 components (unconvertible
  // color spaces longjmp to the error path). Capture before destroy.
  const int components = cinfo.output_components;
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (components != 3) return 2;

  if (!direct) {
    resize_bilinear(scratch.data(), sw, sh, dst, out_size, out_size);
  }
  return 0;
}

}  // namespace

extern "C" {

// Decode n JPEGs into out (n * out_size * out_size * 3, NHWC u8).
// srcs[i]/lens[i] describe image i. Returns the number of FAILED images;
// failed slots are zero-filled and flagged in failed[i] (if non-null).
int ldt_decode_batch(const uint8_t** srcs, const size_t* lens, int n,
                     int out_size, uint8_t* out, uint8_t* failed,
                     int n_threads) {
  if (n <= 0) return 0;
  const size_t img_bytes = (size_t)out_size * out_size * 3;
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    std::vector<uint8_t> scratch;
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      uint8_t* dst = out + (size_t)i * img_bytes;
      int rc = decode_one(srcs[i], lens[i], out_size, dst, scratch);
      if (rc != 0) {
        std::memset(dst, 0, img_bytes);
        if (failed) failed[i] = 1;
        failures.fetch_add(1);
      } else if (failed) {
        failed[i] = 0;
      }
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

// Zero-copy Arrow path: decode n JPEGs described by an Arrow binary column's
// buffers — `data` is the values buffer, `offsets[i]..offsets[i+1]` delimits
// image i (int64, as in Arrow large_binary; the Python side widens int32
// offsets). No per-row Python bytes objects are ever materialised.
int ldt_decode_batch_offsets(const uint8_t* data, const int64_t* offsets,
                             int n, int out_size, uint8_t* out,
                             uint8_t* failed, int n_threads) {
  if (n <= 0) return 0;
  const size_t img_bytes = (size_t)out_size * out_size * 3;
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    std::vector<uint8_t> scratch;
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      uint8_t* dst = out + (size_t)i * img_bytes;
      const int64_t lo = offsets[i], hi = offsets[i + 1];
      int rc = (hi > lo)
                   ? decode_one(data + lo, (size_t)(hi - lo), out_size, dst,
                                scratch)
                   : 1;
      if (rc != 0) {
        std::memset(dst, 0, img_bytes);
        if (failed) failed[i] = 1;
        failures.fetch_add(1);
      } else if (failed) {
        failed[i] = 0;
      }
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

}  // extern "C"

extern "C" {

// Version tag so the Python side can detect a stale build.
int ldt_decode_abi_version() { return 1; }

}  // extern "C"
