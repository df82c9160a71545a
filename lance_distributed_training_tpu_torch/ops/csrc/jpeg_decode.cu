// K2: the dense half of device-side JPEG decode, from coefficient pages to
// resized RGB.
//
// Replaces the JAX package's `ops/jpeg_device.py` `decode_coeff_batch`
// (:180) and its helpers `_idct_plane` (:106), `_upsample_h2v2` (:130),
// `_ycc_to_rgb` (:137), `_axis_samples` (:148) and `_resize_one` (:162),
// which XLA compiles on the TPU. It computes what that function computes,
// bit for bit, in two kernels on one stream:
//
// (a) jpeg_idct_kernel: every 8x8 block of the three planes. Dequantize,
//     the columns pass s1[u][y] = sum_v C[u][v] * B[y][v], (s1 + 1024) >> 11,
//     the rows pass p[x][y] = sum_u B[x][u] * s1[u][y], (p + 1024) >> 11,
//     + 128, clip to [0, 255]; writes uint8 planes [N, BH*8, BW*8]. B is the
//     11-bit basis `IDCT_BASIS_FIX`, handed in by the caller.
// (b) jpeg_color_resize_kernel: one thread per output pixel. The 16.16
//     sample positions of `_axis_samples` from the image's geometry, four
//     luma samples with the chroma at (y >> 1, x >> 1) (the non-fancy h2v2
//     upsample), jdcolor's integer YCbCr -> RGB with clipping, then the
//     bilinear mix, vertical first and horizontal second, as `_resize_one`
//     does. Writes uint8 NHWC [N, S, S, 3].
//
// Integer semantics. The JAX function's products and sums are int32 and
// wrap around (16-bit quant tables can reach that); here they are taken in
// uint32, whose wrap-around is defined, and turned back into int32 only for
// the arithmetic right shifts. A sample index is normalised (a negative one
// counts from the end) and clamped into the plane, as JAX's gather does,
// and the division of `_axis_samples` floors.
//
// Bound: bytes. At the main path's shape (pages int16 [512, 28, 28, 64] and
// 2 x [512, 14, 14, 64] in, uint8 [512, 224, 224, 3] out) the function must
// move about 155 MB and does about 1.3 G integer operations, so it is
// bound by memory at 3.35 TB/s (about 46 us) rather than by the integer
// rate. Design: (a) gives 8 threads to each 8x8 block, one row each, 32
// blocks to a CUDA block: a thread loads its coefficient row as one 16-byte
// vector, keeps both passes in registers with the intermediate rows in
// shared memory (stride 68 words, so that the four blocks of a warp fall in
// different banks), and stores its output row as one 8-byte vector. (b)
// reads the planes through L1 (neighbouring threads share samples). The
// planes make one extra round trip through device memory (about 38 MB
// each way); fusing (a) into (b) is later work.
//
// C interface (bound with ctypes by ops/jpeg_device.py):
//   int ldt_jpeg_decode(const int16_t* coef_y, const int16_t* coef_cb,
//                       const int16_t* coef_cr, const int32_t* quant,
//                       const int32_t* geom, const int32_t* basis,
//                       int N, int ybh, int ybw, int cbh, int cbw, int S,
//                       uint8_t* plane_y, uint8_t* plane_cb,
//                       uint8_t* plane_cr, uint8_t* out, cudaStream_t);
// returns the cudaError_t of the launches (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlocksPerCta = 32;  // 8x8 blocks per CUDA block in (a)
constexpr int kIdctThreads = kBlocksPerCta * 8;
constexpr int kStride = 68;  // shared int32 words per 8x8 block
constexpr int kPixelThreads = 256;

struct Plane {
  const int16_t* coef;  // [N, bh, bw, 64]
  uint8_t* out;         // [N, bh * 8, bw * 8]
  int bh, bw;
  int comp;             // quant slot: 0 Y, 1 Cb, 2 Cr
  long long blocks;     // N * bh * bw
};

__device__ __forceinline__ int descale(uint32_t acc) {
  return static_cast<int>(acc + 1024u) >> 11;
}

__global__ void __launch_bounds__(kIdctThreads)
    jpeg_idct_kernel(Plane py, Plane pcb, Plane pcr,
                     const int32_t* __restrict__ quant,
                     const int32_t* __restrict__ basis, long long groups_y,
                     long long groups_c) {
  __shared__ int32_t s_basis[64];
  __shared__ __align__(16) int32_t s_rows[kBlocksPerCta * kStride];
  const int t = threadIdx.x;
  if (t < 64) s_basis[t] = basis[t];
  long long g = blockIdx.x;
  Plane p = py;
  if (g >= groups_y) {
    g -= groups_y;
    p = pcb;
    if (g >= groups_c) {
      g -= groups_c;
      p = pcr;
    }
  }
  __syncthreads();

  const int jb = t >> 3;  // the 8x8 block of this CUDA block
  const int r = t & 7;    // the row of it this thread works on
  const long long blk = g * kBlocksPerCta + jb;
  const bool valid = blk < p.blocks;
  const long long per_image = static_cast<long long>(p.bh) * p.bw;
  const long long n = valid ? blk / per_image : 0;

  // Row r of the block (natural order u = r, v = 0..7), dequantized.
  uint32_t c[8];
  if (valid) {
    const int4 raw = *reinterpret_cast<const int4*>(p.coef + blk * 64 + r * 8);
    const int4* qp =
        reinterpret_cast<const int4*>(quant + (n * 3 + p.comp) * 64 + r * 8);
    const int4 q0 = __ldg(qp), q1 = __ldg(qp + 1);
    const uint32_t w[4] = {static_cast<uint32_t>(raw.x),
                           static_cast<uint32_t>(raw.y),
                           static_cast<uint32_t>(raw.z),
                           static_cast<uint32_t>(raw.w)};
    const int32_t q[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int16_t coef = static_cast<int16_t>(
          (w[v >> 1] >> ((v & 1) * 16)) & 0xffffu);
      c[v] = static_cast<uint32_t>(static_cast<int32_t>(coef)) *
             static_cast<uint32_t>(q[v]);
    }
  } else {
#pragma unroll
    for (int v = 0; v < 8; ++v) c[v] = 0;
  }

  // Columns pass: s1[r][y] = sum_v C[r][v] * B[y][v].
  int32_t s1[8];
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    uint32_t acc = 0;
#pragma unroll
    for (int v = 0; v < 8; ++v)
      acc += c[v] * static_cast<uint32_t>(s_basis[y * 8 + v]);
    s1[y] = descale(acc);
  }
  int32_t* mine = s_rows + jb * kStride;
  reinterpret_cast<int4*>(mine + r * 8)[0] =
      make_int4(s1[0], s1[1], s1[2], s1[3]);
  reinterpret_cast<int4*>(mine + r * 8)[1] =
      make_int4(s1[4], s1[5], s1[6], s1[7]);
  __syncwarp();  // the 8 threads of a block share one warp

  // Rows pass: p[r][y] = sum_u B[r][u] * s1[u][y].
  uint32_t bx[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) bx[u] = static_cast<uint32_t>(s_basis[r * 8 + u]);
  uint32_t acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int4 a = reinterpret_cast<const int4*>(mine + u * 8)[0];
    const int4 b = reinterpret_cast<const int4*>(mine + u * 8)[1];
    const int32_t row[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int y = 0; y < 8; ++y) acc[y] += bx[u] * static_cast<uint32_t>(row[y]);
  }
  if (!valid) return;
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    int px = static_cast<int>(static_cast<uint32_t>(descale(acc[y])) + 128u);
    px = min(max(px, 0), 255);
    if (y < 4) {
      lo |= static_cast<uint32_t>(px) << (8 * y);
    } else {
      hi |= static_cast<uint32_t>(px) << (8 * (y - 4));
    }
  }
  const long long in_image = blk - n * per_image;
  const int by = static_cast<int>(in_image / p.bw);
  const int bxi = static_cast<int>(in_image - static_cast<long long>(by) * p.bw);
  const long long width = static_cast<long long>(p.bw) * 8;
  const long long row_index =
      n * (static_cast<long long>(p.bh) * 8) + by * 8 + r;
  *reinterpret_cast<uint2*>(p.out + row_index * width + bxi * 8) =
      make_uint2(lo, hi);
}

// JAX's gather on one index: negative counts from the end, then clamp.
__device__ __forceinline__ int gather_index(int i, int extent) {
  if (i < 0) i += extent;
  return min(max(i, 0), extent - 1);
}

// `_axis_samples` for output position `o`: the two source indices (as the
// gather takes them) and the 16-bit weight.
__device__ __forceinline__ void axis_samples(int size, int S, int o,
                                             int extent, int& i0, int& i1,
                                             int& w) {
  size = max(size, 1);
  const int num = static_cast<int>(static_cast<uint32_t>(size - 1) << 16);
  const int den = S > 1 ? S - 1 : 1;
  int ratio = num / den;
  if (num % den != 0 && num < 0) --ratio;  // floor division
  const int fix = static_cast<int>(static_cast<uint32_t>(o) *
                                   static_cast<uint32_t>(ratio));
  const int a = fix >> 16;
  w = fix & 0xFFFF;
  const int b = min(a + 1, size - 1);
  i0 = gather_index(a, extent);
  i1 = gather_index(b, extent);
}

struct Rgb {
  int r, g, b;
};

__device__ __forceinline__ Rgb ycc_at(const uint8_t* __restrict__ y_plane,
                                      const uint8_t* __restrict__ cb_plane,
                                      const uint8_t* __restrict__ cr_plane,
                                      int yw, int cw, int sy, int sx) {
  const int y = __ldg(y_plane + static_cast<long long>(sy) * yw + sx);
  const long long ci = static_cast<long long>(sy >> 1) * cw + (sx >> 1);
  const int cb = static_cast<int>(__ldg(cb_plane + ci)) - 128;
  const int cr = static_cast<int>(__ldg(cr_plane + ci)) - 128;
  Rgb out;
  out.r = min(max(y + ((91881 * cr + 32768) >> 16), 0), 255);
  out.g = min(max(y - ((22554 * cb + 46802 * cr + 32768) >> 16), 0), 255);
  out.b = min(max(y + ((116130 * cb + 32768) >> 16), 0), 255);
  return out;
}

__device__ __forceinline__ int mix(int a, int b, int w) {
  return a + (((b - a) * w) >> 16);
}

__global__ void __launch_bounds__(kPixelThreads)
    jpeg_color_resize_kernel(const uint8_t* __restrict__ plane_y,
                             const uint8_t* __restrict__ plane_cb,
                             const uint8_t* __restrict__ plane_cr,
                             const int32_t* __restrict__ geom, int N,
                             int ybh, int ybw, int cbh, int cbw, int S,
                             uint8_t* __restrict__ out) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kPixelThreads + threadIdx.x;
  const long long per_image = static_cast<long long>(S) * S;
  if (idx >= per_image * N) return;
  const int n = static_cast<int>(idx / per_image);
  const int rem = static_cast<int>(idx - n * per_image);
  const int oy = rem / S;
  const int ox = rem - oy * S;
  const int yh = ybh * 8, yw = ybw * 8;
  const int ch = cbh * 8, cw = cbw * 8;
  int sy0, sy1, wy, sx0, sx1, wx;
  axis_samples(__ldg(geom + n * 6 + 1), S, oy, yh, sy0, sy1, wy);
  axis_samples(__ldg(geom + n * 6 + 0), S, ox, yw, sx0, sx1, wx);
  const uint8_t* py = plane_y + static_cast<long long>(n) * yh * yw;
  const uint8_t* pcb = plane_cb + static_cast<long long>(n) * ch * cw;
  const uint8_t* pcr = plane_cr + static_cast<long long>(n) * ch * cw;
  const Rgb a00 = ycc_at(py, pcb, pcr, yw, cw, sy0, sx0);
  const Rgb a10 = ycc_at(py, pcb, pcr, yw, cw, sy1, sx0);
  const Rgb a01 = ycc_at(py, pcb, pcr, yw, cw, sy0, sx1);
  const Rgb a11 = ycc_at(py, pcb, pcr, yw, cw, sy1, sx1);
  uint8_t* o = out + idx * 3;
  o[0] = static_cast<uint8_t>(
      mix(mix(a00.r, a10.r, wy), mix(a01.r, a11.r, wy), wx));
  o[1] = static_cast<uint8_t>(
      mix(mix(a00.g, a10.g, wy), mix(a01.g, a11.g, wy), wx));
  o[2] = static_cast<uint8_t>(
      mix(mix(a00.b, a10.b, wy), mix(a01.b, a11.b, wy), wx));
}

}  // namespace

extern "C" int ldt_jpeg_decode(const int16_t* coef_y, const int16_t* coef_cb,
                               const int16_t* coef_cr, const int32_t* quant,
                               const int32_t* geom, const int32_t* basis,
                               int N, int ybh, int ybw, int cbh, int cbw,
                               int S, uint8_t* plane_y, uint8_t* plane_cb,
                               uint8_t* plane_cr, uint8_t* out,
                               cudaStream_t stream) {
  if (N <= 0 || S <= 0) return 0;
  if (ybh <= 0 || ybw <= 0 || cbh <= 0 || cbw <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t vec = reinterpret_cast<uintptr_t>(coef_y) |
                        reinterpret_cast<uintptr_t>(coef_cb) |
                        reinterpret_cast<uintptr_t>(coef_cr) |
                        reinterpret_cast<uintptr_t>(quant) |
                        reinterpret_cast<uintptr_t>(plane_y) |
                        reinterpret_cast<uintptr_t>(plane_cb) |
                        reinterpret_cast<uintptr_t>(plane_cr);
  if (vec % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const Plane py = {coef_y, plane_y, ybh, ybw, 0,
                    static_cast<long long>(N) * ybh * ybw};
  const Plane pcb = {coef_cb, plane_cb, cbh, cbw, 1,
                     static_cast<long long>(N) * cbh * cbw};
  Plane pcr = pcb;
  pcr.coef = coef_cr;
  pcr.out = plane_cr;
  pcr.comp = 2;
  const long long groups_y = (py.blocks + kBlocksPerCta - 1) / kBlocksPerCta;
  const long long groups_c = (pcb.blocks + kBlocksPerCta - 1) / kBlocksPerCta;
  const long long idct_grid = groups_y + 2 * groups_c;
  const long long pixels = static_cast<long long>(N) * S * S;
  const long long pixel_grid = (pixels + kPixelThreads - 1) / kPixelThreads;
  if (idct_grid > 0x7fffffffLL || pixel_grid > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  jpeg_idct_kernel<<<static_cast<unsigned>(idct_grid), kIdctThreads, 0,
                     stream>>>(py, pcb, pcr, quant, basis, groups_y,
                               groups_c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  jpeg_color_resize_kernel<<<static_cast<unsigned>(pixel_grid),
                             kPixelThreads, 0, stream>>>(
      plane_y, plane_cb, plane_cr, geom, N, ybh, ybw, cbh, cbw, S, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ldt_jpeg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
