// K1: image normalisation and per-image horizontal flip, one fused pass.
//
// Replaces the JAX package's `ops/image.py` `normalize_images` (:24) and
// `random_flip` (:37), which XLA fuses into the train step on the TPU. Here
// one kernel reads the uint8 NHWC batch once and writes the bf16 NHWC batch
// once; the caller views the output as a channels_last NCHW tensor, so no
// layout pass follows.
//
//   out[b, h, w, c] = f_c(in[b, h, flip[b] ? W - 1 - w : w, c])
//   f_c(x) = bf16(bf16(bf16(x / 255) - mean_c) / std_c)
//
// with `mean_c` and `std_c` the bf16-rounded ImageNet constants. Each step
// rounds to bf16, as each bf16 operation of the JAX function does; the
// divisions are IEEE divisions (`__fdiv_rn`), so the result does not depend
// on fast-math flags. Over all 256 input values of each channel this equals
// the JAX function on the CPU bit for bit.
//
// Bound: bytes. 1 byte read and 2 bytes written per element, a handful of
// flops each, far below the card's 295 flops a byte. Design: one thread per
// group of 16 pixels of one row (48 input bytes, 96 output bytes). When W is
// a multiple of 16 and both buffers are 16-byte aligned, the group's source
// span starts on a 16-byte boundary in both the plain and the mirrored case,
// so a thread loads three 16-byte vectors and stores six; otherwise it falls
// back to byte loads and 2-byte stores. No shared memory, no atomics.
//
// C interface (bound with ctypes by ops/image.py):
//   int ldt_image_normalize(const uint8_t* in, const uint8_t* flip_or_null,
//                           uint16_t* out, int B, int H, int W,
//                           float m0, float m1, float m2,
//                           float s0, float s1, float s2, cudaStream_t);
// returns the cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 16;    // pixels per thread
constexpr int kThreads = 256;

struct Consts {
  float mean[3];
  float stdv[3];
};

__device__ __forceinline__ __nv_bfloat16 normalize(uint32_t x, int c,
                                                   const Consts& k) {
  const float t1 = __bfloat162float(
      __float2bfloat16_rn(__fdiv_rn(static_cast<float>(x), 255.0f)));
  const float t2 =
      __bfloat162float(__float2bfloat16_rn(__fsub_rn(t1, k.mean[c])));
  return __float2bfloat16_rn(__fdiv_rn(t2, k.stdv[c]));
}

__device__ __forceinline__ uint32_t byte_at(const uint32_t (&w)[12], int j) {
  return (w[j >> 2] >> ((j & 3) * 8)) & 0xffu;
}

// Source byte of output element j (pixel j / 3, channel j % 3) of a group.
template <bool kMirror>
__device__ __forceinline__ int src_index(int j) {
  return (kMirror ? kGroup - 1 - j / 3 : j / 3) * 3 + j % 3;
}

// One whole group through registers: three 16-byte loads, six 16-byte
// stores. Every index is a compile-time constant after unrolling.
template <bool kMirror>
__device__ __forceinline__ void group_vec(const uint4* __restrict__ src,
                                          uint4* __restrict__ dst,
                                          const Consts& k) {
  uint32_t w[12];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint4 v = __ldg(src + i);
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
  uint32_t o[24];
#pragma unroll
  for (int j = 0; j < 3 * kGroup; j += 2) {
    const uint32_t lo = __bfloat16_as_ushort(
        normalize(byte_at(w, src_index<kMirror>(j)), j % 3, k));
    const uint32_t hi = __bfloat16_as_ushort(
        normalize(byte_at(w, src_index<kMirror>(j + 1)), (j + 1) % 3, k));
    o[j / 2] = lo | (hi << 16);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
    dst[i] = make_uint4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
}

__global__ void __launch_bounds__(kThreads)
    image_normalize_kernel(const uint8_t* __restrict__ in,
                           const uint8_t* __restrict__ flip,
                           __nv_bfloat16* __restrict__ out, int B, int H,
                           int W, int vec, Consts k) {
  const int groups = (W + kGroup - 1) / kGroup;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long total = static_cast<long long>(B) * H * groups;
  if (t >= total) return;
  const int g = static_cast<int>(t % groups);
  const long long row = t / groups;  // b * H + h
  const int b = static_cast<int>(row / H);
  const bool mirrored = flip != nullptr && flip[b] != 0;
  const long long row_px = row * W;
  const int w0 = g * kGroup;

  if (vec) {
    // W % 16 == 0: the group is whole, and its source span of 16 pixels
    // starts at a multiple of 16 pixels (48 bytes) in either direction.
    const int src0 = mirrored ? W - w0 - kGroup : w0;
    const uint4* src =
        reinterpret_cast<const uint4*>(in + (row_px + src0) * 3);
    uint4* dst = reinterpret_cast<uint4*>(out + (row_px + w0) * 3);
    if (mirrored) {
      group_vec<true>(src, dst, k);
    } else {
      group_vec<false>(src, dst, k);
    }
    return;
  }
  const int n = min(kGroup, W - w0);
  for (int p = 0; p < n; ++p) {
    const int w = w0 + p;
    const int sw = mirrored ? W - 1 - w : w;
    const uint8_t* s = in + (row_px + sw) * 3;
    __nv_bfloat16* d = out + (row_px + w) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) d[c] = normalize(s[c], c, k);
  }
}

}  // namespace

extern "C" int ldt_image_normalize(const uint8_t* in, const uint8_t* flip,
                                   uint16_t* out, int B, int H, int W,
                                   float m0, float m1, float m2, float s0,
                                   float s1, float s2, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const Consts k = {{m0, m1, m2}, {s0, s1, s2}};
  const int vec = (W % kGroup == 0) &&
                  (reinterpret_cast<uintptr_t>(in) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long total =
      static_cast<long long>(B) * H * ((W + kGroup - 1) / kGroup);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  image_normalize_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(
      in, flip, reinterpret_cast<__nv_bfloat16*>(out), B, H, W, vec, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ldt_image_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
