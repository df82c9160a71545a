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
// f_c of a uint8 has 256 inputs in each of 3 channels, so each CTA first
// builds the 3 x 256 bf16 table in shared memory with that arithmetic
// (`normalize` below, three entries a thread) and every element is then one
// table load: the same bits as computing it, without two IEEE divisions an
// element (about ten instructions each).
//
// Bound: bytes. 1 byte read and 2 bytes written per element. Two routes:
//
// * Rows (W % 16 == 0 and both buffers 16-byte aligned, the path's case):
//   a row is 3W bytes in and 6W out, both multiples of 16. Persistent CTAs,
//   `kCtasPerSm` an SM, each walk chunks of `kRows` whole rows (any image;
//   the flip is looked up per row). A chunk's input is one flat byte range:
//   one thread brings it into a ring of `kStages` shared-memory stages with
//   a 1-D TMA bulk copy (`cp.async.bulk`, completion on an mbarrier), so
//   the copies of the next stages are in flight while the CTA maps this
//   one. A thread maps one 16-byte output unit (8 elements) at a time:
//   its 8 source bytes (one 8-byte shared load, or 8 byte loads from the
//   mirrored columns), 8 table loads, one 16-byte store into a shared
//   output tile (neighbouring threads, neighbouring units); the chunk's
//   tile leaves by one `cp.async.bulk` from shared to global memory while
//   the CTA fills the other of two tiles. On the H100 at the path's shape
//   this runs at 1.05-1.09x a device-to-device copy of the same bytes;
//   16-byte stores from registers instead measured 3-5% slower, and one
//   table entry a 32-bit word no faster than two entries packed in one.
// * Groups (every other shape or alignment): one thread a group of 16
//   pixels of one row, through the same table. Where W % 16 == 0 and both
//   buffers are 16-byte aligned but a row is too wide for the rows route's
//   chunk, a group is three 16-byte loads (issued before the CTA builds
//   the table) and six 16-byte stores; else byte loads and 2-byte stores.
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

// The rows route's shape.
struct K1Cfg {
  static constexpr int kThreads = 256;
  static constexpr int kRows = 8;
  static constexpr int kStages = 4;
  static constexpr int kCtasPerSm = 2;
};

constexpr int kGroup = 16;         // pixels a thread on the groups route
constexpr int kGroupThreads = 256;
constexpr int kEntries = 3 * 256;  // table entries: channel * 256 + value
constexpr int kSmemBudget = 96 * 1024;  // per CTA on the rows route

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

// Entry e = c * 256 + x of the table, two entries a 32-bit word. Ends
// with a barrier.
__device__ __forceinline__ void build_table(uint16_t* table,
                                            const Consts& k) {
  for (int e = threadIdx.x; e < kEntries; e += blockDim.x)
    table[e] = __bfloat16_as_ushort(normalize(e & 255, e >> 8, k));
  __syncthreads();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One flat byte range into shared memory, completing `bar`'s transaction
// count. `bytes`, both addresses: multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(dst)),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// The shared-memory layout of the rows route: the table, the stages'
// mbarriers, the input stages and two output tiles.
struct RowsLayout {
  int bars, stages, out, total;
  __host__ __device__ RowsLayout(int rows, int W) {
    const int in_bytes = rows * 3 * W;
    bars = (kEntries * 2 + 15) / 16 * 16;
    stages = bars + 16 * ((K1Cfg::kStages * 8 + 15) / 16);
    out = stages + K1Cfg::kStages * in_bytes;
    total = out + 2 * 2 * in_bytes;
  }
};

__global__ void __launch_bounds__(K1Cfg::kThreads)
    image_normalize_rows_kernel(const uint8_t* __restrict__ in,
                                const uint8_t* __restrict__ flip,
                                uint4* __restrict__ out, int H, int W,
                                int total_rows, int rows, Consts k) {
  constexpr int S = K1Cfg::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsLayout lay(rows, W);
  uint16_t* table = reinterpret_cast<uint16_t*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  unsigned char* stage0 = smem + lay.stages;
  uint4* out_tile = reinterpret_cast<uint4*>(smem + lay.out);

  const int row_bytes = 3 * W;
  const int upr = row_bytes / 8;  // 16-byte output units (8 elements) a row
  const int stage_bytes = rows * row_bytes;
  const int chunks = (total_rows + rows - 1) / rows;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < S; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(&bars[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < S; ++s) {
      const int c = blockIdx.x + s * gridDim.x;
      if (c >= chunks) break;
      const int n = min(rows, total_rows - c * rows);
      bulk_load(stage0 + s * stage_bytes,
                in + static_cast<size_t>(c) * stage_bytes, n * row_bytes,
                &bars[s]);
    }
  }
  build_table(table, k);  // its barrier also publishes the inits

  // This thread's units are tid, tid + kThreads, ...: as (row, unit in the
  // row), stepped without a division.
  const int rl0 = tid / upr, uu0 = tid % upr;
  const int d_rows = K1Cfg::kThreads / upr, d_units = K1Cfg::kThreads % upr;

  int it = 0;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x, ++it) {
    const int s = it % S;
    mbar_wait(&bars[s], (it / S) & 1);
    const unsigned char* src = stage0 + s * stage_bytes;
    const int row0 = c * rows;
    const int n = min(rows, total_rows - row0);
    uint4* dst = out_tile + (it & 1) * rows * upr;
    int rl = rl0, uu = uu0;
    int b = (row0 + rl) / H, h = (row0 + rl) - b * H;
    while (rl < n) {
      const bool mirrored = flip != nullptr && flip[b] != 0;
      const unsigned char* srow = src + rl * row_bytes;
      // Element k of this unit is element 8 * uu + k of the row: channel
      // (c0 + k) % 3, where c0 = (8 * uu) % 3.
      const int m = uu % 3;
      const int c0 = m == 0 ? 0 : 3 - m;
      const int ch[3] = {c0, c0 == 2 ? 0 : c0 + 1, c0 == 0 ? 2 : c0 - 1};
      uint32_t x[8];
      if (!mirrored) {
        const uint2 v = *reinterpret_cast<const uint2*>(srow + 8 * uu);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[j] = (v.x >> (8 * j)) & 0xffu;
          x[4 + j] = (v.y >> (8 * j)) & 0xffu;
        }
      } else {
        // Element e = 3p + c of the row reads pixel W - 1 - p, channel c:
        // byte 3W - 3 - e + 2c.
        const int last = row_bytes - 3 - 8 * uu;
#pragma unroll
        for (int j = 0; j < 8; ++j) x[j] = srow[last - j + 2 * ch[j % 3]];
      }
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo = table[ch[(2 * j) % 3] * 256 + x[2 * j]];
        const uint32_t hi = table[ch[(2 * j + 1) % 3] * 256 + x[2 * j + 1]];
        o[j] = lo | (hi << 16);
      }
      dst[rl * upr + uu] = make_uint4(o[0], o[1], o[2], o[3]);
      uu += d_units;
      rl += d_rows;
      int dh = d_rows;
      if (uu >= upr) {
        uu -= upr;
        ++rl;
        ++dh;
      }
      for (h += dh; h >= H; h -= H) ++b;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // every thread is done with stage s and the tile
    if (tid == 0) {
      bulk_store(out + static_cast<size_t>(row0) * upr, dst,
                 n * row_bytes * 2);
      // The other tile's store (the previous chunk's) has been read out.
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      const int next = c + S * gridDim.x;
      if (next < chunks) {
        const int nn = min(rows, total_rows - next * rows);
        bulk_load(stage0 + s * stage_bytes,
                  in + static_cast<size_t>(next) * stage_bytes,
                  nn * row_bytes, &bars[s]);
      }
    }
    __syncthreads();
  }
  if (tid == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t byte_at(const uint32_t (&w)[12], int j) {
  return (w[j >> 2] >> ((j & 3) * 8)) & 0xffu;
}

// Source byte of output element j (pixel j / 3, channel j % 3) of a group.
template <bool kMirror>
__device__ __forceinline__ int src_index(int j) {
  return (kMirror ? kGroup - 1 - j / 3 : j / 3) * 3 + j % 3;
}

// One whole group through registers: its 48 source bytes `w` (three
// 16-byte loads) out as six 16-byte stores. Every index is a compile-time
// constant after unrolling.
template <bool kMirror>
__device__ __forceinline__ void group_vec(const uint32_t (&w)[12],
                                          uint4* __restrict__ dst,
                                          const uint16_t* table) {
  uint32_t o[24];
#pragma unroll
  for (int j = 0; j < 3 * kGroup; j += 2) {
    const uint32_t lo = table[(j % 3) * 256 + byte_at(w, src_index<kMirror>(j))];
    const uint32_t hi =
        table[((j + 1) % 3) * 256 + byte_at(w, src_index<kMirror>(j + 1))];
    o[j / 2] = lo | (hi << 16);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
    dst[i] = make_uint4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
}

__global__ void __launch_bounds__(kGroupThreads)
    image_normalize_groups_kernel(const uint8_t* __restrict__ in,
                                  const uint8_t* __restrict__ flip,
                                  __nv_bfloat16* __restrict__ out, int B,
                                  int H, int W, int vec, Consts k) {
  __shared__ uint16_t table[kEntries];
  const int groups = (W + kGroup - 1) / kGroup;
  const long long t = static_cast<long long>(blockIdx.x) * kGroupThreads +
                      threadIdx.x;
  const long long total = static_cast<long long>(B) * H * groups;
  const bool live = t < total;
  const int g = static_cast<int>(t % groups);
  const long long row = t / groups;  // b * H + h
  const bool mirrored =
      live && flip != nullptr && flip[static_cast<int>(row / H)] != 0;
  const long long row_px = row * W;
  const int w0 = g * kGroup;
  // W % 16 == 0 (vec): the group is whole, and its source span of 16
  // pixels starts at a multiple of 16 pixels (48 bytes) in either
  // direction. Its loads are in flight while the CTA builds the table.
  uint32_t w[12];
  if (vec && live) {
    const uint4* src = reinterpret_cast<const uint4*>(
        in + (row_px + (mirrored ? W - w0 - kGroup : w0)) * 3);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const uint4 v = __ldg(src + i);
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  }
  build_table(table, k);
  if (!live) return;
  if (vec) {
    uint4* dst = reinterpret_cast<uint4*>(out + (row_px + w0) * 3);
    if (mirrored) {
      group_vec<true>(w, dst, table);
    } else {
      group_vec<false>(w, dst, table);
    }
    return;
  }
  const int n = min(kGroup, W - w0);
  for (int p = 0; p < n; ++p) {
    const int px = w0 + p;
    const int sw = mirrored ? W - 1 - px : px;
    const uint8_t* s = in + (row_px + sw) * 3;
    uint16_t* d = reinterpret_cast<uint16_t*>(out + (row_px + px) * 3);
#pragma unroll
    for (int c = 0; c < 3; ++c) d[c] = table[c * 256 + s[c]];
  }
}

// Rows a chunk on the rows route for rows of W pixels: the most, up to
// kRows, whose layout fits kSmemBudget; 0 where one row does not.
int chunk_rows(int W) {
  for (int rows = K1Cfg::kRows; rows > 0; --rows)
    if (RowsLayout(rows, W).total <= kSmemBudget) return rows;
  return 0;
}

}  // namespace

extern "C" int ldt_image_normalize(const uint8_t* in, const uint8_t* flip,
                                   uint16_t* out, int B, int H, int W,
                                   float m0, float m1, float m2, float s0,
                                   float s1, float s2, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const Consts k = {{m0, m1, m2}, {s0, s1, s2}};
  const long long total_rows = static_cast<long long>(B) * H;
  const int vec = W % 16 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int rows = vec ? chunk_rows(W) : 0;
  if (rows > 0 && total_rows < (1 << 30) &&
      static_cast<long long>(rows) * 3 * W * K1Cfg::kStages < (1 << 30)) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int smem = RowsLayout(rows, W).total;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(image_normalize_rows_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const long long chunks = (total_rows + rows - 1) / rows;
    const int grid = static_cast<int>(
        chunks < static_cast<long long>(sms) * K1Cfg::kCtasPerSm
            ? chunks
            : static_cast<long long>(sms) * K1Cfg::kCtasPerSm);
    image_normalize_rows_kernel<<<grid, K1Cfg::kThreads, smem, stream>>>(
        in, flip, reinterpret_cast<uint4*>(out), H, W,
        static_cast<int>(total_rows), rows, k);
    return static_cast<int>(cudaGetLastError());
  }
  const long long total = total_rows * ((W + kGroup - 1) / kGroup);
  const long long blocks = (total + kGroupThreads - 1) / kGroupThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  image_normalize_groups_kernel<<<static_cast<unsigned>(blocks),
                                  kGroupThreads, 0, stream>>>(
      in, flip, reinterpret_cast<__nv_bfloat16*>(out), B, H, W, vec, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ldt_image_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
