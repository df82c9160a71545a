// K5: ring attention's block fold, forward and backward, for sm_90a.
//
// Replaces the JAX package's `parallel/ring_attention.py` `_block_attn`
// (:37), the body of `ring_attention`'s loop (:62), and the backward that
// JAX takes through that loop by autodiff. Queries stay resident; at ring
// step t, query block i folds key/value block (i - t) mod P into its f32
// running statistics (max m, sum l, accumulator acc). One launch covers
// every position the process holds: P positions of one in-process ring (the
// "rotation" is this index shift), or P = 1 for a process ring whose
// current block arrived over the network.
//
// The fold keeps the JAX function's rounding points:
//   s   = bf16(q . k) as f32, / sqrt(D)            (einsum of bf16 -> bf16)
//   s   = finfo(f32).min where the key is masked
//   m'  = max(m, max over the WHOLE block of s)    (pass 1 over the tiles)
//   p   = exp(s - m') * mask                       (pass 2)
//   l'  = l * exp(m - m') + sum(p)
//   acc'= acc * exp(m - m') + f32(bf16(bf16(p) . v summed over the block))
// and, on the last step, out = bf16(acc' / max(l', 1e-30)). A fully masked
// block adds nothing (p is multiplied by the mask), and m = -inf on the
// first fold gives exp(-inf) = 0, not NaN.
//
// The backward uses lse = m + log(l) (0 where l = 0) and
// delta = rowsum(dO * O), as flash attention does: P = exp(s - lse) where
// the key is valid (0 elsewhere), dS = P (dP - delta), dP = dO . v^T, and
//   dQ += bf16(dS / sqrt(D)) . K            (resident queries, f32)
//   dK += bf16(dS / sqrt(D))^T . Q          (the travelling block, f32)
//   dV += bf16(P)^T . dO
// The casts pass the gradient through, as autodiff does through
// `.astype`. Rows with l = 0 (no valid key anywhere) get zero gradients.
//
// Design: mma.sync m16n8k16 bf16 -> f32. A CTA of four warps owns 64 rows
// (queries for the forward and dQ, keys for dK/dV) of one (b, h, position)
// and loops over the other side's 64-row tiles in shared memory. Each
// output element is owned by one CTA and summed in a fixed order: no
// atomics, and the result does not depend on the order of the blocks. The
// in-process ring uses each key block for exactly one query position per
// step, so dK/dV accumulate in ring-step order, as the process ring's
// travelling partials do.
//
// Bound: bytes. At BERT-base, sequence 512, batch 32 in four blocks of 128,
// a forward step reads q, k, v (75.5 MB) and reads and writes the f32
// carries (103.8 MB) against 6.4 GFLOP of products; the f32 carry between
// ring steps is what the JAX semantics costs.
//
// C interface (bound with ctypes by ops/ring_attention.py); q, k, v and dout
// are bf16 [B, H, P*Sb, 64], mask uint8 [B, P*Sb] (key validity), the
// carries and gradients f32:
//   int ldt_ring_fold_fwd(q, k, v, mask, float* m, float* l, float* acc,
//                         bf16* out_or_null, int B, int H, int P, int Sb,
//                         int D, int shift, cudaStream_t);
//   int ldt_ring_fold_bwd_dq(q, k, v, mask, const float* lse,
//                            const float* delta, dout, float* dq, ...);
//   int ldt_ring_fold_bwd_dkv(q, k, v, mask, lse, delta, dout, float* dk,
//                             float* dv, ...);
// each returns 0, -1 for a head dim other than 64, or the cudaError_t of the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kD = 64;            // head dim
constexpr int kRows = 64;         // rows a CTA owns (4 warps x 16)
constexpr int kTile = 64;         // rows of the other side per smem tile
constexpr int kLd = kD + 8;       // smem row stride of a row-major tile
constexpr int kLdT = kTile + 8;   // smem row stride of a transposed tile
constexpr int kThreads = 128;
constexpr int kErrHeadDim = -1;

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t lds32(const bf16* base, int offset) {
  return *reinterpret_cast<const uint32_t*>(base + offset);
}

// Two bf16 of row r, columns c and c+1, of a row-major [rows, kD] block;
// zero for a row past the block.
__device__ __forceinline__ uint32_t ldg32(const bf16* block, int r, int c,
                                          int rows) {
  if (r >= rows) return 0u;
  return *reinterpret_cast<const uint32_t*>(block +
                                            static_cast<size_t>(r) * kD + c);
}

// A fragments (16 rows x 64 columns, four k-steps) of rows r0 and r0 + 8.
__device__ __forceinline__ void load_a_frags(uint32_t a[4][4],
                                             const bf16* block, int r0,
                                             int tig, int rows) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + tig * 2;
    a[kk][0] = ldg32(block, r0, c, rows);
    a[kk][1] = ldg32(block, r0 + 8, c, rows);
    a[kk][2] = ldg32(block, r0, c + 8, rows);
    a[kk][3] = ldg32(block, r0 + 8, c + 8, rows);
  }
}

// Rows [first, first + kTile) of a row-major [rows, kD] block into smem,
// row-major (stride kLd) and/or transposed (stride kLdT); rows past the
// block are zero.
__device__ __forceinline__ void load_tile(bf16* dst, bf16* dst_t,
                                          const bf16* block, int first,
                                          int rows) {
  for (int idx = threadIdx.x; idx < kTile * (kD / 8); idx += kThreads) {
    const int r = idx / (kD / 8);
    const int c = (idx % (kD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (first + r < rows)
      val = *reinterpret_cast<const uint4*>(
          block + static_cast<size_t>(first + r) * kD + c);
    if (dst != nullptr)
      *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
    if (dst_t != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int u = 0; u < 8; ++u) dst_t[(c + u) * kLdT + r] = e[u];
    }
  }
}

// S-tile (16 rows x 8 columns) = A (four k-steps) . B, B's column n being
// row n of a row-major smem tile.
__device__ __forceinline__ void product_nt(float c[4], const uint32_t a[4][4],
                                           const bf16* tile, int nt, int g,
                                           int tig) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int off = (nt * 8 + g) * kLd + kk * 16 + tig * 2;
    mma16816(c, a[kk], lds32(tile, off), lds32(tile, off + 8));
  }
}

// acc[dn] += A (16 rows x 16 of the tile's rows, k-step kp) . tile rows,
// the tile given transposed ([kD][kLdT]).
__device__ __forceinline__ void accumulate_pv(float acc[8][4],
                                              const uint32_t a[4],
                                              const bf16* tile_t, int kp,
                                              int g, int tig) {
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) {
    const int off = (dn * 8 + g) * kLdT + kp * 16 + tig * 2;
    mma16816(acc[dn], a, lds32(tile_t, off), lds32(tile_t, off + 8));
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

struct Geometry {
  int b, bh, i, j, first;  // batch, batch*H + head, query pos, key pos, row
  size_t q_row, k_row;     // row index of block i / block j's first row
};

// Forward and dQ: the CTA owns query rows of position blockIdx.y, which
// folds key block (i - shift) mod P. dK/dV: it owns key rows of position
// blockIdx.y, folded by query position (j + shift) mod P.
__device__ __forceinline__ Geometry geometry(int H, int P, int Sb, int shift,
                                             bool owns_keys) {
  Geometry geo;
  geo.bh = blockIdx.x;
  geo.b = geo.bh / H;
  const int own = blockIdx.y;
  const int other = owns_keys ? (own + shift) % P : ((own - shift) % P + P) % P;
  geo.i = owns_keys ? other : own;
  geo.j = owns_keys ? own : other;
  geo.first = blockIdx.z * kRows;
  const size_t base = static_cast<size_t>(geo.bh) * P * Sb;
  geo.q_row = base + static_cast<size_t>(geo.i) * Sb;
  geo.k_row = base + static_cast<size_t>(geo.j) * Sb;
  return geo;
}

__global__ void __launch_bounds__(kThreads)
    ring_fold_fwd_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const uint8_t* __restrict__ mask,
                         float* __restrict__ m, float* __restrict__ l,
                         float* __restrict__ acc, bf16* __restrict__ out,
                         int H, int P, int Sb, int shift) {
  __shared__ __align__(16) bf16 ks[kTile * kLd];
  __shared__ __align__(16) bf16 vt[kD * kLdT];
  __shared__ uint8_t ms[kTile];

  const Geometry geo = geometry(H, P, Sb, shift, false);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const bf16* qb = q + geo.q_row * kD;
  const bf16* kb = k + geo.k_row * kD;
  const bf16* vb = v + geo.k_row * kD;
  const uint8_t* mb = mask + static_cast<size_t>(geo.b) * P * Sb +
                      static_cast<size_t>(geo.j) * Sb;
  const int r0 = geo.first + warp * 16 + g;  // this thread's rows r0, r0 + 8
  const float root_d = sqrtf(static_cast<float>(kD));

  uint32_t qa[4][4];
  load_a_frags(qa, qb, r0, tig, Sb);

  // Pass 1: the row max over the whole block.
  float mx[2] = {-INFINITY, -INFINITY};
  for (int kt = 0; kt < Sb; kt += kTile) {
    __syncthreads();
    load_tile(ks, nullptr, kb, kt, Sb);
    if (threadIdx.x < kTile)
      ms[threadIdx.x] = kt + threadIdx.x < Sb ? mb[kt + threadIdx.x] : 0;
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float c[4];
      product_nt(c, qa, ks, nt, g, tig);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = nt * 8 + tig * 2 + (e & 1);
        if (kt + key >= Sb) continue;
        const float s = ms[key] ? round_bf16(c[e]) / root_d : -FLT_MAX;
        mx[e / 2] = fmaxf(mx[e / 2], s);
      }
    }
  }
  float m_prev[2], l_prev[2], m_new[2];
  const size_t stat = geo.q_row;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    m_prev[h] = r < Sb ? m[stat + r] : 0.f;
    l_prev[h] = r < Sb ? l[stat + r] : 0.f;
    m_new[h] = fmaxf(m_prev[h], quad_max(mx[h]));
  }

  // Pass 2: p, its row sums and the block's PV in f32.
  float ls[2] = {0.f, 0.f};
  float o[8][4];
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  for (int kt = 0; kt < Sb; kt += kTile) {
    __syncthreads();
    load_tile(ks, nullptr, kb, kt, Sb);
    load_tile(nullptr, vt, vb, kt, Sb);
    if (threadIdx.x < kTile)
      ms[threadIdx.x] = kt + threadIdx.x < Sb ? mb[kt + threadIdx.x] : 0;
    __syncthreads();
#pragma unroll
    for (int kp = 0; kp < kTile / 16; ++kp) {
      float p[2][4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float c[4];
        product_nt(c, qa, ks, 2 * kp + h2, g, tig);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = (2 * kp + h2) * 8 + tig * 2 + (e & 1);
          const bool valid = kt + key < Sb && ms[key];
          p[h2][e] = valid ? expf(round_bf16(c[e]) / root_d - m_new[e / 2])
                           : 0.f;
          ls[e / 2] += p[h2][e];
        }
      }
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]),
                              pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]),
                              pack_bf16(p[1][2], p[1][3])};
      accumulate_pv(o, pa, vt, kp, g, tig);
    }
  }

  // Rescale the carries to the new max and add the block's rounded PV.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const float block_sum = quad_sum(ls[h]);
    if (r >= Sb) continue;
    const float scale = expf(m_prev[h] - m_new[h]);
    const float l_new = __fadd_rn(__fmul_rn(l_prev[h], scale), block_sum);
    if (tig == 0) {
      m[stat + r] = m_new[h];
      l[stat + r] = l_new;
    }
    float* acc_row = acc + (stat + r) * kD;
    bf16* out_row = out != nullptr ? out + (stat + r) * kD : nullptr;
    const float denom = fmaxf(l_new, 1e-30f);
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      const int col = dn * 8 + tig * 2;
      float2 a = *reinterpret_cast<float2*>(acc_row + col);
      a.x = __fadd_rn(__fmul_rn(a.x, scale), round_bf16(o[dn][2 * h]));
      a.y = __fadd_rn(__fmul_rn(a.y, scale), round_bf16(o[dn][2 * h + 1]));
      *reinterpret_cast<float2*>(acc_row + col) = a;
      if (out_row != nullptr)
        *reinterpret_cast<__nv_bfloat162*>(out_row + col) =
            __floats2bfloat162_rn(a.x / denom, a.y / denom);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    ring_fold_bwd_dq_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const uint8_t* __restrict__ mask,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const bf16* __restrict__ dout,
                            float* __restrict__ dq, int H, int P, int Sb,
                            int shift) {
  __shared__ __align__(16) bf16 ks[kTile * kLd];
  __shared__ __align__(16) bf16 kt_s[kD * kLdT];
  __shared__ __align__(16) bf16 vs[kTile * kLd];
  __shared__ uint8_t ms[kTile];

  const Geometry geo = geometry(H, P, Sb, shift, false);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const bf16* kb = k + geo.k_row * kD;
  const bf16* vb = v + geo.k_row * kD;
  const uint8_t* mb = mask + static_cast<size_t>(geo.b) * P * Sb +
                      static_cast<size_t>(geo.j) * Sb;
  const int r0 = geo.first + warp * 16 + g;
  const float root_d = sqrtf(static_cast<float>(kD));

  uint32_t qa[4][4], da[4][4];
  load_a_frags(qa, q + geo.q_row * kD, r0, tig, Sb);
  load_a_frags(da, dout + geo.q_row * kD, r0, tig, Sb);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    row_lse[h] = r < Sb ? lse[geo.q_row + r] : 0.f;
    row_delta[h] = r < Sb ? delta[geo.q_row + r] : 0.f;
  }
  float dqa[8][4];
#pragma unroll
  for (int dn = 0; dn < 8; ++dn)
    dqa[dn][0] = dqa[dn][1] = dqa[dn][2] = dqa[dn][3] = 0.f;

  for (int kt = 0; kt < Sb; kt += kTile) {
    __syncthreads();
    load_tile(ks, kt_s, kb, kt, Sb);
    load_tile(vs, nullptr, vb, kt, Sb);
    if (threadIdx.x < kTile)
      ms[threadIdx.x] = kt + threadIdx.x < Sb ? mb[kt + threadIdx.x] : 0;
    __syncthreads();
#pragma unroll
    for (int kp = 0; kp < kTile / 16; ++kp) {
      float ds[2][4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float s[4], dp[4];
        product_nt(s, qa, ks, 2 * kp + h2, g, tig);
        product_nt(dp, da, vs, 2 * kp + h2, g, tig);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = (2 * kp + h2) * 8 + tig * 2 + (e & 1);
          const bool valid = kt + key < Sb && ms[key];
          const float pr =
              valid ? expf(round_bf16(s[e]) / root_d - row_lse[e / 2]) : 0.f;
          ds[h2][e] = pr * (dp[e] - row_delta[e / 2]) / root_d;
        }
      }
      const uint32_t dsa[4] = {pack_bf16(ds[0][0], ds[0][1]),
                               pack_bf16(ds[0][2], ds[0][3]),
                               pack_bf16(ds[1][0], ds[1][1]),
                               pack_bf16(ds[1][2], ds[1][3])};
      accumulate_pv(dqa, dsa, kt_s, kp, g, tig);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= Sb) continue;
    float* row = dq + (geo.q_row + r) * kD;
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      const int col = dn * 8 + tig * 2;
      float2 a = *reinterpret_cast<float2*>(row + col);
      a.x += dqa[dn][2 * h];
      a.y += dqa[dn][2 * h + 1];
      *reinterpret_cast<float2*>(row + col) = a;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    ring_fold_bwd_dkv_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const uint8_t* __restrict__ mask,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const bf16* __restrict__ dout,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int H, int P, int Sb, int shift) {
  __shared__ __align__(16) bf16 qs[kTile * kLd];
  __shared__ __align__(16) bf16 qt[kD * kLdT];
  __shared__ __align__(16) bf16 dos[kTile * kLd];
  __shared__ __align__(16) bf16 dot[kD * kLdT];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const Geometry geo = geometry(H, P, Sb, shift, true);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const bf16* qb = q + geo.q_row * kD;
  const bf16* db = dout + geo.q_row * kD;
  const uint8_t* mb = mask + static_cast<size_t>(geo.b) * P * Sb +
                      static_cast<size_t>(geo.j) * Sb;
  const int r0 = geo.first + warp * 16 + g;  // this thread's keys r0, r0 + 8
  const float root_d = sqrtf(static_cast<float>(kD));

  uint32_t ka[4][4], va[4][4];
  load_a_frags(ka, k + geo.k_row * kD, r0, tig, Sb);
  load_a_frags(va, v + geo.k_row * kD, r0, tig, Sb);
  const bool key_ok[2] = {r0 < Sb && mb[r0] != 0,
                          r0 + 8 < Sb && mb[r0 + 8] != 0};
  float dka[8][4], dva[8][4];
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) {
    dka[dn][0] = dka[dn][1] = dka[dn][2] = dka[dn][3] = 0.f;
    dva[dn][0] = dva[dn][1] = dva[dn][2] = dva[dn][3] = 0.f;
  }

  for (int t0 = 0; t0 < Sb; t0 += kTile) {
    __syncthreads();
    load_tile(qs, qt, qb, t0, Sb);
    load_tile(dos, dot, db, t0, Sb);
    if (threadIdx.x < kTile) {
      const int r = t0 + threadIdx.x;
      lse_s[threadIdx.x] = r < Sb ? lse[geo.q_row + r] : 0.f;
      delta_s[threadIdx.x] = r < Sb ? delta[geo.q_row + r] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int qp = 0; qp < kTile / 16; ++qp) {
      float pr[2][4], ds[2][4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float s[4], dp[4];
        product_nt(s, ka, qs, 2 * qp + h2, g, tig);
        product_nt(dp, va, dos, 2 * qp + h2, g, tig);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = (2 * qp + h2) * 8 + tig * 2 + (e & 1);
          const bool valid = key_ok[e / 2] && t0 + col < Sb;
          pr[h2][e] =
              valid ? expf(round_bf16(s[e]) / root_d - lse_s[col]) : 0.f;
          ds[h2][e] = pr[h2][e] * (dp[e] - delta_s[col]) / root_d;
        }
      }
      const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]),
                              pack_bf16(pr[0][2], pr[0][3]),
                              pack_bf16(pr[1][0], pr[1][1]),
                              pack_bf16(pr[1][2], pr[1][3])};
      const uint32_t dsa[4] = {pack_bf16(ds[0][0], ds[0][1]),
                               pack_bf16(ds[0][2], ds[0][3]),
                               pack_bf16(ds[1][0], ds[1][1]),
                               pack_bf16(ds[1][2], ds[1][3])};
      accumulate_pv(dva, pa, dot, qp, g, tig);
      accumulate_pv(dka, dsa, qt, qp, g, tig);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= Sb) continue;
    float* k_row = dk + (geo.k_row + r) * kD;
    float* v_row = dv + (geo.k_row + r) * kD;
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      const int col = dn * 8 + tig * 2;
      float2 a = *reinterpret_cast<float2*>(k_row + col);
      a.x += dka[dn][2 * h];
      a.y += dka[dn][2 * h + 1];
      *reinterpret_cast<float2*>(k_row + col) = a;
      float2 b = *reinterpret_cast<float2*>(v_row + col);
      b.x += dva[dn][2 * h];
      b.y += dva[dn][2 * h + 1];
      *reinterpret_cast<float2*>(v_row + col) = b;
    }
  }
}

int check_launch(int B, int H, int P, int Sb, int D, int shift, dim3* grid) {
  if (D != kD) return kErrHeadDim;
  if (B <= 0 || H <= 0 || P <= 0 || Sb <= 0 || shift < 0 || shift >= P)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bh = static_cast<long long>(B) * H;
  const int tiles = (Sb + kRows - 1) / kRows;
  if (bh > 0x7fffffffLL || P > 65535 || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  *grid = dim3(static_cast<unsigned>(bh), P, tiles);
  return 0;
}

}  // namespace

extern "C" int ldt_ring_fold_fwd(const void* q, const void* k, const void* v,
                                 const uint8_t* mask, float* m, float* l,
                                 float* acc, void* out, int B, int H, int P,
                                 int Sb, int D, int shift,
                                 cudaStream_t stream) {
  dim3 grid;
  const int bad = check_launch(B, H, P, Sb, D, shift, &grid);
  if (bad != 0) return bad;
  ring_fold_fwd_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, m, l, acc, static_cast<bf16*>(out),
      H, P, Sb, shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ldt_ring_fold_bwd_dq(const void* q, const void* k,
                                    const void* v, const uint8_t* mask,
                                    const float* lse, const float* delta,
                                    const void* dout, float* dq, int B, int H,
                                    int P, int Sb, int D, int shift,
                                    cudaStream_t stream) {
  dim3 grid;
  const int bad = check_launch(B, H, P, Sb, D, shift, &grid);
  if (bad != 0) return bad;
  ring_fold_bwd_dq_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, lse, delta,
      static_cast<const bf16*>(dout), dq, H, P, Sb, shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ldt_ring_fold_bwd_dkv(const void* q, const void* k,
                                     const void* v, const uint8_t* mask,
                                     const float* lse, const float* delta,
                                     const void* dout, float* dk, float* dv,
                                     int B, int H, int P, int Sb, int D,
                                     int shift, cudaStream_t stream) {
  dim3 grid;
  const int bad = check_launch(B, H, P, Sb, D, shift, &grid);
  if (bad != 0) return bad;
  ring_fold_bwd_dkv_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, lse, delta,
      static_cast<const bf16*>(dout), dk, dv, H, P, Sb, shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ldt_ring_error_string(int code) {
  if (code == kErrHeadDim) return "head dim must be 64";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
