// K5: ring attention's block fold, forward and backward, for sm_90a.
//
// Replaces the JAX package's `parallel/ring_attention.py` `_block_attn`
// (:37), the body of `ring_attention`'s loop (:62), and the backward that
// JAX takes through that loop by autodiff. Queries stay resident; at ring
// step t, query block i folds key/value block (i - t) mod P into its f32
// running statistics (max m, sum l, accumulator acc). One launch covers
// every position the process holds: P positions of one in-process ring (the
// "rotation" is this index shift), or P = 1 for a process ring whose
// current block arrived over the network. Each kernel folds a run of
// `steps` ring steps, shift, shift + 1, ..., shift + steps - 1, in one
// launch, exactly as `steps` launches of one step each would: the
// in-process ring folds all P steps in one launch with its carries and
// gradient totals on chip, the process ring one step a launch with them in
// device memory.
//
// The fold keeps the JAX function's rounding points:
//   s   = bf16(q . k) as f32, / sqrt(D)            (einsum of bf16 -> bf16)
//   s   = finfo(f32).min where the key is masked
//   m'  = max(m, max over the WHOLE block of s)
//   p   = exp(s - m') * mask
//   l'  = l * exp(m - m') + sum(p)
//   acc'= acc * exp(m - m') + f32(bf16(bf16(p) . v summed over the block))
// and, after the last step, out = bf16(acc' / max(l', 1e-30)). A fully
// masked block adds nothing (p is multiplied by the mask), and m = -inf on
// the first fold gives exp(-inf) = 0, not NaN.
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
// Bound, at BERT-base, sequence 512, batch 32 in four blocks of 128, one
// launch over the whole in-process ring: the forward reads q, k, v and
// writes out, m and l (102.3 MB, 0.031 ms at 3.35 TB/s; its 25.8 GFLOP take
// 0.026 ms), so it is bound by bytes; dQ's 38.65 GFLOP take 0.039 ms at the
// bf16 peak against 127.4 MB (q, k, v, dO, mask, lse and delta in, a bf16
// dq out: 0.038 ms), and dK/dV's 51.5 GFLOP take 0.052 ms against 151 MB,
// so both are bound by operations. A one-step launch also reads and writes
// the f32 carries or gradient totals, which is what the process ring's
// hops cost.
//
// Design (Hopper, after ops/csrc/flash_attn.cu):
//  * A CTA has two consumer warpgroups and one producer warpgroup. It owns
//    128 rows of one (b, h, position): queries in the forward and dQ, keys
//    in dK/dV, 64 a consumer warpgroup. Every product is a warpgroup
//    product (wgmma, 64 rows) with f32 accumulators in registers; P and dS
//    go to the next product as register A operands, packed to bf16, and the
//    other side's tiles are B operands read from shared memory, V, K, dO
//    and Q MN-major through the transpose bit. No tile is copied
//    transposed.
//  * The owned tiles load once by TMA (Q; Q and dO; K and V). One producer
//    warp streams the other side through a ring of three shared-memory
//    stages with mbarriers: K and V tiles of 128 keys with their validity
//    bits (forward and dQ), or Q and dO tiles of 64 queries with their lse
//    and delta (dK/dV), for each ring step of the launch in order.
//  * The forward takes the block's max before any exponent. When a block
//    fits one tile (Sb <= 128, the path's 512 / 4) its 64 x 128 scores stay
//    in registers: max, p, then PV. A longer block streams its key tiles
//    twice: once for the max, once for p and PV. Each block's PV sums in
//    its own f32 registers from zero and is rounded to bf16 once; the
//    carries m, l and acc stay in registers across the launch's steps. A
//    tile whose keys are all valid skips the per-score mask, and every
//    exponent is one FMA and one ex2 in log2 units.
//  * dQ and dK/dV accumulate their products straight onto the f32 totals
//    in the wgmma accumulators, tile after tile in ring-step order: dQ over
//    the key tiles of blocks (i - t) mod P, dK/dV over the query tiles of
//    blocks (j + t) mod P. A one-step launch loads the totals it is given
//    (the process ring's dQ at home, or its travelling dK/dV partials) into
//    the accumulators and carries on, so a launch of `steps` steps gives
//    the bits of `steps` one-step launches and the process ring sums in the
//    in-process ring's order.
//  * The two consumer warpgroups take turns to issue their score products
//    (named barriers), so that one's softmax or dS runs while the
//    other's products do.
//  * Rows past a block are not zeros: in the in-process layout a tile that
//    starts near the end of block j reads the first rows of block j + 1.
//    Keys at or past Sb are invalid, queries at or past Sb get lse = +inf
//    (p = 0), and results are written for rows below Sb only, with plain
//    16-byte stores from a staging tile (a TMA store would spill into the
//    next block).
//  * Each output element is owned by one CTA and summed in a fixed order:
//    no atomics, a repeat launch gives the same bits, and a launch of
//    `steps` steps gives the bits of `steps` one-step launches.
//
// C interface (bound with ctypes by ops/ring_attention.py); q, k, v and dout
// are bf16 [B, H, P*Sb, 64], mask uint8 [B, P*Sb] (key validity), the
// carries and f32 gradients f32:
//   int ldt_ring_fold_fwd(q, k, v, mask, float* m, float* l,
//                         float* acc_or_null, bf16* out_or_null, int B,
//                         int H, int P, int Sb, int D, int shift, int steps,
//                         cudaStream_t);
//     acc given: m, l, acc are the carries, read and written; null: the
//     launch starts from fresh carries and writes m and l only.
//   int ldt_ring_fold_bwd_dq(q, k, v, mask, const float* lse,
//                            const float* delta, dout, float* dq_or_null,
//                            bf16* dq_out_or_null, int B, int H, int P,
//                            int Sb, int D, int shift, int steps,
//                            cudaStream_t);
//   int ldt_ring_fold_bwd_dkv(q, k, v, mask, lse, delta, dout,
//                             float* dk_or_null, float* dv_or_null,
//                             bf16* dk_out_or_null, bf16* dv_out_or_null,
//                             int B, int H, int P, int Sb, int D, int shift,
//                             int steps, cudaStream_t);
//     dq (dk/dv) given: f32 totals the launch adds to; null: the totals
//     start at zero. dq_out (dk_out/dv_out) given: the final totals in bf16.
// Each returns 0, -1 for a head dim other than 64, -2 when
// cuTensorMapEncodeTiled cannot be reached, -3 when it refuses a map, or
// the cudaError_t of the launch. The tensor maps are encoded on the host
// with cuTensorMapEncodeTiled found through the runtime, so the library
// needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kD = 64;            // head dim
constexpr int kErrHeadDim = -1;
constexpr int kErrNoEncoder = -2;
constexpr int kErrBadMap = -3;

// ================================================================ helpers

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ================================================================ Hopper
// Building blocks of the three kernels (PTX for sm_90a), as in
// ops/csrc/flash_attn.cu.

constexpr int kConsumerWarps = 8;                     // two warpgroups
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kHopperThreads = kConsumers + 128;      // + the producer warpgroup
constexpr int kProducerRegs = 40;                     // a thread, after setmaxnreg
constexpr int kConsumerRegs = 232;
constexpr int kStages = 3;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInvRootD = 0.125f;                   // 1 / sqrt(64), exact
constexpr float kScoreLog2 = kInvRootD * kLog2e;      // a raw score to log2 units

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory base rounded up to 1024 bytes, the period of the
// 128-byte swizzle (the kernels request 1024 bytes of slack for it).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
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

// TMA: the box at (row, head) of a [B*H, P*Sb, 64] map into shared memory,
// completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(row), "r"(head)
      : "memory");
}

// Give registers back to (dec) or take them from (inc) the block's pool; all
// four warps of a warpgroup execute it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand whose rows
// are 128 bytes: `lbo` is the byte stride between 64-column panels, 8-row
// groups are 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  wgmma_commit();
  wgmma_wait();
}

// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous product.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory
// (both K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B from shared memory
// (both K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (the accumulator
// layout packed to bf16), B from shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(x) as 2^(x log2 e); exp(-inf) = 0.
__device__ __forceinline__ float fast_exp(float x) {
  return exp2_approx(x * kLog2e);
}

// A wgmma accumulator of 64 x N (N / 2 floats a thread) as N / 16 A-operand
// fragments of 64 x 16 bf16: for k-slice kk, registers 8kk..8kk+7 hold rows
// (r, r + 8) x columns (16kk + 2t, 16kk + 8 + 2t) in exactly the order the
// A fragment wants them.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&acc)[N / 2],
                                         uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

// Byte offset of the 4 bytes at (row, columns 8j + 2t, +1) of a 64-row,
// 128-byte-row tile swizzled as the 128-byte TMA swizzle lays it out.
__device__ __forceinline__ int swizzled(int row, int j, int t) {
  return row * 128 + ((j ^ (row & 7)) << 4) + 4 * t;
}

// Rows [first, first + 64) of a block, staged as bf16 in a warpgroup's
// swizzled 64 x 64 tile, to the row-major `dst` (row r of the block at
// dst + r * 64): rows below Sb only, 16 bytes a thread a store.
__device__ __forceinline__ void store_rows(bf16* dst, const unsigned char* tile,
                                           int first, int Sb, int tid) {
  for (int idx = tid; idx < 64 * 8; idx += 128) {
    const int r = idx >> 3, c = idx & 7;
    if (first + r < Sb)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(first + r) * kD +
                                c * 8) =
          *reinterpret_cast<const uint4*>(tile + swizzled(r, c, 0));
  }
}

// A CTA's barriers, from `bars`: one for its resident tile, then the ring's
// full[kStages] (one arrival, the producer's) and empty[kStages] (one
// arrival a consumer thread).
__device__ __forceinline__ void init_barriers(uint64_t* bars) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars[1 + s], 1);
      mbar_init(&bars[1 + kStages + s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The CTA's place: row tile `tile` of position `pos` of head `bh`, from a
// flat blockIdx.x (tiles fastest, then positions, then heads).
struct Place {
  int tile, pos, bh, b;
  size_t base;  // flat row of the position's first row in [B*H*P*Sb]
};

__device__ __forceinline__ Place place(int H, int P, int Sb, int tiles) {
  Place pl;
  pl.tile = blockIdx.x % tiles;
  pl.pos = (blockIdx.x / tiles) % P;
  pl.bh = blockIdx.x / tiles / P;
  pl.b = pl.bh / H;
  pl.base = (static_cast<size_t>(pl.bh) * P + pl.pos) * Sb;
  return pl;
}

// ----------------------------------------------------------------- K/V ring

constexpr int kKeyTile = 128;                       // keys a K/V stage
constexpr uint32_t kKeyTileBytes = kKeyTile * 128;  // one of K, V

// One producer warp fills a K/V stage: the validity bits of keys
// [k0, k0 + kKeyTile) of key block j (a key at or past Sb, or masked, is
// invalid; `mb` is the block's mask row), then K, and V unless tm_v is null,
// by TMA at the block's rows, completing `full`.
__device__ __forceinline__ void load_kv_stage(uint32_t* bits, unsigned char* sK,
                                              uint64_t* full, const CUtensorMap* tm_k,
                                              const CUtensorMap* tm_v, const uint8_t* mb,
                                              int Sb, int j, int k0, int bh, int lane) {
#pragma unroll
  for (int c = 0; c < kKeyTile / 32; ++c) {
    const int key = k0 + 32 * c + lane;
    const uint32_t word = __ballot_sync(0xffffffffu, key < Sb && mb[key] != 0);
    if (lane == 0) bits[c] = word;
  }
  __syncwarp();
  if (lane == 0) {
    mbar_arrive_expect_tx(full, tm_v != nullptr ? 2 * kKeyTileBytes : kKeyTileBytes);
    tma_load(sK, tm_k, full, j * Sb + k0, bh);
    if (tm_v != nullptr) tma_load(sK + kKeyTileBytes, tm_v, full, j * Sb + k0, bh);
  }
}

// ----------------------------------------------------------------- forward

struct FwdCfg {
  static constexpr int BM = 128;  // query rows a CTA
  static constexpr int BN = kKeyTile;  // keys a stage
  static constexpr uint32_t Q_BYTES = BM * 128;
  static constexpr uint32_t KV_BYTES = kKeyTileBytes;  // one of K, V
  // Byte offsets from the 1024-aligned base. Stage s holds K at
  // kv + 2 s KV_BYTES and V right after it; bits[s] its keys' validity.
  static constexpr uint32_t q = 0;
  static constexpr uint32_t kv = q + Q_BYTES;
  static constexpr uint32_t bits = kv + kStages * 2 * KV_BYTES;  // [kStages][4] u32
  static constexpr uint32_t bars = bits + kStages * 16;  // q_full, full[], empty[]
  static constexpr size_t smem = bars + (1 + 2 * kStages) * 8 + 1024;
};

// A consumer thread's view of a stage's 128 key-validity bits: word c
// shifted by 2t, so that the bit of column 8j + 2t + odd is bit
// 8 (j % 4) + odd of word j / 4.
__device__ __forceinline__ void load_bits(uint32_t (&w)[4], const uint32_t* bits,
                                          int t4) {
  const uint4 v = *reinterpret_cast<const uint4*>(bits);
  w[0] = v.x >> (2 * t4);
  w[1] = v.y >> (2 * t4);
  w[2] = v.z >> (2 * t4);
  w[3] = v.w >> (2 * t4);
}

__device__ __forceinline__ bool key_valid(const uint32_t (&w)[4], int j, int odd) {
  return (w[j / 4] >> (8 * (j % 4) + odd)) & 1u;
}

// The two consumer warpgroups take turns to issue their score products, so
// that one's softmax runs while the other's product does: named barrier
// kTurn + wg (256 threads) is warpgroup wg's turn, which it waits for and
// the other warpgroup hands on. Barriers 1 and 2 are warpgroup_sync's.
constexpr int kTurn = 3;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// S = Q K^T for a warpgroup's 64 query rows and the stage's 128 keys, issued
// in warpgroup wg's turn; the turn passes on unless `last` (warpgroup 1's
// last product, which warpgroup 0 never waits for).
__device__ __forceinline__ void qk_scores(float (&sc)[64], const unsigned char* sQ,
                                          const unsigned char* sK, int wg, bool last) {
  named_sync(kTurn + wg);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss(sc, sw128_desc(sQ + kk * 32, 16), sw128_desc(sK + kk * 32, 16), kk > 0);
  wgmma_commit();
  if (!last) named_arrive(kTurn + 1 - wg);
  wgmma_wait();
  reg_fence(sc);
}

// The fold's raw scores r = bf16(q . k), -inf at invalid keys (masked, or
// past the block) when the tile has any (kMasked); the row maxima of r over
// this thread's columns go into mx. The score is s = r / sqrt(D), exactly.
template <bool kMasked>
__device__ __forceinline__ void raw_scores(float (&sc)[64], const uint32_t (&w)[4],
                                           float (&mx)[2]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float r = round_bf16(sc[4 * j + e]);
      if (kMasked && !key_valid(w, j, e & 1)) r = -INFINITY;
      sc[4 * j + e] = r;
      mx[e / 2] = fmaxf(mx[e / 2], r);
    }
}

// Every key of the stage is valid: all 128 bits set (a uniform branch).
__device__ __forceinline__ bool all_valid(const uint32_t* bits) {
  const uint4 v = *reinterpret_cast<const uint4*>(bits);
  return (v.x & v.y & v.z & v.w) == 0xffffffffu;
}

__device__ __forceinline__ void raw_scores(float (&sc)[64], const uint32_t (&w)[4],
                                           float (&mx)[2], bool full) {
  if (full)
    raw_scores<false>(sc, w, mx);
  else
    raw_scores<true>(sc, w, mx);
}

// The block's max of s over its raw maxima: a masked key scores finfo.min,
// and every block has a key, so the max is at least finfo.min.
__device__ __forceinline__ float block_max(float raw_max) {
  return fmaxf(-FLT_MAX, quad_max(raw_max) * kInvRootD);
}

__global__ void __launch_bounds__(kHopperThreads, 1)
    ring_fold_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const uint8_t* __restrict__ mask,
                         float* __restrict__ m, float* __restrict__ l,
                         float* __restrict__ acc, bf16* __restrict__ out,
                         int H, int P, int Sb, int shift, int steps,
                         int tiles) {
  typedef FwdCfg C;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint32_t* sBits = reinterpret_cast<uint32_t*>(smem + C::bits);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::bars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const Place pl = place(H, P, Sb, tiles);
  const int n_kt = (Sb + C::BN - 1) / C::BN;
  // A block longer than one tile streams its key tiles twice: the max,
  // then p and PV.
  const bool two_pass = n_kt > 1;

  init_barriers(q_full);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumerWarps) {
    // Producer warpgroup: its first warp loads the Q tile once, then per
    // stage the keys' validity bits and K (and V) by TMA; the other three
    // only give up registers.
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kConsumerWarps) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, C::Q_BYTES);
      tma_load(smem + C::q, &tm_q, q_full, pl.pos * Sb + pl.tile * C::BM, pl.bh);
    }
    int it = 0;
    for (int t = 0; t < steps; ++t) {
      const int j = ((pl.pos - shift - t) % P + P) % P;
      const uint8_t* mb = mask + (static_cast<size_t>(pl.b) * P + j) * Sb;
      for (int pass = two_pass ? 0 : 1; pass < 2; ++pass) {
        for (int kt = 0; kt < n_kt; ++kt, ++it) {
          const int s = it % kStages, k0 = kt * C::BN;
          if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          load_kv_stage(sBits + 4 * s, smem + C::kv + s * 2 * C::KV_BYTES, &full[s], &tm_k,
                        pass ? &tm_v : nullptr, mb, Sb, j, k0, pl.bh, lane);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  // Consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of the tile;
  // this thread holds rows ra and ra + 8 of them, key columns 8j + 2t + {0, 1}.
  const int wg = warp / 4, t4 = lane % 4;
  const int ra = 16 * (warp % 4) + lane / 4;
  const int first = pl.tile * C::BM + 64 * wg;  // the warpgroup's first row
  const int rows[2] = {first + ra, first + ra + 8};
  const unsigned char* sQ = smem + C::q + 64 * wg * 128;

  // The carries: from device memory, or fresh.
  float m_r[2], l_r[2], o[32];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool load = acc != nullptr && rows[h] < Sb;
    m_r[h] = load ? m[pl.base + rows[h]] : -INFINITY;
    l_r[h] = load ? l[pl.base + rows[h]] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 a = make_float2(0.f, 0.f);
      if (load)
        a = *reinterpret_cast<const float2*>(acc + (pl.base + rows[h]) * kD + 8 * j + 2 * t4);
      o[4 * j + 2 * h] = a.x;
      o[4 * j + 2 * h + 1] = a.y;
    }
  }

  // Score products in all, the same count for both warpgroups; warpgroup 0
  // takes the first turn.
  const int n_products = steps * (two_pass ? 2 : 1) * n_kt;
  if (wg == 1) named_arrive(kTurn);
  mbar_wait(q_full, 0);
  int it = 0;
  for (int t = 0; t < steps; ++t) {
    float sc[64];
    uint32_t w[4];
    float mx[2] = {-INFINITY, -INFINITY};  // raw maxima of the block
    if (two_pass) {
      for (int kt = 0; kt < n_kt; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        load_bits(w, sBits + 4 * s, t4);
        const bool full_tile = all_valid(sBits + 4 * s);
        qk_scores(sc, sQ, smem + C::kv + s * 2 * C::KV_BYTES, wg,
                  wg == 1 && it == n_products - 1);
        mbar_arrive(&empty[s]);
        raw_scores(sc, w, mx, full_tile);
      }
    }
    // m' in natural units (the carry), and in log2 units for the exponents:
    // finfo.min * log2 e overflows, and a row at finfo.min has no valid key
    // yet, so it is clamped (its p stays exp2(-inf) = 0).
    float m_new[2], m2[2], ls[2] = {0.f, 0.f}, pv[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) pv[e] = 0.f;
    for (int kt = 0; kt < n_kt; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const unsigned char* sK = smem + C::kv + s * 2 * C::KV_BYTES;
      load_bits(w, sBits + 4 * s, t4);
      const bool full_tile = all_valid(sBits + 4 * s);
      qk_scores(sc, sQ, sK, wg, wg == 1 && it == n_products - 1);
      float tile_mx[2] = {-INFINITY, -INFINITY};
      raw_scores(sc, w, tile_mx, full_tile);
      if (kt == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          m_new[h] = fmaxf(m_r[h], block_max(two_pass ? mx[h] : tile_mx[h]));
          m2[h] = fmaxf(m_new[h] * kLog2e, -FLT_MAX);
        }
      }
      // p = exp(s - m') = exp2(r log2(e) / sqrt(D) - m' log2(e)); an
      // invalid key's r = -inf gives 0. Then the block's PV.
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(fmaf(sc[4 * j + e], kScoreLog2, -m2[e / 2]));
          sc[4 * j + e] = p;
          ls[e / 2] += p;
        }
      uint32_t pa[8][4];
      acc_to_a<128>(sc, pa);
      const unsigned char* sV = sK + C::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs(pv, pa[kk], sw128_desc(sV + kk * 16 * 128, C::BN * 128));
      wgmma_commit_and_wait();
      reg_fence(pv);
      mbar_arrive(&empty[s]);
    }
    // Rescale the carries to the new max and add the block's rounded PV.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float block_sum = quad_sum(ls[h]);
      const float scale = fast_exp(m_r[h] - m_new[h]);
      l_r[h] = __fadd_rn(__fmul_rn(l_r[h], scale), block_sum);
      m_r[h] = m_new[h];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int odd = 0; odd < 2; ++odd) {
          float& a = o[4 * j + 2 * h + odd];
          a = __fadd_rn(__fmul_rn(a, scale), round_bf16(pv[4 * j + 2 * h + odd]));
        }
    }
  }

  // Epilogue: m and l; the carried acc; out = bf16(acc / max(l, 1e-30))
  // staged in this warpgroup's (no longer read) rows of the Q tile.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= Sb) continue;
    if (t4 == 0) {
      m[pl.base + rows[h]] = m_r[h];
      l[pl.base + rows[h]] = l_r[h];
    }
    if (acc != nullptr) {
      float* row = acc + (pl.base + rows[h]) * kD;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(row + 8 * j + 2 * t4) =
            make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
    }
  }
  if (out != nullptr) {
    unsigned char* stage = smem + C::q + 64 * wg * 128;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = __frcp_rn(fmaxf(l_r[h], 1e-30f));
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(stage + swizzled(ra + 8 * h, j, t4)) =
            pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    }
    warpgroup_sync(wg);
    store_rows(out + pl.base * kD, stage, first, Sb, threadIdx.x % 128);
  }
}

// ----------------------------------------------------------------- dK, dV

struct DkvCfg {
  static constexpr int BN = 128;  // keys a CTA
  static constexpr int BM = 64;   // queries a stage
  static constexpr uint32_t KV_BYTES = BN * 128;  // one of K, V
  static constexpr uint32_t Q_BYTES = BM * 128;   // one of Q, dO
  // Byte offsets from the 1024-aligned base. Stage s holds Q at
  // ring + 2 s Q_BYTES, dO right after it, and its queries' lse (in log2
  // units) and delta at vec + 2 s BM * 4.
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = k + KV_BYTES;
  static constexpr uint32_t ring = v + KV_BYTES;
  static constexpr uint32_t vec = ring + kStages * 2 * Q_BYTES;
  static constexpr uint32_t bars = vec + kStages * 2 * BM * 4;  // kv_full, full[], empty[]
  static constexpr size_t smem = bars + (1 + 2 * kStages) * 8 + 1024;
};

__global__ void __launch_bounds__(kHopperThreads, 1)
    ring_fold_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const uint8_t* __restrict__ mask,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             bf16* __restrict__ dk_out,
                             bf16* __restrict__ dv_out, int H, int P, int Sb,
                             int shift, int steps, int tiles) {
  typedef DkvCfg C;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  float* sVec = reinterpret_cast<float*>(smem + C::vec);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::bars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const Place pl = place(H, P, Sb, tiles);  // pl.pos is the key block j
  const int n_qt = (Sb + C::BM - 1) / C::BM;

  init_barriers(kv_full);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumerWarps) {
    // Producer warpgroup: its first warp loads K and V once, then per stage
    // the queries' lse and delta and Q and dO by TMA; the other three only
    // give up registers.
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kConsumerWarps) return;
    if (lane == 0) {
      const int row = pl.pos * Sb + pl.tile * C::BN;
      mbar_arrive_expect_tx(kv_full, 2 * C::KV_BYTES);
      tma_load(smem + C::k, &tm_k, kv_full, row, pl.bh);
      tma_load(smem + C::v, &tm_v, kv_full, row, pl.bh);
    }
    int it = 0;
    for (int t = 0; t < steps; ++t) {
      const int i = (pl.pos + shift + t) % P;
      const size_t qbase = (static_cast<size_t>(pl.bh) * P + i) * Sb;
      for (int qt = 0; qt < n_qt; ++qt, ++it) {
        const int s = it % kStages, q0 = qt * C::BM;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        float* v_lse = sVec + s * 2 * C::BM;
        float* v_delta = v_lse + C::BM;
        // lse in log2 units; a query at or past Sb gets +inf, so its P
        // (and dS) is 0.
        for (int r = lane; r < C::BM; r += 32) {
          const bool ok = q0 + r < Sb;
          v_lse[r] = ok ? lse[qbase + q0 + r] * kLog2e : INFINITY;
          v_delta[r] = ok ? delta[qbase + q0 + r] : 0.f;
        }
        __syncwarp();
        if (lane == 0) {
          unsigned char* sQ = smem + C::ring + s * 2 * C::Q_BYTES;
          mbar_arrive_expect_tx(&full[s], 2 * C::Q_BYTES);
          tma_load(sQ, &tm_q, &full[s], i * Sb + q0, pl.bh);
          tma_load(sQ + C::Q_BYTES, &tm_do, &full[s], i * Sb + q0, pl.bh);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  // Consumers: warpgroup wg owns keys [64 wg, 64 wg + 64) of the tile; this
  // thread holds key rows ra and ra + 8, query columns 8j + 2t + {0, 1}.
  const int wg = warp / 4, t4 = lane % 4;
  const int ra = 16 * (warp % 4) + lane / 4;
  const int first = pl.tile * C::BN + 64 * wg;
  const int keys[2] = {first + ra, first + ra + 8};
  const uint8_t* mb = mask + (static_cast<size_t>(pl.b) * P + pl.pos) * Sb;
  const bool key_ok[2] = {keys[0] < Sb && mb[keys[0]] != 0,
                          keys[1] < Sb && mb[keys[1]] != 0};
  unsigned char* sK = smem + C::k + 64 * wg * 128;
  unsigned char* sV = smem + C::v + 64 * wg * 128;

  // The totals: the f32 dk/dv in device memory, or zeros. The products
  // accumulate straight onto them, step after step, so a launch of `steps`
  // steps gives the bits of `steps` one-step launches.
  float dka[32], dva[32];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool load = dk != nullptr && keys[h] < Sb;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 a = make_float2(0.f, 0.f), b = make_float2(0.f, 0.f);
      if (load) {
        const size_t at = (pl.base + keys[h]) * kD + 8 * j + 2 * t4;
        a = *reinterpret_cast<const float2*>(dk + at);
        b = *reinterpret_cast<const float2*>(dv + at);
      }
      const int e = 4 * j + 2 * h;
      dka[e] = a.x;
      dka[e + 1] = a.y;
      dva[e] = b.x;
      dva[e + 1] = b.y;
    }
  }

  // The score products take turns between the warpgroups, as in the
  // forward; warpgroup 0 takes the first.
  const int n_products = steps * n_qt;
  if (wg == 1) named_arrive(kTurn);
  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_products; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const unsigned char* sQ = smem + C::ring + s * 2 * C::Q_BYTES;
    const unsigned char* sdO = sQ + C::Q_BYTES;
    const float* v_lse = sVec + s * 2 * C::BM;
    const float* v_delta = v_lse + C::BM;

    // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys x 64
    // queries, issued in its turn.
    float st[32], dpt[32];
    named_sync(kTurn + wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(st, sw128_desc(sK + kk * 32, 16), sw128_desc(sQ + kk * 32, 16), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(dpt, sw128_desc(sV + kk * 32, 16), sw128_desc(sdO + kk * 32, 16), kk > 0);
    wgmma_commit();
    if (!(wg == 1 && it == n_products - 1)) named_arrive(kTurn + 1 - wg);
    wgmma_wait();
    reg_fence(st);
    reg_fence(dpt);

    // P^T = exp(bf16(q . k) / sqrt(D) - lse), in log2 units, at valid
    // keys; dS^T = P^T (dP^T - delta) / sqrt(D).
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t4;
      const float2 l2 = *reinterpret_cast<const float2*>(v_lse + col);
      const float2 d2 = *reinterpret_cast<const float2*>(v_delta + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        const float p =
            key_ok[e / 2]
                ? exp2_approx(fmaf(round_bf16(st[4 * j + e]), kScoreLog2, -(odd ? l2.y : l2.x)))
                : 0.f;
        st[4 * j + e] = p;
        dpt[4 * j + e] = p * (dpt[4 * j + e] - (odd ? d2.y : d2.x)) * kInvRootD;
      }
    }

    // dV += P^T dO and dK += dS^T Q, both from registers; dO and Q MN-major.
    uint32_t pa[4][4], dsa[4][4];
    acc_to_a<64>(st, pa);
    acc_to_a<64>(dpt, dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(dva, pa[kk], sw128_desc(sdO + kk * 16 * 128, C::BM * 128));
      wgmma_rs(dka, dsa[kk], sw128_desc(sQ + kk * 16 * 128, C::BM * 128));
    }
    wgmma_commit_and_wait();
    reg_fence(dka);
    reg_fence(dva);
    mbar_arrive(&empty[s]);
  }

  // Epilogue: the f32 totals back to dk/dv, and/or bf16 through this
  // warpgroup's (no longer read) rows of the K and V tiles.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (dk == nullptr || keys[h] >= Sb) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const size_t at = (pl.base + keys[h]) * kD + 8 * j + 2 * t4;
      const int e = 4 * j + 2 * h;
      *reinterpret_cast<float2*>(dk + at) = make_float2(dka[e], dka[e + 1]);
      *reinterpret_cast<float2*>(dv + at) = make_float2(dva[e], dva[e + 1]);
    }
  }
  if (dk_out != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = 4 * j + 2 * h;
        const int at = swizzled(ra + 8 * h, j, t4);
        *reinterpret_cast<uint32_t*>(sK + at) = pack_bf16(dka[e], dka[e + 1]);
        *reinterpret_cast<uint32_t*>(sV + at) = pack_bf16(dva[e], dva[e + 1]);
      }
    warpgroup_sync(wg);
    store_rows(dk_out + pl.base * kD, sK, first, Sb, threadIdx.x % 128);
    store_rows(dv_out + pl.base * kD, sV, first, Sb, threadIdx.x % 128);
  }
}

// ----------------------------------------------------------------- dQ

struct DqCfg {
  static constexpr int BM = 128;                      // query rows a CTA
  static constexpr int BN = kKeyTile;                 // keys a stage
  static constexpr uint32_t Q_BYTES = BM * 128;       // one of Q, dO
  static constexpr uint32_t KV_BYTES = kKeyTileBytes;  // one of K, V
  // Byte offsets from the 1024-aligned base: Q, dO, then the K/V ring as in
  // FwdCfg (stage s holds K at kv + 2 s KV_BYTES, V right after it, and its
  // keys' validity at bits[s]).
  static constexpr uint32_t q = 0;
  static constexpr uint32_t dout = q + Q_BYTES;
  static constexpr uint32_t kv = dout + Q_BYTES;
  static constexpr uint32_t bits = kv + kStages * 2 * KV_BYTES;  // [kStages][4] u32
  static constexpr uint32_t bars = bits + kStages * 16;  // q_full, full[], empty[]
  static constexpr size_t smem = bars + (1 + 2 * kStages) * 8 + 1024;
};

// dS = P (dP - delta) / sqrt(D) in place of dP, from the raw scores sc:
// P = exp(bf16(q . k) / sqrt(D) - lse), one FMA and one ex2 in log2 units,
// at valid keys and 0 at the others (kMasked: the tile has some). A row at
// or past Sb has lse2 = +inf, so its P is 0.
template <bool kMasked>
__device__ __forceinline__ void ds_from_scores(const float (&sc)[64], float (&dp)[64],
                                               const uint32_t (&w)[4], const float (&lse2)[2],
                                               const float (&dlt)[2]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_approx(fmaf(round_bf16(sc[4 * j + e]), kScoreLog2, -lse2[e / 2]));
      if (kMasked && !key_valid(w, j, e & 1)) p = 0.f;
      dp[4 * j + e] = p * (dp[4 * j + e] - dlt[e / 2]) * kInvRootD;
    }
}

__global__ void __launch_bounds__(kHopperThreads, 1)
    ring_fold_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const uint8_t* __restrict__ mask,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, bf16* __restrict__ dq_out,
                            int H, int P, int Sb, int shift, int steps,
                            int tiles) {
  typedef DqCfg C;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint32_t* sBits = reinterpret_cast<uint32_t*>(smem + C::bits);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::bars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const Place pl = place(H, P, Sb, tiles);  // pl.pos is the query block i
  const int n_kt = (Sb + C::BN - 1) / C::BN;

  init_barriers(q_full);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumerWarps) {
    // Producer warpgroup: its first warp loads Q and dO once, then per stage
    // the keys' validity bits and K and V, as the forward's second pass
    // does; the other three only give up registers.
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kConsumerWarps) return;
    if (lane == 0) {
      const int row = pl.pos * Sb + pl.tile * C::BM;
      mbar_arrive_expect_tx(q_full, 2 * C::Q_BYTES);
      tma_load(smem + C::q, &tm_q, q_full, row, pl.bh);
      tma_load(smem + C::dout, &tm_do, q_full, row, pl.bh);
    }
    int it = 0;
    for (int t = 0; t < steps; ++t) {
      const int j = ((pl.pos - shift - t) % P + P) % P;
      const uint8_t* mb = mask + (static_cast<size_t>(pl.b) * P + j) * Sb;
      for (int kt = 0; kt < n_kt; ++kt, ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        load_kv_stage(sBits + 4 * s, smem + C::kv + s * 2 * C::KV_BYTES, &full[s], &tm_k,
                      &tm_v, mb, Sb, j, kt * C::BN, pl.bh, lane);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  // Consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of the tile;
  // this thread holds rows ra and ra + 8 of them, key columns 8j + 2t + {0, 1}.
  const int wg = warp / 4, t4 = lane % 4;
  const int ra = 16 * (warp % 4) + lane / 4;
  const int first = pl.tile * C::BM + 64 * wg;  // the warpgroup's first row
  const int rows[2] = {first + ra, first + ra + 8};
  unsigned char* sQ = smem + C::q + 64 * wg * 128;
  const unsigned char* sdO = smem + C::dout + 64 * wg * 128;

  // The rows' lse in log2 units (+inf at or past Sb) and delta; the totals:
  // the f32 dq in device memory, or zeros. The products accumulate straight
  // onto them, step after step.
  float lse2[2], dlt[2], dqa[32];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = rows[h] < Sb;
    lse2[h] = ok ? lse[pl.base + rows[h]] * kLog2e : INFINITY;
    dlt[h] = ok ? delta[pl.base + rows[h]] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 a = make_float2(0.f, 0.f);
      if (dq != nullptr && ok)
        a = *reinterpret_cast<const float2*>(dq + (pl.base + rows[h]) * kD + 8 * j + 2 * t4);
      dqa[4 * j + 2 * h] = a.x;
      dqa[4 * j + 2 * h + 1] = a.y;
    }
  }

  // The score products take turns between the warpgroups, as in the
  // forward; warpgroup 0 takes the first.
  const int n_products = steps * n_kt;
  if (wg == 1) named_arrive(kTurn);
  mbar_wait(q_full, 0);
  for (int it = 0; it < n_products; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const unsigned char* sK = smem + C::kv + s * 2 * C::KV_BYTES;
    const unsigned char* sV = sK + C::KV_BYTES;
    uint32_t w[4];
    load_bits(w, sBits + 4 * s, t4);
    const bool full_tile = all_valid(sBits + 4 * s);

    // S = Q K^T and dP = dO V^T for this warpgroup's 64 queries x the
    // stage's 128 keys, issued in its turn.
    float sc[64], dp[64];
    named_sync(kTurn + wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(sc, sw128_desc(sQ + kk * 32, 16), sw128_desc(sK + kk * 32, 16), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(dp, sw128_desc(sdO + kk * 32, 16), sw128_desc(sV + kk * 32, 16), kk > 0);
    wgmma_commit();
    if (!(wg == 1 && it == n_products - 1)) named_arrive(kTurn + 1 - wg);
    wgmma_wait();
    reg_fence(sc);
    reg_fence(dp);

    if (full_tile)
      ds_from_scores<false>(sc, dp, w, lse2, dlt);
    else
      ds_from_scores<true>(sc, dp, w, lse2, dlt);

    // dQ += bf16(dS) K: dS from registers, K MN-major from the stage, 16
    // keys a product.
    uint32_t dsa[8][4];
    acc_to_a<128>(dp, dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs(dqa, dsa[kk], sw128_desc(sK + kk * 16 * 128, C::BN * 128));
    wgmma_commit_and_wait();
    reg_fence(dqa);
    mbar_arrive(&empty[s]);
  }

  // Epilogue: the f32 totals back to dq, and/or bf16 through this
  // warpgroup's (no longer read) rows of the Q tile.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (dq == nullptr || rows[h] >= Sb) continue;
    float* row = dq + (pl.base + rows[h]) * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + 2 * t4) =
          make_float2(dqa[4 * j + 2 * h], dqa[4 * j + 2 * h + 1]);
  }
  if (dq_out != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(sQ + swizzled(ra + 8 * h, j, t4)) =
            pack_bf16(dqa[4 * j + 2 * h], dqa[4 * j + 2 * h + 1]);
    warpgroup_sync(wg);
    store_rows(dq_out + pl.base * kD, sQ, first, Sb, threadIdx.x % 128);
  }
}

// ----------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the CUDA runtime so that the
// library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A tensor map over the bf16 [B*H, P*Sb, 64] view of `ptr` whose box is
// `rows` rows of one head, 128-byte swizzled. Rows past the head's end read
// as zeros.
int make_map(CUtensorMap* map, const void* ptr, long long bh, long long rows, int box) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)kD * sizeof(bf16),
                                 (cuuint64_t)rows * kD * sizeof(bf16)};
  const cuuint32_t boxes[3] = {(cuuint32_t)kD, (cuuint32_t)box, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                      strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrBadMap;
}

// The flat grid of a fused launch: row tiles of `rows` rows, positions,
// heads; 0 or an error code.
int fused_grid(int B, int H, int P, int Sb, int D, int shift, int steps, int rows,
               int* tiles, dim3* grid) {
  if (D != kD) return kErrHeadDim;
  if (B <= 0 || H <= 0 || P <= 0 || Sb <= 0 || shift < 0 || shift >= P || steps < 1 ||
      shift + steps > P)
    return static_cast<int>(cudaErrorInvalidValue);
  *tiles = (Sb + rows - 1) / rows;
  const long long blocks = static_cast<long long>(B) * H * P * *tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *grid = dim3(static_cast<unsigned>(blocks));
  return 0;
}

}  // namespace

extern "C" int ldt_ring_fold_fwd(const void* q, const void* k, const void* v,
                                 const uint8_t* mask, float* m, float* l,
                                 float* acc, void* out, int B, int H, int P,
                                 int Sb, int D, int shift, int steps,
                                 cudaStream_t stream) {
  int tiles;
  dim3 grid;
  int e = fused_grid(B, H, P, Sb, D, shift, steps, FwdCfg::BM, &tiles, &grid);
  if (e != 0) return e;
  const long long bh = static_cast<long long>(B) * H, rows = static_cast<long long>(P) * Sb;
  CUtensorMap tq, tk, tv;
  if ((e = make_map(&tq, q, bh, rows, FwdCfg::BM)) != 0) return e;
  if ((e = make_map(&tk, k, bh, rows, FwdCfg::BN)) != 0) return e;
  if ((e = make_map(&tv, v, bh, rows, FwdCfg::BN)) != 0) return e;
  cudaError_t ce = cudaFuncSetAttribute(ring_fold_fwd_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(FwdCfg::smem));
  if (ce != cudaSuccess) return static_cast<int>(ce);
  ring_fold_fwd_kernel<<<grid, kHopperThreads, FwdCfg::smem, stream>>>(
      tq, tk, tv, mask, m, l, acc, static_cast<bf16*>(out), H, P, Sb, shift, steps, tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ldt_ring_fold_bwd_dq(const void* q, const void* k,
                                    const void* v, const uint8_t* mask,
                                    const float* lse, const float* delta,
                                    const void* dout, float* dq, void* dq_out,
                                    int B, int H, int P, int Sb, int D,
                                    int shift, int steps,
                                    cudaStream_t stream) {
  int tiles;
  dim3 grid;
  int e = fused_grid(B, H, P, Sb, D, shift, steps, DqCfg::BM, &tiles, &grid);
  if (e != 0) return e;
  if (dq == nullptr && dq_out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long bh = static_cast<long long>(B) * H, rows = static_cast<long long>(P) * Sb;
  CUtensorMap tq, tk, tv, tdo;
  if ((e = make_map(&tq, q, bh, rows, DqCfg::BM)) != 0) return e;
  if ((e = make_map(&tk, k, bh, rows, DqCfg::BN)) != 0) return e;
  if ((e = make_map(&tv, v, bh, rows, DqCfg::BN)) != 0) return e;
  if ((e = make_map(&tdo, dout, bh, rows, DqCfg::BM)) != 0) return e;
  cudaError_t ce = cudaFuncSetAttribute(ring_fold_bwd_dq_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(DqCfg::smem));
  if (ce != cudaSuccess) return static_cast<int>(ce);
  ring_fold_bwd_dq_kernel<<<grid, kHopperThreads, DqCfg::smem, stream>>>(
      tq, tk, tv, tdo, mask, lse, delta, dq, static_cast<bf16*>(dq_out), H, P, Sb, shift,
      steps, tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ldt_ring_fold_bwd_dkv(const void* q, const void* k,
                                     const void* v, const uint8_t* mask,
                                     const float* lse, const float* delta,
                                     const void* dout, float* dk, float* dv,
                                     void* dk_out, void* dv_out, int B, int H,
                                     int P, int Sb, int D, int shift,
                                     int steps, cudaStream_t stream) {
  int tiles;
  dim3 grid;
  int e = fused_grid(B, H, P, Sb, D, shift, steps, DkvCfg::BN, &tiles, &grid);
  if (e != 0) return e;
  if ((dk == nullptr) != (dv == nullptr) || (dk_out == nullptr) != (dv_out == nullptr) ||
      (dk == nullptr && dk_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bh = static_cast<long long>(B) * H, rows = static_cast<long long>(P) * Sb;
  CUtensorMap tq, tk, tv, tdo;
  if ((e = make_map(&tq, q, bh, rows, DkvCfg::BM)) != 0) return e;
  if ((e = make_map(&tk, k, bh, rows, DkvCfg::BN)) != 0) return e;
  if ((e = make_map(&tv, v, bh, rows, DkvCfg::BN)) != 0) return e;
  if ((e = make_map(&tdo, dout, bh, rows, DkvCfg::BM)) != 0) return e;
  cudaError_t ce = cudaFuncSetAttribute(ring_fold_bwd_dkv_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(DkvCfg::smem));
  if (ce != cudaSuccess) return static_cast<int>(ce);
  ring_fold_bwd_dkv_kernel<<<grid, kHopperThreads, DkvCfg::smem, stream>>>(
      tq, tk, tv, tdo, mask, lse, delta, dk, dv, static_cast<bf16*>(dk_out),
      static_cast<bf16*>(dv_out), H, P, Sb, shift, steps, tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ldt_ring_error_string(int code) {
  if (code == kErrHeadDim) return "head dim must be 64";
  if (code == kErrNoEncoder) return "cuTensorMapEncodeTiled not found";
  if (code == kErrBadMap) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
