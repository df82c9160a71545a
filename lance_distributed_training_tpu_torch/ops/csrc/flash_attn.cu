// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the TPU kernels that lance_distributed_training_tpu/ops/flash.py
// (make_flash_attention) reaches through
// jax.experimental.pallas.ops.tpu.flash_attention:
//   flash_fwd_kernel     <- _flash_attention_impl     (pallas_call, forward)
//   flash_bwd_dq_kernel  <- _flash_attention_bwd_dq   (pallas_call, dQ)
//   flash_bwd_dkv_kernel <- _flash_attention_bwd_dkv  (pallas_call, dK, dV)
//
// Semantics are the Pallas kernel's: q, k, v are [B, H, S, D] bf16; a query
// attends a key iff their segment ids are equal (and, when causal, the key
// does not lie after the query). Masking is additive with
// MASK_VALUE = -0.7 * FLT_MAX, as upstream; the scale is applied to QK^T
// before the mask, and a key past S gets -inf. The forward writes O (bf16)
// and the per-row log-sum-exp lse = m + log(l) (f32), which the backward
// kernels use to recompute P = exp(S - lse) tile by tile. di = rowsum(O * dO)
// is computed by the caller, as upstream does outside its kernels.
//
// What bounds these kernels on an H100: at the BERT-base shapes
// [32, 12, 512, 64] the forward does 4*B*H*S^2*D = 25.8 GFLOP against about
// 101 MB of compulsory traffic, so its floor is the 30 us it takes to move
// the bytes (the tensor cores would need 26 us); the two backward kernels do
// 6 and 8 such products and are bound by operations (39 and 52 us). All
// three keep the S x S score matrix out of device memory: each block owns a
// tile of one sequence axis and loops over the other. The backward is split
// into a dQ kernel (one block per query tile) and a dK/dV kernel (one block
// per key tile), so no block writes another's output: no atomics, and the
// result is the same bit for bit from launch to launch.
//
// The three kernels share one design:
//  * Every matrix product is a warpgroup product (wgmma.mma_async, 64 rows
//    per warpgroup) with f32 accumulators in registers. Products whose left
//    operand is a probability tile (P V; dS K; P^T dO, dS^T Q) take it from
//    registers: wgmma's accumulator layout, packed to bf16, is its A-operand
//    layout, so scores never go through shared memory.
//  * Large tiles arrive by TMA (cp.async.bulk.tensor) through tensor maps
//    over the 3-D view [B*H, S, D] with 128-byte swizzle, the layout the
//    wgmma descriptors read. Rows past S are zero-filled by the hardware; a
//    head dim of 128 is two 64-column panels. One stage tile serves as a
//    K-major B (K in Q K^T) and an MN-major B (K in dS K, read with the
//    transpose bit). Outputs leave by TMA stores from the same layout, which
//    clip rows past S.
//  * The block's own rows (Q in the forward; Q and dO in dQ; K and V in
//    dK/dV) load once; the streamed tiles (K, V and the keys' segment ids in
//    the forward and dQ; Q, dO and the per-row lse, di and segment ids in
//    dK/dV) pass through a ring of STAGES buffers guarded by full/empty
//    mbarriers, so the next tiles load while this one is computed.
//  * Scale, mask and softmax run in registers in the log2 domain (exp2 of a
//    pre-scaled score). Each accumulator row lives in one 4-thread quad, so
//    a row max or sum is two shuffles. A tile whose keys all share the
//    query rows' segment, lie before S and below the diagonal skips the
//    mask. A masked score is set to MASK_VALUE, which is what adding it
//    gives in f32; it is not multiplied by log2(e), which would overflow to
//    -inf. Either way a masked entry weighs exp(0) = 1 while its row has
//    seen only masked keys and 0 once the row sees an allowed key, and
//    every query attends at least itself. The backward kernels give a row
//    past S lse = +inf, so its P and dS are exactly 0.
// Warp specialisation: each block has two consumer warpgroups (128 query
// rows in the forward and dQ, 128 keys in dK/dV, 64 each) and one producer
// warpgroup, of which one warp issues the TMA copies and writes the per-row
// vectors. ptxas budgets registers by warpgroup (168 a thread for three), so
// the producer gives its registers up with setmaxnreg (down to 40) and the
// consumers take them (up to 232): dK/dV holds two 64 x D accumulators and
// two 64 x 64 score tiles, and spills at 168. The two consumer warpgroups
// share the ring and overlap each other's softmax with their products
// through the warp schedulers.
// Tiles: the forward and dQ stream 128 keys per stage at D = 64 and 64 at
// D = 128, which keeps the 64-float output accumulator and the score tiles
// (S and, in dQ, dP and the packed dS) inside the consumers' registers;
// dK/dV streams 64 queries per stage for both head dims.
//
// Plain C interface (loaded with ctypes): every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError() after the
// launch, -1 for an unsupported head dim, -2 when the CUDA driver
// API's cuTensorMapEncodeTiled cannot be reached and -3 when it refuses a map.
// The tensor maps are encoded on the host through the runtime's
// cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

// ================================================================= Hopper
// Building blocks of the three kernels (PTX for sm_90a).

constexpr int CONSUMER_WARPS = 8;                  // two warpgroups
constexpr int CONSUMERS = CONSUMER_WARPS * 32;
constexpr int HOPPER_THREADS = CONSUMERS + 128;    // + the producer warpgroup
constexpr int PRODUCER_REGS = 40;                  // registers a thread, after setmaxnreg
constexpr int CONSUMER_REGS = 232;
constexpr int PANEL = 64;                          // bf16 columns per 128-byte row
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
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
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// TMA: the box at (c0, c1, c2) = (column, row, head) of a [B*H, S, D] map
// into shared memory, completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Wait until the issued TMA stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Make this thread's shared-memory stores visible to TMA (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Give registers back to (dec) or take them from (inc) the block's pool; all
// four warps of a warpgroup execute it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(wg + 1) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand whose rows
// are 128 bytes: `lbo` is the byte stride between 64-column panels (read by
// MN-major operands wider than a panel), 8-row groups are 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous product.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
  #pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
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
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
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
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (the accumulator
// layout packed to bf16), B from shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A from registers (the accumulator
// layout packed to bf16), B from shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}


__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A wgmma accumulator of 64 x N (N / 2 floats a thread) as N / 16 A-operand
// fragments of 64 x 16 bf16: for k-slice kk, registers 8kk..8kk+7 hold rows
// (r, r + 8) x columns (16kk + 2t, 16kk + 8 + 2t) in exactly the order the
// A fragment wants them.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&acc)[N / 2], uint32_t (&a)[N / 16][4]) {
  #pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    #pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

// Store a 64 x D accumulator (times `mul`) as bf16 into a warpgroup's 64 rows
// of a 128-byte-swizzled tile whose panels are `panel_bytes` apart. `row` is
// the thread's first accumulator row (the second is row + 8), `t` its
// thread-in-quad.
template <int D>
__device__ __forceinline__ void acc_to_smem(unsigned char* tile, uint32_t panel_bytes,
                                            const float (&acc)[D / 2], float mul_a, float mul_b,
                                            int row, int t) {
  #pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = (8 * j) % PANEL;
    unsigned char* p = tile + (8 * j / PANEL) * panel_bytes + row * 128 +
                       (((col / 8) ^ (row % 8)) * 16) + 4 * t;
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(acc[4 * j] * mul_a, acc[4 * j + 1] * mul_a);
    *reinterpret_cast<uint32_t*>(p + 8 * 128) =
        pack_bf16(acc[4 * j + 2] * mul_b, acc[4 * j + 3] * mul_b);
  }
}

// The segment id every entry of a per-row vector of n ints shares, or
// INT_MIN when they differ (one warp; writes the vector's entries to dst).
__device__ __forceinline__ int copy_segments(int* dst, const int* seg, int row0, int n, int S,
                                             int lane) {
  int lo = 2147483647, hi = -2147483647 - 1;
  for (int i = lane; i < n; i += 32) {
    const int s = (seg != nullptr && row0 + i < S) ? seg[row0 + i] : 0;
    dst[i] = s;
    lo = min(lo, s);
    hi = max(hi, s);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  return lo == hi ? lo : (-2147483647 - 1);
}

// A block's barriers, from `bars`: one for its resident tiles, then the
// ring's full[STAGES] (one arrival, the producer's) and empty[STAGES] (one
// arrival a consumer thread).
template <int STAGES>
__device__ __forceinline__ void init_barriers(uint64_t* bars) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bars[1 + s], 1);
      mbar_init(&bars[1 + STAGES + s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warp of the kernels that stream keys (forward, dQ; config C):
// per ring stage, the keys' segment ids and their uniform flag, then K and V
// by TMA onto the stage's full barrier.
template <typename C>
__device__ __forceinline__ void produce_kv(unsigned char* smem, const CUtensorMap* tm_k,
                                           const CUtensorMap* tm_v, uint64_t* full,
                                           uint64_t* empty, const int* segb, int n_kv, int S,
                                           int bh, int lane) {
  int* sSegK = reinterpret_cast<int*>(smem + C::segk);
  int* sUni = reinterpret_cast<int*>(smem + C::uni);
  for (int t = 0; t < n_kv; ++t) {
    const int s = t % C::STAGES, k0 = t * C::BN;
    if (t >= C::STAGES) mbar_wait(&empty[s], ((t / C::STAGES) & 1) ^ 1);
    const int uni = copy_segments(sSegK + s * C::BN, segb, k0, C::BN, S, lane);
    if (lane == 0) sUni[s] = uni;
    __syncwarp();
    if (lane == 0) {
      mbar_arrive_expect_tx(&full[s], 2 * C::KV_BYTES);
      unsigned char* sK = smem + C::kv + s * 2 * C::KV_BYTES;
      for (int c = 0; c < C::NCOL; ++c) {
        tma_load(sK + c * C::BN * 128, tm_k, &full[s], PANEL * c, k0, bh);
        tma_load(sK + C::KV_BYTES + c * C::BN * 128, tm_v, &full[s], PANEL * c, k0, bh);
      }
    }
  }
}

// Scale a warpgroup's 64 x BN score tile to the log2 domain and mask it in
// place. This thread holds query rows qa and qb = qa + 8 (segments sqa, sqb)
// and keys k0 + 8j + 2t + {0, 1}; `sk` holds the stage's key segments, `uni`
// the one they all share (INT_MIN if mixed). A key past S gets -inf; one of
// another segment or (causal) after the row's query gets MASK_VALUE. The
// mask is skipped when every key shares both rows' segment, lies before S
// and (causal) at or before both rows' queries.
template <int BN>
__device__ __forceinline__ void scale_and_mask(float (&sc)[BN / 2], float scale_log2,
                                               const int* sk, int uni, int k0, int S, int qa,
                                               int qb, int sqa, int sqb, int causal, int t4) {
  const bool need_mask =
      uni != sqa || uni != sqb || k0 + BN > S || (causal && k0 + BN - 1 > qa);
  if (need_mask) {
    #pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      const int2 skv = *reinterpret_cast<const int2*>(sk + col);
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + col + (e & 1);
        const int segk_j = (e & 1) ? skv.y : skv.x;
        const bool row_b = e >= 2;
        float x = sc[4 * j + e] * scale_log2;
        if (kj >= S) x = -INFINITY;
        else if (segk_j != (row_b ? sqb : sqa) || (causal && kj > (row_b ? qb : qa)))
          x = MASK_VALUE;
        sc[4 * j + e] = x;
      }
    }
  } else {
    #pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] *= scale_log2;
  }
}

// ----------------------------------------------------------------- forward

template <int D>
struct FwdCfg {
  static constexpr int BM = 128;                  // query rows per block
  static constexpr int BN = D == 64 ? 128 : 64;   // keys per ring stage
  static constexpr int STAGES = 3;
  static constexpr int NCOL = D / PANEL;
  static constexpr uint32_t Q_BYTES = NCOL * BM * 128;
  static constexpr uint32_t KV_BYTES = NCOL * BN * 128;  // one of K, V
  // Byte offsets from the 1024-aligned base. Stage s holds K at
  // kv + 2 s KV_BYTES and V right after it.
  static constexpr uint32_t q = 0;
  static constexpr uint32_t kv = q + Q_BYTES;
  static constexpr uint32_t segk = kv + STAGES * 2 * KV_BYTES;   // [STAGES][BN] int
  static constexpr uint32_t uni = segk + STAGES * BN * 4;        // [STAGES] int
  static constexpr uint32_t bars = (uni + STAGES * 4 + 7) & ~7u;  // q_full, full[], empty[]
  static constexpr size_t smem = bars + (1 + 2 * STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                 const int* __restrict__ seg, float* __restrict__ lse,
                 int H, int S, int causal, float scale) {
  typedef FwdCfg<D> C;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  int* sSegK = reinterpret_cast<int*>(smem + C::segk);
  int* sUni = reinterpret_cast<int*>(smem + C::uni);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::bars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + C::STAGES;

  const int q0 = blockIdx.x * C::BM, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int* segb = seg != nullptr ? seg + (size_t)b * S : nullptr;
  int n_kv = (S + C::BN - 1) / C::BN;
  if (causal) n_kv = min(n_kv, (min(q0 + C::BM, S) - 1) / C::BN + 1);

  init_barriers<C::STAGES>(q_full);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= CONSUMER_WARPS) {
    // Producer warpgroup: its first warp loads Q once, then K, V and the
    // keys' segment ids per stage; the other three only give up registers.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp != CONSUMER_WARPS) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < C::NCOL; ++c)
        tma_load(smem + C::q + c * C::BM * 128, &tm_q, q_full, PANEL * c, q0, bh);
    }
    produce_kv<C>(smem, &tm_k, &tm_v, full, empty, segb, n_kv, S, bh, lane);
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  // Consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of the block;
  // this thread holds rows ra and ra + 8 of them, columns 8j + 2t + {0, 1}.
  const int wg = warp / 4, t4 = lane % 4;
  const int ra = 16 * (warp % 4) + lane / 4;
  const int qa = q0 + 64 * wg + ra, qb = qa + 8;
  const int sqa = (segb != nullptr && qa < S) ? segb[qa] : 0;
  const int sqb = (segb != nullptr && qb < S) ? segb[qb] : 0;
  const float scale_log2 = scale * LOG2E;
  unsigned char* sQ = smem + C::q + 64 * wg * 128;  // this warpgroup's rows, panel 0

  float o[D / 2];
  #pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;  // log2 domain

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_kv; ++t) {
    const int s = t % C::STAGES, k0 = t * C::BN;
    mbar_wait(&full[s], (t / C::STAGES) & 1);
    unsigned char* sK = smem + C::kv + s * 2 * C::KV_BYTES;
    unsigned char* sV = sK + C::KV_BYTES;

    // S = Q K^T over D in 16-wide slices (32 bytes within a 128-byte panel row).
    float sc[C::BN / 2];
    wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      wgmma_ss(sc, sw128_desc(sQ + c * C::BM * 128 + off, 16),
               sw128_desc(sK + c * C::BN * 128 + off, 16), kk > 0);
    }
    wgmma_commit_and_wait();
    reg_fence(sc);

    scale_and_mask<C::BN>(sc, scale_log2, sSegK + s * C::BN, sUni[s], k0, S, qa, qb, sqa,
                          sqb, causal, t4);

    // Online softmax: the row max over the quad, then P = exp2(S - m).
    float mx_a = m_a, mx_b = m_b;
    #pragma unroll
    for (int j = 0; j < C::BN / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    #pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o_));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o_));
    }
    const float alpha_a = exp2_approx(m_a - mx_a), alpha_b = exp2_approx(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.f, sum_b = 0.f;
    #pragma unroll
    for (int j = 0; j < C::BN / 8; ++j) {
      sc[4 * j] = exp2_approx(sc[4 * j] - m_a);
      sc[4 * j + 1] = exp2_approx(sc[4 * j + 1] - m_a);
      sc[4 * j + 2] = exp2_approx(sc[4 * j + 2] - m_b);
      sc[4 * j + 3] = exp2_approx(sc[4 * j + 3] - m_b);
      sum_a += sc[4 * j] + sc[4 * j + 1];
      sum_b += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l_a = l_a * alpha_a + sum_a;  // this thread's columns; summed over the quad at the end
    l_b = l_b * alpha_b + sum_b;
    #pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha_a;
      o[4 * j + 1] *= alpha_a;
      o[4 * j + 2] *= alpha_b;
      o[4 * j + 3] *= alpha_b;
    }

    // O += P V: P from registers, V MN-major from the stage, 16 keys a step.
    uint32_t pa[C::BN / 16][4];
    acc_to_a<C::BN>(sc, pa);
    wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk)
      wgmma_rs(o, pa[kk], sw128_desc(sV + kk * 16 * 128, C::BN * 128));
    wgmma_commit_and_wait();
    reg_fence(o);
    mbar_arrive(&empty[s]);
  }

  // Epilogue: normalise, stage O in this warpgroup's (no longer read) rows of
  // the Q tile and store it by TMA; write lse = (m + log2 l) ln 2.
  #pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o_);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o_);
  }
  acc_to_smem<D>(sQ, C::BM * 128, o, 1.f / l_a, 1.f / l_b, ra, t4);
  fence_proxy_async();
  warpgroup_sync(wg);
  if (threadIdx.x % 128 == 0 && q0 + 64 * wg < S) {
    for (int c = 0; c < C::NCOL; ++c)
      tma_store(&tm_o, sQ + c * C::BM * 128, PANEL * c, q0 + 64 * wg, bh);
    tma_store_wait();
  }
  if (t4 == 0) {
    float* lse_bh = lse + (size_t)bh * S;
    if (qa < S) lse_bh[qa] = (m_a + log2f(l_a)) * LN2;
    if (qb < S) lse_bh[qb] = (m_b + log2f(l_b)) * LN2;
  }
}

// ----------------------------------------------------------------- dQ

template <int D>
struct DqCfg {
  static constexpr int BM = 128;                  // query rows per block
  static constexpr int BN = D == 64 ? 128 : 64;   // keys per ring stage
  static constexpr int STAGES = 3;
  static constexpr int NCOL = D / PANEL;
  static constexpr uint32_t Q_BYTES = NCOL * BM * 128;   // one of Q, dO
  static constexpr uint32_t KV_BYTES = NCOL * BN * 128;  // one of K, V
  // Byte offsets from the 1024-aligned base: Q, dO, then the ring as in
  // FwdCfg (stage s holds K at kv + 2 s KV_BYTES and V right after it).
  static constexpr uint32_t q = 0;
  static constexpr uint32_t dout = q + Q_BYTES;
  static constexpr uint32_t kv = dout + Q_BYTES;
  static constexpr uint32_t segk = kv + STAGES * 2 * KV_BYTES;   // [STAGES][BN] int
  static constexpr uint32_t uni = segk + STAGES * BN * 4;        // [STAGES] int
  static constexpr uint32_t bars = (uni + STAGES * 4 + 7) & ~7u;  // q_full, full[], empty[]
  static constexpr size_t smem = bars + (1 + 2 * STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_dq,
                    const int* __restrict__ seg, const float* __restrict__ lse,
                    const float* __restrict__ di, int H, int S, int causal, float scale) {
  typedef DqCfg<D> C;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int* sSegK = reinterpret_cast<const int*>(smem + C::segk);
  const int* sUni = reinterpret_cast<const int*>(smem + C::uni);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::bars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + C::STAGES;

  const int q0 = blockIdx.x * C::BM, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int* segb = seg != nullptr ? seg + (size_t)b * S : nullptr;
  int n_kv = (S + C::BN - 1) / C::BN;
  if (causal) n_kv = min(n_kv, (min(q0 + C::BM, S) - 1) / C::BN + 1);

  init_barriers<C::STAGES>(q_full);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= CONSUMER_WARPS) {
    // Producer warpgroup: its first warp loads Q and dO once, then K, V and
    // the keys' segment ids per stage; the other three only give up registers.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp != CONSUMER_WARPS) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * C::Q_BYTES);
      for (int c = 0; c < C::NCOL; ++c) {
        tma_load(smem + C::q + c * C::BM * 128, &tm_q, q_full, PANEL * c, q0, bh);
        tma_load(smem + C::dout + c * C::BM * 128, &tm_do, q_full, PANEL * c, q0, bh);
      }
    }
    produce_kv<C>(smem, &tm_k, &tm_v, full, empty, segb, n_kv, S, bh, lane);
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  // Consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of the block;
  // this thread holds rows ra and ra + 8 of them, key columns 8j + 2t + {0, 1}.
  // Its rows' lse (times log2 e), di and segment ids stay in registers; a
  // row past S gets lse = +inf, so its P and dS are exactly 0.
  const int wg = warp / 4, t4 = lane % 4;
  const int ra = 16 * (warp % 4) + lane / 4;
  const int qa = q0 + 64 * wg + ra, qb = qa + 8;
  const int sqa = (segb != nullptr && qa < S) ? segb[qa] : 0;
  const int sqb = (segb != nullptr && qb < S) ? segb[qb] : 0;
  const float* lse_bh = lse + (size_t)bh * S;
  const float* di_bh = di + (size_t)bh * S;
  const float lse_a = qa < S ? lse_bh[qa] * LOG2E : INFINITY;
  const float lse_b = qb < S ? lse_bh[qb] * LOG2E : INFINITY;
  const float di_a = qa < S ? di_bh[qa] : 0.f;
  const float di_b = qb < S ? di_bh[qb] : 0.f;
  const float scale_log2 = scale * LOG2E;
  unsigned char* sQ = smem + C::q + 64 * wg * 128;  // this warpgroup's rows, panel 0
  unsigned char* sdO = smem + C::dout + 64 * wg * 128;

  float dq[D / 2];
  #pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_kv; ++t) {
    const int s = t % C::STAGES, k0 = t * C::BN;
    mbar_wait(&full[s], (t / C::STAGES) & 1);
    unsigned char* sK = smem + C::kv + s * 2 * C::KV_BYTES;
    unsigned char* sV = sK + C::KV_BYTES;

    // S = Q K^T and dP = dO V^T over D in 16-wide slices.
    float sc[C::BN / 2], dp[C::BN / 2];
    wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      wgmma_ss(sc, sw128_desc(sQ + c * C::BM * 128 + off, 16),
               sw128_desc(sK + c * C::BN * 128 + off, 16), kk > 0);
    }
    #pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      wgmma_ss(dp, sw128_desc(sdO + c * C::BM * 128 + off, 16),
               sw128_desc(sV + c * C::BN * 128 + off, 16), kk > 0);
    }
    wgmma_commit_and_wait();
    reg_fence(sc);
    reg_fence(dp);

    // P = exp2(S scale log2 e + mask - lse log2 e), dS = P (dP - di).
    scale_and_mask<C::BN>(sc, scale_log2, sSegK + s * C::BN, sUni[s], k0, S, qa, qb, sqa,
                          sqb, causal, t4);
    #pragma unroll
    for (int i = 0; i < C::BN / 2; ++i) {
      const bool row_b = i % 4 >= 2;
      dp[i] = exp2_approx(sc[i] - (row_b ? lse_b : lse_a)) * (dp[i] - (row_b ? di_b : di_a));
    }

    // dQ += dS K: dS from registers, K MN-major from the stage, 16 keys a step.
    uint32_t dsa[C::BN / 16][4];
    acc_to_a<C::BN>(dp, dsa);
    wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk)
      wgmma_rs(dq, dsa[kk], sw128_desc(sK + kk * 16 * 128, C::BN * 128));
    wgmma_commit_and_wait();
    reg_fence(dq);
    mbar_arrive(&empty[s]);
  }

  // Epilogue: stage dQ (times the scale) in this warpgroup's (no longer read)
  // rows of the Q tile and store it by TMA.
  acc_to_smem<D>(sQ, C::BM * 128, dq, scale, scale, ra, t4);
  fence_proxy_async();
  warpgroup_sync(wg);
  if (threadIdx.x % 128 == 0 && q0 + 64 * wg < S) {
    for (int c = 0; c < C::NCOL; ++c)
      tma_store(&tm_dq, sQ + c * C::BM * 128, PANEL * c, q0 + 64 * wg, bh);
    tma_store_wait();
  }
}

// ----------------------------------------------------------------- dK, dV

template <int D>
struct DkvCfg {
  static constexpr int BN = 128;  // keys per block
  static constexpr int BM = 64;   // queries per ring stage
  static constexpr int STAGES = 3;
  static constexpr int NCOL = D / PANEL;
  static constexpr uint32_t KV_BYTES = NCOL * BN * 128;  // one of K, V
  static constexpr uint32_t Q_BYTES = NCOL * BM * 128;   // one of Q, dO
  // Byte offsets from the 1024-aligned base. Stage s holds Q at
  // ring + 2 s Q_BYTES, dO right after it, and the stage's per-query
  // vectors (lse * log2 e, di, segment ids) at vec + 3 s BM * 4.
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = k + KV_BYTES;
  static constexpr uint32_t ring = v + KV_BYTES;
  static constexpr uint32_t vec = ring + STAGES * 2 * Q_BYTES;
  static constexpr uint32_t uni = vec + STAGES * 3 * BM * 4;      // [STAGES] int
  static constexpr uint32_t bars = (uni + STAGES * 4 + 7) & ~7u;   // kv_full, full[], empty[]
  static constexpr size_t smem = bars + (1 + 2 * STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_dk,
                     const __grid_constant__ CUtensorMap tm_dv,
                     const int* __restrict__ seg, const float* __restrict__ lse,
                     const float* __restrict__ di, int H, int S, int causal, float scale) {
  typedef DkvCfg<D> C;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  float* sVec = reinterpret_cast<float*>(smem + C::vec);
  int* sUni = reinterpret_cast<int*>(smem + C::uni);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::bars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + C::STAGES;

  const int k0 = blockIdx.x * C::BN, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int* segb = seg != nullptr ? seg + (size_t)b * S : nullptr;
  // Causal: query tiles that end before this block's first key see none of it.
  const int qt0 = causal ? k0 / C::BM : 0;
  const int n_q = (S + C::BM - 1) / C::BM - qt0;

  init_barriers<C::STAGES>(kv_full);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= CONSUMER_WARPS) {
    // Producer warpgroup: its first warp loads K and V once, then Q, dO and
    // the per-query vectors per stage; the other three only give up registers.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp != CONSUMER_WARPS) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * C::KV_BYTES);
      for (int c = 0; c < C::NCOL; ++c) {
        tma_load(smem + C::k + c * C::BN * 128, &tm_k, kv_full, PANEL * c, k0, bh);
        tma_load(smem + C::v + c * C::BN * 128, &tm_v, kv_full, PANEL * c, k0, bh);
      }
    }
    const float* lse_bh = lse + (size_t)bh * S;
    const float* di_bh = di + (size_t)bh * S;
    for (int t = 0; t < n_q; ++t) {
      const int s = t % C::STAGES, q0 = (qt0 + t) * C::BM;
      if (t >= C::STAGES) mbar_wait(&empty[s], ((t / C::STAGES) & 1) ^ 1);
      float* v_lse = sVec + s * 3 * C::BM;
      float* v_di = v_lse + C::BM;
      // A query past S gets lse = +inf, so its P (and dS) is exactly 0.
      for (int i = lane; i < C::BM; i += 32) {
        const bool ok = q0 + i < S;
        v_lse[i] = ok ? lse_bh[q0 + i] * LOG2E : INFINITY;
        v_di[i] = ok ? di_bh[q0 + i] : 0.f;
      }
      const int uni = copy_segments(reinterpret_cast<int*>(v_di + C::BM), segb, q0, C::BM, S, lane);
      if (lane == 0) sUni[s] = uni;
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * C::Q_BYTES);
        unsigned char* sQ = smem + C::ring + s * 2 * C::Q_BYTES;
        for (int c = 0; c < C::NCOL; ++c) {
          tma_load(sQ + c * C::BM * 128, &tm_q, &full[s], PANEL * c, q0, bh);
          tma_load(sQ + C::Q_BYTES + c * C::BM * 128, &tm_do, &full[s], PANEL * c, q0, bh);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  // Consumers: warpgroup wg owns keys [64 wg, 64 wg + 64) of the block; this
  // thread holds key rows ra and ra + 8, query columns 8j + 2t + {0, 1}.
  const int wg = warp / 4, t4 = lane % 4;
  const int ra = 16 * (warp % 4) + lane / 4;
  const int ka = k0 + 64 * wg + ra, kb = ka + 8;
  const int ska = (segb != nullptr && ka < S) ? segb[ka] : 0;
  const int skb = (segb != nullptr && kb < S) ? segb[kb] : 0;
  const float scale_log2 = scale * LOG2E;
  unsigned char* sK = smem + C::k + 64 * wg * 128;  // this warpgroup's rows, panel 0
  unsigned char* sV = smem + C::v + 64 * wg * 128;

  float dk[D / 2], dv[D / 2];
  #pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  mbar_wait(kv_full, 0);
  for (int t = 0; t < n_q; ++t) {
    const int s = t % C::STAGES, q0 = (qt0 + t) * C::BM;
    mbar_wait(&full[s], (t / C::STAGES) & 1);
    unsigned char* sQ = smem + C::ring + s * 2 * C::Q_BYTES;
    unsigned char* sdO = sQ + C::Q_BYTES;
    const float* v_lse = sVec + s * 3 * C::BM;
    const float* v_di = v_lse + C::BM;
    const int* v_seg = reinterpret_cast<const int*>(v_di + C::BM);

    // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys x 64 queries.
    float st[C::BM / 2], dpt[C::BM / 2];
    wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      wgmma_ss(st, sw128_desc(sK + c * C::BN * 128 + off, 16),
               sw128_desc(sQ + c * C::BM * 128 + off, 16), kk > 0);
    }
    #pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      wgmma_ss(dpt, sw128_desc(sV + c * C::BN * 128 + off, 16),
               sw128_desc(sdO + c * C::BM * 128 + off, 16), kk > 0);
    }
    wgmma_commit_and_wait();
    reg_fence(st);
    reg_fence(dpt);

    // P^T = exp2(S^T scale log2 e + mask - lse log2 e), dS^T = P^T (dP^T - di).
    const int uni = sUni[s];
    const bool need_mask = uni != ska || uni != skb || (causal && q0 < kb);
    #pragma unroll
    for (int j = 0; j < C::BM / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      const float2 l2 = *reinterpret_cast<const float2*>(v_lse + col);
      const float2 d2 = *reinterpret_cast<const float2*>(v_di + col);
      int2 sq2 = make_int2(0, 0);
      if (need_mask) sq2 = *reinterpret_cast<const int2*>(v_seg + col);
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool row_b = e >= 2, odd = e & 1;
        float u = st[4 * j + e] * scale_log2;
        if (need_mask && ((odd ? sq2.y : sq2.x) != (row_b ? skb : ska) ||
                          (causal && q0 + col + odd < (row_b ? kb : ka))))
          u = MASK_VALUE;
        const float p = exp2_approx(u - (odd ? l2.y : l2.x));
        st[4 * j + e] = p;
        dpt[4 * j + e] = p * (dpt[4 * j + e] - (odd ? d2.y : d2.x));
      }
    }

    // dV += P^T dO and dK += dS^T Q, both from registers; dO and Q MN-major.
    uint32_t pa[C::BM / 16][4], dsa[C::BM / 16][4];
    acc_to_a<C::BM>(st, pa);
    acc_to_a<C::BM>(dpt, dsa);
    wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < C::BM / 16; ++kk) {
      wgmma_rs(dv, pa[kk], sw128_desc(sdO + kk * 16 * 128, C::BM * 128));
      wgmma_rs(dk, dsa[kk], sw128_desc(sQ + kk * 16 * 128, C::BM * 128));
    }
    wgmma_commit_and_wait();
    reg_fence(dk);
    reg_fence(dv);
    mbar_arrive(&empty[s]);
  }

  // Epilogue: stage dK (times the scale) and dV in this warpgroup's (no
  // longer read) rows of the K and V tiles and store them by TMA.
  acc_to_smem<D>(sK, C::BN * 128, dk, scale, scale, ra, t4);
  acc_to_smem<D>(sV, C::BN * 128, dv, 1.f, 1.f, ra, t4);
  fence_proxy_async();
  warpgroup_sync(wg);
  if (threadIdx.x % 128 == 0 && k0 + 64 * wg < S) {
    for (int c = 0; c < C::NCOL; ++c) {
      tma_store(&tm_dk, sK + c * C::BN * 128, PANEL * c, k0 + 64 * wg, bh);
      tma_store(&tm_dv, sV + c * C::BN * 128, PANEL * c, k0 + 64 * wg, bh);
    }
    tma_store_wait();
  }
}

// ----------------------------------------------------------------- host

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

constexpr int ERR_NO_ENCODER = -2;  // cuTensorMapEncodeTiled not reachable
constexpr int ERR_BAD_MAP = -3;     // cuTensorMapEncodeTiled refused a map

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The CUDA driver API's cuTensorMapEncodeTiled, reached through the runtime so that
// the library needs no -lcuda.
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

// A tensor map over the bf16 [B*H, S, D] view of `ptr` whose box is one
// 64-column panel of `rows` rows of one head, 128-byte swizzled. Rows past S
// read as zeros and are not written.
int make_map(CUtensorMap* map, const void* ptr, int BH, int S, int D, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(bf16), (cuuint64_t)S * D * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)PANEL, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_BAD_MAP;
}

template <int D>
int fwd(const void* q, const void* k, const void* v, const int* seg, void* o,
        float* lse, int B, int H, int S, int causal, float scale, cudaStream_t stream) {
  typedef FwdCfg<D> C;
  CUtensorMap tq, tk, tv, to;
  int e;
  if ((e = make_map(&tq, q, B * H, S, D, C::BM)) != 0) return e;
  if ((e = make_map(&tk, k, B * H, S, D, C::BN)) != 0) return e;
  if ((e = make_map(&tv, v, B * H, S, D, C::BN)) != 0) return e;
  if ((e = make_map(&to, o, B * H, S, D, 64)) != 0) return e;
  cudaError_t ce = prepare(flash_fwd_kernel<D>, C::smem);
  if (ce != cudaSuccess) return (int)ce;
  dim3 grid((S + C::BM - 1) / C::BM, H, B);
  flash_fwd_kernel<D><<<grid, HOPPER_THREADS, C::smem, stream>>>(tq, tk, tv, to, seg, lse, H, S,
                                                                   causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const int* seg, const float* lse,
           const void* dout, const float* di, void* dq, int B, int H, int S, int causal,
           float scale, cudaStream_t stream) {
  typedef DqCfg<D> C;
  CUtensorMap tq, tk, tv, tdo, tdq;
  int e;
  if ((e = make_map(&tq, q, B * H, S, D, C::BM)) != 0) return e;
  if ((e = make_map(&tk, k, B * H, S, D, C::BN)) != 0) return e;
  if ((e = make_map(&tv, v, B * H, S, D, C::BN)) != 0) return e;
  if ((e = make_map(&tdo, dout, B * H, S, D, C::BM)) != 0) return e;
  if ((e = make_map(&tdq, dq, B * H, S, D, 64)) != 0) return e;
  cudaError_t ce = prepare(flash_bwd_dq_kernel<D>, C::smem);
  if (ce != cudaSuccess) return (int)ce;
  dim3 grid((S + C::BM - 1) / C::BM, H, B);
  flash_bwd_dq_kernel<D><<<grid, HOPPER_THREADS, C::smem, stream>>>(
      tq, tk, tv, tdo, tdq, seg, lse, di, H, S, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const int* seg, const float* lse,
            const void* dout, const float* di, void* dk, void* dv, int B, int H, int S,
            int causal, float scale, cudaStream_t stream) {
  typedef DkvCfg<D> C;
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  int e;
  if ((e = make_map(&tq, q, B * H, S, D, C::BM)) != 0) return e;
  if ((e = make_map(&tk, k, B * H, S, D, C::BN)) != 0) return e;
  if ((e = make_map(&tv, v, B * H, S, D, C::BN)) != 0) return e;
  if ((e = make_map(&tdo, dout, B * H, S, D, C::BM)) != 0) return e;
  if ((e = make_map(&tdk, dk, B * H, S, D, 64)) != 0) return e;
  if ((e = make_map(&tdv, dv, B * H, S, D, 64)) != 0) return e;
  cudaError_t ce = prepare(flash_bwd_dkv_kernel<D>, C::smem);
  if (ce != cudaSuccess) return (int)ce;
  dim3 grid((S + C::BN - 1) / C::BN, H, B);
  flash_bwd_dkv_kernel<D><<<grid, HOPPER_THREADS, C::smem, stream>>>(
      tq, tk, tv, tdo, tdk, tdv, seg, lse, di, H, S, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ldt_flash_fwd(const void* q, const void* k, const void* v, const void* seg,
                  void* o, void* lse, int B, int H, int S, int D, int causal,
                  float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return fwd<64>(q, k, v, (const int*)seg, o, (float*)lse, B, H, S, causal, scale, st);
  if (D == 128) return fwd<128>(q, k, v, (const int*)seg, o, (float*)lse, B, H, S, causal, scale, st);
  return -1;
}

int ldt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* seg,
                     const void* lse, const void* dout, const void* di, void* dq,
                     int B, int H, int S, int D, int causal, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return bwd_dq<64>(q, k, v, (const int*)seg, (const float*)lse, dout, (const float*)di, dq,
                      B, H, S, causal, scale, st);
  if (D == 128)
    return bwd_dq<128>(q, k, v, (const int*)seg, (const float*)lse, dout, (const float*)di, dq,
                       B, H, S, causal, scale, st);
  return -1;
}

int ldt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* seg,
                      const void* lse, const void* dout, const void* di, void* dk,
                      void* dv, int B, int H, int S, int D, int causal, float scale,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return bwd_dkv<64>(q, k, v, (const int*)seg, (const float*)lse, dout, (const float*)di, dk,
                       dv, B, H, S, causal, scale, st);
  if (D == 128)
    return bwd_dkv<128>(q, k, v, (const int*)seg, (const float*)lse, dout, (const float*)di, dk,
                        dv, B, H, S, causal, scale, st);
  return -1;
}

const char* ldt_flash_error_string(int code) {
  if (code == -1) return "unsupported head dim";
  if (code == ERR_NO_ENCODER) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (code == ERR_BAD_MAP) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory a launch of a kernel takes (kernel 0 fwd, 1 bwd_dq,
// 2 bwd_dkv) at head dim D, or -1.
int ldt_flash_smem_bytes(int kernel, int D) {
  if (D != 64 && D != 128) return -1;
  switch (kernel) {
    case 0: return (int)(D == 64 ? FwdCfg<64>::smem : FwdCfg<128>::smem);
    case 1: return (int)(D == 64 ? DqCfg<64>::smem : DqCfg<128>::smem);
    case 2: return (int)(D == 64 ? DkvCfg<64>::smem : DkvCfg<128>::smem);
    default: return -1;
  }
}

}  // extern "C"
