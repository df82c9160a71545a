// K2: the dense half of device-side JPEG decode, from coefficient pages to
// resized RGB, in one kernel.
//
// Replaces the JAX package's `ops/jpeg_device.py` `decode_coeff_batch`
// (:180) and its helpers `_idct_plane` (:106), `_upsample_h2v2` (:130),
// `_ycc_to_rgb` (:137), `_axis_samples` (:148) and `_resize_one` (:162),
// which XLA compiles on the TPU. It computes what that function computes,
// bit for bit:
//
//   * the IDCT of every 8x8 block that is sampled: dequantize, the columns
//     pass s1[u][y] = sum_v C[u][v] * B[y][v], (s1 + 1024) >> 11, the rows
//     pass p[x][y] = sum_u B[x][u] * s1[u][y], (p + 1024) >> 11, + 128,
//     clip to [0, 255]. B is the 11-bit basis `IDCT_BASIS_FIX`
//     (ops/jpeg_device.py), here as the constant table kBasis;
//   * the 16.16 sample positions of `_axis_samples` from the image's
//     geometry, four luma samples with the chroma at (y >> 1, x >> 1) (the
//     non-fancy h2v2 upsample), jdcolor's integer YCbCr -> RGB with
//     clipping, then the bilinear mix, vertical first and horizontal
//     second, as `_resize_one` does. Writes uint8 NHWC [N, S, S, 3].
//
// Integer semantics. The JAX function's products and sums are int32 and
// wrap around (16-bit quant tables can reach that); here they are taken in
// uint32, whose wrap-around is defined, and turned back into int32 only for
// the arithmetic right shifts. A sample index is normalised (a negative one
// counts from the end) and clamped into the plane, as JAX's gather does,
// and the division of `_axis_samples` floors. A sample whose weight is 0
// does not change the mix (a + ((b - a) * 0 >> 16) = a), so its second
// index is taken equal to the first: nothing then reads or decodes a row
// or column that only a zero weight touches.
//
// Bound, at the main path's shape (pages int16 [512, 28, 28, 64] and
// 2 x [512, 14, 14, 64] in, uint8 [512, 224, 224, 3] out): the function
// must move 154.6 MB, 0.046 ms at 3.35 TB/s. Its integer operations (the
// IDCT of every sampled block in the even/odd form below, the colour
// conversion of each sampled source pixel, and the mixes whose weight is
// not 0, none at the path's scale) take about 0.04 ms at the card's 32-bit
// integer rate, so it is bound by bytes; chip_smoke.py counts both.
//
// Design. A CTA of 256 threads owns a tile of one image's output: a band
// of R rows by T columns (T = S where it fits, which is the path). It
// tabulates the samples of its T columns and R rows once, marks in a
// bitmap the luma and chroma block columns that its columns sample (two
// source columns at most each, so at most 2T of either, whatever the width
// of the grid), and numbers them by a prefix count of the bitmap: a slot
// then holds only those block columns, side by side. Where a slot can hold
// every block column of the grid, as on the path, it does, with no bitmap
// (whose atomics and barriers cost the path 14%). It walks its rows in
// runs. The first row of a run claims the block rows it samples (at most
// two of luma and two of chroma, both chroma planes together) in two
// slots of each kind, decoding into shared memory as uint8 those not yet
// held; the run goes on while the next rows sample only held block rows,
// and the threads then take the run's pixels, a column each. Rows sampled
// in order keep a slot for 8 (luma) or 16 (chroma) source rows, so a band
// decodes each block it samples once. A decode gives each 8x8 block 8
// threads: a thread's coefficient row is one 16-byte load, the columns
// pass multiplies by constants, the rows pass by the thread's basis row in
// registers, each pass sums the basis's even and odd terms apart (half the
// products, the same uint32 sums, so the same bits), and the intermediate
// rows pass through a scratch tile in shared memory (stride 68 words: the
// four blocks of a warp fall in different banks). Each output pixel reads
// its samples from shared memory; the tile's bytes are staged in shared
// memory at the output's alignment and written with 16-byte stores (byte
// stores at the ragged ends), the band as one run where T = S and row by
// row otherwise. Nothing but the pages in and the pixels out touches
// device memory.
//
// Shared memory. The host picks T and R so that the layout fits 227 KB:
// the fewest column tiles that leave room for a band of 8 rows (1 where
// even one column does not leave room for 8), then as many rows as fit, up
// to 32. What grows with the grid's width is the bitmap and its prefix
// count, 8 bytes for each 32 block columns of luma and of chroma, so the
// widest grid the kernel takes (ldt_jpeg_widest_grid) lies hundreds of
// thousands of blocks past JPEG's own limit of 65535 pixels (8192 blocks).
//
// C interface (bound with ctypes by ops/jpeg_device.py):
//   int ldt_jpeg_decode(const int16_t* coef_y, const int16_t* coef_cb,
//                       const int16_t* coef_cr, const int32_t* quant,
//                       const int32_t* geom, int N, int ybh, int ybw,
//                       int cbh, int cbw, int S, uint8_t* out, cudaStream_t);
// returns the cudaError_t of the launch (0 on success), or
// kGridTooWide (-1) when even a tile of one pixel does not fit;
//   int ldt_jpeg_widest_grid(int S);
// returns the widest luma grid, in blocks (chroma half as wide, rounded
// up), that the kernel takes at output size S.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerPass = kThreads / 8;  // 8x8 blocks a decode pass
constexpr int kStride = 68;  // shared int32 words of a block's scratch
constexpr int kSlots = 2;    // block rows of each kind held at once
constexpr int kMinBandRows = 8;   // rows a band is given before tiles narrow
constexpr int kMaxBandRows = 32;
constexpr size_t kSmemBudget = 232448;  // bytes of shared memory a CTA may use
constexpr int kGridTooWide = -1;

// IDCT_BASIS_FIX[x][u]: round(2048 * c(u) / 2 * cos((2x + 1) u pi / 16)).
__constant__ int32_t kBasis[64] = {
    724, 1004, 946,  851,   724,  569,   392,  200,
    724, 851,  392,  -200,  -724, -1004, -946, -569,
    724, 569,  -392, -1004, -724, 200,   946,  851,
    724, 200,  -946, -569,  724,  851,   -392, -1004,
    724, -200, -946, 569,   724,  -851,  -392, 1004,
    724, -569, -392, 1004,  -724, -200,  946,  -851,
    724, -851, 392,  200,   -724, 1004,  -946, 569,
    724, -1004, 946, -851,  724,  -569,  392,  -200,
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// A CTA's shared memory for a tile of T columns and R rows: the column
// tables (lx0, lx1, cx0, cx1, wx: 5 ints a column), the row tables (sy0,
// sy1, wy), the bitmap of sampled block columns (wl words of luma, then wc
// of chroma), its exclusive prefix count (one more word: the total), the
// per-warp sums of that count, the lists of sampled block columns (kl
// luma, then kc chroma), the decode scratch, the luma slots (8 rows of
// 8 kl bytes), the chroma slots (8 rows of 8 kc bytes of Cb, then of Cr)
// and the staged tile (rows at most 3 T + 15 bytes apart, and 16 bytes of
// room to match the output's alignment).
struct Layout {
  int wl, wc, kl, kc;
  size_t rows, bits, prefix, warp, lists, scratch, luma, chroma, stage, total;
};

__host__ __device__ inline Layout layout(int ybw, int cbw, int T, int R) {
  Layout l;
  l.wl = (ybw + 31) / 32;
  l.wc = (cbw + 31) / 32;
  l.kl = 2 * T < ybw ? 2 * T : ybw;
  l.kc = 2 * T < cbw ? 2 * T : cbw;
  l.rows = align16(static_cast<size_t>(20) * T);
  l.bits = align16(l.rows + static_cast<size_t>(12) * R);
  l.prefix = align16(l.bits + static_cast<size_t>(4) * (l.wl + l.wc));
  l.warp = align16(l.prefix + static_cast<size_t>(4) * (l.wl + l.wc + 1));
  l.lists = l.warp + 4 * kWarps;
  l.scratch = align16(l.lists + static_cast<size_t>(4) * (l.kl + l.kc));
  l.luma = l.scratch + static_cast<size_t>(kBlocksPerPass) * kStride * 4;
  l.chroma = l.luma + static_cast<size_t>(kSlots) * 64 * l.kl;
  l.stage = l.chroma + static_cast<size_t>(kSlots) * 128 * l.kc;
  l.total = l.stage + 16 + static_cast<size_t>(R) * (3 * T + 15);
  return l;
}

// The tile of a launch: T columns and R rows, as the layout above sizes
// them; false when not even one column and one row fit.
bool pick_tile(int ybw, int cbw, int S, int& T, int& R) {
  const int floors[2] = {S < kMinBandRows ? S : kMinBandRows, 1};
  for (int rows : floors) {
    for (int tiles = 1;; ++tiles) {
      T = (S + tiles - 1) / tiles;
      if (layout(ybw, cbw, T, rows).total <= kSmemBudget) {
        R = rows;
        while (R < kMaxBandRows && R < S && layout(ybw, cbw, T, R + 1).total <= kSmemBudget) ++R;
        return true;
      }
      if (T == 1) break;
    }
  }
  return false;
}

__device__ __forceinline__ int descale(uint32_t acc) {
  return static_cast<int>(acc + 1024u) >> 11;
}

// JAX's gather on one index: negative counts from the end, then clamp.
__device__ __forceinline__ int gather_index(int i, int extent) {
  if (i < 0) i += extent;
  return min(max(i, 0), extent - 1);
}

// `_axis_samples` of one axis: the 16.16 step from the image's extent
// `size` (clamped to at least 1, so a zeroed geometry samples pixel 0),
// with floor division.
__device__ __forceinline__ int axis_ratio(int size, int S) {
  const int num = static_cast<int>(static_cast<uint32_t>(size - 1) << 16);
  const int den = S > 1 ? S - 1 : 1;
  int ratio = num / den;
  if (num % den != 0 && num < 0) --ratio;  // floor division
  return ratio;
}

// The samples of output position `o`: the two source indices (as the
// gather takes them) and the 16-bit weight; the second index is the first
// when the weight is 0.
__device__ __forceinline__ void axis_samples(int size, int ratio, int o, int extent, int& i0,
                                             int& i1, int& w) {
  const int fix = static_cast<int>(static_cast<uint32_t>(o) *
                                   static_cast<uint32_t>(ratio));
  const int a = fix >> 16;
  w = fix & 0xFFFF;
  const int b = min(a + 1, size - 1);
  i0 = gather_index(a, extent);
  i1 = w == 0 ? i0 : gather_index(b, extent);
}

// A block row to decode into a slot: `row` of its plane, `blocks` blocks
// wide (0: nothing to decode), into `dst`.
struct Job {
  int row, blocks;
  uint8_t* dst;
};

// One 8x8 block through the IDCT, by its 8 threads (one warp holds them),
// this one r: it dequantizes coefficient row r of `coef` (64 int16 in
// natural order) and takes the columns pass of that row; the rows pass
// then reads the intermediate rows from `scratch` and gives output rows x
// and 7 - x (x = r % 4), columns 4 (r / 4) to 4 (r / 4) + 3, to `dst`
// (the block's first pixel, rows `pitch` bytes apart). The basis is even
// or odd in x as u is (B[7 - x][u] = (-1)^u B[x][u]), so each pass sums
// the even and the odd u apart, once for x and 7 - x: half the products,
// and in uint32 the same sums, so the same bits.
__device__ __forceinline__ void idct_block(const int16_t* coef, const int32_t* quant, int r,
                                           int32_t* scratch, uint8_t* dst, int pitch,
                                           bool valid) {
  uint32_t c[8];
  if (valid) {
    const int4 raw = *reinterpret_cast<const int4*>(coef + r * 8);
    const int4* qp = reinterpret_cast<const int4*>(quant + r * 8);
    const int4 q0 = __ldg(qp), q1 = __ldg(qp + 1);
    const uint32_t w[4] = {static_cast<uint32_t>(raw.x), static_cast<uint32_t>(raw.y),
                           static_cast<uint32_t>(raw.z), static_cast<uint32_t>(raw.w)};
    const int32_t q[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int16_t coef_v = static_cast<int16_t>((w[v >> 1] >> ((v & 1) * 16)) & 0xffffu);
      c[v] = static_cast<uint32_t>(static_cast<int32_t>(coef_v)) * static_cast<uint32_t>(q[v]);
    }
  } else {
#pragma unroll
    for (int v = 0; v < 8; ++v) c[v] = 0;
  }
  // Columns pass: s1[r][y] = sum_v C[r][v] * B[y][v], for y and 7 - y.
  int32_t s1[8];
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    uint32_t even = 0, odd = 0;
#pragma unroll
    for (int v = 0; v < 8; v += 2) {
      even += c[v] * static_cast<uint32_t>(kBasis[y * 8 + v]);
      odd += c[v + 1] * static_cast<uint32_t>(kBasis[y * 8 + v + 1]);
    }
    s1[y] = descale(even + odd);
    s1[7 - y] = descale(even - odd);
  }
  __syncwarp();  // the block's last rows pass has read the scratch
  reinterpret_cast<int4*>(scratch + r * 8)[0] = make_int4(s1[0], s1[1], s1[2], s1[3]);
  reinterpret_cast<int4*>(scratch + r * 8)[1] = make_int4(s1[4], s1[5], s1[6], s1[7]);
  __syncwarp();
  // Rows pass: p[x][y] = sum_u B[x][u] * s1[u][y] for x and 7 - x, this
  // thread's four columns y, B's row x in registers.
  const int x = r & 3, y0 = (r >> 2) * 4;
  uint32_t bx[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) bx[u] = static_cast<uint32_t>(kBasis[x * 8 + u]);
  uint32_t even[4] = {0, 0, 0, 0}, odd[4] = {0, 0, 0, 0};
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int4 a = *reinterpret_cast<const int4*>(scratch + u * 8 + y0);
    const uint32_t row[4] = {static_cast<uint32_t>(a.x), static_cast<uint32_t>(a.y),
                             static_cast<uint32_t>(a.z), static_cast<uint32_t>(a.w)};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (u % 2 == 0) {
        even[k] += bx[u] * row[k];
      } else {
        odd[k] += bx[u] * row[k];
      }
    }
  }
  if (!valid) return;
  uint32_t top = 0, bottom = 0;  // rows x and 7 - x
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int pt = min(max(static_cast<int>(static_cast<uint32_t>(descale(even[k] + odd[k])) + 128u), 0), 255);
    const int pb = min(max(static_cast<int>(static_cast<uint32_t>(descale(even[k] - odd[k])) + 128u), 0), 255);
    top |= static_cast<uint32_t>(pt) << (8 * k);
    bottom |= static_cast<uint32_t>(pb) << (8 * k);
  }
  *reinterpret_cast<uint32_t*>(dst + x * pitch + y0) = top;
  *reinterpret_cast<uint32_t*>(dst + (7 - x) * pitch + y0) = bottom;
}

// The two slots of one kind, tagged t0 and t1 with the block rows they
// hold, take the rows a and b that a source row pair needs: a row already
// held stays, and a missing one replaces a row that neither needs and
// becomes a job (blocks = `blocks`). Every thread runs this on the same
// values, so the tags agree across the CTA.
__device__ __forceinline__ void claim(int& t0, int& t1, int a, int b, uint8_t* base,
                                      size_t slot_bytes, int blocks, Job (&jobs)[2]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int row = k == 0 ? a : b;
    jobs[k] = {row, 0, base};
    if ((k == 1 && row == a) || t0 == row || t1 == row) continue;
    if (t0 != a && t0 != b) {
      t0 = row;
      jobs[k] = {row, blocks, base};
    } else {
      t1 = row;
      jobs[k] = {row, blocks, base + slot_bytes};
    }
  }
}

__device__ __forceinline__ const uint8_t* slot_of(int t0, int row, const uint8_t* base,
                                                  size_t slot_bytes) {
  return base + (t0 == row ? 0 : slot_bytes);
}

struct Rgb {
  int r, g, b;
};

__device__ __forceinline__ Rgb ycc(int y, int cb, int cr) {
  cb -= 128;
  cr -= 128;
  Rgb out;
  out.r = min(max(y + ((91881 * cr + 32768) >> 16), 0), 255);
  out.g = min(max(y - ((22554 * cb + 46802 * cr + 32768) >> 16), 0), 255);
  out.b = min(max(y + ((116130 * cb + 32768) >> 16), 0), 255);
  return out;
}

__device__ __forceinline__ int mix(int a, int b, int w) {
  return a + (((b - a) * w) >> 16);
}

__device__ __forceinline__ Rgb mix(const Rgb& a, const Rgb& b, int w) {
  return {mix(a.r, b.r, w), mix(a.g, b.g, w), mix(a.b, b.b, w)};
}

// Block row x is held by the slot tagged t0 or t1.
__device__ __forceinline__ bool held(int t0, int t1, int x) { return t0 == x || t1 == x; }

// prefix[i] = the set bits of bits[0 .. i), for i in [0, count], by all
// threads of the CTA (warp sums in `warp_sums`).
__device__ void prefix_count(const uint32_t* bits, int* prefix, int count, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int first = 0; first < count; first += kThreads) {
    const int i = first + threadIdx.x;
    const int v = i < count ? __popc(bits[i]) : 0;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    int before = carry, chunk = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_sums[w] : 0;
      chunk += warp_sums[w];
    }
    if (i < count) prefix[i] = before + x - v;
    carry += chunk;
    __syncthreads();  // warp_sums is taken again
  }
  if (threadIdx.x == 0) prefix[count] = carry;
}

// The place of block column c among the sampled ones of its bitmap.
__device__ __forceinline__ int rank(const uint32_t* bits, const int* prefix, int c) {
  return prefix[c >> 5] + __popc(bits[c >> 5] & ((1u << (c & 31)) - 1u));
}

// `len` staged bytes to `d`, by threads t, t + n, ...: byte stores up to
// d's first 16-byte boundary, 16-byte stores, byte stores after the last.
// The staged bytes lie at d's alignment modulo 16.
__device__ __forceinline__ void copy_run(uint8_t* d, const uint8_t* st, int len, int t, int n) {
  const int head = min(static_cast<int>((16 - (reinterpret_cast<uintptr_t>(d) & 15)) & 15), len);
  const int body = (len - head) / 16;
  for (int i = t; i < head; i += n) d[i] = st[i];
  for (int i = t; i < body; i += n)
    reinterpret_cast<uint4*>(d + head)[i] = reinterpret_cast<const uint4*>(st + head)[i];
  for (int i = head + body * 16 + t; i < len; i += n) d[i] = st[i];
}

__global__ void __launch_bounds__(kThreads, 4)
    jpeg_decode_kernel(const int16_t* __restrict__ coef_y,
                       const int16_t* __restrict__ coef_cb,
                       const int16_t* __restrict__ coef_cr,
                       const int32_t* __restrict__ quant,
                       const int32_t* __restrict__ geom, int ybh, int ybw,
                       int cbh, int cbw, int S, int T, int R, int bands,
                       int tiles, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(ybw, cbw, T, R);
  int* s_lx0 = reinterpret_cast<int*>(smem);
  int* s_lx1 = s_lx0 + T;
  int* s_cx0 = s_lx1 + T;
  int* s_cx1 = s_cx0 + T;
  int* s_wx = s_cx1 + T;
  int* s_sy0 = reinterpret_cast<int*>(smem + L.rows);
  int* s_sy1 = s_sy0 + R;
  int* s_wy = s_sy1 + R;
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(smem + L.bits);  // luma, then chroma
  int* s_prefix = reinterpret_cast<int*>(smem + L.prefix);
  int* s_warp = reinterpret_cast<int*>(smem + L.warp);
  int* s_lists = reinterpret_cast<int*>(smem + L.lists);
  int32_t* s_scratch = reinterpret_cast<int32_t*>(smem + L.scratch);
  uint8_t* s_luma = smem + L.luma;
  uint8_t* s_chroma = smem + L.chroma;
  uint8_t* s_stage = smem + L.stage;

  const int n = blockIdx.x / (bands * tiles);
  const int band = (blockIdx.x / tiles) % bands, tile = blockIdx.x % tiles;
  const int oy0 = band * R, rows = min(R, S - oy0);
  const int ox0 = tile * T, cols = min(T, S - ox0);
  const int yh = ybh * 8, yw = ybw * 8;
  const int lp = L.kl * 8, cp = L.kc * 8;  // bytes of a slot's pixel row
  const size_t luma_slot = static_cast<size_t>(8) * lp;
  const size_t chroma_slot = static_cast<size_t>(16) * cp;  // Cb rows, then Cr rows
  const int words = L.wl + L.wc;
  const int tid = threadIdx.x;
  const int jb = tid >> 3, r8 = tid & 7;  // a decode's block and row
  const int32_t* quant_n = quant + static_cast<size_t>(n) * 3 * 64;

  // The sample tables, and the bitmap of the block columns the tile's
  // columns sample: luma column x lies in block x >> 3, its chroma (column
  // x >> 1) in chroma block x >> 4. Where the slots hold every block
  // column of the grid (the path), there is no bitmap: a column's place in
  // a slot's row is the column itself.
  const bool every_column = L.kl == ybw && L.kc == cbw;
  if (!every_column) {
    for (int i = tid; i < words; i += kThreads) s_bits[i] = 0;
    __syncthreads();
  }
  {
    const int width = max(__ldg(geom + n * 6 + 0), 1);
    const int height = max(__ldg(geom + n * 6 + 1), 1);
    const int ratio_x = axis_ratio(width, S), ratio_y = axis_ratio(height, S);
    for (int i = tid; i < cols; i += kThreads) {
      int a, b, w;
      axis_samples(width, ratio_x, ox0 + i, yw, a, b, w);
      s_lx0[i] = a;
      s_lx1[i] = b;
      s_wx[i] = w;
      if (every_column) {
        s_cx0[i] = a >> 1;
        s_cx1[i] = b >> 1;
      } else {
        atomicOr(s_bits + (a >> 8), 1u << ((a >> 3) & 31));
        atomicOr(s_bits + (b >> 8), 1u << ((b >> 3) & 31));
        atomicOr(s_bits + L.wl + (a >> 9), 1u << ((a >> 4) & 31));
        atomicOr(s_bits + L.wl + (b >> 9), 1u << ((b >> 4) & 31));
      }
    }
    for (int i = tid; i < rows; i += kThreads)
      axis_samples(height, ratio_y, oy0 + i, yh, s_sy0[i], s_sy1[i], s_wy[i]);
  }
  __syncthreads();
  int nl = ybw, nc = cbw;  // sampled block columns of luma and of chroma
  if (!every_column) {
    prefix_count(s_bits, s_prefix, words, s_warp);
    __syncthreads();
    // The lists of sampled block columns (luma from 0, chroma from nl),
    // and each column's samples as places in the slots' rows.
    nl = s_prefix[L.wl];
    nc = s_prefix[words] - nl;
    for (int i = tid; i < words; i += kThreads) {
      uint32_t word = s_bits[i];
      int at = s_prefix[i];
      const int base = 32 * (i < L.wl ? i : i - L.wl);
      while (word) {
        s_lists[at++] = base + __ffs(word) - 1;
        word &= word - 1;
      }
    }
    for (int i = tid; i < cols; i += kThreads) {
      const int a = s_lx0[i], b = s_lx1[i];
      const uint32_t* cbits = s_bits + L.wl;
      const int* cprefix = s_prefix + L.wl;
      s_lx0[i] = rank(s_bits, s_prefix, a >> 3) * 8 + (a & 7);
      s_lx1[i] = rank(s_bits, s_prefix, b >> 3) * 8 + (b & 7);
      s_cx0[i] = (rank(cbits, cprefix, a >> 4) - nl) * 8 + ((a >> 1) & 7);
      s_cx1[i] = (rank(cbits, cprefix, b >> 4) - nl) * 8 + ((b >> 1) & 7);
    }
    __syncthreads();
  }

  // Where the tile's bytes go: row r of the tile to dst0 + r * 3 S, staged
  // at stage0 + r * step, where step = 3 S modulo 16, so each staged row
  // lies at its output row's alignment modulo 16.
  const bool whole = cols == S;  // the band is one run of output bytes
  uint8_t* dst0 = out + ((static_cast<size_t>(n) * S + oy0) * S + ox0) * 3;
  const size_t dst_pitch = static_cast<size_t>(S) * 3;
  const int step = 3 * cols + ((3 * S - 3 * cols) & 15);
  uint8_t* stage0 = s_stage + (reinterpret_cast<uintptr_t>(dst0) & 15);

  // Runs of rows: the first row of a run claims the block rows it samples
  // (decoding those not held), and the run goes on while the next rows
  // sample only held block rows; then all the run's pixels at once.
  int lt0 = -1, lt1 = -1, ct0 = -1, ct1 = -1;  // block rows in the slots
  for (int r = 0; r < rows;) {
    const int sy0 = s_sy0[r], sy1 = s_sy1[r];
    // Luma jobs: the nl sampled blocks of Y; chroma jobs: nc of Cb, then
    // nc of Cr.
    Job luma[2], chroma[2];
    claim(lt0, lt1, sy0 >> 3, sy1 >> 3, s_luma, luma_slot, nl, luma);
    claim(ct0, ct1, sy0 >> 4, sy1 >> 4, s_chroma, chroma_slot, 2 * nc, chroma);
    const Job jobs[4] = {luma[0], luma[1], chroma[0], chroma[1]};
    const int total = jobs[0].blocks + jobs[1].blocks + jobs[2].blocks + jobs[3].blocks;
    if (total > 0) {
      __syncthreads();  // no thread still reads a slot
      // Decode the missing block rows, kBlocksPerPass blocks a pass: block
      // g of the jobs taken in order.
      for (int first = 0; first < total; first += kBlocksPerPass) {
        int g = first + jb;
        const bool valid = g < total;
        int k = 0;
#pragma unroll
        for (int j = 0; j < 3; ++j)
          if (k == j && g >= jobs[j].blocks) {
            g -= jobs[j].blocks;
            k = j + 1;
          }
        Job job = jobs[0];
#pragma unroll
        for (int j = 1; j < 4; ++j)
          if (k == j) job = jobs[j];
        const int16_t* coef = coef_y;
        const int32_t* q = quant_n;
        uint8_t* to = job.dst;
        int pitch = lp;
        if (!valid) {
          // no block: the thread only joins its warp's barriers
        } else if (k < 2) {
          const int col = every_column ? g : s_lists[g];
          coef = coef_y + ((static_cast<size_t>(n) * ybh + job.row) * ybw + col) * 64;
          to += g * 8;
        } else {
          const int plane = g >= nc ? 1 : 0;
          const int at = g - plane * nc;
          const int col = every_column ? at : s_lists[nl + at];
          coef = (plane ? coef_cr : coef_cb) +
                 ((static_cast<size_t>(n) * cbh + job.row) * cbw + col) * 64;
          q = quant_n + 64 * (1 + plane);
          to += plane * 8 * cp + at * 8;
          pitch = cp;
        }
        idct_block(coef, q, r8, s_scratch + jb * kStride, to, pitch, valid);
      }
      __syncthreads();
    }
    int end = r + 1;
    while (end < rows && held(lt0, lt1, s_sy0[end] >> 3) && held(lt0, lt1, s_sy1[end] >> 3) &&
           held(ct0, ct1, s_sy0[end] >> 4) && held(ct0, ct1, s_sy1[end] >> 4))
      ++end;

    // The run's pixels, a column a thread: the column's samples once, then
    // for each row four samples (fewer where a weight is 0), each converted
    // from YCbCr, mixed vertically and then horizontally.
    const int cr_off = 8 * cp;
    for (int ox = tid; ox < cols; ox += kThreads) {
      const int sx0 = s_lx0[ox], sx1 = s_lx1[ox], wx = s_wx[ox];
      const int cx0 = s_cx0[ox], cx1 = s_cx1[ox];
      uint8_t* o = stage0 + r * step + ox * 3;
      for (int rr = r; rr < end; ++rr, o += step) {
        const int y0 = s_sy0[rr], y1 = s_sy1[rr], wy = s_wy[rr];
        const uint8_t* l0 = slot_of(lt0, y0 >> 3, s_luma, luma_slot) + (y0 & 7) * lp;
        const uint8_t* c0 = slot_of(ct0, y0 >> 4, s_chroma, chroma_slot) + ((y0 >> 1) & 7) * cp;
        const Rgb a00 = ycc(l0[sx0], c0[cx0], c0[cr_off + cx0]);
        const Rgb a01 = sx1 == sx0 ? a00 : ycc(l0[sx1], c0[cx1], c0[cr_off + cx1]);
        Rgb v0 = a00, v1 = a01;
        if (y1 != y0) {
          const uint8_t* l1 = slot_of(lt0, y1 >> 3, s_luma, luma_slot) + (y1 & 7) * lp;
          const uint8_t* c1 =
              slot_of(ct0, y1 >> 4, s_chroma, chroma_slot) + ((y1 >> 1) & 7) * cp;
          const Rgb a10 = ycc(l1[sx0], c1[cx0], c1[cr_off + cx0]);
          const Rgb a11 = sx1 == sx0 ? a10 : ycc(l1[sx1], c1[cx1], c1[cr_off + cx1]);
          v0 = mix(a00, a10, wy);
          v1 = mix(a01, a11, wy);
        }
        const Rgb p = wx == 0 ? v0 : mix(v0, v1, wx);
        o[0] = static_cast<uint8_t>(p.r);
        o[1] = static_cast<uint8_t>(p.g);
        o[2] = static_cast<uint8_t>(p.b);
      }
    }
    r = end;
  }
  __syncthreads();
  // The tile to device memory: the band at once where it is one run of
  // bytes, else a warp a row.
  if (whole) {
    copy_run(dst0, stage0, rows * S * 3, tid, kThreads);
  } else {
    for (int r = tid >> 5; r < rows; r += kWarps)
      copy_run(dst0 + r * dst_pitch, stage0 + r * step, cols * 3, tid & 31, 32);
  }
}

}  // namespace

extern "C" int ldt_jpeg_decode(const int16_t* coef_y, const int16_t* coef_cb,
                               const int16_t* coef_cr, const int32_t* quant,
                               const int32_t* geom, int N, int ybh, int ybw,
                               int cbh, int cbw, int S, uint8_t* out,
                               cudaStream_t stream) {
  if (N <= 0 || S <= 0) return 0;
  if (ybh <= 0 || ybw <= 0 || cbh <= 0 || cbw <= 0 || 2 * cbh < ybh || 2 * cbw < ybw)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t vec = reinterpret_cast<uintptr_t>(coef_y) |
                        reinterpret_cast<uintptr_t>(coef_cb) |
                        reinterpret_cast<uintptr_t>(coef_cr) |
                        reinterpret_cast<uintptr_t>(quant);
  if (vec % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  int T = 0, R = 0;
  if (!pick_tile(ybw, cbw, S, T, R)) return kGridTooWide;
  const int bands = (S + R - 1) / R, tiles = (S + T - 1) / T;
  const long long grid = static_cast<long long>(N) * bands * tiles;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = layout(ybw, cbw, T, R).total;
  cudaError_t err = cudaFuncSetAttribute(
      jpeg_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  jpeg_decode_kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      coef_y, coef_cb, coef_cr, quant, geom, ybh, ybw, cbh, cbw, S, T, R, bands, tiles, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ldt_jpeg_widest_grid(int S) {
  if (S <= 0) return 0;
  int lo = 0, hi = 1 << 30, T = 0, R = 0;  // lo fits (or is 0), hi does not
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (pick_tile(mid, (mid + 1) / 2, S, T, R)) lo = mid; else hi = mid;
  }
  return lo;
}

extern "C" const char* ldt_jpeg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
