// K3: ragged token pack and its inverse, for packed causal/masked LM.
//
// Replaces the JAX package's `ops/token_device.py` `pack_token_batch` (:67)
// and `unpack_token_batch` (:117), two jitted scatters/gathers. The host
// ships a variable-length column as a flat int32 values page (zero tail up
// to a power-of-two capacity), its [n+1] offsets and the first-fit-
// decreasing plan (slot, start per sequence). The pack places sequence i's
// first min(len_i, L) tokens at grid[slot_i * L + start_i + k] and writes,
// at the same cells, its 1-based segment id, the position k and a 1 in the
// int8 attention mask. Cells no sequence covers stay 0. The unpack gathers
// the flat page back from the grid, zero past the live tokens.
//
// The JAX pack finds each flat position's sequence by
// searchsorted(offsets, p, side="right") - 1, clipped to [0, n-1], keeps p
// where p < offsets[n] and k = p - offsets[seq] < min(len, L), and drops
// the rest (and any destination past the grid). For offsets that start at
// 0 and never fall (what the decoder emits) that is: sequence i owns
// p in [offsets[i], offsets[i] + min(len_i, L)), clipped to the page, and an
// empty sequence owns nothing; positions before a nonzero offsets[0] fall to
// sequence 0 with k < 0. So each sequence's positions are one range, and
// their destinations slot_i * L + start_i + k one flat run, which may cross
// a row's end. A negative destination counts from the end of the grid and
// one still outside [0, rows * L) is dropped, as JAX's scatter with
// mode="drop" treats them, so a run is at most two pieces of the grid: the
// part below 0 (moved up by rows * L) and the part inside. Offsets that
// fall are not taken (the search JAX makes over them has no meaning
// either).
//
// Pack design: one launch, no memset. Each CTA owns a tile of kPackTile
// cells, kPackCells consecutive cells a thread. It walks the plan in chunks
// of kPackThreads sequences: each thread turns one sequence into its pieces,
// keeps those that meet the tile, and a block scan packs them, in sequence
// order, into a list in shared memory; every thread then tests its cells
// against the list. Once the plan is done, each thread writes each of its
// cells exactly once, in all four outputs: the token, the 1-based segment
// id, k and 1 where a piece covers the cell, 0 everywhere else, as 16-byte
// (mask: 4-byte) stores where the grid's cell count is a multiple of 4. The
// planner's runs are disjoint; where runs overlap (no planner emits that,
// and JAX's scatter leaves the order open), the last piece in the list
// wins: the higher sequence, and within one sequence the part inside the
// grid over the part moved up. The unpack is one thread per flat position
// with the same search as JAX (an upper bound over the offsets).
//
// Bound: bytes. Integer copies only: the pack reads the tokens it places
// (not the page's tail past them), the offsets and the plan once and writes
// 13 bytes a grid cell (three int32 and one int8); the unpack reads the grid
// cells holding those tokens and writes the page. At the causal-LM path's
// sizes (64 sequences, 24 x 1024 cells: 24 CTAs) the launch, not the bytes,
// sets the time.
//
// C interface (bound with ctypes by ops/token_device.py):
//   int ldt_token_pack(const int32_t* values, int cap, const int32_t* offsets,
//                      const int32_t* slot, const int32_t* start, int n,
//                      int rows, int L, uint8_t* out, cudaStream_t);
//     out holds grid, segment ids and positions (int32 [rows*L] each) and
//     the mask (int8 [rows*L]), in that order; the kernel writes all of it.
//   int ldt_token_unpack(const int32_t* grid, int rows, int L,
//                        const int32_t* offsets, const int32_t* slot,
//                        const int32_t* start, int n, int32_t* out,
//                        int capacity, cudaStream_t);
// each returns the cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPackThreads = 256;  // also the plan's chunk, in sequences
constexpr int kPackCells = 4;      // consecutive cells a thread
constexpr int kPackTile = kPackThreads * kPackCells;
constexpr int kUnpackThreads = 256;

// A piece of a sequence's run inside a tile: cells [a, b), and the flat
// position of cell c is c + pofs.
struct Piece {
  int a, b, pofs, lo, seq;
};

// Exclusive prefix sum of v over the block, and the block's total.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int& total) {
  constexpr int kWarps = kPackThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  total = warp_sums[kWarps - 1];
  return (warp ? warp_sums[warp - 1] : 0) + x - v;
}

__global__ void __launch_bounds__(kPackThreads)
    token_pack_kernel(const int32_t* __restrict__ values, int cap,
                      const int32_t* __restrict__ offsets,
                      const int32_t* __restrict__ slot,
                      const int32_t* __restrict__ start, int n, int L,
                      int cells, int vec, int32_t* __restrict__ grid,
                      int32_t* __restrict__ seg, int32_t* __restrict__ pos,
                      int8_t* __restrict__ mask) {
  __shared__ Piece pieces[2 * kPackThreads];
  __shared__ int warp_sums[kPackThreads / 32];
  const int t0 = blockIdx.x * kPackTile;
  const int t1 = min(t0 + kPackTile, cells);
  const int c0 = t0 + threadIdx.x * kPackCells;
  const int end = n > 0 ? min(offsets[n], cap) : 0;  // positions JAX keeps
  int p[kPackCells], k[kPackCells], id[kPackCells];
#pragma unroll
  for (int q = 0; q < kPackCells; ++q) p[q] = k[q] = id[q] = 0;

  for (int base_i = 0; base_i < n; base_i += kPackThreads) {
    // This thread's sequence as at most two pieces that meet the tile: the
    // part of its run below 0, moved up by `cells`, then the part inside.
    Piece low{}, in{};
    bool has_low = false, has_in = false;
    const int i = base_i + threadIdx.x;
    if (i < n) {
      const int lo = offsets[i];
      const int len = min(offsets[i + 1] - lo, L);
      // Positions before offsets[0] fall to sequence 0 with k < 0.
      const int pa = i == 0 ? 0 : max(lo, 0);
      const int pb = min(end, lo + len);
      if (pa < pb) {
        // Position p goes to flat cell shift + p, before the wrap.
        const long long shift =
            static_cast<long long>(slot[i]) * L + start[i] - lo;
        const long long da = shift + pa, db = shift + pb;
        long long a = max(max(da, -1LL * cells) + cells,
                          static_cast<long long>(t0));
        long long b = min(min(db, 0LL) + cells, static_cast<long long>(t1));
        has_low = a < b;
        low = {static_cast<int>(a), static_cast<int>(b),
               static_cast<int>(-(shift + cells)), lo, i + 1};
        a = max(da, static_cast<long long>(t0));
        b = min(db, static_cast<long long>(t1));
        has_in = a < b;
        in = {static_cast<int>(a), static_cast<int>(b),
              static_cast<int>(-shift), lo, i + 1};
      }
    }
    int total;
    const int at = block_scan(has_low + has_in, warp_sums, total);
    if (has_low) pieces[at] = low;
    if (has_in) pieces[at + has_low] = in;
    __syncthreads();
    for (int j = 0; j < total; ++j) {
      const Piece r = pieces[j];
#pragma unroll
      for (int q = 0; q < kPackCells; ++q) {
        const int c = c0 + q;
        if (c >= r.a && c < r.b) {
          p[q] = c + r.pofs;
          k[q] = p[q] - r.lo;
          id[q] = r.seq;
        }
      }
    }
    __syncthreads();  // the list is read before the next chunk writes it
  }

  int v[kPackCells];
#pragma unroll
  for (int q = 0; q < kPackCells; ++q) v[q] = id[q] ? values[p[q]] : 0;
  if (vec && c0 + kPackCells <= t1) {
    *reinterpret_cast<int4*>(grid + c0) = make_int4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<int4*>(seg + c0) =
        make_int4(id[0], id[1], id[2], id[3]);
    *reinterpret_cast<int4*>(pos + c0) = make_int4(k[0], k[1], k[2], k[3]);
    *reinterpret_cast<char4*>(mask + c0) =
        make_char4(id[0] != 0, id[1] != 0, id[2] != 0, id[3] != 0);
    return;
  }
#pragma unroll
  for (int q = 0; q < kPackCells; ++q) {
    const int c = c0 + q;
    if (c >= t1) break;
    grid[c] = v[q];
    seg[c] = id[q];
    pos[c] = k[q];
    mask[c] = id[q] != 0;
  }
}

// searchsorted(offsets[0..n], p, side="right") - 1, clipped to [0, n-1].
__device__ __forceinline__ int owner(const int32_t* __restrict__ offsets,
                                     int n, int p) {
  int a = 0, b = n + 1;  // the first index with offsets[idx] > p is in [a, b]
  while (a < b) {
    const int m = (a + b) >> 1;
    if (offsets[m] <= p) {
      a = m + 1;
    } else {
      b = m;
    }
  }
  return min(max(a - 1, 0), n - 1);
}

__global__ void __launch_bounds__(kUnpackThreads)
    token_unpack_kernel(const int32_t* __restrict__ grid, long long cells,
                        int L, const int32_t* __restrict__ offsets,
                        const int32_t* __restrict__ slot,
                        const int32_t* __restrict__ start, int n,
                        int32_t* __restrict__ out, int capacity) {
  const int p = blockIdx.x * kUnpackThreads + threadIdx.x;
  if (p >= capacity) return;
  const int s = owner(offsets, n, p);
  const int k = p - offsets[s];
  const int len = min(offsets[s + 1] - offsets[s], L);
  const bool valid = p < offsets[n] && k < len;
  long long src =
      static_cast<long long>(slot[s]) * L + static_cast<long long>(start[s]) +
      k;
  src = src < 0 ? 0 : (src >= cells ? cells - 1 : src);
  out[p] = valid ? grid[src] : 0;
}

}  // namespace

extern "C" int ldt_token_pack(const int32_t* values, int cap,
                              const int32_t* offsets, const int32_t* slot,
                              const int32_t* start, int n, int rows, int L,
                              uint8_t* out, cudaStream_t stream) {
  if (rows <= 0 || L <= 0 || cap < 0 || n < 0 ||
      static_cast<long long>(rows) * L > (1 << 29))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cells = rows * L;
  int32_t* grid = reinterpret_cast<int32_t*>(out);
  const int vec = cells % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  token_pack_kernel<<<(cells + kPackTile - 1) / kPackTile, kPackThreads, 0,
                      stream>>>(
      values, cap, offsets, slot, start, n, L, cells, vec, grid, grid + cells,
      grid + 2 * static_cast<size_t>(cells),
      reinterpret_cast<int8_t*>(grid + 3 * static_cast<size_t>(cells)));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ldt_token_unpack(const int32_t* grid, int rows, int L,
                                const int32_t* offsets, const int32_t* slot,
                                const int32_t* start, int n, int32_t* out,
                                int capacity, cudaStream_t stream) {
  if (rows <= 0 || L <= 0 || capacity < 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (capacity == 0) return 0;
  if (n == 0) {
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(capacity) * sizeof(int32_t), stream));
  }
  const int blocks = (capacity + kUnpackThreads - 1) / kUnpackThreads;
  token_unpack_kernel<<<blocks, kUnpackThreads, 0, stream>>>(
      grid, static_cast<long long>(rows) * L, L, offsets, slot, start, n,
      out, capacity);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ldt_token_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
