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
// sequence 0 with k < 0. So the pack needs no search: one block per
// sequence, its threads striding over the positions it owns. A negative
// destination counts from the end of the grid and one past it is dropped,
// as JAX's scatter with mode="drop" treats them. Offsets that fall are not
// taken (the search JAX makes over them has no meaning either). The
// planner's runs are disjoint, so no cell is written twice and the result
// does not depend on the order of the blocks. The unpack is one thread per
// flat position with the same search as JAX (an upper bound over the
// offsets).
//
// Bound: bytes. Integer copies only: the pack reads the tokens it places
// (not the page's tail past them), the offsets and the plan once and writes
// 13 bytes a grid cell (three int32 and one int8); the unpack reads the grid
// cells holding those tokens and writes the page. At
// the causal-LM path's sizes (64 sequences, about 24 x 1024 cells) the
// launch, not the bytes, sets the time.
//
// C interface (bound with ctypes by ops/token_device.py):
//   int ldt_token_pack(const int32_t* values, int cap, const int32_t* offsets,
//                      const int32_t* slot, const int32_t* start, int n,
//                      int rows, int L, uint8_t* out, cudaStream_t);
//     out holds grid, segment ids and positions (int32 [rows*L] each) and
//     the mask (int8 [rows*L]), in that order; the call zeroes it first.
//   int ldt_token_unpack(const int32_t* grid, int rows, int L,
//                        const int32_t* offsets, const int32_t* slot,
//                        const int32_t* start, int n, int32_t* out,
//                        int capacity, cudaStream_t);
// each returns the cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPackThreads = 256;
constexpr int kUnpackThreads = 256;

__global__ void __launch_bounds__(kPackThreads)
    token_pack_kernel(const int32_t* __restrict__ values, int cap,
                      const int32_t* __restrict__ offsets,
                      const int32_t* __restrict__ slot,
                      const int32_t* __restrict__ start, int n, int L,
                      long long cells, int32_t* __restrict__ grid,
                      int32_t* __restrict__ seg, int32_t* __restrict__ pos,
                      int8_t* __restrict__ mask) {
  const int i = blockIdx.x;
  const int lo = offsets[i];
  const int len = min(offsets[i + 1] - lo, L);  // live tokens of sequence i
  const int end = min(offsets[n], cap);         // positions JAX considers
  const long long base =
      static_cast<long long>(slot[i]) * L + static_cast<long long>(start[i]);
  // Positions before offsets[0] fall to sequence 0 with k < 0, as the
  // clipped search gives them.
  const int first = i == 0 ? 0 : max(lo, 0);
  for (int p = first + threadIdx.x; p < end; p += kPackThreads) {
    const int k = p - lo;
    if (k >= len) break;
    long long dest = base + k;
    if (dest < 0) dest += cells;  // JAX counts a negative index from the end
    if (dest < 0 || dest >= cells) continue;
    grid[dest] = values[p];
    seg[dest] = i + 1;
    pos[dest] = k;
    mask[dest] = 1;
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
  if (rows <= 0 || L <= 0 || cap < 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cells = static_cast<long long>(rows) * L;
  const cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(cells) * 13, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  int32_t* grid = reinterpret_cast<int32_t*>(out);
  token_pack_kernel<<<n, kPackThreads, 0, stream>>>(
      values, cap, offsets, slot, start, n, L, cells, grid, grid + cells,
      grid + 2 * cells, reinterpret_cast<int8_t*>(grid + 3 * cells));
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
