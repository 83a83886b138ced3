// K13 exact_topk: exact per-row top-k of x [R, n] in lax.top_k's order.
//
//   vals[r, t], idx[r, t]: the t-th largest value of row r and its index;
//   equal values go to the lower index first; indices are distinct and < n.
//
// The order is lax.top_k's total order on floats: -0.0 below +0.0, a NaN
// with the sign bit clear above +inf.
//
// Replaces the Pallas kernel sibrar_tpu/ops/pallas_topk.py:77 (entry
// exact_topk :102, body :45): a VMEM copy of each row, its 128-lane window
// maxima, and k rounds of (argmax over the maxima, argmax in that window,
// mask the element with -inf, refresh that window's max). Masking with -inf
// ties the extracted element with the row's own -inf entries, so once a row
// runs out of larger values the Pallas kernel finds an extracted lane again
// and repeats an index. Here an extracted lane is a set bit instead.
//
// Bound on the H100: bytes (the row read once, 411 MB at R = 1024,
// n = 100,352), but the k rounds are a serial chain per row, so latency
// holds it in practice. Design: one block per row; a 100,352-float row
// (392 KB) does not fit the 227 KB of shared memory, so the row stays in
// device memory, read only, and shared memory holds the window maxima (784
// words) and the extracted-lane bitmask (12.5 KB). Values are compared as
// 32-bit keys in the total order; key 0 marks a window or lane with nothing
// left. Each round: a block argmax over the windows' keys (the lowest window
// on ties), then one warp finds the lowest live lane of that window holding
// its key, sets the lane's bit, and recomputes the window's key over its
// live lanes. The NaN of all ones also has key 0: once only such lanes are
// left, every window's key is 0 and the argmax may land on a used-up
// window; the warp then takes the lowest live lane of the whole row from
// the bitmask, which is the next element in lax.top_k's order.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int W = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
typedef unsigned long long u64;

// unsigned key in lax.top_k's total order of floats
__device__ __forceinline__ unsigned key_of(float f) {
  const unsigned bits = __float_as_uint(f);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

// larger key first, then the lower window
__device__ __forceinline__ u64 pack(unsigned key, int w) {
  return (static_cast<u64>(key) << 32) |
         (0xffffffffu - static_cast<unsigned>(w));
}

__device__ __forceinline__ u64 warp_max(u64 p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const u64 q = __shfl_xor_sync(FULL, p, off);
    p = q > p ? q : p;
  }
  return p;
}

__global__ void __launch_bounds__(THREADS)
exact_topk_kernel(const float* __restrict__ x, int n, int k,
                  float* __restrict__ vals, long long* __restrict__ idxs) {
  extern __shared__ unsigned smem[];
  __shared__ u64 partial[WARPS];
  const int nw = (n + W - 1) / W;
  unsigned* wkey = smem;        // [nw] key of each window's live maximum
  unsigned* taken = smem + nw;  // [nw * 4] bit e % 32 of word e / 32
  const float* row = x + static_cast<int64_t>(blockIdx.x) * n;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  for (int i = tid; i < nw * 4; i += THREADS) taken[i] = 0u;
  for (int w = warp; w < nw; w += WARPS) {  // one warp per window
    unsigned mx = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = w * W + q * 32 + lane;
      if (e < n) mx = max(mx, key_of(row[e]));
    }
    mx = __reduce_max_sync(FULL, mx);
    if (lane == 0) wkey[w] = mx;
  }
  __syncthreads();

  for (int t = 0; t < k; ++t) {
    u64 p = 0;
    for (int w = tid; w < nw; w += THREADS) {
      const u64 q = pack(wkey[w], w);
      p = q > p ? q : p;
    }
    p = warp_max(p);
    if (lane == 0) partial[warp] = p;
    __syncthreads();
    if (warp == 0) {
      p = warp_max(lane < WARPS ? partial[lane] : 0);
      const unsigned wk = static_cast<unsigned>(p >> 32);
      const int w = static_cast<int>(0xffffffffu - static_cast<unsigned>(p));
      unsigned keys[4];
      int first = INT_MAX;
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // element w*128 + q*32 + lane: bit lane
        const int e = w * W + q * 32 + lane;
        const bool live = e < n && !((taken[w * 4 + q] >> lane) & 1u);
        keys[q] = live ? key_of(row[e]) : 0u;
        if (live && keys[q] == wk && first == INT_MAX) first = e;
      }
      first = __reduce_min_sync(FULL, first);
      for (int base = 0; first == INT_MAX && base < nw * 4; base += 32) {
        const int i = base + lane;  // word i holds elements 32 i .. 32 i + 31
        const int left = n - i * 32;
        unsigned free_bits = 0u;
        if (left > 0)
          free_bits = ~taken[i] & (left >= 32 ? FULL : (1u << left) - 1u);
        const unsigned has = __ballot_sync(FULL, free_bits != 0u);
        if (has) {
          const int src = __ffs(has) - 1;
          const unsigned bits = __shfl_sync(FULL, free_bits, src);
          first = (base + src) * 32 + __ffs(bits) - 1;
        }
      }
      unsigned rest = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (w * W + q * 32 + lane != first) rest = max(rest, keys[q]);
      rest = __reduce_max_sync(FULL, rest);
      if (lane == 0 && first != INT_MAX) {  // none left only if k > n
        taken[first / 32] |= 1u << (first % 32);
        wkey[w] = rest;
        const int64_t o = static_cast<int64_t>(blockIdx.x) * k + t;
        vals[o] = row[first];
        idxs[o] = first;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int sibrar_exact_topk(const void* x, int R, int n, int k,
                                 void* vals, void* idxs, void* stream) {
  if (R == 0 || k == 0) return 0;
  // window keys and bitmask: 5 words per window (20 B per 128 values)
  const long long smem = static_cast<long long>((n + W - 1) / W) * 5 * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        exact_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  exact_topk_kernel<<<R, THREADS, static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, k, static_cast<float*>(vals),
      static_cast<long long*>(idxs));
  return static_cast<int>(cudaGetLastError());
}
