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
// runs out of larger values the Pallas kernel repeats an index; here no
// element is extracted twice.
//
// Bound on the H100: bytes (the row read once, 411 MB at R = 1024,
// n = 100,352: 0.123 ms at 3.35 TB/s). k serial rounds per row are a
// latency chain; this kernel reads the row once and then selects by a
// threshold. One block per row; a value is compared as a 32-bit key in the
// total order, and an element as the 64-bit word (key, ~index), so the
// larger word comes first and no two elements tie.
//   1. Read the row in aligned 16-byte loads, 8 windows of 128 values in
//      flight per warp, and keep each window's maximum key in shared memory
//      (windows are cut from the row's 16-byte aligned start, so each holds
//      at least one of the row's values).
//   2. T = the k-th largest window key (radix select, 8 bits a pass): k
//      windows hold a key >= T, so the k-th largest element's key is >= T,
//      and every element of the top k lies in a window whose key is >= T.
//   3. Reread those windows (about k of them) and gather every element with
//      key >= T into shared memory.
//   4. Sort the gathered words (bitonic, descending) and write the first k.
// When more than CAP elements pass T (a row of many equal values: a
// constant row, -inf rows, all-ones NaNs) or k > CAP, the block takes the
// exact path instead: batch by batch of at most CAP, a radix select of the
// batch's last word over the whole row (8 passes over the row, in L2), a
// gather of the words between it and the previous batch's last, a sort.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sort.cuh"

namespace {

constexpr int W = 128;        // values per window
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int DEPTH = 8;      // windows in flight per warp, step 1
constexpr int CAP = 2048;     // elements a block sorts in shared memory
constexpr unsigned FULL = 0xffffffffu;
typedef unsigned long long u64;

// unsigned key in lax.top_k's total order of floats, and back
__device__ __forceinline__ unsigned key_of(float f) {
  const unsigned bits = __float_as_uint(f);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// the element's word: the larger key first, then the lower index
__device__ __forceinline__ u64 word_of(unsigned key, int e) {
  return (static_cast<u64>(key) << 32) |
         (0xffffffffu - static_cast<unsigned>(e));
}

struct Shared {
  u64 cand[CAP];
  int hist[256];
  u64 prefix;
  int left, count;
};

// The k-th largest (1 <= k <= their number) of the keys key_at(i, v) gives
// for i < n (false: no key), by radix select over 8-bit digits from the
// top; each pass histograms the keys that share the digits chosen so far.
// Every thread calls it; a warp counts equal digits with one atomic.
template <typename T, typename KeyAt>
__device__ T select_kth(KeyAt key_at, int n, int k, Shared& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T prefix = 0;
  int left = k;
  for (int shift = 8 * sizeof(T) - 8; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += THREADS) sm.hist[i] = 0;
    __syncthreads();
    const T high = shift + 8 < 8 * static_cast<int>(sizeof(T))
                       ? ~T(0) << (shift + 8)
                       : T(0);
    for (int base = warp * 32; base < n; base += THREADS) {
      T v;
      int digit = -1;
      if (base + lane < n && key_at(base + lane, v) && (v & high) == prefix)
        digit = static_cast<int>((v >> shift) & 255);
      const unsigned peers = __match_any_sync(FULL, digit);
      if (digit >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&sm.hist[digit], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {  // lane l holds digits 255 - 8 l down to 248 - 8 l
      int c[8], sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        c[q] = sm.hist[255 - 8 * lane - q];
        sum += c[q];
      }
      int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += o;
      }
      int before = incl - sum;
      if (before < left && left <= incl) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (before < left && left <= before + c[q]) {
            sm.prefix = prefix | (static_cast<T>(255 - 8 * lane - q) << shift);
            sm.left = left - before;
          }
          before += c[q];
        }
      }
    }
    __syncthreads();
    prefix = static_cast<T>(sm.prefix);
    left = sm.left;
  }
  return prefix;
}

// Writes sm.cand[0, m) (sorted) to the outputs out0, ..., out0 + m - 1.
__device__ __forceinline__ void emit(const Shared& sm, int m, int64_t out0,
                                     float* vals, long long* idxs) {
  for (int i = threadIdx.x; i < m; i += THREADS) {
    const u64 w = sm.cand[i];
    vals[out0 + i] = value_of(static_cast<unsigned>(w >> 32));
    idxs[out0 + i] = 0xffffffffu - static_cast<unsigned>(w);
  }
}

// Appends `word` (where `take`) to sm.cand with one shared atomic per warp;
// positions from CAP on are counted, not stored. Every lane calls it.
__device__ __forceinline__ void append(Shared& sm, bool take, u64 word) {
  const int lane = threadIdx.x & 31;
  const unsigned ballot = __ballot_sync(FULL, take);
  if (!ballot) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(&sm.count, __popc(ballot));
  base = __shfl_sync(FULL, base, 0);
  const int pos = base + __popc(ballot & ((1u << lane) - 1u));
  if (take && pos < CAP) sm.cand[pos] = word;
}

__global__ void __launch_bounds__(THREADS, 8)
exact_topk_kernel(const float* __restrict__ x, int n, int k,
                  float* __restrict__ vals, long long* __restrict__ idxs) {
  extern __shared__ unsigned wkey[];  // [nw] each window's maximum key
  __shared__ Shared sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* row = x + static_cast<int64_t>(blockIdx.x) * n;
  const int64_t out0 = static_cast<int64_t>(blockIdx.x) * k;
  const uintptr_t a = reinterpret_cast<uintptr_t>(row);
  const int lead = static_cast<int>((a & 15u) / 4);  // values before row[0]
  const float4* a0 = reinterpret_cast<const float4*>(a - 4 * lead);
  const int nw = (lead + n + W - 1) / W;

  // 1. window keys: lane q of window j holds values 128 j + 4 q - lead + i
  for (int j0 = warp * DEPTH; j0 < nw; j0 += WARPS * DEPTH) {
    float4 v[DEPTH];
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int e = (j0 + d) * W + 4 * lane - lead;
      if (j0 + d < nw && e < n) v[d] = a0[(j0 + d) * 32 + lane];
    }
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int e = (j0 + d) * W + 4 * lane - lead;
      unsigned mx = 0u;
      if (j0 + d < nw && e < n) {
        const float f[4] = {v[d].x, v[d].y, v[d].z, v[d].w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (e + i >= 0 && e + i < n) mx = max(mx, key_of(f[i]));
      }
      mx = __reduce_max_sync(FULL, mx);
      if (lane == 0 && j0 + d < nw) wkey[j0 + d] = mx;
    }
  }
  if (threadIdx.x == 0) sm.count = 0;
  __syncthreads();

  // 2. the threshold: every element passes when k exceeds the windows
  unsigned t = 0u;
  if (k <= nw)
    t = select_kth<unsigned>(
        [&](int i, unsigned& v) {
          v = wkey[i];
          return true;
        },
        nw, k, sm);

  // 3. the elements of key >= t, from the windows of key >= t
  if (k <= CAP) {
    for (int g0 = warp * 32; g0 < nw; g0 += WARPS * 32) {
      unsigned todo =
          __ballot_sync(FULL, g0 + lane < nw && wkey[g0 + lane] >= t);
      while (todo) {
        int js[DEPTH];
        float4 v[DEPTH];
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) {  // up to DEPTH windows in flight
          js[d] = -1;
          if (todo) {
            js[d] = g0 + __ffs(todo) - 1;
            todo &= todo - 1;
            if (js[d] * W + 4 * lane - lead < n) v[d] = a0[js[d] * 32 + lane];
          }
        }
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) {
          if (js[d] < 0) break;
          const int e = js[d] * W + 4 * lane - lead;
          const float f[4] = {v[d].x, v[d].y, v[d].z, v[d].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool in = e + i >= 0 && e + i < n;
            const unsigned key = in ? key_of(f[i]) : 0u;
            append(sm, in && key >= t, word_of(key, e + i));
          }
        }
      }
    }
  }
  __syncthreads();
  const int found = sm.count;
  if (k <= CAP && found <= CAP) {  // 4. sort and write the first k
    sibrar::block_sort<true>(sm.cand, found);
    emit(sm, k, out0, vals, idxs);
    return;
  }

  // the exact path: batches of CAP, each below the previous batch's last
  u64 below = 0;  // exclusive bound of the batch (0: none yet)
  for (int done = 0; done < k; done += CAP) {
    const int m = min(CAP, k - done);
    const bool bounded = done > 0;
    auto word_at = [&](int i, u64& v) {
      v = word_of(key_of(row[i]), i);
      return !bounded || v < below;
    };
    const u64 last = select_kth<u64>(word_at, n, m, sm);
    if (threadIdx.x == 0) sm.count = 0;
    __syncthreads();
    for (int base = warp * 32; base < n; base += THREADS) {
      u64 v = 0;
      const bool take =
          base + lane < n && word_at(base + lane, v) && v >= last;
      append(sm, take, v);
    }
    __syncthreads();
    sibrar::block_sort<true>(sm.cand, m);
    emit(sm, m, out0 + done, vals, idxs);
    below = last;
    __syncthreads();
  }
}

}  // namespace

// Shared memory: the window keys (4 bytes per 128 values, dynamic) and the
// 17 KB of buffers; above 48 KB in all the dynamic size is allowed first.
extern "C" int sibrar_exact_topk(const void* x, int R, int n, int k,
                                 void* vals, void* idxs, void* stream) {
  if (R == 0 || k == 0) return 0;
  if (k > n) return static_cast<int>(cudaErrorInvalidValue);
  const int nw = (n + 3 + W - 1) / W;  // the most windows a row can cut
  const size_t dyn = static_cast<size_t>(nw) * 4;
  static size_t allowed = 48 * 1024 - sizeof(Shared);
  if (dyn > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        exact_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = dyn;
  }
  exact_topk_kernel<<<R, THREADS, dyn, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, k, static_cast<float*>(vals),
      static_cast<long long*>(idxs));
  return static_cast<int>(cudaGetLastError());
}
