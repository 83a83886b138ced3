// K9 window_scores_from: retile a score matrix into its window planes and
// emit the window maxima.
//
//   sw_t[j, b, :] = scores[b, 128 * j : 128 * j + 128]
//   wmax[b, j]    = max(scores[b, 128 * j : 128 * j + 128])
//
// for a contiguous row-major [B, C] f32 matrix with C % 128 == 0; sw_t is
// [C / 128, B, 128] and wmax [B, C / 128], both contiguous.
//
// Replaces the Pallas kernel sibrar_tpu/ops/pallas_window.py:147
// window_scores_from (body _retile_kernel :74). On the TPU the tiling keeps
// users on sublanes and window lanes on lanes on both sides of the copy.
// On Hopper a window is 512 contiguous bytes in both layouts, so the retile
// is a permutation of 512-byte chunks.
//
// Bound on the H100: bytes. At B = 1024, C = 100,352 it reads and writes
// 411 MB each (plus 3.2 MB of maxima), 0.247 ms at 3.35 TB/s. Design: one
// warp per chunk, taken in source order so a block's reads are one run;
// each lane moves one float4 with a coalesced load and store, and the warp
// reduces the maximum with shuffles (fmax_nan: a NaN lane gives a NaN
// maximum, as JAX's max).
#include <cuda_runtime.h>
#include <stdint.h>

#include "fmax_nan.cuh"

namespace {

constexpr int W = 128;
constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
window_retile_kernel(const float* __restrict__ scores, int B, int nw,
                     float* __restrict__ sw_t, float* __restrict__ wmax) {
  const int lane = threadIdx.x % 32;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * WARPS
                    + threadIdx.x / 32;  // source window b * nw + j
  if (w >= static_cast<int64_t>(B) * nw) return;
  const int64_t b = w / nw;
  const int64_t j = w - b * nw;
  const float4 v = reinterpret_cast<const float4*>(scores + w * W)[lane];
  reinterpret_cast<float4*>(sw_t + (j * B + b) * W)[lane] = v;
  float m = sibrar::fmax_nan(sibrar::fmax_nan(v.x, v.y),
                             sibrar::fmax_nan(v.z, v.w));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = sibrar::fmax_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) wmax[w] = m;
}

}  // namespace

extern "C" int sibrar_window_retile(const void* scores, int B, int nw,
                                    void* sw_t, void* wmax, void* stream) {
  const long long n = static_cast<long long>(B) * nw;
  if (n == 0) return 0;
  const long long blocks = (n + WARPS - 1) / WARPS;
  window_retile_kernel<<<static_cast<unsigned>(blocks), WARPS * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), B, nw, static_cast<float*>(sw_t),
      static_cast<float*>(wmax));
  return static_cast<int>(cudaGetLastError());
}
