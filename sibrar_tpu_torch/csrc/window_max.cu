// K8 window_max: the maxima of the 128-wide windows of a score matrix.
//
//   out[b, j] = max(scores[b, 128 * j : 128 * j + 128])
//
// over a contiguous row-major [B, C] f32 matrix with C % 128 == 0, so the
// B * C / 128 windows are consecutive 512-byte runs and out[b, j] is entry
// b * C / 128 + j of both the window list and the [B, C / 128] output.
//
// Replaces the Pallas kernel sibrar_tpu/ops/pallas_peel.py:302 window_max
// (body :289). Its tail of fewer than 128 windows, reduced by XLA outside
// the kernel, is an artifact of the TPU's lane rule; here every window is
// covered by the one launch.
//
// Bound on the H100: bytes. At B = 1024, C = 100,352 it reads 411 MB and
// writes 3.2 MB, 0.123 ms at 3.35 TB/s. Design: one warp per window; each
// lane loads one float4 (the warp's load is one coalesced 512-byte run),
// reduces it, and a shuffle tree reduces the warp.
//
// NaN rule: JAX's, as every maximum of the port (fmax_nan.cuh): a window
// with a NaN lane has a NaN maximum, as from .max in JAX or torch.amax.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fmax_nan.cuh"

namespace {

constexpr int W = 128;
constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
window_max_kernel(const float* __restrict__ scores, int64_t n_windows,
                  float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * WARPS
                    + threadIdx.x / 32;
  if (w >= n_windows) return;
  const float4 v = reinterpret_cast<const float4*>(scores + w * W)[lane];
  float m = sibrar::fmax_nan(sibrar::fmax_nan(v.x, v.y),
                             sibrar::fmax_nan(v.z, v.w));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = sibrar::fmax_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) out[w] = m;
}

}  // namespace

extern "C" int sibrar_window_max(const void* scores, long long n_windows,
                                 void* out, void* stream) {
  if (n_windows == 0) return 0;
  const long long blocks = (n_windows + WARPS - 1) / WARPS;
  window_max_kernel<<<static_cast<unsigned>(blocks), WARPS * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<int64_t>(n_windows),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
