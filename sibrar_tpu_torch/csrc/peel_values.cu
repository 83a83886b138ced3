// K4 peel_values: the top-t distinct values of each 128-wide row.
//
//   vals[r, i] = i-th largest distinct value of x[r, :], descending,
//                -inf once the row runs out of distinct values
//   last[r]    = vals[r, t - 1]
//
// over x [R, 128]. The serving path calls it on the gathered windows
// [B, m, 128] (R = B * m), so vals is [B, m, t], read as [B, m * t], and
// last is [B, m].
//
// Replaces the Pallas kernels sibrar_tpu/ops/pallas_peel.py:240
// peel_values_grouped (rows transposed onto lanes so the output lands
// lane-compact, [t, B * m]) and pallas_peel.py:188 peel_values (row-flat,
// taken when B % 16 != 0). Both layouts are Mosaic workarounds; here one
// kernel writes the grouped layout directly, and the row-flat variant is
// the same call with m = 1.
//
// Bound on the H100: bytes (t rounds of a few register ops per value, one
// 512-byte read per row). Design: one warp per row, 4 values per lane held in
// registers. Each round takes the warp max with shuffles and clears every
// lane equal to it (all ties at once), exactly the TPU kernel's rule, so the
// values are bit-equal to it.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
peel_values_kernel(const float* __restrict__ x, int64_t R, int t,
                   float* __restrict__ vals, float* __restrict__ last) {
  const int lane = threadIdx.x % 32;
  const int64_t r = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  if (r >= R) return;
  float4 v = reinterpret_cast<const float4*>(x + r * 128)[lane];
  float mx = -CUDART_INF_F;
  for (int round = 0; round < t; ++round) {
    mx = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) vals[r * t + round] = mx;
    if (v.x == mx) v.x = -CUDART_INF_F;
    if (v.y == mx) v.y = -CUDART_INF_F;
    if (v.z == mx) v.z = -CUDART_INF_F;
    if (v.w == mx) v.w = -CUDART_INF_F;
  }
  if (lane == 0) last[r] = mx;
}

}  // namespace

extern "C" int sibrar_peel_values(const void* x, long long R, int t,
                                  void* vals, void* last, void* stream) {
  if (R == 0 || t == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((R + WARPS - 1) / WARPS);
  peel_values_kernel<<<blocks, WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int64_t>(R), t,
      static_cast<float*>(vals), static_cast<float*>(last));
  return static_cast<int>(cudaGetLastError());
}
