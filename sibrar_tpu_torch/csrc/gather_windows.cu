// K3 gather_windows: fetch selected 128-wide windows of each row.
//
//   out[b, j, :] = src[b * stride + idx[b, j] * window_stride : +128]
//   out[b, j, l] = -inf  where dead[b, j, l]   (optional mask)
//
// with row stride `stride` and window stride `window_stride` (in floats):
// 128 for the windows of a row-major [B, n * 128] source, and B * 128 for
// the window planes of a [n, B, 128] tiling (sw_t[widx[b, j], b, :]).
//
// Replaces the Pallas kernels sibrar_tpu/ops/pallas_peel.py:490
// gather_score_windows (three spellings: row block resident in VMEM,
// catalog-chunked, and sorted-run chunked, all VMEM workarounds) and
// pallas_peel.py:599 gather_subwindows (the same copy from the gathered
// [B, m, 128] tensor, here passed as a [B, m * 128] source); with the
// window stride B * 128, sibrar_tpu/ops/pallas_window.py:243 gather_windows
// (body :229), which gathers from the [NW, B, 128] tiling of
// window_scores_from.
//
// Bound on the H100: bytes. Design: one warp per window; each lane moves one
// float4 (and reads one uchar4 of the dead mask), so a window is one 512-byte
// coalesced read and one coalesced write. The mask is applied on copy, so
// masking costs no extra pass over the output.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int W = 128;
constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
gather_windows_kernel(const float* __restrict__ src, int64_t stride,
                      int64_t window_stride, const int* __restrict__ idx,
                      int m,
                      const unsigned char* __restrict__ dead,
                      float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int j = blockIdx.x * WARPS + threadIdx.x / 32;
  const int64_t b = blockIdx.y;
  if (j >= m) return;
  const int64_t slot = b * m + j;
  const int64_t wi = idx[slot];
  float4 v = reinterpret_cast<const float4*>(
      src + b * stride + wi * window_stride)[lane];
  if (dead != nullptr) {
    const uchar4 d = reinterpret_cast<const uchar4*>(dead + slot * W)[lane];
    if (d.x) v.x = -CUDART_INF_F;
    if (d.y) v.y = -CUDART_INF_F;
    if (d.z) v.z = -CUDART_INF_F;
    if (d.w) v.w = -CUDART_INF_F;
  }
  reinterpret_cast<float4*>(out + slot * W)[lane] = v;
}

}  // namespace

extern "C" int sibrar_gather_windows(const void* src, long long stride,
                                     long long window_stride,
                                     const void* idx, int B, int m,
                                     const void* dead, void* out,
                                     void* stream) {
  if (B == 0 || m == 0) return 0;
  const dim3 grid((m + WARPS - 1) / WARPS, B);
  gather_windows_kernel<<<grid, WARPS * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<int64_t>(stride),
      static_cast<int64_t>(window_stride), static_cast<const int*>(idx), m,
      static_cast<const unsigned char*>(dead), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
