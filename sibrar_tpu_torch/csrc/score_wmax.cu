// K2 score_wmax and K10 score_windows: dot-product scores plus their
// 128-wide window maxima, stored in one of two layouts.
//
//   s[b, c]    = sum_d u[b, d] * items[c, d]
//   wmax[b, w] = max(s[b, 128 w : 128 w + 128])            f32 [B, C / 128]
//
// K2 stores s row-major as scores [B, C]; K10 stores it as window planes
// sw_t [C / 128, B, 128] (sw_t[w, b, :] = s[b, 128 w : +128]). One kernel
// does both: row b of window w lands at b * row_stride + w * window_stride,
// (C, 128) for K2 and (128, B * 128) for K10, so the two layouts hold the
// same bits.
//
// K2 replaces the Pallas kernel sibrar_tpu/ops/pallas_window.py:182
// score_native_wmax (MXU GEMM whose epilogue reduces each 128-lane window and
// writes the maxima transposed as [NW, B], transposed back by XLA); K10
// replaces sibrar_tpu/ops/pallas_window.py:104 score_windows (body :56), the
// same epilogue writing each window's lane slice into its own plane.
//
// Bound on the H100: f32 FFMA. At the serving shape (B = 1024, C = 100,352,
// D = 256) the GEMM is 52.6 GFLOP against 0.4 GB of score writes. Design: the
// shared main loop of score_tile.cuh. A block owns a 64 x 128 output tile,
// i.e. exactly one window for 64 users, so the window max is a reduction
// inside the block: each thread reduces its 8 columns, then a 16-lane shuffle
// reduces across the threads that share a row. wmax is written once, as
// [B, C / 128], with no atomics and no second pass; it is the max of the very
// values stored, so the two always agree bit for bit. In either layout a
// thread's stores are two float4s per row, 128 contiguous floats per row.
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace {

using sibrar::BK;
using sibrar::BM;
using sibrar::BN;
using sibrar::PAD;

__global__ void __launch_bounds__(256)
score_wmax_kernel(const float* __restrict__ u, const float* __restrict__ items,
                  int B, int C, int D, int64_t row_stride,
                  int64_t window_stride, float* __restrict__ out,
                  float* __restrict__ wmax) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * BM;
  float acc[4][8];
  sibrar::score_tile(u, items, B, D, row0, blockIdx.x * BN, acc, As, Bs);

  const int nw = C / BN;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = acc[i][0];
#pragma unroll
    for (int j = 1; j < 8; ++j) mx = fmaxf(mx, acc[i][j]);
    // the 16 threads sharing this row are lanes tx = 0..15 of one half-warp
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const int r = row0 + ty * 4 + i;
    if (r < B) {
      float* srow = out + r * row_stride + blockIdx.x * window_stride;
      *reinterpret_cast<float4*>(srow + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(srow + 64 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      if (tx == 0) wmax[(int64_t)r * nw + blockIdx.x] = mx;
    }
  }
}

int launch(const void* u, const void* items, int B, int C, int D,
           int64_t row_stride, int64_t window_stride, void* out, void* wmax,
           void* stream) {
  if (B == 0 || C == 0) return 0;
  const dim3 grid(C / BN, (B + BM - 1) / BM);
  score_wmax_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(items), B, C, D,
      row_stride, window_stride, static_cast<float*>(out),
      static_cast<float*>(wmax));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2: scores [B, C] and wmax [B, C / 128]; C a multiple of 128.
extern "C" int sibrar_score_wmax(const void* u, const void* items, int B,
                                 int C, int D, void* scores, void* wmax,
                                 void* stream) {
  return launch(u, items, B, C, D, C, BN, scores, wmax, stream);
}

// K10: planes sw_t [C / 128, B, 128] and wmax [B, C / 128].
extern "C" int sibrar_score_windows(const void* u, const void* items, int B,
                                    int C, int D, void* sw_t, void* wmax,
                                    void* stream) {
  return launch(u, items, B, C, D, BN, static_cast<int64_t>(B) * BN, sw_t,
                wmax, stream);
}
