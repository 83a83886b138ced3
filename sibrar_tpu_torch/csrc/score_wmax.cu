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
// D = 256) the GEMM is 52.6 GFLOP (0.785 ms at 67 TFLOP/s) against 0.52 GB
// moved (the score store 0.41 GB of it). Design: the main loop of
// score_tile.cuh on a 128 x 128 tile, i.e. one window for 128 users, so the
// window max is a reduction inside the block (row_max: each thread's 8
// columns, then a 16-lane shuffle). wmax is written once, with no atomics
// and no second pass; it is the max of the very values stored (NaN where
// one of them is, as JAX's max: fmax_nan.cuh). A warp
// stores two rows of 256 contiguous bytes per float4 store. The raster
// runs the B / 128 user tiles of one window on consecutive blocks, so each
// items window leaves HBM once, not once per user tile; with two blocks
// per SM, one block's score store overlaps the other's main loop (K14's
// full takes 3 % longer than its noscores on an H100 SXM at 700 W).
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace {

using sibrar::THREADS;
using sibrar::TILE;

__global__ void __launch_bounds__(THREADS, 2)
score_wmax_kernel(const float* __restrict__ u, const float* __restrict__ items,
                  int B, int C, int D, bool vec, int64_t row_stride,
                  int64_t window_stride, float* __restrict__ out,
                  float* __restrict__ wmax) {
  __shared__ __align__(16) sibrar::TileSmem sm;
  const int n_ut = (B + TILE - 1) / TILE;
  const int row0 = (blockIdx.x % n_ut) * TILE;
  const int w = blockIdx.x / n_ut;
  float acc[8][8];
  sibrar::score_tile(u, B, items, C, D, vec, row0, w * TILE, acc, sm);

  const int tx = sibrar::thread_tx();
  const int ty = sibrar::thread_ty();
  const int nw = C / TILE;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float mx = sibrar::row_max(acc[i]);
    const int r = row0 + sibrar::tile_row(ty, i);
    if (r < B) {
      float* srow = out + r * row_stride + w * window_stride;
      *reinterpret_cast<float4*>(srow + sibrar::tile_col(tx, 0)) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(srow + sibrar::tile_col(tx, 4)) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      if (tx == 0) wmax[static_cast<int64_t>(r) * nw + w] = mx;
    }
  }
}

int launch(const void* u, const void* items, int B, int C, int D,
           int64_t row_stride, int64_t window_stride, void* out, void* wmax,
           void* stream) {
  if (B == 0 || C == 0) return 0;
  const int blocks = (B + TILE - 1) / TILE * (C / TILE);
  score_wmax_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(items), B, C, D,
      sibrar::vec_operands(u, items, D), row_stride, window_stride,
      static_cast<float*>(out), static_cast<float*>(wmax));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2: scores [B, C] and wmax [B, C / 128]; C a multiple of 128.
extern "C" int sibrar_score_wmax(const void* u, const void* items, int B,
                                 int C, int D, void* scores, void* wmax,
                                 void* stream) {
  return launch(u, items, B, C, D, C, TILE, scores, wmax, stream);
}

// K10: planes sw_t [C / 128, B, 128] and wmax [B, C / 128].
extern "C" int sibrar_score_windows(const void* u, const void* items, int B,
                                    int C, int D, void* sw_t, void* wmax,
                                    void* stream) {
  return launch(u, items, B, C, D, TILE, static_cast<int64_t>(B) * TILE, sw_t,
                wmax, stream);
}
