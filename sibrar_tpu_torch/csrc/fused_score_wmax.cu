// K12 fused_score_wmax: catalog-major dot-product scores plus the maxima of
// windows of `window` consecutive catalog rows.
//
//   scores_t[c, b] = sum_d items[c, d] * u[b, d]             f32 [C, B]
//   wmax_t[w, b]   = max(scores_t[window w : window w + window, b])
//                                                           f32 [C / window, B]
//
// with `window` a multiple of 8 that divides 512 (8 .. 512) and C a multiple
// of 512, the Pallas function's contract.
//
// Replaces the Pallas kernel sibrar_tpu/ops/pallas_score.py:47
// fused_score_wmax (body :37): an MXU product in catalog-major layout whose
// epilogue splits the sublane axis into windows.
//
// Bound on the H100: f32 FFMA (52.6 GFLOP at B = 1024, C = 100,352, D = 256,
// against 0.4 GB of score writes). Design: the main loop of score_tile.cuh
// (so the scores are bit-equal to K2's and K10's, transposed), then the
// 64 x 128 tile is staged transposed through shared memory, so each catalog
// row's 64 users are stored as consecutive floats, and the window maxima are
// reduced down the staged columns. A block owns max(window, 128) catalog
// rows: windows of at most 128 rows lie inside one tile; for 256 and 512 the
// block walks 2 or 4 tiles and carries each user's running maximum in a
// register. No atomics, no second pass.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace {

using sibrar::BK;
using sibrar::BM;
using sibrar::BN;
using sibrar::PAD;

__global__ void __launch_bounds__(256)
fused_score_wmax_kernel(const float* __restrict__ u,
                        const float* __restrict__ items, int B, int D,
                        int window, float* __restrict__ scores_t,
                        float* __restrict__ wmax_t) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  __shared__ float Ts[BN][BM + 1];  // [catalog row][user] of one tile

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int span = window > BN ? window : BN;  // catalog rows of this block
  const int wr = window < BN ? window : BN;    // rows of a window in a tile
  float run = -CUDART_INF_F;  // window > 128: user tid's running maximum

  for (int sub = 0; sub < span; sub += BN) {
    const int col0 = blockIdx.x * span + sub;
    float acc[4][8];
    sibrar::score_tile(u, items, B, D, row0, col0, acc, As, Bs);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        Ts[j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4)][ty * 4 + i] = acc[i][j];
    __syncthreads();
    // a warp stores 32 consecutive users of one catalog row
    for (int idx = tid; idx < BN * BM; idx += 256) {
      const int c = idx / BM;
      const int r = row0 + idx % BM;
      if (r < B) scores_t[(int64_t)(col0 + c) * B + r] = Ts[c][idx % BM];
    }
    if (window <= BN) {
      for (int idx = tid; idx < (BN / wr) * BM; idx += 256) {
        const int g = idx / BM;
        const int user = idx % BM;
        float mx = Ts[g * wr][user];
        for (int q = 1; q < wr; ++q) mx = fmaxf(mx, Ts[g * wr + q][user]);
        if (row0 + user < B)
          wmax_t[(int64_t)(col0 / window + g) * B + row0 + user] = mx;
      }
    } else if (tid < BM) {
      for (int q = 0; q < BN; ++q) run = fmaxf(run, Ts[q][tid]);
    }
    __syncthreads();  // Ts is restaged by the next tile
  }
  if (window > BN && tid < BM && row0 + tid < B)
    wmax_t[(int64_t)blockIdx.x * B + row0 + tid] = run;
}

}  // namespace

extern "C" int sibrar_fused_score_wmax(const void* u, const void* items,
                                       int B, int C, int D, int window,
                                       void* scores_t, void* wmax_t,
                                       void* stream) {
  if (B == 0 || C == 0) return 0;
  const int span = window > BN ? window : BN;
  const dim3 grid(C / span, (B + BM - 1) / BM);
  fused_score_wmax_kernel<<<grid, 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(items), B, D,
      window, static_cast<float*>(scores_t), static_cast<float*>(wmax_t));
  return static_cast<int>(cudaGetLastError());
}
