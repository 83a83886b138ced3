// The f32 main loop shared by K2 score_wmax, K10 score_windows and K12
// fused_score_wmax: one 64 x 128 tile of u @ items.T, accumulated in
// registers. All three kernels run these very instructions in this order,
// so their scores are bit-equal; they differ only in where the tile is
// stored and how its maxima are reduced.
//
// Design: a shared-memory tiled SIMT GEMM (f32 FFMA; tensor cores would mean
// TF32 or bf16 inputs, which changes the scores). 256 threads as 16 (ty,
// rows) x 16 (tx, columns). Thread (ty, tx) owns rows ty*4 .. ty*4+3 and
// columns tx*4 .. tx*4+3 and 64+tx*4 .. 64+tx*4+3 of the tile; the 16
// threads of one row group are one half-warp.
#pragma once

#include <stdint.h>

namespace sibrar {

constexpr int BM = 64;    // users per tile
constexpr int BN = 128;   // catalog rows per tile: one 128-wide window
constexpr int BK = 16;    // depth of one shared-memory stage
constexpr int PAD = 4;    // row padding: fewer bank conflicts, float4-aligned

// acc[i][j]: user row0 + ty*4 + i, catalog row col0 + tx*4 + j (j < 4) or
// col0 + 64 + tx*4 + (j - 4) (j >= 4). Depths past D, and users past B, are
// read as zeros. Every catalog row col0 .. col0 + 127 must exist.
__device__ __forceinline__ void score_tile(
    const float* __restrict__ u, const float* __restrict__ items, int B,
    int D, int row0, int col0, float (&acc)[4][8], float (*As)[BM + PAD],
    float (*Bs)[BN + PAD]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    // A tile: 64 x 16 values, 4 per thread; 16 consecutive threads read one
    // user's 16 consecutive depths (coalesced along D)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * 256;
      const int m = idx / BK;
      const int kk = idx % BK;
      const int gr = row0 + m;
      const int gk = k0 + kk;
      As[kk][m] = (gr < B && gk < D) ? u[(int64_t)gr * D + gk] : 0.0f;
    }
    // B tile: 128 x 16 values, 8 per thread
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * 256;
      const int n = idx / BK;
      const int kk = idx % BK;
      const int gk = k0 + kk;
      Bs[kk][n] = gk < D ? items[(int64_t)(col0 + n) * D + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace sibrar
