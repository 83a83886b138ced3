// K2 score_wmax: dot-product scores plus their 128-wide window maxima.
//
//   scores[b, c] = sum_d u[b, d] * items[c, d]            f32 [B, C]
//   wmax[b, w]   = max(scores[b, 128 w : 128 w + 128])     f32 [B, C / 128]
//
// Replaces the Pallas kernel sibrar_tpu/ops/pallas_window.py:182
// score_native_wmax (MXU GEMM whose epilogue reduces each 128-lane window and
// writes the maxima transposed as [NW, B], transposed back by XLA).
//
// Bound on the H100: f32 FFMA. At the serving shape (B = 1024, C = 100,352,
// D = 256) the GEMM is 52.6 GFLOP against 0.4 GB of score writes. Tensor
// cores would mean TF32 or bf16 inputs, which changes the scores; that is a
// serving-dtype decision for a later change. Design: a shared-memory tiled
// SIMT GEMM. A block owns a 64 x 128 output tile, i.e. exactly one window
// column for 64 users, so the window max is a reduction inside the block:
// each thread reduces its 8 columns, then a 16-lane shuffle reduces across
// the threads that share a row. wmax is written once, as [B, C / 128], with
// no atomics and no second pass; it is the max of the very values stored in
// scores, so the two always agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // users per block
constexpr int BN = 128;   // catalog columns per block: one window
constexpr int BK = 16;    // depth of one shared-memory stage
constexpr int PAD = 4;    // row padding: fewer bank conflicts, float4 alignment kept

// 256 threads as 16 (ty, rows) x 16 (tx, columns). Thread (ty, tx) owns rows
// ty*4 .. ty*4+3 and columns tx*4 .. tx*4+3 and 64+tx*4 .. 64+tx*4+3, so its
// stores are two float4s per row, and the 16 threads of one row group are
// one half-warp.
__global__ void __launch_bounds__(256)
score_wmax_kernel(const float* __restrict__ u, const float* __restrict__ items,
                  int B, int C, int D, float* __restrict__ scores,
                  float* __restrict__ wmax) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[4][8];
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
    // B tile: 128 x 16 values, 8 per thread (C is a multiple of 128)
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
      float* srow = scores + (int64_t)r * C + col0;
      *reinterpret_cast<float4*>(srow + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(srow + 64 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      if (tx == 0) wmax[(int64_t)r * nw + blockIdx.x] = mx;
    }
  }
}

}  // namespace

extern "C" int sibrar_score_wmax(const void* u, const void* items, int B,
                                 int C, int D, void* scores, void* wmax,
                                 void* stream) {
  if (B == 0 || C == 0) return 0;
  const dim3 grid(C / BN, (B + BM - 1) / BM);
  score_wmax_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(items), B, C, D,
      static_cast<float*>(scores), static_cast<float*>(wmax));
  return static_cast<int>(cudaGetLastError());
}
