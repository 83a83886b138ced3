// K5 dw_matmul: the weight gradient of the interaction towers' dense first
// layer, without a transposed copy of the densified rows.
//
//   dw[c, h] = sum_r vec[r, c] * g[r, h]        vec f32 [R, C], g f32 [R, H]
//
// Replaces the Pallas kernel sibrar_tpu/ops/pallas_dw.py:90 dw_matmul (MXU
// dot_general contracting dim 0 of both [rb, cb] / [rb, h] tiles, the [cb, h]
// output tile revisited along a sequential row-tile grid axis). Its point is
// that XLA would otherwise write a transposed copy of the whole [R, C] matrix
// before the GEMM.
//
// Bound on the H100: f32 FFMA. At the train shape (R = 2,256 rows, C = 50,000
// users, H = 512) the GEMM is 115.5 GFLOP against 0.56 GB of traffic. Tensor
// cores would mean TF32 or bf16 g (vec is 0/1 and exact either way), which
// changes the gradient; they stay off. Design: a shared-memory tiled SIMT
// GEMM with K2's tiling. A block owns a 64 (c) x 128 (h) tile of dw and loops
// over r inside the block: that loop replaces the TPU's sequential row-tile
// axis, so no atomics are needed and the sums are deterministic. vec is read
// row-major, 64 consecutive c of one row at a time (coalesced), straight
// into the transposed A tile: no transposed copy exists anywhere.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // dw rows (c) per block
constexpr int BN = 128;   // dw columns (h) per block
constexpr int BK = 16;    // r per shared-memory stage
constexpr int PAD = 4;    // row padding: fewer bank conflicts, float4 alignment kept

// 256 threads as 16 (ty, c) x 16 (tx, h). Thread (ty, tx) owns c rows
// ty*4 .. ty*4+3 and h columns tx*4 .. tx*4+3 and 64+tx*4 .. 64+tx*4+3.
__global__ void __launch_bounds__(256)
dw_matmul_kernel(const float* __restrict__ vec, const float* __restrict__ g,
                 int R, int C, int H, float* __restrict__ dw) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int c0 = blockIdx.x * BM;
  const int h0 = blockIdx.y * BN;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int r0 = 0; r0 < R; r0 += BK) {
    // A tile: 16 rows of vec x 64 columns, 4 values per thread; consecutive
    // threads read consecutive c of one row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * 256;
      const int m = idx % BM;
      const int kk = idx / BM;
      const int gr = r0 + kk;
      const int gc = c0 + m;
      As[kk][m] = (gr < R && gc < C) ? vec[(int64_t)gr * C + gc] : 0.0f;
    }
    // B tile: 16 rows of g x 128 columns, 8 values per thread
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * 256;
      const int n = idx % BN;
      const int kk = idx / BN;
      const int gr = r0 + kk;
      const int gh = h0 + n;
      Bs[kk][n] = (gr < R && gh < H) ? g[(int64_t)gr * H + gh] : 0.0f;
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= C) continue;
    float* row = dw + (int64_t)c * H;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int h = h0 + half * 64 + tx * 4;
      const float* v = &acc[i][half * 4];
      if ((H % 4) == 0 && h + 3 < H) {
        *reinterpret_cast<float4*>(row + h) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (h + j < H) row[h + j] = v[j];
      }
    }
  }
}

}  // namespace

extern "C" int sibrar_dw_matmul(const void* vec, const void* g, int R, int C,
                                int H, void* dw, void* stream) {
  if (C == 0 || H == 0) return 0;
  const dim3 grid((C + BM - 1) / BM, (H + BN - 1) / BN);
  dw_matmul_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vec), static_cast<const float*>(g), R, C, H,
      static_cast<float*>(dw));
  return static_cast<int>(cudaGetLastError());
}
