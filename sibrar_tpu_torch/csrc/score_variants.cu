// K14: the f32 score GEMM under the six epilogues of the tools/ bisect
// probes, one kernel name each, so a profiler's rows tell them apart.
//
//   s[b, c]    = sum_d u[b, d] * items[c, d]                 f32 [B, C]
//   m[b, w]    = max(s[b, 128 w : 128 w + 128])
//
//   full         scores [B, C], wmax_t [C / 128, B] (wmax_t[w, b] = m[b, w])
//   noscores     wmax_t only
//   nowmax       scores only: the GEMM and nothing else
//   wmax_contig  scores, [C / 1024, 8, B]: the bytes of wmax_t (the TPU
//                variant moved the out block, not the layout)
//   wmax_T       as full, the tile's 64 maxima staged in shared memory and
//                written by 64 consecutive threads in one coalesced store
//   wmax_lanes   scores, [B, C / 128] (K2's layout)
//
// Replaces the Pallas kernels of tools/probe_gemm_bisect.py:143 (bodies
// k_full :66, k_noscores :72, k_nowmax :77, k_wmax3d :80, k_wmax_T :86,
// k_wmax_lanes :96), of tools/probe_gemm_variants.py:83 (full, noscores,
// nowmax) and, for the precisions HIGHEST and none, of
// tools/probe_gemm_precision.py:56 (full).
//
// Bound on the H100: f32 FFMA. At the probes' shape (B = 1024, C = 501,760,
// D = 256) the GEMM is 263 GFLOP (3.93 ms at 67 TFLOP/s) against 2.59 GB
// moved by full (0.77 ms at 3.35 TB/s). Design: K2's main loop
// (score_tile.cuh) and K2's reduction, so every variant's scores and maxima
// are K2's bit for bit; only the stores differ. A block owns one 128-wide
// window of 64 users; its maxima are 64 consecutive floats of wmax_t.
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace {

using sibrar::BK;
using sibrar::BM;
using sibrar::BN;
using sibrar::PAD;

// what a variant stores
constexpr int kScores = 1;    // scores [B, C]
constexpr int kWmaxT = 2;     // maxima as [C / 128, B], one thread per row
constexpr int kStagedT = 4;   // maxima as [C / 128, B] through shared memory
constexpr int kWmaxLanes = 8; // maxima as [B, C / 128]

template <int kStore>
__device__ __forceinline__ void variant_tile(
    const float* __restrict__ u, const float* __restrict__ items, int B,
    int C, int D, float* __restrict__ scores, float* __restrict__ wmax) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  __shared__ float tile_max[BM];
  constexpr bool kMax = (kStore & (kWmaxT | kStagedT | kWmaxLanes)) != 0;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * BM;
  const int w = blockIdx.x;
  float acc[4][8];
  sibrar::score_tile(u, items, B, D, row0, w * BN, acc, As, Bs);

  const int nw = C / BN;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = 0.0f;
    if constexpr (kMax) {  // K2's reduction, in K2's order
      mx = acc[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, acc[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    const int r = row0 + ty * 4 + i;
    if constexpr ((kStore & kStagedT) != 0) {
      if (tx == 0) tile_max[ty * 4 + i] = mx;
    }
    if (r < B) {
      if constexpr ((kStore & kScores) != 0) {
        float* srow = scores + static_cast<int64_t>(r) * C + w * BN;
        *reinterpret_cast<float4*>(srow + tx * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(srow + 64 + tx * 4) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
      if constexpr ((kStore & kWmaxT) != 0) {
        if (tx == 0) wmax[static_cast<int64_t>(w) * B + r] = mx;
      }
      if constexpr ((kStore & kWmaxLanes) != 0) {
        if (tx == 0) wmax[static_cast<int64_t>(r) * nw + w] = mx;
      }
    }
  }
  if constexpr ((kStore & kStagedT) != 0) {
    __syncthreads();
    const int t = threadIdx.x;
    if (t < BM && row0 + t < B)
      wmax[static_cast<int64_t>(w) * B + row0 + t] = tile_max[t];
  }
}

#define SIBRAR_VARIANT(NAME, STORE)                                          \
  __global__ void __launch_bounds__(256) NAME(                              \
      const float* __restrict__ u, const float* __restrict__ items, int B,  \
      int C, int D, float* __restrict__ scores, float* __restrict__ wmax) { \
    variant_tile<STORE>(u, items, B, C, D, scores, wmax);                   \
  }

SIBRAR_VARIANT(score_full_kernel, kScores | kWmaxT)
SIBRAR_VARIANT(score_noscores_kernel, kWmaxT)
SIBRAR_VARIANT(score_nowmax_kernel, kScores)
SIBRAR_VARIANT(score_wmax_contig_kernel, kScores | kWmaxT)
SIBRAR_VARIANT(score_wmax_T_kernel, kScores | kStagedT)
SIBRAR_VARIANT(score_wmax_lanes_kernel, kScores | kWmaxLanes)
#undef SIBRAR_VARIANT

using Kernel = void (*)(const float*, const float*, int, int, int, float*,
                        float*);
// indexed by the wrapper's variant code (ops/gemm_probe.py VARIANT_CODES)
constexpr Kernel kKernels[] = {score_full_kernel,      score_noscores_kernel,
                               score_nowmax_kernel,    score_wmax_contig_kernel,
                               score_wmax_T_kernel,    score_wmax_lanes_kernel};

}  // namespace

// C a multiple of 128; wmax is ignored by nowmax, scores by noscores.
extern "C" int sibrar_score_variant(const void* u, const void* items, int B,
                                    int C, int D, int variant, void* scores,
                                    void* wmax, void* stream) {
  if (variant < 0 || variant >= 6) return static_cast<int>(
      cudaErrorInvalidValue);
  if (B == 0 || C == 0) return 0;
  const dim3 grid(C / BN, (B + BM - 1) / BM);
  kKernels[variant]<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(items), B, C, D,
      static_cast<float*>(scores), static_cast<float*>(wmax));
  return static_cast<int>(cudaGetLastError());
}
