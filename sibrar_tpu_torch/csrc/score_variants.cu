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
// moved by full (0.77 ms at 3.35 TB/s). Design: K2's kernel with other
// stores: the main loop of score_tile.cuh on a 128 x 128 tile (one window
// of 128 users), K2's reduction (row_max) and K2's raster (the user tiles
// of one window on consecutive blocks), so every variant's scores and
// maxima are K2's bit for bit; only the stores differ. A block's maxima
// are 128 consecutive floats of wmax_t.
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace {

using sibrar::THREADS;
using sibrar::TILE;

// what a variant stores
constexpr int kScores = 1;    // scores [B, C]
constexpr int kWmaxT = 2;     // maxima as [C / 128, B], one thread per row
constexpr int kStagedT = 4;   // maxima as [C / 128, B] through shared memory
constexpr int kWmaxLanes = 8; // maxima as [B, C / 128]

template <int kStore>
__device__ __forceinline__ void variant_tile(
    const float* __restrict__ u, const float* __restrict__ items, int B,
    int C, int D, bool vec, float* __restrict__ scores,
    float* __restrict__ wmax) {
  __shared__ __align__(16) sibrar::TileSmem sm;
  __shared__ float tile_max[TILE];
  constexpr bool kMax = (kStore & (kWmaxT | kStagedT | kWmaxLanes)) != 0;

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
    float mx = 0.0f;
    if constexpr (kMax) mx = sibrar::row_max(acc[i]);  // K2's reduction
    const int t = sibrar::tile_row(ty, i);
    const int r = row0 + t;
    if constexpr ((kStore & kStagedT) != 0) {
      if (tx == 0) tile_max[t] = mx;
    }
    if (r < B) {
      if constexpr ((kStore & kScores) != 0) {
        float* srow = scores + static_cast<int64_t>(r) * C + w * TILE;
        *reinterpret_cast<float4*>(srow + sibrar::tile_col(tx, 0)) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(srow + sibrar::tile_col(tx, 4)) =
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
    if (t < TILE && row0 + t < B)
      wmax[static_cast<int64_t>(w) * B + row0 + t] = tile_max[t];
  }
}

#define SIBRAR_VARIANT(NAME, STORE)                                          \
  __global__ void __launch_bounds__(THREADS, 2) NAME(                       \
      const float* __restrict__ u, const float* __restrict__ items, int B,  \
      int C, int D, bool vec, float* __restrict__ scores,                   \
      float* __restrict__ wmax) {                                           \
    variant_tile<STORE>(u, items, B, C, D, vec, scores, wmax);              \
  }

SIBRAR_VARIANT(score_full_kernel, kScores | kWmaxT)
SIBRAR_VARIANT(score_noscores_kernel, kWmaxT)
SIBRAR_VARIANT(score_nowmax_kernel, kScores)
SIBRAR_VARIANT(score_wmax_contig_kernel, kScores | kWmaxT)
SIBRAR_VARIANT(score_wmax_T_kernel, kScores | kStagedT)
SIBRAR_VARIANT(score_wmax_lanes_kernel, kScores | kWmaxLanes)
#undef SIBRAR_VARIANT

using Kernel = void (*)(const float*, const float*, int, int, int, bool,
                        float*, float*);
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
  const int blocks = (B + TILE - 1) / TILE * (C / TILE);
  kKernels[variant]<<<blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(items), B, C, D,
      sibrar::vec_operands(u, items, D), static_cast<float*>(scores),
      static_cast<float*>(wmax));
  return static_cast<int>(cudaGetLastError());
}
