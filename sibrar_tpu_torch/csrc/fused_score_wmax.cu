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
// against 0.52 GB moved). Design: the main loop of score_tile.cuh with the
// operands' roles swapped, items as the tile's rows and u as its columns
// (fmaf(a, b, c) == fmaf(b, a, c), and the depth order is K2's, so the
// scores are K2's bit for bit, transposed). A thread's accumulator row is
// then one catalog row of scores_t, and a warp stores two catalog rows of
// 256 contiguous bytes per float4 store, with no staging. The window maxima
// run down the tile's rows: each thread takes the max of its 4 consecutive
// rows per column, the 32 row groups of 4 go through 16 KB of shared
// memory (the main loop's, between tiles), and one thread per (window,
// user) reduces its window's groups.
// A block owns max(window, 128) catalog rows: windows of at most 128 rows
// lie inside one tile; for 256 and 512 the block walks 2 or 4 tiles and
// carries each user's running maximum in a register. No atomics, no second
// pass. The raster runs the user tiles of one catalog span on consecutive
// blocks, so each items window leaves HBM once. A window with a NaN score
// has a NaN maximum, as in JAX (fmax_nan.cuh).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace {

using sibrar::THREADS;
using sibrar::TILE;

// kSpan: window > 128, the block walks window / 128 tiles (a template
// argument, so the one-tile kernel of the smaller windows carries no
// running maximum through its main loop)
template <bool kSpan>
__global__ void __launch_bounds__(THREADS, 2)
fused_score_wmax_kernel(const float* __restrict__ u,
                        const float* __restrict__ items, int B, int C, int D,
                        bool vec, int window, float* __restrict__ scores_t,
                        float* __restrict__ wmax_t) {
  // the main loop's stages, then, between tiles, each 4-row group's maxima
  // of the tile [group][user] (score_tile ends on a barrier)
  __shared__ __align__(16) union {
    sibrar::TileSmem tile;
    float part[TILE / 4][TILE];
  } sm;

  const int tid = threadIdx.x;
  const int n_ut = (B + TILE - 1) / TILE;
  const int user0 = (blockIdx.x % n_ut) * TILE;
  const int span = kSpan ? window : TILE;  // catalog rows of the block
  float run = -CUDART_INF_F;  // kSpan: user tid's running maximum

  for (int sub = 0; sub < span; sub += TILE) {
    const int c0 = (blockIdx.x / n_ut) * span + sub;
    float acc[8][8];
    sibrar::score_tile(items, C, u, B, D, vec, c0, user0, acc, sm.tile);
    const int tx = sibrar::thread_tx();
    const int ty = sibrar::thread_ty();
    // rows 4 g .. 4 g + 3 of the thread (tile rows 64 g + 4 ty ..) are the
    // tile's row group 16 g + ty: store them, then their maxima per column
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int i = 4 * g; i < 4 * g + 4; ++i) {
        float* srow =
            scores_t + static_cast<int64_t>(c0 + sibrar::tile_row(ty, i)) * B;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int b0 = user0 + sibrar::tile_col(tx, 4 * h);
          const float* v = &acc[i][4 * h];
          if (B % 4 == 0 && b0 < B) {
            *reinterpret_cast<float4*>(srow + b0) =
                make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (b0 + q < B) srow[b0 + q] = v[q];
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 4 * h + q;
          m[q] = sibrar::fmax_nan(
              sibrar::fmax_nan(acc[4 * g][j], acc[4 * g + 1][j]),
              sibrar::fmax_nan(acc[4 * g + 2][j], acc[4 * g + 3][j]));
        }
        *reinterpret_cast<float4*>(
            &sm.part[g * 16 + ty][sibrar::tile_col(tx, 4 * h)]) =
            make_float4(m[0], m[1], m[2], m[3]);
      }
    }
    __syncthreads();
    if constexpr (!kSpan) {
      const int groups = window / 4;
      for (int idx = tid; idx < (TILE / window) * TILE; idx += THREADS) {
        const int wi = idx / TILE;
        const int user = idx % TILE;
        float mx = sm.part[wi * groups][user];
        for (int q = 1; q < groups; ++q)
          mx = sibrar::fmax_nan(mx, sm.part[wi * groups + q][user]);
        if (user0 + user < B)
          wmax_t[static_cast<int64_t>(c0 / window + wi) * B + user0 + user] =
              mx;
      }
    } else if (tid < TILE) {
      for (int q = 0; q < TILE / 4; ++q)
        run = sibrar::fmax_nan(run, sm.part[q][tid]);
    }
    __syncthreads();  // the next tile's stages overwrite part
  }
  if (kSpan && tid < TILE && user0 + tid < B)
    wmax_t[static_cast<int64_t>(blockIdx.x / n_ut) * B + user0 + tid] = run;
}

}  // namespace

extern "C" int sibrar_fused_score_wmax(const void* u, const void* items,
                                       int B, int C, int D, int window,
                                       void* scores_t, void* wmax_t,
                                       void* stream) {
  if (B == 0 || C == 0) return 0;
  const bool span = window > TILE;
  const int blocks = (B + TILE - 1) / TILE * (C / (span ? window : TILE));
  (span ? fused_score_wmax_kernel<true> : fused_score_wmax_kernel<false>)
      <<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(u), static_cast<const float*>(items), B,
          C, D, sibrar::vec_operands(u, items, D), window,
          static_cast<float*>(scores_t), static_cast<float*>(wmax_t));
  return static_cast<int>(cudaGetLastError());
}
