// The f32 SIMT tile shared by the hand-written GEMMs: the main loop of
// every score kernel (K2 score_wmax, K10 score_windows, K12
// fused_score_wmax, K14's six variants), and the FFMA stage and thread
// mapping of K5 dw_matmul.
//
// A 128 x 128 output tile, 256 threads as 16 (ty) x 16 (tx), 8 x 8
// accumulators per thread. Every accumulator is one chain of fmaf over the
// depth in order 0, 1, ..., starting at 0 (depths past D read as zeros), so
// any kernel that calls score_tile on the same operands stores the same
// bits, whatever its tile's place in the grid and whichever operand it
// calls the rows (fmaf(a, b, c) == fmaf(b, a, c)).
//
// Bound on the H100: f32 FFMA (tensor cores would mean TF32 or bf16
// operands, which changes the scores). What the design does about it:
// - 64 FFMA per 4 16-byte shared-memory loads per depth, and 2 blocks of
//   256 threads per SM (__launch_bounds__(256, 2) holds a thread to 128
//   registers), so one block's barrier and score store overlap the other
//   block's FFMA;
// - both score operands are D-contiguous ([n, D]), so a 16-byte global
//   load brings 4 depths of one row; the transpose into the k-major stage
//   that the outer product reads goes through registers: the loads of
//   stage t + 1 are in flight while stage t is multiplied, then stored as
//   4 scalars into the other of two shared-memory buffers (a row stride of
//   132 floats keeps the float4 reads free of bank conflicts, the stores
//   at two ways). A swizzled [n][k] stage read along k would need 4 depths
//   of 8 rows in registers at once, 64 fragment registers instead of 16;
// - 16 depths per stage, one barrier per 1,024 FFMA of a thread (on an
//   H100 SXM at 700 W, K2 takes 1.27 ms at 16 depths, 1.43 ms at 8); the
//   16 prefetch registers are what a 128-register thread has left;
// - the raster (each kernel's launcher) puts the tiles that share a
//   catalog window on consecutive blocks, so the window leaves HBM once
//   and the user rows, read by every window, are served from L2.
#pragma once

#include <stdint.h>

#include "fmax_nan.cuh"

namespace sibrar {

constexpr int TILE = 128;      // rows and columns of one output tile
constexpr int TK = 16;         // depths per shared-memory stage
constexpr int THREADS = 256;   // 16 x 16
constexpr int LDS = TILE + 4;  // row stride of a score stage [TK][LDS]

// Thread (ty, tx) = (thread_ty(), thread_tx()) holds acc[i][j] for tile row
// tile_row(ty, i) and tile column tile_col(tx, j): i, j < 4 in the first
// 64, 4 .. 7 in the second. The 16 threads of one row are lanes tx of one
// half-warp.
__device__ __forceinline__ int thread_ty() { return threadIdx.x / 16; }
__device__ __forceinline__ int thread_tx() { return threadIdx.x % 16; }
__device__ __forceinline__ int tile_row(int ty, int i) {
  return (i >> 2) * 64 + ty * 4 + (i & 3);
}
__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j >> 2) * 64 + tx * 4 + (j & 3);
}

// acc += a[k] (x) b[k] for the TK depths of one stage, a and b k-major
// ([TK][ld]) with the tile's rows and columns along ld.
template <int LD>
__device__ __forceinline__ void fma_stage(const float (*a)[LD],
                                          const float (*b)[LD],
                                          float (&acc)[8][8]) {
  const int tx = thread_tx();
  const int ty = thread_ty();
#pragma unroll
  for (int kk = 0; kk < TK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&a[kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&a[kk][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&b[kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&b[kk][64 + tx * 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The two k-major stages of score_tile.
struct TileSmem {
  float a[2][TK][LDS];
  float b[2][TK][LDS];
};

// Depths k .. k + 3 of row `row` of p [n, D]; rows past n and depths past
// D read as zeros. vec: D % 4 == 0 and p 16-byte aligned (k is a multiple
// of 4).
__device__ __forceinline__ float4 load_depths(const float* __restrict__ p,
                                              int row, int n, int D, int k,
                                              bool vec) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row >= n || k >= D) return v;
  const float* src = p + static_cast<int64_t>(row) * D + k;
  if (vec) return __ldg(reinterpret_cast<const float4*>(src));
  v.x = __ldg(src);
  if (k + 1 < D) v.y = __ldg(src + 1);
  if (k + 2 < D) v.z = __ldg(src + 2);
  if (k + 3 < D) v.w = __ldg(src + 3);
  return v;
}

// score_tile's loads: a thread stages 4 depths of LOAD_ROWS rows of each
// operand, rows THREADS / (TK / 4) apart
constexpr int LOAD_ROWS = TILE * TK / 4 / THREADS;

// The 4 depths of tile row `row` into a k-major stage.
__device__ __forceinline__ void stage_depths(float (*s)[LDS], int row, int kq,
                                             float4 v) {
  s[kq][row] = v.x;
  s[kq + 1][row] = v.y;
  s[kq + 2][row] = v.z;
  s[kq + 3][row] = v.w;
}

// acc[i][j] = sum_d a[row0 + tile_row(ty, i), d] * b[col0 + tile_col(tx, j), d]
// for a [na, D] and b [nb, D]; rows past na or nb read as zeros. vec: D % 4
// == 0 and both operands 16-byte aligned. Every thread of the block calls
// it; it ends on a barrier, so `sm` may be reused at once.
__device__ __forceinline__ void score_tile(
    const float* __restrict__ a, int na, const float* __restrict__ b, int nb,
    int D, bool vec, int row0, int col0, float (&acc)[8][8], TileSmem& sm) {
  constexpr int kRowStep = THREADS / (TK / 4);
  const int lr = threadIdx.x / (TK / 4);        // its first row of a and b
  const int kq = (threadIdx.x % (TK / 4)) * 4;  // its 4 depths in a stage
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float4 pa[LOAD_ROWS], pb[LOAD_ROWS];
#pragma unroll
  for (int p = 0; p < LOAD_ROWS; ++p) {
    const int row = lr + p * kRowStep;
    stage_depths(sm.a[0], row, kq, load_depths(a, row0 + row, na, D, kq, vec));
    stage_depths(sm.b[0], row, kq, load_depths(b, col0 + row, nb, D, kq, vec));
  }
  __syncthreads();
  const int nk = (D + TK - 1) / TK;
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < nk;
    if (more) {  // stage t + 1 in flight while stage t is multiplied
#pragma unroll
      for (int p = 0; p < LOAD_ROWS; ++p) {
        const int row = lr + p * kRowStep;
        pa[p] = load_depths(a, row0 + row, na, D, (t + 1) * TK + kq, vec);
        pb[p] = load_depths(b, col0 + row, nb, D, (t + 1) * TK + kq, vec);
      }
    }
    fma_stage<LDS>(sm.a[cur], sm.b[cur], acc);
    if (more) {
#pragma unroll
      for (int p = 0; p < LOAD_ROWS; ++p) {
        stage_depths(sm.a[cur ^ 1], lr + p * kRowStep, kq, pa[p]);
        stage_depths(sm.b[cur ^ 1], lr + p * kRowStep, kq, pb[p]);
      }
    }
    __syncthreads();
  }
}

// Max of one accumulator row over the tile's 128 columns: the thread's 8,
// then across the 16 lanes that hold the row. Every lane calls it. NaN
// when any of the 128 is NaN, as JAX's max (fmax_nan.cuh).
__device__ __forceinline__ float row_max(const float (&v)[8]) {
  float mx = v[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) mx = fmax_nan(mx, v[j]);
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    mx = fmax_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  return mx;
}

// 16-byte alignment of the operands and D % 4 == 0: score_tile's vec.
inline bool vec_operands(const void* a, const void* b, int D) {
  return D % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

}  // namespace sibrar
