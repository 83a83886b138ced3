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
// users, H = 512) the GEMM is 115.5 GFLOP (1.72 ms at 67 TFLOP/s) against
// 0.56 GB of traffic. Tensor cores would mean TF32 or bf16 g (vec is 0/1 and
// exact either way), which changes the gradient; they stay off. Design:
// - the FFMA stage and thread mapping of score_tile.cuh: a block owns a
//   128 (c) x 128 (h) tile of dw, 8 x 8 accumulators per thread, 64 FFMA per
//   4 16-byte shared-memory loads, two blocks per SM;
// - both operands are row-major along r, so 16-byte cp.async copies land
//   them in shared memory already k-major ([r][c], [r][h]), the layout the
//   outer product reads: a ring of 3 stages of 32 rows (96 KB of dynamic
//   shared memory) keeps 2 stages of loads in flight behind the FFMA, with
//   one barrier per 2,048 FFMA of a thread (on an H100 SXM at 700 W: 2.56
//   ms at 8 rows per stage, 2.41 at 16, 2.39 at 32);
// - the kernel is built twice, for 16-byte copies (C and H multiples of 4,
//   aligned rows) and for 4-byte ones, so the common loop carries no
//   branch on it (2.39 -> 2.28 ms);
// - the raster runs the H / 128 h-tiles of one vec column panel on
//   consecutive blocks, so vec (451 MB at the train shape, 9x the L2)
//   leaves HBM about once, not once per h-tile;
// - the r loop stays inside the block: no atomics, deterministic sums.
//   Ragged C, H and R are masked here: zero-filled copies in, bounded
//   stores out.
// What is left: of the loop's 2,264 instructions per stage, 2,048 are
// FFMA and 128 shared-memory loads, so the FFMA issue rate tops out near
// 90 %; the kernel reaches 75 % of the f32 peak, cuBLAS's f32 GEMM of the
// same product 80 %. An 8 x 16 micro-tile has fewer loads per FFMA but
// needs over 200 registers, one block per SM, and ran 7-10 % slower.
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace {

using sibrar::THREADS;
using sibrar::TILE;
using sibrar::TK;

constexpr int KS = 32;     // rows of r per stage: KS / TK FFMA stages
constexpr int STAGES = 3;  // the cp.async ring
constexpr int SMEM = 2 * STAGES * KS * TILE * 4;  // dynamic: 96 KB

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// Rows r0 .. r0 + KS - 1 and columns col0 .. col0 + 127 of src [R, ncols]
// into stage s [KS][TILE]; out-of-range elements are zero-filled. 16-byte
// chunks, KS / 8 per thread: a warp copies 512 contiguous bytes of a row
// (kVec; else each chunk as four 4-byte copies).
template <bool kVec>
__device__ __forceinline__ void load_stage(float (*s)[TILE],
                                           const float* __restrict__ src,
                                           int R, int ncols, int r0,
                                           int col0) {
  const int q = (threadIdx.x % 32) * 4;
  const int col = col0 + q;
#pragma unroll
  for (int p = 0; p < KS / 8; ++p) {
    const int kk = threadIdx.x / 32 + 8 * p;
    const int r = r0 + kk;
    const float* row = src + static_cast<int64_t>(r) * ncols;
    if constexpr (kVec) {
      const bool ok = r < R && col < ncols;
      cp_async16(&s[kk][q], ok ? row + col : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = r < R && col + e < ncols;
        cp_async4(&s[kk][q + e], ok ? row + col + e : src, ok);
      }
    }
  }
}

// kVec: C and H multiples of 4, vec, g and dw 16-byte aligned
template <bool kVec>
__global__ void __launch_bounds__(THREADS, 2)
dw_matmul_kernel(const float* __restrict__ vec, const float* __restrict__ g,
                 int R, int C, int H, float* __restrict__ dw) {
  extern __shared__ __align__(16) float smem[];
  auto As = reinterpret_cast<float (*)[KS][TILE]>(smem);
  auto Bs = reinterpret_cast<float (*)[KS][TILE]>(smem + STAGES * KS * TILE);

  const int n_ht = (H + TILE - 1) / TILE;
  const int h0 = (blockIdx.x % n_ht) * TILE;
  const int c0 = (blockIdx.x / n_ht) * TILE;
  const int nk = (R + KS - 1) / KS;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      load_stage<kVec>(As[s], vec, R, C, s * KS, c0);
      load_stage<kVec>(Bs[s], g, R, H, s * KS, h0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int t = 0; t < nk; ++t) {
    // stage t has landed for this thread; the barrier makes it every
    // thread's, and frees the slot stage t - 1 used
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();
    const int next = t + STAGES - 1;
    if (next < nk) {
      load_stage<kVec>(As[next % STAGES], vec, R, C, next * KS, c0);
      load_stage<kVec>(Bs[next % STAGES], g, R, H, next * KS, h0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
#pragma unroll
    for (int k = 0; k < KS; k += TK)
      sibrar::fma_stage<TILE>(As[t % STAGES] + k, Bs[t % STAGES] + k, acc);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  const int tx = sibrar::thread_tx();
  const int ty = sibrar::thread_ty();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + sibrar::tile_row(ty, i);
    if (c >= C) continue;
    float* row = dw + static_cast<int64_t>(c) * H;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int h = h0 + sibrar::tile_col(tx, 4 * half);
      const float* v = &acc[i][4 * half];
      if (kVec && h < H) {
        *reinterpret_cast<float4*>(row + h) =
            make_float4(v[0], v[1], v[2], v[3]);
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
  // 16-byte copies and stores need rows of whole float4s, 16-byte aligned
  const bool vec16 = C % 4 == 0 && H % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(vec) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dw) % 16 == 0;
  const auto kernel = vec16 ? dw_matmul_kernel<true> : dw_matmul_kernel<false>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int blocks = (H + TILE - 1) / TILE * ((C + TILE - 1) / TILE);
  kernel<<<blocks, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vec), static_cast<const float*>(g), R, C, H,
      static_cast<float*>(dw));
  return static_cast<int>(cudaGetLastError());
}
