// K15: the score GEMM in one bf16 pass on the tensor cores, with the full
// variant's epilogue.
//
//   s[b, c]       = sum_d bf16(u[b, d]) * bf16(items[c, d])   (f32 sums)
//   wmax_t[w, b]  = max(s[b, 128 w : 128 w + 128])            f32 [C/128, B]
//
// bf16() is round-to-nearest-even. Products of two bf16 values are exact in
// f32, so the result differs from an f32 product of the rounded operands
// only by the order of the f32 sums.
//
// Replaces the Pallas kernel of tools/probe_gemm_precision.py:56 (body :43)
// at precision DEFAULT, which on the TPU is one bf16 pass of the matrix
// unit with f32 accumulation.
//
// Bound on the H100: bytes. At B = 1024, C = 501,760, D = 256 the product
// is 263 GFLOP (0.27 ms at 989 TFLOP/s dense bf16) against 2.59 GB moved
// (f32 operands read once, f32 scores and maxima written once: 0.77 ms at
// 3.35 TB/s). Design, simple first: a block owns a 64 x 128 tile, one
// window of 64 users, as in K2. Each stage loads a 32-deep slice of u and
// items as float4s, rounds them to bf16 into shared memory, and 8 warps
// (2 x 4) each run 2 x 2 wmma 16x16x16 bf16 fragments with f32
// accumulators. The accumulators then go through shared memory (reusing the
// operand buffers) so that K2's epilogue can read them back: each thread
// holds 4 rows x 8 columns, reduces them, a 16-lane shuffle reduces the row,
// and the scores leave as float4s. The maxima are the max of the very
// values stored, NaN where one of them is (fmax_nan.cuh). No wgmma, TMA or
// double buffering yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "fmax_nan.cuh"

namespace {

using namespace nvcuda;

constexpr int TM = 64;        // users per tile
constexpr int TN = 128;       // catalog rows per tile: one window
constexpr int TK = 32;        // depth of one stage
constexpr int LDA = TK + 8;   // bf16 row stride of the operand tiles
constexpr int LDC = TN + 4;   // f32 row stride of the accumulator tile
constexpr int OPERAND_BYTES = (TM + TN) * LDA * 2;
constexpr int TILE_BYTES = TM * LDC * 4;
constexpr int SMEM_BYTES =
    OPERAND_BYTES > TILE_BYTES ? OPERAND_BYTES : TILE_BYTES;

// rows [row0, row0 + rows) x depths [k0, k0 + TK) of the f32 matrix x
// [n, D] into dst [rows][LDA] as bf16; rows past n and depths past D read
// as zeros. D % 4 == 0, so a float4 lies wholly inside or outside D.
template <int kRows>
__device__ __forceinline__ void stage(const float* __restrict__ x, int n,
                                      int D, int row0, int k0,
                                      __nv_bfloat16* dst) {
  constexpr int kQuads = kRows * TK / 4;
#pragma unroll
  for (int q = threadIdx.x; q < kQuads; q += 256) {
    const int r = q / (TK / 4);
    const int k = (q % (TK / 4)) * 4;
    const int gr = row0 + r;
    const int gk = k0 + k;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gr < n && gk < D)
      v = *reinterpret_cast<const float4*>(x + static_cast<int64_t>(gr) * D
                                           + gk);
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(dst + r * LDA + k);
    out[0] = __floats2bfloat162_rn(v.x, v.y);
    out[1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

__global__ void __launch_bounds__(256)
score_bf16_kernel(const float* __restrict__ u, const float* __restrict__ items,
                  int B, int C, int D, float* __restrict__ scores,
                  float* __restrict__ wmax_t) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + TM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int warp = threadIdx.x / 32;
  const int wm = warp / 4;  // rows wm * 32 .. + 31 of the tile
  const int wn = warp % 4;  // columns wn * 32 .. + 31
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < D; k0 += TK) {
    stage<TM>(u, B, D, row0, k0, As);
    stage<TN>(items, C, D, col0, k0, Bs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      // items[c, k] at Bs[c * LDA + k]: the K x N operand, column-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn * 32 + j * 16) * LDA + kk, LDA);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the accumulators into Cs [TM][LDC] (over the operand tiles: every warp
  // passed the loop's last barrier)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  // K2's epilogue: thread (ty, tx) holds rows ty*4 .. +3, columns tx*4 .. +3
  // and 64 + tx*4 .. +3
  using sibrar::fmax_nan;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* crow = Cs + (ty * 4 + i) * LDC;
    const float4 v0 = *reinterpret_cast<const float4*>(crow + tx * 4);
    const float4 v1 = *reinterpret_cast<const float4*>(crow + 64 + tx * 4);
    float mx = fmax_nan(fmax_nan(fmax_nan(v0.x, v0.y), fmax_nan(v0.z, v0.w)),
                        fmax_nan(fmax_nan(v1.x, v1.y), fmax_nan(v1.z, v1.w)));
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmax_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const int r = row0 + ty * 4 + i;
    if (r < B) {
      float* srow = scores + static_cast<int64_t>(r) * C + col0;
      *reinterpret_cast<float4*>(srow + tx * 4) = v0;
      *reinterpret_cast<float4*>(srow + 64 + tx * 4) = v1;
      if (tx == 0) wmax_t[static_cast<int64_t>(blockIdx.x) * B + r] = mx;
    }
  }
}

}  // namespace

// scores [B, C] and wmax_t [C / 128, B]; C % 128 == 0, D % 4 == 0.
extern "C" int sibrar_score_bf16(const void* u, const void* items, int B,
                                 int C, int D, void* scores, void* wmax_t,
                                 void* stream) {
  if (B == 0 || C == 0) return 0;
  const dim3 grid(C / TN, (B + TM - 1) / TM);
  score_bf16_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(items), B, C, D,
      static_cast<float*>(scores), static_cast<float*>(wmax_t));
  return static_cast<int>(cudaGetLastError());
}
