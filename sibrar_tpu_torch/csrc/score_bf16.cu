// K15: the score GEMM in one bf16 pass on the tensor cores, with the full
// variant's epilogue.
//
//   s[b, c]       = sum_d bf16(u[b, d]) * bf16(items[c, d])   (f32 sums)
//   wmax_t[w, b]  = max(s[b, 128 w : 128 w + 128])            f32 [C/128, B]
//
// bf16() is round-to-nearest-even. Products of two bf16 values are exact in
// f32, so the result differs from an f32 product of the rounded operands
// only by the order of the f32 sums (within D 2^-24 (|u~| @ |i~|^T)).
//
// Replaces the Pallas kernel of tools/probe_gemm_precision.py:56 (body :43)
// at precision DEFAULT, which on the TPU is one bf16 pass of the matrix
// unit with f32 accumulation; its block holds all 1,024 users x 1,024 items
// and reads the items once.
//
// Bound on the H100: bytes. At B = 1024, C = 501,760, D = 256 the product
// is 263 GFLOP (0.27 ms at 989 TFLOP/s dense bf16) against 2.59 GB moved
// (f32 operands read once, f32 scores and maxima written once: 0.77 ms at
// 3.35 TB/s). The design keeps every byte but those off the HBM:
//
//   1. score_bf16_round_u (prologue): u rounded to bf16 once into the
//      workspace, zero-padded to pairs of 64-row chunks and to 256-deep
//      segments, each (chunk, segment) a 32 KB image of the shared-memory
//      tile wgmma reads (K-major, 64-deep K-blocks of 128-byte rows,
//      128-byte swizzle). At B = 1,024 it is 0.5 MB and stays in L2.
//   2. score_bf16_main: a persistent grid, one block of two warpgroups per
//      SM, walks over tiles of 256 items (two windows). The block rounds the
//      tile to bf16 once into shared memory in the same swizzled layout
//      (128 KB: the items leave the HBM once, not once per 64 users), then
//      all users pass over it in chunks of 64: thread 0 streams each chunk's
//      image into a ring of two stages with one bulk copy (TMA,
//      cp.async.bulk, completion on an mbarrier), and each warpgroup runs
//      wgmma m64n128k16 over one window of the tile from shared memory, the
//      f32 sums in registers. Each warpgroup holds two accumulator sets:
//      chunk m + 1's wgmma runs on the tensor cores while chunk m's scores
//      leave, so the SM's stores do not wait on its products. In the
//      accumulator layout a row's 128 window values sit in the 4 lanes of a
//      quad, so the window maximum is 32 thread-local fmax_nan plus two
//      shuffles. The scores pass through a small per-warp staging in shared
//      memory so that each store instruction writes a row's 512 bytes
//      whole (the accumulator layout gives 32-byte pieces of 8 rows), as
//      streaming stores (st.global.cs): the 2.06 GB of scores would
//      otherwise evict the u images the blocks read again.
//
// Depths past D are zeros on both operands. A D above 256 runs as several
// 256-deep segments over each tile; every segment after the first adds the
// partial sums the previous one stored (the block that stores a score
// reloads it, after the __syncthreads that retire the segment's chunks),
// and the last one takes the maxima. A last tile of one window is computed
// by both warpgroups; only the first loads, stores and takes maxima.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fmax_nan.cuh"

namespace {

constexpr int WIN = 128;             // items per window: one warpgroup's N
constexpr int TILE_N = 2 * WIN;      // items per tile: a window per warpgroup
constexpr int CHUNK_M = 64;          // users per chunk: wgmma's M
constexpr int KBLK = 64;             // depths per K-block: a 128-byte bf16 row
constexpr int SEG_KB = 4;            // K-blocks per segment
constexpr int SEG_D = SEG_KB * KBLK;  // depths per segment
constexpr int THREADS = 256;         // two warpgroups
constexpr int STAGES = 2;            // u chunks in flight
constexpr int ROW_BYTES = 128;
constexpr int ITEM_KB_BYTES = TILE_N * ROW_BYTES;   // one K-block of a tile
constexpr int STAGE_KB_BYTES = CHUNK_M * ROW_BYTES;  // one K-block of a chunk
constexpr int ITEM_BYTES = SEG_KB * ITEM_KB_BYTES;   // 128 KB
constexpr int STAGE_BYTES = SEG_KB * STAGE_KB_BYTES;  // 32 KB
// each warp's score staging: 8 rows of a window, padded so that the
// accumulator layout's writes hit 32 banks
constexpr int OUT_LD = WIN + 4;
constexpr int OUT_BYTES = (THREADS / 32) * 8 * OUT_LD * 4;  // 33 KB
constexpr int SMEM_BYTES =
    1024 + ITEM_BYTES + STAGES * STAGE_BYTES + OUT_BYTES + 64;

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// byte offset of 16-byte chunk c (of 8 in a 128-byte row) in row r of a
// K-block: the 128-byte swizzle wgmma and TMA use (chunk ^ row % 8)
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * ROW_BYTES + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // RNE
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 consecutive f32 of row `row` from depth d0 as bf16 (uint4); depths past
// D read as zeros (D % 4 == 0: a float4 lies wholly inside or outside D)
__device__ __forceinline__ uint4 round8(const float* __restrict__ x,
                                        int64_t row, int D, int d0) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
  const float* p = x + row * D + d0;
  if (d0 < D) a = __ldcs(reinterpret_cast<const float4*>(p));  // read once
  if (d0 + 4 < D) b = __ldcs(reinterpret_cast<const float4*>(p + 4));
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                    pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

// --------------------------------------------------------------- prologue
// ws[m][g][kb][r][128 B]: chunk m (64 users), segment g, K-block kb, row r,
// its 16-byte chunks swizzled; one thread per 16 bytes
__global__ void __launch_bounds__(256)
score_bf16_round_u(const float* __restrict__ u, int B, int D, int n_seg,
                   int64_t n_vec, uint4* __restrict__ ws) {
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
       t < n_vec; t += static_cast<int64_t>(gridDim.x) * 256) {
    const int phys = static_cast<int>(t & 7);
    const int r = static_cast<int>((t >> 3) & (CHUNK_M - 1));
    const int kb = static_cast<int>((t >> 9) & (SEG_KB - 1));
    const int64_t mg = t >> 11;  // m * n_seg + g
    const int g = static_cast<int>(mg % n_seg);
    const int64_t row = (mg / n_seg) * CHUNK_M + r;
    const int d0 = g * SEG_D + kb * KBLK + ((phys ^ (r & 7)) << 3);
    ws[t] = row < B ? round8(u, row, D, d0) : make_uint4(0, 0, 0, 0);
  }
}

// ------------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma's shared-memory matrix descriptor: K-major rows of 128 bytes,
// 128-byte swizzle, 8-row groups 1,024 bytes apart
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one bulk copy of `bytes` from global `src` to shared `dst`, completing
// on mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// wgmma fence / wait around it
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i)                                                         \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A[64 x 16] B[16 x 128], A and B K-major bf16 in shared memory;
// accumulate = 0 starts the sums from zero
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef ACC8

// ------------------------------------------------------------ main kernel
__global__ void __launch_bounds__(THREADS, 1)
score_bf16_main(const float* __restrict__ items, const uint4* __restrict__ ws,
                int B, int C, int D, float* __restrict__ scores,
                float* __restrict__ wmax_t) {
  extern __shared__ unsigned char smem_raw[];
  // 1,024-byte alignment: the swizzle is a function of the address bits
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  unsigned char* item_s = smem;
  unsigned char* stage_s = smem + ITEM_BYTES;
  float* out_s = reinterpret_cast<float*>(stage_s + STAGES * STAGE_BYTES)
                 + (threadIdx.x / 32) * 8 * OUT_LD;  // this warp's staging
  uint64_t* full = reinterpret_cast<uint64_t*>(stage_s + STAGES * STAGE_BYTES
                                               + OUT_BYTES);

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // this warpgroup's window of the tile
  const int n_chunks = 2 * cdiv(B, 2 * CHUNK_M);  // even: chunks in pairs
  const int n_seg = cdiv(D, SEG_D);
  const int n_tiles = cdiv(C, TILE_N);
  const int my_tiles = blockIdx.x < n_tiles
                           ? cdiv(n_tiles - blockIdx.x, gridDim.x) : 0;
  const int64_t n_loads = static_cast<int64_t>(my_tiles) * n_seg * n_chunks;
  const unsigned char* ws_bytes = reinterpret_cast<const unsigned char*>(ws);

  // chunk image `i` of this block's sequence (tile, segment, chunk) into
  // stage i % STAGES
  auto issue = [&](int64_t i) {
    const int m = static_cast<int>(i % n_chunks);
    const int g = static_cast<int>((i / n_chunks) % n_seg);
    const int s = static_cast<int>(i % STAGES);
    bulk_load(smem_addr(stage_s + s * STAGE_BYTES),
              ws_bytes + (static_cast<int64_t>(m) * n_seg + g) * STAGE_BYTES,
              STAGE_BYTES, smem_addr(full + s));
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) bar_init(smem_addr(full + s));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int64_t i = 0; i < STAGES && i < n_loads; ++i) issue(i);
  }
  __syncthreads();

  // accumulator layout of m64n128: warp q of the warpgroup holds rows
  // 16 q + lane / 4 and + 8; d[4 j + {0, 1}] at columns 8 j + 2 (lane % 4)
  // + {0, 1} of the first row, d[4 j + {2, 3}] of the second
  const int lane = tid % 32;
  const int row_in_chunk = ((tid % 128) / 32) * 16 + lane / 4;
  const int col_in_win = 2 * (lane % 4);
  uint32_t b_base = 0;  // this warpgroup's window in the item tile
  bool owner = true;    // this warpgroup loads and stores its window

  // wgmma over the whole segment of chunk `i` (stage i % STAGES) into d,
  // depths past D included (zeros on both sides); asynchronous
  auto mma = [&](float (&d)[64], int64_t i) {
    const int s = static_cast<int>(i % STAGES);
    bar_wait(smem_addr(full + s), static_cast<uint32_t>((i / STAGES) & 1));
    const uint32_t a_base = smem_addr(stage_s + s * STAGE_BYTES);
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int k = 0; k < SEG_D / 16; ++k) {
      const int kb = k / 4;
      const int off = (k % 4) * 32;  // 16 bf16 along the row
      wgmma_128(d, desc(a_base + kb * STAGE_KB_BYTES + off),
                desc(b_base + kb * ITEM_KB_BYTES + off), k > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  };
  // waits for chunk i's sums; once both warpgroups have them, its stage
  // takes chunk i + STAGES
  auto retire = [&](float (&d)[64], int64_t i) {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);
    __syncthreads();
    if (tid == 0 && i + STAGES < n_loads) issue(i + STAGES);
  };
  // chunk m's scores (plus the earlier segments' partial sums) out, 8 rows
  // of the warp at a time through its staging, each row's 512 bytes in one
  // coalesced streaming store; in the last segment its window maxima too
  auto epilogue = [&](float (&d)[64], int m, int win, int g, bool last_seg) {
    using sibrar::fmax_nan;
    const int r0 = m * CHUNK_M + row_in_chunk;
    float* p0 = scores + static_cast<int64_t>(r0) * C + win * WIN
                + col_in_win;
    float* p1 = p0 + static_cast<int64_t>(8) * C;
    const bool ok0 = owner && r0 < B, ok1 = owner && r0 + 8 < B;
    if (g > 0) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (ok0) {
          const float2 o = *reinterpret_cast<const float2*>(p0 + 8 * j);
          d[4 * j] += o.x;
          d[4 * j + 1] += o.y;
        }
        if (ok1) {
          const float2 o = *reinterpret_cast<const float2*>(p1 + 8 * j);
          d[4 * j + 2] += o.x;
          d[4 * j + 3] += o.y;
        }
      }
    }
    float mx0 = d[0], mx1 = d[2];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx0 = fmax_nan(mx0, fmax_nan(d[4 * j], d[4 * j + 1]));
      mx1 = fmax_nan(mx1, fmax_nan(d[4 * j + 2], d[4 * j + 3]));
    }
    // the warp's rows row8 + rr (first half) and row8 + 8 + rr (second)
    const int row8 = r0 - lane / 4;
    float* out_row = scores + static_cast<int64_t>(row8) * C + win * WIN
                     + 4 * lane;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(out_s + (lane / 4) * OUT_LD + 8 * j
                                   + col_in_win) =
            make_float2(d[4 * j + 2 * half], d[4 * j + 2 * half + 1]);
      __syncwarp();
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const float4 v =
            *reinterpret_cast<const float4*>(out_s + rr * OUT_LD + 4 * lane);
        if (owner && row8 + 8 * half + rr < B)
          __stcs(reinterpret_cast<float4*>(
                     out_row + static_cast<int64_t>(8 * half + rr) * C), v);
      }
      __syncwarp();
    }
    if (!last_seg) return;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmax_nan(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmax_nan(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    if (lane % 4 == 0) {
      float* w = wmax_t + static_cast<int64_t>(win) * B;
      if (ok0) w[r0] = mx0;
      if (ok1) w[r0 + 8] = mx1;
    }
  };

  int64_t it = 0;  // this block's chunk sequence number
  float acc0[64], acc1[64];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int c0 = tile * TILE_N;
    const int rows = min(TILE_N, C - c0);  // 256, or 128 at the end
    // a last tile of one window: both warpgroups compute it and the first
    // alone loads and stores (no branch on the thread around the wgmma
    // pipeline: ptxas serializes wgmma in such paths; the predicates sit in
    // the epilogue)
    const int wsel = wg * WIN < rows ? wg : 0;
    owner = wsel == wg;
    const int win = c0 / WIN + wsel;
    b_base = smem_addr(item_s) + wsel * WIN * ROW_BYTES;
    for (int g = 0; g < n_seg; ++g) {
      // the tile's depths [g SEG_D, + SEG_D) as bf16: a warp reads one item
      // row segment (1 KB) per pass; the wgmma reads of the previous
      // segment all retired before its last chunk's barrier
#pragma unroll 8
      for (int v = tid; v < rows * (SEG_D / 8); v += THREADS) {
        const int n = v / (SEG_D / 8);
        const int lc = v % (SEG_D / 8);
        const uint4 val = round8(items, c0 + n, D, g * SEG_D + lc * 8);
        *reinterpret_cast<uint4*>(item_s + (lc / 8) * ITEM_KB_BYTES
                                  + swizzled(n, lc % 8)) = val;
      }
      // the generic-proxy stores above, before wgmma reads them
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();

      // two accumulator sets: chunk m + 1's wgmma runs while chunk m's
      // scores leave (n_chunks is even; the last pair is peeled so that no
      // wgmma sits under a branch)
      const bool last_seg = g == n_seg - 1;
      mma(acc0, it);
      for (int m = 0; m + 2 < n_chunks; m += 2) {
        retire(acc0, it);
        mma(acc1, it + 1);
        epilogue(acc0, m, win, g, last_seg);
        retire(acc1, ++it);
        mma(acc0, it + 1);
        epilogue(acc1, m + 1, win, g, last_seg);
        ++it;
      }
      retire(acc0, it);
      mma(acc1, it + 1);
      epilogue(acc0, n_chunks - 2, win, g, last_seg);
      retire(acc1, ++it);
      epilogue(acc1, n_chunks - 1, win, g, last_seg);
      ++it;
    }
  }
}

int n_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace

// Bytes of the workspace sibrar_score_bf16 takes for u [B, D]: u as bf16,
// one 32 KB image per 64-user chunk (an even number of them) and 256-deep
// segment.
extern "C" long long sibrar_score_bf16_workspace(int B, int D) {
  return static_cast<long long>(2 * cdiv(B, 2 * CHUNK_M)) * cdiv(D, SEG_D)
         * STAGE_BYTES;
}

// scores [B, C] and wmax_t [C / 128, B]; C % 128 == 0, D % 4 == 0;
// workspace: sibrar_score_bf16_workspace(B, D) bytes, 16-byte aligned.
extern "C" int sibrar_score_bf16(const void* u, const void* items, int B,
                                 int C, int D, void* scores, void* wmax_t,
                                 void* workspace, void* stream) {
  if (B == 0 || C == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_vec = sibrar_score_bf16_workspace(B, D) / 16;
  const int64_t want = (n_vec + 255) / 256;
  score_bf16_round_u<<<static_cast<unsigned>(want < 4096 ? want : 4096), 256,
                       0, st>>>(static_cast<const float*>(u), B, D,
                                cdiv(D, SEG_D), n_vec,
                                static_cast<uint4*>(workspace));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool sized = false;
  if (!sized) {
    err = cudaFuncSetAttribute(score_bf16_main,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const int n_tiles = cdiv(C, TILE_N);
  const int grid = n_tiles < n_sms() ? n_tiles : n_sms();
  score_bf16_main<<<grid, THREADS, SMEM_BYTES, st>>>(
      static_cast<const float*>(items), static_cast<const uint4*>(workspace),
      B, C, D, static_cast<float*>(scores), static_cast<float*>(wmax_t));
  return static_cast<int>(cudaGetLastError());
}
