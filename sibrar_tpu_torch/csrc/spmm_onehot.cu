// K6 spmm_fwd and K7 spmm_bwd: the interaction towers' first layer straight
// from the padded CSR rows, without the dense [B, n_cols] 0/1 matrix.
//
//   K6: out[b, h] = sum_{l : mask[b, l]} kernel[cols[b, l], h]
//   K7: dk[c, h] += sum_{(b, l) : mask[b, l], cols[b, l] == c} g[b, h]
//
// Replace the Pallas kernels sibrar_tpu/ops/pallas_spmm.py:67 _spmm_fwd and
// :127 _spmm_bwd (behind spmm_onehot :163): per nonzero, a dynamic-sublane
// [1, h] read-modify-write against every [kc, h] weight tile in VMEM, a
// serial scalar chain that lost to densify + MXU matmul on the TPU.
//
// Bound on the H100: bytes, and they depend on the batch. K6 reads cols and
// mask once and one kernel row per live slot; K7 reads them and g and writes
// the whole [n_cols, h] gradient (the wrapper zero-fills it). At the train
// shape (2,256 rows x 2,205 slots, ~41.5k live, h = 512) that is tens of MB
// against the 451 MB dense matrix and 115.5 GFLOP of the dense path. Design:
// one block per (row, 256-wide slice of h). The block stages the row's slots
// 256 at a time, compacting the live ones into shared memory in slot order
// (warp ballots plus a prefix over the 8 warps), and skips a chunk with no
// live slot, so rows packed to the left (as K1 writes them) cost one pass over
// their length. Each thread then owns one h: K6 sums the staged kernel rows in
// slot order (one coalesced 128-byte read per warp per slot, deterministic);
// K7 adds its g value into each staged row of dk with atomicAdd, so the order
// of the sums, and the last bits of dk, vary between runs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 256;     // threads per block = h per block = slots staged per pass
constexpr int WARPS = TH / 32;

// Compacts the live slots of cols[l0, l0 + TH) into s_col (slot order) and
// returns their count; every thread of the block must call it.
__device__ __forceinline__ int stage_live(const int* __restrict__ cols,
                                          const bool* __restrict__ mask,
                                          int64_t row_off, int l0, int L,
                                          int* s_col, int* s_wcount) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int l = l0 + threadIdx.x;
  const bool live = l < L && mask[row_off + l];
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) s_wcount[warp] = __popc(ballot);
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int cnt = s_wcount[w];
    off += w < warp ? cnt : 0;
    total += cnt;
  }
  if (live) s_col[off + __popc(ballot & ((1u << lane) - 1u))] = cols[row_off + l];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(TH)
spmm_fwd_kernel(const int* __restrict__ cols, const bool* __restrict__ mask,
                const float* __restrict__ kernel, int L, int H,
                float* __restrict__ out) {
  __shared__ int s_col[TH];
  __shared__ int s_wcount[WARPS];
  const int64_t b = blockIdx.x;
  const int h = blockIdx.y * TH + threadIdx.x;
  float acc = 0.0f;
  for (int l0 = 0; l0 < L; l0 += TH) {
    const int n = stage_live(cols, mask, b * L, l0, L, s_col, s_wcount);
    if (h < H) {
#pragma unroll 4
      for (int j = 0; j < n; ++j) acc += kernel[(int64_t)s_col[j] * H + h];
    }
    __syncthreads();  // s_col is rewritten by the next pass
  }
  if (h < H) out[b * H + h] = acc;
}

__global__ void __launch_bounds__(TH)
spmm_bwd_kernel(const int* __restrict__ cols, const bool* __restrict__ mask,
                const float* __restrict__ g, int L, int H,
                float* __restrict__ dk) {
  __shared__ int s_col[TH];
  __shared__ int s_wcount[WARPS];
  const int64_t b = blockIdx.x;
  const int h = blockIdx.y * TH + threadIdx.x;
  const float gv = h < H ? g[b * H + h] : 0.0f;
  for (int l0 = 0; l0 < L; l0 += TH) {
    const int n = stage_live(cols, mask, b * L, l0, L, s_col, s_wcount);
    if (h < H) {
      for (int j = 0; j < n; ++j) atomicAdd(dk + (int64_t)s_col[j] * H + h, gv);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int sibrar_spmm_fwd(const void* cols, const void* mask,
                               const void* kernel, int B, int L, int H,
                               void* out, void* stream) {
  if (B == 0 || H == 0) return 0;
  const dim3 grid(B, (H + TH - 1) / TH);
  spmm_fwd_kernel<<<grid, TH, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const bool*>(mask),
      static_cast<const float*>(kernel), L, H, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sibrar_spmm_bwd(const void* cols, const void* mask,
                               const void* g, int B, int L, int H, void* dk,
                               void* stream) {
  if (B == 0 || H == 0 || L == 0) return 0;
  const dim3 grid(B, (H + TH - 1) / TH);
  spmm_bwd_kernel<<<grid, TH, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const bool*>(mask),
      static_cast<const float*>(g), L, H, static_cast<float*>(dk));
  return static_cast<int>(cudaGetLastError());
}
