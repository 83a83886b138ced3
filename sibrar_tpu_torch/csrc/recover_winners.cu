// K11 recover_winners: for each winner (b, s) of the peel's merge, its row of
// the gathered windows and what the row says about it.
//
//   row         = g[b, slots[b, s], :]                   (128 floats)
//   lane[b, s]  = first l with row[l] == v[b, s], else 128
//   n_hit[b, s] = number of l with row[l] == v[b, s]
//   wsel[b, s]  = widx[b, slots[b, s]]                   all int32 [B, kk]
//
// Replaces the Pallas kernel sibrar_tpu/ops/pallas_peel.py:654
// recover_winners (body :629), which copies the rows into VMEM scratch one
// scalar-indexed copy at a time and compares with lane-broadcast relayouts.
//
// Bound on the H100: bytes (each winner's 512-byte row, read once; 52 MB at
// B = 1024, kk = 100). Design: one warp per winner. Each lane loads one
// float4 of the row and compares it with the winner's value; a ballot finds
// the first lane with a hit, a shuffle brings that lane's 4-bit hit mask for
// the first equal element, and a warp sum of the popcounts gives the count.
// The [B, kk, 128] rows tensor and the [B, kk, m] one-hot of the XLA
// spelling never exist.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int W = 128;
constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
recover_winners_kernel(const float* __restrict__ g,
                       const int* __restrict__ widx,
                       const int* __restrict__ slots,
                       const float* __restrict__ v, int m, int kk,
                       int* __restrict__ lane_out, int* __restrict__ nhit_out,
                       int* __restrict__ wsel_out) {
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * WARPS + threadIdx.x / 32;
  const int64_t b = blockIdx.y;
  if (s >= kk) return;  // whole warps only
  const int64_t i = b * kk + s;
  const int slot = slots[i];
  const float val = v[i];
  const float4 x =
      reinterpret_cast<const float4*>(g + (b * m + slot) * W)[lane];
  const unsigned hits = (x.x == val ? 1u : 0u) | (x.y == val ? 2u : 0u) |
                        (x.z == val ? 4u : 0u) | (x.w == val ? 8u : 0u);
  const unsigned any = __ballot_sync(FULL, hits != 0u);
  const int count =
      __reduce_add_sync(FULL, static_cast<unsigned>(__popc(hits)));
  const int src = any ? __ffs(any) - 1 : 0;
  const unsigned src_hits = __shfl_sync(FULL, hits, src);
  if (lane == 0) {
    lane_out[i] = any ? src * 4 + __ffs(src_hits) - 1 : W;
    nhit_out[i] = count;
    wsel_out[i] = widx[b * m + slot];
  }
}

}  // namespace

extern "C" int sibrar_recover_winners(const void* g, const void* widx,
                                      const void* slots, const void* v, int B,
                                      int m, int kk, void* lane, void* n_hit,
                                      void* wsel, void* stream) {
  if (B == 0 || kk == 0) return 0;
  const dim3 grid((kk + WARPS - 1) / WARPS, B);
  recover_winners_kernel<<<grid, WARPS * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int*>(widx),
      static_cast<const int*>(slots), static_cast<const float*>(v), m, kk,
      static_cast<int*>(lane), static_cast<int*>(n_hit),
      static_cast<int*>(wsel));
  return static_cast<int>(cudaGetLastError());
}
