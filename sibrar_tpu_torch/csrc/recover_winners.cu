// K11 recover_winners: the end of every peel selection. For user row b with
// the merge's winners (v [B, kk], positions p [B, kk] into the m * t peeled
// values) over the gathered windows g [B, m, 128] and their catalog ids
// widx [B, m], and each window's deepest peeled value last [B, m]:
//
//   slot        = p[b, s] / t                            (window slot)
//   lane        = first l with g[b, slot, l] == v[b, s], else 128
//   idx[b, s]   = widx[b, slot] * 128 + min(lane, 127)   (int64)
//   ok[b]       = all_s (n_hit == 1) && all_s (v[b, s] > -inf)
//                 && all_j (last[b, j] <= v[b, kk - 1])
//
// where n_hit counts the lanes equal to the winner. Comparisons are IEEE:
// a NaN winner hits no lane and fails the -inf test, a NaN k-th value
// fails every `last <=` test (built without fast-math).
//
// Replaces the Pallas kernel sibrar_tpu/ops/pallas_peel.py:654
// recover_winners (body :629) together with the XLA tail of _peel_select
// after it (:873-899: the window id, the catalog id and the three row
// flags), which the TPU copies row by row into VMEM scratch and then
// reduces in separate fusions.
//
// Bound on the H100: bytes. Each winner's 512-byte row, its p, v, widx
// entry and idx, and each row's m entries of `last` plus its flag, read or
// written once: 55.6 MB at B = 1,024, m = 168, kk = 100. Design: one block
// per user row, WARPS = 4 warps at 55 registers a thread, so that eight
// blocks fit on an SM and a batch of 1,024 rows runs in one wave. The
// row's winners go to the warps round robin, up to 32 at a time per warp.
// Lane i of a warp loads its winner's p, v and widx entry, then the warp
// walks the winners UNROLL at a time: each lane loads one float4 of every
// row before any compare. A ballot finds the first lane with a hit, a
// shuffle brings that lane's 4-bit hit mask, and a warp sum of the
// popcounts gives n_hit; the winner's own lane keeps both and writes idx,
// so the warp's idx stores coalesce. The block loads the row's `last`
// (coalesced) and the k-th value before the winners, so their latency
// hides under the rows', and __syncthreads_and reduces every thread's flag
// to ok. The [B, kk, 128] rows tensor of the XLA spelling and the dozen
// small launches of the tail never exist. Measured at the validation
// path's inputs on an H100 80GB HBM3 at 700 W (`tools/compare_builds.py
// --only recover_winners`): eight warps a row at 64 registers (four
// blocks an SM, two waves) took 0.0270 ms against four warps' 0.0244 at
// UNROLL = 8; UNROLL = 2, 4 and 6 at four warps took 0.0216-0.0221 ms, so
// the row loads a warp keeps in flight do not bound it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int W = 128;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int LAST_AHEAD = 2;  // entries of `last` a thread loads first
constexpr int UNROLL = 4;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS, 8)
recover_winners_kernel(const float* __restrict__ g,
                       const int* __restrict__ widx,
                       const int64_t* __restrict__ p, int64_t ld_p,
                       const float* __restrict__ v, int64_t ld_v,
                       const float* __restrict__ last, int m, int kk, int t,
                       int64_t* __restrict__ idx, bool* __restrict__ ok) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int64_t b = blockIdx.x;
  const float* gb = g + b * m * W;
  const int* wb = widx + b * m;
  const int64_t* pb = p + b * ld_p;
  const float* vb = v + b * ld_v;
  const float* lb = last + b * m;
  const float vk = vb[kk - 1];
  float ahead[LAST_AHEAD];
#pragma unroll
  for (int i = 0; i < LAST_AHEAD; ++i) {
    const int j = threadIdx.x + i * THREADS;
    ahead[i] = j < m ? lb[j] : -INFINITY;
  }
  bool good = true;

  // winners s = base + warp + WARPS * i, lane i holding winner i's inputs
  for (int base = 0; base < kk; base += WARPS * 32) {
    const int s = base + warp + WARPS * lane;
    const bool mine = s < kk;
    int slot = 0, wsel = 0;
    float val = 0.f;
    if (mine) {
      slot = static_cast<int>(pb[s] / t);
      val = vb[s];
      wsel = wb[slot];
      good &= val > -INFINITY;
    }
    const int first = base + warp;
    const int n = first < kk ? (kk - first + WARPS - 1) / WARPS : 0;
    const int count = n < 32 ? n : 32;
    int my_lane = W, my_hits = 0;
    for (int j0 = 0; j0 < count; j0 += UNROLL) {
      float4 x[UNROLL];
      float xv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int sl = __shfl_sync(FULL, slot, j0 + u);
        xv[u] = __shfl_sync(FULL, val, j0 + u);
        x[u] = j0 + u < count
                   ? reinterpret_cast<const float4*>(gb + sl * W)[lane]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float c = xv[u];
        const unsigned hits = (x[u].x == c ? 1u : 0u) |
                              (x[u].y == c ? 2u : 0u) |
                              (x[u].z == c ? 4u : 0u) |
                              (x[u].w == c ? 8u : 0u);
        const unsigned any = __ballot_sync(FULL, hits != 0u);
        const int n_hit =
            __reduce_add_sync(FULL, static_cast<unsigned>(__popc(hits)));
        const int src = any ? __ffs(any) - 1 : 0;
        const unsigned src_hits = __shfl_sync(FULL, hits, src);
        if (lane == j0 + u) {
          my_lane = any ? src * 4 + __ffs(src_hits) - 1 : W;
          my_hits = n_hit;
        }
      }
    }
    if (mine) {
      idx[b * kk + s] =
          static_cast<int64_t>(wsel) * W + (my_lane < W ? my_lane : W - 1);
      good &= my_hits == 1;
    }
  }

  // complete: no window's deepest peeled value above the k-th winner
#pragma unroll
  for (int i = 0; i < LAST_AHEAD; ++i) good &= ahead[i] <= vk;
  for (int j = threadIdx.x + LAST_AHEAD * THREADS; j < m; j += THREADS) {
    good &= lb[j] <= vk;
  }
  const int all = __syncthreads_and(good);
  if (threadIdx.x == 0) ok[b] = all != 0;
}

}  // namespace

extern "C" int sibrar_recover_winners(const void* g, const void* widx,
                                      const void* p, long long ld_p,
                                      const void* v, long long ld_v,
                                      const void* last, int B, int m, int kk,
                                      int t, void* idx, void* ok,
                                      void* stream) {
  if (B == 0) return 0;
  recover_winners_kernel<<<B, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int*>(widx),
      static_cast<const int64_t*>(p), ld_p, static_cast<const float*>(v),
      ld_v, static_cast<const float*>(last), m, kk, t,
      static_cast<int64_t*>(idx), static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}
