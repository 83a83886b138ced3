// K4 peel_values: the top-t distinct values of each 128-wide row.
//
//   vals[r, i] = i-th largest distinct value of x[r, :], descending,
//                -inf once the row runs out of distinct values
//   last[r]    = vals[r, t - 1]
//
// over x [R, 128]; a row holding a NaN gives NaN in every round (the max of
// JAX's kernel and of the plain version propagates it). The serving path
// calls it on the gathered windows [B, m, 128] (R = B * m), so vals is
// [B, m, t], read as [B, m * t], and last is [B, m].
//
// Replaces the Pallas kernels sibrar_tpu/ops/pallas_peel.py:240
// peel_values_grouped (rows transposed onto lanes so the output lands
// lane-compact, [t, B * m]) and pallas_peel.py:188 peel_values (row-flat,
// taken when B % 16 != 0). Both layouts are Mosaic workarounds; here one
// kernel writes the grouped layout directly, and the row-flat variant is
// the same call with m = 1.
//
// Bound on the H100: bytes, one 512-byte read per row and t + 1 values
// written. A warp per row with a max over its four values per lane and a
// 5-step shuffle butterfly every round issues ~22 instructions and 5 shuffles
// per lane per round, more than the bytes take. Design: 8 lanes per row (4
// rows per warp), 16 values per lane read as four coalesced 16-byte loads.
// Each lane sorts its values once into a descending list of its top 8 (two
// 8-input networks and a bitonic merge); a round then reads every lane's
// head, takes the row's max in a 3-step butterfly, and the lanes whose head
// equals it pop it, and every copy behind it, so all tied lanes clear at once
// (JAX's rule). A lane whose list runs dry while it may hold more values
// rebuilds it from its registers below the round's max. A vote ends the
// rounds once every row of the warp is out of values; the values of a row
// are stored by its 8 lanes together, one coalesced store per 8 rounds.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;      // warps per block
constexpr int LANES = 8;      // lanes per row
constexpr int ROWS = 32 / LANES;  // rows per warp
constexpr int VALS = 128 / LANES; // values per lane
constexpr int LIST = 8;       // sorted head list per lane
constexpr unsigned FULL = 0xffffffffu;

// a >= b afterwards
__device__ __forceinline__ void cas(float& a, float& b) {
  const float hi = fmaxf(a, b);
  b = fminf(a, b);
  a = hi;
}

// Sorts v[0..8) descending (Batcher's 19-comparator network).
__device__ __forceinline__ void sort8(float* v) {
  cas(v[0], v[2]); cas(v[1], v[3]); cas(v[4], v[6]); cas(v[5], v[7]);
  cas(v[0], v[4]); cas(v[1], v[5]); cas(v[2], v[6]); cas(v[3], v[7]);
  cas(v[0], v[1]); cas(v[2], v[3]); cas(v[4], v[5]); cas(v[6], v[7]);
  cas(v[2], v[4]); cas(v[3], v[5]);
  cas(v[1], v[4]); cas(v[3], v[6]);
  cas(v[1], v[2]); cas(v[3], v[4]); cas(v[5], v[6]);
}

// list = the 8 largest of v[0..16) (with repeats), descending; with
// `below`, only the values < thr count. Returns whether the lane may hold
// live values outside the list (the list is full of live values).
template <bool BELOW>
__device__ __forceinline__ bool build(const float* v, float thr, float* l) {
  float a[8], b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = !BELOW || v[i] < thr ? v[i] : -CUDART_INF_F;
    b[i] = !BELOW || v[i + 8] < thr ? v[i + 8] : -CUDART_INF_F;
  }
  sort8(a);
  sort8(b);
  // the top 8 of both, as a bitonic sequence, then its merge
#pragma unroll
  for (int i = 0; i < 8; ++i) l[i] = fmaxf(a[i], b[7 - i]);
#pragma unroll
  for (int d = 4; d > 0; d >>= 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if ((i & d) == 0) cas(l[i], l[i + d]);
  }
  return l[LIST - 1] > -CUDART_INF_F;
}

template <int TC>
__global__ void __launch_bounds__(WARPS * 32)
peel_values_kernel(const float* __restrict__ x, int64_t R, int t_rt,
                   float* __restrict__ vals, float* __restrict__ last) {
  const int t = TC > 0 ? TC : t_rt;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (LANES - 1);
  const int grp = lane / LANES;
  const int64_t r =
      ((int64_t)blockIdx.x * WARPS + threadIdx.x / 32) * ROWS + grp;
  const bool live_row = r < R;

  float v[VALS];
  bool has_nan = false;
  if (live_row) {
    const float4* row = reinterpret_cast<const float4*>(x + r * 128);
#pragma unroll
    for (int k = 0; k < VALS / 4; ++k) {
      const float4 q = row[k * LANES + sub];
      v[4 * k] = q.x; v[4 * k + 1] = q.y; v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
#pragma unroll
    for (int i = 0; i < VALS; ++i) has_nan |= v[i] != v[i];
  }
  const unsigned nan_bits = __ballot_sync(FULL, has_nan);
  const bool nan_row = (nan_bits >> (grp * LANES)) & ((1u << LANES) - 1u);
  if (!live_row || nan_row) {  // nothing to peel: out of the votes at once
#pragma unroll
    for (int i = 0; i < VALS; ++i) v[i] = -CUDART_INF_F;
  }
  float l[LIST];
  bool more = build<false>(v, 0.0f, l);

  bool done = __all_sync(FULL, l[0] == -CUDART_INF_F);
  float keep = -CUDART_INF_F, out = -CUDART_INF_F;
#pragma unroll
  for (int round = 0; round < t; ++round) {
    float mx = -CUDART_INF_F;
    if (!done) {  // warp-uniform
      mx = l[0];
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      if (l[0] == mx && mx > -CUDART_INF_F) {
        // pop the head and every copy of it behind
#pragma unroll
        for (int p = 0; p < LIST; ++p) {
          if (l[0] != mx) break;
#pragma unroll
          for (int i = 0; i < LIST - 1; ++i) l[i] = l[i + 1];
          l[LIST - 1] = -CUDART_INF_F;
        }
        if (l[0] == -CUDART_INF_F && more) more = build<true>(v, mx, l);
      }
      done = __all_sync(FULL, l[0] == -CUDART_INF_F);
    }
    out = nan_row ? CUDART_NAN_F : mx;
    const int slot = round & (LANES - 1);
    if (slot == sub) keep = out;
    if (slot == LANES - 1 || round == t - 1) {
      if (live_row && sub <= slot)
        vals[r * t + (round - slot) + sub] = keep;
    }
  }
  if (live_row && sub == 0) last[r] = out;
}

}  // namespace

extern "C" int sibrar_peel_values(const void* x, long long R, int t,
                                  void* vals, void* last, void* stream) {
  if (R == 0 || t == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((R + WARPS * ROWS - 1) / (WARPS * ROWS));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* vp = static_cast<float*>(vals);
  float* lp = static_cast<float*>(last);
  if (t == 8)
    peel_values_kernel<8><<<blocks, WARPS * 32, 0, s>>>(xp, R, t, vp, lp);
  else
    peel_values_kernel<0><<<blocks, WARPS * 32, 0, s>>>(xp, R, t, vp, lp);
  return static_cast<int>(cudaGetLastError());
}
