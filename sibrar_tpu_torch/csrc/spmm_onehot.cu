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
// shape (2,256 rows x 2,205 slots, ~39k live, h = 512) that is tens of MB
// against the 451 MB dense matrix and 115.5 GFLOP of the dense path.
//
// K6 spreads the work by live slot, not by row: the train batch's rows hold
// 9 live slots at the median and 2,205 at most, and a grid of one block per
// row ran as long as its longest row. Four launches on the caller's stream:
//   1. spmm_rows: one block per row compacts the row's live slots
//      (spmm_plan.cuh's compact_row: the mask read once, in aligned 16-byte
//      loads; the ids packed into the workspace) and sums a row of at most
//      SHORT = 32 of them itself (96 % of the train batch's rows): each
//      thread 4 values of h, 8 kernel rows' 16-byte loads in flight, in slot
//      order, so the sum is bit-equal to a serial one.
//   2. spmm_plan: cuts the longer rows into runs of at least 64 live slots.
//   3. spmm_sum: a persistent grid of warps over runs x 128 values of h, 16
//      kernel rows in flight per lane; a row of one run writes its sum, the
//      runs of a longer row store partial sums.
//   4. spmm_combine: per multi-run row, 8 warps each add a contiguous eighth
//      of its partial sums in order, then one warp adds the eight in order.
// No atomics: every call gives the same bits. The workspace
// (`sibrar_spmm_fwd_workspace` bytes) is fixed by B, L and H; nothing goes
// to the host.
//
// K7: one block per (row, 256-wide slice of h). The block stages the row's
// slots 256 at a time, compacting the live ones into shared memory in slot
// order (warp ballots plus a prefix over the 8 warps), and skips a chunk with
// no live slot. Each thread then owns one h and adds its g value into each
// staged row of dk with atomicAdd, so the order of the sums, and the last
// bits of dk, vary between runs.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "spmm_plan.cuh"

namespace {

// ------------------------------------------------------------------ K6
constexpr int RB = 128;        // threads of a spmm_rows block
constexpr int SHORT = 32;      // live slots spmm_rows sums itself
constexpr int ROW_DEPTH = 8;   // kernel rows in flight, spmm_rows
constexpr int SW = 4;          // warps of a spmm_sum block
constexpr int SUM_DEPTH = 16;  // kernel rows in flight, spmm_sum
constexpr int SUM_NA = 1;      // loads per lane per kernel row, spmm_sum
constexpr int CG = 8;          // warps of a spmm_combine block

// The nh values of h a unit covers, lane's share: (lane + 32 a) * VEC + e
// for a < NA, e < VEC (VEC = 4: 16-byte accesses; H % 4 == 0).
template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T ldg(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void add(float* acc, const T& q) {
    acc[0] += q.x; acc[1] += q.y; acc[2] += q.z; acc[3] += q.w;
  }
  static __device__ __forceinline__ void put(float* dst, const float* acc) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T ldg(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void add(float* acc, const T& q) {
    acc[0] += q;
  }
  static __device__ __forceinline__ void put(float* dst, const float* acc) {
    *dst = acc[0];
  }
};

// acc += the rows src(0), ..., src(n - 1) in order, DEPTH rows' loads
// issued before their adds (src(d) gives row d's first value of h)
template <int VEC, int NA, int DEPTH, typename Src>
__device__ __forceinline__ void add_rows(Src src, int n, int lane, int nh,
                                         float* acc) {
  using V = Vec<VEC>;
  for (int j0 = 0; j0 < n; j0 += DEPTH) {
    typename V::T q[DEPTH][NA];
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const float* row = src(j0 + d);  // every lane calls it (shuffles)
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const int e = (lane + 32 * a) * VEC;
        if (j0 + d < n && e < nh)
          q[d][a] = V::ldg(row + e);
      }
    }
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const int e = (lane + 32 * a) * VEC;
        if (j0 + d < n && e < nh) V::add(acc + a * VEC, q[d][a]);
      }
    }
  }
}

template <int VEC, int NA>
__device__ __forceinline__ void store(float* dst, int lane, int nh,
                                      const float* acc) {
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int e = (lane + 32 * a) * VEC;
    if (e < nh) Vec<VEC>::put(dst + e, acc + a * VEC);
  }
}

// One block per row: compacts the row's live slots (compact_row) and, for
// a row of at most SHORT of them, sums its kernel rows itself, each thread
// VEC values of h, ROW_DEPTH rows' loads in flight, in slot order. A
// longer row is left to the plan: counts[b] gets its count (0 once done).
template <int VEC>
__global__ void __launch_bounds__(RB)
spmm_rows(const int* __restrict__ cols, const bool* __restrict__ mask,
          const float* __restrict__ kernel, int L, int H,
          int* __restrict__ packed, int* __restrict__ counts,
          float* __restrict__ out) {
  __shared__ int scratch[33];
  __shared__ int s_ids[SHORT];
  const int64_t b = blockIdx.x;
  const int c = spmm::compact_row<RB>(cols, mask, L, b, packed, s_ids,
                                      SHORT, scratch);
  if (threadIdx.x == 0) counts[b] = c > SHORT ? c : 0;
  if (c > SHORT) return;
  using V = Vec<VEC>;
  for (int h0 = 0; h0 < H; h0 += RB * VEC) {
    const int e = h0 + threadIdx.x * VEC;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    for (int j0 = 0; j0 < c; j0 += ROW_DEPTH) {
      typename V::T q[ROW_DEPTH];
#pragma unroll
      for (int d = 0; d < ROW_DEPTH; ++d)
        if (j0 + d < c && e < H)
          q[d] = V::ldg(kernel + (int64_t)s_ids[j0 + d] * H + e);
#pragma unroll
      for (int d = 0; d < ROW_DEPTH; ++d)
        if (j0 + d < c && e < H) V::add(acc, q[d]);
    }
    if (e < H) V::put(out + b * H + e, acc);
  }
}

// A persistent grid of warps over the plan's units, each a run of one long
// row's live slots x HS values of h: the run's kernel rows summed in slot
// order, SUM_DEPTH rows' loads in flight, into the row's output (a row of
// one unit) or into the unit's partial sum.
template <int VEC, int NA>
__global__ void __launch_bounds__(SW * 32)
spmm_sum(const int* __restrict__ packed, const int* __restrict__ hdr,
         const int4* __restrict__ desc, const float* __restrict__ kernel,
         int L, int H, int n_hs, float* __restrict__ partial,
         float* __restrict__ out) {
  constexpr int HS = 32 * VEC * NA;
  const int lane = threadIdx.x & 31;
  const int64_t tasks = (int64_t)hdr[0] * n_hs;
  const int64_t step = (int64_t)gridDim.x * SW;
  int64_t task = (int64_t)blockIdx.x * SW + threadIdx.x / 32;
  int4 next = task < tasks ? desc[task / n_hs] : make_int4(0, 0, 0, 0);
  for (; task < tasks; task += step) {
    const int4 d = next;  // {row, first slot, end slot, multi-unit row}
    if (task + step < tasks) next = desc[(task + step) / n_hs];
    const int b = d.x;
    const int h0 = static_cast<int>(task % n_hs) * HS;
    const int nh = min(HS, H - h0);
    const int* ids = packed + (int64_t)b * L;
    const float* kh = kernel + h0;
    float acc[VEC * NA];
#pragma unroll
    for (int i = 0; i < VEC * NA; ++i) acc[i] = 0.0f;
    for (int c0 = d.y; c0 < d.z; c0 += 32) {
      const int n = min(32, d.z - c0);
      const int mine = lane < n ? ids[c0 + lane] : 0;
      add_rows<VEC, NA, SUM_DEPTH>(
          [&](int j) {
            const int id = __shfl_sync(0xffffffffu, mine, j & 31);
            return kh + (int64_t)id * H;
          },
          n, lane, nh, acc);
    }
    const int64_t u = task / n_hs;
    store<VEC, NA>(d.w ? partial + u * H + h0 : out + (int64_t)b * H + h0,
                   lane, nh, acc);
  }
}

// One block per (multi-unit row, 32 VEC values of h), grid-stride over the
// rows: warp g sums its contiguous eighth of the row's partial sums in
// order, then one warp adds the eight in order, so the bits are fixed.
template <int VEC>
__global__ void __launch_bounds__(CG * 32)
spmm_combine(const int* __restrict__ hdr, const int4* __restrict__ mrows,
             const float* __restrict__ partial, int H,
             float* __restrict__ out) {
  using V = Vec<VEC>;
  __shared__ float s_part[CG][32 * VEC];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int e = (blockIdx.y * 32 + lane) * VEC;
  const int n_rows = hdr[1];
  for (int r = blockIdx.x; r < n_rows; r += gridDim.x) {
    const int4 m = mrows[r];  // {row, first unit, units}
    const int per = (m.z + CG - 1) / CG;
    const int q0 = min(m.z, g * per), q1 = min(m.z, q0 + per);
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    const int h0 = blockIdx.y * 32 * VEC;
    add_rows<VEC, 1, 4>(
        [&](int q) { return partial + (int64_t)(m.y + q0 + q) * H + h0; },
        q1 - q0, lane, H - h0, acc);
#pragma unroll
    for (int i = 0; i < VEC; ++i) s_part[g][lane * VEC + i] = acc[i];
    __syncthreads();
    if (g == 0 && e < H) {
      float sum[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum[i] = s_part[0][lane * VEC + i];
      for (int k = 1; k < CG; ++k)
#pragma unroll
        for (int i = 0; i < VEC; ++i) sum[i] += s_part[k][lane * VEC + i];
      V::put(out + (int64_t)m.x * H + e, sum);
    }
    __syncthreads();
  }
}

// The plan, the sum pass (units of HS = 32 VEC NA values of h, a
// persistent grid of warps over up to 2 B units per slice of h) and the
// combine of the multi-unit rows.
template <int VEC, int NA>
void launch_long(int* w, const spmm::Layout& lay, const float* kernel,
                 int B, int L, int H, float* out, cudaStream_t s) {
  constexpr int HS = 32 * VEC * NA;
  const int n_hs = (H + HS - 1) / HS;
  static int per_sm = 0, sms = 0;
  if (per_sm == 0) {
    int dev;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, spmm_sum<VEC, NA>,
                                                  SW * 32, 0);
    per_sm = per_sm > 0 ? per_sm : 1;
  }
  const int64_t max_tasks = 2 * (int64_t)B * n_hs;
  const int grid = static_cast<int>(
      std::min<int64_t>((max_tasks + SW - 1) / SW, (int64_t)sms * per_sm));
  int* hdr = w + lay.hdr;
  int4* desc = reinterpret_cast<int4*>(w + lay.desc);
  int4* mrows = reinterpret_cast<int4*>(w + lay.mrows);
  float* partial = reinterpret_cast<float*>(w + lay.partial);
  spmm::spmm_plan<<<1, spmm::PT, 0, s>>>(w + lay.counts, B, hdr, desc,
                                          mrows);
  spmm_sum<VEC, NA><<<grid, SW * 32, 0, s>>>(w + lay.packed, hdr, desc,
                                             kernel, L, H, n_hs, partial,
                                             out);
  const dim3 cgrid(std::min(B, 2 * sms), (H + 32 * VEC - 1) / (32 * VEC));
  spmm_combine<VEC><<<cgrid, CG * 32, 0, s>>>(hdr, mrows, partial, H, out);
}

// ------------------------------------------------------------------ K7
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

// Bytes of the workspace sibrar_spmm_fwd takes for [B, L] rows and width H
// (the arrival counters sized for the narrowest slice of h, 32).
extern "C" long long sibrar_spmm_fwd_workspace(int B, int L, int H) {
  return spmm::Layout(B, L, H).words * 4;
}

extern "C" int sibrar_spmm_fwd(const void* cols, const void* mask,
                               const void* kernel, int B, int L, int H,
                               void* out, void* work, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (B >= (1 << 20)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const spmm::Layout lay(B, L, H);
  int* w = static_cast<int*>(work);
  const int* c = static_cast<const int*>(cols);
  const bool* m = static_cast<const bool*>(mask);
  const float* k = static_cast<const float*>(kernel);
  float* o = static_cast<float*>(out);
  const bool vec4 = H % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(kernel) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) {
    spmm_rows<4><<<B, RB, 0, s>>>(c, m, k, L, H, w + lay.packed,
                                  w + lay.counts, o);
    launch_long<4, SUM_NA>(w, lay, k, B, L, H, o, s);
  } else {
    spmm_rows<1><<<B, RB, 0, s>>>(c, m, k, L, H, w + lay.packed,
                                  w + lay.counts, o);
    launch_long<1, 4 * SUM_NA>(w, lay, k, B, L, H, o, s);
  }
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
