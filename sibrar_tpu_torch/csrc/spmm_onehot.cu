// K6 spmm_fwd and K7 spmm_bwd: the interaction towers' first layer straight
// from the padded CSR rows, without the dense [B, n_cols] 0/1 matrix.
//
//   K6: out[b, h] = sum_{l : mask[b, l]} kernel[cols[b, l], h]
//   K7: dk[c, h] = sum_{(b, l) : mask[b, l], cols[b, l] == c} g[b, h]
//
// Replace the Pallas kernels sibrar_tpu/ops/pallas_spmm.py:67 _spmm_fwd and
// :127 _spmm_bwd (behind spmm_onehot :163): per nonzero, a dynamic-sublane
// [1, h] read-modify-write against every [kc, h] weight tile in VMEM, a
// serial scalar chain that lost to densify + MXU matmul on the TPU.
//
// Bound on the H100: bytes, and they depend on the batch. K6 reads cols and
// mask once and one kernel row per live slot; K7 reads them and g and writes
// every row of the [n_cols, h] gradient once. At the train shape (2,256
// rows x 2,205 slots, ~39k live, h = 512) that is tens of MB against the
// 451 MB dense matrix and 115.5 GFLOP of the dense path.
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
// K7 groups the live slots by column and sums each column's g rows in
// JAX's order, key (b >> 3, l, b & 7): _spmm_bwd walks row groups of 8,
// then slots, then the rows of the group, adding into a zeroed tile. So dk
// is bit-equal to JAX's and the same on every call; no float atomics. The
// train batch's 38,959 live slots hit 27,138 of 50,000 columns (1.44 per
// column hit), so the time is the 102 MB of dk, each row written once,
// +0.0 where no slot hits (no zero-fill beforehand). Five steps on the
// caller's stream, with a workspace fixed by B, L and n_cols
// (`sibrar_spmm_bwd_workspace`), nothing sent to the host:
//   1. clear the per-column counts;
//   2. spmm_bwd_slots<true>: a grid over the flat mask in aligned 4-byte
//      words counts each live slot into its column (integer atomics);
//   3. spmm_bwd_scan: the counts scanned into each column's first entry
//      (one tile of 4,096 columns per block, decoupled look-back); columns
//      of more than 32 entries listed;
//   4. spmm_bwd_slots<false>: each live slot's order key stored at its
//      column's next free entry (any order within the column);
//   5. spmm_bwd_sum: a warp per column of at most 32 entries ranks the
//      keys across its lanes and adds the g rows in key order from +0.0; a
//      column of more than 32 entries has a block that sorts its keys
//      (bitonic) first.
// Every dk row is written once, with 16-byte streaming stores: dk is twice
// the L2 and would evict the g rows the sums gather (with plain stores the
// train batch took 0.066 ms instead of 0.058 on an H100 SXM at 700 W).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "block_sort.cuh"
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
  // a store that leaves L2 first (streamed output)
  static __device__ __forceinline__ void put_cs(float* dst,
                                                const float* acc) {
    __stcs(reinterpret_cast<float4*>(dst),
           make_float4(acc[0], acc[1], acc[2], acc[3]));
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
  static __device__ __forceinline__ void put_cs(float* dst,
                                                const float* acc) {
    __stcs(dst, acc[0]);
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

template <int VEC, int NA, bool STREAM = false>
__device__ __forceinline__ void store(float* dst, int lane, int nh,
                                      const float* acc) {
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int e = (lane + 32 * a) * VEC;
    if (e >= nh) continue;
    if (STREAM)
      Vec<VEC>::put_cs(dst + e, acc + a * VEC);
    else
      Vec<VEC>::put(dst + e, acc + a * VEC);
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
constexpr int BT = 256;       // threads of a K7 block
constexpr int SCAN_PER = 4;   // counts per thread of spmm_bwd_scan
constexpr int SCAN_T = 1024;  // threads of spmm_bwd_scan
constexpr int SCAN_TILE = SCAN_T * SCAN_PER;
constexpr int WARP_MAX = 32;  // entries a column's warp sorts in registers
constexpr int SORT_SMEM = 4096;  // keys a big column sorts in shared memory
constexpr int COL_DEPTH = 2;  // g rows in flight per lane, spmm_bwd_sum
constexpr int BIG_DEPTH = 4;  // g rows in flight per thread, a big column
constexpr unsigned FULL = 0xffffffffu;

// Offsets, in 4-byte words, of K7's arrays in one workspace. The first
// `zeroed` words are cleared before the count.
struct BwdLayout {
  int64_t hdr, tiles, cursor, start, big, keys, zeroed, words;
  BwdLayout(int B, int L, int n_cols) {
    const int64_t n_tiles = (n_cols + SCAN_TILE - 1) / SCAN_TILE;
    hdr = 0;                        // [1] big columns, [2] scan tickets
    tiles = 4;                      // [n_tiles] u64 scan state per tile
    cursor = tiles + 2 * n_tiles;   // [n_cols] counts, then next free entry
    zeroed = cursor + n_cols;
    start = zeroed;                 // [n_cols + 1] first entry of a column
    big = start + n_cols + 1;       // [n_cols] columns of > WARP_MAX entries
    keys = big + n_cols;            // [B L] entry keys, grouped by column
    words = keys + (int64_t)B * L;
  }
};

// The order key of live slot (b, l): JAX's _spmm_bwd adds a column's
// contributions row group of 8 by row group, then slot by slot, then row
// by row within the group, so (b >> 3, l, b & 7) in that order of weight.
__device__ __forceinline__ unsigned order_key(unsigned b, unsigned l,
                                              unsigned L) {
  return ((b >> 3) * L + l) * 8u + (b & 7u);
}

__device__ __forceinline__ int row_of(unsigned key, unsigned L) {
  return static_cast<int>(((key >> 3) / L) * 8u + (key & 7u));
}

// Every live slot of the flat [B L] (cols, mask), read as aligned 4-byte
// mask words, 4 words in flight per thread (an aligned word that holds a
// byte of the mask lies in its allocation): COUNT adds one to its column's
// count; otherwise it takes the column's next free entry (the counts
// scanned into cursors) and stores its key there. A word's column ids are
// loaded, then its atomics issued, then its keys stored. A column's
// entries land in any order.
template <bool COUNT>
__global__ void __launch_bounds__(BT)
spmm_bwd_slots(const int* __restrict__ cols, const bool* __restrict__ mask,
               int64_t N, int L, int* __restrict__ cursor,
               unsigned* __restrict__ keys) {
  constexpr int U = 4;
  const uintptr_t a = reinterpret_cast<uintptr_t>(mask);
  const uintptr_t a0 = a & ~uintptr_t(3);
  const int lead = static_cast<int>(a - a0);
  const int64_t words = (lead + N + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * BT;
  for (int64_t q0 = (int64_t)blockIdx.x * BT + threadIdx.x; q0 < words;
       q0 += U * stride) {
    unsigned w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t q = q0 + u * stride;
      w[u] = q < words ? *reinterpret_cast<const unsigned*>(a0 + 4 * q) : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (w[u] == 0u) continue;
      const int64_t f0 = 4 * (q0 + u * stride) - lead;
      int c[4];
      bool live[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        live[i] = ((w[u] >> (8 * i)) & 0xffu) && f0 + i >= 0 && f0 + i < N;
        c[i] = live[i] ? cols[f0 + i] : 0;
      }
      if (COUNT) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (live[i]) atomicAdd(cursor + c[i], 1);
      } else {
        int pos[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (live[i]) pos[i] = atomicAdd(cursor + c[i], 1);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (live[i]) {
            const unsigned f = static_cast<unsigned>(f0 + i);
            const unsigned b = f / L;
            keys[pos[i]] = order_key(b, f - b * L, L);
          }
      }
    }
  }
}

// Exclusive scan of the counts into start[] (and the cursors), one tile of
// SCAN_TILE columns per block, tiles taken by ticket so a tile's
// predecessors are running or done: each block posts its tile's total,
// then its first warp reads 32 predecessors at a time and adds their
// totals back to the nearest inclusive prefix (decoupled look-back: a
// posted word is {1: total, 2: inclusive prefix} << 32 | value). Lists
// the columns of more than WARP_MAX entries in big[] (in any order).
__global__ void __launch_bounds__(SCAN_T)
spmm_bwd_scan(int* __restrict__ hdr, unsigned long long* tiles, int n_cols,
              int* __restrict__ cursor, int* __restrict__ start,
              int* __restrict__ big) {
  __shared__ int scratch[33];
  __shared__ int s_tile, s_prefix;
  if (threadIdx.x == 0) s_tile = atomicAdd(hdr + 2, 1);
  __syncthreads();
  const int tile = s_tile;
  const int c0 = tile * SCAN_TILE + threadIdx.x * SCAN_PER;
  int v[SCAN_PER], sum = 0;
#pragma unroll
  for (int i = 0; i < SCAN_PER; ++i) {
    v[i] = c0 + i < n_cols ? cursor[c0 + i] : 0;
    sum += v[i];
  }
  int total;
  const int before = spmm::block_scan(sum, scratch, total);
  if (threadIdx.x < 32) {
    typedef unsigned long long u64;
    const int lane = threadIdx.x;
    if (lane == 0)
      atomicExch(tiles + tile,
                 (u64(tile == 0 ? 2 : 1) << 32) | unsigned(total));
    int prefix = 0;
    for (int t = tile - 1; t >= 0; t -= 32) {  // warp-uniform
      const int j = t - lane;
      u64 w = 0;
      if (j >= 0) {
        do {
          w = *reinterpret_cast<volatile u64*>(tiles + j);
        } while ((w >> 32) == 0);
      }
      const unsigned incl = __ballot_sync(FULL, j >= 0 && (w >> 32) == 2);
      const int stop = incl ? __ffs(incl) - 1 : 31;  // nearest inclusive
      prefix += __reduce_add_sync(
          FULL, j >= 0 && lane <= stop ? static_cast<unsigned>(w) : 0u);
      if (incl) break;
    }
    if (lane == 0) {
      if (tile > 0)
        atomicExch(tiles + tile, (u64(2) << 32) | unsigned(prefix + total));
      if (c0 + SCAN_TILE >= n_cols) start[n_cols] = prefix + total;
      s_prefix = prefix;
    }
  }
  __syncthreads();
  int run = s_prefix + before;
#pragma unroll
  for (int i = 0; i < SCAN_PER; ++i) {
    const int c = c0 + i;
    if (c < n_cols) {
      start[c] = cursor[c] = run;
      if (v[i] > WARP_MAX) big[atomicAdd(hdr + 1, 1)] = c;
    }
    run += v[i];
  }
}

// dk row dst = the sum from +0.0 of the g rows that lanes o, ..., o + n - 1
// of `row` name, in that order, COL_DEPTH rows' loads in flight; +0.0 for
// n = 0. Every lane calls it.
template <int VEC, int NA>
__device__ __forceinline__ void write_column(const float* __restrict__ g,
                                             int H, int row, int o, int n,
                                             int lane, float* dst) {
  constexpr int HS = 32 * VEC * NA;
  for (int h0 = 0; h0 < H; h0 += HS) {
    const int nh = min(HS, H - h0);
    float acc[VEC * NA];
#pragma unroll
    for (int q = 0; q < VEC * NA; ++q) acc[q] = 0.0f;
    add_rows<VEC, NA, COL_DEPTH>(
        [&](int j) {
          return g + (int64_t)__shfl_sync(FULL, row, (o + j) & 31) * H + h0;
        },
        n, lane, nh, acc);
    store<VEC, NA, true>(dst + h0, lane, nh, acc);
  }
}

// Writes every row of dk. First the blocks take the columns of big[], one
// block each, grid-stride: the keys sorted by the block (in shared memory
// up to SORT_SMEM of them), then each thread adds VEC values of h over the
// g rows in key order. Then each warp takes one column (the grid covers
// them) of at most WARP_MAX entries: it ranks the keys across its lanes
// (keys are distinct), puts the rows in key order through shared memory
// and adds them (write_column); a column of none is +0.0.
// Every sum starts at +0.0 and adds one row at a time in key order: JAX's
// _spmm_bwd's order, so its bits.
template <int VEC, int NA>
__global__ void __launch_bounds__(BT, 4)
spmm_bwd_sum(const int* __restrict__ hdr, const int* __restrict__ big,
             const int* __restrict__ start, unsigned* keys,
             const float* __restrict__ g, int L, int H, int n_cols,
             float* __restrict__ dk) {
  using V = Vec<VEC>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  {
    __shared__ unsigned s_keys[SORT_SMEM];
    const int n_listed = hdr[1];
    for (int i = blockIdx.x; i < n_listed; i += gridDim.x) {
      const int c = big[i];
      const int s0 = start[c], n = start[c + 1] - s0;
      unsigned* k = keys + s0;
      if (n <= SORT_SMEM) {
        for (int j = threadIdx.x; j < n; j += BT) s_keys[j] = k[j];
        k = s_keys;
        __syncthreads();
      }
      sibrar::block_sort<false>(k, n);
      for (int e = threadIdx.x * VEC; e < H; e += BT * VEC) {
        float acc[VEC];
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
        for (int j0 = 0; j0 < n; j0 += BIG_DEPTH) {
          typename V::T rows[BIG_DEPTH];
#pragma unroll
          for (int d = 0; d < BIG_DEPTH; ++d)
            if (j0 + d < n)
              rows[d] = V::ldg(g + (int64_t)row_of(k[j0 + d], L) * H + e);
#pragma unroll
          for (int d = 0; d < BIG_DEPTH; ++d)
            if (j0 + d < n) V::add(acc, rows[d]);
        }
        V::put_cs(dk + (int64_t)c * H + e, acc);
      }
      __syncthreads();  // before the next column's keys overwrite s_keys
    }
  }
  __shared__ int s_rows[BT / 32][WARP_MAX];
  const int64_t c = (int64_t)blockIdx.x * (BT / 32) + warp;
  if (c >= n_cols) return;
  const int s0 = start[c], n = start[c + 1] - s0;
  if (n > WARP_MAX) return;  // a big column: written above
  const unsigned key = lane < n ? keys[s0 + lane] : 0u;
  int rank = 0;
  for (int j = 0; j < n; ++j) rank += __shfl_sync(FULL, key, j) < key;
  if (lane < n) s_rows[warp][rank] = row_of(key, L);
  __syncwarp();
  write_column<VEC, NA>(g, H, lane < n ? s_rows[warp][lane] : 0, 0, n, lane,
                        dk + c * H);
}

// The five steps on one stream: clear the counts, count, scan, place the
// keys, sum. The two passes over the mask run at most 8 blocks per SM,
// grid-stride.
template <int VEC, int NA>
cudaError_t launch_bwd(const int* cols, const bool* mask, const float* g,
                       int B, int L, int H, int n_cols, float* dk, int* w,
                       cudaStream_t s) {
  static int sms = 0;
  if (sms == 0) {
    int dev;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const BwdLayout lay(B, L, n_cols);
  const int64_t N = (int64_t)B * L;
  cudaError_t err = cudaMemsetAsync(w, 0, lay.zeroed * 4, s);
  if (err != cudaSuccess) return err;
  const int64_t words = (N + 3 + 3) / 4;
  const int grid = static_cast<int>(
      std::min<int64_t>((words + BT - 1) / BT, (int64_t)sms * 8));
  int* cursor = w + lay.cursor;
  unsigned* keys = reinterpret_cast<unsigned*>(w + lay.keys);
  spmm_bwd_slots<true><<<grid, BT, 0, s>>>(cols, mask, N, L, cursor, keys);
  spmm_bwd_scan<<<(n_cols + SCAN_TILE - 1) / SCAN_TILE, SCAN_T, 0, s>>>(
      w + lay.hdr, reinterpret_cast<unsigned long long*>(w + lay.tiles),
      n_cols, cursor, w + lay.start, w + lay.big);
  spmm_bwd_slots<false><<<grid, BT, 0, s>>>(cols, mask, N, L, cursor, keys);
  spmm_bwd_sum<VEC, NA><<<(n_cols + BT / 32 - 1) / (BT / 32), BT, 0, s>>>(
      w + lay.hdr, w + lay.big, w + lay.start, keys, g, L, H, n_cols, dk);
  return cudaSuccess;
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

// Bytes of the workspace sibrar_spmm_bwd takes for [B, L] rows and n_cols
// columns (the counts, the scan, and one key per slot of the mask).
extern "C" long long sibrar_spmm_bwd_workspace(int B, int L, int n_cols) {
  return BwdLayout(B, L, n_cols).words * 4;
}

extern "C" int sibrar_spmm_bwd(const void* cols, const void* mask,
                               const void* g, int B, int L, int H,
                               int n_cols, void* dk, void* work,
                               void* stream) {
  if (n_cols == 0 || H == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t N = (int64_t)B * L;
  if (N == 0)  // no slot: every row of dk is +0.0
    return static_cast<int>(
        cudaMemsetAsync(dk, 0, (size_t)n_cols * H * 4, s));
  // slots and order keys fit in 31 and 32 bits
  if (N >= (int64_t(1) << 31) ||
      ((int64_t)B + 7) / 8 * 8 * L > (int64_t(1) << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* c = static_cast<const int*>(cols);
  const bool* m = static_cast<const bool*>(mask);
  const float* gp = static_cast<const float*>(g);
  float* out = static_cast<float*>(dk);
  int* w = static_cast<int*>(work);
  const bool vec4 = H % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dk) % 16 == 0;
  const cudaError_t err =
      vec4 ? launch_bwd<4, 2>(c, m, gp, B, L, H, n_cols, out, w, s)
           : launch_bwd<1, 4>(c, m, gp, B, L, H, n_cols, out, w, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
