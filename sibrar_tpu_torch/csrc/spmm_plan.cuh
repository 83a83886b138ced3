// The live slots of a padded [B, L] (cols, mask) pair and a work plan over
// them, for the one-hot sparse products (K6 spmm_fwd; K7 can take the
// same pieces).
//
//   compact_row: the block of one row reads its mask once, with aligned
//     16-byte loads, and writes its live column ids in slot order to
//     packed[b * L + j] (and the first `keep` of them to shared memory).
//     Any mask: holes, empty rows, rows not packed left.
//   spmm_plan: one block cuts the rows that counts[] lists (count > 0)
//     into runs of `run` live slots (run = the larger of RUN_MIN and N / B
//     over their N live slots, so there are at most 2 B units), writes one
//     descriptor per unit {row, first slot, end slot, 1 if the row has
//     more than one unit}, the multi-unit rows' units first, and one
//     {row, first unit, units} per multi-unit row, a row's units in order.
//
// The workspace is fixed by B, L and H (`sibrar_spmm_fwd_workspace`), and
// no count goes to the host.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace spmm {

constexpr int RUN_MIN = 64;  // live slots per unit, at least
constexpr int PT = 1024;  // plan threads (one block)

// Offsets, in 4-byte words, of the plan's arrays in one workspace.
struct Layout {
  int64_t counts, hdr, desc, mrows, packed, partial, words;
  Layout(int B, int L, int H) {
    counts = 0;                          // [B] live slots of listed rows
    hdr = counts + B;                    // [0] units, [1] multi-unit rows
    desc = (hdr + 4 + 3) / 4 * 4;        // [2B] int4 per unit
    mrows = desc + 8 * (int64_t)B;       // [B] int4 per multi-unit row
    packed = mrows + 4 * (int64_t)B;     // [B, L] live ids, slot order
    partial = (packed + (int64_t)B * L + 3) / 4 * 4;  // [2B, H] f32
    words = partial + 2 * (int64_t)B * H;
  }
};

// Exclusive prefix sum of `v` over the block; `total` gets the sum.
// `scratch` holds 33 ints. Every thread must call it.
__device__ __forceinline__ int block_scan(int v, int* scratch, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {  // scan of the warps' sums
    const int w = lane < nw ? scratch[lane] : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += o;
    }
    scratch[lane] = wi - w;
    if (lane == 31) scratch[32] = wi;
  }
  __syncthreads();
  const int before = scratch[warp];
  total = scratch[32];
  __syncthreads();  // scratch is free again
  return before + incl - v;
}

// The live slots of row b, packed in slot order into packed[b * L + j]; the
// first `keep` also into s_ids. Returns the row's live count. Every thread
// of the block must call it; `scratch` holds 33 ints. Reads the mask in
// aligned 16-byte chunks (two per thread per tile): an aligned chunk that
// holds a byte of the row lies in the pages of the row's allocation.
template <int THREADS>
__device__ __forceinline__ int compact_row(
    const int* __restrict__ cols, const bool* __restrict__ mask, int L,
    int64_t b, int* __restrict__ packed, int* s_ids, int keep,
    int* scratch) {
  constexpr int CB = 32;  // mask bytes per thread per tile
  if (L == 0) return 0;
  const int64_t row = b * L;
  const uintptr_t a = reinterpret_cast<uintptr_t>(mask) + row;
  const uintptr_t a0 = a & ~uintptr_t(15);
  const int lead = static_cast<int>(a - a0);  // bytes before slot 0
  int base = 0;
  for (int t0 = 0; t0 < lead + L; t0 += THREADS * CB) {
    const int o = t0 + threadIdx.x * CB;  // byte offset from a0
    uint4 q[2];
#pragma unroll
    for (int k = 0; k < 2; ++k)
      q[k] = o + 16 * k < lead + L
                 ? *reinterpret_cast<const uint4*>(a0 + o + 16 * k)
                 : make_uint4(0, 0, 0, 0);
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < CB; ++i) {
      const uint4& v = q[i / 16];
      const int k = (i & 15) >> 2;
      const unsigned w = k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
      const int slot = o + i - lead;
      if (slot >= 0 && slot < L && ((w >> (8 * (i & 3))) & 0xffu))
        bits |= 1u << i;
    }
    int total;
    const int off = base + block_scan(__popc(bits), scratch, total);
#pragma unroll
    for (int i = 0; i < CB; ++i)  // all of the thread's loads in flight
      if (bits >> i & 1u) {
        const int j = off + __popc(bits & ((1u << i) - 1u));
        const int id = cols[row + o + i - lead];
        packed[row + j] = id;
        if (j < keep) s_ids[j] = id;
      }
    base += total;
  }
  __syncthreads();  // s_ids is complete
  return base;
}

__device__ __forceinline__ int units_of(int count, int run) {
  return (count + run - 1) / run;
}

// Sum of v over the block, added into *dst in shared memory.
__device__ __forceinline__ void block_add(long long v,
                                          unsigned long long* dst) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  if ((threadIdx.x & 31) == 0)
    atomicAdd(dst, static_cast<unsigned long long>(v));
}

// The plan of the listed rows (counts[b] > 0). Rows go to threads
// strided; units take their places by shared-memory atomics, so their
// order varies, but each row's runs, and so the sums, do not.
__global__ void __launch_bounds__(PT)
spmm_plan(const int* __restrict__ counts, int B, int* __restrict__ hdr,
          int4* __restrict__ desc, int4* __restrict__ mrows) {
  __shared__ unsigned long long n_live, n_multi;
  __shared__ int m_next, s_next, r_next;
  if (threadIdx.x == 0) n_live = n_multi = m_next = r_next = 0;
  __syncthreads();
  long long live = 0;
#pragma unroll 4
  for (int b = threadIdx.x; b < B; b += PT) live += counts[b];
  block_add(live, &n_live);
  __syncthreads();
  const int want = static_cast<int>((n_live + B - 1) / B);
  const int run = (max(RUN_MIN, want) + 31) / 32 * 32;
  long long multi = 0;
#pragma unroll 4
  for (int b = threadIdx.x; b < B; b += PT) {
    const int u = units_of(counts[b], run);
    multi += u > 1 ? u : 0;
  }
  block_add(multi, &n_multi);
  __syncthreads();
  if (threadIdx.x == 0) s_next = static_cast<int>(n_multi);
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += PT) {  // multi-unit rows first
    const int c = counts[b];
    const int u = units_of(c, run);
    if (u > 1) {
      const int off = atomicAdd(&m_next, u);
      for (int k = 0; k < u; ++k)
        desc[off + k] = make_int4(b, k * run, min(c, (k + 1) * run), 1);
      mrows[atomicAdd(&r_next, 1)] = make_int4(b, off, u, 0);
    } else if (u == 1) {
      desc[atomicAdd(&s_next, 1)] = make_int4(b, 0, c, 0);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hdr[0] = s_next;
    hdr[1] = r_next;
  }
}

}  // namespace spmm
