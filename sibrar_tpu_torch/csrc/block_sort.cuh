// Bitonic sort of a[0, n) by one block, for the sorts of K7 (a column's
// order keys) and K13 (a row's candidates). Every thread of the block calls
// it; `a` is in shared or device memory and owned by the block. The merge
// of each stage compares mirror positions, so every compare moves the
// element that goes first to the lower position, and the positions past n
// (virtual last elements) never move: any n, no padding.
#pragma once

namespace sibrar {

template <bool DESCENDING, typename T>
__device__ void block_sort(T* a, int n) {
  int p = 1;
  while (p < n) p <<= 1;
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += blockDim.x) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = j == (k >> 1) ? lo ^ (k - 1) : lo + j;
        if (hi < n) {
          const T x = a[lo], y = a[hi];
          if (DESCENDING ? x < y : y < x) {
            a[lo] = y;
            a[hi] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace sibrar
