// K1 segment_gather: padded column ids of a batch of CSR rows.
//
//   cols[b, j] = indices[indptr[rows[b]] + j]   for j < len(rows[b]), else 0
//   mask[b, j] = j < len(rows[b])
//
// Replaces the Pallas kernels sibrar_tpu/ops/sparse.py:131 _segment_gather
// (flat indices resident in VMEM, 128-aligned block read + lane roll) and
// sparse.py:204 _segment_gather_dma (flat indices left in HBM, one async DMA
// per row). Both exist because the TPU's VMEM holds 4 MB of indices at most;
// on Hopper every row reads straight from device memory, so one kernel covers
// both, and the index array is never re-padded per call.
//
// Bound on the H100: bytes. Each output element costs one 4-byte read and a
// 5-byte write (int32 column + bool mask) and no arithmetic. Design: one
// block per row; consecutive threads copy consecutive positions, so the read
// of a row's segment and the writes of its output row are coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void segment_gather_kernel(const int* __restrict__ indptr,
                                      const int* __restrict__ indices,
                                      const int* __restrict__ rows, int L,
                                      int* __restrict__ cols,
                                      bool* __restrict__ mask) {
  const int64_t b = blockIdx.x;
  const int r = rows[b];
  const int start = indptr[r];
  const int len = indptr[r + 1] - start;
  int* out_cols = cols + b * L;
  bool* out_mask = mask + b * L;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const bool live = j < len;
    out_cols[j] = live ? indices[start + j] : 0;
    out_mask[j] = live;
  }
}

}  // namespace

extern "C" int sibrar_segment_gather(const void* indptr, const void* indices,
                                     const void* rows, int n_rows_out, int L,
                                     void* cols, void* mask, void* stream) {
  if (n_rows_out == 0 || L == 0) return 0;
  const int threads = L >= 256 ? 256 : ((L + 31) / 32) * 32;
  segment_gather_kernel<<<n_rows_out, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const int*>(rows), L, static_cast<int*>(cols),
      static_cast<bool*>(mask));
  return static_cast<int>(cudaGetLastError());
}
