// K17 mask_where: out = where(mask, fill, x) over a contiguous f32 tensor
// and a byte mask of the same shape (torch.bool, or int8 where non-zero
// means masked).
//
// Replaces the Pallas kernel of tools/probe_pred_input.py:31 try_mask
// (body :38, call :42), which fed a bool or an int8 block to Mosaic to learn
// whether the dead-lane mask of the peel's window gather could be applied
// inside a kernel. Here a byte is a byte: both dtypes take one path.
//
// Bound on the H100: bytes. At [1024, 168, 128] it reads 88 MB of scores
// and 22 MB of mask and writes 88 MB: 198 MB, 0.059 ms at 3.35 TB/s.
// Design: one thread per 4 elements, a float4 of x with its 4 mask bytes
// (one 32-bit load), in a grid-stride loop; a scalar tail covers n % 4.
// The wrapper passes 16-byte-aligned x and out and a 4-byte-aligned mask.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
mask_where_kernel(const uint8_t* __restrict__ mask,
                  const float* __restrict__ x, float fill, int64_t n,
                  float* __restrict__ out) {
  const int64_t n4 = n / 4;
  const int64_t step = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * THREADS
                        + threadIdx.x;
  for (int64_t i = first; i < n4; i += step) {
    const uchar4 m = reinterpret_cast<const uchar4*>(mask)[i];
    float4 v = reinterpret_cast<const float4*>(x)[i];
    v.x = m.x ? fill : v.x;
    v.y = m.y ? fill : v.y;
    v.z = m.z ? fill : v.z;
    v.w = m.w ? fill : v.w;
    reinterpret_cast<float4*>(out)[i] = v;
  }
  for (int64_t i = n4 * 4 + first; i < n; i += step)
    out[i] = mask[i] ? fill : x[i];
}

}  // namespace

extern "C" int sibrar_mask_where(const void* mask, const void* x, float fill,
                                 long long n, void* out, void* stream) {
  if (n == 0) return 0;
  const long long quads = (n + 3) / 4;
  long long blocks = (quads + THREADS - 1) / THREADS;
  if (blocks > 65535) blocks = 65535;  // then the loop strides
  mask_where_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const float*>(x), fill,
      static_cast<int64_t>(n), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
