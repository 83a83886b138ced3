// K16: lane moves by an offset that lives in device memory (the tools/
// Mosaic capability probes), on 4-byte elements (f32 or int32, moved as
// bits).
//
//   roll_lanes    out[r, i] = x[r, (i + s) mod n], s = *shift
//                 (np.roll(x, -s, axis=1); any width n, any int32 s)
//   lane_slice    out[r, j] = x[r, s + j], j < width, s = *start
//   segment_roll  out[b, j] = flat[starts[b] + j], j < L
//
// Reads outside [0, n) (lane_slice) or [0, N) (segment_roll) give 0.
//
// Replaces the Pallas kernels of tools/probe_roll.py: probe_roll :26
// (pltpu.roll by a shift read from SMEM, call :34), probe_unaligned :45
// (a 128-lane slice at an unaligned data offset, call :53) and
// probe_segment :64 (aligned 128-lane blocks + roll, call :80). The TPU's
// roll rotates only power-of-two lane widths correctly; here the rotation is
// index arithmetic and holds at any width.
//
// Bound on the H100: bytes (each element read and written once), but at the
// probes' shapes (1-8 KB) a call is its launch: the wrappers do no more
// host work than the checks and the output's allocation, and the kernels
// one thread per element with 32-bit lane arithmetic. The shift and starts
// are read by the kernel itself, so no host sync sits between the op that
// computes them and this one. segment_roll follows the probe's
// pattern: a block owns one row, reads the 128-aligned run around it into
// shared memory (coalesced, in chunks of 1,024 outputs) and writes it back
// rotated by starts[b] % 128.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 1024;  // outputs of segment_roll per shared stage
constexpr int ALIGN = 128;

// one thread per element of a row: the row from blockIdx.y (strided past
// 65,535 rows), the lane in 32 bits; only the row's offset is 64-bit
__global__ void __launch_bounds__(THREADS)
roll_lanes_kernel(const uint32_t* __restrict__ x,
                  const int* __restrict__ shift, int64_t rows, int n,
                  uint32_t* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  int s = *shift % n;
  if (s < 0) s += n;
  const int j = i < n - s ? i + s : i - (n - s);  // (i + s) mod n
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y)
    out[r * n + i] = x[r * n + j];
}

__global__ void __launch_bounds__(THREADS)
lane_slice_kernel(const uint32_t* __restrict__ x,
                  const int* __restrict__ start, int64_t rows, int n,
                  int width, uint32_t* __restrict__ out) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= width) return;
  const int64_t p = static_cast<int64_t>(*start) + j;
  const bool in = p >= 0 && p < n;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y)
    out[r * width + j] = in ? x[r * n + p] : 0u;
}

__global__ void __launch_bounds__(THREADS)
segment_roll_kernel(const uint32_t* __restrict__ flat, int64_t n_flat,
                    const int* __restrict__ starts, int length,
                    uint32_t* __restrict__ out) {
  __shared__ uint32_t buf[CHUNK + ALIGN];
  const int64_t s = starts[blockIdx.x];
  const int64_t base = (s >= 0 ? s / ALIGN : (s - ALIGN + 1) / ALIGN) * ALIGN;
  const int off = static_cast<int>(s - base);  // s % 128, in [0, 128)
  uint32_t* orow = out + static_cast<int64_t>(blockIdx.x) * length;
  for (int c0 = 0; c0 < length; c0 += CHUNK) {
    const int n_out = min(CHUNK, length - c0);
    const int n_in = off + n_out;  // the aligned run base + c0 .. + n_in
    for (int t = threadIdx.x; t < n_in; t += THREADS) {
      const int64_t p = base + c0 + t;
      buf[t] = (p >= 0 && p < n_flat) ? flat[p] : 0u;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < n_out; t += THREADS)
      orow[c0 + t] = buf[off + t];
    __syncthreads();
  }
}

// lanes on x, rows on y (at most 65,535 blocks; the kernels stride past)
dim3 row_grid(int64_t rows, int lanes) {
  return dim3(static_cast<unsigned>((lanes + THREADS - 1) / THREADS),
              static_cast<unsigned>(rows < 65535 ? rows : 65535));
}

}  // namespace

// x, out [rows, n] with n > 0; shift: one int32 in device memory.
extern "C" int sibrar_roll_lanes(const void* x, const void* shift,
                                 long long rows, int n, void* out,
                                 void* stream) {
  if (rows == 0 || n == 0) return 0;
  roll_lanes_kernel<<<row_grid(rows, n), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const int*>(shift), rows, n,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x [rows, n], out [rows, width]; start: one int32 in device memory.
extern "C" int sibrar_lane_slice(const void* x, const void* start,
                                 long long rows, int n, int width, void* out,
                                 void* stream) {
  if (rows == 0 || width == 0) return 0;
  lane_slice_kernel<<<row_grid(rows, width), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const int*>(start), rows, n,
      width, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// flat [n_flat], starts int32 [n_rows], out [n_rows, length].
extern "C" int sibrar_segment_roll(const void* flat, long long n_flat,
                                   const void* starts, int n_rows, int length,
                                   void* out, void* stream) {
  if (n_rows == 0 || length == 0) return 0;
  segment_roll_kernel<<<n_rows, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(flat), n_flat,
      static_cast<const int*>(starts), length, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
