// K18 adam_step: one Adam or AdamW step over a list of f32 tensors, in
// place, in one launch.
//
// Replaces no TPU kernel. On the TPU, XLA fuses optax's update chain
// (scale_by_adam, add_decayed_weights, scale) into one pass over each
// parameter; eager PyTorch has no such fusion, and the optimizer's loop of
// 13 elementwise launches a parameter moved ~124 bytes per element. This
// kernel stands in for XLA's fusion, for every parameter at once.
//
// Bound on the H100: bytes. Each element is read once from p, g, mu and nu
// (16 bytes) and written once to p, mu and nu (12 bytes): 28 bytes, nothing
// in between goes through device memory. SBNet's 52.5M parameter elements
// move 1.47 GB, 0.44 ms at 3.35 TB/s.
//
// Design: the tensors' table (four pointers, the element count and the
// running count of chunks of each tensor) is passed by value in the
// kernel's arguments, so one launch covers up to MAX_TENSORS tensors with
// no copy to the card and no wait. Each tensor is cut into chunks of CHUNK
// elements; the blocks, as many as fit on the SMs at once, walk the chunks
// of all the tensors in a grid-stride loop, so the blocks at work at any
// moment read neighbouring chunks. A full chunk whose four pointers are
// 16-byte aligned is read with float4 loads, UNROLL per array per thread,
// all issued before any arithmetic (128 bytes in flight a thread; the
// registers leave room for 4 blocks of 256 threads an SM), with the
// streaming cache hint: nothing is read twice. Any other chunk (a tensor's ragged end, a gradient that is a view
// at a 4-byte offset into the mesh's flat buffer) takes a scalar path with
// the same arithmetic. A null gradient reads as zeros. The decay's place
// (none, the gradient, the update) is a template argument, and the bias
// corrections are multiplications by their rounded reciprocals, as
// PyTorch divides a tensor by a number on the card: the arithmetic left is
// one division and one square root an element, and the kernel runs within
// a few per cent of one with the same loads and stores and no arithmetic.
//
// Arithmetic, in optax's order, each operation rounded as the plain
// version's own PyTorch operation on the card is (the two moment updates
// one fused multiply-add each, nothing else contracted):
//   Adam:  g += wd p
//   mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g^2
//   upd = (mu * (1 / c1)) / (sqrt(nu * (1 / c2)) + eps)
//   AdamW: upd += wd p
//   p -= lr upd
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;                    // float4s per array per thread
constexpr int CHUNK = THREADS * UNROLL * 4;  // elements a block takes at once
constexpr int MAX_TENSORS = 64;              // keeps the arguments < 4 KB

struct Table {
  float* p[MAX_TENSORS];
  const float* g[MAX_TENSORS];  // null: a zero gradient
  float* mu[MAX_TENSORS];
  float* nu[MAX_TENSORS];
  int64_t n[MAX_TENSORS];
  int chunk_end[MAX_TENSORS];  // chunks of tensors 0..t together
  int count;
};

struct Scalars {
  float b1, omb1, b2, omb2, inv_c1, inv_c2, eps, wd, lr;
};

enum Decay { NO_DECAY, DECAY_GRAD, DECAY_UPDATE };

template <Decay D>
__device__ __forceinline__ void adam(float& p, float g, float& m, float& v,
                                     const Scalars& s) {
  if (D == DECAY_GRAD) g = __fadd_rn(g, __fmul_rn(s.wd, p));
  m = __fmaf_rn(s.omb1, g, __fmul_rn(m, s.b1));
  v = __fmaf_rn(__fmul_rn(s.omb2, g), g, __fmul_rn(v, s.b2));
  float u = __fdiv_rn(__fmul_rn(m, s.inv_c1),
                      __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.inv_c2)), s.eps));
  if (D == DECAY_UPDATE) u = __fadd_rn(u, __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, u));
}

template <Decay D>
__device__ __forceinline__ void adam4(float4& p, const float4& g, float4& m,
                                      float4& v, const Scalars& s) {
  adam<D>(p.x, g.x, m.x, v.x, s);
  adam<D>(p.y, g.y, m.y, v.y, s);
  adam<D>(p.z, g.z, m.z, v.z, s);
  adam<D>(p.w, g.w, m.w, v.w, s);
}

template <Decay D>
__global__ void __launch_bounds__(THREADS)
adam_step_kernel(const Table t, const Scalars s) {
  const int chunks = t.chunk_end[t.count - 1];
  int k = 0;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    while (c >= t.chunk_end[k]) ++k;
    const int64_t start =
        static_cast<int64_t>(c - (k ? t.chunk_end[k - 1] : 0)) * CHUNK;
    const int64_t rest = t.n[k] - start;
    const int len = rest < CHUNK ? static_cast<int>(rest) : CHUNK;
    float* p = t.p[k] + start;
    const float* g = t.g[k] ? t.g[k] + start : nullptr;
    float* mu = t.mu[k] + start;
    float* nu = t.nu[k] + start;
    const uintptr_t bits = reinterpret_cast<uintptr_t>(p)
                           | reinterpret_cast<uintptr_t>(g)
                           | reinterpret_cast<uintptr_t>(mu)
                           | reinterpret_cast<uintptr_t>(nu);
    if (len == CHUNK && (bits & 15) == 0) {
      float4 pv[UNROLL], gv[UNROLL], mv[UNROLL], vv[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        const int i = threadIdx.x + j * THREADS;
        pv[j] = __ldcs(reinterpret_cast<const float4*>(p) + i);
        gv[j] = g ? __ldcs(reinterpret_cast<const float4*>(g) + i)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
        mv[j] = __ldcs(reinterpret_cast<const float4*>(mu) + i);
        vv[j] = __ldcs(reinterpret_cast<const float4*>(nu) + i);
      }
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        const int i = threadIdx.x + j * THREADS;
        adam4<D>(pv[j], gv[j], mv[j], vv[j], s);
        __stcs(reinterpret_cast<float4*>(p) + i, pv[j]);
        __stcs(reinterpret_cast<float4*>(mu) + i, mv[j]);
        __stcs(reinterpret_cast<float4*>(nu) + i, vv[j]);
      }
    } else {
      for (int i = threadIdx.x; i < len; i += THREADS) {
        float pi = p[i], mi = mu[i], vi = nu[i];
        adam<D>(pi, g ? g[i] : 0.f, mi, vi, s);
        p[i] = pi;
        mu[i] = mi;
        nu[i] = vi;
      }
    }
  }
}

// SMs x the blocks an SM holds at once, on the first device asked.
template <Decay D>
cudaError_t resident_blocks(int* out) {
  static int blocks = 0;
  if (blocks == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, adam_step_kernel<D>, THREADS, 0);
    if (err != cudaSuccess) return err;
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  *out = blocks;
  return cudaSuccess;
}

template <Decay D>
int launch(const Table& t, long long chunks, const Scalars& s,
           cudaStream_t stream) {
  int resident = 0;
  const cudaError_t err = resident_blocks<D>(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = chunks < resident ? chunks : resident;
  adam_step_kernel<D><<<static_cast<unsigned>(blocks), THREADS, 0,
                        stream>>>(t, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long sibrar_adam_step_max_tensors() { return MAX_TENSORS; }

// `table` holds `count` rows of five 64-bit values in host memory: the
// addresses of p, g (0: a zero gradient), mu and nu, and the element count
// (> 0). It is read before this call returns.
extern "C" int sibrar_adam_step(const void* table, int count, float b1,
                                float omb1, float b2, float omb2, float c1,
                                float c2, float eps, float wd, float lr,
                                int decay_grad, int decay_update,
                                void* stream) {
  if (count <= 0) return 0;
  if (count > MAX_TENSORS) return static_cast<int>(cudaErrorInvalidValue);
  const long long* rows = static_cast<const long long*>(table);
  Table t;
  long long chunks = 0;
  for (int k = 0; k < count; ++k) {
    const long long* row = rows + 5 * k;
    t.p[k] = reinterpret_cast<float*>(row[0]);
    t.g[k] = reinterpret_cast<const float*>(row[1]);
    t.mu[k] = reinterpret_cast<float*>(row[2]);
    t.nu[k] = reinterpret_cast<float*>(row[3]);
    t.n[k] = row[4];
    chunks += (row[4] + CHUNK - 1) / CHUNK;
    if (row[4] <= 0 || chunks > 0x7fffffff)
      return static_cast<int>(cudaErrorInvalidValue);
    t.chunk_end[k] = static_cast<int>(chunks);
  }
  t.count = count;
  // the reciprocals rounded as PyTorch rounds a divisor's on the card
  const Scalars s{b1, omb1, b2, omb2, 1.0f / c1, 1.0f / c2, eps, wd, lr};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (decay_grad) return launch<DECAY_GRAD>(t, chunks, s, st);
  if (decay_update) return launch<DECAY_UPDATE>(t, chunks, s, st);
  return launch<NO_DECAY>(t, chunks, s, st);
}
