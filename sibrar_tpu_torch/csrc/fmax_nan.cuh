// One NaN rule for every maximum the port's kernels take: JAX's. XLA's max
// (jnp.max, a Pallas block's .max) and torch.amax propagate NaN; fmaxf
// returns the other operand when one of the two is NaN, so a NaN lane
// would drop out of a window's maximum.
//
// fmax_nan is PTX max.NaN.f32 (sm_80 and later), one FMNMX.NAN: NaN (the
// canonical 0x7fffffff) when either operand is NaN, otherwise what fmaxf
// returns, bit for bit (signed zeros included: the two differ only in
// their NaN rule).
#pragma once

namespace sibrar {

__device__ __forceinline__ float fmax_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

}  // namespace sibrar
