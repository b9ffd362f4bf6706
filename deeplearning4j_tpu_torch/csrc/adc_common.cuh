// Shared pieces of the ADC (asymmetric distance computation) kernels,
// adc_pq.cu and adc_ivf_pq.cu.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace adc {

constexpr int kThreads = 256;
// Dynamic shared memory a block of an H100 may take (227 KB). A LUT larger
// than this is read from global memory in the same kernel.
constexpr long long kMaxSmem = 232448;

// Copy nfloat floats from global to shared memory with the whole block:
// 16-byte loads when the source is 16-byte aligned and nfloat % 4 == 0.
__device__ __forceinline__ void stage(float *__restrict__ dst,
                                      const float *__restrict__ src,
                                      long long nfloat) {
  if ((((uintptr_t)src) & 15) == 0 && (nfloat & 3) == 0) {
    const float4 *s4 = reinterpret_cast<const float4 *>(src);
    float4 *d4 = reinterpret_cast<float4 *>(dst);
    for (long long t = threadIdx.x; t < (nfloat >> 2); t += blockDim.x)
      d4[t] = __ldg(s4 + t);
  } else {
    for (long long t = threadIdx.x; t < nfloat; t += blockDim.x)
      dst[t] = __ldg(src + t);
  }
}

// A LUT entry: from shared memory (kSmem) or through the read-only cache.
template <bool kSmem>
__device__ __forceinline__ float lut_at(const float *p) {
  if constexpr (kSmem) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// The M codes of one row. kM == 8 takes one 8-byte load (the wrapper only
// picks it for an 8-byte-aligned table); kM == 0 loads byte by byte.
// Codes at or past ksub are clamped to ksub - 1, so a bad code can never
// read outside the LUT; the index builders never write one.
template <int kM>
__device__ __forceinline__ void load_codes(const uint8_t *__restrict__ row, int m0,
                                           int cnt, int ksub, int *c) {
  if constexpr (kM == 8) {
    const uint2 w = __ldg(reinterpret_cast<const uint2 *>(row));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      c[u] = min((int)((w.x >> (8 * u)) & 0xFFu), ksub - 1);
      c[u + 4] = min((int)((w.y >> (8 * u)) & 0xFFu), ksub - 1);
    }
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u)
      c[u] = u < cnt ? min((int)__ldg(row + m0 + u), ksub - 1) : 0;
  }
}

}  // namespace adc
