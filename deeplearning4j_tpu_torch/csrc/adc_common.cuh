// Shared pieces of the ADC (asymmetric distance computation) kernels,
// adc_pq.cu and adc_ivf_pq.cu: LUT staging and code loads, and the sizing
// and splitting of a persistent grid.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace adc {

constexpr int kThreads = 256;
// Dynamic shared memory a block of an H100 may take (227 KB). A LUT larger
// than this is read from global memory in the same kernel.
constexpr long long kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

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

// Where block i's contiguous range of items starts: i * items / grid, by a
// 32-bit division while the product fits (a 64-bit one costs about 0.5 us
// at a small n, where a block takes one item).
__device__ __forceinline__ int span_edge(unsigned i, unsigned items, unsigned grid) {
  const unsigned long long prod = (unsigned long long)i * items;
  return (int)(prod >> 32 ? prod / grid : (unsigned)prod / grid);
}

// Blocks of one kernel an SM at `threads` threads and `smem` bytes of
// dynamic shared memory, from the occupancy calculator, cached per device
// (the last smem asked for); raises the kernel's dynamic shared-memory limit
// to what its static shared memory leaves, once per device.
inline int blocks_per_sm(const void *kern, int threads, int smem,
                         std::atomic<long long> *cache, int *per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices) {
    const long long hit = cache[dev].load(std::memory_order_relaxed);
    if (hit != 0 && (hit >> 32) == smem) {
      *per_sm = (int)(hit & 0xFFFFFFFF);
      return 0;
    }
  }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(kMaxSmem - (long long)attr.sharedSizeBytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (*per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (dev < kMaxDevices) cache[dev].store(((long long)smem << 32) | *per_sm);
  return 0;
}

// The current device's SM count, cached per device.
inline int sm_count(int *sms) {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  *sms = dev < kMaxDevices ? cache[dev].load(std::memory_order_relaxed) : 0;
  if (*sms > 0) return 0;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices) cache[dev].store(*sms, std::memory_order_relaxed);
  return 0;
}

}  // namespace adc
