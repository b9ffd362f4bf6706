// What the bn_act_fwd and bn_act_bwd kernels share: element types, the
// activations they take, and the recomputed pre-activation.
//
// Every elementwise step rounds where the plain PyTorch version rounds
// (perf/kernels/bn_act.py): products and sums are __fmul_rn/__fadd_rn, never
// contracted into an FMA, and each step of a bf16/f16 expression is rounded
// to that type, as PyTorch's eager bf16 operators do. Given the same
// per-channel statistics, the kernels' elementwise results therefore equal
// the plain version's bitwise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace bn_act {

constexpr int kTC = 32;           // channels per block of a reduction kernel
constexpr int kTR = 8;            // row lanes per block of a reduction kernel
constexpr int kEltThreads = 256;  // threads per block of an elementwise kernel
constexpr int kEltBlocksMax = 132 * 16;

enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };
enum Act { kIdentity = 0, kRelu = 1, kLeakyRelu = 2 };

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  __device__ static float f(float v) { return v; }
  __device__ static float t(float v) { return v; }
};
template <> struct Cvt<__nv_bfloat16> {
  __device__ static float f(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 t(float v) { return __float2bfloat16_rn(v); }
};
template <> struct Cvt<__half> {
  __device__ static float f(__half v) { return __half2float(v); }
  __device__ static __half t(float v) { return __float2half_rn(v); }
};

// v rounded to T, as a float (the identity for float)
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return Cvt<T>::f(Cvt<T>::t(v));
}

// pre = T(T(z * T(scale)) + T(shift)), plus res rounded to T when given:
// scale and shift are cast to z's type before the multiply-add, as the JAX
// reference casts them (nn/conf/convolutional.py _bn_act_fwd_math).
// The same from the values of z and res (as floats; r is not read without
// RES).
template <typename T, bool RES>
__device__ __forceinline__ float pre_act_of(float z, float r, float sc, float sh) {
  float p = rnd<T>(__fmul_rn(z, rnd<T>(sc)));
  p = rnd<T>(__fadd_rn(p, rnd<T>(sh)));
  if (RES) p = rnd<T>(__fadd_rn(p, r));
  return p;
}

template <typename T, bool RES>
__device__ __forceinline__ float pre_act(const T *z, const T *res, long long i,
                                         float sc, float sh) {
  return pre_act_of<T, RES>(Cvt<T>::f(z[i]), RES ? Cvt<T>::f(res[i]) : 0.f, sc, sh);
}

template <typename T, int ACT>
__device__ __forceinline__ float act_fwd(float pre) {
  if (ACT == kRelu) return pre > 0.f ? pre : 0.f;
  if (ACT == kLeakyRelu) return pre >= 0.f ? pre : rnd<T>(__fmul_rn(pre, 0.01f));
  return pre;
}

// dout times the activation's derivative at pre, with JAX's values at the
// kinks: jax.nn.relu has derivative 0 at 0; leakyrelu (where(x >= 0, ...))
// has derivative 1 at 0.
template <typename T, int ACT>
__device__ __forceinline__ float act_bwd(float pre, float dout) {
  if (ACT == kRelu) return pre > 0.f ? dout : 0.f;
  if (ACT == kLeakyRelu) return pre >= 0.f ? dout : rnd<T>(__fmul_rn(dout, 0.01f));
  return dout;
}

// Grid of an elementwise kernel over `total` elements (grid-stride loop).
inline unsigned elt_blocks(long long total) {
  long long b = (total + kEltThreads - 1) / kEltThreads;
  return (unsigned)(b < kEltBlocksMax ? (b > 0 ? b : 1) : kEltBlocksMax);
}

// Sum one float per thread over the kTR row lanes of a (kTC, kTR) block, in
// lane order; the result is valid in lane ty == 0.
__device__ __forceinline__ float lane_sum(float (*buf)[kTC + 1], float v) {
  buf[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0)
    for (int i = 1; i < kTR; ++i) v = __fadd_rn(v, buf[i][threadIdx.x]);
  return v;
}

}  // namespace bn_act
