// bn_act_bwd_v1: the first design of bn_act_bwd (scalar loads, threads
// along C), kept as the yardstick its redesign (bn_act_bwd.cu) is timed
// against (chip_smoke.py's "previous_ms"). Nothing on the port's path
// launches it. Its kernels keep the bn_bwd_ mark of the family.
//
// The backward of bn_act_fwd through the batch statistics, from z and the
// O(C) saves only.
//
// Replaces the TPU kernel deeplearning4j_tpu/perf/pallas/bn.py::bn_act_bwd
// (body _bwd_kernel). With scale = gamma*inv, shift = beta - mean*scale:
//
//   pre    = T(T(z*T(scale)) + T(shift)) [+ res]   (recomputed, not saved)
//   dpre   = dout * act'(pre)                      (in z's type)
//   xhat   = (z - mean) * inv                      (float32)
//   dgamma = sum dpre*xhat, dbeta = sum dpre       (float32, over the n rows)
//   dz     = T(scale * (dpre - dbeta/n - xhat * (dgamma/n)))
//
// and dpre itself when res is given (the residual input's gradient).
//
// Bound on an H100 SXM (3.35 TB/s): bytes. The function reads z and dout
// (and res) once and writes dz (and dpre) once. At ResNet50's stem at batch
// 128 (1,605,632 x 64, bf16) that is 617 MB, about 184 us.
//
// Design: the same row blocking as bn_act_fwd, for the same reason (a
// channel column of all rows does not fit on an SM).
//   1. bn_bwd_partials, (channel tiles x row blocks) of (32 x 8) threads,
//      threads along C: recompute pre, dpre and xhat, write dpre when res is
//      given, and per block the per-channel partial sums of dpre*xhat and
//      dpre (row lanes added in lane order).
//   2. bn_bwd_finalize, one thread per channel: add the partials in block
//      order (in double), write dgamma/dbeta and the per-channel
//      coefficients of phase 3.
//   3. bn_bwd_dz, elementwise: recompute pre, dpre, xhat and write dz.
// No atomics: the order of every sum is fixed by the shape, so two runs
// agree bitwise. Phase 3 reads z, dout (and res) again: the kernel moves
// about 1.7x the bytes of its bound.

#include <stdint.h>

#include "bn_act_common.cuh"

namespace {

using namespace bn_act;

template <typename T, int ACT, bool RES>
__global__ void __launch_bounds__(kTC *kTR)
bn_bwd_partials(const T *__restrict__ z, const T *__restrict__ res,
                const T *__restrict__ dout, const T *__restrict__ gamma,
                const T *__restrict__ beta, const float *__restrict__ mean,
                const float *__restrict__ inv, long long n, int C, long long rpb,
                float *__restrict__ pg, float *__restrict__ pb, T *__restrict__ dpre) {
  __shared__ float bg[kTR][kTC + 1], bb[kTR][kTC + 1];
  const int c = blockIdx.x * kTC + threadIdx.x;
  const long long r0 = (long long)blockIdx.y * rpb;
  const long long r1 = min(n, r0 + rpb);
  float g = 0.f, b = 0.f;
  if (c < C) {
    const float m = mean[c], iv = inv[c];
    const float sc = __fmul_rn(Cvt<T>::f(gamma[c]), iv);
    const float sh = __fsub_rn(Cvt<T>::f(beta[c]), __fmul_rn(m, sc));
#pragma unroll 2
    for (long long r = r0 + threadIdx.y; r < r1; r += kTR) {
      const long long i = r * C + c;
      const float d = act_bwd<T, ACT>(pre_act<T, RES>(z, res, i, sc, sh),
                                      Cvt<T>::f(dout[i]));
      if (RES) dpre[i] = Cvt<T>::t(d);
      const float xh = __fmul_rn(__fsub_rn(Cvt<T>::f(z[i]), m), iv);
      g = __fmaf_rn(d, xh, g);
      b = __fadd_rn(b, d);
    }
  }
  g = lane_sum(bg, g);
  b = lane_sum(bb, b);
  if (threadIdx.y == 0 && c < C) {
    pg[(long long)blockIdx.y * C + c] = g;
    pb[(long long)blockIdx.y * C + c] = b;
  }
}

// coef holds, per channel: scale, shift, dbeta/n, dgamma/n.
template <typename T>
__global__ void bn_bwd_finalize(const float *__restrict__ pg, const float *__restrict__ pb,
                                int nrb, int C, long long n, const T *__restrict__ gamma,
                                const T *__restrict__ beta, const float *__restrict__ mean,
                                const float *__restrict__ inv, float *dgamma,
                                float *dbeta, float *coef) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  double G = 0.0, B = 0.0;
  for (int k = 0; k < nrb; ++k) {
    G += pg[(long long)k * C + c];
    B += pb[(long long)k * C + c];
  }
  const float dg = (float)G, db = (float)B, nf = (float)n;
  dgamma[c] = dg;
  dbeta[c] = db;
  const float sc = __fmul_rn(Cvt<T>::f(gamma[c]), inv[c]);
  coef[c] = sc;
  coef[C + c] = __fsub_rn(Cvt<T>::f(beta[c]), __fmul_rn(mean[c], sc));
  coef[2 * C + c] = __fdiv_rn(db, nf);
  coef[3 * C + c] = __fdiv_rn(dg, nf);
}

template <typename T, int ACT, bool RES>
__global__ void bn_bwd_dz(const T *__restrict__ z, const T *__restrict__ res,
                          const T *__restrict__ dout, const float *__restrict__ mean,
                          const float *__restrict__ inv, const float *__restrict__ coef,
                          long long total, int C, T *__restrict__ dz) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const float sc = coef[c];
    const float d = act_bwd<T, ACT>(pre_act<T, RES>(z, res, i, sc, coef[C + c]),
                                    Cvt<T>::f(dout[i]));
    const float xh = __fmul_rn(__fsub_rn(Cvt<T>::f(z[i]), mean[c]), inv[c]);
    const float t = __fsub_rn(__fsub_rn(d, coef[2 * C + c]), __fmul_rn(xh, coef[3 * C + c]));
    dz[i] = Cvt<T>::t(__fmul_rn(sc, t));
  }
}

template <typename T, int ACT, bool RES>
int run_act(const T *z, const T *res, const T *dout, const T *gamma, const T *beta,
            const float *mean, const float *inv, long long n, int C, T *dz,
            float *dgamma, float *dbeta, T *dpre, float *scratch, int nrb,
            long long rpb, cudaStream_t st) {
  float *pg = scratch, *pb = scratch + (long long)nrb * C;
  float *coef = pb + (long long)nrb * C;
  cudaError_t err;
  bn_bwd_partials<T, ACT, RES><<<dim3((C + kTC - 1) / kTC, nrb), dim3(kTC, kTR), 0, st>>>(
      z, res, dout, gamma, beta, mean, inv, n, C, rpb, pg, pb, dpre);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bn_bwd_finalize<T><<<(C + 127) / 128, 128, 0, st>>>(pg, pb, nrb, C, n, gamma, beta,
                                                      mean, inv, dgamma, dbeta, coef);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long total = n * (long long)C;
  bn_bwd_dz<T, ACT, RES><<<elt_blocks(total), kEltThreads, 0, st>>>(
      z, res, dout, mean, inv, coef, total, C, dz);
  return (int)cudaGetLastError();
}

template <typename T, int ACT>
int run_res(const void *z, const void *res, const void *dout, const void *gamma,
            const void *beta, const float *mean, const float *inv, long long n, int C,
            void *dz, float *dgamma, float *dbeta, void *dpre, float *scratch, int nrb,
            long long rpb, cudaStream_t st) {
  if (res)
    return run_act<T, ACT, true>((const T *)z, (const T *)res, (const T *)dout,
                                 (const T *)gamma, (const T *)beta, mean, inv, n, C,
                                 (T *)dz, dgamma, dbeta, (T *)dpre, scratch, nrb, rpb, st);
  return run_act<T, ACT, false>((const T *)z, nullptr, (const T *)dout, (const T *)gamma,
                                (const T *)beta, mean, inv, n, C, (T *)dz, dgamma, dbeta,
                                nullptr, scratch, nrb, rpb, st);
}

template <typename T>
int run(int act, const void *z, const void *res, const void *dout, const void *gamma,
        const void *beta, const float *mean, const float *inv, long long n, int C,
        void *dz, float *dgamma, float *dbeta, void *dpre, float *scratch, int nrb,
        long long rpb, cudaStream_t st) {
  if (act == kRelu)
    return run_res<T, kRelu>(z, res, dout, gamma, beta, mean, inv, n, C, dz, dgamma,
                             dbeta, dpre, scratch, nrb, rpb, st);
  if (act == kLeakyRelu)
    return run_res<T, kLeakyRelu>(z, res, dout, gamma, beta, mean, inv, n, C, dz,
                                  dgamma, dbeta, dpre, scratch, nrb, rpb, st);
  return run_res<T, kIdentity>(z, res, dout, gamma, beta, mean, inv, n, C, dz, dgamma,
                               dbeta, dpre, scratch, nrb, rpb, st);
}

}  // namespace

// Scratch: 2 * nrb * C + 4 * C floats; row blocks as in bn_act_fwd_launch.
// res and dpre are null together. Returns a cudaError_t.
extern "C" int bn_act_bwd_v1_launch(int dtype, int act, const void *z, const void *gamma,
                                    const void *beta, const void *res, const float *mean,
                                    const float *inv, const void *dout, long long n, int C,
                                    void *dz, float *dgamma, float *dbeta, void *dpre,
                                    float *scratch, int nrb, long long rpb, void *stream) {
  if (n <= 0 || C <= 0) return 0;
  if (act < kIdentity || act > kLeakyRelu || (res == nullptr) != (dpre == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      return run<float>(act, z, res, dout, gamma, beta, mean, inv, n, C, dz, dgamma,
                        dbeta, dpre, scratch, nrb, rpb, st);
    case kBF16:
      return run<__nv_bfloat16>(act, z, res, dout, gamma, beta, mean, inv, n, C, dz,
                                dgamma, dbeta, dpre, scratch, nrb, rpb, st);
    case kF16:
      return run<__half>(act, z, res, dout, gamma, beta, mean, inv, n, C, dz, dgamma,
                         dbeta, dpre, scratch, nrb, rpb, st);
  }
  return (int)cudaErrorInvalidValue;
}
