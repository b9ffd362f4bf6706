// bn_act_fwd_v1: the first design of bn_act_fwd (threads along C with scalar
// loads, three launches in bf16 and five in float32), kept as the yardstick
// its redesign (bn_act_fwd.cu) is timed against (chip_smoke.py's
// "previous_ms"). Nothing on the port's path launches it. Its kernels keep
// the bn_fwd_ mark of the family.
//
// Train-mode batch-norm statistics, normalise, optional residual add,
// activation, over channels-last z (n rows, C channels).
//
// Replaces the TPU kernel deeplearning4j_tpu/perf/pallas/bn.py::bn_act_fwd
// (body _fwd_kernel). Outputs: out (n, C) in z's type; mean, var, inv (C,)
// in float32.
//
//   bf16/f16 z: mean = S/n, var = max(Q/n - mean^2, 0) from float32 sums
//               S = sum z, Q = sum z^2 (one pass over z);
//   f32 z:      mean = S/n, then var = sum (z - mean)^2 / n (centred, a
//               second pass; never E[z^2] - mean^2 in float32);
//   inv = rsqrt(var + eps), scale = gamma*inv, shift = beta - mean*scale;
//   out = act(T(T(z*T(scale)) + T(shift)) [+ res]).
//
// Bound on an H100 SXM (3.35 TB/s): bytes. The function reads z (and res)
// once and writes out once, a few operations per element. ResNet50's stem
// at batch 128 is 1,605,632 x 64: 411 MB of bf16 in and out, about 123 us.
//
// Design. The Pallas kernel keeps one channel tile of all n rows in VMEM;
// at 1.6 M rows that tile is 205 MB, against 227 KB of shared memory on a
// Hopper SM. So the rows are blocked and the work runs in phases:
//   1. bn_fwd_moments, a (channel tiles x row blocks) grid of (32 x 8)
//      threads: threads run along C, so each row's channels are coalesced;
//      each thread sums its rows in float32, the 8 row lanes are added in
//      lane order, and each block writes its per-channel partials to a
//      scratch tensor the wrapper allocates. No atomics.
//   2. bn_fwd_finalize, one thread per channel, adds the partials of all
//      row blocks in block order (in double), and writes mean/var/inv and
//      the float32 scale and shift. The f32 path runs 1-2 twice (S, then the
//      centred Q).
//   3. bn_fwd_apply, elementwise, grid-stride: out = act(pre).
// The order of every sum is fixed by the shape, so two runs agree bitwise.
// Phase 3 reads z again: the kernel moves 1.5x (bf16) or 2x (f32, 3 reads)
// the bytes of its bound. A single-pass design that keeps row blocks on
// chip across a grid-wide barrier is later work.
//
// The grid (nrb, rpb) comes from the caller: chip_smoke.py's row_blocks.

#include <stdint.h>

#include "bn_act_common.cuh"

namespace {

using namespace bn_act;

enum Finalize { kSinglePass = 0, kMean = 1, kCentred = 2 };

// Per row block and channel: S = sum (z - center), Q = sum (z - center)^2.
template <typename T>
__global__ void __launch_bounds__(kTC *kTR)
bn_fwd_moments(const T *__restrict__ z, long long n, int C, long long rpb,
               const float *__restrict__ center, float *__restrict__ ps,
               float *__restrict__ pq) {
  __shared__ float bs[kTR][kTC + 1], bq[kTR][kTC + 1];
  const int c = blockIdx.x * kTC + threadIdx.x;
  const long long r0 = (long long)blockIdx.y * rpb;
  const long long r1 = min(n, r0 + rpb);
  float s = 0.f, q = 0.f;
  if (c < C) {
    const float m = center ? center[c] : 0.f;
#pragma unroll 4
    for (long long r = r0 + threadIdx.y; r < r1; r += kTR) {
      const float v = __fsub_rn(Cvt<T>::f(z[r * C + c]), m);
      s = __fadd_rn(s, v);
      q = __fmaf_rn(v, v, q);
    }
  }
  s = lane_sum(bs, s);
  q = lane_sum(bq, q);
  if (threadIdx.y == 0 && c < C) {
    ps[(long long)blockIdx.y * C + c] = s;
    pq[(long long)blockIdx.y * C + c] = q;
  }
}

template <typename T>
__global__ void bn_fwd_finalize(int mode, const float *__restrict__ ps,
                                const float *__restrict__ pq, int nrb, int C,
                                long long n, float eps, const T *__restrict__ gamma,
                                const T *__restrict__ beta, float *mean, float *var,
                                float *inv, float *sc, float *sh) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  double S = 0.0, Q = 0.0;
  for (int b = 0; b < nrb; ++b) {
    S += ps[(long long)b * C + c];
    Q += pq[(long long)b * C + c];
  }
  const float nf = (float)n;
  float m, v;
  if (mode == kMean) {
    mean[c] = __fdiv_rn((float)S, nf);
    return;
  }
  if (mode == kCentred) {
    m = mean[c];
    v = __fdiv_rn((float)Q, nf);
  } else {
    m = __fdiv_rn((float)S, nf);
    v = fmaxf(__fsub_rn(__fdiv_rn((float)Q, nf), __fmul_rn(m, m)), 0.f);
    mean[c] = m;
  }
  var[c] = v;
  const float iv = __frsqrt_rn(__fadd_rn(v, eps));
  inv[c] = iv;
  const float s = __fmul_rn(Cvt<T>::f(gamma[c]), iv);
  sc[c] = s;
  sh[c] = __fsub_rn(Cvt<T>::f(beta[c]), __fmul_rn(m, s));
}

template <typename T, int ACT, bool RES>
__global__ void bn_fwd_apply(const T *__restrict__ z, const T *__restrict__ res,
                             const float *__restrict__ sc, const float *__restrict__ sh,
                             T *__restrict__ out, long long total, int C) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    out[i] = Cvt<T>::t(act_fwd<T, ACT>(pre_act<T, RES>(z, res, i, sc[c], sh[c])));
  }
}

template <typename T, int ACT>
void launch_apply(const T *z, const T *res, const float *sc, const float *sh, T *out,
                  long long total, int C, cudaStream_t st) {
  const unsigned g = elt_blocks(total);
  if (res)
    bn_fwd_apply<T, ACT, true><<<g, kEltThreads, 0, st>>>(z, res, sc, sh, out, total, C);
  else
    bn_fwd_apply<T, ACT, false><<<g, kEltThreads, 0, st>>>(z, res, sc, sh, out, total, C);
}

template <typename T>
int run(int act, const void *zv, const void *gv, const void *bv, const void *rv,
        long long n, int C, float eps, void *outv, float *mean, float *var,
        float *inv, float *scratch, int nrb, long long rpb, cudaStream_t st) {
  const T *z = (const T *)zv, *gamma = (const T *)gv, *beta = (const T *)bv;
  const T *res = (const T *)rv;
  float *ps = scratch, *pq = scratch + (long long)nrb * C;
  float *sc = pq + (long long)nrb * C, *sh = sc + C;
  const dim3 rgrid((C + kTC - 1) / kTC, nrb), rblock(kTC, kTR);
  const unsigned fgrid = (C + 127) / 128;
  cudaError_t err;
#define BN_CHECK() \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err
  if (sizeof(T) == 2) {
    bn_fwd_moments<T><<<rgrid, rblock, 0, st>>>(z, n, C, rpb, nullptr, ps, pq);
    BN_CHECK();
    bn_fwd_finalize<T><<<fgrid, 128, 0, st>>>(kSinglePass, ps, pq, nrb, C, n, eps,
                                              gamma, beta, mean, var, inv, sc, sh);
    BN_CHECK();
  } else {
    bn_fwd_moments<T><<<rgrid, rblock, 0, st>>>(z, n, C, rpb, nullptr, ps, pq);
    BN_CHECK();
    bn_fwd_finalize<T><<<fgrid, 128, 0, st>>>(kMean, ps, pq, nrb, C, n, eps, gamma,
                                              beta, mean, var, inv, sc, sh);
    BN_CHECK();
    bn_fwd_moments<T><<<rgrid, rblock, 0, st>>>(z, n, C, rpb, mean, ps, pq);
    BN_CHECK();
    bn_fwd_finalize<T><<<fgrid, 128, 0, st>>>(kCentred, ps, pq, nrb, C, n, eps, gamma,
                                              beta, mean, var, inv, sc, sh);
    BN_CHECK();
  }
  const long long total = n * (long long)C;
  T *out = (T *)outv;
  if (act == kRelu)
    launch_apply<T, kRelu>(z, res, sc, sh, out, total, C, st);
  else if (act == kLeakyRelu)
    launch_apply<T, kLeakyRelu>(z, res, sc, sh, out, total, C, st);
  else
    launch_apply<T, kIdentity>(z, res, sc, sh, out, total, C, st);
  BN_CHECK();
#undef BN_CHECK
  return 0;
}

}  // namespace

// Scratch: 2 * nrb * C + 2 * C floats. Rows [b * rpb, min(n, (b+1) * rpb))
// form row block b; nrb * rpb >= n. res may be null. Returns a cudaError_t.
extern "C" int bn_act_fwd_v1_launch(int dtype, int act, const void *z, const void *gamma,
                                 const void *beta, const void *res, long long n, int C,
                                 float eps, void *out, float *mean, float *var,
                                 float *inv, float *scratch, int nrb, long long rpb,
                                 void *stream) {
  if (n <= 0 || C <= 0) return 0;
  if (act < kIdentity || act > kLeakyRelu) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      return run<float>(act, z, gamma, beta, res, n, C, eps, out, mean, var, inv,
                        scratch, nrb, rpb, st);
    case kBF16:
      return run<__nv_bfloat16>(act, z, gamma, beta, res, n, C, eps, out, mean, var,
                                inv, scratch, nrb, rpb, st);
    case kF16:
      return run<__half>(act, z, gamma, beta, res, n, C, eps, out, mean, var, inv,
                         scratch, nrb, rpb, st);
  }
  return (int)cudaErrorInvalidValue;
}
