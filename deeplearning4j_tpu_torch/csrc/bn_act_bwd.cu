// bn_act_bwd: backward of bn_act_fwd through the batch statistics, from z
// and the O(C) saves only.
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
// Design (the first design, bn_act_bwd_v1.cu, ran threads along C with one
// 2-byte load per bf16 element, and a pass over the elements that took a
// 64-bit modulo and six coefficient loads per element):
// - Each thread owns a fixed group of V channels, V = 16 bytes / element
//   size (8 bf16/f16 or 4 float32), and walks rows, two in flight: z, dout,
//   res, dz and dpre move as 16-byte vectors, so a warp reads whole 128-byte
//   lines (at the stem in bf16, 4 rows of 64 channels). Its per-channel
//   values (scale, shift, mean, inv and the two finalized coefficients) sit
//   in registers. Where C * element size is not a multiple of 16 or an
//   operand is not 16-byte aligned (ragged C, offset views), V = 1: the same
//   code and arithmetic on scalars.
// - A block of 256 threads holds GC channel groups (a power of two, at
//   most 256) by RL = 256/GC row lanes. The grid (plan) is nrb row blocks
//   times the channel tiles, one work item a block, and is as large as the
//   card holds at once: at most two blocks an SM, and no more than the
//   occupancy calculator finds resident for the kernel as built.
// - One cooperative launch (bn_bwd_fused) runs three passes with a
//   grid-wide sync between them:
//   1. recompute pre, dpre and xhat, write dpre when res is given, and per
//      block the per-channel partial sums of dpre*xhat and dpre (each
//      lane's rows in order, then the lanes in order);
//   2. one thread per channel adds the partials in block order (in double)
//      and writes dgamma/dbeta and the coefficients of pass 3;
//   3. recompute pre, dpre and xhat and write dz, each block walking its own
//      rows in the reverse of pass 1's order, so that the rows it read last,
//      still in the 50 MB L2, are read again first.
//   The other choice, three launches with pass 3 walking the work items
//   and their rows in reverse, was slower: at the stem in bf16 392.8 us
//   against 381.7 for one launch; at res5 79.0 against 69.8; at the ragged
//   C = 130 28.7 against 20.4 (tools/kernel_variants.py, H100 SXM, 700 W).
//   Rereading in pass 1's order instead costs 1-4%.
// No atomics: the order of every sum is fixed by the shape, so two runs
// agree bitwise. Pass 3 reads z, dout (and res) again: past the L2 (the
// stem's z and dout are 411 MB) the kernel moves about 1.7x the bytes of
// its bound.

// The split launches (a data world above 1, perf/kernels/bn_act.py
// bn_act_bwd_split): bn_bwd_sums (cooperative, passes 1 and 2's sums on the
// one launch's grid, fit_grid) writes dpre and this rank's dgamma and
// dbeta; the wrapper all-reduces the two with the row count; bn_bwd_dz (one
// block a work item) forms each channel's coefficients from the global sums
// as pass 2 does and runs pass 3. At one rank it reproduces the one launch
// bitwise.

#include <cooperative_groups.h>
#include <stdint.h>

#include "bn_act_common.cuh"

namespace {

using namespace bn_act;

constexpr int kMinBlocks = 2;  // blocks an SM the grid is sized for
constexpr int kMaxV = 8;
constexpr int kRows = 2;  // rows a thread has in flight

// What a launch runs: the one cooperative launch, or one of the split
// launches a data world above 1 takes (the sums launch, then after the
// all-reduce the dz launch).
enum Op { kFused = 0, kSums = 1, kDz = 2 };

struct Args : Grid {
  const void *z, *res, *dout, *gamma, *beta;
  const float *mean, *inv;
  void *dz, *dpre;
  float *dgamma, *dbeta, *pg, *pb, *coef;
  // the dz launch: the sums of dpre*xhat and dpre over the ranks, and the
  // global row count
  const float *gg, *gb, *gn;
};

// pre, then dpre, of V elements
template <typename T, int V, int ACT, bool RES>
__device__ __forceinline__ void dpre_of(const Pack<T, V> &z, const Pack<T, V> &r,
                                        const Pack<T, V> &dd, const float (&sc)[V],
                                        const float (&sh)[V], float (&d)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e)
    d[e] = act_bwd<T, ACT>(
        pre_act_of<T, RES>(Cvt<T>::f(z.e[e]), RES ? Cvt<T>::f(r.e[e]) : 0.f, sc[e], sh[e]),
        Cvt<T>::f(dd.e[e]));
}

// Pass 1 for one work item: the per-channel partial sums of dpre*xhat and
// dpre over the item's rows, and dpre itself when res is given.
template <typename T, int V, int ACT, bool RES>
__device__ __forceinline__ void partials(const Args &a, int item, float *red) {
  const Item it = item_of<V>(a, item);
  const T *const z = (const T *)a.z, *const res = (const T *)a.res;
  const T *const dout = (const T *)a.dout;
  float g[V], b[V];
#pragma unroll
  for (int e = 0; e < V; ++e) g[e] = b[e] = 0.f;
  if (it.active) {
    float m[V], iv[V], sc[V], sh[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int c = it.c0 + e;
      m[e] = a.mean[c];
      iv[e] = a.inv[c];
      sc[e] = __fmul_rn(Cvt<T>::f(((const T *)a.gamma)[c]), iv[e]);
      sh[e] = __fsub_rn(Cvt<T>::f(((const T *)a.beta)[c]), __fmul_rn(m[e], sc[e]));
    }
    for (long long r = it.r0 + it.lane; r < it.r1; r += kRows * a.RL) {
      long long i[kRows];
      bool ok[kRows];
      Pack<T, V> zv[kRows], dv[kRows], rv[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {  // every row's loads first
        const long long rk = r + k * a.RL;
        ok[k] = rk < it.r1;
        i[k] = (ok[k] ? rk : r) * a.C + it.c0;
        zv[k] = ld<T, V>(z + i[k]);
        dv[k] = ld<T, V>(dout + i[k]);
        if (RES) rv[k] = ld<T, V>(res + i[k]);
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (!ok[k]) break;
        float d[V];
        dpre_of<T, V, ACT, RES>(zv[k], rv[k], dv[k], sc, sh, d);
        if (RES) {
          Pack<T, V> out;
#pragma unroll
          for (int e = 0; e < V; ++e) out.e[e] = Cvt<T>::t(d[e]);
          st<T, V>((T *)a.dpre + i[k], out);
        }
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xh = __fmul_rn(__fsub_rn(Cvt<T>::f(zv[k].e[e]), m[e]), iv[e]);
          g[e] = __fmaf_rn(d[e], xh, g[e]);
          b[e] = __fadd_rn(b[e], d[e]);
        }
      }
    }
  }
  // the row lanes in order
  const int gl = threadIdx.x % a.GC, width = a.GC * V;
  float *const rg = red, *const rb = red + kThreads * kMaxV;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    rg[it.lane * width + gl * V + e] = g[e];
    rb[it.lane * width + gl * V + e] = b[e];
  }
  __syncthreads();
  const int tile = item % a.tiles, rbk = item / a.tiles;
  for (int j = threadIdx.x; j < width; j += kThreads) {
    const int c = tile * width + j;
    if (c >= a.C) continue;
    float sg = rg[j], sb = rb[j];
    for (int l = 1; l < a.RL; ++l) {
      sg = __fadd_rn(sg, rg[l * width + j]);
      sb = __fadd_rn(sb, rb[l * width + j]);
    }
    a.pg[(long long)rbk * a.C + c] = sg;
    a.pb[(long long)rbk * a.C + c] = sb;
  }
}

// Pass 2's sums for channel c, by one thread: the partials in block order,
// in double, rounded once to float32.
__device__ __forceinline__ void channel_sums(const Args &a, int c, float &dg, float &db) {
  double G = 0.0, B = 0.0;
  for (int k = 0; k < a.nrb; ++k) {
    G += a.pg[(long long)k * a.C + c];
    B += a.pb[(long long)k * a.C + c];
  }
  dg = (float)G;
  db = (float)B;
}

// Pass 2 for channel c. coef holds, per channel: scale, shift, dbeta/n,
// dgamma/n.
template <typename T>
__device__ __forceinline__ void finalize(const Args &a, int c) {
  float dg, db;
  channel_sums(a, c, dg, db);
  const float nf = (float)a.n;
  a.dgamma[c] = dg;
  a.dbeta[c] = db;
  const float sc = __fmul_rn(Cvt<T>::f(((const T *)a.gamma)[c]), a.inv[c]);
  a.coef[c] = sc;
  a.coef[a.C + c] = __fsub_rn(Cvt<T>::f(((const T *)a.beta)[c]), __fmul_rn(a.mean[c], sc));
  a.coef[2 * a.C + c] = __fdiv_rn(db, nf);
  a.coef[3 * a.C + c] = __fdiv_rn(dg, nf);
}

// Pass 3 over one work item's rows, walked from the last, with its
// channels' coefficients.
template <typename T, int V, int ACT, bool RES>
__device__ __forceinline__ void dz_rows(const Args &a, const Item &it, const float (&sc)[V],
                                        const float (&sh)[V], const float (&cb)[V],
                                        const float (&cg)[V], const float (&m)[V],
                                        const float (&iv)[V]) {
  const T *const z = (const T *)a.z, *const res = (const T *)a.res;
  const T *const dout = (const T *)a.dout;
  for (long long r = it.r1 - 1 - it.lane; r >= it.r0; r -= kRows * a.RL) {
    long long i[kRows];
    bool ok[kRows];
    Pack<T, V> zv[kRows], dv[kRows], rv[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {  // every row's loads first
      const long long rk = r - k * a.RL;
      ok[k] = rk >= it.r0;
      i[k] = (ok[k] ? rk : r) * a.C + it.c0;
      zv[k] = ld<T, V>(z + i[k]);
      dv[k] = ld<T, V>(dout + i[k]);
      if (RES) rv[k] = ld<T, V>(res + i[k]);
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (!ok[k]) break;
      float d[V];
      dpre_of<T, V, ACT, RES>(zv[k], rv[k], dv[k], sc, sh, d);
      Pack<T, V> out;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xh = __fmul_rn(__fsub_rn(Cvt<T>::f(zv[k].e[e]), m[e]), iv[e]);
        const float t = __fsub_rn(__fsub_rn(d[e], cb[e]), __fmul_rn(xh, cg[e]));
        out.e[e] = Cvt<T>::t(__fmul_rn(sc[e], t));
      }
      st<T, V>((T *)a.dz + i[k], out);
    }
  }
}

// Pass 3 for one work item: dz over the item's rows.
template <typename T, int V, int ACT, bool RES>
__device__ __forceinline__ void dz_pass(const Args &a, int item) {
  const Item it = item_of<V>(a, item);
  if (!it.active) return;
  float sc[V], sh[V], m[V], iv[V], cb[V], cg[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int c = it.c0 + e;
    sc[e] = a.coef[c];
    sh[e] = a.coef[a.C + c];
    cb[e] = a.coef[2 * a.C + c];
    cg[e] = a.coef[3 * a.C + c];
    m[e] = a.mean[c];
    iv[e] = a.inv[c];
  }
  dz_rows<T, V, ACT, RES>(a, it, sc, sh, cb, cg, m, iv);
}

// The three passes in one cooperative launch: every block is resident (see
// plan), so the grid-wide syncs cannot deadlock.
template <typename T, int V, int ACT, bool RES>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bn_bwd_fused(const Args a) {
  __shared__ float red[2 * kThreads * kMaxV];
  partials<T, V, ACT, RES>(a, blockIdx.x, red);
  cooperative_groups::this_grid().sync();
  for (int c = blockIdx.x * kThreads + threadIdx.x; c < a.C; c += gridDim.x * kThreads)
    finalize<T>(a, c);
  cooperative_groups::this_grid().sync();
  dz_pass<T, V, ACT, RES>(a, blockIdx.x);
}

// The split sums launch (cooperative): passes 1 and 2's sums, this rank's
// dgamma and dbeta (and dpre when res is given), for the all-reduce over
// the ranks.
template <typename T, int V, int ACT, bool RES>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bn_bwd_sums(const Args a) {
  __shared__ float red[2 * kThreads * kMaxV];
  partials<T, V, ACT, RES>(a, blockIdx.x, red);
  cooperative_groups::this_grid().sync();
  for (int c = blockIdx.x * kThreads + threadIdx.x; c < a.C; c += gridDim.x * kThreads)
    channel_sums(a, c, a.dgamma[c], a.dbeta[c]);
}

// The split dz launch (one block a work item, no grid sync): each thread
// forms its channels' coefficients from the global sums gg, gb and row
// count gn as the one-launch kernel's pass 2 does from its own, then pass 3
// runs.
template <typename T, int V, int ACT, bool RES>
__global__ void __launch_bounds__(kThreads) bn_bwd_dz(const Args a) {
  const Item it = item_of<V>(a, blockIdx.x);
  if (!it.active) return;
  const float nf = *a.gn;
  float sc[V], sh[V], m[V], iv[V], cb[V], cg[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int c = it.c0 + e;
    m[e] = a.mean[c];
    iv[e] = a.inv[c];
    sc[e] = __fmul_rn(Cvt<T>::f(((const T *)a.gamma)[c]), iv[e]);
    sh[e] = __fsub_rn(Cvt<T>::f(((const T *)a.beta)[c]), __fmul_rn(m[e], sc[e]));
    cb[e] = __fdiv_rn(a.gb[c], nf);
    cg[e] = __fdiv_rn(a.gg[c], nf);
  }
  dz_rows<T, V, ACT, RES>(a, it, sc, sh, cb, cg, m, iv);
}

// The grid for V-element channel groups (bn_act_common.cuh's plan_grid).
template <typename T, int V, int ACT, bool RES>
int plan(Args &a) {
  static std::atomic<int> resident[kMaxDevices];  // blocks, by device
  return plan_grid(a, V, (const void *)bn_bwd_fused<T, V, ACT, RES>, kMinBlocks, resident);
}

// Plans the grid and sets *need to the scratch it takes (floats); then,
// given scratch of at least that, launches `op`. The sums launch runs on the
// one-launch kernel's grid (fit_grid); the dz launch takes no scratch.
template <typename T, int V, int ACT, bool RES>
int run_v(int op, Args &a, float *scratch, long long cap, long long *need, cudaStream_t st) {
  int err = plan<T, V, ACT, RES>(a);
  if (err == 0 && op == kSums) {
    static std::atomic<int> resident[kMaxDevices];  // blocks, by device
    err = fit_grid(a, V, (const void *)bn_bwd_sums<T, V, ACT, RES>, kMinBlocks, resident);
  }
  if (err != 0) return err;
  if (op == kDz) {
    bn_bwd_dz<T, V, ACT, RES><<<a.tiles * a.nrb, kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  *need = 2LL * a.nrb * a.C + 4LL * a.C;
  if (scratch == nullptr) return 0;
  if (cap < *need) return (int)cudaErrorInvalidValue;
  a.pg = scratch;
  a.pb = a.pg + (long long)a.nrb * a.C;
  a.coef = a.pb + (long long)a.nrb * a.C;
  void *args[] = {(void *)&a};
  const void *kernel = op == kSums ? (const void *)bn_bwd_sums<T, V, ACT, RES>
                                   : (const void *)bn_bwd_fused<T, V, ACT, RES>;
  return (int)cudaLaunchCooperativeKernel(kernel, a.tiles * a.nrb, kThreads, args, 0, st);
}

template <typename T, int ACT>
int run_act(int op, Args &a, bool res, int vec, float *scratch, long long cap, long long *need,
            cudaStream_t st) {
  constexpr int kV = 16 / (int)sizeof(T);
  if (res)
    return vec == 1 ? run_v<T, 1, ACT, true>(op, a, scratch, cap, need, st)
                    : run_v<T, kV, ACT, true>(op, a, scratch, cap, need, st);
  return vec == 1 ? run_v<T, 1, ACT, false>(op, a, scratch, cap, need, st)
                  : run_v<T, kV, ACT, false>(op, a, scratch, cap, need, st);
}

template <typename T>
int run(int op, int act, Args &a, bool res, int vec, float *scratch, long long cap,
        long long *need, cudaStream_t st) {
  if (!vec_ok<T>(vec)) return (int)cudaErrorInvalidValue;
  if (act == kRelu) return run_act<T, kRelu>(op, a, res, vec, scratch, cap, need, st);
  if (act == kLeakyRelu)
    return run_act<T, kLeakyRelu>(op, a, res, vec, scratch, cap, need, st);
  return run_act<T, kIdentity>(op, a, res, vec, scratch, cap, need, st);
}

int dispatch(int op, int dtype, int act, Args &a, bool res, int vec, float *scratch,
             long long cap, long long *need, cudaStream_t st) {
  if (a.n <= 0 || a.C <= 0 || act < kIdentity || act > kLeakyRelu || vec < 1 ||
      a.C % vec != 0)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return run<float>(op, act, a, res, vec, scratch, cap, need, st);
    case kBF16:
      return run<__nv_bfloat16>(op, act, a, res, vec, scratch, cap, need, st);
    case kF16:
      return run<__half>(op, act, a, res, vec, scratch, cap, need, st);
  }
  return (int)cudaErrorInvalidValue;
}

long long scratch_of(int op, int dtype, int act, int has_res, long long n, int C, int vec) {
  Args a{};
  a.n = n;
  a.C = C;
  long long need = 0;
  const int err = dispatch(op, dtype, act, a, has_res != 0, vec, nullptr, 0, &need, nullptr);
  return err != 0 ? -(long long)err : need;
}

}  // namespace

// vec: V, the elements each thread moves at a time (1, or 16 bytes' worth:
// C * element size a multiple of 16 and every (n, C) operand 16-byte
// aligned). The scratch floats a launch over (n, C) takes, or minus a
// cudaError_t.
extern "C" long long bn_act_bwd_scratch(int dtype, int act, int has_res, long long n, int C,
                                        int vec) {
  return scratch_of(kFused, dtype, act, has_res, n, C, vec);
}

// scratch: scratch_floats floats, at least bn_act_bwd_scratch's count. res
// and dpre are null together. Returns a cudaError_t.
extern "C" int bn_act_bwd_launch(int dtype, int act, const void *z, const void *gamma,
                                 const void *beta, const void *res, const float *mean,
                                 const float *inv, const void *dout, long long n, int C,
                                 void *dz, float *dgamma, float *dbeta, void *dpre,
                                 float *scratch, long long scratch_floats, int vec,
                                 void *stream) {
  if (n <= 0 || C <= 0) return 0;
  if ((res == nullptr) != (dpre == nullptr) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.z = z;
  a.res = res;
  a.dout = dout;
  a.gamma = gamma;
  a.beta = beta;
  a.mean = mean;
  a.inv = inv;
  a.dz = dz;
  a.dpre = dpre;
  a.dgamma = dgamma;
  a.dbeta = dbeta;
  a.n = n;
  a.C = C;
  long long need = 0;
  return dispatch(kFused, dtype, act, a, res != nullptr, vec, scratch, scratch_floats, &need,
                  (cudaStream_t)stream);
}

// ---------------------------------------------- the split launches
// At a data world above 1 the wrapper runs the sums launch (this rank's
// dgamma and dbeta, and dpre when res is given), sums dgamma and dbeta over
// the ranks with the row count, and runs the dz launch on the sums.
extern "C" long long bn_act_bwd_sums_scratch(int dtype, int act, int has_res, long long n,
                                             int C, int vec) {
  return scratch_of(kSums, dtype, act, has_res, n, C, vec);
}

extern "C" int bn_act_bwd_sums_launch(int dtype, int act, const void *z, const void *gamma,
                                      const void *beta, const void *res, const float *mean,
                                      const float *inv, const void *dout, long long n, int C,
                                      float *dgamma, float *dbeta, void *dpre, float *scratch,
                                      long long scratch_floats, int vec, void *stream) {
  if (n <= 0 || C <= 0) return 0;
  if ((res == nullptr) != (dpre == nullptr) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.z = z;
  a.res = res;
  a.dout = dout;
  a.gamma = gamma;
  a.beta = beta;
  a.mean = mean;
  a.inv = inv;
  a.dpre = dpre;
  a.dgamma = dgamma;
  a.dbeta = dbeta;
  a.n = n;
  a.C = C;
  long long need = 0;
  return dispatch(kSums, dtype, act, a, res != nullptr, vec, scratch, scratch_floats, &need,
                  (cudaStream_t)stream);
}

// gg, gb: the per-channel sums of dpre*xhat and dpre over the ranks; gn: the
// global row count.
extern "C" int bn_act_bwd_dz_launch(int dtype, int act, const void *z, const void *gamma,
                                    const void *beta, const void *res, const float *mean,
                                    const float *inv, const void *dout, long long n, int C,
                                    const float *gg, const float *gb, const float *gn,
                                    void *dz, int vec, void *stream) {
  if (n <= 0 || C <= 0) return 0;
  if (dz == nullptr || gg == nullptr || gb == nullptr || gn == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.z = z;
  a.res = res;
  a.dout = dout;
  a.gamma = gamma;
  a.beta = beta;
  a.mean = mean;
  a.inv = inv;
  a.dz = dz;
  a.gg = gg;
  a.gb = gb;
  a.gn = gn;
  a.n = n;
  a.C = C;
  long long need = 0;
  return dispatch(kDz, dtype, act, a, res != nullptr, vec, nullptr, 0, &need,
                  (cudaStream_t)stream);
}
