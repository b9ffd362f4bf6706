// bn_act_split_v1: the first design of the bn kernels' split launches (a
// data world above 1), kept as the yardstick their redesign (bn_act_fwd.cu
// and bn_act_bwd.cu's split launches) is timed against (chip_smoke.py's
// "previous_ms" of the split rows). Nothing on the port's path launches it.
//
// Forward: a cooperative statistics launch writes this rank's per-channel
// float32 sums (bf16/f16: S and Q in one pass; float32: S, then after an
// all-reduce a second launch the centred Q = sum (z - S/n)^2), and an apply
// launch (one block a work item) forms the statistics and out, walking each
// item's rows from the last. Backward: a cooperative sums launch writes
// dpre and this rank's dgamma and dbeta; a dz launch recomputes dpre from
// dout and res and forms dz. Each thread owns 16 bytes of channels and
// keeps 4 (forward) or 2 (backward) rows of loads in flight. The grid is
// planned over the statistics kernel's resident blocks (bn_act_common.cuh).

#include <cooperative_groups.h>
#include <stdint.h>

#include "bn_act_common.cuh"

namespace fwd {

using namespace bn_act;

constexpr int kMinBlocks = 3;  // blocks an SM the grid is sized for
constexpr int kStatRows = 4;   // rows a thread has in flight in pass 1
constexpr int kApplyRows = 4;  // and in pass 3

// What a launch runs: the one cooperative launch, or one of the split
// launches a data world above 1 takes (a statistics launch, then after the
// all-reduce the apply launch).
enum Op { kFused = 0, kSums = 1, kApply = 2 };
// What a statistics pass sums: the one-launch kernel's sums (float32 S and
// Q for bf16/f16, which the split launch takes too; double sums shifted by
// z[0, c] for float32), or for float32 at a data world above 1, sum z, then
// sum (z - mean)^2 with the global mean (the plain global path's two passes).
enum Pass { kFusedPass = 0, kSumPass = 1, kCenteredPass = 2 };

struct Args : Grid {
  const void *z, *res, *gamma, *beta;
  void *out;
  float *mean, *var, *inv;
  double *ps, *pq;  // per row block and channel: the partial sums
  float *coef;      // per channel: scale, then shift
  float eps;
  // the split launches: this rank's per-channel sums (statistics launch);
  // the sums over the ranks and the global row count (apply launch, and
  // the centred statistics pass)
  float *lsum;
  const float *gsum, *gsq, *gn;
  int pass;
};

// What pass 1 sums in: float32 for bf16/f16 (the JAX kernel's float32 sums),
// double for float32.
template <typename T> struct Stat { using type = float; };
template <> struct Stat<float> { using type = double; };

// Pass 1 for one work item: the per-channel partial sums over the item's rows.
template <typename T, int V, int P>
__device__ __forceinline__ void partials(const Args &a, int item,
                                         typename Stat<T>::type *red) {
  using S = typename Stat<T>::type;
  constexpr bool kShift = sizeof(T) == 4 && P == kFusedPass;
  const Item it = item_of<V>(a, item);
  const T *const z = (const T *)a.z;
  S s[V], q[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = q[e] = 0;
  if (it.active) {
    double k[V];
    float m[V];
    if (kShift) {
      const Pack<T, V> k0 = ld<T, V>(z + it.c0);
#pragma unroll
      for (int e = 0; e < V; ++e) k[e] = (double)Cvt<T>::f(k0.e[e]);
    }
    if (P == kCenteredPass) {
      const float nf = *a.gn;
#pragma unroll
      for (int e = 0; e < V; ++e) m[e] = __fdiv_rn(a.gsum[it.c0 + e], nf);
    }
    for (long long r = it.r0 + it.lane; r < it.r1; r += kStatRows * a.RL) {
      bool ok[kStatRows];
      Pack<T, V> zv[kStatRows];
#pragma unroll
      for (int j = 0; j < kStatRows; ++j) {  // every row's load first
        const long long rj = r + j * a.RL;
        ok[j] = rj < it.r1;
        zv[j] = ld<T, V>(z + (ok[j] ? rj : r) * a.C + it.c0);
      }
#pragma unroll
      for (int j = 0; j < kStatRows; ++j) {
        if (!ok[j]) break;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float v = Cvt<T>::f(zv[j].e[e]);
          if constexpr (kShift) {
            const double d = __dsub_rn((double)v, k[e]);
            s[e] = __dadd_rn(s[e], d);
            q[e] = __fma_rn(d, d, q[e]);
          } else if constexpr (P == kSumPass) {
            s[e] = __dadd_rn(s[e], (double)v);
          } else if constexpr (P == kCenteredPass) {
            const double d = (double)__fsub_rn(v, m[e]);
            q[e] = __fma_rn(d, d, q[e]);
          } else {
            s[e] = __fadd_rn(s[e], v);
            q[e] = __fmaf_rn(v, v, q[e]);
          }
        }
      }
    }
  }
  // the row lanes in order
  const int gl = threadIdx.x % a.GC, width = a.GC * V;
  S *const rs = red, *const rq = red + kThreads * V;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    rs[it.lane * width + gl * V + e] = s[e];
    rq[it.lane * width + gl * V + e] = q[e];
  }
  __syncthreads();
  const int tile = item % a.tiles, rbk = item / a.tiles;
  for (int j = threadIdx.x; j < width; j += kThreads) {
    const int c = tile * width + j;
    if (c >= a.C) continue;
    S ss = rs[j], sq = rq[j];
    for (int l = 1; l < a.RL; ++l) {
      if constexpr (sizeof(S) == 8) {
        ss = __dadd_rn(ss, rs[l * width + j]);
        sq = __dadd_rn(sq, rq[l * width + j]);
      } else {
        ss = __fadd_rn(ss, rs[l * width + j]);
        sq = __fadd_rn(sq, rq[l * width + j]);
      }
    }
    a.ps[(long long)rbk * a.C + c] = ss;
    a.pq[(long long)rbk * a.C + c] = sq;
  }
}

// Pass 2's sums for channel c, by one warp: lane l adds the partials of row
// blocks l, l + 32, ... in order, then the lanes are added in a fixed tree;
// S and Q are valid in lane 0.
__device__ __forceinline__ void channel_totals(const Args &a, int c, int lane, double &S,
                                               double &Q) {
  S = 0.0;
  Q = 0.0;
  for (int k = lane; k < a.nrb; k += 32) {
    S = __dadd_rn(S, a.ps[(long long)k * a.C + c]);
    Q = __dadd_rn(Q, a.pq[(long long)k * a.C + c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    S = __dadd_rn(S, __shfl_down_sync(0xffffffffu, S, off));
    Q = __dadd_rn(Q, __shfl_down_sync(0xffffffffu, Q, off));
  }
}

// Pass 3 over one work item's rows, walked from the last, with its
// channels' scale and shift.
template <typename T, int V, int ACT, bool RES>
__device__ __forceinline__ void apply_rows(const Args &a, const Item &it,
                                           const float (&sc)[V], const float (&sh)[V]) {
  const T *const z = (const T *)a.z, *const res = (const T *)a.res;
  for (long long r = it.r1 - 1 - it.lane; r >= it.r0; r -= kApplyRows * a.RL) {
    long long i[kApplyRows];
    bool ok[kApplyRows];
    Pack<T, V> zv[kApplyRows], rv[kApplyRows];
#pragma unroll
    for (int j = 0; j < kApplyRows; ++j) {  // every row's loads first
      const long long rj = r - j * a.RL;
      ok[j] = rj >= it.r0;
      i[j] = (ok[j] ? rj : r) * a.C + it.c0;
      zv[j] = ld<T, V>(z + i[j]);
      if (RES) rv[j] = ld<T, V>(res + i[j]);
    }
#pragma unroll
    for (int j = 0; j < kApplyRows; ++j) {
      if (!ok[j]) break;
      Pack<T, V> o;
#pragma unroll
      for (int e = 0; e < V; ++e)
        o.e[e] = Cvt<T>::t(act_fwd<T, ACT>(pre_act_of<T, RES>(
            Cvt<T>::f(zv[j].e[e]), RES ? Cvt<T>::f(rv[j].e[e]) : 0.f, sc[e], sh[e])));
      st<T, V>((T *)a.out + i[j], o);
    }
  }
}

// The split statistics launch (cooperative): passes 1 and 2's sums, written
// as float32 per channel into lsum (S then Q for bf16/f16; S, or the
// centred Q, for float32) for the all-reduce over the ranks.
template <typename T, int V, int P>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bn_fwd_sums(const Args a) {
  __shared__ typename Stat<T>::type red[2 * kThreads * V];
  partials<T, V, P>(a, blockIdx.x, red);
  cooperative_groups::this_grid().sync();
  const int warps = gridDim.x * (kThreads / 32);
  for (int c = blockIdx.x * (kThreads / 32) + threadIdx.x / 32; c < a.C; c += warps) {
    double S, Q;
    channel_totals(a, c, threadIdx.x % 32, S, Q);
    if (threadIdx.x % 32 != 0) continue;
    if (P == kCenteredPass) {
      a.lsum[c] = (float)Q;
    } else {
      a.lsum[c] = (float)S;
      if (P == kFusedPass) a.lsum[a.C + c] = (float)Q;
    }
  }
}

// The split apply launch (one block a work item, no grid sync): each thread
// forms its channels' statistics from the global sums gsum, gsq and row
// count gn as the one-launch kernel's pass 2 does from its own (bf16/f16:
// var = max(Q/n - mean^2, 0); float32: var = Q/n of the centred sums), the
// first row block writes mean, var and inv, and pass 3 runs.
template <typename T, int V, int ACT, bool RES>
__global__ void __launch_bounds__(kThreads) bn_fwd_apply(const Args a) {
  const Item it = item_of<V>(a, blockIdx.x);
  if (!it.active) return;
  const float nf = *a.gn;
  const bool first = blockIdx.x / a.tiles == 0 && it.lane == 0;
  float sc[V], sh[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int c = it.c0 + e;
    const float m = __fdiv_rn(a.gsum[c], nf);
    const float v = sizeof(T) == 4
                        ? __fdiv_rn(a.gsq[c], nf)
                        : fmaxf(__fsub_rn(__fdiv_rn(a.gsq[c], nf), __fmul_rn(m, m)), 0.f);
    const float iv = __frsqrt_rn(__fadd_rn(v, a.eps));
    sc[e] = __fmul_rn(Cvt<T>::f(((const T *)a.gamma)[c]), iv);
    sh[e] = __fsub_rn(Cvt<T>::f(((const T *)a.beta)[c]), __fmul_rn(m, sc[e]));
    if (first) {
      a.mean[c] = m;
      a.var[c] = v;
      a.inv[c] = iv;
    }
  }
  apply_rows<T, V, ACT, RES>(a, it, sc, sh);
}

// The statistics kernel of a pass, and its grid fitted (fit_grid).
template <typename T, int V>
const void *sums_kernel(int pass) {
  if constexpr (sizeof(T) == 4)
    return pass == kSumPass ? (const void *)bn_fwd_sums<T, V, kSumPass>
                            : (const void *)bn_fwd_sums<T, V, kCenteredPass>;
  else
    return (const void *)bn_fwd_sums<T, V, kFusedPass>;
}

template <typename T, int V>
int fit_sums(Args &a) {
  static std::atomic<int> resident[3][kMaxDevices];  // blocks, by pass and device
  return fit_grid(a, V, sums_kernel<T, V>(a.pass), kMinBlocks, resident[a.pass]);
}

// The grid: plan_grid over the statistics kernel's blocks (the one
// launch's kernel is not in this file).
template <typename T, int V>
int plan(Args &a) {
  static std::atomic<int> resident[kMaxDevices];  // blocks, by device
  return plan_grid(a, V, sums_kernel<T, V>(sizeof(T) == 4 ? kSumPass : kFusedPass), kMinBlocks,
                   resident);
}

// Plans the grid and sets *need to the scratch it takes (floats); then,
// given scratch of at least that, launches `op`. The partial sums are
// doubles, first in the scratch (which is 16-byte aligned), then scale and
// shift. The apply launch takes no scratch.
template <typename T, int V, int ACT, bool RES>
int run_v(int op, Args &a, float *scratch, long long cap, long long *need, cudaStream_t st) {
  int err = plan<T, V>(a);
  if (err == 0 && op == kSums) err = fit_sums<T, V>(a);
  if (err != 0) return err;
  if (op == kApply) {
    bn_fwd_apply<T, V, ACT, RES><<<a.tiles * a.nrb, kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  *need = 4LL * a.nrb * a.C + 2LL * a.C;
  if (scratch == nullptr) return 0;
  if (cap < *need) return (int)cudaErrorInvalidValue;
  a.ps = (double *)scratch;
  a.pq = a.ps + (long long)a.nrb * a.C;
  a.coef = (float *)(a.pq + (long long)a.nrb * a.C);
  void *args[] = {(void *)&a};
  return (int)cudaLaunchCooperativeKernel(sums_kernel<T, V>(a.pass), a.tiles * a.nrb, kThreads,
                                          args, 0, st);
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
  if (op == kSums && (sizeof(T) == 4 ? (a.pass != kSumPass && a.pass != kCenteredPass)
                                     : a.pass != kFusedPass))
    return (int)cudaErrorInvalidValue;
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

long long scratch_of(int op, int dtype, int act, int has_res, long long n, int C, int vec,
                     int pass) {
  Args a{};
  a.n = n;
  a.C = C;
  a.pass = pass;
  long long need = 0;
  const int err = dispatch(op, dtype, act, a, has_res != 0, vec, nullptr, 0, &need, nullptr);
  return err != 0 ? -(long long)err : need;
}

}  // namespace fwd

namespace bwd {

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

// Plans the grid (over the sums kernel's resident blocks) and sets *need
// to the scratch it takes (floats); then, given scratch of at least that,
// launches `op`. The dz launch takes no scratch.
template <typename T, int V, int ACT, bool RES>
int run_v(int op, Args &a, float *scratch, long long cap, long long *need, cudaStream_t st) {
  static std::atomic<int> resident[kMaxDevices];  // blocks, by device
  const int err =
      plan_grid(a, V, (const void *)bn_bwd_sums<T, V, ACT, RES>, kMinBlocks, resident);
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
  return (int)cudaLaunchCooperativeKernel((const void *)bn_bwd_sums<T, V, ACT, RES>,
                                          a.tiles * a.nrb, kThreads, args, 0, st);
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

}  // namespace bwd

// ---------------------------------------------- forward
// At a data world above 1 the wrapper runs the statistics launch, sums its
// float32 output over the ranks with the row count, and runs the apply
// launch on the sums. act and has_res name the one-launch kernel whose grid
// the statistics launch takes. pass: 0 for bf16/f16 (lsum gets S then Q, 2C
// floats); for float32 1 (lsum gets S, C floats), then 2 after the first
// all-reduce (lsum gets the centred Q; gsum and gn are the global S and row
// count).
extern "C" long long bn_act_split_v1_fwd_sums_scratch(int dtype, int act, int has_res, int pass,
                                             long long n, int C, int vec) {
  return fwd::scratch_of(fwd::kSums, dtype, act, has_res, n, C, vec, pass);
}

extern "C" int bn_act_split_v1_fwd_sums_launch(int dtype, int act, int has_res, int pass,
                                      const void *z, long long n, int C, const float *gsum,
                                      const float *gn, float *lsum, float *scratch,
                                      long long scratch_floats, int vec, void *stream) {
  if (n <= 0 || C <= 0) return 0;
  if (scratch == nullptr || ((uintptr_t)scratch & 15) != 0) return (int)cudaErrorInvalidValue;
  if (pass == fwd::kCenteredPass && (gsum == nullptr || gn == nullptr))
    return (int)cudaErrorInvalidValue;
  fwd::Args a{};
  a.z = z;
  a.gsum = gsum;
  a.gn = gn;
  a.lsum = lsum;
  a.pass = pass;
  a.n = n;
  a.C = C;
  long long need = 0;
  return fwd::dispatch(fwd::kSums, dtype, act, a, has_res != 0, vec, scratch, scratch_floats, &need,
                  (cudaStream_t)stream);
}

// gsum, gsq: the per-channel sums over the ranks (bf16/f16: S and Q; float32:
// S and the centred Q); gn: the global row count. Writes out, mean, var and
// inv as bn_act_fwd_launch does.
extern "C" int bn_act_split_v1_fwd_apply_launch(int dtype, int act, const void *z, const void *gamma,
                                       const void *beta, const void *res, long long n, int C,
                                       float eps, const float *gsum, const float *gsq,
                                       const float *gn, void *out, float *mean, float *var,
                                       float *inv, int vec, void *stream) {
  if (n <= 0 || C <= 0) return 0;
  if (out == nullptr || gsum == nullptr || gsq == nullptr || gn == nullptr)
    return (int)cudaErrorInvalidValue;
  fwd::Args a{};
  a.z = z;
  a.res = res;
  a.gamma = gamma;
  a.beta = beta;
  a.out = out;
  a.mean = mean;
  a.var = var;
  a.inv = inv;
  a.eps = eps;
  a.gsum = gsum;
  a.gsq = gsq;
  a.gn = gn;
  a.n = n;
  a.C = C;
  long long need = 0;
  return fwd::dispatch(fwd::kApply, dtype, act, a, res != nullptr, vec, nullptr, 0, &need,
                  (cudaStream_t)stream);
}

// ---------------------------------------------- backward
// At a data world above 1 the wrapper runs the sums launch (this rank's
// dgamma and dbeta, and dpre when res is given), sums dgamma and dbeta over
// the ranks with the row count, and runs the dz launch on the sums.
extern "C" long long bn_act_split_v1_bwd_sums_scratch(int dtype, int act, int has_res, long long n,
                                             int C, int vec) {
  return bwd::scratch_of(bwd::kSums, dtype, act, has_res, n, C, vec);
}

extern "C" int bn_act_split_v1_bwd_sums_launch(int dtype, int act, const void *z, const void *gamma,
                                      const void *beta, const void *res, const float *mean,
                                      const float *inv, const void *dout, long long n, int C,
                                      float *dgamma, float *dbeta, void *dpre, float *scratch,
                                      long long scratch_floats, int vec, void *stream) {
  if (n <= 0 || C <= 0) return 0;
  if ((res == nullptr) != (dpre == nullptr) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  bwd::Args a{};
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
  return bwd::dispatch(bwd::kSums, dtype, act, a, res != nullptr, vec, scratch, scratch_floats, &need,
                  (cudaStream_t)stream);
}

// gg, gb: the per-channel sums of dpre*xhat and dpre over the ranks; gn: the
// global row count.
extern "C" int bn_act_split_v1_bwd_dz_launch(int dtype, int act, const void *z, const void *gamma,
                                    const void *beta, const void *res, const float *mean,
                                    const float *inv, const void *dout, long long n, int C,
                                    const float *gg, const float *gb, const float *gn,
                                    void *dz, int vec, void *stream) {
  if (n <= 0 || C <= 0) return 0;
  if (dz == nullptr || gg == nullptr || gb == nullptr || gn == nullptr)
    return (int)cudaErrorInvalidValue;
  bwd::Args a{};
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
  return bwd::dispatch(bwd::kDz, dtype, act, a, res != nullptr, vec, nullptr, 0, &need,
                  (cudaStream_t)stream);
}
