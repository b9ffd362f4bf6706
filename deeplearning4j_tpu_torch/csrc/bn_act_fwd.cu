// bn_act_fwd: train-mode batch-norm statistics, normalise, optional residual
// add, activation, over channels-last z (n rows, C channels).
//
// Replaces the TPU kernel deeplearning4j_tpu/perf/pallas/bn.py::bn_act_fwd
// (body _fwd_kernel). Outputs: out (n, C) in z's type; mean, var, inv (C,)
// in float32.
//
//   bf16/f16 z: mean = S/n, var = max(Q/n - mean^2, 0) from float32 sums
//               S = sum z, Q = sum z^2 (the JAX kernel's single pass);
//   f32 z:      shifted sums S' = sum (z - K), Q' = sum (z - K)^2 with
//               K = z[0, c], in double, from the same single read of z:
//               mean = K + S'/n, var = max(Q'/n - (S'/n)^2, 0), both in
//               double and rounded once to float32 (never E[z^2] - mean^2
//               in float32);
//   inv = rsqrt(var + eps), scale = gamma*inv, shift = beta - mean*scale;
//   out = act(T(T(z*T(scale)) + T(shift)) [+ res]).
//
// Bound on an H100 SXM (3.35 TB/s): bytes. The function reads z (and res)
// once and writes out once, a few operations per element. ResNet50's stem
// at batch 128 is 1,605,632 x 64: 411 MB of bf16 in and out, about 123 us.
//
// Design (the first design, bn_act_fwd_v1.cu, ran threads along C with one
// 2-byte load per bf16 element in three launches, five in float32 where it
// read z three times, and an elementwise pass that took a 64-bit modulo and
// two coefficient loads per element). bn_act_bwd.cu's design, on the same
// grid (bn_act_common.cuh):
// - Each thread owns a fixed group of V channels, V = 16 bytes / element
//   size (8 bf16/f16 or 4 float32), and walks rows: z, res and out move as
//   16-byte vectors, and its scale and shift sit in registers. Where
//   C * element size is not a multiple of 16 or an operand is not 16-byte
//   aligned (ragged C, offset views), V = 1: the same code and arithmetic on
//   scalars.
// - One cooperative launch (bn_fwd_fused), as many blocks as the card holds
//   at once (plan_grid: at most kMinBlocks an SM, fewer if the occupancy
//   calculator says so), one work item (channel tile x row block) a block,
//   three passes with a grid-wide sync between them:
//   1. per block, the per-channel partial sums of its rows (each lane's
//      rows in order, kStatRows in flight, then the lanes in order): float32
//      S and Q for bf16/f16, double S' and Q' for float32;
//   2. one warp per channel adds the partials (in double, in a fixed order:
//      each lane a strided run of blocks in order, then the lanes in a
//      tree) and writes mean, var, inv and the float32 scale and shift;
//   3. out = act(pre), each block walking its own rows in the reverse of
//      pass 1's order, so that the rows it read last, still in the 50 MB L2,
//      are read again first.
// No atomics: the order of every sum is fixed by the shape, so two runs
// agree bitwise. z is read once for the statistics in every type; pass 3
// reads it again (past the L2, the stem's z is 205 MB in bf16), so the
// kernel moves about 1.5x the bytes of its bound.
//
// The choices, timed by tools/kernel_variants.py on an H100 SXM at 700 W
// (stem 1,605,632 x 64 bf16 relu, as built about 244 us): one thread a
// channel in pass 2 instead of a warp 265 us (and +10-20 us on every
// other shape); 2 blocks an SM (96 registers) instead of 3 (80) 259 us,
// 4 (64, spilling with 4 rows in flight in pass 3) no faster; 2 rows in
// flight in pass 3 instead of 4 1-3% slower; float32 statistics summed
// in float32 within a thread instead of double 486 against 448 us at the
// stem in float32 (the doubles cost nothing: pass 1 is bound by loads);
// three launches within 2% (slower at the stem and the ragged shapes,
// faster at the residual ones); rereading in pass 1's order 1-4% slower.

// The split launches (a data world above 1, perf/kernels/bn_act.py
// bn_act_fwd_split): the one launch takes its statistics inside the launch,
// where no all-reduce can sit, so the forward runs as
// - bn_fwd_sums (cooperative, passes 1 and 2's sums on the one launch's
//   grid, fit_grid): this rank's per-channel float32 sums, S and Q in one
//   pass for bf16/f16; for float32 S, then after an all-reduce a second
//   launch the centred Q = sum (z - S/n)^2 with the global S and n (the
//   plain global path's two passes);
// - the wrapper's all-reduce of the sums with the row count;
// - bn_fwd_apply (one block a work item): each thread forms its channels'
//   statistics from the global sums as pass 2 does, the first row block
//   writes mean, var and inv, and pass 3 runs.
// At one rank the bf16/f16 split reproduces the one launch bitwise (the
// same partial sums in the same order); float32 differs from its shifted
// sums by roundoff. It reads z once more than the one launch (twice more
// in float32).

#include <cooperative_groups.h>
#include <stdint.h>

#include "bn_act_common.cuh"

namespace {

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

// Pass 2 for channel c, by one warp.
template <typename T>
__device__ __forceinline__ void finalize(const Args &a, int c, int lane) {
  double S, Q;
  channel_totals(a, c, lane, S, Q);
  if (lane != 0) return;
  float m, v;
  if constexpr (sizeof(T) == 4) {
    const double nd = (double)a.n, d = __ddiv_rn(S, nd);
    const double K = (double)Cvt<T>::f(((const T *)a.z)[c]);
    m = (float)__dadd_rn(K, d);
    v = (float)fmax(__dsub_rn(__ddiv_rn(Q, nd), __dmul_rn(d, d)), 0.0);
  } else {
    const float nf = (float)a.n;
    m = __fdiv_rn((float)S, nf);
    v = fmaxf(__fsub_rn(__fdiv_rn((float)Q, nf), __fmul_rn(m, m)), 0.f);
  }
  a.mean[c] = m;
  a.var[c] = v;
  const float iv = __frsqrt_rn(__fadd_rn(v, a.eps));
  a.inv[c] = iv;
  const float sc = __fmul_rn(Cvt<T>::f(((const T *)a.gamma)[c]), iv);
  a.coef[c] = sc;
  a.coef[a.C + c] = __fsub_rn(Cvt<T>::f(((const T *)a.beta)[c]), __fmul_rn(m, sc));
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

// Pass 3 for one work item: out over the item's rows.
template <typename T, int V, int ACT, bool RES>
__device__ __forceinline__ void apply(const Args &a, int item) {
  const Item it = item_of<V>(a, item);
  if (!it.active) return;
  float sc[V], sh[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    sc[e] = a.coef[it.c0 + e];
    sh[e] = a.coef[a.C + it.c0 + e];
  }
  apply_rows<T, V, ACT, RES>(a, it, sc, sh);
}

// The three passes in one cooperative launch: every block is resident (see
// plan_grid), so the grid-wide syncs cannot deadlock.
template <typename T, int V, int ACT, bool RES>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bn_fwd_fused(const Args a) {
  __shared__ typename Stat<T>::type red[2 * kThreads * V];
  partials<T, V, kFusedPass>(a, blockIdx.x, red);
  cooperative_groups::this_grid().sync();
  const int warps = gridDim.x * (kThreads / 32);
  for (int c = blockIdx.x * (kThreads / 32) + threadIdx.x / 32; c < a.C; c += warps)
    finalize<T>(a, c, threadIdx.x % 32);
  cooperative_groups::this_grid().sync();
  apply<T, V, ACT, RES>(a, blockIdx.x);
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

template <typename T, int V, int ACT, bool RES>
int plan(Args &a) {
  static std::atomic<int> resident[kMaxDevices];  // blocks, by device
  return plan_grid(a, V, (const void *)bn_fwd_fused<T, V, ACT, RES>, kMinBlocks, resident);
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

// Plans the grid and sets *need to the scratch it takes (floats); then,
// given scratch of at least that, launches `op`. The partial sums are
// doubles, first in the scratch (which is 16-byte aligned), then scale and
// shift. The apply launch takes no scratch.
template <typename T, int V, int ACT, bool RES>
int run_v(int op, Args &a, float *scratch, long long cap, long long *need, cudaStream_t st) {
  int err = plan<T, V, ACT, RES>(a);
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
  const void *kernel = op == kSums ? sums_kernel<T, V>(a.pass)
                                   : (const void *)bn_fwd_fused<T, V, ACT, RES>;
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

}  // namespace

// vec: V, the elements each thread moves at a time (1, or 16 bytes' worth:
// C * element size a multiple of 16 and z, res and out 16-byte aligned).
// The scratch floats a launch over (n, C) takes, or minus a cudaError_t.
extern "C" long long bn_act_fwd_scratch(int dtype, int act, int has_res, long long n, int C,
                                        int vec) {
  return scratch_of(kFused, dtype, act, has_res, n, C, vec, kFusedPass);
}

// scratch: scratch_floats floats, at least bn_act_fwd_scratch's count, 16-byte
// aligned. res may be null. Returns a cudaError_t.
extern "C" int bn_act_fwd_launch(int dtype, int act, const void *z, const void *gamma,
                                 const void *beta, const void *res, long long n, int C,
                                 float eps, void *out, float *mean, float *var, float *inv,
                                 float *scratch, long long scratch_floats, int vec,
                                 void *stream) {
  if (n <= 0 || C <= 0) return 0;
  if (scratch == nullptr || ((uintptr_t)scratch & 15) != 0) return (int)cudaErrorInvalidValue;
  Args a{};
  a.z = z;
  a.res = res;
  a.gamma = gamma;
  a.beta = beta;
  a.out = out;
  a.mean = mean;
  a.var = var;
  a.inv = inv;
  a.eps = eps;
  a.n = n;
  a.C = C;
  long long need = 0;
  return dispatch(kFused, dtype, act, a, res != nullptr, vec, scratch, scratch_floats, &need,
                  (cudaStream_t)stream);
}

// ---------------------------------------------- the split launches
// At a data world above 1 the wrapper runs the statistics launch, sums its
// float32 output over the ranks with the row count, and runs the apply
// launch on the sums. act and has_res name the one-launch kernel whose grid
// the statistics launch takes. pass: 0 for bf16/f16 (lsum gets S then Q, 2C
// floats); for float32 1 (lsum gets S, C floats), then 2 after the first
// all-reduce (lsum gets the centred Q; gsum and gn are the global S and row
// count).
extern "C" long long bn_act_fwd_sums_scratch(int dtype, int act, int has_res, int pass,
                                             long long n, int C, int vec) {
  return scratch_of(kSums, dtype, act, has_res, n, C, vec, pass);
}

extern "C" int bn_act_fwd_sums_launch(int dtype, int act, int has_res, int pass,
                                      const void *z, long long n, int C, const float *gsum,
                                      const float *gn, float *lsum, float *scratch,
                                      long long scratch_floats, int vec, void *stream) {
  if (n <= 0 || C <= 0) return 0;
  if (scratch == nullptr || ((uintptr_t)scratch & 15) != 0) return (int)cudaErrorInvalidValue;
  if (pass == kCenteredPass && (gsum == nullptr || gn == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.z = z;
  a.gsum = gsum;
  a.gn = gn;
  a.lsum = lsum;
  a.pass = pass;
  a.n = n;
  a.C = C;
  long long need = 0;
  return dispatch(kSums, dtype, act, a, has_res != 0, vec, scratch, scratch_floats, &need,
                  (cudaStream_t)stream);
}

// gsum, gsq: the per-channel sums over the ranks (bf16/f16: S and Q; float32:
// S and the centred Q); gn: the global row count. Writes out, mean, var and
// inv as bn_act_fwd_launch does.
extern "C" int bn_act_fwd_apply_launch(int dtype, int act, const void *z, const void *gamma,
                                       const void *beta, const void *res, long long n, int C,
                                       float eps, const float *gsum, const float *gsq,
                                       const float *gn, void *out, float *mean, float *var,
                                       float *inv, int vec, void *stream) {
  if (n <= 0 || C <= 0) return 0;
  if (out == nullptr || gsum == nullptr || gsq == nullptr || gn == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a{};
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
  return dispatch(kApply, dtype, act, a, res != nullptr, vec, nullptr, 0, &need,
                  (cudaStream_t)stream);
}
