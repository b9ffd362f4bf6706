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
// where no collective can sit, so the forward runs as two launches around
// one collective, both on the one launch's grid and work items (fit_grid):
// - bn_fwd_sums (cooperative): pass 1 and pass 2's sums as the one launch
//   takes them, bitwise. bf16/f16: float32 S and Q with the row count (2C + 1
//   floats). float32: this rank's row (K, S', Q', n) of a zero-padded
//   (world, 3C + 1) buffer of doubles, K = z[0, c] of this rank;
// - the wrapper's one all-reduce of that buffer (the float32 rows come back
//   every rank's, in rank order);
// - bn_fwd_apply: each thread forms its channels' statistics in its
//   prologue (float32: the ranks' shifted sums re-shifted to rank 0's K in
//   rank order, in double: with d_r = K_r - K_0, S = sum (S'_r + n_r d_r),
//   Q = sum (Q'_r + 2 d_r S'_r + n_r d_r^2), then pass 2's expressions; at
//   one rank d = 0 and these are the one launch's), the first row block
//   writes mean, var and inv, and pass 3 runs, each block rereading its rows
//   from the last (the statistics launch read them last: L2 hits).
// At one rank the split reproduces the one launch bitwise in every type.
// Both launches stream rows through ring_walk (bn_act_common.cuh): TMA
// bulk copies into a ring of kStages stages of dynamic shared memory; at
// V = 1, reg_walk. The split reads z twice (the one launch too, from L2
// where it can); its first design read it three times in float32 and took
// a second collective (kept as bn_act_split_v1.cu).
//
// The choices, timed by tools/kernel_variants.py (split_fwd_*): see
// PERF.md (the table's row 1).

#include <cooperative_groups.h>
#include <stdint.h>

#include "bn_act_common.cuh"

namespace {

using namespace bn_act;

constexpr int kMinBlocks = 3;  // blocks an SM the grid is sized for
constexpr int kStatRows = 4;   // rows a thread has in flight in pass 1
constexpr int kApplyRows = 4;  // and in pass 3

// The split launches' TMA ring (kStages stages in kRing bytes of dynamic
// shared memory a block; three blocks an SM take 96 KB) and the rows a
// thread has in flight where they walk registers (V = 1)
constexpr int kStages = 2;
constexpr int kRing = 32768;
constexpr bool kUseRing = true;  // V > 1: ring_walk (false: reg_walk)
constexpr int kSplitRows = 4;

// What a launch runs: the one cooperative launch, or one of the split
// launches a data world above 1 takes (a statistics launch, then after the
// collective the apply launch).
enum Op { kFused = 0, kSums = 1, kApply = 2 };

struct Args : Grid {
  const void *z, *res, *gamma, *beta;
  void *out;
  float *mean, *var, *inv;
  double *ps, *pq;  // per row block and channel: the partial sums
  float *coef;      // per channel: scale, then shift
  float eps;
  // the split launches: the statistics launch writes `stats` (bf16/f16: S,
  // Q, n as 2C + 1 floats; float32: the (world, 3C + 1) doubles, row rank);
  // the apply launch reads them summed over the ranks (gstats)
  void *stats;
  const void *gstats;
  int rank, world;
};

// What pass 1 sums in: float32 for bf16/f16 (the JAX kernel's float32 sums),
// double for float32.
template <typename T> struct Stat { using type = float; };
template <> struct Stat<float> { using type = double; };

// One row's V values into a thread's pass-1 sums: double sums shifted by
// k for float32, float32 sums of z and z^2 for bf16/f16.
template <typename T, int V, typename S>
__device__ __forceinline__ void add_row(const Pack<T, V> &zv, const double (&k)[V], S (&s)[V],
                                        S (&q)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float v = Cvt<T>::f(zv.e[e]);
    if constexpr (sizeof(T) == 4) {
      const double d = __dsub_rn((double)v, k[e]);
      s[e] = __dadd_rn(s[e], d);
      q[e] = __fma_rn(d, d, q[e]);
    } else {
      s[e] = __fadd_rn(s[e], v);
      q[e] = __fmaf_rn(v, v, q[e]);
    }
  }
}

// The shift of float32's sums: the thread's channels' values in row 0.
template <typename T, int V>
__device__ __forceinline__ void shift_of(const T *z, const Item &it, double (&k)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) k[e] = 0.0;
  if (sizeof(T) == 4 && it.active) {
    const Pack<T, V> k0 = ld<T, V>(z + it.c0);
#pragma unroll
    for (int e = 0; e < V; ++e) k[e] = (double)Cvt<T>::f(k0.e[e]);
  }
}

// The row lanes' sums in order, written as the item's row block's partials.
template <typename T, int V, typename S>
__device__ __forceinline__ void lane_totals(const Args &a, int item, const Item &it,
                                            const S (&s)[V], const S (&q)[V], S *red) {
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

// Pass 1 for one work item: the per-channel partial sums over the item's rows.
template <typename T, int V>
__device__ __forceinline__ void partials(const Args &a, int item,
                                         typename Stat<T>::type *red) {
  using S = typename Stat<T>::type;
  const Item it = item_of<V>(a, item);
  const T *const z = (const T *)a.z;
  S s[V], q[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = q[e] = 0;
  double k[V];
  shift_of<T, V>(z, it, k);
  if (it.active) {
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
        add_row<T, V>(zv[j], k, s, q);
      }
    }
  }
  lane_totals<T, V>(a, item, it, s, q, red);
}

// The split statistics launch's pass 1: partials' sums, in partials' order
// (each lane's rows in increasing order), its rows through ring_walk.
template <typename T, int V>
__device__ __forceinline__ void split_partials(const Args &a, int item, unsigned char *smem) {
  using S = typename Stat<T>::type;
  const Item it = item_of<V>(a, item);
  const T *const z = (const T *)a.z;
  S s[V], q[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = q[e] = 0;
  double k[V];
  shift_of<T, V>(z, it, k);
  const T *const src[1] = {z};
  auto add = [&](long long, const Pack<T, V> *v) { add_row<T, V>(v[0], k, s, q); };
  if constexpr (V > 1 && kUseRing)
    ring_walk<T, V, 1, false, kStages>(a, item, it, src, smem, kRing, add);
  else
    reg_walk<T, V, 1, false, kSplitRows>(a, it, src, add);
  lane_totals<T, V>(a, item, it, s, q, reinterpret_cast<S *>(smem + ring_head(kStages)));
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
  partials<T, V>(a, blockIdx.x, red);
  cooperative_groups::this_grid().sync();
  const int warps = gridDim.x * (kThreads / 32);
  for (int c = blockIdx.x * (kThreads / 32) + threadIdx.x / 32; c < a.C; c += warps)
    finalize<T>(a, c, threadIdx.x % 32);
  cooperative_groups::this_grid().sync();
  apply<T, V, ACT, RES>(a, blockIdx.x);
}

extern __shared__ __align__(16) unsigned char split_smem[];

// The split statistics launch (cooperative): passes 1 and 2's sums, into
// `stats` (bf16/f16: S, Q and n as floats; float32: this rank's row K, S',
// Q', n of the zero-padded (world, 3C + 1) doubles, the other rows zeroed).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bn_fwd_sums(const Args a) {
  split_partials<T, V>(a, blockIdx.x, split_smem);
  cooperative_groups::this_grid().sync();
  const int warps = gridDim.x * (kThreads / 32);
  const long long w = 3LL * a.C + 1;
  for (int c = blockIdx.x * (kThreads / 32) + threadIdx.x / 32; c < a.C; c += warps) {
    double S, Q;
    channel_totals(a, c, threadIdx.x % 32, S, Q);
    if (threadIdx.x % 32 != 0) continue;
    if constexpr (sizeof(T) == 4) {
      double *const row = (double *)a.stats + a.rank * w;
      row[c] = (double)Cvt<T>::f(((const T *)a.z)[c]);
      row[a.C + c] = S;
      row[2 * a.C + c] = Q;
    } else {
      ((float *)a.stats)[c] = (float)S;
      ((float *)a.stats)[a.C + c] = (float)Q;
    }
  }
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t == 0) {
    if constexpr (sizeof(T) == 4)
      ((double *)a.stats)[a.rank * w + 3LL * a.C] = (double)a.n;
    else
      ((float *)a.stats)[2 * a.C] = (float)a.n;
  }
  if constexpr (sizeof(T) == 4)  // the other ranks' rows, for the all-reduce
    for (long long i = t; i < (a.world - 1) * w; i += (long long)gridDim.x * kThreads)
      ((double *)a.stats)[i < a.rank * w ? i : i + w] = 0.0;
}

// Channel c's float32 mean and var from the ranks' partials (world rows of
// 3C + 1 doubles: K, S', Q', n), re-shifted to rank 0's K in rank order, in
// double; at one rank pass 2's expressions on the one launch's sums.
__device__ __forceinline__ void combine(const double *p, int world, int C, int c, float &m,
                                        float &v) {
  const long long w = 3LL * C + 1;
  const double K = p[c];
  double S = p[C + c], Q = p[2 * C + c], n = p[3LL * C];
  for (int r = 1; r < world; ++r) {
    const double *const q = p + r * w;
    const double d = __dsub_rn(q[c], K), s = q[C + c], nr = q[3LL * C];
    S = __dadd_rn(S, __dadd_rn(s, __dmul_rn(nr, d)));
    Q = __dadd_rn(Q, __dadd_rn(__dadd_rn(q[2 * C + c], __dmul_rn(__dmul_rn(2.0, d), s)),
                               __dmul_rn(nr, __dmul_rn(d, d))));
    n = __dadd_rn(n, nr);
  }
  const double dm = __ddiv_rn(S, n);
  m = (float)__dadd_rn(K, dm);
  v = (float)fmax(__dsub_rn(__ddiv_rn(Q, n), __dmul_rn(dm, dm)), 0.0);
}

// The split apply launch (the statistics launch's grid and items, no grid
// sync): each thread forms its channels' statistics from gstats (see
// combine; bf16/f16: var = max(Q/n - mean^2, 0) from the float32 sums), the
// first row block writes mean, var and inv, and pass 3 runs over the item's
// rows from the last.
template <typename T, int V, int ACT, bool RES>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bn_fwd_apply(const Args a) {
  const Item it = item_of<V>(a, blockIdx.x);
  float sc[V], sh[V];
  if (it.active) {
    const bool first = blockIdx.x / a.tiles == 0 && it.lane == 0;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int c = it.c0 + e;
      float m, v;
      if constexpr (sizeof(T) == 4) {
        combine((const double *)a.gstats, a.world, a.C, c, m, v);
      } else {
        const float *const g = (const float *)a.gstats, nf = g[2 * a.C];
        m = __fdiv_rn(g[c], nf);
        v = fmaxf(__fsub_rn(__fdiv_rn(g[a.C + c], nf), __fmul_rn(m, m)), 0.f);
      }
      const float iv = __frsqrt_rn(__fadd_rn(v, a.eps));
      sc[e] = __fmul_rn(Cvt<T>::f(((const T *)a.gamma)[c]), iv);
      sh[e] = __fsub_rn(Cvt<T>::f(((const T *)a.beta)[c]), __fmul_rn(m, sc[e]));
      if (first) {
        a.mean[c] = m;
        a.var[c] = v;
        a.inv[c] = iv;
      }
    }
  }
  constexpr int NT = RES ? 2 : 1;
  const T *const src[2] = {(const T *)a.z, (const T *)a.res};
  auto put = [&](long long i, const Pack<T, V> *v) {
    Pack<T, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e)
      o.e[e] = Cvt<T>::t(act_fwd<T, ACT>(pre_act_of<T, RES>(
          Cvt<T>::f(v[0].e[e]), RES ? Cvt<T>::f(v[NT - 1].e[e]) : 0.f, sc[e], sh[e])));
    st<T, V>((T *)a.out + i, o);
  };
  if constexpr (V > 1 && kUseRing)
    ring_walk<T, V, NT, true, kStages>(a, blockIdx.x, it, src, split_smem, kRing, put);
  else
    reg_walk<T, V, NT, true, kSplitRows>(a, it, src, put);
}

static_assert(kRing / kStages >= 2 * kLaneRowsBytes, "a stage holds a row a lane of 2 tensors");
static_assert(2 * kThreads * 8 * 4 <= kRing, "the statistics' lane sums fit in the ring");

template <typename T, int V, int ACT, bool RES>
int plan(Args &a) {
  static std::atomic<int> resident[kMaxDevices];  // blocks, by device
  return plan_grid(a, V, (const void *)bn_fwd_fused<T, V, ACT, RES>, kMinBlocks, resident);
}

// Dynamic shared memory of the split launches' blocks: the ring at V > 1;
// at V = 1 the statistics launch's lane sums alone, the apply launch none.
template <int V>
constexpr int sums_smem() {
  return V > 1 && kUseRing ? ring_smem(kStages, kRing)
                           : ring_head(kStages) + 2 * kThreads * V * 8;
}
template <int V>
constexpr int apply_smem() {
  return V > 1 && kUseRing ? ring_smem(kStages, kRing) : 0;
}

// Allows `kernel` `bytes` of dynamic shared memory, once a device.
inline int allow_smem(const void *kernel, int bytes, std::atomic<int> *allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= kMaxDevices || allowed[dev].load() == 0)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && dev < kMaxDevices) allowed[dev].store(1);
  }
  return (int)err;
}

// The split launches' grid: the one launch's (plan), fitted to the
// statistics kernel (fit_grid).
template <typename T, int V, int ACT, bool RES>
int split_plan(Args &a) {
  static std::atomic<int> allowed[kMaxDevices], resident[kMaxDevices];
  int err = plan<T, V, ACT, RES>(a);
  const void *kernel = (const void *)bn_fwd_sums<T, V>;
  if (err == 0) err = allow_smem(kernel, sums_smem<V>(), allowed);
  return err != 0 ? err : fit_grid(a, V, kernel, kMinBlocks, resident, sums_smem<V>());
}

// Plans the grid and sets *need to the scratch it takes (floats); then,
// given scratch of at least that, launches `op`. The partial sums are
// doubles, first in the scratch (which is 16-byte aligned), then (the one
// launch) scale and shift. The apply launch takes no scratch.
template <typename T, int V, int ACT, bool RES>
int run_v(int op, Args &a, float *scratch, long long cap, long long *need, cudaStream_t st) {
  if (op == kApply) {
    static std::atomic<int> allowed[kMaxDevices];
    int err = split_plan<T, V, ACT, RES>(a);
    if (err == 0)
      err = allow_smem((const void *)bn_fwd_apply<T, V, ACT, RES>, apply_smem<V>(), allowed);
    if (err != 0) return err;
    bn_fwd_apply<T, V, ACT, RES><<<a.tiles * a.nrb, kThreads, apply_smem<V>(), st>>>(a);
    return (int)cudaGetLastError();
  }
  const int err = op == kSums ? split_plan<T, V, ACT, RES>(a) : plan<T, V, ACT, RES>(a);
  if (err != 0) return err;
  *need = 4LL * a.nrb * a.C + (op == kSums ? 0 : 2LL * a.C);
  if (scratch == nullptr) return 0;
  if (cap < *need) return (int)cudaErrorInvalidValue;
  a.ps = (double *)scratch;
  a.pq = a.ps + (long long)a.nrb * a.C;
  a.coef = (float *)(a.pq + (long long)a.nrb * a.C);
  void *args[] = {(void *)&a};
  const void *kernel = op == kSums ? (const void *)bn_fwd_sums<T, V>
                                   : (const void *)bn_fwd_fused<T, V, ACT, RES>;
  return (int)cudaLaunchCooperativeKernel(kernel, a.tiles * a.nrb, kThreads, args,
                                          op == kSums ? sums_smem<V>() : 0, st);
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
  if (op != kFused && (a.world < 1 || a.rank < 0 || a.rank >= a.world))
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
  a.world = 1;
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
  return scratch_of(kFused, dtype, act, has_res, n, C, vec);
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
// output over the ranks in one all-reduce, and runs the apply launch on
// the sums. act and has_res name the one-launch kernel whose grid both
// launches take. stats: bf16/f16 2C + 1 floats (S, Q, n); float32 a
// (world, 3C + 1) array of doubles, rank's row (K, S', Q', n) written and
// the others zeroed.
extern "C" long long bn_act_fwd_sums_scratch(int dtype, int act, int has_res, long long n,
                                             int C, int vec) {
  return scratch_of(kSums, dtype, act, has_res, n, C, vec);
}

extern "C" int bn_act_fwd_sums_launch(int dtype, int act, int has_res, const void *z,
                                      long long n, int C, int rank, int world, void *stats,
                                      float *scratch, long long scratch_floats, int vec,
                                      void *stream) {
  if (n <= 0 || C <= 0) return 0;
  if (scratch == nullptr || ((uintptr_t)scratch & 15) != 0 || stats == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.z = z;
  a.stats = stats;
  a.rank = rank;
  a.world = world;
  a.n = n;
  a.C = C;
  long long need = 0;
  return dispatch(kSums, dtype, act, a, has_res != 0, vec, scratch, scratch_floats, &need,
                  (cudaStream_t)stream);
}

// gstats: the statistics launch's output summed over the ranks (float32:
// world rows). Writes out, mean, var and inv as bn_act_fwd_launch does.
extern "C" int bn_act_fwd_apply_launch(int dtype, int act, const void *z, const void *gamma,
                                       const void *beta, const void *res, long long n, int C,
                                       float eps, int world, const void *gstats, void *out,
                                       float *mean, float *var, float *inv, int vec,
                                       void *stream) {
  if (n <= 0 || C <= 0) return 0;
  if (out == nullptr || gstats == nullptr) return (int)cudaErrorInvalidValue;
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
  a.gstats = gstats;
  a.world = world;
  a.n = n;
  a.C = C;
  long long need = 0;
  return dispatch(kApply, dtype, act, a, res != nullptr, vec, nullptr, 0, &need,
                  (cudaStream_t)stream);
}
