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
// bn_act_bwd_split), both on the one launch's grid and work items
// (fit_grid):
// - bn_bwd_sums (cooperative): passes 1 and 2's sums as the one launch
//   takes them, bitwise: dpre (when res is given), this rank's dgamma and
//   dbeta, and the same two with the row count as 2C + 1 floats for the
//   wrapper's one all-reduce;
// - bn_bwd_dz: each thread forms its channels' coefficients from the
//   all-reduced sums as pass 2 does, then pass 3 runs, each block walking
//   its rows from the last (the sums launch read them last: L2 hits). With
//   res it reads z and the dpre the sums launch wrote (stored in z's type,
//   as the JAX reference rounds it before use: the same bits as
//   recomputing it) in place of dout and res; without, z and dout.
// At one rank the split reproduces the one launch bitwise. Both launches
// stream rows through ring_walk (bn_act_common.cuh): TMA bulk copies into
// a ring of kStages stages of dynamic shared memory; at V = 1, reg_walk.
// The first design (bn_act_split_v1.cu) walked registers two rows deep and
// reread dout and res in the dz launch.

#include <cooperative_groups.h>
#include <stdint.h>

#include "bn_act_common.cuh"

namespace {

using namespace bn_act;

constexpr int kMinBlocks = 2;  // blocks an SM the grid is sized for
constexpr int kMaxV = 8;
constexpr int kRows = 2;  // rows a thread has in flight

// The split launches walk registers (reg_walk, kSplitRows rows of loads in
// flight a thread); the TMA ring (kStages stages in kRing bytes of dynamic
// shared memory a block, two blocks an SM) is the timed alternative
constexpr int kStages = 4;
constexpr int kRing = 98304;
constexpr bool kUseRing = false;  // V > 1: ring_walk (false: reg_walk)
constexpr int kSplitRows = 2;

// What a launch runs: the one cooperative launch, or one of the split
// launches a data world above 1 takes (the sums launch, then after the
// all-reduce the dz launch).
enum Op { kFused = 0, kSums = 1, kDz = 2 };

struct Args : Grid {
  const void *z, *res, *dout, *gamma, *beta;
  const float *mean, *inv;
  void *dz, *dpre;
  float *dgamma, *dbeta, *pg, *pb, *coef;
  // the split launches: the sums launch writes sums (dgamma, dbeta, n: 2C +
  // 1 floats); the dz launch reads them summed over the ranks (gsums)
  float *sums;
  const float *gsums;
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

// The row lanes' sums in order, written as the item's row block's partials.
template <int V>
__device__ __forceinline__ void lane_totals(const Args &a, int item, const Item &it,
                                            const float (&g)[V], const float (&b)[V],
                                            float *red) {
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
  lane_totals<V>(a, item, it, g, b, red);
}

// The split sums launch's pass 1: partials' sums and dpre, in partials'
// order (each lane's rows in increasing order), its rows (z, dout and res)
// through ring_walk.
template <typename T, int V, int ACT, bool RES>
__device__ __forceinline__ void split_partials(const Args &a, int item, unsigned char *smem) {
  const Item it = item_of<V>(a, item);
  float g[V], b[V], m[V], iv[V], sc[V], sh[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    g[e] = b[e] = 0.f;
    const int c = it.active ? it.c0 + e : 0;
    m[e] = a.mean[c];
    iv[e] = a.inv[c];
    sc[e] = __fmul_rn(Cvt<T>::f(((const T *)a.gamma)[c]), iv[e]);
    sh[e] = __fsub_rn(Cvt<T>::f(((const T *)a.beta)[c]), __fmul_rn(m[e], sc[e]));
  }
  constexpr int NT = RES ? 3 : 2;
  const T *const src[3] = {(const T *)a.z, (const T *)a.dout, (const T *)a.res};
  auto add = [&](long long i, const Pack<T, V> *v) {
    float d[V];
    dpre_of<T, V, ACT, RES>(v[0], v[NT - 1], v[1], sc, sh, d);
    if (RES) {
      Pack<T, V> out;
#pragma unroll
      for (int e = 0; e < V; ++e) out.e[e] = Cvt<T>::t(d[e]);
      st<T, V>((T *)a.dpre + i, out);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float xh = __fmul_rn(__fsub_rn(Cvt<T>::f(v[0].e[e]), m[e]), iv[e]);
      g[e] = __fmaf_rn(d[e], xh, g[e]);
      b[e] = __fadd_rn(b[e], d[e]);
    }
  };
  if constexpr (V > 1 && kUseRing)
    ring_walk<T, V, NT, false, kStages>(a, item, it, src, smem, kRing, add);
  else
    reg_walk<T, V, NT, false, kSplitRows>(a, it, src, add);
  lane_totals<V>(a, item, it, g, b, reinterpret_cast<float *>(smem + ring_head(kStages)));
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

extern __shared__ __align__(16) unsigned char split_smem[];

// The split sums launch (cooperative): passes 1 and 2's sums, this rank's
// dgamma and dbeta (and dpre when res is given), and sums = (dgamma,
// dbeta, n) for the all-reduce over the ranks.
template <typename T, int V, int ACT, bool RES>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bn_bwd_sums(const Args a) {
  split_partials<T, V, ACT, RES>(a, blockIdx.x, split_smem);
  cooperative_groups::this_grid().sync();
  for (int c = blockIdx.x * kThreads + threadIdx.x; c < a.C; c += gridDim.x * kThreads) {
    float dg, db;
    channel_sums(a, c, dg, db);
    a.dgamma[c] = a.sums[c] = dg;
    a.dbeta[c] = a.sums[a.C + c] = db;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) a.sums[2 * a.C] = (float)a.n;
}

// The split dz launch (the sums launch's grid and items, no grid sync):
// each thread forms its channels' coefficients from gsums as the one
// launch's pass 2 does from its own, then pass 3 runs over the item's rows
// from the last, from z and dpre (with res) or z and dout.
template <typename T, int V, int ACT, bool RES>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bn_bwd_dz(const Args a) {
  const Item it = item_of<V>(a, blockIdx.x);
  const float nf = a.gsums[2 * a.C];
  float sc[V], sh[V], m[V], iv[V], cb[V], cg[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int c = it.active ? it.c0 + e : 0;
    m[e] = a.mean[c];
    iv[e] = a.inv[c];
    sc[e] = __fmul_rn(Cvt<T>::f(((const T *)a.gamma)[c]), iv[e]);
    sh[e] = __fsub_rn(Cvt<T>::f(((const T *)a.beta)[c]), __fmul_rn(m[e], sc[e]));
    cb[e] = __fdiv_rn(a.gsums[a.C + c], nf);
    cg[e] = __fdiv_rn(a.gsums[c], nf);
  }
  const T *const src[2] = {(const T *)a.z, (const T *)(RES ? a.dpre : a.dout)};
  auto put = [&](long long i, const Pack<T, V> *v) {
    Pack<T, V> out;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float z = Cvt<T>::f(v[0].e[e]);
      const float d = RES ? Cvt<T>::f(v[1].e[e])
                          : act_bwd<T, ACT>(pre_act_of<T, false>(z, 0.f, sc[e], sh[e]),
                                            Cvt<T>::f(v[1].e[e]));
      const float xh = __fmul_rn(__fsub_rn(z, m[e]), iv[e]);
      const float t = __fsub_rn(__fsub_rn(d, cb[e]), __fmul_rn(xh, cg[e]));
      out.e[e] = Cvt<T>::t(__fmul_rn(sc[e], t));
    }
    st<T, V>((T *)a.dz + i, out);
  };
  if constexpr (V > 1 && kUseRing)
    ring_walk<T, V, 2, true, kStages>(a, blockIdx.x, it, src, split_smem, kRing, put);
  else
    reg_walk<T, V, 2, true, kSplitRows>(a, it, src, put);
}

static_assert(kRing / kStages >= 3 * kLaneRowsBytes, "a stage holds a row a lane of 3 tensors");
static_assert(2 * kThreads * kMaxV * 4 <= kRing, "the sums' lane totals fit in the ring");

// The grid for V-element channel groups (bn_act_common.cuh's plan_grid).
template <typename T, int V, int ACT, bool RES>
int plan(Args &a) {
  static std::atomic<int> resident[kMaxDevices];  // blocks, by device
  return plan_grid(a, V, (const void *)bn_bwd_fused<T, V, ACT, RES>, kMinBlocks, resident);
}

// Dynamic shared memory of the split launches' blocks: the ring at V > 1;
// at V = 1 the sums launch's lane totals alone, the dz launch none.
template <int V>
constexpr int sums_smem() {
  return V > 1 && kUseRing ? ring_smem(kStages, kRing)
                           : ring_head(kStages) + 2 * kThreads * kMaxV * 4;
}
template <int V>
constexpr int dz_smem() {
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

// The split launches' grid: the one launch's (plan), fitted to the sums
// kernel (fit_grid).
template <typename T, int V, int ACT, bool RES>
int split_plan(Args &a) {
  static std::atomic<int> allowed[kMaxDevices], resident[kMaxDevices];
  int err = plan<T, V, ACT, RES>(a);
  const void *kernel = (const void *)bn_bwd_sums<T, V, ACT, RES>;
  if (err == 0) err = allow_smem(kernel, sums_smem<V>(), allowed);
  return err != 0 ? err : fit_grid(a, V, kernel, kMinBlocks, resident, sums_smem<V>());
}

// Plans the grid and sets *need to the scratch it takes (floats); then,
// given scratch of at least that, launches `op`. The dz launch takes no
// scratch.
template <typename T, int V, int ACT, bool RES>
int run_v(int op, Args &a, float *scratch, long long cap, long long *need, cudaStream_t st) {
  if (op == kDz) {
    static std::atomic<int> allowed[kMaxDevices];
    int err = split_plan<T, V, ACT, RES>(a);
    if (err == 0)
      err = allow_smem((const void *)bn_bwd_dz<T, V, ACT, RES>, dz_smem<V>(), allowed);
    if (err != 0) return err;
    bn_bwd_dz<T, V, ACT, RES><<<a.tiles * a.nrb, kThreads, dz_smem<V>(), st>>>(a);
    return (int)cudaGetLastError();
  }
  const int err = op == kSums ? split_plan<T, V, ACT, RES>(a) : plan<T, V, ACT, RES>(a);
  if (err != 0) return err;
  *need = 2LL * a.nrb * a.C + (op == kSums ? 0 : 4LL * a.C);
  if (scratch == nullptr) return 0;
  if (cap < *need) return (int)cudaErrorInvalidValue;
  a.pg = scratch;
  a.pb = a.pg + (long long)a.nrb * a.C;
  a.coef = a.pb + (long long)a.nrb * a.C;
  void *args[] = {(void *)&a};
  const void *kernel = op == kSums ? (const void *)bn_bwd_sums<T, V, ACT, RES>
                                   : (const void *)bn_bwd_fused<T, V, ACT, RES>;
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
// dgamma and dbeta, dpre when res is given, and sums = (dgamma, dbeta, n),
// 2C + 1 floats), all-reduces sums over the ranks, and runs the dz launch
// on them.
extern "C" long long bn_act_bwd_sums_scratch(int dtype, int act, int has_res, long long n,
                                             int C, int vec) {
  return scratch_of(kSums, dtype, act, has_res, n, C, vec);
}

extern "C" int bn_act_bwd_sums_launch(int dtype, int act, const void *z, const void *gamma,
                                      const void *beta, const void *res, const float *mean,
                                      const float *inv, const void *dout, long long n, int C,
                                      float *dgamma, float *dbeta, void *dpre, float *sums,
                                      float *scratch, long long scratch_floats, int vec,
                                      void *stream) {
  if (n <= 0 || C <= 0) return 0;
  if ((res == nullptr) != (dpre == nullptr) || scratch == nullptr || sums == nullptr)
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
  a.sums = sums;
  a.n = n;
  a.C = C;
  long long need = 0;
  return dispatch(kSums, dtype, act, a, res != nullptr, vec, scratch, scratch_floats, &need,
                  (cudaStream_t)stream);
}

// gsums: the sums launch's `sums` summed over the ranks. With res, dpre (the
// sums launch's) is read in place of dout and res (res only names the
// kernel); without, dout.
extern "C" int bn_act_bwd_dz_launch(int dtype, int act, const void *z, const void *gamma,
                                    const void *beta, const void *res, const float *mean,
                                    const float *inv, const void *dout, const void *dpre,
                                    long long n, int C, const float *gsums, void *dz, int vec,
                                    void *stream) {
  if (n <= 0 || C <= 0) return 0;
  if (dz == nullptr || gsums == nullptr || (res == nullptr) != (dpre == nullptr) ||
      (res == nullptr && dout == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.z = z;
  a.res = res;
  a.dout = dout;
  a.dpre = (void *)dpre;
  a.gamma = gamma;
  a.beta = beta;
  a.mean = mean;
  a.inv = inv;
  a.dz = dz;
  a.gsums = gsums;
  a.n = n;
  a.C = C;
  long long need = 0;
  return dispatch(kDz, dtype, act, a, res != nullptr, vec, nullptr, 0, &need,
                  (cudaStream_t)stream);
}
