// What the bn_act_fwd and bn_act_bwd kernels share: element types, the
// activations they take, the recomputed pre-activation, and the cooperative
// grid of their redesigns (16-byte vectors of channels, work items of a
// channel tile by a row block, at most as many blocks as the card holds at
// once).
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

#include <algorithm>
#include <atomic>

namespace bn_act {

// The first designs' grids (bn_act_{fwd,bwd}_v1.cu, the yardsticks): see
// elt_blocks and lane_sum below.
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

// ------------------------------------------------ the redesigns' grid
constexpr int kThreads = 256;    // threads a block of a cooperative kernel
constexpr int kMaxDevices = 64;  // devices whose resident-block count is cached

// V elements of T at p, one load or store (16 bytes when V > 1: p is then
// 16-byte aligned)
template <typename T, int V>
struct alignas(V * sizeof(T) == 16 ? 16 : alignof(T)) Pack {
  T e[V];
};
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> ld(const T *p) {
  return *reinterpret_cast<const Pack<T, V> *>(p);
}
template <typename T, int V>
__device__ __forceinline__ void st(T *p, const Pack<T, V> &x) {
  *reinterpret_cast<Pack<T, V> *>(p) = x;
}

// The work of a cooperative launch over (n, C): V-element channel groups,
// G of them; a block holds GC groups (a power of two, at most kThreads) by
// RL = kThreads / GC row lanes; tiles channel tiles by nrb row blocks of
// rpb rows, one work item a block.
struct Grid {
  long long n, rpb;
  int C, G, GC, RL, tiles, nrb;
};

// A block's work item: channel tile, row block, and the thread's place.
struct Item {
  int c0;            // the thread's first channel (c0 .. c0+V-1)
  bool active;       // c0 < C
  int lane;          // row lane
  long long r0, r1;  // the row block
};
template <int V>
__device__ __forceinline__ Item item_of(const Grid &g, int item) {
  const int tile = item % g.tiles, rb = item / g.tiles;
  const int gl = threadIdx.x % g.GC;
  Item it;
  it.c0 = (tile * g.GC + gl) * V;
  it.active = tile * g.GC + gl < g.G;
  it.lane = threadIdx.x / g.GC;
  it.r0 = (long long)rb * g.rpb;
  it.r1 = min(g.n, it.r0 + g.rpb);
  return it;
}

// The blocks of `kernel` (kThreads threads) the card holds at once: at most
// min_blocks an SM, fewer if the occupancy calculator finds fewer resident.
// The count is cached per device in `resident`, one array per kernel.
inline int resident_blocks(const void *kernel, int min_blocks, std::atomic<int> *resident,
                           int *out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int blocks = dev < kMaxDevices ? resident[dev].load(std::memory_order_relaxed) : 0;
  if (blocks == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    blocks = std::min(per_sm, min_blocks) * sms;
    if (dev < kMaxDevices) resident[dev].store(blocks, std::memory_order_relaxed);
  }
  *out = blocks;
  return 0;
}

// Lays g (n and C set) out for V-element channel groups over at most
// `blocks` blocks.
inline int plan_items(Grid &g, int V, int blocks) {
  g.G = g.C / V;
  g.GC = 1;
  while (g.GC < g.G && g.GC < kThreads) g.GC *= 2;
  g.RL = kThreads / g.GC;
  g.tiles = (g.G + g.GC - 1) / g.GC;
  if (g.tiles > blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long nrb =
      std::max(1LL, std::min((long long)(blocks / g.tiles), (g.n + g.RL - 1) / g.RL));
  g.rpb = (g.n + nrb - 1) / nrb;
  g.nrb = (int)((g.n + g.rpb - 1) / g.rpb);
  return 0;
}

// Plans g (n and C set) for V-element channel groups over as many blocks of
// `kernel` as the card holds at once (resident_blocks).
inline int plan_grid(Grid &g, int V, const void *kernel, int min_blocks,
                     std::atomic<int> *resident) {
  int blocks = 0;
  const int err = resident_blocks(kernel, min_blocks, resident, &blocks);
  return err != 0 ? err : plan_items(g, V, blocks);
}

// The split launches' statistics kernel runs on the one-launch kernel's
// grid (planned into g), so that at one rank its partial sums are that
// kernel's, bitwise; if fewer of its own blocks fit on the card at once, on
// as many as fit.
inline int fit_grid(Grid &g, int V, const void *kernel, int min_blocks,
                    std::atomic<int> *resident) {
  int blocks = 0;
  const int err = resident_blocks(kernel, min_blocks, resident, &blocks);
  if (err != 0) return err;
  return (long long)g.tiles * g.nrb > blocks ? plan_items(g, V, blocks) : 0;
}

// The vector width a launch may take: 1, or 16 bytes' worth of T (the
// caller found C * sizeof(T) a multiple of 16 and every (n, C) operand
// 16-byte aligned).
template <typename T>
constexpr bool vec_ok(int vec) {
  return vec == 1 || vec == 16 / (int)sizeof(T);
}

}  // namespace bn_act
