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
#include <stdint.h>

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

// The blocks of `kernel` (kThreads threads, `smem` bytes of dynamic shared
// memory) the card holds at once: at most min_blocks an SM, fewer if the
// occupancy calculator finds fewer resident. The count is cached per device
// in `resident`, one array per kernel.
inline int resident_blocks(const void *kernel, int min_blocks, std::atomic<int> *resident,
                           int *out, int smem = 0) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int blocks = dev < kMaxDevices ? resident[dev].load(std::memory_order_relaxed) : 0;
  if (blocks == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
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

// The split launches run on the one-launch kernel's grid (planned into g),
// so that at one rank their partial sums are that kernel's, bitwise; if
// fewer of the statistics kernel's blocks (`smem` bytes of dynamic shared
// memory each) fit on the card at once, on as many as fit. Both launches of
// a direction fit the grid to the statistics kernel, so they share one plan.
inline int fit_grid(Grid &g, int V, const void *kernel, int min_blocks,
                    std::atomic<int> *resident, int smem = 0) {
  int blocks = 0;
  const int err = resident_blocks(kernel, min_blocks, resident, &blocks, smem);
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

// ------------------------------------------- the split launches' row walks
// A work item's rows stream through one of two walks, each handing every
// row of the thread's lane to a consumer fn(i, v) as NT 16-byte (or, at
// V = 1, scalar) packs v[t] of the NT tensors src[t] at element offset i
// (row * C + c0):
// - ring_walk (V > 1): a ring of STAGES stages in dynamic shared memory,
//   filled by TMA 1-D bulk copies (cp.async.bulk) that complete on one
//   mbarrier a stage; warp 0 refills a stage once every warp has
//   arrived on its "empty" barrier. A stage holds R rows of the item's
//   channel tile (R a multiple of RL, each lane R / RL of them), tensor by
//   tensor, each tensor's rows packed (one bulk copy when the tile spans
//   every channel, else one a row). Stage bytes are ring / STAGES.
// - reg_walk (V = 1: ragged C or unaligned operands, where bulk copies
//   cannot go): ROWS rows of loads in flight a thread, as the one launch.
// Either walk hands a lane its rows in increasing order (REV false: the
// statistics launches, whose sums must be the one launch's bitwise) or in
// decreasing order (REV true: the second launches, which reread first the
// rows the first launch read last, still in the 50 MB L2).

__device__ __forceinline__ unsigned smem_u32(const void *p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t *bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t *bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t *bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t *bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from global src
// to shared dst, completing on bar
__device__ __forceinline__ void bulk_load(void *dst, const void *src, unsigned bytes,
                                          uint64_t *bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Dynamic shared memory of a ring_walk of `stages` stages: the barriers
// (ring_head bytes), then the ring.
__host__ __device__ constexpr int ring_head(int stages) { return 16 * stages; }
__host__ __device__ constexpr int ring_smem(int stages, int ring_bytes) {
  return ring_head(stages) + ring_bytes;
}

// The rows of a stage of NT tensors: RL rows (one a lane) of at most
// 16 * GC bytes each take 4 KB a tensor, so a stage of `stage_bytes` (at
// least NT * 4 KB) holds RL * (stage_bytes / (NT * 4 KB)) rows.
constexpr int kLaneRowsBytes = 16 * kThreads;

template <typename T, int V, int NT, bool REV, int STAGES, class Fn>
__device__ __forceinline__ void ring_walk(const Grid &g, int item, const Item &it,
                                          const T *const *src, unsigned char *smem,
                                          int ring_bytes, Fn &&fn) {
  static_assert(V * sizeof(T) == 16, "ring_walk moves 16-byte channel groups");
  uint64_t *const full = reinterpret_cast<uint64_t *>(smem);
  uint64_t *const empty = full + STAGES;
  unsigned char *const ring = smem + ring_head(STAGES);
  const int tile = item % g.tiles;
  const int gl = threadIdx.x % g.GC, warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const unsigned rb = min(g.GC, g.G - tile * g.GC) * 16u;  // bytes of a row's tile slice
  const long long c0 = (long long)tile * g.GC * V;       // the tile's first channel
  const unsigned stage_bytes = (unsigned)(ring_bytes / STAGES) & ~15u;
  const int R = g.RL * (int)(stage_bytes / (NT * kLaneRowsBytes));
  const unsigned tbytes = R * rb;  // one tensor's rows in a stage
  const long long rows = it.r1 - it.r0;
  const int nst = rows <= 0 ? 0 : (int)((rows + R - 1) / R);
  const bool whole = g.tiles == 1;  // a stage's rows are contiguous in global memory
  // stage s of the walk covers rows [r0 + j R, ...), j = s (REV: nst - 1 - s)
  auto first_row = [&](int s) { return it.r0 + (long long)(REV ? nst - 1 - s : s) * R; };
  auto fill = [&](int s) {  // by warp 0: stage s into slot s % STAGES
    const int slot = s % STAGES;
    const long long f = first_row(s);
    const int nr = (int)min((long long)R, it.r1 - f);
    if (wl == 0) mbar_arrive_tx(&full[slot], NT * nr * rb);
    __syncwarp();
    unsigned char *const dst = ring + (size_t)slot * stage_bytes;
    if (whole) {
      if (wl < NT)
        bulk_load(dst + wl * tbytes, src[wl] + f * g.C + c0, nr * rb, &full[slot]);
    } else {
      for (int k = wl; k < NT * nr; k += 32) {
        const int t = k / nr, r = k % nr;
        bulk_load(dst + t * tbytes + r * rb, src[t] + (f + r) * g.C + c0, rb, &full[slot]);
      }
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreads / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp == 0)
    for (int s = 0; s < STAGES && s < nst; ++s) fill(s);
  for (int s = 0; s < nst; ++s) {
    const int slot = s % STAGES;
    const unsigned parity = (s / STAGES) & 1;
    mbar_wait(&full[slot], parity);
    if (it.active) {
      const long long f = first_row(s);
      const int nr = (int)min((long long)R, it.r1 - f);
      const unsigned char *const base = ring + (size_t)slot * stage_bytes + gl * 16;
      for (int k0 = 0; k0 < R; k0 += g.RL) {
        const int k = (REV ? R - g.RL - k0 : k0) + it.lane;
        if (k >= nr) continue;
        Pack<T, V> v[NT];
#pragma unroll
        for (int t = 0; t < NT; ++t)
          v[t] = *reinterpret_cast<const Pack<T, V> *>(base + t * tbytes + k * rb);
        fn((f + k) * g.C + it.c0, v);
      }
    }
    __syncwarp();
    if (wl == 0) mbar_arrive(&empty[slot]);
    if (warp == 0 && s + STAGES < nst) {
      mbar_wait(&empty[slot], parity);
      fill(s + STAGES);
    }
  }
  __syncthreads();  // every stage consumed: the ring may be reused
}

template <typename T, int V, int NT, bool REV, int ROWS, class Fn>
__device__ __forceinline__ void reg_walk(const Grid &g, const Item &it, const T *const *src,
                                         Fn &&fn) {
  if (!it.active) return;
  const long long step = REV ? -(long long)g.RL : (long long)g.RL;
  for (long long r = REV ? it.r1 - 1 - it.lane : it.r0 + it.lane;
       REV ? r >= it.r0 : r < it.r1; r += ROWS * step) {
    long long i[ROWS];
    bool ok[ROWS];
    Pack<T, V> v[ROWS][NT];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {  // every row's loads first
      const long long rj = r + j * step;
      ok[j] = REV ? rj >= it.r0 : rj < it.r1;
      i[j] = (ok[j] ? rj : r) * g.C + it.c0;
#pragma unroll
      for (int t = 0; t < NT; ++t) v[j][t] = ld<T, V>(src[t] + i[j]);
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      if (!ok[j]) break;
      fn(i[j], v[j]);
    }
  }
}

}  // namespace bn_act
