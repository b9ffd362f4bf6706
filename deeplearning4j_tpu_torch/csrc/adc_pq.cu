// adc_pq: flat product-quantization ADC gather-accumulate.
//
//   d2[i, j] = sum_{m = 0}^{M-1} lut[i, m, codes[j, m]]
//
// lut float32 (b, M, ksub), codes uint8 (n, M), d2 float32 (b, n), all
// row-major and contiguous. Replaces the TPU kernel
// deeplearning4j_tpu/perf/pallas/adc.py::_adc_kernel (wrapper score_pq).
// Each sum starts from 0.0f and adds in m order with one rounding per add
// (__fadd_rn, no contraction), which is the order of the JAX reference's
// `acc = acc + take(lut[:, m, :], codes[:, m])`, so the result equals the
// plain PyTorch version bitwise.
//
// Bound on an H100 SXM (3.35 TB/s): the (b, n) float32 output. At b = 256,
// n = 1,000,000, M = 8, ksub = 256 the kernel must write 1.02 GB and read
// 8 MB of codes and 2 MB of LUT: 0.31 ms. Beside the bytes, b*n*M LUT
// gathers (2.05e9 at that shape) go to shared memory, whose 32 banks serve
// one 128-byte wavefront a clock per SM: 32 random 4-byte gathers of a warp
// take about 3.5 wavefronts (bank conflicts), which alone costs about 1 ms
// at b = 256. That, not the bytes, set the first design's time.
//
// Design (the first design, adc_pq_v1.cu, asked for about 2,048 blocks
// that each staged their group of up to 8 queries' LUTs, 64 KB, to score
// about 2 code rows a thread, and gathered one float per (row, query, m)):
// - A persistent grid: as many blocks as the card holds at once (the
//   occupancy calculator, for the shared memory the group takes), each
//   walking a contiguous range of work items, an item being one query
//   group by one tile of code rows (group-major, so a block meets at most
//   a few groups). A block stages its group's LUTs by cp.async once per
//   group it meets, not once per tile. Blocks of 512 threads; fewer when
//   n is so small that the tiles would leave SMs without an item. (At
//   such an n a block takes one item, and every 64-bit division or
//   serial latency shows: the ranges are split by 32-bit division, the
//   (group, tile) walk advances without one, and the codes of M != 8 are
//   prefetched to L2 while the LUT stages.)
// - The LUT in shared memory is laid out [m][code][query] over a group of
//   QG queries (a power of two up to 16; 16 LUTs of 8 KB fill 128 KB). A
//   thread scores kRows = 4 consecutive code rows for QV = 4 queries: one
//   16-byte shared load gives its 4 queries' entries for one row's
//   (m, code). The lanes of a quarter-warp hold 2 rows x 4 query chunks at
//   QG = 16: two 64-byte runs, conflict-free whenever the two codes' runs
//   fall in different bank halves. Groups of 1 or 2 queries (b <= 2) take
//   QV = 1, 4-byte gathers of one query per lane.
// - Codes come as two 16-byte loads per thread (its 4 rows at M = 8), the
//   next item's loaded before the current one is scored. d2 goes out as
//   one 16-byte row piece per (query, thread), with streaming stores
//   (__stcs), so that the 1 GB output does not push the codes out of L2.
//   Each group rereads the codes, from L2.
// - M != 8 or codes not 16-byte aligned: codes byte by byte (kM = 0),
//   eight subspaces' worth of each row loaded before their gathers;
//   n % 4 != 0 or the ragged last rows: scalar stores. A query's LUT over
//   227 KB (M * ksub > 58,112) is read from global memory through the
//   read-only cache (kSmem = false), QV = 1. One kernel for all of them.
//
// The choices, timed by tools/kernel_variants.py on an H100 SXM at 700 W
// against the kernel as built in the same run (b = 8 / 32 / 256 over 1M
// rows, as built 32-35 / 82-87 / 539-546 us): groups of 8 queries
// 35 / 90 / 625, of 4 35 / 99 / 712; one query a lane (4-byte gathers on
// the same layout) 42 / 142 / 948; 8 rows a thread 44 / 110 / 711; 256
// threads a block 36 / 91 / 584; plain stores instead of streaming ones
// 35 / 84 / 548; registers capped for two blocks an SM within 1%.

#include <limits.h>

#include <algorithm>
#include <atomic>

#include "adc_common.cuh"

namespace {

constexpr int kThreads = 512;   // threads a block at most
constexpr int kMinBlocks = 1;   // registers: no cap below 128
constexpr int kRows = 4;        // consecutive code rows a thread scores (a multiple of 4)
constexpr int kMaxGroup = 16;   // queries a block holds at most

struct Params {
  const float *lut;
  const uint8_t *codes;
  float *d2;
  long long n;
  int ntiles, items;  // row tiles a group; (group, tile) items in all
  int b, M, ksub, qg, qshift;  // qg = 1 << qshift queries a group
};

__device__ __forceinline__ void cp_async4(float *dst, const float *src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The kRows rows' codes at M = 8, two words a row (zeros past n).
__device__ __forceinline__ void load_codes8(const Params &p, long long j0,
                                            uint32_t (&w)[2 * kRows]) {
  if (j0 + kRows <= p.n) {
    const uint4 *src = reinterpret_cast<const uint4 *>(p.codes + j0 * 8);
#pragma unroll
    for (int k = 0; k < kRows / 2; ++k) {
      const uint4 a = __ldg(src + k);
      w[4 * k] = a.x, w[4 * k + 1] = a.y, w[4 * k + 2] = a.z, w[4 * k + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      uint2 v = make_uint2(0u, 0u);
      if (j0 + r < p.n) v = __ldg(reinterpret_cast<const uint2 *>(p.codes + (j0 + r) * 8));
      w[2 * r] = v.x, w[2 * r + 1] = v.y;
    }
  }
}

template <bool kSmem, int kM, int QV>
__global__ void __launch_bounds__(kThreads, kMinBlocks) adc_pq_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float *const L = reinterpret_cast<float *>(smem4);
  const int nch = p.qg / QV;  // lanes a row group
  const int chunk = threadIdx.x % nch, rg = threadIdx.x / nch;
  const long long tile_rows = (long long)kRows * (blockDim.x / nch);
  const long long mk = (long long)p.M * p.ksub;  // floats a query's LUT
  const int begin = adc::span_edge(blockIdx.x, p.items, gridDim.x);
  const int count = adc::span_edge(blockIdx.x + 1, p.items, gridDim.x) - begin;
  const bool vec_out = (p.n & 3) == 0;
  // the item's query group and row tile, advanced without a division
  int g = begin / p.ntiles, staged = -1;
  int tile = begin - g * p.ntiles;
  uint32_t cur[2 * kRows] = {}, nxt[2 * kRows] = {};
  if (kM == 8 && count > 0) load_codes8(p, tile * tile_rows + rg * kRows, cur);
  for (int k = 0; k < count; ++k) {
    const long long j0 = tile * tile_rows + rg * kRows;
    const int next_tile = tile + 1 == p.ntiles ? 0 : tile + 1;
    const int q0 = g * p.qg;  // the group's first query
    if constexpr (kM != 8) {  // the rows' codes on their way to L2 while the LUT stages
      const long long last = min(p.n, j0 + kRows) - 1;
      if (j0 <= last) {
        asm volatile("prefetch.global.L2 [%0];" ::"l"(p.codes + j0 * p.M));
        asm volatile("prefetch.global.L2 [%0];" ::"l"(p.codes + last * p.M + p.M - 1));
      }
    }
    if (kSmem && g != staged) {
      __syncthreads();  // every thread is done with the last group's LUTs
      // L[(m * ksub + code) * qg + q] = lut[q0 + q, m, code]; queries past
      // b are zero-filled
      for (int e = threadIdx.x; e < p.qg * (int)mk; e += blockDim.x) {  // under 58,112
        const int q = e & (p.qg - 1);
        const bool ok = q0 + q < p.b;
        cp_async4(L + e, p.lut + (ok ? (q0 + q) * mk + (e >> p.qshift) : 0), ok ? 4 : 0);
      }
      cp_async_wait_all();
      __syncthreads();
      staged = g;
    }
    if (kM == 8 && k + 1 < count) load_codes8(p, next_tile * tile_rows + rg * kRows, nxt);

    float acc[kRows][QV];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < QV; ++i) acc[r][i] = 0.0f;
    const int Mr = kM > 0 ? kM : p.M;  // a constant M lets the loop unroll
    for (int m0 = 0; m0 < Mr; m0 += 8) {
      // the rows' codes of subspaces m0 .. m0+7, all loaded before the
      // gathers (a bad code is clamped: it never reads outside the LUT)
      int code[kRows][8];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if constexpr (kM == 8) {
            code[r][u] = (int)((cur[2 * r + (u >> 2)] >> (8 * (u & 3))) & 0xFFu);
          } else {
            code[r][u] = j0 + r < p.n && m0 + u < Mr
                             ? (int)__ldg(p.codes + (j0 + r) * p.M + m0 + u) : 0;
          }
          code[r][u] = min(code[r][u], p.ksub - 1);
        }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int m = m0 + u;
        if (m >= Mr) break;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int c = code[r][u];
          if constexpr (kSmem) {
            const float *e = L + ((long long)m * p.ksub + c) * p.qg + chunk * QV;
            if constexpr (QV == 4) {
              const float4 v = *reinterpret_cast<const float4 *>(e);
              acc[r][0] = __fadd_rn(acc[r][0], v.x);
              acc[r][1] = __fadd_rn(acc[r][1], v.y);
              acc[r][2] = __fadd_rn(acc[r][2], v.z);
              acc[r][3] = __fadd_rn(acc[r][3], v.w);
            } else {
              acc[r][0] = __fadd_rn(acc[r][0], *e);
            }
          } else {
            const int q = min(q0 + chunk, p.b - 1);
            acc[r][0] = __fadd_rn(acc[r][0], __ldg(p.lut + q * mk + (long long)m * p.ksub + c));
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < QV; ++i) {
      const int q = q0 + chunk * QV + i;
      if (q >= p.b) break;
      float *o = p.d2 + (long long)q * p.n + j0;
#pragma unroll
      for (int r = 0; r < kRows; r += 4) {
        if (vec_out && j0 + r + 4 <= p.n) {
          __stcs(reinterpret_cast<float4 *>(o + r),
                 make_float4(acc[r][i], acc[r + 1][i], acc[r + 2][i], acc[r + 3][i]));
        } else {
#pragma unroll
          for (int k = r; k < r + 4; ++k)
            if (j0 + k < p.n) __stcs(o + k, acc[k][i]);
        }
      }
    }
    if constexpr (kM == 8) {
#pragma unroll
      for (int k = 0; k < 2 * kRows; ++k) cur[k] = nxt[k];
    }
    tile = next_tile;
    if (tile == 0) ++g;
  }
}

template <bool kSmem, int kM, int QV>
int launch(Params p, cudaStream_t stream) {
  static std::atomic<long long> cache[adc::kMaxDevices];
  const void *kern = (const void *)adc_pq_kernel<kSmem, kM, QV>;
  const int smem = kSmem ? (int)(4LL * p.qg * p.M * p.ksub) : 0;
  int per_sm = 0, sms = 0;
  int err = adc::blocks_per_sm(kern, kThreads, smem, cache, &per_sm);
  if (err == 0) err = adc::sm_count(&sms);
  if (err != 0) return err;
  // kThreads a block, fewer (down to a warp's worth of row groups) while
  // that leaves SMs without an item: a small n spreads over the card
  const int nch = p.qg / QV, groups = (p.b + p.qg - 1) / p.qg;
  int threads = kThreads;
  long long items;
  for (;;) {
    const long long tile_rows = (long long)kRows * (threads / nch);
    items = (p.n + tile_rows - 1) / tile_rows * groups;
    if (items >= sms || threads / 2 < 32 * nch) break;
    threads /= 2;
  }
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  p.ntiles = (int)(items / groups);
  p.items = (int)items;
  const int grid = (int)std::min<long long>(items, (long long)per_sm * sms);
  adc_pq_kernel<kSmem, kM, QV><<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// vec8: the wrapper found M == 8 and codes 8-byte aligned; the 16-byte
// code loads also need the codes 16-byte aligned, which the kernel checks.
extern "C" int adc_pq_launch(const void *lut, const void *codes, void *d2, int b,
                             long long n, int M, int ksub, int vec8, void *stream) {
  if (b <= 0 || n <= 0) return 0;
  if (M < 1 || ksub < 1) return (int)cudaErrorInvalidValue;
  Params p{};
  p.lut = (const float *)lut;
  p.codes = (const uint8_t *)codes;
  p.d2 = (float *)d2;
  p.n = n;
  p.b = b;
  p.M = M;
  p.ksub = ksub;
  const long long per_q = 4LL * M * ksub;  // LUT bytes a query
  const bool smem = per_q <= adc::kMaxSmem;
  // the group: b rounded up to a power of two, at most kMaxGroup, as many
  // LUTs as shared memory holds, at most 4 on the global-LUT path
  int qg = 1;
  while (qg < b && qg < (smem ? kMaxGroup : 4) && (!smem || 2 * qg * per_q <= adc::kMaxSmem))
    qg *= 2;
  p.qg = qg;
  while ((1 << p.qshift) < qg) ++p.qshift;
  const bool v8 = vec8 && M == 8 && ((uintptr_t)codes & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (!smem) return launch<false, 0, 1>(p, s);
  if (qg >= 4) return v8 ? launch<true, 8, 4>(p, s) : launch<true, 0, 4>(p, s);
  return v8 ? launch<true, 8, 1>(p, s) : launch<true, 0, 1>(p, s);
}
