// adc_ivf_pq: IVF-PQ per-slot gather-accumulate over CSR candidate slots.
//
//   d2[i, s] = sum_{m = 0}^{M-1} lut[i, seg[i, s], m, codes[pos[i, s], m]]
//
// lut float32 (b, p, M, ksub) (one LUT per probed cell of each query),
// codes uint8 (n_codes, M) (the cell-major flat code table), seg and pos
// int32 (b, C) (each candidate slot's probe segment and flat row, from
// retrieval/index.py::_csr_slots), d2 float32 (b, C), all contiguous.
// Replaces the TPU kernel deeplearning4j_tpu/perf/pallas/adc.py::
// _ivf_adc_kernel (wrapper score_ivf_pq). Each sum starts from 0.0f and
// adds in m order (__fadd_rn), the JAX reference's order, so the result
// equals the plain PyTorch version bitwise. Invalid slots (pos clamped to 0
// and seg to p - 1 by _csr_slots) are computed like any other; the caller
// masks them to inf. Out-of-range seg, pos and codes are clamped here.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. Each slot reads seg and pos and
// writes one float, each valid slot reads its M code bytes, and each
// query's p*M*ksub LUT is read once: at b = 256, C = 65,536, p = 8, M = 8,
// ksub = 256 with 28% of the slots valid that is 201 MB + 38 MB + 17 MB,
// 76 us.
//
// Design (the first design, adc_ivf_pq_v1.cu, ran one block per query and
// slot tile, about 800 blocks, each staging its query's whole 64 KB LUT and
// scoring one slot a thread with 4-byte loads: at b = 1 the 256 blocks
// copied the same LUT 256 times, and at b = 256 it stayed at 2.6x its
// bound):
// - A persistent grid: as many blocks as the card holds at once (the
//   occupancy calculator), each walking a contiguous range of work items,
//   an item being one query by one tile of kSlots * blockDim.x slots, in
//   query-major order. Blocks of kThreads threads; fewer when the tiles
//   would leave SMs without an item (b = 1).
// - Only the cells a tile touches are staged. The block reduces the tile's
//   [min seg, max seg] (clamped) and, when that range is not inside the
//   cells it holds, stages the range's M*ksub floats a cell by cp.async.
//   _csr_slots lays the probed cells out probe-major, so seg does not
//   decrease along a query's slots: a tile touches one or two cells (8-16
//   KB at M = 8, ksub = 256), the invalid tail one. Nothing rests on that
//   order: random seg stages every cell the tile names, and a range over
//   the kStageBytes a block holds reads that tile's LUT from global memory
//   through the read-only cache (the same kernel; p = 32 at M = 8,
//   ksub = 256 takes it).
// - kSlots = 4 consecutive slots a thread: one 16-byte load of seg and one
//   of pos (C % 4 == 0 and 16-byte aligned rows; a scalar edge otherwise),
//   the next item's loaded before the current one is scored. At M = 8 the
//   four code rows come as two 16-byte loads when pos is four consecutive
//   rows starting at an even row (slots of one cell), one 8-byte load when
//   the four are one row (the invalid tail), else four 8-byte loads. Four
//   independent m-ordered chains, then one 16-byte streaming store of d2
//   (__stcs), so that the output does not push the LUT and codes out of L2.

#include <limits.h>

#include <algorithm>
#include <atomic>

#include "adc_common.cuh"

namespace {

constexpr int kThreads = 256;       // threads a block at most
constexpr int kMinBlocks = 4;       // registers: at most 64, four blocks an SM
constexpr int kSlots = 4;           // consecutive slots a thread scores
constexpr int kStageBytes = 32768;  // LUT bytes a block holds at most

struct Params {
  const float *lut;
  const uint8_t *codes;
  const int32_t *seg, *pos;
  float *d2;
  int n_rows;  // code rows, at most INT_MAX (pos is int32)
  int C, p, M, ksub;
  int ntiles, items;  // slot tiles a query; (query, tile) items in all
  int cap;            // cells a block holds in shared memory (0: none)
  int codes16;        // codes 16-byte aligned (the paired row loads)
};

__device__ __forceinline__ void cp_async16(float *dst, const float *src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(float *dst, const float *src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The kSlots seg / pos of one thread's slots in tile `tile` of query q,
// raw (clamped when used); 0 for slots at or past C.
template <bool kVec>
__device__ __forceinline__ void load_slots(const Params &p, int q, int tile,
                                           int (&sg)[kSlots], int (&ps)[kSlots]) {
  const int s0 = (tile * blockDim.x + threadIdx.x) * kSlots;
  const long long base = (long long)q * p.C + s0;
  if constexpr (kVec && kSlots == 4) {  // C % 4 == 0: the slots are all in or all out
    if (s0 < p.C) {
      const int4 a = __ldcs(reinterpret_cast<const int4 *>(p.seg + base));
      const int4 c = __ldcs(reinterpret_cast<const int4 *>(p.pos + base));
      sg[0] = a.x, sg[1] = a.y, sg[2] = a.z, sg[3] = a.w;
      ps[0] = c.x, ps[1] = c.y, ps[2] = c.z, ps[3] = c.w;
      return;
    }
  }
#pragma unroll
  for (int r = 0; r < kSlots; ++r) {
    const bool in = s0 + r < p.C;
    sg[r] = in ? __ldcs(p.seg + base + r) : 0;
    ps[r] = in ? __ldcs(p.pos + base + r) : 0;
  }
}

// The kSlots code rows at M = 8, two words a row: two 16-byte loads for
// four consecutive rows from an even one (slots of one cell), one 8-byte
// load for one row four times (the invalid tail), else one a row.
__device__ __forceinline__ void load_rows8(const Params &p, const int (&row)[kSlots],
                                           uint32_t (&w)[kSlots][2]) {
  if constexpr (kSlots == 4) {
    if (p.codes16 && (row[0] & 1) == 0 && row[1] == row[0] + 1 && row[2] == row[0] + 2 &&
        row[3] == row[0] + 3) {
      const uint4 *src = reinterpret_cast<const uint4 *>(p.codes + (long long)row[0] * 8);
      const uint4 a = __ldg(src), c = __ldg(src + 1);
      w[0][0] = a.x, w[0][1] = a.y, w[1][0] = a.z, w[1][1] = a.w;
      w[2][0] = c.x, w[2][1] = c.y, w[3][0] = c.z, w[3][1] = c.w;
      return;
    }
  }
  bool same = true;
#pragma unroll
  for (int r = 1; r < kSlots; ++r) same = same && row[r] == row[0];
#pragma unroll
  for (int r = 0; r < kSlots; ++r) {
    if (r == 0 || !same) {
      const uint2 v = __ldg(reinterpret_cast<const uint2 *>(p.codes + (long long)row[r] * 8));
      w[r][0] = v.x, w[r][1] = v.y;
    } else {
      w[r][0] = w[0][0], w[r][1] = w[0][1];
    }
  }
}

// Score the thread's slots: acc[r] = sum_m L[cell[r] * M * ksub + m * ksub +
// code], L in shared memory (kSmem) or global. cell[] is relative to L.
template <bool kSmem, int kM>
__device__ __forceinline__ void score(const Params &p, const float *__restrict__ L,
                                      const int (&cell)[kSlots], const int (&row)[kSlots],
                                      float (&acc)[kSlots]) {
  const int cf = p.M * p.ksub;
#pragma unroll
  for (int r = 0; r < kSlots; ++r) acc[r] = 0.0f;
  if constexpr (kM == 8) {
    uint32_t w[kSlots][2];
    load_rows8(p, row, w);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
#pragma unroll
      for (int r = 0; r < kSlots; ++r) {
        const int c = min((int)((w[r][m >> 2] >> (8 * (m & 3))) & 0xFFu), p.ksub - 1);
        acc[r] = __fadd_rn(acc[r], adc::lut_at<kSmem>(L + cell[r] * cf + m * p.ksub + c));
      }
    }
  } else {
    for (int m0 = 0; m0 < p.M; m0 += 8) {
      const int cnt = min(8, p.M - m0);
      int c[kSlots][8];
#pragma unroll
      for (int r = 0; r < kSlots; ++r)
        adc::load_codes<0>(p.codes + (long long)row[r] * p.M, m0, cnt, p.ksub, c[r]);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (u >= cnt) break;
#pragma unroll
        for (int r = 0; r < kSlots; ++r)
          acc[r] = __fadd_rn(acc[r], adc::lut_at<kSmem>(L + cell[r] * cf +
                                                       (m0 + u) * p.ksub + c[r][u]));
      }
    }
  }
}

// The thread's d2 values, streaming: one 16-byte store where C % 4 == 0
// (kVec), else one a slot; `left` slots of the row remain from o on.
template <bool kVec>
__device__ __forceinline__ void store(float *o, const float (&acc)[kSlots], int left) {
  if constexpr (kVec && kSlots == 4) {
    if (left > 0) __stcs(reinterpret_cast<float4 *>(o), make_float4(acc[0], acc[1], acc[2], acc[3]));
  } else {
#pragma unroll
    for (int r = 0; r < kSlots; ++r)
      if (r < left) __stcs(o + r, acc[r]);
  }
}

template <bool kVec, int kM>
__global__ void __launch_bounds__(kThreads, kMinBlocks) adc_ivf_pq_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float *const L = reinterpret_cast<float *>(smem4);
  __shared__ int red[2][2][kThreads / 32];  // [item parity][min, max][warp]
  const int nwarps = blockDim.x >> 5, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cf = p.M * p.ksub;  // floats a cell's LUT
  const int begin = adc::span_edge(blockIdx.x, p.items, gridDim.x);
  const int count = adc::span_edge(blockIdx.x + 1, p.items, gridDim.x) - begin;
  // the item's query and tile, advanced without a division
  int q = begin / p.ntiles;
  int tile = begin - q * p.ntiles;
  int held_q = -1, held_lo = 0, held_hi = -1;  // the cells in shared memory
  int sg[kSlots], ps[kSlots], nsg[kSlots], nps[kSlots];
  if (count > 0) load_slots<kVec>(p, q, tile, sg, ps);
  for (int k = 0; k < count; ++k) {
    const int s0 = (tile * blockDim.x + threadIdx.x) * kSlots;
    // the tile's cell range: every slot of the tile, the scalar edge
    // included; seg and pos clamped in place
    int lo = INT_MAX, hi = -1;
#pragma unroll
    for (int r = 0; r < kSlots; ++r) {
      sg[r] = min(max(sg[r], 0), p.p - 1);
      ps[r] = min(max(ps[r], 0), p.n_rows - 1);
      if (s0 + r < p.C) {
        lo = min(lo, sg[r]);
        hi = max(hi, sg[r]);
      }
    }
    lo = __reduce_min_sync(0xFFFFFFFFu, lo);
    hi = __reduce_max_sync(0xFFFFFFFFu, hi);
    const int par = k & 1;
    if (lane == 0) red[par][0][warp] = lo, red[par][1][warp] = hi;
    __syncthreads();
    for (int j = 0; j < nwarps; ++j) lo = min(lo, red[par][0][j]), hi = max(hi, red[par][1][j]);
    const bool in_smem = hi - lo < p.cap;
    if (in_smem && !(q == held_q && lo >= held_lo && hi <= held_hi)) {
      // every thread passed this item's barrier: none reads the old cells.
      // When the block's next item is this query's next tile, the cells
      // from lo on, as many as it holds (the next tiles' cells, where seg
      // does not decrease along the slots); else the tile's own.
      if (k + 1 < count && tile + 1 < p.ntiles) hi = max(hi, min(lo + p.cap - 1, p.p - 1));
      const float *src = p.lut + ((long long)q * p.p + lo) * cf;
      const int nf = (hi - lo + 1) * cf;
      if ((cf & 3) == 0 && (((uintptr_t)p.lut) & 15) == 0) {
        for (int e = threadIdx.x * 4; e < nf; e += blockDim.x * 4) cp_async16(L + e, src + e);
      } else {
        for (int e = threadIdx.x; e < nf; e += blockDim.x) cp_async4(L + e, src + e);
      }
      cp_async_wait_all();
      __syncthreads();
      held_q = q, held_lo = lo, held_hi = hi;
    }
    // the next item's slots, on their way while this one is scored
    int next_q = q, next_tile = tile + 1;
    if (next_tile == p.ntiles) next_tile = 0, ++next_q;
    if (k + 1 < count) load_slots<kVec>(p, next_q, next_tile, nsg, nps);

    float acc[kSlots];
    if (in_smem) {  // cells relative to the held ones
#pragma unroll
      for (int r = 0; r < kSlots; ++r) sg[r] = s0 + r < p.C ? sg[r] - held_lo : 0;
      score<true, kM>(p, L, sg, ps, acc);
    } else {
      score<false, kM>(p, p.lut + (long long)q * p.p * cf, sg, ps, acc);
    }
    float *o = p.d2 + (long long)q * p.C + s0;
    store<kVec>(o, acc, p.C - s0);
#pragma unroll
    for (int r = 0; r < kSlots; ++r) sg[r] = nsg[r], ps[r] = nps[r];
    q = next_q, tile = next_tile;
  }
}

template <bool kVec, int kM>
int launch(Params p, int b, cudaStream_t stream) {
  static std::atomic<long long> cache[adc::kMaxDevices];
  const void *kern = (const void *)adc_ivf_pq_kernel<kVec, kM>;
  const int smem = p.cap * p.M * p.ksub * 4;
  int per_sm = 0, sms = 0;
  int err = adc::blocks_per_sm(kern, kThreads, smem, cache, &per_sm);
  if (err == 0) err = adc::sm_count(&sms);
  if (err != 0) return err;
  // kThreads a block, fewer (down to a warp) while that leaves SMs without
  // an item: a small b spreads over the card
  int threads = kThreads;
  long long ntiles;
  for (;;) {
    ntiles = (p.C + (long long)kSlots * threads - 1) / ((long long)kSlots * threads);
    if (ntiles * b >= sms || threads / 2 < 32) break;
    threads /= 2;
  }
  if (ntiles * b > INT_MAX) return (int)cudaErrorInvalidValue;
  p.ntiles = (int)ntiles;
  p.items = (int)(ntiles * b);
  const int grid = (int)std::min<long long>(p.items, (long long)per_sm * sms);
  adc_ivf_pq_kernel<kVec, kM><<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// vec8: the wrapper found codes 8-byte aligned and M == 8; the paired
// 16-byte row loads also need them 16-byte aligned, which is checked here.
// b <= 65535 (the wrapper checks; the grid itself has no such limit).
extern "C" int adc_ivf_pq_launch(const void *lut, const void *codes, const void *seg,
                                 const void *pos, void *d2, int b, int C, int p, int M,
                                 int ksub, long long n_codes, int vec8, void *stream) {
  if (b <= 0 || C <= 0) return 0;
  if (M < 1 || ksub < 1 || p < 1 || n_codes < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  Params a{};
  a.lut = (const float *)lut;
  a.codes = (const uint8_t *)codes;
  a.seg = (const int32_t *)seg;
  a.pos = (const int32_t *)pos;
  a.d2 = (float *)d2;
  a.n_rows = (int)std::min<long long>(n_codes, INT_MAX);
  a.C = C, a.p = p, a.M = M, a.ksub = ksub;
  // cells a block holds: as many as kStageBytes takes, at least one while a
  // cell fits in shared memory at all (beside the kernel's 128 static
  // bytes), at most p
  const long long cell_bytes = 4LL * M * ksub;
  const long long cap = std::max<long long>(1, kStageBytes / cell_bytes);
  a.cap = cell_bytes > adc::kMaxSmem - 1024 ? 0 : (int)std::min<long long>(cap, p);
  a.codes16 = (((uintptr_t)codes) & 15) == 0;
  // 16-byte seg / pos / d2 rows: C % 4 == 0 and seg, pos aligned (d2 is the
  // wrapper's own allocation)
  const bool vec = (C & 3) == 0 && (((uintptr_t)seg | (uintptr_t)pos | (uintptr_t)d2) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool v8 = vec8 && M == 8;
  if (vec) return v8 ? launch<true, 8>(a, b, s) : launch<true, 0>(a, b, s);
  return v8 ? launch<false, 8>(a, b, s) : launch<false, 0>(a, b, s);
}
