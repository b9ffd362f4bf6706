// scatter_add: the ordered embedding-table update.
//
//   table[idx[n], :] += grads[n, :]   for n = 0, 1, ..., N-1, in that order
//
// table float32 (V, D), grads float32 (N, D), both row-major and contiguous;
// updated in place. Replaces the TPU kernel
// deeplearning4j_tpu/nlp/pallas_scatter.py::scatter_add_pallas, which holds
// the whole table in a VMEM scratch and applies the rows one after another
// along an "arbitrary" grid. On Hopper blocks run in parallel and in no
// order, so the order is made by the wrapper instead: a stable sort of idx
// gives `rows` (the sorted destination rows) and `perm` (where each came
// from in grads), both int32. Equal rows then sit together, in n order.
//
// Design (simple and right first):
// - One warp per sorted position j. A warp whose position does not start a
//   segment (rows[j] == rows[j-1]) has nothing to do. The warp that starts
//   one loads the table row once, adds grads[perm[k]] for k along the
//   segment in order with __fadd_rn (one rounding per add, no contraction),
//   and stores the row once. That is the JAX reference's sequential order,
//   so the result equals the plain version and `.at[idx].add` bitwise.
// - Each touched row is written by exactly one warp: no atomics, and two
//   runs agree bitwise. Rows no index names are never read or written.
// - Lanes run across D: 16 bytes a lane (float4) where D % 4 == 0 and the
//   rows are 16-byte aligned (kVec), one float a lane otherwise.
// - The walk takes the segment 32 positions at a time: each lane loads one
//   position's row and perm (coalesced), a ballot counts those still in the
//   segment, and shuffles hand each perm to every lane. The loads of kSub
//   gradient rows are issued before their adds, so 16 are in flight per
//   lane while the adds stay in order, and the next 32 positions' indices
//   load meanwhile.
// - A row outside [0, V) is dropped, as XLA's scatter drops an
//   out-of-range index; callers pass none.
// - Offsets are 64-bit: V*D or N*D may pass 2^31.
//
// Bound on an H100 SXM (3.35 TB/s): the bytes. Each gradient row is read
// once (N*D*4), the sorted rows and perm once (N*4*2), and each of the U
// distinct rows read and written once (2*U*D*4). At N = 8192, D = 128 that
// is about 4.3 MB + 8 MB max: a few microseconds, so launch overhead and the
// wrapper's sort dominate. A hot row is one warp's serial chain: a row that
// takes m of the N gradients costs m dependent adds on one warp, ~m/16 round
// trips to memory. Under a Zipf law the most frequent word takes ~10% of a
// batch.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr int kSub = 16;   // gradient rows in flight per lane
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// One warp walks the segment of row r that starts at sorted position j. T is
// float4 (kVec) or float; width = D / (elements per T). Every lane takes part
// in the shuffles; only lanes with a column (c < width) load, add and store.
template <typename T>
__device__ __forceinline__ void walk(T *__restrict__ trow, const T *__restrict__ g,
                                     const int *__restrict__ rows,
                                     const int *__restrict__ perm, long long j,
                                     long long n, int r, int width, int lane) {
  for (int c0 = 0; c0 < width; c0 += 32) {
    const int c = c0 + lane;
    const bool col = c < width;
    T acc{};
    if (col) acc = trow[c];
    // 32 positions at a time, one a lane: rows are sorted, so the lanes
    // still in the segment are a prefix and the ballot counts them
    long long k = j;
    bool in = k + lane < n && rows[k + lane] == r;
    int p = k + lane < n ? perm[k + lane] : 0;
    for (;;) {
      const int cnt = __popc(__ballot_sync(kAll, in));
      const bool more = cnt == 32;
      // the next 32 positions' indices load while this group's rows do
      const long long kn = k + 32 + lane;
      const bool in_next = more && kn < n && rows[kn] == r;
      const int p_next = more && kn < n ? perm[kn] : 0;
      for (int u0 = 0; u0 < cnt; u0 += kSub) {
        T v[kSub];
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
          const int src = __shfl_sync(kAll, p, u0 + u);
          if (col && u0 + u < cnt) v[u] = __ldg(g + (long long)src * width + c);
        }
#pragma unroll
        for (int u = 0; u < kSub; ++u)
          if (col && u0 + u < cnt) acc = add(acc, v[u]);
      }
      if (!more) break;
      k += 32;
      in = in_next;
      p = p_next;
    }
    if (col) trow[c] = acc;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
scatter_add_kernel(float *__restrict__ table, const int *__restrict__ rows,
                   const int *__restrict__ perm, const float *__restrict__ grads,
                   long long n, int V, int D) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long j = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); j < n;
       j += nwarps) {
    const int r = rows[j];
    if (j > 0 && rows[j - 1] == r) continue;  // not the start of a segment
    if (r < 0 || r >= V) continue;            // out of range: dropped
    if constexpr (kVec) {
      const int w = D >> 2;
      walk<float4>(reinterpret_cast<float4 *>(table) + (long long)r * w,
                   reinterpret_cast<const float4 *>(grads), rows, perm, j, n, r, w, lane);
    } else {
      walk<float>(table + (long long)r * D, grads, rows, perm, j, n, r, D, lane);
    }
  }
}

}  // namespace

// vec: the wrapper found D % 4 == 0 and table and grads 16-byte aligned.
extern "C" int scatter_add_launch(void *table, const void *rows, const void *perm,
                                  const void *grads, long long n, int V, int D, int vec,
                                  void *stream) {
  if (n <= 0 || V <= 0 || D <= 0) return 0;
  long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // the warps stride beyond
  const dim3 grid((unsigned)blocks), block(kWarps * 32);
  cudaStream_t s = (cudaStream_t)stream;
  float *t = (float *)table;
  const int *r = (const int *)rows, *p = (const int *)perm;
  const float *g = (const float *)grads;
  if (vec)
    scatter_add_kernel<true><<<grid, block, 0, s>>>(t, r, p, g, n, V, D);
  else
    scatter_add_kernel<false><<<grid, block, 0, s>>>(t, r, p, g, n, V, D);
  return (int)cudaGetLastError();
}
