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
// gives `rows` (the sorted destination rows, int32 or int64 as idx is) and
// `perm` (int64: where each came from in grads). Equal rows then sit
// together, in n order: one segment per distinct row.
//
// Every add is rounded once (__fadd_rn, no contraction) and each column of
// a segment is added in n order: the JAX reference's sequential order, so
// the result equals the plain version and `.at[idx].add` bitwise. Each
// touched (row, column) is written by exactly one thread: no atomics, and
// two runs agree bitwise. Rows no index names are never read or written. A
// row outside [0, V) is dropped, as XLA's scatter drops an out-of-range
// index. Offsets are 64-bit.
//
// Bound on an H100 SXM (3.35 TB/s): the bytes, a few microseconds at the
// Word2Vec shapes (N = 8192, D = 128: 4.3 MB of gradients). What costs time
// is the longest segment: its adds depend on one another, so a segment of m
// positions is m dependent float adds on whoever walks it. The first design
// (scatter_add_v1.cu) gave each segment one warp, which waited on memory
// every 16 positions: about 91 ns a position, 87 us for the head word's 866.
// This design splits that time two ways.
//
// Work by (segment, column slice). One launch, two roles:
// - Long segments (at least kLong positions). Every long segment holds a
//   multiple of kLong, so the first blocks of the grid are one per (chunk
//   point c*kLong, column slice of kCols columns). A block finds the
//   segment through its chunk point (one round of loads back and forward,
//   then, past 2048 positions, 128-way rounds of search for the end, while
//   the first stages' perm values load), owns it only if its point is the
//   segment's first, and walks its slice. Column c's sum is its own chain,
//   so cutting D into slices changes no rounding: at D = 128 the head
//   word's 866 adds run as 8 chains of 16 columns on 8 SMs.
// - In a long-segment block three warps copy the slice's gradient rows (in
//   perm order) into a ring of kRing stages of kStage rows in shared memory
//   with cp.async, 16 bytes a copy (4 bytes when D % 4 != 0 or the rows
//   are not 16-byte aligned), kAhead stages ahead of the adds; the perm
//   values of a stage arrive kAhead stages before its rows. In the fourth
//   warp one thread per column walks the ring in n order, 16 shared-memory
//   reads issued before their adds. The chain then costs its
//   dependent adds and shared-memory reads already issued, not a round trip
//   to memory every 16 positions.
// - Short segments (fewer than kLong positions): one warp each, as in the
//   first design. The warp at a segment's first position adds its rows
//   with 8 gradient rows in flight per lane, lanes across D (float4 a lane
//   where D % 4 == 0 and the rows are 16-byte aligned). One round of loads
//   tells a warp whether its position starts a short segment and brings the
//   rows and perm of its first 32 positions, so a segment of one costs two
//   round trips to memory: that round, then its table and gradient rows.
// The wrapper sends no work list: both roles find their segments in the
// sorted rows, so nothing is synchronised with the host.
//
// The constants come from tools/kernel_variants.py on an H100 SXM (700 W),
// at a Zipf draw of N = 8192 over 9991 rows (the Word2Vec corpus path) and
// at N = 81,920 (CBOW's bags): the short role's waves of warps held the
// first shape, so the registers are capped for five blocks an SM (8 rows in
// flight a lane, not 16) and segments from 32 positions on go to the long
// role; stages of 128 rows halve the barriers a long chain waits at.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 5;  // blocks an SM: caps the registers at 102
constexpr int kWarps = kThreads / 32;
constexpr int kLong = 32;   // a segment this long or longer goes to the long role
constexpr int kCols = 16;   // columns in one slice of a long segment
constexpr int kStage = 128;  // positions per ring stage
constexpr int kAhead = 3;    // stages in flight while one is walked
constexpr int kRing = kAhead + 1;
constexpr int kPermRing = 2 * kRing;  // perm stages run kAhead further ahead
constexpr int kSub = 8;     // gradient rows in flight per lane (short role)
constexpr int kFwd = kThreads - kLong - 1;  // forward probes in the first round
constexpr int kNear = 32;   // ... of which the first kNear are the next positions
constexpr unsigned kAll = 0xffffffffu;

template <typename TR>
struct Args {
  float *table;
  const TR *rows;
  const long long *perm;
  const float *grads;
  long long n;
  long long long_items;  // chunk points * slices
  int V, D, slices;
  unsigned long_blocks;  // the first blocks of the grid take the long role
};

__device__ __forceinline__ uint32_t smem_addr(const void *p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void *dst, const void *src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async8(void *dst, const void *src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void *dst, const void *src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// ------------------------------------------------------------ short role
// One warp walks the segment of row r that starts at sorted position j. T is
// float4 (kVec) or float; width = D / (elements per T). in0 and p0: whether
// position j + lane is in the segment, and its perm. Every lane takes part
// in the shuffles; only lanes with a column (c < width) load, add and store.
template <typename T, typename TR>
__device__ __forceinline__ void walk(T *__restrict__ trow, const T *__restrict__ g,
                                     const TR *__restrict__ rows,
                                     const long long *__restrict__ perm, long long j,
                                     long long n, TR r, int width, int lane, bool in0,
                                     long long p0) {
  for (int c0 = 0; c0 < width; c0 += 32) {
    const int c = c0 + lane;
    const bool col = c < width;
    T acc{};
    if (col) acc = trow[c];
    // 32 positions at a time, one a lane: rows are sorted, so the lanes
    // still in the segment are a prefix and the ballot counts them
    long long k = j;
    bool in = in0;
    long long p = p0;
    for (;;) {
      const int cnt = __popc(__ballot_sync(kAll, in));
      const bool more = cnt == 32;
      const long long kn = k + 32 + lane;
      const bool in_next = more && kn < n && rows[kn] == r;
      const long long p_next = more && kn < n ? perm[kn] : 0;
      for (int u0 = 0; u0 < cnt; u0 += kSub) {
        T v[kSub];
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
          const long long src = __shfl_sync(kAll, p, u0 + u);
          if (col && u0 + u < cnt) v[u] = __ldg(g + src * width + c);
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

template <typename TR, bool kVec>
__device__ __forceinline__ void short_role(const Args<TR> &a, long long block, long long blocks) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = blocks * kWarps;
  for (long long j = block * kWarps + (threadIdx.x >> 5); j < a.n; j += nwarps) {
    // one round of loads: rows and perm of positions j .. j+31, the row
    // before j and the row kLong-1 after it
    const long long k = j + lane;
    const TR rk = k < a.n ? a.rows[k] : TR(0);
    const long long pk = k < a.n ? a.perm[k] : 0;
    const TR before = j > 0 ? a.rows[j - 1] : TR(0);
    const TR last = j + kLong - 1 < a.n ? a.rows[j + kLong - 1] : TR(0);
    const TR r = __shfl_sync(kAll, rk, 0);
    if (j > 0 && before == r) continue;                   // not a segment's start
    if (r < 0 || r >= a.V) continue;                      // out of range: dropped
    if (j + kLong - 1 < a.n && last == r) continue;       // long: the long role's
    const bool in = k < a.n && rk == r;
    if constexpr (kVec) {
      const int w = a.D >> 2;
      walk<float4, TR>(reinterpret_cast<float4 *>(a.table) + (long long)r * w,
                       reinterpret_cast<const float4 *>(a.grads), a.rows, a.perm, j, a.n, r,
                       w, lane, in, pk);
    } else {
      walk<float, TR>(a.table + (long long)r * a.D, a.grads, a.rows, a.perm, j, a.n, r, a.D,
                      lane, in, pk);
    }
  }
}

// ------------------------------------------------------------- long role
// Forward probe u (1 <= u <= kFwd) of the first round reads position
// j0 + fwd_off(u): every one up to kNear past j0, then every kNear-th, to
// kNear * (kFwd - kNear + 1) = 2048 past j0.
__device__ __forceinline__ long long fwd_off(int u) {
  return u <= kNear ? u : (long long)kNear * (u - kNear + 1);
}

template <typename TR, bool kVec>
__device__ __forceinline__ void long_role(const Args<TR> &a) {
  __shared__ __align__(16) float ring[kRing][kStage][kCols];
  __shared__ long long pring[kPermRing][kStage];
  const int tid = threadIdx.x;
  const int lt = tid - 32;  // loader index: warps 1.. copy, warp 0 adds
  for (long long w = blockIdx.x; w < a.long_items; w += a.long_blocks) {
    const long long j0 = (w / a.slices) * kLong;  // the chunk point
    const int col0 = (int)(w % a.slices) * kCols;
    const TR r = a.rows[j0];
    // one round: positions j0 - t (t <= kLong) and j0 + fwd_off(u).
    // Equal rows are contiguous, so each count is a run from j0.
    bool back = false, fwd = false;
    if (tid <= kLong) {
      back = j0 - tid >= 0 && a.rows[j0 - tid] == r;
    } else {
      const long long p = j0 + fwd_off(tid - kLong);
      fwd = p < a.n && a.rows[p] == r;
    }
    const int nb = __syncthreads_count(back);
    const int nf = __syncthreads_count(fwd);
    // j0 - kLong in the segment: an earlier chunk point owns it
    if (nb > kLong || r < 0 || r >= a.V) continue;
    const long long s = j0 - nb + 1;
    // the end e lies in (lo, hi]: rows[lo] == r, hi == n or rows[hi] != r
    long long lo = j0 + fwd_off(nf);
    long long hi = nf < kFwd ? min(a.n, j0 + fwd_off(nf + 1)) : a.n;
    if (hi - s < kLong) continue;  // short: a warp of the short role walks it
    const long long *const pbase = a.perm + s;
    // the perm of the first kAhead stages, asked for before the end is
    // known (hi - s bounds the segment)
    for (int g = 0; g < kAhead; ++g)
      for (int k = lt; k >= 0 && k < kStage && (long long)g * kStage + k < hi - s;
           k += kThreads - 32)
        cp_async8(&pring[g][k], pbase + (long long)g * kStage + k);
    cp_commit();
    while (hi - lo > 1) {  // kThreads points a round
      const long long step = (hi - lo + kThreads - 1) / kThreads;
      const long long p = lo + (long long)(tid + 1) * step;
      const int cnt = __syncthreads_count(p < hi && a.rows[p] == r);
      lo += cnt * step;
      hi = min(hi, lo + step);
    }
    const long long m = hi - s;
    cp_wait<0>();  // the perm landed (or, for a short segment, is done with)
    __syncthreads();
    if (m < kLong) continue;

    const int width = min(kCols, a.D - col0);
    const int stages = (int)((m + kStage - 1) / kStage);
    const float *const gbase = a.grads + col0;
    auto rows_in = [&](int g) { return (int)min((long long)kStage, m - (long long)g * kStage); };
    auto issue_perm = [&](int g) {
      if (g >= stages) return;
      for (int k = lt; k >= 0 && k < rows_in(g); k += kThreads - 32)
        cp_async8(&pring[g % kPermRing][k], pbase + (long long)g * kStage + k);
    };
    auto issue_rows = [&](int g) {
      if (g >= stages || lt < 0) return;
      const int cnt = rows_in(g);
      float(*buf)[kCols] = ring[g % kRing];
      const long long *pp = pring[g % kPermRing];
      if constexpr (kVec) {
        for (int i = lt; i < cnt * (kCols / 4); i += kThreads - 32) {
          const int row = i / (kCols / 4), c = (i % (kCols / 4)) * 4;
          if (c < width) cp_async16(&buf[row][c], gbase + pp[row] * a.D + c);
        }
      } else {
        for (int i = lt; i < cnt * kCols; i += kThreads - 32) {
          const int row = i / kCols, c = i % kCols;
          if (c < width) cp_async4(&buf[row][c], gbase + pp[row] * a.D + c);
        }
      }
    };

    float *const cell = a.table + (long long)r * a.D + col0 + tid;
    float acc = 0.f;
    if (tid < width) acc = *cell;
    // group g (g < kAhead) = stage g's rows + stage g+kAhead's perm
    for (int g = 0; g < kAhead; ++g) {
      issue_perm(g + kAhead);
      issue_rows(g);
      cp_commit();
    }
    for (int i = 0; i < stages; ++i) {
      cp_wait<kAhead - 1>();  // group i: stage i's rows, stage i+kAhead's perm
      __syncthreads();        // ... from every thread; stage i-1's slot is walked
      issue_perm(i + 2 * kAhead);
      issue_rows(i + kAhead);
      cp_commit();
      if (tid < width) {
        const float(*buf)[kCols] = ring[i % kRing];
        const int cnt = rows_in(i);
        if (cnt == kStage) {
#pragma unroll
          for (int k0 = 0; k0 < kStage; k0 += 16) {
            float v[16];  // 16 reads issued before their adds
#pragma unroll
            for (int k = 0; k < 16; ++k) v[k] = buf[k0 + k][tid];
#pragma unroll
            for (int k = 0; k < 16; ++k) acc = __fadd_rn(acc, v[k]);
          }
        } else {
          for (int k = 0; k < cnt; ++k) acc = __fadd_rn(acc, buf[k][tid]);
        }
      }
    }
    cp_wait<0>();
    if (tid < width) *cell = acc;
    __syncthreads();  // the ring is free for the block's next item
  }
}

template <typename TR, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks) scatter_add_kernel(const Args<TR> a) {
  if (blockIdx.x < a.long_blocks)
    long_role<TR, kVec>(a);
  else
    short_role<TR, kVec>(a, blockIdx.x - a.long_blocks, gridDim.x - a.long_blocks);
}

template <typename TR>
int run(float *table, const void *rows, const void *perm, const float *grads, long long n, int V,
        int D, int vec, cudaStream_t s) {
  Args<TR> a;
  a.table = table;
  a.rows = (const TR *)rows;
  a.perm = (const long long *)perm;
  a.grads = grads;
  a.n = n;
  a.V = V;
  a.D = D;
  a.slices = (D + kCols - 1) / kCols;
  a.long_items = (n + kLong - 1) / kLong * a.slices;
  const long long cap = 1LL << 20;  // blocks of either role stride beyond
  a.long_blocks = (unsigned)(a.long_items < cap ? a.long_items : cap);
  long long shorts = (n + kWarps - 1) / kWarps;
  if (shorts > cap) shorts = cap;
  const dim3 grid((unsigned)(a.long_blocks + shorts)), block(kThreads);
  if (vec)
    scatter_add_kernel<TR, true><<<grid, block, 0, s>>>(a);
  else
    scatter_add_kernel<TR, false><<<grid, block, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// rows: the stably sorted indices, int32 (rows_64 == 0) or int64; perm:
// int64, their positions in grads. vec: the wrapper found D % 4 == 0 and
// table and grads 16-byte aligned. Returns a cudaError_t (0: launched).
extern "C" int scatter_add_launch(void *table, const void *rows, int rows_64, const void *perm,
                                  const void *grads, long long n, int V, int D, int vec,
                                  void *stream) {
  if (n <= 0 || V <= 0 || D <= 0) return 0;
  float *t = (float *)table;
  const float *g = (const float *)grads;
  cudaStream_t s = (cudaStream_t)stream;
  if (rows_64) return run<long long>(t, rows, perm, g, n, V, D, vec, s);
  return run<int>(t, rows, perm, g, n, V, D, vec, s);
}
