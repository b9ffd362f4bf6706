// int4_dot: int8 queries (b, d) x packed int4 rows (n, ceil(d/2)) -> int32 (b, n).
//
// Replaces the TPU kernel deeplearning4j_tpu/perf/pallas/adc.py::_int4_dot_kernel
// (wrapper int4_matmul). Byte t of a packed row holds code 2t in its low
// nibble and code 2t+1 in its high nibble, each a sign-extended 4-bit value.
// Only k < d counts: for odd d the last high nibble is padding.
//
// Bound on an H100 SXM (3.35 TB/s, 1,979 TOP/s int8), bytes at every path
// shape:
// - retrieval, (b, 1M, 64): the 32 MB table plus the 4*b*n int32 output; at
//   b = 256 the 1.02 GB output alone is 305 us of the 315 us bound, at
//   b = 1 the table is most of 10.7 us;
// - VGG16 fc1 at serving batches (b <= 16): the 51.4 MB of packed weights,
//   15.4 us, against 1.7 us of int8 arithmetic at b = 16.
//
// Design: int8 tensor-core tiles (mma.sync m16n8k32 s8 x s8 -> s32).
// - A block owns an output tile of BM queries x BN table rows and walks k in
//   chunks of BK codes. Each chunk's query rows (int8) and packed table rows
//   are copied into shared memory with 16-byte cp.async (zero-filled past b,
//   past d and past the packed width), STAGES - 1 chunks in flight ahead of
//   the one in use.
// - Each warp owns BN / warps table rows of the tile, so each packed byte
//   is unpacked once per block, in registers, straight into the mma's B
//   operand: the low nibbles of a 4-byte word are one register, the high
//   nibbles the other (masks and a multiply sign-extend four at a time). The
//   sum runs over k, so the same permutation of k in both operands leaves it
//   exact: the query bytes are taken in the matching order (even bytes, then
//   odd, by __byte_perm) and no nibble interleave is needed. Zero queries
//   past d make the padding nibble of odd d count nothing.
// - Tiles chosen by b and d (BM x BN x BK, warps; timed on an H100 against
//   the alternatives of half and double the width):
//   - b <= 16, one 16-row query fragment, so every weight byte is read from
//     device memory once for all queries: d >= 256 (the fc layers)
//     16 x 128 x 256, 4 warps, so each chunk reads 128 contiguous bytes of a
//     row; smaller d (retrieval) 16 x 512 x 64, 8 warps, whole rows;
//   - b > 16: 64 x 256 x 64, 8 warps of 64 x 32.
// - Blocks are persistent: as many as fit on the card at once, each walking
//   its tiles (queries fastest, so the blocks that share a table tile run
//   together and find it in L2) and prefetching the next tile's chunk while
//   it finishes the current one.
// - Epilogue: the block's int32 tile goes through shared memory and leaves
//   as whole 16-byte rows, coalesced, with streaming stores (__stcs), so the
//   output does not push the table out of L2.
// - Too few tiles to fill the card (VGG16's fc layers: 32 tiles of fc1) split
//   k across blocks instead: the output is zeroed and each block adds its
//   partial tile with int32 atomicAdd. Integer addition is exact and
//   order-independent, so the split sum is bitwise the same in every run.
// - Operands whose base addresses or row strides are not 16-byte aligned are
//   staged byte by byte instead of by cp.async; strides are 64-bit.
// All arithmetic is int32 and exact (|sum| <= d * 127 * 8), so the result
// equals the plain version bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void *p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void *dst, const void *src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four nibbles, one in the low half of each byte, sign-extended to int8.
__device__ __forceinline__ uint32_t sext4(uint32_t x) {
  return x | ((x & 0x08080808u) * 0x1Eu);  // 0x08 * 0x1E = 0xF0, no carries
}

struct Args {
  const int8_t *qq;
  long long sq;
  const int8_t *packed;
  long long sp;
  int32_t *out;
  long long so;
  int b, n, d, pw;  // pw: packed row width, ceil(d/2)
  int m_tiles, kc, split, units;  // units = tiles * split
  int vec_in, vec_out;
};

template <int BM, int BN, int BK, int WN, int STAGES>
struct Tile {
  static constexpr int kThreads = 32 * WN;
  static constexpr int kApitch = BK + 16;      // int8 query rows
  static constexpr int kPpitch = BK / 2 + 16;  // packed rows
  static constexpr int kCpitch = BN + 8;       // int32 output rows
  static constexpr int kAbytes = BM * kApitch;
  static constexpr int kPbytes = BN * kPpitch;
  static constexpr int kSmem = STAGES * (kAbytes + kPbytes) + BM * kCpitch * 4;
  static constexpr int kMI = BM / 16;      // m16 fragments per warp
  static constexpr int kNJ = BN / WN / 8;  // n8 fragments per warp
};

// One unit of work, (tile, split): its tile's origin and its k chunks.
struct Cursor {
  int u, c, cend, m0, n0;
};

template <int BM, int BN>
__device__ __forceinline__ void unit_begin(const Args &a, Cursor &cur) {
  const int tile = a.split == 1 ? cur.u : cur.u / a.split;
  const int s = cur.u - tile * a.split;
  cur.c = (int)((long long)s * a.kc / a.split);
  cur.cend = (int)((long long)(s + 1) * a.kc / a.split);
  cur.m0 = (tile % a.m_tiles) * BM;
  cur.n0 = (tile / a.m_tiles) * BN;
}

template <int BM, int BN>
__device__ __forceinline__ void advance(const Args &a, Cursor &cur) {
  if (++cur.c == cur.cend) {
    cur.u += gridDim.x;
    if (cur.u < a.units) unit_begin<BM, BN>(a, cur);
  }
}

// Copy chunk c of a unit's query rows and packed rows into one stage: the
// k32 steps that hold a code < d, zero-filled past b, n, d and the packed
// width.
template <typename T, int BM, int BN, int BK>
__device__ __forceinline__ void stage(const Args &a, const Cursor &cur, int8_t *As,
                                      int8_t *Ps) {
  constexpr int kAp = BK / 16, kPp = BK / 32;  // 16-byte pieces per row
  const int k0 = cur.c * BK;
  const int steps = min(BK, a.d - k0 + 31) / 32;
  for (int i = threadIdx.x; i < BM * kAp; i += T::kThreads) {
    const int r = i / kAp, p = i % kAp;
    if (p >= 2 * steps) continue;
    const int k = k0 + 16 * p;
    const bool row_ok = cur.m0 + r < a.b;
    const int8_t *src = a.qq + (long long)(row_ok ? cur.m0 + r : 0) * a.sq + k;
    int8_t *dst = As + r * T::kApitch + 16 * p;
    const int bytes = row_ok ? max(0, min(16, a.d - k)) : 0;
    if (a.vec_in) {
      cp_async16(dst, bytes ? src : a.qq, bytes);
    } else {
      for (int e = 0; e < 16; ++e) dst[e] = e < bytes ? src[e] : 0;
    }
  }
  for (int i = threadIdx.x; i < BN * kPp; i += T::kThreads) {
    const int r = i / kPp, p = i % kPp;
    if (p >= steps) continue;
    const int kb = k0 / 2 + 16 * p;  // packed byte
    const bool row_ok = cur.n0 + r < a.n;
    const int8_t *src = a.packed + (long long)(row_ok ? cur.n0 + r : 0) * a.sp + kb;
    int8_t *dst = Ps + r * T::kPpitch + 16 * p;
    const int bytes = row_ok ? max(0, min(16, a.pw - kb)) : 0;
    if (a.vec_in) {
      cp_async16(dst, bytes ? src : a.packed, bytes);
    } else {
      for (int e = 0; e < 16; ++e) dst[e] = e < bytes ? src[e] : 0;
    }
  }
}

// The mma's k order within a k32 step: lane (g, tq) takes packed word tq of
// the step's 16 packed bytes, codes 8tq .. 8tq+7; their low nibbles (codes
// 8tq + 0, 2, 4, 6) are its first B register and the high nibbles (8tq + 1,
// 3, 5, 7) its second. The A registers take the same codes of the query
// rows: bytes 8tq .. 8tq+7, even bytes first. The same permutation of k on
// both sides leaves the sum exact.
template <int BM, int BN, int BK, int WN, int STAGES>
__global__ void __launch_bounds__(32 * WN)
int4_dot_kernel(const Args a) {
  using T = Tile<BM, BN, BK, WN, STAGES>;
  constexpr int MI = T::kMI, NJ = T::kNJ;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t *const As0 = reinterpret_cast<int8_t *>(smem);
  int8_t *const Ps0 = As0 + STAGES * T::kAbytes;
  int32_t *const Cs = reinterpret_cast<int32_t *>(Ps0 + STAGES * T::kPbytes);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;

  Cursor fetch{(int)blockIdx.x, 0, 0, 0, 0};
  if (fetch.u >= a.units) return;
  unit_begin<BM, BN>(a, fetch);
  Cursor cur = fetch;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (fetch.u < a.units) {
      stage<T, BM, BN, BK>(a, fetch, As0 + s * T::kAbytes, Ps0 + s * T::kPbytes);
      advance<BM, BN>(a, fetch);
    }
    cp_commit();
  }

  int acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int it = 0; cur.u < a.units; ++it) {
    const int buf = it % STAGES, fbuf = (it + STAGES - 1) % STAGES;
    __syncthreads();  // stage fbuf and Cs are no longer read
    if (fetch.u < a.units) {
      stage<T, BM, BN, BK>(a, fetch, As0 + fbuf * T::kAbytes, Ps0 + fbuf * T::kPbytes);
      advance<BM, BN>(a, fetch);
    }
    cp_commit();
    cp_wait<STAGES - 1>();
    __syncthreads();

    const int steps = min(BK, a.d - cur.c * BK + 31) / 32;
    const int8_t *const As = As0 + buf * T::kAbytes + g * T::kApitch + 8 * tq;
    const int8_t *const Ps = Ps0 + buf * T::kPbytes + (warp * NJ * 8 + g) * T::kPpitch + 4 * tq;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      if (ks < steps) {
        uint32_t af[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const uint2 x = *reinterpret_cast<const uint2 *>(As + i * 16 * T::kApitch + 32 * ks);
          const uint2 y =
              *reinterpret_cast<const uint2 *>(As + (i * 16 + 8) * T::kApitch + 32 * ks);
          af[i][0] = __byte_perm(x.x, x.y, 0x6420);
          af[i][1] = __byte_perm(y.x, y.y, 0x6420);
          af[i][2] = __byte_perm(x.x, x.y, 0x7531);
          af[i][3] = __byte_perm(y.x, y.y, 0x7531);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const uint32_t w = *reinterpret_cast<const uint32_t *>(Ps + j * 8 * T::kPpitch + 16 * ks);
          const uint32_t lo = sext4(w & 0x0F0F0F0Fu), hi = sext4((w >> 4) & 0x0F0F0F0Fu);
#pragma unroll
          for (int i = 0; i < MI; ++i) mma_s8(acc[i][j], af[i], lo, hi);
        }
      }
    }

    if (cur.c + 1 == cur.cend) {  // the unit's last chunk: write its tile
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int r = i * 16 + g, c = warp * NJ * 8 + j * 8 + 2 * tq;
          *reinterpret_cast<int2 *>(Cs + r * T::kCpitch + c) =
              make_int2(acc[i][j][0], acc[i][j][1]);
          *reinterpret_cast<int2 *>(Cs + (r + 8) * T::kCpitch + c) =
              make_int2(acc[i][j][2], acc[i][j][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
        }
      __syncthreads();
      const int rows = min(BM, a.b - cur.m0);
      for (int i = threadIdx.x; i < rows * (BN / 4); i += T::kThreads) {
        const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
        const int col = cur.n0 + c;
        if (col >= a.n) continue;
        const int32_t *src = Cs + r * T::kCpitch + c;
        int32_t *dst = a.out + (long long)(cur.m0 + r) * a.so + col;
        if (a.split > 1) {
          for (int e = 0; e < 4 && col + e < a.n; ++e) atomicAdd(dst + e, src[e]);
        } else if (a.vec_out && col + 3 < a.n) {
          __stcs(reinterpret_cast<int4 *>(dst), *reinterpret_cast<const int4 *>(src));
        } else {
          for (int e = 0; e < 4 && col + e < a.n; ++e) __stcs(dst + e, src[e]);
        }
      }
    }
    advance<BM, BN>(a, cur);
  }
}

template <int BM, int BN, int BK, int WN, int STAGES>
int run(Args a, cudaStream_t stream) {
  using T = Tile<BM, BN, BK, WN, STAGES>;
  auto kernel = int4_dot_kernel<BM, BN, BK, WN, STAGES>;
  static int occupancy = 0, sms = 0;  // per process: one kind of card
  if (occupancy == 0) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return (int)err;
    int occ = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, T::kThreads,
                                                             T::kSmem)) != cudaSuccess)
      return (int)err;
    occupancy = occ > 0 ? occ : 1;
  }
  const long long cap = (long long)sms * occupancy;
  a.m_tiles = (a.b + BM - 1) / BM;
  a.kc = (a.d + BK - 1) / BK;
  const long long tiles = (long long)a.m_tiles * ((a.n + BN - 1) / BN);
  a.split = tiles >= cap ? 1 : (int)(cap / tiles < a.kc ? cap / tiles : a.kc);
  if (tiles * a.split > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  a.units = (int)(tiles * a.split);
  if (a.split > 1) {
    cudaError_t err = cudaMemset2DAsync(a.out, (size_t)a.so * 4, 0, (size_t)a.n * 4,
                                        (size_t)a.b, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const long long grid = a.units < cap ? a.units : cap;
  kernel<<<(unsigned)grid, T::kThreads, T::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int int4_dot_launch(const void *qq, long long sq, const void *packed,
                               long long sp, void *out, long long so, int b, int n,
                               int d, void *stream) {
  if (b <= 0 || n <= 0) return 0;
  Args a{};
  a.qq = (const int8_t *)qq;
  a.sq = sq;
  a.packed = (const int8_t *)packed;
  a.sp = sp;
  a.out = (int32_t *)out;
  a.so = so;
  a.b = b;
  a.n = n;
  a.d = d;
  a.pw = (d + 1) / 2;
  a.vec_in = ((uintptr_t)qq % 16 == 0) && ((uintptr_t)packed % 16 == 0) && (sq % 16 == 0) &&
             (sp % 16 == 0);
  a.vec_out = ((uintptr_t)out % 16 == 0) && (so % 4 == 0);
  if (d <= 0) {  // an empty sum: zeros
    cudaError_t err = cudaMemset2DAsync(out, (size_t)so * 4, 0, (size_t)n * 4, (size_t)b,
                                        (cudaStream_t)stream);
    return (int)err;
  }
  if (b <= 16 && d >= 256) return run<16, 128, 256, 4, 3>(a, (cudaStream_t)stream);
  if (b <= 16) return run<16, 512, 64, 8, 2>(a, (cudaStream_t)stream);
  return run<64, 256, 64, 8, 2>(a, (cudaStream_t)stream);
}
