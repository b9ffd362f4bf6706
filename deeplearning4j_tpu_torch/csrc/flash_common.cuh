// What the flash attention kernels (flash_attn_fwd.cu, flash_attn_bwd_dkv.cu,
// flash_attn_bwd_dq.cu) share: operand strides, cp.async staging of (t, d)
// tiles into shared memory, and the bf16 tensor-core pieces (ldmatrix,
// mma.sync m16n8k16 with float32 sums, and the hi/lo split of a float32
// fragment into two bf16 A operands).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// Element strides of the b, h and t axes of one operand (d's is 1).
struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ uint32_t smem_addr(const void *p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void *dst, const void *src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void *dst, const void *src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_wait0() { asm volatile("cp.async.wait_group 0;\n" ::); }

template <typename E>
__device__ __forceinline__ E zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

// Rows row0 .. row0+R-1 of a (t, d) matrix with row stride src_t into
// dst[r * PITCH + c], c < DP; zero past t and past d. With vec, by 16-byte
// cp.async (src and src_t 16-byte aligned); else element by element.
template <typename E, int R, int DP, int PITCH, int NT>
__device__ __forceinline__ void load_tile(E *dst, const E *src, long long src_t, int row0,
                                          int t, int d, int vec) {
  constexpr int kPer = 16 / (int)sizeof(E);
  constexpr int kPieces = DP / kPer;
  for (int i = threadIdx.x; i < R * kPieces; i += NT) {
    const int r = i / kPieces, c = (i % kPieces) * kPer;
    const bool ok = row0 + r < t;
    const E *s = src + (long long)(ok ? row0 + r : 0) * src_t + c;
    E *dd = dst + r * PITCH + c;
    const int n = ok ? max(0, min(kPer, d - c)) : 0;
    if (vec) {
      cp_async16(dd, n ? s : src, n * (int)sizeof(E));
    } else {
      for (int e = 0; e < kPer; ++e) dd[e] = e < n ? s[e] : zero<E>();
    }
  }
}

// Entries row0 .. row0+R-1 of one (b, h) row of a float32 (b, h, t) vector;
// zero past t.
template <int R, int NT>
__device__ __forceinline__ void load_rows(float *dst, const float *src, int row0, int t) {
  for (int i = threadIdx.x; i < R; i += NT) {
    const bool ok = row0 + i < t;
    cp_async4(dst + i, ok ? src + row0 + i : src, ok ? 4 : 0);
  }
}

// --------------------------------------------------------------- bfloat16
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void *p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void *p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi), each a bf16 pair
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t &hi, uint32_t &lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t *>(&h);
  lo = *reinterpret_cast<const uint32_t *>(&l);
}

// The A operand of k16 step kk (columns 16kk .. 16kk+15) from the n8
// accumulator tiles 2kk and 2kk+1 of a 16-row fragment, split hi + lo.
template <int N>
__device__ __forceinline__ void a_split(const float (&x)[N][4], int kk, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_bf16(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
  split_bf16(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
  split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
  split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
}

}  // namespace flash
