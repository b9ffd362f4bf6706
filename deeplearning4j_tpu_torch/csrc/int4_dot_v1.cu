// int4_dot_v1: the first design of int4_dot (csrc/int4_dot.cu), kept unchanged
// apart from its entry point's name as the yardstick that chip_smoke.py
// times the redesign against on the same card in the same run
// ("previous_ms"). Nothing in the package calls it.
//
// int4_dot: int8 queries (b, d) x packed int4 rows (n, ceil(d/2)) -> int32 (b, n).
//
// Replaces the TPU kernel deeplearning4j_tpu/perf/pallas/adc.py::_int4_dot_kernel
// (wrapper int4_matmul). Byte t of a packed row holds code 2t in its low
// nibble and code 2t+1 in its high nibble, each a sign-extended 4-bit value.
// Only k < d counts: for odd d the last high nibble is padding.
//
// Bound on an H100 SXM (3.35 TB/s, 1,979 TOP/s int8): every packed weight
// byte is read once and used for 2*b operations, so at serving batch sizes
// (b <= 64) the kernel is bound by memory. VGG16's fc1 reads 51.4 MB of
// packed weights: about 15.6 us at 3.35 TB/s, against 1.7 us of int8
// arithmetic at b = 16.
//
// Design (a first, simple kernel; wgmma/TMA are later work):
// - One warp per weight row j. Lane l takes the 16-byte packed chunks
//   l, l + 32, ... (32 codes each), so a warp reads 512 contiguous bytes per
//   step.
// - A chunk is unpacked in registers: masks give the low and high nibbles,
//   __vsub4((v ^ 0x08) , 0x08) sign-extends four at a time, __byte_perm
//   interleaves them into k order. __dp4a then multiplies four codes by four
//   query bytes and accumulates in int32.
// - Up to 8 query rows share each weight chunk, so each weight byte is read
//   once per 8 queries. Query rows are read through the read-only cache;
//   the warps of a block walk the same k range at about the same time.
// - Lanes' partial sums are reduced with warp shuffles; lane 0 writes.
// - Codes past the last whole 32-code chunk, and rows whose strides or base
//   addresses are not 16-byte aligned, take a scalar path over k.
// All arithmetic is int32 and exact, so the result equals the plain
// version bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // weight rows per block
constexpr int kQB = 8;      // query rows per pass over a weight row

__device__ __forceinline__ void unpack8(uint32_t p, int &a, int &b) {
  // p holds bytes B0..B3 = codes (0,1) (2,3) (4,5) (6,7) as lo/hi nibbles.
  uint32_t lo = __vsub4((p & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
  uint32_t hi = __vsub4(((p >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
  a = (int)__byte_perm(lo, hi, 0x5140);  // codes 0,1,2,3
  b = (int)__byte_perm(lo, hi, 0x7362);  // codes 4,5,6,7
}

__device__ __forceinline__ int code_at(const int8_t *prow, int k) {
  uint32_t byte = (uint8_t)prow[k >> 1];
  uint32_t nib = (k & 1) ? (byte >> 4) : (byte & 0xFu);
  return (int)(nib ^ 8u) - 8;
}

__global__ void __launch_bounds__(kWarps * 32)
int4_dot_kernel(const int8_t *__restrict__ qq, long long sq,
                const int8_t *__restrict__ packed, long long sp,
                int32_t *__restrict__ out, long long so,
                int b, int n, int d, int vec) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (j >= n) return;
  const int8_t *prow = packed + (long long)j * sp;
  const int nfull = vec ? (d >> 5) : 0;  // whole 32-code chunks
  const uint4 *pchunks = reinterpret_cast<const uint4 *>(prow);

  for (int q0 = 0; q0 < b; q0 += kQB) {
    const int nq = min(kQB, b - q0);
    int acc[kQB];
#pragma unroll
    for (int q = 0; q < kQB; ++q) acc[q] = 0;

    for (int c = lane; c < nfull; c += 32) {
      const uint4 pw = __ldg(pchunks + c);
      int w[8];
      unpack8(pw.x, w[0], w[1]);
      unpack8(pw.y, w[2], w[3]);
      unpack8(pw.z, w[4], w[5]);
      unpack8(pw.w, w[6], w[7]);
#pragma unroll
      for (int q = 0; q < kQB; ++q) {
        if (q < nq) {
          const uint4 *qrow =
              reinterpret_cast<const uint4 *>(qq + (long long)(q0 + q) * sq) + 2 * c;
          const uint4 x0 = __ldg(qrow);
          const uint4 x1 = __ldg(qrow + 1);
          int s = acc[q];
          s = __dp4a(w[0], (int)x0.x, s);
          s = __dp4a(w[1], (int)x0.y, s);
          s = __dp4a(w[2], (int)x0.z, s);
          s = __dp4a(w[3], (int)x0.w, s);
          s = __dp4a(w[4], (int)x1.x, s);
          s = __dp4a(w[5], (int)x1.y, s);
          s = __dp4a(w[6], (int)x1.z, s);
          s = __dp4a(w[7], (int)x1.w, s);
          acc[q] = s;
        }
      }
    }

    for (int k = (nfull << 5) + lane; k < d; k += 32) {
      const int wk = code_at(prow, k);
#pragma unroll
      for (int q = 0; q < kQB; ++q)
        if (q < nq) acc[q] += wk * (int)qq[(long long)(q0 + q) * sq + k];
    }

#pragma unroll
    for (int q = 0; q < kQB; ++q) {
      int s = acc[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
      if (lane == 0 && q < nq) out[(long long)(q0 + q) * so + j] = s;
    }
  }
}

}  // namespace

extern "C" int int4_dot_v1_launch(const void *qq, long long sq, const void *packed,
                               long long sp, void *out, long long so, int b, int n,
                               int d, void *stream) {
  if (b <= 0 || n <= 0) return 0;
  const int vec = ((uintptr_t)qq % 16 == 0) && ((uintptr_t)packed % 16 == 0) &&
                  (sq % 16 == 0) && (sp % 16 == 0);
  const dim3 grid((n + kWarps - 1) / kWarps);
  int4_dot_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int8_t *)qq, sq, (const int8_t *)packed, sp, (int32_t *)out, so, b, n,
      d, vec);
  return (int)cudaGetLastError();
}
