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
// 8 MB of codes and 2 MB of LUT: 0.31 ms. Beside the bytes, b*n*M LUT reads
// (2.05e9 at that shape) go to shared memory, at most 32 a cycle per SM
// before bank conflicts: of the same order.
//
// Design (simple and right first):
// - Block (256 threads) = a group of up to 8 queries x a grid-stride walk
//   over code rows. The group's LUTs (8 KB a query at M = 8, ksub = 256) are
//   staged in shared memory once per block; each thread keeps one
//   accumulator per query of the group, so each code row is loaded once
//   (one 8-byte load at M = 8) for up to 8 queries.
// - Stores go to d2[q, j] with j along the threads: coalesced.
// - A query's LUT over 227 KB (M * ksub > 58,112) is read from global memory
//   through the read-only cache instead (template flag kSmem = false).
// - ragged n and b: the row loop and the group size stop at the edge.

#include "adc_common.cuh"

namespace {

constexpr int kQG = 8;  // queries per block at most

template <bool kSmem, int kM>
__global__ void __launch_bounds__(adc::kThreads)
adc_pq_kernel(const float *__restrict__ lut, const uint8_t *__restrict__ codes,
              float *__restrict__ d2, int b, long long n, int M, int ksub, int qpb) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.y * qpb;
  const int nq = min(qpb, b - q0);
  const long long lut_q = (long long)M * ksub;  // floats per query
  const float *L;
  if constexpr (kSmem) {
    adc::stage(smem, lut + q0 * lut_q, nq * lut_q);
    __syncthreads();
    L = smem;
  } else {
    L = lut + q0 * lut_q;
  }
  const int Mr = kM > 0 ? kM : M;  // a constant M lets the loop unroll
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    const uint8_t *row = codes + j * Mr;
    float acc[kQG];
#pragma unroll
    for (int q = 0; q < kQG; ++q) acc[q] = 0.0f;
    for (int m0 = 0; m0 < Mr; m0 += 8) {
      const int cnt = min(8, Mr - m0);
      int c[8];
      adc::load_codes<kM>(row, m0, cnt, ksub, c);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (u < cnt) {
          const float *Lm = L + (long long)(m0 + u) * ksub + c[u];
#pragma unroll
          for (int q = 0; q < kQG; ++q)
            if (q < nq) acc[q] = __fadd_rn(acc[q], adc::lut_at<kSmem>(Lm + q * lut_q));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kQG; ++q)
      if (q < nq) d2[(long long)(q0 + q) * n + j] = acc[q];
  }
}

template <bool kSmem, int kM>
int launch(const float *lut, const uint8_t *codes, float *d2, int b, long long n,
           int M, int ksub, int qpb, long long smem, cudaStream_t stream) {
  auto kern = adc_pq_kernel<kSmem, kM>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int gy = (b + qpb - 1) / qpb;
  const long long row_blocks = (n + adc::kThreads - 1) / adc::kThreads;
  // about 2048 blocks in all: enough to fill the card, few enough that the
  // LUT staging (nq * M * ksub floats a block) stays small beside d2
  long long gx = (2048 + gy - 1) / gy;
  if (gx > row_blocks) gx = row_blocks;
  if (gx < 1) gx = 1;
  kern<<<dim3((unsigned)gx, (unsigned)gy), adc::kThreads, kSmem ? smem : 0, stream>>>(
      lut, codes, d2, b, n, M, ksub, qpb);
  return (int)cudaGetLastError();
}

}  // namespace

// vec8: the wrapper found codes 8-byte aligned and M == 8.
extern "C" int adc_pq_launch(const void *lut, const void *codes, void *d2, int b,
                             long long n, int M, int ksub, int vec8, void *stream) {
  if (b <= 0 || n <= 0) return 0;
  if (M < 1 || ksub < 1) return (int)cudaErrorInvalidValue;
  const long long per_q = (long long)M * ksub * 4;  // LUT bytes per query
  const bool smem_ok = per_q <= adc::kMaxSmem;
  int qpb = kQG;
  if (smem_ok) {
    long long fit = 65536 / per_q;  // aim at 64 KB a block
    qpb = (int)(fit < 1 ? 1 : (fit > kQG ? kQG : fit));
  }
  if (qpb > b) qpb = b;
  const long long smem = per_q * qpb;
  const float *l = (const float *)lut;
  const uint8_t *c = (const uint8_t *)codes;
  float *o = (float *)d2;
  cudaStream_t s = (cudaStream_t)stream;
  if (smem_ok)
    return vec8 ? launch<true, 8>(l, c, o, b, n, M, ksub, qpb, smem, s)
                : launch<true, 0>(l, c, o, b, n, M, ksub, qpb, smem, s);
  return vec8 ? launch<false, 8>(l, c, o, b, n, M, ksub, qpb, 0, s)
              : launch<false, 0>(l, c, o, b, n, M, ksub, qpb, 0, s);
}
