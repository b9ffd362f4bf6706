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
// by _csr_slots) are computed like any other; the caller masks them to inf.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. Each slot reads seg, pos and its
// M codes and writes one float (b*C*(12 + M) bytes), and each query's
// p*M*ksub LUT is read once: at b = 256, C = 32768, M = 8, p = 8, ksub = 256
// that is 168 MB + 16.8 MB, 55 us. b*C*M LUT reads go to shared memory.
//
// Design (simple and right first):
// - Block (256 threads) = one query x one tile of its slots. The block
//   stages that query's whole p*M*ksub LUT (64 KB at p = 8, M = 8,
//   ksub = 256) in shared memory, then each thread walks slots: seg and pos
//   loads coalesce along s, the code row of a slot is one 8-byte load at
//   M = 8 (slots of one cell read consecutive rows), the M gathers hit
//   shared memory, the store coalesces along s.
// - Few tiles per query (about 800 blocks in all), so the LUT staging stays
//   small beside the slot traffic.
// - A query's LUT over 227 KB (p = 32 at M = 8, ksub = 256 is 256 KB) is
//   read from global memory through the read-only cache in the same kernel
//   (template flag kSmem = false); there is no other fallback.

#include "adc_common.cuh"

namespace {

template <bool kSmem, int kM>
__global__ void __launch_bounds__(adc::kThreads)
adc_ivf_pq_kernel(const float *__restrict__ lut, const uint8_t *__restrict__ codes,
                  const int32_t *__restrict__ seg, const int32_t *__restrict__ pos,
                  float *__restrict__ d2, int C, int p, int M, int ksub,
                  long long n_codes) {
  extern __shared__ float smem[];
  const int i = blockIdx.y;
  const long long cell_floats = (long long)M * ksub;
  const long long lut_q = (long long)p * cell_floats;  // floats per query
  const float *L;
  if constexpr (kSmem) {
    adc::stage(smem, lut + i * lut_q, lut_q);
    __syncthreads();
    L = smem;
  } else {
    L = lut + i * lut_q;
  }
  const int Mr = kM > 0 ? kM : M;
  const int per = (C + gridDim.x - 1) / gridDim.x;
  const int s0 = blockIdx.x * per;
  const int s1 = min(C, s0 + per);
  for (int s = s0 + threadIdx.x; s < s1; s += blockDim.x) {
    const long long idx = (long long)i * C + s;
    // clamped, so a bad slot can never read outside the LUT or the codes
    const int sg = min(max(__ldg(seg + idx), 0), p - 1);
    long long ps = __ldg(pos + idx);
    ps = ps < 0 ? 0 : (ps >= n_codes ? n_codes - 1 : ps);
    const uint8_t *row = codes + ps * Mr;
    const float *Ls = L + sg * cell_floats;
    float acc = 0.0f;
    for (int m0 = 0; m0 < Mr; m0 += 8) {
      const int cnt = min(8, Mr - m0);
      int c[8];
      adc::load_codes<kM>(row, m0, cnt, ksub, c);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (u < cnt)
          acc = __fadd_rn(acc, adc::lut_at<kSmem>(Ls + (long long)(m0 + u) * ksub + c[u]));
    }
    d2[idx] = acc;
  }
}

template <bool kSmem, int kM>
int launch(const float *lut, const uint8_t *codes, const int32_t *seg,
           const int32_t *pos, float *d2, int b, int C, int p, int M, int ksub,
           long long n_codes, long long smem, cudaStream_t stream) {
  auto kern = adc_ivf_pq_kernel<kSmem, kM>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int slot_blocks = (C + adc::kThreads - 1) / adc::kThreads;
  int tiles = (800 + b - 1) / b;
  if (tiles > slot_blocks) tiles = slot_blocks;
  if (tiles < 1) tiles = 1;
  kern<<<dim3((unsigned)tiles, (unsigned)b), adc::kThreads, kSmem ? smem : 0, stream>>>(
      lut, codes, seg, pos, d2, C, p, M, ksub, n_codes);
  return (int)cudaGetLastError();
}

}  // namespace

// vec8: the wrapper found codes 8-byte aligned and M == 8. b <= 65535 (the
// grid's y extent; the wrapper checks).
extern "C" int adc_ivf_pq_launch(const void *lut, const void *codes, const void *seg,
                                 const void *pos, void *d2, int b, int C, int p, int M,
                                 int ksub, long long n_codes, int vec8, void *stream) {
  if (b <= 0 || C <= 0) return 0;
  if (M < 1 || ksub < 1 || p < 1 || n_codes < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const long long smem = (long long)p * M * ksub * 4;
  const float *l = (const float *)lut;
  const uint8_t *c = (const uint8_t *)codes;
  const int32_t *sg = (const int32_t *)seg;
  const int32_t *ps = (const int32_t *)pos;
  float *o = (float *)d2;
  cudaStream_t s = (cudaStream_t)stream;
  if (smem <= adc::kMaxSmem)
    return vec8 ? launch<true, 8>(l, c, sg, ps, o, b, C, p, M, ksub, n_codes, smem, s)
                : launch<true, 0>(l, c, sg, ps, o, b, C, p, M, ksub, n_codes, smem, s);
  return vec8 ? launch<false, 8>(l, c, sg, ps, o, b, C, p, M, ksub, n_codes, 0, s)
              : launch<false, 0>(l, c, sg, ps, o, b, C, p, M, ksub, n_codes, 0, s);
}
