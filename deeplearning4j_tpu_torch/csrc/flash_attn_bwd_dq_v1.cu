// flash_attn_bwd_dq_v1: the first design of the dQ kernel of the attention
// backward (CUDA cores only, both dtypes), kept as the yardstick its
// redesign (flash_attn_bwd_dq.cu) is timed against (chip_smoke.py's
// "previous_ms"). Nothing on the port's path launches it. The dK/dV kernel
// that shared this design is flash_attn_bwd_v1.cu.
//
// Given q, k, v, the upstream gradient dO, each row's log-sum-exp L (written
// by flash_attn_fwd.cu) and D = rowsum(dO * O) (computed by the wrapper):
//
//   s = 1 / sqrt(d);   P = exp(s q k^T - L)   (0 where masked)
//   dV = P^T dO;   dS = P * (dO v^T - D);   dK = s dS^T q;   dQ = s dS k
//
// q, k, v, dO and the outputs dq, dk, dv are (b, h, t, d) tensors of one type,
// float32 or bfloat16, whose last axis is contiguous; the b, h and t axes go
// by the strides passed in, so the head-split views of the projections, and
// the transposed dO that autograd hands back, are read and written in place.
// L and D are float32 (b, h, t) contiguous. Every sum is float32; dq, dk and
// dv are rounded once, to the inputs' type.
//
// Replaces the TPU kernels of the backward of JAX's library Pallas flash
// attention, which deeplearning4j_tpu/parallel/ring_attention.py::
// flash_self_attention reaches (jax/experimental/pallas/ops/tpu/
// flash_attention.py, _flash_attention_bwd :254): _flash_attention_bwd_dkv
// (:941, pallas_call :1121) and _flash_attention_bwd_dq (:1287, pallas_call
// :1456). There a sequential grid axis walks the other operand's blocks and
// carries the accumulators in VMEM scratch; here each block walks them in a
// loop, with the accumulators in registers.
//
// Design (simple and right first; CUDA cores, no tensor cores yet):
// - dK/dV kernel: one block of 256 threads per (b*h, tile of BR key rows).
//   It stages its K and V tiles in shared memory as float32 (zero past t and
//   past d), then walks the query tiles: all of them, or when causal from
//   the diagonal tile to the last. For each it stages Q, dO, L and D,
//   recomputes S^T = K Q^T and dP^T = V dO^T for the tile, forms P and dS,
//   and accumulates dV += P^T dO and dK += dS^T Q. dK and dV are written
//   once, at the end.
// - dQ kernel: one block per (b*h, tile of BR query rows). It stages Q, dO,
//   L and D, walks the key tiles up to the diagonal (or all), recomputes S
//   and dP, forms dS, and accumulates dQ += dS K. dQ is written once.
// - Thread (ty, tx) = (threadIdx.x / 16, threadIdx.x % 16) owns the tile
//   rows RI*ty .. RI*ty+RI-1 (RI = BR/16) and, in the BR x BR score tile,
//   the columns tx + 16*j; in the accumulators, the head-dim columns
//   tx + 16*j' (j' < DP/16). The dot products read rows as float4 from rows
//   padded by 4 floats, as flash_attn_fwd.cu does. P, then dS, pass through
//   one BR x (BR+4) shared tile.
// - Masks: keys past the diagonal (causal), keys or queries at or past t
//   give p = 0 exactly. Scores are divided by sqrt(d) in float32, as the
//   forward and the plain version divide.
// - The head dim is a template parameter padded to DP = 32, 64, 128 (with
//   BR = 64) or 256 (with BR = 32: four 64-row tiles would take 283 KB of
//   shared memory, past the SM's 227 KB). Shared memory is
//   4 * (4*BR*(DP+4) + BR*(BR+4) + 2*BR) bytes: 54 KB at DP = 32, 86 KB at
//   64, 150 KB at 128, 135 KB at 256, so each launch sets
//   cudaFuncAttributeMaxDynamicSharedMemorySize first.
// - Offsets are 64-bit. No atomics and no state across blocks: every
//   output element is written by one thread after a fixed order of
//   operations, so two launches agree bitwise.
//
// Bound on an H100 SXM: the operations. dK/dV runs four products of
// t x t x d per (b, h) (S, dP, P^T dO, dS^T Q), dQ three (S, dP, dS K), at 2
// operations per multiply-add, about half of each when causal, over
// 67 TFLOP/s outside the tensor cores (989 TFLOP/s for bf16 on them). At
// (8, 12, 1024, 64) causal float32: 25.8 GFLOP, 0.385 ms, and 19.3 GFLOP,
// 0.288 ms; the bytes (q, k, v, dO, L, D read once, the gradients written
// once) take 0.06 ms. The inner loops issue one shared-memory load per two
// to four FMAs, so they cannot pass about half of the CUDA cores' rate;
// mma/wgmma tiles are the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float *p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16 *p, float x) { *p = __float2bfloat16_rn(x); }

// Element strides of the b, h and t axes of one operand (d's is 1).
struct Strides {
  long long b, h, t;
};

// Rows row0 .. row0+BR-1 of a (t, d) matrix with row stride src_t into
// dst[r * (DP + 4) + c], c < DP, as float32; zero past t and past d.
template <int DP, int BR, typename E>
__device__ __forceinline__ void stage(float *dst, const E *__restrict__ src, long long src_t,
                                      int row0, int t, int d) {
  for (int i = threadIdx.x; i < BR * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (row0 + r < t && c < d) x = to_float(src[(long long)(row0 + r) * src_t + c]);
    dst[r * (DP + 4) + c] = x;
  }
}

// Entries row0 .. row0+BR-1 of one (b, h) row of a float32 (b, h, t) vector;
// zero past t.
template <int BR>
__device__ __forceinline__ void stage_rows(float *dst, const float *__restrict__ src, int row0,
                                           int t) {
  for (int i = threadIdx.x; i < BR; i += kThreads) dst[i] = row0 + i < t ? src[row0 + i] : 0.f;
}

// acc[i][j] = sum_c A[(RI*ty + i) * (DP+4) + c] * B[(tx + 16*j) * (DP+4) + c]
template <int DP, int RI, int CJ>
__device__ __forceinline__ void tile_dot(float (&acc)[RI][CJ], const float *A, const float *B,
                                         int ty, int tx) {
  constexpr int kS = DP + 4;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    float4 a[RI], b[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      a[i] = *reinterpret_cast<const float4 *>(A + (RI * ty + i) * kS + c);
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      b[j] = *reinterpret_cast<const float4 *>(B + (tx + 16 * j) * kS + c);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

__device__ __forceinline__ float lane(const float4 &a, int c) {
  return c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
}

// acc[i][j] += sum_{c < BR} P[(RI*ty + i) * (BR+4) + c] * M[c * (DP+4) + tx + 16*j]
template <int DP, int BR, int RI>
__device__ __forceinline__ void tile_acc(float (&acc)[RI][DP / 16], const float *P,
                                         const float *M, int ty, int tx) {
  constexpr int kS = DP + 4, kP = BR + 4, kJ = DP / 16;
#pragma unroll 2
  for (int c = 0; c < BR; c += 4) {
    float4 pa[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      pa[i] = *reinterpret_cast<const float4 *>(P + (RI * ty + i) * kP + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float mv[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) mv[j] = M[(c + cc) * kS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = lane(pa[i], cc);
#pragma unroll
        for (int j = 0; j < kJ; ++j) acc[i][j] = fmaf(p, mv[j], acc[i][j]);
      }
    }
  }
}

// The thread's rows RI*ty + i (i < RI) of a (BR, DP) register tile into rows
// row0 + RI*ty + i of a (t, d) matrix, each divided by div (sqrt(d) for dk
// and dq, 1 for dv); nothing past t or past d.
template <int DP, int RI, typename E>
__device__ __forceinline__ void store_rows(E *dst, long long dst_t, const float (&acc)[RI][DP / 16],
                                           int row0, int ty, int tx, int t, int d, float div) {
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = row0 + RI * ty + i;
    if (row >= t) continue;
    E *const out = dst + (long long)row * dst_t;
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      const int c = tx + 16 * j;
      if (c < d) store(out + c, div == 1.f ? acc[i][j] : acc[i][j] / div);
    }
  }
}

template <int DP, int BR>
constexpr int smem_bytes() {
  return (int)sizeof(float) * (4 * BR * (DP + 4) + BR * (BR + 4) + 2 * BR);
}

template <int DP, int BR, typename E>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const E *__restrict__ q, const E *__restrict__ k, const E *__restrict__ v,
                    const E *__restrict__ dout, const float *__restrict__ lse,
                    const float *__restrict__ delta, E *__restrict__ dq, Strides sq,
                    Strides sk, Strides sv, Strides sdo, Strides sdq, int h, int bh_count, int t,
                    int d, float sqrt_d, int causal) {
  constexpr int kP = BR + 4, RI = BR / 16, CJ = BR / 16, kJ = DP / 16;
  constexpr int kS = DP + 4;
  extern __shared__ float4 smem4[];
  float *const Qs = reinterpret_cast<float *>(smem4);
  float *const Os = Qs + BR * kS;  // dO
  float *const Ks = Os + BR * kS;
  float *const Vs = Ks + BR * kS;
  float *const Ps = Vs + BR * kS;  // dS: (query, key)
  float *const Ls = Ps + BR * kP;
  float *const Ds = Ls + BR;

  const int n_tiles = (t + BR - 1) / BR;
  const int bh = blockIdx.x % bh_count;
  const int qt = n_tiles - 1 - blockIdx.x / bh_count;  // heaviest tiles first
  const int q0 = qt * BR;
  const long long bi = bh / h, hi = bh % h;
  const E *const k_bh = k + bi * sk.b + hi * sk.h;
  const E *const v_bh = v + bi * sv.b + hi * sv.h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  stage<DP, BR>(Qs, q + bi * sq.b + hi * sq.h, sq.t, q0, t, d);
  stage<DP, BR>(Os, dout + bi * sdo.b + hi * sdo.h, sdo.t, q0, t, d);
  stage_rows<BR>(Ls, lse + (long long)bh * t, q0, t);
  stage_rows<BR>(Ds, delta + (long long)bh * t, q0, t);

  float acc[RI][kJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;

  const int kt_end = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BR;
    __syncthreads();  // staging done (first step); the last step's reads done
    stage<DP, BR>(Ks, k_bh, sk.t, k0, t, d);
    stage<DP, BR>(Vs, v_bh, sv.t, k0, t, d);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
    tile_dot<DP, RI, CJ>(s, Qs, Ks, ty, tx);   // s[i][j] = q_r . k_c
    tile_dot<DP, RI, CJ>(dp, Os, Vs, ty, tx);  // dp[i][j] = dO_r . v_c
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = RI * ty + i, q_pos = q0 + r;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 16 * j, k_pos = k0 + c;
        const bool keep = q_pos < t && k_pos < t && !(causal && k_pos > q_pos);
        const float p = keep ? expf(s[i][j] / sqrt_d - Ls[r]) : 0.f;
        Ps[r * kP + c] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();
    tile_acc<DP, BR, RI>(acc, Ps, Ks, ty, tx);  // dQ += dS K (scaled at the end)
  }

  store_rows<DP, RI>(dq + bi * sdq.b + hi * sdq.h, sdq.t, acc, q0, ty, tx, t, d, sqrt_d);
}

inline Strides strides_of(const long long *s, int i) { return {s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

inline bool grid_of(int b, int h, int t, int br, unsigned *blocks) {
  const long long n = (long long)((t + br - 1) / br) * b * h;
  if (n > 0x7fffffffLL) return false;
  *blocks = (unsigned)n;
  return true;
}

template <int DP, int BR, typename E>
int run_dq(const void *q, const void *k, const void *v, const void *dout, const float *lse,
           const float *delta, void *dq, const long long *st, int b, int h, int t, int d,
           int causal, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP, BR>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DP, BR, E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  unsigned blocks;
  if (!grid_of(b, h, t, BR, &blocks)) return (int)cudaErrorInvalidConfiguration;
  flash_bwd_dq_kernel<DP, BR, E><<<blocks, kThreads, smem, stream>>>(
      (const E *)q, (const E *)k, (const E *)v, (const E *)dout, lse, delta, (E *)dq,
      strides_of(st, 0), strides_of(st, 1), strides_of(st, 2), strides_of(st, 3),
      strides_of(st, 4), h, b * h, t, d, sqrtf((float)d), causal);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch_dq(const void *q, const void *k, const void *v, const void *dout, const float *lse,
                const float *delta, void *dq, const long long *st, int b, int h, int t, int d,
                int causal, cudaStream_t s) {
  if (d <= 32) return run_dq<32, 64, E>(q, k, v, dout, lse, delta, dq, st, b, h, t, d, causal, s);
  if (d <= 64) return run_dq<64, 64, E>(q, k, v, dout, lse, delta, dq, st, b, h, t, d, causal, s);
  if (d <= 128) return run_dq<128, 64, E>(q, k, v, dout, lse, delta, dq, st, b, h, t, d, causal, s);
  return run_dq<256, 32, E>(q, k, v, dout, lse, delta, dq, st, b, h, t, d, causal, s);
}

inline int check(int d, int dtype) {
  if (d < 1 || d > 256 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// strides: the element strides of the b, h and t axes of q, k, v, dO and dq,
// in that order (15 values). Otherwise as flash_attn_bwd_dkv_launch.
extern "C" int flash_attn_bwd_dq_v1_launch(const void *q, const void *k, const void *v,
                                           const void *dout, const void *lse,
                                           const void *delta, void *dq,
                                           const long long *strides, int b, int h, int t, int d,
                                           int dtype, int causal, void *stream) {
  if (b <= 0 || h <= 0 || t <= 0) return 0;
  if (int err = check(d, dtype)) return err;
  const float *l = (const float *)lse, *dl = (const float *)delta;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_dq<float>(q, k, v, dout, l, dl, dq, strides, b, h, t, d, causal, s);
  return dispatch_dq<__nv_bfloat16>(q, k, v, dout, l, dl, dq, strides, b, h, t, d, causal, s);
}
