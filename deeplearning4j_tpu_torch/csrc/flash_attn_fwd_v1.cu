// flash_attn_fwd_v1: the first design of flash_attn_fwd (csrc/flash_attn_fwd.cu), kept unchanged
// apart from its entry point's name as the yardstick that chip_smoke.py
// times the redesign against on the same card in the same run
// ("previous_ms"). Nothing in the package calls it.
//
// flash_attn_fwd: the forward of tiled online-softmax self-attention.
//
//   o[b, h, i, :] = sum_j softmax_j(q[b, h, i, :] . k[b, h, j, :] / sqrt(d)) v[b, h, j, :]
//
// over j < t, or j <= i when causal. q, k, v, o are (b, h, t, d) tensors of
// one type, float32 or bfloat16, whose last axis is contiguous; the b, h and
// t axes go by the strides passed in, so the head-split views of the
// projections ((b, t, h, d) in memory) are read and written in place. Every
// sum, the softmax and the accumulator are float32, and o is written once,
// in q's type. When asked (a non-null pointer), the kernel also writes each
// row's log-sum-exp L[b, h, i] = m + log(l), float32, (b, h, t) contiguous,
// in the scaled units of the scores (s = q . k / sqrt(d)): the backward
// kernels (flash_attn_bwd_dkv.cu, flash_attn_bwd_dq.cu) recompute p =
// exp(s - L) from it. The JAX library saves m and l apart, each broadcast
// over 128 lanes (flash_attention.py:675-692); one float per row carries
// the same.
//
// Replaces the TPU kernel that deeplearning4j_tpu/parallel/ring_attention.py::
// flash_self_attention reaches: JAX's library Pallas flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py, forward
// _flash_attention_impl, pallas_call at :758, body _flash_attention_kernel).
// That kernel walks the key blocks along a sequential grid axis with the
// running max, sum and accumulator in VMEM scratch. Here the walk is a loop
// inside one block, with the same three carried in registers.
//
// Design (simple and right first; CUDA cores, no tensor cores yet):
// - One block of 256 threads per (b*h, tile of 64 query rows). The tile's Q,
//   and in turn each tile of 64 K and V rows, are staged in shared memory as
//   float32 (zero past t and past d). The blocks of the last query tiles,
//   which have the most work when causal, are scheduled first.
// - Thread (ty, tx) = (threadIdx.x / 16, threadIdx.x % 16) owns query rows
//   4*ty .. 4*ty+3 and, in the score tile, key columns tx + 16*j (j < 4): the
//   dot products read Q and K as float4 from rows padded by 4 floats, so a
//   quarter-warp's K reads fall in distinct banks. A row's max and sum are
//   reduced over its 16 threads with shuffles inside a half-warp.
// - Online softmax per key tile: m' = max(m, tile max), alpha = exp(m - m'),
//   p = exp(s - m'), l' = l*alpha + sum p, acc' = acc*alpha + P V. P goes
//   through shared memory; for P V the thread owns output columns tx + 16*j'
//   (j' < DP/16) of its 4 rows. o = acc / l at the end.
// - Scores are divided by sqrt(d) in float32, as the plain version divides.
// - Causal: key tiles wholly above the diagonal are not visited; the
//   diagonal tile is masked per entry (k_pos > q_pos gets -inf, so exp gives
//   exactly 0). Ragged t and d are masked at the tail: keys at or past t are
//   -inf, padded d columns are zero in Q, K and V and never stored. In
//   self-attention every query row has at least one key (k_pos = 0), so l > 0.
// - The head dim is a template parameter padded to DP = 32, 64, 128 or 256
//   (d from 1 to 256). Shared memory is 4 * (2*64*(DP+4) + 64*DP + 64*68)
//   bytes: 44 KB at DP = 32, 69 KB at 64, 118 KB at 128, 216 KB at 256, so
//   the kernel sets cudaFuncAttributeMaxDynamicSharedMemorySize first.
// - Offsets are 64-bit. No atomics: each output element is written by one
//   thread after a fixed order of operations, so two launches agree bitwise.
//
// Bound on an H100 SXM: the operations. 4*b*h*t*t*d float32 operations
// (two products of t x t x d, a multiply and an add each), about half when
// causal, over 67 TFLOP/s outside the tensor cores (989 TFLOP/s if the
// products ran on bf16 tensor cores); q, k, v and o once each over
// 3.35 TB/s is far less. At (8, 12, 1024, 64) causal that is 12.9 GFLOP,
// 0.19 ms, against 30 us of bytes. This kernel's inner loops issue about
// one shared-memory load per two FMAs, so it cannot pass half of the CUDA
// cores' rate; mma/wgmma tiles are the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;         // query rows per block, key rows per step
constexpr int kThreads = 256;
constexpr int kPStride = kTile + 4;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float *p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16 *p, float x) { *p = __float2bfloat16_rn(x); }

// Element strides of the b, h and t axes of one operand (d's is 1).
struct Strides {
  long long b, h, t;
};

// Rows row0 .. row0+63 of a (t, d) matrix with row stride src_t into
// dst[r * stride + c], c < DP, as float32; zero past t and past d.
template <int DP, typename E>
__device__ __forceinline__ void stage(float *dst, int stride, const E *__restrict__ src,
                                      long long src_t, int row0, int t, int d) {
  for (int i = threadIdx.x; i < kTile * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (row0 + r < t && c < d) x = to_float(src[(long long)(row0 + r) * src_t + c]);
    dst[r * stride + c] = x;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kAll, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

__device__ __forceinline__ float lane(const float4 &a, int c) {
  return c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
}

template <int DP, typename E>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const E *__restrict__ q, const E *__restrict__ k, const E *__restrict__ v,
                 E *__restrict__ o, float *__restrict__ lse, Strides sq, Strides sk,
                 Strides sv, Strides so, int h, int bh_count, int t, int d, float sqrt_d,
                 int causal) {
  constexpr int kQK = DP + 4;  // row stride of Q and K in shared memory
  constexpr int kJ = DP / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float *const Qs = reinterpret_cast<float *>(smem4);
  float *const Ks = Qs + kTile * kQK;
  float *const Vs = Ks + kTile * kQK;
  float *const Ps = Vs + kTile * DP;

  const int n_tiles = (t + kTile - 1) / kTile;
  const int bh = blockIdx.x % bh_count;
  const int qt = n_tiles - 1 - blockIdx.x / bh_count;  // heaviest tiles first
  const int q0 = qt * kTile;
  const long long bi = bh / h, hi = bh % h;
  const E *const q_bh = q + bi * sq.b + hi * sq.h;
  const E *const k_bh = k + bi * sk.b + hi * sk.h;
  const E *const v_bh = v + bi * sv.b + hi * sv.h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  stage<DP>(Qs, kQK, q_bh, sq.t, q0, t, d);

  float m[4], l[4], acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;
  }

  const int kt_end = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last step's reads of Ks, Vs and Ps are done
    stage<DP>(Ks, kQK, k_bh, sk.t, k0, t, d);
    stage<DP>(Vs, DP, v_bh, sv.t, k0, t, d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4 *>(Qs + (4 * ty + i) * kQK + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4 *>(Ks + (tx + 16 * j) * kQK + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        float x = s[i][j] / sqrt_d;
        if (k_pos >= t || (causal && k_pos > q_pos)) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no key yet: p = 0
      const float alpha = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(4 * ty + i) * kPStride + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kTile; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4 *>(Ps + (4 * ty + i) * kPStride + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[kJ];
#pragma unroll
        for (int j = 0; j < kJ; ++j) vv[j] = Vs[(c + cc) * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = lane(pa[i], cc);
#pragma unroll
          for (int j = 0; j < kJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + 4 * ty + i;
    if (q_pos >= t) continue;
    // every thread of the half-warp holds the row's m and l
    if (lse != nullptr && tx == 0) lse[(long long)bh * t + q_pos] = m[i] + logf(l[i]);
    E *const row = o + bi * so.b + hi * so.h + q_pos * so.t;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) store(row + c, acc[i][j] / l[i]);
    }
  }
}

template <int DP, typename E>
int run(const void *q, const void *k, const void *v, void *o, float *lse, const Strides *st,
        int b, int h, int t, int d, int causal, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * (2 * kTile * (DP + 4) + kTile * DP + kTile * kPStride);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DP, E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int bh = b * h;
  const long long blocks = (long long)((t + kTile - 1) / kTile) * bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_fwd_kernel<DP, E><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const E *)q, (const E *)k, (const E *)v, (E *)o, lse, st[0], st[1], st[2], st[3], h,
      bh, t, d, sqrtf((float)d), causal);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch(const void *q, const void *k, const void *v, void *o, float *lse,
             const Strides *st, int b, int h, int t, int d, int causal, cudaStream_t s) {
  if (d <= 32) return run<32, E>(q, k, v, o, lse, st, b, h, t, d, causal, s);
  if (d <= 64) return run<64, E>(q, k, v, o, lse, st, b, h, t, d, causal, s);
  if (d <= 128) return run<128, E>(q, k, v, o, lse, st, b, h, t, d, causal, s);
  return run<256, E>(q, k, v, o, lse, st, b, h, t, d, causal, s);
}

}  // namespace

// strides: the element strides of the b, h and t axes of q, k, v and o, in
// that order (12 values; the d axis is contiguous). lse: a float32 (b, h, t)
// contiguous buffer for the rows' log-sum-exp, or null (the serving path:
// nothing more is written). dtype 0 float32, 1 bfloat16. Returns a
// cudaError_t (0: launched).
extern "C" int flash_attn_fwd_v1_launch(const void *q, const void *k, const void *v, void *o,
                                     void *lse, const long long *strides, int b, int h,
                                     int t, int d, int dtype, int causal, void *stream) {
  if (b <= 0 || h <= 0 || t <= 0) return 0;
  if (d < 1 || d > 256 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = (cudaStream_t)stream;
  float *const l = (float *)lse;
  if (dtype == 0) return dispatch<float>(q, k, v, o, l, st, b, h, t, d, causal, s);
  return dispatch<__nv_bfloat16>(q, k, v, o, l, st, b, h, t, d, causal, s);
}
