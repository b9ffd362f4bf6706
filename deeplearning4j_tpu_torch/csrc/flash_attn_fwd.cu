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
// kernels (flash_attn_bwd.cu) recompute p = exp(s - L) from it. The JAX
// library saves m and l apart, each broadcast over 128 lanes
// (flash_attention.py:675-692); one float per row carries the same.
//
// Replaces the TPU kernel that deeplearning4j_tpu/parallel/ring_attention.py::
// flash_self_attention reaches: JAX's library Pallas flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py, forward
// _flash_attention_impl, pallas_call at :758, body _flash_attention_kernel).
// That kernel walks the key blocks along a sequential grid axis with the
// running max, sum and accumulator in VMEM scratch. Here the walk is a loop
// inside one block, with the same three carried in registers.
//
// Bound on an H100 SXM: the operations. 4*b*h*t*t*d operations (two
// products of t x t x d, a multiply and an add each), about half when
// causal: in bf16 over the tensor cores' 989 TFLOP/s, in float32 over
// 67 TFLOP/s (the port keeps float32 in full float32: no TF32). At
// (8, 12, 1024, 64) causal that is 12.9 GFLOP: 13 us in bf16 (the 15 us of
// bytes bound it there) and 192 us in float32.
//
// Common to both types:
// - One block per (b*h, tile of 64 query rows); the blocks of the last query
//   tiles, which have the most work when causal, are scheduled first.
// - Q, and in turn each tile of keys and values, are copied into shared
//   memory by 16-byte cp.async, zero past t and past d; the next K/V tile is
//   in flight while the current one is used (two buffers). Operands whose
//   base or strides are not 16-byte aligned are copied element by element.
// - Online softmax per key tile, on the unscaled scores x = q . k:
//   m' = max(m, tile max), alpha = exp2((m - m') c), p = exp2((x - m') c),
//   l' = l*alpha + sum p, acc' = acc*alpha + P V; o = acc/l, L = m/sqrt(d) +
//   log(l), with c = log2(e)/sqrt(d). Each p = exp((x - m')/sqrt(d)) takes
//   one subtraction, one multiply and the hardware exp2: its absolute error
//   stays near 1e-7 however far x lies below the max, since the rounding of
//   (x - m') c grows with |x - m'| only as p shrinks.
// - Causal: key tiles wholly above the diagonal are not visited; tiles that
//   cross it are masked per entry (k_pos > q_pos gets -inf, so exp gives
//   exactly 0), as are keys at or past t. Padded d columns are zero in Q, K
//   and V and never stored. Every query row has key 0, so l > 0.
// - The head dim is a template parameter padded to DP = 64, 128 or 256.
// - Offsets are 64-bit. No atomics: each output element is written by one
//   thread after a fixed order of operations, so two launches agree bitwise.
//
// bfloat16: tensor cores (mma.sync m16n8k16, bf16 in, float32 sums), the
// FlashAttention-2 shape. Four warps, each owning 16 query rows. Q's
// fragments are loaded once by ldmatrix (DP <= 128; at 256 per step, for
// registers), K's by ldmatrix and V's by ldmatrix.trans. S = Q K^T is exact
// products with float32 sums; the softmax runs on the accumulator fragments,
// rows reduced over the four threads of a quad by shuffles (each thread
// keeps a partial l, summed once at the end). P is split into hi = bf16(P)
// and lo = bf16(P - hi) and both products are issued, so P V keeps about
// 2^-17 of P's precision: rounding P to bf16 alone would put 2^-9 of
// relative error into every term. Key tiles are 64 wide (32 at DP = 256).
//
// float32: CUDA cores. Thread (ty, tx) owns RT query rows and, in the score
// tile, keys tx + 16*j; each step of the score loop loads RT + BN/16 float4s
// from shared memory for 4*RT*BN/16 FMAs. At DP = 64, RT = 8 and 128
// threads: 32 scores a thread, 128 FMAs per 12 loads (the first design made
// 64 per 8). P goes through shared memory; in P V the thread owns output
// columns 4*tx + 64*g, read from V as float4 (4*RT FMAs per load, where the
// first design read V as scalars). DP = 128 and 256 take RT = 4 (256
// threads), which keeps their accumulators in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;  // query rows per block
constexpr unsigned kAll = 0xffffffffu;

// Element strides of the b, h and t axes of one operand (d's is 1).
struct Strides {
  long long b, h, t;
};

struct Params {
  const void *q, *k, *v;
  void *o;
  float *lse;
  Strides sq, sk, sv, so;
  int h, bh_count, t, d;
  float sqrt_d, c;  // c = log2(e) / sqrt(d)
  int causal, vec_in, vec_out;
};

__device__ __forceinline__ uint32_t smem_addr(const void *p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void *dst, const void *src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

template <typename E>
__device__ __forceinline__ E zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// Rows row0 .. row0+R-1 of a (t, d) matrix with row stride src_t into
// dst[r * PITCH + c], c < DP; zero past t and past d.
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kAll, x, 1));
  return fmaxf(x, __shfl_xor_sync(kAll, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kAll, x, 1);
  return x + __shfl_xor_sync(kAll, x, 2);
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

// --------------------------------------------------------------- bfloat16
using bf16 = __nv_bfloat16;

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

template <int DP, int BN>
struct Bf16Cfg {
  static constexpr int kThreads = 128;
  static constexpr int kPitch = DP + 8;  // bf16 elements; 16-byte row shift per row
  static constexpr int kSmem = (int)sizeof(bf16) * (kRows + 4 * BN) * kPitch;
};

template <int DP, int BN>
__global__ void __launch_bounds__(128) flash_fwd_bf16(const Params p) {
  using C = Bf16Cfg<DP, BN>;
  constexpr int P = C::kPitch;
  constexpr bool kQRegs = DP <= 128;
  constexpr int NT = BN / 8;  // n8 score tiles
  constexpr int KD = DP / 16; // k16 steps over d
  constexpr int ND = DP / 8;  // n8 output tiles
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 *const Qs = reinterpret_cast<bf16 *>(smem);
  bf16 *const Ks = Qs + kRows * P;
  bf16 *const Vs = Ks + 2 * BN * P;

  const int t = p.t, d = p.d;
  const int n_tiles = (t + kRows - 1) / kRows;
  const int bh = blockIdx.x % p.bh_count;
  const int q0 = (n_tiles - 1 - (int)(blockIdx.x / p.bh_count)) * kRows;  // heaviest first
  const long long bi = bh / p.h, hi = bh % p.h;
  const bf16 *const q_bh = (const bf16 *)p.q + bi * p.sq.b + hi * p.sq.h;
  const bf16 *const k_bh = (const bf16 *)p.k + bi * p.sk.b + hi * p.sk.h;
  const bf16 *const v_bh = (const bf16 *)p.v + bi * p.sv.b + hi * p.sv.h;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int row_lo = q0 + warp * 16;  // this warp's first query row
  const int kt_end = p.causal ? (min(t, q0 + kRows) + BN - 1) / BN : (t + BN - 1) / BN;

  load_tile<bf16, kRows, DP, P, 128>(Qs, q_bh, p.sq.t, q0, t, d, p.vec_in);
  load_tile<bf16, BN, DP, P, 128>(Ks, k_bh, p.sk.t, 0, t, d, p.vec_in);
  load_tile<bf16, BN, DP, P, 128>(Vs, v_bh, p.sv.t, 0, t, d, p.vec_in);
  cp_commit();

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t qf[kQRegs ? KD : 1][4];

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the buffer refilled next is no longer read
    if (kt + 1 < kt_end) {
      const int nb = (kt + 1) & 1;
      load_tile<bf16, BN, DP, P, 128>(Ks + nb * BN * P, k_bh, p.sk.t, k0 + BN, t, d,
                                      p.vec_in);
      load_tile<bf16, BN, DP, P, 128>(Vs + nb * BN * P, v_bh, p.sv.t, k0 + BN, t, d,
                                      p.vec_in);
    }
    cp_commit();
    cp_wait1();
    __syncthreads();
    const bf16 *const Kb = Ks + (kt & 1) * BN * P;
    const bf16 *const Vb = Vs + (kt & 1) * BN * P;
    if (kQRegs && kt == 0) {
#pragma unroll
      for (int ks = 0; ks < (kQRegs ? KD : 1); ++ks)
        ldsm_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * P + ks * 16 + (lane >> 4) * 8);
    }

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      uint32_t a[4];
      if (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kQRegs ? ks : 0][e];
      } else {
        ldsm_x4(a, Qs + (warp * 16 + (lane & 15)) * P + ks * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        uint32_t kb[4];
        ldsm_x4(kb, Kb + (j2 * 16 + (lane & 7) + (lane >> 4) * 8) * P + ks * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * j2], a, kb[0], kb[1]);
        mma_bf16(s[2 * j2 + 1], a, kb[2], kb[3]);
      }
    }

    const bool masked = k0 + BN > t || (p.causal && k0 + BN - 1 > row_lo);
    if (masked) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k_pos = k0 + 8 * j + 2 * tq + (e & 1);
          const int q_pos = row_lo + g + 8 * (e >> 1);
          if (k_pos >= t || (p.causal && k_pos > q_pos)) s[j][e] = -INFINITY;
        }
    }

    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // no key yet: p = 0
      const float alpha = exp2f((m[r] - m_use[r]) * p.c);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f((s[j][e] - m_use[e >> 1]) * p.c);
        l[e >> 1] += s[j][e];
      }

#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, Vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + dp * 16 +
                          (lane >> 4) * 8);
        mma_bf16(o[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(o[2 * dp], pl, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * dp + 1], pl, vb[2], vb[3]);
      }
    }
  }

  bf16 *const o_bh = (bf16 *)p.o + bi * p.so.b + hi * p.so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    const int q_pos = row_lo + g + 8 * r;
    if (q_pos >= t) continue;
    if (p.lse != nullptr && tq == 0)
      p.lse[(long long)bh * t + q_pos] = m[r] / p.sqrt_d + logf(lr);
    bf16 *const row = o_bh + q_pos * p.so.t;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = 8 * j + 2 * tq;
      const float x0 = o[j][2 * r] / lr, x1 = o[j][2 * r + 1] / lr;
      if (p.vec_out && c + 1 < d) {
        *reinterpret_cast<__nv_bfloat162 *>(row + c) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < d) row[c] = __float2bfloat16_rn(x0);
        if (c + 1 < d) row[c + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// ---------------------------------------------------------------- float32
template <int DP, int BN, int RT>
struct F32Cfg {
  static constexpr int kThreads = kRows / RT * 16;
  static constexpr int kQK = DP + 4;  // row stride of Q and K
  static constexpr int kPS = BN + 4;  // row stride of P
  static constexpr int kSmem =
      (int)sizeof(float) * (kRows * kQK + 2 * BN * kQK + 2 * BN * DP + kRows * kPS);
};

__device__ __forceinline__ float lane_of(const float4 &a, int c) {
  return c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
}

template <int DP, int BN, int RT>
__global__ void __launch_bounds__(kRows / RT * 16, 1) flash_fwd_f32(const Params p) {
  using C = F32Cfg<DP, BN, RT>;
  constexpr int NT = C::kThreads, QK = C::kQK, PS = C::kPS;
  constexpr int KJ = BN / 16;  // keys per thread in the score tile
  constexpr int CG = DP / 64;  // float4 output column groups per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float *const Qs = reinterpret_cast<float *>(smem);
  float *const Ks = Qs + kRows * QK;
  float *const Vs = Ks + 2 * BN * QK;
  float *const Ps = Vs + 2 * BN * DP;

  const int t = p.t, d = p.d;
  const int n_tiles = (t + kRows - 1) / kRows;
  const int bh = blockIdx.x % p.bh_count;
  const int q0 = (n_tiles - 1 - (int)(blockIdx.x / p.bh_count)) * kRows;  // heaviest first
  const long long bi = bh / p.h, hi = bh % p.h;
  const float *const q_bh = (const float *)p.q + bi * p.sq.b + hi * p.sq.h;
  const float *const k_bh = (const float *)p.k + bi * p.sk.b + hi * p.sk.h;
  const float *const v_bh = (const float *)p.v + bi * p.sv.b + hi * p.sv.h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = q0 + RT * ty;  // this thread's first query row
  const int kt_end = p.causal ? (min(t, q0 + kRows) + BN - 1) / BN : (t + BN - 1) / BN;

  load_tile<float, kRows, DP, QK, NT>(Qs, q_bh, p.sq.t, q0, t, d, p.vec_in);
  load_tile<float, BN, DP, QK, NT>(Ks, k_bh, p.sk.t, 0, t, d, p.vec_in);
  load_tile<float, BN, DP, DP, NT>(Vs, v_bh, p.sv.t, 0, t, d, p.vec_in);
  cp_commit();

  float m[RT], l[RT], acc[RT][CG][4];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CG; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the refilled buffer and Ps are no longer read
    if (kt + 1 < kt_end) {
      const int nb = (kt + 1) & 1;
      load_tile<float, BN, DP, QK, NT>(Ks + nb * BN * QK, k_bh, p.sk.t, k0 + BN, t, d,
                                       p.vec_in);
      load_tile<float, BN, DP, DP, NT>(Vs + nb * BN * DP, v_bh, p.sv.t, k0 + BN, t, d,
                                       p.vec_in);
    }
    cp_commit();
    cp_wait1();
    __syncthreads();
    const float *const Kb = Ks + (kt & 1) * BN * QK;
    const float *const Vb = Vs + (kt & 1) * BN * DP;

    float s[RT][KJ];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 qa[RT], kb[KJ];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        qa[i] = *reinterpret_cast<const float4 *>(Qs + (RT * ty + i) * QK + c);
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kb[j] = *reinterpret_cast<const float4 *>(Kb + (tx + 16 * j) * QK + c);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    const bool masked = k0 + BN > t || (p.causal && k0 + BN - 1 > q0);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        if (masked) {
          const int k_pos = k0 + tx + 16 * j;
          if (k_pos >= t || (p.causal && k_pos > row0 + i)) s[i][j] = -INFINITY;
        }
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no key yet: p = 0
      const float alpha = exp2f((m[i] - m_use) * p.c);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        s[i][j] = exp2f((s[i][j] - m_use) * p.c);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + rs;  // this thread's part; summed over tx at the end
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CG; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
#pragma unroll
      for (int j = 0; j < KJ; ++j) Ps[(RT * ty + i) * PS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BN; c += 4) {
      float4 pa[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        pa[i] = *reinterpret_cast<const float4 *>(Ps + (RT * ty + i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float4 vv[CG];
#pragma unroll
        for (int g = 0; g < CG; ++g)
          vv[g] = *reinterpret_cast<const float4 *>(Vb + (c + cc) * DP + 4 * tx + 64 * g);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float pv = lane_of(pa[i], cc);
#pragma unroll
          for (int g = 0; g < CG; ++g) {
            acc[i][g][0] = fmaf(pv, vv[g].x, acc[i][g][0]);
            acc[i][g][1] = fmaf(pv, vv[g].y, acc[i][g][1]);
            acc[i][g][2] = fmaf(pv, vv[g].z, acc[i][g][2]);
            acc[i][g][3] = fmaf(pv, vv[g].w, acc[i][g][3]);
          }
        }
      }
    }
  }

  float *const o_bh = (float *)p.o + bi * p.so.b + hi * p.so.h;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float li = half_warp_sum(l[i]);
    const int q_pos = row0 + i;
    if (q_pos >= t) continue;
    if (p.lse != nullptr && tx == 0)
      p.lse[(long long)bh * t + q_pos] = m[i] / p.sqrt_d + logf(li);
    float *const row = o_bh + q_pos * p.so.t;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const int c = 4 * tx + 64 * g;
      const float4 x = make_float4(acc[i][g][0] / li, acc[i][g][1] / li, acc[i][g][2] / li,
                                   acc[i][g][3] / li);
      if (p.vec_out && c + 3 < d) {
        *reinterpret_cast<float4 *>(row + c) = x;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < d) row[c + e] = lane_of(x, e);
      }
    }
  }
}

// ------------------------------------------------------------------ launch
template <typename K>
int launch(K kernel, int threads, int smem, const Params &p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((p.t + kRows - 1) / kRows) * p.bh_count;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DP, int BN, int RT>
int run_f32(const Params &p, cudaStream_t s) {
  using C = F32Cfg<DP, BN, RT>;
  return launch(flash_fwd_f32<DP, BN, RT>, C::kThreads, C::kSmem, p, s);
}

template <int DP, int BN>
int run_bf16(const Params &p, cudaStream_t s) {
  using C = Bf16Cfg<DP, BN>;
  return launch(flash_fwd_bf16<DP, BN>, C::kThreads, C::kSmem, p, s);
}

bool aligned16(const void *ptr, const Strides &st, int esize) {
  return (uintptr_t)ptr % 16 == 0 && (st.b * esize) % 16 == 0 && (st.h * esize) % 16 == 0 &&
         (st.t * esize) % 16 == 0;
}

}  // namespace

// strides: the element strides of the b, h and t axes of q, k, v and o, in
// that order (12 values; the d axis is contiguous). lse: a float32 (b, h, t)
// contiguous buffer for the rows' log-sum-exp, or null (the serving path:
// nothing more is written). dtype 0 float32, 1 bfloat16. Returns a
// cudaError_t (0: launched).
extern "C" int flash_attn_fwd_launch(const void *q, const void *k, const void *v, void *o,
                                     void *lse, const long long *strides, int b, int h,
                                     int t, int d, int dtype, int causal, void *stream) {
  if (b <= 0 || h <= 0 || t <= 0) return 0;
  if (d < 1 || d > 256 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  Params p{};
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int esize = dtype == 0 ? 4 : 2;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = (float *)lse;
  p.sq = st[0];
  p.sk = st[1];
  p.sv = st[2];
  p.so = st[3];
  p.h = h;
  p.bh_count = b * h;
  p.t = t;
  p.d = d;
  p.sqrt_d = sqrtf((float)d);
  p.c = (float)(1.4426950408889634 / sqrt((double)d));
  p.causal = causal;
  p.vec_in = aligned16(q, st[0], esize) && aligned16(k, st[1], esize) &&
             aligned16(v, st[2], esize);
  p.vec_out = aligned16(o, st[3], esize);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (d <= 64) return run_f32<64, 64, 8>(p, s);
    if (d <= 128) return run_f32<128, 64, 4>(p, s);
    return run_f32<256, 32, 4>(p, s);
  }
  if (d <= 64) return run_bf16<64, 64>(p, s);
  if (d <= 128) return run_bf16<128, 64>(p, s);
  return run_bf16<256, 32>(p, s);
}
