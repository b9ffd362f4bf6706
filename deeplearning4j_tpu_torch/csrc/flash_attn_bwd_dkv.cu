// flash_attn_bwd_dkv: the dK/dV kernel of the backward of tiled
// self-attention (the dQ kernel is flash_attn_bwd_dq.cu).
//
// Given q, k, v, the upstream gradient dO, each row's log-sum-exp L (written
// by flash_attn_fwd.cu) and D = rowsum(dO * O) (computed by the wrapper):
//
//   s = 1 / sqrt(d);   P = exp(s q k^T - L)   (0 where masked)
//   dV = P^T dO;   dS = P * (dO v^T - D);   dK = s dS^T q
//
// q, k, v, dO and the outputs dk, dv are (b, h, t, d) tensors of one type,
// float32 or bfloat16, whose last axis is contiguous; the b, h and t axes go
// by the strides passed in, so the head-split views of the projections, and
// the transposed dO that autograd hands back, are read and written in place.
// L and D are float32 (b, h, t) contiguous. Every sum is float32; dk and dv
// are rounded once, to the inputs' type.
//
// Replaces the TPU kernel _flash_attention_bwd_dkv (jax/experimental/pallas/
// ops/tpu/flash_attention.py:941, pallas_call :1121) of JAX's library flash
// attention, which deeplearning4j_tpu/parallel/ring_attention.py::
// flash_self_attention reaches. There a sequential grid axis walks the query
// blocks and carries dK and dV in VMEM scratch; here each block walks them
// in a loop, with dK and dV in registers.
//
// Bound on an H100 SXM: the operations. Four products of t x t x d per
// (b, h) (S, dP, P^T dO, dS^T Q), 2 operations per multiply-add, about half
// when causal: at (8, 12, 1024, 64) causal 25.8 GFLOP, 26 us on the bf16
// tensor cores (989 TFLOP/s), 385 us on the CUDA cores in float32
// (67 TFLOP/s; the port keeps float32 in full float32, no TF32).
//
// Common to both types (the first design, flash_attn_bwd_v1.cu, staged
// everything as float32 and ran all four products on CUDA cores at one
// shared-memory load per 2-4 FMAs, bf16 included):
// - One block per (b*h, tile of key rows, block of output columns); key
//   tile 0, which has the most query tiles when causal, is scheduled first.
//   K and V are copied into shared memory once. The query tiles (Q, dO, L
//   and D) stream through two buffers by cp.async, the next tile in flight
//   while the current one is used (float32 at d <= 64: one buffer, below):
//   all tiles, or when causal from the one that holds the block's first key
//   onward. Operands whose base or strides
//   are not 16-byte aligned are copied element by element. Zero past t and
//   past d.
// - Masks: keys past the diagonal (causal), keys or queries at or past t
//   give p = 0 exactly.
// - dK is scaled by s once, at the end. Offsets are 64-bit. No atomics and
//   no state across blocks: every output element is written by one thread
//   after a fixed order of operations, so two launches agree bitwise.
//
// bfloat16: tensor cores (mma.sync m16n8k16, bf16 in, float32 sums), the
// FlashAttention-2 dK/dV shape. Four warps, each owning 16 of the block's 64
// key rows. S^T = K Q^T and dP^T = V dO^T are exact products of the bf16
// inputs with float32 sums; K's and V's fragments come by ldmatrix (kept in
// registers at d <= 64), Q's and dO's by ldmatrix. P^T = exp2(S^T c -
// L log2(e)), c = log2(e)/sqrt(d), and dS^T = P^T (dP^T - D) are formed on
// the accumulator fragments, which then serve as the A operands of dV +=
// P^T dO and dK += dS^T Q straight from registers; dO and Q enter those as B
// operands by ldmatrix.trans. P and dS are split into hi = bf16(x) and lo =
// bf16(x - hi) and both products are issued, so they keep about 2^-17 of
// their precision: rounding them to bf16 alone would put 2^-9 of relative
// error into every term (flash_attn_fwd.cu splits P the same way). At
// d = 128 the query tile is 32 rows, for registers; at d = 256 a block
// owns 128 of the output columns (two blocks per key tile, each
// recomputing S and dP over the whole d).
//
// float32: CUDA cores, 256 threads. Thread (ty, tx) = (tid / 16, tid % 16)
// owns RI = BK/16 key rows and, in the BK x BQ score tile, the queries
// tx + 16j, as the first design; each step of those dot products loads
// RI + CJ float4s for 4*RI*CJ FMAs. P and dS go to shared memory together;
// dV and dK accumulate in one loop in which the thread owns the output
// columns 4*tx + 64*g, read from dO and Q as float4s: 2*RI*4*CG FMAs per
// 2*CG loads (the first design read them as scalars, one per RI FMAs). The
// scores and both sums take the first design's arithmetic and order. At
// d <= 64 the query tiles are loaded in turn into one buffer (105 KB of
// shared memory, so two blocks share an SM and one computes while the other
// loads): 0.89 ms at (8, 12, 1024, 64) causal against 1.06 ms with two
// buffers and one block an SM. At d = 128 one block fills an SM either way
// and two buffers win: 10.96 ms at (4, 8, 4096, 128) causal against 11.99
// (tools/kernel_variants.py, H100 SXM, 700 W). One score tile is live at a
// time (dS is formed from the P the thread wrote to shared memory), so the
// d <= 64 kernel fits in the 128 registers two blocks an SM allow.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dk, *dv;
  Strides sq, sk, sv, sdo, sdk, sdv;
  int h, bh_count, t, d;
  float sqrt_d, c;  // c = log2(e) / sqrt(d)
  int causal, vec_in, vec_out;
};

// One query tile's Q, dO, L and D into buffer `buf`.
template <typename E, int BQ, int DP, int PITCH, int NT>
__device__ __forceinline__ void load_query_tile(E *Qs, E *Os, float *Ls, float *Ds, int buf,
                                                const E *q_bh, const E *do_bh,
                                                const float *l_bh, const float *d_bh,
                                                const Params &p, int q0) {
  load_tile<E, BQ, DP, PITCH, NT>(Qs + buf * BQ * PITCH, q_bh, p.sq.t, q0, p.t, p.d, p.vec_in);
  load_tile<E, BQ, DP, PITCH, NT>(Os + buf * BQ * PITCH, do_bh, p.sdo.t, q0, p.t, p.d,
                                  p.vec_in);
  load_rows<BQ, NT>(Ls + buf * BQ, l_bh, q0, p.t);
  load_rows<BQ, NT>(Ds + buf * BQ, d_bh, q0, p.t);
}

// --------------------------------------------------------------- bfloat16
constexpr int kKeysBf16 = 64;  // key rows per block: four warps of 16

template <int DP, int DC, int BQ>
struct Bf16Cfg {
  static constexpr int kThreads = 128;
  static constexpr int kPitch = DP + 8;  // bf16 elements; 16-byte row shift per row
  static constexpr int kColBlocks = DP / DC;
  static constexpr int kSmem =
      (int)sizeof(bf16) * (2 * kKeysBf16 + 4 * BQ) * kPitch + (int)sizeof(float) * 4 * BQ;
};

// DP: padded head dim; DC: output columns per block; BQ: query tile rows.
template <int DP, int DC, int BQ>
__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16(const Params p) {
  using C = Bf16Cfg<DP, DC, BQ>;
  constexpr int P = C::kPitch, BK = kKeysBf16;
  constexpr bool kKVRegs = DP <= 64;
  constexpr int KD = DP / 16;  // k16 steps over d (S, dP)
  constexpr int NQ = BQ / 8;   // n8 tiles over the query tile (S, dP)
  constexpr int KQ = BQ / 16;  // k16 steps over the query tile (dV, dK)
  constexpr int NC = DC / 8;   // n8 tiles over the block's output columns
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 *const Ks = reinterpret_cast<bf16 *>(smem);
  bf16 *const Vs = Ks + BK * P;
  bf16 *const Qs = Vs + BK * P;      // two buffers of BQ rows
  bf16 *const Os = Qs + 2 * BQ * P;  // dO, two buffers
  float *const Ls = reinterpret_cast<float *>(Os + 2 * BQ * P);
  float *const Ds = Ls + 2 * BQ;

  const int t = p.t, d = p.d;
  const int bh = blockIdx.x % p.bh_count;
  const int rest = blockIdx.x / p.bh_count;  // key tile 0 first: the most work when causal
  const int k0 = rest / C::kColBlocks * BK, col0 = rest % C::kColBlocks * DC;
  const long long bi = bh / p.h, hi = bh % p.h;
  const bf16 *const q_bh = (const bf16 *)p.q + bi * p.sq.b + hi * p.sq.h;
  const bf16 *const do_bh = (const bf16 *)p.dout + bi * p.sdo.b + hi * p.sdo.h;
  const float *const l_bh = p.lse + (long long)bh * t;
  const float *const d_bh = p.delta + (long long)bh * t;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int key_lo = k0 + warp * 16;  // this warp's first key row
  const int qt0 = p.causal ? k0 / BQ : 0, n_qt = (t + BQ - 1) / BQ;

  load_tile<bf16, BK, DP, P, 128>(Ks, (const bf16 *)p.k + bi * p.sk.b + hi * p.sk.h, p.sk.t,
                                  k0, t, d, p.vec_in);
  load_tile<bf16, BK, DP, P, 128>(Vs, (const bf16 *)p.v + bi * p.sv.b + hi * p.sv.h, p.sv.t,
                                  k0, t, d, p.vec_in);
  load_query_tile<bf16, BQ, DP, P, 128>(Qs, Os, Ls, Ds, 0, q_bh, do_bh, l_bh, d_bh, p, qt0 * BQ);
  cp_commit();

  float dk[NC][4], dv[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  uint32_t kf[kKVRegs ? KD : 1][4], vf[kKVRegs ? KD : 1][4];

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ, buf = (qt - qt0) & 1;
    __syncthreads();  // the buffer refilled next is no longer read
    if (qt + 1 < n_qt)
      load_query_tile<bf16, BQ, DP, P, 128>(Qs, Os, Ls, Ds, buf ^ 1, q_bh, do_bh, l_bh, d_bh, p,
                                            q0 + BQ);
    cp_commit();
    cp_wait1();
    __syncthreads();
    if (kKVRegs && qt == qt0) {
#pragma unroll
      for (int ks = 0; ks < (kKVRegs ? KD : 1); ++ks) {
        ldsm_x4(kf[ks], Ks + (warp * 16 + (lane & 15)) * P + ks * 16 + (lane >> 4) * 8);
        ldsm_x4(vf[ks], Vs + (warp * 16 + (lane & 15)) * P + ks * 16 + (lane >> 4) * 8);
      }
    }
    // this warp's keys all past t, or (causal) all past the tile's queries
    if (key_lo >= t || (p.causal && key_lo > q0 + BQ - 1)) continue;
    const bf16 *const Qb = Qs + buf * BQ * P;
    const bf16 *const Ob = Os + buf * BQ * P;
    const float *const Lb = Ls + buf * BQ;
    const float *const Db = Ds + buf * BQ;

    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      uint32_t ak[4], av[4];
      if (kKVRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ak[e] = kf[kKVRegs ? ks : 0][e];
          av[e] = vf[kKVRegs ? ks : 0][e];
        }
      } else {
        ldsm_x4(ak, Ks + (warp * 16 + (lane & 15)) * P + ks * 16 + (lane >> 4) * 8);
        ldsm_x4(av, Vs + (warp * 16 + (lane & 15)) * P + ks * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int j2 = 0; j2 < NQ / 2; ++j2) {
        const int off = (j2 * 16 + (lane & 7) + (lane >> 4) * 8) * P + ks * 16 +
                        ((lane >> 3) & 1) * 8;
        uint32_t qb[4], ob[4];
        ldsm_x4(qb, Qb + off);
        mma_bf16(s[2 * j2], ak, qb[0], qb[1]);
        mma_bf16(s[2 * j2 + 1], ak, qb[2], qb[3]);
        ldsm_x4(ob, Ob + off);
        mma_bf16(dp[2 * j2], av, ob[0], ob[1]);
        mma_bf16(dp[2 * j2 + 1], av, ob[2], ob[3]);
      }
    }

    // P^T into s, dS^T into dp: element (j, e) is key key_lo + g + 8(e/2),
    // query q0 + 8j + 2tq + e%2
    const bool masked = q0 + BQ > t || key_lo + 15 >= t || (p.causal && key_lo + 15 > q0);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * tq + (e & 1);
        float pv = exp2f(fmaf(s[j][e], p.c, -Lb[qi] * kLog2e));
        if (masked) {
          const int k_pos = key_lo + g + 8 * (e >> 1), q_pos = q0 + qi;
          if (q_pos >= t || k_pos >= t || (p.causal && k_pos > q_pos)) pv = 0.f;
        }
        s[j][e] = pv;
        dp[j][e] = pv * (dp[j][e] - Db[qi]);
      }

    // dV += P^T dO and dK += dS^T Q, each of P and dS as hi + lo
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      a_split(s, kk, ph, pl);
      a_split(dp, kk, sh, sl);
#pragma unroll
      for (int c2 = 0; c2 < NC / 2; ++c2) {
        const int off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + col0 + c2 * 16 +
                        (lane >> 4) * 8;
        uint32_t ob[4], qb[4];
        ldsm_x4_t(ob, Ob + off);
        mma_bf16(dv[2 * c2], ph, ob[0], ob[1]);
        mma_bf16(dv[2 * c2], pl, ob[0], ob[1]);
        mma_bf16(dv[2 * c2 + 1], ph, ob[2], ob[3]);
        mma_bf16(dv[2 * c2 + 1], pl, ob[2], ob[3]);
        ldsm_x4_t(qb, Qb + off);
        mma_bf16(dk[2 * c2], sh, qb[0], qb[1]);
        mma_bf16(dk[2 * c2], sl, qb[0], qb[1]);
        mma_bf16(dk[2 * c2 + 1], sh, qb[2], qb[3]);
        mma_bf16(dk[2 * c2 + 1], sl, qb[2], qb[3]);
      }
    }
  }

  bf16 *const dk_bh = (bf16 *)p.dk + bi * p.sdk.b + hi * p.sdk.h;
  bf16 *const dv_bh = (bf16 *)p.dv + bi * p.sdv.b + hi * p.sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k_pos = key_lo + g + 8 * r;
    if (k_pos >= t) continue;
    bf16 *const krow = dk_bh + k_pos * p.sdk.t;
    bf16 *const vrow = dv_bh + k_pos * p.sdv.t;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = col0 + 8 * j + 2 * tq;
      const float k0v = dk[j][2 * r] / p.sqrt_d, k1v = dk[j][2 * r + 1] / p.sqrt_d;
      const float v0 = dv[j][2 * r], v1 = dv[j][2 * r + 1];
      if (p.vec_out && c + 1 < d) {
        *reinterpret_cast<__nv_bfloat162 *>(krow + c) = __floats2bfloat162_rn(k0v, k1v);
        *reinterpret_cast<__nv_bfloat162 *>(vrow + c) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (c < d) {
          krow[c] = __float2bfloat16_rn(k0v);
          vrow[c] = __float2bfloat16_rn(v0);
        }
        if (c + 1 < d) {
          krow[c + 1] = __float2bfloat16_rn(k1v);
          vrow[c + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- float32
// NB: buffers of the query tiles (2: the next tile in flight while one is
// used; 1: loaded in turn, for a smaller block)
template <int DP, int BK, int BQ, int NB>
struct F32Cfg {
  static constexpr int kThreads = 256;
  static constexpr int kS = DP + 4;  // row stride of K, V, Q and dO
  static constexpr int kP = BQ + 4;  // row stride of P and dS (key, query)
  static constexpr int kSmem =
      (int)sizeof(float) * (2 * BK * kS + 2 * NB * BQ * kS + 2 * BK * kP + 2 * NB * BQ);
};

__device__ __forceinline__ float lane_of(const float4 &a, int c) {
  return c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
}

// acc[i][j] = sum_c A[(RI*ty + i) * S + c] * B[(tx + 16*j) * S + c]
template <int DP, int S, int RI, int CJ>
__device__ __forceinline__ void tile_dot(float (&acc)[RI][CJ], const float *A, const float *B,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < DP; c += 4) {
    float4 a[RI], b[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = *reinterpret_cast<const float4 *>(A + (RI * ty + i) * S + c);
#pragma unroll
    for (int j = 0; j < CJ; ++j) b[j] = *reinterpret_cast<const float4 *>(B + (tx + 16 * j) * S + c);
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

template <int DP, int BK, int BQ, int NB>
__global__ void __launch_bounds__(256, 3 - NB) flash_bwd_dkv_f32(const Params p) {
  using C = F32Cfg<DP, BK, BQ, NB>;
  constexpr int S = C::kS, PS = C::kP;
  constexpr int RI = BK / 16;  // key rows per thread
  constexpr int CJ = BQ / 16;  // queries per thread in the score tile
  constexpr int CG = DP / 64;  // float4 output column groups per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float *const Ks = reinterpret_cast<float *>(smem);
  float *const Vs = Ks + BK * S;
  float *const Qs = Vs + BK * S;       // NB buffers of BQ rows
  float *const Os = Qs + NB * BQ * S;  // dO, NB buffers
  float *const Ps = Os + NB * BQ * S;  // P: (key, query)
  float *const Ss = Ps + BK * PS;      // dS: (key, query)
  float *const Ls = Ss + BK * PS;      // NB buffers of BQ
  float *const Ds = Ls + NB * BQ;

  const int t = p.t, d = p.d;
  const int bh = blockIdx.x % p.bh_count;
  const int k0 = (int)(blockIdx.x / p.bh_count) * BK;  // key tile 0 first
  const long long bi = bh / p.h, hi = bh % p.h;
  const float *const q_bh = (const float *)p.q + bi * p.sq.b + hi * p.sq.h;
  const float *const do_bh = (const float *)p.dout + bi * p.sdo.b + hi * p.sdo.h;
  const float *const l_bh = p.lse + (long long)bh * t;
  const float *const d_bh = p.delta + (long long)bh * t;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt0 = p.causal ? k0 / BQ : 0, n_qt = (t + BQ - 1) / BQ;

  load_tile<float, BK, DP, S, 256>(Ks, (const float *)p.k + bi * p.sk.b + hi * p.sk.h, p.sk.t,
                                   k0, t, d, p.vec_in);
  load_tile<float, BK, DP, S, 256>(Vs, (const float *)p.v + bi * p.sv.b + hi * p.sv.h, p.sv.t,
                                   k0, t, d, p.vec_in);
  load_query_tile<float, BQ, DP, S, 256>(Qs, Os, Ls, Ds, 0, q_bh, do_bh, l_bh, d_bh, p,
                                         qt0 * BQ);
  cp_commit();

  float acc_dk[RI][CG][4], acc_dv[RI][CG][4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int g = 0; g < CG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_dk[i][g][e] = acc_dv[i][g][e] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ, buf = NB == 2 ? (qt - qt0) & 1 : 0;
    __syncthreads();  // the refilled buffer, Ps and Ss are no longer read
    if (NB == 2) {
      if (qt + 1 < n_qt)
        load_query_tile<float, BQ, DP, S, 256>(Qs, Os, Ls, Ds, buf ^ 1, q_bh, do_bh, l_bh,
                                               d_bh, p, q0 + BQ);
      cp_commit();
      cp_wait1();
    } else {
      if (qt > qt0)
        load_query_tile<float, BQ, DP, S, 256>(Qs, Os, Ls, Ds, 0, q_bh, do_bh, l_bh, d_bh, p,
                                               q0);
      cp_commit();
      cp_wait0();
    }
    __syncthreads();
    const float *const Qb = Qs + buf * BQ * S;
    const float *const Ob = Os + buf * BQ * S;
    const float *const Lb = Ls + buf * BQ;
    const float *const Db = Ds + buf * BQ;

    // P, then dS from the P this thread wrote (one score tile live at a time)
    float x[RI][CJ];
    tile_dot<DP, S, RI, CJ>(x, Ks, Qb, ty, tx);  // x[i][j] = k_r . q_c
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int k_pos = k0 + RI * ty + i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 16 * j, q_pos = q0 + c;
        const bool keep = q_pos < t && k_pos < t && !(p.causal && k_pos > q_pos);
        Ps[(RI * ty + i) * PS + c] = keep ? expf(x[i][j] / p.sqrt_d - Lb[c]) : 0.f;
      }
    }
    tile_dot<DP, S, RI, CJ>(x, Vs, Ob, ty, tx);  // x[i][j] = v_r . dO_c
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int at = (RI * ty + i) * PS + tx + 16 * j;
        Ss[at] = Ps[at] * (x[i][j] - Db[tx + 16 * j]);
      }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q (scaled at the end), queries in order
#pragma unroll 1
    for (int c = 0; c < BQ; c += 4) {
      float4 pa[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        pa[i] = *reinterpret_cast<const float4 *>(Ps + (RI * ty + i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float4 o4[CG];
#pragma unroll
        for (int g = 0; g < CG; ++g)
          o4[g] = *reinterpret_cast<const float4 *>(Ob + (c + cc) * S + 4 * tx + 64 * g);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float pv = lane_of(pa[i], cc);
#pragma unroll
          for (int g = 0; g < CG; ++g) {
            acc_dv[i][g][0] = fmaf(pv, o4[g].x, acc_dv[i][g][0]);
            acc_dv[i][g][1] = fmaf(pv, o4[g].y, acc_dv[i][g][1]);
            acc_dv[i][g][2] = fmaf(pv, o4[g].z, acc_dv[i][g][2]);
            acc_dv[i][g][3] = fmaf(pv, o4[g].w, acc_dv[i][g][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
        pa[i] = *reinterpret_cast<const float4 *>(Ss + (RI * ty + i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float4 q4[CG];
#pragma unroll
        for (int g = 0; g < CG; ++g)
          q4[g] = *reinterpret_cast<const float4 *>(Qb + (c + cc) * S + 4 * tx + 64 * g);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float sv = lane_of(pa[i], cc);
#pragma unroll
          for (int g = 0; g < CG; ++g) {
            acc_dk[i][g][0] = fmaf(sv, q4[g].x, acc_dk[i][g][0]);
            acc_dk[i][g][1] = fmaf(sv, q4[g].y, acc_dk[i][g][1]);
            acc_dk[i][g][2] = fmaf(sv, q4[g].z, acc_dk[i][g][2]);
            acc_dk[i][g][3] = fmaf(sv, q4[g].w, acc_dk[i][g][3]);
          }
        }
      }
    }
  }

  float *const dk_bh = (float *)p.dk + bi * p.sdk.b + hi * p.sdk.h;
  float *const dv_bh = (float *)p.dv + bi * p.sdv.b + hi * p.sdv.h;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int k_pos = k0 + RI * ty + i;
    if (k_pos >= t) continue;
    float *const krow = dk_bh + k_pos * p.sdk.t;
    float *const vrow = dv_bh + k_pos * p.sdv.t;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const int c = 4 * tx + 64 * g;
      const float4 kx = make_float4(acc_dk[i][g][0] / p.sqrt_d, acc_dk[i][g][1] / p.sqrt_d,
                                    acc_dk[i][g][2] / p.sqrt_d, acc_dk[i][g][3] / p.sqrt_d);
      const float4 vx = make_float4(acc_dv[i][g][0], acc_dv[i][g][1], acc_dv[i][g][2],
                                    acc_dv[i][g][3]);
      if (p.vec_out && c + 3 < d) {
        *reinterpret_cast<float4 *>(krow + c) = kx;
        *reinterpret_cast<float4 *>(vrow + c) = vx;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < d) {
            krow[c + e] = lane_of(kx, e);
            vrow[c + e] = lane_of(vx, e);
          }
      }
    }
  }
}

// ------------------------------------------------------------------ launch
template <typename K>
int launch(K kernel, int threads, int smem, int tiles, const Params &p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)tiles * p.bh_count;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DP, int BK, int BQ, int NB>
int run_f32(const Params &p, cudaStream_t s) {
  using C = F32Cfg<DP, BK, BQ, NB>;
  return launch(flash_bwd_dkv_f32<DP, BK, BQ, NB>, C::kThreads, C::kSmem, (p.t + BK - 1) / BK,
                p, s);
}

template <int DP, int DC, int BQ>
int run_bf16(const Params &p, cudaStream_t s) {
  using C = Bf16Cfg<DP, DC, BQ>;
  const int tiles = (p.t + kKeysBf16 - 1) / kKeysBf16 * C::kColBlocks;
  return launch(flash_bwd_dkv_bf16<DP, DC, BQ>, C::kThreads, C::kSmem, tiles, p, s);
}

bool aligned(const void *ptr, const Strides &st, int esize, int to) {
  return (uintptr_t)ptr % to == 0 && (st.b * esize) % to == 0 && (st.h * esize) % to == 0 &&
         (st.t * esize) % to == 0;
}

}  // namespace

// strides: the element strides of the b, h and t axes of q, k, v, dO, dk and
// dv, in that order (18 values; the d axes are contiguous). lse and delta:
// float32 (b, h, t) contiguous. dtype 0 float32, 1 bfloat16. Returns a
// cudaError_t (0: launched).
extern "C" int flash_attn_bwd_dkv_launch(const void *q, const void *k, const void *v,
                                         const void *dout, const void *lse, const void *delta,
                                         void *dk, void *dv, const long long *strides, int b,
                                         int h, int t, int d, int dtype, int causal,
                                         void *stream) {
  if (b <= 0 || h <= 0 || t <= 0) return 0;
  if (d < 1 || d > 256 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  Strides st[6];
  for (int i = 0; i < 6; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int esize = dtype == 0 ? 4 : 2;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = (const float *)lse;
  p.delta = (const float *)delta;
  p.dk = dk;
  p.dv = dv;
  p.sq = st[0];
  p.sk = st[1];
  p.sv = st[2];
  p.sdo = st[3];
  p.sdk = st[4];
  p.sdv = st[5];
  p.h = h;
  p.bh_count = b * h;
  p.t = t;
  p.d = d;
  p.sqrt_d = sqrtf((float)d);
  p.c = (float)(1.4426950408889634 / sqrt((double)d));
  p.causal = causal;
  p.vec_in = aligned(q, st[0], esize, 16) && aligned(k, st[1], esize, 16) &&
             aligned(v, st[2], esize, 16) && aligned(dout, st[3], esize, 16);
  // float32 stores float4s, bf16 bf16 pairs
  const int out_to = dtype == 0 ? 16 : 4;
  p.vec_out = aligned(dk, st[4], esize, out_to) && aligned(dv, st[5], esize, out_to);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (d <= 64) return run_f32<64, 64, 64, 1>(p, s);
    if (d <= 128) return run_f32<128, 64, 32, 2>(p, s);
    return run_f32<256, 32, 32, 2>(p, s);
  }
  if (d <= 64) return run_bf16<64, 64, 64>(p, s);
  if (d <= 128) return run_bf16<128, 128, 32>(p, s);
  return run_bf16<256, 128, 32>(p, s);
}
