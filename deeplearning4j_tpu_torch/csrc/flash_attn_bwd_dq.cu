// flash_attn_bwd_dq: the dQ kernel of the backward of tiled self-attention
// (the dK/dV kernel is flash_attn_bwd_dkv.cu).
//
// Given q, k, v, the upstream gradient dO, each row's log-sum-exp L (written
// by flash_attn_fwd.cu) and D = rowsum(dO * O) (computed by the wrapper):
//
//   s = 1 / sqrt(d);   P = exp(s q k^T - L)   (0 where masked)
//   dS = P * (dO v^T - D);   dQ = s dS k
//
// q, k, v, dO and the output dq are (b, h, t, d) tensors of one type,
// float32 or bfloat16, whose last axis is contiguous; the b, h and t axes go
// by the strides passed in, so the head-split views of the projections, and
// the transposed dO that autograd hands back, are read and written in place.
// L and D are float32 (b, h, t) contiguous. Every sum is float32; dq is
// rounded once, to the inputs' type.
//
// Replaces the TPU kernel _flash_attention_bwd_dq (jax/experimental/pallas/
// ops/tpu/flash_attention.py:1287, pallas_call :1456) of JAX's library flash
// attention, which deeplearning4j_tpu/parallel/ring_attention.py::
// flash_self_attention reaches. There a sequential grid axis walks the key
// blocks and carries dQ in VMEM scratch; here each block walks them in a
// loop, with dQ in registers.
//
// Bound on an H100 SXM: the operations. Three products of t x t x d per
// (b, h) (S, dP, dS K), 2 operations per multiply-add, about half when
// causal: at (8, 12, 1024, 64) causal 19.4 GFLOP, 20 us on the bf16 tensor
// cores (989 TFLOP/s), 289 us on the CUDA cores in float32 (67 TFLOP/s; the
// port keeps float32 in full float32, no TF32).
//
// Common to both types (the first design, flash_attn_bwd_dq_v1.cu, staged
// everything as float32 with no overlap of copy and compute and ran all
// three products on CUDA cores at one shared-memory load per 2-4 FMAs, bf16
// included):
// - One block per (b*h, tile of query rows, block of output columns); the
//   query tiles with the most key tiles (the last, when causal) are
//   scheduled first. Q, dO, L and D are copied in once. The key tiles (K and
//   V) stream through shared memory by cp.async: all of them, or when
//   causal those up to the tile's last query. Operands whose base or
//   strides are not 16-byte aligned are copied element by element. Zero
//   past t and past d.
// - Masks: keys past the diagonal (causal), keys or queries at or past t
//   give p = 0 exactly.
// - dQ is scaled by s once, at the end. Offsets are 64-bit. No atomics and
//   no state across blocks: every output element is written by one thread
//   after a fixed order of operations, so two launches agree bitwise.
//
// bfloat16: tensor cores (mma.sync m16n8k16, bf16 in, float32 sums), the
// FlashAttention-2 dQ shape, the dK/dV kernel's recipe with the roles of
// queries and keys swapped. Four warps, each owning 16 of the block's 64
// query rows, and each row's L and D in registers. Q's and dO's fragments
// come by ldmatrix (kept in registers at d <= 64); the key tiles stream
// through two buffers, the next in flight while the current one is used.
// S = Q K^T and dP = dO V^T are exact products of the bf16 inputs with
// float32 sums (K and V enter as B operands by ldmatrix). P = exp2(S c -
// L log2(e)), c = log2(e)/sqrt(d), and dS = P (dP - D) are formed on the
// accumulator fragments, which then serve as the A operand of dQ += dS K
// straight from registers; K enters that as the B operand by
// ldmatrix.trans. dS is split into hi = bf16(dS) and lo = bf16(dS - hi) and
// both products are issued, so it keeps about 2^-17 of its precision
// (emulated on the CPU, tests/test_torch_flash_attention_bwd.py, dS rounded
// to bf16 alone puts dQ at 1.2-1.8 times the card's limit, hi + lo at
// 0.22-0.23). The key tile is 32 rows: 133.8 us at (8, 12, 1024, 64) causal
// against 167.5 with 64 rows (fewer registers, more blocks an SM) and 142.8
// with 16 (tools/kernel_variants.py, H100 SXM, 700 W). At d = 256 a block
// also owns 128 of the output columns (two blocks per query tile, each
// recomputing S and dP over the whole d).
//
// float32: CUDA cores, 256 threads. Thread (ty, tx) = (tid / 16, tid % 16)
// owns RI = BQ/16 query rows and, in the BQ x BK score tile, the keys
// tx + 16j, as the first design; each step of those dot products loads
// RI + CJ float4s for 4*RI*CJ FMAs. P goes to shared memory and is
// overwritten there by dS, each thread reading back its own elements (one
// score tile live at a time). dQ accumulates in a loop in which the thread
// owns the output columns 4*tx + 64*g, read from K as float4s: RI*4*CG FMAs
// per CG loads of K (the first design read K as scalars, one per RI FMAs).
// The scores and the sums take the first design's arithmetic and order.
// At d <= 64 the key tiles are loaded in turn into one buffer (86 KB of
// shared memory, so two blocks share an SM and one computes while the
// other loads): 731 us at (8, 12, 1024, 64) causal against 904 with two
// buffers and 851 with 32-key tiles. At d >= 128 one block fills an SM
// either way and the key tiles stream through two buffers.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq;
  Strides sq, sk, sv, sdo, sdq;
  int h, bh_count, t, d;
  float sqrt_d, c;  // c = log2(e) / sqrt(d)
  int causal, vec_in, vec_out;
};

// One key tile's K and V into buffer `buf`.
template <typename E, int BK, int DP, int PITCH, int NT>
__device__ __forceinline__ void load_key_tile(E *Ks, E *Vs, int buf, const E *k_bh,
                                              const E *v_bh, const Params &p, int k0) {
  load_tile<E, BK, DP, PITCH, NT>(Ks + buf * BK * PITCH, k_bh, p.sk.t, k0, p.t, p.d, p.vec_in);
  load_tile<E, BK, DP, PITCH, NT>(Vs + buf * BK * PITCH, v_bh, p.sv.t, k0, p.t, p.d, p.vec_in);
}

// Key tiles a query tile q0 .. q0+BQ-1 walks: all, or when causal those up
// to its last query.
__device__ __forceinline__ int key_tiles(const Params &p, int q0, int BQ, int BK) {
  const int last = p.causal ? min(q0 + BQ, p.t) - 1 : p.t - 1;
  return last / BK + 1;
}

// --------------------------------------------------------------- bfloat16
constexpr int kQueriesBf16 = 64;  // query rows per block: four warps of 16

template <int DP, int DC, int BK>
struct Bf16Cfg {
  static constexpr int kThreads = 128;
  static constexpr int kPitch = DP + 8;  // bf16 elements; 16-byte row shift per row
  static constexpr int kColBlocks = DP / DC;
  static constexpr int kSmem = (int)sizeof(bf16) * (2 * kQueriesBf16 + 4 * BK) * kPitch;
};

// DP: padded head dim; DC: output columns per block; BK: key tile rows.
template <int DP, int DC, int BK>
__global__ void __launch_bounds__(128) flash_bwd_dq_bf16(const Params p) {
  using C = Bf16Cfg<DP, DC, BK>;
  constexpr int P = C::kPitch, BQ = kQueriesBf16;
  constexpr bool kQORegs = DP <= 64;
  constexpr int KD = DP / 16;  // k16 steps over d (S, dP)
  constexpr int NK = BK / 8;   // n8 tiles over the key tile (S, dP)
  constexpr int KK = BK / 16;  // k16 steps over the key tile (dQ)
  constexpr int NC = DC / 8;   // n8 tiles over the block's output columns
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 *const Qs = reinterpret_cast<bf16 *>(smem);
  bf16 *const Os = Qs + BQ * P;  // dO
  bf16 *const Ks = Os + BQ * P;  // two buffers of BK rows
  bf16 *const Vs = Ks + 2 * BK * P;

  const int t = p.t, d = p.d;
  const int n_qt = (t + BQ - 1) / BQ;
  const int bh = blockIdx.x % p.bh_count;
  const int rest = blockIdx.x / p.bh_count;  // the last query tile first: the most work
  const int q0 = (n_qt - 1 - rest / C::kColBlocks) * BQ, col0 = rest % C::kColBlocks * DC;
  const long long bi = bh / p.h, hi = bh % p.h;
  const bf16 *const k_bh = (const bf16 *)p.k + bi * p.sk.b + hi * p.sk.h;
  const bf16 *const v_bh = (const bf16 *)p.v + bi * p.sv.b + hi * p.sv.h;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int q_lo = q0 + warp * 16;  // this warp's first query row
  const int n_kt = key_tiles(p, q0, BQ, BK);

  load_tile<bf16, BQ, DP, P, 128>(Qs, (const bf16 *)p.q + bi * p.sq.b + hi * p.sq.h, p.sq.t,
                                  q0, t, d, p.vec_in);
  load_tile<bf16, BQ, DP, P, 128>(Os, (const bf16 *)p.dout + bi * p.sdo.b + hi * p.sdo.h,
                                  p.sdo.t, q0, t, d, p.vec_in);
  load_key_tile<bf16, BK, DP, P, 128>(Ks, Vs, 0, k_bh, v_bh, p, 0);
  cp_commit();

  // L log2(e) and D of the thread's rows g and g + 8 (zero past t)
  float l2[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q_pos = q_lo + g + 8 * r;
    const bool ok = q_pos < t;
    l2[r] = ok ? p.lse[(long long)bh * t + q_pos] * kLog2e : 0.f;
    dr[r] = ok ? p.delta[(long long)bh * t + q_pos] : 0.f;
  }

  float dq[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  uint32_t qf[kQORegs ? KD : 1][4], of[kQORegs ? KD : 1][4];

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK, buf = kt & 1;
    __syncthreads();  // the buffer refilled next is no longer read
    if (kt + 1 < n_kt) load_key_tile<bf16, BK, DP, P, 128>(Ks, Vs, buf ^ 1, k_bh, v_bh, p, k0 + BK);
    cp_commit();
    cp_wait1();
    __syncthreads();
    if (kQORegs && kt == 0) {
#pragma unroll
      for (int ks = 0; ks < (kQORegs ? KD : 1); ++ks) {
        ldsm_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * P + ks * 16 + (lane >> 4) * 8);
        ldsm_x4(of[ks], Os + (warp * 16 + (lane & 15)) * P + ks * 16 + (lane >> 4) * 8);
      }
    }
    // this warp's queries all past t, or (causal) all before the tile's keys
    if (q_lo >= t || (p.causal && k0 > q_lo + 15)) continue;
    const bf16 *const Kb = Ks + buf * BK * P;
    const bf16 *const Vb = Vs + buf * BK * P;

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      uint32_t aq[4], ao[4];
      if (kQORegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          aq[e] = qf[kQORegs ? ks : 0][e];
          ao[e] = of[kQORegs ? ks : 0][e];
        }
      } else {
        ldsm_x4(aq, Qs + (warp * 16 + (lane & 15)) * P + ks * 16 + (lane >> 4) * 8);
        ldsm_x4(ao, Os + (warp * 16 + (lane & 15)) * P + ks * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int j2 = 0; j2 < NK / 2; ++j2) {
        const int off = (j2 * 16 + (lane & 7) + (lane >> 4) * 8) * P + ks * 16 +
                        ((lane >> 3) & 1) * 8;
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, Kb + off);
        mma_bf16(s[2 * j2], aq, kb[0], kb[1]);
        mma_bf16(s[2 * j2 + 1], aq, kb[2], kb[3]);
        ldsm_x4(vb, Vb + off);
        mma_bf16(dp[2 * j2], ao, vb[0], vb[1]);
        mma_bf16(dp[2 * j2 + 1], ao, vb[2], vb[3]);
      }
    }

    // dS into dp: element (j, e) is query q_lo + g + 8(e/2), key
    // k0 + 8j + 2tq + e%2
    const bool masked = q_lo + 15 >= t || k0 + BK > t || (p.causal && k0 + BK - 1 > q_lo);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv = exp2f(fmaf(s[j][e], p.c, -l2[e >> 1]));
        if (masked) {
          const int q_pos = q_lo + g + 8 * (e >> 1), k_pos = k0 + 8 * j + 2 * tq + (e & 1);
          if (q_pos >= t || k_pos >= t || (p.causal && k_pos > q_pos)) pv = 0.f;
        }
        dp[j][e] = pv * (dp[j][e] - dr[e >> 1]);
      }

    // dQ += dS K, dS as hi + lo
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t sh[4], sl[4];
      a_split(dp, kk, sh, sl);
#pragma unroll
      for (int c2 = 0; c2 < NC / 2; ++c2) {
        const int off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + col0 + c2 * 16 +
                        (lane >> 4) * 8;
        uint32_t kb[4];
        ldsm_x4_t(kb, Kb + off);
        mma_bf16(dq[2 * c2], sh, kb[0], kb[1]);
        mma_bf16(dq[2 * c2], sl, kb[0], kb[1]);
        mma_bf16(dq[2 * c2 + 1], sh, kb[2], kb[3]);
        mma_bf16(dq[2 * c2 + 1], sl, kb[2], kb[3]);
      }
    }
  }

  bf16 *const dq_bh = (bf16 *)p.dq + bi * p.sdq.b + hi * p.sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q_pos = q_lo + g + 8 * r;
    if (q_pos >= t) continue;
    bf16 *const row = dq_bh + q_pos * p.sdq.t;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = col0 + 8 * j + 2 * tq;
      const float x0 = dq[j][2 * r] / p.sqrt_d, x1 = dq[j][2 * r + 1] / p.sqrt_d;
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
// NB: buffers of the key tiles (2: the next tile in flight while one is
// used; 1: loaded in turn, for a smaller block)
template <int DP, int BQ, int BK, int NB>
struct F32Cfg {
  static constexpr int kThreads = 256;
  static constexpr int kS = DP + 4;  // row stride of Q, dO, K and V
  static constexpr int kP = BK + 4;  // row stride of P and dS (query, key)
  static constexpr int kSmem =
      (int)sizeof(float) * (2 * BQ * kS + 2 * NB * BK * kS + BQ * kP + 2 * BQ);
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

template <int DP, int BQ, int BK, int NB>
__global__ void __launch_bounds__(256, 3 - NB) flash_bwd_dq_f32(const Params p) {
  using C = F32Cfg<DP, BQ, BK, NB>;
  constexpr int S = C::kS, PS = C::kP;
  constexpr int RI = BQ / 16;  // query rows per thread
  constexpr int CJ = BK / 16;  // keys per thread in the score tile
  constexpr int CG = DP / 64;  // float4 output column groups per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float *const Qs = reinterpret_cast<float *>(smem);
  float *const Os = Qs + BQ * S;       // dO
  float *const Ks = Os + BQ * S;       // NB buffers of BK rows
  float *const Vs = Ks + NB * BK * S;  // NB buffers
  float *const Ss = Vs + NB * BK * S;  // P, then dS: (query, key)
  float *const Ls = Ss + BQ * PS;
  float *const Ds = Ls + BQ;

  const int t = p.t, d = p.d;
  const int n_qt = (t + BQ - 1) / BQ;
  const int bh = blockIdx.x % p.bh_count;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / p.bh_count)) * BQ;  // the most work first
  const long long bi = bh / p.h, hi = bh % p.h;
  const float *const k_bh = (const float *)p.k + bi * p.sk.b + hi * p.sk.h;
  const float *const v_bh = (const float *)p.v + bi * p.sv.b + hi * p.sv.h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_kt = key_tiles(p, q0, BQ, BK);

  load_tile<float, BQ, DP, S, 256>(Qs, (const float *)p.q + bi * p.sq.b + hi * p.sq.h, p.sq.t,
                                   q0, t, d, p.vec_in);
  load_tile<float, BQ, DP, S, 256>(Os, (const float *)p.dout + bi * p.sdo.b + hi * p.sdo.h,
                                   p.sdo.t, q0, t, d, p.vec_in);
  load_rows<BQ, 256>(Ls, p.lse + (long long)bh * t, q0, t);
  load_rows<BQ, 256>(Ds, p.delta + (long long)bh * t, q0, t);
  load_key_tile<float, BK, DP, S, 256>(Ks, Vs, 0, k_bh, v_bh, p, 0);
  cp_commit();

  float acc[RI][CG][4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int g = 0; g < CG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK, buf = NB == 2 ? kt & 1 : 0;
    __syncthreads();  // the refilled buffer and Ss are no longer read
    if (NB == 2) {
      if (kt + 1 < n_kt)
        load_key_tile<float, BK, DP, S, 256>(Ks, Vs, buf ^ 1, k_bh, v_bh, p, k0 + BK);
      cp_commit();
      cp_wait1();
    } else {
      if (kt > 0) load_key_tile<float, BK, DP, S, 256>(Ks, Vs, 0, k_bh, v_bh, p, k0);
      cp_commit();
      cp_wait0();
    }
    __syncthreads();
    const float *const Kb = Ks + buf * BK * S;
    const float *const Vb = Vs + buf * BK * S;

    // P, then dS from the P this thread wrote (one score tile live at a time)
    float x[RI][CJ];
    tile_dot<DP, S, RI, CJ>(x, Qs, Kb, ty, tx);  // x[i][j] = q_r . k_c
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = RI * ty + i, q_pos = q0 + r;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 16 * j, k_pos = k0 + c;
        const bool keep = q_pos < t && k_pos < t && !(p.causal && k_pos > q_pos);
        Ss[r * PS + c] = keep ? expf(x[i][j] / p.sqrt_d - Ls[r]) : 0.f;
      }
    }
    tile_dot<DP, S, RI, CJ>(x, Os, Vb, ty, tx);  // x[i][j] = dO_r . v_c
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int r = RI * ty + i, at = r * PS + tx + 16 * j;
        Ss[at] = Ss[at] * (x[i][j] - Ds[r]);
      }
    __syncthreads();

    // dQ += dS K (scaled at the end), keys in order
#pragma unroll 1
    for (int c = 0; c < BK; c += 4) {
      float4 sa[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        sa[i] = *reinterpret_cast<const float4 *>(Ss + (RI * ty + i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float4 k4[CG];
#pragma unroll
        for (int g = 0; g < CG; ++g)
          k4[g] = *reinterpret_cast<const float4 *>(Kb + (c + cc) * S + 4 * tx + 64 * g);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float sv = lane_of(sa[i], cc);
#pragma unroll
          for (int g = 0; g < CG; ++g) {
            acc[i][g][0] = fmaf(sv, k4[g].x, acc[i][g][0]);
            acc[i][g][1] = fmaf(sv, k4[g].y, acc[i][g][1]);
            acc[i][g][2] = fmaf(sv, k4[g].z, acc[i][g][2]);
            acc[i][g][3] = fmaf(sv, k4[g].w, acc[i][g][3]);
          }
        }
      }
    }
  }

  float *const dq_bh = (float *)p.dq + bi * p.sdq.b + hi * p.sdq.h;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int q_pos = q0 + RI * ty + i;
    if (q_pos >= t) continue;
    float *const row = dq_bh + q_pos * p.sdq.t;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const int c = 4 * tx + 64 * g;
      const float4 x = make_float4(acc[i][g][0] / p.sqrt_d, acc[i][g][1] / p.sqrt_d,
                                   acc[i][g][2] / p.sqrt_d, acc[i][g][3] / p.sqrt_d);
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
int launch(K kernel, int threads, int smem, int tiles, const Params &p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)tiles * p.bh_count;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DP, int BQ, int BK, int NB>
int run_f32(const Params &p, cudaStream_t s) {
  using C = F32Cfg<DP, BQ, BK, NB>;
  return launch(flash_bwd_dq_f32<DP, BQ, BK, NB>, C::kThreads, C::kSmem, (p.t + BQ - 1) / BQ,
                p, s);
}

template <int DP, int DC, int BK>
int run_bf16(const Params &p, cudaStream_t s) {
  using C = Bf16Cfg<DP, DC, BK>;
  const int tiles = (p.t + kQueriesBf16 - 1) / kQueriesBf16 * C::kColBlocks;
  return launch(flash_bwd_dq_bf16<DP, DC, BK>, C::kThreads, C::kSmem, tiles, p, s);
}

bool aligned(const void *ptr, const Strides &st, int esize, int to) {
  return (uintptr_t)ptr % to == 0 && (st.b * esize) % to == 0 && (st.h * esize) % to == 0 &&
         (st.t * esize) % to == 0;
}

}  // namespace

// strides: the element strides of the b, h and t axes of q, k, v, dO and dq,
// in that order (15 values; the d axes are contiguous). lse and delta:
// float32 (b, h, t) contiguous. dtype 0 float32, 1 bfloat16. Returns a
// cudaError_t (0: launched).
extern "C" int flash_attn_bwd_dq_launch(const void *q, const void *k, const void *v,
                                        const void *dout, const void *lse, const void *delta,
                                        void *dq, const long long *strides, int b, int h, int t,
                                        int d, int dtype, int causal, void *stream) {
  if (b <= 0 || h <= 0 || t <= 0) return 0;
  if (d < 1 || d > 256 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  Strides st[5];
  for (int i = 0; i < 5; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int esize = dtype == 0 ? 4 : 2;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = (const float *)lse;
  p.delta = (const float *)delta;
  p.dq = dq;
  p.sq = st[0];
  p.sk = st[1];
  p.sv = st[2];
  p.sdo = st[3];
  p.sdq = st[4];
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
  p.vec_out = aligned(dq, st[4], esize, dtype == 0 ? 16 : 4);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (d <= 64) return run_f32<64, 64, 64, 1>(p, s);
    if (d <= 128) return run_f32<128, 64, 32, 2>(p, s);
    return run_f32<256, 32, 32, 2>(p, s);
  }
  if (d <= 64) return run_bf16<64, 64, 32>(p, s);
  if (d <= 128) return run_bf16<128, 128, 32>(p, s);
  return run_bf16<256, 128, 32>(p, s);
}
