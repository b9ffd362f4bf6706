#!/usr/bin/env python3
"""Time variants of the port's redesigned kernels on one card: int4_dot,
flash_attn_fwd, scatter_add, flash_attn_bwd_dkv, flash_attn_bwd_dq,
bn_act_bwd, bn_act_fwd, adc_pq, adc_ivf_pq and the bn kernels' split
launches (split_fwd_*, split_bwd_*: bn_act_fwd.cu / bn_act_bwd.cu's split
launches at world 1 at chip_smoke.py's SPLIT_CASES, held bitwise against
the variant's own one launch and timed beside the split's first design).

    python3 tools/kernel_variants.py

Each variant is the kernel's source in deeplearning4j_tpu_torch/csrc/ with
one textual substitution (a different tile choice, or one stage of the
kernel switched off). All variants are built at once by nvcc for sm_90a
into deeplearning4j_tpu_torch/build/variants/, loaded with ctypes and
timed as chip_smoke.py times kernels (CUDA events, median of 25 launches,
L2 flushed before each). A variant that keeps the function is checked
against the plain version (int4_dot, scatter_add, adc_pq and adc_ivf_pq
bitwise, the flash kernels and the bn kernels within chip_smoke.py's
limits); one that switches a stage off computes garbage and is timed only,
to show what that stage costs. Prints the card line and one JSON line per
(variant, shape); the bn_act_bwd, bn_act_fwd, adc_pq and adc_ivf_pq lines
also time the kernel's first design (csrc/*_v1.cu) on the same operands.

    python3 tools/kernel_variants.py scatter_add dkv_f32_double_buffer

times only the variants of the named sources and the named variants.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

INT4_SHAPES = [(1, 1_000_000, 64), (8, 1_000_000, 64), (256, 1_000_000, 64),
               (8, 4096, 25088), (16, 4096, 25088)]
FLASH_SHAPES = [(8, 12, 1024, 64, True, "float32"), (1, 12, 1024, 64, True, "float32"),
                (8, 12, 1024, 64, False, "float32")]
# scatter_add on a (9991, 128) table, the Word2Vec vocabulary: (label, N,
# rows): a Zipf draw over the vocabulary (the head row takes ~10%, as the
# corpus path's contexts and centers do at N = 8192 and CBOW's bags at
# 81,920), one hot row, and HS-like points (half of them one row)
SCATTER_V = 9991
SCATTER_SHAPES = [("zipf", 8192), ("zipf", 81920), ("hot_row", 8192), ("half_one_row", 155648)]
# flash_attn_bwd_dkv: (b, h, t, d, causal, dtype), head-split views as the
# training path gives them
DKV_SHAPES = [(8, 12, 1024, 64, True, "bfloat16"), (8, 12, 1024, 64, True, "float32"),
              (4, 8, 4096, 128, True, "bfloat16"), (4, 8, 4096, 128, True, "float32"),
              (2, 3, 129, 256, True, "float32")]
# flash_attn_bwd_dq: the same shapes
DQ_SHAPES = DKV_SHAPES
# bn_act_bwd: chip_smoke.py's BN_CASES (ResNet50's batch norms at batch 128
# and the ragged C = 130, which takes the scalar path)
BN_SHAPES = cs.BN_CASES
# bn_act_bwd's other design: the three passes as three launches, pass 3
# walking the work items in the reverse of pass 1's order. _bn_launches
# substitutes them for the cooperative launch, with the named passes
# launched (one pass alone computes garbage and is timed only).
_BN_COOP = ("  void *args[] = {(void *)&a};\n"
            "  return (int)cudaLaunchCooperativeKernel("
            "(const void *)bn_bwd_fused<T, V, ACT, RES>,\n"
            "                                          a.tiles * a.nrb, kThreads, args, 0, st);\n")
_BN_GRID = "// The grid for V-element channel groups"
_BN_KERNELS = """template <typename T, int V, int ACT, bool RES>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bn_bwd_partials(const Args a) {
  __shared__ float red[2 * kThreads * kMaxV];
  partials<T, V, ACT, RES>(a, blockIdx.x, red);
}
template <typename T>
__global__ void __launch_bounds__(kThreads) bn_bwd_finalize(const Args a) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c < a.C) finalize<T>(a, c);
}
template <typename T, int V, int ACT, bool RES>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bn_bwd_dz(const Args a) {
  dz_pass<T, V, ACT, RES>(a, a.tiles * a.nrb - 1 - blockIdx.x);
}

"""
_BN_LAUNCH = {
    "partials": "  bn_bwd_partials<T, V, ACT, RES><<<a.tiles * a.nrb, kThreads, 0, st>>>(a);\n",
    "finalize": "  bn_bwd_finalize<T><<<(a.C + kThreads - 1) / kThreads, kThreads, 0, st>>>(a);\n",
    "dz": "  bn_bwd_dz<T, V, ACT, RES><<<a.tiles * a.nrb, kThreads, 0, st>>>(a);\n"}


def _bn_launches(*passes):
    return [(_BN_GRID, _BN_KERNELS + _BN_GRID),
            (_BN_COOP, "".join(_BN_LAUNCH[k] for k in passes)
             + "  return (int)cudaGetLastError();\n")]

# bn_act_fwd's other design, as bn_act_bwd's: three launches, pass 3
# walking the work items in the reverse of pass 1's order
_BNF_COOP = ("  void *args[] = {(void *)&a};\n"
             "  return (int)cudaLaunchCooperativeKernel("
             "(const void *)bn_fwd_fused<T, V, ACT, RES>,\n"
             "                                          a.tiles * a.nrb, kThreads, args, 0, st);\n")
_BNF_PLAN = "template <typename T, int V, int ACT, bool RES>\nint plan(Args &a) {"
_BNF_KERNELS = """template <typename T, int V, int ACT, bool RES>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bn_fwd_partials(const Args a) {
  __shared__ typename Stat<T>::type red[2 * kThreads * V];
  partials<T, V>(a, blockIdx.x, red);
}
template <typename T>
__global__ void __launch_bounds__(kThreads) bn_fwd_finalize(const Args a) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) / 32;
  if (c < a.C) finalize<T>(a, c, threadIdx.x % 32);
}
template <typename T, int V, int ACT, bool RES>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bn_fwd_apply(const Args a) {
  apply<T, V, ACT, RES>(a, a.tiles * a.nrb - 1 - blockIdx.x);
}

"""
_BNF_LAUNCH = {
    "partials": "  bn_fwd_partials<T, V, ACT, RES><<<a.tiles * a.nrb, kThreads, 0, st>>>(a);\n",
    "finalize": "  bn_fwd_finalize<T><<<(a.C * 32 + kThreads - 1) / kThreads, kThreads, 0, st>>>(a);\n",
    "apply": "  bn_fwd_apply<T, V, ACT, RES><<<a.tiles * a.nrb, kThreads, 0, st>>>(a);\n"}


def _bnf_launches(*passes):
    return [(_BNF_PLAN, _BNF_KERNELS + _BNF_PLAN),
            (_BNF_COOP, "".join(_BNF_LAUNCH[k] for k in passes)
             + "  return (int)cudaGetLastError();\n")]


# adc_pq: (b, n, M, ksub), the served batches on a (1M, 8) code table of 256
# codes, and chip_smoke.py's ragged shapes
ADC_SHAPES = [(b, 1_000_000, 8, 256) for b in (1, 8, 32, 64, 256)] + cs.ADC_RAGGED

# (name, source, [(old, new)], keeps the function)
# adc_ivf_pq: (b, C, p, M, ksub) on CSR slots laid out as the IVF-PQ
# index lays them out (_csr_slots over 1000 cells of 200-3800 rows, 8
# probed cells a query, C = 65,536: about a quarter of the slots valid),
# and the ragged shapes of chip_smoke.py (random seg)
IVF_SHAPES = [(b, 65536, 8, 8, 256) for b in (1, 8, 256)] + cs.IVF_RAGGED
VARIANTS = [
    ("int4_as_built", "int4_dot", [], True),
    ("int4_no_table_loads", "int4_dot",
     [("      cp_async16(dst, bytes ? src : a.packed, bytes);",
       "      if (a.b < 0) cp_async16(dst, bytes ? src : a.packed, bytes);")], False),
    ("int4_no_arithmetic", "int4_dot",
     [("      if (ks < steps) {", "      if (ks < steps && a.b < 0) {")], False),
    ("int4_no_epilogue", "int4_dot",
     [("        if (col >= a.n) continue;", "        if (col >= a.n || a.b > 0) continue;")],
     False),
    ("int4_fc_chunks_of_64_codes", "int4_dot",
     [("  if (b <= 16 && d >= 256) return run<16, 128, 256, 4, 3>(a, (cudaStream_t)stream);\n",
       "")], True),
    ("flash_as_built", "flash_attn_fwd", [], True),
    ("flash_f32_4x4_tile", "flash_attn_fwd",
     [("    if (d <= 64) return run_f32<64, 64, 8>(p, s);",
       "    if (d <= 64) return run_f32<64, 64, 4>(p, s);")], True),
    ("scatter_as_built", "scatter_add", [], True),
    # the walk's adds as 8 interleaved partial chains: what the dependent
    # adds cost (another order: timed only)
    ("scatter_8_partial_chains", "scatter_add",
     [("            for (int k = 0; k < 16; ++k) acc = __fadd_rn(acc, v[k]);",
       "            float part[8] = {};\n"
       "#pragma unroll\n"
       "            for (int k = 0; k < 16; ++k) part[k & 7] = __fadd_rn(part[k & 7], v[k]);\n"
       "#pragma unroll\n"
       "            for (int k = 0; k < 8; ++k) acc = __fadd_rn(acc, part[k]);")], False),
    ("scatter_no_row_loads", "scatter_add",
     [("          if (c < width) cp_async16(&buf[row][c], gbase + pp[row] * a.D + c);",
       "          if (c < width && a.n < 0) cp_async16(&buf[row][c], gbase + pp[row] * a.D + c);")],
     False),
    # the walk left out: what the copy pipeline and its barriers cost alone
    ("scatter_no_walk", "scatter_add",
     [("      if (tid < width) {\n        const float(*buf)",
       "      if (tid < width && a.n < 0) {\n        const float(*buf)")], False),
    # every segment to the short role's warps: the first design's walk on
    # this design's grid
    ("scatter_no_long_split", "scatter_add",
     [("    if (hi - s < kLong) continue;", "    continue;"),
      ("    if (j + kLong - 1 < a.n && last == r) continue;       // long: the long role's", "")],
     True),
    # each role alone (the other's segments left undone: timed only)
    ("scatter_long_role_only", "scatter_add",
     [("  const int lane = threadIdx.x & 31;\n  const long long nwarps",
       "  if (a.n > 0) return;\n  const int lane = threadIdx.x & 31;\n  const long long nwarps")],
     False),
    ("scatter_short_role_only", "scatter_add",
     [("    if (hi - s < kLong) continue;", "    continue;")], False),
    ("scatter_long_from_64", "scatter_add",
     [("constexpr int kLong = 32; ", "constexpr int kLong = 64; ")], True),
    # the short role as first built here: 16 rows in flight a lane,
    # registers for three blocks an SM, long from 64
    ("scatter_16_in_flight_3_blocks", "scatter_add",
     [("constexpr int kMinBlocks = 5; ", "constexpr int kMinBlocks = 3; "),
      ("constexpr int kSub = 8; ", "constexpr int kSub = 16; "),
      ("constexpr int kLong = 32; ", "constexpr int kLong = 64; ")], True),
    ("scatter_stage_64_ahead_7", "scatter_add",
     [("constexpr int kStage = 128; ", "constexpr int kStage = 64; "),
      ("constexpr int kAhead = 3; ", "constexpr int kAhead = 7; ")], True),
    ("dkv_as_built", "flash_attn_bwd_dkv", [], True),
    ("dkv_no_lo_products", "flash_attn_bwd_dkv",
     [("        mma_bf16(dv[2 * c2], pl, ob[0], ob[1]);\n", ""),
      ("        mma_bf16(dv[2 * c2 + 1], pl, ob[2], ob[3]);\n", ""),
      ("        mma_bf16(dk[2 * c2], sl, qb[0], qb[1]);\n", ""),
      ("        mma_bf16(dk[2 * c2 + 1], sl, qb[2], qb[3]);\n", "")], False),
    ("dkv_no_dsq_product", "flash_attn_bwd_dkv",
     [("        ldsm_x4_t(qb, Qb + off);\n"
       "        mma_bf16(dk[2 * c2], sh, qb[0], qb[1]);\n"
       "        mma_bf16(dk[2 * c2], sl, qb[0], qb[1]);\n"
       "        mma_bf16(dk[2 * c2 + 1], sh, qb[2], qb[3]);\n"
       "        mma_bf16(dk[2 * c2 + 1], sl, qb[2], qb[3]);\n", ""),
      ("            acc_dk[i][g][0] = fmaf(sv, q4[g].x, acc_dk[i][g][0]);\n"
       "            acc_dk[i][g][1] = fmaf(sv, q4[g].y, acc_dk[i][g][1]);\n"
       "            acc_dk[i][g][2] = fmaf(sv, q4[g].z, acc_dk[i][g][2]);\n"
       "            acc_dk[i][g][3] = fmaf(sv, q4[g].w, acc_dk[i][g][3]);\n", "")], False),
    ("dkv_kv_fragments_from_smem", "flash_attn_bwd_dkv",
     [("  constexpr bool kKVRegs = DP <= 64;", "  constexpr bool kKVRegs = false;")], True),
    ("dkv_f32_query_tile_32", "flash_attn_bwd_dkv",
     [("    if (d <= 64) return run_f32<64, 64, 64, 1>(p, s);",
       "    if (d <= 64) return run_f32<64, 64, 32, 1>(p, s);")], True),
    # one query-tile buffer at d = 128 and 256 too
    ("dkv_f32_single_buffer_all", "flash_attn_bwd_dkv",
     [("    if (d <= 128) return run_f32<128, 64, 32, 2>(p, s);\n    return run_f32<256, 32, 32, 2>(p, s);",
       "    if (d <= 128) return run_f32<128, 64, 32, 1>(p, s);\n    return run_f32<256, 32, 32, 1>(p, s);")],
     True),
    # two query-tile buffers: 140 KB of shared memory, one block an SM
    ("dkv_f32_double_buffer", "flash_attn_bwd_dkv",
     [("    if (d <= 64) return run_f32<64, 64, 64, 1>(p, s);",
       "    if (d <= 64) return run_f32<64, 64, 64, 2>(p, s);")], True),
    ("dq_as_built", "flash_attn_bwd_dq", [], True),
    # dS rounded to bf16 alone: what the lo products cost
    ("dq_no_lo_products", "flash_attn_bwd_dq",
     [("        mma_bf16(dq[2 * c2], sl, kb[0], kb[1]);\n", ""),
      ("        mma_bf16(dq[2 * c2 + 1], sl, kb[2], kb[3]);\n", "")], False),
    # without dQ += dS K (bf16: the S and dP products stay, being asm
    # volatile, but the P and dS arithmetic falls away with it)
    ("dq_no_dsk_product", "flash_attn_bwd_dq",
     [("        ldsm_x4_t(kb, Kb + off);\n"
       "        mma_bf16(dq[2 * c2], sh, kb[0], kb[1]);\n"
       "        mma_bf16(dq[2 * c2], sl, kb[0], kb[1]);\n"
       "        mma_bf16(dq[2 * c2 + 1], sh, kb[2], kb[3]);\n"
       "        mma_bf16(dq[2 * c2 + 1], sl, kb[2], kb[3]);\n", ""),
      ("            acc[i][g][0] = fmaf(sv, k4[g].x, acc[i][g][0]);\n"
       "            acc[i][g][1] = fmaf(sv, k4[g].y, acc[i][g][1]);\n"
       "            acc[i][g][2] = fmaf(sv, k4[g].z, acc[i][g][2]);\n"
       "            acc[i][g][3] = fmaf(sv, k4[g].w, acc[i][g][3]);\n", "")], False),
    ("dq_qo_fragments_from_smem", "flash_attn_bwd_dq",
     [("  constexpr bool kQORegs = DP <= 64;", "  constexpr bool kQORegs = false;")], True),
    # the key tile at d <= 64 in bf16: 64 rows (this PR's first build) or 16
    ("dq_bf16_key_tile_64", "flash_attn_bwd_dq",
     [("  if (d <= 64) return run_bf16<64, 64, 32>(p, s);",
       "  if (d <= 64) return run_bf16<64, 64, 64>(p, s);")], True),
    ("dq_bf16_key_tile_16", "flash_attn_bwd_dq",
     [("  if (d <= 64) return run_bf16<64, 64, 32>(p, s);",
       "  if (d <= 64) return run_bf16<64, 64, 16>(p, s);")], True),
    ("dq_f32_key_tile_32", "flash_attn_bwd_dq",
     [("    if (d <= 64) return run_f32<64, 64, 64, 1>(p, s);",
       "    if (d <= 64) return run_f32<64, 64, 32, 1>(p, s);")], True),
    # two key-tile buffers at d <= 64: 121 KB of shared memory, one block an SM
    ("dq_f32_double_buffer", "flash_attn_bwd_dq",
     [("    if (d <= 64) return run_f32<64, 64, 64, 1>(p, s);",
       "    if (d <= 64) return run_f32<64, 64, 64, 2>(p, s);")], True),
    ("bn_as_built", "bn_act_bwd", [], True),
    ("bn_three_launches", "bn_act_bwd", _bn_launches("partials", "finalize", "dz"), True),
    ("bn_pass_1_only", "bn_act_bwd", _bn_launches("partials"), False),
    ("bn_pass_3_only", "bn_act_bwd", _bn_launches("dz"), False),
    # pass 3 in pass 1's order: what rereading the last-read rows first buys
    ("bn_reread_in_order", "bn_act_bwd",
     [("  for (long long r = it.r1 - 1 - it.lane; r >= it.r0; r -= kRows * a.RL) {",
       "  for (long long r = it.r0 + it.lane; r < it.r1; r += kRows * a.RL) {"),
      ("      const long long rk = r - k * a.RL;\n      ok[k] = rk >= it.r0;",
       "      const long long rk = r + k * a.RL;\n      ok[k] = rk < it.r1;")], True),
    ("bn_rows_in_flight_1", "bn_act_bwd",
     [("constexpr int kRows = 2; ", "constexpr int kRows = 1; ")], True),
    ("bn_rows_in_flight_4", "bn_act_bwd",
     [("constexpr int kRows = 2; ", "constexpr int kRows = 4; ")], True),
    # three blocks an SM (registers capped at 85); the kernel's plan sizes
    # the grid to match
    ("bn_3_blocks_per_sm", "bn_act_bwd",
     [("constexpr int kMinBlocks = 2; ", "constexpr int kMinBlocks = 3; ")], True),
    ("bnf_as_built", "bn_act_fwd", [], True),
    ("bnf_three_launches", "bn_act_fwd", _bnf_launches("partials", "finalize", "apply"), True),
    ("bnf_pass_1_only", "bn_act_fwd", _bnf_launches("partials"), False),
    ("bnf_pass_3_only", "bn_act_fwd", _bnf_launches("apply"), False),
    # pass 3 in pass 1's order: what rereading the last-read rows first buys
    ("bnf_reread_in_order", "bn_act_fwd",
     [("  for (long long r = it.r1 - 1 - it.lane; r >= it.r0; r -= kApplyRows * a.RL) {",
       "  for (long long r = it.r0 + it.lane; r < it.r1; r += kApplyRows * a.RL) {"),
      ("      const long long rj = r - j * a.RL;\n      ok[j] = rj >= it.r0;",
       "      const long long rj = r + j * a.RL;\n      ok[j] = rj < it.r1;")], True),
    # blocks an SM (registers capped at 128 / 80 / 64 for 2 / 3 / 4; 4
    # spills with 4 rows in flight in pass 3, so it takes 2 there)
    ("bnf_2_blocks_per_sm", "bn_act_fwd",
     [("constexpr int kMinBlocks = 3; ", "constexpr int kMinBlocks = 2; ")], True),
    ("bnf_4_blocks_per_sm", "bn_act_fwd",
     [("constexpr int kMinBlocks = 3; ", "constexpr int kMinBlocks = 4; "),
      ("constexpr int kApplyRows = 4; ", "constexpr int kApplyRows = 2; ")], True),
    # rows a thread has in flight
    ("bnf_stat_rows_2", "bn_act_fwd",
     [("constexpr int kStatRows = 4; ", "constexpr int kStatRows = 2; ")], True),
    ("bnf_stat_rows_8", "bn_act_fwd",
     [("constexpr int kStatRows = 4; ", "constexpr int kStatRows = 8; ")], True),
    ("bnf_apply_rows_2", "bn_act_fwd",
     [("constexpr int kApplyRows = 4; ", "constexpr int kApplyRows = 2; ")], True),
    # float32 statistics: the shifted sums kept in float32 within a thread
    # (double from the lanes on), against double throughout
    ("bnf_f32_shifted_float_sums", "bn_act_fwd",
     [("template <> struct Stat<float> { using type = double; };",
       "template <> struct Stat<float> { using type = float; };")], True),
    # pass 1's 16-byte loads cached in L2 only (ld.global.cg)
    ("bnf_stat_loads_l2_only", "bn_act_fwd",
     [("        zv[j] = ld<T, V>(z + (ok[j] ? rj : r) * a.C + it.c0);",
       "        if constexpr (V * sizeof(T) == 16) {\n"
       "          const int4 t = __ldcg(\n"
       "              reinterpret_cast<const int4 *>(z + (ok[j] ? rj : r) * a.C + it.c0));\n"
       "          zv[j] = *reinterpret_cast<const Pack<T, V> *>(&t);\n"
       "        } else {\n"
       "          zv[j] = ld<T, V>(z + (ok[j] ? rj : r) * a.C + it.c0);\n"
       "        }")], True),
    # pass 3 with cache hints on its 16-byte vectors: out stored
    # evict-first (__stcs), so that it pushes less of z out of L2 before
    # the reread; and the reread itself loaded evict-first too
    ("bnf_streaming_stores_and_reread", "bn_act_fwd",
     [("      st<T, V>((T *)a.out + i[j], o);",
       "      if constexpr (V * sizeof(T) == 16)\n"
       "        __stcs(reinterpret_cast<int4 *>((T *)a.out + i[j]),\n"
       "               *reinterpret_cast<const int4 *>(&o));\n"
       "      else\n"
       "        st<T, V>((T *)a.out + i[j], o);"),
      ("      zv[j] = ld<T, V>(z + i[j]);\n      if (RES) rv[j] = ld<T, V>(res + i[j]);",
       "      if constexpr (V * sizeof(T) == 16) {\n"
       "        const int4 t = __ldcs(reinterpret_cast<const int4 *>(z + i[j]));\n"
       "        zv[j] = *reinterpret_cast<const Pack<T, V> *>(&t);\n"
       "      } else {\n"
       "        zv[j] = ld<T, V>(z + i[j]);\n"
       "      }\n"
       "      if (RES) rv[j] = ld<T, V>(res + i[j]);")], True),
    # the split launches: ring bytes a block, stages, and the register walk
    # (rows of loads in flight a thread) in place of the TMA ring at V > 1
    ("split_fwd_as_built", "bn_act_fwd", [], True),
    ("split_fwd_ring_16k", "bn_act_fwd",
     [("constexpr int kRing = 32768;", "constexpr int kRing = 16384;")], True),
    ("split_fwd_ring_64k", "bn_act_fwd",
     [("constexpr int kRing = 32768;", "constexpr int kRing = 65536;")], True),
    ("split_fwd_ring_64k_4_stages", "bn_act_fwd",
     [("constexpr int kRing = 32768;", "constexpr int kRing = 65536;"),
      ("constexpr int kStages = 2;", "constexpr int kStages = 4;")], True),
    ("split_fwd_stages_4", "bn_act_fwd",
     [("constexpr int kStages = 2;", "constexpr int kStages = 4;")], True),
    ("split_fwd_registers_4", "bn_act_fwd",
     [("constexpr bool kUseRing = true;", "constexpr bool kUseRing = false;")], True),
    ("split_fwd_registers_8", "bn_act_fwd",
     [("constexpr bool kUseRing = true;", "constexpr bool kUseRing = false;"),
      ("constexpr int kSplitRows = 4;", "constexpr int kSplitRows = 8;")], True),
    ("split_bwd_as_built", "bn_act_bwd", [], True),
    ("split_bwd_registers_3", "bn_act_bwd",
     [("constexpr int kSplitRows = 2;", "constexpr int kSplitRows = 3;")], True),
    ("split_bwd_registers_4", "bn_act_bwd",
     [("constexpr int kSplitRows = 2;", "constexpr int kSplitRows = 4;")], True),
    ("split_bwd_ring_2_stages", "bn_act_bwd",
     [("constexpr bool kUseRing = false;", "constexpr bool kUseRing = true;"),
      ("constexpr int kStages = 4;", "constexpr int kStages = 2;")], True),
    ("split_bwd_ring_4_stages", "bn_act_bwd",
     [("constexpr bool kUseRing = false;", "constexpr bool kUseRing = true;")], True),
    ("split_bwd_ring_8_stages", "bn_act_bwd",
     [("constexpr bool kUseRing = false;", "constexpr bool kUseRing = true;"),
      ("constexpr int kStages = 4;", "constexpr int kStages = 8;")], True),
    ("split_bwd_ring_48k", "bn_act_bwd",
     [("constexpr bool kUseRing = false;", "constexpr bool kUseRing = true;"),
      ("constexpr int kRing = 98304;", "constexpr int kRing = 49152;")], True),
    ("adc_as_built", "adc_pq", [], True),
    # queries a block: groups of 8 (3 blocks an SM at 64 KB) or 4 (5 at 32 KB)
    ("adc_group_8", "adc_pq",
     [("constexpr int kMaxGroup = 16; ", "constexpr int kMaxGroup = 8; ")], True),
    ("adc_group_4", "adc_pq",
     [("constexpr int kMaxGroup = 16; ", "constexpr int kMaxGroup = 4; ")], True),
    # one query a lane: 4-byte gathers on the same [m][code][query] layout
    ("adc_one_query_a_lane", "adc_pq",
     [("  if (qg >= 4) return v8 ? launch<true, 8, 4>(p, s) : launch<true, 0, 4>(p, s);\n", "")],
     True),
    ("adc_rows_8", "adc_pq",
     [("constexpr int kRows = 4; ", "constexpr int kRows = 8; ")], True),
    # 256 threads a block (registers for four blocks an SM)
    ("adc_256_threads", "adc_pq",
     [("constexpr int kThreads = 512;", "constexpr int kThreads = 256;"),
      ("constexpr int kMinBlocks = 1; ", "constexpr int kMinBlocks = 4; ")], True),
    # registers capped at 64, for two blocks an SM
    ("adc_two_block_registers", "adc_pq",
     [("constexpr int kMinBlocks = 1; ", "constexpr int kMinBlocks = 2; ")], True),
    # the items split with the first items % grid blocks taking one more,
    # instead of block i starting at i * items / grid
    ("adc_extra_first_ranges", "adc_pq",
     [("  const int begin = adc::span_edge(blockIdx.x, p.items, gridDim.x);\n"
       "  const int count = adc::span_edge(blockIdx.x + 1, p.items, gridDim.x) - begin;",
       "  const int per = p.items / gridDim.x, extra = p.items % gridDim.x, bx = blockIdx.x;\n"
       "  const int begin = bx * per + min(bx, extra);\n"
       "  const int count = per + (bx < extra ? 1 : 0);")], True),
    # every store without the streaming hint
    ("adc_plain_stores", "adc_pq",
     [("__stcs(reinterpret_cast<float4 *>(o + r),", "__stwb(reinterpret_cast<float4 *>(o + r),"),
      ("if (j0 + k < p.n) __stcs(o + k, acc[k][i]);", "if (j0 + k < p.n) __stwb(o + k, acc[k][i]);")],
     True),
    ("ivf_as_built", "adc_ivf_pq", [], True),
    # the query's whole LUT staged (64 KB at p = 8) instead of the tile's cells
    ("ivf_full_lut", "adc_ivf_pq",
     [("constexpr int kStageBytes = 32768;", "constexpr int kStageBytes = 65536;"),
      ("    const bool in_smem = hi - lo < p.cap;",
       "    lo = 0, hi = p.p - 1;\n    const bool in_smem = hi - lo < p.cap;")], True),
    # one slot a thread (scalar seg / pos / d2, one code row) instead of four
    ("ivf_one_slot", "adc_ivf_pq",
     [("constexpr int kSlots = 4; ", "constexpr int kSlots = 1; ")], True),
    # one block a (query, tile) item instead of the persistent walk
    ("ivf_one_tile_a_block", "adc_ivf_pq",
     [("  const int grid = (int)std::min<long long>(p.items, (long long)per_sm * sms);",
       "  const int grid = p.items;")], True),
    # d2 without the streaming hint
    ("ivf_plain_stores", "adc_ivf_pq",
     [("__stcs(reinterpret_cast<float4 *>(o),", "__stwb(reinterpret_cast<float4 *>(o),"),
      ("if (r < left) __stcs(o + r, acc[r]);", "if (r < left) __stwb(o + r, acc[r]);")], True),
    # 64 KB of cells a block (8 cells at M = 8, ksub = 256)
    ("ivf_stage_64k", "adc_ivf_pq",
     [("constexpr int kStageBytes = 32768;", "constexpr int kStageBytes = 65536;")], True),
    # each tile's own cells only, never the next tiles' ahead of them
    ("ivf_exact_range", "adc_ivf_pq",
     [("      if (k + 1 < count && tile + 1 < p.ntiles) hi = max(hi, min(lo + p.cap - 1, p.p - 1));\n",
       "")], True),
    # registers for two / three blocks an SM
    ("ivf_two_block_registers", "adc_ivf_pq",
     [("constexpr int kMinBlocks = 4; ", "constexpr int kMinBlocks = 2; ")], True),
    ("ivf_three_block_registers", "adc_ivf_pq",
     [("constexpr int kMinBlocks = 4; ", "constexpr int kMinBlocks = 3; ")], True),
]


def build(out_dir: Path, variants):
    from deeplearning4j_tpu_torch.perf.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, source, subs, _ in variants:
        text = (_build.CSRC / f"{source}.cu").read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in csrc/{source}.cu")
            text = text.replace(old, new)
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        lib = out_dir / f"lib{name}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
               str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        print(f"ptxas {name}: {cs.ptxas_summary(log)}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def int4_call(torch, lib, q, p, d):
    fn = lib.int4_dot_launch
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes, fn.restype = [P, L, P, L, P, L, I, I, I, P], I
    out = torch.empty((q.shape[0], p.shape[0]), dtype=torch.int32, device=q.device)
    err = fn(q.data_ptr(), q.stride(0), p.data_ptr(), p.stride(0), out.data_ptr(),
             out.stride(0), q.shape[0], p.shape[0], d, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"int4_dot variant launch failed with CUDA error {err}")
    return out


def flash_call(torch, lib, q, k, v, causal):
    fn = lib.flash_attn_fwd_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    o = torch.empty_like(q)
    b, h, t, d = q.shape
    strides = (ctypes.c_longlong * 12)(*(x for a in (q, k, v, o) for x in a.stride()[:3]))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None,
             ctypes.addressof(strides), b, h, t, d, int(q.dtype == torch.bfloat16),
             int(causal), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attn_fwd variant launch failed with CUDA error {err}")
    return o


def scatter_call(torch, lib, table, rows, perm, grads):
    fn = lib.scatter_add_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [P, P, I, P, P, ctypes.c_longlong, I, I, I, P], I
    v, d = table.shape
    err = fn(table.data_ptr(), rows.data_ptr(), int(rows.dtype == torch.int64),
             perm.data_ptr(), grads.data_ptr(), rows.shape[0], v, d, int(d % 4 == 0),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"scatter_add variant launch failed with CUDA error {err}")
    return table


def scatter_operands(torch, dev, label, n):
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    if label == "hot_row":
        idx = torch.full((n,), 7, dtype=torch.int32, device=dev)
    else:
        p = 1.0 / torch.arange(1, SCATTER_V + 1, device=dev, dtype=torch.float64)
        idx = torch.multinomial(p / p.sum(), n, replacement=True, generator=gen)
        if label == "half_one_row":
            idx[torch.randperm(n, generator=gen, device=dev)[: n // 2]] = 0
        idx = idx.to(torch.int32)
    table = torch.randn((SCATTER_V, 128), generator=gen, device=dev) * 0.1
    grads = torch.randn((n, 128), generator=gen, device=dev) * 0.01
    return table, idx, grads


def dkv_call(torch, lib, q, k, v, do, lse, delta, causal):
    fn = lib.flash_attn_bwd_dkv_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    b, h, t, d = q.shape
    strides = (ctypes.c_longlong * 18)(*(x for a in (q, k, v, do, dk, dv)
                                         for x in a.stride()[:3]))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), ctypes.addressof(strides), b, h, t,
             d, int(q.dtype == torch.bfloat16), int(causal),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attn_bwd_dkv variant launch failed with CUDA error {err}")
    return dk, dv


def dq_call(torch, lib, q, k, v, do, lse, delta, causal):
    fn = lib.flash_attn_bwd_dq_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dq = torch.empty_like(q)
    b, h, t, d = q.shape
    strides = (ctypes.c_longlong * 15)(*(x for a in (q, k, v, do, dq) for x in a.stride()[:3]))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dq.data_ptr(), ctypes.addressof(strides), b, h, t, d,
             int(q.dtype == torch.bfloat16), int(causal), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attn_bwd_dq variant launch failed with CUDA error {err}")
    return dq


def bn_call(torch, lib, act, z, gamma, beta, res, mean, inv, dout):
    from deeplearning4j_tpu_torch.perf.kernels import bn_act
    fn, query = lib.bn_act_bwd_launch, lib.bn_act_bwd_scratch
    fn.argtypes, fn.restype = bn_act._BWD_ARGS, ctypes.c_int
    query.argtypes, query.restype = bn_act._SCRATCH_ARGS, ctypes.c_longlong
    c = z.shape[-1]
    n = z.numel() // c
    dtype, act_code = bn_act._DTYPES[z.dtype], bn_act.KERNEL_ACTS[act]
    vec = bn_act.vec_width(c, z.element_size())
    need = query(dtype, act_code, int(res is not None), n, c, vec)
    if need < 0:
        raise RuntimeError(f"bn_act_bwd variant grid query failed with CUDA error {-need}")
    dz = torch.empty_like(z)
    dpre = None if res is None else torch.empty_like(z)
    dg, db = (torch.empty(c, dtype=torch.float32, device=z.device) for _ in range(2))
    scratch = torch.empty(need, dtype=torch.float32, device=z.device)
    ptr = (lambda a: None if a is None else a.data_ptr())
    err = fn(dtype, act_code, z.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ptr(res),
             mean.data_ptr(), inv.data_ptr(), dout.data_ptr(), n, c, dz.data_ptr(), dg.data_ptr(),
             db.data_ptr(), ptr(dpre), scratch.data_ptr(), need, vec,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"bn_act_bwd variant launch failed with CUDA error {err}")
    return dz, dg, db, dpre


def bnf_call(torch, lib, act, z, gamma, beta, res):
    from deeplearning4j_tpu_torch.perf.kernels import bn_act
    fn, query = lib.bn_act_fwd_launch, lib.bn_act_fwd_scratch
    fn.argtypes, fn.restype = bn_act._FWD_ARGS, ctypes.c_int
    query.argtypes, query.restype = bn_act._SCRATCH_ARGS, ctypes.c_longlong
    c = z.shape[-1]
    n = z.numel() // c
    dtype, act_code = bn_act._DTYPES[z.dtype], bn_act.KERNEL_ACTS[act]
    vec = bn_act.vec_width(c, z.element_size())
    need = query(dtype, act_code, int(res is not None), n, c, vec)
    if need < 0:
        raise RuntimeError(f"bn_act_fwd variant grid query failed with CUDA error {-need}")
    out = torch.empty_like(z)
    mean, var, inv = torch.empty((3, c), dtype=torch.float32, device=z.device)
    scratch = torch.empty(need, dtype=torch.float32, device=z.device)
    err = fn(dtype, act_code, z.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
             None if res is None else res.data_ptr(), n, c, cs.BN_EPS, out.data_ptr(),
             mean.data_ptr(), var.data_ptr(), inv.data_ptr(), scratch.data_ptr(), need, vec,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"bn_act_fwd variant launch failed with CUDA error {err}")
    return out, mean, var, inv


def _fn(lib, name, argtypes, restype=ctypes.c_int):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


def split_fwd_call(torch, lib, act, z, gamma, beta, res, one=False):
    """The variant's split forward at world 1 (statistics, then apply), or
    with ``one`` its one launch."""
    from deeplearning4j_tpu_torch.perf.kernels import bn_act
    if one:
        return bnf_call(torch, lib, act, z, gamma, beta, res)
    c = z.shape[-1]
    n = z.numel() // c
    codes = (bn_act._DTYPES[z.dtype], bn_act.KERNEL_ACTS[act])
    vec = bn_act._vec(z, res)
    stream = torch.cuda.current_stream().cuda_stream
    need = _fn(lib, "bn_act_fwd_sums_scratch", bn_act._SCRATCH_ARGS, ctypes.c_longlong)(
        *codes, int(res is not None), n, c, vec)
    scratch = torch.empty(need, dtype=torch.float32, device=z.device)
    stats = (torch.empty((1, 3 * c + 1), dtype=torch.float64, device=z.device)
             if z.dtype == torch.float32 else
             torch.empty(2 * c + 1, dtype=torch.float32, device=z.device))
    err = _fn(lib, "bn_act_fwd_sums_launch", bn_act._FWD_SUMS_ARGS)(
        *codes, int(res is not None), z.data_ptr(), n, c, 0, 1, stats.data_ptr(),
        scratch.data_ptr(), need, vec, stream)
    out = torch.empty_like(z)
    mean, var, inv = torch.empty((3, c), dtype=torch.float32, device=z.device)
    if not err:
        err = _fn(lib, "bn_act_fwd_apply_launch", bn_act._FWD_APPLY_ARGS)(
            *codes, z.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            None if res is None else res.data_ptr(), n, c, cs.BN_EPS, 1, stats.data_ptr(),
            out.data_ptr(), mean.data_ptr(), var.data_ptr(), inv.data_ptr(), vec, stream)
    if err:
        raise RuntimeError(f"split forward variant failed with CUDA error {err}")
    return out, mean, var, inv


def split_bwd_call(torch, lib, act, z, gamma, beta, res, mean, inv, dout, one=False):
    """The variant's split backward at world 1 (sums, then dz), or with
    ``one`` its one launch."""
    from deeplearning4j_tpu_torch.perf.kernels import bn_act
    if one:
        return bn_call(torch, lib, act, z, gamma, beta, res, mean, inv, dout)
    c = z.shape[-1]
    n = z.numel() // c
    codes = (bn_act._DTYPES[z.dtype], bn_act.KERNEL_ACTS[act])
    ptr = (lambda t: None if t is None else t.data_ptr())
    vec = bn_act._vec(z, res, dout)
    stream = torch.cuda.current_stream().cuda_stream
    need = _fn(lib, "bn_act_bwd_sums_scratch", bn_act._SCRATCH_ARGS, ctypes.c_longlong)(
        *codes, int(res is not None), n, c, vec)
    scratch = torch.empty(need, dtype=torch.float32, device=z.device)
    dg, db = torch.empty((2, c), dtype=torch.float32, device=z.device)
    sums = torch.empty(2 * c + 1, dtype=torch.float32, device=z.device)
    dpre = None if res is None else torch.empty_like(z)
    dz = torch.empty_like(z)
    err = _fn(lib, "bn_act_bwd_sums_launch", bn_act._BWD_SUMS_ARGS)(
        *codes, z.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ptr(res), mean.data_ptr(),
        inv.data_ptr(), dout.data_ptr(), n, c, dg.data_ptr(), db.data_ptr(), ptr(dpre),
        sums.data_ptr(), scratch.data_ptr(), need, vec, stream)
    if not err:
        err = _fn(lib, "bn_act_bwd_dz_launch", bn_act._BWD_DZ_ARGS)(
            *codes, z.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ptr(res), mean.data_ptr(),
            inv.data_ptr(), dout.data_ptr(), ptr(dpre), n, c, sums.data_ptr(), dz.data_ptr(),
            vec, stream)
    if err:
        raise RuntimeError(f"split backward variant failed with CUDA error {err}")
    return dz, dg, db, dpre


def adc_call(torch, lib, lut, codes):
    from deeplearning4j_tpu_torch.perf.kernels import adc
    fn = lib.adc_pq_launch
    fn.argtypes, fn.restype = adc._ARGTYPES["adc_pq"], ctypes.c_int
    b, m_count, ksub = lut.shape
    d2 = torch.empty((b, codes.shape[0]), dtype=torch.float32, device=lut.device)
    err = fn(lut.data_ptr(), codes.data_ptr(), d2.data_ptr(), b, codes.shape[0], m_count, ksub,
             adc._vec8(codes), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"adc_pq variant launch failed with CUDA error {err}")
    return d2


def adc_ivf_call(torch, lib, lut, codes, seg, pos):
    from deeplearning4j_tpu_torch.perf.kernels import adc
    fn = lib.adc_ivf_pq_launch
    fn.argtypes, fn.restype = adc._ARGTYPES["adc_ivf_pq"], ctypes.c_int
    b, p, m_count, ksub = lut.shape
    d2 = torch.empty(seg.shape, dtype=torch.float32, device=lut.device)
    err = fn(lut.data_ptr(), codes.data_ptr(), seg.data_ptr(), pos.data_ptr(), d2.data_ptr(),
             b, seg.shape[1], p, m_count, ksub, codes.shape[0], adc._vec8(codes),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"adc_ivf_pq variant launch failed with CUDA error {err}")
    return d2


def ivf_operands(torch, dev, b, c, p, m_count, ksub):
    """(lut, codes, seg, pos, valid slots): CSR slots as IVF_SHAPES says at
    C = 65,536, random seg and pos at the ragged shapes."""
    from deeplearning4j_tpu_torch.retrieval.index import _csr_slots
    gen = torch.Generator(device=dev)
    gen.manual_seed(b * 7 + c + p)
    if c == 65536:
        counts = torch.randint(200, 3800, (1000,), generator=gen, device=dev)
        offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(torch.int32)
        probe = torch.argsort(torch.rand((b, 1000), generator=gen, device=dev), dim=1)[:, :p]
        seg, pos, valid = _csr_slots(offsets, probe, c)
        n, n_valid = int(offsets[-1]), int(valid.sum())
    else:
        n, n_valid = 2000, b * c
        seg = torch.randint(0, p, (b, c), generator=gen, device=dev, dtype=torch.int32)
        pos = torch.randint(0, n, (b, c), generator=gen, device=dev, dtype=torch.int32)
    lut = torch.randn((b, p, m_count, ksub), generator=gen, device=dev)
    codes = torch.randint(0, ksub, (n, m_count), generator=gen, device=dev, dtype=torch.uint8)
    return lut, codes, seg, pos, n_valid


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device; this script runs on a card", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.parallel.ring_attention import reference_attention
    from deeplearning4j_tpu_torch.perf.kernels import _build, adc, bn_act, int4_dot
    from deeplearning4j_tpu_torch.perf.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.perf.kernels import scatter_add as sa

    print(f"card: {cs.card_line()}", flush=True)
    names = set(sys.argv[1:])
    variants = [v for v in VARIANTS if not names or v[0] in names or v[1] in names]
    libs = build(_build.BUILD / "variants", variants)
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    for name, source, _, keeps in variants:
        lib = libs[name]
        if name.startswith("split_"):
            fwd = source == "bn_act_fwd"
            for case, n, c, dtype_name, act, residual in cs.SPLIT_CASES:
                (z, gamma, beta, res), (_, mean, _, inv), dout = cs.bn_operands(
                    torch, dev, n, c, dtype_name, act, residual)
                ops = (act, z, gamma, beta, res) if fwd else (act, z, gamma, beta, res, mean,
                                                              inv, dout)
                call = split_fwd_call if fwd else split_bwd_call
                first = cs.first_design_split_fwd if fwd else cs.first_design_split_bwd
                row = {"variant": name, "shape": [case, n, c, dtype_name, act, residual]}
                got, one = call(torch, lib, *ops), call(torch, lib, *ops, one=True)
                row["bitwise_vs_one_launch"] = all(
                    (a is None and b is None) or torch.equal(a, b) for a, b in zip(got, one))
                del got, one
                row["ms"] = cs.time_ms(torch, lambda: call(torch, lib, *ops), flush)
                row["one_launch_ms"] = cs.time_ms(torch, lambda: call(torch, lib, *ops,
                                                                      one=True), flush)
                row["first_design_ms"] = cs.time_ms(torch, lambda: first(torch, *ops), flush)
                print(json.dumps(row), flush=True)
                del z, gamma, beta, res, mean, inv, dout, ops
                torch.cuda.empty_cache()
            continue
        if source == "scatter_add":
            for label, n in SCATTER_SHAPES:
                table, idx, grads = scatter_operands(torch, dev, label, n)
                rows, perm = torch.sort(idx, stable=True)
                row = {"variant": name, "shape": [label, n, SCATTER_V, 128],
                       "longest_chain": int(torch.unique(idx, return_counts=True)[1].max())}
                if keeps:
                    got = scatter_call(torch, lib, table.clone(), rows, perm, grads)
                    want = sa.scatter_add_plain(table.clone(), idx, grads)
                    row["bitwise"] = bool(torch.equal(got.view(torch.int32),
                                                      want.view(torch.int32)))
                t = table.clone()
                row["ms"] = cs.time_ms(torch, lambda: scatter_call(torch, lib, t, rows, perm,
                                                                    grads), flush)
                print(json.dumps(row), flush=True)
            continue
        if source == "bn_act_bwd":
            for case, n, c, dtype_name, act, residual in BN_SHAPES:
                (z, gamma, beta, res), (_, mean, _, inv), dout = cs.bn_operands(
                    torch, dev, n, c, dtype_name, act, residual)
                ops = (act, z, gamma, beta, res, mean, inv, dout)
                row = {"variant": name, "shape": [case, n, c, dtype_name, act, residual]}
                if keeps:
                    got = bn_call(torch, lib, *ops)
                    want = bn_act.bn_act_bwd_plain(act, cs.BN_EPS, z, gamma, beta, res, mean,
                                                   inv, dout)
                    try:
                        row["max_abs_err"] = cs.hold_bn_bwd(torch, " ".join(map(str, row["shape"])),
                                                            got, want)
                    except AssertionError as e:
                        row["out_of_limits"] = str(e)
                    row["bitwise_repeat"] = all(
                        torch.equal(a, b) for a, b in zip(got[:3], bn_call(torch, lib, *ops)))
                    del got, want
                row["ms"] = cs.time_ms(torch, lambda: bn_call(torch, lib, *ops), flush)
                row["first_design_ms"] = cs.time_ms(torch, lambda: cs.first_design_bn_bwd(
                    torch, *ops), flush)
                print(json.dumps(row), flush=True)
                del z, gamma, beta, res, mean, inv, dout, ops
                torch.cuda.empty_cache()
            continue
        if source == "bn_act_fwd":
            for case, n, c, dtype_name, act, residual in BN_SHAPES:
                (z, gamma, beta, res), _, _ = cs.bn_operands(torch, dev, n, c, dtype_name, act,
                                                             residual)
                ops = (act, z, gamma, beta, res)
                row = {"variant": name, "shape": [case, n, c, dtype_name, act, residual]}
                if keeps:
                    got = bnf_call(torch, lib, *ops)
                    want = bn_act.bn_act_fwd_plain(act, cs.BN_EPS, z, gamma, beta, res)
                    label = " ".join(map(str, row["shape"]))
                    try:
                        row.update(cs.hold_bn_fwd(torch, label, (z, gamma, beta, res), act,
                                                  got, want))
                    except AssertionError as e:
                        row["out_of_limits"] = str(e)
                    if name == "bnf_as_built":  # the first design held alike
                        first = cs.first_design_bn_fwd(torch, *ops)
                        try:
                            row["first_design"] = cs.hold_bn_fwd(
                                torch, label, (z, gamma, beta, res), act, first, want)
                        except AssertionError as e:
                            row["first_design"] = {"out_of_limits": str(e)}
                        del first
                    row["bitwise_repeat"] = all(
                        torch.equal(a, b) for a, b in zip(got, bnf_call(torch, lib, *ops)))
                    del got, want
                row["ms"] = cs.time_ms(torch, lambda: bnf_call(torch, lib, *ops), flush)
                row["first_design_ms"] = cs.time_ms(torch, lambda: cs.first_design_bn_fwd(
                    torch, *ops), flush)
                print(json.dumps(row), flush=True)
                del z, gamma, beta, res, ops
                torch.cuda.empty_cache()
            continue
        if source == "adc_pq":
            for b, n, m_count, ksub in ADC_SHAPES:
                gen = torch.Generator(device=dev)
                gen.manual_seed(b + n)
                lut = torch.randn((b, m_count, ksub), generator=gen, device=dev)
                codes = torch.randint(0, ksub, (n, m_count), generator=gen, device=dev,
                                      dtype=torch.uint8)
                row = {"variant": name, "shape": [b, n, m_count, ksub]}
                if keeps:
                    got = adc_call(torch, lib, lut, codes)
                    row["bitwise"] = bool(torch.equal(got, adc.adc_pq_plain(lut, codes))
                                          and torch.equal(got, adc_call(torch, lib, lut, codes)))
                    del got
                row["ms"] = cs.time_ms(torch, lambda: adc_call(torch, lib, lut, codes), flush)
                row["first_design_ms"] = cs.time_ms(torch, lambda: cs.first_design_adc_pq(
                    torch, lut, codes), flush)
                print(json.dumps(row), flush=True)
                del lut, codes
                torch.cuda.empty_cache()
            continue
        if source == "adc_ivf_pq":
            for b, c, p, m_count, ksub in IVF_SHAPES:
                lut, codes, seg, pos, n_valid = ivf_operands(torch, dev, b, c, p, m_count, ksub)
                ops = (lut, codes, seg, pos)
                row = {"variant": name, "shape": [b, c, p, m_count, ksub],
                       "valid_slots": n_valid}
                if keeps:
                    got = adc_ivf_call(torch, lib, *ops)
                    row["bitwise"] = bool(torch.equal(got, adc.adc_ivf_pq_plain(*ops))
                                          and torch.equal(got, adc_ivf_call(torch, lib, *ops)))
                    del got
                row["ms"] = cs.time_ms(torch, lambda: adc_ivf_call(torch, lib, *ops), flush)
                row["first_design_ms"] = cs.time_ms(
                    torch, lambda: cs.first_design_adc_ivf_pq(torch, *ops), flush)
                row["bound_ms"] = cs.adc_ivf_bound(b, c, p, m_count, ksub, n_valid)[0]
                print(json.dumps(row), flush=True)
                del lut, codes, seg, pos, ops
                torch.cuda.empty_cache()
            continue
        if source in ("flash_attn_bwd_dkv", "flash_attn_bwd_dq"):
            dq = source.endswith("dq")
            plain = fa.flash_bwd_dq_plain if dq else fa.flash_bwd_dkv_plain
            call = dq_call if dq else dkv_call
            for b, h, t, d, causal, dtype_name in (DQ_SHAPES if dq else DKV_SHAPES):
                dt = getattr(torch, dtype_name)
                gen = torch.Generator(device=dev)
                gen.manual_seed(b * 1000003 + h * 1009 + t * 31 + d)
                q, k, v, do = (torch.randn((b, t, h, d), generator=gen, device=dev).to(dt)
                               .transpose(1, 2) for _ in range(4))
                o, lse = fa.flash_fwd(q, k, v, causal)
                delta = (do.float() * o.float()).sum(-1).contiguous()
                row = {"variant": name, "shape": [b, h, t, d, causal, dtype_name]}
                if keeps:
                    f32 = [a.float() for a in (q, k, v, do)]
                    want = plain(*f32, lse, delta, causal)
                    ref = (plain(*(a.double() for a in f32), lse.double(), delta.double(),
                                 causal) if dt == torch.float32 else None)
                    got = call(torch, lib, q, k, v, do, lse, delta, causal)
                    if dq:
                        got, want, ref = (got,), (want,), (ref,)
                    ref = ref if ref is not None else [None] * len(got)
                    row["max_err_over_limit"] = max(cs._bwd_limit(torch, g, w, r, dt)[1]
                                                    for g, w, r in zip(got, want, ref))
                    del want, ref, got
                row["ms"] = cs.time_ms(torch, lambda: call(torch, lib, q, k, v, do, lse,
                                                            delta, causal), flush)
                print(json.dumps(row), flush=True)
                del q, k, v, do, o, lse, delta
                torch.cuda.empty_cache()
            continue
        if source == "int4_dot":
            for b, n, d in INT4_SHAPES:
                gen = torch.Generator(device=dev)
                gen.manual_seed(b + n + d)
                q = torch.randint(-127, 128, (b, d), generator=gen, device=dev,
                                  dtype=torch.int8)
                p = torch.randint(-128, 128, (n, (d + 1) // 2), generator=gen, device=dev,
                                  dtype=torch.int8)
                row = {"variant": name, "shape": [b, n, d]}
                if keeps:
                    row["bitwise"] = bool(torch.equal(int4_call(torch, lib, q, p, d),
                                                      int4_dot.int4_matmul_plain(q, p, d)))
                row["ms"] = cs.time_ms(torch, lambda: int4_call(torch, lib, q, p, d), flush)
                row["bound_ms"] = cs.int4_dot_bound(b, n, d)[0]
                print(json.dumps(row), flush=True)
        else:
            for b, h, t, d, causal, dtype_name in FLASH_SHAPES:
                dt = getattr(torch, dtype_name)
                gen = torch.Generator(device=dev)
                gen.manual_seed(b * 1000003 + h * 1009 + t * 31 + d)
                q, k, v = (torch.randn((b, t, h, d), generator=gen, device=dev).to(dt)
                           .transpose(1, 2) for _ in range(3))
                row = {"variant": name, "shape": [b, h, t, d, causal, dtype_name]}
                want = reference_attention(q.float(), k.float(), v.float(), causal=causal)
                got = flash_call(torch, lib, q, k, v, causal)
                tol = cs._flash_tol(torch, want, float(v.float().abs().max()), dt)
                row["max_err_over_limit"] = float(((got.float() - want).abs() / tol).max())
                row["ms"] = cs.time_ms(torch, lambda: flash_call(torch, lib, q, k, v, causal),
                                       flush)
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
