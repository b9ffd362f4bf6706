#!/usr/bin/env python3
"""Time variants of the port's redesigned kernels on one card: int4_dot,
flash_attn_fwd, scatter_add and flash_attn_bwd_dkv.

    python3 tools/kernel_variants.py

Each variant is the kernel's source in deeplearning4j_tpu_torch/csrc/ with
one textual substitution (a different tile choice, or one stage of the
kernel switched off). All variants are built at once by nvcc for sm_90a
into deeplearning4j_tpu_torch/build/variants/, loaded with ctypes and
timed as chip_smoke.py times kernels (CUDA events, median of 25 launches,
L2 flushed before each). A variant that keeps the function is checked
against the plain version (int4_dot and scatter_add bitwise,
flash_attn_fwd and flash_attn_bwd_dkv within chip_smoke.py's limits); one
that switches a stage off computes garbage and is timed only, to show what
that stage costs. Prints the card line and one JSON line per (variant,
shape).

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
# (name, source, [(old, new)], keeps the function)
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
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device; this script runs on a card", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.parallel.ring_attention import reference_attention
    from deeplearning4j_tpu_torch.perf.kernels import _build, int4_dot
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
        if source == "flash_attn_bwd_dkv":
            for b, h, t, d, causal, dtype_name in DKV_SHAPES:
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
                    want = fa.flash_bwd_dkv_plain(*f32, lse, delta, causal)
                    ref = (fa.flash_bwd_dkv_plain(*(a.double() for a in f32), lse.double(),
                                                  delta.double(), causal)
                           if dt == torch.float32 else [None, None])
                    got = dkv_call(torch, lib, q, k, v, do, lse, delta, causal)
                    row["max_err_over_limit"] = max(cs._bwd_limit(torch, g, w, r, dt)[1]
                                                    for g, w, r in zip(got, want, ref))
                    del want, ref, got
                row["ms"] = cs.time_ms(torch, lambda: dkv_call(torch, lib, q, k, v, do, lse,
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
