#!/usr/bin/env python3
"""Time variants of the port's int4_dot and flash_attn_fwd kernels on one card.

    python3 tools/kernel_variants.py

Each variant is the kernel's source in deeplearning4j_tpu_torch/csrc/ with
one textual substitution (a different tile choice, or one stage of the
kernel switched off). All variants are built at once by nvcc for sm_90a
into deeplearning4j_tpu_torch/build/variants/, loaded with ctypes and
timed as chip_smoke.py times kernels (CUDA events, median of 25 launches,
L2 flushed before each). A variant that keeps the function is checked
against the plain version (int4_dot bitwise, flash_attn_fwd within
chip_smoke.py's limit); one that switches a stage off computes garbage and
is timed only, to show what that stage costs. Prints the card line and one
JSON line per (variant, shape).
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
]


def build(out_dir: Path):
    from deeplearning4j_tpu_torch.perf.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, source, subs, _ in VARIANTS:
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device; this script runs on a card", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.parallel.ring_attention import reference_attention
    from deeplearning4j_tpu_torch.perf.kernels import _build, int4_dot

    print(f"card: {cs.card_line()}", flush=True)
    libs = build(_build.BUILD / "variants")
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    for name, source, _, keeps in VARIANTS:
        lib = libs[name]
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
