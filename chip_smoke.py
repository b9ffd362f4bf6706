#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deeplearning4j_tpu_torch) on one card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every CUDA kernel of the port from csrc/ (one nvcc per source, all
   started together) and prints the build seconds and a summary of nvcc's
   -Xptxas -v report (registers, shared memory, spills).
3. Kernel phases: holds each kernel against its plain PyTorch version on the
   card at the shapes its path gives it, and times both (CUDA events, median
   of 25 launches after warm-up, L2 flushed before each launch), beside the
   bound the card's published peaks allow and a library call that computes
   the same function (a yardstick the port never calls).
   - int4_dot, bitwise, at VGG16's fc shapes.
   - bn_act_fwd / bn_act_bwd at ResNet50's batch-norm shapes at batch 128
     (stem, res2, res4, res5) and a ragged one, in bf16 and float32. Stats
     (mean, var, inv) within rtol 1e-5 / atol 1e-6 of the plain version.
     out: at the kernel's own stats, bitwise the plain elementwise math;
     against the whole plain version, float32 within rtol 1e-5 / atol 1e-6
     and bf16 within 2 bf16 ulps of the largest addend of the
     pre-activation (a one-ulp change of a per-channel bf16 scale or shift
     moves pre by that much). Backward, from the same saved stats: dpre
     bitwise; dgamma/dbeta within rtol 1e-4 of the plain float32 sums (1.6 M
     rows summed in another order); dz within rtol 1e-4 (float32) or 2 bf16
     ulps, plus 1e-5 of its largest magnitude (it inherits the sums'
     rounding). Two runs of each kernel agree bitwise.
4. Serving phase: VGG16 at full width (224x224x3, 1000 classes, random
   weights from a seeded torch.Generator) is calibrated on two seeded
   batches, quantized to int4 weights and served by ParallelInference
   (batch_limit=16) to two client threads. Every answer is checked, the
   kernel's launch count is held against the dispatch count, and one request
   is recomputed by the same quantized net on the CPU.
5. Training phase: ResNet50 at full width (224x224x3, 1000 classes), bf16
   compute with float32 master weights, fused by conf.fused(), Adam 1e-3,
   trains through ComputationGraph.fit on one seeded batch of 128 (3
   warm-up and 10 timed steps). Every loss must be finite, the last below
   the first, and each bn kernel launched 53 times per step. The same step
   of the unfused graph (plain-tensor batch norm) is timed for scale, and
   one profiled step is broken down by kernel family.
6. Card against CPU: the fused float32 net at batch 2 takes one Sgd step on
   the card through the kernels and, with copied weights, on the CPU
   through the plain versions, in float32 and in float64. Loss within rtol
   1e-4; three gradients and their updated weights as close to the float64
   step as 3x the CPU float32 step's own error, or 1e-3 of the tensor's
   largest magnitude (float32 rounding alone moves the early layers'
   gradients by 1-2% at this size).
7. Prints the kernels JSON line, the card line, and last
   {"ok": true, "device": {...}}.

Any failure raises and exits non-zero before the last line. Without a CUDA
device the script exits 2 and prints no result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import threading
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA data sheet
PEAK_INT8_OPS_PER_S = 1.979e15  # H100 SXM dense int8 tensor-core rate
PEAK_F32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
FC_SHAPES = [(4096, 25088), (4096, 4096), (1000, 4096)]  # VGG16 fc1, fc2, out
KERNEL_BATCHES = [1, 8, 16]
RAGGED = (3, 1000, 33)  # (b, n, d)
BN_EPS = 1e-5
# (case, rows, channels, dtype, activation, residual): ResNet50's batch-norm
# shapes at batch 128 (rows = 128 * h * w), and one ragged shape
BN_CASES = [
    ("stem", 1605632, 64, "bfloat16", "relu", False),
    ("stem", 1605632, 64, "float32", "relu", False),
    ("res2", 401408, 64, "bfloat16", "relu", False),
    ("res2", 401408, 256, "bfloat16", "relu", True),
    ("res2", 401408, 256, "float32", "identity", False),
    ("res4", 25088, 1024, "bfloat16", "relu", True),
    ("res4", 25088, 1024, "float32", "leakyrelu", True),
    ("res5", 6272, 2048, "bfloat16", "identity", False),
    ("ragged", 1001, 130, "float32", "leakyrelu", True),
    ("ragged", 1001, 130, "bfloat16", "leakyrelu", False),
]
# float32 operations per element: stats (2-3), normalise (2), residual add,
# activation; the backward recomputes those and adds x-hat, the two sums and
# dz (about twice as many)
BN_OPS_PER_ELT = {"fwd": 8, "bwd": 16}
TRAIN_BATCH, TRAIN_SIDE, TRAIN_WARM, TRAIN_STEPS = 128, 224, 3, 10
UNFUSED_WARM, UNFUSED_STEPS = 2, 5
RESNET50_FUSED_BLOCKS = 53


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, reps: int = 25, warm: int = 3) -> float:
    """Median device time of one ``fn()`` call, L2 flushed before each."""
    for _ in range(warm):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def int4_dot_bound(b: int, n: int, d: int):
    """(ms, "bytes"|"operations"): each input read once, the output written
    once, 2*b*n*d int8 operations, at the card's published peaks."""
    t_bytes = (b * d + n * ((d + 1) // 2) + 4 * b * n) / PEAK_BYTES_PER_S
    t_ops = 2.0 * b * n * d / PEAK_INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_case(torch, dev, flush, b: int, n: int, d: int) -> dict:
    """Hold int4_dot against its plain version at one shape, bitwise, and
    time the kernel, the plain version and the library yardstick."""
    from deeplearning4j_tpu_torch.perf.kernels import int4_dot
    from deeplearning4j_tpu_torch.quant.pack import unpack_nibbles

    gen = torch.Generator(device=dev)
    gen.manual_seed(b * 100003 + n * 31 + d)
    w = (d + 1) // 2
    qq = torch.randint(-127, 128, (b, d), generator=gen, device=dev,
                       dtype=torch.int8)
    packed = torch.randint(-128, 128, (n, w), generator=gen, device=dev,
                           dtype=torch.int8)
    got = int4_dot.int4_matmul(qq, packed, d)
    want = int4_dot.int4_matmul_plain(qq, packed, d)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
    if not torch.equal(got, want):
        raise AssertionError(f"int4_dot differs from its plain version at "
                             f"b={b} n={n} d={d}: max |diff| {err}")
    ms = time_ms(torch, lambda: int4_dot.int4_matmul(qq, packed, d), flush)
    plain_ms = time_ms(torch, lambda: int4_dot.int4_matmul_plain(qq, packed, d),
                       flush)
    # torch._int_mm needs more than 16 rows and k % 8 == 0: the yardstick
    # runs the same weights against the queries padded to a multiple of 32
    library_ms, library_note = None, None
    w8t = unpack_nibbles(packed, d).t()
    qpad = torch.zeros((max(32, -(-b // 32) * 32), d), dtype=torch.int8,
                       device=dev)
    qpad[:b] = qq
    try:
        torch._int_mm(qpad, w8t)
        library_ms = time_ms(torch, lambda: torch._int_mm(qpad, w8t), flush)
        library_note = (f"torch._int_mm on unpacked int8 weights, queries "
                        f"padded to {qpad.shape[0]} rows")
    except RuntimeError as e:
        library_note = f"torch._int_mm refused: {str(e).splitlines()[0]}"
    bound_ms, bound_by = int4_dot_bound(b, n, d)
    row = {"b": b, "n": n, "d": d, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms, "library": library_note}
    print("int4_dot " + json.dumps(row), flush=True)
    return row


def kernel_phase(torch, dev, flush):
    cases = [(b, n, d) for n, d in FC_SHAPES for b in KERNEL_BATCHES] + [RAGGED]
    return [kernel_case(torch, dev, flush, b, n, d) for b, n, d in cases]


def layer_times(torch, net, x):
    """Device ms of each layer of one forward (CUDA events between layers)."""
    with torch.inference_mode():
        x = net._as_input(x)
        marks = []
        for i, layer in enumerate(net.layers):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            if i in net._pre:
                x = net._pre[i].apply(x)
            x, _ = layer.apply(net.params[i], net.state[i], x)
            e.record()
            marks.append((f"{i}:{type(layer).__name__}", s, e))
        torch.cuda.synchronize()
    return {name: s.elapsed_time(e) for name, s, e in marks}


def serving_phase(torch, dev, card):
    from deeplearning4j_tpu_torch.models import VGG16
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.perf.kernels import int4_dot
    from deeplearning4j_tpu_torch.quant import calibrate, quantize

    rng = np.random.default_rng(0)
    net = VGG16().init(device=dev)
    calib = [rng.standard_normal((8, 224, 224, 3), dtype=np.float32)
             for _ in range(2)]
    t0 = time.perf_counter()
    rec = calibrate(net, calib)
    print(f"calibrated {len(rec.ranges)} layers on {rec.batches} batches in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    x16 = rng.standard_normal((16, 224, 224, 3), dtype=np.float32)
    layer_times(torch, net, x16)  # first touch: cuDNN algorithm choice
    fp32_ms = sum(layer_times(torch, net, x16).values())
    q = quantize(net, rec, weight_bits=4)
    del net
    torch.cuda.empty_cache()

    pi = ParallelInference(q, batch_limit=16)
    answers, errors = [], []

    def client(seed):
        crng = np.random.default_rng(seed)
        reqs = [crng.standard_normal((int(crng.integers(1, 5)), 224, 224, 3),
                                     dtype=np.float32) for _ in range(12)]
        try:
            for x in reqs:
                t_sub = time.perf_counter()
                out = pi.submit(x).get(timeout=600)
                answers.append((x, out, time.perf_counter() - t_sub))
        except Exception as e:  # re-raised on the main thread below
            errors.append(e)

    int4_dot.launches = 0
    threads = [threading.Thread(target=client, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    launches = int4_dot.launches
    stats = pi.stats()
    pi.shutdown()
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads) or len(answers) != 24:
        raise AssertionError(f"{len(answers)} of 24 requests answered")
    for x, out, _ in answers:
        if out.shape != (len(x), 1000) or not np.all(np.isfinite(out)):
            raise AssertionError(f"bad answer of shape {out.shape}")
        if np.abs(out.sum(axis=1) - 1.0).max() > 1e-5:
            raise AssertionError("softmax rows do not sum to 1 within 1e-5")
    if stats["requests_served"] != 24 or launches != 3 * stats["batches_dispatched"]:
        raise AssertionError(f"int4_dot launched {launches} times for "
                             f"{stats['batches_dispatched']} dispatches (want 3 each)")

    # the same quantized net (copied weights and scales) on the CPU
    x, served, _ = min(answers, key=lambda a: len(a[0]))
    t0 = time.perf_counter()
    cpu_out = q.to("cpu").output(x).numpy()
    cpu_err = float(np.abs(cpu_out - served).max())
    if cpu_err > 1e-5:
        raise AssertionError(f"card vs CPU softmax differ by {cpu_err}")

    layer_times(torch, q, x16)
    qt = layer_times(torch, q, x16)
    lat = np.array([a[2] for a in answers]) * 1e3
    summary = {
        "card": card,
        "requests_served": stats["requests_served"],
        "batches_dispatched": stats["batches_dispatched"],
        "bucket_dispatches": stats["bucket_dispatches"],
        "int4_dot_launches": launches,
        "p50_request_ms": float(np.percentile(lat, 50)),
        "max_request_ms": float(lat.max()),
        "card_vs_cpu_max_abs": cpu_err,
        "cpu_check_rows": len(x),
        "cpu_check_s": time.perf_counter() - t0,
        "fp32_forward_ms_b16": fp32_ms,
        "int4_forward_ms_b16": sum(qt.values()),
        "int4_conv_ms_b16": sum(v for k, v in qt.items() if "Convolution" in k),
        "int4_dense_ms_b16": {k: v for k, v in qt.items()
                              if "Dense" in k or "Output" in k},
    }
    print("serving " + json.dumps(summary), flush=True)
    return launches, stats["bucket_dispatches"]


def ptxas_summary(log: str) -> str:
    """Registers, shared memory and spills over a library's entry functions."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    smem = [int(m) for m in re.findall(r"(\d+) bytes smem", log)] or [0]
    spills = sum(int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
    if not regs:
        return "no -Xptxas -v report (library was already built)"
    return (f"{len(regs)} entry functions, {min(regs)}-{max(regs)} registers, "
            f"max {max(smem)} B smem, {spills} B spilled")


def bn_bound(n: int, c: int, esize: int, tensors: int, ops_per_elt: int):
    """(ms, "bytes"|"operations"): ``tensors`` (n, c) arrays read or written
    once, the O(C) vectors, and ``ops_per_elt`` float32 operations per
    element, at the card's published peaks."""
    t_bytes = (tensors * n * c * esize + 6 * 4 * c) / PEAK_BYTES_PER_S
    t_ops = ops_per_elt * n * c / PEAK_F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _hold(what, ok, err):
    if not bool(ok.all()):
        raise AssertionError(f"{what}: {int((~ok).sum())} elements out of "
                             f"tolerance (max |diff| {err})")


def _close(what, got, want, rtol, atol):
    err = (got.float() - want.float()).abs()
    _hold(what, err <= atol + rtol * want.float().abs(), float(err.max()))
    return float(err.max())


def _bf16_ulp(torch, mag):
    """One bf16 ulp at magnitude ``mag`` (float32, elementwise)."""
    return torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126))) - 7)


def bn_case(torch, dev, flush, case, n, c, dtype_name, act, residual) -> dict:
    """Hold bn_act_fwd and bn_act_bwd against their plain versions at one
    shape and time the kernels, the plain versions and the library
    yardsticks."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.nn.activations import get_activation
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    dt = getattr(torch, dtype_name)
    gen = torch.Generator(device=dev)
    gen.manual_seed(n * 31 + c)
    z = (torch.randn((n, c), generator=gen, device=dev) * 2.0 + 0.5).to(dt)
    # gamma > 0 and |beta| small keep dgamma and dbeta far from 0, so that a
    # relative tolerance on them means something
    gamma = (torch.rand(c, generator=gen, device=dev) + 0.5).to(dt)
    beta = ((torch.rand(c, generator=gen, device=dev) - 0.5) * 0.4).to(dt)
    res = torch.randn((n, c), generator=gen, device=dev).to(dt) if residual else None
    args = (act, BN_EPS, z, gamma, beta, res)

    out, mean, var, inv = bn_act.bn_act_fwd(*args)
    p_out, p_mean, p_var, p_inv = bn_act.bn_act_fwd_plain(*args)
    dout = (out.float() + 0.5 + 0.1 * torch.randn((n, c), generator=gen, device=dev)).to(dt)
    bargs = (act, BN_EPS, z, gamma, beta, res, mean, inv, dout)
    dz, dg, db, dpre = bn_act.bn_act_bwd(*bargs)
    p_dz, p_dg, p_db, p_dpre = bn_act.bn_act_bwd_plain(*bargs)
    torch.cuda.synchronize()
    label = f"{case} {n}x{c} {dtype_name} {act}{' +res' if residual else ''}"

    for what, got, want in (("mean", mean, p_mean), ("var", var, p_var),
                            ("inv", inv, p_inv)):
        _close(f"bn_act_fwd {what} {label}", got, want, 1e-5, 1e-6)
    scale = gamma.float() * inv
    shift = beta.float() - mean * scale
    if not torch.equal(out, bn_act.bn_act_apply_plain(act, z, scale, shift, res)):
        raise AssertionError(f"bn_act_fwd {label}: out differs from the plain "
                             "elementwise math at the kernel's own stats")
    fwd_err = _max_err(out, p_out)
    if dt == torch.float32:
        _close(f"bn_act_fwd out {label}", out, p_out, 1e-5, 1e-6)
    else:
        p_scale = gamma.float() * p_inv
        p_shift = beta.float() - p_mean * p_scale
        mag = torch.maximum((z.float() * p_scale.to(dt).float()).abs(),
                            p_shift.to(dt).float().abs())
        if res is not None:
            mag = torch.maximum(mag, res.float().abs())
        mag = torch.maximum(mag, p_out.float().abs())
        _hold(f"bn_act_fwd out {label} (2 bf16 ulps)",
              (out.float() - p_out.float()).abs() <= 2 * _bf16_ulp(torch, mag), fwd_err)
        del mag
    if res is not None and not torch.equal(dpre, p_dpre):
        raise AssertionError(f"bn_act_bwd {label}: dpre differs from the plain version")
    _close(f"bn_act_bwd dgamma {label}", dg, p_dg, 1e-4, 1e-6 * float(p_dg.abs().max()))
    _close(f"bn_act_bwd dbeta {label}", db, p_db, 1e-4, 1e-6 * float(p_db.abs().max()))
    bwd_err = _max_err(dz, p_dz)
    dz_floor = 1e-5 * float(p_dz.float().abs().max())
    if dt == torch.float32:
        _close(f"bn_act_bwd dz {label}", dz, p_dz, 1e-4, dz_floor)
    else:
        mag = torch.maximum(dz.float().abs(), p_dz.float().abs())
        _hold(f"bn_act_bwd dz {label} (2 bf16 ulps)",
              (dz.float() - p_dz.float()).abs() <= 2 * _bf16_ulp(torch, mag) + dz_floor,
              bwd_err)
        del mag
    for what, first, again in (("bn_act_fwd", (out, mean, var, inv), bn_act.bn_act_fwd(*args)),
                               ("bn_act_bwd", (dz, dg, db), bn_act.bn_act_bwd(*bargs)[:3])):
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"{what} {label}: two runs differ")
    del p_out, p_dz, p_dpre

    # library yardsticks (timed here, never called by the port):
    # F.batch_norm(training=True) + add + activation, and its autograd backward
    lib_note = "F.batch_norm(training=True) + add + activation; autograd backward"
    gw, gb = gamma.float(), beta.float()  # batch-norm weights in float32

    def lib_fwd(zz=z, ww=gw, bb=gb, rr=res):
        y = F.batch_norm(zz, None, None, ww, bb, training=True, eps=BN_EPS)
        return get_activation(act)(y if rr is None else y + rr)

    lib_ms = {"fwd": None, "bwd": None}
    try:
        leaves = [z.detach().requires_grad_(True), gw.detach().requires_grad_(True),
                  gb.detach().requires_grad_(True)]
        if res is not None:
            leaves.append(res.detach().requires_grad_(True))
        y = lib_fwd(*leaves)
        lib_ms["fwd"] = time_ms(torch, lib_fwd, flush)
        lib_ms["bwd"] = time_ms(torch, lambda: torch.autograd.grad(
            y, leaves, dout, retain_graph=True), flush)
        del y, leaves
    except RuntimeError as e:
        lib_note = f"F.batch_norm refused: {str(e).splitlines()[0]}"

    esize = z.element_size()
    base = {"case": case, "rows": n, "channels": c, "dtype": dtype_name, "act": act,
            "residual": residual, "library": lib_note}
    row = dict(base)
    for kind, kernel, plain, tensors, err in (
            ("fwd", lambda: bn_act.bn_act_fwd(*args),
             lambda: bn_act.bn_act_fwd_plain(*args), 3 if residual else 2, fwd_err),
            ("bwd", lambda: bn_act.bn_act_bwd(*bargs),
             lambda: bn_act.bn_act_bwd_plain(*bargs), 5 if residual else 3, bwd_err)):
        bound_ms, bound_by = bn_bound(n, c, esize, tensors, BN_OPS_PER_ELT[kind])
        r = dict(base, max_abs_err=err, ms=time_ms(torch, kernel, flush),
                 plain_ms=time_ms(torch, plain, flush), bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=lib_ms[kind])
        print(f"bn_act_{kind} " + json.dumps(r), flush=True)
        row[kind] = r
    return row


def bn_kernel_phase(torch, dev, flush):
    rows = [bn_case(torch, dev, flush, *case) for case in BN_CASES]
    torch.cuda.empty_cache()
    return rows


def _kernel_times(prof):
    """(kernel name, device ms) of every kernel a profile recorded."""
    out = []
    for evt in prof.key_averages():
        us = float(getattr(evt, "self_device_time_total", 0.0)
                   or getattr(evt, "self_cuda_time_total", 0.0) or 0.0)
        if us > 0 and str(getattr(evt, "device_type", "")).endswith("CUDA"):
            out.append((evt.key, us / 1e3))
    return sorted(out, key=lambda kv: -kv[1])


# cuDNN's and cuBLAS's kernel names (convolutions, and the output layer's
# matrix product, which falls in the same family)
CONV_MARKS = ("conv", "cudnn", "xmma", "gemm", "implicit", "wgrad", "dgrad",
              "fprop", "nhwc", "nchw", "cutlass", "nvjet")


def _profile_step(torch, net, ds, step_ms):
    """Device time of one training step by kernel family, from
    torch.profiler: the forward and backward in one profile (convolutions,
    bn_act_fwd, bn_act_bwd, other), the update in a second (optimizer).
    Runs the step twice and keeps the second: the first profile pays the
    tracer's start-up."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.datasets import MultiDataSet

    inputs, labels, lmasks = net._batch(MultiDataSet.from_dataset(ds))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=acts) as fb:
            loss, grads, state = net._loss_and_grads(inputs, labels, net._gen, lmasks)
            torch.cuda.synchronize()
        with profile(activities=acts) as up:
            net._apply_updates(grads)
            net._commit_state(state)
            torch.cuda.synchronize()
    fam = {"convolutions": 0.0, "bn_act_fwd": 0.0, "bn_act_bwd": 0.0, "other": 0.0}
    fb_kernels = _kernel_times(fb)
    for name, ms in fb_kernels:
        key = name.lower()
        if "bn_fwd_" in key:
            fam["bn_act_fwd"] += ms
        elif "bn_bwd_" in key:
            fam["bn_act_bwd"] += ms
        elif any(m in key for m in CONV_MARKS):
            fam["convolutions"] += ms
        else:
            fam["other"] += ms
    up_kernels = _kernel_times(up)
    fam["optimizer"] = sum(ms for _, ms in up_kernels)
    busy = sum(fam.values())
    return {"device_ms_by_family": fam, "device_busy_ms": busy,
            "median_step_ms": step_ms, "idle_share": max(0.0, 1.0 - busy / step_ms),
            "top_kernels_ms": [[name[:70], ms] for name, ms in fb_kernels[:10]],
            "loss": float(loss)}


def _timed_steps(torch, net, ds, warm, steps):
    losses, times = [], []
    for i in range(warm + steps):
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(net._score)
    return [float(v) for v in losses], times[warm:]


def training_phase(torch, dev, card):
    import dataclasses

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.nn.conf.convolutional import FusedConvBNActivation
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    conf = dataclasses.replace(
        ResNet50(num_classes=1000, input_shape=(TRAIN_SIDE, TRAIN_SIDE, 3)).conf(),
        dtype="bfloat16")
    fused_conf = conf.fused()
    blocks = sum(isinstance(o, FusedConvBNActivation) for o, _ in fused_conf.vertices.values())
    if blocks != RESNET50_FUSED_BLOCKS:
        raise AssertionError(f"{blocks} fused blocks, want {RESNET50_FUSED_BLOCKS}")
    net = ComputationGraph(fused_conf, dev).init()
    rng = np.random.default_rng(0)
    batch, side = TRAIN_BATCH, TRAIN_SIDE
    # the batch lies on the card already: the steps time the device step
    x = torch.from_numpy(rng.standard_normal((batch, side, side, 3), dtype=np.float32))
    y = torch.from_numpy(np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, batch)])
    ds = DataSet(x.to(dev), y.to(dev))
    torch.cuda.reset_peak_memory_stats()

    bn_act.fwd_launches = bn_act.bwd_launches = 0
    losses, times = _timed_steps(torch, net, ds, TRAIN_WARM, TRAIN_STEPS)
    fwd, bwd = bn_act.fwd_launches, bn_act.bwd_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = TRAIN_WARM + TRAIN_STEPS
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if not fwd == bwd == RESNET50_FUSED_BLOCKS * steps:
        raise AssertionError(f"bn_act launched {fwd} forward / {bwd} backward in "
                             f"{steps} steps; want {RESNET50_FUSED_BLOCKS * steps} each")
    profile = _profile_step(torch, net, ds, float(np.median(times)))
    del net
    torch.cuda.empty_cache()

    unfused = ComputationGraph(conf, dev).init()
    u_losses, u_times = _timed_steps(torch, unfused, ds, UNFUSED_WARM, UNFUSED_STEPS)
    del unfused
    torch.cuda.empty_cache()
    if not all(np.isfinite(u_losses)):
        raise AssertionError(f"non-finite unfused loss: {u_losses}")

    step_ms = float(np.median(times))
    summary = {
        "card": card, "batch": batch, "side": side, "dtype": "bfloat16",
        "steps": steps, "median_step_ms": step_ms, "min_step_ms": min(times),
        "images_per_s": batch / (step_ms / 1e3),
        "first_loss": losses[0], "last_loss": losses[-1],
        "bn_act_fwd_launches": fwd, "bn_act_bwd_launches": bwd,
        "peak_memory_gb": peak_gb,
        "unfused_median_step_ms": float(np.median(u_times)),
        "unfused_images_per_s": batch / (float(np.median(u_times)) / 1e3),
        "unfused_first_last_loss": [u_losses[0], u_losses[-1]],
    }
    print("training " + json.dumps(summary), flush=True)
    print("training_profile " + json.dumps(profile), flush=True)
    return fwd, bwd


def card_vs_cpu_phase(torch, dev):
    """One Sgd step of the fused float32 ResNet50 at batch 2 on the card
    (through the kernels) against the same step on the CPU (plain
    versions), with copied weights. The CPU also takes the step in float64,
    the reference for rounding: the early layers' float32 gradients of a
    random-init ResNet50 carry about 1-2% rounding error (CPU float32 against
    float64), so each card gradient is held within 3x the CPU float32
    step's own distance to float64, or 1e-3 of the tensor's max-abs,
    whichever is larger; the loss within rtol 1e-4."""
    import dataclasses

    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.optimize.updaters import Sgd
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    conf = ResNet50(num_classes=1000, input_shape=(TRAIN_SIDE, TRAIN_SIDE, 3),
                    updater=Sgd(learning_rate=0.1)).conf().fused()
    gnet = ComputationGraph(conf, dev).init()

    def on_cpu(dtype):
        return ({n: {k: v.to("cpu", dtype, copy=True) for k, v in p.items()}
                 for n, p in tree.items()}
                for tree in (gnet.params, gnet.state))

    nets = {"card": gnet,
            "cpu": ComputationGraph(conf, "cpu").set_params(*on_cpu(torch.float32)),
            "cpu64": ComputationGraph(dataclasses.replace(conf, dtype="float64"),
                                      "cpu").set_params(*on_cpu(torch.float64))}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, TRAIN_SIDE, TRAIN_SIDE, 3), dtype=np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, 2)]
    t0 = time.perf_counter()
    results = {}
    for name, net in nets.items():
        f0 = bn_act.fwd_launches
        inputs, labels, _ = net._batch(MultiDataSet([x], [y]))
        loss, grads, state = net._loss_and_grads(inputs, labels)
        net._apply_updates(grads)
        net._commit_state(state)
        results[name] = (float(loss), grads, net.params)
        if name == "card" and bn_act.fwd_launches - f0 != RESNET50_FUSED_BLOCKS:
            raise AssertionError("the card step did not run every fused block's kernel")
    (lg, gg, pg), (lc, gc, pc), (l64, g64, p64) = (results[k] for k in ("card", "cpu", "cpu64"))
    if abs(lg - lc) > 1e-4 * abs(lc):
        raise AssertionError(f"card loss {lg} vs CPU loss {lc}")
    report = {}
    for n, k in (("stem_act", "W"), ("res3b_out", "gamma"), ("output", "W")):
        ref, ref_p = g64[n][k], p64[n][k]
        scale = float(ref.abs().max())
        cpu_err = float((gc[n][k].double() - ref).abs().max())
        card_err = float((gg[n][k].cpu().double() - ref).abs().max())
        card_cpu = float((gg[n][k].cpu() - gc[n][k]).abs().max())
        limit = max(3.0 * cpu_err, 1e-3 * scale)
        if card_err > limit:
            raise AssertionError(f"gradient {n}/{k}: card vs float64 {card_err} > {limit} "
                                 f"(CPU float32 vs float64 {cpu_err}, max-abs {scale})")
        # the Sgd update is 0.1 * gradient: the same bound, scaled
        p_err = float((pg[n][k].cpu().double() - ref_p).abs().max())
        if p_err > 0.1 * limit + 1e-6 * float(ref_p.abs().max()):
            raise AssertionError(f"updated {n}/{k}: card vs float64 {p_err}")
        report[f"{n}/{k}"] = {"card_vs_f64": card_err / scale, "cpu_vs_f64": cpu_err / scale,
                             "card_vs_cpu": card_cpu / scale}
    summary = {"card_loss": lg, "cpu_loss": lc, "cpu_f64_loss": l64,
               "loss_rel_diff": abs(lg - lc) / abs(lc), "grad_err_over_max_abs": report,
               "seconds": time.perf_counter() - t0}
    print("card_vs_cpu " + json.dumps(summary), flush=True)
    del nets, gnet
    torch.cuda.empty_cache()


def _bn_kernel_entry(name, rows, launches):
    """The kernels-line entry of bn_act_fwd or bn_act_bwd: numbers at the
    stem shape in bf16, max error over every case."""
    kind = name[-3:]
    stem = next(r[kind] for r in rows if r["case"] == "stem" and r["dtype"] == "bfloat16")
    return {"name": name, "route": "cuda",
            "source": f"deeplearning4j_tpu_torch/csrc/{name}.cu",
            "replaces": "deeplearning4j_tpu/perf/pallas/bn.py:"
                        + ("88" if kind == "fwd" else "169"),
            "launches": launches, "max_abs_err": stem["max_abs_err"],
            "max_abs_err_all_cases": max(r[kind]["max_abs_err"] for r in rows),
            "ms": stem["ms"], "plain_ms": stem["plain_ms"],
            "bound_ms": stem["bound_ms"], "bound_by": stem["bound_by"],
            "library_ms": stem["library_ms"],
            "shape": {"rows": stem["rows"], "channels": stem["channels"],
                      "dtype": "bfloat16"}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a card",
              file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.device import resolve_device
    from deeplearning4j_tpu_torch.perf.kernels import _build

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dev = resolve_device("cuda")
    names = ["int4_dot", "bn_act_fwd", "bn_act_bwd"]
    t0 = time.perf_counter()
    _build.build(names)
    print(f"built {', '.join(names)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in names:
        log = _build.build_log.get(name, "")
        print(f"ptxas {name}: {ptxas_summary(log)}", flush=True)
        print(log.strip(), flush=True)

    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    rows = kernel_phase(torch, dev, flush)
    bn_rows = bn_kernel_phase(torch, dev, flush)
    launches, buckets = serving_phase(torch, dev, card)
    bn_fwd, bn_bwd = training_phase(torch, dev, card)
    card_vs_cpu_phase(torch, dev)

    # the kernel line reports fc1 at the batch the serving phase dispatched
    # most often, timed above or here
    b = max(buckets, key=buckets.get)
    n, d = FC_SHAPES[0]
    fc1 = next((r for r in rows if (r["b"], r["n"], r["d"]) == (b, n, d)), None)
    fc1 = fc1 or kernel_case(torch, dev, flush, b, n, d)
    print(f"chip_smoke ran {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [{
        "name": "int4_dot", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/int4_dot.cu",
        "replaces": "deeplearning4j_tpu/perf/pallas/adc.py:150",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows + [fc1]),
        "ms": fc1["ms"], "plain_ms": fc1["plain_ms"], "bound_ms": fc1["bound_ms"],
        "bound_by": fc1["bound_by"], "library_ms": fc1["library_ms"],
        "shape": {"b": b, "n": n, "d": d}},
        _bn_kernel_entry("bn_act_fwd", bn_rows, bn_fwd),
        _bn_kernel_entry("bn_act_bwd", bn_rows, bn_bwd)]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
