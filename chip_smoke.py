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
7. Retrieval phase, at the JAX package's full retrieval benchmark size
   (1,000,000 x 64 vectors from synthetic_corpus, 1024 queries): builds the
   exact BruteForceIndex, BruteForceIndex(int4=True), PQIndex(M=8,
   ksub=256, rerank=16) and IVFPQIndex(M=8, ksub=256, rerank=8) on the card.
   - adc_pq and adc_ivf_pq, bitwise against their plain versions and
     against themselves, at b = 1, 8, 64, 256 on the built indexes (the IVF
     kernel on the index's real probe slots, p = 8) and at ragged shapes
     (the p = 32 one takes the global-LUT path); timed beside the bound,
     the plain version and F.embedding_bag(mode="sum"), whose max |diff|
     is printed (its sum order may differ). int4_dot at (256, 1M, 64).
   - Serving: each of int4, PQ and IVF-PQ behind IndexEndpoint(k_max=128)
     after warmup(), four client threads of 64 requests (1-8 rows, k of 1,
     10 or 32). Every answer checked (shape, ids in range, distances
     finite and ascending); each kernel's launches equal the dispatches,
     warm-up included. recall@10 on all 1024 queries against the exact
     index, gated 0.01 under the JAX package's own indexes at this
     configuration (PQ 0.9427, IVF-PQ 0.6938, measured on the card host's
     CPU by tests/test_torch_retrieval.py's __main__); int4 printed.
   - One PQ dispatch at b = 256 broken down (LUT, kernel, top-k, host copy,
     re-rank).
   - Card against CPU: each served index saved, loaded with device="cpu"
     and asked the same 16 queries through the plain versions: distances
     within rtol 1e-5, ids equal apart from near-ties (distances within
     rtol 1e-5 of each other).
8. Word2Vec phase, at the JAX package's full Word2Vec benchmark size
   (bench.py bench_word2vec, non-QUICK: 25,000 x 20-token sentences from a
   Zipf law over 10,000 words; layer 128, window 5, 5 negatives, batch
   8192, one epoch), corpus-resident skip-gram on the card:
   - The fit runs twice, as bench.py runs it, and the second is timed
     (words/s: the vocab's token count over the fit's seconds). scatter_add
     must launch 3 times per batch (367 batches) and no other kernel; the
     losses must be finite; a second model from the same seed must reach
     the first fit's tables bitwise. One corpus segment is profiled by
     kernel family (idle share against an unprofiled run of it).
   - scatter_add, bitwise against its plain version and against itself, on
     a (10,000, 128) table at the path's shapes (N = 8192 contexts and
     centers drawn from the corpus, the 5 shared negatives) and at
     per-pair SGNS (B*K), CBOW (B*2W), HS (B*L) shapes, ragged shapes and a
     hot row; the kernel alone, the sort + kernel wrapper, the plain
     version and Tensor.index_add_ (atomics; its max |diff| printed) timed
     beside the bound.
   - Quality: the four host-path modes and the corpus-resident path on
     tests/test_nlp.py's two-topic corpus, gated at its margins.
   - Card against CPU: one host-path SGNS fit from one seed on both (the
     same numpy pairs and negatives): tables within 1e-4.
9. Prints the kernels JSON line (six kernels), the card line, and last
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
# retrieval: the JAX package's full retrieval benchmark (bench.py
# bench_retrieval, non-QUICK): 1,000,000 x 64 vectors, 5,000 clusters,
# 1024 queries; PQ M=8 ksub=256 rerank=16, IVF-PQ M=8 ksub=256 rerank=8
# (1000 cells, nprobe 8)
RETR_N, RETR_D, RETR_QUERIES = 1_000_000, 64, 1024
ADC_BATCHES = [1, 8, 64, 256]
# ragged shapes: flat (b, n, M, ksub), IVF (b, C, p, M, ksub); p = 32 at
# M = 8, ksub = 256 is a 256 KB LUT, past shared memory: the global-LUT path
ADC_RAGGED = [(3, 1001, 1, 2), (3, 1001, 3, 17), (3, 1001, 16, 17)]
IVF_RAGGED = [(3, 1001, 32, 8, 256), (3, 1001, 5, 3, 17), (3, 1001, 2, 16, 2)]
RETR_CLIENTS, RETR_REQUESTS = 4, 64
# recall@10 on all 1024 queries: the JAX package's own indexes at this
# configuration, on the card host's CPU (JAX_PLATFORMS=cpu python
# tests/test_torch_retrieval.py), and the gates 0.01 under them
JAX_RECALL = {"pq": 0.94267578125, "ivf_pq": 0.69384765625}
RECALL_GATES = {name: r - 0.01 for name, r in JAX_RECALL.items()}
NEAR_TIE_RTOL = 1e-5
# word2vec: the JAX package's full Word2Vec benchmark (bench.py
# bench_word2vec, non-QUICK), not cut: 25,000 x 20-token Zipf sentences
# over 10,000 words, corpus-resident skip-gram with negative sampling
W2V_SENTS, W2V_LEN, W2V_VOCAB = 25_000, 20, 10_000
W2V_KW = dict(layer_size=128, window_size=5, negative=5, epochs=1, batch_size=8192,
              min_word_frequency=1, seed=1)
# tests/test_nlp.py's quality settings on its two-topic corpus
TWO_TOPIC_KW = dict(layer_size=32, window_size=3, epochs=20, batch_size=512,
                    learning_rate=0.3, min_word_frequency=1, seed=42)


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


# ------------------------------------------------------------- retrieval
def bytes_ops_bound(nbytes: float, ops: float, peak_ops: float):
    """(ms, "bytes"|"operations") at the card's published peaks."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def build_retrieval(torch, dev):
    from deeplearning4j_tpu_torch.retrieval import (BruteForceIndex, IVFPQIndex,
                                                    PQIndex, synthetic_corpus)
    t0 = time.perf_counter()
    V, Q = synthetic_corpus(RETR_N, RETR_D, n_clusters=max(16, RETR_N // 200),
                            seed=0, queries=RETR_QUERIES)
    print(f"retrieval corpus {V.shape} in {time.perf_counter() - t0:.1f} s", flush=True)
    makers = {"exact": lambda: BruteForceIndex(V, device=dev),
              "int4": lambda: BruteForceIndex(V, int4=True, device=dev),
              "pq": lambda: PQIndex(V, M=8, ksub=256, rerank=16, device=dev),
              "ivf_pq": lambda: IVFPQIndex(V, M=8, ksub=256, rerank=8, device=dev)}
    indexes, build_s = {}, {}
    for name, make in makers.items():
        t0 = time.perf_counter()
        indexes[name] = make()
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - t0
        print(f"built {name} index in {build_s[name]:.1f} s", flush=True)
    return V, Q, indexes, build_s


def _hold_bitwise(torch, what, got, want, again):
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel differs from its plain version "
                             f"(max |diff| {err})")
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two runs of the kernel differ")
    return err


def adc_pq_case(torch, flush, lut, codes, label) -> dict:
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.perf.kernels import adc

    b, m_count, ksub = lut.shape
    n = codes.shape[0]
    got, again = adc.adc_pq(lut, codes), adc.adc_pq(lut, codes)
    want = adc.adc_pq_plain(lut, codes)
    torch.cuda.synchronize()
    err = _hold_bitwise(torch, f"adc_pq {label} b={b} n={n} M={m_count} ksub={ksub}",
                        got, want, again)
    del want, again
    ms = time_ms(torch, lambda: adc.adc_pq(lut, codes), flush)
    plain_ms = time_ms(torch, lambda: adc.adc_pq_plain(lut, codes), flush)
    # yardstick: bags of the M offsets m*ksub + code into the transposed LUT
    weight = lut.permute(1, 2, 0).reshape(m_count * ksub, b).contiguous()
    bags = codes.long() + torch.arange(m_count, device=lut.device) * ksub
    lib_diff = float((F.embedding_bag(bags, weight, mode="sum").T - got).abs().max())
    library_ms = time_ms(torch, lambda: F.embedding_bag(bags, weight, mode="sum"), flush)
    del bags, weight, got
    bound_ms, bound_by = bytes_ops_bound(n * m_count + 4 * b * m_count * ksub + 4 * b * n,
                                         b * n * m_count, PEAK_F32_OPS_PER_S)
    row = {"case": label, "b": b, "n": n, "M": m_count, "ksub": ksub,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "library": "F.embedding_bag(mode='sum')", "library_max_abs_diff": lib_diff,
           "lut_gathers": b * n * m_count}
    print("adc_pq " + json.dumps(row), flush=True)
    return row


def adc_ivf_case(torch, flush, lut, codes, seg, pos, n_valid, label) -> dict:
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.perf.kernels import adc

    b, p, m_count, ksub = lut.shape
    c = seg.shape[1]
    args = (lut, codes, seg, pos)
    got, again = adc.adc_ivf_pq(*args), adc.adc_ivf_pq(*args)
    want = adc.adc_ivf_pq_plain(*args)
    torch.cuda.synchronize()
    err = _hold_bitwise(torch, f"adc_ivf_pq {label} b={b} C={c} p={p} M={m_count} "
                        f"ksub={ksub}", got, want, again)
    del want, again
    ms = time_ms(torch, lambda: adc.adc_ivf_pq(*args), flush)
    plain_ms = time_ms(torch, lambda: adc.adc_ivf_pq_plain(*args), flush)
    # yardstick: a (b*p*M*ksub, 1) weight, bags ((i*p + seg)*M + m)*ksub + code
    dev = lut.device
    weight = lut.reshape(-1, 1)
    cell = torch.arange(b, device=dev)[:, None] * p + seg.long()
    bags = ((cell[..., None] * m_count + torch.arange(m_count, device=dev)) * ksub
            + codes[pos.long()].long()).reshape(b * c, m_count)
    lib_diff = float((F.embedding_bag(bags, weight, mode="sum").reshape(b, c)
                      - got).abs().max())
    library_ms = time_ms(torch, lambda: F.embedding_bag(bags, weight, mode="sum"), flush)
    del bags, cell, got
    # each slot reads seg, pos and writes d2; valid slots read M code bytes
    bound_ms, bound_by = bytes_ops_bound(12 * b * c + n_valid * m_count
                                         + 4 * b * p * m_count * ksub,
                                         n_valid * m_count, PEAK_F32_OPS_PER_S)
    row = {"case": label, "b": b, "C": c, "p": p, "M": m_count, "ksub": ksub,
           "valid_slots": n_valid, "global_lut": 4 * p * m_count * ksub > 232448,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "library": "F.embedding_bag(mode='sum')", "library_max_abs_diff": lib_diff,
           "lut_gathers": b * c * m_count}
    print("adc_ivf_pq " + json.dumps(row), flush=True)
    return row


def _ivf_inputs(torch, ix, q):
    """The IVF-PQ scorer's kernel inputs for queries ``q``: per-probed-cell
    LUTs and the index's real CSR slots (retrieval/pq.py::_score_ivf_pq)."""
    from deeplearning4j_tpu_torch.retrieval.index import (_centroid_d2, _csr_slots,
                                                          _topk_smallest)
    from deeplearning4j_tpu_torch.retrieval.pq import _adc_lut

    b = q.shape[0]
    m_count, ksub, dsub = ix._codebooks.shape
    _, probe = _topk_smallest(_centroid_d2(q, ix._centroids), ix.nprobe)
    qc = q[:, None, :] - ix._centroids[probe]
    lut = _adc_lut(qc.reshape(b * ix.nprobe, m_count, dsub),
                   ix._codebooks).reshape(b, ix.nprobe, m_count, ksub)
    seg, pos, valid = _csr_slots(ix._offsets, probe, ix.cand_pad)
    return lut, seg, pos, int(valid.sum())


def adc_kernel_phase(torch, dev, flush, Q, pq, ivf):
    from deeplearning4j_tpu_torch.retrieval.pq import _adc_lut

    qs = torch.from_numpy(Q[:max(ADC_BATCHES)]).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    pq_rows, ivf_rows = [], []
    m_count, _, dsub = pq._codebooks.shape
    for b in ADC_BATCHES:
        lut = _adc_lut(qs[:b].reshape(b, m_count, dsub), pq._codebooks)
        pq_rows.append(adc_pq_case(torch, flush, lut, pq._codes, "pq_1M"))
    for b, n, m_count, ksub in ADC_RAGGED:
        lut = torch.randn((b, m_count, ksub), generator=gen, device=dev)
        codes = torch.randint(0, ksub, (n, m_count), generator=gen, device=dev,
                              dtype=torch.uint8)
        pq_rows.append(adc_pq_case(torch, flush, lut, codes, "ragged"))
    for b in ADC_BATCHES:
        lut, seg, pos, n_valid = _ivf_inputs(torch, ivf, qs[:b])
        ivf_rows.append(adc_ivf_case(torch, flush, lut, ivf._flat_codes, seg, pos,
                                     n_valid, "ivf_pq_1M"))
    for b, c, p, m_count, ksub in IVF_RAGGED:
        lut = torch.randn((b, p, m_count, ksub), generator=gen, device=dev)
        codes = torch.randint(0, ksub, (2000, m_count), generator=gen, device=dev,
                              dtype=torch.uint8)
        seg = torch.randint(0, p, (b, c), generator=gen, device=dev, dtype=torch.int32)
        pos = torch.randint(0, 2000, (b, c), generator=gen, device=dev, dtype=torch.int32)
        ivf_rows.append(adc_ivf_case(torch, flush, lut, codes, seg, pos, b * c, "ragged"))
    int4_row = kernel_case(torch, dev, flush, max(ADC_BATCHES), RETR_N, RETR_D)
    torch.cuda.empty_cache()
    return pq_rows, ivf_rows, int4_row


def _search_all(ix, Q, k, chunk=256):
    parts = [ix.search(Q[lo:lo + chunk], k) for lo in range(0, len(Q), chunk)]
    return (np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]))


KERNEL_OF = {"int4": "int4_dot", "pq": "adc_pq", "ivf_pq": "adc_ivf_pq"}


def _launch_counts():
    from deeplearning4j_tpu_torch.perf.kernels import adc, bn_act, int4_dot, scatter_add
    return {"int4_dot": int4_dot.launches, "adc_pq": adc.pq_launches,
            "adc_ivf_pq": adc.ivf_pq_launches, "bn_act_fwd": bn_act.fwd_launches,
            "bn_act_bwd": bn_act.bwd_launches, "scatter_add": scatter_add.launches}


def _zero_launch_counts():
    from deeplearning4j_tpu_torch.perf.kernels import adc, bn_act, int4_dot, scatter_add
    int4_dot.launches = adc.pq_launches = adc.ivf_pq_launches = 0
    bn_act.fwd_launches = bn_act.bwd_launches = scatter_add.launches = 0


def serve_index(name, ix, Q) -> dict:
    """Serve one index through IndexEndpoint to RETR_CLIENTS client threads;
    check every answer and the kernel's launches against the dispatches."""
    from deeplearning4j_tpu_torch.retrieval import IndexEndpoint

    ep = IndexEndpoint(name, ix, k_max=128)
    answers, errors = [], []

    def client(cid):
        crng = np.random.default_rng(1000 + cid)
        try:
            for _ in range(RETR_REQUESTS):
                rows = int(crng.integers(1, 9))
                sel = crng.integers(0, len(Q), rows)
                k = int(crng.choice([1, 10, 32], p=[0.15, 0.7, 0.15]))
                t0 = time.perf_counter()
                idx, dist = ep.query(Q[sel], k)
                answers.append((rows, k, idx, dist, time.perf_counter() - t0))
        except Exception as e:  # re-raised on the main thread below
            errors.append(e)

    _zero_launch_counts()
    t0 = time.perf_counter()
    ep.warmup()
    warm_s = time.perf_counter() - t0
    threads = [threading.Thread(target=client, args=(c,)) for c in range(RETR_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    stats = ep.stats()
    ep.shutdown()
    if errors:
        raise errors[0]
    want = RETR_CLIENTS * RETR_REQUESTS
    if any(t.is_alive() for t in threads) or len(answers) != want:
        raise AssertionError(f"{name}: {len(answers)} of {want} requests answered")
    for rows, k, idx, dist, _ in answers:
        if idx.shape != (rows, k) or dist.shape != (rows, k):
            raise AssertionError(f"{name}: answer of shape {idx.shape} for ({rows}, {k})")
        if idx.min() < 0 or idx.max() >= ix.size:
            raise AssertionError(f"{name}: ids out of range")
        if not np.all(np.isfinite(dist)) or np.any(np.diff(dist, axis=1) < 0):
            raise AssertionError(f"{name}: distances not finite and ascending")
    dispatches = len(ep.warmed_pairs) + stats["batches_dispatched"]
    kernel = KERNEL_OF[name]
    if launches[kernel] != dispatches or any(v for k, v in launches.items() if k != kernel):
        raise AssertionError(f"{name}: launches {launches} for {dispatches} dispatches "
                             f"({len(ep.warmed_pairs)} warm-up), want {kernel} only")
    lat = np.array([a[4] for a in answers]) * 1e3
    rows_total = sum(a[0] for a in answers)
    return {"warmup_dispatches": len(ep.warmed_pairs), "warmup_s": warm_s,
            "batches_dispatched": stats["batches_dispatched"],
            "requests": len(answers), "query_rows": rows_total,
            "launches": launches[kernel], "kernel": kernel,
            "p50_request_ms": float(np.percentile(lat, 50)),
            "p99_request_ms": float(np.percentile(lat, 99)),
            "queries_per_s": rows_total / wall, "requests_per_s": len(answers) / wall,
            "serving_wall_s": wall}


def pq_dispatch_breakdown(torch, ix, Q, k=10, reps=5) -> dict:
    """Device ms (CUDA events) of the parts of one PQ dispatch at b = 256,
    and host ms of the copy back and the re-rank; medians of ``reps``."""
    from deeplearning4j_tpu_torch.perf.kernels import adc
    from deeplearning4j_tpu_torch.retrieval.index import _rerank_exact, _topk_smallest
    from deeplearning4j_tpu_torch.retrieval.pq import _adc_lut

    q_np = Q[:256]
    k_dev = ix._rerank_k(k)          # the re-rank's candidates, as search() takes
    kp = ix._k_pad(k_dev)
    m_count, _, dsub = ix._codebooks.shape
    parts = {"lut": [], "adc_pq": [], "top_k": [], "sqrt": [], "host_copy": [],
             "rerank": [], "whole_search": []}
    for _ in range(reps):
        q = torch.from_numpy(q_np).to(ix.device)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        lut = _adc_lut(q.reshape(256, m_count, dsub), ix._codebooks)
        ev[1].record()
        d2 = adc.adc_pq(lut, ix._codes)
        ev[2].record()
        vals, idx = _topk_smallest(d2, kp)
        ev[3].record()
        dist = torch.sqrt(torch.clamp_min(vals, 0.0))
        ev[4].record()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = idx[:, :k_dev].to(torch.int32).cpu().numpy()
        dist[:, :k_dev].cpu().numpy()
        t1 = time.perf_counter()
        _rerank_exact(ix._rerank_vecs, q_np, ids, k)
        t2 = time.perf_counter()
        ix.search(q_np, k)
        t3 = time.perf_counter()
        for name, (a, b) in zip(("lut", "adc_pq", "top_k", "sqrt"),
                                zip(ev[:-1], ev[1:])):
            parts[name].append(a.elapsed_time(b))
        parts["host_copy"].append((t1 - t0) * 1e3)
        parts["rerank"].append((t2 - t1) * 1e3)
        parts["whole_search"].append((t3 - t2) * 1e3)
        del d2, vals, idx, dist, lut
    return {"b": 256, "k": k, "k_device": kp, "rerank_candidates": k_dev,
            **{f"{name}_ms": float(np.median(v)) for name, v in parts.items()}}


def card_vs_cpu_index(torch, name, ix, Q, tmpdir) -> dict:
    """The served index saved, loaded on the CPU, asked the same 16 queries:
    distances within rtol 1e-5; ids equal apart from near-ties."""
    import os

    from deeplearning4j_tpu_torch.retrieval import load_index

    t0 = time.perf_counter()
    cpu = load_index(ix.save(os.path.join(tmpdir, f"{name}.npz")), device="cpu")
    qb = Q[-16:]
    gi, gd = ix.search(qb, 10)
    ci, cd = cpu.search(qb, 10)
    if not np.allclose(gd, cd, rtol=NEAR_TIE_RTOL, atol=0.0):
        raise AssertionError(f"{name}: card vs CPU distances differ by "
                             f"{float(np.abs(gd - cd).max())}")
    diff = gi != ci
    if not np.allclose(gd[diff], cd[diff], rtol=NEAR_TIE_RTOL, atol=0.0):
        raise AssertionError(f"{name}: card vs CPU ids differ beyond near-ties")
    return {"id_mismatches": int(diff.sum()),
            "max_rel_dist_diff": float(np.max(np.abs(gd - cd) / np.maximum(cd, 1e-30))),
            "cpu_s": time.perf_counter() - t0}


def retrieval_phase(torch, dev, flush, card):
    import tempfile

    t_phase = time.perf_counter()
    V, Q, ix, build_s = build_retrieval(torch, dev)
    pq_rows, ivf_rows, int4_row = adc_kernel_phase(torch, dev, flush, Q, ix["pq"],
                                                   ix["ivf_pq"])
    exact = _search_all(ix["exact"], Q, 10)[0]
    served = {}
    for name in ("int4", "pq", "ivf_pq"):
        summary = serve_index(name, ix[name], Q)
        got = _search_all(ix[name], Q, 10)[0]
        recall = float(np.mean([len(np.intersect1d(g, w)) / 10.0
                                for g, w in zip(got, exact)]))
        st = ix[name].stats()
        summary.update(card=card, index=name, build_s=build_s[name],
                       memory_bytes=st["memory_bytes"], rerank=st["rerank"],
                       n_cells=st.get("n_cells"), cand_pad=st.get("cand_pad"),
                       recall_at_10=recall, recall_gate=RECALL_GATES.get(name),
                       jax_recall_at_10=JAX_RECALL.get(name))
        served[name] = summary
        print("retrieval " + json.dumps(summary), flush=True)
        if name in RECALL_GATES and recall < RECALL_GATES[name]:
            raise AssertionError(f"{name}: recall@10 {recall:.4f} under the gate "
                                 f"{RECALL_GATES[name]}")
    print("retrieval_profile " + json.dumps(pq_dispatch_breakdown(torch, ix["pq"], Q)),
          flush=True)
    with tempfile.TemporaryDirectory(dir=str(_build_dir())) as tmpdir:
        checks = {name: card_vs_cpu_index(torch, name, ix[name], Q, tmpdir)
                  for name in served}
    print("retrieval_card_vs_cpu " + json.dumps(checks), flush=True)
    del ix, V
    torch.cuda.empty_cache()
    print(f"retrieval phase ran {time.perf_counter() - t_phase:.1f} s", flush=True)
    return pq_rows, ivf_rows, int4_row, served



# ------------------------------------------------------------- word2vec
def w2v_corpus():
    """bench.py's full Word2Vec corpus (bench_word2vec, non-QUICK): 25,000
    sentences of 20 tokens drawn from a Zipf law over 10,000 words."""
    rng = np.random.default_rng(0)
    ranks = np.arange(1, W2V_VOCAB + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    words = np.array([f"w{i}" for i in range(W2V_VOCAB)])
    choice = rng.choice(W2V_VOCAB, (W2V_SENTS, W2V_LEN), p=probs)
    return [" ".join(words[row]) for row in choice]


def two_topic_corpus(n=300, seed=7):
    """tests/test_nlp.py's quality corpus: two disjoint topical vocabularies."""
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "horse", "cow", "sheep", "goat"]
    tools = ["hammer", "wrench", "drill", "saw", "pliers", "chisel"]
    sents = []
    for _ in range(n):
        pool = animals if rng.random() < 0.5 else tools
        sents.append(" ".join(rng.choice(pool, size=rng.integers(4, 9))))
    return sents, animals, tools


def _bits_equal(torch, a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def scatter_case(torch, flush, table, idx, grads, label) -> dict:
    """Hold scatter_add bitwise against its plain version and itself, and
    time the kernel alone (on sorted work), the sort + kernel wrapper, the
    plain version and Tensor.index_add_ beside the bound."""
    from deeplearning4j_tpu_torch.perf.kernels import scatter_add as sa

    n, (v, d) = idx.shape[0], table.shape
    got = sa.scatter_add(table.clone(), idx, grads)
    again = sa.scatter_add(table.clone(), idx, grads)
    want = table.clone()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    sa.scatter_add_plain(want, idx, grads)
    ev[1].record()
    lib = table.clone().index_add_(0, idx, grads)
    torch.cuda.synchronize()
    what = f"scatter_add {label} V={v} D={d} N={n}"
    if not _bits_equal(torch, got, want):
        raise AssertionError(f"{what}: kernel differs from its plain version "
                             f"(max |diff| {float((got - want).abs().max())})")
    if not _bits_equal(torch, got, again):
        raise AssertionError(f"{what}: two runs of the kernel differ")
    lib_diff = float((lib - got).abs().max())
    uniq, counts = torch.unique(idx, return_counts=True)
    distinct, longest = int(uniq.numel()), int(counts.max())
    del again, want, lib
    rows, perm = torch.sort(idx, stable=True)
    rows, perm = rows.to(torch.int32), perm.to(torch.int32)
    t = table.clone()
    ms = time_ms(torch, lambda: sa.launch_sorted(t, rows, perm, grads), flush)
    wrapper_ms = time_ms(torch, lambda: sa.scatter_add(t, idx, grads), flush)
    # the plain version takes one step per rank level: past 1000 levels
    # (hundreds of ms) its one checking run is its time
    plain_reps = 25 if longest <= 1000 else 1
    plain_ms = (time_ms(torch, lambda: sa.scatter_add_plain(t, idx, grads), flush)
                if plain_reps > 1 else ev[0].elapsed_time(ev[1]))
    library_ms = time_ms(torch, lambda: t.index_add_(0, idx, grads), flush)
    del t, got
    # grads once, sorted rows and perm once, each distinct row read and
    # written once; N*D float adds
    bound_ms, bound_by = bytes_ops_bound(n * d * 4 + n * 4 * 2 + 2 * distinct * d * 4,
                                         n * d, PEAK_F32_OPS_PER_S)
    row = {"case": label, "V": v, "D": d, "N": n, "distinct_rows": distinct,
           "longest_chain": longest, "max_abs_err": 0.0, "ms": ms,
           "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "plain_reps": plain_reps,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
           "library": "Tensor.index_add_ (atomics)", "library_max_abs_diff": lib_diff}
    print("scatter_add " + json.dumps(row), flush=True)
    return row


def scatter_kernel_phase(torch, dev, flush, v, corpus, neg_table, points):
    """scatter_add at the shapes the NLP steps give it on a (V, 128) table:
    the corpus path's three (contexts, centers, K = 5 shared negatives),
    per-pair SGNS's syn1 negatives (B*K), CBOW's bags (B*2W), HS's path
    nodes (B*L, padding included), ragged shapes and a hot row."""
    B, K, W = W2V_KW["batch_size"], W2V_KW["negative"], W2V_KW["window_size"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    def draw(table, n):
        return table[torch.randint(0, table.shape[0], (n,), generator=gen,
                                   device=dev)].to(torch.int32)

    def grads(n, d=128):
        return torch.randn((n, d), generator=gen, device=dev) * 0.01

    def table(rows=v, d=128):
        return torch.randn((rows, d), generator=gen, device=dev) * 0.1

    centers = draw(corpus, B)
    cases = [("corpus_contexts", table(), draw(corpus, B), grads(B)),
             ("corpus_centers", table(), centers, grads(B)),
             ("corpus_negatives", table(), draw(neg_table, K), grads(K)),
             ("sgns_negatives", table(), draw(neg_table, B * K), grads(B * K)),
             ("cbow_bags", table(), draw(corpus, B * 2 * W), grads(B * 2 * W)),
             ("hs_points", table(), points[centers.long()].reshape(-1),
              grads(B * points.shape[1])),
             ("ragged", table(), draw(corpus, 1), grads(1)),
             ("ragged", table(), draw(corpus, 1001), grads(1001)),
             ("ragged", table(d=1), draw(corpus, 1001), grads(1001, 1)),
             ("ragged", table(d=33), draw(corpus, 1001), grads(1001, 33)),
             ("hot_row", table(), torch.full((B,), 7, dtype=torch.int32, device=dev),
              grads(B))]
    rows = [scatter_case(torch, flush, t, i, g, label) for label, t, i, g in cases]
    torch.cuda.empty_cache()
    return rows


def _family(name: str) -> str:
    key = name.lower()
    for fam, marks in (("scatter_add", ("scatter_add_kernel",)),
                       ("sort", ("sort", "radix")),
                       ("matmuls", ("gemm", "gemv", "cutlass", "nvjet", "xmma", "dot_kernel",
                                    "splitk")),
                       ("rng", ("philox", "random", "distribution")),
                       ("gathers", ("index", "gather"))):
        if any(m in key for m in marks):
            return fam
    return "elementwise"


def w2v_profile(torch, model, sents) -> dict:
    """One corpus segment under torch.profiler: device ms by family, device
    busy against the segment's wall time, and the idle share. The segment
    runs once unprofiled first, timed: the tracer slows the host's launches,
    so the idle share is read against that run's wall time (the profiled
    run's is printed beside it)."""
    from torch.profiler import ProfilerActivity, profile

    corpus, sid, T, nvb = next(model._corpus_segments(
        lambda: (s.split() for s in sents)))
    lr = model.min_learning_rate
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model._train_corpus_segment(corpus, sid, nvb, lr)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses = model._train_corpus_segment(corpus, sid, nvb, lr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam = {k: 0.0 for k in ("scatter_add", "sort", "gathers", "matmuls", "rng",
                            "elementwise")}
    kernels = _kernel_times(prof)
    for name, ms in kernels:
        fam[_family(name)] += ms
    busy = sum(fam.values())
    return {"segment_tokens": T, "batches": nvb, "device_ms_by_family": fam,
            "device_busy_ms": busy, "wall_ms_profiled": wall_ms,
            "wall_ms_unprofiled": plain_wall_ms,
            "idle_share": max(0.0, 1.0 - busy / plain_wall_ms),
            "idle_share_profiled": max(0.0, 1.0 - busy / wall_ms),
            "host_us_per_batch_unprofiled": 1e3 * plain_wall_ms / nvb,
            "top_kernels_ms": [[name[:70], ms] for name, ms in kernels[:10]],
            "top_host_ops_self_ms": _host_ops(prof, 10),
            "mean_loss": float(losses.mean())}


def _host_ops(prof, top):
    """[op, host self ms, calls] of the ops that took the most host time in
    a profile (the tracer's own cost included)."""
    rows = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_cpu_time_total > 0]
    return [[k[:50], ms, n] for k, ms, n in sorted(rows, key=lambda r: -r[1])[:top]]


def w2v_quality(torch, dev) -> dict:
    """The four host-path modes and the corpus-resident path on the
    two-topic corpus, on the card, at tests/test_nlp.py's settings and
    margins (intra-topic cosine above inter-topic by 0.3, 0.25)."""
    from deeplearning4j_tpu_torch.nlp import Word2Vec

    out = {}
    for name, kw, n, margin in (
            ("sg_ns", dict(negative=5), 200, 0.3),
            ("sg_hs", dict(negative=0), 200, 0.3),
            ("cbow_ns", dict(negative=5, use_cbow=True, learning_rate=1.0, epochs=40),
             200, 0.3),
            ("cbow_hs", dict(negative=0, use_cbow=True), 200, 0.3),
            ("corpus", dict(device_corpus=True), 300, 0.25)):
        sents, animals, tools = two_topic_corpus(n=n)
        t0 = time.perf_counter()
        m = Word2Vec(device=dev, **dict(TWO_TOPIC_KW, **kw)).fit(sents)
        intra = float(np.mean([m.similarity(a, b) for a in animals for b in animals
                               if a != b]))
        inter = float(np.mean([m.similarity(a, t) for a in animals for t in tools]))
        out[name] = {"intra": intra, "inter": inter, "margin": margin,
                     "first_loss": m.loss_history[0], "last_loss": m.loss_history[-1],
                     "seconds": time.perf_counter() - t0}
        if not intra > inter + margin:
            raise AssertionError(f"word2vec {name} on the card: intra {intra:.3f} "
                                 f"not above inter {inter:.3f} + {margin}")
        if name == "corpus" and not m.loss_history[-1] < m.loss_history[0]:
            raise AssertionError(f"corpus path loss did not fall: {m.loss_history}")
    return out


def w2v_card_vs_cpu(torch, dev) -> dict:
    """A host-path SGNS fit of the two-topic corpus from one seed, on the
    card and on the CPU: the same pairs and negatives (numpy draws, fewer
    pairs than batch_size * 8, so no device-drawn macro). Tables within
    1e-4 absolute (float32 rounding of the sums; the same fit's port-vs-JAX
    drift on the CPU is 8.3e-7)."""
    from deeplearning4j_tpu_torch.nlp import Word2Vec

    sents, _, _ = two_topic_corpus(n=200)
    kw = dict(TWO_TOPIC_KW, batch_size=1024)
    card = Word2Vec(device=dev, **kw).fit(sents)
    cpu = Word2Vec(device="cpu", **kw).fit(sents)
    errs = {k: float((getattr(card, k).cpu() - getattr(cpu, k)).abs().max())
            for k in ("syn0", "syn1")}
    if max(errs.values()) > 1e-4:
        raise AssertionError(f"word2vec card vs CPU tables differ: {errs}")
    return {"max_abs_diff": errs, "max_abs": float(cpu.syn0.abs().max()),
            "loss_card": card.loss_history[-1], "loss_cpu": cpu.loss_history[-1],
            "batches": card.counters["batches"]}


def word2vec_phase(torch, dev, flush, card):
    """The main path: Word2Vec.fit at bench.py's full size on the card."""
    from deeplearning4j_tpu_torch.nlp import Word2Vec
    from deeplearning4j_tpu_torch.nlp.vocab import build_huffman

    t_phase = time.perf_counter()
    sents = w2v_corpus()
    model = Word2Vec(device=dev, **W2V_KW)
    _zero_launch_counts()
    t0 = time.perf_counter()
    model.fit(sents)                       # vocab, tables, first pass
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first = (model.syn0.clone(), model.syn1.clone())
    b0, s0 = model.counters["corpus_batches"], model.counters["corpus_segments"]
    _zero_launch_counts()
    t0 = time.perf_counter()
    model.fit(sents)                       # timed, as bench.py times its second fit
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    batches = model.counters["corpus_batches"] - b0
    words = model.vocab.total_word_occurrences
    if launches["scatter_add"] != 3 * batches or batches == 0:
        raise AssertionError(f"scatter_add launched {launches['scatter_add']} times in "
                             f"{batches} corpus batches (want 3 each)")
    if any(n for k, n in launches.items() if k != "scatter_add"):
        raise AssertionError(f"another kernel ran on the word2vec path: {launches}")
    if model.counters["batches"] or not np.isfinite(model.loss_history).all():
        raise AssertionError(f"host-path batches ran or a loss is not finite: "
                             f"{dict(model.counters)} {model.loss_history}")
    shape = (model.vocab.num_words(), W2V_KW["layer_size"])
    for name in ("syn0", "syn1"):
        table = getattr(model, name)
        if tuple(table.shape) != shape or not bool(torch.isfinite(table).all()):
            raise AssertionError(f"{name}: shape {tuple(table.shape)} (want {shape}) "
                                 "or non-finite entries")
    # a second model from the same seed: its first fit, bitwise
    twin = Word2Vec(device=dev, **W2V_KW).fit(sents)
    repeat = {k: _bits_equal(torch, a, getattr(twin, k))
              for k, a in zip(("syn0", "syn1"), first)}
    if not all(repeat.values()):
        raise AssertionError(f"two fits from one seed differ: {repeat}")
    del twin, first
    summary = {"card": card, "vocab": model.vocab.num_words(), "tokens": words,
               "layer_size": W2V_KW["layer_size"], "batch_size": W2V_KW["batch_size"],
               "segments": model.counters["corpus_segments"] - s0,
               "batches": batches, "pairs_drawn": batches * W2V_KW["batch_size"],
               "seconds": seconds, "first_fit_seconds": first_s,
               "words_per_s": words / seconds, "scatter_add_launches": launches["scatter_add"],
               "first_fit_batches": b0, "loss_per_epoch_both_fits": model.loss_history,
               "two_fits_bitwise": repeat}
    print("word2vec " + json.dumps(summary), flush=True)
    print("word2vec_profile " + json.dumps(w2v_profile(torch, model, sents)), flush=True)
    corpus = next(model._corpus_segments(lambda: (s.split() for s in sents)))[0]
    points = torch.from_numpy(build_huffman(model.vocab)[1]).to(dev)
    neg_table, v = model._neg_table_device(), model.vocab.num_words()
    del model
    rows = scatter_kernel_phase(torch, dev, flush, v, corpus, neg_table, points)
    print("word2vec_quality " + json.dumps(w2v_quality(torch, dev)), flush=True)
    print("word2vec_card_vs_cpu " + json.dumps(w2v_card_vs_cpu(torch, dev)), flush=True)
    torch.cuda.empty_cache()
    print(f"word2vec phase ran {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows, summary


def _scatter_kernel_entry(rows, summary):
    """The kernels-line entry of scatter_add: numbers at the corpus path's
    contexts shape (N = 8192, D = 128), the two other per-batch shapes
    beside, max error over every case."""
    head = {r["case"]: r for r in rows}
    main = head["corpus_contexts"]
    return {"name": "scatter_add", "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/scatter_add.cu",
            "replaces": "deeplearning4j_tpu/nlp/pallas_scatter.py:35",
            "launches": summary["scatter_add_launches"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "wrapper_ms": main["wrapper_ms"],
            "shape": {k: main[k] for k in ("V", "D", "N")},
            "other_main_path_shapes": {c: {k: head[c][k] for k in (
                "N", "ms", "wrapper_ms", "plain_ms", "bound_ms", "library_ms")}
                for c in ("corpus_centers", "corpus_negatives")}}

def _build_dir():
    from deeplearning4j_tpu_torch.perf.kernels import _build
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    return _build.BUILD


def _adc_kernel_entry(name, rows, launches, replaces_line):
    """The kernels-line entry of adc_pq or adc_ivf_pq: numbers at b = 256 on
    the 1M-vector index, max error over every case."""
    head = next(r for r in rows if r["b"] == max(ADC_BATCHES) and r["case"] != "ragged")
    return {"name": name, "route": "cuda",
            "source": f"deeplearning4j_tpu_torch/csrc/{name}.cu",
            "replaces": f"deeplearning4j_tpu/perf/pallas/adc.py:{replaces_line}",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": {k: head[k] for k in ("b", "n", "C", "p", "M", "ksub") if k in head}}


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
    names = ["int4_dot", "bn_act_fwd", "bn_act_bwd", "adc_pq", "adc_ivf_pq",
             "scatter_add"]
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
    pq_rows, ivf_rows, int4_retr, served = retrieval_phase(torch, dev, flush, card)
    scatter_rows, w2v = word2vec_phase(torch, dev, flush, card)

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
        # both of its paths: VGG16 serving and the int4 brute-force index
        "launches": launches + served["int4"]["launches"],
        "launches_by_path": {"vgg16_serving": launches,
                             "retrieval_int4": served["int4"]["launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows + [fc1, int4_retr]),
        "ms": fc1["ms"], "plain_ms": fc1["plain_ms"], "bound_ms": fc1["bound_ms"],
        "bound_by": fc1["bound_by"], "library_ms": fc1["library_ms"],
        "shape": {"b": b, "n": n, "d": d},
        "retrieval_shape": {k: int4_retr[k] for k in (
            "b", "n", "d", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        _bn_kernel_entry("bn_act_fwd", bn_rows, bn_fwd),
        _bn_kernel_entry("bn_act_bwd", bn_rows, bn_bwd),
        _adc_kernel_entry("adc_pq", pq_rows, served["pq"]["launches"], 59),
        _adc_kernel_entry("adc_ivf_pq", ivf_rows, served["ivf_pq"]["launches"], 103),
        _scatter_kernel_entry(scatter_rows, w2v)]}),
        flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
