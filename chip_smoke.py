#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deeplearning4j_tpu_torch) on one card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every CUDA kernel of the port from csrc/ (one nvcc per source, all
   started together) and prints the build seconds and a summary of nvcc's
   -Xptxas -v report (registers, shared memory, spills). The first designs
   of int4_dot and flash_attn_fwd (csrc/*_v1.cu) are built beside them and
   timed on the same operands as "previous_ms".
3. Kernel phases: holds each kernel against its plain PyTorch version on the
   card at the shapes its path gives it, and times both (CUDA events, median
   of 25 launches after warm-up, L2 flushed before each launch), beside the
   bound the card's published peaks allow and a library call that computes
   the same function (a yardstick the port never calls).
   - int4_dot, bitwise against its plain version and against itself, at
     VGG16's fc shapes.
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
     is printed (its sum order may differ). int4_dot at (b, 1M, 64) for the
     same b, bitwise against its plain version and itself.
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
9. Flash attention kernel phase: flash_attn_fwd against its plain version
   (parallel/ring_attention.reference_attention) at the transformer path's
   (1, 12, 1024, 64) and (8, 12, 1024, 64) causal, read as head-split views
   of (b, t, h, d) tensors as the path gives them, (8, 12, 1024, 64)
   non-causal contiguous, (4, 8, 4096, 128) causal in float32 and bf16, and
   ragged (3, 5, 1000, 40) causal and not, (2, 3, 129, 256), (1, 1, 1, 1).
   Each element within 1e-5 * max|v| in float32 (the online softmax sums
   and rescales in another order); in bf16 within one bf16 ulp of its own
   |plain| more, the plain version computed in float32 from the same bf16
   inputs (the kernel rounds once, at the output). Two launches agree
   bitwise; the output keeps the inputs' layout. Kernel, its first design,
   plain version and F.scaled_dot_product_attention (whose max |diff| is
   printed) timed beside the bound.
10. Transformer serving phase: a causal LM at GPT-2 small's widths (768
   wide, 12 heads, 12 blocks, FFN 3072, t = 1024, vocab 50,257; random
   weights from a seed) built with the port's builder and served by
   ParallelInference(batch_limit=8) over a window of 128 one-row requests
   from 16 client threads, enough to fill the 8-row bucket; p50/p90/p99
   request ms, tokens/s and bucket occupancy over the whole window. Every
   answer is checked (shape, finite, rows summing to 1 within 1e-4);
   flash_attn_fwd must launch 12 times per dispatch, the attention path
   counters read 12 flash calls per dispatch and no dense one, and no other
   kernel runs. A new last token must leave the first 1023 positions
   bitwise unchanged on the card. One request is recomputed by
   net.to("cpu") through the plain versions (float32 matmuls without TF32
   on the card): log-probabilities within 1e-4, which the same request with
   TF32 products on the card must exceed, and top-1 ids equal wherever the
   top-2 log-probabilities are more than 2e-4 apart. One full dispatch is
   profiled by kernel family, with the device idle share from that same
   dispatch's trace and wall time.
11. Flash attention backward kernel phase: flash_attn_bwd_dkv and
   flash_attn_bwd_dq against their plain versions (dense math from the
   forward's L and D = rowsum(dO * o)) at the training path's (8, 12, 1024,
   64) causal, read as head-split views with dO as _unheads' backward
   gives it, (4, 8, 4096, 128) causal in float32 and bf16, ragged (3, 5,
   1000, 40) causal and not, (2, 3, 129, 256), (1, 1, 1, 1). float32: each
   gradient's distance to a float64 plain referee (from the same L and D)
   within 2x the plain float32 version's own, or 1e-5 of its largest
   magnitude; bf16: each element within 2 bf16 ulps of the plain float32
   version's magnitude there plus 1/8 ulp of its largest (the plain version
   computed in float32 from the same bf16 inputs). Two launches agree
   bitwise; gradients keep their inputs' layouts; L within 1e-5 of
   logsumexp of the plain scores. Each kernel, each plain version and the
   autograd backward of F.scaled_dot_product_attention timed beside the
   bounds.
12. Transformer training phase, the main path of this slice: the LM of 10
   trained through MultiLayerNetwork.fit with Adam(1e-4) on one seeded batch
   of 8 x 1024 ids and next-token one-hot labels (1.65 GB), made on the
   card, in float32 and then in bf16 with float32 masters; 3 warm-up and 10
   timed steps each. Every loss finite, the last below the first; each step
   launches flash_attn_fwd, flash_attn_bwd_dkv and flash_attn_bwd_dq 12
   times each and no other kernel, with 12 flash calls and no dense one.
   Step ms, tokens/s, peak memory; one step profiled by kernel family, with
   the idle share from that same step's trace and wall time.
13. Training card against CPU: one Adam step of the LM at full width with 2
   blocks, batch 1 x t 1024 (the flash path), float32, on the card and on
   the CPU with copied weights, and in float64 on the CPU as the referee:
   loss, the gradients of W_q, W_k, W_v in both blocks and the updated
   weights within the limits lm_training_card_vs_cpu states; a control step
   with the dK/dV kernel's outputs zeroed must miss the W_k and W_v limits.
14. LeNet (BASELINE configs[0]) through fit at batch 64: losses finite and
   falling.
15. Prints the kernels JSON line (nine kernels), the card line, and last
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
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
# flash attention: (b, h, t, d, causal, dtype, layout). The transformer
# path's shapes at 1 and 8 rows (a dispatch pads to 8) in the path's own
# layout ("bthd": head-split views of (b, t, h, d) projections), the bf16
# training run's shape and layout, the same shape contiguous and
# non-causal, the JAX package's docstring shape (ring_attention.py:111) in
# float32 and bf16, and ragged ones
FLASH_CASES = [
    (1, 12, 1024, 64, True, "float32", "bthd"),
    (8, 12, 1024, 64, True, "float32", "bthd"),
    (8, 12, 1024, 64, True, "bfloat16", "bthd"),
    (8, 12, 1024, 64, False, "float32", "bhtd"),
    (4, 8, 4096, 128, True, "float32", "bhtd"),
    (4, 8, 4096, 128, True, "bfloat16", "bhtd"),
    (3, 5, 1000, 40, True, "float32", "bhtd"),
    (3, 5, 1000, 40, False, "float32", "bhtd"),
    (2, 3, 129, 256, True, "float32", "bhtd"),
    (1, 1, 1, 1, False, "float32", "bhtd"),
]
FLASH_PATH_CASE = (8, 12, 1024, 64, True, "float32", "bthd")
# transformer serving: GPT-2 small's widths (openai-community/gpt2
# config.json: n_embd 768, n_head 12, n_layer 12, n_ctx 1024, vocab 50,257;
# FFN 4 x 768), random weights from a seed. The repo's architecture has no
# position embedding, no final LayerNorm and an untied output layer.
LM_VOCAB, LM_WIDTH, LM_HEADS, LM_BLOCKS, LM_T = 50257, 768, 12, 12, 1024
# the serving window: 16 clients, each sending 8 one-row requests (one
# 1024-token sequence) in turn, so 8 requests queue behind the 8 in flight
# and every dispatch fills the 8-row bucket; 128 requests in all
LM_BATCH, LM_CLIENTS, LM_REQUESTS = 8, 16, 8
# card against CPU, on log-probabilities: the card's float32 path must stay
# within this of the CPU's, and the same request with TF32 products must not
LM_LOGP_LIMIT = 1e-4
# flash attention backward: (b, h, t, d, causal, dtype, layout). The training
# path's shape in its own layout (q, k, v and dO head-split views of (b, t, h,
# d) tensors, dO as _unheads' backward gives it) in float32 and in bf16 (the
# two training runs), the JAX package's docstring shape (ring_attention.py:111)
# in float32 and bf16, and ragged ones
FLASH_BWD_CASES = [
    (8, 12, 1024, 64, True, "float32", "bthd"),
    (8, 12, 1024, 64, True, "bfloat16", "bthd"),
    (4, 8, 4096, 128, True, "float32", "bhtd"),
    (4, 8, 4096, 128, True, "bfloat16", "bhtd"),
    (3, 5, 1000, 40, True, "float32", "bhtd"),
    (3, 5, 1000, 40, False, "float32", "bhtd"),
    (2, 3, 129, 256, True, "float32", "bhtd"),
    (1, 1, 1, 1, False, "float32", "bhtd"),
]
# the backward's limits (see _bwd_limit) and L's (absolute; L is O(10), so
# about ten float32 ulps)
FLASH_BWD_F32_MULT, FLASH_BWD_F32_FRAC, FLASH_BWD_BF16_ULPS = 2.0, 1e-5, 2
L_LIMIT = 1e-5
# LM training through fit: 3 warm-up and 10 timed steps per dtype; the card
# against CPU step at full width and 2 blocks, in both dtypes; the loss's
# floor is 1e-6 of it in float32 and, in bf16, LM_CHECK_FRAC of it, as the
# gradients' floor is
LM_TRAIN_WARM, LM_TRAIN_STEPS = 3, 10
LM_CHECK_BLOCKS, LM_CHECK_MULT, LM_CHECK_FRAC = 2, 4.0, 1e-4
LM_CHECK_LOSS_FRAC = {"float32": 1e-6, "bfloat16": LM_CHECK_FRAC}
LENET_BATCH, LENET_STEPS = 64, 10


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


def _first_design(name: str, argtypes):
    """The C entry of a kernel's first design (csrc/<name>_v1.cu), the
    yardstick its redesign is timed against: previous_ms. ``argtypes``
    leaves out the trailing stream."""
    import ctypes

    from deeplearning4j_tpu_torch.perf.kernels import _build
    fn = getattr(_build.load(f"{name}_v1"), f"{name}_v1_launch")
    fn.argtypes = list(argtypes) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def first_design_int4(torch, qq, packed, d: int):
    """int4_dot's first design (one warp per table row) on the same operands."""
    import ctypes
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = _first_design("int4_dot", [P, L, P, L, P, L, I, I, I])
    out = torch.empty((qq.shape[0], packed.shape[0]), dtype=torch.int32, device=qq.device)
    err = fn(qq.data_ptr(), qq.stride(0), packed.data_ptr(), packed.stride(0),
             out.data_ptr(), out.stride(0), qq.shape[0], packed.shape[0], d,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"int4_dot_v1 launch failed with CUDA error {err}")
    return out


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
    again = int4_dot.int4_matmul(qq, packed, d)
    if not torch.equal(got, again):
        raise AssertionError(f"int4_dot: two launches differ at b={b} n={n} d={d}")
    del again
    ms = time_ms(torch, lambda: int4_dot.int4_matmul(qq, packed, d), flush)
    previous_ms = time_ms(torch, lambda: first_design_int4(torch, qq, packed, d), flush)
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
           "previous_ms": previous_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms, "library": library_note}
    print("int4_dot " + json.dumps(row), flush=True)
    return row


INT4_KEYS = ("b", "n", "d", "ms", "previous_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")


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
    int4_rows = [kernel_case(torch, dev, flush, b, RETR_N, RETR_D) for b in ADC_BATCHES]
    torch.cuda.empty_cache()
    return pq_rows, ivf_rows, int4_rows


def _search_all(ix, Q, k, chunk=256):
    parts = [ix.search(Q[lo:lo + chunk], k) for lo in range(0, len(Q), chunk)]
    return (np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]))


KERNEL_OF = {"int4": "int4_dot", "pq": "adc_pq", "ivf_pq": "adc_ivf_pq"}


def _launch_counts():
    from deeplearning4j_tpu_torch.perf.kernels import (adc, bn_act, flash_attention,
                                                       int4_dot, scatter_add)
    return {"int4_dot": int4_dot.launches, "adc_pq": adc.pq_launches,
            "adc_ivf_pq": adc.ivf_pq_launches, "bn_act_fwd": bn_act.fwd_launches,
            "bn_act_bwd": bn_act.bwd_launches, "scatter_add": scatter_add.launches,
            "flash_attn_fwd": flash_attention.launches,
            "flash_attn_bwd_dkv": flash_attention.launches_bwd_dkv,
            "flash_attn_bwd_dq": flash_attention.launches_bwd_dq}


def _zero_launch_counts():
    from deeplearning4j_tpu_torch.perf.kernels import (adc, bn_act, flash_attention,
                                                       int4_dot, scatter_add)
    int4_dot.launches = adc.pq_launches = adc.ivf_pq_launches = 0
    bn_act.fwd_launches = bn_act.bwd_launches = scatter_add.launches = 0
    flash_attention.launches = 0
    flash_attention.launches_bwd_dkv = flash_attention.launches_bwd_dq = 0


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
    pq_rows, ivf_rows, int4_rows = adc_kernel_phase(torch, dev, flush, Q, ix["pq"],
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
    return pq_rows, ivf_rows, int4_rows, served



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

# ---------------------------------------------------------- transformer
def _flash_tol(torch, want, vmax, dtype):
    """Each element's limit: 1e-5 * max|v| in float32 (the online softmax
    sums and rescales in another order); in bf16, one bf16 ulp of the
    element's own |want| on top of that (the kernel rounds once, at the
    output)."""
    tol = torch.full_like(want, 1e-5 * vmax)
    return tol if dtype == torch.float32 else tol + _bf16_ulp(torch, want.abs())


def first_design_flash(torch, q, k, v, causal):
    """flash_attn_fwd's first design (float32 CUDA-core tiles for both
    dtypes) on the same operands, no L: the serving call."""
    import ctypes
    fn = _first_design("flash_attn_fwd", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6)
    o = torch.empty_like(q)
    b, h, t, d = q.shape
    strides = (ctypes.c_longlong * 12)(*(x for a in (q, k, v, o) for x in a.stride()[:3]))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None,
             ctypes.addressof(strides), b, h, t, d, int(q.dtype == torch.bfloat16),
             int(causal), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attn_fwd_v1 launch failed with CUDA error {err}")
    return o


def flash_case(torch, dev, flush, b, h, t, d, causal, dtype_name, layout) -> dict:
    """Hold flash_attn_fwd against its plain version at one shape, element
    by element within :func:`_flash_tol` (bf16 against the plain version
    computed in float32 from the same bf16 inputs), and against itself
    bitwise; time the kernel, the plain version in the case's dtype and
    F.scaled_dot_product_attention beside the bound. ``layout`` "bthd" makes
    q, k, v head-split views of (b, t, h, d) tensors, as the attention
    layers give them; the output must come back in that layout."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.parallel.ring_attention import reference_attention
    from deeplearning4j_tpu_torch.perf.kernels import flash_attention as fa

    dt = getattr(torch, dtype_name)
    gen = torch.Generator(device=dev)
    gen.manual_seed(b * 1000003 + h * 1009 + t * 31 + d)
    shape = (b, t, h, d) if layout == "bthd" else (b, h, t, d)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
               for _ in range(3))
    if layout == "bthd":
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
    got = fa.flash_attention(q, k, v, causal=causal)
    again = fa.flash_attention(q, k, v, causal=causal)
    want = reference_attention(q.float(), k.float(), v.float(), causal=causal)
    lib = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    torch.cuda.synchronize()
    what = f"flash_attn_fwd ({b}, {h}, {t}, {d}) {dtype_name} {layout} causal={causal}"
    vmax = float(v.float().abs().max())
    if got.shape != q.shape or got.dtype != dt or got.stride() != q.stride():
        raise AssertionError(f"{what}: output {tuple(got.shape)} {got.dtype} strides "
                             f"{got.stride()}, inputs' strides {q.stride()}")
    diff = (got.float() - want).abs()
    err = float(diff.max())
    over = float((diff / _flash_tol(torch, want, vmax, dt)).max())
    if not over <= 1.0:
        raise AssertionError(f"{what}: max |kernel - plain| {err} is {over} times its "
                             f"element's limit")
    bits = torch.int32 if dt == torch.float32 else torch.int16
    if not torch.equal(got.view(bits), again.view(bits)):
        raise AssertionError(f"{what}: two launches differ")
    lib_diff = _max_err(lib, want)
    del got, again, want, lib, diff
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal), flush)
    previous_ms = time_ms(torch, lambda: first_design_flash(torch, q, k, v, causal), flush)
    plain_ms = time_ms(torch, lambda: reference_attention(q, k, v, causal=causal), flush)
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal), flush)
    # the entries this run's masks keep: t*(t+1)/2 per (b, h) when causal;
    # a multiply and an add for each of q.k and p.v over d
    pairs = t * (t + 1) // 2 if causal else t * t
    bound_ms, bound_by = bytes_ops_bound(
        4 * b * h * t * d * q.element_size(), 4.0 * b * h * pairs * d,
        PEAK_F32_OPS_PER_S if dt == torch.float32 else PEAK_BF16_OPS_PER_S)
    del q, k, v
    torch.cuda.empty_cache()
    row = {"b": b, "h": h, "t": t, "d": d, "causal": causal, "dtype": dtype_name,
           "layout": layout, "max_abs_err": err, "max_err_over_limit": over,
           "max_abs_v": vmax, "ms": ms, "previous_ms": previous_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms, "library": "F.scaled_dot_product_attention",
           "library_max_abs_diff": lib_diff}
    print("flash_attn_fwd " + json.dumps(row), flush=True)
    return row


def flash_kernel_phase(torch, dev, flush):
    return [flash_case(torch, dev, flush, *case) for case in FLASH_CASES]


def lm_conf(blocks=None):
    """The GPT-2-small-width causal LM, built with the port's builder
    (``blocks`` deep, LM_BLOCKS by default)."""
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.attention import TransformerEncoderBlock
    from deeplearning4j_tpu_torch.nn.conf.recurrent import (EmbeddingSequenceLayer,
                                                            RnnOutputLayer)
    from deeplearning4j_tpu_torch.optimize.updaters import Adam

    lb = (NeuralNetConfiguration.builder().seed(5).updater(Adam(1e-4))
          .weight_init("xavier").list()
          .layer(EmbeddingSequenceLayer(n_in=LM_VOCAB, n_out=LM_WIDTH)))
    for _ in range(LM_BLOCKS if blocks is None else blocks):
        lb = lb.layer(TransformerEncoderBlock(n_heads=LM_HEADS, causal=True))
    return (lb.layer(RnnOutputLayer(n_out=LM_VOCAB, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.recurrent(LM_VOCAB, LM_T)).build())


def _lm_family(name: str) -> str:
    key = name.lower()
    for fam, marks in (("flash_attn_fwd", ("flash_fwd_",)),
                       ("host_copy", ("memcpy",)),
                       ("softmax", ("softmax",)),
                       ("matmuls", ("gemm", "gemv", "cutlass", "nvjet", "xmma", "splitk"))):
        if any(m in key for m in marks):
            return fam
    return "elementwise"


def _union_ms(spans) -> float:
    """Length of the union of (start, end) spans, in ms (spans in us)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def lm_dispatch_profile(torch, pi, x) -> dict:
    """One dispatch of ``x`` (a full bucket) under torch.profiler. Device ms
    by kernel family; the device's busy time as the union of its kernels'
    and copies' spans in the trace; and the idle share of that same
    dispatch against its own wall time on the host clock, with the copy to
    the host counted as busy (``idle_share``) and not
    (``idle_share_but_copy``). The wall time of an unprofiled dispatch is
    printed beside, to show the tracer's cost; it enters no ratio."""
    from torch.profiler import ProfilerActivity, profile

    pi.output(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pi.output(x)
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pi.output(x)  # synchronous: ends when the rows are on the host
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam = {k: 0.0 for k in ("flash_attn_fwd", "matmuls", "softmax", "elementwise",
                            "host_copy")}
    kernels = _kernel_times(prof)
    for name, ms in kernels:
        fam[_lm_family(name)] += ms
    spans, compute_spans = [], []
    for evt in prof.events():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        span = (float(evt.time_range.start), float(evt.time_range.end))
        if span[1] <= span[0]:
            continue
        spans.append(span)
        if _lm_family(evt.name) != "host_copy":
            compute_spans.append(span)
    busy, compute = _union_ms(spans), _union_ms(compute_spans)
    if not spans:
        raise AssertionError("transformer: the profile recorded no device activity")
    if fam["flash_attn_fwd"] == 0.0:
        raise AssertionError("transformer: the profile found no flash_attn_fwd kernel")
    return {"rows": len(x), "bucket": pi._pad_target(len(x)),
            "device_ms_by_family": fam, "device_busy_ms": busy,
            "kernel_busy_ms": compute, "wall_ms": wall_ms,
            "idle_share": 1.0 - busy / wall_ms,
            "idle_share_but_copy": 1.0 - compute / wall_ms,
            "wall_ms_unprofiled": plain_wall_ms,
            "host_copy_mb": len(x) * LM_T * LM_VOCAB * 4 / 1e6,
            "top_kernels_ms": [[name[:70], ms] for name, ms in kernels[:10]]}


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    return tree.numel()


def _logp_check(torch, net, x, served) -> dict:
    """Card against CPU on one request: ``net.to("cpu")`` recomputes it
    through the plain versions, and the card recomputes it once more with
    TF32 products as a control. Log-probabilities are compared, so every
    class weighs alike whatever its probability: the card's float32 path
    must stay within LM_LOGP_LIMIT of the CPU and the TF32 control must
    not, which shows the limit can tell a wrong path. Top-1 ids must agree
    wherever the CPU's top-2 log-probabilities are more than twice the
    limit apart."""
    t0 = time.perf_counter()
    cpu = net.to("cpu")
    cpu_p = cpu.output(x).numpy()
    cpu_s = time.perf_counter() - t0
    del cpu
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_p = net.output(x).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    lp_cpu = np.log(cpu_p.astype(np.float64))
    err = float(np.abs(np.log(served.astype(np.float64)) - lp_cpu).max())
    tf32_err = float(np.abs(np.log(tf32_p.astype(np.float64)) - lp_cpu).max())
    top2 = np.partition(lp_cpu, -2, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * LM_LOGP_LIMIT
    top1_diff = served.argmax(-1) != cpu_p.argmax(-1)
    out = {"rows": len(x), "cpu_s": cpu_s,
           "max_abs_logp_diff": err, "tf32_control_max_abs_logp_diff": tf32_err,
           "limit": LM_LOGP_LIMIT, "max_abs_p_diff": float(np.abs(served - cpu_p).max()),
           "top1_decided_positions": int(decided.sum()),
           "top1_diffs_where_decided": int((top1_diff & decided).sum()),
           "top1_diffs": int(top1_diff.sum())}
    print("transformer_card_vs_cpu " + json.dumps(out), flush=True)
    if not err <= LM_LOGP_LIMIT < tf32_err or out["top1_diffs_where_decided"]:
        raise AssertionError(f"transformer: card vs CPU {out}")
    return out


def transformer_phase(torch, dev, card):
    """The main path: the GPT-2-small-width LM served by ParallelInference
    over a window of LM_CLIENTS * LM_REQUESTS one-row requests."""
    from deeplearning4j_tpu_torch.nn.conf import attention
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import ParallelInference

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    net = MultiLayerNetwork(lm_conf(), dev).init()
    n_params = sum(_numel(p) for p in net.params)
    pi = ParallelInference(net, batch_limit=LM_BATCH)
    rng = np.random.default_rng(99)
    pi.output(rng.integers(0, LM_VOCAB, (1, LM_T)).astype(np.int32))  # first touch
    full = rng.integers(0, LM_VOCAB, (LM_BATCH, LM_T)).astype(np.int32)
    answers, kept, errors = [], [], []

    def client(cid):
        crng = np.random.default_rng(100 + cid)
        reqs = [crng.integers(0, LM_VOCAB, (1, LM_T)).astype(np.int32)
                for _ in range(LM_REQUESTS)]
        try:
            for i, x in enumerate(reqs):
                t0 = time.perf_counter()
                out = pi.submit(x).get(timeout=600)
                lat = time.perf_counter() - t0
                # a NaN or an infinity anywhere in a row leaves its sum
                # non-finite, so finite sums within 1e-4 of 1 check both
                sums = out.sum(axis=-1, dtype=np.float64)
                ok = (out.shape == (len(x), LM_T, LM_VOCAB) and out.dtype == np.float32
                      and bool(np.isfinite(sums).all())
                      and float(np.abs(sums - 1.0).max()) <= 1e-4)
                answers.append((len(x), lat, ok))
                if cid == 0 and i == 0:
                    kept.append((x, out))
        except Exception as e:  # re-raised on the main thread below
            errors.append(e)

    torch.cuda.reset_peak_memory_stats()
    stats0 = pi.stats()
    try:
        _zero_launch_counts()
        for name in attention.counters:
            attention.counters[name] = 0
        threads = [threading.Thread(target=client, args=(c,)) for c in range(LM_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches, paths = _launch_counts(), dict(attention.counters)
        stats = pi.stats()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if errors:
            raise errors[0]
        want = LM_CLIENTS * LM_REQUESTS
        if any(t.is_alive() for t in threads) or len(answers) != want:
            raise AssertionError(f"transformer: {len(answers)} of {want} requests answered")
        if not all(ok for _, _, ok in answers):
            raise AssertionError(f"transformer: {sum(not a[2] for a in answers)} answers "
                                 "of the wrong shape, not finite, or not summing to 1")
        dispatches = stats["batches_dispatched"] - stats0["batches_dispatched"]
        if (launches["flash_attn_fwd"] != LM_BLOCKS * dispatches or dispatches == 0
                or paths["attention.flash"] != LM_BLOCKS * dispatches
                or paths["attention.dense"] != 0):
            raise AssertionError(f"transformer: flash_attn_fwd launched "
                                 f"{launches['flash_attn_fwd']} times, paths {paths}, for "
                                 f"{dispatches} dispatches (want {LM_BLOCKS} flash each)")
        if any(n for k, n in launches.items() if k != "flash_attn_fwd"):
            raise AssertionError(f"another kernel ran on the transformer path: {launches}")
        buckets = {k: n - stats0["bucket_dispatches"].get(k, 0)
                   for k, n in stats["bucket_dispatches"].items()}
        profile = lm_dispatch_profile(torch, pi, full)
    finally:
        pi.shutdown()

    # causality on the card: a new last token moves no earlier position
    x = kept[0][0]
    x2 = x.copy()
    x2[0, -1] = (x2[0, -1] + 1) % LM_VOCAB
    a, b2 = net.output(x), net.output(x2)
    causal_bitwise = torch.equal(a[:, :-1].contiguous().view(torch.int32),
                                 b2[:, :-1].contiguous().view(torch.int32))
    if not causal_bitwise or torch.equal(a[:, -1], b2[:, -1]):
        raise AssertionError("transformer: the last token moved an earlier position, "
                             "or did not move its own")
    del a, b2

    check = _logp_check(torch, net, *kept[0])
    lat = np.array([r[1] for r in answers]) * 1e3
    rows = sum(r[0] for r in answers)
    summary = {
        "card": card, "params": n_params, "vocab": LM_VOCAB, "width": LM_WIDTH,
        "heads": LM_HEADS, "blocks": LM_BLOCKS, "t": LM_T,
        "clients": LM_CLIENTS, "batch_limit": LM_BATCH,
        "requests": len(answers), "rows": rows, "dispatches": dispatches,
        "bucket_dispatches": buckets,
        "bucket_occupancy": rows / sum(int(k) * n for k, n in buckets.items()),
        "flash_attn_fwd_launches": launches["flash_attn_fwd"], "attention_paths": paths,
        "p50_request_ms": float(np.percentile(lat, 50)),
        "p90_request_ms": float(np.percentile(lat, 90)),
        "p99_request_ms": float(np.percentile(lat, 99)),
        "max_request_ms": float(lat.max()), "serving_wall_s": wall,
        "requests_per_s": len(answers) / wall, "tokens_per_s": rows * LM_T / wall,
        "peak_memory_gb": peak_gb, "causal_prefix_bitwise": causal_bitwise,
        "cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "card_vs_cpu": check,
    }
    del net, answers, kept
    torch.cuda.empty_cache()
    print("transformer " + json.dumps(summary), flush=True)
    print("transformer_profile " + json.dumps(profile), flush=True)
    print(f"transformer phase ran {time.perf_counter() - t_phase:.1f} s", flush=True)
    return summary


def _launches_by_path(name, train, serving=None):
    """A kernel's launches on each main path this run drove (the serving
    window, each training run) and their sum."""
    paths = {} if serving is None else {"transformer_serving": serving}
    paths.update({f"lm_training_{dt}": r["launches"][name] for dt, r in train.items()})
    return {"launches": sum(paths.values()), "launches_are": "the sum of launches_by_path",
            "launches_by_path": paths}


def _flash_kernel_entry(rows, summary, train):
    """The kernels-line entry of flash_attn_fwd: numbers at the serving
    path's shape and layout, (8, 12, 1024, 64) causal float32 head-split
    views, which is the float32 training run's too; launches on every path
    (the serving window and both training runs); the other shapes
    beside."""
    key = ("b", "h", "t", "d", "causal", "dtype", "layout")
    main = next(r for r in rows if tuple(r[k] for k in key) == FLASH_PATH_CASE)
    return {"name": "flash_attn_fwd", "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/flash_attn_fwd.cu",
            "replaces": "deeplearning4j_tpu/parallel/ring_attention.py:108",
            **_launches_by_path("flash_attn_fwd", train, summary["flash_attn_fwd_launches"]),
            "max_abs_err": main["max_abs_err"],
            "max_err_over_limit_all_cases": max(r["max_err_over_limit"] for r in rows),
            "ms": main["ms"], "previous_ms": main["previous_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": {k: main[k] for k in key},
            "other_shapes": [{k: r[k] for k in key + ("ms", "previous_ms", "plain_ms",
                                                      "bound_ms", "library_ms")}
                             for r in rows if r is not main]}


# --------------------------------------------------------- transformer training
def _bwd_limit(torch, got, plain, ref, dtype):
    """(max |kernel - plain|, max limit ratio, the stated limit) for one
    gradient tensor. float32: the kernel's distance to the float64 referee
    within FLASH_BWD_F32_MULT times the plain float32 version's own, or
    FLASH_BWD_F32_FRAC of the referee's largest magnitude, whichever is
    larger. bf16: each element within FLASH_BWD_BF16_ULPS bf16 ulps of the
    plain float32 version's magnitude there, plus 1/8 ulp of its largest
    magnitude (where the float32 sums' own order shows)."""
    err = _max_err(got, plain)
    if dtype == torch.float32:
        kernel_err = float((got.double() - ref).abs().max())
        plain_err = float((plain.double() - ref).abs().max())
        limit = max(FLASH_BWD_F32_MULT * plain_err, FLASH_BWD_F32_FRAC * float(ref.abs().max()))
        return err, kernel_err / limit, {"kernel_vs_f64": kernel_err, "plain_vs_f64": plain_err,
                                         "limit": limit}
    top = _bf16_ulp(torch, plain.abs().max()) / 8
    tol = FLASH_BWD_BF16_ULPS * _bf16_ulp(torch, plain.abs()) + top
    return err, float(((got.float() - plain).abs() / tol).max()), {"ulps": FLASH_BWD_BF16_ULPS}


def flash_bwd_case(torch, dev, flush, b, h, t, d, causal, dtype_name, layout) -> dict:
    """Hold flash_attn_bwd_dkv and flash_attn_bwd_dq against their plain
    versions at one shape (limits in :func:`_bwd_limit`), against
    themselves bitwise, and the forward's L against logsumexp of the plain
    float32 scores (within L_LIMIT); time each kernel, each plain version
    and the autograd backward of F.scaled_dot_product_attention (dq, dk and
    dv in one call) beside the bounds. ``layout`` "bthd" makes q, k, v and
    dO head-split views of (b, t, h, d) tensors, dO as _unheads' backward
    gives it; the gradients must come back in those layouts."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.perf.kernels import flash_attention as fa

    dt = getattr(torch, dtype_name)
    gen = torch.Generator(device=dev)
    gen.manual_seed(b * 1000003 + h * 1009 + t * 31 + d + 7)
    shape = (b, t, h, d) if layout == "bthd" else (b, h, t, d)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dt) for _ in range(4))
    if layout == "bthd":
        q, k, v, do = (a.transpose(1, 2) for a in (q, k, v, do))
    what = f"flash_attn_bwd ({b}, {h}, {t}, {d}) {dtype_name} {layout} causal={causal}"
    o, lse = fa.flash_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    f32 = [a.float() for a in (q, k, v, do)]
    l_err = _max_err(lse, fa.flash_fwd_plain(*f32[:3], causal)[1])
    if not l_err <= L_LIMIT:
        raise AssertionError(f"{what}: max |L - plain logsumexp| {l_err} > {L_LIMIT}")
    row = {"b": b, "h": h, "t": t, "d": d, "causal": causal, "dtype": dtype_name,
           "layout": layout, "L_max_abs_err": l_err}
    kernels = {"flash_attn_bwd_dkv": (fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, (k, v)),
               "flash_attn_bwd_dq": (lambda *a: (fa.flash_bwd_dq(*a),),
                                     lambda *a: (fa.flash_bwd_dq_plain(*a),), (q,))}
    bits = torch.int32 if dt == torch.float32 else torch.int16
    pairs = t * (t + 1) // 2 if causal else t * t
    peak = PEAK_F32_OPS_PER_S if dt == torch.float32 else PEAK_BF16_OPS_PER_S
    io = 4 * b * h * t * d * q.element_size() + 2 * 4 * b * h * t  # q, k, v, dO; L, D
    for name, (kernel, plain, like) in kernels.items():
        got = kernel(q, k, v, do, lse, delta, causal)
        again = kernel(q, k, v, do, lse, delta, causal)
        want = plain(*f32, lse, delta, causal)
        ref = (plain(*(a.double() for a in f32), lse.double(), delta.double(), causal)
               if dt == torch.float32 else [None] * len(got))
        torch.cuda.synchronize()
        errs, overs, limits = [], [], []
        for g, a, w, r, x in zip(got, again, want, ref, like):
            if g.shape != x.shape or g.dtype != dt or g.stride() != x.stride():
                raise AssertionError(f"{what} {name}: output {tuple(g.shape)} {g.dtype} "
                                     f"strides {g.stride()}, input's {x.stride()}")
            if not torch.equal(g.view(bits), a.view(bits)):
                raise AssertionError(f"{what} {name}: two launches differ")
            err, over, limit = _bwd_limit(torch, g, w, r, dt)
            errs.append(err)
            overs.append(over)
            limits.append(limit)
        if not max(overs) <= 1.0:
            raise AssertionError(f"{what} {name}: {max(overs)} times its limit {limits}")
        del got, again, want, ref
        ms = time_ms(torch, lambda: kernel(q, k, v, do, lse, delta, causal), flush)
        plain_ms = time_ms(torch, lambda: plain(q, k, v, do, lse, delta, causal), flush)
        products, outputs = (4, 2) if name.endswith("dkv") else (3, 1)
        bound_ms, bound_by = bytes_ops_bound(
            io + outputs * b * h * t * d * q.element_size(),
            products * 2.0 * b * h * pairs * d, peak)
        row[name] = {"max_abs_err": max(errs), "max_err_over_limit": max(overs),
                     "limits": limits, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by}
        torch.cuda.empty_cache()
    leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    lib = torch.autograd.grad(out, leaves, do, retain_graph=True)
    want = fa.flash_bwd_dq_plain(*f32, lse, delta, causal)
    row["library_max_abs_diff_dq"] = _max_err(lib[0], want)
    del lib, want
    row["library_ms"] = time_ms(
        torch, lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), flush)
    row["library"] = "autograd backward of F.scaled_dot_product_attention"
    del q, k, v, do, o, lse, delta, f32, leaves, out
    torch.cuda.empty_cache()
    print("flash_attn_bwd " + json.dumps(row), flush=True)
    return row


def flash_bwd_kernel_phase(torch, dev, flush):
    return [flash_bwd_case(torch, dev, flush, *case) for case in FLASH_BWD_CASES]


def _lm_train_family(name: str) -> str:
    key = name.lower()
    for fam, marks in (("flash_attn_fwd", ("flash_fwd_",)),
                       ("flash_attn_bwd_dkv", ("flash_bwd_dkv",)),
                       ("flash_attn_bwd_dq", ("flash_bwd_dq",)),
                       ("copies", ("memcpy", "memset")),
                       ("softmax_loss", ("softmax",)),
                       ("products", ("gemm", "gemv", "cutlass", "nvjet", "xmma", "splitk"))):
        if any(m in key for m in marks):
            return fam
    return "elementwise"


def _device_spans(prof):
    spans = []
    for evt in prof.events():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            span = (float(evt.time_range.start), float(evt.time_range.end))
            if span[1] > span[0]:
                spans.append(span)
    return spans


def _host_enqueue_ms(torch, net, x, y, reps: int = 3) -> float:
    """The host's time for one training step, untraced: from the step's
    start to the return of its last launch, before the synchronise that
    waits for the device (median of ``reps``). CUDA's launch queue blocks
    the host when the device falls far behind, so this bounds the host's
    own work from above; near the step's time, the host sets the pace."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, grads, state = net._loss_and_grads(x, y, net._gen)
        net._apply_updates(grads)
        net._commit_state(state)
        out.append((time.perf_counter() - t0) * 1e3)
        del grads
        torch.cuda.synchronize()
    return float(np.median(out))


def lm_step_profile(torch, net, x, y, step_ms) -> dict:
    """One training step under torch.profiler, in two traces split where the
    step turns from the gradients to the update (a synchronise between):
    device ms by kernel family (the update's kernels are the optimizer's);
    busy time as the union of each trace's device spans; the idle share of
    that same step against its own wall time, the two traces' walls
    summed, and against the median unprofiled step (the tracer and the
    split lengthen the traced wall, so the first overstates the idle share
    and the second, whose busy time comes from the traced step, is the
    nearer reading of an untraced step); the device kernels and copies the
    step ran and the kernel launches the host made for them; and, untraced,
    the host's enqueue time for a step (:func:`_host_enqueue_ms`). Runs twice
    and keeps the second: the first pays the tracer's start-up."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=acts) as fb:
            t0 = time.perf_counter()
            loss, grads, state = net._loss_and_grads(x, y, net._gen)
            torch.cuda.synchronize()
            wall_fb = time.perf_counter() - t0
        with profile(activities=acts) as up:
            t0 = time.perf_counter()
            net._apply_updates(grads)
            net._commit_state(state)
            torch.cuda.synchronize()
            wall_up = time.perf_counter() - t0
        del grads
    fam = {k: 0.0 for k in ("products", "flash_attn_fwd", "flash_attn_bwd_dkv",
                            "flash_attn_bwd_dq", "elementwise", "softmax_loss", "copies")}
    kernels = _kernel_times(fb)
    for name, ms in kernels:
        fam[_lm_train_family(name)] += ms
    fam["optimizer"] = sum(ms for _, ms in _kernel_times(up))
    spans_fb, spans_up = _device_spans(fb), _device_spans(up)
    if not spans_fb or not spans_up:
        raise AssertionError("lm training: the profile recorded no device activity")
    missing = [f for f in ("flash_attn_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq")
               if fam[f] == 0.0]
    if missing:
        raise AssertionError(f"lm training: the profile found no kernel of {missing}")
    busy = _union_ms(spans_fb) + _union_ms(spans_up)
    wall_ms = (wall_fb + wall_up) * 1e3
    launch_calls = sum(1 for prof in (fb, up) for evt in prof.events()
                       if "LaunchKernel" in evt.name)
    return {"device_ms_by_family": fam, "device_busy_ms": busy, "wall_ms": wall_ms,
            "idle_share": 1.0 - busy / wall_ms, "median_step_ms_unprofiled": step_ms,
            "idle_share_vs_unprofiled_step": 1.0 - busy / step_ms,
            "device_events": len(spans_fb) + len(spans_up),
            "host_kernel_launch_calls": launch_calls,
            "host_enqueue_ms": _host_enqueue_ms(torch, net, x, y),
            "loss": float(loss),
            "top_kernels_ms": [[name[:70], ms] for name, ms in kernels[:12]]}


def lm_train_run(torch, dev, card, dtype_name) -> dict:
    """The main path: the GPT-2-small-width LM trained through
    MultiLayerNetwork.fit on one seeded batch of LM_BATCH x LM_T ids and
    their next-token one-hot labels, both made on the card (the labels are
    1.65 GB), LM_TRAIN_WARM warm-up and LM_TRAIN_STEPS timed steps. Each
    step must launch each flash kernel LM_BLOCKS times and no other kernel,
    with LM_BLOCKS flash calls and no dense one; every loss finite, the last
    below the first."""
    import dataclasses

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf import attention
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = dataclasses.replace(lm_conf(), dtype=dtype_name)
    net = MultiLayerNetwork(conf, dev).init()
    n_params = net.num_params()
    ids = torch.from_numpy(np.random.default_rng(7).integers(0, LM_VOCAB, (LM_BATCH, LM_T + 1)))
    ids = ids.to(dev)
    x = ids[:, :-1].float()
    y = torch.zeros((LM_BATCH, LM_T, LM_VOCAB), device=dev)
    y.scatter_(2, ids[:, 1:, None], 1.0)
    ds = DataSet(x, y)
    per_step = {"flash_attn_fwd": LM_BLOCKS, "flash_attn_bwd_dkv": LM_BLOCKS,
                "flash_attn_bwd_dq": LM_BLOCKS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    _zero_launch_counts()
    for name in attention.counters:
        attention.counters[name] = 0
    for i in range(LM_TRAIN_WARM + LM_TRAIN_STEPS):
        before = _launch_counts()
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(net._score)
        moved = {k: n - before[k] for k, n in _launch_counts().items()}
        if moved != {k: per_step.get(k, 0) for k in moved}:
            raise AssertionError(f"lm training {dtype_name} step {i}: launches {moved}, "
                                 f"want {per_step} and no other kernel")
    launches, paths = _launch_counts(), dict(attention.counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = LM_TRAIN_WARM + LM_TRAIN_STEPS
    if paths != {"attention.flash": LM_BLOCKS * steps, "attention.dense": 0}:
        raise AssertionError(f"lm training {dtype_name}: attention paths {paths}")
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"lm training {dtype_name}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"lm training {dtype_name}: loss did not fall {losses}")
    step_ms = float(np.median(times[LM_TRAIN_WARM:]))
    profile = lm_step_profile(torch, net, x, y, step_ms)
    del net, ds, x, y, ids
    torch.cuda.empty_cache()
    summary = {"card": card, "dtype": dtype_name, "masters": "float32", "params": n_params,
               "batch": LM_BATCH, "t": LM_T, "blocks": LM_BLOCKS, "updater": "Adam(1e-4)",
               "steps": steps, "median_step_ms": step_ms,
               "min_step_ms": min(times[LM_TRAIN_WARM:]),
               "step_ms": times, "tokens_per_s": LM_BATCH * LM_T / (step_ms / 1e3),
               "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
               "launches": {k: launches[k] for k in per_step}, "attention_paths": paths,
               "peak_memory_gb": peak_gb,
               "cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    print(f"lm_training_{dtype_name} " + json.dumps(summary), flush=True)
    print(f"lm_training_profile_{dtype_name} " + json.dumps(profile), flush=True)
    return summary


def lm_training_phase(torch, dev, card):
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    runs = {dt: lm_train_run(torch, dev, card, dt) for dt in ("float32", "bfloat16")}
    print(f"lm training phase ran {time.perf_counter() - t_phase:.1f} s", flush=True)
    return runs


def _lm_check_step(net, x, y):
    """One Adam step through the training step's own parts: (loss, grads)."""
    loss, grads, _ = net._loss_and_grads(x.to(net.device), y.to(net.device), net._gen)
    net._apply_updates(grads)
    return float(loss), grads


def lm_training_card_vs_cpu(torch, dev) -> dict:
    """One Adam step of the LM at full width and LM_CHECK_BLOCKS blocks,
    batch 1 x t 1024 (the flash path), from the same float32 weights, in
    float32 and in bf16 with float32 masters, each on the card through the
    kernels and on the CPU through the plain versions; one float64 step on
    the CPU is the referee of both. TF32 stays off. Held, in each dtype: the
    loss within LM_CHECK_MULT times the CPU step's distance to the referee,
    or LM_CHECK_LOSS_FRAC of it; the gradients of W_q, W_k and W_v in every
    block within LM_CHECK_MULT times the CPU gradient's distance to the
    referee, or LM_CHECK_FRAC of the referee's largest magnitude; the
    updated weights within lr * min(2, dg / (|g| + eps)) + 1e-6 |w| of the
    referee's, dg that gradient's limit (Adam's first step is lr * g / (|g|
    + eps), whose slope in g is at most 1 / (|g| + eps)). A control step on
    the card with the dK/dV kernel's outputs zeroed must miss the gradient
    limit of W_k and W_v in every block."""
    import dataclasses

    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.tree import tree_map
    from deeplearning4j_tpu_torch.perf.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    base = lm_conf(LM_CHECK_BLOCKS)
    start = [tree_map(lambda v: v.cpu(), p) for p in MultiLayerNetwork(base, dev).init().params]
    ids = np.random.default_rng(11).integers(0, LM_VOCAB, (1, LM_T + 1))
    x = torch.from_numpy(ids[:, :-1].astype(np.float32))
    y = torch.from_numpy(np.eye(LM_VOCAB, dtype=np.float32)[ids[:, 1:]])
    referee = MultiLayerNetwork(dataclasses.replace(base, dtype="float64"), "cpu").set_params(
        tree_map(lambda v: v.double(), start))
    l64, g64 = _lm_check_step(referee, x, y)
    upd = base.updater
    summary = {"blocks": LM_CHECK_BLOCKS, "t": LM_T, "cpu_f64_loss": l64}
    for dt in ("float32", "bfloat16"):
        conf = dataclasses.replace(base, dtype=dt)
        card = MultiLayerNetwork(conf, dev).set_params(
            tree_map(lambda v: v.to(dev, copy=True), start))
        _zero_launch_counts()
        lg, gg = _lm_check_step(card, x, y)
        counts = _launch_counts()
        if any(counts[k] != LM_CHECK_BLOCKS for k in
               ("flash_attn_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq")):
            raise AssertionError(f"lm card vs cpu {dt}: the card step launched {counts}")
        cpu = MultiLayerNetwork(conf, "cpu").set_params(tree_map(lambda v: v.clone(), start))
        lc, gc = _lm_check_step(cpu, x, y)
        del cpu
        loss_limit = max(LM_CHECK_MULT * abs(lc - l64), LM_CHECK_LOSS_FRAC[dt] * abs(l64))
        if not abs(lg - l64) <= loss_limit:
            raise AssertionError(f"lm card vs cpu {dt}: loss {lg} vs float64 {l64} "
                                 f"(CPU {lc}, limit {loss_limit})")
        report, limits = {}, {}
        for block in range(1, LM_CHECK_BLOCKS + 1):
            for group in ("q", "k", "v"):
                key = f"{block}/{group}/W"
                ref = g64[block][group]["W"]
                scale = float(ref.abs().max())
                cpu_err = float((gc[block][group]["W"].double() - ref).abs().max())
                card_err = float((gg[block][group]["W"].cpu().double() - ref).abs().max())
                limits[key] = limit = max(LM_CHECK_MULT * cpu_err, LM_CHECK_FRAC * scale)
                if not card_err <= limit:
                    raise AssertionError(f"lm card vs cpu {dt}: gradient {key} card vs "
                                         f"float64 {card_err} > {limit} (CPU {cpu_err}, "
                                         f"max {scale})")
                w64 = referee.params[block][group]["W"]
                w_card = card.params[block][group]["W"].cpu().double()
                w_limit = (upd.learning_rate * torch.clamp_max(
                    limit / (ref.abs() + upd.epsilon), 2.0) + 1e-6 * w64.abs())
                w_over = float(((w_card - w64).abs() / w_limit).max())
                if not w_over <= 1.0:
                    raise AssertionError(f"lm card vs cpu {dt}: updated {key} {w_over} "
                                         f"times its limit")
                report[key] = {"card_vs_f64": card_err, "cpu_vs_f64": cpu_err,
                               "limit": limit, "max_abs": scale,
                               "updated_weight_over_limit": w_over}
        del card, gg, gc
        # control: the same step with dK/dV zeroed must miss the limits
        control = MultiLayerNetwork(conf, dev).set_params(
            tree_map(lambda v: v.to(dev, copy=True), start))
        real = fa.flash_bwd_dkv
        fa.flash_bwd_dkv = lambda *a, **kw: tuple(torch.zeros_like(g) for g in real(*a, **kw))
        try:
            _, g_zero, _ = control._loss_and_grads(x.to(dev), y.to(dev))
        finally:
            fa.flash_bwd_dkv = real
        control_errs = {}
        for block in range(1, LM_CHECK_BLOCKS + 1):
            for group in ("k", "v"):
                key = f"{block}/{group}/W"
                control_errs[key] = float((g_zero[block][group]["W"].cpu().double()
                                           - g64[block][group]["W"]).abs().max())
                if not control_errs[key] > limits[key]:
                    raise AssertionError(f"lm card vs cpu {dt}: the zeroed-dK/dV control "
                                         f"meets the limit of {key} ({control_errs[key]} "
                                         f"<= {limits[key]})")
        del control, g_zero
        torch.cuda.empty_cache()
        summary[dt] = {"card_loss": lg, "cpu_loss": lc, "loss_limit": loss_limit,
                       "grads": report, "zeroed_dkv_control_grad_err": control_errs}
    summary["seconds"] = time.perf_counter() - t0
    print("lm_training_card_vs_cpu " + json.dumps(summary), flush=True)
    return summary


def lenet_phase(torch, dev) -> dict:
    """LeNet (BASELINE configs[0]) through MultiLayerNetwork.fit on the card:
    one batch of LENET_BATCH synthetic_mnist images, 2 warm-up and
    LENET_STEPS timed Adam steps; every loss finite, the last below the
    first; no kernel of the port runs (LeNet has no TPU kernel)."""
    from deeplearning4j_tpu_torch.datasets import DataSet, synthetic_mnist
    from deeplearning4j_tpu_torch.models import LeNet

    net = LeNet().init(dev)
    x, y = synthetic_mnist(LENET_BATCH, seed=0)
    ds = DataSet(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
    _zero_launch_counts()
    losses, times = _timed_steps(torch, net, ds, 2, LENET_STEPS)
    if any(_launch_counts().values()):
        raise AssertionError(f"lenet launched a kernel of the port: {_launch_counts()}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"lenet: losses {losses}")
    summary = {"batch": LENET_BATCH, "steps": len(losses), "first_loss": losses[0],
               "last_loss": losses[-1], "median_step_ms": float(np.median(times)),
               "params": net.num_params()}
    print("lenet " + json.dumps(summary), flush=True)
    return summary


def _flash_bwd_kernel_entry(name, rows, train):
    """The kernels-line entry of flash_attn_bwd_dkv or flash_attn_bwd_dq:
    numbers at the training path's shape and layout, (8, 12, 1024, 64)
    causal float32 head-split views; launches on both training runs; the
    other shapes beside."""
    key = ("b", "h", "t", "d", "causal", "dtype", "layout")
    main = next(r for r in rows if tuple(r[k] for k in key) == FLASH_BWD_CASES[0])
    line = {"dkv": 941, "dq": 1287}[name.rsplit("_", 1)[1]]
    return {"name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/flash_attn_bwd.cu",
            "replaces": "deeplearning4j_tpu/parallel/ring_attention.py:108",
            "tpu_kernel": f"jax/experimental/pallas/ops/tpu/flash_attention.py:{line}",
            **_launches_by_path(name, train),
            "max_abs_err": main[name]["max_abs_err"],
            "max_err_over_limit_all_cases": max(r[name]["max_err_over_limit"] for r in rows),
            "ms": main[name]["ms"], "plain_ms": main[name]["plain_ms"],
            "bound_ms": main[name]["bound_ms"], "bound_by": main[name]["bound_by"],
            "library_ms": main["library_ms"],
            "library": "autograd backward of F.scaled_dot_product_attention (dq, dk, dv)",
            "shape": {k: main[k] for k in key},
            "other_shapes": [dict({k: r[k] for k in key + ("library_ms",)},
                                  **{f: r[name][f] for f in ("ms", "plain_ms", "bound_ms")})
                             for r in rows if r is not main]}


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
    # the two *_v1 sources are the first designs of int4_dot and
    # flash_attn_fwd, timed beside their redesigns (previous_ms)
    names = ["int4_dot", "bn_act_fwd", "bn_act_bwd", "adc_pq", "adc_ivf_pq",
             "scatter_add", "flash_attn_fwd", "flash_attn_bwd", "int4_dot_v1",
             "flash_attn_fwd_v1"]
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
    int4_head = next(r for r in int4_retr if r["b"] == max(ADC_BATCHES))
    scatter_rows, w2v = word2vec_phase(torch, dev, flush, card)
    flash_rows = flash_kernel_phase(torch, dev, flush)
    lm = transformer_phase(torch, dev, card)
    bwd_rows = flash_bwd_kernel_phase(torch, dev, flush)
    train = lm_training_phase(torch, dev, card)
    lm_training_card_vs_cpu(torch, dev)
    lenet_phase(torch, dev)

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
        "max_abs_err": max(r["max_abs_err"] for r in rows + [fc1] + int4_retr),
        "ms": fc1["ms"], "previous_ms": fc1["previous_ms"], "plain_ms": fc1["plain_ms"],
        "bound_ms": fc1["bound_ms"], "bound_by": fc1["bound_by"],
        "library_ms": fc1["library_ms"],
        "shape": {"b": b, "n": n, "d": d},
        "retrieval_shape": {k: int4_head[k] for k in INT4_KEYS},
        "retrieval_batches": [{k: r[k] for k in INT4_KEYS} for r in int4_retr
                              if r is not int4_head]},
        _bn_kernel_entry("bn_act_fwd", bn_rows, bn_fwd),
        _bn_kernel_entry("bn_act_bwd", bn_rows, bn_bwd),
        _adc_kernel_entry("adc_pq", pq_rows, served["pq"]["launches"], 59),
        _adc_kernel_entry("adc_ivf_pq", ivf_rows, served["ivf_pq"]["launches"], 103),
        _scatter_kernel_entry(scatter_rows, w2v),
        _flash_kernel_entry(flash_rows, lm, train),
        _flash_bwd_kernel_entry("flash_attn_bwd_dkv", bwd_rows, train),
        _flash_bwd_kernel_entry("flash_attn_bwd_dq", bwd_rows, train)]}),
        flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
